"""The plain reference against the port at a small size on the CPU (the
test imports the port; the reference does not)."""

import numpy as np
import pytest
import torch

from benchmark.compare import compare_movie, labels_mismatch
from benchmark.movies import make_movie
from benchmark.programs.movie_pipeline import Program
from benchmark.reference.pipeline import reference_movie
from benchmark.tests.helpers import small_cell

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("cell", ["ws_raw_2000", "ws_preproj_2000"])
def test_watershed_chain_bit_for_bit(cell):
    _, config, traffic = small_cell(cell)
    movie = make_movie(traffic, config["frames"], 11, CPU)
    prog = Program(config, [movie], CPU)
    got = prog(movie)
    ref = reference_movie(movie, config, CPU)
    numbers = compare_movie(got, ref)
    assert set(numbers.values()) == {0.0}
    assert int(got["labels"].max()) > 20


def test_unet_chain_from_the_programs_softmax():
    _, config, traffic = small_cell("unet_raw_2000", side=256)
    movie = make_movie(traffic, config["frames"], 12, CPU)
    prog = Program(config, [movie], CPU)
    got = prog.kept_call(movie)
    assert got["probs"].shape == (4, 256, 256, 2)
    numbers = prog.check(movie, got)
    # bfloat16 program, float32 reference: the softmax differs a little;
    # everything downstream of it is exact
    assert 0.0 < numbers["prob_gap"] < 0.05
    assert numbers["labels_mismatch"] == 0.0
    assert numbers["tables_mismatch"] == 0.0
    assert numbers["drift_gap"] == 0.0
    assert numbers["ids_mismatch"] == 0.0


def test_labels_mismatch_counts_merges_and_splits_whatever_the_numbering():
    a = torch.zeros((1, 4, 6), dtype=torch.int32)
    a[0, :, :3], a[0, :, 3:] = 1, 2
    assert labels_mismatch(a, a + 5 * (a > 0)) == 0.0   # renumbered
    merged = torch.ones_like(a)
    assert labels_mismatch(merged, a) == pytest.approx(0.5)
    assert labels_mismatch(a, merged) == pytest.approx(0.5)
    assert labels_mismatch(a, a[:, :2]) == 1.0
    assert np.isfinite(labels_mismatch(a, a))
