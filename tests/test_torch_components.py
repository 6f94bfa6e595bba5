"""PyTorch port vs the JAX package: connected-component labelling, exactly.

``connected_components`` at both connectivities, ``relabel_roots``,
``relabel_sequential`` and ``relabel_by_raster_order`` on the same seeded
inputs give the same int32 maps as the JAX package. The card route of
``connected_components(connectivity=1)`` stands on ``cc_scan`` with the
flat index as its initial value; the plain scan is shown here to give the
JAX package's root map, and the kernel equals the plain route on the card
(``cuda`` marker).
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tissue_image_processing_tpu_torch.ops import components as tcc
from tissue_image_processing_tpu_torch.ops import flood_cuda
from tissue_image_processing_tpu_torch.utils.synthetic import coil_mask

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

jcc = importlib.import_module("tissue_image_processing_tpu.ops.components")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _masks():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :80]
    return {
        "random_0.4": rng.random((64, 80)) < 0.4,
        "random_0.6": rng.random((96, 72)) < 0.6,
        "coil": coil_mask(64, 64, 4),
        "checkerboard": (yy + xx) % 2 == 0,
        "empty": np.zeros((33, 47), bool),
        "full": np.ones((40, 56), bool),
        "one_row": rng.random((1, 128)) < 0.5,
    }


MASKS = _masks()


def _jax_roots(labels: np.ndarray) -> np.ndarray:
    """The JAX package's root map, read back from its labels: each
    foreground pixel's root is the flat index of its component's first
    pixel (the labels are that root's rank), background -1."""
    flat = labels.ravel()
    values, first_index = np.unique(flat, return_index=True)
    first = np.zeros(flat.max() + 1, np.int64)
    first[values] = first_index
    return np.where(flat > 0, first[flat], -1).reshape(labels.shape)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_connected_components_matches_jax(name, connectivity):
    mask = MASKS[name]
    want = np.asarray(jcc.connected_components(jnp.asarray(mask),
                                               connectivity=connectivity))
    got = tcc.connected_components(torch.from_numpy(mask),
                                   connectivity=connectivity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_cc_scan_plain_gives_jax_roots(name):
    """The identity the card route relies on: the component minimum of the
    flat index (``cc_scan`` with ``init`` = the index) is the JAX package's
    root map, and ``relabel_roots`` of it is JAX's labelling."""
    mask = MASKS[name]
    want_labels = np.asarray(jcc.connected_components(jnp.asarray(mask)))
    m = torch.from_numpy(mask)
    H, W = mask.shape
    index = torch.arange(H * W, dtype=torch.int32).reshape(H, W)
    roots = flood_cuda.cc_scan_plain(m, index)
    np.testing.assert_array_equal(roots.numpy(), _jax_roots(want_labels))
    np.testing.assert_array_equal(tcc.relabel_roots(roots).numpy(), want_labels)
    np.testing.assert_array_equal(
        np.asarray(jcc.relabel_roots(jnp.asarray(roots.numpy()))), want_labels)


def test_connected_components_rejects_bad_input():
    with pytest.raises(ValueError):
        tcc.connected_components(torch.ones(2, 3, 4, dtype=torch.bool))
    with pytest.raises(ValueError):
        tcc.connected_components(torch.ones(3, 4, dtype=torch.bool),
                                 connectivity=3)


@pytest.mark.parametrize("case", ["roots", "dense", "sparse", "background_7"])
def test_relabel_matches_jax(case):
    rng = np.random.default_rng(1)
    shape = (48, 60)
    n = shape[0] * shape[1]
    if case == "roots":  # a root map of a random mask
        mask = rng.random(shape) < 0.5
        x = flood_cuda.cc_scan_plain(torch.from_numpy(mask)).numpy()
        fn = "relabel_roots"
        args = ()
    else:
        values = {"dense": (0, 40), "sparse": (0, n), "background_7": (0, 20)}
        x = rng.integers(*values[case], shape).astype(np.int32)
        fn = "relabel_sequential"
        args = (7,) if case == "background_7" else ()
    want = np.asarray(getattr(jcc, fn)(jnp.asarray(x), *args))
    got = getattr(tcc, fn)(torch.from_numpy(x), *args)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("labels_max", [5, 300])
def test_relabel_by_raster_order_matches_jax(labels_max):
    x = np.random.default_rng(2).integers(0, labels_max, (40, 50)).astype(np.int32)
    want = np.asarray(jcc.relabel_by_raster_order(jnp.asarray(x)))
    got = tcc.relabel_by_raster_order(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_connected_components_card_matches_plain(cuda_device, name,
                                                 connectivity):
    import tissue_image_processing_tpu_torch as tipt

    mask = torch.from_numpy(MASKS[name])
    want = tcc.connected_components(mask, connectivity=connectivity)
    tipt.reset_launches()
    got = tcc.connected_components(mask.to(cuda_device),
                                   connectivity=connectivity)
    assert tipt.LAUNCHES["cc_scan"] == (4 if connectivity == 1 else 0)
    assert torch.equal(got.cpu(), want)
