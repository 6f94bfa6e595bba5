"""The benchmark's movie generator as a function of the seed."""

import numpy as np
import pytest
import torch

from benchmark.movies import make_movie, two_nearest
from benchmark.tests.helpers import small_cell


def _traffic(z=3, side=96):
    _, _, t = small_cell("ws_raw_2000", side)
    t["z"] = z
    return t


def test_same_seed_same_movie_other_seed_other_movie():
    t = _traffic()
    a = make_movie(t, 2, 2 ** 31 + 7, torch.device("cpu"))
    b = make_movie(t, 2, 2 ** 31 + 7, torch.device("cpu"))
    c = make_movie(t, 2, 2 ** 31 + 8, torch.device("cpu"))
    assert a.shape == (2, 2, 3, 96, 96) and a.dtype == np.uint16
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_membranes_are_bright_on_channel_0_and_dark_on_channel_1():
    m = make_movie(_traffic(z=1), 1, 5, torch.device("cpu")).astype(float)
    # the membrane channel's brightest pixels are the marker's darkest
    hot = m[0, 0, 0] > np.percentile(m[0, 0, 0], 95)
    assert m[0, 1, 0][hot].mean() < m[0, 1, 0][~hot].mean()
    assert m.max() <= 65535 and m.min() >= 0


def test_two_nearest_against_brute_force():
    g = torch.Generator().manual_seed(3)
    pts = torch.rand((300, 2), generator=g) * torch.tensor([150.0, 170.0])
    d1, d2 = two_nearest(pts, 150, 170)
    yy, xx = torch.meshgrid(torch.arange(150.0), torch.arange(170.0),
                            indexing="ij")
    d = ((yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2)
    want = torch.topk(d, 2, dim=-1, largest=False).values.sqrt()
    assert torch.equal(d1, want[..., 0]) and torch.equal(d2, want[..., 1])


def test_an_unknown_generator_is_refused():
    t = _traffic()
    t["generator"] = "other"
    with pytest.raises(ValueError):
        make_movie(t, 1, 0, torch.device("cpu"))
