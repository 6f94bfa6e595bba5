"""PyTorch port vs the JAX package: the space-sharded projection
(``parallel/spatial.py``).

The JAX side runs on the 8-device virtual CPU mesh of ``conftest.py``, the
port on ``[torch.device("cpu")] * 8``; each JAX result is computed once per
module. Bars, the JAX tests' own (``tests/test_parallel_spatial.py``):
z-maps exact and projections at rtol 2e-4 / atol 2e-3 against both JAX's
``sharded_projection`` and its unsharded
``time_point_surface_projection(precise=True)``; the distributed percentile
equal to the global one, and above ``_EXACT_SORT_LIMIT`` equal to JAX's
``masked_percentile`` bit for bit; the 1-hop halo exchange equal to
``np.pad(mode="edge")`` windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tissue_image_processing_tpu_torch.ops.percentile import (
    _EXACT_SORT_LIMIT, masked_percentile)
from tissue_image_processing_tpu_torch.parallel import spatial as tsp
from tissue_image_processing_tpu_torch.parallel.mesh import _object_array
from tissue_image_processing_tpu_torch.projection.surface import (
    time_point_surface_projection)

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
# (frame, y, x) shards: the JAX tests' row cases (x = 1) and xy cases
CASES = [(2, 4, 1), (1, 8, 1), (1, 4, 2), (2, 2, 2), (1, 2, 4)]


def _movie(T, C, Z, Y, X, seed=0):
    """``tests/test_parallel_spatial.py:_movie``."""
    rng = np.random.default_rng(seed)
    m = (rng.random((T, C, Z, Y, X)) * 5000).astype(np.float32)
    zz = np.arange(Z).reshape(Z, 1, 1)
    depth = Z / 2 + (Z / 4) * np.sin(np.arange(Y) / 17.0).reshape(-1, 1)
    m *= np.exp(-((zz - depth) ** 2))[None, None]
    return m


def _case_movie(f, y, x):
    """The JAX tests' shapes: 8 rows a y shard, 64 columns (row cases) or
    32 an x shard."""
    if x == 1:
        return _movie(2 * f, 2, 4, 8 * y, 64)
    return _movie(2 * f, 2, 4, 8 * y, 32 * x, seed=5)


def _grid(shards, shape):
    return _object_array(list(shards), shape)


@pytest.fixture(scope="module")
def jax_projections():
    """Per case: JAX's ``sharded_projection`` and its unsharded precise
    projection of every frame."""
    from tissue_image_processing_tpu.parallel import spatial as jsp
    from tissue_image_processing_tpu.projection.surface import (
        time_point_surface_projection as jtp)

    out = {}
    for f, y, x in CASES:
        movie = _case_movie(f, y, x)
        mesh = jsp.make_space_mesh(8, frame_shards=f, x_shards=x)
        with mesh:
            sp, sz = jsp.sharded_projection(mesh, reference_channel=0,
                                            airyscan=False)(jnp.asarray(movie))
        single = [jtp(jnp.asarray(s), reference_channel=0, airyscan=False,
                      precise=True) for s in movie]
        out[f, y, x] = (np.asarray(sp), np.asarray(sz),
                        np.stack([np.asarray(p) for p, _ in single]),
                        np.stack([np.asarray(z) for _, z in single]))
    return out


def test_make_space_mesh():
    mesh = tsp.make_space_mesh(8, frame_shards=2, x_shards=2, devices=CPU8)
    assert dict(mesh.shape) == {"frame": 2, "y": 2, "x": 2}
    assert dict(tsp.make_space_mesh(8, devices=CPU8).shape) == {
        "frame": 1, "y": 8, "x": 1}
    with pytest.raises(ValueError, match="must divide"):
        tsp.make_space_mesh(8, frame_shards=3, devices=CPU8)
    with pytest.raises(ValueError, match="devices="):
        tsp.make_space_mesh(16, devices=CPU8)


def test_masked_percentile_psum_matches_global():
    from jax.sharding import Mesh, PartitionSpec as P

    from tissue_image_processing_tpu.parallel.spatial import (
        masked_percentile_psum as jmpp)

    rng = np.random.default_rng(0)
    x = (rng.random((8, 256)) * 100).astype(np.float32)
    mask = x > 20
    got = tsp.masked_percentile_psum([torch.from_numpy(r) for r in x],
                                     [torch.from_numpy(m) for m in mask], 95.0)
    assert len(got) == 8 and all(g.dim() == 0 for g in got)
    assert abs(float(got[3]) - float(np.percentile(x[mask], 95.0))) < 1e-4
    mesh = Mesh(np.array(jax.devices()[:8]), ("y",))
    want = jax.jit(jax.shard_map(
        lambda xs, ms: jmpp(xs, ms, 95.0, "y"), mesh=mesh,
        in_specs=(P("y"), P("y")), out_specs=P(), check_vma=False))(
            jnp.asarray(x), jnp.asarray(mask))
    assert float(got[0]) == float(want)
    empty = tsp.masked_percentile_psum([torch.ones(4)] * 2,
                                       [torch.zeros(4, dtype=torch.bool)] * 2,
                                       50.0)
    assert float(empty[0]) == 0.0


@pytest.mark.parametrize("f,y,x", CASES)
def test_sharded_projection_parity(f, y, x, jax_projections):
    """Tiny shapes take the gather fallback of the 120-px halo (8-row
    shards); the 1-hop exchange is covered by
    test_sharded_projection_one_hop_halos and test_halo_exchange_1hop."""
    movie = _case_movie(f, y, x)
    mesh = tsp.make_space_mesh(8, frame_shards=f, x_shards=x, devices=CPU8)
    proj, zmap = tsp.sharded_projection(mesh, reference_channel=0,
                                        airyscan=False)(movie)
    T, C, _, Y, X = movie.shape
    assert tuple(proj.shape) == (T, C, Y, X) and tuple(zmap.shape) == (T, Y, X)
    assert zmap.dtype == torch.int32
    sp, sz, up, uz = jax_projections[f, y, x]
    for want_p, want_z in ((sp, sz), (up, uz)):
        np.testing.assert_array_equal(zmap.numpy(), want_z)
        np.testing.assert_allclose(proj.numpy(), want_p, rtol=2e-4, atol=2e-3)
    for t in range(T):   # and the port's own unsharded projection
        wp, wz = time_point_surface_projection(torch.from_numpy(movie[t]),
                                               airyscan=False, precise=True)
        assert torch.equal(zmap[t], wz)
        torch.testing.assert_close(proj[t], wp, rtol=2e-4, atol=2e-3)


def test_sharded_projection_one_hop_halos():
    """Shards of 128 rows and columns take the ppermute exchange for every
    halo (4, 8 and the score blur's 120 px), corners through the column
    halo; against the port's unsharded projection (itself held to JAX's)."""
    movie = _movie(2, 2, 4, 256, 256, seed=3)
    for f, x in ((1, 2), (2, 1)):
        mesh = tsp.make_space_mesh(4, frame_shards=f, x_shards=x,
                                   devices=CPU8)
        proj, zmap = tsp.sharded_projection(mesh, airyscan=False)(movie)
        for t in range(2):
            wp, wz = time_point_surface_projection(
                torch.from_numpy(movie[t]), airyscan=False, precise=True)
            assert torch.equal(zmap[t], wz), (f, x, t)
            torch.testing.assert_close(proj[t], wp, rtol=2e-4, atol=2e-3)


def test_sharded_projection_airyscan_atoh():
    """The airyscan offset and a shifted second-channel mask, against the
    port's unsharded projection."""
    movie = _movie(2, 2, 5, 32, 64, seed=7) * 4
    mesh = tsp.make_space_mesh(4, frame_shards=2, x_shards=2, devices=CPU8)
    proj, zmap = tsp.sharded_projection(mesh, airyscan=True,
                                        airyscan_offset=2000.0,
                                        atoh_shift=1)(torch.from_numpy(movie))
    for t in range(2):
        wp, wz = time_point_surface_projection(
            torch.from_numpy(movie[t]), airyscan=True, airyscan_offset=2000.0,
            atoh_shift=1, precise=True)
        assert torch.equal(zmap[t], wz)
        torch.testing.assert_close(proj[t], wp, rtol=2e-4, atol=2e-3)


def test_clip_percentile_mirrors_subsampling_above_limit():
    """Above _EXACT_SORT_LIMIT the unsharded masked_percentile subsamples
    strided rows; the sharded clip selects the same global rows, over row
    shards (whole rows) and over x shards narrower than 128 columns of a
    narrow volume (single elements)."""
    from tissue_image_processing_tpu.ops.percentile import (
        masked_percentile as jmp)

    rng = np.random.default_rng(2)
    for shape, split in (((6, 1024, 768), (8, 1)), ((40, 1024, 120), (2, 4))):
        assert np.prod(shape) > _EXACT_SORT_LIMIT
        vol = (rng.random(shape) * 5000).astype(np.float32)
        want = float(jmp(jnp.asarray(vol), jnp.asarray(vol > 0), 95.0))
        t = torch.from_numpy(vol)
        assert float(masked_percentile(t, t > 0, 95.0)) == want
        rows = torch.chunk(t, split[0], 1)
        grid = _grid([c for r in rows for c in torch.chunk(r, split[1], 2)],
                     split)
        masks = _grid([s > 0 for s in grid.flat], split)
        got = tsp.clip_percentile_sharded(grid, masks, 95.0)
        assert got.shape == split
        assert all(float(g) == want for g in got.flat), (shape, want)


def test_halo_exchange_1hop():
    """halo <= shard rows: the ppermute path; each extended shard equals
    the edge-padded axis's window."""
    rng = np.random.default_rng(1)
    x = rng.random((1, 64, 32)).astype(np.float32)   # (C, Y, X), 8 rows/shard
    halo = 5
    ext = tsp._halo_exchange_rows(list(torch.chunk(torch.from_numpy(x), 8, 1)),
                                  halo)
    padded = np.pad(x, ((0, 0), (halo, halo), (0, 0)), mode="edge")
    blk = halo + 8 + halo
    for s, e in enumerate(ext):
        np.testing.assert_array_equal(e.numpy(), padded[:, s * 8:s * 8 + blk])
    cols = tsp._halo_exchange_cols(list(torch.chunk(
        torch.from_numpy(x), 4, 2)), 3)
    padded = np.pad(x, ((0, 0), (0, 0), (3, 3)), mode="edge")
    for s, e in enumerate(cols):
        np.testing.assert_array_equal(e.numpy(),
                                      padded[:, :, s * 8:s * 8 + 14])


@pytest.mark.cuda
def test_sharded_projection_on_card_matches_cpu():
    """Two row shards on the card (a virtual mesh) against the CPU: z-maps
    equal, projections in the JAX tests' class."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    movie = _case_movie(1, 2, 2)
    proj = {}
    for dev in ("cuda", "cpu"):
        mesh = tsp.make_space_mesh(4, frame_shards=1, x_shards=2,
                                   devices=[torch.device(dev)] * 4)
        p, z = tsp.sharded_projection(mesh, airyscan=False)(movie)
        assert p.device.type == dev
        proj[dev] = (p.cpu(), z.cpu())
    assert torch.equal(proj["cuda"][1], proj["cpu"][1])
    torch.testing.assert_close(proj["cuda"][0], proj["cpu"][0], rtol=2e-4,
                               atol=2e-3)
