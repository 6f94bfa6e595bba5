"""PyTorch port vs the JAX package: ``parallel/`` (mesh, frame-sharded
pipelines, sharded training step) and the ``frame_cellinfo`` keywords it
needs.

The JAX side runs on the 8-device virtual CPU mesh of ``conftest.py``, the
port on ``[torch.device("cpu")] * n``. Each JAX result is computed once per
module. Bars:

- ids of the sharded watershed, chunked and U-Net pipelines: exact, against
  the JAX program and the port's unsharded chain;
- the U-Net's probabilities to 1e-5 (float32, summation order) with no
  pixel within that of the 0.1 threshold, so masks and labels are exact;
- ``shard_params``: every shard equal to the converted JAX shard of the
  same model position;
- the sharded training step against JAX's and the port's unsharded step:
  loss to rel 1e-5, gradients to 1e-4 of their largest magnitude,
  BatchNorm running statistics to 1e-6, parameters to 2 x lr (the
  training tolerances of ``tests/test_torch_train.py``);
- ``frame_cellinfo(intensity=, with_neighbors=False)``: field for field.

The JAX package's ``models/`` and ``parallel/`` are imported inside the
fixtures and tests that need them (the card's machine has no flax).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cell_image, make_cell_labels
from tissue_image_processing_tpu.core import cell_table as jct
from tissue_image_processing_tpu_torch.core import cell_table as tct
from tissue_image_processing_tpu_torch.core.tracking import (
    compute_drift_chain, track_movie)
from tissue_image_processing_tpu_torch.models import train as ttrain
from tissue_image_processing_tpu_torch.models.predictor import (
    find_desired_shape, unet_postprocess)
from tissue_image_processing_tpu_torch.models.unet import UNet
from tissue_image_processing_tpu_torch.ops.brightness import normalize_channel
from tissue_image_processing_tpu_torch.ops.watershed import (
    watershed_segmentation)
from tissue_image_processing_tpu_torch.parallel import mesh as tmesh
from tissue_image_processing_tpu_torch.parallel import pipeline as tpipe
from tissue_image_processing_tpu_torch.projection.surface import (
    time_point_surface_projection)
from tissue_image_processing_tpu_torch.utils.state import unet_state_from_flax

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
CAP, BLOCK = 64, 31
LR = 1e-5


def _tiny_movie(T, C=2, Z=4, H=64, W=64, seed=0):
    """``tests/test_parallel.py:_tiny_movie``."""
    rng = np.random.default_rng(seed)
    zz = np.arange(Z, dtype=np.float32).reshape(Z, 1, 1)
    zprof = np.exp(-((zz - Z / 2.0) ** 2) / 2.0)
    base = rng.random((T, C, 1, H, W)).astype(np.float32) * 1000.0
    return (base * zprof[None, None]).astype(np.float32)


def _single_chain(movie, frame_fn, cap=CAP):
    """The port's unsharded chain (``tests/test_parallel.py``'s): per-frame
    tables, ``compute_drift_chain``, ``track_movie``."""
    outs = [frame_fn(torch.from_numpy(s)) for s in movie]
    refs, cy, cx, area, mask = (torch.stack(o) for o in zip(*outs))
    return track_movie(cy, cx, area, mask, drifts=compute_drift_chain(refs),
                       capacity=2 * cap).numpy()


def _watershed_frame(stack):
    proj, _ = time_point_surface_projection(stack, reference_channel=0,
                                            airyscan=False)
    labels = watershed_segmentation(proj[0], 0.2, 3.0, BLOCK)
    table = tct.frame_cellinfo(labels, capacity=CAP)
    return proj[0], table.cy, table.cx, table.area, table.valid_mask()


# --- mesh ------------------------------------------------------------------

def test_make_mesh_shapes():
    assert dict(tmesh.make_mesh(8, devices=CPU8).shape) == {"data": 2,
                                                            "model": 4}
    assert dict(tmesh.make_mesh(2, devices=CPU8).shape) == {"data": 1,
                                                            "model": 2}
    assert dict(tmesh.make_mesh(3, devices=CPU8).shape) == {"data": 3,
                                                            "model": 1}
    fmesh = tpipe.make_frame_mesh(8, devices=CPU8)
    assert dict(fmesh.shape) == {"frame": 8}
    assert list(fmesh.devices) == CPU8 and fmesh.lead == torch.device("cpu")


def test_make_mesh_validates_device_count():
    with pytest.raises(ValueError, match="devices="):
        tmesh.make_mesh(1024, devices=CPU8)
    with pytest.raises(ValueError, match="devices="):
        tpipe.make_frame_mesh(1024, devices=CPU8)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="devices="):
            tmesh.make_mesh(torch.cuda.device_count() + 1)
    else:   # no quiet CPU mesh: without a card and without devices=, raise
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            tpipe.make_frame_mesh()


def test_collectives():
    shards = [torch.full((2,), float(i)) for i in range(4)]
    got = tmesh.ppermute(shards, [(i, (i + 1) % 4) for i in range(4)])
    assert [float(g[0]) for g in got] == [3.0, 0.0, 1.0, 2.0]
    got = tmesh.ppermute(shards, [(0, 1)])   # no sender: zeros
    assert [float(g[0]) for g in got] == [0.0, 0.0, 0.0, 0.0]
    gathered = tmesh.all_gather(shards)
    assert len(gathered) == 4 and all(g is gathered[0] for g in gathered)
    assert gathered[0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert tuple(tmesh.all_gather(shards, tiled=False)[2].shape) == (4, 2)
    assert [float(s[1]) for s in tmesh.psum(shards)] == [6.0] * 4
    mesh = tmesh.make_mesh(8, devices=CPU8)
    assert tmesh.axis_index(mesh, "model", (1, 3)) == 3
    xs = tmesh.shard_batch(mesh, np.arange(12).reshape(6, 2))
    assert [x[:, 0].tolist() for x in xs] == [[0, 2, 4], [6, 8, 10]]
    with pytest.raises(ValueError, match="data axis"):
        tmesh.shard_batch(mesh, np.zeros((3, 2)))


def test_parallel_imports_no_jax():
    code = ("import sys\n"
            "import tissue_image_processing_tpu_torch.parallel.pipeline\n"
            "import tissue_image_processing_tpu_torch.parallel.spatial\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'tissue_image_processing_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# --- frame_cellinfo's keywords ----------------------------------------------

@pytest.mark.parametrize("with_neighbors", [False, True])
def test_frame_cellinfo_keywords_match_jax(with_neighbors):
    labels = make_cell_labels(128, 128, n_seeds=40, seed=3)
    img = make_cell_image(128, 128, n_seeds=40, seed=3)
    want = jct.frame_cellinfo(jnp.asarray(labels), capacity=64,
                              intensity=jnp.asarray(img),
                              with_neighbors=with_neighbors)
    got = tct.frame_cellinfo(torch.from_numpy(labels), capacity=64,
                             intensity=torch.from_numpy(img),
                             with_neighbors=with_neighbors)
    for name in ("area", "perimeter", "label", "cx", "cy", "valid", "type",
                 "bbox", "empty_cell", "neighbors", "n_neighbors"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert bool(got.n_neighbors.any()) == with_neighbors
    wc, wo = jct.frame_cellinfo_checked(jnp.asarray(labels), capacity=64,
                                        intensity=jnp.asarray(img))
    gc, go = tct.frame_cellinfo_checked(torch.from_numpy(labels), capacity=64,
                                        intensity=torch.from_numpy(img))
    np.testing.assert_array_equal(gc.neighbors.numpy(), np.asarray(wc.neighbors))
    assert bool(go) == bool(wo)


# --- the frame-sharded watershed pipeline ------------------------------------

@pytest.fixture(scope="module")
def jax_watershed_ids():
    """JAX's ``sharded_movie_pipeline`` ids on ``_tiny_movie(8)`` over 8 and
    4 frame shards."""
    from tissue_image_processing_tpu.parallel import pipeline as jpipe

    return {n: np.asarray(jpipe.sharded_movie_pipeline(
        jpipe.make_frame_mesh(n), capacity=CAP, block_size=BLOCK)(
            jnp.asarray(_tiny_movie(8)))) for n in (8, 4)}


@pytest.fixture(scope="module")
def single_ids():
    return _single_chain(_tiny_movie(8), _watershed_frame)


@pytest.mark.parametrize("n", [8, 4])
def test_sharded_pipeline_matches_jax_and_single(n, jax_watershed_ids,
                                                 single_ids):
    fn = tpipe.sharded_movie_pipeline(tpipe.make_frame_mesh(n, devices=CPU8),
                                      capacity=CAP, block_size=BLOCK)
    got = fn(_tiny_movie(8))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, CAP)
    assert (got > 0).sum() > 0
    np.testing.assert_array_equal(got.numpy(), jax_watershed_ids[n])
    np.testing.assert_array_equal(got.numpy(), single_ids)


def test_sharded_pipeline_rejects_uneven_frames():
    fn = tpipe.sharded_movie_pipeline(tpipe.make_frame_mesh(8, devices=CPU8))
    with pytest.raises(ValueError, match="divisible"):
        fn(_tiny_movie(4))


@pytest.mark.parametrize("chunk", [8, 16, 24])
def test_sharded_chunked_matches_unchunked(chunk, jax_watershed_ids):
    """T=20 with chunk 8 or 16 takes a padded tail chunk; T=24 with chunk 24
    is one chunk. Held to the port's unchunked program (itself held to
    JAX's above), and its first 8 frames to JAX's unchunked ids."""
    T = 24 if chunk == 24 else 20
    movie = _tiny_movie(T)
    mesh = tpipe.make_frame_mesh(8, devices=CPU8)
    got = tpipe.sharded_movie_pipeline_chunked(mesh, movie, chunk_frames=chunk,
                                               capacity=CAP, block_size=BLOCK)
    assert got.shape == (T, CAP)
    want = tpipe.sharded_movie_pipeline(mesh, capacity=CAP, block_size=BLOCK)(
        movie[:T - T % 8]).numpy()
    np.testing.assert_array_equal(got[:want.shape[0]], want)
    np.testing.assert_array_equal(got[:8], jax_watershed_ids[8])


def test_sharded_chunked_on_chunk_streams():
    from tissue_image_processing_tpu_torch.io.movie import MovieStore

    movie = _tiny_movie(16)
    seen = []
    got = tpipe.sharded_movie_pipeline_chunked(
        tpipe.make_frame_mesh(8, devices=CPU8), MovieStore(movie),
        chunk_frames=8, capacity=CAP, block_size=BLOCK,
        on_chunk=lambda t0, ids: seen.append((t0, ids.shape[0])))
    assert seen == [(0, 8), (8, 8)]
    assert got.shape == (16, CAP)


def test_sharded_chunked_rejects_bad_chunk():
    mesh = tpipe.make_frame_mesh(8, devices=CPU8)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        tpipe.sharded_movie_pipeline_chunked(
            mesh, np.zeros((16, 1, 2, 16, 16)), chunk_frames=12)
    with pytest.raises(ValueError, match="T, C, Z, Y, X"):
        tpipe.sharded_movie_pipeline_chunked(mesh, np.zeros((16, 2, 16, 16)),
                                             chunk_frames=8)


# --- the frame-sharded U-Net pipeline ----------------------------------------

H, W = 48, 40   # non-square, non-power-of-two: the pad and the transposes


@pytest.fixture(scope="module")
def unet_case():
    """JAX's ``sharded_unet_pipeline`` ids and per-frame probabilities on
    ``_tiny_movie(8, H=48, W=40)``, depth 2, 8 filters, float32, weights
    with non-trivial BatchNorm statistics."""
    import jax

    from test_torch_unet import flax_variables
    from tissue_image_processing_tpu.models import predictor as jpred
    from tissue_image_processing_tpu.models import unet as junet
    from tissue_image_processing_tpu.ops.brightness import (
        normalize_channel as jnorm)
    from tissue_image_processing_tpu.parallel import pipeline as jpipe
    from tissue_image_processing_tpu.projection import surface as jsurf

    movie = _tiny_movie(8, H=H, W=W)
    variables = flax_variables(depth=2, base_filters=8, seed=3,
                               shape=find_desired_shape(W, H) + (2,))
    jmodel = junet.UNet(depth=2, base_filters=8)
    jfn = jpipe.sharded_unet_pipeline(jpipe.make_frame_mesh(8), jmodel,
                                      capacity=CAP)
    ids = np.asarray(jfn(variables, jnp.asarray(movie)))

    @jax.jit
    def probs(stack):
        proj, _ = jsurf.time_point_surface_projection(stack, reference_channel=0,
                                                      airyscan=False)
        x = jnp.transpose(jax.vmap(jnorm)(proj))
        px, py = jpred.find_desired_shape(W, H)
        x = jnp.pad(x, ((px - W, 0), (py - H, 0), (0, 0)))
        return jmodel.apply(variables, x[None], train=False)[0][px - W:, py - H:]

    return dict(movie=movie, variables=variables, ids=ids,
                probs=np.stack([np.asarray(probs(jnp.asarray(s)))
                                for s in movie]))


def _unet_frame(model):
    def one_frame(stack):
        proj, _ = time_point_surface_projection(stack, reference_channel=0,
                                                airyscan=False)
        x = torch.stack([normalize_channel(ch) for ch in proj]).permute(2, 1, 0)
        px, py = find_desired_shape(W, H)
        x = torch.nn.functional.pad(x, (0, 0, py - H, 0, px - W, 0))
        with torch.no_grad():
            pred = model(x[None])[0][px - W:, py - H:]
        labels, _ = unet_postprocess(pred)
        table = tct.frame_cellinfo(labels.T.contiguous(), capacity=CAP)
        return proj[0], table.cy, table.cx, table.area, table.valid_mask()
    return one_frame


def test_sharded_unet_pipeline_matches_jax(unet_case):
    state = unet_state_from_flax(unet_case["variables"])
    model = UNet(depth=2, base_filters=8)
    model.load_state_dict(state)
    model.eval()
    got_p = []
    for s in unet_case["movie"]:   # the per-frame probabilities
        proj, _ = time_point_surface_projection(torch.from_numpy(s),
                                                airyscan=False)
        x = torch.stack([normalize_channel(ch) for ch in proj]).permute(2, 1, 0)
        px, py = find_desired_shape(W, H)
        x = torch.nn.functional.pad(x, (0, 0, py - H, 0, px - W, 0))
        with torch.no_grad():
            got_p.append(model(x[None])[0][px - W:, py - H:].numpy())
    want_p = unet_case["probs"]
    err = float(np.abs(np.stack(got_p) - want_p).max())
    assert err <= 1e-5
    assert np.abs(want_p[..., 0] - 0.1).min() > err   # no mask pixel in doubt

    fn = tpipe.sharded_unet_pipeline(tpipe.make_frame_mesh(8, devices=CPU8),
                                     UNet(depth=2, base_filters=8),
                                     capacity=CAP)
    got = fn(state, unet_case["movie"]).numpy()
    assert got.shape == (8, CAP)
    np.testing.assert_array_equal(got, unet_case["ids"])
    np.testing.assert_array_equal(got, _single_chain(unet_case["movie"],
                                                     _unet_frame(model)))
    np.testing.assert_array_equal(fn(model, unet_case["movie"]).numpy(), got)


# --- parameters over the (data x model) mesh and the training step -----------

@pytest.mark.parametrize("n", [2, 8])
def test_shard_params_placement_matches_jax(n):
    """Every tensor of a converted depth-2 tree (8 base filters; the
    2-class head divides a model axis of 2 but not of 4) is split on the
    axis JAX splits, piece m equal to JAX's shard on model position m
    converted (the transposed conv's output axis included)."""
    import jax

    from test_torch_unet import flax_variables
    from tissue_image_processing_tpu.parallel import mesh as jmesh

    variables = flax_variables(depth=2, base_filters=8, seed=3,
                               shape=find_desired_shape(W, H) + (2,))
    jm = jmesh.make_mesh(n)
    placed = jmesh.shard_params(jm, variables)
    model_axis = jm.devices.shape[1]
    # JAX's shard on (data 0, model m): the tree of each leaf's piece there
    pieces = [jax.tree.map(lambda a, d=jm.devices[0, m]: np.asarray(next(
        s.data for s in a.addressable_shards if s.device == d)), placed)
        for m in range(model_axis)]
    model = UNet(depth=2, base_filters=8)
    model.load_state_dict(unet_state_from_flax(variables))
    tm = tmesh.make_mesh(n, devices=CPU8)
    got = tmesh.shard_params(tm, model)
    want = [unet_state_from_flax(p) for p in pieces]
    split = 0
    for k, shards in got.shards.items():
        if "num_batches" in k:
            assert got.specs[k] is None
            continue
        if got.specs[k] is None:
            assert len(shards) == 1
            for w in want:
                assert torch.equal(shards[0], w[k]), k
        else:
            split += 1
            assert len(shards) == model_axis, k
            for m, w in enumerate(want):
                assert torch.equal(shards[m], w[k]), (k, m)
    assert split > 0
    for k, v in got.state_dict().items():   # joined back: the whole tree
        assert torch.equal(v, model.state_dict()[k]), k


@pytest.fixture(scope="module")
def train_case():
    """One step of JAX's ``unet_train_step_sharded`` on a (2 x 4) mesh:
    depth 2, 8 filters, float32, dropout 0, 4 x 32^2 (the dry-run in
    ``__graft_entry__.py``), with its gradients from the same program."""
    import dataclasses

    import jax

    from tissue_image_processing_tpu.models import train as jtrain
    from tissue_image_processing_tpu.models import unet as junet
    from tissue_image_processing_tpu.parallel import mesh as jmesh

    jm = jmesh.make_mesh(8)
    jmodel = junet.UNet(depth=2, base_filters=8, dtype=jnp.float32,
                        dropout_rate=0.0)
    state, tx = jtrain.create_train_state(jmodel, (32, 32, 2),
                                          learning_rate=LR)
    start = jax.device_get({"params": state.params,
                            "batch_stats": state.batch_stats})
    sharded = dataclasses.replace(
        state, params=jmesh.shard_params(jm, state.params),
        batch_stats=jmesh.shard_params(jm, state.batch_stats),
        opt_state=jax.tree.map(
            lambda x: jmesh.shard_params(jm, x) if hasattr(x, "shape") else x,
            state.opt_state))
    rng = np.random.default_rng(0)
    x = rng.random((4, 32, 32, 2)).astype(np.float32)
    y_cls = (rng.random((4, 32, 32)) > 0.5).astype(np.float32)
    y = np.stack([y_cls, 1 - y_cls], -1)
    step = jmesh.unet_train_step_sharded(jm, jmodel, tx)
    with jm:
        new, loss = step(sharded, jmesh.shard_batch(jm, jnp.asarray(x)),
                         jnp.asarray(y), jax.random.PRNGKey(0))
    after = jax.device_get({"params": new.params,
                            "batch_stats": new.batch_stats})
    return dict(x=x, y=y, start=unet_state_from_flax(start),
                jloss=float(loss), jnew=unet_state_from_flax(after))


def _port_model(start):
    model = UNet(depth=2, base_filters=8, dropout_rate=0.0)
    state, tx = ttrain.create_train_state(model, (32, 32, 2), LR,
                                          device="cpu")
    model.load_state_dict(start)
    return model, state, tx


def test_unet_train_step_sharded_matches_jax_and_unsharded(train_case):
    s = train_case
    model, state, tx = _port_model(s["start"])
    mesh = tmesh.make_mesh(8, devices=CPU8)
    sstate = tmesh.shard_params(mesh, state)
    assert dict(mesh.shape) == {"data": 2, "model": 4}
    step = tmesh.unet_train_step_sharded(mesh, model, sstate.optimizer)
    sstate, loss = step(sstate, tmesh.shard_batch(mesh, s["x"]), s["y"])
    assert sstate.step == 1
    ref_model, ref_state, ref_tx = _port_model(s["start"])
    ref_state, ref_loss, _ = ttrain.make_train_step(ref_model, ref_tx)(
        ref_state, s["x"], s["y"])
    got = sstate.model.state_dict()
    for want_loss in (s["jloss"], float(ref_loss)):
        assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    for want in (s["jnew"], ref_model.state_dict()):
        for k, w in want.items():
            if "num_batches" in k:
                continue
            if "running" in k:
                torch.testing.assert_close(got[k], w, rtol=0, atol=1e-6, msg=k)
                assert not torch.equal(w, s["start"][k]), k   # it moved
            else:
                torch.testing.assert_close(got[k], w, rtol=0, atol=2 * LR,
                                           msg=k)
    assert int(got["blocks.0.bn0.num_batches_tracked"]) == 1
    # each gradient piece against the unsharded step's gradient
    for k, p in ref_model.named_parameters():
        dim = sstate.model.specs[k]
        pieces = [g.grad for g in sstate.model.shards[k]]
        g = pieces[0] if dim is None else torch.cat(pieces, dim)
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(g, p.grad, rtol=0, atol=1e-4 * scale, msg=k)


def test_shard_params_carries_adam_moments():
    """A TrainState sharded after a step: each piece's Adam moments are its
    parameter's moments split the same way, and the steps go on."""
    rng = np.random.default_rng(1)
    x = rng.random((4, 16, 16, 2)).astype(np.float32)
    y = np.stack([x[..., 0] > 0.5, x[..., 0] <= 0.5], -1).astype(np.float32)
    model = UNet(depth=1, base_filters=4, dropout_rate=0.0)
    state, tx = ttrain.create_train_state(model, (16, 16, 2), 1e-3,
                                          device="cpu")
    state, _, _ = ttrain.make_train_step(model, tx)(state, x, y)
    mesh = tmesh.make_mesh(4, devices=CPU8[:4])
    sstate = tmesh.shard_params(mesh, state)
    assert sstate.optimizer.defaults == tx.defaults
    named = dict(model.named_parameters())
    for k, pieces in sstate.model.shards.items():
        if k not in named:
            continue
        dim = sstate.model.specs[k]
        src = tx.state[named[k]]
        for name in ("exp_avg", "exp_avg_sq"):
            moments = [sstate.optimizer.state[p][name] for p in pieces]
            joined = moments[0] if dim is None else torch.cat(moments, dim)
            assert torch.equal(joined, src[name]), (k, name)
            assert all(m.data_ptr() != src[name].data_ptr() for m in moments)
        assert all(torch.equal(sstate.optimizer.state[p]["step"], src["step"])
                   for p in pieces)
    step = tmesh.unet_train_step_sharded(mesh, model, sstate.optimizer)
    sstate, loss = step(sstate, x, y)
    assert sstate.step == 2 and bool(torch.isfinite(loss))


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_sharded_pipeline_on_card_matches_cpu():
    """Two frame shards on the card (a virtual mesh) against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    movie = _tiny_movie(8)
    kw = dict(capacity=CAP, block_size=BLOCK)
    on_card = tpipe.sharded_movie_pipeline(
        tpipe.make_frame_mesh(2, devices=[torch.device("cuda")] * 2), **kw)(
            movie)
    assert on_card.device.type == "cuda"
    on_cpu = tpipe.sharded_movie_pipeline(
        tpipe.make_frame_mesh(2, devices=CPU8), **kw)(movie)
    np.testing.assert_array_equal(on_card.cpu().numpy(), on_cpu.numpy())
