"""The port's ``parallel/`` runner, its launch plumbing and the shard
bodies' sync-free cell tables.

- ``ops/regionprops.py:_perimeter_tables`` (now built on the host and
  copied once per device and stream) equals its literal index sets, and
  ``frame_cellinfo`` (label 0 now cleared on the device) stays exact
  against the JAX package on label maps with and without label 0;
- on a CPU mesh :meth:`Mesh.run` makes no stream and runs the positions in
  the calling thread, in order; the collectives on its results give the
  values they gave before;
- the runner returns results in position order, equal to the serial form,
  and raises a position's exception with a note naming the position;
- ``_device.launch`` enters its tensor's device and passes that device's
  current stream, with ``torch.cuda`` stood in for (no card here);
- ``_device.count_launch`` from many threads at once sums exactly, and
  ``load_library`` from many threads builds a library once.

A shard body's host reads cannot be tested here (on the CPU it runs the
kernels' plain versions, which may read back by design): ``chip_smoke.py``'s
"parallel" phase runs the bodies under ``set_sync_debug_mode("error")``.
The one card test holds the streams form to the serial one on a
4-position virtual mesh.
"""

import contextlib
import dataclasses
import sys
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cell_labels
from tissue_image_processing_tpu.core import cell_table as jct
from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.core import cell_table as tct
from tissue_image_processing_tpu_torch.ops.regionprops import (
    _perimeter_tables)
from tissue_image_processing_tpu_torch.parallel import mesh as tmesh
from tissue_image_processing_tpu_torch.parallel import pipeline as tpipe
from tissue_image_processing_tpu_torch.parallel import spatial as tspat

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

CPU4 = [torch.device("cpu")] * 4
THREADS = 16
JOIN_S = 60.0


def _frame_mesh(form="streams", devices=CPU4):
    return dataclasses.replace(tpipe.make_frame_mesh(len(devices),
                                                     devices=devices),
                               _form=form)


# --- the sync-free cell table -------------------------------------------------

def test_perimeter_tables_literal():
    a, b = _perimeter_tables(torch.device("cpu"))
    want_a, want_b = np.zeros(50, np.int64), np.zeros(50, np.int64)
    want_a[[5, 7, 15, 17, 25, 27]] = 2
    want_b[[21, 33]] = 2
    want_a[[13, 23]] = 1
    want_b[[13, 23]] = 1
    np.testing.assert_array_equal(a.numpy(), want_a)
    np.testing.assert_array_equal(b.numpy(), want_b)
    assert a.dtype == b.dtype == torch.int64


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _no_zero(seed):
    """A label map in which every pixel is a cell: no label 0."""
    lab = make_cell_labels(64, 96, n_seeds=15, seed=seed)
    filled = lab.copy()
    for _ in range(3):   # grow the cells over their 1-px lines
        up = np.roll(filled, 1, 0)
        filled = np.where(filled == 0, up, filled)
        left = np.roll(filled, 1, 1)
        filled = np.where(filled == 0, left, filled)
    assert filled.min() > 0
    return filled


@pytest.mark.parametrize("labels,cap,neighbors", [
    (make_cell_labels(96, 128, n_seeds=30, seed=11), 64, True),
    (make_cell_labels(96, 128, n_seeds=30, seed=12), 64, False),
    (make_cell_labels(64, 64, n_seeds=40, seed=13), 16, False),  # > cap labels
    (_no_zero(14), 32, True),
    (_no_zero(15), 32, False),
], ids=["zero_lines", "zero_lines_no_nbrs", "over_capacity", "no_zero",
        "no_zero_no_nbrs"])
def test_frame_cellinfo_exact(labels, cap, neighbors):
    want = jct.frame_cellinfo(jnp.asarray(labels), capacity=cap,
                              with_neighbors=neighbors)
    got = tct.frame_cellinfo(torch.from_numpy(labels), capacity=cap,
                             with_neighbors=neighbors)
    for name, arr in _leaves(want).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), arr,
                                      err_msg=name)


def test_host_constant_on_cpu_is_fresh():
    calls = []

    def make():
        calls.append(1)
        return torch.arange(3)

    a = _device.host_constant("test", make, torch.device("cpu"))
    b = _device.host_constant("test", make, "cpu")
    assert a.tolist() == b.tolist() == [0, 1, 2] and len(calls) == 2


# --- the runner on a CPU mesh -------------------------------------------------

def test_cpu_mesh_runs_in_calling_thread_in_order():
    mesh = _frame_mesh()
    seen = []

    def body(i, dev):
        seen.append((i, threading.get_ident()))
        return torch.full((2,), float(i), device=dev)

    before = threading.active_count()
    out = mesh.run(body, range(4), list(mesh.devices.flat))
    assert seen == [(i, threading.get_ident()) for i in range(4)]
    assert [float(o[0]) for o in out] == [0.0, 1.0, 2.0, 3.0]
    assert mesh._streams == {} and threading.active_count() == before


@pytest.mark.parametrize("collective", ["ppermute", "all_gather", "psum"])
def test_collectives_on_runner_outputs(collective):
    """The collectives on what the runner returns: the values computed with
    numpy from the same shards."""
    mesh = _frame_mesh()
    rng = np.random.default_rng(3)
    data = [rng.random((3, 5)).astype(np.float32) for _ in range(4)]
    shards = mesh.run(lambda x, dev: torch.from_numpy(x).to(dev) * 2.0, data,
                      list(mesh.devices.flat))
    want = [2.0 * d for d in data]
    if collective == "ppermute":
        got = tmesh.ppermute(shards, [(i, (i + 1) % 4) for i in range(3)])
        want = [np.zeros_like(want[0])] + want[:3]
    elif collective == "all_gather":
        got = tmesh.all_gather(shards, axis=1)
        want = [np.concatenate(want, 1)] * 4
    else:
        got = tmesh.psum(shards)
        want = [want[0] + want[1] + want[2] + want[3]] * 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert mesh._streams == {}


@pytest.mark.parametrize("form", tmesh.FORMS)
def test_runner_results_in_position_order(form):
    mesh = tmesh.Mesh(tmesh._object_array(CPU4 * 2, (2, 4)),
                      ("data", "model"), _form=form)
    out = mesh.run(lambda a, b: a * 10 + b, range(8), range(8))
    assert out == [i * 11 for i in range(8)]
    some = [(1, 2), (0, 3)]
    assert mesh.run(lambda: 7, positions=some) == [7, 7]
    assert mesh.run(lambda x: x, ["a", "b"], positions=some) == ["a", "b"]
    with pytest.raises(ValueError, match="argument sets"):
        mesh.run(lambda x: x, [1, 2, 3], positions=some)


def test_runner_serial_form_equal():
    """A frame-sharded pipeline on the CPU: the default form and the serial
    one give the same ids."""
    rng = np.random.default_rng(0)
    zz = np.arange(4, dtype=np.float32).reshape(4, 1, 1)
    movie = (rng.random((4, 2, 1, 48, 48)).astype(np.float32) * 1000.0
             * np.exp(-((zz - 2.0) ** 2) / 2.0)[None, None])
    kw = dict(capacity=32, block_size=15)
    a = tpipe.sharded_movie_pipeline(_frame_mesh("streams"), **kw)(movie)
    b = tpipe.sharded_movie_pipeline(_frame_mesh("serial"), **kw)(movie)
    assert torch.equal(a, b) and int((a > 0).sum()) > 0


def test_runner_names_failed_position():
    mesh = _frame_mesh()

    def body(i):
        if i == 2:
            raise ValueError("shard body broke")
        return i

    with pytest.raises(ValueError, match="shard body broke") as info:
        mesh.run(body, range(4))
    assert info.value.__notes__ == ["raised in mesh position (2,)"]


def test_mesh_rejects_unknown_form():
    with pytest.raises(ValueError, match="form"):
        tmesh.Mesh(tmesh._object_array(CPU4, (4,)), ("frame",),
                   _form="async")


def test_space_mesh_positions_without_x_axis():
    """``_grid_map`` on a (frame, y) mesh: positions (f, iy), results in
    grid order."""
    mesh = tmesh.Mesh(tmesh._object_array(CPU4, (2, 2)), ("frame", "y"))
    map_ = tspat._grid_map(mesh, 1)
    grid = tmesh._object_array([torch.tensor(1.0), torch.tensor(2.0)], (2, 1))
    out = map_(lambda t: t * 3, grid)
    assert out.shape == (2, 1) and [float(o) for o in out.flat] == [3.0, 6.0]


# --- the launch plumbing ------------------------------------------------------

class _FakeCuda:
    """Stand-ins for ``torch.cuda.device`` and ``torch.cuda.current_stream``
    on a host with no card: the current device is ``cuda:0`` outside any
    guard, and each device's current stream has handle 1000 + its index."""

    def __init__(self):
        self.current = torch.device("cuda", 0)
        self.entered, self.asked = [], []

    @contextlib.contextmanager
    def device(self, dev):
        dev, before = torch.device(dev), self.current
        self.entered.append(dev)
        self.current = dev
        try:
            yield
        finally:
            self.current = before

    def current_stream(self, device=None):
        self.asked.append(device)
        dev = self.current if device is None else torch.device(device)
        return types.SimpleNamespace(cuda_stream=1000 + dev.index)


class _FakeLib:
    @staticmethod
    def kernel_error_string(rc):
        return f"error {rc}".encode()


@pytest.mark.parametrize("index", [1, 3])
def test_launch_on_tensor_device_and_stream(monkeypatch, index):
    """A launch for a tensor on ``cuda:index`` from a thread whose current
    device is ``cuda:0``: the C entry runs with ``cuda:index`` current and
    gets ``cuda:index``'s stream, and the guard is left afterwards."""
    fake = _FakeCuda()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    calls = []

    def entry(*args):
        calls.append((args[:-1], args[-1].value, fake.current))
        return 0

    dev = torch.device("cuda", index)
    _device.launch(_FakeLib(), entry, dev, "kernel", 7, 8)
    assert calls == [((7, 8), 1000 + index, dev)]
    assert fake.entered == [dev] and fake.asked == [dev]
    assert fake.current == torch.device("cuda", 0)


def test_launch_failure_raises_and_leaves_guard(monkeypatch):
    fake = _FakeCuda()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    with pytest.raises(RuntimeError, match=r"settle: CUDA error 700 \(error 700\)"):
        _device.launch(_FakeLib(), lambda *args: 700, torch.device("cuda", 2),
                       "settle")
    assert fake.entered == [torch.device("cuda", 2)]
    assert fake.current == torch.device("cuda", 0)



def _in_threads(fn, n=THREADS):
    """``fn(k)`` in ``n`` threads started together, with a short switch
    interval; returns their results by k. Every wait is bounded, and the
    threads are daemons, so a hung one fails the test and not the run."""
    out, errors = [None] * n, []
    start = threading.Barrier(n)

    def run(k):
        try:
            start.wait(JOIN_S)
            out[k] = fn(k)
        except Exception as exc:   # reported by the caller
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=run, args=(k,), daemon=True)
                   for k in range(n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(JOIN_S)
        assert not any(w.is_alive() for w in workers), "a thread hung"
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    return out


def test_count_launch_from_threads(monkeypatch):
    monkeypatch.setattr(_device, "LAUNCHES", {"blur3d": 0, "settle": 0})
    for name in ("BLUR_LAUNCHES", "BLUR_FORMS", "CONV_LAUNCHES"):
        monkeypatch.setattr(_device, name, _device.collections.Counter())
    reps = 500

    def launch(k):
        for _ in range(reps):
            _device.count_launch("blur3d", 1, (_device.BLUR_FORMS, k % 3))
            _device.count_launch("settle", 2)

    _in_threads(launch)
    assert _device.LAUNCHES == {"blur3d": THREADS * reps,
                                "settle": 2 * THREADS * reps}
    assert sum(_device.BLUR_FORMS.values()) == THREADS * reps
    assert _device.BLUR_FORMS[0] == reps * len(range(0, THREADS, 3))
    _device.reset_launches()
    assert _device.LAUNCHES == {"blur3d": 0, "settle": 0}
    assert not _device.BLUR_FORMS


def test_load_library_builds_once_from_threads(monkeypatch):
    built = []

    def fake_build(names):
        built.append(tuple(names))
        threading.Event().wait(0.05)   # a build takes a while

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_device, "_libs", {})
    monkeypatch.setattr(_device, "_build", fake_build)
    monkeypatch.setattr(_device.ctypes, "CDLL", lambda path: FakeLib())
    libs = _in_threads(lambda k: _device.load_library(
        "blur3d", {"blur3d_f32": (_device.ctypes.c_int,)}), n=8)
    assert built == [("blur3d",)]
    assert all(lib is libs[0] for lib in libs)


def test_to_host_cpu_tensors():
    a, b = torch.arange(4), torch.ones(2, 3)
    got = _device.to_host(a, b)
    np.testing.assert_array_equal(got[0], np.arange(4))
    np.testing.assert_array_equal(got[1], np.ones((2, 3)))


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_concurrent_forms_equal_serial_on_card():
    """A 4-position virtual mesh on the card: the streams form gives the
    serial form's ids and its space-sharded projection, bit for bit, on
    four position streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    zz = np.arange(4, dtype=np.float32).reshape(4, 1, 1)
    movie = (rng.random((8, 2, 1, 64, 64)).astype(np.float32) * 1000.0
             * np.exp(-((zz - 2.0) ** 2) / 2.0)[None, None])
    cards = [torch.device("cuda")] * 4
    kw = dict(capacity=64, block_size=31)
    ids = {form: tpipe.sharded_movie_pipeline(_frame_mesh(form, cards),
                                              **kw)(movie)
           for form in tmesh.FORMS}
    assert torch.equal(ids["streams"], ids["serial"])
    mesh = _frame_mesh("streams", cards)
    tpipe.sharded_movie_pipeline(mesh, **kw)(movie)
    assert len({s.cuda_stream for s in mesh._streams.values()}) == 4
    sm = np.random.default_rng(5).random((2, 2, 4, 16, 64)).astype(
        np.float32) * 5000
    proj = {form: tspat.sharded_projection(dataclasses.replace(
        tspat.make_space_mesh(4, frame_shards=1, x_shards=2, devices=cards),
        _form=form))(sm) for form in ("streams", "serial")}
    for a, b in zip(proj["streams"], proj["serial"]):
        assert torch.equal(a, b)
