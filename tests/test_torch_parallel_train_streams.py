"""The sharded U-Net training step on position streams
(``parallel/mesh.py:unet_train_step_sharded``).

- On the (2 x 4) CPU mesh the streams form (its stream route taken with
  ``torch.cuda`` stood in for, as ``test_torch_parallel_streams.py``
  does) and the serial form give the loss, parameters, gradients and
  BatchNorm statistics of JAX's ``unet_train_step_sharded`` and of the
  unsharded step, within ``tests/test_torch_parallel.py``'s tolerances
  (loss rel 1e-5, parameters 2 x lr, statistics 1e-6, gradients 1e-4 of
  their largest magnitude), and equal each other bit for bit over two
  steps with dropout on (the same draws in both forms).
- With the stand-ins, every forward op of a position (its conv, the ReLU
  and BatchNorm sums after it, the normalisation, dropout, the softmax and
  the cross-entropy) is issued under its own stream and device, and no
  conv runs on the caller's stream.
- Every tensor that one stream makes and another reads (the activations
  gathered on the caller's stream, the BatchNorm and loss sums, the
  parameter pieces, the running statistics and parameters written in
  place) is handed over: the reader's stream waited on an event recorded
  on the writer's stream after the write (checked with vector clocks over
  the log of ops, events and waits) and the tensor was ``record_stream``-ed
  on the reader's stream. ``loss.backward()`` is issued on the caller's
  stream after it waited on every position stream. A log with the
  runner's waits taken out fails the check.

The ``cuda`` tests hold both forms to the unsharded step on a 4-position
virtual mesh of the card and run bfloat16 steps under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from test_torch_parallel import LR, _port_model, train_case  # noqa: F401
from tissue_image_processing_tpu_torch.models import train as ttrain
from tissue_image_processing_tpu_torch.models.unet import UNet
from tissue_image_processing_tpu_torch.parallel import mesh as tmesh

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
# ops that only tag a tensor: in place by name, but no write
NOT_WRITES = {"requires_grad_", "retain_grad", "share_memory_"}
# reads of metadata (a property's ``__get__``: device, shape, grad), not
# of data: no hand-over needed
METADATA = {"__get__", "numel", "dim", "size", "stride", "is_contiguous",
            "is_floating_point", "element_size", "__len__", "untyped_storage",
            "data_ptr"}


class _Event:
    def __init__(self, log):
        self.log, self.stream = log, None

    def record(self, stream):
        self.stream = stream
        self.log.append(("record", stream.name, self))


class _Stream:
    """A stand-in CUDA stream: ``wait_stream`` is PyTorch's own (an event
    recorded on the other stream, waited on by this one)."""

    def __init__(self, log, name, device):
        self.log, self.name, self.device = log, name, torch.device(device)

    def record_event(self, event=None):
        event = event or _Event(self.log)
        event.record(self)
        return event

    def wait_event(self, event):
        self.log.append(("wait", self.name, event))

    wait_stream = torch.cuda.Stream.wait_stream


class _FakeCuda:
    """``torch.cuda.Stream`` / ``stream`` / ``device`` / ``current_stream``
    stood in for, ``Tensor.record_stream`` logged, the runner's stream
    route taken on a CPU mesh, and every torch function call logged with
    the stream and device current when it was issued."""

    def __init__(self, monkeypatch):
        self.log = []
        self.device = torch.device("cpu")
        self.caller = {}
        self.current = {}
        self.made = 0
        fake = self

        def make_stream(device=None):
            fake.made += 1
            return _Stream(fake.log, f"position{fake.made}", device)

        @contextlib.contextmanager
        def device(dev):
            before, fake.device = fake.device, torch.device(dev)
            try:
                yield
            finally:
                fake.device = before

        @contextlib.contextmanager
        def stream(s):
            key = s.device
            before = fake.current.get(key)
            fake.current[key] = s
            try:
                yield
            finally:
                fake.current[key] = before

        def record_stream(tensor, s):
            fake.log.append(("record_stream", _key(tensor), s.name))

        monkeypatch.setattr(torch.cuda, "Stream", make_stream)
        monkeypatch.setattr(torch.cuda, "stream", stream)
        monkeypatch.setattr(torch.cuda, "device", device)
        monkeypatch.setattr(torch.cuda, "current_stream", self.current_stream)
        monkeypatch.setattr(torch.Tensor, "record_stream", record_stream)
        monkeypatch.setattr(tmesh.Mesh, "_streamed", lambda self, devs: True)

    def current_stream(self, device=None):
        dev = self.device if device is None else torch.device(device)
        s = self.current.get(dev)
        if s is None:
            s = self.caller.setdefault(dev, _Stream(self.log, "caller", dev))
        return s

    def ops(self):
        fake = self

        class Log(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                fake.log.append(("op", fake.current_stream().name,
                                 getattr(func, "__name__", str(func)),
                                 fake.device, args, kwargs or {}, out))
                return out

        return Log()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


def check_hand_overs(log):
    """Walk ``log`` with a vector clock a stream: an op that reads a tensor
    last written on another stream must come after a wait on an event
    recorded there after that write, and after a ``record_stream`` of the
    tensor on the reader's stream; and ``backward`` must come after its
    stream waited on every other stream's last op. Returns {stream: ops
    issued}; raises AssertionError naming the first op that breaks a
    rule."""
    clock = collections.defaultdict(lambda: collections.defaultdict(int))
    snapshot = {}
    writer = {}            # storage -> (stream, op index)
    recorded = set()       # (storage, stream)
    issued = collections.Counter()
    last = {}              # stream -> its last op index
    for i, entry in enumerate(log, 1):
        kind = entry[0]
        if kind == "record":
            _, s, event = entry
            snapshot[id(event)] = dict(clock[s])
        elif kind == "wait":
            _, s, event = entry
            for other, t in snapshot[id(event)].items():
                clock[s][other] = max(clock[s][other], t)
        elif kind == "record_stream":
            recorded.add((entry[1], entry[2]))
        else:
            _, s, name, _, args, kwargs, out = entry
            if name in METADATA:
                continue
            issued[s] += 1
            clock[s][s] = last[s] = i
            if name == "backward":
                behind = {t: at for t, at in last.items() if clock[s][t] < at}
                assert not behind, f"backward on {s} before a wait on {behind}"
            inputs = {_key(t) for t in _tensors((args, kwargs))}
            for k in inputs:
                if k in writer and writer[k][0] != s:
                    w, at = writer[k]
                    assert clock[s][w] >= at, \
                        f"{name} on {s} reads a tensor written on {w} " \
                        f"(entry {at}) without a wait after the write"
                    assert (k, s) in recorded, \
                        f"{name} on {s} reads a tensor made on {w} that was " \
                        f"never record_stream-ed on {s}"
            for t in _tensors(out):
                if _key(t) not in inputs:
                    writer[_key(t)] = (s, i)
            if name.endswith("_") and not name.startswith("__") \
                    and name not in NOT_WRITES and args:
                for t in _tensors(args[0]):
                    writer[_key(t)] = (s, i)
    return issued


def _grads(sp: tmesh.ShardedParams) -> dict:
    """Each parameter's gradient, its pieces joined."""
    return {k: (g[0] if sp.specs[k] is None else torch.cat(g, sp.specs[k]))
            for k, g in ((k, [p.grad for p in ps])
                         for k, ps in sp.shards.items()) if g[0] is not None}


def _run(s, form, fake=None, steps=1, dropout=0.0, seed=0):
    """(loss per step, whole state_dict, gradients, mesh) of ``steps``
    sharded steps in ``form``, under ``fake``'s op log when given."""
    model, state, _ = _port_model(s["start"])
    model.dropout_rate = dropout
    mesh = dataclasses.replace(tmesh.make_mesh(8, devices=CPU8), _form=form)
    sstate = tmesh.shard_params(mesh, state)
    step = tmesh.unet_train_step_sharded(mesh, model, sstate.optimizer)
    xs = tmesh.shard_batch(mesh, s["x"])
    torch.manual_seed(seed)
    losses = []
    with (fake.ops() if fake else contextlib.nullcontext()):
        for _ in range(steps):
            sstate, loss = step(sstate, xs, s["y"])
            losses.append(loss)
    return losses, sstate.model.state_dict(), _grads(sstate.model), mesh


@pytest.mark.parametrize("form", tmesh.FORMS)
def test_forms_match_jax_and_unsharded(train_case, monkeypatch, form):
    s = train_case
    fake = _FakeCuda(monkeypatch) if form == "streams" else None
    losses, got, grads, mesh = _run(s, form, fake)
    assert len(mesh._streams) == (8 if form == "streams" else 0)
    ref_model, ref_state, ref_tx = _port_model(s["start"])
    ref_state, ref_loss, _ = ttrain.make_train_step(ref_model, ref_tx)(
        ref_state, s["x"], s["y"])
    for want_loss in (s["jloss"], float(ref_loss)):
        assert abs(float(losses[0]) - want_loss) <= 1e-5 * abs(want_loss)
    for want in (s["jnew"], ref_model.state_dict()):
        for k, w in want.items():
            if "num_batches" in k:
                continue
            atol = 1e-6 if "running" in k else 2 * LR
            torch.testing.assert_close(got[k], w, rtol=0, atol=atol, msg=k)
    assert int(got["blocks.0.bn0.num_batches_tracked"]) == 1
    for k, p in ref_model.named_parameters():
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(grads[k], p.grad, rtol=0,
                                   atol=1e-4 * scale, msg=k)


def test_forms_equal_with_dropout(train_case, monkeypatch):
    """Two steps with dropout 0.3: the streams route and the serial form
    draw the same masks and give the same losses, state and gradients, bit
    for bit."""
    serial = _run(train_case, "serial", steps=2, dropout=0.3)
    streams = _run(train_case, "streams", _FakeCuda(monkeypatch), steps=2,
                   dropout=0.3)
    clean = _run(train_case, "serial", steps=2, dropout=0.0)
    assert [float(v) for v in streams[0]] == [float(v) for v in serial[0]]
    assert float(serial[0][0]) != float(clean[0][0])   # dropout did act
    for a, b in ((streams[1], serial[1]), (streams[2], serial[2])):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _streams_log(s, monkeypatch, steps=2):
    fake = _FakeCuda(monkeypatch)
    _run(s, "streams", fake, steps=steps, dropout=0.3)
    return fake


def test_position_ops_on_their_streams(train_case, monkeypatch):
    fake = _streams_log(train_case, monkeypatch)
    ops = [e for e in fake.log if e[0] == "op"]
    by_stream = collections.defaultdict(collections.Counter)
    for _, s, name, dev, *_ in ops:
        by_stream[s][name] += 1
        assert dev == torch.device("cpu"), (name, dev)
    positions = {f"position{i}" for i in range(1, 9)}
    assert set(by_stream) == positions | {"caller"}
    for name in ("conv2d", "conv_transpose2d", "relu", "dropout", "softmax",
                 "log", "rsqrt", "max_pool2d"):
        assert by_stream["caller"][name] == 0, (name, by_stream["caller"])
    # every position ran convs; the split convs on all eight, the head
    # (two classes over four model positions: replicated) on the first
    # of each row only, and the cross-entropy on the first of each row
    convs = {s: c["conv2d"] for s, c in by_stream.items() if s in positions}
    assert min(convs.values()) > 0 and len(set(convs.values())) == 2, convs
    logs = sorted(c["log"] for s, c in by_stream.items() if s in positions)
    assert logs == [0] * 6 + [2] * 2, logs   # two steps, rows 0 and 1
    # the gathers and the loss sum on the caller's stream
    assert by_stream["caller"]["cat"] > 0 and by_stream["caller"]["add"] > 0
    backward = [e for e in ops if e[2] == "backward"]
    assert [e[1] for e in backward] == ["caller", "caller"]


def test_every_hand_over_waits_on_an_event(train_case, monkeypatch):
    """Two steps, so that the second reads on the position streams what
    the first's Adam step and running statistics wrote."""
    log = _streams_log(train_case, monkeypatch).log
    issued = check_hand_overs(log)
    assert len(issued) == 9 and all(n > 0 for n in issued.values()), issued
    # each wait is on an event recorded on another stream
    waits = [e for e in log if e[0] == "wait"]
    assert waits and all(e[2].stream is not None and e[2].stream.name != e[1]
                         for e in waits)
    assert any(e[0] == "record_stream" for e in log)


def test_hand_over_check_catches_a_missing_wait(train_case, monkeypatch):
    """The check is not vacuous: the same log without the waits of the
    runner's fork (a position's stream on the caller's) fails it."""
    log = _streams_log(train_case, monkeypatch, steps=1).log
    forks = [e for e in log if e[0] == "wait" and e[1] != "caller"]
    assert forks
    cut = [e for e in log if not any(e is f for f in forks)]
    with pytest.raises(AssertionError, match="without a wait"):
        check_hand_overs(cut)


# --- on the card -------------------------------------------------------------

def _card_case(n=2, side=32):
    rng = np.random.default_rng(0)
    x = rng.random((n, side, side, 2)).astype(np.float32)
    y_cls = (rng.random((n, side, side)) > 0.5).astype(np.float32)
    return x, np.stack([y_cls, 1 - y_cls], -1)


def _card_steps(dtype, form, x, y, cards, filters=8):
    """``steps(n) -> loss`` (n steps, the loss left on the card) of the
    sharded step in ``form`` on a (2 x 2) mesh of ``cards`` (None: the
    unsharded step on ``cards[0]``), and ``result()`` -> (loss, gradients,
    state_dict, mesh) after them."""
    net = UNet(depth=2, base_filters=filters, dropout_rate=0.0, dtype=dtype)
    state, tx = ttrain.create_train_state(net, x.shape[1:], LR, seed=0,
                                          device=cards[0])
    if dtype == torch.float64:
        net.double()
    out = {}
    if form is None:
        step = ttrain.make_train_step(net, tx)

        def steps(n):
            for _ in range(n):
                out["loss"] = step(state, x, y)[1]
            return out["loss"]

        def result():
            return (float(out["loss"]),
                    {k: p.grad for k, p in net.named_parameters()},
                    net.state_dict(), None)
        return steps, result
    mesh = tmesh.Mesh(tmesh._object_array(cards, (2, 2)), ("data", "model"),
                      _form=form)
    sstate = tmesh.shard_params(mesh, state)
    step = tmesh.unet_train_step_sharded(mesh, net, sstate.optimizer)
    xs = tmesh.shard_batch(mesh, x)

    def steps(n):
        for _ in range(n):
            out["loss"] = step(sstate, xs, y)[1]
        return out["loss"]

    def result():
        return (float(out["loss"]), _grads(sstate.model),
                sstate.model.state_dict(), mesh)
    return steps, result


@pytest.mark.cuda
@pytest.mark.parametrize("form", tmesh.FORMS)
def test_float64_step_on_card(form):
    """A 4-position virtual mesh of the card in float64: the step within
    the CPU tests' tolerances of the unsharded step, each gradient to 1e-4
    of its largest magnitude; the streams form on four streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y = _card_case()
    cards = [torch.device("cuda")] * 4
    runs = []
    for f in (form, None):
        steps, result = _card_steps(torch.float64, f, x, y, cards)
        steps(1)
        runs.append(result())
    got, want = runs
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    for k, g in want[1].items():
        scale = float(g.abs().max())
        torch.testing.assert_close(got[1][k], g, rtol=0, atol=1e-4 * scale,
                                   msg=k)
    for k, v in want[2].items():
        if "num_batches" not in k:
            atol = 1e-6 if "running" in k else 2 * LR
            torch.testing.assert_close(got[2][k], v, rtol=0, atol=atol, msg=k)
    streams = {s.cuda_stream for s in got[3]._streams.values()}
    assert len(streams) == (4 if form == "streams" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", tmesh.FORMS)
def test_bfloat16_steps_make_no_host_sync(form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y = _card_case(n=4)
    cards = [torch.device("cuda")] * 4
    steps, _ = _card_steps(torch.bfloat16, form, x, y, cards)
    steps(1)   # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = steps(3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(loss))
