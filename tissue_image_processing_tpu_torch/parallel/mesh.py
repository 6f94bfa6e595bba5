"""Device mesh, collectives and the tensor-parallel U-Net training step.

Port of ``tissue_image_processing_tpu/parallel/mesh.py``. The JAX package is
single-controller: one Python process runs ``shard_map`` over an array of
devices. The port keeps that design with ``torch.device``s instead of
``torch.distributed`` process groups: NCCL cannot place two ranks on one
card, and one process can drive every card of a host. So

- a :class:`Mesh` is a numpy object array of ``torch.device``s with axis
  names. ``devices=None`` means the visible CUDA cards; a virtual mesh
  repeats one device (``[torch.device("cuda")] * 4`` on one card,
  ``[torch.device("cpu")] * 8`` in the tests);
- a sharded value is a list of per-shard tensors, one per position along a
  mesh axis, each on its position's device;
- the collectives (:func:`ppermute`, :func:`all_gather`, :func:`psum`) are
  explicit ``.to(device)`` copies (non-blocking onto a card) plus
  ``torch.cat`` or a sum, made once per distinct device. None reads a value
  back to the host;
- shard bodies run through :meth:`Mesh.run`, in the calling thread: on
  the card each position has a CUDA stream of its own on its device (a
  virtual mesh on one card gets one stream a position, so its positions
  overlap as separate cards would); on the CPU the positions run in
  order. A shard body makes no host synchronisation, so the calling thread
  queues every position's body without waiting for the card. The
  training step's per-position work (a conv with what follows it, the
  BatchNorm sums, the normalisation, dropout, the cross-entropy) runs
  through the runner too, one call a layer.

The runner is fork-join on the device. At entry each position's stream
waits on an event recorded on the caller's current stream of its device;
at exit the caller's stream waits on an event recorded on each position's
stream. The collectives run between runner calls, on the caller's streams,
so every hand-over between a producer's stream and a consumer's goes
through one of those events; that holds on a virtual mesh too, where
``_move`` hands the same tensor to another stream. A tensor that crosses
the runner's boundary, in or out, is ``record_stream``-ed on the stream
that uses it, so the caching allocator does not reuse its memory early.

The backward pass needs no runner: PyTorch runs each backward op on the
stream of its forward op, syncs the gradients that cross streams, and at
the end makes the caller's streams wait for the gradients, since
``loss.backward()`` is called on the caller's stream of the lead device.
So the optimizer's step, on the caller's streams, reads finished
gradients without a host synchronisation.

Axes as in the JAX package: ``data`` (frames / batch) and ``model`` (the
U-Net's conv output channels). :func:`unet_train_step_sharded` is data
parallel over ``data`` and tensor parallel over ``model``: each conv's output
channels are computed on their ``model`` shard and the activations gathered
over ``model`` before the next conv, BatchNorm statistics are taken over the
global batch (reduced over ``data``, as GSPMD's global program computes
them) and autograd sums each parameter's gradient over ``data`` through the
copies.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tissue_image_processing_tpu_torch._device import (
    host_to_device, resolve_device)
from tissue_image_processing_tpu_torch.models.train import TrainState
from tissue_image_processing_tpu_torch.models.unet import (
    _conv, _full_float32_convs)

__all__ = ["Mesh", "make_mesh", "shard_batch", "shard_params",
           "unet_train_step_sharded", "ShardedParams", "ppermute",
           "all_gather", "psum", "axis_index"]


FORMS = ("streams", "serial")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device`` with one axis per name in ``axis_names``.

    ``_form`` says how :meth:`run` runs the positions on the card:
    ``"streams"`` (a stream a position) or ``"serial"`` (the caller's
    stream), which exists to compare the two in one process
    (``dataclasses.replace(mesh, _form="serial")``)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    _form: str = dataclasses.field(default="streams", repr=False)
    # position index -> its CUDA stream, made at the position's first run
    _streams: Dict[Tuple[int, ...], "torch.cuda.Stream"] = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False)

    def __post_init__(self):
        if self._form not in FORMS:
            raise ValueError(f"Mesh form {self._form!r} not in {FORMS}")

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """The device of the first position, where replicated results land."""
        return self.devices.flat[0]

    def _stream(self, pos: Tuple[int, ...]) -> "torch.cuda.Stream":
        stream = self._streams.get(pos)
        if stream is None:
            stream = self._streams[pos] = torch.cuda.Stream(
                device=self.devices[pos])
        return stream

    def _streamed(self, devs) -> bool:
        """Whether :meth:`run` gives the positions on ``devs`` streams of
        their own: in the ``"streams"`` form, on cards."""
        return self._form == "streams" and all(d.type == "cuda" for d in devs)

    def run(self, fn, *args, positions=None) -> list:
        """``[fn(*a) for a in zip(*args)]``: ``fn`` once for each position of
        ``positions`` (index tuples of ``devices``; default every position,
        in order), given that position's element of each sequence in
        ``args``. Returns the results in position order.

        The calls run in the calling thread, in order. On a card each runs
        under ``torch.cuda.device`` and ``torch.cuda.stream`` of its
        position's device and stream, fork-join against the caller's
        streams (see the module docstring); on the CPU, and in the
        ``"serial"`` form, on the caller's streams. An exception in a
        position is raised here with a note naming the position."""
        if positions is None:
            positions = list(np.ndindex(self.devices.shape))
        per_pos = list(zip(*args)) if args else [()] * len(positions)
        if len(per_pos) != len(positions):
            raise ValueError(f"{len(per_pos)} argument sets for "
                             f"{len(positions)} mesh positions")
        devs = [self.devices[p] for p in positions]
        if not self._streamed(devs):
            return [_call(pos, fn, a) for pos, a in zip(positions, per_pos)]
        streams = [self._stream(p) for p in positions]
        for dev, stream, a in zip(devs, streams, per_pos):
            stream.wait_stream(torch.cuda.current_stream(dev))
            _record_on(a, stream)
        results = []
        for pos, dev, stream, a in zip(positions, devs, streams, per_pos):
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                results.append(_call(pos, fn, a))
        for dev, stream, out in zip(devs, streams, results):
            caller = torch.cuda.current_stream(dev)
            caller.wait_stream(stream)
            _record_on(out, caller)
        return results


def _call(pos, fn, args):
    """``fn(*args)`` in the calling thread, an exception naming ``pos``."""
    try:
        return fn(*args)
    except Exception as exc:
        exc.add_note(f"raised in mesh position {pos}")
        raise


def _record_on(obj, stream: "torch.cuda.Stream") -> None:
    """``record_stream(stream)`` on each card tensor of ``obj`` (a tensor
    or nested tuples / lists of them) on ``stream``'s device."""
    if isinstance(obj, torch.Tensor):
        if obj.device == stream.device:
            obj.record_stream(stream)
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            _record_on(item, stream)


def _mesh_devices(n_devices: Optional[int], devices, what: str
                  ) -> List[torch.device]:
    """The first ``n_devices`` of ``devices`` (None: the visible CUDA
    cards; raises without one, as every entry point of the port does)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    # a tensor's device always carries its index: "cuda" becomes the
    # current card's "cuda:i", so a mesh device keys a shard's device
    devices = [torch.device("cuda", torch.cuda.current_device())
               if torch.device(d) == torch.device("cuda") else torch.device(d)
               for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"requested a {n}-device {what} but only {len(devices)} device(s) "
            f"are given or visible; for a virtual mesh pass devices= with a "
            f"device repeated, e.g. devices=[torch.device('cuda')] * {n}")
    return devices[:n]


def _object_array(items: Sequence, shape) -> np.ndarray:
    """``items`` (devices or tensors) as a numpy object array of ``shape``,
    each stored as it is (numpy would unpack a list of tensors)."""
    arr = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        arr[i] = item
    return arr.reshape(shape)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("data", "model"),
              devices=None) -> Mesh:
    """A (data x model) mesh over the first ``n_devices`` of ``devices``
    (None: the visible CUDA cards). The model axis gets the largest of 4
    and 2 that divides the count (else 1); the rest is data."""
    devs = _mesh_devices(n_devices, devices, "mesh")
    n = len(devs)
    model = next((c for c in (4, 2) if n % c == 0), 1)
    return Mesh(_object_array(devs, (n // model, model)), tuple(axis_names))


def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: asynchronous onto a card (stream-ordered), a
    plain copy onto the CPU, which must not read a copy still in flight."""
    return t.to(device, non_blocking=device.type == "cuda")


def ppermute(shards: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``out[dst] = shards[src]`` for each (src, dst) of ``perm``, on the
    destination's device; a position that receives nothing gets zeros
    (``jax.lax.ppermute``)."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for src, dst in perm:
        out[dst] = _move(shards[src], shards[dst].device)
    return [torch.zeros_like(s) if o is None else o
            for s, o in zip(shards, out)]


def _per_device(shards: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
    """``fn(device)`` for the device of each shard, computed once per
    distinct device (a virtual mesh shares one result)."""
    done: Dict[torch.device, torch.Tensor] = {}
    for s in shards:
        if s.device not in done:
            done[s.device] = fn(s.device)
    return [done[s.device] for s in shards]


def all_gather(shards: Sequence[torch.Tensor], axis: int = 0,
               tiled: bool = True) -> List[torch.Tensor]:
    """Every shard, joined along ``axis`` (``tiled``) or stacked on a new
    leading axis, on each shard's device (``jax.lax.all_gather``)."""
    join = torch.cat if tiled else torch.stack
    return _per_device(shards, lambda dev: join(
        [_move(s, dev) for s in shards], axis if tiled else 0))


def psum(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards in position order, on each shard's device
    (``jax.lax.psum``)."""
    def total(dev):
        out = _move(shards[0], dev)
        for s in shards[1:]:
            out = out + _move(s, dev)
        return out
    return _per_device(shards, total)


def axis_index(mesh: Mesh, axis_name: str, position: Tuple[int, ...]) -> int:
    """The coordinate along ``axis_name`` of the mesh ``position`` (an index
    tuple of ``mesh.devices``), ``jax.lax.axis_index`` of a shard body."""
    return position[mesh.axis_names.index(axis_name)]


def shard_batch(mesh: Mesh, batch) -> List[torch.Tensor]:
    """A (B, ...) batch (numpy or tensor) split along B over the ``data``
    axis: one slice per data position, on that row's first device. A host
    batch goes onto a card through pinned memory, on the caller's stream,
    so the upload makes no host synchronisation."""
    t = torch.as_tensor(batch)
    rows = mesh.devices.shape[mesh.axis_names.index("data")]
    if t.shape[0] % rows:
        raise ValueError(f"batch {t.shape[0]} does not divide over the mesh's "
                         f"data axis {rows}")
    move = host_to_device if t.device.type == "cpu" else _move
    return [move(s, mesh.devices[d, 0]) for d, s in
            enumerate(torch.chunk(t, rows, 0))]


def _param_spec(layer: type, leaf: str, shape) -> Optional[int]:
    """The dim of tensor ``leaf`` of a ``layer`` holding its output channels,
    which the JAX package shards over ``model`` (the last axis of an HWIO
    kernel, and every 1-D bias, scale, shift and BatchNorm statistic), or
    None (replicated). By layer type: output channels are dim 0 of a
    ``Conv2d`` weight but dim 1 of a ``ConvTranspose2d`` weight."""
    if leaf == "weight" and issubclass(layer, nn.ConvTranspose2d):
        return 1
    if leaf == "weight" and issubclass(layer, nn.Conv2d):
        return 0
    return 0 if len(shape) == 1 else None


@dataclasses.dataclass
class ShardedParams:
    """A U-Net's ``state_dict`` laid out over a mesh: ``specs[key]`` is the
    dim split over ``model`` (None: replicated) and ``shards[key]`` the
    pieces, one per model position (one when replicated), each on the
    first data row's device of its position. Parameters are leaves that
    require grad; :meth:`parameters` feeds an optimizer."""

    mesh: Mesh
    specs: Dict[str, Optional[int]]
    shards: Dict[str, List[torch.Tensor]]

    def parameters(self) -> List[torch.Tensor]:
        return [s for pieces in self.shards.values() for s in pieces
                if s.requires_grad]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole tensors, joined on the mesh's lead device."""
        lead = self.mesh.lead
        return {k: (_move(p[0], lead) if self.specs[k] is None else
                    torch.cat([_move(s, lead) for s in p], self.specs[k])
                    ).detach()
                for k, p in self.shards.items()}


def _split(t: torch.Tensor, dim: Optional[int], mesh: Mesh,
           grad: bool) -> List[torch.Tensor]:
    """Own copies of ``t``'s pieces along ``dim`` (the whole of it when
    None), piece m on the first data row's device of model position m."""
    devs = mesh.devices[0]
    pieces = [t] if dim is None else torch.chunk(t, len(devs), dim)
    return [_move(p.detach(), devs[m]).clone(
        memory_format=torch.contiguous_format).requires_grad_(grad)
        for m, p in enumerate(pieces)]


def shard_params(mesh: Mesh, module_or_state):
    """Lay a ``UNet`` out over ``mesh`` as a :class:`ShardedParams`: each
    tensor's output-channel dim (:func:`_param_spec`, by the type of the
    layer that owns it) is split over ``model`` when its size divides the
    axis, else the tensor is replicated. Given a ``models.train.TrainState``,
    returns a new one whose ``model`` is the :class:`ShardedParams` and
    whose optimizer (same class and hyperparameters) holds the parameters'
    shards, each Adam moment split as its parameter."""
    if isinstance(module_or_state, TrainState):
        return _shard_train_state(mesh, module_or_state)
    module, model = module_or_state, mesh.shape["model"]
    params = {n for n, _ in module.named_parameters()}
    specs, shards = {}, {}
    for k, t in module.state_dict().items():
        owner, _, leaf = k.rpartition(".")
        dim = _param_spec(type(module.get_submodule(owner)), leaf,
                          tuple(t.shape))
        if dim is not None and t.shape[dim] % model:
            dim = None
        specs[k] = dim
        shards[k] = _split(t, dim, mesh, k in params)
    return ShardedParams(mesh, specs, shards)


def _shard_train_state(mesh: Mesh, state: TrainState) -> TrainState:
    sharded = shard_params(mesh, state.model)
    old = state.optimizer
    tx = type(old)(sharded.parameters(), **old.defaults)
    named = dict(state.model.named_parameters())
    for k, pieces in sharded.shards.items():
        src = old.state.get(named[k]) if k in named else None
        if not src:
            continue
        split = {name: ([v.clone() for _ in pieces] if v.dim() == 0 else
                        _split(v, sharded.specs[k], mesh, False))
                 for name, v in src.items()}
        for m, p in enumerate(pieces):
            tx.state[p] = {name: v[m] for name, v in split.items()}
    return TrainState(sharded, tx, state.step)


def _pieces(params: ShardedParams, key: str, d: int) -> List[torch.Tensor]:
    """The pieces of ``key`` for data row ``d``: each moved (through
    autograd) to row ``d``'s device of its model position, on the
    caller's streams; the runner hands them to the positions. A piece
    already there is viewed (an autograd node on the caller's stream), so
    every use of a parameter reaches its gradient's accumulation through
    the caller's stream, not through whichever position used it first."""
    out = []
    for m, p in enumerate(params.shards[key]):
        moved = _move(p, params.mesh.devices[d, m])
        out.append(moved.view_as(p) if moved is p else moved)
    return out


def _gathered(pieces: Sequence[torch.Tensor], devs) -> List[torch.Tensor]:
    """A channel-split activation (NCHW pieces) joined on every device of
    ``devs`` (one data row's model positions); a single piece is the whole
    activation already."""
    if len(pieces) == 1:
        return [_move(pieces[0], dev) for dev in devs]
    return all_gather(pieces, axis=1)


def _relu_and_sums(y: torch.Tensor):
    """ReLU of a conv piece and its per-channel sums of x and x^2 over
    (N, H, W): what training-mode BatchNorm reduces over ``data``."""
    y = torch.relu(y)
    return y, y.sum(dim=(0, 2, 3)), (y * y).sum(dim=(0, 2, 3))


class _TensorParallelUNet:
    """The training-mode forward of a ``UNet`` over a (data x model) mesh:
    ``acts[d][m]`` is data row ``d``'s activation on its model position
    ``m`` (whole when gathered, a channel piece when split).

    Each layer's per-position work runs in one :meth:`each` call (on the
    card, on the position's stream); the collectives between them
    (gathers, the BatchNorm and loss sums, the parameter pieces' moves)
    run on the caller's streams, so every hand-over goes through the
    runner's events."""

    def __init__(self, model: nn.Module, params: ShardedParams):
        if model.up_kind != "convt":
            raise ValueError("the sharded train step takes up_kind='convt'")
        self.model, self.params = model, params
        self.mesh = params.mesh
        self.rows = self.mesh.devices.shape[0]

    def each(self, fn, *grids) -> list:
        """``fn(d, m, *elements)`` at each position (d, m) of the ragged
        grid ``grids[0]`` (``grid[d][m]``; a row may hold one piece or one
        a model position), given that position's element of each grid,
        through :meth:`Mesh.run`. Returns the results as a grid."""
        positions = [(d, m) for d, row in enumerate(grids[0])
                     for m in range(len(row))]
        flat = self.mesh.run(
            fn, [d for d, _ in positions], [m for _, m in positions],
            *([g[d][m] for d, m in positions] for g in grids),
            positions=positions)
        out = [[] for _ in grids[0]]
        for (d, _), r in zip(positions, flat):
            out[d].append(r)
        return out

    def pieces(self, key: str) -> list:
        return [_pieces(self.params, key, d) for d in range(self.rows)]

    def conv(self, full, key: str, transpose: bool = False, then=None,
             extra=()):
        """``key``'s conv on each row's whole input: output channel piece m
        on model position m (one piece when replicated), then
        ``then(y, *e)`` in the same position body (``e``: the position's
        element of each grid of ``extra``)."""
        ws, bs = self.pieces(key + ".weight"), self.pieces(key + ".bias")
        dtype = self.model.dtype

        def body(d, m, x, w, b, *e):
            y = _conv(x, w, b, dtype, transpose=transpose)
            return y if then is None else then(y, *e)

        return self.each(body, [row[:len(w)] for row, w in zip(full, ws)],
                         ws, bs, *extra)

    def batch_norm(self, sums, key: str):
        """Training-mode BatchNorm of channel pieces over the GLOBAL batch,
        cast to the model's dtype: ``sums[d][m]`` is (piece, its sum, its
        sum of squares), the sums reduced over ``data``; the running
        statistics move as ``models/unet.py:_batch_norm_train`` moves
        them, on shard m's position of the first data row."""
        bn = self.model.get_submodule(key)
        count = sum(row[0][0].numel() // row[0][0].shape[1] for row in sums)
        totals = [[None] * len(row) for row in sums]
        for m in range(len(sums[0])):
            s1 = psum([row[m][1] for row in sums])
            s2 = psum([row[m][2] for row in sums])
            for d in range(self.rows):
                totals[d][m] = (s1[d], s2[d])

        def body(d, m, piece, total, w, b):
            y = piece[0]
            mean = total[0] / count
            var = (total[1] / count - mean * mean).clamp_min(0.0)
            if d == 0:
                self._update_running(key, m, mean, var, bn.momentum)
            scale = w * torch.rsqrt(var + bn.eps)
            return ((y - mean[None, :, None, None]) * scale[None, :, None, None]
                    + b[None, :, None, None]).to(self.model.dtype)

        return self.each(body, sums, totals, self.pieces(key + ".weight"),
                         self.pieces(key + ".bias"))

    def _update_running(self, key, m, mean, var, momentum):
        with torch.no_grad():
            for name, v in (("running_mean", mean), ("running_var", var)):
                buf = self.params.shards[f"{key}.{name}"][m]
                buf.mul_(1.0 - momentum).add_(momentum * _move(v, buf.device))
            if m == 0:
                self.params.shards[f"{key}.num_batches_tracked"][0].add_(1)

    def gather(self, pieces):
        return [_gathered(row, self.mesh.devices[d])
                for d, row in enumerate(pieces)]

    def double_conv(self, full, k: int):
        block, dtype = self.model.blocks[k], self.model.dtype
        for i in range(2):
            conv = f"blocks.{k}.conv{i}"
            if block.norm == "bn":
                y = self.batch_norm(self.conv(full, conv, then=_relu_and_sums),
                                    f"blocks.{k}.bn{i}")
            elif block.norm == "shift":
                y = self.conv(full, conv, then=lambda t, s: (
                    torch.relu(t) + s[None, :, None, None]).to(dtype),
                    extra=(self.pieces(f"blocks.{k}.shift{i}"),))
            else:
                y = self.conv(full, conv,
                              then=lambda t: torch.relu(t).to(dtype))
            if i == 0:
                full = self.gather(y)
        return y

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """(b, X, Y, C) inputs by data row -> (b, classes, X, Y) logits by
        data row, whole on each row's first device."""
        model = self.model
        drop = lambda t: F.dropout(t, model.dropout_rate, True)  # noqa: E731
        full = self.gather([[x.to(model.dtype).permute(0, 3, 1, 2)]
                            for x in xs])
        skips = []
        for k in range(model.depth):
            y = self.double_conv(full, k)
            skips.append(y)
            full = self.gather(self.each(
                lambda d, m, t: drop(F.max_pool2d(t, 2)), y))
        y = self.double_conv(full, model.depth)
        for j in range(model.depth):
            up = self.conv(self.gather(y), f"ups.{j}", transpose=True,
                           then=lambda t: drop(t.to(model.dtype)))
            skip = self.each(lambda d, m, t: drop(t), skips.pop())
            full = self.each(lambda d, m, u, s: torch.cat([u, s], 1),
                             self.gather(up), self.gather(skip))
            y = self.double_conv(full, model.depth + 1 + j)
        return [row[0] for row in self.gather(
            self.conv(self.gather(y), "head"))]


def unet_train_step_sharded(mesh: Mesh, model: nn.Module, tx):
    """A U-Net training step over ``mesh``: data parallel over ``data``,
    tensor parallel over ``model``. ``model`` is the ``UNet`` whose
    architecture (depth, dtype, norm, dropout rate) the step runs; ``tx``
    the optimizer over the :class:`ShardedParams`' parameters (as
    :func:`shard_params` of a ``TrainState`` builds it).

    ``step(state, batch_x, batch_y) -> (state, loss)``: ``state.model`` is
    the :class:`ShardedParams`, ``batch_x`` a (B, X, Y, C) batch or its
    :func:`shard_batch` slices, ``batch_y`` the (B, X, Y, 2) one-hot
    targets; loss = mean categorical cross-entropy with eps 1e-7 inside
    the log (on the lead device). Dropout draws from PyTorch's generator,
    the positions in the same order in both forms of the mesh, so both
    draw the same masks.

    On the card the step makes no host synchronisation: each position's
    forward runs on its stream (:meth:`Mesh.run`), the backward on the
    streams of the forward ops and the Adam step on the caller's streams
    (module docstring)."""
    def step(state, batch_x, batch_y):
        xs = (batch_x if isinstance(batch_x, (list, tuple))
              else shard_batch(mesh, torch.as_tensor(batch_x,
                                                     dtype=torch.float32)))
        ys = shard_batch(mesh, torch.as_tensor(batch_y, dtype=torch.float32))
        xs = [x.to(torch.float32) for x in xs]
        net = _TensorParallelUNet(model, state.model)
        tx.zero_grad(set_to_none=True)
        logits = net.forward(xs)
        n = sum(y.numel() // y.shape[-1] for y in ys)

        def cross_entropy(d, m, t, y):
            o = torch.softmax(t, dim=1).permute(0, 2, 3, 1)
            return -(y * torch.log(o + 1e-7)).sum()

        ce = net.each(cross_entropy, [[t] for t in logits], [[y] for y in ys])
        loss = psum([row[0] for row in ce])[0] / n
        # on the caller's stream of the lead device, after the sum: the
        # backward syncs the gradients with the caller's streams
        with _full_float32_convs(mesh.lead):
            loss.backward()
        tx.step()
        state.step += 1
        return state, loss.detach()

    return step
