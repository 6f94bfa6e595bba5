"""Cellpose v2 (Stringer et al., Nat. Methods 18:100-106, 2021) as a
segmenter of the port: its network ``CPnet`` and the ``eval`` path that
turns frames into flows.

``CPnet`` keeps the module tree and names of Cellpose v2's
``resnet_torch.py``, so the ``state_dict`` of a v2 ``cyto``/``cyto2``/
``cyto3`` file loads with ``strict=True`` (the non-trainable ``diam_mean``
and ``diam_labels`` included). Every block is a pre-activation residual
pair (BatchNorm -> ReLU -> conv, 1x1 projections), skips are added, the
decoder upsamples by nearest neighbour and takes the tile's style (the
L2-normalised mean of the deepest features) through a ``Linear`` in every
up block. The output is (dY, dX, cellprob).

:class:`CellposePredictor` runs v2's ``eval`` with ``resample=True``,
``tile=True``, ``augment=False``:

1. the channels reordered to (cytoplasm / membrane, nucleus);
2. each channel scaled by its 1-99 percentiles (v2's ``normalize99``, not
   clipped; a channel whose percentiles lie within 1e-3 becomes 0);
3. resized by ``diam_mean / diameter`` (bilinear, ``align_corners=False``:
   v2 uses cv2's ``INTER_LINEAR``);
4. zero-padded on each side to a multiple of 16, split symmetrically (v2's
   ``pad_image_ND`` adds 8 more pixels a side);
5. cut into ``tile``-square tiles, ``ceil((1 + 2 overlap) L / tile)`` starts
   a side spaced by ``linspace(0, L - tile, n)`` truncated;
6. the forward of every tile of ``batch`` frames at once, in bfloat16
   and channels-last memory (v2 computes in float32);
7. the tiles blended with v2's taper mask over the summed mask
   (:class:`TileBlend`), unpadded and resized back to the frame.

``ops/flows.py`` turns the flows into masks.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tissue_image_processing_tpu_torch._device import count, resolve_device
from tissue_image_processing_tpu_torch.ops.percentile import percentile

__all__ = ["CPnet", "TileBlend", "CellposeRunner", "CellposePredictor",
           "tile_geometry", "normalize99", "NBASE", "DIAM_MEAN",
           "BATCH"]

NBASE = (2, 32, 64, 128, 256)
DIAM_MEAN = 30.0
# frames a forward: 98 tiles of 224^2 at a 2000^2 frame and diameter 48
BATCH = 2


def batchconv(cin: int, cout: int, sz: int) -> nn.Sequential:
    return nn.Sequential(nn.BatchNorm2d(cin, eps=1e-5), nn.ReLU(inplace=True),
                         nn.Conv2d(cin, cout, sz, padding=sz // 2))


def batchconv0(cin: int, cout: int, sz: int) -> nn.Sequential:
    return nn.Sequential(nn.BatchNorm2d(cin, eps=1e-5),
                         nn.Conv2d(cin, cout, sz, padding=sz // 2))


class resdown(nn.Module):
    def __init__(self, cin: int, cout: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential()
        self.proj = batchconv0(cin, cout, 1)
        for t in range(4):
            self.conv.add_module(f"conv_{t}", batchconv(cin if t == 0 else cout,
                                                        cout, sz))

    def forward(self, x):
        x = self.proj(x) + self.conv[1](self.conv[0](x))
        return x + self.conv[3](self.conv[2](x))


class downsample(nn.Module):
    def __init__(self, nbase: Sequence[int], sz: int):
        super().__init__()
        self.down = nn.Sequential()
        self.maxpool = nn.MaxPool2d(2, 2)
        for n in range(len(nbase) - 1):
            self.down.add_module(f"res_down_{n}",
                                 resdown(nbase[n], nbase[n + 1], sz))

    def forward(self, x):
        xd = []
        for n in range(len(self.down)):
            xd.append(self.down[n](self.maxpool(xd[n - 1]) if n else x))
        return xd


class batchconvstyle(nn.Module):
    def __init__(self, cin: int, cout: int, style_channels: int, sz: int):
        super().__init__()
        self.conv = batchconv(cin, cout, sz)
        self.full = nn.Linear(style_channels, cout)

    def forward(self, style, x, y=None):
        if y is not None:
            x = x + y
        feat = self.full(style)
        return self.conv(x + feat[:, :, None, None])


class resup(nn.Module):
    def __init__(self, cin: int, cout: int, style_channels: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential()
        self.conv.add_module("conv_0", batchconv(cin, cout, sz))
        for t in (1, 2, 3):
            self.conv.add_module(f"conv_{t}", batchconvstyle(
                cout, cout, style_channels, sz))
        self.proj = batchconv0(cin, cout, 1)

    def forward(self, x, y, style):
        x = self.proj(x) + self.conv[1](style, self.conv[0](x), y=y)
        return x + self.conv[3](style, self.conv[2](style, x))


class make_style(nn.Module):
    def forward(self, x0):
        style = x0.mean(dim=(-2, -1))
        return style / torch.sum(style ** 2, dim=1, keepdim=True) ** .5


class upsample(nn.Module):
    def __init__(self, nbase: Sequence[int], sz: int):
        super().__init__()
        self.upsampling = nn.Upsample(scale_factor=2, mode="nearest")
        self.up = nn.Sequential()
        for n in range(1, len(nbase)):
            self.up.add_module(f"res_up_{n - 1}",
                               resup(nbase[n], nbase[n - 1], nbase[-1], sz))

    def forward(self, style, xd):
        x = self.up[-1](xd[-1], xd[-1], style)
        for n in range(len(self.up) - 2, -1, -1):
            x = self.up[n](self.upsampling(x), xd[n], style)
        return x


class CPnet(nn.Module):
    """Cellpose v2's network (``residual_on``, ``style_on``, no
    concatenation): (B, nbase[0], H, W) -> ((B, nout, H, W), (B, nbase[-1])
    styles); H and W divisible by 8."""

    def __init__(self, nbase: Sequence[int] = NBASE, nout: int = 3,
                 sz: int = 3, diam_mean: float = DIAM_MEAN):
        super().__init__()
        self.nbase, self.nout, self.sz = list(nbase), nout, sz
        self.downsample = downsample(self.nbase, sz)
        nbaseup = self.nbase[1:] + [self.nbase[-1]]
        self.upsample = upsample(nbaseup, sz)
        self.make_style = make_style()
        self.output = batchconv(nbaseup[0], nout, 1)
        self.diam_mean = nn.Parameter(torch.ones(1) * diam_mean,
                                      requires_grad=False)
        self.diam_labels = nn.Parameter(torch.ones(1) * diam_mean,
                                        requires_grad=False)

    def forward(self, data):
        xd = self.downsample(data)
        style = self.make_style(xd[-1])
        return self.output(self.upsample(style, xd)), style


def _taper_mask(ly: int, lx: int, sig: float = 7.5) -> np.ndarray:
    """v2's ``_taper_mask``: 1 / (1 + exp((|i - mean| - (b/2 - 20)) / sig))
    along each axis of a b = max(224, ly, lx) square, their outer product,
    its centre (ly, lx) crop; float32."""
    bsize = max(224, ly, lx)
    xm = np.arange(bsize)
    xm = np.abs(xm - xm.mean())
    mask = 1 / (1 + np.exp((xm - (bsize / 2 - 20)) / sig))
    mask = mask * mask[:, np.newaxis]
    mask = mask[bsize // 2 - ly // 2: bsize // 2 + ly // 2 + ly % 2,
                bsize // 2 - lx // 2: bsize // 2 + lx // 2 + lx % 2]
    return mask.astype(np.float32)


def _starts(L: int, b: int, overlap: float) -> np.ndarray:
    """v2's ``make_tiles`` starts along a side of L pixels with tiles of
    b = min(tile, L)."""
    n = 1 if L <= b else int(math.ceil((1.0 + 2 * overlap) * L / b))
    return np.linspace(0, L - b, n).astype(int)


def tile_geometry(Y: int, X: int, diameter: float, diam_mean: float,
                  tile: int = 224, overlap: float = 0.1) -> dict:
    """Sizes of the eval path for a (Y, X) frame: the resized frame
    (``ly``, ``lx``), its padding (``pad`` = (top, bottom, left, right)),
    the padded sides, the tile sides and their starts (host values: they
    depend on the shape alone)."""
    rescale = float(diam_mean) / float(diameter)
    ly, lx = (Y, X) if rescale == 1.0 else (int(Y * rescale), int(X * rescale))
    pads = []
    for L in (ly, lx):
        extra = int(16 * math.ceil(L / 16) - L)
        pads += [extra // 2, extra - extra // 2]
    LY, LX = ly + pads[0] + pads[1], lx + pads[2] + pads[3]
    overlap = min(0.5, max(0.05, overlap))
    by, bx = min(tile, LY), min(tile, LX)
    return {"frame": (Y, X), "resized": (ly, lx), "pad": tuple(pads),
            "padded": (LY, LX), "tile": (by, bx),
            "ys": _starts(LY, by, overlap), "xs": _starts(LX, bx, overlap)}


def normalize99(img: torch.Tensor) -> torch.Tensor:
    """(Y, X) -> float32 (x - p1) / (p99 - p1), with numpy's percentiles;
    0 where p99 - p1 <= 1e-3 (v2's ``normalize_img``)."""
    img = img.to(torch.float32)
    p1, p99 = percentile(img, 1.0), percentile(img, 99.0)
    return torch.where(p99 - p1 > 1e-3, (img - p1) / (p99 - p1), 0.0)


class TileBlend(nn.Module):
    """(n_frames * n_tiles, C, by, bx) network outputs -> (n_frames, C, Y,
    X) float32 frames: each tile times the taper mask added at its place in
    row-major tile order, over the summed mask, unpadded and resized back
    to the frame. A module so that a forward hook can read the frames."""

    def __init__(self, geom: Mapping, device: torch.device):
        super().__init__()
        self.geom = geom
        by, bx = geom["tile"]
        mask = torch.from_numpy(_taper_mask(by, bx)).to(device)
        self.register_buffer("mask", mask, persistent=False)
        navg = torch.zeros(geom["padded"], dtype=torch.float32, device=device)
        for y0 in geom["ys"]:
            for x0 in geom["xs"]:
                navg[y0:y0 + by, x0:x0 + bx] += mask
        self.register_buffer("navg", navg, persistent=False)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        g = self.geom
        by, bx = g["tile"]
        ny, nx = len(g["ys"]), len(g["xs"])
        y = (y.to(torch.float32) * self.mask).reshape(-1, ny, nx, y.shape[1],
                                                      by, bx)
        out = torch.zeros((y.shape[0], y.shape[3]) + tuple(g["padded"]),
                          dtype=torch.float32, device=y.device)
        for j, y0 in enumerate(g["ys"]):
            for i, x0 in enumerate(g["xs"]):
                out[:, :, y0:y0 + by, x0:x0 + bx] += y[:, j, i]
        out = out / self.navg
        (ly, lx), (t, _, l, _) = g["resized"], g["pad"]
        out = out[:, :, t:t + ly, l:l + lx]
        if (ly, lx) != tuple(g["frame"]):
            out = F.interpolate(out, size=tuple(g["frame"]), mode="bilinear",
                                align_corners=False)
        return out


class CellposeRunner:
    """The eval path of one :meth:`CellposePredictor.pipeline_config` dict
    on a device, in three calls the pipeline times apart: :meth:`tiles`
    (normalise, resize, pad, cut), :meth:`forward` (the network alone) and
    :meth:`blend`."""

    def __init__(self, config: Mapping, device: torch.device):
        params = config["params"]
        self.device, self.dtype = device, torch.bfloat16
        nbase = list(config.get("nbase", NBASE))
        with torch.device(device):
            net = CPnet(nbase, config.get("nout", 3), config.get("sz", 3))
        net.load_state_dict(params, strict=True)
        self.diam_mean = float(net.diam_mean.detach().float().cpu()[0])
        # channels-last: cuDNN's tensor-core convs take NHWC without
        # transposing (12% less forward time on an H100 at 98 tiles)
        self.net = net.to(dtype=self.dtype, memory_format=torch.channels_last
                          ).eval().requires_grad_(False)
        self.diameter = float(config.get("diameter") or self.diam_mean)
        self.tile = int(config.get("tile", 224))
        self.overlap = float(config.get("tile_overlap", 0.1))
        self.channels = list(config.get("channels", (0, 1)))
        self.batch = int(config.get("batch", BATCH))
        self.niter = int(config.get("niter", 200))
        self.cellprob_threshold = float(config.get("cellprob_threshold", 0.0))
        self.flow_threshold = float(config.get("flow_threshold", 0.4))
        self.min_size = int(config.get("min_size", 15))
        self._blends = {}

    def blender(self, Y: int, X: int) -> TileBlend:
        key = (Y, X)
        if key not in self._blends:
            self._blends[key] = TileBlend(tile_geometry(
                Y, X, self.diameter, self.diam_mean, self.tile, self.overlap),
                self.device)
        return self._blends[key]

    def tiles(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, C, Y, X) frames -> (B * n_tiles, 2, by, bx) network input in
        the network's dtype; adds the tiles to ``COUNTS["cp_tiles"]``."""
        B, _, Y, X = frames.shape
        g = self.blender(Y, X).geom
        img = torch.stack([torch.stack([normalize99(f[c])
                                        for c in self.channels])
                           for f in frames])
        if tuple(g["resized"]) != (Y, X):
            img = F.interpolate(img, size=tuple(g["resized"]),
                                mode="bilinear", align_corners=False)
        t, b, l, r = g["pad"]
        img = F.pad(img, (l, r, t, b))
        by, bx = g["tile"]
        dev = img.device
        rows = (torch.as_tensor(g["ys"], device=dev)[:, None]
                + torch.arange(by, device=dev))
        cols = (torch.as_tensor(g["xs"], device=dev)[:, None]
                + torch.arange(bx, device=dev))
        tl = img[:, :, rows][..., cols]              # (B, C, ny, by, nx, bx)
        tl = tl.permute(0, 2, 4, 1, 3, 5).reshape(-1, img.shape[1], by, bx)
        count("cp_tiles", tl.shape[0])
        return tl.to(self.dtype).contiguous(memory_format=torch.channels_last)

    def forward(self, tiles: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.net(tiles)[0]

    def blend(self, y: torch.Tensor, Y: int, X: int) -> torch.Tensor:
        """Network outputs of whole frames -> (B, 3, Y, X) float32 (dY, dX,
        cellprob)."""
        with torch.no_grad():
            return self.blender(Y, X)(y)


def _load_state(weights) -> Mapping:
    if isinstance(weights, Mapping):
        return weights
    state = torch.load(weights, map_location="cpu", weights_only=True)
    if not isinstance(state, Mapping):
        raise ValueError(f"{weights}: not a state_dict")
    return state


class CellposePredictor:
    """A Cellpose v2 model for the port: ``weights`` a v2 ``cyto*``
    ``state_dict`` file (or the dict itself), loaded strictly; without
    weights a ``CPnet`` drawn from seed 0. ``diameter`` is the cells'
    diameter in pixels (None: the model's ``diam_mean``); ``channels`` the
    frame's (membrane, nucleus) channel indices. ``device=None`` is the
    card."""

    def __init__(self, weights=None, diameter: Optional[float] = None,
                 channels: Sequence[int] = (0, 1), tile: int = 224,
                 tile_overlap: float = 0.1, batch: int = BATCH,
                 niter: int = 200,
                 cellprob_threshold: float = 0.0, flow_threshold: float = 0.4,
                 min_size: int = 15, device=None):
        self.device = resolve_device(device)
        if weights is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                state = CPnet().state_dict()
        else:
            state = dict(_load_state(weights))
        self.config = {"params": state, "nbase": list(NBASE), "nout": 3,
                       "sz": 3, "diameter": diameter, "tile": tile,
                       "tile_overlap": tile_overlap,
                       "channels": list(channels), "batch": batch,
                       "niter": niter,
                       "cellprob_threshold": cellprob_threshold,
                       "flow_threshold": flow_threshold, "min_size": min_size}
        # loads the weights strictly, on the device the pipeline will use
        self.runner = CellposeRunner(self.config, self.device)

    def pipeline_config(self) -> dict:
        """Package this model for ``movie_pipeline(cellpose=...)``."""
        return dict(self.config)
