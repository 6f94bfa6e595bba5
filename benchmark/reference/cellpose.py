"""Cellpose v2, plain: the network, its tiled ``eval`` path and
``compute_masks``, written from Cellpose v2's ``resnet_torch.py``,
``core.py``/``transforms.py`` (``make_tiles``, ``average_tiles``,
``_taper_mask``) and ``dynamics.py``/``metrics.py``/``utils.py``, with the
departures the configuration lists (bilinear resizes, padding to a multiple
of 16 without v2's extra 8 pixels, pixel-coordinate flow following with
every operation in float32, a fixed order for the diffusion's 9-term sum).
Imports nothing of the port: the network runs in float32 (TF32 off by the
caller), the steps on the host where v2 runs them there (numpy / scipy,
the per-seed growth and the per-mask hole filling loops) and on the device
where v2's GPU path does (the diffusion).

``lower`` rounds every conv's input through float8 e4m3: the control,
which ``prob_gap`` has to catch.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import scipy.ndimage as ndi
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.percentile import percentile

__all__ = ["CPnet", "eval_input", "reference_flows", "follow_flows",
           "get_masks", "masks_to_flows", "remove_bad_flow_masks",
           "fill_holes_and_remove_small_masks", "compute_masks",
           "reference_net", "reference_movie"]


class _Conv(nn.Conv2d):
    """A conv whose input is rounded through float8 e4m3 when ``lower``."""

    lower = False

    def forward(self, x):
        if _Conv.lower:
            x = x.to(torch.float8_e4m3fn).to(x.dtype)
        return super().forward(x)


def _bc(cin, cout, sz, relu=True):
    mods = [nn.BatchNorm2d(cin, eps=1e-5)]
    if relu:
        mods.append(nn.ReLU(inplace=True))
    mods.append(_Conv(cin, cout, sz, padding=sz // 2))
    return nn.Sequential(*mods)


class _ResDown(nn.Module):
    def __init__(self, cin, cout, sz):
        super().__init__()
        self.conv = nn.Sequential()
        self.proj = _bc(cin, cout, 1, relu=False)
        for t in range(4):
            self.conv.add_module("conv_%d" % t,
                                 _bc(cin if t == 0 else cout, cout, sz))

    def forward(self, x):
        x = self.proj(x) + self.conv[1](self.conv[0](x))
        x = x + self.conv[3](self.conv[2](x))
        return x


class _Down(nn.Module):
    def __init__(self, nbase, sz):
        super().__init__()
        self.down = nn.Sequential()
        self.maxpool = nn.MaxPool2d(2, 2)
        for n in range(len(nbase) - 1):
            self.down.add_module("res_down_%d" % n,
                                 _ResDown(nbase[n], nbase[n + 1], sz))

    def forward(self, x):
        xd = []
        for n in range(len(self.down)):
            y = self.maxpool(xd[n - 1]) if n > 0 else x
            xd.append(self.down[n](y))
        return xd


class _ConvStyle(nn.Module):
    def __init__(self, cin, cout, style_channels, sz):
        super().__init__()
        self.conv = _bc(cin, cout, sz)
        self.full = nn.Linear(style_channels, cout)

    def forward(self, style, x, y=None):
        if y is not None:
            x = x + y
        feat = self.full(style)
        y = x + feat.unsqueeze(-1).unsqueeze(-1)
        return self.conv(y)


class _ResUp(nn.Module):
    def __init__(self, cin, cout, style_channels, sz):
        super().__init__()
        self.conv = nn.Sequential()
        self.conv.add_module("conv_0", _bc(cin, cout, sz))
        self.conv.add_module("conv_1", _ConvStyle(cout, cout, style_channels, sz))
        self.conv.add_module("conv_2", _ConvStyle(cout, cout, style_channels, sz))
        self.conv.add_module("conv_3", _ConvStyle(cout, cout, style_channels, sz))
        self.proj = _bc(cin, cout, 1, relu=False)

    def forward(self, x, y, style):
        x = self.proj(x) + self.conv[1](style, self.conv[0](x), y=y)
        x = x + self.conv[3](style, self.conv[2](style, x))
        return x


class _Style(nn.Module):
    def forward(self, x0):
        style = F.avg_pool2d(x0, kernel_size=(x0.shape[-2], x0.shape[-1]))
        style = torch.flatten(style, 1)
        return style / torch.sum(style ** 2, axis=1, keepdim=True) ** .5


class _Up(nn.Module):
    def __init__(self, nbase, sz):
        super().__init__()
        self.upsampling = nn.Upsample(scale_factor=2, mode="nearest")
        self.up = nn.Sequential()
        for n in range(1, len(nbase)):
            self.up.add_module("res_up_%d" % (n - 1),
                               _ResUp(nbase[n], nbase[n - 1], nbase[-1], sz))

    def forward(self, style, xd):
        x = self.up[-1](xd[-1], xd[-1], style)
        for n in range(len(self.up) - 2, -1, -1):
            x = self.upsampling(x)
            x = self.up[n](x, xd[n], style)
        return x


class CPnet(nn.Module):
    """Cellpose v2's ``CPnet(nbase, nout, sz)`` (residual, style on, no
    concatenation) with its module names."""

    def __init__(self, nbase=(2, 32, 64, 128, 256), nout=3, sz=3,
                 diam_mean=30.0):
        super().__init__()
        nbase = list(nbase)
        self.downsample = _Down(nbase, sz)
        nbaseup = nbase[1:]
        nbaseup.append(nbaseup[-1])
        self.upsample = _Up(nbaseup, sz)
        self.make_style = _Style()
        self.output = _bc(nbaseup[0], nout, 1)
        self.diam_mean = nn.Parameter(torch.ones(1) * diam_mean,
                                      requires_grad=False)
        self.diam_labels = nn.Parameter(torch.ones(1) * diam_mean,
                                        requires_grad=False)

    def forward(self, data):
        T0 = self.downsample(data)
        style = self.make_style(T0[-1])
        T0 = self.upsample(style, T0)
        return self.output(T0), style


# --- eval: normalise, resize, pad, tile, forward, blend ----------------------

def _normalize(img: torch.Tensor) -> torch.Tensor:
    i1, i99 = percentile(img, 1.0), percentile(img, 99.0)
    return torch.where(i99 - i1 > 1e-3, (img - i1) / (i99 - i1), 0.0)


def _taper_mask(ly=224, lx=224, sig=7.5):
    bsize = max(224, max(ly, lx))
    xm = np.arange(bsize)
    xm = np.abs(xm - xm.mean())
    mask = 1 / (1 + np.exp((xm - (bsize / 2 - 20)) / sig))
    mask = mask * mask[:, np.newaxis]
    mask = mask[bsize // 2 - ly // 2: bsize // 2 + ly // 2 + ly % 2,
                bsize // 2 - lx // 2: bsize // 2 + lx // 2 + lx % 2]
    return mask.astype(np.float32)


def _run_tiled(net, img: torch.Tensor, bsize: int, tile_overlap: float,
               batch_size: int = 8) -> torch.Tensor:
    """v2's ``_run_tiled`` + ``average_tiles`` on one (C, Ly, Lx) image."""
    nchan, Ly, Lx = img.shape
    tile_overlap = min(0.5, max(0.05, tile_overlap))
    bY, bX = min(bsize, Ly), min(bsize, Lx)
    ny = 1 if Ly <= bsize else int(np.ceil((1. + 2 * tile_overlap) * Ly / bsize))
    nx = 1 if Lx <= bsize else int(np.ceil((1. + 2 * tile_overlap) * Lx / bsize))
    ystart = np.linspace(0, Ly - bY, ny).astype(int)
    xstart = np.linspace(0, Lx - bX, nx).astype(int)
    ysub, xsub, tiles = [], [], []
    for j in range(len(ystart)):
        for i in range(len(xstart)):
            ysub.append([ystart[j], ystart[j] + bY])
            xsub.append([xstart[i], xstart[i] + bX])
            tiles.append(img[:, ysub[-1][0]:ysub[-1][1],
                             xsub[-1][0]:xsub[-1][1]])
    IMG = torch.stack(tiles)
    y = torch.cat([net(IMG[k:k + batch_size])[0]
                   for k in range(0, IMG.shape[0], batch_size)])
    mask = torch.from_numpy(_taper_mask(bY, bX)).to(img.device)
    yf = torch.zeros((y.shape[1], Ly, Lx), dtype=torch.float32,
                     device=img.device)
    navg = torch.zeros((Ly, Lx), dtype=torch.float32, device=img.device)
    for j in range(len(ysub)):
        yf[:, ysub[j][0]:ysub[j][1], xsub[j][0]:xsub[j][1]] += y[j] * mask
        navg[ysub[j][0]:ysub[j][1], xsub[j][0]:xsub[j][1]] += mask
    return yf / navg


def eval_input(frame: torch.Tensor, rescale: float, channels=(0, 1)):
    """One (C, Y, X) frame -> the network's (2, LY, LX) float32 input as
    the eval path makes it (each channel normalised, resized by
    ``rescale``, zero-padded to a multiple of 16, split symmetrically), the
    resized size (Ly, Lx) and the pads ((top, bottom), (left, right))."""
    Y, X = frame.shape[-2:]
    img = torch.stack([_normalize(frame[c].to(torch.float32))
                       for c in channels])
    if rescale != 1.0:
        img = F.interpolate(img[None], size=(int(Y * rescale),
                                             int(X * rescale)),
                            mode="bilinear", align_corners=False)[0]
    Ly, Lx = img.shape[-2:]
    pads = []
    for L in (Ly, Lx):
        Lpad = int(16 * np.ceil(L / 16) - L)
        pads.append((Lpad // 2, Lpad - Lpad // 2))
    img = F.pad(img, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    return img, (Ly, Lx), pads


def reference_flows(net: CPnet, frames: torch.Tensor, diameter: float,
                    channels=(0, 1), tile: int = 224,
                    tile_overlap: float = 0.1,
                    lower: bool = False) -> torch.Tensor:
    """(T, C, Y, X) float32 frames -> (T, 3, Y, X) float32 (dY, dX,
    cellprob) by the float32 network, one frame at a time."""
    diam_mean = float(net.diam_mean.detach().cpu()[0])
    rescale = diam_mean / float(diameter)
    out = []
    _Conv.lower = lower
    try:
        for frame in frames:
            Y, X = frame.shape[-2:]
            img, (Ly, Lx), pads = eval_input(frame, rescale, channels)
            with torch.no_grad():
                yf = _run_tiled(net, img, tile, tile_overlap)
            yf = yf[:, pads[0][0]:pads[0][0] + Ly, pads[1][0]:pads[1][0] + Lx]
            if (Ly, Lx) != (Y, X):
                yf = F.interpolate(yf[None], size=(Y, X), mode="bilinear",
                                   align_corners=False)[0]
            out.append(yf)
    finally:
        _Conv.lower = False
    return torch.stack(out)


# --- compute_masks -------------------------------------------------------------

def follow_flows(dP: torch.Tensor, niter: int) -> torch.Tensor:
    """v2's ``follow_flows`` (interp, CPU form) on a (2, Y, X) float32
    field already masked and divided by 5: (2, Y, X) final positions."""
    Ly, Lx = dP.shape[1:]
    dev = dP.device
    grid = torch.meshgrid(torch.arange(Ly, device=dev),
                          torch.arange(Lx, device=dev), indexing="ij")
    p = torch.stack(grid).to(torch.float32)
    inds = torch.nonzero(dP[0].abs() > 1e-3)
    if inds.shape[0] < 5:
        return None
    yc, xc = p[0, inds[:, 0], inds[:, 1]], p[1, inds[:, 0], inds[:, 1]]
    for _ in range(niter):
        yi, xi = yc.to(torch.int32), xc.to(torch.int32)
        ry, rx = yc - yi.to(torch.float32), xc - xi.to(torch.float32)
        yf = torch.clamp(yi, 0, Ly - 1).long()
        xf = torch.clamp(xi, 0, Lx - 1).long()
        yf1 = torch.clamp(yf + 1, max=Ly - 1)
        xf1 = torch.clamp(xf + 1, max=Lx - 1)
        step = []
        for c in range(2):
            I = dP[c]
            step.append(I[yf, xf] * (1 - ry) * (1 - rx)
                        + I[yf, xf1] * (1 - ry) * rx
                        + I[yf1, xf] * ry * (1 - rx)
                        + I[yf1, xf1] * ry * rx)
        yc = torch.minimum(torch.tensor(Ly - 1.0, device=dev),
                           torch.maximum(torch.tensor(0.0, device=dev),
                                         yc + step[0]))
        xc = torch.minimum(torch.tensor(Lx - 1.0, device=dev),
                           torch.maximum(torch.tensor(0.0, device=dev),
                                         xc + step[1]))
    p[0, inds[:, 0], inds[:, 1]] = yc
    p[1, inds[:, 0], inds[:, 1]] = xc
    return p


def get_masks(p: np.ndarray, iscell: np.ndarray, rpad: int = 20) -> np.ndarray:
    """v2's ``get_masks`` in 2-D, on the host: each seed's bins grown as a
    set for five rounds, the sets written in seed order."""
    shape0 = p.shape[1:]
    p = p.copy()
    inds = np.meshgrid(np.arange(shape0[0]), np.arange(shape0[1]),
                       indexing="ij")
    for i in range(2):
        p[i, ~iscell] = inds[i][~iscell]
    pflows = [p[i].flatten().astype("int32") for i in range(2)]
    shape = (shape0[0] + 2 * rpad, shape0[1] + 2 * rpad)
    h = np.bincount((pflows[0] + rpad) * shape[1] + pflows[1] + rpad,
                    minlength=shape[0] * shape[1]).reshape(shape)
    h = h.astype(np.float64)
    hmax = h.copy()
    for i in range(2):
        hmax = ndi.maximum_filter1d(hmax, 5, axis=i)
    seeds = np.nonzero(np.logical_and(h - hmax > -1e-6, h > 10))
    # every seed's bin set as (seed, bin) pairs, grown five rounds at once
    k = np.arange(len(seeds[0]), dtype=np.int64)
    ys, xs = seeds[0].astype(np.int64), seeds[1].astype(np.int64)
    for _ in range(5):
        ey = (ys[:, None] + np.array([-1, -1, -1, 0, 0, 0, 1, 1, 1])).ravel()
        ex = (xs[:, None] + np.array([-1, 0, 1, -1, 0, 1, -1, 0, 1])).ravel()
        ek = np.repeat(k, 9)
        ok = (ey >= 0) & (ey < shape[0]) & (ex >= 0) & (ex < shape[1])
        ey, ex, ek = ey[ok], ex[ok], ek[ok]
        good = h[ey, ex] > 2
        key = np.unique((ek[good] * shape[0] + ey[good]) * shape[1] + ex[good])
        k, rest = key // (shape[0] * shape[1]), key % (shape[0] * shape[1])
        ys, xs = rest // shape[1], rest % shape[1]
    M = np.zeros(shape, np.int64)
    np.maximum.at(M, (ys, xs), 1 + k)          # later seeds written last
    M0 = M[pflows[0] + rpad, pflows[1] + rpad]
    uniq, counts = np.unique(M0, return_counts=True)
    big = np.prod(shape0) * 0.4
    bigc = uniq[counts > big]
    if len(bigc) > 0 and (len(bigc) > 1 or bigc[0] != 0):
        M0[np.isin(M0, bigc)] = 0
    # renumber by first appearance
    vals, first = np.unique(M0, return_index=True)
    order = np.argsort(first[vals > 0])
    new = np.zeros(int(M0.max()) + 1, np.int64)
    new[vals[vals > 0][order]] = np.arange(1, order.size + 1)
    return new[M0].reshape(shape0)


def _centres(masks: np.ndarray) -> np.ndarray:
    """Each mask's pixel nearest its (median y, median x) in padded
    coordinates, the first in row-major order on a tie (v2's per-mask loop,
    vectorised over the masks)."""
    N = int(masks.max())
    ys, xs = np.nonzero(masks)
    lab = masks[ys, xs]
    centres = np.zeros((N, 2), np.int64)
    med = np.zeros((N + 1, 2))
    for axis, v in enumerate((ys, xs)):
        order = np.lexsort((v, lab))
        sv, sl = v[order], lab[order]
        start = np.searchsorted(sl, np.arange(1, N + 1))
        stop = np.searchsorted(sl, np.arange(1, N + 1), side="right")
        n = stop - start
        med[1:, axis] = (sv[start + (n - 1) // 2].astype(np.float64)
                         + sv[start + n // 2]) / 2
    d = (xs - med[lab, 1]) ** 2 + (ys - med[lab, 0]) ** 2
    order = np.lexsort((np.arange(lab.size), d, lab))
    sl = lab[order]
    firsts = order[np.searchsorted(sl, np.arange(1, N + 1))]
    centres[:, 0] = ys[firsts] + 1
    centres[:, 1] = xs[firsts] + 1
    return centres


def masks_to_flows(masks: np.ndarray, device: torch.device) -> np.ndarray:
    """v2's ``masks_to_flows_gpu`` (2-D): (2, Y, X) float64 flows."""
    Ly0, Lx0 = masks.shape
    Ly, Lx = Ly0 + 2, Lx0 + 2
    masks_padded = np.zeros((Ly, Lx), np.int64)
    masks_padded[1:-1, 1:-1] = masks
    y, x = np.nonzero(masks_padded)
    neighborsY = np.stack((y, y - 1, y + 1, y, y, y - 1, y - 1, y + 1, y + 1))
    neighborsX = np.stack((x, x, x, x - 1, x + 1, x - 1, x + 1, x - 1, x + 1))
    centers = _centres(masks)
    slices = ndi.find_objects(masks)
    ext = np.array([[sr.stop - sr.start + 1, sc.stop - sc.start + 1]
                    for sr, sc in slices])
    n_iter = 2 * int(ext.sum(axis=1).max())
    nm = masks_padded[neighborsY, neighborsX]
    isneigh = torch.from_numpy(nm == nm[0]).to(device)
    # T[y, x] as T.view(-1)[y * Lx + x]
    pt = torch.from_numpy(neighborsY * Lx + neighborsX).to(device)
    meds = torch.from_numpy(centers[:, 0] * Lx + centers[:, 1]).to(device)
    T = torch.zeros((Ly, Lx), dtype=torch.float64, device=device)
    Tf = T.view(-1)
    for _ in range(n_iter):
        Tf[meds] += 1
        Tneigh = Tf[pt] * isneigh
        s = Tneigh[0]
        for k in range(1, 9):
            s = s + Tneigh[k]
        Tf[pt[0]] = s / 9
    Tf = torch.log(1. + Tf)
    dy = Tf[pt[2]] - Tf[pt[1]]
    dx = Tf[pt[4]] - Tf[pt[3]]
    norm = torch.sqrt(dy * dy + dx * dx)
    mu = torch.stack((dy / (1e-20 + norm), dx / (1e-20 + norm))).cpu().numpy()
    mu0 = np.zeros((2, Ly0, Lx0))
    mu0[:, y - 1, x - 1] = mu
    return mu0


def remove_bad_flow_masks(masks: np.ndarray, dP: np.ndarray,
                          threshold: float, device: torch.device
                          ) -> np.ndarray:
    """v2's ``remove_bad_flow_masks`` with ``metrics.flow_error``."""
    dP_masks = masks_to_flows(masks, device)
    errors = np.zeros(masks.max())
    for i in range(2):
        errors += ndi.mean((dP_masks[i] - dP[i] / 5.) ** 2, masks,
                           index=np.arange(1, masks.max() + 1))
    badi = 1 + (errors > threshold).nonzero()[0]
    masks = masks.copy()
    masks[np.isin(masks, badi)] = 0
    return masks


def fill_holes_and_remove_small_masks(masks: np.ndarray,
                                      min_size: int = 15) -> np.ndarray:
    """v2's ``utils.fill_holes_and_remove_small_masks`` (2-D)."""
    masks = masks.copy()
    slices = ndi.find_objects(masks)
    j = 0
    for i, slc in enumerate(slices):
        if slc is not None:
            msk = masks[slc] == (i + 1)
            npix = msk.sum()
            if min_size > 0 and npix < min_size:
                masks[slc][msk] = 0
            elif npix > 0:
                msk = ndi.binary_fill_holes(msk)
                masks[slc][msk] = (j + 1)
                j += 1
    return masks


def compute_masks(dP: torch.Tensor, cellprob: torch.Tensor, niter: int = 200,
                  cellprob_threshold: float = 0.0, flow_threshold: float = 0.4,
                  min_size: int = 15, seeds_out: Optional[list] = None
                  ) -> torch.Tensor:
    """v2's ``compute_masks`` (2-D, no resize) on one frame's (2, Y, X)
    flows and (Y, X) cell probability logits: (Y, X) int32 labels on their
    device. ``seeds_out`` receives ``get_masks``'s labels."""
    dev = dP.device
    cp_mask = cellprob > cellprob_threshold
    shape = tuple(cellprob.shape)
    empty = torch.zeros(shape, dtype=torch.int32, device=dev)
    if not bool(cp_mask.any()):
        if seeds_out is not None:
            seeds_out.append(empty)
        return empty
    p = follow_flows(dP * cp_mask / 5., niter)
    if p is None:
        if seeds_out is not None:
            seeds_out.append(empty)
        return empty
    mask = get_masks(p.cpu().numpy(), cp_mask.cpu().numpy())
    if seeds_out is not None:
        seeds_out.append(torch.from_numpy(mask.astype(np.int32)).to(dev))
    if mask.max() > 0 and flow_threshold is not None and flow_threshold > 0:
        mask = remove_bad_flow_masks(mask, dP.cpu().numpy(), flow_threshold,
                                     dev)
    mask = fill_holes_and_remove_small_masks(mask, min_size=min_size)
    return torch.from_numpy(mask.astype(np.int32)).to(dev)


def reference_net(state: Mapping, device: torch.device) -> CPnet:
    """The float32 network of a ``CPnet`` state_dict."""
    with torch.device(device):
        net = CPnet()
    net.load_state_dict(state, strict=True)
    return net.eval().requires_grad_(False)


def reference_movie(movie: np.ndarray, config: Mapping, device: torch.device,
                    state: Mapping, flows: Optional[torch.Tensor] = None,
                    lower: bool = False) -> dict:
    """The chain of ``movie_pipeline(cellpose=...)`` on a host movie:
    ``labels`` (T, X, Y), ``tables``, ``drifts``, ``ids``, the reference's
    own float32 ``flows`` (T, 3, Y, X) and ``get_masks``'s labels
    ``seeds`` (T, Y, X). The masks come from ``flows`` when given (the
    program's, which a float32 forward cannot match bit for bit) and from
    the reference's own otherwise."""
    from benchmark.reference.cell_table import (
        frame_cellinfo_checked, stack_tables)
    from benchmark.reference.pipeline import projections
    from benchmark.reference.tracking import (
        adaptive_effective_ranges, compute_drift_chain, track_movie)

    ref = int(config["reference_channel"])
    prj = projections(movie, ref, device)
    net = reference_net(state, device)
    own = reference_flows(net, prj, config["diameter"], config["channels"],
                          config["tile"], config["tile_overlap"], lower)
    del net
    source = own if flows is None else flows.to(device)
    seeds, labels = [], []
    for f in source:
        labels.append(compute_masks(
            f[:2], f[2], int(config["niter"]),
            float(config["cellprob_threshold"]),
            float(config["flow_threshold"]), int(config["min_size"]),
            seeds_out=seeds))
    labels = torch.stack(labels).transpose(1, 2).contiguous()
    refs = prj[:, ref]
    del prj
    cap = int(config["capacity"])
    tabs = stack_tables([frame_cellinfo_checked(f, capacity=cap,
                                                neighbor_compact_k=192)[0]
                         for f in labels])
    drifts = compute_drift_chain(refs).flip(1).cpu().numpy()
    host = tabs.map(lambda x: x.cpu())
    ranges = adaptive_effective_ranges(
        host.cy.numpy(), host.cx.numpy(), host.area.numpy(),
        host.valid_mask().numpy(), drifts=drifts,
        search_range=config["search_range"], per_cell=True)
    ids = track_movie(tabs.cy, tabs.cx, tabs.area, tabs.valid_mask(),
                      drifts=torch.as_tensor(drifts, dtype=torch.float32,
                                             device=device),
                      search_range=config["search_range"],
                      memory=config["memory"], capacity=2 * cap,
                      search_ranges=torch.as_tensor(
                          ranges, dtype=torch.float32, device=device))
    return {"labels": labels, "tables": tabs, "drifts": drifts,
            "ids": ids.cpu().numpy(), "flows": own,
            "seeds": torch.stack(seeds)}
