#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tissue_image_processing_tpu_torch``).

    python3 chip_smoke.py            # needs one CUDA card; run from the repo root

Phases (any failure exits non-zero; no phase catches and continues):

1. print the card's name and power limit, build every CUDA kernel from
   ``tissue_image_processing_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card, on the
   main path's shapes, and time the kernel, the plain version and (where one
   exists) one PyTorch library call computing the same function:
   the blur on a batch of two thresholded 1024^2 frames, as
   ``watershed_segmentation_batch`` hands it over; the floods on the two
   frames row-stacked to 2112 x 1024; the projection's score and project
   passes on one (2, 30, 1024, 1024) uint16 frame and its z-map; the
   segmented-scan component minimum on eight boundary maps of 1024^2
   row-stacked to 8320 x 1024, as the U-Net post-process floods them (with
   the index init and a poisoned init, against its plain version AND the
   sweep kernel), and on two small winding masks; the settle and its mask
   once more on that stacked U-Net input (lam == img, ties everywhere). Blur to rtol 2e-6 / atol
   1e-4; the diffusions, the scan, the settle mask, the settle (labels AND
   arrival stamps) and both projection passes bit for bit; then the device
   time of each step of ``fused_projection`` on that frame;
3. hold the fused projection against the unfused one on the card (the JAX
   tolerance class: >= 99% of pixels within one plane, median relative
   error < 0.02 where the z-maps agree), and ``unet_postprocess_batch`` on
   the card against the CPU route (exact);
4. drive ``movie_pipeline`` on a synthetic pre-projected movie (T=8, C=2,
   Z=1, 1024^2), on the raw headline movie (T=8, C=2, Z=30, 1024^2 uint16)
   and on that movie through the U-Net branch at the reference
   architecture's full width (depth 3, 128 base filters, bfloat16, batch 8,
   seeded random weights with non-trivial BatchNorm statistics folded to
   shifts, head bias calibrated so about half the pixels pass the HC
   threshold), each with the launch counters zeroed just before and read
   just after: every kernel of the path launched (the two projection
   kernels once a frame; on the U-Net branch the scan, the settle and its
   mask, and NOT the Bellman-Ford flood), cells per frame and id
   persistence as expected, ``movie_pipeline_chunked`` (3-frame chunks)
   identical to the unchunked run; print frames/s and the pipeline's own stage seconds;
5. compare the card with the CPU path of the port on small movies: the
   pre-projected watershed path, the fused projection (2, 8, 128, 128)
   against its plain route on CPU tensors, a Z > 1 pipeline at a shape
   the fused gate refuses (96^2, Z=6), so both take the unfused route, and
   the U-Net branch (probabilities within 0.01, two and a half bfloat16
   steps: the card rounds each conv's output once more; foreground
   agreement >= 0.99);
6. print the kernel table as one JSON object (launches from the Z=30
   watershed run, the scan's from the U-Net run), then the card's line, and
   as the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
KERNEL_SOURCE = {
    "blur3d": "tissue_image_processing_tpu_torch/csrc/blur3d.cu",
    "proj_score": "tissue_image_processing_tpu_torch/csrc/projection.cu",
    "proj_project": "tissue_image_processing_tpu_torch/csrc/projection.cu",
    "cc_scan": "tissue_image_processing_tpu_torch/csrc/cc_scan.cu",
}
FLOOD_SOURCE = "tissue_image_processing_tpu_torch/csrc/flood.cu"
REPLACES = {
    "blur3d": "tissue_image_processing_tpu/ops/blur_pallas.py:130",
    "diffusion_bf": "tissue_image_processing_tpu/ops/flood_pallas.py:431",
    "diffusion_cc": "tissue_image_processing_tpu/ops/flood_pallas.py:447",
    "settle_mask": "tissue_image_processing_tpu/ops/flood_pallas.py:713",
    "settle": "tissue_image_processing_tpu/ops/flood_pallas.py:1416",
    "proj_score": "tissue_image_processing_tpu/projection/fused.py:147",
    "proj_project": "tissue_image_processing_tpu/projection/fused.py:274",
    "cc_scan": "tissue_image_processing_tpu/ops/flood_pallas.py:697",
}
KERNELS = ("blur3d", "diffusion_bf", "diffusion_cc", "settle_mask", "settle",
           "proj_score", "proj_project", "cc_scan")
PROJECTION_KERNELS = ("proj_score", "proj_project")
WATERSHED_KERNELS = ("blur3d", "diffusion_bf", "diffusion_cc", "settle_mask",
                     "settle")
UNET_KERNELS = ("cc_scan", "settle_mask", "settle")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm call,
    bracketed by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> float:
    import torch

    if a.dtype.is_floating_point:  # equal infinities count as no error
        d = torch.where(a == b, 0.0, a.double() - b.double())
        return float(d.abs().max())
    return float((a.long() - b.long()).abs().max())


def check_kernels(frames):
    """Phase 2: every kernel against its plain version at the path's shapes.
    ``frames``: (2, 1024, 1024) x-major reference frames on the card."""
    import torch

    from tissue_image_processing_tpu_torch.ops import blur_cuda, flood_cuda
    from tissue_image_processing_tpu_torch.ops import watershed as ws
    from tissue_image_processing_tpu_torch.ops.filters import (
        gaussian_blur, gaussian_kernel1d)
    from tissue_image_processing_tpu_torch.ops.local_threshold import (
        threshold_local_max)

    rows = {}
    taps = gaussian_kernel1d(3.0)
    thr = 0.2 * threshold_local_max(frames, 101)
    seg = torch.where(frames < thr, 0.0, frames)

    # blur3d: the (2, 1024, 1024) batch, sigma 3 (25 taps per axis), as
    # _preprocess passes it (one launch per batch of two frames)
    x = seg.contiguous()
    got = blur_cuda.blur3d(x, (1.0,), taps, taps)
    want = blur_cuda.blur3d_plain(x, (1.0,), taps, taps)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-4)
    nvox = x.numel()
    k2d = torch.tensor(np.outer(taps, taps), dtype=torch.float32,
                       device=x.device)[None, None]
    r = len(taps) // 2

    def library():
        xp = torch.nn.functional.pad(x[:, None], (r, r, r, r), mode="replicate")
        return torch.nn.functional.conv2d(xp, k2d)[:, 0]

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.testing.assert_close(library(), want, rtol=1e-5, atol=1e-2)
    lib_ms = cuda_ms(library, 20)
    torch.backends.cudnn.allow_tf32 = prev_tf32
    rows["blur3d"] = dict(
        err=max_abs_err(got, want),
        ms=cuda_ms(lambda: blur_cuda.blur3d(x, (1.0,), taps, taps), 50),
        plain_ms=cuda_ms(lambda: blur_cuda.blur3d_plain(x, (1.0,), taps, taps), 5),
        bound=bound(8 * nvox, 2 * (1 + 2 * len(taps)) * nvox), library_ms=lib_ms)
    print(f"blur3d {tuple(x.shape)} 25x25 taps: max_abs_err {rows['blur3d']['err']:.3g}"
          f" kernel {rows['blur3d']['ms']:.4f} ms, plain "
          f"{rows['blur3d']['plain_ms']:.4f} ms, conv2d {lib_ms:.4f} ms")

    # the flood on the two frames row-stacked, as watershed_batch floods them
    img = ws.stack_frames(gaussian_blur(seg, (0.0, 3.0, 3.0)))
    H, W = img.shape
    npx = H * W
    cand, init = ws.minima_candidates(img)
    got = flood_cuda.cc_diffusion(cand, init)
    want, cc_sweeps = flood_cuda.cc_diffusion_plain(cand, init, return_sweeps=True)
    assert torch.equal(got, want), "cc_diffusion disagrees with its plain version"
    rows["diffusion_cc"] = dict(
        err=max_abs_err(got, want),
        ms=cuda_ms(lambda: flood_cuda.cc_diffusion(cand, init), 10),
        plain_ms=cuda_ms(lambda: flood_cuda.cc_diffusion_plain(cand, init), 2),
        bound=bound(12 * npx, 7 * npx * max(cc_sweeps, 1)), library_ms=None)
    print(f"diffusion_cc {H}x{W}: bit-exact, {cc_sweeps} sweeps, kernel "
          f"{rows['diffusion_cc']['ms']:.4f} ms, plain "
          f"{rows['diffusion_cc']['plain_ms']:.4f} ms")

    seeds = ws.regional_minima_labels(img)
    got = flood_cuda.bf_flood(img, seeds)
    want, bf_sweeps = flood_cuda.bf_flood_plain(img, seeds, return_sweeps=True)
    assert torch.equal(got, want), "bf_flood disagrees with its plain version"
    rows["diffusion_bf"] = dict(
        err=max_abs_err(got, want),
        ms=cuda_ms(lambda: flood_cuda.bf_flood(img, seeds), 10),
        plain_ms=cuda_ms(lambda: flood_cuda.bf_flood_plain(img, seeds), 2),
        bound=bound(12 * npx, 6 * npx * max(bf_sweeps, 1)), library_ms=None)
    print(f"diffusion_bf {H}x{W}: bit-exact, {bf_sweeps} sweeps, kernel "
          f"{rows['diffusion_bf']['ms']:.4f} ms, plain "
          f"{rows['diffusion_bf']['plain_ms']:.4f} ms")

    lam = got
    got = flood_cuda.settle_mask(lam)
    want = flood_cuda.settle_mask_plain(lam)
    assert torch.equal(got, want), "settle_mask disagrees with its plain version"
    rows["settle_mask"] = dict(
        err=max_abs_err(got, want),
        ms=cuda_ms(lambda: flood_cuda.settle_mask(lam), 50),
        plain_ms=cuda_ms(lambda: flood_cuda.settle_mask_plain(lam), 5),
        bound=bound(8 * npx, 8 * npx), library_ms=None)

    got_l, got_t = flood_cuda.settle(lam, seeds)
    want_l, want_t, st_sweeps = flood_cuda.settle_plain(lam, seeds,
                                                        return_sweeps=True)
    assert torch.equal(got_l, want_l), "settle labels disagree with plain"
    assert torch.equal(got_t, want_t), "settle stamps disagree with plain"
    # inputs lam + seeds read once, lbl + t written once; ~40 int ops per
    # pixel and sweep
    rows["settle"] = dict(
        err=max(max_abs_err(got_l, want_l), max_abs_err(got_t, want_t)),
        ms=cuda_ms(lambda: flood_cuda.settle(lam, seeds), 10),
        plain_ms=cuda_ms(lambda: flood_cuda.settle_plain(lam, seeds), 2),
        bound=bound(16 * npx, 40 * npx * st_sweeps), library_ms=None)
    print(f"settle {H}x{W}: lbl and t bit-exact, {st_sweeps} sweeps, kernel "
          f"{rows['settle']['ms']:.4f} ms, plain {rows['settle']['plain_ms']:.4f} ms"
          f"; settle_mask kernel {rows['settle_mask']['ms']:.4f} ms")
    return rows


def synthetic_predictions(movie_z1):
    """(8, 1024, 1024, 2) softmax-like predictions on the card from the
    synthetic movie's membranes, in x-major space: HC probability 0.9 in the
    cell interiors (dim membrane channel), 0.02 on the membranes — cells as
    HC blobs inside a connected background sea."""
    import torch

    ridge = torch.from_numpy(movie_z1[:, 0, 0].astype(np.float32)).cuda()
    ridge = ridge.transpose(1, 2)
    p0 = torch.where(ridge < 0.15 * ridge.amax(), 0.9, 0.02)
    return torch.stack([p0, 1.0 - p0], dim=-1).contiguous()


def check_cc_scan(preds):
    """Phase 2 for the segmented scan: bit-exact against its plain version
    and against the sweep kernel at the U-Net path's shape, with the index
    init and a poisoned init; its time, iterations and bound; two small
    winding masks."""
    import torch

    from tissue_image_processing_tpu_torch.models.predictor import _boundary
    from tissue_image_processing_tpu_torch.ops import flood_cuda
    from tissue_image_processing_tpu_torch.ops import watershed as ws

    boundary, _ = _boundary(preds, 0.1, 5, 7)
    img = ws.stack_frames(boundary.to(torch.float32))
    H, W = img.shape
    npx = H * W
    cand = ws._binary_candidates(img)
    idx = torch.arange(npx, dtype=torch.int32, device=img.device).reshape(H, W)
    gen = torch.Generator(device=img.device).manual_seed(0)
    poison = torch.rand(img.shape, device=img.device, generator=gen) < 0.01
    err = 0.0
    for name, init in (("index", idx), ("poisoned",
                                        torch.where(poison, idx - npx, idx))):
        got, iters = flood_cuda.cc_scan(cand, init, return_iterations=True)
        want = flood_cuda.cc_scan_plain(cand, init)
        assert torch.equal(got, want), f"cc_scan ({name}) disagrees with plain"
        assert torch.equal(got, flood_cuda.cc_diffusion(cand, init)), \
            f"cc_scan ({name}) disagrees with the sweep kernel"
        err = max(err, max_abs_err(got, want))
        print(f"cc_scan {H}x{W} {name} init: bit-exact vs plain and vs the "
              f"sweep kernel, {iters} iterations")
    _, iters = flood_cuda.cc_scan(cand, idx, return_iterations=True)
    # mask (1 B) and init (4 B) read once, the result (4 B) written once; the
    # function needs at least one compare and one min per pixel and direction
    # (how many passes a schedule takes to get there is its own affair), so
    # the byte term always sets the bound
    row = dict(
        err=err, ms=cuda_ms(lambda: flood_cuda.cc_scan(cand, idx), 5),
        plain_ms=cuda_ms(lambda: flood_cuda.cc_scan_plain(cand, idx), 2),
        bound=bound(9 * npx, 8 * npx), library_ms=None)
    sweeps_ms = cuda_ms(lambda: flood_cuda.cc_diffusion(cand, idx), 1)
    print(f"cc_scan {H}x{W}: zero set {float(cand.float().mean()):.3f} of the "
          f"pixels, {iters} iterations, kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, sweep kernel {sweeps_ms:.4f} ms, bound "
          f"{row['bound'][0]:.4f} ms ({row['bound'][1]}), library: none")

    # small hard cases: the open one-pixel rings of the JAX package's scan
    # test and a one-pixel serpentine (one component, 48 turns)
    rings = np.zeros((128, 128), bool)
    lo, hi = 0, 127
    while lo < hi - 8:
        rings[lo, lo:hi] = True
        rings[lo:hi, hi] = True
        rings[hi, lo + 4:hi] = True
        rings[lo + 4:hi, lo] = True
        lo, hi = lo + 4, hi - 4
    serpentine = np.zeros((96, 80), bool)
    serpentine[::2] = True
    serpentine[1::4, -1] = True
    serpentine[3::4, 0] = True
    rng = np.random.default_rng(5)
    for name, mask in (("rings", rings), ("serpentine", serpentine)):
        m = torch.from_numpy(mask).cuda()
        init = torch.from_numpy(rng.integers(0, mask.size, mask.shape)
                                .astype(np.int32)).cuda()
        got, iters = flood_cuda.cc_scan(m, init, return_iterations=True)
        assert torch.equal(got, flood_cuda.cc_scan_plain(m, init)), name
        assert torch.equal(got, flood_cuda.cc_diffusion(m, init)), name
        print(f"cc_scan {name} {mask.shape}: bit-exact vs plain and vs the "
              f"sweep kernel, {iters} iterations")
    return {"cc_scan": row}


def check_settle_unet(preds):
    """Phase 2 for the settle and its mask on the U-Net path's own input: the
    eight boundary maps row-stacked to 8320 x 1024, where lam is the image
    itself ({0, 1, +inf}, ties everywhere) and the seeds are the binary
    minima by the scan. Labels, arrival stamps and the mask bit for bit
    against the plain versions on the same card tensors; times and bounds."""
    import torch

    from tissue_image_processing_tpu_torch.models.predictor import _boundary
    from tissue_image_processing_tpu_torch.ops import flood_cuda
    from tissue_image_processing_tpu_torch.ops import watershed as ws

    boundary, _ = _boundary(preds, 0.1, 5, 7)
    img = ws.stack_frames(boundary.to(torch.float32))
    H, W = img.shape
    npx = H * W
    seeds = ws.regional_minima_labels(img, scan=True, binary=True)
    got = flood_cuda.settle_mask(img)
    want = flood_cuda.settle_mask_plain(img)
    assert torch.equal(got, want), "settle_mask (U-Net input) disagrees with plain"
    mask_row = dict(
        err=max_abs_err(got, want),
        ms=cuda_ms(lambda: flood_cuda.settle_mask(img), 20),
        plain_ms=cuda_ms(lambda: flood_cuda.settle_mask_plain(img), 3),
        bound=bound(8 * npx, 8 * npx))
    got_l, got_t = flood_cuda.settle(img, seeds)
    want_l, want_t, sweeps = flood_cuda.settle_plain(img, seeds,
                                                     return_sweeps=True)
    assert torch.equal(got_l, want_l), "settle labels (U-Net input) disagree with plain"
    assert torch.equal(got_t, want_t), "settle stamps (U-Net input) disagree with plain"
    row = dict(
        err=max(max_abs_err(got_l, want_l), max_abs_err(got_t, want_t)),
        ms=cuda_ms(lambda: flood_cuda.settle(img, seeds), 5),
        plain_ms=cuda_ms(lambda: flood_cuda.settle_plain(img, seeds), 2),
        bound=bound(16 * npx, 40 * npx * sweeps))
    print(f"settle {H}x{W} (U-Net input, lam == img, {int(seeds.max())} seeds):"
          f" lbl and t bit-exact, {sweeps} sweeps, kernel {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
          f"({row['bound'][1]}); settle_mask bit-exact, kernel "
          f"{mask_row['ms']:.4f} ms, plain {mask_row['plain_ms']:.4f} ms, bound "
          f"{mask_row['bound'][0]:.4f} ms ({mask_row['bound'][1]})")
    return {"settle": row, "settle_mask": mask_row}


def check_postprocess(preds):
    """Phase 3 for the U-Net post-process: the card against the CPU route,
    exactly (on the first two frames: the plain scan and settle are slow on
    the CPU), and the cells a frame of all eight."""
    import torch

    from tissue_image_processing_tpu_torch.models.predictor import (
        unet_postprocess_batch)

    labels, hc = unet_postprocess_batch(preds)
    want_l, want_hc = unet_postprocess_batch(preds[:2].cpu())
    assert torch.equal(labels[:2].cpu(), want_l), "post-process labels: card != CPU"
    assert torch.equal(hc[:2].cpu(), want_hc), "post-process HC mask: card != CPU"
    cells = [int(l.max()) for l in labels]
    assert min(cells) > 200, cells
    ms = cuda_ms(lambda: unet_postprocess_batch(preds), 2)
    print(f"unet_postprocess_batch {tuple(preds.shape)}: card == CPU on 2 "
          f"frames (labels and HC mask), cells/frame {cells}, {ms:.3f} ms")


def check_projection_kernels(stack):
    """Phase 2 for the projection: the score and project passes against their
    plain versions on one (2, 30, 1024, 1024) uint16 frame and its z-map,
    bit for bit; times and bounds."""
    import torch
    import torch.nn.functional as F

    from tissue_image_processing_tpu_torch.ops.percentile import (
        masked_percentile)
    from tissue_image_processing_tpu_torch.projection import fused

    rows = {}
    C, Z, Y, X = stack.shape
    ref = stack[0]
    sub = ref[:, ::16, :].to(torch.float32)
    p95 = masked_percentile(sub, sub > 0, 95.0)
    got = fused.score_pass(ref, p95)
    want = fused.score_pass_plain(ref, p95)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    # one library call computing the same function: conv3d with the folded
    # (5, 12, 12) kernel and stride (1, 4, 4) over the pre-padded clipped
    # volume (cuDNN TF32 off)
    kz, ky, kx = (np.asarray(k, np.float64) for k in fused._SCORE_TAPS)
    fy, fx = (0.25 * np.convolve(k, np.ones(4)) for k in (ky, kx))
    kern = torch.tensor(kz[:, None, None] * fy[None, :, None] * fx[None, None, :],
                        dtype=torch.float32, device=ref.device)[None, None]
    clipped = torch.minimum(ref.to(torch.float32), p95)
    xp = F.pad(clipped[None, None], (4, 4, 4, 4, 2, 2), mode="replicate")

    def library():
        return F.conv3d(xp, kern, stride=(1, 4, 4))[0, 0]

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    lib_err = max_abs_err(library(), want)
    torch.testing.assert_close(library(), want, rtol=1e-4, atol=1.0)
    lib_ms = cuda_ms(library, 10)
    torch.backends.cudnn.allow_tf32 = prev_tf32
    nvox = Z * Y * X
    # ~36 flops per input voxel: offset and clip, 5 z taps, 9 y taps, the row
    # mean, and 9 x taps with the column mean on a quarter of the rows
    rows["proj_score"] = dict(
        err=max_abs_err(got, want),
        ms=cuda_ms(lambda: fused.score_pass(ref, p95), 50),
        plain_ms=cuda_ms(lambda: fused.score_pass_plain(ref, p95), 5),
        bound=bound(2 * nvox + 4 * nvox // 16, 36 * nvox), library_ms=lib_ms)
    print(f"proj_score {tuple(ref.shape)}: bit-exact, kernel "
          f"{rows['proj_score']['ms']:.4f} ms, plain "
          f"{rows['proj_score']['plain_ms']:.4f} ms, conv3d {lib_ms:.4f} ms "
          f"(max_abs_err vs plain {lib_err:.3g}), bound "
          f"{rows['proj_score']['bound'][0]:.4f} ms "
          f"({rows['proj_score']['bound'][1]})")

    _, rel_z = fused.fused_projection(stack)
    got = fused.project_pass(stack, rel_z)
    want = fused.project_pass_plain(stack, rel_z)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the planes this z-map needs: for each pixel those within 4 of any
    # z-map value in its 17 x 17 window (the mask is 0 elsewhere)
    zp = F.pad(rel_z.to(torch.float32)[None, None], (8, 8, 8, 8),
               mode="replicate")
    hi = F.max_pool2d(zp, 17, stride=1)[0, 0]
    lo = -F.max_pool2d(-zp, 17, stride=1)[0, 0]
    planes = int(((hi + 4).clamp(max=Z - 1) - (lo - 4).clamp(min=0) + 1).sum())
    all_planes = bound(2 * C * Z * Y * X + 4 * Y * X + 4 * C * Y * X, 0)[0]
    # per admitted pixel-plane: 17 y taps, 17 x taps, a multiply and a max
    # per channel
    rows["proj_project"] = dict(
        err=max_abs_err(got, want),
        ms=cuda_ms(lambda: fused.project_pass(stack, rel_z), 20),
        plain_ms=cuda_ms(lambda: fused.project_pass_plain(stack, rel_z), 3),
        bound=bound(2 * C * planes + 4 * Y * X + 4 * C * Y * X,
                    (68 + 2 * C) * planes), library_ms=None)
    print(f"proj_project {tuple(stack.shape)}: bit-exact, kernel "
          f"{rows['proj_project']['ms']:.4f} ms, plain "
          f"{rows['proj_project']['plain_ms']:.4f} ms, bound "
          f"{rows['proj_project']['bound'][0]:.4f} ms "
          f"({rows['proj_project']['bound'][1]}; {planes / (Y * X):.2f} planes "
          f"a pixel of {Z}; reading every plane {all_planes:.4f} ms); z-map "
          f"range {int(rel_z.min())}..{int(rel_z.max())}")
    return rows


def projection_breakdown(stack, card: str):
    """Device time of each step of ``fused_projection`` on one frame (CUDA
    events around repeated calls, so launch gaps count)."""
    import torch

    from tissue_image_processing_tpu_torch.ops.filters import (
        gaussian_blur, resize_bilinear)
    from tissue_image_processing_tpu_torch.ops.percentile import (
        masked_percentile)
    from tissue_image_processing_tpu_torch.projection import fused

    Z, Y, X = stack.shape[1:]
    ref = stack[0]
    sub = ref[:, ::16, :].to(torch.float32)
    p95 = masked_percentile(sub, sub > 0, 95.0)
    small = fused.score_pass(ref, p95)
    score = gaussian_blur(small, (0.5, 7.5, 7.5), fast=True)
    rel_z = fused.fused_projection(stack)[1]

    def zmap():
        rel = torch.argmax(score, dim=0).to(torch.float32)
        return torch.round(resize_bilinear(rel, (Y, X))).to(torch.int32).clamp(0, Z - 1)

    steps = {
        "p95": lambda: masked_percentile(sub, sub > 0, 95.0),
        "score_pass": lambda: fused.score_pass(ref, p95),
        "small_blur": lambda: gaussian_blur(small, (0.5, 7.5, 7.5), fast=True),
        "argmax_resize": zmap,
        "project_pass": lambda: fused.project_pass(stack, rel_z),
        "fused_projection": lambda: fused.fused_projection(stack),
    }
    ms = {k: cuda_ms(fn, 10) for k, fn in steps.items()}
    print(f"fused_projection steps, ms a frame {tuple(stack.shape)}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items()) + f" on {card}")


def check_fused_vs_unfused(stack):
    """Phase 3: the fused projection against the unfused one on the card,
    to the JAX package's tolerance class (tests/test_projection_fused.py)."""
    from tissue_image_processing_tpu_torch.projection.fused import (
        fused_projection)
    from tissue_image_processing_tpu_torch.projection.surface import (
        time_point_surface_projection)

    pf, zf = fused_projection(stack, airyscan=False)
    pr, zr = time_point_surface_projection(stack, airyscan=False)
    dz = (zf - zr).abs()
    near = float((dz <= 1).float().mean())
    same = dz == 0
    rel = ((pf[:, same] - pr[:, same]).abs() / (pr[:, same].abs() + 1.0))
    med = float(rel.median())
    assert near > 0.99, f"fused z-map within one plane on {near:.4f} of pixels"
    assert med < 0.02, f"fused projection median relative error {med:.4f}"
    print(f"fused vs unfused {tuple(stack.shape)}: |dz| <= 1 on {near:.6f}, "
          f"dz == 0 on {float(same.float().mean()):.6f}, median relative "
          f"error {med:.3g}")


def check_pipeline(card: str, movie):
    """Phase 4: one watershed main path (Z == 1 pre-projected, or the raw
    Z-plane movie), its launch counts, chunked == unchunked."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core.pipeline import (
        movie_pipeline, movie_pipeline_chunked)

    kw = dict(batch=2, capacity=1024, block_size=101, std=3.0)
    T, Z = movie.shape[0], movie.shape[2]
    movie_pipeline(movie[:2], **kw)  # warm: library loads, allocator, cuFFT plans
    torch.cuda.synchronize()
    tipt.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    out = movie_pipeline(movie, timings=stages, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tipt.LAUNCHES)
    expected = WATERSHED_KERNELS + (PROJECTION_KERNELS if Z > 1 else ())
    missing = [k for k in expected if launches[k] == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    assert launches["cc_scan"] == 0, launches
    if Z > 1:
        assert all(launches[k] == T for k in PROJECTION_KERNELS), launches
    else:
        assert all(launches[k] == 0 for k in PROJECTION_KERNELS), launches

    labels = out["labels"].cpu().numpy()
    assert labels.shape == (T, 1024, 1024), labels.shape
    n_cells = [int(np.unique(l).size - 1) for l in labels]
    assert min(n_cells) > 200, n_cells
    assert np.isfinite(out["drifts"]).all() and np.abs(out["drifts"]).max() < 5
    ids = out["ids"]
    assert ids.shape == (T, 1024) and (ids > 0).sum(axis=1).min() > 200
    # a cell seen in frame 0 should mostly keep its id to the last frame
    kept = np.intersect1d(ids[0][ids[0] > 0], ids[-1][ids[-1] > 0]).size
    assert kept > 0.5 * (ids[0] > 0).sum(), kept

    got = movie_pipeline_chunked(movie, chunk_frames=3, **kw)
    assert np.array_equal(got["ids"], ids), "chunked ids differ"
    assert np.array_equal(got["labels"], labels), "chunked labels differ"
    assert np.array_equal(got["tables"].area.numpy(),
                          out["tables"].area.cpu().numpy()), "chunked areas differ"
    print(f"pipeline Z={Z}: cells/frame {n_cells}, chunked(3) == unchunked")
    print(f"movie_pipeline {T} x 1024^2 Z={Z}: {T / secs:.3f} frames/s "
          f"({secs:.3f} s) on {card}; launches {launches}")
    print(f"stage seconds ({T} x 1024^2, Z={Z}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f" on {card}")
    return launches


def random_unet_config(frame, depth: int, base_filters: int, batch: int,
                       seed: int = 0, share: float = 0.5):
    """``movie_pipeline(unet=...)`` configuration with seeded random weights:
    he / lecun-normal convs, BatchNorm scales, biases and running statistics
    drawn away from the identity and folded to shifts by the predictor, and
    the head bias set from one forward of ``frame`` ((C, Z, Y, X), projected
    first when Z > 1) so that ``share`` of its pixels pass the 0.1 HC
    threshold — random logits would else pass everywhere or nowhere and the
    flood be trivial. Returns (config, share measured after calibration)."""
    import torch

    from tissue_image_processing_tpu_torch.models.predictor import (
        SegmentationPredictor, prepare_batch)
    from tissue_image_processing_tpu_torch.models.unet import build_unet
    from tissue_image_processing_tpu_torch.projection.surface import (
        project_timepoint_auto)

    gen = torch.Generator().manual_seed(seed)
    Y, X = frame.shape[-2:]
    model = build_unet((X, Y, 2), depth=depth, base_filters=base_filters,
                       dtype=torch.bfloat16, generator=gen)
    ranges = {"weight": (0.5, 1.5), "bias": (-0.2, 0.2),
              "running_mean": (0.0, 0.5), "running_var": (0.5, 1.5)}
    with torch.no_grad():
        for name, buf in model.state_dict().items():
            leaf = name.rsplit(".", 1)[1]
            if ".bn" in name and leaf in ranges:
                lo, hi = ranges[leaf]
                buf.copy_(lo + (hi - lo) * torch.rand(buf.shape, generator=gen))
    pred = SegmentationPredictor(None, (2, Y, X), depth=depth,
                                 base_filters=base_filters,
                                 variables=model.state_dict())
    assert pred.model.norm == "shift", "BatchNorm was not folded"
    stack = torch.from_numpy(np.ascontiguousarray(frame)).cuda()
    prj = (project_timepoint_auto(stack)[0] if stack.shape[1] > 1
           else stack[:, 0].to(torch.float32))
    x, (px, py) = prepare_batch(prj[None])
    logit_cut = float(np.log(0.1 / 0.9))

    def logit_gap():
        p = pred._forward(x)[0, px:, py:].clamp_min(1e-30)
        return torch.log(p[..., 0]) - torch.log(p[..., 1])

    d = logit_gap().reshape(-1)
    kth = max(1, int(round((1.0 - share) * d.numel())))
    with torch.no_grad():
        pred.model.head.bias[0] += logit_cut - torch.kthvalue(d, kth).values
    got = float((logit_gap() > logit_cut).float().mean())
    return pred.pipeline_config(batch=batch), got


def check_unet_pipeline(card: str, movie):
    """Phase 4 for the U-Net branch: the raw headline movie through
    ``movie_pipeline(unet=...)`` at the reference architecture's full width,
    its launch counts; then chunked == unchunked."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core.pipeline import (
        movie_pipeline, movie_pipeline_chunked)

    T, Z = movie.shape[0], movie.shape[2]
    cfg, share = random_unet_config(movie[0], depth=3, base_filters=128, batch=8)
    kw = dict(capacity=2048)
    movie_pipeline(movie, unet=cfg, **kw)  # warm: cuDNN plans at batch 8, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tipt.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    out = movie_pipeline(movie, unet=cfg, timings=stages, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tipt.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    missing = [k for k in UNET_KERNELS + PROJECTION_KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched on the U-Net path: {missing}"
    assert launches["diffusion_bf"] == 0, launches  # binary route: no BF flood
    assert launches["diffusion_cc"] == 0 and launches["blur3d"] == T, launches
    assert all(launches[k] == T for k in PROJECTION_KERNELS), launches
    assert launches["cc_scan"] >= 2 and launches["settle_mask"] == 1, launches

    labels = out["labels"]
    assert tuple(labels.shape) == (T, 1024, 1024), labels.shape
    cells = [int(l.max()) for l in labels]
    hc_share = float((labels > 0).float().mean())
    assert min(cells) > 20, f"trivial flood: cells/frame {cells}"
    assert np.isfinite(out["drifts"]).all() and np.abs(out["drifts"]).max() < 5
    ids = out["ids"]
    assert ids.shape == (T, kw["capacity"]) and (ids > 0).sum(axis=1).min() > 10
    area = out["tables"].area
    assert bool(torch.isfinite(area).all()) and float(area.sum()) > 0
    valid = out["tables"].valid.sum(dim=1).tolist()
    print(f"U-Net pipeline depth 3, 128 filters, bfloat16, batch 8, Z={Z}: "
          f"p0 > 0.1 on {share:.3f} of frame 0 after calibration, cells/frame "
          f"{cells} (valid by the area rule {valid}), labelled share "
          f"{hc_share:.3f}, peak memory {peak_gib:.2f} GiB")
    print(f"movie_pipeline(unet) {T} x 1024^2 Z={Z}: {T / secs:.3f} frames/s "
          f"({secs:.3f} s) on {card}; launches {launches}")
    print(f"stage seconds (U-Net, {T} x 1024^2, Z={Z}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f" on {card}")

    # chunked == unchunked, chunk 3 of T=8: the model sees groups of 3, 3
    # and 2 frames instead of 8, and the tail chunk is partial
    got = movie_pipeline_chunked(movie, chunk_frames=3, unet=cfg, **kw)
    assert np.array_equal(got["labels"], labels.cpu().numpy()), \
        "U-Net chunked labels differ"
    assert np.array_equal(got["ids"], ids), "U-Net chunked ids differ"
    assert np.array_equal(got["tables"].area.numpy(), area.cpu().numpy()), \
        "U-Net chunked areas differ"
    assert np.abs(got["drifts"] - out["drifts"]).max() <= 1e-4
    print("U-Net pipeline: chunked(3) == unchunked (labels, ids, areas; "
          "drifts to 1e-4)")
    return launches


def check_card_vs_cpu():
    """Phase 5: the card against the port's CPU path on small inputs."""
    import torch

    from tissue_image_processing_tpu_torch.core.pipeline import movie_pipeline
    from tissue_image_processing_tpu_torch.models.predictor import (
        prepare_batch, unet_from_config)
    from tissue_image_processing_tpu_torch.projection.fused import (
        fused_projection)
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    skw = dict(batch=2, capacity=128, block_size=31, std=3.0)
    agree = {}
    for name, movie in (("Z=1 128^2", make_movie(T=4, Z=1, H=128, W=128, seed=1)),
                        ("Z=6 96^2 unfused",
                         make_movie(T=4, Z=6, H=96, W=96, seed=1).astype(np.uint16))):
        on_card = movie_pipeline(movie, **skw)
        on_cpu = movie_pipeline(movie, device="cpu", **skw)
        agree[name] = float((on_card["labels"].cpu().numpy()
                             == on_cpu["labels"].numpy()).mean())
        assert agree[name] >= 0.995, f"card vs CPU label agreement {agree}"

    # the U-Net branch, random weights: the card rounds every conv's output
    # to bfloat16 once more than the CPU route. One bfloat16 step of a
    # probability in [0.5, 1) is 2^-8 = 0.0039; the bar is 0.01, two and a
    # half such steps (this movie reads 0.0015), far below what a wrong
    # layout, flip or crop would give. Single mask pixels beside the 0.1
    # threshold may flip: >= 0.99 of the pixels agree on labelled vs line /
    # background (this movie reads 0.9975)
    mv = make_movie(T=4, Z=1, H=128, W=128, seed=1)
    cfg, share = random_unet_config(mv[0], depth=2, base_filters=8, batch=2,
                                    seed=2)
    on_card = movie_pipeline(mv, unet=cfg, capacity=256)
    cpu_cfg = dict(cfg, params={k: v.cpu() for k, v in cfg["params"].items()})
    on_cpu = movie_pipeline(mv, unet=cpu_cfg, capacity=256, device="cpu")
    x, _ = prepare_batch(torch.from_numpy(mv[:, :, 0]))
    with torch.no_grad():
        dp = float((unet_from_config(cfg, torch.device("cuda"))(x.cuda()).cpu()
                    - unet_from_config(cpu_cfg, torch.device("cpu"))(x)
                    ).abs().max())
    gl, wl = on_card["labels"].cpu().numpy(), on_cpu["labels"].numpy()
    fg = float(((gl > 0) == (wl > 0)).mean())
    assert dp <= 0.01, f"U-Net card vs CPU: max probability difference {dp}"
    assert fg >= 0.99, f"U-Net card vs CPU: foreground agreement {fg}"
    print(f"card vs CPU, U-Net branch (4 x 128^2, depth 2, 8 filters, p0 > 0.1 "
          f"on {share:.3f}): max probability difference {dp:.4f}, foreground "
          f"agreement {fg:.6f}, label agreement {float((gl == wl).mean()):.6f}, "
          f"cells/frame {[int(l.max()) for l in wl]}")

    # the fused route on the card against its plain route on CPU tensors
    stack = torch.from_numpy(make_movie(T=1, Z=8, H=128, W=128, seed=3)[0]
                             .astype(np.uint16))
    gp, gz = fused_projection(stack.cuda())
    wp, wz = fused_projection(stack)
    gp, gz = gp.cpu(), gz.cpu()
    dz = (gz - wz).abs()
    same = dz == 0
    assert float(same.float().mean()) >= 0.999 and int(dz.max()) <= 1, \
        "fused z-map on the card differs from the CPU route"
    torch.testing.assert_close(gp[:, same], wp[:, same], rtol=2e-6, atol=1e-4)
    print(f"card vs CPU: label agreement {agree}; fused (2, 8, 128, 128) z-map "
          f"equal on {float(same.float().mean()):.6f}, projection max_abs_err "
          f"{max_abs_err(gp[:, same], wp[:, same]):.3g} where equal")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import tissue_image_processing_tpu_torch as tipt

    card = card_line()
    print(f"card: {card}")
    t0 = time.time()
    tipt.build_kernels()
    print(f"kernels built in {time.time() - t0:.1f} s")
    for log in sorted(tipt._device.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.name}: {line.strip()}")

    from tissue_image_processing_tpu_torch.core.pipeline import _reference_frames
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    frames = _reference_frames(make_movie(T=2, Z=1, H=1024, W=1024, seed=2),
                               0, torch.device("cuda"))
    rows = check_kernels(frames)
    t0 = time.time()
    movie_z1 = make_movie(T=8, Z=1, H=1024, W=1024, seed=0).astype(np.uint16)
    movie_z30 = make_movie(T=8, Z=30, H=1024, W=1024, seed=0).astype(np.uint16)
    print(f"movies {movie_z1.shape} and {movie_z30.shape} uint16 made in "
          f"{time.time() - t0:.1f} s")
    preds = synthetic_predictions(movie_z1)
    rows.update(check_cc_scan(preds))
    unet_rows = check_settle_unet(preds)
    check_postprocess(preds)
    del preds
    stack = torch.from_numpy(make_movie(T=1, Z=30, H=1024, W=1024, seed=2)[0]
                             .astype(np.uint16)).cuda()
    rows.update(check_projection_kernels(stack))
    projection_breakdown(stack, card)
    check_fused_vs_unfused(stack)
    del stack
    check_pipeline(card, movie_z1)
    launches = check_pipeline(card, movie_z30)
    unet_launches = check_unet_pipeline(card, movie_z30)
    check_card_vs_cpu()

    table = []
    for name in KERNELS:
        r = rows[name]
        at_unet = {}
        if name in unet_rows:  # the same kernel on the U-Net path's input
            u = unet_rows[name]
            at_unet = {"max_abs_err_unet": u["err"], "ms_unet": u["ms"],
                       "plain_ms_unet": u["plain_ms"],
                       "bound_ms_unet": u["bound"][0],
                       "bound_by_unet": u["bound"][1]}
        table.append({
            "name": name, "route": "cuda",
            "source": KERNEL_SOURCE.get(name, FLOOD_SOURCE),
            "replaces": REPLACES[name],
            "launches": (unet_launches if name == "cc_scan" else launches)[name],
            "launches_unet": unet_launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], **at_unet})
    print(json.dumps({"kernels": table}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
