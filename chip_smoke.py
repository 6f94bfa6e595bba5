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
   passes on one (2, 30, 1024, 1024) uint16 frame and its z-map. Blur to
   rtol 2e-6 / atol 1e-4; the diffusions, the settle mask, the settle
   (labels AND arrival stamps) and both projection passes bit for bit;
   then the device time of each step of ``fused_projection`` on that frame;
3. hold the fused projection against the unfused one on the card (the JAX
   tolerance class: >= 99% of pixels within one plane, median relative
   error < 0.02 where the z-maps agree);
4. drive ``movie_pipeline`` on a synthetic pre-projected movie (T=8, C=2,
   Z=1, 1024^2) and then on the raw headline movie (T=8, C=2, Z=30,
   1024^2 uint16), each with the launch counters zeroed just before and
   read just after: every kernel of the path launched (the two projection
   kernels once a frame), cells per frame and id persistence as expected,
   ``movie_pipeline_chunked`` (3-frame chunks) identical to the unchunked
   run; print frames/s and the pipeline's own stage seconds;
5. compare the card with the CPU path of the port on small movies: the
   pre-projected watershed path, the fused projection (2, 8, 128, 128)
   against its plain route on CPU tensors, and a Z > 1 pipeline at a shape
   the fused gate refuses (96^2, Z=6), so both take the unfused route;
6. print the kernel table as one JSON object (launches from the Z=30
   run), then the card's line, and as the last line
   ``{"ok": true, "device": {...}}``.

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
}
KERNELS = ("blur3d", "diffusion_bf", "diffusion_cc", "settle_mask", "settle",
           "proj_score", "proj_project")
PROJECTION_KERNELS = ("proj_score", "proj_project")


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


def check_pipeline(card: str, Z: int):
    """Phase 4: one main path (Z == 1 pre-projected, or the raw Z-plane
    movie), its launch counts, chunked == unchunked."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core.pipeline import (
        movie_pipeline, movie_pipeline_chunked)
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    kw = dict(batch=2, capacity=1024, block_size=101, std=3.0)
    T = 8
    t0 = time.time()
    movie = make_movie(T=T, Z=Z, H=1024, W=1024, seed=0).astype(np.uint16)
    print(f"movie {movie.shape} uint16 made in {time.time() - t0:.1f} s")
    movie_pipeline(movie[:2], **kw)  # warm: library loads, allocator, cuFFT plans
    torch.cuda.synchronize()
    tipt.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    out = movie_pipeline(movie, timings=stages, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tipt.LAUNCHES)
    expected = [k for k in KERNELS if Z > 1 or k not in PROJECTION_KERNELS]
    missing = [k for k in expected if launches[k] == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
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


def check_card_vs_cpu():
    """Phase 5: the card against the port's CPU path on small inputs."""
    import torch

    from tissue_image_processing_tpu_torch.core.pipeline import movie_pipeline
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
    stack = torch.from_numpy(make_movie(T=1, Z=30, H=1024, W=1024, seed=2)[0]
                             .astype(np.uint16)).cuda()
    rows.update(check_projection_kernels(stack))
    projection_breakdown(stack, card)
    check_fused_vs_unfused(stack)
    del stack
    check_pipeline(card, Z=1)
    launches = check_pipeline(card, Z=30)
    check_card_vs_cpu()

    table = []
    for name in KERNELS:
        r = rows[name]
        table.append({
            "name": name, "route": "cuda",
            "source": KERNEL_SOURCE.get(name, FLOOD_SOURCE),
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": table}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
