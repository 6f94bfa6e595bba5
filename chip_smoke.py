#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tissue_image_processing_tpu_torch``).

    python3 chip_smoke.py            # needs one CUDA card; run from the repo root

Phases (any failure exits non-zero; no phase catches and continues):

1. print the card's name and power limit, build every CUDA kernel from
   ``tissue_image_processing_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card, on the
   main path's shapes (the blur on a batch of two thresholded 1024^2 frames,
   as ``watershed_segmentation_batch`` hands it over; the floods on the two
   frames row-stacked to 2112 x 1024): blur to rtol 2e-6 / atol 1e-4, the diffusions, the settle
   mask and the settle (labels AND arrival stamps) bit for bit; time each;
3. drive ``movie_pipeline`` on a synthetic pre-projected movie (T=8, C=2,
   Z=1, 1024^2) with launch counters zeroed just before and read just after,
   read the pipeline's own stage timings from that run, check every kernel
   launched, that ``movie_pipeline_chunked`` (3-frame
   chunks) gives identical ids, labels and areas, that the card's pipeline
   agrees with the CPU path of the port on a small movie, and print frames/s;
4. print the kernel table as one JSON object, then the card's line, and as
   the last line ``{"ok": true, "device": {...}}``.

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
KERNEL_SOURCE = {"blur3d": "tissue_image_processing_tpu_torch/csrc/blur3d.cu"}
FLOOD_SOURCE = "tissue_image_processing_tpu_torch/csrc/flood.cu"
REPLACES = {
    "blur3d": "tissue_image_processing_tpu/ops/blur_pallas.py:130",
    "diffusion_bf": "tissue_image_processing_tpu/ops/flood_pallas.py:431",
    "diffusion_cc": "tissue_image_processing_tpu/ops/flood_pallas.py:447",
    "settle_mask": "tissue_image_processing_tpu/ops/flood_pallas.py:713",
    "settle": "tissue_image_processing_tpu/ops/flood_pallas.py:1416",
}


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


def check_pipeline(card: str):
    """Phase 3: the main path, its launch counts, chunked == unchunked, and
    agreement with the CPU path on a small movie."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core.pipeline import (
        movie_pipeline, movie_pipeline_chunked)
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    kw = dict(batch=2, capacity=1024, block_size=101, std=3.0)
    t0 = time.time()
    movie = make_movie(T=8, Z=1, H=1024, W=1024, seed=0).astype(np.uint16)
    print(f"movie (8, 2, 1, 1024, 1024) uint16 made in {time.time() - t0:.1f} s")
    movie_pipeline(movie[:2], **kw)  # warm: library loads, allocator, cuFFT plans
    torch.cuda.synchronize()
    tipt.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    out = movie_pipeline(movie, timings=stages, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tipt.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"

    labels = out["labels"].cpu().numpy()
    assert labels.shape == (8, 1024, 1024), labels.shape
    n_cells = [int(np.unique(l).size - 1) for l in labels]
    assert min(n_cells) > 200, n_cells
    assert np.isfinite(out["drifts"]).all() and np.abs(out["drifts"]).max() < 5
    ids = out["ids"]
    assert ids.shape == (8, 1024) and (ids > 0).sum(axis=1).min() > 200
    # a cell seen in frame 0 should mostly keep its id to the last frame
    kept = np.intersect1d(ids[0][ids[0] > 0], ids[-1][ids[-1] > 0]).size
    assert kept > 0.5 * (ids[0] > 0).sum(), kept

    got = movie_pipeline_chunked(movie, chunk_frames=3, **kw)
    assert np.array_equal(got["ids"], ids), "chunked ids differ"
    assert np.array_equal(got["labels"], labels), "chunked labels differ"
    assert np.array_equal(got["tables"].area.numpy(),
                          out["tables"].area.cpu().numpy()), "chunked areas differ"

    small = make_movie(T=4, Z=1, H=128, W=128, seed=1)
    skw = dict(batch=2, capacity=128, block_size=31, std=3.0)
    on_card = movie_pipeline(small, **skw)
    on_cpu = movie_pipeline(small, device="cpu", **skw)
    agree = float((on_card["labels"].cpu().numpy()
                   == on_cpu["labels"].numpy()).mean())
    assert agree >= 0.995, f"card vs CPU label agreement {agree}"
    print(f"pipeline: cells/frame {n_cells}, chunked(3) == unchunked, "
          f"card vs CPU label agreement {agree:.6f} (128^2 x 4)")
    print(f"movie_pipeline 8 x 1024^2 Z=1: {8 / secs:.3f} frames/s "
          f"({secs:.3f} s) on {card}; launches {launches}")
    print("stage seconds (8 x 1024^2): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f" on {card}")
    return launches


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
    launches = check_pipeline(card)

    table = []
    for name in ("blur3d", "diffusion_bf", "diffusion_cc", "settle_mask", "settle"):
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
