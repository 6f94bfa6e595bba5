#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tissue_image_processing_tpu_torch``).

    python3 chip_smoke.py            # needs one CUDA card; run from the repo root
    python3 chip_smoke.py parallel   # the build and the "parallel" phase alone
    python3 chip_smoke.py cards      # its mesh of every card, against one card
    python3 chip_smoke.py radii      # the build and the "radii" phase alone
    python3 chip_smoke.py cellpose   # the build and the "cellpose" phase alone
    python3 chip_smoke.py auction    # the build and the "auction" phase alone

Phases (any failure exits non-zero; no phase catches and continues):

1. print the card's name and power limit, build every CUDA kernel from
   ``tissue_image_processing_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card, on the
   main path's shapes, and time the kernel, the plain version and (where one
   exists) one PyTorch library call computing the same function:
   the blur on a batch of two thresholded 1024^2 frames, as
   ``watershed_segmentation_batch`` hands it over, and along z alone on the
   (30, 256, 256) score volume, as the projection's small-score blur hands
   it over; the floods on the two
   frames row-stacked to 2112 x 1024; the projection's score and project
   passes on one (2, 30, 1024, 1024) uint16 frame and its z-map; the
   union-find component minimum on eight boundary maps of 1024^2
   row-stacked to 8320 x 1024, as the U-Net post-process floods them (with
   the index init and a poisoned init, against its plain version AND the
   relaxation kernel), on a coil, a checkerboard and an all-true image of
   that size, on shapes that no tile divides and on two small winding
   masks; the two diffusions also on an image-wide plateau and a ragged
   shape; every run of the redesigned kernels twice, the results equal;
   the settle and its mask once more on that stacked U-Net input (lam ==
   img, ties everywhere), no host synchronisation inside a settle call, and
   the settle on the inputs where a tiled schedule is weakest (one corner
   seed on a flat image of every tile, serpentine corridors, seeds on tile
   borders, lines along a tile seam and through a tile corner, +inf voids,
   negative seeds, shapes no tile divides and below one tile); the project
   pass also with ``atoh_shift``, with the airyscan offset, on a ragged
   stack and on a z-map with a full-range step (every plane admitted).
   The int8 U-Net's conv kernel (``conv3x3_s8``) at every 3x3 conv shape of
   the depth-3, 128-filter network on eight 1024^2 frames, the int8 main
   path's batch (single and split convs, Cin = 2 included), in the form it
   picks for the shape (tensor core or first conv) and in the generic form,
   against its plain version and a ``torch._int_mm`` route (each case's
   inputs checksummed before and after), the two forms
   timed in turns (generic, picked, picked, generic) beside cuDNN's
   bfloat16 conv of the same shape. The blur, the diffusions, the component
   minimum, the settle mask, the settle (labels AND arrival stamps), both
   projection passes and the int8 conv bit for bit; times are the median of
   five repeats of a CUDA-event bracket, the redesigned kernels' with their
   spread, and for the score pass, the blur and the settle mask also the
   device time of calls replayed from a CUDA graph; then the device time of
   each step of ``fused_projection`` on that frame;
3. the functions ported beside the main path, at full width on 1024^2
   frames, each on the card against the CPU route with the kernels it
   launches asserted: ``watershed_segmentation`` on one frame (equal to
   frame 0 of the batch form), ``connected_components`` of its cells
   (4-connected through the union-find scan, 8-connected through the plain
   route), ``contact_length_matrix`` (both forms), ``segment_percentile``,
   ``band_pass_filter`` (its blur in the walk form) and
   ``local_drift_field``;
4. hold the fused projection against the unfused one on the card (the JAX
   tolerance class: >= 99% of pixels within one plane, median relative
   error < 0.02 where the z-maps agree), and ``unet_postprocess_batch`` on
   the card against the CPU route (exact);
5. drive ``movie_pipeline`` on a synthetic pre-projected movie (T=8, C=2,
   Z=1, 1024^2), on the raw headline movie (T=8, C=2, Z=30, 1024^2 uint16)
   and on that movie through the U-Net branch at the reference
   architecture's full width (depth 3, 128 base filters, bfloat16, batch 8,
   seeded random weights with non-trivial BatchNorm statistics folded to
   shifts, head bias calibrated so about half the pixels pass the HC
   threshold), each with the launch counters zeroed just before and read
   just after, and the U-Net branch once more with the int8 configuration
   of the same weights (calibrated on the movie's first projected frame):
   every kernel of the path launched (the two projection
   kernels once a frame; one launch a diffusion call and a settle call, four
   a component minimum; on the U-Net branch the component minimum, the
   settle and its mask, and NOT the Bellman-Ford flood; the blur's launches
   by shape: the pre-blur once a flood, the score blur once a frame of a
   Z > 1 movie), cells per frame and id
   persistence as expected, ``movie_pipeline_chunked`` (3-frame chunks)
   identical to the unchunked run; print frames/s and the pipeline's own
   stage seconds; int8 against bfloat16: 14 ``conv3x3_s8`` launches a
   forward (13 of the tensor-core form, 1 of the first-conv form), each of
   the batch-8 forward's convs equal to the plain version
   on its inputs, HC-mask agreement >= ``INT8_HC_FLOOR`` (witnessed by the
   JAX package's own pair: ``tests/int8_witness.py``) and the label Dice
   (``bench.py``'s accuracy pair);
6. compare the card with the CPU path of the port on small movies: the
   pre-projected watershed path, the fused projection (2, 8, 128, 128)
   against its plain route on CPU tensors, a Z > 1 pipeline at a shape
   the fused gate refuses (96^2, Z=6), so both take the unfused route, and
   the U-Net branch (probabilities within 0.01, two and a half bfloat16
   steps: the card rounds each conv's output once more; foreground
   agreement >= 0.99); full-width Keras weight arrays mapped by the loader
   into a predictor on the card equal to the CPU, tensor for tensor (the
   file reading needs ``h5py``, which the card's machine lacks); ``train_unet``
   with the reference recipe (depth 2, 128 filters, batch 32, 256^2,
   bfloat16) for 10 steps (steps/s, finite loss) and one float32 step on the
   card against the CPU;
7. "files": the file layer and the projection driver. The headline
   movie's frames tiled 2 x 2 to (8, 2, 30, 2048, 2048) uint16 (4.0 GB)
   and written through ``MovieStore.create`` / ``write_frame`` into a
   temporary directory under ``build/`` (removed at the end); the
   projection CLI (``projection.cli.main``, ``tip-project``) on that
   ``.npy`` store with the counters zeroed: file-to-file frames/s, its
   ``StageMetrics`` seconds and ``blur3d``'s launches by shape (3 a frame),
   its z-maps equal to ``project_movie_array`` on the in-memory array and
   ``position1.tif`` to those projections as uint16; a 1024^2 crop on the
   card against the CPU (z-maps >= 99.9% equal, |dz| <= 1, projections
   rtol 1e-4); ``large_image_projection`` of a (1, 2, 30, 3000, 2600) fixed
   sample in 1024 tiles (9, 5 ragged), each tile equal to that tile
   projected alone; ``movie_pipeline_chunked`` fed from a ``MovieStore`` of
   the headline movie equal to ``movie_pipeline`` on the in-memory array;
   the ``project`` stage of one 4-frame batch traced with the profiler,
   the blurs in the generic and in the walk form (the ten costliest device
   operations, the device-busy share, the blurs' share); the production
   envelope: ``movie_pipeline`` on T=2 of (2, 40, 2000, 2000) uint16
   frames cut from the tiled frames (the unfused route: no fused-kernel
   launch; ``blur3d``'s launches by shape and form; frames/s). The TIFF
   legs run where PIL is installed; the phase prints which optional
   packages it found;
8. "tissue": the ``Tissue`` session (``check_tissue``). The headline raw
   movie's ``movie_pipeline`` output populates a session on the card as
   the JAX package's ``cmd_pipeline`` does (one stacked read-back of the
   tables); each session step is timed with its kernel launches (none of
   its own): cell types (and the peak-gated form), their repair, events,
   contact matrices, every feature name, re-tracking from images, an edit
   with two undos (bit for bit), ``.seg`` save and load (equal); the same
   steps on a CPU session are held to the card's (exact but the float
   features, 1e-5, and the re-tracked drifts, one 0.01 px bin); planted
   events at 2000 cells on 1024^2 are found, none on a static tissue; the
   example analyses ``examples/event_rates_torch.py`` and
   ``examples/survival_by_neighbors_torch.py`` on the card's ``.seg``,
   their CSV and JSON outputs on the card equal to ``device="cpu"``;
9. "cli": the session front end (``check_cli``). The main CLI's ``main``
   on the card, file to file, with the headline movie written as a
   ``.npy`` store under ``build/``: ``pipeline --events`` (every watershed
   kernel launched as often as ``movie_pipeline`` launches it; the session
   equal to the "tissue" phase's in-memory one; ``--chunk 4`` equal) and
   ``pipeline --unet --quantize`` at depth 3 / 128 filters from a seeded
   Keras weights file (``cc_scan`` and ``conv3x3_s8`` launched;
   ``--chunk 4`` equal), frames/s of both; on a Z = 1 store of the
   projected frames ``segment`` (labels equal to the pipeline's),
   ``types``, ``track --use-images --fix-types``, ``events``, ``export``
   in all five formats, ``analyze``, ``warmup`` (and ``--unet
   --quantize``), ``view`` through a stub napari with one click in each
   mode (equal to direct ``SegmentationEditor`` calls); the chain on a
   256^2 crop on the card against the CPU (exact but the drifts, one bin);
   TV-L1 on a projected 1024^2 frame pair (card vs CPU in the CPU tests'
   class, ms a pair) and the flow tracker over the 8 frames (ids card == CPU); each
   subcommand's seconds;
10. "parallel": ``parallel/`` (``check_parallel``) over virtual meshes of
    four positions on the one card (``devices=[torch.device("cuda")] *
    4``), each position on a CUDA stream of its own, the shard bodies of
    the sharded paths under ``torch.cuda.set_sync_debug_mode("error")``
    (a host synchronisation fails the run): the frame-sharded watershed
    on the headline movie (ids equal to the unsharded chain, the unfused
    projection's blurs and the flood launched, not the fused kernels),
    the chunked form from a ``MovieStore`` (chunk 4, and a padded tail on
    a T=6 cut), the frame-sharded U-Net at depth 3 / 128 filters /
    bfloat16 (ids equal, ``cc_scan`` launched), the space-sharded
    projection of two frames tiled to 2048^2 over (frame, y, x) = (1, 2,
    2) and (2, 2, 1) against the unsharded precise projection (clip
    equal; z-maps equal wherever the score's top two planes are more than
    1e-5 apart; projections rtol 2e-4 / atol 2e-3) with ``blur3d`` at each
    shard shape bit for bit and timed; each of these in its serial and
    streams forms, bit for bit equal, the frames/s of each (three runs,
    in turns); one watershed run traced: each shard's
    hand-written kernels on its position's stream, the overlapped device
    ms, the busy share, the host seconds to queue a shard body against
    its device seconds; where two or more cards are visible, the
    watershed and U-Net on a mesh of every card (ids equal to one card);
    the (data 2 x model 2) training step against ``make_train_step``
    (float32 and, in each form, float64: the CPU tests' tolerances) and
    10 bfloat16 steps a run of each form and of the unsharded step, in
    turns (steps/s), the step under ``set_sync_debug_mode("error")``, one
    run traced (its four position streams busy and their overlap); the
    card against the CPU on the CPU tests' tiny shapes, and the host
    synchronisations counted by path. ``cards`` runs the multi-card parts
    alone: the pipelines on a mesh of every card and, where four cards
    are visible, the training step over four of them (float64 hold, 10
    bfloat16 steps a run of each form, syncs 0);
10b. "radii": the adaptive radii's sweep (``csrc/radii.cu``,
   ``check_radii``) on the benchmark's ``raw_2000`` tables: one movie of
   the traffic file's recipe through the watershed ``movie_pipeline`` at
   both configurations' capacities (4096 and 8192), three
   ``radii_sweep`` launches and the solves counted on that path; on its
   tables the kernels (union-find in shared memory, and in device memory)
   against the plain sweep on CPU tensors and the host recursion, radii
   bit for bit and solves equal, the chunked call (carry) equal to the
   whole; the kernels' device time by kernel, the wrapper's, the plain
   sweep's and the recursion's;
10b'. "auction": the tracker's auction kernel (``csrc/auction.cu``,
   ``check_auction``) on the benchmark's ``preproj_2000`` tables: one movie
   of the traffic file's recipe through the watershed ``movie_pipeline``
   at both configurations' capacities (4096: persons x tracks 4096 x 8192,
   the state in shared memory; 8192: 8192 x 16384, in device memory), one
   ``auction`` launch a frame on that path; each frame's auction inputs
   captured from the tracking tail (``_track``) and, on them, the kernel
   against the plain loop on the same card tensors, ids and rounds bit for
   bit, the tail's ids with the loop in place of the kernel equal to the
   path's; the kernel's device time a frame by CUDA events and by the
   profiler, the plain loop's and the whole tail's host time in each form,
   and the bound (valid persons x C x 12 B a round, every round, at 3.35
   TB/s);
10c. "cellpose": Cellpose's flow following (``csrc/follow_flows.cu``,
   ``check_cellpose``) on the benchmark's ``cellpose_preproj_2000`` input:
   one movie of the ``preproj_2000`` recipe, the configuration's network
   as its set-up trains it, the port's flows of two 2000^2 frames;
   on their masked field the kernel against its plain version on the card,
   200 steps, bit for bit (two kernel runs equal too), the kernel's device
   time by graph-free CUDA-event brackets and by the profiler, the plain
   version's, the followed pixels and the bound of
   ``benchmark/costs/follow.py``; then the flow check's diffusion
   (``csrc/flow_diffuse.cu``, ``check_flow_diffuse``) on the first frame's
   masks against the plain whole-frame loop on the CPU, bit for bit (the
   global form too), timed by events and by the profiler beside the plain
   loop on the card and the bound of ``benchmark/costs/flow_qc.py``; then
   the Cellpose ``movie_pipeline`` on that movie, one ``follow_flows``
   launch a group of frames and one ``flow_diffuse`` launch a size class
   a frame, none of the global form;
11. print the kernel table as one JSON object (launches from the Z=30
    watershed run, the component minimum's from the U-Net run, the int8
    conv's from the int8 U-Net run, with its launches by form — its times
    summed over one forward's 14 convs at B = 8, the generic form's beside
    them, with each shape under ``by_shape`` — and each
    kernel's launches by function of phase 3; the blur at the driver's
    shapes as three rows ``blur3d_driver_*`` with the CLI run's launches;
    ``launches_cli`` / ``launches_cli_unet_int8``: the "cli" phase's two
    pipeline runs; ``launches_parallel``: the "parallel" phase's runs by
    path; the blur at the space shards' shapes as six rows
    ``blur3d_shard_*``). Before it, ``blur3d`` wherever the unfused
    projection runs it, on the path's own inputs: the driver's three
    shapes, the frame-sharded pipelines' (30, 1024, 1024), the band-pass
    filter's (1, 1024, 1024), the envelope's (40, 2000, 2000), the space
    shards' and ragged tiles of ``large_image_projection``: the form it
    picks and, where that is the walk form, the generic tile form, each bit
    for bit against the plain version and over two runs, the two timed by
    graph replay in turns (generic, walk, walk, generic; the walk form
    faster), beside ``conv3d``; each such row gives its ``form`` and
    ``generic_ms``. Then the card's line, and as the last line
    ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# H100 SXM float64 outside the tensor cores, unfused: the data sheet's 34
# TFLOP/s counts a fused multiply-add as two; csrc/radii.cu forbids fusing
F64_OPS_PER_S = 17e12
KERNEL_SOURCE = {
    "blur3d": "tissue_image_processing_tpu_torch/csrc/blur3d.cu",
    "proj_score": "tissue_image_processing_tpu_torch/csrc/projection.cu",
    "proj_project": "tissue_image_processing_tpu_torch/csrc/projection.cu",
    "cc_scan": "tissue_image_processing_tpu_torch/csrc/cc_scan.cu",
    "conv3x3_s8": "tissue_image_processing_tpu_torch/csrc/conv_s8.cu",
    "radii_sweep": "tissue_image_processing_tpu_torch/csrc/radii.cu",
    "follow_flows": "tissue_image_processing_tpu_torch/csrc/follow_flows.cu",
    "flow_diffuse": "tissue_image_processing_tpu_torch/csrc/flow_diffuse.cu",
    "auction": "tissue_image_processing_tpu_torch/csrc/auction.cu",
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
    # an XLA int8 convolution in the JAX package, not a Pallas kernel
    "conv3x3_s8": "tissue_image_processing_tpu/models/quant.py:65",
}
KERNELS = ("blur3d", "diffusion_bf", "diffusion_cc", "settle_mask", "settle",
           "proj_score", "proj_project", "cc_scan", "conv3x3_s8")
PROJECTION_KERNELS = ("proj_score", "proj_project")
WATERSHED_KERNELS = ("blur3d", "diffusion_bf", "diffusion_cc", "settle_mask",
                     "settle")
UNET_KERNELS = ("cc_scan", "settle_mask", "settle")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


REPEATS = 5


def cuda_ms_spread(fn, reps: int):
    """Device time of ``fn()``: after one warm call, ``REPEATS`` brackets of
    CUDA events around ``reps`` calls each. Returns (median, least, most) of
    the brackets' means."""
    import torch

    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / reps)
    means.sort()
    return means[REPEATS // 2], means[0], means[-1]


def cuda_ms(fn, reps: int) -> float:
    return cuda_ms_spread(fn, reps)[0]


def spread(ms) -> str:
    return f"{ms[0]:.4f} ms ({ms[1]:.4f}..{ms[2]:.4f} over {REPEATS} repeats)"


def kernel_split(fn, reps: int) -> str:
    """Device microseconds a call of each kernel that ``fn()`` launches, by
    the profiler's trace of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    def device_us(e):  # the attribute's name changed between PyTorch versions
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)

    rows = [(e.key.split("::")[-1].split("(")[0], device_us(e) / reps)
            for e in prof.key_averages() if device_us(e) > 0]
    assert rows, "the profiler recorded no device time"
    return ", ".join(f"{k} {us:.1f}" for k, us in sorted(rows, key=lambda r: -r[1]))


def device_profile(fn, rows: bool = False, trace: Optional[str] = None):
    """(device operations launched, their summed device ms) of one call of
    ``fn()`` after a warm one, by the profiler's CUDA trace: against the
    call's wall time it says how much of it the card was busy. With
    ``rows``, also the traced call's host-clock ms (profiler on) and its
    device operations as (name, count, device ms), costliest first. With
    ``trace``, the Chrome trace is written to that path (for
    :func:`stream_activity`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace is not None:
        prof.export_chrome_trace(trace)

    def device_ms(e):  # the attribute's name changed between PyTorch versions
        return (getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0)) / 1e3

    ops = sorted(((e.key, e.count, device_ms(e)) for e in prof.key_averages()
                  if device_ms(e) > 0), key=lambda r: -r[2])
    assert ops, "the profiler recorded no device time"
    summary = (sum(n for _, n, _ in ops), sum(ms for _, _, ms in ops))
    return (*summary, wall_ms, ops) if rows else summary


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
    ws = importlib.import_module("tissue_image_processing_tpu_torch.ops.watershed")
    from tissue_image_processing_tpu_torch.ops.filters import (
        gaussian_blur, gaussian_kernel1d)
    from tissue_image_processing_tpu_torch.ops.local_threshold import (
        threshold_local_max)
    from tissue_image_processing_tpu_torch.utils.kernel_variants import graph_ms

    rows = {}
    taps = gaussian_kernel1d(3.0)
    thr = 0.2 * threshold_local_max(frames, 101)
    seg = torch.where(frames < thr, 0.0, frames)

    # blur3d: the (2, 1024, 1024) batch, sigma 3 (25 taps per axis), as
    # _preprocess passes it (one launch per batch of two frames)
    x = seg.contiguous()
    got = blur_cuda.blur3d(x, (1.0,), taps, taps)
    want = blur_cuda.blur3d_plain(x, (1.0,), taps, taps)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(blur_cuda.blur3d(x, (1.0,), taps, taps), got), \
        "blur3d: two runs differ"
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
    # the volume read once and written once; a multiply and an add a tap
    ms = cuda_ms_spread(lambda: blur_cuda.blur3d(x, (1.0,), taps, taps), 50)
    rows["blur3d"] = dict(
        err=max_abs_err(got, want), ms=ms[0], ms_min=ms[1], ms_max=ms[2],
        device_ms=graph_ms(lambda: blur_cuda.blur3d(x, (1.0,), taps, taps)),
        plain_ms=cuda_ms(lambda: blur_cuda.blur3d_plain(x, (1.0,), taps, taps), 5),
        bound=bound(8 * nvox, 2 * (1 + 2 * len(taps)) * nvox), library_ms=lib_ms)
    print(f"blur3d {tuple(x.shape)} taps (1, 25, 25): bit-exact (max_abs_err "
          f"{rows['blur3d']['err']:.3g}), two runs equal, kernel {spread(ms)}, "
          f"device {rows['blur3d']['device_ms']:.4f} ms, "
          f"plain {rows['blur3d']['plain_ms']:.4f} ms, conv2d {lib_ms:.4f} ms, "
          f"bound {rows['blur3d']['bound'][0]:.4f} ms ({rows['blur3d']['bound'][1]})")

    # the flood on the two frames row-stacked, as watershed_batch floods them
    img = ws.stack_frames(gaussian_blur(seg, (0.0, 3.0, 3.0)))
    H, W = img.shape
    npx = H * W
    # a different update order could only show in the sign of a zero
    assert not bool(torch.signbit(img).any()), "negative zero in the flood input"
    cand, init = ws.minima_candidates(img)
    got = flood_cuda.cc_diffusion(cand, init)
    rounds = int(flood_cuda._ROUNDS["diffusion_cc"])
    want, cc_sweeps = flood_cuda.cc_diffusion_plain(cand, init, return_sweeps=True)
    assert torch.equal(got, want), "cc_diffusion disagrees with its plain version"
    assert torch.equal(got, flood_cuda.cc_diffusion(cand, init)), \
        "cc_diffusion: two runs differ"
    # mask (1 B) and init (4 B) read once, the result (4 B) written once; a
    # compare and a min per pixel and direction. No term counts the sweeps or
    # rounds of any schedule
    ms = cuda_ms_spread(lambda: flood_cuda.cc_diffusion(cand, init), 20)
    rows["diffusion_cc"] = dict(
        err=max_abs_err(got, want), ms=ms[0], ms_min=ms[1], ms_max=ms[2],
        plain_ms=cuda_ms(lambda: flood_cuda.cc_diffusion_plain(cand, init), 1),
        bound=bound(9 * npx, 8 * npx), library_ms=None)
    print(f"diffusion_cc {H}x{W}: bit-exact, two runs equal, 1 launch, {rounds} "
          f"rounds (plain: {cc_sweeps} sweeps), kernel {spread(ms)}, plain "
          f"{rows['diffusion_cc']['plain_ms']:.4f} ms, bound "
          f"{rows['diffusion_cc']['bound'][0]:.4f} ms "
          f"({rows['diffusion_cc']['bound'][1]})")

    seeds = ws.regional_minima_labels(img)
    got = flood_cuda.bf_flood(img, seeds)
    rounds = int(flood_cuda._ROUNDS["diffusion_bf"])
    want, bf_sweeps = flood_cuda.bf_flood_plain(img, seeds, return_sweeps=True)
    assert torch.equal(got, want), "bf_flood disagrees with its plain version"
    assert torch.equal(got, flood_cuda.bf_flood(img, seeds)), \
        "bf_flood: two runs differ"
    # img, seeds read once, lam written once (4 B each); four mins, a max and
    # a min per pixel
    ms = cuda_ms_spread(lambda: flood_cuda.bf_flood(img, seeds), 20)
    rows["diffusion_bf"] = dict(
        err=max_abs_err(got, want), ms=ms[0], ms_min=ms[1], ms_max=ms[2],
        plain_ms=cuda_ms(lambda: flood_cuda.bf_flood_plain(img, seeds), 1),
        bound=bound(12 * npx, 6 * npx), library_ms=None)
    print(f"diffusion_bf {H}x{W}: bit-exact, two runs equal, 1 launch, {rounds} "
          f"rounds (plain: {bf_sweeps} sweeps), kernel {spread(ms)}, plain "
          f"{rows['diffusion_bf']['plain_ms']:.4f} ms, bound "
          f"{rows['diffusion_bf']['bound'][0]:.4f} ms "
          f"({rows['diffusion_bf']['bound'][1]})")
    check_diffusion_hard_cases(img, seeds)

    lam = got
    got = flood_cuda.settle_mask(lam)
    want = flood_cuda.settle_mask_plain(lam)
    assert torch.equal(got, want), "settle_mask disagrees with its plain version"
    # lam read once, the mask written once (8 B/px); eight compares a pixel
    rows["settle_mask"] = dict(
        err=max_abs_err(got, want),
        ms=cuda_ms(lambda: flood_cuda.settle_mask(lam), 50),
        device_ms=graph_ms(lambda: flood_cuda.settle_mask(lam)),
        plain_ms=cuda_ms(lambda: flood_cuda.settle_mask_plain(lam), 5),
        bound=bound(8 * npx, 8 * npx), library_ms=None)

    rows["settle"] = settle_row(lam, seeds, f"settle {H}x{W}", reps=10)
    print(f"settle_mask {H}x{W}: bit-exact, kernel "
          f"{rows['settle_mask']['ms']:.4f} ms, device "
          f"{rows['settle_mask']['device_ms']:.4f} ms, bound "
          f"{rows['settle_mask']['bound'][0]:.4f} ms "
          f"({rows['settle_mask']['bound'][1]})")
    check_settle_hard_cases(lam.device)
    return rows


def settle_row(lam, seeds, name: str, reps: int):
    """The settle on (lam, seeds): labels AND arrival stamps bit for bit
    against the plain version, two runs equal, the sweep count the kernel
    left on the card equal to the plain version's, no host synchronisation
    inside the call; then its time, spread and bound."""
    import torch

    from tissue_image_processing_tpu_torch.ops import flood_cuda

    npx = lam.numel()
    got_l, got_t = flood_cuda.settle(lam, seeds)
    rounds = int(flood_cuda._ROUNDS["settle"])
    sweeps = int(flood_cuda._SWEEPS["settle"])
    want_l, want_t, plain_sweeps = flood_cuda.settle_plain(lam, seeds,
                                                           return_sweeps=True)
    assert torch.equal(got_l, want_l), f"{name}: labels disagree with plain"
    assert torch.equal(got_t, want_t), f"{name}: stamps disagree with plain"
    assert sweeps == plain_sweeps, (name, sweeps, plain_sweeps)
    # a call that read anything back would raise here
    torch.cuda.set_sync_debug_mode("error")
    try:
        again_l, again_t = flood_cuda.settle(lam, seeds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(again_l, got_l) and torch.equal(again_t, got_t), \
        f"{name}: two runs differ"
    # the comparison's inputs lam + seeds read once, lbl + t written once
    # (16 B/px), ~40 integer operations a pixel. No term counts the sweeps of
    # any schedule; the old rule (40 operations a pixel and plain sweep) is
    # printed beside it
    ms = cuda_ms_spread(lambda: flood_cuda.settle(lam, seeds), reps)
    row = dict(
        err=max(max_abs_err(got_l, want_l), max_abs_err(got_t, want_t)),
        ms=ms[0], ms_min=ms[1], ms_max=ms[2],
        plain_ms=cuda_ms(lambda: flood_cuda.settle_plain(lam, seeds), 2),
        bound=bound(16 * npx, 40 * npx), library_ms=None)
    old_rule = bound(16 * npx, 40 * npx * plain_sweeps)
    print(f"{name}: lbl and t bit-exact, two runs equal, 1 launch, no host "
          f"synchronisation, {rounds} rounds, {sweeps} sweeps (plain: "
          f"{plain_sweeps}), kernel {spread(ms)}, plain {row['plain_ms']:.4f} ms,"
          f" bound {row['bound'][0]:.4f} ms ({row['bound'][1]}; old rule "
          f"{old_rule[0]:.4f} ms, {old_rule[1]} x sweeps)")
    return row


def check_settle_hard_cases(device):
    """The settle where a tiled schedule is weakest (``settle_cases`` at the
    kernel's 64-pixel tile, with ragged shapes), and one corner seed on a
    flat image over every tile of the stacked shape: labels and stamps bit
    for bit against the plain version, two runs equal."""
    import torch

    from tissue_image_processing_tpu_torch.ops import flood_cuda
    from tissue_image_processing_tpu_torch.utils.synthetic import settle_cases

    cases = settle_cases(64, ((1, 1), (1, 700), (700, 1), (31, 65), (65, 31),
                              (1001, 931)))
    flat = np.full((2112, 1024), 0.25, np.float32)
    one_seed = np.zeros(flat.shape, np.int32)
    one_seed[-1, -1] = 1
    cases["plateau_every_tile"] = (flat, one_seed)
    for name, (lam, seeds) in cases.items():
        lam = torch.from_numpy(lam).to(device)
        seeds = torch.from_numpy(seeds).to(device)
        got_l, got_t = flood_cuda.settle(lam, seeds)
        rounds = int(flood_cuda._ROUNDS["settle"])
        sweeps = int(flood_cuda._SWEEPS["settle"])
        want_l, want_t, plain_sweeps = flood_cuda.settle_plain(
            lam, seeds, return_sweeps=True)
        assert torch.equal(got_l, want_l), f"settle ({name}): labels disagree"
        assert torch.equal(got_t, want_t), f"settle ({name}): stamps disagree"
        assert sweeps == plain_sweeps, (name, sweeps, plain_sweeps)
        again = flood_cuda.settle(lam, seeds)
        assert torch.equal(again[0], got_l) and torch.equal(again[1], got_t), name
        ms = cuda_ms(lambda: flood_cuda.settle(lam, seeds), 2)
        print(f"settle {name} {tuple(lam.shape)}: lbl and t bit-exact, two runs "
              f"equal, {rounds} rounds, {sweeps} sweeps, {ms:.4f} ms")


def check_diffusion_hard_cases(img, seeds):
    """The two diffusions where a tiled schedule is weakest: one plateau
    spanning the stacked image (a single seed in the far corner; an all-true
    mask with a random init), and a crop whose edges no tile divides. Bit
    for bit against the plain versions, two runs equal."""
    import torch

    from tissue_image_processing_tpu_torch.ops import flood_cuda

    H, W = img.shape
    gen = torch.Generator(device=img.device).manual_seed(1)
    flat = torch.full((H, W), 0.25, device=img.device)
    one_seed = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    one_seed[-1, -1] = 1
    crop = (slice(3, 3 + 1001), slice(5, 5 + 931))
    for name, im, sd in (("plateau", flat, one_seed),
                         ("ragged", img[crop].contiguous(),
                          seeds[crop].contiguous())):
        got = flood_cuda.bf_flood(im, sd)
        rounds = int(flood_cuda._ROUNDS["diffusion_bf"])
        want, sweeps = flood_cuda.bf_flood_plain(im, sd, return_sweeps=True)
        assert torch.equal(got, want), f"bf_flood ({name}) disagrees with plain"
        assert torch.equal(got, flood_cuda.bf_flood(im, sd)), name
        ms = cuda_ms(lambda: flood_cuda.bf_flood(im, sd), 3)
        print(f"diffusion_bf {name} {tuple(im.shape)}: bit-exact, two runs "
              f"equal, {rounds} rounds (plain: {sweeps} sweeps), {ms:.4f} ms")
    for name, shape in (("plateau", (H, W)), ("ragged", (1001, 931))):
        mask = torch.ones(shape, dtype=torch.bool, device=img.device)
        if name == "ragged":
            mask = torch.rand(shape, device=img.device, generator=gen) < 0.62
        n = shape[0] * shape[1]
        init = torch.randint(0, n, shape, device=img.device, generator=gen,
                             dtype=torch.int32)
        got = flood_cuda.cc_diffusion(mask, init)
        rounds = int(flood_cuda._ROUNDS["diffusion_cc"])
        # the plain scan: Jacobi sweeps would need one per pixel of the way
        want = flood_cuda.cc_scan_plain(mask, init)
        assert torch.equal(got, want), f"cc_diffusion ({name}) disagrees with plain"
        assert torch.equal(got, flood_cuda.cc_diffusion(mask, init)), name
        assert torch.equal(got, flood_cuda.cc_scan(mask, init)), name
        ms = cuda_ms(lambda: flood_cuda.cc_diffusion(mask, init), 3)
        print(f"diffusion_cc {name} {shape}: bit-exact vs the plain scan and the "
              f"union-find kernel, two runs equal, {rounds} rounds, {ms:.4f} ms")


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
    """Phase 2 for the union-find component minimum: bit-exact against its
    plain version and against the relaxation kernel at the U-Net path's
    shape, with the index init and a poisoned init, two runs equal; its
    time and bound; then the hard masks at that size and small ones."""
    import torch

    from tissue_image_processing_tpu_torch.models.predictor import _boundary
    from tissue_image_processing_tpu_torch.ops import flood_cuda
    ws = importlib.import_module("tissue_image_processing_tpu_torch.ops.watershed")
    from tissue_image_processing_tpu_torch.utils.synthetic import coil_mask

    boundary, _ = _boundary(preds, 0.1, 5, 7)
    img = ws.stack_frames(boundary.to(torch.float32))
    H, W = img.shape
    npx = H * W
    cand = ws._binary_candidates(img)
    idx = torch.arange(npx, dtype=torch.int32, device=img.device).reshape(H, W)
    gen = torch.Generator(device=img.device).manual_seed(0)
    poison = torch.rand(img.shape, device=img.device, generator=gen) < 0.01
    poisoned = torch.where(poison, idx - npx, idx)
    err = 0.0

    def exact(name, mask, init):
        """cc_scan on (mask, init): equal to the plain scan, to the
        relaxation kernel and to a second run."""
        got = flood_cuda.cc_scan(mask, init)
        assert torch.equal(got, flood_cuda.cc_diffusion(mask, init)), \
            f"cc_scan ({name}) disagrees with the relaxation kernel"
        rounds = int(flood_cuda._ROUNDS["diffusion_cc"])
        assert torch.equal(got, flood_cuda.cc_scan(mask, init)), \
            f"cc_scan ({name}): two runs differ"
        want, iters = flood_cuda.cc_scan_plain(mask, init, return_iterations=True)
        assert torch.equal(got, want), f"cc_scan ({name}) disagrees with plain"
        print(f"cc_scan {tuple(mask.shape)} {name}: bit-exact vs plain ({iters} "
              f"scan iterations) and vs the relaxation kernel ({rounds} "
              f"rounds), two runs equal")
        return max_abs_err(got, want)

    for name, init in (("index init", idx), ("poisoned init", poisoned),
                       ("default init", None)):
        err = max(err, exact(f"boundary maps, {name}", cand, init))
    # mask (1 B) and init (4 B) read once, the result (4 B) written once; the
    # function needs at least one compare and one min per pixel and direction
    # (how many passes a schedule takes to get there is its own affair), so
    # the byte term always sets the bound
    ms = cuda_ms_spread(lambda: flood_cuda.cc_scan(cand, idx), 20)
    row = dict(
        err=err, ms=ms[0], ms_min=ms[1], ms_max=ms[2],
        plain_ms=cuda_ms(lambda: flood_cuda.cc_scan_plain(cand, idx), 1),
        bound=bound(9 * npx, 8 * npx), library_ms=None)
    relax_ms = cuda_ms(lambda: flood_cuda.cc_diffusion(cand, idx), 2)
    print(f"cc_scan {H}x{W}: zero set {float(cand.float().mean()):.3f} of the "
          f"pixels, 4 launches, no host read, kernel {spread(ms)}, plain "
          f"{row['plain_ms']:.4f} ms, relaxation kernel {relax_ms:.4f} ms, bound "
          f"{row['bound'][0]:.4f} ms ({row['bound'][1]}), library: none")

    print(f"cc_scan {H}x{W} by pass, us a call: {kernel_split(lambda: flood_cuda.cc_scan(cand, idx), 5)}")

    # the hard masks at the path's size: one thin component winding through
    # the image, no link at all, one component over every tile
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    hard = (("coil, pitch 16", torch.from_numpy(coil_mask(H, W, 16)).cuda()),
            ("checkerboard", (yy + xx) % 2 == 0),
            ("all true", torch.ones((H, W), dtype=torch.bool, device=img.device)))
    for name, mask in hard:
        for kind, init in (("index", idx), ("poisoned", poisoned)):
            err = max(err, exact(f"{name}, {kind} init", mask, init))
        ms = cuda_ms(lambda: flood_cuda.cc_scan(mask, idx), 5)
        print(f"cc_scan {H}x{W} {name}: kernel {ms:.4f} ms")
    row["err"] = err

    # shapes no tile divides (32 for the union-find, 64 for the relaxation),
    # the open one-pixel rings of the JAX package's scan test and a
    # one-pixel serpentine (one component, 48 turns)
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
    small = [("rings", rings), ("serpentine", serpentine),
             ("coil, pitch 2", coil_mask(1001, 931, 2))]
    small += [(f"percolation {h}x{w}", rng.random((h, w)) < 0.62)
              for h, w in ((31, 65), (33, 63), (63, 33), (65, 31), (1, 1),
                           (1, 700), (700, 1), (1001, 931))]
    for name, mask in small:
        m = torch.from_numpy(mask).cuda()
        n = mask.size
        init = rng.integers(0, n, mask.shape).astype(np.int32)
        init = np.where(rng.random(mask.shape) < 0.1, init - n, init)
        exact(name, m, torch.from_numpy(init.astype(np.int32)).cuda())
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
    from tissue_image_processing_tpu_torch.utils.kernel_variants import graph_ms
    ws = importlib.import_module("tissue_image_processing_tpu_torch.ops.watershed")

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
        device_ms=graph_ms(lambda: flood_cuda.settle_mask(img)),
        plain_ms=cuda_ms(lambda: flood_cuda.settle_mask_plain(img), 3),
        bound=bound(8 * npx, 8 * npx))
    row = settle_row(img, seeds, f"settle {H}x{W} (U-Net input, lam == img, "
                     f"{int(seeds.max())} seeds)", reps=5)
    print(f"settle_mask {H}x{W} (U-Net input): bit-exact, kernel "
          f"{mask_row['ms']:.4f} ms, device {mask_row['device_ms']:.4f} ms, "
          f"plain {mask_row['plain_ms']:.4f} ms, bound "
          f"{mask_row['bound'][0]:.4f} ms ({mask_row['bound'][1]})")
    return {"settle": row, "settle_mask": mask_row}


def check_postprocess(preds):
    """Phase 4 for the U-Net post-process: the card against the CPU route,
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
    from tissue_image_processing_tpu_torch.utils.kernel_variants import graph_ms

    rows = {}
    C, Z, Y, X = stack.shape
    ref = stack[0]
    sub = ref[:, ::16, :].to(torch.float32)
    p95 = masked_percentile(sub, sub > 0, 95.0)
    got = fused.score_pass(ref, p95)
    want = fused.score_pass_plain(ref, p95)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(fused.score_pass(ref, p95), got), "proj_score: two runs differ"

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
    ms = cuda_ms_spread(lambda: fused.score_pass(ref, p95), 50)
    rows["proj_score"] = dict(
        err=max_abs_err(got, want), ms=ms[0], ms_min=ms[1], ms_max=ms[2],
        device_ms=graph_ms(lambda: fused.score_pass(ref, p95)),
        plain_ms=cuda_ms(lambda: fused.score_pass_plain(ref, p95), 5),
        bound=bound(2 * nvox + 4 * nvox // 16, 36 * nvox), library_ms=lib_ms)
    print(f"proj_score {tuple(ref.shape)}: bit-exact, two runs equal, 1 "
          f"launch, kernel {spread(ms)}, device "
          f"{rows['proj_score']['device_ms']:.4f} ms, plain "
          f"{rows['proj_score']['plain_ms']:.4f} ms, conv3d {lib_ms:.4f} ms "
          f"(max_abs_err vs plain {lib_err:.3g}), bound "
          f"{rows['proj_score']['bound'][0]:.4f} ms "
          f"({rows['proj_score']['bound'][1]})")
    rows["blur3d_score"] = check_score_blur(got)

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
    ms = cuda_ms_spread(lambda: fused.project_pass(stack, rel_z), 20)
    rows["proj_project"] = dict(
        err=max_abs_err(got, want), ms=ms[0], ms_min=ms[1], ms_max=ms[2],
        plain_ms=cuda_ms(lambda: fused.project_pass_plain(stack, rel_z), 3),
        bound=bound(2 * C * planes + 4 * Y * X + 4 * C * Y * X,
                    (68 + 2 * C) * planes), library_ms=None)
    print(f"proj_project {tuple(stack.shape)}: bit-exact, kernel {spread(ms)}, "
          f"plain {rows['proj_project']['plain_ms']:.4f} ms, bound "
          f"{rows['proj_project']['bound'][0]:.4f} ms "
          f"({rows['proj_project']['bound'][1]}; {planes / (Y * X):.2f} planes "
          f"a pixel of {Z}; reading every plane {all_planes:.4f} ms); z-map "
          f"range {int(rel_z.min())}..{int(rel_z.max())}")
    check_project_cases(stack, rel_z)
    return rows


def check_score_blur(small):
    """Phase 2 for the blur at its second main-path shape: the z axis (5
    taps) of the projection's small-score blur on the (Z, Y/4, X/4) score
    volume, which ``gaussian_blur`` hands to ``blur3d`` before its 61-tap
    band products. Bit for bit against the plain version, two runs equal;
    time, spread, bound and a library yardstick (``conv3d`` with a (5, 1, 1)
    kernel over the replicate-padded volume, cuDNN TF32 off)."""
    import torch
    import torch.nn.functional as F

    from tissue_image_processing_tpu_torch.ops import blur_cuda
    from tissue_image_processing_tpu_torch.ops.filters import gaussian_kernel1d
    from tissue_image_processing_tpu_torch.utils.kernel_variants import graph_ms

    kz, one = gaussian_kernel1d(0.5), (1.0,)
    got = blur_cuda.blur3d(small, kz, one, one)
    want = blur_cuda.blur3d_plain(small, kz, one, one)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(blur_cuda.blur3d(small, kz, one, one), got), \
        "blur3d (score blur): two runs differ"
    k3 = torch.tensor(kz, dtype=torch.float32,
                      device=small.device).reshape(1, 1, len(kz), 1, 1)
    rz = len(kz) // 2

    def library():
        xp = F.pad(small[None, None], (0, 0, 0, 0, rz, rz), mode="replicate")
        return F.conv3d(xp, k3)[0, 0]

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.testing.assert_close(library(), want, rtol=1e-5, atol=1e-3)
    lib_ms = cuda_ms(library, 20)
    torch.backends.cudnn.allow_tf32 = prev_tf32
    nvox = small.numel()
    ms = cuda_ms_spread(lambda: blur_cuda.blur3d(small, kz, one, one), 50)
    row = dict(
        err=max_abs_err(got, want), ms=ms[0], ms_min=ms[1], ms_max=ms[2],
        device_ms=graph_ms(lambda: blur_cuda.blur3d(small, kz, one, one)),
        plain_ms=cuda_ms(lambda: blur_cuda.blur3d_plain(small, kz, one, one), 5),
        bound=bound(8 * nvox, 2 * (len(kz) + 2) * nvox), library_ms=lib_ms)
    print(f"blur3d {tuple(small.shape)} taps ({len(kz)}, 1, 1) (score blur): "
          f"bit-exact (max_abs_err {row['err']:.3g}), two runs equal, kernel "
          f"{spread(ms)}, device {row['device_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, conv3d {lib_ms:.4f} ms, bound "
          f"{row['bound'][0]:.4f} ms ({row['bound'][1]})")
    return row


def check_project_cases(stack, rel_z):
    """The project pass off its main road, bit for bit against the plain
    version: the shifted mask for the other channels (either reference
    channel, both signs), the airyscan offset, both at once, a z-map with a
    full-range step (every plane admitted in the tiles on the step), and a
    ragged stack that no tile and no 16-byte word divides."""
    import torch

    from tissue_image_processing_tpu_torch.projection import fused

    C, Z, Y, X = stack.shape
    xx = torch.arange(X, device=stack.device)[None, :].expand(Y, X)
    step = torch.where(xx < X // 2 + 3, 0, Z - 1).to(torch.int32).contiguous()
    gen = torch.Generator(device=stack.device).manual_seed(3)
    ragged = torch.randint(0, 65536, (2, 7, 97, 131), device=stack.device,
                           generator=gen, dtype=torch.int32).to(torch.uint16)
    ragged_z = torch.randint(0, 7, (97, 131), device=stack.device,
                             generator=gen, dtype=torch.int32)
    cases = (("atoh_shift 2", stack, rel_z, dict(atoh_shift=2)),
             ("atoh_shift -3, reference channel 1", stack, rel_z,
              dict(atoh_shift=-3, ref_channel=1)),
             ("airyscan offset", stack, rel_z, dict(airyscan_offset=10000.0)),
             ("offset and shift", stack, rel_z,
              dict(airyscan_offset=10000.0, atoh_shift=1)),
             ("full-range step", stack, step, {}),
             ("ragged", ragged, ragged_z, dict(atoh_shift=1,
                                               airyscan_offset=5000.0)),
             ("ragged, one channel", ragged[:1].contiguous(), ragged_z, {}))
    for name, img, zmap, kw in cases:
        got = fused.project_pass(img, zmap, **kw)
        want = fused.project_pass_plain(img, zmap, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   msg=f"project_pass ({name}) disagrees with plain")
        ms = cuda_ms_spread(lambda: fused.project_pass(img, zmap, **kw), 5)
        print(f"proj_project {name} {tuple(img.shape)}: bit-exact, {spread(ms)}")


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
    """Phase 4: the fused projection against the unfused one on the card,
    to the JAX package's tolerance class (tests/test_projection_fused.py).
    Returns the unfused projection's walk-form blur inputs (its pre-blur
    and z-mask blur, as the frame-sharded pipelines run them) by (Z, Y, X,
    tz, ty, tx)."""
    from tissue_image_processing_tpu_torch.projection.fused import (
        fused_projection)
    from tissue_image_processing_tpu_torch.projection.surface import (
        time_point_surface_projection)

    pf, zf = fused_projection(stack, airyscan=False)
    Z, Y, X = stack.shape[1:]
    walk = {(Z, Y, X, 5, 9, 9), (Z, Y, X, 9, 17, 17)}
    with capture_blur_inputs(walk) as captured:
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
    return captured


PRE_BLUR = (2, 1024, 1024, 1, 25, 25)    # the watershed pre-blur, a flood's batch
SCORE_BLUR = (30, 256, 256, 5, 1, 1)     # the small-score blur's z axis, a frame


def blur_launches(expected) -> dict:
    """blur3d's launches of the run just made, by (Z, Y, X, tz, ty, tx),
    held to ``expected`` exactly; printed, and returned with string keys."""
    import tissue_image_processing_tpu_torch as tipt

    got = {k: v for k, v in tipt._device.BLUR_LAUNCHES.items() if v}
    want = {k: v for k, v in expected.items() if v}
    assert got == want, f"blur3d launches by shape {got}, expected {want}"
    named = {f"{k[:3]} taps {k[3:]}": v for k, v in got.items()}
    print(f"blur3d launches by shape: {named}")
    return named


def check_pipeline(card: str, movie):
    """Phase 5: one watershed main path (Z == 1 pre-projected, or the raw
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
    floods = -(-T // kw["batch"])
    by_shape = blur_launches({PRE_BLUR: floods,
                              SCORE_BLUR: T if Z > 1 else 0})
    forms = {k: v for k, v in tipt._device.BLUR_FORMS.items() if v}
    assert forms == {"tile25": floods, **({"z_only": T} if Z > 1 else {})}, forms
    expected = WATERSHED_KERNELS + (PROJECTION_KERNELS if Z > 1 else ())
    missing = [k for k in expected if launches[k] == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    assert launches["cc_scan"] == 0, launches
    # one launch a diffusion call: the BF flood once and the CC twice (the
    # minima search) for each stacked flood of two frames
    assert launches["diffusion_bf"] == floods, launches
    assert launches["diffusion_cc"] == 2 * floods, launches
    # and one settle, with its mask: a launch each
    assert launches["settle"] == floods, launches
    assert launches["settle_mask"] == floods, launches
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
    return launches, by_shape


INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core rate
INT8_HC_FLOOR = 0.96   # int8 vs bfloat16 HC agreement: check_int8_pipeline
# every 3x3 conv of the depth-3, 128-filter U-Net on a 1024^2 input: (side,
# input channels, output channels, skip channels of a split conv), with how
# many times a forward runs it
UNET_CONVS = (
    ((1024, 2, 128, 0), 1), ((1024, 128, 128, 0), 2), ((512, 128, 256, 0), 1),
    ((512, 256, 256, 0), 2), ((256, 256, 512, 0), 1), ((256, 512, 512, 0), 2),
    ((128, 512, 1024, 0), 1), ((128, 1024, 1024, 0), 1),
    ((256, 512, 512, 512), 1), ((512, 256, 256, 256), 1),
    ((1024, 128, 128, 128), 1))


def int_mm_route(x, skip, wq, wscale, bias, shift, s0, s1, so):
    """One library route to ``conv3x3_s8``'s function: the int32 sums by
    ``torch._int_mm`` over an im2col of the int8 input(s) (K padded to a
    multiple of 8), then the same float32 epilogue as the plain version."""
    import torch
    import torch.nn.functional as F

    from tissue_image_processing_tpu_torch.ops.conv_s8_cuda import exact_div

    def sums(t, w):
        B, H, W, C = t.shape
        tp = F.pad(t, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([tp[:, dy:dy + H, dx:dx + W] for dy in range(3)
                          for dx in range(3)], dim=-1).reshape(B * H * W, 9 * C)
        wk = w.permute(2, 3, 1, 0).reshape(9 * C, -1)
        pad = -(9 * C) % 8
        if pad:
            cols, wk = F.pad(cols, (0, pad)), F.pad(wk, (0, 0, 0, pad))
        return torch._int_mm(cols, wk.contiguous()).reshape(B, H, W, -1)

    cu = x.shape[-1]
    acc = sums(x, wq[:, :cu]).to(torch.float32)
    a0, q = exact_div(s0, 127.0), exact_div(127.0, so)
    if skip is None:
        y = acc * (wscale * a0) + bias
    else:
        y = (acc * a0 + sums(skip, wq[:, cu:]).to(torch.float32)
             * exact_div(s1, 127.0)) * wscale + bias
    y = torch.clamp_min(y, 0.0) + shift
    return torch.round(torch.clamp(y * q, -127.0, 127.0)).to(torch.int8)


def plain_in_slices(x, wq, wscale, bias, shift, x_scale, out_scale,
                    skip=None, skip_scale=None, step: int = 2):
    """``conv3x3_s8_plain`` over ``step`` frames at a time: its float64 sums
    of a batch-8 1024^2 conv would take tens of GiB, and the frames of a
    batch are independent, so the concatenation is the whole batch's
    result."""
    import torch

    from tissue_image_processing_tpu_torch.ops.conv_s8_cuda import (
        conv3x3_s8_plain)

    return torch.cat([conv3x3_s8_plain(
        x[i:i + step], wq, wscale, bias, shift, x_scale, out_scale,
        skip=None if skip is None else skip[i:i + step], skip_scale=skip_scale)
        for i in range(0, x.shape[0], step)])


def conv_case(gen, B: int, side: int, cin: int, cout: int, cs: int):
    """One conv shape of ``UNET_CONVS`` on B frames: random int8 inputs and
    weights, scales that spread the outputs over the int8 range. Returns
    (positional arguments, keyword arguments, packed weights) of
    ``conv3x3_s8``."""
    import torch

    from tissue_image_processing_tpu_torch.ops.conv_s8_cuda import packed_pair

    dev = torch.device("cuda")

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    x = i8(B, side, side, cin)
    skip = i8(B, side, side, cs) if cs else None
    wq = i8(cout, cin + cs, 3, 3)
    K = 9 * (cin + cs)
    # acc std ~ sqrt(K) * 127^2 / 3: scales that put y at ~half the range
    wscale = (0.5 + torch.rand(cout, generator=gen, device=dev)) * (
        127.0 / (2 * K ** 0.5 * 127 ** 2 / 3))
    bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
    shift = 0.1 * torch.randn(cout, generator=gen, device=dev)
    s0, s1, so = (torch.tensor(v, device=dev) for v in (1.0, 1.3, 1.0))
    kw = dict(skip=skip, skip_scale=s1 if cs else None)
    return (x, wq, wscale, bias, shift, s0, so), kw, packed_pair(
        wq, cin if cs else None)


def check_conv_s8(card: str, B: int = 8):
    """The int8 conv kernel against its plain version, bit for bit, at every
    3x3 conv shape of the depth-3, 128-filter U-Net on B 1024^2 frames, the
    shapes of the int8 main path's batch-8 forward (``conv_case``), two runs
    equal: the form ``conv3x3_s8`` picks for the shape (tensor core, or the
    first conv) and the generic form, each timed by CUDA-graph replay in
    turns (generic, picked, picked, generic); the plain version's time (two
    frames at a time), the ``torch._int_mm`` route's (equal to the kernel,
    checked) and cuDNN's bfloat16 conv of the same shape; the bound.
    Returns the kernel row: sums over one forward's 14 convs, and the
    shapes."""
    import torch
    import torch.nn.functional as F

    from tissue_image_processing_tpu_torch.ops.conv_s8_cuda import (
        _conv3x3_s8, conv3x3_s8, conv_s8_form)
    from tissue_image_processing_tpu_torch.utils.kernel_variants import (
        checksum, graph_ms)

    gen = torch.Generator(device="cuda").manual_seed(8)
    total = dict(ms=0.0, ms_2=0.0, generic_ms=0.0, generic_ms_2=0.0,
                 plain_ms=0.0, library_ms=0.0, library_bf16_ms=0.0,
                 bound_ms=0.0, ops=0.0, nbytes=0.0)
    err, shapes = 0.0, []
    for (side, cin, cout, cs), times in UNET_CONVS:
        args, kw, packed = conv_case(gen, B, side, cin, cout, cs)
        x, wq, wscale, bias, shift, s0, so = args
        skip, s1 = kw["skip"], kw["skip_scale"]
        form = conv_s8_form(cin, cs, cout)
        inputs = [t for t in (*args, *kw.values(), *packed)
                  if isinstance(t, torch.Tensor)]
        sums = [checksum(t) for t in inputs]

        def picked():
            return conv3x3_s8(*args, packed=packed, **kw)

        def generic():
            return _conv3x3_s8(*args, packed=packed, form="generic", **kw)

        got = picked()
        want = plain_in_slices(*args, **kw)
        assert torch.equal(got, want), \
            f"conv3x3_s8 ({form}) {side} {cin}+{cs}->{cout}"
        err = max(err, max_abs_err(got, want))
        assert torch.equal(picked(), got), "conv3x3_s8: two runs differ"
        assert torch.equal(generic(), want), \
            f"conv3x3_s8 (generic) {side} {cin}+{cs}->{cout}"
        lib = int_mm_route(x, skip, wq, wscale, bias, shift, s0, s1, so)
        assert torch.equal(lib, want), "the _int_mm route disagrees"
        levels = len(torch.unique(got))
        assert levels > 100, f"outputs saturated or empty: {levels} levels"
        xb = (x if skip is None else torch.cat([x, skip], -1)).permute(
            0, 3, 1, 2).to(torch.bfloat16)
        wb = wq.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        turns = [graph_ms(fn, reps=5) for fn in (generic, picked, picked,
                                                 generic)]
        row = dict(
            shape=[B, side, side, cin, cs, cout], per_forward=times, form=form,
            device_ms=turns[1], device_ms_2=turns[2], generic_ms=turns[0],
            generic_ms_2=turns[3],
            plain_ms=cuda_ms(lambda: plain_in_slices(*args, **kw), 1),
            library_ms=cuda_ms(lambda: int_mm_route(x, skip, wq, wscale, bias,
                                                    shift, s0, s1, so), 2),
            library_bf16_ms=cuda_ms(lambda: F.conv2d(xb, wb, padding=1), 5))
        K = 9 * (cin + cs)
        ops = 2.0 * B * side * side * K * cout
        nbytes = B * side * side * (cin + cs + cout) + K * cout + 12 * cout
        row["bound_ms"], row["bound_by"] = bound_int8(nbytes, ops)
        row["tops"] = ops / row["device_ms"] / 1e9
        row["generic_tops"] = ops / row["generic_ms"] / 1e9
        assert [checksum(t) for t in inputs] == sums, \
            f"conv3x3_s8 {side} {cin}+{cs}->{cout}: the case's inputs changed"
        shapes.append(row)
        for k in ("plain_ms", "library_ms", "library_bf16_ms", "bound_ms",
                  "generic_ms", "generic_ms_2", "device_ms_2"):
            total["ms_2" if k == "device_ms_2" else k] += times * row[k]
        total["ms"] += times * row["device_ms"]
        total["ops"] += times * ops
        total["nbytes"] += times * nbytes
        print(f"conv3x3_s8 B={B} {side}^2 {cin}{'+' + str(cs) if cs else ''}"
              f"->{cout} ({form} form): bit-exact vs plain, the generic form "
              f"and the _int_mm route, two runs equal, inputs unchanged "
              f"(checksums), {levels} output levels; device {row['device_ms']:.4f} / "
              f"{row['device_ms_2']:.4f} ms ({row['tops']:.1f} TOP/s, "
              f"{row['bound_ms'] / row['device_ms']:.3f} of the bound), "
              f"generic form {row['generic_ms']:.4f} / "
              f"{row['generic_ms_2']:.4f} ({row['generic_tops']:.1f} TOP/s), "
              f"plain {row['plain_ms']:.4f}, _int_mm route "
              f"{row['library_ms']:.4f}, cuDNN bf16 "
              f"{row['library_bf16_ms']:.4f}, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) on {card}")
        del x, skip, got, want, lib, xb, args, kw, inputs
    total_bound = bound_int8(total["nbytes"], total["ops"])
    print(f"conv3x3_s8, one forward's 14 convs at B={B}: device "
          f"{total['ms']:.4f} / {total['ms_2']:.4f} ms "
          f"({total['ops'] / total['ms'] / 1e9:.1f} TOP/s, "
          f"{total_bound[0] / total['ms']:.3f} of the bound), generic form "
          f"{total['generic_ms']:.4f} / {total['generic_ms_2']:.4f}, plain "
          f"{total['plain_ms']:.4f}, _int_mm route {total['library_ms']:.4f}, "
          f"cuDNN bf16 {total['library_bf16_ms']:.4f}, bound "
          f"{total_bound[0]:.4f} ms ({total_bound[1]}) on {card}")
    return dict(err=err, ms=total["ms"], device_ms=total["ms"],
                device_ms_2=total["ms_2"], generic_ms=total["generic_ms"],
                generic_ms_2=total["generic_ms_2"],
                plain_ms=total["plain_ms"], bound=total_bound,
                library_ms=total["library_ms"],
                library_bf16_ms=total["library_bf16_ms"], by_shape=shapes)


def bound_int8(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_unet_config(frame, depth: int, base_filters: int, batch: int,
                       seed: int = 0, share: float = 0.5,
                       quantized: bool = False, device: str = "cuda"):
    """``movie_pipeline(unet=...)`` configuration with seeded random weights:
    he / lecun-normal convs, BatchNorm scales, biases and running statistics
    drawn away from the identity and folded to shifts by the predictor, and
    the head bias set from one forward of ``frame`` ((C, Z, Y, X), projected
    first when Z > 1) so that ``share`` of its pixels pass the 0.1 HC
    threshold — random logits would else pass everywhere or nowhere and the
    flood be trivial. Returns (config, share measured after calibration);
    with ``quantized`` also the int8 configuration of the same weights, its
    activation scales calibrated on that projected frame
    (``SegmentationPredictor(quantize=True).calibrate``)."""
    import torch

    from tissue_image_processing_tpu_torch.models.predictor import (
        SegmentationPredictor, prepare_batch)
    from tissue_image_processing_tpu_torch.projection.surface import (
        project_timepoint_auto)
    from tissue_image_processing_tpu_torch.utils.synthetic import (
        head_bias_for_share, random_unet)

    Y, X = frame.shape[-2:]
    model = random_unet(depth, base_filters, seed)
    pred = SegmentationPredictor(None, (2, Y, X), depth=depth,
                                 base_filters=base_filters,
                                 variables=model.state_dict(), device=device)
    assert pred.model.norm == "shift", "BatchNorm was not folded"
    stack = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
    prj = (project_timepoint_auto(stack)[0] if stack.shape[1] > 1
           else stack[:, 0].to(torch.float32))
    x, (px, py) = prepare_batch(prj[None])
    delta = head_bias_for_share(pred._forward(x)[0, px:, py:], share)
    with torch.no_grad():
        pred.model.head.bias[0] += delta
        model.head.bias[0] += delta
    p = pred._forward(x)[0, px:, py:]
    got = float((p[..., 0] > 0.1).float().mean())
    print(f"random U-Net depth {depth}, {base_filters} filters, seed {seed}: "
          f"head bias + {delta:.6f} for p0 > 0.1 on {share} of the frame")
    if not quantized:
        return pred.pipeline_config(batch=batch), got
    q = SegmentationPredictor(None, (2, Y, X), depth=depth,
                              base_filters=base_filters,
                              variables=model.state_dict(), quantize=True)
    assert q.quantize, "the int8 path did not activate"
    q.calibrate(prj)
    return pred.pipeline_config(batch=batch), got, q.pipeline_config(batch=batch)


def check_unet_pipeline(card: str, movie):
    """Phase 5 for the U-Net branch: the raw headline movie through
    ``movie_pipeline(unet=...)`` at the reference architecture's full width,
    its launch counts; then chunked == unchunked."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core.pipeline import (
        movie_pipeline, movie_pipeline_chunked)

    T, Z = movie.shape[0], movie.shape[2]
    cfg, share, cfg_q = random_unet_config(movie[0], depth=3, base_filters=128,
                                           batch=8, quantized=True)
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
    by_shape = blur_launches({SCORE_BLUR: T})
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    missing = [k for k in UNET_KERNELS + PROJECTION_KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched on the U-Net path: {missing}"
    assert launches["diffusion_bf"] == 0, launches  # binary route: no BF flood
    assert launches["diffusion_cc"] == 0 and launches["blur3d"] == T, launches
    assert all(launches[k] == T for k in PROJECTION_KERNELS), launches
    # two component minima of four launches each, in one stacked flood
    assert launches["cc_scan"] == 8 and launches["settle_mask"] == 1, launches
    assert launches["settle"] == 1, launches

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
    int8_launches, int8_forms = check_int8_pipeline(card, movie, cfg, cfg_q,
                                                    kw, T / secs)
    return launches, by_shape, int8_launches, int8_forms


def best_dice(got, want) -> float:
    """``bench.py:_best_dice``: the mean over the cells of ``want`` (>= 20
    px) of the Dice with the ``got`` label that overlaps each most (the
    smallest such label on a tie; 0 when none does), from one contingency
    table."""
    got = np.asarray(got).ravel().astype(np.int64)
    want = np.asarray(want).ravel().astype(np.int64)
    nw, ng = np.bincount(want), np.bincount(got)
    both = (want > 0) & (got > 0)
    keys, counts = np.unique(want[both] * ng.size + got[both], return_counts=True)
    wl, gl = keys // ng.size, keys % ng.size
    order = np.lexsort((gl, -counts, wl))
    first = order[np.r_[True, wl[order][1:] != wl[order][:-1]]]
    best = {int(w): (int(g), int(c))
            for w, g, c in zip(wl[first], gl[first], counts[first])}
    dices = []
    for lab in range(1, int(want.max()) + 1):
        if nw[lab] < 20:
            continue
        if lab not in best:
            dices.append(0.0)
            continue
        g, c = best[lab]
        dices.append(2 * c / (nw[lab] + ng[g]))
    return float(np.mean(dices)) if dices else 0.0


def check_int8_pipeline(card: str, movie, cfg, cfg_q, kw, bf16_fps: float):
    """The int8 U-Net branch on the same movie and weights as the bfloat16
    run: ``movie_pipeline(unet={"quantized": True, ...})`` with the launch
    counters zeroed just before (every 3x3 conv through ``conv3x3_s8``: 14
    launches for one forward of the 8 frames), frames/s beside the bfloat16
    run's, chunked == unchunked; the batch-8 int8 forward of the projected
    frames again with each of its 14 convs held, bit for bit, against the
    plain version on the same inputs (the main path's shapes and
    activations); then HC-mask agreement and label Dice int8 vs bfloat16 as
    ``bench.py`` computes them (post-process of each forward).

    That pair measures the int8 scheme on a random network whose head bias
    puts half the pixels near the threshold, where the int8 noise flips
    pixels that a trained network would keep far from it. The JAX
    package's own pair on the same weights, head-bias rule and frames
    (``tests/int8_witness.py``, on CPU crops) is the witness for the
    floor asserted here: agreement >= ``INT8_HC_FLOOR``."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core.pipeline import (
        _projections, movie_pipeline, movie_pipeline_chunked)
    from tissue_image_processing_tpu_torch.models.predictor import (
        prepare_batch, unet_from_config, unet_postprocess_batch)

    T, Z = movie.shape[0], movie.shape[2]
    movie_pipeline(movie, unet=cfg_q, **kw)   # warm
    torch.cuda.synchronize()
    tipt.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    out = movie_pipeline(movie, unet=cfg_q, timings=stages, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tipt.LAUNCHES)
    missing = [k for k in ("conv3x3_s8",) + UNET_KERNELS + PROJECTION_KERNELS
               if launches[k] == 0]
    assert not missing, f"kernels not launched on the int8 U-Net path: {missing}"
    assert launches["conv3x3_s8"] == 14, launches   # 7 double convs, batch 8
    forms = dict(tipt._device.CONV_LAUNCHES)
    assert forms == {"tensor_core": 13, "first_conv": 1}, forms
    assert launches["cc_scan"] == 8 and launches["settle"] == 1, launches
    labels = out["labels"]
    cells = [int(l.max()) for l in labels]
    assert min(cells) > 20, f"trivial flood: cells/frame {cells}"
    assert np.isfinite(out["drifts"]).all()
    print(f"movie_pipeline(unet, int8) {T} x 1024^2 Z={Z}: {T / secs:.3f} "
          f"frames/s ({secs:.3f} s; bfloat16 run {bf16_fps:.3f} frames/s) on "
          f"{card}; launches {launches}; conv3x3_s8 launches by form {forms}; "
          f"cells/frame {cells}")
    print(f"stage seconds (U-Net int8, {T} x 1024^2, Z={Z}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f" on {card}")
    got = movie_pipeline_chunked(movie, chunk_frames=3, unet=cfg_q, **kw)
    assert np.array_equal(got["labels"], labels.cpu().numpy()), \
        "int8 chunked labels differ"
    assert np.array_equal(got["ids"], out["ids"]), "int8 chunked ids differ"

    dev = torch.device("cuda")
    prj = _projections(movie, 0, dev)
    x, (px, py) = prepare_batch(prj)
    x = x.to(torch.bfloat16)
    quant = importlib.import_module(
        "tissue_image_processing_tpu_torch.models.quant")
    kernel_conv, held = quant.conv3x3_s8, []

    def conv_held(*a, packed=None, **k):
        got = kernel_conv(*a, packed=packed, **k)
        want = plain_in_slices(*a, **k)
        skip = k.get("skip")
        shape = (a[0].shape[1], a[0].shape[-1], a[1].shape[0],
                 0 if skip is None else skip.shape[-1])
        assert torch.equal(got, want), f"int8 forward conv {shape} disagrees"
        held.append((a[0].shape[0],) + shape)
        return got

    res, probs = {}, {}
    with torch.no_grad():
        for name, c in (("bf16", cfg), ("int8", cfg_q)):
            model = unet_from_config(c, dev)
            if name == "int8":
                quant.conv3x3_s8 = conv_held
            try:
                probs[name] = model(x)
            finally:
                quant.conv3x3_s8 = kernel_conv
            preds = probs[name][:, px:, py:, :]
            res[name] = [t.cpu().numpy() for t in unet_postprocess_batch(preds)]
    want_shapes = sorted((T, side, cin, cout, cs)
                         for (side, cin, cout, cs), n in UNET_CONVS
                         for _ in range(n))
    got_shapes = sorted((b, side, cin, cout, cs)
                        for b, side, cin, cout, cs in held)
    assert got_shapes == want_shapes, f"int8 forward convs {held}"
    (lab_f, hc_f), (lab_q, hc_q) = res["bf16"], res["int8"]
    assert np.array_equal(lab_q, labels.cpu().numpy()), \
        "int8 pipeline labels differ from the int8 forward's"
    hc_agree = float((hc_f == hc_q).mean())
    dice = float(np.mean([best_dice(lab_q[i], lab_f[i]) for i in range(T)]))
    dp = float((probs["int8"] - probs["bf16"]).abs().mean())
    print(f"int8 forward ({T} x 1024^2): each of its {len(held)} convs equal "
          f"to the plain version on its inputs, bit for bit; int8 vs "
          f"bfloat16: mean |dP| {dp:.6f}, HC-mask agreement {hc_agree:.6f}, "
          f"label Dice {dice:.6f} (floor {INT8_HC_FLOOR}, from the JAX "
          f"package's pair on the same network: tests/int8_witness.py)")
    assert hc_agree >= INT8_HC_FLOOR, f"int8 vs bf16 HC agreement {hc_agree}"
    return launches, forms


def check_keras_weights(card: str):
    """Full-width (depth 3, 128 filters) Keras U-Net weights from a seed
    (``keras_unet_arrays``, the arrays a Keras h5 file holds) mapped by the
    loader (``keras_arrays_to_state``, what ``SegmentationPredictor(
    model_weights_path=...)`` runs after reading the file) into predictors
    on the card and on the CPU: the loaded state equal tensor for tensor, as
    loaded (folded: within 1e-6, the fold's float32 arithmetic runs on each
    device). The file itself is not read here: the card's machine
    has no ``h5py``; ``tests/test_torch_weights.py`` reads both layouts on
    the CPU against the JAX loader."""
    import torch

    from tissue_image_processing_tpu_torch.models.predictor import (
        SegmentationPredictor)
    from tissue_image_processing_tpu_torch.models.unet import UNet
    from tissue_image_processing_tpu_torch.models.weights_io import (
        keras_arrays_to_state)
    from tissue_image_processing_tpu_torch.utils.synthetic import (
        keras_unet_arrays)

    t0 = time.time()
    state = keras_arrays_to_state(keras_unet_arrays(3, 128, seed=4),
                                  UNet(depth=3, base_filters=128).state_dict())
    states = {}
    for device in ("cuda", "cpu"):
        for fold in (False, True):
            pred = SegmentationPredictor(None, (2, 1024, 1024), depth=3,
                                         base_filters=128, variables=state,
                                         fold_bn=fold, device=device)
            states[(device, fold)] = {k: v.cpu() for k, v in
                                      pred.model.state_dict().items()}
    secs = time.time() - t0
    n = sum(v.numel() for k, v in state.items() if "num_batches" not in k)
    want, got = states[("cpu", False)], states[("cuda", False)]
    assert sorted(got) == sorted(want) == sorted(state)
    for k, v in state.items():
        assert torch.equal(got[k], v) and torch.equal(want[k], v), k
    # the fold's arithmetic (a = gamma / sqrt(var + eps), w * a, beta - mean
    # * a) runs on each device: a few float32 ulps apart
    want, got = states[("cpu", True)], states[("cuda", True)]
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k, v in want.items():
        if v.is_floating_point():
            d = float(((got[k] - v).abs() / v.abs().clamp_min(1e-6)).max())
            worst = max(worst, d)
            torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-6, msg=k)
    print(f"Keras weights depth 3 / 128 filters ({n} values) mapped by the "
          f"loader: on the card == on the CPU, tensor for tensor; folded, "
          f"largest relative difference {worst:.3g}; 4 predictors in "
          f"{secs:.1f} s on {card}")


def check_training(card: str):
    """``train_unet`` with the reference recipe (depth 2, 128 filters, batch
    32, 256^2 crops, bfloat16) on synthetic annotated 512^2 frames: 2 warm
    steps, then 10 timed steps; the loss finite. Then one float32 step of a
    depth-2, 4-filter net on 32^2 crops on the card and on the CPU from the
    same seeded weights: the CPU test's tolerances (loss rel 1e-5, gradients
    1e-4 of their largest magnitude, stepped parameters 2 x lr)."""
    import torch

    from tissue_image_processing_tpu_torch.models import train
    from tissue_image_processing_tpu_torch.models.unet import UNet
    from tissue_image_processing_tpu_torch.utils.synthetic import (
        training_frames)

    images, labels = training_frames(4, 512, 512, seed=3)
    kw = dict(batch_size=32, crop=256, depth=2, base_filters=128,
              dtype=torch.bfloat16, verbose=False)
    train.train_unet(images, labels, epochs=1, steps_per_epoch=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, history = train.train_unet(images, labels, epochs=1,
                                     steps_per_epoch=10, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert np.isfinite(history["loss"]).all(), history
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train_unet depth 2, 128 filters, batch 32, 256^2 crops, bfloat16: "
          f"{10 / secs:.3f} steps/s (10 steps, {secs:.3f} s, crops made on "
          f"the host included), loss {history['loss'][0]:.4f}, accuracy "
          f"{history['accuracy'][0]:.4f}, peak memory {peak:.2f} GiB on {card}")

    lr = 1e-5
    rng = np.random.default_rng(0)
    x = rng.random((4, 32, 32, 2)).astype(np.float32)
    y_cls = (x[..., 0] > 0.5).astype(np.float32)
    y = np.stack([y_cls, 1 - y_cls], -1)
    runs = {}
    for device in ("cuda", "cpu"):
        model = UNet(depth=2, base_filters=4, dropout_rate=0.0)
        state, tx = train.create_train_state(model, (32, 32, 2), lr, seed=0,
                                             device=device)
        state, loss, _ = train.make_train_step(model, tx)(state, x, y)
        runs[device] = (float(loss), {n: p.grad.cpu() for n, p in
                                      model.named_parameters()},
                        {k: v.cpu() for k, v in model.state_dict().items()})
    (lg, gg, sg), (lc, gc, sc) = runs["cuda"], runs["cpu"]
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    worst = 0.0
    for k, g in gc.items():
        scale = float(g.abs().max())
        rel = float((gg[k] - g).abs().max()) / scale
        worst = max(worst, rel)
        assert rel <= 1e-4, (k, rel)
    for k, v in sc.items():
        if "num_batches" not in k:
            torch.testing.assert_close(sg[k], v, rtol=0, atol=2 * lr, msg=k)
    print(f"float32 train step (depth 2, 4 filters, 4 x 32^2) card vs CPU: "
          f"loss {lg:.7f} vs {lc:.7f}, worst gradient difference {worst:.3g} "
          f"of its largest magnitude, parameters within 2 x lr")


def check_radii(card: str, capacities=(4096, 8192), seed: int = 2026101807
                ) -> dict:
    """Phase "radii" (see the module docstring). Returns the kernel table's
    row: launches on the pipeline's path and, by capacity, the device ms
    of one call's kernels, the wrapper's ms, the plain sweep's and the
    recursion's, pairs and solves a frame, and the fp64 bound."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from benchmark.movies import make_movie as benchmark_movie
    from tissue_image_processing_tpu_torch.core import tracking as ttr
    from tissue_image_processing_tpu_torch.core.pipeline import movie_pipeline

    root = Path(__file__).resolve().parent
    traffic = json.loads((root / "benchmark/traffic/raw_2000.json").read_text())
    cfg = json.loads((root / "benchmark/configs/utricle_ws.json").read_text())
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    movie = benchmark_movie(traffic, int(cfg["frames"]), seed, dev)
    print(f"radii: raw_2000 movie {movie.shape} (seed {seed}) in "
          f"{time.perf_counter() - t0:.1f} s")
    kw = {k: cfg[k] for k in ("reference_channel", "threshold", "std",
                              "block_size", "batch", "search_range",
                              "memory")}
    row = {"by_capacity": {}}
    for capacity in capacities:
        tipt.reset_launches()
        out = movie_pipeline(movie, capacity=capacity, device=dev, **kw)
        launches = tipt.LAUNCHES["radii_sweep"]
        path_solves = tipt._device.COUNTS["radii_solves"]
        assert launches == 3, tipt.LAUNCHES
        tabs = out["tables"]
        mask = tabs.valid_mask()
        drifts = out["drifts"]
        T = mask.shape[0]
        card = (tabs.cy, tabs.cx, tabs.area, mask)
        host = tuple(x.cpu() for x in card)

        def solved(fn):
            tipt.reset_launches()
            got = fn()
            return got, tipt._device.COUNTS["radii_solves"]

        def kernel():
            return ttr.adaptive_radii(*card, drifts=torch.from_numpy(
                drifts).to(dev))

        got, solves = solved(kernel)
        again, _ = solved(kernel)
        plain, plain_solves = solved(
            lambda: ttr.adaptive_radii(*host, drifts=drifts))
        rec, rec_solves = solved(lambda: ttr.adaptive_effective_ranges(
            *(x.numpy() for x in host), drifts=drifts, per_cell=True))
        real = ttr._radii_shared_limit
        ttr._radii_shared_limit = lambda lib, d: 0
        try:
            dm, dm_solves = solved(kernel)
        finally:
            ttr._radii_shared_limit = real
        assert torch.equal(got, again), "two runs of the sweep differ"
        assert torch.equal(got.cpu(), plain), "kernel != plain sweep"
        assert torch.equal(dm, got), "device-memory form != shared form"
        assert np.array_equal(plain.numpy(), rec.astype(np.float32)), \
            "plain sweep != host recursion"
        assert solves == plain_solves == rec_solves == dm_solves == \
            path_solves, (solves, plain_solves, rec_solves, dm_solves,
                          path_solves)
        first, carry = ttr.adaptive_radii(
            *(x[:3] for x in card), drifts=torch.from_numpy(drifts[:3]).to(dev),
            return_carry=True)
        rest = ttr.adaptive_radii(*(x[3:] for x in card),
                                  drifts=torch.from_numpy(drifts[3:]).to(dev),
                                  carry=carry)
        assert torch.equal(torch.cat([first, rest]), got), "chunked != whole"
        n = mask.sum(1).cpu().numpy().astype(np.int64)
        pairs_evaluated = int((n[1:] * n[:-1]).sum())
        bound_ms = pairs_evaluated * 8 / F64_OPS_PER_S * 1e3
        wrapper = cuda_ms_spread(kernel, 5)
        split = kernel_split(kernel, 5)
        t_plain = host_ms(lambda: ttr.adaptive_radii(*host, drifts=drifts), 3)
        t_rec = host_ms(lambda: ttr.adaptive_effective_ranges(
            *(x.numpy() for x in host), drifts=drifts, per_cell=True), 1)
        r = {"cells_per_frame": n.tolist(), "solves_per_frame": solves / T,
             "wrapper_ms": wrapper[0], "wrapper_ms_min": wrapper[1],
             "wrapper_ms_max": wrapper[2], "kernels_us": split,
             "plain_ms": t_plain, "recursion_ms": t_rec,
             "bound_ms": bound_ms, "bound_by": "fp64 operations",
             "launches": launches}
        row["by_capacity"][capacity] = r
        print(f"radii capacity {capacity}: kernel == plain == recursion "
              f"(radii bit for bit, {solves} solves = "
              f"{solves / T:.2f} a frame; device-memory form and chunked "
              f"equal); cells a frame {n.tolist()}; wrapper "
              f"{spread(wrapper)} (T={T}), kernels (us a call) {split}; "
              f"plain {t_plain:.1f} ms, recursion {t_rec:.1f} ms; bound "
              f"{bound_ms:.4f} ms (fp64) on {card_line()}")
    del movie
    return row


def check_auction(card: str, capacities=(4096, 8192), seed: int = 2026101824
                  ) -> dict:
    """Phase "auction" (see the module docstring). Returns the kernel
    table's row: by capacity, the kernel's device ms a frame (events; the
    profiler's split is a movie's), the plain loop's and the tracking
    tail's host ms a frame with each, rounds a frame, the form and the
    bound."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from benchmark.movies import make_movie as benchmark_movie
    from tissue_image_processing_tpu_torch.core import pipeline as tpipe
    from tissue_image_processing_tpu_torch.core import tracking as ttr

    root = Path(__file__).resolve().parent
    traffic = json.loads((root / "benchmark/traffic/preproj_2000.json")
                         .read_text())
    cfg = json.loads((root / "benchmark/configs/utricle_ws.json").read_text())
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    movie = benchmark_movie(traffic, int(cfg["frames"]), seed, dev)
    print(f"auction: preproj_2000 movie {movie.shape} (seed {seed}) in "
          f"{time.perf_counter() - t0:.1f} s")
    kw = {k: cfg[k] for k in ("reference_channel", "threshold", "std",
                              "block_size", "batch", "search_range",
                              "memory")}
    T = movie.shape[0]
    kernel = ttr._rounds_card

    def loop(b, cand, person_mask, eps, K, max_rounds, rounds):
        person_obj, n = ttr._rounds_plain(b, cand, person_mask, eps, K,
                                          max_rounds)
        rounds.fill_(n)
        return person_obj

    def swapped(fn, rounds_fn):
        ttr._rounds_card = rounds_fn
        try:
            return fn()
        finally:
            ttr._rounds_card = kernel

    row = {"by_capacity": {}}
    for capacity in capacities:
        tipt.reset_launches()
        out = tpipe.movie_pipeline(movie, capacity=capacity, device=dev, **kw)
        assert tipt.LAUNCHES["auction"] == T, tipt.LAUNCHES
        assert tipt._device.COUNTS["auction_card"] == T
        n_global = tipt._device.COUNTS["auction_global"]
        assert n_global == (T if capacity == 8192 else 0), n_global

        def tail():
            ids = tpipe._track(out["tables"], out["drifts"],
                               float(kw["search_range"]), int(kw["memory"]),
                               capacity)
            torch.cuda.synchronize()
            return ids

        inputs = []

        def capture(*args):
            inputs.append(args[:6])
            return kernel(*args)

        ids = swapped(tail, capture)
        assert np.array_equal(ids.cpu().numpy(), out["ids"]), \
            "the tail's ids differ from the path's"
        assert torch.equal(swapped(tail, loop), ids), "kernel != loop (ids)"
        rounds = torch.zeros(len(inputs), dtype=torch.int32, device=dev)

        def kernels():
            return [kernel(*x, rounds[i:i + 1]) for i, x in enumerate(inputs)]

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = kernels()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        per_frame = rounds.tolist()
        for g, (want, n), r in zip(got, (ttr._rounds_plain(*x)
                                         for x in inputs), per_frame):
            assert torch.equal(g, want) and r == n, (r, n)
        ms = cuda_ms_spread(kernels, 5)
        split = kernel_split(kernels, 3)
        t_plain = host_ms(lambda: ([ttr._rounds_plain(*x) for x in inputs],
                                   torch.cuda.synchronize()), 3)
        t_tail = host_ms(tail, 3)
        t_tail_loop = host_ms(lambda: swapped(tail, loop), 3)
        # where the rest of the tail goes: device us a movie by kernel
        tail_split = kernel_split(tail, 1)
        M, C = inputs[0][0].shape
        K = inputs[0][4]
        persons = [int(x[2].sum()) for x in inputs]
        nbytes = sum(p * C * 12 * n for p, n in zip(persons, per_frame))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3 / T
        r = {"persons_x_tracks": [M, K], "valid_persons": persons,
             "rounds_per_frame": per_frame,
             "form": "device memory" if n_global else "shared memory",
             "ms": ms[0] / T, "ms_min": ms[1] / T, "ms_max": ms[2] / T,
             "kernels_us_a_movie": split, "plain_ms": t_plain / T,
             "tail_ms": t_tail / T, "tail_loop_ms": t_tail_loop / T,
             "tail_kernels_us_a_movie": tail_split,
             "bound_ms": bound_ms, "bound_by": "bytes", "launches": T}
        row["by_capacity"][capacity] = r
        print(f"auction capacity {capacity} ({M} x {K}, {r['form']}): "
              f"kernel == loop (ids and rounds bit for bit, {sum(per_frame)} "
              f"rounds: {per_frame}; no host synchronisation in "
              f"{len(inputs)} calls; the tail's ids with the loop equal); "
              f"kernel {ms[0] / T:.4f} ms a frame ({ms[1] / T:.4f}.."
              f"{ms[2] / T:.4f}), by the profiler (us a movie of {T}) "
              f"{split}; plain loop {t_plain / T:.3f} ms a frame; tracking "
              f"tail {t_tail / T:.3f} ms a frame (with the loop "
              f"{t_tail_loop / T:.3f}); bound {bound_ms:.5f} ms a frame "
              f"(bytes) on {card_line()}")
        print(f"auction capacity {capacity}: the tail's kernels (us a movie "
              f"of {T}) {tail_split}")
    del movie
    return row


def check_cellpose(card: str, seed: int = 2026101821) -> dict:
    """Phase "cellpose" (see the module docstring). Returns the kernel
    table's row."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from benchmark.costs.follow import least_follow_seconds
    from benchmark.movies import make_movie as benchmark_movie
    from benchmark.programs.cellpose_pipeline import Program
    from tissue_image_processing_tpu_torch.core.pipeline import movie_pipeline
    from tissue_image_processing_tpu_torch.models.cellpose import (
        CellposeRunner)
    from tissue_image_processing_tpu_torch.ops.flows import (
        follow_plain, get_masks)
    from tissue_image_processing_tpu_torch.ops.flows_cuda import follow_cuda

    root = Path(__file__).resolve().parent
    traffic = json.loads((root / "benchmark/traffic/preproj_2000.json")
                         .read_text())
    cfg = json.loads((root / "benchmark/configs/utricle_cellpose.json")
                     .read_text())
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    movie = benchmark_movie(traffic, int(cfg["frames"]), seed, dev)
    program = Program(cfg, [movie], dev)
    print(f"cellpose: preproj_2000 movie {movie.shape} (seed {seed}) and "
          f"the trained network in {time.perf_counter() - t0:.1f} s")
    runner = CellposeRunner(program.kwargs["cellpose"], dev)
    frames = torch.from_numpy(movie[:2, :, 0].astype(np.float32)).to(dev)
    flows = runner.blend(runner.forward(runner.tiles(frames)),
                         *frames.shape[-2:])
    m = flows[:, 2] > runner.cellprob_threshold
    d = ((flows[:, :2] * m[:, None]) / 5.0).contiguous()
    steps = runner.niter
    tipt.reset_launches()
    got = follow_cuda(d, steps)
    again = follow_cuda(d, steps)
    launches = tipt.LAUNCHES["follow_flows"]
    plain = follow_plain(d, steps)
    assert torch.equal(got, again), "two runs of follow_flows differ"
    assert torch.equal(got, plain), "follow_flows != its plain version"
    followed = int((d[:, 0].abs() > 1e-3).sum())
    B, _, Y, X = d.shape
    bound_ms = least_follow_seconds(B * Y * X, followed, steps) * 1e3
    ms = cuda_ms_spread(lambda: follow_cuda(d, steps), 3)
    split = kernel_split(lambda: follow_cuda(d, steps), 3)
    t_plain = host_ms(lambda: (follow_plain(d, steps),
                               torch.cuda.synchronize()), 1)
    print(f"cellpose follow_flows: kernel == plain bit for bit on {B} "
          f"2000^2 frames, {steps} steps, {followed} followed pixels; "
          f"kernel {spread(ms)}, by the profiler (us a call) {split}; plain "
          f"{t_plain:.1f} ms; bound {bound_ms:.4f} ms (float32 operations) "
          f"on {card_line()}")
    labels, n = get_masks(got[0], m[0])
    del got, again, plain, d, flows, frames
    diffuse_row = check_flow_diffuse(labels, n)
    kw = {k: cfg[k] for k in ("reference_channel", "capacity",
                              "search_range", "memory")}
    tipt.reset_launches()
    t0 = time.perf_counter()
    out = movie_pipeline(movie, device=dev, cellpose=program.kwargs["cellpose"],
                         **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = tipt._device.COUNTS
    path = tipt.LAUNCHES["follow_flows"]
    T = movie.shape[0]
    assert path == T // int(cfg["batch"]), tipt.LAUNCHES
    diffuse = tipt.LAUNCHES["flow_diffuse"]
    assert diffuse > 0 and tipt.LAUNCHES["flow_diffuse_global"] == 0, \
        tipt.LAUNCHES
    print(f"cellpose pipeline: {T} frames in {secs:.2f} s (first call), "
          f"{path} follow_flows launches; masks found {c['cp_masks_found']}, "
          f"kept {c['cp_masks_kept']}, cells a frame "
          f"{out['tables'].valid_mask().sum(1).tolist()}; diffusion "
          f"iterations {c['qc_iters']}, {diffuse} flow_diffuse launches "
          f"({diffuse / T:.2f} a frame), masks in the global form "
          f"{c['qc_masks_global']}")
    diffuse_row["launches"] = diffuse
    return {"launches": path, "followed_px": followed, "steps": steps,
            "frames": B, "ms": ms[0], "ms_min": ms[1], "ms_max": ms[2],
            "kernels_us": split, "plain_ms": t_plain, "bound_ms": bound_ms,
            "bound_by": "float32 operations", "max_abs_err": 0.0}, diffuse_row


def check_flow_diffuse(labels, n: int) -> dict:
    """The flow check's diffusion (``csrc/flow_diffuse.cu``) on one 2000^2
    frame's masks of the trained traffic: the kernel against the plain
    whole-frame loop on the CPU, bit for bit (two kernel runs equal, the
    global form equal too), its launches timed by CUDA events and by the
    profiler, the plain loop on the card (today's path before the kernel;
    its division multiplies by the reciprocal, so it is compared by its
    largest relative difference), the global form, and the bound of
    ``benchmark/costs/flow_qc.py``. Returns the kernel table's row."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from benchmark.costs.flow_qc import least_flow_qc_seconds
    from tissue_image_processing_tpu_torch.ops import flow_diffuse_cuda as fd
    from tissue_image_processing_tpu_torch.ops.flows import (
        _geometry, diffuse_plain)

    boxes, centre = _geometry(labels, n)
    p = fd.plan(labels, boxes, centre)
    tipt.reset_launches()
    got = fd.run(p)
    assert torch.equal(got, fd.run(p)), "two runs of flow_diffuse differ"
    launches = tipt.LAUNCHES["flow_diffuse"] // 2
    t0 = time.perf_counter()
    plain = diffuse_plain(labels.cpu(), centre.cpu(), p.n_iter)
    cpu_s = time.perf_counter() - t0
    assert torch.equal(got.cpu(), plain), "flow_diffuse != its plain loop"
    g = fd.plan(labels, boxes, centre, form="global")
    glob = fd.run(g)
    assert torch.equal(glob, got), "the global form != the shared form"
    on_card = diffuse_plain(labels, centre, p.n_iter)
    rel = float(((on_card - got).abs() / got.abs().clamp(min=1e-300)).max())
    ms = cuda_ms_spread(lambda: fd.run(p), 3)
    split = kernel_split(lambda: fd.run(p), 3)
    t_plain = host_ms(lambda: (diffuse_plain(labels, centre, p.n_iter),
                               torch.cuda.synchronize()), 1)
    t_global = cuda_ms(lambda: fd.run(g), 1)
    Y, X = labels.shape
    bound_ms = least_flow_qc_seconds(Y * X, p.pixels * p.n_iter) * 1e3
    print(f"cellpose flow_diffuse: kernel == plain loop (CPU, {cpu_s:.1f} s) "
          f"bit for bit on one 2000^2 frame, {n} masks, {p.pixels} mask "
          f"pixels, {p.n_iter} iterations, {launches} launches (masks per "
          f"size class {p.per_class}, largest padded boxes {p.largest}, "
          f"global form {p.n_global}); kernel {spread(ms)}, by the profiler "
          f"(us a call) {split}; plain loop on the card {t_plain:.1f} ms "
          f"(largest relative difference {rel:.3e}); global form "
          f"{t_global:.2f} ms; bound {bound_ms:.4f} ms (float64 operations) "
          f"on {card_line()}")
    return {"masks": n, "mask_px": p.pixels, "iterations": p.n_iter,
            "launches_a_frame": launches, "ms": ms[0], "ms_min": ms[1],
            "ms_max": ms[2], "kernels_us": split, "plain_ms": t_plain,
            "plain_card_max_rel": rel, "global_ms": t_global,
            "bound_ms": bound_ms, "bound_by": "float64 operations",
            "max_abs_err": 0.0}


def check_card_vs_cpu():
    """Phase 6: the card against the port's CPU path on small inputs."""
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


ONE_FRAME_BLUR = (1, 1024, 1024, 1, 25, 25)  # watershed_segmentation's blur
BAND_PASS_BLUR = (1, 1024, 1024, 1, 9, 9)     # band_pass_filter's sigma 1


def launched(kernels) -> dict:
    """The launch counts of the calls since the last reset: those named in
    ``kernels`` exactly as given, every other kernel none."""
    import tissue_image_processing_tpu_torch as tipt

    got = {k: v for k, v in tipt.LAUNCHES.items() if v}
    want = {k: v for k, v in kernels.items() if v}
    assert got == want, f"launches {got}, expected {want}"
    return got


def check_ported_functions(frames, card: str):
    """Phase 3: the functions ported beside the main path, at full width on
    1024^2 frames of the synthetic movie, on the card against the CPU route
    (or the batch form), with the kernels each one launches:
    ``watershed_segmentation`` on one frame equal to frame 0 of the batch
    form (blur 1, BF 1, CC 2, settle mask 1, settle 1); the connected
    components of its cells (the watershed lines inverted) by the union-find
    scan (4 launches) and, 8-connected, by the plain route on the card, both
    equal to the CPU; the contact matrices (exact and run-length forms) and
    per-cell percentiles exactly; the band-pass filter (one blur launch,
    in the walk form, and the band matrix) within the CPU test's 1e-6 on
    [0, 1) values; the local drift field (16 windows of 700^2) within 1e-4
    px. Returns each kernel's launches by function and the band-pass
    filter's blur input (x, kz, ky, kx)."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core.tracking import local_drift_field
    from tissue_image_processing_tpu_torch.ops.components import (
        connected_components)
    from tissue_image_processing_tpu_torch.ops.filters import band_pass_filter
    from tissue_image_processing_tpu_torch.ops.neighbors import (
        contact_length_matrix, contact_length_matrix_checked)
    from tissue_image_processing_tpu_torch.ops.percentile import (
        segment_percentile)
    ws = importlib.import_module("tissue_image_processing_tpu_torch.ops.watershed")

    by_caller = {}
    frame = frames[0].contiguous()
    kw = dict(imgthresh=0.2, std=3.0, block_size=101)
    tipt.reset_launches()
    labels = ws.watershed_segmentation(frame, **kw)
    flood = {"blur3d": 1, "diffusion_bf": 1, "diffusion_cc": 2,
             "settle_mask": 1, "settle": 1}
    by_caller["watershed_segmentation"] = launched(flood)
    blur_launches({ONE_FRAME_BLUR: 1})
    batch = ws.watershed_segmentation_batch(frame[None], **kw)[0]
    assert torch.equal(labels, batch), "watershed_segmentation != batch form"
    ms = cuda_ms(lambda: ws.watershed_segmentation(frame, **kw), 3)
    cells = int(labels.max())
    assert cells > 200 * frame.numel() // 2 ** 20, cells
    print(f"watershed_segmentation {tuple(frame.shape)}: equal to frame 0 of "
          f"the batch form, {cells} cells, launches "
          f"{by_caller['watershed_segmentation']}, {ms:.4f} ms on {card}")

    mask = labels > 0
    mask_cpu = mask.cpu()
    for conn in (1, 2):
        tipt.reset_launches()
        comp = connected_components(mask, connectivity=conn)
        got = launched({"cc_scan": 4 if conn == 1 else 0})
        if conn == 1:
            by_caller["connected_components"] = got
        assert torch.equal(comp.cpu(), connected_components(
            mask_cpu, connectivity=conn)), f"components ({conn}): card != CPU"
        ms = cuda_ms_spread(lambda: connected_components(mask, connectivity=conn),
                            10 if conn == 1 else 2)
        print(f"connected_components {tuple(mask.shape)} connectivity {conn} "
              f"(mask: that frame's cells): card == CPU, {int(comp.max())} "
              f"components, launches {got}, {spread(ms)}")

    cap = 1024
    for k in (None, 192):
        got, over = contact_length_matrix_checked(labels, cap, compact_k=k) \
            if k else (contact_length_matrix(labels, cap), None)
        want, want_over = contact_length_matrix_checked(labels.cpu(), cap,
                                                        compact_k=k) \
            if k else (contact_length_matrix(labels.cpu(), cap), None)
        assert torch.equal(got.cpu(), want), f"contact matrix (k={k}): card != CPU"
        assert over is None or bool(over) == bool(want_over)
        ms = cuda_ms(lambda: contact_length_matrix(labels, cap, compact_k=k), 5)
        print(f"contact_length_matrix compact_k={k}: card == CPU, "
              f"{int((got > 0).sum()) // 2} contacts, {ms:.4f} ms")
    for q in (50.0, 95.0):
        got = segment_percentile(frame, labels, cap + 1, q)
        want = segment_percentile(frame.cpu(), labels.cpu(), cap + 1, q)
        assert torch.equal(got.cpu(), want), f"segment_percentile {q}: card != CPU"
        ms = cuda_ms(lambda: segment_percentile(frame, labels, cap + 1, q), 5)
        print(f"segment_percentile q={q}: card == CPU over {cap + 1} "
              f"segments, {ms:.4f} ms")

    x = frame / (frame.max() + 1.0)  # [0, 1), the CPU test's value range
    tipt.reset_launches()
    with capture_blur_inputs({BAND_PASS_BLUR}) as band_input:
        got = band_pass_filter(x, 1.0, 4.0)
    by_caller["band_pass_filter"] = launched({"blur3d": 1})
    blur_launches({BAND_PASS_BLUR: 1})
    assert dict(tipt._device.BLUR_FORMS) == {"walk": 1}, tipt._device.BLUR_FORMS
    err = max_abs_err(got.cpu(), band_pass_filter(x.cpu(), 1.0, 4.0))
    assert err <= 1e-6, f"band_pass_filter card vs CPU {err}"
    ms = cuda_ms(lambda: band_pass_filter(x, 1.0, 4.0), 5)
    print(f"band_pass_filter sigmas 1 / 4: card vs CPU max_abs_err {err:.3g}, "
          f"{ms:.4f} ms")

    tipt.reset_launches()
    gy, gx = local_drift_field(frames[0], frames[1])
    launched({})
    wy, wx = local_drift_field(frames[0].cpu(), frames[1].cpu())
    err = max(max_abs_err(gy.cpu(), wy), max_abs_err(gx.cpu(), wx))
    assert err <= 1e-4, f"local_drift_field card vs CPU {err}"
    ms = cuda_ms(lambda: local_drift_field(frames[0], frames[1]), 2)
    print(f"local_drift_field 700 / 100 on {tuple(frames[0].shape)}: card vs "
          f"CPU max_abs_err {err:.3g} px, mean shift ({float(gy.mean()):.3f}, "
          f"{float(gx.mean()):.3f}), {ms:.4f} ms")
    out = {}
    for fn, counts in by_caller.items():
        for name, n in counts.items():
            out.setdefault(name, {})[fn] = n
    return out, band_input[BAND_PASS_BLUR]


# the unfused projection's three blurs of a frame at the driver's 2048^2
# frame size: the pre-blur (0.5, 1, 1), the z-mask blur (1, 2, 2), and the
# z axis of the 4x-decimated score volume's (0.5, 7.5, 7.5) blur (its y / x
# axes, 61 taps, take the band matrix)
def driver_blurs(Z: int, side: int) -> dict:
    """blur3d's shapes on a (Z, side, side) frame, side >= 512 and a
    multiple of 4 (the score volume is decimated 4x): (30, 2048, 2048, 5,
    9, 9), (30, 2048, 2048, 9, 17, 17) and (30, 512, 512, 5, 1, 1) for the
    files phase's movie."""
    return {"pre_blur": (Z, side, side, 5, 9, 9),
            "mask_blur": (Z, side, side, 9, 17, 17),
            "score_blur": (Z, side // 4, side // 4, 5, 1, 1)}


OPTIONAL_PACKAGES = ("PIL", "pandas", "zstandard", "matplotlib")


@contextlib.contextmanager
def capture_blur_inputs(shapes):
    """While open, the first ``blur3d`` input that ``gaussian_blur`` hands
    over at each (Z, Y, X, tz, ty, tx) of ``shapes`` is cloned into the dict
    it yields, with its taps."""
    from tissue_image_processing_tpu_torch.ops import filters

    seen, orig = {}, filters.blur3d

    def capturing(x, kz, ky, kx):
        key = (*x.shape, len(kz), len(ky), len(kx))
        if key in shapes and key not in seen:
            seen[key] = (x.clone(), kz, ky, kx)
        return orig(x, kz, ky, kx)

    filters.blur3d = capturing
    yield seen
    filters.blur3d = orig
    assert set(seen) == set(shapes), f"captured {sorted(seen)}"


@contextlib.contextmanager
def forced_blur_form(form):
    """While open, every ``blur3d`` call of ``gaussian_blur`` that would
    take the walk form runs in ``form`` instead (None: as picked)."""
    from tissue_image_processing_tpu_torch.ops import blur_cuda, filters

    orig = filters.blur3d

    def forced(x, kz, ky, kx):
        walk = blur_cuda.blur3d_form(tuple(x.shape), (len(kz), len(ky),
                                                      len(kx))) == "walk"
        return orig(x, kz, ky, kx, form=form if walk else None)

    filters.blur3d = forced
    try:
        yield
    finally:
        filters.blur3d = orig


def check_driver_blur(name: str, x, kz, ky, kx, card: str,
                      library: bool = True) -> dict:
    """``blur3d`` at one of the unfused projection's shapes on the path's
    own input: the form ``blur3d_form`` picks and, where that is the walk
    form, the generic tile form too, each bit for bit against the plain
    version and equal over two runs; device time by graph replay, the two
    forms in turns (generic, walk, walk, generic; the walk form faster than
    the generic one in both pairs), the picked form's by events, the plain
    version's time and (``library``) a library yardstick (``conv3d`` with
    the outer product of the taps over the replicate-padded volume, cuDNN
    TF32 off)."""
    import torch
    import torch.nn.functional as F

    from tissue_image_processing_tpu_torch.ops import blur_cuda
    from tissue_image_processing_tpu_torch.utils.kernel_variants import graph_ms

    shape = (*x.shape, len(kz), len(ky), len(kx))
    form = blur_cuda.blur3d_form(shape[:3], shape[3:])
    forms = (form, "generic") if form == "walk" else (form,)
    want = blur_cuda.blur3d_plain(x, kz, ky, kx)
    call = {f: (lambda f=f: blur_cuda.blur3d(x, kz, ky, kx, form=f))
            for f in forms}
    for f in forms:
        got = call[f]()
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   msg=f"blur3d ({name}, {f}) disagrees with plain")
        assert torch.equal(call[f](), got), f"blur3d ({name}, {f}): two runs differ"
    got = call[form]()
    lib_ms = None
    if library:
        k = [torch.tensor(t, dtype=torch.float32, device=x.device)
             for t in (kz, ky, kx)]
        k3 = (k[0][:, None, None] * k[1][None, :, None]
              * k[2][None, None, :])[None, None]
        rz, ry, rx = (len(t) // 2 for t in (kz, ky, kx))

        def conv():
            xp = F.pad(x[None, None], (rx, rx, ry, ry, rz, rz), mode="replicate")
            return F.conv3d(xp, k3)[0, 0]

        prev_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        scale = float(want.abs().max())
        torch.testing.assert_close(conv(), want, rtol=1e-5, atol=1e-5 * scale)
        lib_ms = cuda_ms(conv, 1)  # ~1 s a call for the 9 x 17 x 17 taps
        torch.backends.cudnn.allow_tf32 = prev_tf32
    if form == "walk":   # in turns: generic, walk, walk, generic
        runs = [graph_ms(call[f]) for f in ("generic", "walk", "walk", "generic")]
        generic_runs, walk_runs = runs[::3], runs[1:3]
        assert max(walk_runs) < min(generic_runs), \
            f"blur3d ({name}): walk {walk_runs} ms not faster than generic {generic_runs}"
        device_ms, generic_ms = sum(walk_runs) / 2, sum(generic_runs) / 2
    else:
        walk_runs, generic_runs = [graph_ms(call[form])], None
        device_ms, generic_ms = walk_runs[0], None
    nvox = x.numel()
    ms = cuda_ms_spread(call[form], 10)
    row = dict(err=max_abs_err(got, want), form=form, device_ms=device_ms,
               device_ms_runs=walk_runs, generic_ms=generic_ms,
               generic_ms_runs=generic_runs, ms=ms[0], ms_min=ms[1], ms_max=ms[2],
               plain_ms=cuda_ms(lambda: blur_cuda.blur3d_plain(x, kz, ky, kx), 3),
               bound=bound(8 * nvox, 2 * sum(shape[3:]) * nvox),
               library_ms=lib_ms, shape=shape)
    versus = (f", generic form {generic_ms:.4f} ms (turns: generic "
              f"{generic_runs[0]:.4f}, {form} {walk_runs[0]:.4f} / "
              f"{walk_runs[1]:.4f}, generic {generic_runs[1]:.4f}; both "
              f"forms bit-exact)" if generic_ms else "")
    print(f"blur3d {name} {tuple(x.shape)} taps {shape[3:]}: {form} form "
          f"bit-exact (max_abs_err {row['err']:.3g}), two runs equal, device "
          f"(graph replay) {device_ms:.4f} ms{versus}, events {spread(ms)}, "
          f"plain {row['plain_ms']:.4f} ms, conv3d "
          + (f"{lib_ms:.4f} ms" if lib_ms else "not timed")
          + f", bound {row['bound'][0]:.4f} ms ({row['bound'][1]}) on {card}")
    return row


def check_ragged_blurs(card: str) -> dict:
    """The blur on ragged tiles of ``large_image_projection`` (952 x 552,
    and an odd 953 x 551 that takes the scalar loads) at the driver's tap
    counts: both forms bit for bit against the plain version, timed in
    turns (``check_driver_blur`` without the library yardstick). Returns
    {shape: (walk ms, generic ms)}."""
    import torch

    from tissue_image_processing_tpu_torch.ops.filters import gaussian_kernel1d

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for Y, X in ((952, 552), (953, 551)):
        x = torch.rand((30, Y, X), device="cuda", generator=gen) * 60000
        for sig in ((0.5, 1.0, 1.0), (1.0, 2.0, 2.0)):
            taps = [gaussian_kernel1d(s) for s in sig]
            r = check_driver_blur(f"ragged {Y}x{X}", x, *taps, card,
                                  library=False)
            out[f"{r['shape'][:3]} taps {r['shape'][3:]}"] = (
                r["device_ms"], r["generic_ms"])
    return out


ENVELOPE = (2, 40, 2000)   # README's production movie: T cut to 2, ~40 z, ~2000^2


def trace_project_stage(card: str, batch, device: str = "cuda") -> dict:
    """The projection driver's ``project`` stage traced on the card: the
    profiler (``device_profile``) around ``project_movie_array`` on one
    batch of the driver's frames (``batch``: (4, 2, Z, 2048, 2048) uint16,
    its default batch of 4), with the unfused projection's blurs in the
    generic tile form (before) and in the walk form (after): the ten
    costliest device operations, the device-busy share of the call's wall
    time and the blurs' share of the device time, by form. ``device``
    exists for a dry run on the CPU."""
    from tissue_image_processing_tpu_torch.projection import driver

    out = {}
    for label, form in (("generic", "generic"), ("walk", None)):
        with forced_blur_form(form):
            n_ops, busy, wall, ops = device_profile(
                lambda: driver.project_movie_array(batch, device=device),
                rows=True)
        blur = sum(ms for name, _, ms in ops if "blur_" in name)
        out[label] = dict(wall_ms=wall, busy_ms=busy, blur_ms=blur,
                          top=[(name[:80], n, ms) for name, n, ms in ops[:10]])
        print(f"files: project stage traced, blurs in the {label} form: "
              f"project_movie_array on one batch {batch.shape}: wall "
              f"{wall:.1f} ms (profiler on), device busy {busy:.1f} ms "
              f"({busy / wall:.4f} of the wall), {n_ops} device operations; "
              f"blurs {blur:.3f} ms ({blur / busy:.4f} of the device time) on "
              f"{card}; the ten costliest: " + "; ".join(
                  f"{name[:80]} x{n} {ms:.3f} ms" for name, n, ms in ops[:10]))
    return out


def check_envelope(card: str, big, device: str = "cuda",
                   min_cells: int = 800) -> dict:
    """The README's production envelope on the card: ``movie_pipeline`` on a
    T=2 movie of (2, 40, 2000, 2000) uint16 frames cut from the driver's
    tiled 2048^2 frames (``big``), planes 0-9 repeated to reach 40. No
    fused kernel takes it (2000 % 64 != 0): no ``proj_score`` /
    ``proj_project`` launch; ``blur3d``'s launches by shape (the pre-blur
    and z-mask blur twice each, in the walk form, the score blur's z axis
    twice, the watershed pre-blur once for the one flood batch) and by
    form; frames/s. The walk form's inputs of frame 0 bit for bit in both
    forms and timed (``check_driver_blur``). Returns their rows by name.
    ``device``, ``ENVELOPE`` and ``min_cells`` exist for a dry run on the
    CPU."""
    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core.pipeline import movie_pipeline

    T, Z, S = ENVELOPE
    env = np.ascontiguousarray(np.concatenate(
        [big[:T, :, :, :S, :S], big[:T, :, :Z - big.shape[2], :S, :S]], axis=2))
    kw = dict(batch=2, capacity=4096, block_size=101, std=3.0, device=device)
    walk = {"pre_blur": (Z, S, S, 5, 9, 9), "mask_blur": (Z, S, S, 9, 17, 17)}
    with capture_blur_inputs(set(walk.values())) as captured:
        movie_pipeline(env, **kw)   # warm, and frame 0's blur inputs
    tipt.reset_launches()
    out, secs = synced_seconds(lambda: movie_pipeline(env, **kw),
                               torch.device(device))
    launches = {k: v for k, v in tipt.LAUNCHES.items() if v}
    assert not any(launches.get(k) for k in PROJECTION_KERNELS), \
        f"the envelope movie took the fused route: {launches}"
    small = S // 4 if S >= 512 and S % 4 == 0 else S  # the score's decimation
    by_shape = blur_launches({walk["pre_blur"]: T, walk["mask_blur"]: T,
                              (Z, small, small, 5, 1, 1): T,
                              (T, S, S, 1, 25, 25): -(-T // kw["batch"])})
    forms = dict(tipt._device.BLUR_FORMS)
    assert forms == {"walk": 2 * T, "z_only": T, "tile25": 1}, forms
    labels = out["labels"].cpu().numpy()
    cells = [int(np.unique(f).size - 1) for f in labels]
    assert labels.shape == (T, S, S) and min(cells) > min_cells, (labels.shape,
                                                                cells)
    print(f"envelope: movie_pipeline {env.shape} uint16 (unfused route, no "
          f"fused-kernel launch): {T / secs:.3f} frames/s ({secs:.3f} s) on "
          f"{card}; cells/frame {cells}; launches {launches}; blur3d by form "
          f"{forms}")
    del env, out
    rows = {}
    for name, shape in walk.items():
        x, kz, ky, kx = captured.pop(shape)
        rows[f"envelope_{name}"] = dict(check_driver_blur(
            f"envelope_{name}", x, kz, ky, kx, card),
            launches=by_shape[f"{shape[:3]} taps {shape[3:]}"])
        del x
    return rows


def check_files(card: str, movie):
    """The "files" phase: the file layer and the projection driver on the
    card. ``movie``: the (T, 2, 30, 1024, 1024) uint16 headline movie (sizes
    below are for it; they scale with its side).

    1. its frames tiled 2 x 2 to (T, 2, 30, 2048, 2048) uint16 (503 MB a
       frame), written frame by frame through ``MovieStore.create`` /
       ``write_frame`` into a temporary directory under ``build/``;
    2. ``project_movie_array`` on the in-memory array (warm-up, and the
       reference: the blur's inputs at the driver's three shapes captured),
       then ``tip-project`` (``projection.cli.main``) on the ``.npy`` store
       with the counters zeroed: file-to-file frames/s, its StageMetrics,
       ``blur3d``'s launches by shape (3 a frame), the saved z-maps equal
       to the in-memory ones and ``position1.tif`` to their projections
       cast to uint16;
    3. one 1024^2 crop of frame 0 on the card against the CPU;
    4. ``large_image_projection`` of a (1, 2, 30, 3000, 2600) fixed sample
       cut from frame 0 tiled 3 x 3, chunk 1024 (9 tiles, 5 ragged): each
       tile's z-map and projection equal to that tile projected alone;
    5. ``movie_pipeline_chunked`` fed from a ``MovieStore`` of the headline
       movie (``.npy``, 4-frame chunks) equal to ``movie_pipeline`` on the
       in-memory array;
    6. the ``project`` stage of one batch traced (``trace_project_stage``)
       and the production envelope (``check_envelope``).
    The TIFF legs run where PIL is installed. Returns the captured blur
    inputs by name, ``blur3d``'s launches by shape on the CLI run (the
    pre-blur and z-mask blur in the walk form) and the envelope's blur
    rows."""
    import importlib.util
    import os
    import tempfile
    from pathlib import Path

    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core.pipeline import (
        movie_pipeline, movie_pipeline_chunked)
    from tissue_image_processing_tpu_torch.io import tiff
    from tissue_image_processing_tpu_torch.io.movie import MovieStore
    from tissue_image_processing_tpu_torch.projection import cli, driver
    from tissue_image_processing_tpu_torch.utils.runtime import StageMetrics

    found = [m for m in OPTIONAL_PACKAGES if importlib.util.find_spec(m)]
    pil = "PIL" in found
    print(f"files: optional packages found {found}, missing "
          f"{[m for m in OPTIONAL_PACKAGES if m not in found]}; legs run: "
          + ("CLI to TIFF, large_image_projection, " if pil else
             "driver on the .npy store (no PIL: no TIFF leg), ")
          + "card vs CPU, store-fed chunked pipeline, blurs")
    T, _, Z, H, W = movie.shape
    side, cut = 2 * H, (3000 * H // 1024, 2600 * W // 1024)
    blurs = driver_blurs(Z, side)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="smoke_files_") as d:
        t0 = time.perf_counter()
        big = np.empty((T, 2, Z, side, side), np.uint16)
        store = MovieStore.create(os.path.join(d, "m1.npy"), big.shape)
        for t in range(T):
            big[t] = np.tile(movie[t], (1, 1, 2, 2))
            store.write_frame(t, big[t])
        store.data.flush()
        del store
        print(f"files: driver movie {big.shape} uint16, {big.nbytes / 1e9:.3f} "
              f"GB, written through MovieStore in {time.perf_counter() - t0:.1f} s")

        with capture_blur_inputs(set(blurs.values())) as captured:
            proj, zmap = driver.project_movie_array(big)
        torch.cuda.synchronize()
        print(f"files: expected blur3d launches on the driver run: 3 a frame "
              f"({3 * T}), one at each of {sorted(blurs.values())}")
        out = os.path.join(d, "out")
        os.makedirs(out)
        metrics = StageMetrics(stream=None)
        tipt.reset_launches()
        t0 = time.perf_counter()
        if pil:
            rc = cli.main(["-i", d, "-o", out, "-n", "1", "-m", "1", "-r", "0",
                           "--ext", "npy"], metrics=metrics)
            assert rc == 0, rc
        else:
            with metrics.stage("project"):
                got_p, got_z = driver.project_movie_array(
                    MovieStore.open(os.path.join(d, "m1.npy")).data)
        secs = time.perf_counter() - t0
        launches = launched({"blur3d": 3 * T})
        by_shape = blur_launches({s: T for s in blurs.values()})
        forms = dict(tipt._device.BLUR_FORMS)
        assert forms == {"walk": 2 * T, "z_only": T}, forms
        stages = metrics.summary()
        what = ("tip-project (CLI): .npy store -> position1.tif + zmap_position1.npy"
                if pil else "project_movie_array on the .npy store")
        print(f"files: {what}, {T} x 2 x {Z} x {side}^2 uint16: "
              f"{T / secs:.3f} frames/s file to file ({secs:.3f} s), stage "
              f"seconds " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
              + f"; launches {launches} on {card}")
        if pil:
            got_z = np.load(os.path.join(out, "zmap_position1.npy"))
            got_p = tiff.read_tiff(os.path.join(out, "position1.tif"))[0]
            assert got_p.dtype == np.uint16 and np.array_equal(
                got_p, proj.astype(np.uint16)), "position1.tif != projections"
            assert sorted(os.listdir(out)) == ["position1.tif",
                                               "zmap_position1.npy"]
        else:
            assert np.array_equal(got_p, proj), "store projections differ"
        assert np.array_equal(got_z.astype(np.int64), zmap), \
            "the CLI's z-maps differ from project_movie_array's"
        assert zmap.shape == (T, side, side) and 0 <= zmap.min() <= zmap.max() < Z
        print("files: CLI z-maps == project_movie_array on the in-memory "
              "array" + (", position1.tif == its projections as uint16" if pil
                         else ""))
        trace_project_stage(card, big[:4])
        envelope_rows = check_envelope(card, big)

        # card against CPU on one H x W crop of frame 0
        crop = big[:1, :, :, :H, :W]
        gp, gz = driver.project_movie_array(crop)
        t0 = time.perf_counter()
        wp, wz = driver.project_movie_array(crop, device="cpu")
        cpu_s = time.perf_counter() - t0
        same = gz == wz
        assert same.mean() >= 0.999 and np.abs(gz - wz).max() <= 1, \
            (same.mean(), np.abs(gz - wz).max())
        sel = np.broadcast_to(same[:, None], gp.shape)
        np.testing.assert_allclose(gp[sel], wp[sel], rtol=1e-4, atol=1e-3)
        print(f"files: card vs CPU on a {H} x {W} crop of frame 0: z-maps equal "
              f"on {same.mean():.6f} (|dz| <= {np.abs(gz - wz).max()}), "
              f"projections max rel err "
              f"{float(np.max(np.abs(gp[sel] - wp[sel]) / (np.abs(wp[sel]) + 1e-3))):.3g}"
              f" (CPU {cpu_s:.1f} s)")
        del big

        # large_image_projection: 9 tiles of H (1024), 5 ragged
        fixed = np.ascontiguousarray(
            np.tile(movie[0], (1, 1, 3, 3))[None, :, :, :cut[0], :cut[1]])
        np.save(os.path.join(d, "fixed.npy"), fixed)
        if pil:
            t0 = time.perf_counter()
            assert driver.large_image_projection(
                d, out, "fixed.npy", chunk_size=H) == 1
            print(f"files: large_image_projection {fixed.shape} chunk {H} in "
                  f"{time.perf_counter() - t0:.3f} s")
            lz = np.load(os.path.join(out, "fixed_zmap.npy"))
            lp = tiff.read_tiff(os.path.join(out, "fixed_projection.tif"))[0]
            assembled = np.zeros((2,) + cut, np.float32)
            tiles = []
            for y0 in range(0, cut[0], H):
                for x0 in range(0, cut[1], H):
                    tile = fixed[:, :, :, y0:y0 + H, x0:x0 + H]
                    tiles.append(tile.shape[-2:])
                    p1, z1 = driver.project_movie_array(tile)
                    assert np.array_equal(
                        lz[0, y0:y0 + H, x0:x0 + H], z1[0]), (y0, x0)
                    assembled[:, y0:y0 + H, x0:x0 + H] = p1[0]
            assert len(tiles) == 9 and sum(t != (H, H) for t in tiles) == 5, tiles
            tiff.save_tiff(os.path.join(d, "want.tif"), assembled, axes="CYX",
                           data_type="uint16")
            assert np.array_equal(lp, tiff.read_tiff(os.path.join(d, "want.tif"))[0])
            print(f"files: large_image_projection 9 tiles {tiles}: z-maps and "
                  f"projection equal to each tile projected alone")

        # movie_pipeline_chunked fed from a MovieStore
        np.save(os.path.join(d, "headline.npy"), movie)
        kw = dict(batch=2, capacity=1024, block_size=101, std=3.0)
        store = MovieStore.open(os.path.join(d, "headline.npy"))
        want = movie_pipeline(movie, **kw)
        got = movie_pipeline_chunked(store, chunk_frames=4, **kw)
        assert np.array_equal(got["labels"], want["labels"].cpu().numpy())
        assert np.array_equal(got["ids"], want["ids"])
        for f in dataclasses.fields(got["tables"]):
            assert np.array_equal(getattr(got["tables"], f.name).numpy(),
                                  getattr(want["tables"], f.name).cpu().numpy()), f.name
        print(f"files: movie_pipeline_chunked from a MovieStore ({movie.shape} "
              f".npy, 4-frame chunks) == movie_pipeline on the in-memory array "
              f"(labels, every table field, ids)")

    inputs = {name: captured[shape] for name, shape in blurs.items()}
    launches = {name: by_shape[f"{shape[:3]} taps {shape[3:]}"]
                for name, shape in blurs.items()}
    return inputs, launches, envelope_rows


TISSUE_CPU_FULL_S = 60.0   # the CPU twin runs every frame below this, else 3


def tissue_steps(tissue, markers, refs, frame: int, timed):
    """The session steps of the "tissue" phase on one ``Tissue`` (card or
    CPU), each wrapped in ``timed(name, fn)``; returns what each produced.
    ``markers`` / ``refs``: (T, X, Y) projected atoh and reference frames
    in the labels' x-major space, as numpy."""
    from tissue_image_processing_tpu_torch.core import frame_data as FD
    from tissue_image_processing_tpu_torch.core.editing import (
        SegmentationEditor)

    T = tissue.number_of_frames
    out = {}

    def classify():
        for f in range(1, T + 1):
            tissue.calc_cell_types(markers[f - 1], f, "HC", threshold=0.3)

    timed("calc_cell_types", classify, T)
    timed("fix_cell_types_after_tracking",
          lambda: tissue.fix_cell_types_after_tracking(
              min_frame_for_diff_detection=3), T)
    timed("find_events", lambda: tissue.find_events(), max(T - 1, 1))
    out["contact"] = timed(
        "calc_neighbors_contact_matrix",
        lambda: [tissue.calc_neighbors_contact_matrix(f) for f in range(1, T + 1)],
        T)
    side = tissue.get_labels(1).shape[0]
    tissue.add_event("ablation", frame, min(frame + 1, T),
                     start_pos=(side // 2, side // 2))
    mask = tissue.get_valid_non_edge_mask(frame)
    names = (FD.COLUMN_FEATURES + FD.SPECIAL_FEATURES + FD.SPATIAL_FEATURES
             + FD.SPECIAL_X_ONLY_FEATURES + FD.GLOBAL_FEATURES)
    out["features"] = timed("get_frame_data", lambda: {
        name: FD.get_frame_data(tissue, frame, name, mask)[0] for name in names}, 1)
    timed("track_cells", lambda: tissue.track_cells(images=refs), T)
    out["ids"] = np.stack([tissue.get_cells_info(f).label.cpu().numpy()
                           for f in range(1, T + 1)])

    # editing: split the largest interior cell of the frame, remove a
    # boundary line beside it, undo both: bit for bit at each depth
    table = tissue.get_cells_info(frame)
    labels = tissue.get_labels(frame)
    left, right, line, _ = cell_geometry(labels, table, mask)
    before = (labels.copy(), tissue.get_cell_types(frame).copy(),
              host_fields(table))

    def edit():
        ed = SegmentationEditor(tissue)
        ed.add_segmentation_line(frame, left, initial=True)
        ed.add_segmentation_line(frame, right, point2=left)
        ed.add_segmentation_line(frame, right, final=True)
        split = tissue.get_labels(frame).copy()
        # the line on the cell's right, beside its upper half
        ed.remove_segmentation_line(frame, line)
        merged = tissue.get_labels(frame).copy()
        undone = (ed.undo_last_action(frame), ed.undo_last_action(frame))
        return split, merged, undone

    split, merged, undone = timed("editing (add, remove, 2 undos)", edit, 1)
    assert undone == (1, 1), undone
    assert (split != before[0]).any() and (merged != split).any(), \
        "the edits changed nothing"
    now = host_fields(tissue.get_cells_info(frame))
    assert np.array_equal(tissue.get_labels(frame), before[0]) and \
        np.array_equal(tissue.get_cell_types(frame), before[1]) and all(
            np.array_equal(now[k], v) for k, v in before[2].items()), \
        "undo is not bit for bit"
    out["edits"] = (split, merged)
    return out


def host_fields(table) -> dict:
    return {f.name: getattr(table, f.name).cpu().numpy()
            for f in dataclasses.fields(table)}


def sorted_events(df):
    return df.sort_values(["type", "start_frame", "cell_id"],
                          kind="stable").reset_index(drop=True)


def session_contents(tissue) -> dict:
    """Every artifact of a session as host arrays (tables as their fields)."""
    T = tissue.number_of_frames
    return {
        "labels": [tissue.get_labels(f) for f in range(1, T + 1)],
        "types": [tissue.get_cell_types(f) for f in range(1, T + 1)],
        "tables": [host_fields(tissue.get_cells_info(f))
                   for f in range(1, T + 1)],
        "events": sorted_events(tissue.get_events()),
        "drifts": tissue.drifts, "valid_frames": tissue.valid_frames,
        "names": (tissue.type_names, tissue.channel_names, tissue.fake_channels)}


def assert_contents_equal(a: dict, b: dict, what: str, drift_atol: float = 0.0):
    for key in ("labels", "types"):
        for f, (x, y) in enumerate(zip(a[key], b[key])):
            assert np.array_equal(x, y), f"{what}: {key} of frame {f + 1}"
    for f, (x, y) in enumerate(zip(a["tables"], b["tables"])):
        for k in y:
            assert np.array_equal(x[k], y[k]), f"{what}: {k} of frame {f + 1}"
    import pandas as pd
    pd.testing.assert_frame_equal(a["events"], b["events"], check_dtype=False,
                                  obj=f"{what}: events")
    assert np.allclose(a["drifts"], b["drifts"], rtol=0, atol=drift_atol), what
    assert np.array_equal(a["valid_frames"], b["valid_frames"]), what
    assert a["names"] == b["names"], what


def check_tissue(card: str, movie, device: str = "cuda", side: int = 1024,
                 n_cells: int = 2000):
    """The "tissue" phase: the ``Tissue`` session on the card, fed by
    ``movie_pipeline`` as the JAX package's ``cmd_pipeline`` feeds it.

    1. ``movie_pipeline`` on ``movie`` (the headline raw movie, watershed
       branch, capacity 1024) and the projections of both channels (the
       reference frames and the atoh marker), the feed; one stacked
       read-back of labels and tables, then ``set_labels``,
       ``apply_track_ids`` and the drifts into a session on the card (its
       tables stay on the host, as ``cmd_pipeline`` keeps them; the steps
       compute on the card). Then each step timed (host clock,
       synchronised) with its hand-written kernel launches (none expected
       but ``track_cells``' three ``radii_sweep``, its adaptive radii):
       ``calc_cell_types`` on every frame, ``fix_cell_types_after_tracking``,
       ``find_events``, the contact matrices, ``get_frame_data`` for every
       feature name on frame 4, ``track_cells(images=...)`` on the
       reference frames, a ``SegmentationEditor`` add-line, remove-line and
       two undos (bit for bit), ``save`` to a ``.seg`` under ``build/`` and
       ``load`` (every artifact equal), then the peak-gated classification
       (``peak_window_size=5``) of frame 1 under its own type name;
    2. the same steps from the same labels on a CPU session (every frame,
       or the first 3 when a probe says all of them would pass
       ``TISSUE_CPU_FULL_S``): tables, types, ids, events, integer features,
       contact matrices, edits and every member of the archives but the
       drifts exact, float features 1e-5, the drifts of ``track_cells``
       within one bin of the 100x upsampled phase correlation (0.01 px
       and float32 rounding; printed); the peak-gated types'
       agreement printed (>= 99.9% of cells) and ``track_cells``' ids
       against the pipeline's (printed, not gated);
    3. ``make_tracked_tissue`` at production density (8 frames, ``side``^2,
       ``n_cells`` cells; capacity 2048 at 2000) with its tables on the card
       and a planted delamination, division and differentiation (seeds
       n/2, n/2 - 20 and n/2 + 20: ids 1001, 981 and 1021 at 2000): each
       found under its type with its planted id, none on a static tissue of
       that size; ``find_events`` ms per frame pair,
       ``second_order_neighbors_from_type`` and ``spatial_map`` ms.
    ``device``, ``side`` and ``n_cells`` exist for a dry run on the CPU at
    a small size; the smoke run takes the defaults. Returns the feed (the
    pipeline's labels, host tables, ids and drifts) for the "cli" phase."""
    import tempfile
    from pathlib import Path

    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch.core import features as F
    from tissue_image_processing_tpu_torch.core.pipeline import (
        _projections, movie_pipeline)
    from tissue_image_processing_tpu_torch.core.tissue import Tissue
    from tissue_image_processing_tpu_torch.utils.synthetic import (
        make_tracked_tissue)

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    T = movie.shape[0]
    cap = 1024
    tipt.reset_launches()
    out = movie_pipeline(movie, batch=2, capacity=cap, block_size=101, std=3.0,
                         device=dev)
    prj = _projections(movie, 0, dev)            # (T, 2, Y, X): reference, atoh
    refs = prj[:, 0].transpose(1, 2).contiguous().cpu().numpy()
    markers = prj[:, 1].transpose(1, 2).contiguous().cpu().numpy()
    sync()
    feed = {k: v for k, v in tipt.LAUNCHES.items() if v}
    labels = out["labels"].cpu().numpy()
    host = out["tables"].map(lambda t: t.cpu())  # one stacked read-back
    feed = {"labels": labels, "tables": host, "ids": out["ids"],
            "drifts": out["drifts"]}
    print(f"tissue: fed by movie_pipeline {tuple(movie.shape)} and the "
          f"projections of both channels; the feed's launches {feed}")

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="smoke_tissue_") as d:
        def populate(on, frames):
            return populate_session(feed, frames, str(Path(d) / f"session_{on}"),
                                    on, ["zo", "atoh"], cap)

        def run(tissue, frames, record):
            def timed(name, fn, per):
                if record is not None:
                    sync()
                    tipt.reset_launches()
                t0 = time.perf_counter()
                res = fn()
                if record is not None:
                    sync()
                    tracked = (name == "track_cells"
                               and tissue.device.type == "cuda")
                    # the radii's three launches, an auction a frame
                    record[name] = ((time.perf_counter() - t0) * 1e3 / per,
                                    launched({"radii_sweep": 3 * tracked,
                                              "auction": per * tracked}))
                return res

            res = tissue_steps(tissue, markers[:frames], refs[:frames],
                               min(4, frames), timed)
            seg = str(Path(d) / f"{tissue.device.type}.seg")
            timed(".seg save", lambda: list(tissue.save(seg)), frames)
            back = Tissue(frames, str(Path(d) / f"back_{tissue.device.type}"),
                          capacity=cap, device=tissue.device)
            timed(".seg load", lambda: list(back.load(seg)), frames)
            res["contents"] = session_contents(tissue)
            # load() drops duplicated event rows, as the JAX package's does
            saved = dict(res["contents"], events=sorted_events(
                tissue.get_events().drop_duplicates(ignore_index=True)))
            assert_contents_equal(session_contents(back), saved,
                                  f".seg round trip ({tissue.device.type})")
            back.clean_up()
            timed("calc_cell_types (peak_window_size=5)",
                  lambda: tissue.calc_cell_types(markers[0], 1, "HCpeak",
                                                 threshold=0.3,
                                                 peak_window_size=5), 1)
            res["peak"] = tissue.get_cells_info(1).type.cpu().numpy()
            res["seg"] = zipfile_contents(seg)
            return res

        # the CPU twin takes every frame unless a probe (one frame's
        # classification and contact matrix) says that would pass the limit
        t0 = time.perf_counter()
        probe = populate("cpu", 1)
        probe.calc_cell_types(markers[0], 1, "HC", threshold=0.3)
        probe.calc_neighbors_contact_matrix(1)
        estimate = (time.perf_counter() - t0) * T * 4
        probe.clean_up()
        frames = T if estimate < TISSUE_CPU_FULL_S else 3

        card_s = populate(device, T)
        steps = {}
        t0 = time.perf_counter()
        got = run(card_s, T, steps)
        card_total = time.perf_counter() - t0
        check_examples(card, str(Path(d) / f"{card_s.device.type}.seg"),
                       Path(d), device)
        for name, (ms, launches) in steps.items():
            print(f"tissue (card): {name} {ms:.3f} ms per frame "
                  f"(hand-written kernel launches: {launches or 'none'}) on {card}")
        print(f"tissue (card): {T} frames, capacity {cap}: every step "
              f"{card_total:.3f} s; undo bit for bit; .seg save + load equal "
              f"on {card}")
        card_s.clean_up()
        if frames < T:   # the card again, on the CPU's frames
            card_s = populate(device, frames)
            got = run(card_s, frames, None)
            card_s.clean_up()
        cpu_s = populate("cpu", frames)
        t0 = time.perf_counter()
        want = run(cpu_s, frames, None)
        cpu_total = time.perf_counter() - t0
        cpu_s.clean_up()

    # the drifts come from phase correlation upsampled 100x: the card's and
    # the CPU's FFTs may pick neighbouring bins of a flat peak, one bin
    # (0.01 px, plus the float32 rounding of the shifts) apart
    drift_err = float(np.abs(got["contents"]["drifts"]
                             - want["contents"]["drifts"]).max())
    assert_contents_equal(got["contents"], want["contents"], "card vs CPU",
                          drift_atol=0.01 + 1e-5)
    for f, (a, b) in enumerate(zip(got["contact"], want["contact"])):
        assert np.array_equal(a, b), f"contact matrix of frame {f + 1}"
    for a, b in zip(got["edits"], want["edits"]):
        assert np.array_equal(a, b), "edits differ"
    n_float = 0
    for name, w in want["features"].items():
        g = got["features"][name]
        if hasattr(w, "to_numpy"):   # the 'neighbors by type' DataFrame
            assert list(g.columns) == list(w.columns), name
            g, w = g.to_numpy(), w.to_numpy()
        g, w = np.asarray(g), np.asarray(w)
        if w.dtype.kind == "f":
            n_float += 1
            assert np.allclose(g, w, rtol=1e-5, atol=1e-6), name
        else:
            assert np.array_equal(g, w), name
    members = got["seg"]
    assert members.keys() == want["seg"].keys()
    exact = sorted(k for k in members if k != "drifts.npy")
    for k in exact:
        assert members[k] == want["seg"][k], f".seg member {k} differs"
    exists = got["contents"]["tables"][0]["empty_cell"] == 0
    peak_same = float((got["peak"] == want["peak"])[exists].mean())
    assert peak_same >= 0.999, peak_same
    pipe = np.where(host.valid_mask()[:frames].numpy(), out["ids"][:frames], 0)
    valid = pipe > 0
    agree = float((got["ids"][valid] == pipe[valid]).mean())
    which = ("every frame" if frames == T else
             f"the first 3: all {T} were estimated at {estimate:.0f} s > "
             f"{TISSUE_CPU_FULL_S:.0f} s")
    print(f"tissue: card == CPU on {frames} of {T} frames ({which}; CPU "
          f"{cpu_total:.1f} s): tables, types, ids, events, contact matrices, "
          f"edits and integer features exact, {n_float} float features within "
          f"1e-5, {len(got['contents']['events'])} events equal, drifts "
          f"within {drift_err:.6g} px, {len(exact)} of {len(members)} .seg "
          f"members byte for byte (all but drifts.npy); peak-gated "
          f"types agree on {peak_same:.6f} of {int(exists.sum())} cells; "
          f"track_cells ids == the pipeline's on {agree:.6f} of "
          f"{int(valid.sum())} cells on {card}")

    # production density with planted events, tables on the card
    mid = n_cells // 2
    t0 = time.perf_counter()
    tissue, info = make_tracked_tissue(
        n_frames=8, size=side, n_cells=n_cells, seed=3,
        delaminate=[(mid, 4)], divide=[(mid - 20, 5)],
        differentiate=[(mid + 20, 5)], device=dev)
    made = time.perf_counter() - t0
    assert tissue.get_cells_info(1).area.device.type == dev.type
    tipt.reset_launches()
    sync()
    t0 = time.perf_counter()
    tissue.find_events()
    events_ms = (time.perf_counter() - t0) * 1e3 / 7
    launched({})
    ev = tissue.get_events()
    for kind, cid in (("delamination", mid + 1), ("division", mid - 19),
                      ("differentiation", mid + 21)):
        assert cid in set(ev.query(f'type == "{kind}"').cell_id.astype(int)), \
            (kind, ev.to_string())
    daughter = info["division"][0][0]
    assert daughter in set(ev.query('type == "division"').daughter_id.astype(int))
    table = tissue.get_cells_info(4)
    mask = table.valid_mask()
    timer = cuda_ms if dev.type == "cuda" else host_ms
    so_ms = timer(lambda: F.second_order_neighbors_from_type(table, 0, True), 5)
    sm_ms = timer(lambda: F.spatial_map(table, (side, side), 100.0, 16,
                                        mask.float(), mask, "density"), 5)
    static, _ = make_tracked_tissue(n_frames=4, size=side, n_cells=n_cells,
                                    seed=3, device=dev)
    static.find_events()
    assert len(static.get_events()) == 0, static.get_events().to_string()
    print(f"tissue: make_tracked_tissue 8 x {side}^2, {n_cells} cells, capacity "
          f"{tissue.capacity} ({made:.1f} s): planted delamination {mid + 1}, "
          f"division {mid - 19} (daughter {daughter}) and differentiation "
          f"{mid + 21} found among {len(ev)} events; none on a static tissue; "
          f"find_events {events_ms:.3f} ms per frame pair, "
          f"second_order_neighbors_from_type {so_ms:.4f} ms, spatial_map "
          f"({-(-side // 16)}^2 grid) {sm_ms:.4f} ms on {card}")
    print(f"tissue: phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return feed


def matplotlib_stand_in() -> dict:
    """Stub ``matplotlib`` and ``matplotlib.pyplot`` modules (the card's
    machine has no matplotlib) with what the example analyses draw with:
    ``subplots`` hands out axes whose every method does nothing, and a
    figure's ``savefig`` writes an empty file, so the scripts write their
    data files as they do with the real library."""
    import types

    class Axes:
        def __getattr__(self, name):
            return lambda *args, **kwargs: None

    class Figure(Axes):
        def savefig(self, path, *args, **kwargs):
            Path(path).write_bytes(b"")

    def subplots(nrows=1, ncols=1, **kwargs):
        n = nrows * ncols
        return Figure(), Axes() if n == 1 else tuple(Axes() for _ in range(n))

    mpl = types.ModuleType("matplotlib")
    plt = types.ModuleType("matplotlib.pyplot")
    mpl.use = lambda *args, **kwargs: None
    plt.subplots, plt.close = subplots, lambda *args, **kwargs: None
    mpl.pyplot = plt
    return {"matplotlib": mpl, "matplotlib.pyplot": plt}


def data_files(folder: Path) -> dict:
    """The CSV and JSON files an example analysis wrote into ``folder``:
    {name: CSV table or parsed JSON}."""
    import pandas as pd

    out = {}
    for path in sorted(folder.iterdir()):
        if path.suffix == ".csv":
            out[path.name] = pd.read_csv(path)
        elif path.suffix == ".json":
            out[path.name] = json.loads(path.read_text())
    return out


def check_examples(card: str, seg: str, root: Path, device: str = "cuda"
                   ) -> None:
    """``examples/event_rates_torch.py`` (a 2 x 2 design: two groups of
    sessions, each ``seg`` twice, and two of literal counts) and
    ``examples/survival_by_neighbors_torch.py`` on ``seg``, each run on
    ``device`` (the card: ``device=None``, the scripts' default) and with
    ``device="cpu"``: the same files, their CSV tables and JSON equal
    (integers exactly, floats to rtol 1e-6). matplotlib's stand-in where
    it is missing."""
    import pandas as pd

    examples = Path(__file__).resolve().parent / "examples"

    def script(name):
        spec = importlib.util.spec_from_file_location(
            f"smoke_{name}", examples / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    rates, survival = script("event_rates_torch"), script(
        "survival_by_neighbors_torch")
    literal = {"counts": [32, 27, 59], "hours": [48, 46, 30],
               "area_um2": [327040, 300160, 328320]}
    sessions = {"sessions": [seg, seg], "hours": [30, 36],
                "area_um2": [1e6, 1.1e6]}
    groups = {"E17.5/normal": literal, "E17.5/ablation": sessions,
              "P0/normal": dict(literal, counts=[8, 14, 11]),
              "P0/ablation": dict(sessions, hours=[40, 44])}
    real = importlib.util.find_spec("matplotlib") is not None
    stubs = {} if real else matplotlib_stand_in()
    got = {}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for name, mod in stubs.items():
            stack.enter_context(stub_module(name, mod))
        for on, dev in (("card", None if device == "cuda" else device),
                        ("cpu", "cpu")):
            out = root / f"examples_{on}"
            out.mkdir()
            cfg = root / f"rates_{on}.json"
            cfg.write_text(json.dumps({"groups": groups, "output": str(out),
                                       "event_type": "differentiation"}))
            assert rates.main([str(cfg)], device=dev) == 0
            assert survival.main([str(out), seg, seg], device=dev) == 0
            got[on] = data_files(out)
    seconds = time.perf_counter() - t0
    card_files, cpu_files = got["card"], got["cpu"]
    assert card_files.keys() == cpu_files.keys() and card_files, \
        (card_files.keys(), cpu_files.keys())
    for name, want in cpu_files.items():
        have = card_files[name]
        if isinstance(want, pd.DataFrame):
            assert list(have.columns) == list(want.columns), name
            for col in want.columns:
                a, b = have[col].to_numpy(), want[col].to_numpy()
                if a.dtype.kind == "f" or b.dtype.kind == "f":
                    np.testing.assert_allclose(a.astype(float), b.astype(float),
                                               rtol=1e-6, err_msg=name + col)
                else:
                    both = pd.isna(a) & pd.isna(b)
                    assert np.array_equal(a[~both], b[~both]), name + col
        else:
            assert json.dumps(have, sort_keys=True) == json.dumps(
                want, sort_keys=True), name
    curves = card_files["survival_by_neighbors_data.csv"]
    print(f"tissue: the example analyses on the card's .seg "
          f"(event_rates_torch 2 x 2 design: "
          f"{card_files['differentiation_rates_stats.json']['method']}; "
          f"survival_by_neighbors_torch: {curves.shape[1] - 1} curve columns "
          f"of {len(curves)} rows): {sorted(card_files)} on the card equal "
          f"to device='cpu' ({'matplotlib' if real else 'a matplotlib stand-in'}"
          f"; {seconds:.1f} s for both) on {card}")


def populate_session(feed, frames: int, path: str, device, channel_names,
                     capacity: int):
    """A ``Tissue`` on ``device`` populated from ``movie_pipeline``'s host
    output ``feed`` (labels, stacked host tables, ids, drifts) as the CLI's
    ``cmd_pipeline`` populates it: per frame ``set_labels`` and
    ``apply_track_ids`` with the frame's slice of the tables, then the
    drifts."""
    from tissue_image_processing_tpu_torch.core.tissue import Tissue

    host = feed["tables"]
    t = Tissue(frames, path, channel_names=channel_names, capacity=capacity,
               device=device)
    for f in range(1, frames + 1):
        t.set_labels(f, feed["labels"][f - 1].copy(), reset_data=True)
        t.apply_track_ids(f, host.map(lambda x: x[f - 1].clone()),
                          feed["ids"][f - 1], host.valid_mask()[f - 1].numpy())
    t.drifts[:] = feed["drifts"][:frames]
    return t


def h5py_stand_in():
    """A module with the part of h5py's interface that
    ``utils/synthetic.py:write_keras_h5`` and
    ``models/weights_io.py:keras_layer_arrays`` use (``File`` as a context
    manager, groups, datasets, ``visititems``). The card's machine has no
    h5py; this one keeps a file's datasets in an ``.npz`` under their HDF5
    paths, so the CLI's ``--weights`` loader runs there as it does on a
    real Keras file."""
    import types

    mod = types.ModuleType("h5py")
    GROUPS = "__groups__"

    class Dataset:
        def __init__(self, array):
            self._array = np.asarray(array)

        def __array__(self, dtype=None, copy=None):
            return self._array if dtype is None else self._array.astype(dtype)

    class Group(dict):
        def create_group(self, name):
            return self.setdefault(name, Group())

        def create_dataset(self, name, data):
            self[name] = Dataset(data)

        def visititems(self, fn, prefix=""):
            for name in sorted(self):   # h5py visits in name order
                obj = self[name]
                fn(prefix + name, obj)
                if isinstance(obj, Group):
                    obj.visititems(fn, prefix + name + "/")

    class File(Group):
        def __init__(self, path, mode="r"):
            super().__init__()
            self._path, self._mode = path, mode
            if mode == "r":
                with np.load(path) as z:
                    for key in z.files:
                        *groups, leaf = key.split("/")
                        g = self
                        for name in groups:
                            g = g.create_group(name)
                        if key == GROUPS:   # the groups, empty ones too
                            for group in z[key]:
                                g = self
                                for name in str(group).split("/"):
                                    g = g.create_group(name)
                        else:
                            g.create_dataset(leaf, z[key])

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            if self._mode == "w" and exc[0] is None:
                flat, groups = {}, []
                self.visititems(lambda k, o: flat.__setitem__(k, np.asarray(o))
                                if isinstance(o, Dataset) else groups.append(k))
                flat[GROUPS] = np.array(groups, dtype=str)
                with open(self._path, "wb") as f:
                    np.savez(f, **flat)
            return False

    mod.Dataset, mod.Group, mod.File = Dataset, Group, File
    return mod


@contextlib.contextmanager
def stub_module(name: str, module):
    """``module`` in ``sys.modules[name]`` for the block."""
    saved = sys.modules.get(name)
    sys.modules[name] = module
    try:
        yield module
    finally:
        if saved is None:
            del sys.modules[name]
        else:
            sys.modules[name] = saved


def napari_stand_in(script):
    """A stub ``napari``: ``Viewer`` records layers and mouse callbacks;
    ``run()`` calls ``script(tissue_viewer)`` with the ``TissueViewer``
    whose click handler was registered, in place of a user's clicks."""
    import types

    mod = types.ModuleType("napari")

    class LayerList(list):
        def __contains__(self, name):
            return any(layer.name == name for layer in self)

        def remove(self, name):
            for layer in list(self):
                if layer.name == name:
                    super().remove(layer)

    class Layer:
        def __init__(self, data, name, **kwargs):
            self.data, self.name, self.kwargs = data, name, kwargs

    class Viewer:
        made = []

        def __init__(self, title=""):
            self.layers = LayerList()
            self.mouse_drag_callbacks = []
            Viewer.made.append(self)

        def _add(self, data, name=None, **kwargs):
            self.layers.append(Layer(data, name, **kwargs))

        add_image = add_labels = add_points = _add

    def run():
        viewer = Viewer.made[-1]
        script(viewer.mouse_drag_callbacks[0].__self__)

    mod.Viewer, mod.run = Viewer, run
    return mod


class _Click:
    type = "mouse_press"

    def __init__(self, y, x):
        self.position = (float(y), float(x))


def cell_geometry(labels, table, mask):
    """Click positions (x, y) on the largest valid interior cell of a label
    map: the two ends of its median row (a line across it), a pixel of the
    line on its right beside its upper half, and a second cell's centroid."""
    area = np.where(mask, table.area.cpu().numpy(), 0)
    cell = int(area.argmax()) + 1
    ys, xs = np.nonzero(labels == cell)
    mid = int(np.median(ys))
    row, upper = xs[ys == mid], xs[ys == mid - 3]
    other = int(np.argsort(area)[-2])
    centre = (int(round(float(table.cx[other]))), int(round(float(table.cy[other]))))
    return ((int(row.min()), mid), (int(row.max()), mid),
            (int(upper.max()) + 1, mid - 3), centre)


def keras_arrays(state, depth: int) -> dict:
    """The Keras layer arrays (name -> {weight name -> array}) that
    ``models/weights_io.py:keras_arrays_to_state`` maps onto ``state`` (a
    ``UNet(norm="bn")`` state_dict): its inverse, convs, transposed convs
    and BatchNorms in the U-Net's creation order."""
    bn_names = {"gamma": "weight", "beta": "bias",
                "moving_mean": "running_mean", "moving_variance": "running_var"}
    n_blocks = 2 * depth + 1
    convs = [f"blocks.{k}.conv{i}" for k in range(n_blocks) for i in (0, 1)]
    bns = [f"blocks.{k}.bn{i}" for k in range(n_blocks) for i in (0, 1)]

    def name(base, i):
        return base if i == 0 else f"{base}_{i}"

    def arr(key):
        return state[key].detach().float().cpu().numpy()

    layers = {}
    for i, key in enumerate(convs + ["head"]):
        layers[name("conv2d", i)] = {
            "kernel": arr(key + ".weight").transpose(2, 3, 1, 0),
            "bias": arr(key + ".bias")}
    for j in range(depth):
        layers[name("conv2d_transpose", j)] = {
            "kernel": arr(f"ups.{j}.weight").transpose(2, 3, 1, 0),
            "bias": arr(f"ups.{j}.bias")}
    for i, key in enumerate(bns):
        layers[name("batch_normalization", i)] = {
            k: arr(f"{key}.{t}") for k, t in bn_names.items()}
    return layers


def check_cli(card: str, movie, feed, ws_launches: dict, device: str = "cuda",
              unet_depth: int = 3, unet_filters: int = 128, crop: int = 256,
              min_unet_cells: int = 20):
    """The "cli" phase: ``python -m tissue_image_processing_tpu_torch.cli``'s
    ``main`` on the card (``device=None``, the normal entry point), file to
    file, the movie written as a ``.npy`` store under ``build/``:

    1. ``pipeline --capacity 1024 --events`` on the headline raw movie with
       the counters zeroed: every watershed-path kernel launched, as often
       as ``movie_pipeline`` launched it in phase 5 (``ws_launches``); its
       session (labels, tables, ids, drifts, events) equal to one populated
       in memory from the "tissue" phase's ``movie_pipeline`` output
       (``feed``) as ``cmd_pipeline`` populates it, then
       ``find_events_iterator``; ``--chunk 4`` the same (drifts to 1e-4);
    2. ``pipeline --unet --quantize --unet-batch 8`` at ``unet_depth`` /
       ``unet_filters`` (3 / 128) from a Keras ``.h5`` (through
       ``h5py_stand_in`` where h5py is absent) of the seeded random U-Net
       of phase 5 (``utils/synthetic.py:random_unet``; the file read back
       equal), the head bias set so half of the first projected frame
       passes the HC threshold: ``cc_scan`` 8 launches and ``conv3x3_s8`` 14 (one
       forward of the 8 frames), the flood non-trivial, ``--chunk 4``
       equal;
    3. on a Z = 1 store of the movie's projected frames: ``segment`` (labels
       equal to the pipeline's: the same reference frames, the same
       watershed), ``types``, ``track --use-images --fix-types``,
       ``events``, ``export`` in all five formats, ``analyze --feature area
       --out``, ``warmup`` with and without ``--unet --quantize``;
    4. ``view`` against ``napari_stand_in``: an add-line, a remove-line, a
       change-type and a mark-event click on frame 4 and an undo, the saved
       session equal to the same ``SegmentationEditor`` / ``add_event``
       calls on a twin session;
    5. the chain of 3 (and ``pipeline --events`` on that store) on a
       ``crop``^2 corner with ``device="cpu"``: sessions equal to the
       card's, exact but the drifts (one bin of the 100x upsampled phase
       correlation, as in the "tissue" phase);
    6. ``optical_flow_tvl1`` on the first two projected reference frames,
       card vs CPU in the CPU tests' class for a whole frame (|dflow| <=
       5e-3 px on >= 99.9% of the values, mean <= 1e-3 px), ms per frame
       pair by CUDA events beside the device operations it launches and
       their summed device time (``device_profile``); ``track_movie_nearest_pixel(use_flow=True)`` over the T
       frames of ``feed``: the card's ids equal the CPU's.
    Returns the launches of the two pipeline runs. ``device``, the U-Net's
    size, ``crop`` and ``min_unet_cells`` exist for a dry run on the CPU at
    a small size."""
    import io
    import tempfile
    from pathlib import Path

    import torch

    import tissue_image_processing_tpu_torch as tipt
    from tissue_image_processing_tpu_torch import cli
    from tissue_image_processing_tpu_torch.core.editing import (
        SegmentationEditor)
    from tissue_image_processing_tpu_torch.core.events import add_event
    from tissue_image_processing_tpu_torch.core.pipeline import _projections
    from tissue_image_processing_tpu_torch.core.tissue import Tissue
    from tissue_image_processing_tpu_torch.core.tracking import (
        track_movie_nearest_pixel)
    from tissue_image_processing_tpu_torch.models.predictor import (
        SegmentationPredictor, prepare_batch)
    from tissue_image_processing_tpu_torch.ops.optical_flow import (
        optical_flow_tvl1)
    from tissue_image_processing_tpu_torch.models.weights_io import (
        load_keras_unet_weights)
    from tissue_image_processing_tpu_torch.utils.synthetic import (
        head_bias_for_share, random_unet, write_keras_h5)

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run(name, argv, on=None):
        """One ``cli.main`` call; its wall seconds and its printed lines.
        ``on``: None = the phase's device (the card: device=None)."""
        on = on or device
        out = io.StringIO()
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv, device=None if on == "cuda" else on)
        sync()
        secs = time.perf_counter() - t0
        assert rc == 0, (name, rc)
        lines = out.getvalue().strip().splitlines()
        seconds[name if on == device else f"{name} ({on})"] = secs
        return secs, lines

    def contents(path, T, cap, on=None):
        t = Tissue(T, str(Path(path).with_suffix("")), capacity=cap,
                   device=on or device)
        for _ in t.load(path):
            pass
        c = session_contents(t)
        t.clean_up()
        return c

    t_phase = time.perf_counter()
    seconds = {}
    T, C, Z, Y, X = movie.shape
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="smoke_cli_") as d:
        d = Path(d)
        movie_path = str(d / "movie.npy")
        np.save(movie_path, movie)

        # 1. the watershed path, file to file
        ws = str(d / "ws.seg")
        sync()
        tipt.reset_launches()
        secs, lines = run("pipeline", ["pipeline", movie_path, "--session", ws,
                                       "--capacity", "1024", "--events"])
        launches = {k: v for k, v in tipt.LAUNCHES.items() if v}
        if on_card:
            missing = [k for k in WATERSHED_KERNELS + PROJECTION_KERNELS
                       if not launches.get(k)]
            assert not missing, f"cli pipeline launched no {missing}"
            want = {k: v for k, v in ws_launches.items() if v}
            assert launches == want, (launches, want)
        ws_fps = T / secs
        got = contents(ws, T, 1024)
        ref = populate_session(feed, T, str(d / "memory"), device, [], 1024)
        for _ in ref.find_events_iterator(1, T):
            pass
        # load() drops duplicated event rows, as the JAX package's does
        want_c = dict(session_contents(ref), events=sorted_events(
            ref.get_events().drop_duplicates(ignore_index=True)))
        ref.clean_up()
        assert_contents_equal(got, want_c, "cli pipeline vs movie_pipeline")
        n_events = len(got["events"])
        print(f"cli: pipeline {T} x {Y}x{X} Z={Z} file to file {secs:.3f} s, "
              f"{ws_fps:.3f} frames/s ({'; '.join(lines[-3:])}); launches "
              f"{launches}; session == movie_pipeline's in memory (labels, "
              f"tables, ids, drifts, {n_events} events) on {card}")
        chunked = str(d / "ws_chunked.seg")
        _, lines = run("pipeline --chunk 4",
                       ["pipeline", movie_path, "--session", chunked,
                        "--capacity", "1024", "--events", "--chunk", "4"])
        assert lines[0] == f"streaming {T} frames in chunks of 4", lines
        assert_contents_equal(contents(chunked, T, 1024), got,
                              "cli pipeline --chunk 4", drift_atol=1e-4)

        # 2. the int8 U-Net path, file to file, weights from a Keras file
        weights = str(d / "unet.h5")
        real_h5 = importlib.util.find_spec("h5py") is not None
        h5 = importlib.import_module("h5py") if real_h5 else h5py_stand_in()
        with stub_module("h5py", h5):
            state = random_unet(unet_depth, unet_filters, seed=0).state_dict()
            layers = keras_arrays(state, unet_depth)
            write_keras_h5(weights, layers, "keras2")
            back = load_keras_unet_weights(state, weights)
            assert all(torch.equal(back[k], v.float()) for k, v in state.items()
                       if v.is_floating_point()), "Keras file round trip"
            pred = SegmentationPredictor(weights, (2, Y, X), depth=unet_depth,
                                         base_filters=unet_filters,
                                         device=device)
            x, (px, py) = prepare_batch(_projections(movie[:1], 0, dev))
            head = f"conv2d_{4 * unet_depth + 2}"
            delta = head_bias_for_share(pred._forward(x)[0, px:, py:], 0.5)
            layers[head]["bias"][0] += delta
            write_keras_h5(weights, layers, "keras2")
            del pred
            unet_argv = ["pipeline", movie_path, "--capacity", "2048",
                         "--unet", "--quantize", "--unet-batch", "8",
                         "--weights", weights, "--unet-depth", str(unet_depth),
                         "--unet-filters", str(unet_filters)]
            unet = str(d / "unet.seg")
            sync()
            tipt.reset_launches()
            secs, lines = run("pipeline --unet --quantize",
                              unet_argv + ["--session", unet])
            unet_launches = {k: v for k, v in tipt.LAUNCHES.items() if v}
            if on_card:   # 4 launches a component minimum, 2 a flood
                assert unet_launches.get("cc_scan") == 8 * -(-T // 8), \
                    unet_launches
                assert unet_launches.get("conv3x3_s8") == \
                    (4 * unet_depth + 2) * -(-T // 8), unet_launches
                assert "diffusion_bf" not in unet_launches, unet_launches
            unet_fps = T / secs
            got_u = contents(unet, T, 2048)
            cells = [int(lab.max()) for lab in got_u["labels"]]
            assert min(cells) >= min_unet_cells, \
                f"trivial flood: cells/frame {cells}"
            run("pipeline --unet --quantize --chunk 4",
                unet_argv + ["--session", str(d / "unet4.seg"), "--chunk", "4"])
            assert_contents_equal(contents(str(d / "unet4.seg"), T, 2048),
                                  got_u, "cli pipeline --unet --chunk 4",
                                  drift_atol=1e-4)
        print(f"cli: pipeline --unet --quantize (depth {unet_depth}, "
              f"{unet_filters} filters, Keras weights through "
              f"{'h5py' if real_h5 else 'the h5py stand-in'}, head bias "
              f"+ {delta:.6f}) {T} x {Y}x{X} Z={Z} file to file {secs:.3f} s, "
              f"{unet_fps:.3f} frames/s ({lines[-2]}); cells/frame {cells}; "
              f"--chunk 4 equal; launches {unet_launches} on {card}")

        # 3. the per-frame chain on a Z = 1 store of the projected frames
        prj = _projections(movie, 0, dev).cpu().numpy()     # (T, C, Y, X)
        z1 = str(d / "z1.npy")
        np.save(z1, prj[:, :, None])
        chain_s = str(d / "chain.seg")

        def chain(store, session, frames, on=None, out=None, tag=""):
            common = ["--session", session, "--capacity", "1024"]
            run(tag + "segment", ["segment", store, "--session", session,
                                  "--capacity", "1024"], on)
            run(tag + "types", ["types", store, *common, "--channel", "1",
                                "--name", "HC", "--threshold", "0.3"], on)
            run(tag + "track", ["track", store, *common, "--use-images",
                                "--fix-types"], on)
            run(tag + "events", ["events", *common, "--frames", str(frames)],
                on)
            if out is not None:
                for fmt in ("matlab", "tiff", "tiff+types", "npy", "events"):
                    run(f"export {fmt}", ["export", *common, "--frames",
                                          str(frames), str(out / fmt),
                                          "--format", fmt], on)
                run("analyze", ["analyze", *common, "--frames", str(frames),
                                "--feature", "area", "--out",
                                str(out / "area.csv")], on)

        chain(z1, chain_s, T, out=d / "export")
        got_c = contents(chain_s, T, 1024)
        for f in range(T):
            assert np.array_equal(got_c["labels"][f], feed["labels"][f]), \
                f"cli segment frame {f + 1} != the pipeline's labels"
        assert all((t["type"] > 0).any() for t in got_c["tables"]), "no HC typed"
        valid = feed["tables"].valid_mask().numpy()
        pipe_ids = np.where(valid, feed["ids"], 0)
        ids = np.stack([t["label"] for t in got_c["tables"]])
        same = float((ids[valid] == pipe_ids[valid]).mean())
        exports = sorted(p.name for p in (d / "export").rglob("*") if p.is_file())
        assert exports == ["area.csv", "export.csv", "export.mat", "export.npy",
                           "export.tif", "export.tif"], exports
        for argv in (["warmup"], ["warmup", "--unet", "--quantize",
                                  "--unet-depth", str(unet_depth),
                                  "--unet-filters", str(unet_filters)]):
            _, lines = run(" ".join(argv), argv)
            assert lines[-1].startswith("warm cache ready"), lines
            print(f"cli: {' '.join(argv)}: {' | '.join(lines)}")
        print(f"cli: per-frame chain on the Z=1 store: segment labels == the "
              f"pipeline's on all {T} frames; track --use-images ids == the "
              f"pipeline's on {same:.6f} of {int(valid.sum())} cells; "
              f"{len(got_c['events'])} events; exports {exports} on {card}")

        # 4. the viewer, clicks through the napari stand-in
        frame = min(4, T)
        twin = Tissue(T, str(d / "twin"), capacity=1024, device=device)
        for _ in twin.load(chain_s):
            pass
        table = twin.get_cells_info(frame)
        left, right, line, centre = cell_geometry(
            twin.get_labels(frame), table, twin.get_valid_non_edge_mask(frame))
        clicks = []

        def script(tv):
            assert tv.frame == frame
            for mode, points in (("add_line", (left, right)),
                                 ("remove_line", (line,)),
                                 ("change_type", (centre,)),
                                 ("mark_event", (centre,))):
                tv.mode = mode
                for x, y in points:   # napari hands over (y, x)
                    tv.viewer.mouse_drag_callbacks[0](tv.viewer, _Click(y, x))
            clicks.append(tv.undo())
            names = [layer.name for layer in tv.viewer.layers]
            assert names[-1] == "events" and "segmentation" in names, names

        with stub_module("napari", napari_stand_in(script)):
            run("view", ["view", z1, "--session", chain_s, "--capacity", "1024",
                         "--frame", str(frame)])
        ed = SegmentationEditor(twin)
        ed.add_segmentation_line(frame, left, right, initial=True, final=True)
        ed.remove_segmentation_line(frame, line)
        ed.change_cell_type(frame, centre, "HC")
        add_event(twin, "division", frame, frame, start_pos=centre,
                  end_pos=centre)
        assert clicks == [ed.undo_last_action(frame)], clicks
        viewed = contents(chain_s, T, 1024)
        assert_contents_equal(viewed, dict(
            session_contents(twin), events=sorted_events(
                twin.get_events().drop_duplicates(ignore_index=True))),
            "cli view")
        twin.clean_up()
        assert (viewed["events"].type == "division").sum() >= 1
        print(f"cli: view (napari stand-in): add-line {left}->{right}, "
              f"remove-line {line}, change-type and mark-event at {centre}, "
              f"undo on frame {frame}: session == SegmentationEditor / "
              f"add_event on a twin on {card}")

        # 5. card vs CPU on a crop of the Z = 1 store
        crop_path = str(d / "crop.npy")
        np.save(crop_path, np.ascontiguousarray(prj[:, :, None, :crop, :crop]))
        for on in (device, "cpu"):
            chain(crop_path, str(d / f"crop_{on}.seg"), T, on, tag="crop ")
            run("crop pipeline", ["pipeline", crop_path, "--session",
                             str(d / f"crop_pipe_{on}.seg"), "--capacity",
                             "1024", "--events"], on)
        drift_err = 0.0
        for name in ("crop", "crop_pipe"):
            a = contents(str(d / f"{name}_{device}.seg"), T, 1024)
            b = contents(str(d / f"{name}_cpu.seg"), T, 1024, "cpu")
            assert_contents_equal(a, b, f"cli {name}: card vs CPU",
                                  drift_atol=0.01 + 1e-5)
            drift_err = max(drift_err, float(np.abs(a["drifts"]
                                                    - b["drifts"]).max()))
        print(f"cli: card == CPU on a {crop}^2 crop ({T} frames): the chain's "
              f"and pipeline's sessions exact, drifts within {drift_err:.6g} px "
              f"on {card}")

    # 6. TV-L1 and the flow tracker
    ref0, ref1 = (torch.from_numpy(prj[i, 0]).to(dev) for i in (0, 1))
    flow = optical_flow_tvl1(ref0, ref1, device=device)
    timer = cuda_ms if on_card else host_ms
    flow_ms = timer(lambda: optical_flow_tvl1(ref0, ref1, device=device), 3)
    # launch-bound or not: the card's busy time within a pair's wall time
    flow_ops, flow_busy = (device_profile(
        lambda: optical_flow_tvl1(ref0, ref1, device=device))
        if on_card else (0, 0.0))
    flow_cpu = optical_flow_tvl1(ref0.cpu(), ref1.cpu(), device="cpu")
    # the CPU tests' class for a whole frame: a few values cross the
    # solver's pointwise threshold on one side and not the other
    dflow = (flow.cpu() - flow_cpu).abs()
    flow_err = float(dflow.max())
    flow_far = int((dflow > 5e-3).sum())
    assert flow_far <= 1e-3 * dflow.numel(), flow_far
    assert float(dflow.mean()) <= 1e-3, float(dflow.mean())
    host = feed["tables"]
    images = np.ascontiguousarray(prj[:, 0].transpose(0, 2, 1))   # x-major
    track_args = (feed["labels"], host.cy.numpy(), host.cx.numpy(),
                  host.valid_mask().numpy())
    sync()
    t0 = time.perf_counter()
    flow_ids = track_movie_nearest_pixel(*track_args, images=images,
                                         use_flow=True, device=device)
    track_s = time.perf_counter() - t0
    cpu_ids = track_movie_nearest_pixel(*track_args, images=images,
                                        use_flow=True, device="cpu")
    assert np.array_equal(flow_ids, cpu_ids), "flow tracker: card != CPU"
    kept = np.intersect1d(flow_ids[0][flow_ids[0] > 0],
                          flow_ids[-1][flow_ids[-1] > 0]).size
    print(f"cli: optical_flow_tvl1 {Y}x{X} {flow_ms:.3f} ms per frame pair "
          f"(CUDA events, 3 calls; {flow_ops} device operations a pair, the "
          f"card busy {flow_busy:.3f} ms of them), card vs CPU |dflow| > 5e-3 px on "
          f"{flow_far} of {dflow.numel()} values, mean {float(dflow.mean()):.3g}, "
          f"max {flow_err:.3g} px; "
          f"track_movie_nearest_pixel(use_flow=True) {T} frames {track_s:.3f} "
          f"s, ids == CPU's, {kept} of {int((flow_ids[0] > 0).sum())} frame-1 "
          f"ids reach frame {T} on {card}")
    print("cli: seconds per subcommand " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()) + f" on {card}")
    print(f"cli: phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, unet_launches


# --- phase 10: parallel/ on the card ------------------------------------------

# blur3d's shapes on the space shards of a (30, side, side) frame: the
# halo-extended blocks of the pre-blur (4 px), the score blur's z pass
# (120 px; its y / x passes are band matrices) and the mask blur (8 px)
def shard_blurs(Z: int, side: int, y_shards: int, x_shards: int) -> dict:
    Yl, Xl = side // y_shards, side // x_shards
    ext = lambda h: (Z, Yl + 2 * h, Xl + 2 * h if x_shards > 1 else Xl)
    tag = f"{y_shards}x{x_shards}"
    return {f"pre_blur_{tag}": (*ext(4), 5, 9, 9),
            f"score_blur_{tag}": (*ext(120), 5, 1, 1),
            f"mask_blur_{tag}": (*ext(8), 9, 17, 17)}


@contextlib.contextmanager
def count_syncs(counts: dict, sites: collections.Counter, key: str, targets,
                mode: str = "error", seconds: Optional[list] = None):
    """While open, each call of a function in ``targets`` ((module, name)
    pairs: the shard bodies of a path) runs under
    ``torch.cuda.set_sync_debug_mode(mode)``:

    - ``"error"``: a host synchronisation raises inside the body and fails
      the run (``counts[key]`` stays 0);
    - ``"warn"``: the synchronisation warnings are added to ``counts[key]``
      and, by the source line that raised each, to ``sites``.

    With ``seconds``, each call appends (function name, its stream's
    handle, host-clock seconds): the seconds the host took to queue the
    body, since a body that does not synchronise returns before its device
    work ends."""
    import os
    import warnings

    import torch

    counts.setdefault(key, 0)
    origs = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def erroring(name, fn):
        def guarded(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            handle = torch.cuda.current_stream(
                torch.cuda.current_device()).cuda_stream
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if seconds is not None:
                    seconds.append((name, handle, time.perf_counter() - t0))
                torch.cuda.set_sync_debug_mode("default")
        return guarded

    def counting(name, fn):
        def counted(*args, **kwargs):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    syncs = [w for w in seen if "synchroniz" in str(w.message)]
                    counts[key] += len(syncs)
                    sites.update(f"{os.path.relpath(w.filename)}:{w.lineno}"
                                 for w in syncs)
        return counted

    wrap = erroring if mode == "error" else counting
    for mod, name, fn in origs:
        setattr(mod, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in origs:
            setattr(mod, name, fn)


def synced_seconds(fn, dev):
    """(result, host-clock seconds) of ``fn()``, every visible card
    synchronised before and after."""
    import torch

    def sync():
        if dev.type == "cuda":
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def same(a, b) -> bool:
    """Bit-for-bit equality of tensors, arrays, or tuples and lists of
    them."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.device == b.device and bool(torch.equal(a, b)))
    return np.array_equal(a, b)


def handwritten_kernels() -> list:
    """The ``__global__`` functions of the port's CUDA sources, longest
    name first."""
    names = set()
    for src in (Path(__file__).resolve().parent / "tissue_image_processing_tpu_torch"
                / "csrc").glob("*.cu"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            src.read_text()))
    return sorted(names, key=len, reverse=True)


def stream_activity(path: str, kernels) -> dict:
    """Device activity by stream in the profiler's Chrome trace at
    ``path``: {stream id: {"intervals": [(start us, end us)] of its
    kernels, copies and fills, "kernels": Counter of the hand-written
    kernels (``kernels``: their names) it ran, "runs": their (name, start
    us, end us)}}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    streams = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset") \
                or "dur" not in e:
            continue
        s = streams.setdefault(e["args"]["stream"], {
            "intervals": [], "kernels": collections.Counter(), "runs": []})
        s["intervals"].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        name = next((k for k in kernels
                     if re.search(rf"\b{k}\b", e["name"])), None)
        if e["cat"] == "kernel" and name is not None:
            s["kernels"][name] += 1
            s["runs"].append((name, *s["intervals"][-1]))
    return streams


def merged_us(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_and_overlap_ms(streams) -> tuple:
    """(ms in which some stream of ``streams`` was active, ms in which two
    or more were) over a trace's streams."""
    edges = sorted((t, d) for s in streams.values()
                   for a, b in merged_us(s["intervals"])
                   for t, d in ((a, 1), (b, -1)))
    busy = over = 0.0
    active, last = 0, None
    for t, d in edges:
        if last is not None:
            busy += (t - last) if active >= 1 else 0.0
            over += (t - last) if active >= 2 else 0.0
        active, last = active + d, t
    return busy / 1e3, over / 1e3


def concurrent_runs(streams, names) -> int:
    """Pairs of kernels of ``names`` on two different streams that ran at
    once (overlapping intervals)."""
    runs = sorted((a, b, sid) for sid, s in streams.items()
                  for n, a, b in s["runs"] if n in names)
    pairs = 0
    for i, (a, b, sid) in enumerate(runs):
        for a2, _, sid2 in runs[i + 1:]:
            if a2 >= b:
                break
            pairs += sid2 != sid
    return pairs


def unsharded_chain(movie, frame_fn, capacity: int, dev):
    """``tests/test_parallel.py:60-74`` in the port: the per-frame chain on
    ``dev``, ``compute_drift_chain`` and ``track_movie``."""
    import torch

    from tissue_image_processing_tpu_torch.core.tracking import (
        compute_drift_chain, track_movie)

    outs = [frame_fn(torch.from_numpy(np.ascontiguousarray(s)).to(dev))
            for s in movie]
    refs, cy, cx, area, mask = (torch.stack(o) for o in zip(*outs))
    return track_movie(cy, cx, area, mask, drifts=compute_drift_chain(refs),
                       capacity=2 * capacity)


@dataclasses.dataclass
class ParallelRun:
    """What the "parallel" phase's steps share: the card's line, the
    device, the virtual mesh's devices, the host synchronisations counted
    by path, the launches by path, the shard bodies' host seconds by path
    and the streams-form mesh of each path run in its two forms."""
    card: str
    dev: "object"
    shards: int
    syncs: dict = dataclasses.field(default_factory=dict)
    sync_sites: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    launches: dict = dataclasses.field(default_factory=dict)
    blur_forms: dict = dataclasses.field(default_factory=dict)
    body_seconds: dict = dataclasses.field(default_factory=dict)
    meshes: dict = dataclasses.field(default_factory=dict)

    @property
    def on_card(self) -> bool:
        return self.dev.type == "cuda"

    @property
    def devs(self) -> list:
        return [self.dev] * self.shards

    def run(self, name: str, fn, targets, mode: str = "error"):
        """(result, seconds) of ``fn()`` with the counters zeroed before and
        read after into ``launches[name]``, the path's shard bodies
        (``targets``) under ``set_sync_debug_mode(mode)`` (see
        :func:`count_syncs`) and timed into ``body_seconds[name]``."""
        import tissue_image_processing_tpu_torch as tipt

        tipt.reset_launches()
        seconds = self.body_seconds.setdefault(name, [])
        with count_syncs(self.syncs, self.sync_sites, name,
                         targets if self.on_card else [], mode, seconds):
            out, secs = synced_seconds(fn, self.dev)
        self.launches[name] = {k: v for k, v in tipt.LAUNCHES.items() if v}
        self.blur_forms[name] = {k: v for k, v in
                                 tipt._device.BLUR_FORMS.items() if v}
        return out, secs

    def forms(self, name: str, mesh, build, call, targets):
        """``call(build(m))`` for ``m`` = ``mesh`` in each of its forms:
        serial (the caller's stream) and streams (a stream a position).
        Each is warmed by one call, then both run by :meth:`run` in turns
        (serial, streams, streams, serial, serial, streams) as
        ``name_serial`` and ``name``. Every result must equal the first
        streams run's bit for bit, and every run's launches its launches.
        Returns (the streams form's result, its function, {form: [seconds
        of its three runs]})."""
        forms = ("serial", "streams")
        fns = {}
        for form in forms:
            m = dataclasses.replace(mesh, _form=form)
            fns[form] = build(m)
            call(fns[form])   # warm: libraries, streams, plans, allocator
            if form == "streams":
                self.meshes[name] = m
        runs = []
        for form in forms + forms[::-1] + forms:
            key = name if form == "streams" else f"{name}_{form}"
            out, secs = self.run(key, lambda: call(fns[form]), targets)
            runs.append((form, out, secs, self.launches[key],
                         self.blur_forms[key]))
        _, want, _, launches, blur_forms = runs[1]
        for form, out, _, got, got_forms in runs:
            assert same(out, want), \
                f"{name}: the {form} form differs from the streams form"
            assert (got, got_forms) == (launches, blur_forms), (name, form)
        self.launches[name], self.blur_forms[name] = launches, blur_forms
        del self.launches[f"{name}_serial"], self.blur_forms[f"{name}_serial"]
        secs = {form: [s for f, _, s, _, _ in runs if f == form]
                for form in forms}
        return want, fns["streams"], secs


def forms_line(T: int, secs: dict) -> str:
    """Frames/s of each form's runs, in the order they ran."""
    return ", ".join(f"{form} " + " / ".join(f"{T / s:.3f}" for s in runs)
                     + " frames/s (" + " / ".join(f"{s:.3f}" for s in runs)
                     + " s)" for form, runs in secs.items())


def trace_positions(par: ParallelRun, name: str, fn) -> None:
    """One run of ``fn`` (the streams form of path ``name``) under the
    profiler: the hand-written kernels ran on ``shards`` streams, none
    elsewhere, each stream carrying one shard's launches (the same count of
    each kernel) and all of them the path's launches; prints the device
    ms on those streams that overlap, the busy share of the traced wall,
    the host seconds to queue each position's body (the untraced streams
    run, by position) against each position stream's device seconds (the
    trace names streams by its own ids, so the two lists are not paired),
    and whether two cooperative kernels ever ran at once on two streams."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build, prefix="smoke_trace_") as d:
        path = str(Path(d) / "trace.json")
        _, _, wall_ms, _ = device_profile(fn, rows=True, trace=path)
        # the tracker's auction runs on the lead device's stream after the
        # shards join, once a frame: not a shard body's kernel
        streams = stream_activity(path, [k for k in handwritten_kernels()
                                         if k != "auction_kernel"])
    carrying = {s: v for s, v in streams.items() if v["kernels"]}
    counts = [dict(v["kernels"]) for v in carrying.values()]
    assert len(carrying) == par.shards, \
        f"hand-written kernels on {len(carrying)} streams: {counts}"
    assert all(c == counts[0] for c in counts), counts
    launched = sum(v for k, v in par.launches[name].items() if k != "auction")
    assert sum(sum(c.values()) for c in counts) == launched, (counts, launched)
    busy, overlapped = busy_and_overlap_ms(streams)
    on_positions = busy_and_overlap_ms(carrying)
    mesh = par.meshes[name]
    position_of = {st.cuda_stream: pos for pos, st in mesh._streams.items()}
    host = {position_of[h]: s for body, h, s in par.body_seconds[name]
            if body == "_shard_frames"}
    device = {sid: sum(b - a for a, b in merged_us(v["intervals"])) / 1e6
              for sid, v in sorted(carrying.items())}
    # cooperative launches fill the card: do two on two streams run at once?
    coop = concurrent_runs(carrying, ("diffusion_kernel", "settle_kernel"))
    print(f"parallel: traced {name} run (streams form, {par.shards} "
          f"positions): hand-written kernels on {len(carrying)} position "
          f"streams, {counts[0]} each, none on another stream; device busy "
          f"{busy:.3f} ms of {wall_ms:.3f} ms traced wall ({busy / wall_ms:.3f} "
          f"share), overlapped (two or more streams at once) {overlapped:.3f} "
          f"ms, on the position streams {on_positions[1]:.3f} ms overlapped "
          f"of {on_positions[0]:.3f} ms busy; host seconds to queue a shard "
          f"body (untraced run) by position "
          f"{ {p: round(s, 4) for p, s in sorted(host.items())} }, device "
          f"seconds by position stream (trace ids) "
          f"{ {k: round(v, 4) for k, v in device.items()} }: host / device "
          f"{min(host.values()) / max(device.values()):.2f}x at least; "
          f"cooperative kernels (diffusion, settle) on two streams at once: "
          f"{coop} pairs; the trace step {time.perf_counter() - t0:.1f} s; "
          f"on {par.card}")


def parallel_frames(par: ParallelRun, movie, unet_depth: int,
                    unet_filters: int, capacity: int, block_size: int,
                    min_cells: int, min_unet_cells: int) -> None:
    """Steps 1-3 of the "parallel" phase: the frame-sharded watershed, its
    chunked form from a ``MovieStore`` and the frame-sharded U-Net, each in
    its two forms (serial, streams: bit for bit equal) against
    the unsharded chain on the same device; then both pipelines on a mesh
    of every visible card where there are two or more."""
    import os

    import torch

    from tissue_image_processing_tpu_torch.core.cell_table import frame_cellinfo
    from tissue_image_processing_tpu_torch.io.movie import MovieStore
    from tissue_image_processing_tpu_torch.models.predictor import (
        find_desired_shape, unet_postprocess)
    from tissue_image_processing_tpu_torch.ops.brightness import (
        normalize_channel)
    from tissue_image_processing_tpu_torch.ops.watershed import (
        watershed_segmentation)
    from tissue_image_processing_tpu_torch.parallel import pipeline as ppipe
    from tissue_image_processing_tpu_torch.projection.surface import (
        time_point_surface_projection)

    dev, shards, card = par.dev, par.shards, par.card
    T, _, Z, H, W = movie.shape
    bodies = [(ppipe, "_shard_frames"), (ppipe, "_shifts")]
    marks = [("start", time.perf_counter())]

    # 1. the frame-sharded watershed, in its two forms
    kw = dict(capacity=capacity, block_size=block_size)
    fmesh = ppipe.make_frame_mesh(shards, devices=par.devs)
    ids, pipe, secs = par.forms(
        "watershed", fmesh, lambda m: ppipe.sharded_movie_pipeline(m, **kw),
        lambda p: p(movie), bodies)
    if par.on_card:
        got = par.launches["watershed"]
        missing = [k for k in WATERSHED_KERNELS if not got.get(k)]
        assert not missing, f"kernels not launched by the sharded path: {missing}"
        assert not any(got.get(k) for k in PROJECTION_KERNELS), got
        # the unfused projection's three blurs and the watershed pre-blur,
        # once a frame each; the flood's five launches a frame
        blur_launches({(Z, H, W, 5, 9, 9): T, (Z, H // 4, W // 4, 5, 1, 1): T,
                       (Z, H, W, 9, 17, 17): T, (1, H, W, 1, 25, 25): T})
        assert par.blur_forms["watershed"] == {
            "walk": 2 * T, "z_only": T, "tile25": T}, par.blur_forms
        assert got["diffusion_bf"] == T and got["settle"] == T, got

    def ws_frame(stack):
        proj, _ = time_point_surface_projection(stack.to(torch.float32),
                                                airyscan=False)
        labels = watershed_segmentation(proj[0], 0.2, 3.0, block_size)
        table = frame_cellinfo(labels, capacity=capacity)
        return proj[0], table.cy, table.cx, table.area, table.valid_mask()

    want, secs1 = synced_seconds(
        lambda: unsharded_chain(movie, ws_frame, capacity, dev), dev)
    assert ids.device.type == dev.type and tuple(ids.shape) == (T, capacity)
    assert torch.equal(ids, want), "sharded watershed ids differ from the chain"
    assert int((ids > 0).sum(1).min()) > min_cells, "too few tracked cells"
    print(f"parallel: sharded_movie_pipeline {T} x {H}^2 Z={Z} over "
          f"{shards} frame shards: ids of the serial and streams "
          f"forms equal bit for bit and equal to the unsharded chain; "
          f"{forms_line(T, secs)}; {T / secs1:.3f} frames/s unsharded chain "
          f"({secs1:.3f} s); same host clock, synchronised, on {card}; "
          f"launches {par.launches['watershed']}")
    marks.append(("watershed", time.perf_counter()))
    if par.on_card:
        trace_positions(par, "watershed", lambda: pipe(movie))
    marks.append(("trace", time.perf_counter()))

    # 2. chunked, from a MovieStore under build/, concurrent and serial
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    serial = dataclasses.replace(fmesh, _form="serial")
    with tempfile.TemporaryDirectory(dir=build, prefix="smoke_parallel_") as d:
        path = os.path.join(d, "movie.npy")
        store = MovieStore.create(path, movie.shape, movie.dtype)
        for t in range(T):
            store.write_frame(t, movie[t])
        store.data.flush()
        del store
        store = MovieStore.open(path)
        seen = []
        got, _ = par.run("chunked", lambda: ppipe.sharded_movie_pipeline_chunked(
            fmesh, store, chunk_frames=shards, on_chunk=lambda t0, i: seen.append(
                (t0, i.shape[0])), **kw), bodies)
        assert np.array_equal(got, ids.cpu().numpy()), "chunked ids differ"
        assert seen == [(t, shards) for t in range(0, T, shards)], seen
        assert np.array_equal(ppipe.sharded_movie_pipeline_chunked(
            serial, store, chunk_frames=shards, **kw), got), \
            "chunked ids: the serial form differs"
        cut = MovieStore(np.asarray(store.data[:T - 2]))
        seen = []
        got = ppipe.sharded_movie_pipeline_chunked(
            fmesh, cut, chunk_frames=shards, on_chunk=lambda t0, i: seen.append(
                (t0, i.shape[0])), **kw)
        assert np.array_equal(got, ids.cpu().numpy()[:T - 2]), \
            "chunked ids with a padded tail differ"
        assert seen == [(t0, min(shards, T - 2 - t0))
                        for t0 in range(0, T - 2, shards)], seen
        del store, cut
    marks.append(("chunked", time.perf_counter()))
    print(f"parallel: sharded_movie_pipeline_chunked from a MovieStore: chunk "
          f"{shards} == unchunked, streams form == serial form; chunk "
          f"{shards} on a T={T - 2} cut (padded tail) == the first {T - 2} "
          f"frames; on_chunk saw {seen}")

    # 3. the frame-sharded U-Net, in its two forms
    model, cfg, share = unet_model(movie, dev, unet_depth, unet_filters)
    uids, _, usecs = par.forms(
        "unet", fmesh,
        lambda m: ppipe.sharded_unet_pipeline(m, model, capacity=capacity),
        lambda p: p(cfg["params"], movie), bodies)

    def unet_frame(stack):
        proj, _ = time_point_surface_projection(stack.to(torch.float32),
                                                airyscan=False)
        x = torch.stack([normalize_channel(c) for c in proj]).permute(2, 1, 0)
        px, py = find_desired_shape(W, H)
        x = torch.nn.functional.pad(x, (0, 0, py - H, 0, px - W, 0))
        with torch.no_grad():
            pred = model(x[None])[0][px - W:, py - H:]
        labels, _ = unet_postprocess(pred.to(torch.float32))
        table = frame_cellinfo(labels.T.contiguous(), capacity=capacity)
        return proj[0], table.cy, table.cx, table.area, table.valid_mask()

    uwant, usecs1 = synced_seconds(
        lambda: unsharded_chain(movie, unet_frame, capacity, dev), dev)
    assert torch.equal(uids, uwant), "sharded U-Net ids differ from the chain"
    assert int((uids > 0).sum(1).min()) > min_unet_cells, \
        "too few tracked U-Net cells"
    if par.on_card:
        assert par.launches["unet"].get("cc_scan"), par.launches["unet"]
        assert not par.launches["unet"].get("diffusion_bf"), par.launches["unet"]
    print(f"parallel: sharded_unet_pipeline depth {unet_depth}, "
          f"{unet_filters} filters, bfloat16 (p0 > 0.1 on {share:.3f} of frame "
          f"0) over {shards} frame shards: ids of the two forms equal bit "
          f"for bit and equal to the unsharded chain; {forms_line(T, usecs)}; "
          f"{T / usecs1:.3f} frames/s unsharded ({usecs1:.3f} s), on {card}; "
          f"launches {par.launches['unet']}")

    marks.append(("unet", time.perf_counter()))

    # 4. every visible card, where there are two or more
    parallel_cards(par, movie, kw, ids, model, cfg["params"], uids)
    marks.append(("cards", time.perf_counter()))
    print("parallel: steps 1-4 seconds: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.1f}" for a, b in zip(marks, marks[1:])))


def unet_model(movie, dev, depth: int, filters: int):
    """(model, config, share): a bfloat16 U-Net with seeded random weights
    on ``dev`` (``random_unet_config`` on the movie's first frame)."""
    import torch

    from tissue_image_processing_tpu_torch.models.unet import UNet

    cfg, share = random_unet_config(movie[0], depth=depth,
                                    base_filters=filters, batch=8,
                                    device=dev.type)
    with torch.device(dev):
        model = UNet(depth=depth, base_filters=filters, dtype=torch.bfloat16,
                     norm=cfg["norm"])
    model.load_state_dict(cfg["params"])
    model.eval().requires_grad_(False)
    return model, cfg, share


def parallel_cards(par: ParallelRun, movie, kw: dict, ids, model, params,
                   uids) -> None:
    """The frame-sharded watershed (``kw``: its capacity and block size)
    and U-Net (``model`` with ``params``) on a mesh of every visible card,
    in both forms (:meth:`ParallelRun.forms`), their ids equal to ``ids``
    / ``uids`` of the one-card virtual mesh and their launches equal;
    where fewer than two cards are visible, one line saying so."""
    import torch

    from tissue_image_processing_tpu_torch.parallel import pipeline as ppipe

    T = movie.shape[0]
    cards = torch.cuda.device_count() if par.on_card else 0
    if cards < 2:
        print(f"parallel: the watershed and U-Net pipelines on a mesh of "
              f"every visible card were not run: {cards} card(s) visible")
        return
    n = max(c for c in range(1, cards + 1) if T % c == 0)
    cmesh = ppipe.make_frame_mesh(n, devices=[torch.device("cuda", i)
                                              for i in range(n)])
    bodies = [(ppipe, "_shard_frames"), (ppipe, "_shifts")]
    for path, want_ids, build, args in (
            ("watershed", ids,
             lambda m: ppipe.sharded_movie_pipeline(m, **kw), (movie,)),
            ("unet", uids, lambda m: ppipe.sharded_unet_pipeline(
                m, model, capacity=kw["capacity"]), (params, movie))):
        got, _, csecs = par.forms(f"{path}_cards", cmesh, build,
                                  lambda p: p(*args), bodies)
        assert same(got, want_ids), f"{path}: ids on {n} cards differ"
        assert par.launches[f"{path}_cards"] == par.launches[path], \
            (par.launches[f"{path}_cards"], par.launches[path])
        print(f"parallel: {path} on a mesh of {n} cards ({cards} visible): "
              f"ids of both forms equal to the one-card run, launches "
              f"equal; {forms_line(T, csecs)} on {par.card}")


def check_cards(card: str, movie, shards: int = 4, capacity: int = 1024,
                block_size: int = 101, unet_depth: int = 3,
                unet_filters: int = 128, train_filters: int = 128,
                train_batch: int = 32, train_side: int = 256) -> None:
    """The frame-sharded watershed and U-Net on a virtual mesh of
    ``shards`` positions on card 0 (both forms, shard bodies under
    ``set_sync_debug_mode("error")``), then on a mesh of every visible card
    against them (:func:`parallel_cards`); then the training step over
    (data 2 x model 2) of four cards against four positions of card 0
    (:func:`train_cards`): the multi-card parts of the "parallel" phase
    and what they are compared with, alone, for a machine with several
    cards."""
    import torch

    from tissue_image_processing_tpu_torch.parallel import pipeline as ppipe

    par = ParallelRun(card, torch.device("cuda"), shards)
    kw = dict(capacity=capacity, block_size=block_size)
    fmesh = ppipe.make_frame_mesh(shards, devices=par.devs)
    bodies = [(ppipe, "_shard_frames"), (ppipe, "_shifts")]
    model, cfg, _ = unet_model(movie, par.dev, unet_depth, unet_filters)
    got = {}
    for path, build, args in (
            ("watershed", lambda m: ppipe.sharded_movie_pipeline(m, **kw),
             (movie,)),
            ("unet", lambda m: ppipe.sharded_unet_pipeline(
                m, model, capacity=capacity), (cfg["params"], movie))):
        got[path], _, secs = par.forms(path, fmesh, build,
                                       lambda p: p(*args), bodies)
        print(f"parallel: {path} over {shards} positions of card 0: "
              f"{forms_line(movie.shape[0], secs)} on {card}")
    parallel_cards(par, movie, kw, got["watershed"], model, cfg["params"],
                   got["unet"])
    del model, cfg
    train_cards(par, train_filters, train_batch, train_side)
    print(f"parallel: host synchronisations by path (a sync fails the run): "
          f"{par.syncs}")


def parallel_space(par: ParallelRun, movie) -> dict:
    """Step 4 of the "parallel" phase: ``sharded_projection`` of two frames
    tiled 2 x 2 over (frame, y, x) = (1, 2, 2) and (2, 2, 1) in its two
    forms (bit for bit equal) against the unsharded precise projection,
    and ``blur3d`` at every shard shape on its input. Returns the blur rows
    by name (on the card)."""
    import torch

    from tissue_image_processing_tpu_torch.ops.filters import gaussian_blur
    from tissue_image_processing_tpu_torch.ops.percentile import (
        masked_percentile)
    from tissue_image_processing_tpu_torch.parallel import mesh as pmesh
    from tissue_image_processing_tpu_torch.parallel import spatial as pspat
    from tissue_image_processing_tpu_torch.projection.surface import (
        time_point_surface_projection)

    dev, shards, card = par.dev, par.shards, par.card
    Z = movie.shape[2]
    big = np.stack([np.tile(movie[t], (1, 1, 2, 2)) for t in range(2)])
    side = big.shape[-1]
    shapes = {}
    for y_sh, x_sh in ((2, 2), (2, 1)):
        shapes.update(shard_blurs(Z, side, y_sh, x_sh))
    want_p, want_z, scores, clips, secs1 = [], [], [], [], 0.0
    def upload_and_project(frame):
        stack = torch.from_numpy(frame).to(dev)
        return stack, time_point_surface_projection(stack, airyscan=False,
                                                    precise=True)

    for t in range(2):   # timed with its upload, as the sharded runs are
        (stack, (p, z)), s1 = synced_seconds(
            lambda: upload_and_project(big[t]), dev)
        secs1 += s1
        ref = stack[0].to(torch.float32)
        clip = masked_percentile(ref, ref > 0, 95.0)
        ref = torch.where((ref > clip) & (clip > 0), clip, ref)
        score = gaussian_blur(gaussian_blur(ref, (0.5, 1.0, 1.0)),
                              (0.5, 30.0, 30.0))
        top = torch.topk(score, 2, dim=0).values
        scores.append(((top[0] - top[1]) > 1e-5 * top[0].abs()).cpu())
        want_p.append(p.cpu())
        want_z.append(z.cpu())
        clips.append(float(clip))
        del stack, ref, score, top
    print(f"parallel: unsharded precise projection of 2 frames of (2, {Z}, "
          f"{side}, {side}): {secs1:.3f} s, upload included, on {card}")
    captured_all, shard_launches = {}, {}
    for f_sh, y_sh, x_sh in ((1, 2, 2), (2, 2, 1)):
        smesh = pspat.make_space_mesh(shards, frame_shards=f_sh,
                                      x_shards=x_sh, devices=par.devs)
        tag = f"{y_sh}x{x_sh}"
        want_shapes = {v for k, v in shapes.items() if k.endswith(tag)}
        with capture_blur_inputs(want_shapes) as captured:
            # the blur inputs at the shard shapes
            pspat.sharded_projection(smesh, airyscan=False)(big)
        captured_all.update(captured)
        (p, z), _, ssecs = par.forms(
            f"spatial_{tag}", smesh,
            lambda m: pspat.sharded_projection(m, airyscan=False),
            lambda fn: fn(big), [(pspat, "_project_block")])
        # one launch at each shape a frame and space shard
        shard_launches.update({s: 2 * y_sh * x_sh for s in want_shapes})
        if par.on_card:
            blur_launches({s: shard_launches[s] for s in want_shapes})
            assert par.blur_forms[f"spatial_{tag}"] == {
                "walk": 4 * y_sh * x_sh, "z_only": 2 * y_sh * x_sh}, \
                par.blur_forms
        grid_shape = smesh.devices.shape[1:]
        for t in range(2):
            ref = torch.from_numpy(big[t, 0]).to(dev).to(torch.float32)
            grid = pmesh._object_array(
                [c for r in torch.chunk(ref, y_sh, 1)
                 for c in torch.chunk(r, x_sh, 2)], grid_shape)
            clip = pspat.clip_percentile_sharded(
                grid, pmesh._object_array([g > 0 for g in grid.flat],
                                          grid_shape), 95.0)
            assert all(float(c) == clips[t] for c in clip.flat), \
                f"sharded clip value {float(clip[0, 0])} != {clips[t]}"
            del ref, grid
            gz, gp = z[t].cpu(), p[t].cpu()
            differ = gz != want_z[t]
            assert not bool((differ & scores[t]).any()), \
                f"z-map differs where the score's top two planes are apart ({tag})"
            # a plane chosen otherwise at a tie moves the one-hot mask blur
            # (taps 9 x 17 x 17) within 8 px of it, and the projection there;
            # everywhere else the projection is held to the JAX class
            reach = torch.nn.functional.max_pool2d(
                differ[None, None].float(), 17, 1, 8)[0, 0] > 0
            off = (gp - want_p[t]).abs() > 2e-3 + 2e-4 * want_p[t].abs()
            torch.testing.assert_close(gp[:, ~reach], want_p[t][:, ~reach],
                                       rtol=2e-4, atol=2e-3)
            print(f"parallel: sharded_projection (frame, y, x) = ({f_sh}, "
                  f"{y_sh}, {x_sh}) frame {t}: clip {clips[t]} equal, z-map "
                  f"differs on {int(differ.sum())} of {differ.numel()} pixels, "
                  f"each where the unsharded score's top two planes are within "
                  f"1e-5 relative ({int((~scores[t]).sum())} such pixels); "
                  f"projection within rtol 2e-4 / atol 2e-3 on the "
                  f"{int((~reach).sum())} pixels farther than 8 px from them "
                  f"(max_abs_err {max_abs_err(gp[:, ~reach], want_p[t][:, ~reach]):.3g}),"
                  f" {int(off.any(0).sum())} pixels outside the class within "
                  f"their reach (max_abs_err {max_abs_err(gp, want_p[t]):.3g})")
        print(f"parallel: sharded_projection over ({f_sh}, {y_sh}, {x_sh}): "
              f"projections and z-maps of the serial and streams "
              f"forms equal bit for bit; for 2 frames of {side}^2, upload "
              f"included: "
              + ", ".join(f"{form} " + " / ".join(f"{s:.3f}" for s in runs)
                          + " s" for form, runs in ssecs.items())
              + f", on {card}; launches {par.launches[f'spatial_{tag}']}")
        del p, z
    del big
    rows = {}
    if par.on_card:
        for name, shape in shapes.items():
            x, kz, ky, kx = captured_all.pop(shape)
            rows[name] = dict(check_driver_blur(f"shard_{name}", x, kz, ky,
                                                kx, card),
                              launches=shard_launches[shape])
            del x
    return rows


@dataclasses.dataclass
class TrainCase:
    """The training cell's batch (``batch`` crops of ``side``^2 from
    ``utils/synthetic.py:training_frames``, the reference recipe's crop
    generator) and the one-step helpers of step 5 of the "parallel" phase
    and of ``check_cards``: a fresh depth-2 U-Net and Adam from seed 0 on
    ``dev``, one step sharded over a (data 2 x model 2) mesh or unsharded,
    and the CPU tests' tolerances."""
    dev: "object"
    filters: int
    batch: int
    side: int
    lr: float = 1e-5

    def __post_init__(self):
        from tissue_image_processing_tpu_torch.models import train
        from tissue_image_processing_tpu_torch.utils.synthetic import (
            training_frames)

        images, labels = training_frames(2, 2 * self.side, 2 * self.side,
                                         seed=3)
        self.bx, self.by = next(train.crop_generator(
            images, labels, self.batch, self.side, seed=0))

    def fresh(self, dtype):
        import torch

        from tissue_image_processing_tpu_torch.models import train
        from tissue_image_processing_tpu_torch.models.unet import UNet

        net = UNet(depth=2, base_filters=self.filters, dropout_rate=0.0,
                   dtype=dtype)
        state, tx = train.create_train_state(net, (self.side, self.side, 2),
                                             self.lr, seed=0, device=self.dev)
        if dtype == torch.float64:
            net.double()   # in place: the optimizer keeps its parameters
        return net, state, tx

    def one_step(self, dtype, mesh, n: int):
        """(loss, gradients, state_dict) after one step from seed 0 on the
        batch's first ``n`` crops: over ``mesh`` (None: unsharded)."""
        import torch

        from tissue_image_processing_tpu_torch.models import train
        from tissue_image_processing_tpu_torch.parallel import mesh as pmesh

        net, state, tx = self.fresh(dtype)
        if mesh is not None:
            state = pmesh.shard_params(mesh, state)
            state, loss = pmesh.unet_train_step_sharded(
                mesh, net, state.optimizer)(state, pmesh.shard_batch(
                    mesh, self.bx[:n]), self.by[:n])
            sp = state.model
            grads = {k: (g[0] if sp.specs[k] is None else
                         torch.cat([t.to(self.dev) for t in g], sp.specs[k]))
                     for k, g in ((k, [p.grad for p in ps])
                                  for k, ps in sp.shards.items())
                     if g[0] is not None}
            out = float(loss), grads, sp.state_dict()
        else:
            state, loss, _ = train.make_train_step(net, tx)(
                state, self.bx[:n], self.by[:n])
            out = (float(loss), {k: p.grad for k, p in net.named_parameters()},
                   net.state_dict())
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    @staticmethod
    def worst_gradient(a, b) -> float:
        return max(float((a[1][k] - g).abs().max()) / float(g.abs().max())
                   for k, g in b[1].items())

    def hold(self, a, b, what: str, gradients: bool) -> None:
        import torch

        assert abs(a[0] - b[0]) <= 1e-5 * abs(b[0]), (what, a[0], b[0])
        if gradients:
            assert self.worst_gradient(a, b) <= 1e-4, \
                (what, self.worst_gradient(a, b))
        for k, v in b[2].items():
            if "num_batches" not in k:
                torch.testing.assert_close(
                    a[2][k], v, rtol=0,
                    atol=1e-6 if "running" in k else 2 * self.lr,
                    msg=what + k)


def train_mesh(devs, form: str = "streams"):
    """A (data 2 x model 2) mesh of ``devs`` in ``form``."""
    from tissue_image_processing_tpu_torch.parallel import mesh as pmesh

    return pmesh.Mesh(pmesh._object_array(list(devs), (2, 2)),
                      ("data", "model"), _form=form)


def train_float64_holds(case: TrainCase, devs, where: str, card: str) -> None:
    """One float64 step of each form over ``train_mesh(devs)`` against the
    unsharded step on ``case.dev``, on a quarter of the batch (float64
    doubles the memory): loss rel 1e-5, each gradient to 1e-4 of its
    largest magnitude, parameters 2 x lr, BatchNorm statistics 1e-6. A
    per-shard BatchNorm, a lost gradient sum or a hand-over read early
    misses them by orders of magnitude."""
    import torch

    n64 = max(2, case.batch // 4)
    want = case.one_step(torch.float64, None, n64)
    for form in ("serial", "streams"):
        got = case.one_step(torch.float64, train_mesh(devs, form), n64)
        case.hold(got, want, f"float64 {form} ", gradients=True)
        print(f"parallel: unet_train_step_sharded over (data 2 x model 2) of "
              f"{where}, {form} form, float64 on {n64} crops of {case.side}^2 "
              f"({case.filters} filters): loss {got[0]:.12f} vs "
              f"{want[0]:.12f} unsharded, worst gradient difference "
              f"{case.worst_gradient(got, want):.3g} of its largest "
              f"magnitude, parameters within 2 x lr, BatchNorm statistics "
              f"within 1e-6, on {card}")


def train_turns(par: ParallelRun, case: TrainCase, devs, name: str) -> tuple:
    """10 bfloat16 steps a run of the step over ``train_mesh(devs)`` in
    each form and of the unsharded step on ``case.dev``, each warmed by
    one step, then three runs each in turns (serial, streams, unsharded,
    streams, serial, unsharded, serial, streams, unsharded). The sharded
    runs go through :meth:`ParallelRun.run` as ``name_serial`` and
    ``name``, the step under ``set_sync_debug_mode("error")`` (a host
    synchronisation fails the run); every loss finite. Returns ({form or
    "unsharded": [seconds of its three runs]}, a function running two
    more steps of the streams form, its mesh)."""
    import torch

    from tissue_image_processing_tpu_torch.models import train
    from tissue_image_processing_tpu_torch.parallel import mesh as pmesh

    runs, holders, losses = {}, {}, []
    for form in ("serial", "streams"):
        net, state, _ = case.fresh(torch.bfloat16)
        mesh = train_mesh(devs, form)
        sstate = pmesh.shard_params(mesh, state)
        holder = types.SimpleNamespace(step=pmesh.unet_train_step_sharded(
            mesh, net, sstate.optimizer), mesh=mesh)
        xs = pmesh.shard_batch(mesh, case.bx)
        holder.step(sstate, xs, case.by)   # warm: plans, streams, allocator

        def ten(h=holder, st=sstate, x=xs, n=10):
            for _ in range(n):
                losses.append(h.step(st, x, case.by)[1])

        holders[form], runs[form] = holder, ten
    net, ustate, utx = case.fresh(torch.bfloat16)
    ustep = train.make_train_step(net, utx)
    ustep(ustate, case.bx, case.by)   # warm

    def ten_unsharded():
        for _ in range(10):
            losses.append(ustep(ustate, case.bx, case.by)[1])

    secs = {"serial": [], "streams": [], "unsharded": []}
    for form in ("serial", "streams", "unsharded", "streams", "serial",
                 "unsharded", "serial", "streams", "unsharded"):
        if form == "unsharded":
            secs[form].append(synced_seconds(ten_unsharded, case.dev)[1])
            continue
        key = name if form == "streams" else f"{name}_{form}"
        secs[form].append(par.run(key, runs[form], [(holders[form], "step")])[1])
    assert all(bool(torch.isfinite(loss)) for loss in losses)
    return secs, (lambda: runs["streams"](n=2)), holders["streams"].mesh


def steps_line(secs: dict) -> str:
    """Steps/s of each form's 10-step runs: min / median / max, then the
    runs in the order they ran."""
    def one(form, runs):
        rates = sorted(10 / s for s in runs)
        return (f"{form} {rates[0]:.3f} / {rates[len(rates) // 2]:.3f} / "
                f"{rates[-1]:.3f} steps/s (runs: "
                + " / ".join(f"{10 / s:.3f}" for s in runs) + ")")
    return "; ".join(one(form, runs) for form, runs in secs.items()) \
        + " (min / median / max)"


def trace_training(par: ParallelRun, fn, positions: int) -> None:
    """One run of ``fn`` (two bfloat16 steps of the streams form) under the
    profiler. The caller's stream is the one that ran the Adam step's
    foreach kernels (``multi_tensor_apply_kernel``); every other busy
    stream must be a position stream, ``positions`` of them, each busy.
    Prints each one's busy device ms and device operations, the ms in
    which two or more of them were busy (overlap) and its share of their
    busy time, the caller's busy ms (gathers, sums, the optimizer) and the
    device-busy share of the traced wall."""
    adam = "multi_tensor_apply_kernel"
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="smoke_trace_") as d:
        path = str(Path(d) / "trace.json")
        _, _, wall_ms, _ = device_profile(fn, rows=True, trace=path)
        streams = stream_activity(path, [adam])
        with open(path) as f:
            names = collections.Counter(
                (e["args"]["stream"], re.sub(r"<.*", "", e["name"])[-48:])
                for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel" and "args" in e)
    callers = [s for s, v in streams.items() if v["kernels"][adam]]
    moving = {s: v for s, v in streams.items() if s not in callers}
    assert len(callers) == 1 and len(moving) == positions, \
        (callers, sorted(streams), names.most_common(40))
    ops = {s: len(v["intervals"]) for s, v in sorted(moving.items())}
    busy, overlapped = busy_and_overlap_ms(moving)
    each = {s: round(sum(b - a for a, b in merged_us(v["intervals"])) / 1e3, 3)
            for s, v in sorted(moving.items())}
    assert min(each.values()) > 0, each
    caller_ms = sum(b - a for a, b in merged_us(
        streams[callers[0]]["intervals"])) / 1e3
    all_busy, _ = busy_and_overlap_ms(streams)
    print(f"parallel: traced 2 bfloat16 training steps (streams form): "
          f"{positions} position streams besides the caller's, device "
          f"operations by position stream (trace ids) {ops}, busy ms "
          f"{each}; overlapped (two or more position streams at once) "
          f"{overlapped:.3f} ms of {busy:.3f} ms busy ({overlapped / busy:.3f} "
          f"share); the caller's stream (gathers, sums, Adam) busy "
          f"{caller_ms:.3f} ms; device busy {all_busy:.3f} ms of "
          f"{wall_ms:.3f} ms traced wall ({all_busy / wall_ms:.3f} share) on "
          f"{par.card}")


def parallel_training(par: ParallelRun, filters: int, batch: int,
                      side: int) -> None:
    """Step 5 of the "parallel" phase: ``unet_train_step_sharded`` over
    (data 2 x model 2) of the virtual mesh with the training cell's recipe
    against ``make_train_step``, one step each from the same state and
    batch:

    - in float32 with TF32 off (streams form): the loss, parameters and
      BatchNorm statistics to the CPU tests' tolerances
      (``tests/test_torch_train.py``: loss rel 1e-5, parameters 2 x lr,
      statistics 1e-6); the gradients' difference is printed beside the
      unsharded step's own difference between two runs (cuDNN's float32
      kernels are not deterministic, and at this size their sums spread
      past those tests' 1e-4 of the largest gradient: PERF.md section 6);
    - in float64, each form (:func:`train_float64_holds`): all of those
      tolerances, the gradients' included;

    then 10 bfloat16 steps a run of the serial and streams forms and of
    the unsharded step, three runs each in turns, the sharded steps under
    ``set_sync_debug_mode("error")`` (:func:`train_turns`); on the card one
    traced run of the streams form (:func:`trace_training`)."""
    import torch

    case = TrainCase(par.dev, filters, batch, side)
    devs = par.devs[:4]

    def peak_gib() -> float:
        if not par.on_card:
            return float("nan")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        return peak

    peak_gib()
    got = case.one_step(torch.float32, train_mesh(devs), batch)
    want = case.one_step(torch.float32, None, batch)
    again = case.one_step(torch.float32, None, batch)
    case.hold(got, want, "float32 ", gradients=False)
    print(f"parallel: unet_train_step_sharded over (data 2 x model 2), depth "
          f"2, {filters} filters, batch {batch}, {side}^2, float32 (TF32 "
          f"off), streams form: loss {got[0]:.7f} vs {want[0]:.7f} "
          f"unsharded, parameters within 2 x lr, BatchNorm statistics within "
          f"1e-6; worst gradient difference "
          f"{case.worst_gradient(got, want):.3g} of its largest magnitude, "
          f"the unsharded step against a second run of itself "
          f"{case.worst_gradient(again, want):.3g}; peak memory "
          f"{peak_gib():.2f} GiB")
    del got, want, again
    train_float64_holds(case, devs, f"{len(set(devs))} card(s), "
                        f"{len(devs)} positions", par.card)
    print(f"parallel: float64 peak memory {peak_gib():.2f} GiB")
    secs, two_steps, mesh = train_turns(par, case, devs, "train")
    print(f"parallel: 10 bfloat16 training steps a run (depth 2, {filters} "
          f"filters, batch {batch}, {side}^2) over (data 2 x model 2) of "
          f"{len(devs)} positions, in turns, host syncs in the step "
          f"{par.syncs.get('train', 0)} (streams) / "
          f"{par.syncs.get('train_serial', 0)} (serial) under "
          f"set_sync_debug_mode error: {steps_line(secs)} on {par.card}")
    if par.on_card:
        trace_training(par, two_steps, len(mesh._streams))


def train_cards(par: ParallelRun, filters: int, batch: int, side: int
                ) -> None:
    """The training step over (data 2 x model 2) of four distinct cards:
    the float64 hold of each form against the unsharded step on card 0,
    10 bfloat16 steps a run of each form in turns (syncs 0: a sync fails
    the run), beside the same over four positions of card 0; where fewer
    than four cards are visible, one line saying so."""
    import torch

    cards = torch.cuda.device_count() if par.on_card else 0
    if cards < 4:
        print(f"parallel: the training step over (data 2 x model 2) of four "
              f"distinct cards was not run: {cards} card(s) visible")
        return
    case = TrainCase(torch.device("cuda", 0), filters, batch, side)
    devs = [torch.device("cuda", i) for i in range(4)]
    train_float64_holds(case, devs, "four cards", par.card)
    for where, d, name in (("4 positions of card 0", par.devs[:4], "train"),
                           ("four cards", devs, "train_cards")):
        secs, _, _ = train_turns(par, case, d, name)
        print(f"parallel: 10 bfloat16 training steps a run (depth 2, "
              f"{filters} filters, batch {batch}, {side}^2) over (data 2 x "
              f"model 2) of {where}, host syncs in the step "
              f"{par.syncs.get(name, 0)} (streams) / "
              f"{par.syncs.get(name + '_serial', 0)} (serial): "
              f"{steps_line(secs)} on {par.card}")


def parallel_card_vs_cpu(par: ParallelRun) -> None:
    """Step 6 of the "parallel" phase: the card against the CPU on the CPU
    tests' tiny shapes: sharded ids equal, space-sharded z-maps equal and
    projections within rtol 2e-4 / atol 2e-3."""
    import torch

    from tissue_image_processing_tpu_torch.parallel import pipeline as ppipe
    from tissue_image_processing_tpu_torch.parallel import spatial as pspat

    rng = np.random.default_rng(0)
    zz = np.arange(4, dtype=np.float32).reshape(4, 1, 1)
    tiny = (rng.random((8, 2, 1, 64, 64)).astype(np.float32) * 1000.0
            * np.exp(-((zz - 2.0) ** 2) / 2.0)[None, None])
    cpus = [torch.device("cpu")] * par.shards
    small = dict(capacity=64, block_size=31)
    a, b = (ppipe.sharded_movie_pipeline(ppipe.make_frame_mesh(
        par.shards, devices=d), **small)(tiny) for d in (par.devs, cpus))
    assert torch.equal(a.cpu(), b), "sharded ids: card != CPU"
    sm = np.random.default_rng(5).random((2, 2, 4, 16, 64)).astype(
        np.float32) * 5000
    (gp, gz), (wp, wz) = (pspat.sharded_projection(pspat.make_space_mesh(
        par.shards, frame_shards=1, x_shards=2, devices=d))(sm)
        for d in (par.devs, cpus))
    assert torch.equal(gz.cpu(), wz), "z-maps: card != CPU"
    torch.testing.assert_close(gp.cpu(), wp, rtol=2e-4, atol=2e-3)
    print(f"parallel: card vs CPU on tiny shapes: sharded ids equal "
          f"({int((a > 0).sum())} tracked), space-sharded z-maps equal, "
          f"projections max_abs_err {max_abs_err(gp.cpu(), wp):.3g}")


def check_parallel(card: str, movie, device: str = "cuda", shards: int = 4,
                   unet_depth: int = 3, unet_filters: int = 128,
                   train_filters: int = 128, train_batch: int = 32,
                   train_side: int = 256, capacity: int = 1024,
                   block_size: int = 101, min_cells: int = 200,
                   min_unet_cells: int = 10):
    """The "parallel" phase: ``parallel/`` on virtual meshes of ``shards``
    positions on one device (``devices=[torch.device("cuda")] * shards``),
    each position with a CUDA stream of its own, so that they overlap on
    the one card as they would on separate cards. The shard bodies of the
    four sharded paths (``pipeline._shard_frames``, ``_shifts``,
    ``spatial._project_block``) run under
    ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation in
    one fails the run. Each path runs in its two forms (serial: the
    caller's stream; streams: a stream a position), equal bit for bit.

    1. ``sharded_movie_pipeline`` on the raw headline movie (capacity 1024,
       block 101): ids equal to the unsharded chain's on the card; the
       unfused projection's blurs, the diffusions, the settle and its mask
       launched, the fused projection kernels not; frames/s of the two
       forms and the chain; one run of the streams form traced: the
       hand-written kernels on ``shards`` position streams, each carrying
       one shard's launches, none on another stream; the overlapped device
       ms, the busy share, and by position the host seconds to queue its
       body against its stream's device seconds;
    2. ``sharded_movie_pipeline_chunked`` fed from an ``io/movie.MovieStore``
       of the movie under ``build/`` (removed at the end): chunk 4 equal to
       the unchunked ids and to the serial form, and chunk 4 on a T=6 cut (a
       padded tail chunk) equal to their first 6 frames; ``on_chunk`` sees
       real frames only;
    3. ``sharded_unet_pipeline`` at depth 3 / 128 filters / bfloat16 with
       ``utils/synthetic.py:random_unet`` weights: ids equal to the
       per-frame unsharded chain; ``cc_scan`` launched; frames/s of the
       two forms; then, where two or more cards are visible, the
       watershed and U-Net pipelines on a mesh of every card in both forms
       (ids equal to the one-card run), else one line saying they were
       not run;
    4. ``sharded_projection`` of two frames tiled 2 x 2 to 2048^2 over
       (frame, y, x) = (1, 2, 2) and (2, 2, 1) against
       ``time_point_surface_projection(precise=True)``: the clip value
       equal; z-maps equal wherever the unsharded score's top two planes
       differ by more than 1e-5 relative (the other pixels counted); the
       projections within rtol 2e-4 / atol 2e-3 farther than the mask
       blur's 8 px from a z-map difference (the pixels within counted);
       every ``blur3d`` call at a shard shape bit for bit against its plain
       version on its input, timed by graph replay, its launches counted
       by shape;
    5. ``unet_train_step_sharded`` over (data 2 x model 2) with the training
       cell's recipe (depth 2, 128 filters, batch 32, 256^2, dropout 0):
       one float32 step (TF32 off) against ``make_train_step``'s within the
       CPU tests' tolerances but for the gradients, whose difference is
       printed beside the unsharded step's own run-to-run spread; one
       float64 step of each form on 8 crops within all of them; then 10
       bfloat16 steps a run of the serial and streams forms and of the
       unsharded step, three runs each in turns (steps/s min / median /
       max), the sharded step under ``set_sync_debug_mode("error")``; one
       traced run of the streams form: its four position streams busy, the
       overlap across them, the busy share;
    6. the card against the CPU on the CPU tests' tiny shapes;
    7. the host synchronisations counted by path, printed (0 in the four
       sharded paths, or the run has failed).

    ``device`` and the sizes exist for a dry run on the CPU (no launch,
    timing or synchronisation checks there, no trace, no step 6; both
    forms run on the CPU's one queue). Returns (launches by path, blur3d
    shard rows)."""
    import torch

    t_phase = time.perf_counter()
    par = ParallelRun(card, torch.device(device), shards)
    print(f"parallel: torch.cuda.device_count() = {torch.cuda.device_count()}"
          f"; virtual meshes of {shards} positions on {par.dev}")
    steps = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        steps[name] = round(time.perf_counter() - t0, 1)
        return out

    step("frames", parallel_frames, par, movie, unet_depth, unet_filters,
         capacity, block_size, min_cells, min_unet_cells)
    rows = step("space", parallel_space, par, movie)
    step("training", parallel_training, par, train_filters, train_batch,
         train_side)
    if par.on_card:
        step("card_vs_cpu", parallel_card_vs_cpu, par)
        print(f"parallel: host synchronisations inside the shard bodies "
              f"and the sharded train step (set_sync_debug_mode error, a "
              f"sync fails the run; tracker excluded): "
              f"{par.syncs}; by source line: "
              f"{dict(par.sync_sites.most_common())}")
    print(f"parallel: phase {time.perf_counter() - t_phase:.1f} s on {card} "
          f"(seconds by step: {steps})")
    return par.launches, rows


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``reps`` calls (the dry run on the CPU)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def zipfile_contents(path: str) -> dict:
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def main(argv=()) -> int:
    """Every phase (no arguments); with ``parallel`` the build and the
    "parallel" phase alone, with ``cards`` the build and that phase's mesh
    of every visible card with the one-card runs it is held to
    (:func:`check_cards`), each without the kernel table and the last
    line."""
    import torch

    if list(argv) not in ([], ["parallel"], ["cards"], ["radii"],
                          ["cellpose"], ["auction"]):
        print("usage: python3 chip_smoke.py [parallel | cards | radii | "
              "cellpose | auction]", file=sys.stderr)
        return 2
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

    from tissue_image_processing_tpu_torch.core.pipeline import _projections
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    if argv == ["radii"]:
        print(json.dumps({"radii_sweep": check_radii(card)}))
        print(card_line())
        return 0
    if argv == ["auction"]:
        print(json.dumps({"auction": check_auction(card)}))
        print(card_line())
        return 0
    if argv == ["cellpose"]:
        follow_row, diffuse_row = check_cellpose(card)
        print(json.dumps({"follow_flows": follow_row,
                          "flow_diffuse": diffuse_row}))
        print(card_line())
        return 0
    if argv:
        movie = make_movie(T=8, Z=30, H=1024, W=1024, seed=0).astype(np.uint16)
        (check_parallel if argv == ["parallel"] else check_cards)(card, movie)
        print(card_line())
        return 0
    frames = _projections(make_movie(T=2, Z=1, H=1024, W=1024, seed=2), 0,
                          torch.device("cuda"), keep=[0])
    frames = frames[:, 0].transpose(1, 2).contiguous()
    rows = check_kernels(frames)
    rows["conv3x3_s8"] = check_conv_s8(card)
    by_caller, band_input = check_ported_functions(frames, card)
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
    frame_inputs = check_fused_vs_unfused(stack)
    del stack
    check_pipeline(card, movie_z1)
    launches, blur_shapes = check_pipeline(card, movie_z30)
    unet_launches, unet_blur_shapes, int8_launches, int8_forms = \
        check_unet_pipeline(card, movie_z30)
    radii_row = check_radii(card)
    auction_row = check_auction(card)
    follow_row, diffuse_row = check_cellpose(card)
    check_card_vs_cpu()
    check_keras_weights(card)
    check_training(card)
    blur_inputs, blur_launches_cli, envelope_rows = check_files(card, movie_z30)
    feed = check_tissue(card, movie_z30)
    cli_launches, cli_unet_launches = check_cli(card, movie_z30, feed, launches)
    del feed
    par_launches, shard_rows = check_parallel(card, movie_z30)
    driver_rows = {f"driver_{name}": dict(check_driver_blur(name, *x, card),
                                          launches=blur_launches_cli[name])
                   for name, x in blur_inputs.items()}
    del blur_inputs
    # the frame-sharded pipelines' unfused projection of (30, 1024, 1024)
    # frames (one launch of each a frame on the sharded watershed run) and
    # band_pass_filter's blur (one a call)
    T = movie_z30.shape[0]
    for shape, x in frame_inputs.items():
        name = f"frame_{'pre' if shape[3] == 5 else 'mask'}_blur"
        driver_rows[name] = dict(check_driver_blur(name, *x, card), launches=T)
    driver_rows["band_pass"] = dict(
        check_driver_blur("band_pass", *band_input, card),
        launches=by_caller["blur3d"]["band_pass_filter"])
    del frame_inputs, band_input
    driver_rows.update(envelope_rows)
    ragged = check_ragged_blurs(card)

    table = []
    for name in KERNELS:
        r = rows[name]
        at_unet = {}
        if name in unet_rows:  # the same kernel on the U-Net path's input
            u = unet_rows[name]
            at_unet = {"max_abs_err_unet": u["err"], "ms_unet": u["ms"],
                       **({"device_ms_unet": u["device_ms"]}
                          if "device_ms" in u else {}),
                       "plain_ms_unet": u["plain_ms"],
                       "bound_ms_unet": u["bound"][0],
                       "bound_by_unet": u["bound"][1]}
        if name == "blur3d":  # its second main-path shape, and launches by shape
            b = rows["blur3d_score"]
            at_unet.update({
                "form": "tile25", "generic_ms": None,
                "form_score_blur": "z_only", "generic_ms_score_blur": None,
                "ragged_walk_and_generic_ms": ragged,
                "max_abs_err_score_blur": b["err"], "ms_score_blur": b["ms"],
                "ms_min_score_blur": b["ms_min"], "ms_max_score_blur": b["ms_max"],
                "device_ms_score_blur": b["device_ms"],
                "plain_ms_score_blur": b["plain_ms"],
                "bound_ms_score_blur": b["bound"][0],
                "bound_by_score_blur": b["bound"][1],
                "library_ms_score_blur": b["library_ms"],
                "launches_by_shape": blur_shapes,
                "launches_by_shape_unet": unet_blur_shapes})
        if name == "conv3x3_s8":   # one forward's convs, and each shape
            at_unet = {"library_bf16_ms": r["library_bf16_ms"],
                       "ms_2": r["device_ms_2"],
                       "generic_ms": r["generic_ms"],
                       "generic_ms_2": r["generic_ms_2"],
                       "launches_by_form": int8_forms,
                       "by_shape": r["by_shape"]}
        table.append({
            "name": name, "route": "cuda",
            "source": KERNEL_SOURCE.get(name, FLOOD_SOURCE),
            "replaces": REPLACES[name],
            "launches": (unet_launches if name == "cc_scan" else
                         int8_launches if name == "conv3x3_s8" else
                         launches)[name],
            "launches_unet": unet_launches[name],
            "launches_unet_int8": int8_launches[name],
            "launches_cli": cli_launches.get(name, 0),
            "launches_cli_unet_int8": cli_unet_launches.get(name, 0),
            "launches_parallel": {path: got.get(name, 0) for path, got in
                                  par_launches.items()
                                  if not path.startswith("train")},
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], **at_unet,
            **({"launches_by_function": by_caller[name]}
               if name in by_caller else {}),
            **{k: r[k] for k in ("ms_min", "ms_max", "device_ms") if k in r}})
    table.append({"name": "radii_sweep", "route": "cuda",
                  "source": KERNEL_SOURCE["radii_sweep"],
                  "replaces": "none (host numpy / scipy in the JAX package: "
                              "core/tracking.py:adaptive_effective_ranges)",
                  **radii_row})
    table.append({"name": "auction", "route": "cuda",
                  "source": KERNEL_SOURCE["auction"],
                  "replaces": "none (a lax.while_loop in the JAX package: "
                              "core/tracking.py:auction_assignment)",
                  **auction_row})
    table.append({"name": "follow_flows", "route": "cuda",
                  "source": KERNEL_SOURCE["follow_flows"],
                  "replaces": "none (the JAX package has no Cellpose)",
                  **follow_row})
    table.append({"name": "flow_diffuse", "route": "cuda",
                  "source": KERNEL_SOURCE["flow_diffuse"],
                  "replaces": "none (the JAX package has no Cellpose)",
                  **diffuse_row})
    # blur3d at the unfused projection's shapes (the driver, the
    # frame-sharded pipelines, band_pass_filter, the production envelope,
    # the space shards): the form each ran and the generic form's time
    for name, r in {**driver_rows, **{f"shard_{k}": v for k, v in
                                     shard_rows.items()}}.items():
        table.append({
            "name": f"blur3d_{name}", "route": "cuda",
            "source": KERNEL_SOURCE["blur3d"], "replaces": REPLACES["blur3d"],
            "shape": list(r["shape"]), "form": r["form"],
            "launches": r["launches"], "max_abs_err": r["err"],
            "ms": r["device_ms"], "ms_runs": r["device_ms_runs"],
            "generic_ms": r["generic_ms"],
            "generic_ms_runs": r["generic_ms_runs"],
            "events_ms": r["ms"], "events_ms_min": r["ms_min"],
            "events_ms_max": r["ms_max"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": table}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
