"""Time the settle and the project pass built with other tuning constants.

    python3 -m tissue_image_processing_tpu_torch.utils.kernel_variants \\
        settle k16,SK=16 b3,SETTLE_MIN_BLOCKS=3 counters
    python3 -m tissue_image_processing_tpu_torch.utils.kernel_variants \\
        project b4,PR_MIN_BLOCKS=4

Needs one CUDA card and ``nvcc``; run from the repository root (the inputs
are those of ``chip_smoke.py``). Each argument after the kernel's name is a
variant ``name,CONSTANT=value,...``: the source in ``csrc/`` is copied with
those ``constexpr int`` constants replaced, built into
``build/torch_kernels/variants/`` and loaded in place of the library. Every
variant (and ``base``, the source as it is) is held bit for bit against the
plain version before it is timed (median of five CUDA-event brackets). For
the settle, the variant ``counters`` adds ``clock64`` counters to the kernel
and prints, for a few blocks, the cycles spent in the gate, the tile load,
the sweeps and the grid sync, with the tile-rounds and sweeps the block ran.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.ops import flood_cuda
from tissue_image_processing_tpu_torch.ops import watershed as ws
from tissue_image_processing_tpu_torch.projection import fused
from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

# (text in flood.cu that occurs once, what takes its place) for ``counters``
_TICK = "{long long n_ = clock64(); prof[%d] += n_ - pc; pc = n_;}"
_COUNTERS = (
    ("  int last_sweep = 0;  // thread 0",
     "  long long prof[7] = {0, 0, 0, 0, 0, 0, 0}, pc = clock64();\n"
     "  int last_sweep = 0;  // thread 0"),
    ("      __syncthreads();  // the previous tile's shared state is done with\n\n"
     "      // the region as it stood",
     "      __syncthreads();\n      " + _TICK % 0 + "\n      // the region as it stood"),
    ("      s_u[0][seg][lx] = u;\n      __syncthreads();\n",
     "      s_u[0][seg][lx] = u;\n      __syncthreads();\n      " + _TICK % 1 + "\n"),
    ("      const int left = __syncthreads_or(",
     "      " + _TICK % 2 + " prof[5]++; prof[6] += j_last;\n"
     "      const int left = __syncthreads_or("),
    ("    grid.sync();\n    if (__ldcg(any + round % 3) == 0) break;",
     "    " + _TICK % 4 + "\n    grid.sync();\n    " + _TICK % 3 + "\n"
     "    if (__ldcg(any + round % 3) == 0) break;"),
    ("    if (blockIdx.x == 0) flags[3 * tiles + 4] = round + 1;",
     '    if (blockIdx.x % 97 == 0) printf("block %d: gate %lld load %lld '
     'sweeps %lld sync %lld rest %lld cycles; %lld tile-rounds, %lld sweeps, '
     '%d rounds\\n", blockIdx.x, prof[0], prof[1], prof[2], prof[3], prof[4], '
     "prof[5], prof[6], round + 1);\n"
     "    if (blockIdx.x == 0) flags[3 * tiles + 4] = round + 1;"),
)


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / reps)
    return sorted(means)[2]


def build_variants(source: str, signatures, specs):
    """Name -> (library, constants, ptxas register lines); all nvcc runs are
    started together."""
    text = (_device._CSRC / f"{source}.cu").read_text()
    out_dir = _device.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in ["base", *specs]:
        name, *pairs = spec.split(",")
        constants = dict(pair.split("=") for pair in pairs)
        variant = text
        for key, value in constants.items():
            variant, n = re.subn(rf"constexpr int {key} = [^;]+;",
                                 f"constexpr int {key} = {value};", variant)
            assert n == 1, f"{key}: {n} definitions in {source}.cu"
        if name == "counters":
            for old, new in _COUNTERS:
                assert variant.count(old) == 1, old
                variant = variant.replace(old, new)
            variant = "#include <cstdio>\n" + variant
        src = out_dir / f"{source}_{name}.cu"
        src.write_text(variant)
        lib = out_dir / f"lib{source}_{name}.so"
        procs[name] = (lib, constants, subprocess.Popen(
            [_device._nvcc(), *_device.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (path, constants, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: build failed\n{log[-1500:]}")
            continue
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line]
        built[name] = (lib, constants, regs)
    return built


def settle_inputs():
    """(lam, seeds) of the watershed path (two 1024^2 frames stacked) and of
    the U-Net path (eight boundary maps stacked), as ``chip_smoke.py``
    makes them."""
    import chip_smoke
    from tissue_image_processing_tpu_torch.core.pipeline import _reference_frames
    from tissue_image_processing_tpu_torch.models.predictor import _boundary
    from tissue_image_processing_tpu_torch.ops.filters import gaussian_blur
    from tissue_image_processing_tpu_torch.ops.local_threshold import (
        threshold_local_max)

    frames = _reference_frames(make_movie(T=2, Z=1, H=1024, W=1024, seed=2),
                               0, torch.device("cuda"))
    seg = torch.where(frames < 0.2 * threshold_local_max(frames, 101), 0.0, frames)
    img = ws.stack_frames(gaussian_blur(seg, (0.0, 3.0, 3.0)))
    seeds = ws.regional_minima_labels(img)
    movie = make_movie(T=8, Z=1, H=1024, W=1024, seed=0).astype(np.uint16)
    boundary, _ = _boundary(chip_smoke.synthetic_predictions(movie), 0.1, 5, 7)
    uimg = ws.stack_frames(boundary.to(torch.float32))
    useeds = ws.regional_minima_labels(uimg, scan=True, binary=True)
    return {"watershed": (flood_cuda.bf_flood(img, seeds), seeds),
            "unet": (uimg, useeds)}


def tune_settle(specs) -> None:
    inputs = settle_inputs()
    want = {k: flood_cuda.settle_plain(*v) for k, v in inputs.items()}
    for name, (lib, constants, regs) in build_variants(
            "flood", flood_cuda._SIGNATURES, specs).items():
        _device._libs["flood"] = lib
        line = [f"{name} {constants}:"]
        for key, (lam, seeds) in inputs.items():
            got = flood_cuda.settle(lam, seeds)
            torch.cuda.synchronize()  # the counters' lines come out here
            exact = all(torch.equal(g, w) for g, w in zip(got, want[key]))
            line.append(f"{key} {'bit-exact' if exact else 'WRONG'}, "
                        f"{int(flood_cuda._ROUNDS['settle'])} rounds, "
                        f"{int(flood_cuda._SWEEPS['settle'])} sweeps")
            if name != "counters":
                line.append(f"{cuda_ms(lambda: flood_cuda.settle(lam, seeds)):.4f} ms;")
        print(" ".join(line), regs[-2:-1])


def tune_project(specs) -> None:
    stack = torch.from_numpy(make_movie(T=1, Z=30, H=1024, W=1024, seed=2)[0]
                             .astype(np.uint16)).cuda()
    rel_z = fused.fused_projection(stack)[1]
    cases = {"plain": {}, "shift and offset": dict(atoh_shift=2,
                                                   airyscan_offset=1000.0)}
    want = {k: fused.project_pass_plain(stack, rel_z, **kw)
            for k, kw in cases.items()}
    for name, (lib, constants, regs) in build_variants(
            "projection", fused._SIGNATURES, specs).items():
        _device._libs["projection"] = lib
        line = [f"{name} {constants}:"]
        for key, kw in cases.items():
            exact = torch.equal(fused.project_pass(stack, rel_z, **kw), want[key])
            ms = cuda_ms(lambda: fused.project_pass(stack, rel_z, **kw), 20)
            line.append(f"{key} {'bit-exact' if exact else 'WRONG'} {ms:.4f} ms;")
        print(" ".join(line), regs[:2])


def main(argv) -> int:
    if len(argv) < 1 or argv[0] not in ("settle", "project"):
        print(__doc__)
        return 2
    (tune_settle if argv[0] == "settle" else tune_project)(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
