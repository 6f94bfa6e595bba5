"""Time the settle, the projection's two passes and the blur built with
other tuning constants.

    python3 -m tissue_image_processing_tpu_torch.utils.kernel_variants \\
        settle k16,SK=16 b3,SETTLE_MIN_BLOCKS=3 counters
    python3 -m tissue_image_processing_tpu_torch.utils.kernel_variants \\
        project b4,PR_MIN_BLOCKS=4
    python3 -m tissue_image_processing_tpu_torch.utils.kernel_variants \\
        score b1,SC_MIN_BLOCKS=1 z16,SC_ZCHUNK=16
    python3 -m tissue_image_processing_tpu_torch.utils.kernel_variants \\
        blur y32,BT_Y=32 c4,BZ_CHUNK=4 a3,BW_AHEAD=3
    python3 -m tissue_image_processing_tpu_torch.utils.kernel_variants \\
        conv s3,TC_MAX_STAGES=3 r2,FC_ROWS=2,FC_THREADS=128 noepilogue [check]
    python3 -m tissue_image_processing_tpu_torch.utils.kernel_variants \
        wrappers          # from any tree's root: its kernels as built

Needs one CUDA card and ``nvcc``; run from the repository root (the inputs
are those of ``chip_smoke.py``). Each argument after the kernel's name is a
variant ``name,CONSTANT=value,...``: the source in ``csrc/`` (or the file
``SOURCE=<path>`` names, e.g. a parent's) is copied with those ``constexpr
int`` constants replaced, built into
``build/torch_kernels/variants/`` and loaded in place of the library. Every
variant (and ``base``, the source as it is) is held bit for bit against the
plain version before it is timed (median of five CUDA-event brackets). For
the settle, the variant ``counters`` adds ``clock64`` counters to the kernel
and prints, for a few blocks, the cycles spent in the gate, the tile load,
the sweeps and the grid sync, with the tile-rounds and sweeps the block ran;
for the score pass, the cycles a thread of the y pass and one of the x pass
spent in the z sums, in their pass and at the barrier. For the int8 conv,
``check`` holds the variants bit for bit at every shape without timing
them (a first call after a new source), and the variant ``noepilogue``
drops the tensor-core form's epilogue (its results are WRONG by design):
its time beside ``base`` is the epilogue's share.
"""

from __future__ import annotations

import ctypes
import importlib
import re
import subprocess
import sys

import numpy as np
import torch

from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.ops import (blur_cuda, conv_s8_cuda,
                                                   flood_cuda)
from tissue_image_processing_tpu_torch.projection import fused
from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

# ``ops`` exports a function of this module's name
ws = importlib.import_module("tissue_image_processing_tpu_torch.ops.watershed")

# (text in flood.cu that occurs once, what takes its place) for ``counters``
_TICK = "{long long n_ = clock64(); prof[%d] += n_ - pc; pc = n_;}"
_SETTLE_COUNTERS = (
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
# the score pass: cycles a step in the z sums, in the y or x pass, and
# waiting at the barrier, for a thread of the y pass and one of the x pass
_SCORE_COUNTERS = (
    ("  // step k: the z sums of plane k",
     "  long long prof[3] = {0, 0, 0};\n  // step k: the z sums of plane k"),
    ("    constexpr int S = decltype(S_)::value;\n",
     "    constexpr int S = decltype(S_)::value;\n    long long c0 = clock64();\n"),
    ("    if (k >= 1 && k <= n && tid < SC_Y_TASKS) {",
     "    long long c1 = clock64(); prof[0] += c1 - c0;\n"
     "    if (k >= 1 && k <= n && tid < SC_Y_TASKS) {"),
    ("    // after this barrier\n    __syncthreads();\n",
     "    long long c2 = clock64(); prof[1] += c2 - c1;\n"
     "    __syncthreads();\n    prof[2] += clock64() - c2;\n"),
    ("    if (k + 4 < n + 2) step(k + 4, Int<4>{});\n  }\n",
     "    if (k + 4 < n + 2) step(k + 4, Int<4>{});\n  }\n"
     "  if ((tid == 0 || tid == SC_THREADS - 1) && blockIdx.x == 3 && "
     "blockIdx.y % 16 == 5)\n"
     '    printf("block %d thread %d: z sums %lld, %s pass %lld, barrier %lld '
     'cycles over %d steps\\n", blockIdx.y, tid, prof[0], tid ? "x" : "y", '
     "prof[1], prof[2], n + 2);\n"),
)
_COUNTERS = {"flood": _SETTLE_COUNTERS, "projection": _SCORE_COUNTERS}
# the int8 conv's tensor-core form without its epilogue (no output: WRONG by
# design), so that its time against the source's shows the epilogue's cost
_NO_EPILOGUE = (
    ("        tc_epilogue<MW, BN, true>(acc, acc1[0], p, t, wg, tid, stg);",
     "        (void)acc1;"),
    ("        tc_epilogue<MW, BN, false>(acc, acc[0], p, t, wg, tid, stg);",
     "        (void)stg;"),
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds a call of ``fn()`` with no launch gaps: ``reps``
    calls captured in one CUDA graph, replayed between CUDA events; the
    median of five replays. (An event bracket around plain calls of a kernel
    shorter than its Python wrapper times the wrapper.)"""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    means = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / reps)
    return sorted(means)[2]


def build_variants(source: str, signatures, specs):
    """Name -> (library, constants, ptxas register lines); all nvcc runs are
    started together."""
    out_dir = _device.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in ["base", *specs]:
        name, *pairs = spec.split(",")
        constants = dict(pair.split("=") for pair in pairs)
        # SOURCE=<path>: another version of the source (e.g. a parent's)
        variant = open(constants.pop("SOURCE")).read() if "SOURCE" in \
            constants else (_device._CSRC / f"{source}.cu").read_text()
        for key, value in constants.items():
            variant, n = re.subn(rf"constexpr int {key} = [^;]+;",
                                 f"constexpr int {key} = {value};", variant)
            assert n == 1, f"{key}: {n} definitions in {source}.cu"
        if name in ("counters", "noepilogue"):
            edits = _COUNTERS[source] if name == "counters" else _NO_EPILOGUE
            for old, new in edits:
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
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            print(f"{name}: build failed\n{log[-1500:]}")
            continue
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            if not hasattr(lib, fn):  # an older source without this entry
                continue
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line]
        built[name] = (lib, constants, regs)
    return built


def _pre_blur_input():
    """Two thresholded 1024^2 reference frames, as the watershed hands them
    to its pre-blur."""
    from tissue_image_processing_tpu_torch.core.pipeline import _projections
    from tissue_image_processing_tpu_torch.ops.local_threshold import (
        threshold_local_max)

    frames = _projections(make_movie(T=2, Z=1, H=1024, W=1024, seed=2), 0,
                          torch.device("cuda"), keep=[0])
    frames = frames[:, 0].transpose(1, 2).contiguous()
    return torch.where(frames < 0.2 * threshold_local_max(frames, 101), 0.0,
                       frames).contiguous()


def settle_inputs():
    """(lam, seeds) of the watershed path (two 1024^2 frames stacked) and of
    the U-Net path (eight boundary maps stacked), as ``chip_smoke.py``
    makes them."""
    import chip_smoke
    from tissue_image_processing_tpu_torch.models.predictor import _boundary
    from tissue_image_processing_tpu_torch.ops.filters import gaussian_blur

    img = ws.stack_frames(gaussian_blur(_pre_blur_input(), (0.0, 3.0, 3.0)))
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


def _score_input():
    """The reference channel of a (2, 30, 1024, 1024) frame and its p95, as
    ``fused_projection`` makes them."""
    from tissue_image_processing_tpu_torch.ops.percentile import (
        masked_percentile)

    stack = torch.from_numpy(make_movie(T=1, Z=30, H=1024, W=1024, seed=2)[0]
                             .astype(np.uint16)).cuda()
    ref = stack[0]
    sub = ref[:, ::16, :].to(torch.float32)
    return ref, masked_percentile(sub, sub > 0, 95.0)


def _time_variants(source, signatures, specs, cases) -> None:
    """cases: name -> (kernel call, plain result); each variant is held bit
    for bit to the plain result before it is timed: CUDA events around
    calls, and the device time without launch gaps (:func:`graph_ms`)."""
    for name, (lib, constants, regs) in build_variants(
            source, signatures, specs).items():
        _device._libs[source] = lib
        line = [f"{name} {constants}:"]
        for key, (fn, want) in cases.items():
            exact = torch.equal(fn(), want)
            line.append(f"{key} {'bit-exact' if exact else 'WRONG'} "
                        f"{cuda_ms(fn, 20):.4f} ms, device "
                        f"{graph_ms(fn):.4f} ms;")
        print(" ".join(line), regs)


def tune_score(specs) -> None:
    ref, p95 = _score_input()
    want = fused.score_pass_plain(ref, p95)
    if "counters" in specs:  # its lines come out at the synchronisation
        lib = build_variants("projection", fused._SIGNATURES, ["counters"])
        _device._libs["projection"] = lib["counters"][0]
        exact = torch.equal(fused.score_pass(ref, p95), want)
        torch.cuda.synchronize()
        print(f"counters: {'bit-exact' if exact else 'WRONG'}")
        specs = [s for s in specs if s != "counters"]
    cases = {"(30, 1024, 1024)": (lambda: fused.score_pass(ref, p95), want)}
    _time_variants("projection", fused._SIGNATURES, specs, cases)


def _driver_blur_inputs():
    """The unfused projection's pre-blur and z-mask blur inputs on a
    (2, 30, 2048, 2048) frame (the headline frame tiled 2 x 2, as the
    projection driver's cell makes it): (x, kz, ky, kx) by name."""
    import chip_smoke
    from tissue_image_processing_tpu_torch.projection.surface import (
        time_point_surface_projection)

    frame = make_movie(T=1, Z=30, H=1024, W=1024, seed=2)[0].astype(np.uint16)
    stack = torch.from_numpy(np.tile(frame, (1, 1, 2, 2))).cuda()
    shapes = chip_smoke.driver_blurs(30, 2048)
    wanted = {shapes["pre_blur"], shapes["mask_blur"]}
    with chip_smoke.capture_blur_inputs(wanted) as captured:
        time_point_surface_projection(stack, airyscan=False)
    return {name: captured[shapes[name]] for name in ("pre_blur", "mask_blur")}


def tune_blur(specs) -> None:
    """The blur at its two main-path shapes: the watershed pre-blur of two
    thresholded frames, taps (1, 25, 25), and the z axis of the small-score
    blur, taps (5, 1, 1); and at the projection driver's two 2048^2 shapes
    (the unfused projection's pre-blur, taps (5, 9, 9), and z-mask blur,
    taps (9, 17, 17), on a (30, 2048, 2048) frame), which take the walk
    form: each variant's walk form, and the generic tile form of the same
    library beside it. A library without the walk form (``SOURCE=`` an
    older source) runs the generic form in both rows."""
    from tissue_image_processing_tpu_torch.ops.filters import gaussian_kernel1d

    seg = _pre_blur_input()
    small = fused.score_pass(*_score_input())
    k25, k5, one = gaussian_kernel1d(3.0), gaussian_kernel1d(0.5), (1.0,)

    def walk(x, *k):  # the walk form where the loaded library has it
        has = hasattr(_device._libs.get("blur3d"), "blur3d_walk_f32")
        return blur_cuda.blur3d(x, *k, form=None if has else "generic")

    cases = {
        "pre-blur (2, 1024, 1024)": (
            lambda: blur_cuda.blur3d(seg, one, k25, k25),
            blur_cuda.blur3d_plain(seg, one, k25, k25)),
        "score blur (30, 256, 256)": (
            lambda: blur_cuda.blur3d(small, k5, one, one),
            blur_cuda.blur3d_plain(small, k5, one, one))}
    for name, (x, *k) in _driver_blur_inputs().items():
        want = blur_cuda.blur3d_plain(x, *k)
        taps = tuple(map(len, k))
        cases[f"driver {name} {tuple(x.shape)} taps {taps}, walk"] = (
            lambda x=x, k=k: walk(x, *k), want)
        cases[f"driver {name}, generic"] = (
            lambda x=x, k=k: blur_cuda.blur3d(x, *k, form="generic"), want)
    _time_variants("blur3d", blur_cuda._SIGNATURES, specs, cases)


def checksum(t: torch.Tensor) -> tuple:
    """(sum, position-weighted sum) of a tensor's bytes read as int32 words,
    accumulated in int64 (wrapping) in chunks on the tensor's device: a
    change of any word changes the pair with near certainty."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
    w = b.view(torch.int32)
    s0 = s1 = 0
    step = 1 << 26
    for i in range(0, w.numel(), step):
        c = w[i:i + step].to(torch.int64)
        pos = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
        s0 += int(c.sum())
        s1 += int((c * pos).sum())
    return s0, s1


def first_difference(got: torch.Tensor, want: torch.Tensor):
    """None if ``got`` equals ``want``; else (index, got value, want value)
    of the first differing element in row-major order (searched in chunks),
    or ("shape", got shape, want shape)."""
    if got.shape != want.shape:
        return "shape", tuple(got.shape), tuple(want.shape)
    g, w = got.reshape(-1), want.reshape(-1)
    step = 1 << 26
    for i in range(0, g.numel(), step):
        d = torch.nonzero(g[i:i + step] != w[i:i + step])
        if d.numel():
            k = i + int(d[0, 0])
            return (tuple(int(v) for v in np.unravel_index(k, tuple(got.shape))),
                    g[k].item(), w[k].item())
    return None


def _case_inputs(args, kw, packed):
    return [t for t in (*args, *kw.values(), *packed)
            if isinstance(t, torch.Tensor)]


def tune_conv(specs) -> None:
    """The int8 conv at the 11 conv shapes of the depth-3, 128-filter U-Net
    at B = 8 (``chip_smoke.conv_case``, in the form ``conv3x3_s8`` picks for
    each): every variant of ``csrc/conv_s8.cu`` (its ``constexpr int`` tile
    and stage constants: ``TC_MAX_STAGES``, ``TC_SMEM``, ``FC_ROWS`` with
    ``FC_THREADS``) held bit for bit against the plain version at every
    shape, twice, then timed by graph replay; one forward's sum of the 14
    convs and its TOP/s. Each case's inputs and plain result are
    checksummed at the start and re-checked after every variant; a WRONG
    prints the first differing element, whether the inputs and the plain
    result still match their checksums, and the verdict of the library
    loaded at entry on the same case. That library is restored on exit."""
    import chip_smoke

    check_only = "check" in specs
    specs = [s for s in specs if s != "check"]
    entry = _device.load_library("conv_s8", conv_s8_cuda._SIGNATURES)
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    for (side, cin, cout, cs), n in chip_smoke.UNET_CONVS:
        args, kw, packed = chip_smoke.conv_case(gen, 8, side, cin, cout, cs)
        want = chip_smoke.plain_in_slices(*args, **kw)
        sums = ([checksum(t) for t in _case_inputs(args, kw, packed)],
                checksum(want))
        cases.append((f"{side}^2 {cin}{'+' + str(cs) if cs else ''}->{cout}",
                      n, 2.0 * 8 * side * side * 9 * (cin + cs) * cout, args,
                      kw, packed, want, sums))

    def intact(args, kw, packed, want, sums):
        return ([checksum(t) for t in _case_inputs(args, kw, packed)]
                == sums[0], checksum(want) == sums[1])

    try:
        for name, (lib, constants, regs) in build_variants(
                "conv_s8", conv_s8_cuda._SIGNATURES, specs).items():
            _device._libs["conv_s8"] = lib
            total = ops = 0.0
            print(f"{name} {constants}: {regs}")
            for label, n, nops, args, kw, packed, want, sums in cases:
                def fn():
                    return conv_s8_cuda.conv3x3_s8(*args, packed=packed, **kw)

                got = fn()
                diff = first_difference(got, want)
                if diff is None:
                    diff = first_difference(fn(), want)
                form = conv_s8_cuda.conv_s8_form(args[0].shape[-1], 0 if kw[
                    "skip"] is None else kw["skip"].shape[-1], args[1].shape[0])
                inputs_ok, want_ok = intact(args, kw, packed, want, sums)
                line = f"  {label} ({form}): {'bit-exact' if diff is None else 'WRONG'}"
                if diff is not None:
                    _device._libs["conv_s8"] = entry
                    again = first_difference(fn(), want)
                    _device._libs["conv_s8"] = lib
                    line += (f" (first difference at {diff[0]}: got {diff[1]}, "
                             f"want {diff[2]}; inputs "
                             f"{'match' if inputs_ok else 'DO NOT match'} their "
                             f"checksums, the plain result "
                             f"{'matches' if want_ok else 'DOES NOT match'} its "
                             f"checksum; the library loaded at entry: "
                             f"{'bit-exact' if again is None else f'WRONG {again}'})")
                elif not (inputs_ok and want_ok):
                    line += (f" (inputs {'match' if inputs_ok else 'CHANGED'}, "
                             f"plain result {'matches' if want_ok else 'CHANGED'})")
                if not check_only:
                    ms = graph_ms(fn, reps=5)
                    total, ops = total + n * ms, ops + n * nops
                    line += f", {ms:.4f} ms ({nops / ms / 1e9:.1f} TOP/s)"
                print(line, flush=True)
                del got
            if not check_only:
                print(f"  one forward's 14 convs: {total:.4f} ms "
                      f"({ops / total / 1e9:.1f} TOP/s)")
    finally:
        _device._libs["conv_s8"] = entry


def time_wrappers(_specs) -> None:
    """The score pass, the blur and the settle mask at their main-path shapes
    through the wrappers of whichever package is imported, built as it
    stands: events around calls and the device time without launch gaps.
    Run it with ``-m`` from the root of the tree to time (e.g. a parent
    commit unpacked with ``git archive``): the settle mask's inputs come
    from that tree's ``chip_smoke.py``."""
    from tissue_image_processing_tpu_torch.ops.filters import gaussian_kernel1d

    ref, p95 = _score_input()
    small = fused.score_pass(ref, p95)
    seg = _pre_blur_input()
    k25, k5, one = gaussian_kernel1d(3.0), gaussian_kernel1d(0.5), (1.0,)
    lam = settle_inputs()
    ws_lam, unet_lam = lam["watershed"][0], lam["unet"][0]
    calls = {
        "proj_score (30, 1024, 1024)": lambda: fused.score_pass(ref, p95),
        "blur3d (2, 1024, 1024) taps (1, 25, 25)":
            lambda: blur_cuda.blur3d(seg, one, k25, k25),
        "blur3d (30, 256, 256) taps (5, 1, 1)":
            lambda: blur_cuda.blur3d(small, k5, one, one),
        f"settle_mask {tuple(ws_lam.shape)}":
            lambda: flood_cuda.settle_mask(ws_lam),
        f"settle_mask {tuple(unet_lam.shape)} (U-Net input)":
            lambda: flood_cuda.settle_mask(unet_lam)}
    for name, fn in calls.items():
        try:  # a wrapper that copies its taps each call may refuse capture
            device = f"{graph_ms(fn):.4f} ms"
        except RuntimeError as e:
            device = f"not measured (graph capture failed: {e})"
        print(f"{name}: events {cuda_ms(fn, 20):.4f} ms, device {device} "
              f"({_device.__file__})")


_TUNERS = {"settle": tune_settle, "project": tune_project, "score": tune_score,
           "blur": tune_blur, "conv": tune_conv, "wrappers": time_wrappers}


def main(argv) -> int:
    if len(argv) < 1 or argv[0] not in _TUNERS:
        print(__doc__)
        return 2
    _TUNERS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
