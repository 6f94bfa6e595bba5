"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the card(s) the cell asks
for. A run:

1. makes the cell's two movies from the seed on the card (``movies.py``,
   parameters from ``traffic/<traffic>.json``) and copies them to the host;
2. builds the system under test (``programs/<program>.py`` of the
   configuration file named in ``BENCHMARK.json``) and calls it once on each
   movie, which builds or loads every kernel: all of this is ``setup_s``,
   counted from the start of the process;
3. calls it on whole movies, alternating between the two, back to back
   until ``--seconds`` have passed (the last call ends after): a closed
   loop of one client. With ``--trace 1`` every call records the program's
   stage spans and the first two calls run under ``torch.profiler``;
4. once the window has closed, compares the outputs of one call drawn from
   the seed among the first four with the plain reference
   (``reference/``), each number against its limit from the configuration
   file, and computes the metrics, each by its reader in ``metrics/``.

Context goes to standard output first, the compared numbers to standard
error last, and the result as one JSON object on the last line of standard
output. Nothing is printed as a result, and the exit code is not 0, when the
card is missing, when fewer cards are visible than the cell asks for, or
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the JAX side of the repository and what would load it: compared by the
# whole top-level module name (the port's name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tissue_image_processing_tpu")
TRACED_CALLS = 2
SAMPLED_AMONG = 4
_SMI_QUERY = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that belong to the JAX side."""
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, workload: str):
    """(cell, configuration entry) of ``workload``; KeyError if absent."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return cell, configs[cell["config"]]


def metrics_of(spec: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]


def reader(root: Path, name: str) -> Callable:
    """``read(ctx, name)`` of metric ``name``: ``metrics/<name>.py``, else
    the family's ``metrics/<first part of the name>.py``."""
    base = root / "benchmark" / "metrics"
    for stem in (name, name.split(".", 1)[0]):
        path = base / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"benchmark.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {base}")


def derived_seeds(seed: int, movies: int) -> Dict[str, object]:
    """Independent seeds of the run's parts, all from ``--seed``: one a
    movie, and the call whose outputs are compared."""
    import numpy as np

    state = np.random.SeedSequence(int(seed) % 2 ** 64).generate_state(
        movies + 1, dtype=np.uint32)
    return {"movies": [int(v) for v in state[:movies]],
            "sampled_call": int(state[movies]) % SAMPLED_AMONG}


@dataclass
class Context:
    """What the metric readers read."""

    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    frames: int
    peak_bytes: int
    timings: Optional[Dict[str, float]] = None
    trace: Optional[object] = None
    traced_frames: int = 0
    blur_launches: Dict[tuple, int] = field(default_factory=dict)


class _Sampler:
    """``nvidia-smi`` sampling clocks and power beside the window, one
    process, every 2 s; a no-op where the tool is missing."""

    def __init__(self, on: bool):
        self.proc = None
        if on:
            try:
                self.proc = subprocess.Popen(
                    ["nvidia-smi", f"--query-gpu={_SMI_QUERY}",
                     "--format=csv,noheader,nounits", "-lms", "2000"],
                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                    text=True)
            except OSError:
                self.proc = None

    def stop(self) -> str:
        if self.proc is None:
            return "clocks and power beside the window: not sampled"
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = [[v.strip() for v in line.split(",")]
                for line in out.splitlines() if line.count(",") == 3]
        if not rows:
            return "clocks and power beside the window: no sample"
        cols = list(zip(*rows))
        names = _SMI_QUERY.split(",")
        return ("clocks and power beside the window (nvidia-smi, "
                f"{len(rows)} samples): " + "; ".join(
                    f"{n} {min(c, key=_num)}..{max(c, key=_num)}"
                    for n, c in zip(names, cols)))


def _num(v: str) -> float:
    try:
        return float(v)
    except ValueError:
        return float("nan")


def card_line(torch) -> str:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.split("\n")[0]
    except (OSError, subprocess.TimeoutExpired):
        limit = "power.limit not read"
    return (f"card: {name} x {torch.cuda.device_count()} visible, "
            f"power.limit {limit.strip()}")


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", control: bool = False,
             least_calls: int = max(SAMPLED_AMONG, TRACED_CALLS) + 1,
             spec: Optional[dict] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None, out=None, err=None) -> dict:
    """One run of ``workload``; returns the result object after printing
    it. ``device="cpu"`` runs the plain route, and ``spec``, ``config`` and
    ``traffic`` stand in for the files (the tests' dry run at a small
    size); ``control`` puts the configuration's control in the program's
    place and ``least_calls`` cuts the window short once the compared call
    has run (``readings.py``; never in a benchmark run)."""
    import torch

    out = out or sys.stdout
    err = err or sys.stderr
    spec = spec or load_json(root / "BENCHMARK.json")
    cell, cfg_entry = find_cell(spec, workload)
    config = config or load_json(root / cfg_entry["file"])
    traffic = traffic or load_json(root / "benchmark" / "traffic"
                                   / f"{cell['traffic']}.json")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    seeds = derived_seeds(seed, int(traffic["movies"]))
    from benchmark.movies import make_movie
    from tissue_image_processing_tpu_torch import _device as port_device

    frames = int(config["frames"])
    marks = [("start", time.perf_counter())]
    movies = [make_movie(traffic, frames, s, dev) for s in seeds["movies"]]
    marks.append(("movies", time.perf_counter()))
    programs = importlib.import_module(f"benchmark.programs."
                                       f"{config['program']}")
    make = programs.control if control else programs.Program
    program = make(config, movies, dev)
    marks.append(("program", time.perf_counter()))
    for movie in movies:
        program(movie)
    if on_card:
        torch.cuda.synchronize()
    marks.append(("warm-up calls", time.perf_counter()))
    setup_s = marks[-1][1] - _START
    parts = {name: b - a for (_, a), (name, b) in
             zip([("", _START)] + marks, marks)}

    prof = mark = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark.trace import WINDOW_MARK
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.start()
        mark = record_function(WINDOW_MARK)
    timings = {} if trace else None
    port_device.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sampler = _Sampler(on_card)
    kept = None
    calls = failed = done_frames = 0
    call_s = []
    traced = {}
    t0 = time.perf_counter()
    while True:
        if trace and calls == 0:
            mark.__enter__()
        movie = movies[calls % len(movies)]
        c0 = time.perf_counter()
        try:
            res = (program.kept_call(movie, timings)
                   if calls == seeds["sampled_call"] else
                   program(movie, timings))
            done_frames += frames
            if program.overflowed(res):
                failed += 1
                print(f"call {calls}: a frame's cells overflow the tables",
                      file=err)
        except Exception:  # a failed call is counted, the window goes on
            res = None
            failed += 1
            traceback.print_exc(file=err)
        call_s.append(time.perf_counter() - c0)
        if calls == seeds["sampled_call"]:
            kept = (calls % len(movies), res)
        calls += 1
        if trace and calls == TRACED_CALLS:
            if on_card:
                torch.cuda.synchronize()
            mark.__exit__(None, None, None)
            prof.stop()
            traced = {"frames": TRACED_CALLS * frames,
                      "blur": dict(port_device.BLUR_LAUNCHES)}
        # by default a call after the compared one, so that the window's
        # memory peak holds the kept outputs in every run
        if (time.perf_counter() - t0 >= seconds and kept is not None
                and calls >= least_calls):
            break
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    smi = sampler.stop()
    launches = {k: v / calls for k, v in port_device.LAUNCHES.items() if v}
    forms = {k: v / calls for k, v in port_device.BLUR_FORMS.items()}
    shapes = {str(k): v / calls for k, v in port_device.BLUR_LAUNCHES.items()}

    from benchmark.trace import read_profile
    tr = read_profile(prof) if trace else None
    del prof
    ctx = Context(config=config, traffic=traffic, setup_s=setup_s,
                  window_s=window_s, frames=done_frames, peak_bytes=peak,
                  timings=timings, trace=tr,
                  traced_frames=traced.get("frames", 0),
                  blur_launches=traced.get("blur", {}))
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, workload, section):
        value = reader(root, m["name"])(ctx, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    idx, kept_out = kept if kept else (0, None)
    cells = []
    if kept_out is not None:
        cells = [int(v) for v in kept_out["tables"].valid_mask().sum(1)]
    program.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    limits = config["limits"]
    numbers = ({k: float("inf") for k in limits} if kept_out is None
               else program.check(movies[idx], kept_out))
    del kept_out, kept
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in limits)

    lines = [card_line(torch) if on_card else f"device: {dev}", smi,
             f"host: {os.cpu_count()} CPUs, torch threads "
             f"{torch.get_num_threads()}",
             f"seeds: --seed {seed} -> movie seeds {seeds['movies']}; "
             f"compared call {seeds['sampled_call']}",
             f"movies: {len(movies)} of {movies[0].shape} uint16 "
             f"({movies[0].nbytes} bytes each); set-up {setup_s!r} s: "
             f"{parts}",
             f"window: {calls} calls, {done_frames} frames, {window_s!r} s, "
             f"{failed} failed; seconds a call {[round(c, 4) for c in call_s]}",
             f"cells a frame (compared call): {cells}",
             f"kernel launches a movie: {launches}; blur3d by form {forms}; "
             f"by (Z, Y, X, tz, ty, tx) {shapes}",
             f"every number of the compared call: {numbers}",
             *program.context()]
    if trace:
        lines.append(f"stage seconds over the window: {timings}")
    found = forbidden_modules()
    if found:
        print(f"JAX side loaded in the benchmark's process: {found}", file=err)
        raise SystemExit(3)
    for line in lines:
        print(line, file=out)
    result = {"correct": correct, "attempted": calls, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    for k in limits:
        print(f"check {k}: {numbers[k]!r} (limit {limits[k]!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell, _ = find_cell(spec, args.workload)

    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from tissue_image_processing_tpu_torch.utils.runtime import (
        enable_compilation_cache)
    enable_compilation_cache(str(ROOT / "build" / "torch_kernels"))
    run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
