"""Readings of a cell's compared numbers on many seeds, on the card at the
cell's own size, in one process: the program's (the lower readings that a
limit is set above) or, with ``--control``, the control's in the program's
place (the program's int8 U-Net, or the plain reference a step of precision
below float32), which has to fail at least one number.

    python3 benchmark/readings.py --workload NAME --seeds N [N ...] [--control]

Each run stops once its compared call has run; the numbers print as in a
benchmark run. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from tissue_image_processing_tpu_torch.utils.runtime import (
        enable_compilation_cache)
    enable_compilation_cache(str(ROOT / "build" / "torch_kernels"))
    verdicts = []
    for seed in args.seeds:
        res = run_cell(ROOT, args.workload, seed, 0.0, False,
                       control=args.control, least_calls=0)
        verdicts.append(res["correct"])
        torch.cuda.empty_cache()
    print(f"{'control' if args.control else 'program'} of {args.workload}: "
          f"correct on {sum(verdicts)} of {len(verdicts)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
