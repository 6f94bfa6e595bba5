"""Cross-experiment statistical comparison driver, on the PyTorch port.

The port's version of ``examples/compare_experiments.py``: the same
arguments, config and output files, with ``tissue_image_processing_tpu_torch``'s
``stats/`` and ``core/export``. The statistics are host code (numpy and
scipy) in both packages; ``main(argv, device=None)`` checks the device as
the port's CLI does (``None``: the CUDA card; raises without one before any
file is read; ``device="cpu"`` for the plain route).

Parametrized replacement for the reference's ~45 hard-coded paper-figure scripts
(``combine_results.py:81-2523``): collect a feature across condition folders, run the
appropriate statistical comparison, and emit plots + tables. Conditions and folders
come from a JSON config instead of hard-coded experiment lists
(``combine_results.py:18-78``).

Config format:
{
  "conditions": {"E17.5": ["/data/e17_1", "/data/e17_2"],
                  "P0":    ["/data/p0_1"]},
  "pattern": "area_and_roundness_division*_data",
  "feature": "area",
  "output": "out/"
}
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tissue_image_processing_tpu_torch._device import resolve_device  # noqa: E402


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    p.add_argument("--kind", default="violin",
                   choices=["violin", "bar", "box", "histogram"])
    p.add_argument("--hierarchical", action="store_true",
                   help="treat each folder as a biological repeat")
    args = p.parse_args(argv)
    resolve_device(device)
    with open(args.config) as f:
        cfg = json.load(f)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from tissue_image_processing_tpu_torch.stats.collect import DataCollector
    from tissue_image_processing_tpu_torch.stats.compare import (
        HierarchicalTwoSamplesCompare)
    from tissue_image_processing_tpu_torch.stats.plots import compare_and_plot_samples

    outdir = cfg.get("output", ".")
    os.makedirs(outdir, exist_ok=True)
    samples = {}
    per_repeat = {}
    for cond, folders in cfg["conditions"].items():
        dc = DataCollector(folders, cfg["pattern"], cfg["feature"],
                           group_labels=[f"{cond}_{i}" for i in range(len(folders))])
        per_repeat[cond] = list(dc.samples.values())
        samples[cond] = np.concatenate([v for v in dc.samples.values()]) \
            if dc.samples else np.empty((0,))

    fig, ax = plt.subplots(figsize=(1.5 * len(samples) + 2, 4))
    ax, results = compare_and_plot_samples(samples, kind=args.kind,
                                           ylabel=cfg["feature"])
    fig.savefig(os.path.join(outdir, f"{cfg['feature']}_compare.png"), dpi=150)
    plt.close(fig)

    rows = []
    for (a, b), r in results.items():
        rows.append({"pair": f"{a} vs {b}", **{k: v for k, v in r.items()
                                               if not isinstance(v, np.ndarray)}})
    if args.hierarchical and len(per_repeat) == 2:
        (c1, g1), (c2, g2) = per_repeat.items()
        hier = HierarchicalTwoSamplesCompare(g1, g2).result
        rows.append({"pair": f"{c1} vs {c2} (hierarchical)", **hier})
    import pandas as pd
    from tissue_image_processing_tpu_torch.core.export import write_table
    table_path = write_table(pd.DataFrame(rows),
                             os.path.join(outdir, f"{cfg['feature']}_stats.csv"))
    print(f"wrote {table_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
