"""Event-rate comparison across conditions with 2x2 factorial statistics,
on the PyTorch port.

The port's version of ``examples/event_rates.py``: the same arguments,
config and output files, with ``tissue_image_processing_tpu_torch``'s
``Tissue``, ``stats/`` and ``core/plotting``. ``main(argv, device=None)``:
sessions load onto ``device`` (``None``: the CUDA card; raises without one
before any file is read; ``device="cpu"`` for the plain route).

Parametrized replacement for the reference's hard-coded event bar charts
(``combine_results.py:1851-1948``: E17.5/P0 x normal/ablation event counts
normalized by movie duration x tissue area, compared with TwoByTwoCompare).

Counts come either from .seg sessions (events are counted per type) or straight
from a JSON config:

{
  "factors": ["age", "treatment"],
  "groups": {
    "E17.5/normal":   {"counts": [32, 27, 59], "hours": [48, 46, 30],
                        "area_um2": [327040, 300160, 328320]},
    "E17.5/ablation": {"sessions": ["a1.seg", "a2.seg"],
                        "hours": [36, 50], "area_um2": [252520, 320580]},
    "P0/normal":      {...}, "P0/ablation": {...}
  },
  "event_type": "differentiation",
  "output": "out/"
}

Rates are events / (day * (100 um)^2), like the reference. With exactly four
groups forming a 2x2 design, a two-way ANOVA (or Scheirer-Ray-Hare) runs via
``TwoByTwoCompare``; otherwise every pair gets a ``TwoSampleCompare``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tissue_image_processing_tpu_torch._device import resolve_device  # noqa: E402


def count_events_in_session(path: str, event_type: str, device) -> int:
    from tissue_image_processing_tpu_torch.core.tissue import Tissue

    t = Tissue(1, path, device=device)
    for _ in t.load(path):
        pass
    ev = t.events
    n = int((ev["type"] == event_type).sum()) if len(ev) else 0
    t.clean_up()
    return n


def group_rates(spec: dict, event_type: str, device) -> np.ndarray:
    if "counts" in spec:
        counts = np.asarray(spec["counts"], float)
    else:
        counts = np.array([count_events_in_session(p, event_type, device)
                           for p in spec["sessions"]], float)
    days = np.asarray(spec["hours"], float) / 24.0
    area = np.asarray(spec["area_um2"], float) / 1e4  # (100 um)^2
    return counts / (days * area)


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    args = p.parse_args(argv)
    dev = resolve_device(device)
    with open(args.config) as f:
        cfg = json.load(f)
    event_type = cfg.get("event_type", "differentiation")
    out = cfg.get("output", ".")
    os.makedirs(out, exist_ok=True)

    rates = {name: group_rates(spec, event_type, dev)
             for name, spec in cfg["groups"].items()}

    results = {}
    names = list(rates)
    if len(names) == 4 and all("/" in n for n in names):
        from tissue_image_processing_tpu_torch.stats.compare import TwoByTwoCompare

        samples = {tuple(n.split("/", 1)): rates[n] for n in names}
        a_levels = sorted({k[0] for k in samples})
        b_levels = sorted({k[1] for k in samples})
        keyed = {(a_levels.index(a), b_levels.index(b)): v
                 for (a, b), v in samples.items()}
        r = TwoByTwoCompare(keyed).result
        results["design"] = "2x2"
        results["method"] = r["method"]
        results["table"] = r["table"].to_dict()
        print(r["method"])
        print(r["table"].to_string())
    else:
        from tissue_image_processing_tpu_torch.stats.compare import TwoSampleCompare

        results["design"] = "pairwise"
        for n1, n2 in itertools.combinations(names, 2):
            r = TwoSampleCompare(rates[n1], rates[n2], labels=(n1, n2)).result
            results[f"{n1} vs {n2}"] = {
                "test": r["test"], "p_value": r["p_value"]}
            print(f"{n1} vs {n2}: {r['test']} p={r['p_value']:.4g}")

    # bar chart with per-repeat scatter, reference style
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from tissue_image_processing_tpu_torch.core.plotting import save_figure_with_data

    fig, ax = plt.subplots(figsize=(1.5 * len(names) + 2, 4))
    xs = np.arange(len(names))
    means = [rates[n].mean() for n in names]
    ses = [rates[n].std(ddof=1) / np.sqrt(len(rates[n])) if len(rates[n]) > 1
           else 0.0 for n in names]
    ax.bar(xs, means, yerr=ses, capsize=4, color="#8dbad9")
    for i, n in enumerate(names):
        ax.scatter(np.full(len(rates[n]), i) +
                   np.random.default_rng(0).uniform(-0.1, 0.1, len(rates[n])),
                   rates[n], color="k", zorder=3, s=14)
    ax.set_xticks(xs, names, rotation=20, ha="right")
    ax.set_ylabel(f"{event_type} events / (day x (100um)^2)")
    import pandas as pd
    df = pd.DataFrame({n: pd.Series(rates[n]) for n in names})
    save_figure_with_data(fig, os.path.join(out, f"{event_type}_rates.png"), df)

    with open(os.path.join(out, f"{event_type}_rates_stats.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(f"wrote {out}/{event_type}_rates.png + stats")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
