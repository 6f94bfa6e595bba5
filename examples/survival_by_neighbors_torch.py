"""Differentiation rate vs number of HC neighbors (Kaplan-Meier) across
sessions, on the PyTorch port.

The port's version of ``examples/survival_by_neighbors.py``: the same
arguments and output files, with ``tissue_image_processing_tpu_torch``'s
``core/events``, ``Tissue`` and ``core/plotting``. ``main(argv,
device=None)``: sessions load onto ``device`` (``None``: the CUDA card;
raises without one before any file is read; ``device="cpu"`` for the plain
route).

Parametrized replacement for the reference's neighborhood-survival figures
(``combine_results.py`` differentiation-rate analyses built on
``calculate_events_rate_by_n_neighbors_from_type``, ``tissue_info.py:1682-1750``).

Usage: python survival_by_neighbors_torch.py out/ session1.seg session2.seg ...
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tissue_image_processing_tpu_torch._device import resolve_device  # noqa: E402


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output")
    p.add_argument("sessions", nargs="+")
    p.add_argument("--type-name", default="HC")
    p.add_argument("--event-type", default="differentiation")
    p.add_argument("--reference-frame", type=int, default=1)
    args = p.parse_args(argv)
    dev = resolve_device(device)
    os.makedirs(args.output, exist_ok=True)

    from tissue_image_processing_tpu_torch.core.events import (
        events_rate_by_n_neighbors, events_timing_by_n_neighbors)
    from tissue_image_processing_tpu_torch.core.tissue import Tissue

    per_session = []
    for path in args.sessions:
        t = Tissue(1, path, device=dev)
        for _ in t.load(path):
            pass
        timings, rates = events_rate_by_n_neighbors(
            t, args.event_type, args.reference_frame, type_name=args.type_name)
        timing_hist, abundance = events_timing_by_n_neighbors(
            t, args.event_type, args.reference_frame, type_name=args.type_name)
        per_session.append((os.path.basename(path), timings, rates,
                            timing_hist, abundance))
        t.clean_up()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    from tissue_image_processing_tpu_torch.core.plotting import save_figure_with_data

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    rows = {}
    for name, timings, rates, timing_hist, abundance in per_session:
        # one Kaplan-Meier cumulative event curve per #HC-neighbors group
        for k, curve in rates.items():
            tk = np.asarray(timings[k], float)
            ax1.step(tk, np.asarray(curve, float), where="post", alpha=0.6,
                     label=f"{name}: {k} nbrs")
            rows[f"{name}_k{k}_frame"] = pd.Series(tk)
            rows[f"{name}_k{k}_rate"] = pd.Series(np.asarray(curve, float))
        for tm in timing_hist:
            if len(tm):
                ax2.hist(np.asarray(tm, float), bins=20, alpha=0.35)
    ax1.set_xlabel("frame")
    ax1.set_ylabel(f"cumulative {args.event_type} fraction (KM)")
    ax1.legend(fontsize=6)
    ax2.set_xlabel("event frame")
    ax2.set_ylabel("count")

    out = os.path.join(args.output, "survival_by_neighbors.png")
    save_figure_with_data(fig, out, pd.DataFrame(rows))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
