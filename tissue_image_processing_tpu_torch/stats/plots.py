"""Comparison plotting (reference ``compare_and_plot_samples`` +
``barplot_annotate_brackets``, ``statistical_analysis.py:887-1155``): violin / bar /
box / histogram panels with jittered scatter, SE bars and p-value brackets.

Copied from ``tissue_image_processing_tpu/stats/plots.py``: host code, the
same functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from tissue_image_processing_tpu_torch.stats.compare import TwoSampleCompare

__all__ = ["compare_and_plot_samples", "barplot_annotate_brackets"]


def barplot_annotate_brackets(ax, num1: int, num2: int, text, centers, heights,
                              dh: float = 0.05, barh: float = 0.05, fs=None):
    """Significance bracket between bars (reference
    ``statistical_analysis.py:887-948``)."""
    if isinstance(text, (int, float)):
        stars = ""
        p = 0.05
        while text < p and len(stars) < 4:
            stars += "*"
            p /= 10.0
        text = stars if stars else "n.s."
    lx, ly = centers[num1], heights[num1]
    rx, ry = centers[num2], heights[num2]
    ax_y0, ax_y1 = ax.get_ylim()
    dh *= (ax_y1 - ax_y0)
    barh *= (ax_y1 - ax_y0)
    y = max(ly, ry) + dh
    ax.plot([lx, lx, rx, rx], [y, y + barh, y + barh, y], c="black")
    kwargs = {"ha": "center", "va": "bottom"}
    if fs is not None:
        kwargs["fontsize"] = fs
    ax.text((lx + rx) / 2, y + barh, text, **kwargs)


def compare_and_plot_samples(samples: Dict[str, np.ndarray],
                             kind: str = "violin",
                             ylabel: str = "",
                             ax=None,
                             pairs: Optional[Sequence[tuple]] = None,
                             alpha: float = 0.05):
    """Plot grouped samples and annotate pairwise test p-values.

    kind: violin | bar | box | histogram. Returns (ax, results_dict).
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    labels = list(samples.keys())
    data = [np.asarray(samples[k], float) for k in labels]
    if ax is None:
        _, ax = plt.subplots()
    centers = np.arange(len(labels), dtype=float)
    heights = []
    rng = np.random.default_rng(0)
    if kind == "violin":
        ax.violinplot(data, positions=centers, showextrema=False)
        for c, d in zip(centers, data):
            jitter = rng.uniform(-0.08, 0.08, d.size)
            ax.plot(c + jitter, d, ".", ms=3, alpha=0.5, color="k")
            heights.append(d.max() if d.size else 0)
    elif kind == "bar":
        means = [d.mean() if d.size else 0 for d in data]
        ses = [d.std(ddof=1) / np.sqrt(d.size) if d.size > 1 else 0 for d in data]
        ax.bar(centers, means, yerr=ses, capsize=6, alpha=0.6)
        heights = [m + s for m, s in zip(means, ses)]
    elif kind == "box":
        ax.boxplot(data, positions=centers)
        heights = [d.max() if d.size else 0 for d in data]
    elif kind == "histogram":
        for label, d in zip(labels, data):
            ax.hist(d, bins=20, alpha=0.5, label=label, density=True)
        ax.legend()
        heights = [0] * len(labels)
    ax.set_xticks(centers)
    ax.set_xticklabels(labels)
    if ylabel:
        ax.set_ylabel(ylabel)
    results = {}
    if kind != "histogram":
        pairs = pairs or [(i, j) for i in range(len(labels))
                          for j in range(i + 1, len(labels))]
        for k, (i, j) in enumerate(pairs):
            cmp = TwoSampleCompare(data[i], data[j], (labels[i], labels[j]), alpha)
            results[(labels[i], labels[j])] = cmp.result
            barplot_annotate_brackets(ax, i, j, cmp.result["p_value"], centers,
                                      heights, dh=0.05 + 0.08 * k)
    return ax, results
