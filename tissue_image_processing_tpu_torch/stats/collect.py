"""Cross-experiment sample collection.

Rebuild of the reference ``DataCollector`` (``statistical_analysis.py:18-165``):
loads feature columns from pickled result DataFrames across experiment folders,
slices by biological-repeat groups, normalizes, and exports group means/SEs.

Copied from ``tissue_image_processing_tpu/stats/collect.py``: host code, the
same functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

__all__ = ["DataCollector"]


class DataCollector:
    """Collects one feature across experiment folders.

    Each folder holds pickled DataFrames (as produced by
    ``save_event_statistics_data`` / the plot-window exporters); ``pattern``
    selects which pickles to read.
    """

    def __init__(self, folders: Sequence[str], pattern: str,
                 feature: str, group_labels: Optional[Sequence[str]] = None):
        self.folders = list(folders)
        self.pattern = pattern
        self.feature = feature
        self.group_labels = list(group_labels or [os.path.basename(f.rstrip("/"))
                                                  for f in folders])
        self.samples: Dict[str, np.ndarray] = {}
        self.collect()

    def collect(self) -> "DataCollector":
        for folder, label in zip(self.folders, self.group_labels):
            values: List[np.ndarray] = []
            for path in sorted(glob(os.path.join(folder, self.pattern))):
                try:
                    df = pd.read_pickle(path)
                except Exception:
                    continue
                if isinstance(df, pd.DataFrame) and self.feature in df.columns:
                    v = pd.to_numeric(df[self.feature], errors="coerce").to_numpy()
                    values.append(v[~np.isnan(v)])
            self.samples[label] = (np.concatenate(values)
                                   if values else np.empty((0,)))
        return self

    def normalized(self, by: str = "mean") -> Dict[str, np.ndarray]:
        out = {}
        for label, v in self.samples.items():
            denom = (np.mean(v) if by == "mean" else np.median(v)) if v.size else 1.0
            out[label] = v / denom if denom else v
        return out

    def group_stats(self) -> pd.DataFrame:
        rows = []
        for label, v in self.samples.items():
            rows.append({
                "group": label, "n": v.size,
                "mean": float(np.mean(v)) if v.size else np.nan,
                "std": float(np.std(v, ddof=1)) if v.size > 1 else np.nan,
                "se": float(np.std(v, ddof=1) / np.sqrt(v.size)) if v.size > 1 else np.nan,
                "median": float(np.median(v)) if v.size else np.nan,
            })
        return pd.DataFrame(rows)

    def ratio_of_samples(self, numerator: str, denominator: str) -> float:
        a = self.samples[numerator]
        b = self.samples[denominator]
        return float(np.mean(a) / np.mean(b)) if a.size and b.size and np.mean(b) else np.nan

    def export(self, path: str) -> str:
        from tissue_image_processing_tpu_torch.core.export import write_table
        df = pd.DataFrame({k: pd.Series(v) for k, v in self.samples.items()})
        return write_table(df, path)

    def export_npy(self, path: str) -> None:
        np.save(path, {k: v for k, v in self.samples.items()}, allow_pickle=True)
