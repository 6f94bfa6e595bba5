"""Exporters: tabular outputs.

Port of ``tissue_image_processing_tpu/core/export.py``, ``write_table`` only:
``stats/`` writes its tables through it. The module's other exporters (matlab
structs, label / type TIFFs, npy bundles, simulation and event-statistics
dumps) take a ``Tissue`` and reach ``viz/overlays.py``, and come with the port
of ``core/tissue.py``. ``write_table`` needs no pandas import of its own: it
calls the methods of the DataFrame it is given.
"""

from __future__ import annotations

__all__ = ["write_table"]


def write_table(df, path: str) -> str:
    """Excel if openpyxl is available, CSV otherwise; returns the path written."""
    if path.endswith(".xlsx"):
        try:
            df.to_excel(path, index=False)
            return path
        except Exception:
            path = path.replace(".xlsx", ".csv")
    df.to_csv(path, index=False)
    return path
