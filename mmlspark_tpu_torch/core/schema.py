"""Image columns (own copy of the image-struct helpers of
``mmlspark_tpu.core.schema`` and ``mmlspark_tpu.data.table``).

An image cell is a dict with the ``IMAGE_FIELDS`` keys: decoded HWC uint8
BGR pixels (OpenCV's order) in ``data``. A column is marked as an image
column in the table's per-column metadata (``DataTable.meta``) under
``K_IMAGE``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.data.table import DataTable

IMAGE_FIELDS = ("path", "height", "width", "channels", "data")
K_IMAGE = "is_image"


def _is_missing(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, (float, np.floating)):
        return bool(np.isnan(v))
    return False


def make_image(path: str, array_hwc: np.ndarray) -> dict[str, Any]:
    a = np.ascontiguousarray(array_hwc, dtype=np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    return {"path": path, "height": a.shape[0], "width": a.shape[1],
            "channels": a.shape[2], "data": a}


def is_image_column(table: DataTable, column: str) -> bool:
    if table.meta.get(column, {}).get(K_IMAGE):
        return True
    col = table[column]
    if col.dtype != object:
        return False
    # the first non-missing cell decides: a leading None (a failed decode,
    # a missing row) must not hide an image column
    for v in col:
        if _is_missing(v):
            continue
        if isinstance(v, dict):
            return set(IMAGE_FIELDS).issubset(v.keys())
        return False
    return False


def mark_image_column(table: DataTable, column: str) -> DataTable:
    return table.with_column(column, table[column],
                             meta={**table.meta.get(column, {}),
                                   K_IMAGE: True})


def find_unused_column_name(table: DataTable, base: str) -> str:
    name = base
    i = 1
    while name in table.columns:
        name = f"{base}_{i}"
        i += 1
    return name
