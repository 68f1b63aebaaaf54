"""DataTable — the columnar table the port's stages consume and produce.

The port's own copy of the subset of ``mmlspark_tpu/data/table.py`` that
model scoring and serving use: an ordered mapping column name → 1-D numpy
column (numeric, or ``object`` for row vectors, images and strings) with a
per-column metadata dict. Tables are treated as immutable: every update
returns a new table sharing the untouched columns.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _object_column(values: Any) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _as_column(values: Any) -> np.ndarray:
    """Coerce input values to a 1-D numpy column (object dtype if ragged)."""
    if isinstance(values, np.ndarray):
        if values.ndim == 1:
            return values
        # 2-D numeric arrays become object columns of row vectors
        return _object_column(values)
    values = list(values)
    if not values:
        return np.empty(0, dtype=object)
    first = values[0]
    if isinstance(first, (str, bytes, dict, list, tuple, np.ndarray)) \
            or first is None:
        return _object_column(values)
    arr = np.asarray(values)
    if arr.ndim != 1:
        return _object_column(values)
    return arr


class DataTable:
    """An ordered mapping column-name → 1-D column, with per-column metadata."""

    def __init__(self, columns: Mapping[str, Any] | None = None,
                 meta: Mapping[str, Mapping[str, Any]] | None = None):
        self._cols: dict[str, np.ndarray] = {}
        n = None
        for name, values in (columns or {}).items():
            col = _as_column(values)
            if n is None:
                n = len(col)
            elif len(col) != n:
                raise ValueError(
                    f"column {name!r} has {len(col)} rows, expected {n}")
            self._cols[name] = col
        self._nrows = n or 0
        self.meta: dict[str, dict[str, Any]] = {
            k: dict(v) for k, v in (meta or {}).items() if k in self._cols
        }

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._nrows

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(
                f"no column {name!r}; available: {self.columns}")
        return self._cols[name]

    def __repr__(self) -> str:
        cols = ", ".join(f"{k}:{v.dtype}" for k, v in self._cols.items())
        return f"DataTable[{self._nrows} rows; {cols}]"

    def with_column(self, name: str, values: Any,
                    meta: Mapping[str, Any] | None = None) -> "DataTable":
        col = _as_column(values)
        if self._cols and len(col) != self._nrows:
            raise ValueError(
                f"column {name!r} has {len(col)} rows, expected {self._nrows}")
        out = DataTable.__new__(DataTable)
        out._cols = {**self._cols, name: col}
        out._nrows = len(col) if not self._cols else self._nrows
        out.meta = {k: dict(v) for k, v in self.meta.items()}
        if meta is not None:
            out.meta[name] = dict(meta)
        return out

    def take(self, indices: Any) -> "DataTable":
        """Row subset/reorder by integer indices or boolean mask."""
        indices = np.asarray(indices)
        if indices.dtype == bool:
            indices = np.flatnonzero(indices)
        elif not np.issubdtype(indices.dtype, np.integer):
            indices = indices.astype(np.intp)  # e.g. empty list → float64
        return DataTable({k: v[indices] for k, v in self._cols.items()},
                         self.meta)

    def concat(self, *others: "DataTable") -> "DataTable":
        """This table's rows followed by every other table's, in one pass
        per column (pairwise concatenation would re-copy the accumulated
        rows once per table)."""
        tables = (self,) + others
        for t in others:
            if set(t.columns) != set(self.columns):
                raise ValueError(
                    f"column mismatch: {self.columns} vs {t.columns}")
        cols = {}
        for k in self.columns:
            parts = [t._cols[k] for t in tables]
            if any(p.dtype == object for p in parts):
                merged = np.empty(sum(len(p) for p in parts), dtype=object)
                offset = 0
                for p in parts:
                    merged[offset:offset + len(p)] = p
                    offset += len(p)
                cols[k] = merged
            else:
                cols[k] = np.concatenate(parts)
        meta: dict[str, dict[str, Any]] = {}
        for t in reversed(tables):
            meta.update(t.meta)
        return DataTable(cols, meta)

    def column_matrix(self, name: str, dtype: Any = np.float32) -> np.ndarray:
        """Stack a column of equal-length vectors/scalars into a 2-D matrix
        with one contiguous host copy, ready for the device transfer."""
        col = self[name]
        if col.dtype != object:
            return (col.astype(dtype)[:, None] if col.ndim == 1
                    else col.astype(dtype))
        if self._nrows == 0:
            return np.empty((0, 0), dtype=dtype)
        return np.stack([np.asarray(v, dtype=dtype).reshape(-1) for v in col])
