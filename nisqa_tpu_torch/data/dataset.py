"""Speech-quality datasets over a small column table, without pandas.

Counterpart of ``nisqa_tpu/data/dataset.py``: the dataset is a host-side
view (paths + targets) of a CSV; feature extraction runs in the engine.
:class:`Table` stands in for the DataFrame: ordered columns of 1-D numpy
arrays, read and written as ``pd.read_csv`` / ``DataFrame.to_csv(index=False)``
read and write them:

  * a column whose cells are all integers is int64, all numbers (or some
    empty) float64, all ``True``/``False`` bool, else an object column of str;
  * empty cells and pandas' default NA strings ("NA", "nan", "null", ...)
    are NaN;
  * floats are written in their shortest round-trip form, NaN as an empty
    cell.
"""

from __future__ import annotations

import csv
import math
import os
import re

import numpy as np

DIM_COLS = ("mos", "noi", "dis", "col", "loud")

# pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\s*",
                    re.IGNORECASE)
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def is_na(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _column(cells):
    """One CSV column's cells (str) -> numpy array, typed as pandas types it."""
    vals = [c for c in cells if c not in NA_STRINGS]
    if len(vals) == len(cells) and vals and all(_INT.fullmatch(c) for c in vals):
        ints = [int(c) for c in vals]
        if all(-(1 << 63) <= v < (1 << 63) for v in ints):
            return np.array(ints, dtype=np.int64)
    if all(_FLOAT.fullmatch(c) for c in vals):
        return np.array([float(c) if c not in NA_STRINGS else np.nan for c in cells], np.float64)
    if len(vals) == len(cells) and all(c in _TRUE or c in _FALSE for c in vals):
        return np.array([c in _TRUE for c in cells], dtype=bool)
    out = np.empty(len(cells), dtype=object)
    out[:] = [np.nan if c in NA_STRINGS else c for c in cells]
    return out


def _cell(v) -> str:
    if is_na(v):
        return ""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


class Table:
    """Ordered columns ``{name: 1-D numpy array}`` of one length."""

    def __init__(self, columns: dict | None = None):
        self._cols = {k: np.asarray(v) for k, v in (columns or {}).items()}

    @classmethod
    def read_csv(cls, path) -> "Table":
        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f) if r]
        if not rows:
            raise ValueError(f"No columns to parse from file {path}")
        header, body = rows[0], rows[1:]
        cols = {}
        for j, name in enumerate(header):
            cols[name or f"Unnamed: {j}"] = _column([r[j] if j < len(r) else "" for r in body])
        return cls(cols)

    def to_csv(self, path):
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            w.writerows([_cell(v) for v in row] for row in zip(*self._cols.values()))

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __len__(self):
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name):
        return name in self._cols

    def __getitem__(self, name):
        return self._cols[name]

    def __setitem__(self, name, values):
        """A new column goes last, an existing one keeps its place; a scalar
        fills the column."""
        if np.ndim(values) == 0:
            col = np.empty(len(self), dtype=object if isinstance(values, str) else None)
            col[:] = values
            values = col
        values = np.asarray(values)
        if self._cols and len(values) != len(self):
            raise ValueError(f"column {name!r} has {len(values)} rows, the table {len(self)}")
        self._cols[name] = values

    def rows(self, mask) -> "Table":
        """The rows where ``mask`` is true, as a new table."""
        return Table({k: v[mask] for k, v in self._cols.items()})

    def to_string(self) -> str:
        cells = [[_cell(v) for v in col] for col in self._cols.values()]
        widths = [max([len(k)] + [len(c) for c in col]) for k, col in zip(self._cols, cells)]
        lines = [" ".join(k.rjust(w) for k, w in zip(self._cols, widths))]
        lines += [" ".join(c.rjust(w) for c, w in zip(row, widths)) for row in zip(*cells)]
        return "\n".join(lines)


class SpeechDataset:
    """Paths and targets of a :class:`Table` (the JAX package's
    ``SpeechDataset`` over a DataFrame): a single ``mos_column``, the five
    dimension columns for DIM models, or NaN in predict-only mode."""

    def __init__(self, df: Table, df_con: Table | None = None, data_dir: str = "",
                 filename_column: str = "deg", mos_column: str = "mos",
                 filename_column_ref: str | None = None, dim: bool = False,
                 double_ended: bool = False):
        self.df = df
        self.df_con = df_con
        self.data_dir = data_dir
        self.filename_column = filename_column
        self.filename_column_ref = filename_column_ref
        self.mos_column = mos_column
        self.dim = dim
        self.double_ended = double_ended

    def __len__(self):
        return len(self.df)

    def paths(self):
        return [os.path.join(self.data_dir, f) for f in self.df[self.filename_column]]

    def paths_ref(self):
        if not self.double_ended:
            return None
        return [os.path.join(self.data_dir, f) for f in self.df[self.filename_column_ref]]

    def targets(self) -> np.ndarray:
        """(N, 5) for dim models, else (N, 1); NaN in predict-only mode."""
        n = len(self.df)
        if self.dim:
            if self.mos_column == "predict_only":
                return np.full((n, 5), np.nan, dtype=np.float32)
            return np.stack([self.df[c].astype(np.float32) for c in DIM_COLS], axis=1)
        if self.mos_column == "predict_only":
            return np.full((n, 1), np.nan, dtype=np.float32)
        return self.df[self.mos_column].astype(np.float32).reshape(-1, 1)

    def write_predictions(self, y_hat: np.ndarray):
        """The ``*_pred`` columns, float64, as the reference writes them."""
        if self.dim:
            for j, c in enumerate(DIM_COLS):
                self.df[f"{c}_pred"] = y_hat[:, j].astype(float)
        else:
            self.df["mos_pred"] = y_hat[:, 0].astype(float)
