"""Per-database / per-condition evaluation reports, without pandas.

Counterpart of ``nisqa_tpu/eval/report.py::eval_results`` over the port's
:class:`..data.dataset.Table`: per-db file-level metrics with a per-db
polynomial mapping, optional per-condition metrics (means over the ``con``
groups in sorted order, as ``groupby("con").mean()`` gives them, and
CI-aware RMSE*), correlation plots, and the averaged summary keys
(r_p_mean_file, rmse_map_mean_file, ... r_p_all, rmse_all). Plots import
matplotlib only when asked for.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.dataset import Table, is_na
from .metrics import apply_poly, eval_metrics, fit_mapping

_FILE_KEYS = ("r_p_file", "rmse_file", "rmse_map_file")
_CON_KEYS = ("r_p_con", "rmse_con", "rmse_map_con", "rmse_star_map_con")


def _groups(values):
    """Sorted distinct non-NaN values (a category column's categories)."""
    return sorted({v for v in values.tolist() if not is_na(v)})


def _con_mean(con, values) -> np.ndarray:
    """Mean of ``values`` per ``con`` group, NaN skipped, groups sorted."""
    out = []
    for g in _groups(con):
        v = values[con == g]
        v = v[~np.isnan(v)]
        out.append(v.mean() if len(v) else np.nan)
    return np.asarray(out, dtype=np.float64)


def _nanmean(x) -> float:
    """pandas' Series.mean: NaN skipped, NaN when nothing is left."""
    x = np.asarray(x, dtype=np.float64)
    x = x[~np.isnan(x)]
    return float(x.mean()) if len(x) else float("nan")


def eval_results(
    df: Table,
    dcon: Table | None = None,
    target_mos: str = "mos",
    target_ci: str = "mos_ci",
    pred: str = "mos_pred",
    mapping: str | None = None,
    do_print: bool = False,
    do_plot: bool = False,
    plot_dir: str | None = None,
):
    """Returns (db_results table, overall results); adds ``y_hat_map`` to ``df``."""
    rows = []
    y_hat_map_all = np.full(len(df), np.nan)

    for db_name in _groups(df["db"]):
        in_db = df["db"] == db_name
        con_db = dcon.rows(dcon["db"] == db_name) if dcon is not None else None

        r = {k: np.nan for k in _FILE_KEYS + _CON_KEYS}
        y = df[target_mos][in_db].astype(np.float64)
        y_hat = df[pred][in_db].astype(np.float64)
        have_labels = not np.isnan(y).any()

        b = None
        if have_labels:
            b, d = fit_mapping(y_hat, y, mapping)
            y_hat_map = apply_poly(y_hat, b)
            m = eval_metrics(y, y_hat, y_hat_map=y_hat_map, d=d)
            r["r_p_file"], r["rmse_file"], r["rmse_map_file"] = m["r_p"], m["rmse"], m["rmse_map"]

        b_con = None
        if (con_db is not None) and ("con" in df):
            con = df["con"][in_db]
            y_con = con_db[target_mos].astype(np.float64)
            y_con_hat = _con_mean(con, y_hat)
            if not np.isnan(y_con).any():
                ci_con = con_db[target_ci].astype(np.float64) if target_ci in con_db else None
                b_con, d = fit_mapping(y_hat, y, mapping, con_ids=con, y_con=y_con, ci=ci_con)
                mapped = apply_poly(y_hat, b_con)
                y_hat_map_all[in_db] = mapped
                y_con_hat_map = _con_mean(con, mapped)
                m = eval_metrics(y_con, y_con_hat, y_hat_map=y_con_hat_map, d=d, ci=ci_con)
                r["r_p_con"], r["rmse_con"] = m["r_p"], m["rmse"]
                r["rmse_map_con"], r["rmse_star_map_con"] = m["rmse_map"], m["rmse_star_map"]

        rows.append({"db": db_name, **r})

        if do_plot and have_labels:
            _plot_db(db_name, y, y_hat, b, target_mos, plot_dir, suffix="per_file")
            if b_con is not None:
                _plot_db(db_name, y_con, y_con_hat, b_con, target_mos, plot_dir, suffix="per_con")

        if do_print and have_labels:
            if not np.isnan(r["r_p_con"]):
                print(
                    f"{db_name + ':':<30} r_p_file: {r['r_p_file']:0.2f}, "
                    f"rmse_map_file: {r['rmse_map_file']:0.2f}, r_p_con: {r['r_p_con']:0.2f}, "
                    f"rmse_map_con: {r['rmse_map_con']:0.2f}, rmse_star_map_con: {r['rmse_star_map_con']:0.2f}"
                )
            else:
                print(
                    f"{db_name + ':':<30} r_p_file: {r['r_p_file']:0.2f}, "
                    f"rmse_map_file: {r['rmse_map_file']:0.2f}"
                )

    df["y_hat_map"] = y_hat_map_all
    keys = ("db",) + _FILE_KEYS + _CON_KEYS
    db_results = Table({k: np.array([row[k] for row in rows], dtype=object if k == "db" else None)
                        for k in keys})

    overall = {
        "r_p_mean_file": _nanmean(db_results["r_p_file"]),
        "rmse_mean_file": _nanmean(db_results["rmse_file"]),
        "rmse_map_mean_file": _nanmean(db_results["rmse_map_file"]),
    }
    con_means = ("r_p_mean_con", "rmse_mean_con", "rmse_map_mean_con", "rmse_star_map_mean_con")
    for key, col in zip(con_means, _CON_KEYS):
        overall[key] = _nanmean(db_results[col]) if dcon is not None else np.nan

    m_all = eval_metrics(df[target_mos].astype(np.float64), df[pred].astype(np.float64))
    overall["r_p_all"] = m_all["r_p"]
    overall["rmse_all"] = m_all["rmse"]
    return db_results, overall


def _plot_db(db_name, y, y_hat, b, target, plot_dir, suffix):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xx = np.arange(0, 6, 0.01)
    yy = apply_poly(xx, b) if b is not None else xx
    plt.figure(figsize=(3.0, 3.0), dpi=150)
    plt.plot(y_hat, y, "o", markersize=2, label="data")
    plt.plot([0, 5], [0, 5], "gray")
    plt.plot(xx, yy, "r", label="fit")
    plt.axis([1, 5, 1, 5])
    plt.gca().set_aspect("equal", adjustable="box")
    plt.grid(True)
    plt.xticks(np.arange(1, 6))
    plt.yticks(np.arange(1, 6))
    plt.title(f"{db_name} {suffix}")
    plt.ylabel(f"Subjective {target.upper()}")
    plt.xlabel(f"Predicted {target.upper()}")
    out_dir = plot_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    plt.savefig(os.path.join(out_dir, f"corr_{db_name}_{suffix}.png"), bbox_inches="tight")
    plt.close()
