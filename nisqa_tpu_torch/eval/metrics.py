"""Evaluation metrics and polynomial MOS mappings (host-side).

Behavioural parity with the original NISQA's `nisqa/NISQA_lib.py:1469-1685`:
Pearson's r with constant-vector guard, RMSE with the ITU-T P.1401 degrees-
of-freedom correction (Eq 7-29), epsilon-insensitive RMSE* against the
condition confidence interval (Eq 7-27), least-squares first/second/third
order mappings, and the SLSQP monotonic third-order fit.

Metrics stay on the host (numpy/scipy): they run once per epoch/eval on tiny
vectors, so there is nothing for the card to accelerate here.

The port's copy of ``nisqa_tpu/eval/metrics.py`` (same functions, same
code), so the port imports nothing of the JAX package; a test holds the two
equal.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize
from scipy.stats import pearsonr


def is_constant(x: np.ndarray) -> bool:
    x = np.asarray(x, dtype=np.float64)
    if np.all(x == x[0]):
        return True
    return bool(np.linalg.norm(x - x.mean()) < 1e-13 * abs(x.mean()))


def rmse(y_true, y_pred, d: int = 0) -> float:
    """RMSE with P.1401 Eq (7-29) dof correction when d > 0."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    n = y_true.shape[0]
    if d == 0:
        return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))
    if n - d < 1:
        return float("nan")
    return float(np.sqrt(np.sum((y_true - y_pred) ** 2) / (n - d)))


def rmse_star(mos_sub, mos_obj, ci, d: int):
    """Epsilon-insensitive RMSE* (P.1401 Eq 7-27 + 7-29). Returns (rmse*, p_error, error)."""
    mos_sub = np.asarray(mos_sub, dtype=np.float64)
    mos_obj = np.asarray(mos_obj, dtype=np.float64)
    error = mos_sub - mos_obj
    if np.isnan(np.asarray(ci, dtype=np.float64)).any():
        return float("nan"), float("nan"), error
    p_error = np.clip(np.abs(error) - ci, 0.0, None)
    n = mos_sub.shape[0]
    if n - d < 1:
        return float("nan"), p_error, error
    return float(np.sqrt(np.sum(p_error**2) / (n - d))), p_error, error


def eval_metrics(y, y_hat, y_hat_map=None, d=None, ci=None) -> dict:
    """{'r_p', 'rmse', 'rmse_map', 'rmse_star_map'} like the reference."""
    out = {"r_p": np.nan, "rmse": np.nan, "rmse_map": np.nan, "rmse_star_map": np.nan}
    y = np.asarray(y, dtype=np.float64)
    y_hat = np.asarray(y_hat, dtype=np.float64)
    if not (is_constant(y_hat) or np.isnan(y).any()):
        out["r_p"] = float(pearsonr(y, y_hat)[0])
    out["rmse"] = rmse(y, y_hat)
    if y_hat_map is not None:
        out["rmse_map"] = rmse(y, y_hat_map, d=d or 0)
        if ci is not None:
            out["rmse_star_map"] = rmse_star(y, y_hat_map, ci, d or 0)[0]
    return out


# ---------------------------------------------------------------------------
# Polynomial mappings
# ---------------------------------------------------------------------------


def apply_poly(x, b):
    """Evaluate sum_i b[i] * x**i."""
    x = np.asarray(x, dtype=np.float64)
    return sum(b[i] * x**i for i in range(len(b)))


def fit_poly(y, y_hat, order: int):
    """Least-squares polynomial fit of y on y_hat (coefficients low->high)."""
    A = np.stack([np.asarray(y_hat, dtype=np.float64) ** i for i in range(order + 1)], axis=1)
    b, *_ = np.linalg.lstsq(A, np.asarray(y, dtype=np.float64), rcond=None)
    return b


def fit_monotonic_third_order(y_hat_file, y_target, con_ids=None, y_con=None, ci=None, objective="error"):
    """Constrained third-order fit with non-negative first derivative over the
    observed prediction range (SLSQP), per the reference's 'third_order'
    mapping. When ``con_ids``/``y_con`` are given the objective is computed on
    per-condition means, else per file against ``y_target``.
    """
    x = np.asarray(y_hat_file, dtype=np.float64)
    lo, hi = x.min() - 0.01, x.max() + 0.01
    grid = np.arange(lo, hi, 0.1)

    if con_ids is not None:
        con_ids = np.asarray(con_ids)
        uniq, inv = np.unique(con_ids, return_inverse=True)
        counts = np.bincount(inv).astype(np.float64)

        def objective_fn(p):
            mapped = apply_poly(x, p)
            con_means = np.bincount(inv, weights=mapped) / counts
            err = con_means - np.asarray(y_con, dtype=np.float64)
            if objective == "pError":
                err = np.clip(np.abs(err) - ci, 0.0, None)
            return float(np.sum(err**2))

    else:
        yt = np.asarray(y_target, dtype=np.float64)

        def objective_fn(p):
            err = apply_poly(x, p) - yt
            if objective == "pError":
                err = np.clip(np.abs(err) - ci, 0.0, None)
            return float(np.sum(err**2))

    cons = {"type": "ineq", "fun": lambda p: p[1] + 2 * p[2] * grid + 3 * p[3] * grid**2}
    res = minimize(objective_fn, x0=np.array([0.0, 1.0, 0.0, 0.0]), method="SLSQP", constraints=cons)
    return res.x


def fit_mapping(y_hat, y, mapping, con_ids=None, y_con=None, ci=None):
    """Dispatch mapping fit -> (coeffs b, dof d) with the reference's d values
    {None: 0, first: 1, second: 3, third*: 4} (`NISQA_lib.py:1642-1685`).

    When ``con_ids``/``y_con`` are given, first/second/third-order
    least-squares fits use per-condition means (like the reference's
    dcon-aware `calc_mapping`).
    """
    if mapping is None:
        return np.array([0.0, 1.0, 0.0, 0.0]), 0
    if con_ids is not None and y_con is not None and mapping != "third_order":
        uniq, inv = np.unique(np.asarray(con_ids), return_inverse=True)
        counts = np.bincount(inv).astype(np.float64)
        y_hat_fit = np.bincount(inv, weights=np.asarray(y_hat, dtype=np.float64)) / counts
        y_fit = np.asarray(y_con, dtype=np.float64)
    else:
        y_hat_fit, y_fit = y_hat, y
    if mapping == "first_order":
        return fit_poly(y_fit, y_hat_fit, 1), 1
    if mapping == "second_order":
        return fit_poly(y_fit, y_hat_fit, 2), 3
    if mapping == "third_order_not_monotonic":
        return fit_poly(y_fit, y_hat_fit, 3), 4
    if mapping == "third_order":
        b = fit_monotonic_third_order(y_hat, y, con_ids=con_ids, y_con=y_con, ci=ci, objective="error")
        return b, 4
    raise NotImplementedError(f"mapping not available: {mapping}")
