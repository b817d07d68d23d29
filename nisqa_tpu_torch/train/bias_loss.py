"""Database-bias-aware loss (host-side coefficient bookkeeping).

Behavioural parity with the reference's ``biasLoss``: per-sample cubic
mapping coefficients (identity-initialised), activated once the global
Pearson r of an epoch's train predictions exceeds ``min_r``, then refit per
database with a first-order least-squares fit of y on y_hat each epoch
(anchor database excluded). The device side only sees a (B, K, 4)
coefficient array per batch; the polynomial and the NaN-masked MSE run in
the train step (see loop.py).

The port's copy of ``nisqa_tpu/train/bias_loss.py`` (same class, same
code). ``db`` is any 1-D sequence: a numpy array or a column of the port's
``Table``; a test holds the two equal.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import pearsonr


class BiasLoss:
    def __init__(self, db, anchor_db=None, mapping="first_order", min_r=0.7,
                 loss_weight=0.0, do_print=True):
        self.db = np.asarray(db)
        self.mapping = mapping
        self.min_r = min_r
        self.anchor_db = anchor_db
        self.loss_weight = loss_weight
        self.do_print = do_print
        self.b = np.zeros((len(self.db), 4), dtype=np.float32)
        self.b[:, 1] = 1.0
        self.do_update = False
        self.apply_bias_loss = (min_r is not None) and (mapping is not None)

    def coeffs(self, idx) -> np.ndarray:
        """Per-sample polynomial coefficients for a batch of df indices."""
        return self.b[np.asarray(idx)]

    def update_bias(self, y: np.ndarray, y_hat: np.ndarray):
        if not self.apply_bias_loss:
            return
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        y_hat = np.asarray(y_hat, dtype=np.float64).reshape(-1)

        if not self.do_update:
            ok = ~np.isnan(y)
            r = pearsonr(y[ok], y_hat[ok])[0]
            if self.do_print:
                print(f"--> bias update: min_r {self.min_r:0.2f}, r_p {r:0.2f}")
            if r > self.min_r:
                self.do_update = True

        if self.do_update:
            if self.do_print:
                print("--> bias updated")
            for db_name in np.unique(self.db):
                sel = self.db == db_name
                y_db, y_hat_db = y[sel], y_hat[sel]
                if np.isnan(y_db).any():
                    continue
                if self.mapping != "first_order":
                    raise NotImplementedError(self.mapping)
                A = np.stack([np.ones_like(y_hat_db), y_hat_db], axis=1)
                btmp, *_ = np.linalg.lstsq(A, y_db, rcond=None)
                if db_name != self.anchor_db:
                    self.b[sel, 0] = btmp[0]
                    self.b[sel, 1] = btmp[1]
                    self.b[sel, 2:] = 0.0
