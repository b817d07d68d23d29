"""Early stopping (behavioural parity with the reference's ``earlyStopper``
and ``earlyStopper_dim``).

The counter resets when either the per-file Pearson r or the mapped RMSE of
any tracked target improves; the ``best`` flag (used for 'best_only'
checkpointing) is tied to the MOS mapped-RMSE improvement only.

The port's copy of ``nisqa_tpu/train/early_stop.py`` (same classes, same
code); a test holds the two equal.
"""

from __future__ import annotations


class EarlyStopper:
    def __init__(self, patience: int):
        self.best_rmse = 1e10
        self.best_r_p = -1e10
        self.cnt = -1
        self.patience = patience
        self.best = False

    def step(self, r: dict) -> bool:
        self.best = False
        if r["r_p_mean_file"] > self.best_r_p:
            self.best_r_p = r["r_p_mean_file"]
            self.cnt = -1
        if r["rmse_map_mean_file"] < self.best_rmse:
            self.best_rmse = r["rmse_map_mean_file"]
            self.cnt = -1
            self.best = True
        self.cnt += 1
        return self.cnt >= self.patience

    def state_dict(self) -> dict:
        return {"best_rmse": self.best_rmse, "best_r_p": self.best_r_p, "cnt": self.cnt}

    def load_state_dict(self, d: dict):
        self.best_rmse = float(d["best_rmse"])
        self.best_r_p = float(d["best_r_p"])
        self.cnt = int(d["cnt"])


class EarlyStopperDim:
    """Tracks r_p + mapped RMSE for all five targets (10 stats)."""

    # check order of the reference's earlyStopper_dim: mos, noi, col, dis,
    # loud; the order has no behavioral effect (every stat is checked each
    # step) but is kept identical for line-by-line parity review
    _SUFFIXES = ("", "_noi", "_col", "_dis", "_loud")

    def __init__(self, patience: int):
        self.best_rmse = {s: 1e10 for s in self._SUFFIXES}
        self.best_r_p = {s: -1e10 for s in self._SUFFIXES}
        self.cnt = -1
        self.patience = patience
        self.best = False

    def step(self, r: dict) -> bool:
        self.best = False
        for s in self._SUFFIXES:
            if r[f"r_p_mean_file{s}"] > self.best_r_p[s]:
                self.best_r_p[s] = r[f"r_p_mean_file{s}"]
                self.cnt = -1
            if r[f"rmse_map_mean_file{s}"] < self.best_rmse[s]:
                self.best_rmse[s] = r[f"rmse_map_mean_file{s}"]
                self.cnt = -1
                if s == "":
                    self.best = True
        self.cnt += 1
        return self.cnt >= self.patience

    def state_dict(self) -> dict:
        return {"best_rmse": dict(self.best_rmse), "best_r_p": dict(self.best_r_p), "cnt": self.cnt}

    def load_state_dict(self, d: dict):
        self.best_rmse = {s: float(d["best_rmse"][s]) for s in self._SUFFIXES}
        self.best_r_p = {s: float(d["best_r_p"][s]) for s in self._SUFFIXES}
        self.cnt = int(d["cnt"])

    # convenience accessors matching the reference's printout fields
    @property
    def best_r_p_mos(self):
        return self.best_r_p[""]

    @property
    def best_rmse_mos(self):
        return self.best_rmse[""]
