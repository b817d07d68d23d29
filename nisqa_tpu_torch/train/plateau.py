"""Reduce-on-plateau learning-rate schedule (host-side).

Equivalent of the torch scheduler the reference uses: mode 'min', relative
threshold 0.003, factor 0.1, no cooldown. The loop sets the current LR on
the optimiser's parameter groups each epoch.

The port's copy of ``nisqa_tpu/train/plateau.py`` (same class, same code);
a test holds the two equal.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(self, lr: float, patience: int, factor: float = 0.1,
                 threshold: float = 0.003, min_lr: float = 0.0):
        self.lr = float(lr)
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if new_lr < self.lr:
                print(f"--> reducing learning rate to {new_lr:0.2e}")
            self.lr = new_lr
            self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict):
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad = int(d["num_bad"])
