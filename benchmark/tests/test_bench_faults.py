"""Runs with the timed path broken underneath come out not correct: each
fault a cell can have, planted in the program, and the control."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness

from . import tiny


def _run(name, seconds=1.0):
    return harness.run_cell(tiny.cell(name), 2 ** 31 + 41, seconds, False, time.perf_counter(),
                            device="cpu")


def _plant_scatter(monkeypatch, alter):
    from nisqa_tpu_torch.data import pipeline

    orig = pipeline.InferenceEngine._scatter

    def broken(self, all_y, chunks, n):
        return alter(orig(self, all_y, chunks, n).copy())

    monkeypatch.setattr(pipeline.InferenceEngine, "_scatter", broken)


def _altered(y):
    y[len(y) // 2, 0] += 1.0
    return y


def _half(y):
    if len(y) > 1:
        y[len(y) // 2:] = y[: len(y) // 2].mean(axis=0)
    return y


@pytest.mark.parametrize("name", ["dim_corpus_cold", "dim_files_open"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, name):
    _plant_scatter(monkeypatch, _altered)
    assert not _run(name)["correct"]


def test_half_the_batch_left_out_and_the_mean_over_the_rest(monkeypatch):
    _plant_scatter(monkeypatch, _half)
    assert not _run("dim_corpus_cold")["correct"]


def test_a_train_step_that_returns_its_state_unchanged(monkeypatch):
    import importlib

    monkeypatch.setattr(importlib.import_module("torch.optim.adam"), "adam", lambda *a, **k: None)
    res = _run("nisqa_train_yaml")
    assert not res["correct"] and res["check"]["step_gap"]["value"] >= 0.99


def test_a_train_step_on_half_its_batch(monkeypatch):
    from nisqa_tpu_torch.train import loop

    orig = loop.train_loss

    def half(y_hat, y, bias_b, loss_weight=0.0, counts=None):
        h = max(1, len(y) // 2)
        return orig(y_hat[:h], y[:h], bias_b[:h], loss_weight, counts)

    monkeypatch.setattr(loop, "train_loss", half)
    assert not _run("nisqa_train_yaml")["correct"]


def test_the_scoring_control_fails_the_limit():
    """The reference in bfloat16 put in the program's place."""
    from benchmark.drivers.scoring import Scoring

    cell = tiny.cell("dim_corpus_cold")
    ctx = harness.Ctx(cell, 5, 1.0, False, "cpu", time.perf_counter(), None)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ctx.tmp = tmp
        sc = Scoring(ctx, cell.traffic["files"])
        files = list(range(len(sc.paths)))
        gap = sc.gap(sc.reference(files, torch.bfloat16), files)
    assert gap > cell.limits["pred_gap"]


@pytest.mark.card
def test_the_training_control_fails_a_limit(card):
    """The reference with TF32 on put in the program's place (on the card:
    the CPU has no TF32)."""
    from benchmark import readings

    cell = tiny.cell("nisqa_train_yaml")
    import importlib
    import tempfile

    driver = importlib.import_module("benchmark.drivers.train_epochs")
    with tempfile.TemporaryDirectory() as tmp:
        out = driver.run(harness.Ctx(cell, 5, 1.0, False, card, time.perf_counter(), tmp))
        out.release()
        c = readings.control(out, cell)["tf32"]
    assert any(c[k] > cell.limits[k] for k in ("loss_gap", "grad_gap", "step_gap")), c
    assert np.isfinite(c["loss_gap"])
