"""Whole runs of each cell on the CPU at a tiny size: everything but the
look for a card. A sound program comes out correct, with the cell's
metrics in the line."""

import time

import pytest

from benchmark import harness

from . import tiny

CELLS = ["dim_corpus_cold", "dim_files_open", "nisqa_train_yaml"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_is_correct_and_carries_its_layer_metrics(name):
    cell = tiny.cell(name)
    res = harness.run_cell(cell, 2 ** 31 + 3, 1.0, True, time.perf_counter(), device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res["check"]
    want = {m["name"] for m in cell.metrics("per_layer")}
    device_only = {n for n in want if "roofline" in n}  # no kernel runs on the CPU
    assert want - device_only <= set(res["metrics"]) <= want
    assert list(res)[-1] == "check" and set(res["check"]) == set(cell.limits)
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


def test_an_untraced_run_reports_the_end_to_end_metrics():
    cell = tiny.cell("dim_corpus_cold")
    res = harness.run_cell(cell, 17, 1.0, False, time.perf_counter(), device="cpu")
    assert set(res["metrics"]) == {"setup_s", "score_audio_s_per_s"} and res["correct"]
    assert "breakdown" not in res and res["metrics"]["setup_s"]["value"] > 0


def test_without_a_card_the_command_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "dim_corpus_cold", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
