"""The engine host's stage metrics (``engine_head_ms``, ``engine_stall_ms``,
``fill_decode_ms``, ``fill_slot_ms``, ``fill_ready_pct``): each reader on
stats with and without the keys, whole traced runs of a program that lacks
them (a parent that does not split its passes), and the trace naming an
idle gap by the engine's stage span, or by the operator of a dispatch."""

import os
import time

import pytest
import torch

from benchmark import harness, trace

from . import tiny

STAGE = {"engine_head_ms.score": lambda s: 1e3 * s["head_s"],
         "engine_stall_ms.score": lambda s: 1e3 * (s["wait_s"] - s["first_wait_s"]),
         "fill_decode_ms.score": lambda s: 1e3 * s["fill_decode_s"],
         "fill_slot_ms.score": lambda s: 1e3 * s["fill_slot_s"],
         "fill_ready_pct.score": lambda s: 100.0 * s["ready_batches"] / s.get(
             "cold_batches", s["batches"])}
SPLIT_KEYS = ("head_s", "first_wait_s", "ready_batches", "fill_decode_s", "fill_slot_s")


def _reader(name):
    return harness.load_file(os.path.join(harness.HERE, "metrics", name + ".py"), f"metric_{name}")


class _Run:
    def __init__(self, stats):
        self.stats = stats


@pytest.mark.parametrize("name", sorted(STAGE))
def test_a_reader_is_silent_without_its_keys_and_means_them_with(name):
    read = _reader(name).read
    parent = {"mode": "interleaved", "batches": 12, "wall_s": 0.25, "scan_plan_s": 0.01,
              "fill_s": 0.08, "wait_s": 0.04, "dispatch_s": 0.03}
    assert read(_Run([])) is None and read(object()) is None
    assert read(_Run([parent, dict(parent)])) is None
    passes = [{**parent, "head_s": 0.05, "first_wait_s": 0.03, "ready_batches": 9,
               "fill_decode_s": 0.06, "fill_slot_s": 0.01},
              {**parent, "wait_s": 0.05, "head_s": 0.07, "first_wait_s": 0.02,
               "ready_batches": 11, "fill_decode_s": 0.07, "fill_slot_s": 0.004}]
    if name != "engine_head_ms.score":  # a partial pass: no head, its own cold batches
        passes.append({**parent, "mode": "cached_partial", "resident_batches": 8,
                       "cold_batches": 4, "first_wait_s": 0.01, "ready_batches": 1,
                       "fill_decode_s": 0.02, "fill_slot_s": 0.002})
    want = sum(STAGE[name](s) for s in passes) / len(passes)
    assert read(_Run(passes + [parent])) == pytest.approx(want)


def _parent_shaped(monkeypatch):
    """The engine's ``_note_pass`` without the split's keys, as the parent's."""
    from nisqa_tpu_torch.data import pipeline

    orig = pipeline.InferenceEngine._note_pass

    def note(self, mode, n_files, n_batches, t0, t_plan, t_end, timings=None):
        kept = {k: v for k, v in (timings or {}).items() if k not in SPLIT_KEYS}
        return orig(self, mode, n_files, n_batches, t0, t_plan, t_end, kept)

    monkeypatch.setattr(pipeline.InferenceEngine, "_note_pass", note)


@pytest.mark.parametrize("name", ["dim_corpus_cold", "nisqa_train_yaml"])
def test_a_traced_run_of_a_program_without_the_split_is_correct_and_leaves_them_out(
        monkeypatch, name):
    _parent_shaped(monkeypatch)
    cell = tiny.cell(name)
    res = harness.run_cell(cell, 2 ** 31 + 7, 1.0, True, time.perf_counter(), device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res["check"]
    assert not set(STAGE) & set(res["metrics"])
    others = {m["name"] for m in cell.metrics("per_layer")} - set(STAGE)
    assert others - {n for n in others if "roofline" in n} <= set(res["metrics"])


class _Event:
    """A profiler event as ``trace.summarise`` reads it."""

    def __init__(self, name, start, end, tid=1, device=False):
        self._n, self._s, self._d, self._t, self._dev = name, start, end - start, tid, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return self._t

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False


def test_a_gap_inside_an_engine_span_is_named_by_it():
    """Device idle from 300 to 700 ns, with the host inside ``engine.wait_fill``
    (which holds no operator) within ``bench.pass``: the gap is named
    ``bench.pass|engine.wait_fill``; a gap in the dispatch that follows,
    outside any ``engine.*`` span, keeps the name of its operator."""
    events = [_Event("bench.window_start", 0, 0), _Event("bench.window_end", 1000, 1000),
              _Event("bench.pass", 50, 990),
              _Event("engine.scan_plan", 60, 100),
              _Event("engine.wait_fill", 100, 750),
              _Event("aten::linear", 800, 880),
              _Event("kernel", 0, 300, tid=9, device=True),
              _Event("kernel", 700, 790, tid=9, device=True),
              _Event("kernel", 860, 1000, tid=9, device=True)]
    gaps = dict(trace.summarise(events).gaps)
    assert gaps["bench.pass|engine.wait_fill"] == pytest.approx(400e-9)
    assert gaps["bench.pass|aten::linear"] == pytest.approx(70e-9)
    assert not [n for n in gaps if n.endswith("|host")]
