"""The serving engine's stage clocks and profiler spans, on the CPU.

Cold and partial passes split their host time in ``stats["last"]``
(``head_s`` on cold passes; ``first_wait_s``, ``ready_batches``,
``fill_decode_s`` and ``fill_slot_s`` wherever the filler runs) and record
``engine.*`` spans on the main thread alone, seen under ``torch.profiler``
and through a recorder put in place of the span. Single-ended and NISQA_DE
corpora, decoded by the native loader and in Python.
"""

import contextlib
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar
from nisqa_tpu_torch.data import pipeline as pl
from nisqa_tpu_torch.data.fill import HostFill
from nisqa_tpu_torch.data.pipeline import InferenceEngine, MsConfig
from tests.test_e2e import _make_ckpt, _write_corpus
from tests.test_e2e_de_eval import _make_de_ckpt

FILL_KEYS = {"first_wait_s", "ready_batches", "fill_decode_s", "fill_slot_s"}
BS = 3


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """kind -> (checkpoint, degraded paths, reference paths or None): 7
    single-ended files, and 6 NISQA_DE pairs, at 8 kHz."""
    se, de = tmp_path_factory.mktemp("stages_se"), tmp_path_factory.mktemp("stages_de")
    names = [str(de / n) for n in _write_corpus(de, n=12)]
    return {"se": (_make_ckpt(se), [str(se / n) for n in _write_corpus(se, n=7)], None),
            "de": (_make_de_ckpt(de), names[:6], names[6:])}


@pytest.fixture(params=["native", "python"])
def decode(request, monkeypatch):
    """The host decode: the native loader, or Python where it is missing."""
    if request.param == "python":
        monkeypatch.setattr(pl.native, "available", lambda: False)
    else:
        assert pl.native.available()
    return request.param


def _engine(ckpt, **kw):
    model, args = load_model_from_tar(ckpt)
    return InferenceEngine(model, MsConfig(args), "cpu", batch_size=BS, num_workers=2,
                           precision="highest", **kw)


def _check_split(last, cold):
    """The relations the split's keys hold on a pass that filled."""
    assert FILL_KEYS <= set(last) and ("head_s" in last) == cold
    if cold:
        assert last["scan_plan_s"] <= last["head_s"] <= last["wall_s"]
    assert 0 <= last["first_wait_s"] <= last["wait_s"]
    assert 0 <= last["fill_decode_s"] and 0 <= last["fill_slot_s"]
    assert last["fill_decode_s"] + last["fill_slot_s"] <= last["fill_s"] + 1e-3
    assert isinstance(last["ready_batches"], int) and 0 <= last["ready_batches"] <= last["batches"]


def _predict(eng, deg, ref, fetch):
    y = eng.predict_paths(deg, ref, fetch=fetch)
    return y() if fetch == "async" else y


@pytest.mark.parametrize("fetch", [True, "async"])
@pytest.mark.parametrize("kind", ["se", "de"])
def test_split_keys_by_regime(corpora, decode, kind, fetch):
    """``head_s`` on cold passes alone; the fill keys on cold and partial
    passes; none of them on fully cached passes; with the result fetched at
    once or through the async handle."""
    ckpt, deg, ref = corpora[kind]
    full = _engine(ckpt, cache_mb=64)
    y = _predict(full, deg, ref, fetch)
    assert full.stats["last"]["mode"] == "interleaved"
    _check_split(full.stats["last"], cold=True)
    first = next(iter(full._corpus_cache.values()))["batches"][0]
    cap = pl._nbytes(*first[2:]) + 1  # the first batch stays resident, the rest go cold
    np.testing.assert_allclose(_predict(full, deg, ref, fetch), y, atol=1e-6)
    last = full.stats["last"]
    assert last["mode"] == "cached" and not (FILL_KEYS | {"head_s"}) & set(last)

    partial = _engine(ckpt, cache_mb=cap / (1 << 20))
    _predict(partial, deg, ref, fetch)
    _check_split(partial.stats["last"], cold=True)
    np.testing.assert_allclose(_predict(partial, deg, ref, fetch), y, atol=1e-6)
    last = partial.stats["last"]
    assert last["mode"] == "cached_partial" and last["cold_batches"] >= 1
    _check_split(last, cold=False)


def _per_batch(kind):
    """The main thread's spans of one batch: its wait for each end's fill
    and, double-ended, the alignment and fusion inside its dispatch."""
    if kind == "de":
        return ["engine.wait_fill", "engine.wait_fill", "engine.align"]
    return ["engine.wait_fill"]


def _main_thread_spans(prof):
    """The names of the main thread's ``engine.*`` events in the order they
    start, and the set of every event's name."""
    events = prof.profiler.kineto_results.events()
    main = next(e.start_thread_id() for e in events if e.name() == "test.mark")
    spans = sorted((e.start_ns(), e.name()) for e in events
                   if e.start_thread_id() == main and e.name().startswith("engine."))
    return [n for _, n in spans], {e.name() for e in events}


@pytest.mark.parametrize("kind", ["se", "de"])
def test_main_thread_spans_under_the_profiler(corpora, kind):
    """A cold pass under ``torch.profiler``: ``engine.scan_plan``, then per
    batch ``engine.wait_fill`` per end (and ``engine.align`` double-ended), then
    ``engine.collect`` on the calling thread, no ``bench.`` name, and the predictions bit-equal to a pass
    without the profiler."""
    ckpt, deg, ref = corpora[kind]
    eng = _engine(ckpt, cache_mb=0)
    y_off = eng.predict_paths(deg, ref)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.mark"):
            pass
        y_on = eng.predict_paths(deg, ref)
    np.testing.assert_array_equal(y_on, y_off)
    names, every = _main_thread_spans(prof)
    n = eng.stats["last"]["batches"]
    assert n == len(eng.plan(deg, ref)) and n >= 2
    assert names == ["engine.scan_plan"] + _per_batch(kind) * n + ["engine.collect"]
    assert not [e for e in every if e.startswith("bench.")]


def _recorder(log):
    """Stands in for the span: appends (thread, depth, name) to ``log`` at
    each entry."""
    depth = threading.local()

    @contextlib.contextmanager
    def span(name):
        d = getattr(depth, "n", 0)
        log.append((threading.current_thread().name, d, name))
        depth.n = d + 1
        try:
            yield
        finally:
            depth.n = d

    return span


@pytest.mark.parametrize("kind", ["se", "de"])
def test_the_filler_records_no_span_and_its_clocks_make_the_pass(corpora, decode, kind,
                                                                  monkeypatch):
    """Spans come from the main thread alone, none nested; the pass's
    ``fill_slot_s`` and ``fill_decode_s`` are the sums of what each
    ``HostFill.batch`` returned, one call per batch and end; a fill called
    as the train engine calls it records nothing."""
    ckpt, deg, ref = corpora[kind]
    log, got = [], []
    monkeypatch.setattr(pl, "_span", _recorder(log))
    make = HostFill.batch

    def timed(self, *a, **k):
        got.append(make(self, *a, **k))
        return got[-1]

    monkeypatch.setattr(HostFill, "batch", timed)
    eng = _engine(ckpt, cache_mb=0)
    eng.predict_paths(deg, ref)
    last, ends = eng.stats["last"], 1 if ref is None else 2
    assert not [t for t, _, _ in log if t.startswith("nisqa-filler")]
    assert [(d, s) for _, d, s in log] == [
        (0, s) for s in ["engine.scan_plan"] + _per_batch(kind) * last["batches"]
        + ["engine.collect"]]
    assert len(got) == ends * last["batches"]
    assert all(slot_s >= 0 and decode_s > 0 for slot_s, decode_s in got)
    assert last["fill_slot_s"] == pytest.approx(sum(g[0] for g in got), abs=1e-4)
    assert last["fill_decode_s"] == pytest.approx(sum(g[1] for g in got), abs=1e-4)

    log.clear()
    audio, _, plan = eng._scan_plan(deg, ref)
    gkey, chunk = plan[0]
    buf_len = pl.frame_geometry(eng.ms, gkey[0], gkey[1])[4]
    slot = eng.fill.slot(gkey[2], 0, eng.batch_size)
    eng.fill.batch(slot, chunk, audio, deg, buf_len, gkey[2])
    slot.release()
    assert log == []


def test_a_failed_fill_leaves_the_next_pass_split(corpora, monkeypatch):
    """A fill that raises reaches the caller; the next cold pass still
    writes every key of the split, with its own totals."""
    ckpt, deg, _ = corpora["se"]
    eng = _engine(ckpt, cache_mb=0)
    eng.predict_paths(deg)
    before = dict(eng.stats["last"])
    real = pl.native.fill_batch_i16

    def fail(*a, **k):
        raise RuntimeError("decode failed")

    monkeypatch.setattr(pl.native, "fill_batch_i16", fail)
    with pytest.raises(RuntimeError, match="decode failed"):
        eng.predict_paths(deg)
    assert eng.stats["last"] == before
    monkeypatch.setattr(pl.native, "fill_batch_i16", real)
    eng.predict_paths(deg)
    _check_split(eng.stats["last"], cold=True)
    assert eng.stats["passes"] == 2


DE_KEYS = {"fill_decode_ref_s", "trunk_rows", "own_rows", "align_device_s"}


def _own_rows(eng, paths):
    from nisqa_tpu_torch.audio.wav import read_wav

    total = 0
    for p in paths:
        y, sr = read_wav(p)
        total += eng.ms.n_wins(eng.ms.n_frames(len(y), sr))
    return total


def test_de_counters_on_a_cold_pass(corpora, decode):
    """The reference end's decode is a part of the pass's decode; the trunk
    runs both ends of every batch row at its bucket, of which the ends' own
    n_wins are a part; no device time on the CPU."""
    ckpt, deg, ref = corpora["de"]
    eng = _engine(ckpt, cache_mb=0)
    eng.predict_paths(deg, ref)
    last = eng.stats["last"]
    assert 0 < last["fill_decode_ref_s"] <= last["fill_decode_s"]
    plan = eng.plan(deg, ref)
    assert last["trunk_rows"] == 2 * BS * sum(gkey[1] for gkey, _ in plan)
    assert last["own_rows"] == _own_rows(eng, deg) + _own_rows(eng, ref)
    assert 0 < last["own_rows"] <= last["trunk_rows"]
    assert "align_device_s" not in last


def test_de_partial_pass_splits_the_reference_decode(corpora):
    """A partial pass re-fills its cold tail: the reference end's decode is
    counted there too; the trunk's rows are a cold pass's alone."""
    ckpt, deg, ref = corpora["de"]
    full = _engine(ckpt, cache_mb=64)
    full.predict_paths(deg, ref)
    first = next(iter(full._corpus_cache.values()))["batches"][0]
    partial = _engine(ckpt, cache_mb=(pl._nbytes(*first[2:]) + 1) / (1 << 20))
    partial.predict_paths(deg, ref)
    partial.predict_paths(deg, ref)
    last = partial.stats["last"]
    assert last["mode"] == "cached_partial"
    assert 0 < last["fill_decode_ref_s"] <= last["fill_decode_s"]
    assert not {"trunk_rows", "own_rows", "align_device_s"} & set(last)


@pytest.mark.parametrize("cache_mb", [0, 64])
def test_a_single_ended_pass_carries_no_de_key(corpora, cache_mb):
    ckpt, deg, _ = corpora["se"]
    eng = _engine(ckpt, cache_mb=cache_mb)
    for _ in range(2):  # cold, then (with the cache) cached
        eng.predict_paths(deg)
        assert not DE_KEYS & set(eng.stats["last"])
    assert eng._align_n == 0 and eng._align_events == []


class _TimedPair:
    """Stands in for a CUDA event: ``elapsed_time`` in ms to its partner."""

    def elapsed_time(self, other):
        return 2.5


@pytest.mark.parametrize("fetch", [True, False])
def test_align_device_time_is_summed_once_the_pass_synchronised(corpora, monkeypatch, fetch):
    """Each alignment's event pair is read by the pass's collect, after its
    synchronisation, and summed into ``align_device_s``; the next pass
    records into the same pairs."""
    ckpt, deg, ref = corpora["de"]
    eng = _engine(ckpt, cache_mb=0)
    stage = eng._align_stage
    seen = []

    @contextlib.contextmanager
    def timed():
        with stage():
            yield
        if eng._align_n == len(eng._align_events):
            eng._align_events.append((_TimedPair(), _TimedPair()))
        eng._align_n += 1
        seen.append(eng._align_n)

    monkeypatch.setattr(eng, "_align_stage", timed)
    for _ in range(2):  # the second pass reuses the first one's events
        seen.clear()
        eng.predict_paths(deg, ref, fetch=fetch)
        n = eng.stats["last"]["batches"]
        assert seen == list(range(1, n + 1))
        assert eng.stats["last"]["align_device_s"] == pytest.approx(n * 2.5e-3)
        assert eng._align_n == 0 and len(eng._align_events) == n
