"""The port's serving engine in depth, on the CPU.

Mirrors the single-ended cases of ``tests/test_engine_cache.py`` against
``nisqa_tpu_torch``'s engine: the batching plan, the device-resident corpus
mel cache (hit, invalidation, off, LRU eviction, partial residency), the
fused cached passes (whole-plan ``mel_fused`` and ``mel_fused_parts``),
``warmup``, ``fetch="async"`` and ``stats``; then the filler thread and its
staging ring. Every regime is held within 1e-3 of the JAX engine at
"highest"; on the CPU fused and per-batch passes agree within 1e-6 and
repeated cached passes bit for bit.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

from nisqa_tpu.audio.wav import write_wav
from nisqa_tpu.compat.torch_ckpt import load_model_from_tar as load_jax_model
from nisqa_tpu.data.pipeline import InferenceEngine as JaxEngine, MsConfig as JaxMsConfig
from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar
from nisqa_tpu_torch.data import pipeline as pl
from nisqa_tpu_torch.data.pipeline import InferenceEngine, MsConfig
from tests.test_e2e import _make_ckpt, _write_corpus


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _make_ckpt(tmp_path_factory.mktemp("torch_cache_ckpt"))


def _engine(ckpt, **kw):
    model, args = load_model_from_tar(ckpt)
    return InferenceEngine(model, MsConfig(args), "cpu", num_workers=2, **kw)


def _entry(eng):
    return next(iter(eng._corpus_cache.values()))


def _block_sizes(eng):
    return [pl._nbytes(db, n) for _, _, db, n in _entry(eng)["batches"]]


def _eq_paths(tmp_path, n=8):
    """Near-equal lengths: every batch lands in the same grid bucket."""
    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        t = np.arange(int(8000 * (0.80 + 0.01 * i))) / 8000
        y = 0.3 * np.sin(2 * np.pi * (180 + 25 * i) * t) + 0.02 * rng.standard_normal(len(t))
        p = str(tmp_path / f"eq{i}.wav")
        write_wav(p, y.astype(np.float32), 8000)
        paths.append(p)
    return paths


def test_plan_is_one_exec_per_chunk(tmp_path, ckpt):
    """Single-sr corpus: exactly ceil(N/bs) batches, length-sorted chunks,
    minimal grid bucket per chunk."""
    names = _write_corpus(tmp_path, n=7)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=3)
    metas = eng._metas_for(eng._scan_transport(paths))
    plan = eng._plan_for(metas)
    assert len(plan) == 3  # ceil(7/3)
    nw = {m[0]: m[2] for m in metas}
    chunk_maxes = [max(nw[i] for i in chunk) for _, chunk in plan]
    assert chunk_maxes == sorted(chunk_maxes, reverse=True)
    grid = eng.ms.buckets()
    for (sr, bucket, kind), chunk in plan:
        assert bucket in grid and bucket >= max(nw[i] for i in chunk)
        smaller = [b for b in grid if b < bucket]
        if smaller:
            assert max(nw[i] for i in chunk) > smaller[-1]


@pytest.mark.parametrize("fuse_pass", [None, False])
def test_cache_hit_identical_and_skips_decode(tmp_path, ckpt, monkeypatch, fuse_pass):
    names = _write_corpus(tmp_path, n=5)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=2, cache_mb=256, fuse_pass=fuse_pass)
    y1 = eng.predict_paths(paths)
    assert len(eng._corpus_cache) == 1

    def boom(*a, **k):
        raise AssertionError("decode on a cache hit")

    # a hit scans nothing, fills nothing and decodes nothing
    monkeypatch.setattr(eng, "_scan_transport", boom)
    monkeypatch.setattr(eng, "_make_batch", boom)
    monkeypatch.setattr(pl.native, "fill_batch_i16", boom)
    y2 = eng.predict_paths(paths)
    y3 = eng.predict_paths(paths)
    if fuse_pass is False:
        np.testing.assert_array_equal(y1, y2)
    np.testing.assert_allclose(y2, y1, atol=1e-6)
    np.testing.assert_array_equal(y2, y3)
    assert eng.stats["passes"] == 3 and eng.stats["cache_hits"] == 2
    last = eng.stats["last"]
    assert last["mode"] == "cached" and last["files"] == 5 and last["batches"] == 3
    assert {"wall_s", "scan_plan_s", "dispatch_s", "block_s", "fetch_s"} <= set(last)
    assert _entry(eng)["mode"] == ("mel" if fuse_pass is False else "mel_fused")


def test_cache_invalidates_on_file_change(tmp_path, ckpt):
    names = _write_corpus(tmp_path, n=4)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=2, cache_mb=256)
    y1 = eng.predict_paths(paths)
    rng = np.random.default_rng(99)
    write_wav(paths[0], (0.2 * rng.standard_normal(4000)).astype(np.float32), 8000)
    os.utime(paths[0], ns=(time.time_ns(), time.time_ns() + 10_000_000))
    y3 = eng.predict_paths(paths)
    assert eng.stats["last"]["mode"] == "interleaved"
    assert np.abs(y3[0] - y1[0]).max() > 1e-4  # recomputed, new audio
    np.testing.assert_allclose(y3[1:], y1[1:], atol=1e-6)


def test_cache_disabled_when_zero(tmp_path, ckpt):
    names = _write_corpus(tmp_path, n=3)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=2, cache_mb=0)
    eng.predict_paths(paths)
    eng.predict_paths(paths)
    assert not eng._corpus_cache and eng.stats["cache_hits"] == 0
    assert eng.stats["last"]["mode"] == "interleaved"


def test_cache_eviction_lru(tmp_path, ckpt):
    names = _write_corpus(tmp_path, n=4)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=2, cache_mb=256)
    eng.predict_paths(paths[:2])
    eng.predict_paths(paths[2:])
    assert len(eng._corpus_cache) == 2
    eng.cache_mb = eng._cache_bytes * 0.9 / (1 << 20)
    eng.predict_paths(paths[1:3])  # a third corpus: the oldest entry goes
    assert len(eng._corpus_cache) <= 2
    assert eng._cache_bytes <= int(eng.cache_mb * (1 << 20))
    assert tuple(p for p, _, _ in next(reversed(eng._corpus_cache))) == tuple(paths[1:3])


def test_fuse_pass_true_is_alias_of_default(tmp_path, ckpt):
    names = _write_corpus(tmp_path, n=6)
    paths = [str(tmp_path / n) for n in names]
    y0 = _engine(ckpt, batch_size=2, cache_mb=0).predict_paths(paths)
    eng = _engine(ckpt, batch_size=2, cache_mb=256, fuse_pass=True)
    eng.warmup(paths)
    y1 = eng.predict_paths(paths)
    assert eng.stats["last"]["mode"] == "interleaved"
    y2 = eng.predict_paths(paths)
    assert _entry(eng)["mode"] == "mel_fused"
    y3 = eng.predict_paths(paths)
    assert np.abs(y1 - y0).max() < 1e-6
    np.testing.assert_allclose(y2, y1, atol=1e-6)
    np.testing.assert_array_equal(y2, y3)


def test_auto_fuse_cached_pass_matches(tmp_path, ckpt):
    names = _write_corpus(tmp_path, n=6)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=2, cache_mb=256)
    warmed = eng.warmup(paths)
    plan = eng.plan(paths)
    assert {g for s, g, _ in warmed if s == "cold"} == {g for g, _ in plan}
    assert {g for s, g, _ in warmed if s == "seg"} == {g for g, _ in plan}
    y1 = eng.predict_paths(paths)
    assert eng.stats["last"]["mode"] == "interleaved"
    assert _entry(eng)["mode"] == "mel"
    y2 = eng.predict_paths(paths)
    assert eng.stats["last"]["mode"] == "cached"
    entry = _entry(eng)
    assert entry["mode"] == "mel_fused"
    # the parts are views of the one flat block
    assert all(db.untyped_storage().data_ptr() == entry["flat"].untyped_storage().data_ptr()
               for _, db, _ in entry["parts"])
    y3 = eng.predict_paths(paths)
    np.testing.assert_allclose(y2, y1, atol=1e-6)
    np.testing.assert_array_equal(y2, y3)
    e_off = _engine(ckpt, batch_size=2, cache_mb=256, fuse_pass=False)
    ya, yb = e_off.predict_paths(paths), e_off.predict_paths(paths)
    assert _entry(e_off)["mode"] == "mel"
    np.testing.assert_array_equal(yb, ya)
    np.testing.assert_allclose(y2, yb, atol=1e-6)


def test_partial_cache_over_cap(tmp_path, ckpt, monkeypatch, capsys):
    names = _write_corpus(tmp_path, n=6)
    paths = [str(tmp_path / n) for n in names]
    y0 = _engine(ckpt, batch_size=2, cache_mb=0).predict_paths(paths)
    e_full = _engine(ckpt, batch_size=2, cache_mb=256)
    e_full.predict_paths(paths)
    sizes = _block_sizes(e_full)
    assert len(sizes) == 3
    capsys.readouterr()

    eng = _engine(ckpt, batch_size=2, cache_mb=(sizes[0] + sizes[1] + 1) / (1 << 20))
    y1 = eng.predict_paths(paths)
    err = capsys.readouterr().err
    assert "nisqa_tpu_torch: corpus mels exceed the serving cache cap" in err
    assert "2/3 batches stay device-resident" in err and "serving_cache_mb >= 1" in err
    entry = _entry(eng)
    assert entry["mode"] == "mel" and len(entry["batches"]) == 2 and len(entry["cold"]) == 1

    scanned = []
    orig = eng._scan_transport
    monkeypatch.setattr(eng, "_scan_transport", lambda ps: (scanned.append(list(ps)) or orig(ps)))
    y2 = eng.predict_paths(paths)
    last = eng.stats["last"]
    assert last["mode"] == "cached_partial" and eng.stats["cache_hits"] == 1
    assert last["resident_batches"] == 2 and last["cold_batches"] == 1
    tail_files = {i for _, chunk in entry["cold"] for i in chunk}
    assert scanned and all(len(ps) == len(tail_files) for ps in scanned)
    np.testing.assert_allclose(y2, y1, atol=1e-6)
    np.testing.assert_allclose(y2, y0, atol=1e-6)
    np.testing.assert_array_equal(y2, eng.predict_paths(paths))
    assert _entry(eng)["mode"] == "mel"  # never fused while a cold tail exists


def test_warmup_partial_cache_warms_resident_seg_only(tmp_path, ckpt):
    names = _write_corpus(tmp_path, n=6)
    paths = [str(tmp_path / n) for n in names]
    e_full = _engine(ckpt, batch_size=2, cache_mb=256)
    y_full = e_full.predict_paths(paths)
    sizes = _block_sizes(e_full)
    plan = e_full.plan(paths)
    for fuse_pass in (None, True):
        eng = _engine(ckpt, batch_size=2, fuse_pass=fuse_pass,
                      cache_mb=(sizes[0] + 1) / (1 << 20))
        warmed = eng.warmup(paths)
        # the partial regime runs per-batch seg+model for the resident
        # batch only: its shape, at bs rows
        assert [(g, r) for s, g, r in warmed if s == "seg"] == [(plan[0][0], 2)]
        y1 = eng.predict_paths(paths)
        y2 = eng.predict_paths(paths)
        assert eng.stats["last"]["mode"] == "cached_partial"
        np.testing.assert_allclose(y1, y_full, atol=1e-6)
        np.testing.assert_allclose(y2, y_full, atol=1e-6)
    for cache_mb in (0, 1e-6):  # the cache can take nothing: no seg shapes
        warmed = _engine(ckpt, batch_size=2, cache_mb=cache_mb).warmup(paths)
        assert warmed and not [w for w in warmed if w[0] == "seg"]


def test_async_fetch_matches_sync_all_regimes(tmp_path, ckpt):
    names = _write_corpus(tmp_path, n=5)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=2, cache_mb=256)
    y_cold = eng.predict_paths(paths, fetch="async")()  # cold pass: eager
    h1 = eng.predict_paths(paths, fetch="async")  # cached: both dispatched ...
    h2 = eng.predict_paths(paths, fetch="async")
    y1, y2 = h1(), h2()  # ... then resolved
    y_sync = eng.predict_paths(paths)
    assert eng.predict_paths(paths, fetch=False) is None
    np.testing.assert_allclose(y_cold, y_sync, atol=1e-6)
    np.testing.assert_array_equal(y1, y_sync)
    np.testing.assert_array_equal(y2, y_sync)
    assert eng.stats["passes"] == 5 and eng.stats["cache_hits"] == 4
    assert "block_s" in eng.stats["last"] and "fetch_s" not in eng.stats["last"]

    e_off = _engine(ckpt, batch_size=2, cache_mb=256, fuse_pass=False)
    np.testing.assert_allclose(e_off.predict_paths(paths, fetch="async")(), y_sync, atol=1e-6)
    np.testing.assert_allclose(e_off.predict_paths(paths, fetch="async")(), y_sync, atol=1e-6)
    h_empty = eng.predict_paths([], fetch="async")
    assert h_empty().shape == (0, 1)
    with pytest.raises(ValueError, match="fetch"):
        eng.predict_paths(paths, fetch="later")


def test_async_fetch_partial_cache_resolves_eagerly(tmp_path, ckpt):
    paths = []
    for i in range(4):
        t = np.arange(int(8000 * (0.5 + 0.2 * i))) / 8000
        p = str(tmp_path / f"p{i}.wav")
        write_wav(p, (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)).astype(np.float32), 8000)
        paths.append(p)
    eng = _engine(ckpt, batch_size=2, cache_mb=0.02)  # tiny cap
    y_sync = eng.predict_paths(paths)
    y_sync2 = eng.predict_paths(paths)
    assert eng.stats["last"]["mode"] == "cached_partial"
    h = eng.predict_paths(paths, fetch="async")
    assert eng.stats["last"]["mode"] == "cached_partial"  # resolved inside the call
    np.testing.assert_array_equal(h(), y_sync2)
    np.testing.assert_allclose(y_sync2, y_sync, atol=1e-6)


def test_big_plan_fused_parts(tmp_path, ckpt, monkeypatch):
    paths = _eq_paths(tmp_path)
    monkeypatch.setattr(pl, "FUSE_WHOLE_MAX", 2)  # 4 batches > 2 -> parts
    y0 = _engine(ckpt, batch_size=2, cache_mb=0).predict_paths(paths)
    eng = _engine(ckpt, batch_size=2, cache_mb=256)
    warmed = eng.warmup(paths)
    assert [r for s, _, r in warmed if s == "seg"] == [8]  # one part of 4 batches
    y1 = eng.predict_paths(paths)
    assert _entry(eng)["mode"] == "mel"
    y2 = eng.predict_paths(paths)
    entry = _entry(eng)
    assert entry["mode"] == "mel_fused_parts"
    assert len(entry["parts"]) < 4
    assert sum(db.shape[0] // eng.batch_size for _, db, _ in entry["parts"]) == 4
    y3 = eng.predict_paths(paths)
    assert eng.stats["last"]["mode"] == "cached"
    np.testing.assert_allclose(y1, y0, atol=1e-6)
    np.testing.assert_allclose(y2, y1, atol=1e-6)
    np.testing.assert_array_equal(y2, y3)
    h1 = eng.predict_paths(paths, fetch="async")
    h2 = eng.predict_paths(paths, fetch="async")
    np.testing.assert_array_equal(h1(), y3)
    np.testing.assert_array_equal(h2(), y3)


def test_fuse_chunk_cap_respects_working_set(ckpt):
    eng = _engine(ckpt, batch_size=32)
    small = [((48000, 163, "i16"), list(range(32)))] * 40
    big = [((48000, 1300, "i16"), list(range(32)))] * 40
    k_small = len(eng._fuse_plan_chunks(small)[0])
    k_big = len(eng._fuse_plan_chunks(big)[0])
    assert k_big <= k_small
    assert 1 <= k_big <= 16 and 1 <= k_small <= 16
    mixed = [((48000, 163, "i16"), [0])] * 2 + [((48000, 204, "i16"), [0])] * 2
    for idxs in eng._fuse_plan_chunks(mixed):
        assert len({mixed[i][0] for i in idxs}) == 1


# -- the port's regimes against the JAX engine ----------------------------------


@pytest.fixture(scope="module")
def parity_corpus(tmp_path_factory, ckpt):
    """7 PCM16 files (i16 transport) and a stereo one (f32), and the JAX
    engine's predictions at "highest" (run once for the module)."""
    tmp = tmp_path_factory.mktemp("torch_cache_parity")
    names = _write_corpus(tmp, n=7)
    rng = np.random.default_rng(4)
    write_wav(str(tmp / "stereo.wav"), 0.2 * rng.standard_normal((2, 7000)).astype(np.float32), 8000)
    paths = [str(tmp / n) for n in sorted(names + ["stereo.wav"])]
    jmodel, params, state, args = load_jax_model(ckpt)
    y_ref = JaxEngine(jmodel, params, state, JaxMsConfig(args), batch_size=2, num_workers=1,
                      precision="highest", fe_precision="exact", cache_mb=0).predict_paths(paths)
    return paths, y_ref


REGIMES = ["cold", "cached_fused", "cached_per_batch", "fused_parts", "partial", "async",
           "python_fill"]


@pytest.mark.parametrize("regime", REGIMES)
def test_regimes_match_jax_engine(parity_corpus, ckpt, monkeypatch, regime):
    paths, y_ref = parity_corpus
    kw = {"precision": "highest", "fe_precision": "exact", "batch_size": 2}
    if regime == "python_fill":
        monkeypatch.setattr(pl.native, "available", lambda: False)
    if regime == "fused_parts":
        monkeypatch.setattr(pl, "FUSE_WHOLE_MAX", 1)
    if regime == "partial":
        full = _engine(ckpt, cache_mb=256, **kw)
        full.predict_paths(paths)
        kw["cache_mb"] = (sum(_block_sizes(full)) // 2) / (1 << 20)
    eng = _engine(ckpt, fuse_pass=False if regime == "cached_per_batch" else None, **kw)
    plan = eng.plan(paths)
    assert {g[2] for g, _ in plan} == {"i16", "f32"}
    y_cold = eng.predict_paths(paths)
    assert eng.stats["last"]["mode"] == "interleaved"
    if regime in ("cold", "python_fill"):
        y = y_cold
    elif regime == "async":
        h1, h2 = eng.predict_paths(paths, fetch="async"), eng.predict_paths(paths, fetch="async")
        y = h1()
        np.testing.assert_array_equal(h2(), y)
    else:
        y = eng.predict_paths(paths)
        mode = {"cached_fused": "mel_fused", "cached_per_batch": "mel",
                "fused_parts": "mel_fused_parts", "partial": "mel"}[regime]
        assert _entry(eng)["mode"] == mode
        assert eng.stats["last"]["mode"] == ("cached_partial" if regime == "partial" else "cached")
    assert y.shape == y_ref.shape and np.isfinite(y).all()
    assert np.abs(y - y_ref).max() <= 1e-3
    np.testing.assert_allclose(y, y_cold, atol=1e-6)


# -- filler thread and staging ring -------------------------------------------------


def _run_with_timeout(fn, timeout=120):
    """Run ``fn`` on a thread; fail instead of hanging if it deadlocks."""
    box = {}

    def target():
        try:
            box["y"] = fn()
        except BaseException as e:  # handed to the test thread below
            box["e"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "predict_paths did not finish: filler or ring deadlock"
    if "e" in box:
        raise box["e"]
    return box["y"]


def test_filler_exception_reaches_caller(tmp_path, ckpt, monkeypatch):
    """A fill that raises surfaces in predict_paths (nothing is swallowed),
    and the engine's filler and ring still work on the next pass."""
    names = _write_corpus(tmp_path, n=7)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=1, cache_mb=0)
    y0 = eng.predict_paths(paths)
    calls = []
    real = pl.native.fill_batch_i16

    def fail_third(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("decode failed")
        return real(*a, **k)

    monkeypatch.setattr(pl.native, "fill_batch_i16", fail_third)
    with pytest.raises(RuntimeError, match="decode failed"):
        _run_with_timeout(lambda: eng.predict_paths(paths))
    monkeypatch.undo()
    np.testing.assert_array_equal(_run_with_timeout(lambda: eng.predict_paths(paths)), y0)


def test_ring_is_reused_and_bounded(tmp_path, ckpt):
    """Staging slots are allocated once per transport and reused across
    passes: RING_SLOTS per transport however many batches a pass has."""
    names = _write_corpus(tmp_path, n=7)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=1, cache_mb=0)
    eng.warmup(paths)
    ptrs = [s.buf.data_ptr() for s in eng._rings["i16"]]
    y1 = eng.predict_paths(paths)
    y2 = eng.predict_paths(paths)
    assert list(eng._rings) == ["i16"] and len(eng._rings["i16"]) == pl.RING_SLOTS
    assert [s.buf.data_ptr() for s in eng._rings["i16"]] == ptrs
    np.testing.assert_array_equal(y1, y2)
    assert eng.stats["last"]["batches"] == 7
    assert {"fill_s", "wait_s", "dispatch_s", "block_s", "fetch_s"} <= set(eng.stats["last"])


def test_filler_ring_stress(tmp_path, ckpt):
    """Many one-file batches through the 3-slot ring with a tiny thread
    switch interval and more decode threads than cores: every pass gives
    the per-file answers (a slot refilled too early would mix files)."""
    names = _write_corpus(tmp_path, n=12)
    paths = [str(tmp_path / n) for n in names]
    one = _engine(ckpt, batch_size=1, cache_mb=0)
    y_each = np.concatenate([one.predict_paths([p]) for p in paths])
    model, args = load_model_from_tar(ckpt)
    eng = InferenceEngine(model, MsConfig(args), "cpu", batch_size=1, cache_mb=0,
                          num_workers=2 * (os.cpu_count() or 1))
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            y = _run_with_timeout(lambda: eng.predict_paths(paths))
            np.testing.assert_array_equal(y, y_each)
    finally:
        sys.setswitchinterval(prev)


def test_double_ended_not_ported(tmp_path, ckpt):
    """Reference files reach a single-ended model's engine only by mistake:
    it refuses them (double-ended serving: tests/test_torch_de_engine.py)."""
    names = _write_corpus(tmp_path, n=2)
    paths = [str(tmp_path / n) for n in names]
    eng = _engine(ckpt, batch_size=2)
    for call in (eng.predict_paths, eng.plan, eng.warmup):
        with pytest.raises(ValueError, match="single-ended"):
            call(paths[:1], paths[1:])
