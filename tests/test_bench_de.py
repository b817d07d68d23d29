"""The benchmark's double-ended cell (``de_corpus_cold``) on the CPU: the
plain NISQA_DE reference against the port, the pair recipe, the work
counts, the cell's metric readers, and whole tiny runs of the cell (a sound
program, a program without the engine's double-ended counters, and the
planted fault)."""

import os
import time

import numpy as np
import pytest
import torch

from benchmark import corpus, corpus_pairs, harness
from benchmark.counts.work_de import PairTally, pair_flops
from benchmark.reference import nisqa_de_ref as de_ref
from benchmark.reference import nisqa_ref as ref
from benchmark.weights import make_state

CELL = "de_corpus_cold"
DE_READERS = ("align_ms.de", "fill_ref_ms.de", "trunk_pad_pct.de", "mfu_pct.de",
              "dft_mel_roofline.de", "device_idle_pct.de")
COUNTER_READERS = ("align_ms.de", "fill_ref_ms.de", "trunk_pad_pct.de")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args():
    return harness.Cell(CELL).config["args"]


def _tiny(pairs=3):
    c = harness.Cell(CELL)
    c.traffic.update(pairs=pairs, seconds_lo=3.0, seconds_hi=4.0, batch_size=2)
    return c


def _port_model(args, state):
    from nisqa_tpu_torch.models.nisqa import build_model

    m = build_model("NISQA_DE", args)
    m.load_state_dict(state, strict=True)
    return m.eval()


# ---------------------------------------------------------------------------
# the reference against the port
# ---------------------------------------------------------------------------


def test_the_spec_is_the_ports_state_dict():
    from nisqa_tpu_torch.models.nisqa import build_model

    args = _args()
    spec = de_ref.param_spec(args)
    want = build_model("NISQA_DE", args).state_dict()
    assert {n: tuple(s) for n, s, _ in spec} == {n: tuple(v.shape) for n, v in want.items()}
    assert len(spec) == len(want)
    assert dict((n, s) for n, s, _ in spec)["time_dependency_2.model.linear.weight"] == (64, 192)


@pytest.mark.parametrize("n_deg,n_ref", [(23, 23), (9, 31), (40, 17)],
                         ids=["equal", "reference_longer", "degraded_longer"])
def test_the_model_equals_the_ports_on_the_same_segments(n_deg, n_ref, one_thread):
    """The port's ``forward_ends`` on padded segments against the reference
    on each end's own: float32 on both sides, so only the order of the
    sums differs (the dense CNN of the padded batch and the masked
    attentions against the unpadded ones); 2e-5 as for the single-ended
    model. The alignment moves the answer by far more than that."""
    args = _args()
    state = make_state(de_ref.param_spec(args), 4, "cpu", "trained")
    m = _port_model(args, state)
    g = torch.Generator().manual_seed(n_deg * 100 + n_ref)
    segs_d = torch.randn(n_deg, 48, 15, generator=g) * 10
    segs_r = torch.randn(n_ref, 48, 15, generator=g) * 10
    t = max(n_deg, n_ref) + 3  # the bucket pads both ends
    x_d, x_r = torch.zeros(1, t, 48, 15), torch.zeros(1, t, 48, 15)
    x_d[0, :n_deg], x_r[0, :n_ref] = segs_d, segs_r
    with torch.no_grad():
        port = m.forward_ends(x_d, torch.tensor([n_deg]), x_r, torch.tensor([n_ref]))
        mine = de_ref.predict(state, args, [(segs_d, segs_r)])
        unaligned = de_ref.predict(state, args, [(segs_d, segs_r)], skip_align=True)
    assert torch.allclose(port, mine, atol=2e-5, rtol=1e-5), (port, mine)
    assert float((mine - unaligned).abs().max()) > 1e-3


def _write_pairs(tmp, pcm_d, pcm_r, sr):
    deg = [str(tmp / f"deg_{i}.wav") for i in range(len(pcm_d))]
    refs = [str(tmp / f"ref_{i}.wav") for i in range(len(pcm_r))]
    for paths, pcm in ((deg, pcm_d), (refs, pcm_r)):
        for p, x in zip(paths, pcm):
            corpus.write_wav(p, x, sr)
    return deg, refs


@pytest.mark.parametrize("case", ["recipe_pairs", "reference_longer", "degraded_longer"])
def test_served_through_load_predictor_equals_the_reference(tmp_path, case, one_thread):
    """The port's NISQA_DE served as a user serves it (``load_predictor`` on
    a reference-format ``.tar``, ``(paths, paths_ref)``) at "highest" with
    the exact front end, against the reference on each end's own samples.
    The two front ends sum the DFT over the same samples in another order
    and the port's over its kept bins padded to 128 (dB within 2e-3 at
    48 kHz, ``test_bench_reference``); the trunk carries that into the
    features, the hard argmax can then take a near-tied reference segment
    of the same stretch, whose features are nearly the same: 2e-4."""
    from nisqa_tpu_torch import load_predictor

    args, sr = _args(), 48000
    if case == "recipe_pairs":
        mix = {**harness.Cell(CELL).traffic, "pairs": 3}
        n_deg = np.array([48000 * 3 + 17, 48000 * 4 + 5, 48000 * 3 + 4000])
        pcm_d, pcm_r = corpus_pairs.synth(n_deg, np.array([4800, 0, 14400]), sr, mix, 7, "cpu")
    else:
        long_, short = 48000 * 4 + 333, 48000 * 3 + 71
        n_d, n_r = (short, long_) if case == "reference_longer" else (long_, short)
        pcm_d = corpus.synth(np.array([n_d]), sr, 8, "cpu")
        pcm_r = corpus.synth(np.array([n_r]), sr, 9, "cpu")
    deg, refs = _write_pairs(tmp_path, pcm_d, pcm_r, sr)
    state = make_state(de_ref.param_spec(args), 5, "cpu", "trained")
    tar = str(tmp_path / "de.tar")
    torch.save({"args": {**args, "model": "NISQA_DE", "name": "NISQA_DE"},
                "model_state_dict": state, "model_name": "NISQA_DE"}, tar)
    predict = load_predictor(tar, batch_size=2, tr_device="cpu", precision="highest", cache_mb=0)
    assert predict.engine.fe_precision == "exact"
    y = predict(deg, refs)
    fe = ref.FrontEnd(args, sr, "cpu")
    pairs = [(ref.segments(fe.db(d), 15, 4), ref.segments(fe.db(r), 15, 4))
             for d, r in zip(pcm_d, pcm_r)]
    want = de_ref.predict(state, args, pairs).numpy()
    assert y.shape == (len(deg), 1)
    np.testing.assert_allclose(y, want, atol=2e-4)


# ---------------------------------------------------------------------------
# the pair recipe
# ---------------------------------------------------------------------------


def test_every_seed_gets_the_same_lengths_and_delays_in_another_order():
    mix = harness.Cell(CELL).traffic
    n, sr = mix["pairs"], mix["sr"]

    def draw(seed):
        return (corpus.lengths(n, mix["seconds_lo"], mix["seconds_hi"], mix["dist"], sr,
                               corpus.seed_stream(seed, 1)),
                corpus_pairs.delays(n, mix["delay_s_lo"], mix["delay_s_hi"], sr,
                                    corpus.seed_stream(seed, 4)))

    (la, da), (lb, db), (lc, dc) = draw(2 ** 31 + 5), draw(2 ** 31 + 5), draw(12)
    assert np.array_equal(la, lb) and np.array_equal(da, db)
    assert not np.array_equal(la, lc) and not np.array_equal(da, dc)
    assert np.array_equal(np.sort(la), np.sort(lc)) and np.array_equal(np.sort(da), np.sort(dc))
    assert 0 <= da.min() and da.max() <= 0.3 * sr and len(set(da.tolist())) == n
    assert 2000 < la.sum() / sr < 2400  # about half of dim_corpus_cold's 4,500 audio-s


def test_the_pairs_are_a_delayed_damaged_noisy_source(tmp_path):
    """Both ends from the seed alone; the reference is the degraded length
    less the delay; the degraded end holds the source after its delay (at
    the highest SNR the noise is small), with whole 20 ms frames zeroed."""
    mix = {**harness.Cell(CELL).traffic, "pairs": 2, "snr_db_lo": 60.0, "snr_db_hi": 60.0}
    n, d = np.array([48000 * 3, 48000 * 4 + 99]), np.array([960 * 5 + 7, 0])
    a = corpus_pairs.synth(n, d, 48000, mix, 3, "cpu")
    b = corpus_pairs.synth(n, d, 48000, mix, 3, "cpu")
    c = corpus_pairs.synth(n, d, 48000, mix, 4, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))
    assert not np.array_equal(a[1][0], c[1][0])
    deg, refs = a
    assert [len(x) for x in deg] == n.tolist() and [len(x) for x in refs] == (n - d).tolist()
    for x, r, dl in zip(deg, refs, d.tolist()):
        src, got = r.astype(np.float64), x[dl:].astype(np.float64)
        frames = np.abs(x[: len(x) // 960 * 960].astype(np.float64)).reshape(-1, 960).max(axis=1)
        lost = frames < 40  # zeroed: the noise alone, 60 dB under
        assert 0 < lost[dl // 960 + 1:].sum() <= round(0.02 * (len(x) // 960)) + 1
        kept = np.ones(len(got), bool)
        for f in np.nonzero(lost)[0]:
            kept[max(0, f * 960 - dl):max(0, (f + 1) * 960 - dl)] = False
        assert np.abs(got[kept] - src[kept]).max() < 100
    # the source's pitch jumps: the dominant frequency differs between stretches
    r = refs[1].astype(np.float64)
    peaks = {int(np.argmax(np.abs(np.fft.rfft(r[i:i + 4800])))) for i in range(0, len(r) - 4800, 4800)}
    assert len(peaks) >= 3


# ---------------------------------------------------------------------------
# the work counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 150, 749])
def test_pair_flops_equal_the_port_tool_at_unpadded_shapes(n):
    from nisqa_tpu_torch.models.nisqa import build_model
    from nisqa_tpu_torch.tools.flops import forward_flops

    args = _args()
    port = forward_flops(build_model("NISQA_DE", args), 1, n, args["ms_n_mels"], args["ms_seg_length"])
    assert pair_flops(args, n, n) == sum(port.values())


def test_the_tally_counts_each_ends_own_segments_and_frames():
    args = _args()
    t = PairTally(args, 48000)
    one = t.of([48000 * 4], [48000 * 3], True)
    fe = t.fe
    assert one["model"] == pair_flops(args, fe.segments(48000 * 4), fe.segments(48000 * 3))
    assert one["dft"] == fe.dft_flops(48000 * 4) + fe.dft_flops(48000 * 3)
    assert pair_flops(args, 90, 80) - pair_flops(args, 90, 79) > 0
    two = t.of([48000 * 4] * 2, [48000 * 3] * 2, False)
    assert all(two[k] == 2 * t.of([48000 * 4], [48000 * 3], False)[k] for k in one)


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------


def _reader(name):
    return harness.load_file(os.path.join(harness.HERE, "metrics", name + ".py"), f"metric_{name}")


class _Run:
    def __init__(self, stats, **kw):
        self.stats, self.trace, self.work, self.window_s = stats, None, None, 0.0
        self.__dict__.update(kw)


PARENT_PASS = {"mode": "interleaved", "batches": 6, "wall_s": 0.25, "scan_plan_s": 0.01,
               "fill_s": 0.1, "wait_s": 0.04, "dispatch_s": 0.03, "head_s": 0.05,
               "first_wait_s": 0.02, "ready_batches": 2, "fill_decode_s": 0.09,
               "fill_slot_s": 0.004}


@pytest.mark.parametrize("name", DE_READERS)
def test_a_reader_is_silent_without_its_key(name):
    read = _reader(name).read
    assert read(_Run([])) is None
    assert read(_Run([PARENT_PASS, dict(PARENT_PASS)])) is None
    assert read(object()) is None


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_a_counter_reader_means_its_keys(name):
    passes = [{**PARENT_PASS, "fill_decode_ref_s": 0.04, "trunk_rows": 1000, "own_rows": 900,
               "align_device_s": 0.002},
              {**PARENT_PASS, "fill_decode_ref_s": 0.05, "trunk_rows": 1000, "own_rows": 800}]
    want = {"align_ms.de": 2.0, "fill_ref_ms.de": 45.0, "trunk_pad_pct.de": 15.0}[name]
    assert _reader(name).read(_Run(passes + [PARENT_PASS])) == pytest.approx(want)


# ---------------------------------------------------------------------------
# whole tiny runs
# ---------------------------------------------------------------------------


def _parent_shaped(monkeypatch):
    """The engine's ``_note_pass`` without the double-ended counters, as the
    parent's."""
    from nisqa_tpu_torch.data import pipeline

    orig = pipeline.InferenceEngine._note_pass
    keys = ("fill_decode_ref_s", "trunk_rows", "own_rows", "align_device_s")

    def note(self, mode, n_files, n_batches, t0, t_plan, t_end, timings=None):
        kept = {k: v for k, v in (timings or {}).items() if k not in keys}
        return orig(self, mode, n_files, n_batches, t0, t_plan, t_end, kept)

    monkeypatch.setattr(pipeline.InferenceEngine, "_note_pass", note)


@pytest.mark.parametrize("parent", [False, True], ids=["change", "parent_shaped"])
def test_a_traced_run_is_correct_and_carries_the_cells_metrics(monkeypatch, parent):
    """A sound program comes out correct with every metric the CPU can read
    (no kernel and no CUDA event here); a program without the counters
    leaves their three metrics out and keeps the others."""
    if parent:
        _parent_shaped(monkeypatch)
    cell = _tiny()
    res = harness.run_cell(cell, 2 ** 31 + 9, 1.0, True, time.perf_counter(), device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 3, res["check"]
    got = set(res["metrics"])
    assert {"mfu_pct.de", "device_idle_pct.de"} <= got
    assert ({"fill_ref_ms.de", "trunk_pad_pct.de"} <= got) != parent
    assert not {"align_ms.de", "dft_mel_roofline.de"} & got  # card only
    assert list(res)[-1] == "check" and set(res["check"]) == {"pred_gap"}
    assert 0 < res["metrics"]["mfu_pct.de"]["value"] < 100


def test_an_untraced_run_reports_the_end_to_end_metrics():
    res = harness.run_cell(_tiny(2), 17, 0.5, False, time.perf_counter(), device="cpu")
    assert set(res["metrics"]) == {"setup_s", "score_audio_s_per_s"} and res["correct"]


@pytest.mark.parametrize("fault", ["align_skipped", "bf16"])
def test_the_controls_fail_the_limit(tmp_path, fault):
    """The reference with the alignment left out, and the reference in
    bfloat16, each put in the program's place."""
    from benchmark.drivers.pair_passes import PairScoring

    cell = _tiny()
    ctx = harness.Ctx(cell, 2 ** 31 + 21, 1.0, False, "cpu", time.perf_counter(), str(tmp_path))
    sc = PairScoring(ctx)
    files = list(range(len(sc.paths)))
    y = (sc.reference(files, skip_align=True) if fault == "align_skipped"
         else sc.reference(files, torch.bfloat16))
    assert sc.gap(y, files) > cell.limits["pred_gap"]
