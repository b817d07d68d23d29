"""The port's corpus parity tool (``nisqa_tpu_torch.tools.parity``) and its
stored reference, on the CPU.

* ``parity_ref.npz`` holds ``nisqa_tpu``'s predictions over the JAX tools'
  corpora at precision "highest" with ``fe_precision="exact"``: its shapes,
  keys and ``_meta``; the leading files of each corpus, scored afresh by
  ``nisqa_tpu.load_predictor`` exactly as the record was made, equal the
  stored rows within 1e-6, so the file cannot drift from the JAX package
  unseen.
* The tool over the same subsets with ``--device cpu``, every key: the port
  on the CPU (the kernel's plain twin) against ``nisqa_tpu`` on the CPU at
  the key's settings, inside the key's budget and within 1e-4. For the
  keys with the bf16 front-end that is ``nisqa_tpu``'s Pallas kernel in
  interpret mode: its einsum front-end is float32 on the CPU whatever the
  precision, as the stored reference is.
* A corpus file changed by one byte makes the tool raise; ``--check-record``
  fails on a key over 3 x its recorded MOS MAE + 2e-4 and on a missing key;
  the metric fields equal numpy's; the recorded H100 baseline is within
  budget; importing the tool loads no jax and nothing of ``nisqa_tpu``.

Regenerate the reference (a few CPU minutes; it imports ``nisqa_tpu``):

    JAX_PLATFORMS=cpu python tests/test_torch_parity_corpus.py --record-reference

It computes what the stored file lacks (a new corpus or checkpoint) and
keeps the rest, unless the stored file was made by another jax; then it
computes everything.
"""

import datetime
import inspect
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from nisqa_tpu_torch.tools import corpus, parity  # noqa: E402

# leading files compared on the CPU: bench files, TTS clips, DE pairs, 16 kHz bench files
SUBSET = {"bench": 6, "tts": 2, "de": 4, "bench16k": 6}
FRESH_BOUND = 1e-6     # stored reference vs a fresh nisqa_tpu run
SAME_BOUND = 1e-4      # the port vs nisqa_tpu at a key's settings, on the CPU
# corpus -> (recipe, its arguments other than the folder and size)
RECIPES = {"bench": (corpus.bench_corpus, {}), "tts": (corpus.tts_corpus, {}),
           "de": (corpus.de_corpus, {"portable": True}),
           "bench16k": (corpus.bench_corpus, {"sr": 16000})}


def jax_predictions(tar, paths, paths_ref, batch_size):
    """``nisqa_tpu``'s predictions as the reference is made: "highest",
    the exact front-end, 4 decode workers."""
    import nisqa_tpu

    predict = nisqa_tpu.load_predictor(tar, batch_size=batch_size, precision="highest",
                                       fe_precision="exact", num_workers=4)
    return np.asarray(predict(paths, paths_ref), np.float32)


def record_reference(path=parity.REFERENCE):
    """Write ``parity_ref.npz``: every corpus in full, each checkpoint's
    ``nisqa_tpu`` predictions over its corpus, the corpus hashes, ``meta``.
    The entries of a stored file made by this jax are kept; the meta's
    ``date`` is then that of the newest entry."""
    import jax
    import jaxlib

    arrays, corpora_meta = {}, {}
    if os.path.exists(path):
        stored, stored_meta = parity.load_reference()
        if (stored_meta["jax"], stored_meta["jaxlib"]) == (jax.__version__, jaxlib.__version__):
            arrays, corpora_meta = stored, stored_meta["corpora"]
    with tempfile.TemporaryDirectory(prefix="nisqa_parity_ref_") as tmp:
        corpora = parity.write_corpora(tmp, {c: v[0] for c, v in parity.CORPORA.items()})
        tars = parity.write_checkpoints(tmp)
        for name, (paths, paths_ref) in corpora.items():
            if name in corpora_meta:
                continue
            per_file, total = parity.digests(parity.corpus_files(paths, paths_ref))
            arrays[f"sha256::{name}"] = per_file
            fn, kwargs = RECIPES[name]
            corpora_meta[name] = {
                "recipe": f"nisqa_tpu_torch/tools/corpus.py::{fn.__name__}",
                "seed": inspect.signature(fn).parameters["seed"].default,
                "n": len(paths), "sha256": total, **kwargs}
        for tar, name in parity.CHECKPOINT_CORPUS.items():
            if f"ref::{tar}" in arrays:
                continue
            paths, paths_ref = corpora[name]
            arrays[f"ref::{tar}"] = jax_predictions(tars[tar], paths, paths_ref,
                                                    parity.CORPORA[name][1])
            print(f"{tar}: {arrays[f'ref::{tar}'].shape}", flush=True)
    meta = {"made_by": "python tests/test_torch_parity_corpus.py --record-reference",
            "jax": jax.__version__, "jaxlib": jaxlib.__version__,
            "platform": jax.devices()[0].platform,
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": "highest", "fe_precision": "exact", "num_workers": 4,
            "batch_size": {c: v[1] for c, v in parity.CORPORA.items()}, "corpora": corpora_meta}
    np.savez_compressed(path, meta=np.array(json.dumps(meta, sort_keys=True)), **arrays)
    print(f"wrote {path}", flush=True)


# -- fixtures -------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several workers on
    a shared CPU, where torch's default of a thread per core oversubscribes
    it and small ops slow down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    return parity.load_reference()


@pytest.fixture(scope="module")
def subset(tmp_path_factory):
    """(corpus folder, {corpus: (paths, reference paths)}, {checkpoint: .tar}):
    the leading files of each corpus and the checkpoints."""
    tmp = tmp_path_factory.mktemp("parity")
    corpus_dir = str(tmp / "corpora")
    return corpus_dir, parity.write_corpora(corpus_dir, SUBSET), parity.write_checkpoints(str(tmp))


@pytest.fixture(scope="module")
def port(subset):
    """(record, {key: predictions}): the tool over the subsets on the CPU, no budget check."""
    return parity.run(parity.parse_args(
        ["--device", "cpu", "--n-bench", str(SUBSET["bench"]), "--n-tts", str(SUBSET["tts"]),
         "--n-de", str(SUBSET["de"]), "--n-bench16k", str(SUBSET["bench16k"]),
         "--corpus-dir", subset[0]]))


def fast_front_end(key):
    """Whether a key's engine runs the bf16 DFT: "fast" asked for, or left to "default"."""
    precision, fe = parity.KEYS[key]
    return fe == "fast" or (fe is None and precision == "default")


@pytest.fixture(scope="module")
def jax_fast(subset):
    """{checkpoint: nisqa_tpu's predictions with its bf16 front-end}: at precision "default"
    through its Pallas kernel in interpret mode (``pallas_mel=True``), bf16 operands as on its
    chip; its plain einsum front-end runs float32 on the CPU whatever the precision."""
    import nisqa_tpu

    _, corpora, tars = subset
    out = {}
    for tar in sorted({k.split("::")[0] for k in parity.KEYS if fast_front_end(k)}):
        paths, paths_ref = corpora[parity.CHECKPOINT_CORPUS[tar]]
        predict = nisqa_tpu.load_predictor(tars[tar], batch_size=len(paths), precision="default",
                                           fe_precision="fast", pallas_mel=True, num_workers=4)
        out[tar] = np.asarray(predict(paths, paths_ref), np.float32)
    return out


def _key(mos_mae, n=384):
    return {"n": n, "precision": "default", "fe": "exact", "mos_mae": mos_mae,
            "max_abs": 2 * mos_mae, "pearson_r": 0.99999, "mae_per_output": [mos_mae],
            "launches": 12, "batches": 12}


def _record(**over):
    """A record of every key at a MOS MAE of 1e-4, with ``over``'s keys replaced."""
    rec = {k: _key(1e-4) for k in parity.KEYS}
    rec.update(over)
    rec["_meta"] = {"device": "test"}
    return rec


# -- the stored reference ---------------------------------------------------------------


def test_reference_layout(reference):
    arrays, meta = reference
    outputs = {"nisqa.tar": 5, "nisqa_mos_only.tar": 1, "nisqa_tts.tar": 1, "de_trained.tar": 1,
               "nisqa.tar@16k": 5, "nisqa_dim80.tar": 5}
    ends = {"bench": 1, "tts": 1, "de": 2, "bench16k": 1}
    assert set(arrays) == ({f"ref::{t}" for t in outputs} | {f"sha256::{c}" for c in ends})
    for tar, k in outputs.items():
        y = arrays[f"ref::{tar}"]
        assert y.shape == (parity.CORPORA[parity.CHECKPOINT_CORPUS[tar]][0], k)
        assert y.dtype == np.float32 and np.isfinite(y).all()
        assert np.ptp(y[:, 0]) > 0.1  # the corpus spans a range of scores
    for name, e in ends.items():
        n, bs, _ = parity.CORPORA[name]
        assert arrays[f"sha256::{name}"].shape == (n, e)
        assert meta["corpora"][name]["n"] == n and meta["batch_size"][name] == bs
        assert len(meta["corpora"][name]["sha256"]) == 64
    assert meta["corpora"]["tts"]["seed"] == 3 and meta["corpora"]["bench"]["seed"] == 0
    assert meta["corpora"]["bench16k"]["sr"] == 16000
    assert (meta["platform"], meta["precision"], meta["fe_precision"]) == \
        ("cpu", "highest", "exact")
    assert meta["made_by"] == "python tests/test_torch_parity_corpus.py --record-reference"


@pytest.mark.parametrize("tar", sorted(parity.CHECKPOINT_CORPUS))
def test_reference_matches_a_fresh_nisqa_tpu_run(reference, subset, tar):
    arrays, meta = reference
    _, corpora, tars = subset
    name = parity.CHECKPOINT_CORPUS[tar]
    paths, paths_ref = corpora[name]
    # the subset is the leading files of the corpus the reference was made from
    assert (parity.digests(parity.corpus_files(paths, paths_ref))[0]
            == arrays[f"sha256::{name}"][: len(paths)]).all()
    y = jax_predictions(tars[tar], paths, paths_ref, meta["batch_size"][name])
    np.testing.assert_allclose(y, arrays[f"ref::{tar}"][: len(paths)], rtol=0, atol=FRESH_BOUND)


# -- the port against the reference -------------------------------------------------------


@pytest.mark.parametrize("key", list(parity.KEYS))
def test_port_key_against_nisqa_tpu(port, reference, jax_fast, key):
    """The port on the CPU against ``nisqa_tpu`` on the CPU at the key's
    settings: the stored float32 rows, or for a bf16 front-end ``nisqa_tpu``'s
    own fast pass. Inside the key's budget and within 1e-4; and the record,
    against the float32 reference, reports what ``nisqa_tpu`` itself scores
    there (on 4 DE pairs at "default" both are 0.0239 off the float32 pass)."""
    record, predictions = port
    m, y = record[key], predictions[key]
    tar = key.split("::")[0]
    precision, fe = parity.KEYS[key]
    ref = reference[0][f"ref::{tar}"][: len(y)]
    assert m["n"] == len(y) == SUBSET[parity.CHECKPOINT_CORPUS[tar]]
    assert (m["precision"], m["fe"]) == (precision, fe or "auto")
    assert y.shape[1] == len(m["mae_per_output"]) == (
        5 if tar in ("nisqa.tar", "nisqa.tar@16k", "nisqa_dim80.tar") else 1)
    assert {k: m[k] for k in ("mos_mae", "max_abs", "pearson_r", "mae_per_output")} == \
        parity.compare(y, ref)
    theirs = jax_fast[tar] if fast_front_end(key) else ref
    same = parity.compare(y, theirs)
    mae, r = parity.budget_for(key)
    assert same["mos_mae"] < mae and same["pearson_r"] > r, same
    np.testing.assert_allclose(y, theirs, rtol=0, atol=SAME_BOUND)
    assert abs(m["mos_mae"] - parity.compare(theirs, ref)["mos_mae"]) <= SAME_BOUND
    # the CPU runs the kernel's twin, which counts no launch
    assert m["launches"] == 0 and m["batches"] == 1
    assert record["_meta"]["device"] == "cpu"


@pytest.mark.parametrize("name", sorted(parity.CORPORA))
def test_a_changed_corpus_byte_refuses_the_comparison(tmp_path, name):
    sizes = {"bench": 2, "tts": 2, "de": 2, "bench16k": 2}
    files = parity.corpus_files(*parity.write_corpora(str(tmp_path), sizes)[name])
    path = files[-1][-1]
    with open(path, "r+b") as f:  # one byte of the samples, past the header
        f.seek(1000)
        b = f.read(1)
        f.seek(1000)
        f.write(bytes([b[0] ^ 1]))
    argv = ["--device", "cpu", "--corpus-dir", str(tmp_path)]
    argv += [a for c, n in sizes.items() for a in (f"--n-{c}", str(n))]
    with pytest.raises(parity.ParityFailure, match=f"corpus {name}: .*differ"):
        parity.main(argv)


@pytest.mark.parametrize("argv", [["--n-tts", "1"], ["--n-de", "97"], ["--n-bench", "385"]])
def test_subset_sizes_out_of_range_raise(argv):
    with pytest.raises(ValueError, match="must be in"):
        parity.main(["--device", "cpu", *argv])


def test_a_whole_corpus_is_also_held_to_its_total_hash(subset):
    _, corpora, _ = subset
    files = parity.corpus_files(*corpora["tts"])
    per_file, total = parity.digests(files)
    arrays = {"sha256::tts": per_file}
    parity.check_corpus(arrays, {"corpora": {"tts": {"sha256": total}}}, "tts", files)
    with pytest.raises(parity.ParityFailure, match="its sha256"):
        parity.check_corpus(arrays, {"corpora": {"tts": {"sha256": "0" * 64}}}, "tts", files)
    # more files than the reference holds
    with pytest.raises(parity.ParityFailure, match="asked for"):
        parity.check_corpus({"sha256::tts": per_file[:1]}, {}, "tts", files)


# -- the gate -------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["within", "drift", "missing", "new", "other_n"])
def test_check_record(monkeypatch, tmp_path, capsys, case):
    key = "nisqa.tar::fast"
    base = _record()
    run = _record(**{key: _key(3 * 1e-4 + 2e-4)})  # at the bound: passes
    if case == "drift":
        run[key] = _key(3 * 1e-4 + 2e-4 + 1e-9)
    elif case == "missing":
        del run[key]
    elif case == "new":
        del base[key]
    elif case == "other_n":
        run[key] = _key(1e-4, n=6)
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(base))
    monkeypatch.setattr(parity, "run", lambda opts: (run, {}))
    if case == "within":
        assert parity.main(["--check-record", str(path)]) == run
        return
    want = {"drift": "drifted", "missing": "recorded, not measured",
            "new": "not in the recorded baseline", "other_n": "recorded over n 384"}[case]
    with pytest.raises(parity.ParityFailure, match=want):
        parity.main(["--check-record", str(path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == run  # printed first


def test_record_prints_exactly_what_it_writes(monkeypatch, tmp_path, capsys):
    rec = _record()
    monkeypatch.setattr(parity, "run", lambda opts: (rec, {}))
    path = tmp_path / "rec.json"
    assert parity.main(["--record", str(path)]) is rec
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(path.read_text()) == rec


@pytest.mark.parametrize("key", ["nisqa.tar::exact", "nisqa_tts.tar::exact",
                                 "de_trained.tar::auto", "de_trained.tar::highest"])
def test_a_key_over_budget_fails_and_records_nothing(monkeypatch, tmp_path, key):
    mae, r = parity.budget_for(key)
    rec = _record(**{key: _key(mae)})  # the budget is strict
    monkeypatch.setattr(parity, "run", lambda opts: (rec, {}))
    path = tmp_path / "rec.json"
    with pytest.raises(parity.ParityFailure, match=key):
        parity.main(["--record", str(path)])
    assert not path.exists()
    rec[key] = {**_key(mae / 2), "pearson_r": r}
    assert parity.failures(rec) and key in parity.failures(rec)[0]


def test_budgets_are_the_jax_gates():
    from tests import test_parity_regression as gate

    with open(gate.RECORD) as f:
        jax_keys = {k for k in json.load(f) if not k.startswith("_")}
    assert jax_keys < set(parity.KEYS)
    assert set(parity.KEYS) - jax_keys == {"nisqa.tar::highest", "nisqa_mos_only.tar::highest",
                                           "nisqa.tar@16k::exact", "nisqa_dim80.tar::exact"}
    # the new keys: the default-precision single-ended budget
    for key in ("nisqa.tar@16k::exact", "nisqa_dim80.tar::exact"):
        assert parity.budget_for(key) == gate._budget_for("nisqa.tar::exact"), key
    for key in jax_keys:
        assert parity.budget_for(key) == gate._budget_for(key), key
    assert parity.budget_for("nisqa.tar::highest") == gate.KEY_BUDGET["de_trained.tar::highest"]
    assert (parity.DRIFT_FACTOR, parity.DRIFT_SLACK) == (3.0, 2e-4)


def test_metric_fields_against_numpy():
    rng = np.random.default_rng(0)
    ref = rng.uniform(1, 5, (50, 5)).astype(np.float32)
    y = (ref + rng.normal(0, 0.01, ref.shape)).astype(np.float32)
    m = parity.compare(y, ref)
    d = np.abs(y.astype(np.float64) - ref)
    assert m["mos_mae"] == pytest.approx(np.mean(d[:, 0]), rel=1e-12)
    assert m["max_abs"] == pytest.approx(d.max(), rel=1e-12)
    assert m["pearson_r"] == pytest.approx(np.corrcoef(y[:, 0], ref[:, 0])[0, 1], rel=1e-12)
    assert m["mae_per_output"] == pytest.approx(list(d.mean(axis=0)), rel=1e-12)
    # the JAX tool's float32 formulas give the same within float32 rounding
    assert m["mos_mae"] == pytest.approx(float(np.abs(y - ref)[:, 0].mean()), rel=1e-5)


def test_h100_record_is_within_budget():
    with open(parity.H100_RECORD) as f:
        rec = json.load(f)
    assert set(rec) == set(parity.KEYS) | {"_meta"}
    assert parity.failures(rec) == []
    for key, m in rec.items():
        if key != "_meta":
            assert m["n"] == parity.CORPORA[parity.CHECKPOINT_CORPUS[key.split("::")[0]]][0]
            assert m["launches"] == m["batches"] * (2 if key.startswith("de_") else 1)
    assert "H100" in rec["_meta"]["device"] and rec["_meta"]["device"].endswith(" W")


def test_importing_the_tool_loads_no_jax():
    code = ("import sys, torch\n"
            "base = set(sys.modules)\n"
            "import nisqa_tpu_torch.tools.parity\n"
            "print(sorted(m for m in sys.modules if m not in base\n"
            "             and m.split('.')[0] in ('jax', 'jaxlib', 'nisqa_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": REPO}, timeout=120, check=True)
    assert r.stdout.strip() == "[]"


if __name__ == "__main__":
    if sys.argv[1:] != ["--record-reference"]:
        sys.exit("usage: python tests/test_torch_parity_corpus.py --record-reference")
    os.environ["NISQA_TPU_NO_CACHE"] = "1"  # as tests/conftest.py: compile fresh
    import jax

    jax.config.update("jax_platforms", "cpu")
    record_reference()
