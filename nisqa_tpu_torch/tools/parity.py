"""Corpus parity of the port against ``nisqa_tpu``, and its drift gate.

Counterpart of ``tools/measure_parity.py --corpus`` and of the gate that
reads its record, ``tests/test_parity_regression.py``. The released
checkpoints serve the JAX tools' corpora (``tools/corpus.py``, byte for
byte) through :func:`nisqa_tpu_torch.load_predictor`, and each key's
predictions are compared, row by row in corpus order, with ``nisqa_tpu``'s
on the same files:

  * ``nisqa.tar`` (``g2_dim.npz``) and ``nisqa_mos_only.tar``
    (``g1_mos_only.npz``) at the yaml geometry over the 384-file bench
    corpus at bs 32: ``::exact`` and ``::fast`` at precision "default" with
    that front-end, ``::highest`` at "highest";
  * ``nisqa_tts.tar`` (``g3_tts.npz``) at its checkpoint geometry over 32
    TTS clips of 10-40 s at bs 8: ``::exact``, precision "default", which
    the LSTM rule upgrades to "highest";
  * ``de_trained.tar`` (``tests/goldens/de_trained.tar``) over the 96 DE
    pairs, written portably (``corpus.de_corpus(portable=True)``), at bs
    32: ``::auto`` at "default" with the front-end by precision,
    ``::highest`` at "highest";
  * ``nisqa.tar@16k::exact``: ``nisqa.tar`` over the bench recipe sampled at
    16 kHz (128 files, bs 32), the front-end's other main geometry (K 2,049);
  * ``nisqa_dim80.tar::exact``: a seeded NISQA_DIM at 80 mel bands
    (``g2_dim``'s weights perturbed from seed 80, ``corpus.golden_tar``)
    over the bench corpus: more bands than the kernel's 64-band tile.

Every key runs on a fresh predictor with ``cache_mb=0`` and 4 decode
workers, so each pass is cold and launches the DFT->mel kernel once per
batch and end. A leading subset of a corpus (``--n-bench``, ``--n-tts``,
``--n-de``) smaller than the batch size runs as one batch of its own size:
rows do not interact in eval, and the padding rows would only cost time.

The reference side is not computed here: ``parity_ref.npz`` beside this
file holds ``nisqa_tpu``'s predictions on the CPU at precision "highest"
with ``fe_precision="exact"`` (float32 throughout), one array per
checkpoint, and the sha256 of every corpus file. The tool refuses to
compare a corpus whose files hash otherwise. ``python
tests/test_torch_parity_corpus.py --record-reference`` regenerates it.

Per key the record has ``tests/goldens/parity_corpus.json``'s fields (``n``,
``precision`` and ``fe`` as asked, ``mos_mae``, ``max_abs`` over every
output, ``pearson_r`` of MOS) with ``mae_per_output``, and the pass's kernel
``launches`` and plan ``batches``; ``_meta`` names the card and its power
limit, the torch and CUDA versions and the date. Each key is held to the
JAX gate's budget (MOS MAE below, Pearson r above); ``--check-record``
applies its drift bound against a recorded run, and fails when a recorded
key is missing from this one.

Usage: python -m nisqa_tpu_torch.tools.parity [--device cpu] [--n-bench 384]
    [--n-tts 32] [--n-de 96] [--n-bench16k 128] [--record PATH] [--check-record PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import load_predictor
from ..model import resolve_device
from ..ops.dft_mel import fused_dft_mel
from . import corpus, measure
from .bench_de import DE_TAR

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(HERE, "parity_ref.npz")
H100_RECORD = os.path.join(HERE, "parity_h100.json")

# corpus -> (files or pairs, batch size, folder under --corpus-dir): measure_parity.py's
# sizes; the DE pairs are written portably, so not into bench_de's folder; the 16 kHz
# bench files are a third of the 48 kHz count, which keeps the pass a few seconds
CORPORA = {"bench": (384, 32, "bench"), "tts": (32, 8, "bench_tts"), "de": (96, 32, "parity_de"),
           "bench16k": (128, 32, "bench_16k")}
# checkpoint -> the corpus it serves; "<tar>@16k" serves <tar> over the 16 kHz corpus
CHECKPOINT_CORPUS = {"nisqa.tar": "bench", "nisqa_mos_only.tar": "bench",
                     "nisqa_tts.tar": "tts", "de_trained.tar": "de",
                     "nisqa.tar@16k": "bench16k", "nisqa_dim80.tar": "bench"}
# key -> (precision, fe_precision): the JAX record's keys, and "highest" for the single-ended
KEYS = {
    "nisqa.tar::exact": ("default", "exact"),
    "nisqa.tar::fast": ("default", "fast"),
    "nisqa.tar::highest": ("highest", None),
    "nisqa_mos_only.tar::exact": ("default", "exact"),
    "nisqa_mos_only.tar::fast": ("default", "fast"),
    "nisqa_mos_only.tar::highest": ("highest", None),
    "nisqa_tts.tar::exact": ("default", "exact"),
    "de_trained.tar::auto": ("default", None),
    "de_trained.tar::highest": ("highest", None),
    "nisqa.tar@16k::exact": ("default", "exact"),
    "nisqa_dim80.tar::exact": ("default", "exact"),
}
# tests/test_parity_regression.py's budgets, (MOS MAE below, Pearson r above), by checkpoint;
# every "highest" key is held to the repo's 1e-3 parity invariant at "highest"
BUDGET = {"nisqa.tar": (0.01, 0.999), "nisqa_mos_only.tar": (0.01, 0.999),
          "nisqa_tts.tar": (1e-3, 0.9999), "de_trained.tar": (0.02, 0.999),
          "nisqa.tar@16k": (0.01, 0.999), "nisqa_dim80.tar": (0.01, 0.999)}
HIGHEST_BUDGET = (1e-3, 0.9999)
# the JAX gate's drift bound: MOS MAE <= 3 x recorded + 2e-4
DRIFT_FACTOR, DRIFT_SLACK = 3.0, 2e-4


class ParityFailure(RuntimeError):
    pass


def budget_for(key: str):
    """(MOS MAE below, Pearson r above) of a key."""
    if key.endswith("::highest"):
        return HIGHEST_BUDGET
    return BUDGET[key.split("::")[0]]


def write_checkpoints(out_dir: str) -> dict:
    """{checkpoint name: path} (``CHECKPOINT_CORPUS``'s names): the goldens'
    released weights as ``.tar`` files at their geometries, the seeded
    80-mel NISQA_DIM, and the trained DE ``.tar``."""
    def tar(golden, geometry, name, label=None, seed=None):
        return corpus.golden_tar(golden, geometry, os.path.join(out_dir, name), label, seed)

    nisqa = tar("g2_dim", corpus.YAML_GEOMETRY, "nisqa.tar")
    return {"nisqa.tar": nisqa, "nisqa.tar@16k": nisqa,
            "nisqa_mos_only.tar": tar("g1_mos_only", corpus.YAML_GEOMETRY, "nisqa_mos_only.tar"),
            "nisqa_tts.tar": tar("g3_tts", corpus.TTS_GEOMETRY, "nisqa_tts.tar", "NISQA_TTS"),
            "de_trained.tar": DE_TAR,
            "nisqa_dim80.tar": tar("g2_dim", corpus.MEL80_GEOMETRY, "nisqa_dim80.tar",
                                   "NISQA_DIM_80", seed=80)}


def write_corpora(corpus_dir: str, sizes: dict) -> dict:
    """{corpus: (paths, reference paths or None)}: the leading ``sizes[c]``
    files (DE: pairs) of each corpus under ``corpus_dir``, written where
    missing."""
    folder = {c: os.path.join(corpus_dir, CORPORA[c][2]) for c in CORPORA}
    _, bench = corpus.bench_corpus(folder["bench"], sizes["bench"])
    _, tts = corpus.tts_corpus(folder["tts"], sizes["tts"])
    _, deg, ref, _ = corpus.de_corpus(folder["de"], sizes["de"], portable=True)
    _, bench16k = corpus.bench_corpus(folder["bench16k"], sizes["bench16k"], sr=16000)
    return {"bench": (bench, None), "tts": (tts, None), "de": (deg, ref),
            "bench16k": (bench16k, None)}


def corpus_files(paths, paths_ref):
    """The files of a corpus in order: each file, or each pair as (degraded, reference)."""
    return [(p,) for p in paths] if paths_ref is None else list(zip(paths, paths_ref))


def digests(files):
    """(per-file sha256 hex digests, shaped like ``files``; the sha256 over
    every file's bytes in order)."""
    total, rows = hashlib.sha256(), []
    for row in files:
        out = []
        for p in row:
            with open(p, "rb") as f:
                data = f.read()
            total.update(data)
            out.append(hashlib.sha256(data).hexdigest())
        rows.append(out)
    return np.array(rows), total.hexdigest()


def check_corpus(ref, meta: dict, name: str, files):
    """Raise unless the leading files of corpus ``name`` are the bytes the
    reference was made from (the whole corpus also by its total hash)."""
    per_file, total = digests(files)
    want = ref[f"sha256::{name}"]
    if len(files) > len(want):
        raise ParityFailure(f"corpus {name}: {len(files)} files asked for, the reference has "
                            f"{len(want)}")
    bad = np.flatnonzero((per_file != want[: len(files)]).any(axis=1))
    if bad.size:
        raise ParityFailure(f"corpus {name}: file(s) {[list(files[i]) for i in bad[:4]]} differ "
                            "from those the reference was made from; not compared")
    if len(files) == len(want) and total != meta["corpora"][name]["sha256"]:
        raise ParityFailure(f"corpus {name}: its sha256 {total} is not the reference's")


def compare(y, ref) -> dict:
    """``parity_corpus.json``'s metric fields of predictions ``y`` against ``ref``, both (n, k)."""
    d = np.abs(np.asarray(y, np.float64) - np.asarray(ref, np.float64))
    return {"mos_mae": float(d[:, 0].mean()), "max_abs": float(d.max()),
            "pearson_r": float(np.corrcoef(y[:, 0], ref[:, 0])[0, 1]),
            "mae_per_output": [float(v) for v in d.mean(axis=0)]}


def load_reference():
    """(arrays, meta) of the stored reference."""
    with np.load(REFERENCE, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "meta"}
        meta = json.loads(str(z["meta"]))
    return arrays, meta


def failures(record: dict, baseline: dict | None = None) -> list:
    """What breaks a budget in ``record``; with a ``baseline`` record, also
    each key over the drift bound, each key of one record missing from the
    other, and each key measured over another corpus size."""
    keys = {k: v for k, v in record.items() if not k.startswith("_")}
    out = []
    for key, m in keys.items():
        mae, r = budget_for(key)
        if not (m["mos_mae"] < mae and m["pearson_r"] > r):
            out.append(f"{key}: mos_mae {m['mos_mae']} (budget < {mae}), pearson_r "
                       f"{m['pearson_r']} (budget > {r})")
    if baseline is None:
        return out
    base = {k: v for k, v in baseline.items() if not k.startswith("_")}
    out += [f"{k}: recorded, not measured" for k in sorted(set(base) - set(keys))]
    out += [f"{k}: measured, not in the recorded baseline" for k in sorted(set(keys) - set(base))]
    for key in sorted(set(keys) & set(base)):
        m, b = keys[key], base[key]
        if m["n"] != b["n"]:
            out.append(f"{key}: n {m['n']}, recorded over n {b['n']}")
        elif m["mos_mae"] > DRIFT_FACTOR * b["mos_mae"] + DRIFT_SLACK:
            out.append(f"{key}: mos_mae {m['mos_mae']} drifted over {DRIFT_FACTOR} x recorded "
                       f"{b['mos_mae']} + {DRIFT_SLACK}")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nisqa_tpu_torch.tools.parity",
                                 description=__doc__.split("\n")[0])
    measure.device_args(ap)
    ap.add_argument("--n-bench", type=int, default=CORPORA["bench"][0],
                    help="leading bench files compared")
    ap.add_argument("--n-tts", type=int, default=CORPORA["tts"][0],
                    help="leading TTS clips compared")
    ap.add_argument("--n-de", type=int, default=CORPORA["de"][0], help="leading DE pairs compared")
    ap.add_argument("--n-bench16k", type=int, default=CORPORA["bench16k"][0],
                    help="leading 16 kHz bench files compared")
    ap.add_argument("--corpus-dir",
                    help="where the corpora are written or reused, in folders bench, bench_tts, "
                         "parity_de and bench_16k (default: under the temporary directory)")
    ap.add_argument("--record", metavar="PATH", help="write the record to PATH")
    ap.add_argument("--check-record", metavar="PATH",
                    help="fail when a key drifts over 3 x its recorded MOS MAE + 2e-4, or a "
                         "recorded key is missing")
    return ap.parse_args(argv)


def run(opts):
    """(record, {key: predictions in corpus order})."""
    sizes = {"bench": opts.n_bench, "tts": opts.n_tts, "de": opts.n_de,
             "bench16k": opts.n_bench16k}
    for name, n in sizes.items():
        if not 2 <= n <= CORPORA[name][0]:  # Pearson r needs two rows
            raise ValueError(f"--n-{name} must be in [2, {CORPORA[name][0]}], got {n}")
    device = resolve_device(opts.device)
    ref, meta = load_reference()
    corpora = write_corpora(opts.corpus_dir or corpus.default_dir("parity"), sizes)
    for name, (paths, paths_ref) in corpora.items():
        check_corpus(ref, meta, name, corpus_files(paths, paths_ref))
    record, predictions = {}, {}
    with tempfile.TemporaryDirectory(prefix="nisqa_parity_") as tmp:
        tars = write_checkpoints(tmp)
        for key, (precision, fe) in KEYS.items():
            tar = key.split("::")[0]
            name = CHECKPOINT_CORPUS[tar]
            paths, paths_ref = corpora[name]
            bs = min(CORPORA[name][1], len(paths))
            predict = load_predictor(tars[tar], batch_size=bs, tr_device=device,
                                     precision=precision, fe_precision=fe, num_workers=4,
                                     cache_mb=0)
            before = fused_dft_mel.LAUNCHES
            t0 = time.perf_counter()
            y = predict(paths, paths_ref)
            wall = time.perf_counter() - t0
            predictions[key] = y
            record[key] = {"n": len(paths), "precision": precision, "fe": fe or "auto",
                           **compare(y, ref[f"ref::{tar}"][: len(paths)]),
                           "launches": fused_dft_mel.LAUNCHES - before,
                           "batches": predict.engine.stats["last"]["batches"]}
            m = record[key]
            measure.log(f"{key:28s} n={m['n']:3d} engine {predict.engine.precision}/"
                        f"{predict.engine.fe_precision} MOS MAE={m['mos_mae']:.6f} "
                        f"max={m['max_abs']:.6f} pearson_r={m['pearson_r']:.7f} "
                        f"launches {m['launches']} for {m['batches']} batches, {wall:.2f} s")
    record["_meta"] = {
        "device": measure.card(device), "torch": torch.__version__, "cuda": torch.version.cuda,
        "recorded": time.strftime("%Y-%m-%d %H:%M:%S"),
        "reference": {k: meta[k] for k in ("made_by", "jax", "jaxlib", "platform", "date")},
    }
    return record, predictions


def main(argv=None) -> dict:
    """Run, print the record as one JSON line, then raise on any budget
    (and, with ``--check-record``, drift) failure; with ``--record`` and no
    failure, write the record there."""
    opts = parse_args(argv)
    record, _ = run(opts)
    print(json.dumps(record, sort_keys=True), flush=True)
    baseline = None
    if opts.check_record:
        with open(opts.check_record) as f:
            baseline = json.load(f)
    bad = failures(record, baseline)
    if bad:
        raise ParityFailure("; ".join(bad))
    if opts.record:
        with open(opts.record, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")
    return record


if __name__ == "__main__":
    main()
