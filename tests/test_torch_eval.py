"""predict_csv, the CSV table and evaluate in the port, held against the JAX
package (which uses pandas) on the CPU.

``eval/metrics.py`` is the JAX package's code; ``eval/report.py`` and
``data/dataset.py`` stand in for pandas. The same frames go through both
``eval_results``; the same corpus and checkpoints through both
``predict_csv`` + ``evaluate`` flows and both CLIs.
"""

import csv
import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest

from nisqa_tpu.compat.model_args import model_args_from_ckpt_args
from nisqa_tpu.compat.torch_ckpt import save_torch_checkpoint
from nisqa_tpu.eval import metrics as jax_metrics
from nisqa_tpu.eval.report import eval_results as jax_eval_results
from nisqa_tpu.model import NisqaTPU
from nisqa_tpu.models.nisqa import build_model as build_jax_model
from nisqa_tpu_torch.audio import codec
from nisqa_tpu_torch.data.dataset import Table
from nisqa_tpu_torch.eval import metrics
from nisqa_tpu_torch.eval.report import eval_results
from nisqa_tpu_torch.model import NisqaTorch
from tests.test_e2e import TINY_ARGS, _write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "eval_goldens.json")
MAPPINGS = [None, "first_order", "second_order", "third_order", "third_order_not_monotonic"]
DIMS = ("mos", "noi", "dis", "col", "loud")


def test_metrics_copy_is_the_original():
    names = [n for n, f in inspect.getmembers(jax_metrics, inspect.isfunction)
             if f.__module__ == jax_metrics.__name__]
    assert len(names) >= 8
    for n in names:
        assert inspect.getsource(getattr(metrics, n)) == inspect.getsource(getattr(jax_metrics, n)), n
    rng = np.random.default_rng(1)
    y, y_hat, ci = rng.uniform(1, 5, 40), rng.uniform(1, 5, 40), rng.uniform(0, 0.3, 40)
    for mapping in MAPPINGS:
        b, d = metrics.fit_mapping(y_hat, y, mapping)
        b_ref, d_ref = jax_metrics.fit_mapping(y_hat, y, mapping)
        assert d == d_ref
        np.testing.assert_array_equal(b, b_ref)
    assert metrics.eval_metrics(y, y_hat, y_hat * 0.9, 1, ci) == \
        jax_metrics.eval_metrics(y, y_hat, y_hat * 0.9, 1, ci)


def _frames(seed=0, n=60):
    """Seeded labelled frames: 3 dbs, 4 conditions each, labels and CIs,
    and one db whose file labels are missing."""
    rng = np.random.default_rng(seed)
    db = np.array(["db_b", "db_a", "db_c"] * (n // 3), dtype=object)
    con = np.array([f"c{i % 4}" for i in range(n)], dtype=object)
    mos = rng.uniform(1, 5, n).round(3)
    df = {"db": db, "con": con, "mos": mos, "mos_pred": mos + rng.normal(0, 0.4, n)}
    mos[np.flatnonzero(db == "db_c")[:2]] = np.nan
    cons = [(d, f"c{i}") for d in ("db_a", "db_b", "db_c") for i in range(4)]
    dcon = {"db": np.array([d for d, _ in cons], dtype=object),
            "con": np.array([c for _, c in cons], dtype=object),
            "mos": rng.uniform(1, 5, len(cons)), "mos_ci": rng.uniform(0.05, 0.3, len(cons))}
    return df, dcon


@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("use_con", [False, True])
def test_eval_results_matches_jax(mapping, use_con):
    df, dcon = _frames()
    db_ref, r_ref = jax_eval_results(pd.DataFrame(df), dcon=pd.DataFrame(dcon) if use_con else None,
                                     mapping=mapping)
    table = Table(df)
    db_res, r = eval_results(table, dcon=Table(dcon) if use_con else None, mapping=mapping)
    assert list(r) == list(r_ref)
    for k, v in r_ref.items():
        assert (np.isnan(r[k]) and np.isnan(v)) or abs(r[k] - v) <= 1e-9, (k, r[k], v)
    assert db_res.columns == list(db_ref.columns)
    assert list(db_res["db"]) == list(db_ref["db"])
    for col in db_res.columns[1:]:
        np.testing.assert_allclose(db_res[col], db_ref[col].to_numpy(float), rtol=0, atol=1e-9)
    assert "y_hat_map" in table


@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("use_con", [False, True])
def test_eval_results_meets_reference_goldens(mapping, use_con):
    with open(GOLDEN) as f:
        golden = json.load(f)
    db_res, overall = eval_results(
        Table({k: np.array(v) for k, v in golden["df"].items()}),
        dcon=Table({k: np.array(v) for k, v in golden["dcon"].items()}) if use_con else None,
        target_mos="mos", target_ci="mos_ci", pred="mos_pred", mapping=mapping)
    ref = golden[f"eval_{mapping}_{'con' if use_con else 'file'}"]
    tol = 5e-4 if mapping == "third_order" else 1e-8  # SLSQP is iterative
    for k, v in ref["overall"].items():
        if v is None:
            assert np.isnan(overall[k]), k
        else:
            assert abs(overall[k] - v) < max(tol, abs(v) * tol + 1e-9), (k, overall[k], v)
    for col, ref_vals in ref["db_results"].items():
        if col not in db_res.columns:
            assert all(v is None for v in ref_vals)  # the reference's placeholder columns
            continue
        for ours, v in zip(db_res[col].tolist(), ref_vals):
            if v is None:
                assert np.isnan(ours)
            else:
                assert abs(ours - v) < max(tol, abs(v) * tol + 1e-9), (col, ours, v)


def test_condition_without_files_raises_like_jax():
    """A condition CSV row with no file of its db in the file CSV leaves the
    per-condition fit one label short: both packages raise LinAlgError."""
    df, dcon = _frames()
    keep = ~((df["db"] == "db_a") & (df["con"] == "c3"))
    df = {k: v[keep] for k, v in df.items()}
    with pytest.raises(np.linalg.LinAlgError):
        jax_eval_results(pd.DataFrame(df), dcon=pd.DataFrame(dcon), mapping="first_order")
    with pytest.raises(np.linalg.LinAlgError):
        eval_results(Table(df), dcon=Table(dcon), mapping="first_order")


CSV_CASES = {
    "ints": "a,b\n1,2\n3,-4\n",
    "floats_and_empty": "a,b,c\n1.5,2,\n3,,x\n-1e-3,7,y\n",
    "strings_and_na": "name,v,w\nx.wav,NA,True\n\"y, z.wav\",nan,False\n,null,True\n",
    "mixed": "f,g,h,Unnamed\n1,a,inf,2.50\n2,3,-inf,\n",
}


@pytest.mark.parametrize("case", list(CSV_CASES))
def test_csv_reader_matches_pandas(tmp_path, case):
    path = tmp_path / "t.csv"
    path.write_text(CSV_CASES[case])
    ref = pd.read_csv(path)
    table = Table.read_csv(path)
    assert table.columns == list(ref.columns) and len(table) == len(ref)
    for col in ref.columns:
        got, want = table[col], ref[col]
        if want.dtype.kind in "iufb":
            assert got.dtype == want.dtype, (col, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want.to_numpy())
        else:  # str columns: equal cells, NaN where pandas has NaN
            assert got.dtype == object
            for a, b in zip(got, want):
                assert (pd.isna(a) and pd.isna(b)) or a == b, (col, a, b)
    out = tmp_path / "out.csv"
    table.to_csv(out)
    ref.to_csv(tmp_path / "ref.csv", index=False)
    assert out.read_text() == (tmp_path / "ref.csv").read_text()


# -- predict_csv + evaluate on the e2e corpus ---------------------------------


def _ckpt(tmp, model_name):
    args = {**TINY_ARGS, "model": model_name, "name": f"tiny_{model_name}"}
    model = build_jax_model(model_name, model_args_from_ckpt_args(args))
    params, state = model.init(jax.random.PRNGKey(3))
    path = str(tmp / f"{model_name}.tar")
    save_torch_checkpoint(path, model, params, state, args)
    return path


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    """The e2e corpus (8 files), a labelled file CSV (dbs, conditions, the
    five dimensions and their CIs, an int and a string column) and a
    condition CSV, and a MOS and a DIM checkpoint."""
    tmp = tmp_path_factory.mktemp("torch_eval")
    names = _write_corpus(tmp, n=8)
    rng = np.random.default_rng(6)
    df = pd.DataFrame({"idx": np.arange(8) * 3, "filename": names,
                       "db": ["A"] * 4 + ["B"] * 4, "con": [f"k{i % 2}" for i in range(8)],
                       "note": ["x", None, "y", "z", None, "w", "v", "u"]})
    cons = pd.DataFrame({"db": ["A", "A", "B", "B"], "con": ["k0", "k1", "k0", "k1"]})
    for c in DIMS:
        df[c] = rng.uniform(1, 5, 8).round(2)
        cons[c] = rng.uniform(1, 5, 4)
        cons[f"{c}_ci"] = rng.uniform(0.05, 0.3, 4)
    df.to_csv(tmp / "files.csv", index=False)
    cons.to_csv(tmp / "cons.csv", index=False)
    return tmp, names, {m: _ckpt(tmp, m) for m in ("NISQA", "NISQA_DIM")}


@pytest.mark.parametrize("dim,mos_column", [(False, "mos"), (False, "predict_only"),
                                             (True, "mos"), (True, "predict_only")])
def test_speech_dataset_matches_jax(labelled, dim, mos_column):
    """Paths, targets and the ``*_pred`` columns of the port's dataset over
    its table equal the JAX package's over the DataFrame of the same CSV."""
    from nisqa_tpu.data.dataset import SpeechDataset as JaxSpeechDataset
    from nisqa_tpu_torch.data.dataset import SpeechDataset

    tmp, names, _ = labelled
    kw = dict(data_dir=str(tmp), filename_column="filename", mos_column=mos_column, dim=dim)
    ref = JaxSpeechDataset(pd.read_csv(tmp / "files.csv"), **kw)
    ds = SpeechDataset(Table.read_csv(tmp / "files.csv"), **kw)
    assert len(ds) == len(ref) == 8
    assert ds.paths() == ref.paths() == [str(tmp / n) for n in names]
    assert ds.paths_ref() is ref.paths_ref() is None
    t, t_ref = ds.targets(), ref.targets()
    assert t.dtype == t_ref.dtype == np.float32 and t.shape == t_ref.shape == (8, 5 if dim else 1)
    np.testing.assert_array_equal(t, t_ref)
    y_hat = np.random.default_rng(0).uniform(1, 5, t.shape).astype(np.float32)
    ds.write_predictions(y_hat)
    ref.write_predictions(y_hat)
    preds = [c for c in ref.df.columns if c.endswith("_pred")]
    assert ds.df.columns == list(ref.df.columns) and len(preds) == t.shape[1]
    for c in preds:
        assert ds.df[c].dtype == ref.df[c].dtype == np.float64
        np.testing.assert_array_equal(ds.df[c], ref.df[c].to_numpy())


@pytest.mark.parametrize("model_name", ["NISQA", "NISQA_DIM"])
@pytest.mark.parametrize("use_con", [False, True])
def test_predict_csv_and_evaluate_match_jax(labelled, tmp_path, model_name, use_con, capsys):
    tmp, names, ckpts = labelled
    runs = {}
    for pkg, cls in (("jax", NisqaTPU), ("port", NisqaTorch)):
        out_dir = tmp_path / pkg
        out_dir.mkdir()
        args = {"mode": "predict_csv", "pretrained_model": ckpts[model_name], "data_dir": str(tmp),
                "csv_file": "files.csv", "csv_deg": "filename", "output_dir": str(out_dir),
                "csv_con": "cons.csv" if use_con else None, "tr_bs_val": 3, "tr_num_workers": 1,
                "precision": "highest"}
        if cls is NisqaTorch:
            args["tr_device"] = "cpu"
        runner = cls(args)
        runner.predict()
        runner.evaluate(mapping="first_order", do_print=False)
        runs[pkg] = (runner, pd.read_csv(out_dir / "NISQA_results.csv"), dict(runner.r))

    (jax_runner, ref, ref_r), (runner, got, own_r) = runs["jax"], runs["port"]
    preds = [f"{c}_pred" for c in DIMS] if model_name == "NISQA_DIM" else ["mos_pred"]
    inputs = ["idx", "filename", "db", "con", "note", *DIMS]
    assert list(got.columns) == list(ref.columns) == inputs + preds + ["model"]
    pd.testing.assert_frame_equal(got[inputs + ["model"]], ref[inputs + ["model"]])
    assert np.abs(got[preds].to_numpy() - ref[preds].to_numpy()).max() <= 1e-3

    # evaluate on the same predictions: r within 1e-6, and the same report
    for c in preds:
        runner.ds_val.df[c] = ref[c].to_numpy()
    capsys.readouterr()
    jax_runner.evaluate(mapping="first_order", do_print=True, do_plot=False)
    ref_out = capsys.readouterr().out
    runner.evaluate(mapping="first_order", do_print=True, do_plot=False)
    out = capsys.readouterr().out
    assert list(runner.r) == list(jax_runner.r) == list(own_r)
    for k, v in jax_runner.r.items():
        assert (np.isnan(runner.r[k]) and np.isnan(v)) or abs(runner.r[k] - v) <= 1e-6, (k, v)
    assert out == ref_out
    assert ("Average over MOS and dimensions" in out) == (model_name == "NISQA_DIM")
    # on each package's own predictions r moves with their float32
    # differences (~1e-7), which a tiny random model's narrow prediction
    # spread (~1e-2) amplifies
    for k, v in ref_r.items():
        assert (np.isnan(own_r[k]) and np.isnan(v)) or abs(own_r[k] - v) <= 1e-4, (k, v)


def test_predict_csv_cli_runs_without_jax_or_pandas(labelled, tmp_path):
    """``python -m nisqa_tpu_torch.run_predict --mode predict_csv`` in a
    process where jax, pandas and yaml cannot be imported; its CSV equals
    the JAX CLI flow's within 1e-3 (the checkpoint's default precision)."""
    tmp, names, ckpts = labelled
    argv = ["--mode", "predict_csv", "--pretrained_model", ckpts["NISQA_DIM"], "--data_dir", str(tmp),
            "--csv_file", "files.csv", "--csv_deg", "filename", "--output_dir", str(tmp_path),
            "--bs", "4", "--tr_device", "cpu"]
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['pandas'] = sys.modules['yaml'] = None\n"
        "import runpy\n"
        f"sys.argv = ['run_predict'] + {argv!r}\n"
        "runpy.run_module('nisqa_tpu_torch.run_predict', run_name='__main__', alter_sys=True)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": REPO}, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = pd.read_csv(tmp_path / "NISQA_results.csv")
    ref_dir = tmp_path / "jax"
    ref_dir.mkdir()
    ref = NisqaTPU({"mode": "predict_csv", "pretrained_model": ckpts["NISQA_DIM"],
                    "data_dir": str(tmp), "csv_file": "files.csv", "csv_deg": "filename",
                    "output_dir": str(ref_dir), "tr_bs_val": 4, "tr_num_workers": 0}).predict()
    assert list(got.columns) == list(ref.columns)
    assert list(got["filename"]) == names
    preds = [f"{c}_pred" for c in DIMS]
    assert np.abs(got[preds].to_numpy() - ref[preds].to_numpy()).max() <= 1e-2


def test_predict_dir_lists_the_files_jax_lists(labelled, tmp_path, monkeypatch):
    """With the FFmpeg libraries present both packages also score mp3, ogg,
    m4a and opus files in predict_dir."""
    from nisqa_tpu.audio import codec as jax_codec

    tmp, names, ckpts = labelled
    for name in ("a.wav", "b.flac", "c.mp3", "d.ogg", "e.m4a", "f.opus", "g.txt", "h.aac"):
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setattr(codec, "available", lambda: True)
    monkeypatch.setattr(jax_codec, "available", lambda: True)
    args = {"mode": "predict_dir", "pretrained_model": ckpts["NISQA"], "data_dir": str(tmp_path)}
    ref = NisqaTPU(dict(args)).ds_val.paths()
    got = NisqaTorch({**args, "tr_device": "cpu"}).ds_val.paths()
    assert got == ref and len(got) == 6
    monkeypatch.setattr(codec, "available", lambda: False)
    monkeypatch.setattr(jax_codec, "available", lambda: False)
    assert NisqaTorch({**args, "tr_device": "cpu"}).ds_val.paths() == \
        NisqaTPU(dict(args)).ds_val.paths() == [str(tmp_path / "a.wav"), str(tmp_path / "b.flac")]
