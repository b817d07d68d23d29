"""PyTorch port serving path held against the JAX package on the CPU.

The same corpus and checkpoints go through ``nisqa_tpu`` and
``nisqa_tpu_torch``: the engines' ``predict_paths``, the CLIs'
``NISQA_results.csv``, the reference's error paths, and the port's import
rules (nothing of jax, pandas, yaml or ``nisqa_tpu``; no silent CPU
fallback).
"""

import csv
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nisqa_tpu.audio.wav import write_wav
from nisqa_tpu.compat.model_args import model_args_from_ckpt_args
from nisqa_tpu.compat.torch_ckpt import load_model_from_tar as load_jax_model, save_torch_checkpoint
from nisqa_tpu.data.pipeline import InferenceEngine as JaxEngine, MsConfig as JaxMsConfig
from nisqa_tpu.models.nisqa import build_model as build_jax_model
from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar
from nisqa_tpu_torch.data.pipeline import InferenceEngine, MsConfig
from nisqa_tpu_torch.model import NisqaTorch
from nisqa_tpu_torch.run_predict import main as port_main
from tests.test_e2e import TINY_ARGS, _write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "nisqa_tpu_torch")


def _ckpt(tmp, model_name, seed, n_mels=TINY_ARGS["ms_n_mels"]):
    # "precision" in the checkpoint args is the base config of both CLIs
    args = {**TINY_ARGS, "model": model_name, "name": f"tiny_{model_name}", "precision": "highest",
            "ms_n_mels": n_mels}
    model = build_jax_model(model_name, model_args_from_ckpt_args(args))
    params, state = model.init(jax.random.PRNGKey(seed))
    path = str(tmp / f"{model_name}_{n_mels}.tar")
    save_torch_checkpoint(path, model, params, state, args)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_corpus")
    names = _write_corpus(tmp, n=6)
    # one stereo file takes the f32 transport
    rng = np.random.default_rng(4)
    write_wav(str(tmp / "stereo.wav"), 0.2 * rng.standard_normal((2, 7000)).astype(np.float32), 8000)
    names.append("stereo.wav")
    ckpts = {m: _ckpt(tmp, m, seed) for seed, m in enumerate(("NISQA", "NISQA_DIM"), start=1)}
    # more mel bands than the kernel's 64-band tile: two chunks on the card
    ckpts["NISQA_DIM@80"] = _ckpt(tmp, "NISQA_DIM", 3, n_mels=80)
    return tmp, sorted(names), ckpts


@pytest.mark.parametrize("model_name", ["NISQA", "NISQA_DIM", "NISQA_DIM@80"])
def test_engine_matches_jax_engine(corpus, model_name):
    tmp, names, ckpts = corpus
    paths = [str(tmp / n) for n in names]
    jmodel, params, state, args = load_jax_model(ckpts[model_name])
    assert args["ms_n_mels"] == (80 if model_name.endswith("@80") else TINY_ARGS["ms_n_mels"])
    y_ref = JaxEngine(jmodel, params, state, JaxMsConfig(args), batch_size=4, num_workers=1,
                      precision="highest", fe_precision="exact").predict_paths(paths)
    model, args_t = load_model_from_tar(ckpts[model_name])
    engine = InferenceEngine(model, MsConfig(args_t), "cpu", batch_size=4, num_workers=1,
                             precision="highest", fe_precision="exact")
    plan = engine.plan(paths)
    assert {g[2] for g, _ in plan} == {"i16", "f32"}
    assert sorted(i for _, chunk in plan for i in chunk) == list(range(len(paths)))
    y = engine.predict_paths(paths)
    assert y.shape == y_ref.shape == (len(paths), 5 if "DIM" in model_name else 1)
    assert np.isfinite(y).all()
    assert np.abs(y - y_ref).max() <= 1e-3


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return rows


def test_cli_csv_matches_jax_and_runs_without_jax(corpus, tmp_path):
    """predict_dir runs as ``python -m nisqa_tpu_torch.run_predict`` in a
    subprocess where jax, pandas and yaml cannot be imported (the card
    machine's installation); predict_file runs in-process through main()."""
    from nisqa_tpu.model import NisqaTPU

    tmp, names, ckpts = corpus
    ckpt = ckpts["NISQA_DIM"]
    jax_dir, port_dir, file_dir = (tmp_path / d for d in ("jax", "port", "file"))
    for d in (jax_dir, port_dir, file_dir):
        d.mkdir()
    NisqaTPU({"mode": "predict_dir", "pretrained_model": ckpt, "data_dir": str(tmp),
              "output_dir": str(jax_dir), "tr_bs_val": 4, "tr_num_workers": 0}).predict()
    ref = _read_csv(jax_dir / "NISQA_results.csv")

    argv = ["--mode", "predict_dir", "--pretrained_model", ckpt, "--data_dir", str(tmp),
            "--output_dir", str(port_dir), "--bs", "4", "--tr_device", "cpu"]
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['pandas'] = sys.modules['yaml'] = None\n"
        "import runpy\n"
        f"sys.argv = ['run_predict'] + {argv!r}\n"
        "runpy.run_module('nisqa_tpu_torch.run_predict', run_name='__main__', alter_sys=True)\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None\n"
        "          and m.split('.')[0] in ('jax', 'jaxlib', 'pandas', 'yaml')]\n"
        "assert not loaded, loaded\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": REPO}, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = _read_csv(port_dir / "NISQA_results.csv")

    cols = ["deg", "mos_pred", "noi_pred", "dis_pred", "col_pred", "loud_pred", "model"]
    assert list(ref[0]) == list(got[0]) == cols
    assert [r_["deg"] for r_ in got] == [r_["deg"] for r_ in ref] == names
    for a, b in zip(got, ref):
        assert a["model"] == b["model"] == "tiny_NISQA_DIM"
        for c in cols[1:-1]:
            assert abs(float(a[c]) - float(b[c])) <= 1e-3

    runner = port_main(["--mode", "predict_file", "--pretrained_model", ckpt, "--deg",
                        str(tmp / names[2]), "--output_dir", str(file_dir), "--tr_device", "cpu"])
    one = _read_csv(file_dir / "NISQA_results.csv")
    assert len(runner.ds_val.df) == len(one) == 1 and one[0]["deg"] == names[2]
    for c in cols[1:-1]:
        assert abs(float(one[0][c]) - float(ref[2][c])) <= 1e-3


def test_error_paths(corpus, tmp_path):
    tmp, names, ckpts = corpus
    short = tmp_path / "short" / "short.wav"
    short.parent.mkdir()
    write_wav(str(short), 0.1 * np.ones(400, np.float32), 8000)  # 6 frames < seg_length 7
    with pytest.raises(ValueError, match="Sample too short"):
        port_main(["--mode", "predict_file", "--pretrained_model", ckpts["NISQA"],
                   "--deg", str(short), "--tr_device", "cpu"])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="No wav/flac files found"):
        port_main(["--mode", "predict_dir", "--pretrained_model", ckpts["NISQA"],
                   "--data_dir", str(empty), "--tr_device", "cpu"])
    with pytest.raises(ValueError, match="--deg argument"):
        port_main(["--mode", "predict_file", "--pretrained_model", ckpts["NISQA"]])
    with pytest.raises(ValueError, match="--csv_deg argument"):
        port_main(["--mode", "predict_csv", "--pretrained_model", ckpts["NISQA"],
                   "--csv_file", "f.csv"])
    with pytest.raises(FileNotFoundError, match="missing.csv"):
        port_main(["--mode", "predict_csv", "--pretrained_model", ckpts["NISQA"],
                   "--csv_file", "missing.csv", "--csv_deg", "deg", "--data_dir", str(empty),
                   "--tr_device", "cpu"])
    with pytest.raises(NotImplementedError, match="mode not available: bogus"):
        NisqaTorch({"mode": "bogus", "pretrained_model": ckpts["NISQA"], "tr_device": "cpu"})


def test_no_silent_cpu_fallback(corpus, monkeypatch):
    """tr_device unset means CUDA: without a card the run raises and names
    tr_device='cpu' instead of running on the CPU."""
    import nisqa_tpu_torch

    tmp, names, ckpts = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"mode": "predict_file", "pretrained_model": ckpts["NISQA"], "deg": str(tmp / names[0])}
    with pytest.raises(RuntimeError, match="tr_device='cpu'"):
        NisqaTorch(args)
    with pytest.raises(RuntimeError, match="tr_device='cpu'"):
        nisqa_tpu_torch.load_predictor(ckpts["NISQA"])
    predict = nisqa_tpu_torch.load_predictor(ckpts["NISQA"], batch_size=3, tr_device="cpu",
                                             num_workers=1)
    y = predict([str(tmp / n) for n in names[:4]])
    assert y.shape == (4, 1) and np.isfinite(y).all() and predict.model_name == "NISQA"


def test_port_import_leaves_jax_unloaded():
    """jax is installed here: importing every port module must load no jax,
    pandas or yaml module and no module of the JAX package ``nisqa_tpu``."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import nisqa_tpu_torch\n"
        "for m in pkgutil.walk_packages(nisqa_tpu_torch.__path__, 'nisqa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'pandas', 'yaml', 'nisqa_tpu')]\n"
        "assert not loaded, loaded\n"
        "assert 'nisqa_tpu_torch.data.pipeline' in sys.modules\n"
        "assert 'nisqa_tpu_torch.parallel.mesh' in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def test_port_never_imports_jax_pandas_or_yaml():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pandas|yaml)\b", re.M)
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PORT_DIR) for f in fs if f.endswith(".py")]
    assert len(sources) >= 15
    for path in sources:
        with open(path) as f:
            assert not pattern.search(f.read()), path
    # nothing of the JAX package either: only the prefix nisqa_tpu_torch
    banned = re.compile(r"^\s*(import|from)\s+nisqa_tpu(\.|\s|$)", re.M)
    for path in sources + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            assert not banned.search(f.read()), path
