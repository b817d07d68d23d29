"""The training slice's host modules held to their originals, on the CPU.

The port's copies of ``BiasLoss``, ``EarlyStopper`` / ``EarlyStopperDim``
and ``ReduceLROnPlateau`` against ``nisqa_tpu``'s on the same sequences (the
JAX ``BiasLoss`` reads a pandas column, the port's a ``Table`` column); the
YAML reader against ``yaml.load(..., FullLoader)`` on the five shipped
configs and on ``yaml.dump`` of them, and the writer against
``yaml.safe_load``; the results CSV against what pandas writes for the same
rows; and the import rules for the new modules.
"""

import glob
import math
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

from nisqa_tpu.train import bias_loss as jax_bias
from nisqa_tpu.train import early_stop as jax_stop
from nisqa_tpu.train import plateau as jax_plateau
from nisqa_tpu_torch.compat import yaml_lite
from nisqa_tpu_torch.data.dataset import Table
from nisqa_tpu_torch.train import bias_loss, early_stop, plateau
from nisqa_tpu_torch.train.loop import ResultsWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "nisqa_tpu", "config", "*.yaml")))


@pytest.mark.parametrize("anchor", [None, "db_b"])
def test_bias_loss_matches_jax(anchor):
    rng = np.random.default_rng(0)
    db = np.array(["db_a", "db_b", "db_c"] * 10, dtype=object)
    y = rng.uniform(1, 5, 30)
    y[4] = np.nan  # db_b holds a NaN label: it is skipped in the refit
    kw = dict(anchor_db=anchor, mapping="first_order", min_r=0.7, do_print=False)
    ours = bias_loss.BiasLoss(Table({"db": db})["db"], **kw)
    ref = jax_bias.BiasLoss(pd.Series(db), **kw)
    for epoch in range(4):
        # weakly then strongly correlated predictions: the update starts late
        y_hat = y + rng.normal(0, 3.0 / (1 + 2 * epoch), 30)
        ours.update_bias(y, y_hat)
        ref.update_bias(y, y_hat)
        assert ours.do_update == ref.do_update
        np.testing.assert_array_equal(ours.b, ref.b)
        np.testing.assert_array_equal(ours.coeffs([3, 1, 7]), ref.coeffs([3, 1, 7]))
    assert ours.do_update
    off = bias_loss.BiasLoss(db, mapping=None, min_r=None)
    assert not off.apply_bias_loss and off.coeffs([0])[0].tolist() == [0.0, 1.0, 0.0, 0.0]


def _r(rng, suffixes):
    return {f"{k}{s}": float(v) for s in suffixes
            for k, v in (("r_p_mean_file", rng.uniform(0, 1)),
                         ("rmse_map_mean_file", rng.uniform(0.2, 1)))}


@pytest.mark.parametrize("dim", [False, True])
def test_early_stoppers_match_jax(dim):
    rng = np.random.default_rng(1 + dim)
    suffixes = ("", "_noi", "_col", "_dis", "_loud") if dim else ("",)
    cls = "EarlyStopperDim" if dim else "EarlyStopper"
    ours, ref = getattr(early_stop, cls)(3), getattr(jax_stop, cls)(3)
    for _ in range(12):
        r = _r(rng, suffixes)
        assert ours.step(r) == ref.step(r)
        assert (ours.cnt, ours.best) == (ref.cnt, ref.best)
        assert ours.state_dict() == ref.state_dict()
    again = getattr(early_stop, cls)(3)
    again.load_state_dict(ours.state_dict())
    assert again.state_dict() == ours.state_dict()


def test_plateau_matches_jax():
    ours, ref = plateau.ReduceLROnPlateau(1e-3, 2), jax_plateau.ReduceLROnPlateau(1e-3, 2)
    for loss in [5.0, 4.0, 3.999, 3.998, 3.997, 3.0, 3.5, 3.4, 3.3, 3.2, 2.0]:
        assert ours.step(loss) == ref.step(loss)
        assert ours.state_dict() == ref.state_dict()


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_yaml_reader_matches_pyyaml(path):
    with open(path) as f:
        ref = yaml.load(f, Loader=yaml.FullLoader)
    got = yaml_lite.load(path)
    assert list(got) == list(ref)
    assert all(_same(got[k], ref[k]) for k in ref), [k for k in ref if not _same(got[k], ref[k])]
    # yaml.dump's two list styles: flow (default_flow_style=None) and block at the key's indent
    for style in (None, False):
        text = yaml.dump(ref, default_flow_style=style, sort_keys=style is None)
        assert yaml_lite.loads(text) == yaml.load(text, Loader=yaml.FullLoader)
    # the writer: what it writes reads back with safe_load; for these configs it
    # writes what yaml.dump(default_flow_style=None, sort_keys=False) does
    assert yaml.safe_load(yaml_lite.dumps(ref)) == ref
    assert yaml_lite.dumps(ref) == yaml.dump(ref, default_flow_style=None, sort_keys=False)


SCALARS = ["1e-3", "1.0e-3", "1.0e3", "0.001", "-2.5", "1.", ".5", "12e3", "010", "0x1F",
           "0b101", "1_000", "1:30", "1:30.5", "-.inf", ".NaN", "yes", "No", "on", "OFF", "~",
           "null", "Null", "", "TRUE", "y", "n", "'quoted # not a comment'", '"d\\tq"', "+12",
           "0", "-0", "x/y/-", "plain text  # comment", "[1, 'a,b', null, 2.5e-3]", "[]"]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_typed_as_pyyaml(text):
    ref = yaml.load(f"k: {text}", Loader=yaml.FullLoader)["k"]
    got = yaml_lite.loads(f"k: {text}")["k"]
    if isinstance(ref, list):
        assert len(got) == len(ref) and all(_same(a, b) for a, b in zip(got, ref))
    else:
        assert _same(got, ref), (got, ref)


def test_yaml_writer_round_trips():
    d = {"a": "1e-3", "b": 1e-05, "c": "yes", "d": "", "e": "x: y", "f": "it's", "g": "-",
         "h": [1, "two", None, 2.5, True], "i": (3, 3), "j": 1e17, "k": "a #b", "l": "010",
         "m": "~", "n": "line\nbreak", "o": "ünï", "p": [], "q": float("inf"), "r": -0.0,
         "s": {"nested": 1}, "t": "/data/runs/x_1.tar", "u": "NISQA_DIM", "v": 0.1}
    back = yaml.safe_load(yaml_lite.dumps(d))
    assert back == {**d, "i": [3, 3]}
    with pytest.raises(ValueError, match="nested mappings"):
        yaml_lite.loads("a:\n  b: 1\n")
    with pytest.raises(ValueError, match="unsupported"):
        yaml_lite.loads("a: {b: 1}\n")


def test_results_csv_matches_pandas(tmp_path):
    """The per-epoch results CSV: every value stringified, one row per
    epoch, written as pandas writes ``pd.concat`` of one-row frames."""
    args = {"output_dir": str(tmp_path), "tr_checkpoint": "best_only", "name": "r",
            "csv_db_train": ["a", "b"], "csv_con": None, "tr_lr": 1e-3, "now": "dropped"}

    class Runner:
        runinfos = {"ds_train_len": 8, "ds_val_len": 4}
        dp, is_main = None, True  # one process, which writes

    runner = Runner()
    runner.args = args
    writer = ResultsWriter(runner, "run")
    rows = []
    for epoch, r in enumerate([{"r_p_mean_file": 0.5, "rmse_map_mean_file": float("nan")},
                               {"r_p_mean_file": 0.75, "rmse_map_mean_file": 0.25}]):
        writer.save(epoch, 1.0 / (epoch + 1), 0.123, r, None, None, False, None, None)
        row = {"runname": "run", "epoch": f"{epoch + 1:05d}", "filename": "run.tar",
               "loss": 1.0 / (epoch + 1), "ep_runtime": "0.12", **runner.runinfos, **r,
               **{k: v for k, v in args.items() if k != "now"}}
        rows.append(pd.DataFrame({k: str(v) for k, v in row.items()}, index=[0]))
    ref = tmp_path / "ref.csv"
    pd.concat(rows, ignore_index=True).to_csv(ref, index=False)
    got = tmp_path / "run" / "run__results.csv"
    assert got.read_text() == ref.read_text()
    assert not list((tmp_path / "run").glob("*.tar"))  # best_only and not best: no checkpoint


def test_training_modules_import_nothing_banned():
    """A fresh import of the training modules (after torch, which itself
    loads tqdm where it is installed) loads no jax, pandas, yaml, tqdm or
    ``nisqa_tpu`` module."""
    code = (
        "import sys, torch\n"
        "base = set(sys.modules)\n"
        "import nisqa_tpu_torch.run_train, nisqa_tpu_torch.train.loop\n"
        "import nisqa_tpu_torch.train.checkpoint, nisqa_tpu_torch.compat.yaml_lite\n"
        "loaded = [m for m in sys.modules if m not in base and m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'pandas', 'yaml', 'tqdm', 'nisqa_tpu')]\n"
        "assert not loaded, loaded\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
