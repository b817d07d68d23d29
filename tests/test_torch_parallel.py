"""Data parallelism of the port (``nisqa_tpu_torch/parallel/mesh.py``) on the CPU.

Two ranks run under ``torchrun --standalone --nproc_per_node 2`` over gloo:
one launch of this file as a script (:func:`worker`) runs every W = 2 case
and writes each rank's results, which the tests hold to W = 1 (one process,
no group) and to ``NisqaTPU`` with ``tr_parallel: True`` on the 8-device
CPU mesh of ``tests/conftest.py``:

  * masked batch norm over the two ranks' rows equals one call on the
    concatenated batch within 1e-6 (output, running statistics, the
    gradients of x, weight and bias), also when one rank's rows are all
    invalid;
  * serving: ``predict_dir`` over 13 files at bs 4 (5 batches: three sample
    rates, ragged last batches; rank 0 runs 3, rank 1 runs 2) equals W = 1
    within 1e-5 and the JAX mesh within 1e-3 at "highest"; so do an async
    cold pass, two async cached passes dispatched before either resolves,
    and a partial-cache pass;
  * training: one unshuffled epoch at zero dropout, lr 3e-5, bs 4, over ten
    train files with a one-row 16 kHz group (rank 1 holds only padding
    there), for NISQA, NISQA_DIM and NISQA_DE from the JAX model's initial
    weights: loss within 1e-5 relative and predictions within 1e-4 of
    W = 1, the weights after the epoch identical on both ranks, and the
    bounds of ``tests/test_torch_train_epoch.py`` against the JAX mesh
    (loss 1e-4 relative, predictions 1e-3); the resident corpus at W = 2
    equals the host fill at W = 2;
  * the launcher: ``torchrun -m nisqa_tpu_torch.run_train --yaml`` writes
    one results CSV and one ``.tar`` / ``.pt`` pair.

One process with ``tr_parallel: True`` is one device: no note, and bit for
bit the run without it. ``profile_dir`` writes one trace per rank.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = (("NISQA", 1), ("NISQA_DIM", 5), ("NISQA_DE", 1))
BN_CASES = ("2d", "2d_rank1_invalid", "1d")
LR, BS = 3e-5, 4


def bn_inputs(case: str):
    """(x (8, ...), w (8,), upstream gradient, the batch norm module) of a
    case: the whole batch; rank r takes rows 4r .. 4r + 3."""
    g = torch.Generator().manual_seed(BN_CASES.index(case))
    shape = (8, 6) if case == "1d" else (8, 3, 5, 4)
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    w = torch.rand(8, generator=g) > 0.3
    w[0] = True
    if case == "2d_rank1_invalid":
        w[4:] = False
    gy = torch.randn(shape, generator=g)
    bn = torch.nn.BatchNorm1d(6) if case == "1d" else torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
    return x, w, gy, bn


def bn_run(case: str, rows=slice(None), group=None):
    """masked_batch_norm on ``rows`` of the case: (y, dx, dweight, dbias,
    running mean, running var, num_batches_tracked)."""
    from nisqa_tpu_torch.models.modules import masked_batch_norm

    x, w, gy, bn = bn_inputs(case)
    x = x[rows].clone().requires_grad_()
    y = masked_batch_norm(x, bn, w[rows], group)
    (y * gy[rows]).sum().backward()
    return [t.detach().clone() for t in (y, x.grad, bn.weight.grad, bn.bias.grad,
                                         bn.running_mean, bn.running_var, bn.num_batches_tracked)]


# -- the W = 2 worker (this file run by torchrun) ------------------------------


def worker(job_path: str):
    """Every W = 2 case of ``job_path``'s job on this rank; writes
    ``rank<r>.pt`` into the job's ``out`` directory."""
    from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar
    from nisqa_tpu_torch.data.pipeline import InferenceEngine, MsConfig
    from nisqa_tpu_torch.model import NisqaTorch
    from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference
    from nisqa_tpu_torch.parallel.mesh import init_data_parallel
    from nisqa_tpu_torch.train import loop

    torch.set_num_threads(1)
    with open(job_path) as f:
        job = json.load(f)
    dp = init_data_parallel({"tr_parallel": True}, torch.device("cpu"))
    out = {"rank": dp.rank, "size": dp.size, "backend": dp.backend}
    for case in BN_CASES:
        out[f"bn/{case}"] = bn_run(case, slice(4 * dp.rank, 4 * dp.rank + 4), dp.group)

    # serving through the runner, with a count of the front-end's DFT->mel calls
    runner = NisqaTorch(job["serve_args"])
    eng = runner._engine()
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return dft_mel_reference(*a, **k)

    eng.dft_mel = counted
    df = runner.predict()
    out["serve/names"] = list(df["deg"])
    out["serve/y"] = torch.tensor(np.asarray(df["mos_pred"], np.float64))
    out["serve/calls"] = calls[0]
    out["serve/plan"] = len(eng.plan(runner.ds_val.paths()))

    # async and partial-cache passes on engines of their own
    paths = runner.ds_val.paths()
    model, args = load_model_from_tar(job["serve_args"]["pretrained_model"], "cpu")
    kw = {"batch_size": BS, "num_workers": 1, "precision": "highest", "mesh": dp}
    eng = InferenceEngine(model, MsConfig(args), "cpu", cache_mb=256, **kw)
    y_cold = eng.predict_paths(paths, fetch="async")()
    h1 = eng.predict_paths(paths, fetch="async")
    h2 = eng.predict_paths(paths, fetch="async")  # dispatched before h1 resolves
    out["serve/async"] = [torch.from_numpy(y) for y in (y_cold, h1(), h2())]
    out["serve/async_mode"] = eng.stats["last"]["mode"]
    probe = InferenceEngine(model, MsConfig(args), "cpu", cache_mb=256, **kw)
    probe.predict_paths(paths)
    sizes = [sum(t.numel() * t.element_size() for t in b[2:])
             for b in next(iter(probe._corpus_cache.values()))["batches"]]
    eng = InferenceEngine(model, MsConfig(args), "cpu", cache_mb=(sizes[0] + 1) / (1 << 20), **kw)
    ys = [eng.predict_paths(paths)]
    ys.append(eng.predict_paths(paths))
    out["serve/partial_mode"] = eng.stats["last"]["mode"]
    ys.append(eng.predict_paths(paths))
    out["serve/partial"] = [torch.from_numpy(y) for y in ys]

    # one epoch of each model, then NISQA from the device-resident corpus
    for name, spec in job["train"].items():
        loss, y, engine, grads = train_epoch(spec)
        out[f"train/{name}"] = {"loss": loss, "y": torch.from_numpy(y), "steps": engine.steps,
                                "grads": grads, "sd": {k: v.clone() for k, v in
                                                       engine.model.state_dict().items()}}
    torch.save(out, os.path.join(job["out"], f"rank{dp.rank}.pt"))


def train_epoch(spec, **over):
    """One unshuffled epoch of a fresh runner on ``spec``'s args and
    initial weights: (loss, predictions, the engine, the gradients Adam
    took at each step)."""
    from nisqa_tpu_torch.model import NisqaTorch
    from nisqa_tpu_torch.train import loop

    pr = NisqaTorch({**spec["args"], **over})
    pr.model.load_state_dict(torch.load(spec["sd"], weights_only=True))
    engine = loop.TrainEngine(pr)
    grads, adam_step = [], engine.opt.step

    def step(*a, **k):
        grads.append({n: p.grad.clone() for n, p in pr.model.named_parameters()
                      if p.grad is not None})
        return adam_step(*a, **k)

    engine.opt.step = step
    k = 5 if pr.args["dim"] else 1
    loss, y = engine.run_epoch(pr.ds_train, loop._bias_losses(pr, k), LR, 0, BS, shuffle=False)
    return loss, y, engine, grads


def torchrun(args, cwd, timeout=600):
    """``torchrun --standalone --nproc_per_node 2 <args>`` on the CPU, one
    intra-op thread a rank; raises with the output when a rank fails."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "2", *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-5000:])
    return r


# -- fixtures -------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_serving_corpus(d):
    """13 PCM16 files of 0.4-1.2 s: 5 at 8 kHz, 3 at 12 kHz, 5 at 16 kHz
    (at bs 4: batches of 4 + 1, 3, 4 + 1)."""
    from nisqa_tpu_torch.audio.wav import write_wav

    rng = np.random.default_rng(7)
    for i, sr in enumerate([8000] * 5 + [12000] * 3 + [16000] * 5):
        t = np.arange(int(sr * rng.uniform(0.4, 1.2))) / sr
        y = 0.4 * np.sin(2 * np.pi * (180 + 50 * i) * t) + 0.05 * rng.standard_normal(len(t))
        write_wav(str(d / f"s{i:02d}_{sr}.wav"), y.astype(np.float32), sr)


def train_args(corpus, model):
    from tests.test_torch_train_epoch import EPOCH_ARGS
    from tests.test_torch_train_jax import DE_ARGS

    return {**EPOCH_ARGS, **(DE_ARGS if model == "NISQA_DE" else {}), "td_2_sa_dropout": 0.0,
            "model": model, "mode": "main", "data_dir": str(corpus),
            "output_dir": str(corpus / "out"), "tr_parallel": True}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The W = 2 run: its job, each rank's results, and the JAX runners
    whose initial weights the W = 2 models took."""
    import jax

    from nisqa_tpu.model import NisqaTPU
    from nisqa_tpu_torch.compat.jax_params import state_dict_from_jax
    from nisqa_tpu_torch.model import NisqaTorch
    from tests.test_e2e import _make_ckpt
    from tests.test_torch_train_epoch import write_corpus

    tmp = tmp_path_factory.mktemp("torch_parallel")
    serve_dir, train_dir, out = tmp / "serve", tmp / "train", tmp / "out"
    for d in (serve_dir, train_dir, out):
        d.mkdir()
    write_serving_corpus(serve_dir)
    write_corpus(train_dir, n48=12, n16=1)  # 10 train files, the 16 kHz one among them
    job = {"out": str(out), "train": {}, "serve_args": {
        "mode": "predict_dir", "pretrained_model": _make_ckpt(tmp), "data_dir": str(serve_dir),
        "output_dir": None, "tr_bs_val": BS, "tr_num_workers": 1, "tr_parallel": True,
        "tr_device": "cpu", "precision": "highest", "name": "tiny"}}
    jax_runners = {}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    for model, _ in MODELS:
        args = train_args(train_dir, model)
        jr = jax_runners[model] = NisqaTPU(dict(args))
        sd = state_dict_from_jax(to_np(jr.params), to_np(jr.state), model,
                                 NisqaTorch({**args, "tr_device": "cpu"}).model.cfg)
        torch.save(sd, tmp / f"{model}.pt")
        job["train"][model] = {"args": {**args, "tr_device": "cpu"}, "sd": str(tmp / f"{model}.pt")}
    job["train"]["resident"] = {**job["train"]["NISQA"],
                                "args": {**job["train"]["NISQA"]["args"], "tr_ds_to_memory": True}}
    with open(tmp / "job.json", "w") as f:
        json.dump(job, f)
    torchrun([os.path.abspath(__file__), str(tmp / "job.json")], cwd=REPO)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in (0, 1)]
    return job, ranks, jax_runners


# -- tests ------------------------------------------------------------------------


def test_shard_rows():
    from nisqa_tpu_torch.parallel.mesh import shard_rows

    assert shard_rows(3, 2, 0) == (4, 0, 2) and shard_rows(3, 2, 1) == (4, 2, 4)
    assert shard_rows(1, 2, 1) == (2, 1, 2)  # rank 1: only the padding copy of row 0
    assert [shard_rows(5, 8, r)[1:] for r in (0, 7)] == [(0, 1), (7, 8)]
    assert shard_rows(4, 1, 0) == (4, 0, 4)


def test_no_launcher_means_one_device(monkeypatch, capsys):
    """Without torchrun's WORLD_SIZE there is no group; with several cards
    visible one line names torchrun, and nothing touches a card."""
    from nisqa_tpu_torch.parallel.mesh import init_data_parallel

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert init_data_parallel({"tr_parallel": False}, torch.device("cuda")) is None
    assert capsys.readouterr().err == ""
    assert init_data_parallel({"tr_parallel": True}, torch.device("cuda")) is None
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "torchrun --nproc_per_node N" in err and "4 visible" in err
    assert init_data_parallel({"tr_parallel": True}, torch.device("cpu")) is None
    assert capsys.readouterr().err == ""


def test_ranks_without_tr_parallel_raise(monkeypatch):
    """Several launched ranks without ``tr_parallel`` would each run the
    whole job on one card: that raises; one launched rank is one device."""
    from nisqa_tpu_torch.parallel.mesh import init_data_parallel

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="tr_parallel is off"):
        init_data_parallel({"tr_parallel": False}, torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_data_parallel({"tr_parallel": False}, torch.device("cpu")) is None


@pytest.mark.parametrize("cards, backend", [
    (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),  # a card per rank (also under a per-rank mask)
    (["GPU-a", "GPU-a"], "gloo"),                    # two ranks on one card
    (["GPU-a", "GPU-b", "GPU-a", "GPU-b"], "gloo"),  # four ranks on two cards
    (["GPU-a"], "nccl"),
])
def test_backend_from_the_ranks_cards(cards, backend):
    """Each rank posts its card's UUID to the store and reads every rank's;
    all ranks then choose the same backend."""
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist
    from nisqa_tpu_torch.parallel.mesh import card_backend, exchange

    store = dist.PrefixStore("cards", dist.HashStore())
    n = len(cards)
    with ThreadPoolExecutor(n) as pool:  # get() waits for the ranks posted later
        seen = list(pool.map(lambda r: exchange(store, r, n, cards[r]), reversed(range(n))))
    assert all(s == cards for s in seen)
    assert card_backend(cards) == backend


@pytest.mark.parametrize("case", BN_CASES)
def test_masked_bn_across_ranks_equals_concatenated_batch(dp, case):
    _, ranks, _ = dp
    assert [r["size"] for r in ranks] == [2, 2] and ranks[0]["backend"] == "gloo"
    full = bn_run(case)
    parts = [r[f"bn/{case}"] for r in ranks]
    for i, name in ((0, "y"), (1, "dx")):
        torch.testing.assert_close(torch.cat([p[i] for p in parts]), full[i], atol=1e-6, rtol=0,
                                   msg=name)
    for i, name in ((2, "dweight"), (3, "dbias")):  # each rank holds its share
        torch.testing.assert_close(parts[0][i] + parts[1][i], full[i], atol=1e-6, rtol=0, msg=name)
    for p in parts:
        for i in (4, 5):
            torch.testing.assert_close(p[i], full[i], atol=1e-6, rtol=0)
        assert int(p[6]) == 1
    if case == "2d_rank1_invalid":
        assert not bn_inputs(case)[1][4:].any()


def test_serving_w2_equals_w1_and_the_jax_mesh(dp):
    from nisqa_tpu.model import NisqaTPU
    from nisqa_tpu_torch.model import NisqaTorch

    job, ranks, _ = dp
    args = job["serve_args"]
    one = NisqaTorch({**args, "tr_parallel": False}).predict()
    y1 = np.asarray(one["mos_pred"])
    assert all(r["serve/names"] == list(one["deg"]) for r in ranks)
    for r in ranks:
        assert float(np.abs(r["serve/y"].numpy() - y1).max()) <= 1e-5
    # whole batches per rank: 5 batches, 3 on rank 0 and 2 on rank 1, one
    # front-end call per cold batch of the rank's own
    assert [r["serve/plan"] for r in ranks] == [3, 2]
    assert [r["serve/calls"] for r in ranks] == [3, 2]
    jax_args = {k: v for k, v in args.items() if k != "tr_device"}
    mesh = NisqaTPU({**jax_args, "output_dir": None}).predict()
    assert list(mesh["deg"]) == list(one["deg"])
    assert float(np.abs(mesh["mos_pred"].to_numpy() - y1).max()) <= 1e-3


def test_serving_async_and_partial_at_w2(dp):
    _, ranks, _ = dp
    y1 = ranks[0]["serve/y"].numpy()[:, None]
    for r in ranks:
        assert r["serve/async_mode"] == "cached" and r["serve/partial_mode"] == "cached_partial"
        for y in r["serve/async"] + r["serve/partial"]:
            assert float(np.abs(y.numpy() - y1).max()) <= 1e-5
        torch.testing.assert_close(r["serve/partial"][1], r["serve/partial"][2], atol=0, rtol=0)


@pytest.mark.parametrize("model,k", MODELS)
def test_training_w2_equals_w1_and_the_jax_mesh(dp, model, k):
    import jax

    from nisqa_tpu.train import loop as jax_loop

    job, ranks, jax_runners = dp
    loss1, y1, engine, grads1 = train_epoch(job["train"][model], tr_parallel=False)
    # 10 files at bs 4: batches 4, 4 (48 + 16 kHz: two steps), 2
    assert engine.steps == 4
    w2 = [r[f"train/{model}"] for r in ranks]
    for r in w2:
        assert r["steps"] == 4
        assert abs(r["loss"] - loss1) <= 1e-5 * abs(loss1), (r["loss"], loss1)
        assert r["y"].shape == (10, k) and float(np.abs(r["y"].numpy() - y1).max()) <= 1e-4
        # the summed gradients are those of the global loss (the third step
        # is the 16 kHz file alone: rank 1 holds only its padding copy)
        for step, (g2, g1) in enumerate(zip(r["grads"], grads1, strict=True)):
            assert g2.keys() == g1.keys()
            a, b = (torch.cat([g[n].reshape(-1) for n in sorted(g1)]) for g in (g2, g1))
            rel = float((a - b).norm() / b.norm())
            assert rel <= 1e-4, (step, rel)
    for key, v in w2[0]["sd"].items():  # weights and BN buffers equal on both ranks
        assert torch.equal(v, w2[1]["sd"][key]), key
    # nisqa_tpu on its 8-device mesh: every group padded to 8 rows
    jr = jax_runners[model]
    assert jr.mesh is not None and jr.mesh.size == 8
    loss_j, y_j = jax_loop.TrainEngine(jr).run_epoch(
        jr.ds_train, jax_loop._bias_losses(jr, k), LR, jax.random.PRNGKey(0), BS, shuffle=False)
    assert abs(w2[0]["loss"] - loss_j) <= 1e-4 * abs(loss_j), (w2[0]["loss"], loss_j)
    assert float(np.abs(w2[0]["y"].numpy() - y_j).max()) <= 1e-3


def test_resident_at_w2_equals_host_fill_at_w2(dp):
    _, ranks, _ = dp
    for r in ranks:
        res, host = r["train/resident"], r["train/NISQA"]
        np.testing.assert_allclose(res["loss"], host["loss"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["y"].numpy(), host["y"].numpy(), rtol=1e-5, atol=1e-6)
    for key, v in ranks[0]["train/resident"]["sd"].items():
        assert torch.equal(v, ranks[1]["train/resident"]["sd"][key]), key


def test_torchrun_cli_writes_one_set_of_outputs(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    nisqa_tpu_torch.run_train --yaml`` with ``tr_device: cpu``, one epoch:
    one run directory with one YAML, one results CSV of one row and one
    ``.tar`` / ``.pt`` pair; the ``.tar`` loads with ``strict=True``."""
    from nisqa_tpu_torch.compat import yaml_lite
    from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar
    from nisqa_tpu_torch.data.dataset import Table
    from tests.test_torch_train_epoch import write_corpus

    write_corpus(tmp_path, n48=6, n16=1)
    cfg = {**train_args(tmp_path, "NISQA"), "name": "dp_cli", "tr_device": "cpu", "tr_epochs": 1,
           "tr_early_stop": 5, "tr_lr_patience": 15, "tr_checkpoint": "every_epoch",
           "tr_verbose": 0, "tr_bias_mapping": None, "tr_bias_min_r": None,
           "tr_bias_anchor_db": None, "cnn_dropout": 0.2}
    yaml_lite.dump(cfg, str(tmp_path / "cfg.yaml"))
    r = torchrun(["-m", "nisqa_tpu_torch.run_train", "--yaml", str(tmp_path / "cfg.yaml")],
                 cwd=str(tmp_path))
    assert r.stdout.count("--> start training") == 1  # the prints of rank 0 only
    (run,) = os.listdir(tmp_path / "out")
    files = sorted(os.listdir(tmp_path / "out" / run))
    assert files == sorted(f"{run}{s}" for s in ("__ep_001.pt", "__ep_001.tar", "__results.csv",
                                                 ".yaml")), files
    assert len(Table.read_csv(str(tmp_path / "out" / run / f"{run}__results.csv"))) == 1
    model, _ = load_model_from_tar(str(tmp_path / "out" / run / f"{run}__ep_001.tar"), "cpu")
    assert model.name == "NISQA"


def test_one_process_tr_parallel_is_one_device(dp, capsys):
    """Without a launcher ``tr_parallel`` runs this process alone: no group,
    no note, and the epoch equal bit for bit to ``tr_parallel: False``."""
    from nisqa_tpu_torch.model import NisqaTorch
    from nisqa_tpu_torch.train import loop

    job, _, _ = dp
    spec = job["train"]["NISQA"]
    out = []
    for parallel in (True, False):
        pr = NisqaTorch({**spec["args"], "tr_parallel": parallel, "cnn_dropout": 0.2})
        assert pr.dp is None and pr.is_main
        engine = loop.TrainEngine(pr)
        out.append((*engine.run_epoch(pr.ds_train, loop._bias_losses(pr, 1), LR, 0, BS),
                    pr.model.state_dict()))
    assert "nisqa_tpu_torch" not in capsys.readouterr().err
    (loss_a, y_a, sd_a), (loss_b, y_b, sd_b) = out
    assert loss_a == loss_b
    np.testing.assert_array_equal(y_a, y_b)
    assert all(torch.equal(v, sd_b[k]) for k, v in sd_a.items())


def test_profile_dir_writes_a_trace(dp, tmp_path):
    """``profile_dir`` traces ``predict`` into one Chrome trace (rank 0 of
    one); the predictions are those of the run without it."""
    from nisqa_tpu_torch.model import NisqaTorch

    job, _, _ = dp
    args = {**job["serve_args"], "tr_parallel": False}
    plain = NisqaTorch(args).predict()
    traced = NisqaTorch({**args, "profile_dir": str(tmp_path / "prof")}).predict()
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace == "predict_dir_rank0.pt.trace.json"
    with open(tmp_path / "prof" / trace) as f:
        assert json.load(f)["traceEvents"]
    np.testing.assert_array_equal(np.asarray(traced["mos_pred"]), np.asarray(plain["mos_pred"]))


if __name__ == "__main__":
    worker(sys.argv[1])
