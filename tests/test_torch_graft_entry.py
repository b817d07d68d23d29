"""The port's entry points (``nisqa_tpu_torch/graft_entry.py``) against
the root ``__graft_entry__.py`` on the CPU.

  * ``entry()``: the inputs bitwise equal to ``nisqa_tpu``'s, and with its
    params carried across by ``state_dict_from_jax`` the (4, 5) forward
    within 2e-4 (fp32, the module-forward bound) of ``jax.jit(fn)``;
  * the data-parallel train step at W = 2 over gloo under ``torchrun`` (this
    file run as a script, :func:`worker`), dropout 0, against
    ``jax.value_and_grad`` of the same loss over the whole batch on one CPU
    device from the same params, with the bounds of
    ``tests/test_torch_train_jax.py``: the loss within 1e-5 relative, the
    summed gradients within 1e-4 * max(1, max|jax|), the BN running
    statistics within 1e-5 * max(1, max|jax|); the weights after Adam equal
    on both ranks. Gradients, not post-Adam weights: Adam's first step
    moves a weight whose exact gradient is zero by about lr, in the
    direction of float32 noise. The JAX step runs in float64 (a subprocess,
    :func:`jax_reference`, since ``jax_enable_x64`` is process-global) from
    the float32 params: at full width ``nisqa_tpu``'s float32 gradients of
    the first four convolutions are off its own float64 ones by up to 0.24
    (conv4, 6.6% of max|grad|), the port's float32 ones by at most 4.5e-5
    (measured on a Xeon CPU when the test was written);
  * ``dryrun_multichip(2, device="cpu")`` passes its three checks;
  * without CUDA ``entry()`` and ``dryrun_multichip`` raise when no device
    is given, and a fresh import loads no jax, nisqa_tpu or pandas.

The file imports no jax at module level, so the ranks start fast.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROPOUT = {"cnn_dropout": 0.0, "td_sa_dropout": 0.0, "td_2_sa_dropout": 0.0,
              "pool_att_dropout": 0.0}
W = 2


def no_dropout_args():
    from nisqa_tpu_torch.graft_entry import _flagship_model_args

    return {**_flagship_model_args(), **NO_DROPOUT}


# -- the W = 2 worker (this file run by torchrun) ------------------------------


def worker(job_path: str):
    """One rank of the DP step from the job's weights, dropout 0; writes
    ``rank<r>.pt`` (the batch's loss, the summed gradients, the state dict
    after the step, whether every rank holds the same weights)."""
    from nisqa_tpu_torch.graft_entry import (STEP_ROWS_PER_RANK, dp_train_step,
                                             same_on_every_rank, step_batch)
    from nisqa_tpu_torch.models.nisqa import build_model
    from nisqa_tpu_torch.parallel.mesh import init_data_parallel

    torch.set_num_threads(1)
    with open(job_path) as f:
        job = json.load(f)
    dp = init_data_parallel({"tr_parallel": True}, torch.device("cpu"))
    model = build_model("NISQA_DIM", no_dropout_args())
    model.load_state_dict(torch.load(job["sd"], weights_only=True), strict=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    rows = slice(STEP_ROWS_PER_RANK * dp.rank, STEP_ROWS_PER_RANK * (dp.rank + 1))
    loss = dp_train_step(model, opt, dp, *(torch.from_numpy(a[rows])
                                           for a in step_batch(dp.size)))
    out = {"loss": float(loss), "size": dp.size, "backend": dp.backend,
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
           "sd": {k: v.clone() for k, v in model.state_dict().items()},
           "same": same_on_every_rank(model, dp)}
    torch.save(out, os.path.join(job["out"], f"rank{dp.rank}.pt"))


# -- fixtures -------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module, as tests/test_torch_train_epoch.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_entry():
    import __graft_entry__ as jge
    import jax

    fn, args = jge.entry()
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return fn, args, to_np(args[0]), to_np(args[1])


def jax_reference(job_path: str):
    """``nisqa_tpu``'s whole-batch step in float64 from the job's float32
    params: writes the loss and, as the port's state-dict names, the
    gradients and the BN state the train-mode forward leaves."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from nisqa_tpu.compat.torch_ckpt import params_to_torch
    from nisqa_tpu.models.nisqa import build_model
    from nisqa_tpu.train.loop import nan_mse
    from nisqa_tpu_torch.graft_entry import step_batch

    with open(job_path) as f:
        job = json.load(f)
    model = build_model("NISQA_DIM", no_dropout_args())
    tree = jax.tree_util.tree_structure(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    leaves = np.load(job["leaves"])
    params, state = jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(a, jnp.float64 if a.dtype.kind == "f" else a.dtype)
        for a in (leaves[f"arr_{i}"] for i in range(len(leaves.files)))])
    segs, n_wins, y = step_batch(W)

    def loss_fn(p):
        y_hat, new_bn = model.apply(p, state, jnp.asarray(segs, jnp.float64), jnp.asarray(n_wins),
                                    train=True, rng=None)
        return sum(nan_mse(y_hat[:, k], jnp.asarray(y[:, k], jnp.float64)) for k in range(5)), new_bn

    (loss, new_bn), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ref = {k: np.asarray(v) for k, v in params_to_torch(model, grads, new_bn).items()}
    np.savez(job["jax_out"], loss=np.float64(loss), **ref)


@pytest.fixture(scope="module")
def dp_step(tmp_path_factory, jax_entry):
    """The W = 2 step from ``nisqa_tpu``'s initial params (each rank's
    results) and the JAX whole-batch reference in float64: (ranks, loss,
    the gradients and the BN state as the port's state dict)."""
    import jax

    from nisqa_tpu_torch.compat.jax_params import state_dict_from_jax
    from tests.test_torch_parallel import torchrun

    _, _, params, state = jax_entry
    tmp = tmp_path_factory.mktemp("graft_entry_step")
    torch.save(state_dict_from_jax(params, state, "NISQA_DIM", no_dropout_args()), tmp / "sd.pt")
    np.savez(tmp / "leaves.npz", *jax.tree_util.tree_leaves((params, state)))
    job = {"sd": str(tmp / "sd.pt"), "out": str(tmp), "leaves": str(tmp / "leaves.npz"),
           "jax_out": str(tmp / "jax.npz")}
    with open(tmp / "job.json", "w") as f:
        json.dump(job, f)
    # the float64 reference runs beside the two ranks
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--jax-reference",
                            str(tmp / "job.json")], cwd=REPO, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True,
                           env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})
    torchrun([os.path.abspath(__file__), str(tmp / "job.json")], cwd=REPO)
    out, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, out[-3000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(W)]
    z = np.load(tmp / "jax.npz")
    return ranks, float(z["loss"]), {k: z[k] for k in z.files if k != "loss"}


# -- tests ------------------------------------------------------------------------


def test_entry_inputs_bitwise_equal_to_jax(jax_entry):
    from nisqa_tpu_torch.graft_entry import entry

    _, (_, _, segs, n_wins) = jax_entry[:2]
    fn, (t_segs, t_n_wins) = entry(device="cpu")
    assert not fn.training and t_segs.device.type == "cpu"
    assert t_segs.dtype == torch.float32 and t_segs.shape == (4, 163, 48, 15)
    np.testing.assert_array_equal(t_segs.numpy(), segs)
    np.testing.assert_array_equal(t_n_wins.numpy(), n_wins)


def test_entry_forward_matches_jax(jax_entry):
    import jax

    from nisqa_tpu_torch.compat.jax_params import state_dict_from_jax
    from nisqa_tpu_torch.graft_entry import _flagship_model_args, entry

    jfn, jargs, params, state = jax_entry
    want = np.asarray(jax.jit(jfn)(*jargs))
    sd = state_dict_from_jax(params, state, "NISQA_DIM", _flagship_model_args())
    fn, args = entry(device="cpu", state_dict=sd)
    with torch.inference_mode():
        got = fn(*args).numpy()
    assert got.shape == want.shape == (4, 5)
    assert float(np.abs(got - want).max()) <= 2e-4, np.abs(got - want).max()


def test_entry_weights_are_seeded_and_leave_the_global_generator():
    from nisqa_tpu_torch.graft_entry import entry

    before = torch.random.get_rng_state()
    a, _ = entry(device="cpu")
    b, _ = entry(device="cpu")
    assert torch.equal(torch.random.get_rng_state(), before)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


def test_dp_step_loss_matches_jax_whole_batch(dp_step):
    ranks, loss, _ = dp_step
    assert [r["size"] for r in ranks] == [W, W] and ranks[0]["backend"] == "gloo"
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-5 * abs(loss), (r["loss"], loss)


def test_dp_step_gradients_match_jax_whole_batch(dp_step):
    ranks, _, ref = dp_step
    for r in ranks:  # every parameter's gradient (the worker takes each one's)
        assert r["grads"] and set(r["grads"]) <= set(ref)
        for key, g in r["grads"].items():
            want = np.asarray(ref[key])
            d = float(np.abs(g.numpy() - want).max())
            assert d <= 1e-4 * max(1.0, float(np.abs(want).max())), (key, d)


def test_dp_step_bn_statistics_match_jax_whole_batch(dp_step):
    ranks, _, ref = dp_step
    keys = [k for k in ranks[0]["sd"] if "running_" in k]
    assert keys
    for r in ranks:
        for key in keys:
            want = np.asarray(ref[key])
            d = float(np.abs(r["sd"][key].numpy() - want).max())
            assert d <= 1e-5 * max(1.0, float(np.abs(want).max())), (key, d)


def test_dp_step_leaves_the_ranks_equal(dp_step):
    ranks, _, _ = dp_step
    assert all(r["same"] for r in ranks)
    for k, v in ranks[0]["sd"].items():
        assert torch.equal(v, ranks[1]["sd"][k]), k


def test_dryrun_multichip_on_the_cpu(capsys):
    from nisqa_tpu_torch.graft_entry import DRYRUN_FILES, dryrun_multichip

    rec = dryrun_multichip(W, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(f"dryrun_multichip({W}): ")]
    assert len(lines) == 3, lines
    assert "train step OK" in lines[0] and "TrainEngine" in lines[1] and "serving" in lines[2]
    assert rec["ranks"] == W and rec["backend"] == "gloo" and rec["device"] == "cpu"
    assert np.isfinite(rec["step_loss"]) and np.isfinite(rec["epoch_loss"])
    assert rec["max_abs_diff"] <= 1e-5 and len(rec["mos"]) == DRYRUN_FILES
    # whole batches of 2 per rank: 3 batches, rank 0 runs 2 and rank 1 one;
    # on the CPU the front-end is the kernel's twin, which counts nothing
    assert rec["batches_by_rank"] == [2, 1] and rec["launches_by_rank"] == [0, 0]


def test_dryrun_multichip_raises_with_the_ranks_output():
    from nisqa_tpu_torch.graft_entry import dryrun_multichip

    # no rank can build the model on the meta device: every rank fails
    with pytest.raises(RuntimeError, match=r"a rank failed \(torchrun exit 1\)") as e:
        dryrun_multichip(W, device="meta")
    assert "[rank0]:" in str(e.value) and "[rank1]:" in str(e.value)


def test_entry_points_without_cuda_raise(monkeypatch):
    from nisqa_tpu_torch.graft_entry import dryrun_multichip, entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="needs CUDA"):
        dryrun_multichip(W)  # before any launch


def test_fresh_import_and_cli_load_no_jax_nisqa_tpu_or_pandas():
    code = (
        "import sys\n"
        "import nisqa_tpu_torch.graft_entry as ge\n"
        "import nisqa_tpu_torch.features.segments\n"
        "out = ge.main(['--device', 'cpu'])\n"
        "assert tuple(out.shape) == (4, 5), out.shape\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'nisqa_tpu', 'pandas')))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("entry forward: [[") and lines[-1] == "[]", r.stdout


if __name__ == "__main__":
    if sys.argv[1] == "--jax-reference":
        jax_reference(sys.argv[2])
    else:
        worker(sys.argv[1])
