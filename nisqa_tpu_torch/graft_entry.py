"""Entry points: a forward of the flagship model, and a dry run of
training and serving over a process group.

Counterpart of the root ``__graft_entry__.py``:

  * :func:`entry` returns ``(fn, args)``: ``fn`` is the flagship model
    (NISQA_DIM: AdaptCNN -> 2-layer self-attention -> 5 attention-pooling
    heads) in eval mode, ``args`` a batch of 4 seeded segment tensors and
    their window counts, so ``fn(*args)`` gives the (4, 5) predictions
    [mos, noi, dis, col, loud];
  * :func:`dryrun_multichip` runs three checks over an n-rank
    ``torch.distributed`` group (:func:`.parallel.mesh.init_data_parallel`):
    (a) one data-parallel train step of the flagship model (batch norm over
    every rank's rows, dropout, gradients summed over the ranks, Adam),
    after which every rank holds the same weights; (b) one ``TrainEngine``
    epoch of a small model from the device-resident corpus; (c) serving
    through ``InferenceEngine`` over the group against one process: a cold
    pass, a cached one and two async ones. Outside a launcher it starts
    ``torchrun`` on this module and raises when a rank fails.

The JAX version runs its dry run on 8 virtual CPU devices in one process;
the port runs one process per rank: NCCL when every rank has a card of its
own, gloo when ranks share the one card, gloo on the CPU only with
``device="cpu"``. Both entry points run on the card unless the caller asks
for the CPU.

    python -m nisqa_tpu_torch.graft_entry [--multichip [N]] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_BATCH, ENTRY_T = 4, 163
STEP_T = 16              # segments per row of the dry run's train step
STEP_ROWS_PER_RANK = 2   # the step's batch is 2 rows a rank
DRYRUN_SR = 8000
DRYRUN_FILES = 6
DRYRUN_BOUND = 1e-5      # serving over the group vs one process, absolute
LAUNCH_TIMEOUT = 1200    # s, the dry run's torchrun launch, killed whole after it
# the dry run's small model and 8 kHz / 24-mel front-end (__graft_entry__.py:150-164)
DRYRUN_ARGS = {
    "mode": "main", "name": "dryrun", "model": "NISQA",
    "pretrained_model": False, "csv_file": "c.csv", "csv_deg": "filename",
    "csv_mos_train": "mos", "csv_mos_val": "mos",
    "csv_db_train": ["T"], "csv_db_val": ["V"], "csv_con": None,
    "tr_epochs": 1, "tr_early_stop": 5, "tr_bs": 3, "tr_bs_val": 2,
    "tr_lr": 1e-3, "tr_lr_patience": 5, "tr_num_workers": 0,
    "tr_parallel": True, "tr_checkpoint": "best_only", "tr_verbose": 0,
    "tr_bias_mapping": None, "tr_bias_min_r": None,
    "tr_bias_anchor_db": None, "tr_ds_to_memory": True, "seed": 0,
    "ms_sr": None, "ms_fmax": 4000.0, "ms_n_fft": 512,
    "ms_hop_length": 0.01, "ms_win_length": 0.02, "ms_n_mels": 24,
    "ms_seg_length": 7, "ms_seg_hop_length": 2, "ms_max_segments": 64,
    "ms_channel": None,
    "cnn_model": "adapt", "cnn_c_out_1": 4, "cnn_c_out_2": 8,
    "cnn_c_out_3": 8, "cnn_kernel_size": 3, "cnn_dropout": 0.2,
    "cnn_pool_1": [12, 5], "cnn_pool_2": [6, 3], "cnn_pool_3": [4, 2],
    "cnn_fc_out_h": None,
    "td": "self_att", "td_sa_d_model": 16, "td_sa_nhead": 1,
    "td_sa_pos_enc": None, "td_sa_num_layers": 1, "td_sa_h": 16,
    "td_sa_dropout": 0.1, "td_lstm_h": None, "td_lstm_num_layers": None,
    "td_lstm_dropout": None, "td_lstm_bidirectional": None,
    "td_2": "skip", "pool": "att", "pool_att_h": 8, "pool_att_dropout": 0.1,
}


def _flagship_model_args():
    from .compat.model_args import model_args_from_ckpt_args

    return model_args_from_ckpt_args({"model": "NISQA_DIM"})


def flagship_model(device, state_dict=None):
    """The flagship NISQA_DIM on ``device``, its weights drawn from seed 0
    with the global generator left as it was, or ``state_dict`` loaded with
    ``strict=True``."""
    from .models.nisqa import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("NISQA_DIM", _flagship_model_args())
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device)


def entry(device=None, state_dict=None):
    """(fn, (segs (4, 163, 48, 15), n_wins (4,))) on ``device`` (None: the
    card; raises without one). ``fn`` is the flagship model in eval mode;
    ``fn(*args)`` gives the (4, 5) predictions."""
    from .model import resolve_device

    device = resolve_device(device)
    fn = flagship_model(device, state_dict).eval()
    rng = np.random.default_rng(0)
    segs = rng.uniform(-80.0, 0.0, size=(ENTRY_BATCH, ENTRY_T, 48, 15)).astype(np.float32)
    n_wins = np.array([ENTRY_T, ENTRY_T // 2, ENTRY_T // 3, 20], dtype=np.int32)
    return fn, (torch.from_numpy(segs).to(device), torch.from_numpy(n_wins).to(device))


def step_batch(n: int):
    """The dry run's train batch over ``n`` ranks, numpy-seeded as the JAX
    version's: (segs (2n, 16, 48, 15), n_wins (2n,), y (2n, 5)); rank r
    takes rows 2r and 2r + 1."""
    b = STEP_ROWS_PER_RANK * n
    rng = np.random.default_rng(0)
    segs = rng.uniform(-80.0, 0.0, size=(b, STEP_T, 48, 15)).astype(np.float32)
    n_wins = rng.integers(4, STEP_T + 1, size=(b,)).astype(np.int32)
    y = rng.uniform(1.0, 5.0, size=(b, 5)).astype(np.float32)
    return segs, n_wins, y


def dp_train_step(model, opt, dp, segs, n_wins, y):
    """One data-parallel train step on this rank's rows (``segs``,
    ``n_wins``, ``y``) of a batch split over the ranks of ``dp``: the
    train-mode forward with batch norm over every rank's rows, the loss
    sum_k nan_mse(y_hat[:, k], y[:, k]) over the whole batch (each rank
    divides by the whole batch's count of valid targets), the gradients
    summed over the ranks, then ``opt.step()``. Returns the whole batch's
    loss; the summed gradients stay in the parameters' ``.grad``."""
    import torch.distributed as dist

    from .data.pipeline import matmul_precision
    from .parallel.mesh import all_reduce_grads
    from .train.loop import nan_mse

    counts = (~torch.isnan(y)).sum(dim=0).to(y.dtype)
    dist.all_reduce(counts, group=dp.group)
    model.train()
    model.set_process_group(dp.group)
    with matmul_precision("highest"):
        y_hat = model(segs, n_wins)
        loss = sum(nan_mse(y_hat[:, k], y[:, k], counts[k].clamp(min=1.0))
                   for k in range(y.shape[1]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(model.parameters(), dp.group)
        opt.step()
    total = loss.detach().clone()
    dist.all_reduce(total, group=dp.group)
    return total


def same_on_every_rank(module, dp) -> bool:
    """Whether every floating-point parameter and buffer of ``module`` is
    bitwise equal to rank 0's, on every rank."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1) for t in module.state_dict().values()
                      if t.is_floating_point()])
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=dp.group)
    same = torch.tensor([float(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(same, group=dp.group)
    return int(same.item()) == dp.size


def _require(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(msg)


def _check_step(n: int, dp, say) -> float:
    """(a) One DP train step of the flagship model, dropout on."""
    segs, n_wins, y = step_batch(n)
    rows = slice(STEP_ROWS_PER_RANK * dp.rank, STEP_ROWS_PER_RANK * (dp.rank + 1))
    model = flagship_model(dp.device)
    # dropout from a stream of each rank's own, as the train loop's
    model.set_dropout_generator(torch.Generator(device=dp.device).manual_seed(1 + dp.rank))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)  # optax.scale_by_adam, p - lr * u
    loss = float(dp_train_step(model, opt, dp, *(torch.from_numpy(a[rows]).to(dp.device)
                                                 for a in (segs, n_wins, y))))
    _require(np.isfinite(loss), f"non-finite loss: {loss}")
    _require(same_on_every_rank(model, dp), "the ranks' weights differ after the step")
    say(f"dryrun_multichip({n}): one DP train step OK ({dp.backend}, weights equal on every "
        f"rank), loss={loss:.4f}")
    return loss


def write_dryrun_corpus(out_dir: str):
    """Six 0.7 s sines at 8 kHz and ``c.csv`` (4 files db T, 2 db V, MOS
    from a seeded generator), as the JAX version writes them. Returns the
    paths."""
    from .audio.wav import write_wav

    rng = np.random.default_rng(0)
    names = []
    for i in range(DRYRUN_FILES):
        t = np.arange(int(DRYRUN_SR * 0.7)) / DRYRUN_SR
        wav = 0.4 * np.sin(2 * np.pi * (180 + 40 * i) * t)
        names.append(f"d{i}.wav")
        write_wav(os.path.join(out_dir, names[-1]), wav.astype(np.float32), DRYRUN_SR)
    mos = rng.uniform(1, 5, DRYRUN_FILES).round(2)
    with open(os.path.join(out_dir, "c.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "db", "mos"])
        for i, name in enumerate(names):
            w.writerow([name, "T" if i < 4 else "V", mos[i]])
    return [os.path.join(out_dir, name) for name in names]


def _check_epoch(n: int, dp, device, tmp: str, say):
    """(b) One ``TrainEngine`` epoch from the device-resident corpus, the
    batches sharded over the ranks. Returns (the runner, its epoch loss)."""
    from .model import NisqaTorch
    from .train.loop import TrainEngine, _bias_losses

    args = {**DRYRUN_ARGS, "data_dir": tmp, "output_dir": tmp, "tr_device": device}
    with contextlib.redirect_stdout(io.StringIO()):  # the runner prints its args
        runner = NisqaTorch(args)
    _require(runner.dp is not None and runner.dp.size == n,
             f"the runner is not on the {n}-rank group: {runner.dp}")
    eng = TrainEngine(runner)
    # the port's run_epoch takes an epoch number where the JAX one takes a PRNG key
    ep_loss, y_hat = eng.run_epoch(runner.ds_train, _bias_losses(runner, 1), 1e-3, 3,
                                   batch_size=3)
    _require(bool(eng._corpus), "the device corpus must be resident over the group")
    _require(bool(np.isfinite(ep_loss) and np.isfinite(y_hat).all()),
             f"non-finite epoch: loss {ep_loss}, predictions {y_hat}")
    say(f"dryrun_multichip({n}): TrainEngine DP epoch OK (resident corpus, sharded "
        f"batches), loss={ep_loss:.4f}")
    return runner, float(ep_loss)


def _check_serving(n: int, dp, runner, paths, say) -> dict:
    """(c) ``predict_paths`` over the group (each rank runs whole batches
    of the plan) against one process: cold within ``DRYRUN_BOUND``, the
    cached pass and two async cached passes equal to the cold one. On the
    card the group's front-end is the CUDA kernel, one launch per batch
    of the rank. Both engines take the exact front-end and "highest", so
    that the check sees the split over the ranks, not the precision
    policy; the group's cached passes run batch by batch
    (``fuse_pass=False``), an exact replay of the cold pass's batches from
    its resident mels (a fused pass regroups the rows, and the model's sums
    then differ in the last bits)."""
    import torch.distributed as dist

    from .data.pipeline import InferenceEngine, MsConfig
    from .ops.dft_mel import fused_dft_mel

    ms = MsConfig({k: v for k, v in DRYRUN_ARGS.items() if k.startswith("ms_")})
    kw = {"num_workers": 1, "precision": "highest", "fe_precision": "exact"}
    y_single = InferenceEngine(runner.model, ms, dp.device, batch_size=4,
                               **kw).predict_paths(paths)
    eng = InferenceEngine(runner.model, ms, dp.device, batch_size=n, mesh=dp, fuse_pass=False,
                          **kw)
    _require(eng.dft_mel is fused_dft_mel, "the group's front-end must be fused_dft_mel")
    fused_dft_mel.LAUNCHES = 0
    y = eng.predict_paths(paths)
    launches = fused_dft_mel.LAUNCHES
    batches = len(eng.plan(paths))
    on_card = dp.device.type == "cuda"
    # on the CPU the wrapper computes its plain twin and counts nothing
    _require(launches == (batches if on_card else 0),
             f"rank {dp.rank}: {launches} kernel launches for {batches} cold batches")
    y2 = eng.predict_paths(paths)  # cached: the cold pass's mels, resident
    diff = float(np.abs(y - y_single).max())
    _require(diff <= DRYRUN_BOUND, f"serving over the group != one process: {diff}")
    _require(np.array_equal(y2, y), "cached pass != cold pass")
    # a rank that owns no batch of the plan (more ranks than batches) keeps
    # nothing, and its passes stay cold, with no work of its own
    _require(eng.stats["cache_hits"] == (1 if batches else 0),
             f"rank {dp.rank}: cache hits {eng.stats['cache_hits']} with {batches} batches")
    # pipelined serving: two async cached passes, both dispatched before either resolves
    h1 = eng.predict_paths(paths, fetch="async")
    h2 = eng.predict_paths(paths, fetch="async")
    _require(np.array_equal(h1(), y) and np.array_equal(h2(), y), "async cached pass != sync")
    per_rank = [None] * dp.size
    dist.all_gather_object(per_rank, (launches, batches), group=dp.group)
    front = ("the CUDA fused_dft_mel kernel" if on_card
             else "the DFT->mel twin on the CPU")
    say(f"dryrun_multichip({n}): InferenceEngine DP serving OK ({front}, launches per rank "
        f"{[p[0] for p in per_rank]}, corpus cache, async fetch), max_abs_diff vs one "
        f"process {diff:.3e}, mos={float(y[0, 0]):.3f}")
    return {"max_abs_diff": diff, "mos": y[:, 0].tolist(),
            "launches_by_rank": [p[0] for p in per_rank],
            "batches_by_rank": [p[1] for p in per_rank]}


def _run_checks(n: int, device) -> dict:
    """The three checks on this rank of an ``n``-rank launch."""
    from .model import resolve_device
    from .parallel.mesh import init_data_parallel

    dp = init_data_parallel({"tr_parallel": True}, resolve_device(device))
    _require(dp is not None and dp.size == n, f"dryrun_multichip({n}) on a group of {dp}")
    say = print if dp.rank == 0 else (lambda *_: None)
    t0 = time.perf_counter()
    step_loss = _check_step(n, dp, say)
    t1 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="nisqa_dryrun_")  # each rank writes its own copy
    try:
        paths = write_dryrun_corpus(tmp)
        runner, epoch_loss = _check_epoch(n, dp, device, tmp, say)
        t2 = time.perf_counter()
        serving = _check_serving(n, dp, runner, paths, say)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t3 = time.perf_counter()
    return {"ranks": n, "backend": dp.backend, "device": dp.device.type,
            "step_loss": step_loss, "epoch_loss": epoch_loss, **serving,
            "wall_s": {"step": t1 - t0, "epoch": t2 - t1, "serving": t3 - t2}}


def dryrun_multichip(n: int, device=None, timeout: float = LAUNCH_TIMEOUT) -> dict:
    """The three checks over an ``n``-rank group; returns rank 0's record.

    Under a launcher (``WORLD_SIZE`` set) this rank runs them. Otherwise it
    starts ``python -m torch.distributed.run --standalone --nproc_per_node
    n -m nisqa_tpu_torch.graft_entry --multichip n`` in a session of its
    own, killed whole after ``timeout`` s, prints the ranks' check lines and
    raises with the ranks' output when any rank fails. ``device`` None means
    the card (raises without one); "cpu" runs the ranks on the CPU over
    gloo."""
    from .model import resolve_device

    resolve_device(device)  # no launch without the card that was asked for
    if "WORLD_SIZE" in os.environ:
        _require(int(os.environ["WORLD_SIZE"]) == n,
                 f"dryrun_multichip({n}) under a launch of {os.environ['WORLD_SIZE']} ranks")
        return _run_checks(n, device)
    with tempfile.TemporaryDirectory(prefix="nisqa_dryrun_") as tmp:
        record = os.path.join(tmp, "record.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               str(n), "-m", "nisqa_tpu_torch.graft_entry", "--multichip", str(n),
               "--record", record] + (["--device", str(device)] if device is not None else [])
        path = os.environ.get("PYTHONPATH")
        env = {**os.environ, "PYTHONPATH": REPO + (os.pathsep + path if path else "")}
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env=env, start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            raise RuntimeError(f"dryrun_multichip({n}) took over {timeout} s; the ranks' "
                               f"output:\n{out}") from None
        if proc.returncode != 0:
            raise RuntimeError(f"dryrun_multichip({n}): a rank failed (torchrun exit "
                               f"{proc.returncode}); the ranks' output:\n{out}")
        for line in out.splitlines():
            if line.startswith("dryrun_multichip("):
                print(line, flush=True)
        with open(record) as f:
            return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", nargs="?", type=int, const=0, default=None, metavar="N",
                    help="run the dry run over N ranks (default: the card count when there "
                         "is more than one card, else 2)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; unset means the card (raises without one)")
    ap.add_argument("--record", help="write the dry run's JSON record to this file")
    opts = ap.parse_args(argv)
    if opts.multichip is None:
        fn, args = entry(opts.device)
        with torch.inference_mode():
            out = fn(*args)
        print("entry forward:", out.cpu().numpy())
        return out
    # N: the card count when there is more than one card, else 2 (over gloo
    # on the one card, or on the CPU)
    cards = torch.cuda.device_count() if opts.device != "cpu" else 0
    rec = dryrun_multichip(opts.multichip or (cards if cards > 1 else 2), opts.device)
    if opts.record and int(os.environ.get("RANK", 0)) == 0:
        with open(opts.record, "w") as f:
            json.dump(rec, f)
    if "WORLD_SIZE" in os.environ:
        from .parallel.mesh import destroy_data_parallel

        destroy_data_parallel()
    return rec


if __name__ == "__main__":
    main()
