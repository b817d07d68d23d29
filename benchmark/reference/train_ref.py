"""The plain reference of the first train steps, and the numbers that
compare a program's steps with it.

The reference starts from the weights the benchmark made, takes the batches
of epoch 1 by the run's documented shuffle (numpy's ``default_rng`` seeded
with ``SeedSequence([seed, epoch])``, then ``shuffle`` of the file indices),
runs each step's front end, train-mode forward, mean squared error,
gradient and Adam update in plain PyTorch (``nisqa_ref``), and applies the
program's dropout masks: a mask is a random draw of the program's, so the
reference takes the program's masks and the stage that draws them is held
by itself (``mask_z``: each mask holds only 0 and 1, and its share of ones
lies within six standard deviations of the keep probability).

Numbers compared (each the worst over its items):
  * ``loss_gap``: each step's loss, relative to the reference's;
  * ``grad_gap``: each leaf's gradient norm at step 1, as the optimizer
    got it, against the reference's: |norm_p - norm_r| over the larger of
    norm_r and the median leaf's norm_r;
  * ``step_gap``: the same of the norm of each leaf's change over the
    compared steps.
A leaf whose reference gradient norm lies under a thousandth of the median
leaf's is left out of both leaf numbers: Adam moves such a leaf by
round-off alone (a softmax score's bias has an exact gradient of 0).
"""

from __future__ import annotations

import numpy as np
import torch

from . import nisqa_ref as ref


def shuffle(seed: int, epoch: int, n: int) -> np.ndarray:
    s = int(np.random.SeedSequence([int(seed), int(epoch)]).generate_state(1)[0])
    order = np.arange(n)
    np.random.default_rng(s).shuffle(order)
    return order


def steps(state, spec, pcm, mos, cfg, sr, bs, order, masks, n_steps, device, dtype=torch.float32,
          tf32=False, half=False):
    """Runs the reference's first ``n_steps`` steps. Returns (losses, leaf
    gradients of step 1, leaf values after the steps). ``half``: each step
    on the first half of its batch alone (a planted fault)."""
    from ..drivers.scoring import tf32 as tf32_flags

    names = ref.leaves(spec)
    params = {n: state[n].to(dtype).clone() for n in names}
    adam = ref.Adam(float(cfg["tr_lr"]))
    keep_cnn, keep_sa = 1.0 - float(cfg["cnn_dropout"]), 1.0 - float(cfg["td_sa_dropout"])
    seg, hop = int(cfg["ms_seg_length"]), int(cfg["ms_seg_hop_length"])
    losses, grads0 = [], None
    with tf32_flags(tf32):
        fe = ref.FrontEnd(cfg, sr, device, dtype)
        for k in range(n_steps):
            files = order[k * bs:(k + 1) * bs]
            t_bucket = masks[k][0].shape[0] // len(files)
            if half:
                files = files[: len(files) // 2]
            with torch.no_grad():
                segs = [ref.segments(fe.db(pcm[i]), seg, hop) for i in files]
            leaf = {n: v.detach().requires_grad_() for n, v in params.items()}
            p = {**{n: state[n].to(dtype) for n, _, _ in spec}, **leaf}
            y_hat = ref.train_forward(p, cfg, segs, ref.Masks(masks[k], keep_cnn, keep_sa), t_bucket)
            y = torch.tensor(np.asarray(mos)[files], dtype=dtype, device=device)[:, None]
            loss = ref.mse_loss(y_hat, y)
            g = dict(zip(names, torch.autograd.grad(loss, [leaf[n] for n in names])))
            losses.append(float(loss.detach()))
            if k == 0:
                grads0 = {n: v.detach() for n, v in g.items()}
            adam.step(params, {n: v.detach() for n, v in g.items()})
    return losses, grads0, {n: v.detach() for n, v in params.items()}


def _norms(d):
    return {n: float(torch.linalg.vector_norm(v.double())) for n, v in d.items()}


def compare(prog, refr, p0) -> dict:
    """The three numbers of ``prog`` against ``refr``, each (losses, step-1
    gradients, leaves after the steps); ``p0`` the leaves before."""
    (lp, gp, pp), (lr, gr, pr) = prog, refr
    g_ref = _norms(gr)
    med_all = float(np.median(list(g_ref.values())))
    counted = [n for n, v in g_ref.items() if v >= 1e-3 * med_all]

    def leaf_gaps(a, b):
        med = float(np.median([b[n] for n in counted]))
        return {n: abs(a[n] - b[n]) / max(b[n], med) for n in counted}

    d_p = _norms({n: pp[n].double() - p0[n].double() for n in counted})
    d_r = _norms({n: pr[n].double() - p0[n].double() for n in counted})
    grad = leaf_gaps(_norms({n: gp[n] for n in counted}), g_ref)
    step = leaf_gaps(d_p, d_r)
    losses = [abs(a - b) / abs(b) for a, b in zip(lp, lr)]
    return {"loss_gap": max(losses), "grad_gap": max(grad.values()), "step_gap": max(step.values()),
            "left_out": sorted(set(g_ref) - set(counted)), "loss_gap_by_step": losses,
            "worst_grad_leaf": max(grad, key=grad.get), "worst_step_leaf": max(step, key=step.get)}


def mask_z(masks, cfg, shift: float = 0.0) -> float:
    """The largest deviation of a mask's share of ones from its keep
    probability, in binomial standard deviations; 1e30 for a mask with a
    value other than 0 and 1. ``shift`` moves every keep probability (the
    reading of masks drawn at a rate the configuration does not state)."""
    keeps = [1.0 - float(cfg["cnn_dropout"]) + shift] * 4 + [
        1.0 - float(cfg["td_sa_dropout"]) + shift] * (4 * int(cfg["td_sa_num_layers"]))
    worst = 0.0
    for step in masks.values():
        for m, keep in zip(step, keeps):
            if not bool(((m == 0) | (m == 1)).all()):
                return 1e30
            n = m.numel()
            worst = max(worst, abs(float(m.float().mean()) - keep) / np.sqrt(keep * (1 - keep) / n))
    return worst


def check(program, state, spec, pcm, mos, cfg, sr, n_train, bs, seed, n_steps, device, limits):
    """[(name, value, limit)] of the program's first steps."""
    from ..drivers.scoring import finite

    names = ref.leaves(spec)
    want = 4 + 4 * int(cfg["td_sa_num_layers"])
    masks = program["masks"]
    ok = (program["grads"] is not None and program["params"] is not None
          and len(program["losses"]) == n_steps
          and all(len(masks.get(k, [])) == want for k in range(n_steps)))
    if not ok:
        vals = {"loss_gap": 1e30, "grad_gap": 1e30, "step_gap": 1e30, "mask_z": 1e30}
    else:
        order = shuffle(seed, 0, n_train)
        refr = steps(state, spec, pcm, mos, cfg, sr, bs, order, masks, n_steps, device)
        p0 = {n: state[n].float() for n in names}
        vals = compare((program["losses"], program["grads"], program["params"]), refr, p0)
        vals["mask_z"] = mask_z(masks, cfg)
    return [(k, finite(vals[k]), limits[k]) for k in ("loss_gap", "grad_gap", "step_gap", "mask_z")]
