"""The port's NISQA_DE model held against the torch goldens and the JAX
package on the CPU.

The double-ended goldens (cosine / hard, x/y/- in ``g5``; bahd / soft,
distance / hard, dot / soft, luong / hard with ``+/-``, ``x/y`` and
``fuse_dim`` in the four ``g9_de_*``) load with ``strict=True``. Random
narrow DE models of every scorer x apply, with every fusion mode and
``fuse_dim`` set and unset, carry over from ``NisqaNet.init`` through
``state_dict_from_jax`` and give the JAX outputs at "highest" precision on
ragged ``n_deg != n_ref``. The scorers alone: the chunked distance and bahd
equal their one-chunk form, and every scorer equals ``_scores``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nisqa_tpu.compat.model_args import model_args_from_ckpt_args
from nisqa_tpu.compat.torch_ckpt import params_to_torch
from nisqa_tpu.models import align as jax_align
from nisqa_tpu.models.nisqa import build_model as build_jax_model
from nisqa_tpu_torch.compat.jax_params import state_dict_from_jax
from nisqa_tpu_torch.models import align
from nisqa_tpu_torch.models.nisqa import build_model
from tests.test_e2e import TINY_ARGS

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
DE_GOLDENS = ["g5_double_ended", "g9_de_bahd_soft", "g9_de_distance_hard", "g9_de_dot_soft",
              "g9_de_luong_hard"]


@pytest.mark.parametrize("name", DE_GOLDENS)
def test_de_golden_loads_strict_and_matches(name):
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"), allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    model = build_model(meta["model"], meta["model_args"])
    model.load_state_dict(sd, strict=True)
    model.eval()
    assert meta["model"] == "NISQA_DE" and sorted(model.state_dict()) == sorted(sd)
    x, n_wins = torch.from_numpy(z["x"]), torch.from_numpy(z["n_wins"])
    with torch.no_grad():
        y = model(x, n_wins).numpy()
        # the reference's hooks keep the last of the two trunk calls: the
        # reference end
        cnn_out = model.cnn(x[:, :, 1])
        td_out = model.time_dependency(cnn_out, n_wins[:, 1]).numpy()
    assert y.shape == z["y"].shape == (3, 1)
    assert np.abs(y - z["y"]).max() <= 2e-4
    for b, nw in enumerate(z["n_wins"][:, 1]):  # pad frames differ by design
        assert np.abs(cnn_out.numpy()[b, :nw] - z["tap::cnn_out"][b, :nw]).max() <= 1e-4
        assert np.abs(td_out[b, :nw] - z["tap::td_out"][b, :nw]).max() <= 1e-4


def test_de_trained_tar_loads_strict():
    from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar

    model, args = load_model_from_tar(os.path.join(GOLDEN_DIR, "de_trained.tar"))
    assert model.name == "NISQA_DE" and args["csv_ref"] == "ref"
    assert (model.align.method, model.align.apply_method, model.fuse.fuse) == \
        ("cosine", "hard", "x/y/-")
    assert sum(v.numel() for v in model.state_dict().values()) == 281_928


# every scorer (and none) x apply; the six (fusion, fuse_dim) pairs cycle
# through them, so each appears twice
SCORERS = [(m, a) for m in ("dot", "cosine", "distance", "bahd", "luong", "none")
           for a in ("hard", "soft")]
FUSIONS = [("x/y/-", None), ("+/-", None), ("x/y", None), ("x/y/-", 12), ("+/-", 12),
           ("x/y", 12)]
NARROW_DE = {f"{m}_{a}_{f.replace('/', '')}_{d or 0}": (m, a, f, d)
             for (m, a), (f, d) in zip(SCORERS, FUSIONS * 2)}
SA2 = {"td_2": "self_att", "td_2_sa_d_model": 8, "td_2_sa_nhead": 2, "td_2_sa_num_layers": 1,
       "td_2_sa_h": 8, "td_2_sa_pos_enc": False}


def _narrow_de(key, seed=7):
    method, apply, fuse, fuse_dim = NARROW_DE[key]
    # td_2 self-attention on half the cases, skip on the others
    extra = SA2 if list(NARROW_DE).index(key) % 2 else {}
    margs = model_args_from_ckpt_args({**TINY_ARGS, "model": "NISQA_DE", **extra,
                                       "de_align": method, "de_align_apply": apply,
                                       "de_fuse": fuse, "de_fuse_dim": fuse_dim})
    jmodel = build_jax_model("NISQA_DE", margs)
    params, state = jmodel.init(jax.random.PRNGKey(seed))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return margs, jmodel, to_np(params), to_np(state)


@pytest.mark.parametrize("key", list(NARROW_DE))
def test_narrow_de_model_matches_jax(key):
    margs, jmodel, params, state = _narrow_de(key)
    sd = state_dict_from_jax(params, state, "NISQA_DE", margs)
    theirs = params_to_torch(jmodel, params, state)
    assert list(sd) == list(theirs)
    model = build_model("NISQA_DE", margs)
    model.load_state_dict(sd, strict=True)
    model.eval()

    rng = np.random.default_rng(13)
    h, s = int(margs["ms_n_mels"]), int(margs["ms_seg_length"])
    x = (rng.standard_normal((4, 13, 2, h, s)) * 10 - 40).astype(np.float32)
    n_wins = np.array([[13, 13], [7, 3], [1, 13], [10, 1]], np.int32)
    with jax.default_matmul_precision("highest"):
        y_ref, _ = jmodel.apply(params, state, x, n_wins)
    with torch.no_grad():
        y = model(torch.from_numpy(x), torch.from_numpy(n_wins).long()).numpy()
    assert y.shape == (4, 1)
    assert np.abs(y - np.asarray(y_ref)).max() <= 1e-5


def _scorer_pair(method, q_dim=6, seed=3):
    """A JAX alignment def and the port's Alignment with the same weights."""
    adef = jax_align.alignment_init(jax.random.PRNGKey(seed), method, q_dim, q_dim, att_dim=10)
    mod = align.Alignment(method, "hard", q_dim, q_dim, att_dim=10)
    for key, name in (("wq", "Wq"), ("wy", "Wy"), ("v", "v"), ("w", "W")):
        if key in adef["params"]:
            p = adef["params"][key]
            mod.att[name].weight.data = torch.from_numpy(np.array(p["w"]).T.copy())
            mod.att[name].bias.data = torch.from_numpy(np.array(p["b"]))
    return adef, mod


@pytest.mark.parametrize("method", ["dot", "cosine", "distance", "bahd", "luong"])
def test_scores_match_jax_and_chunks_change_nothing(method, monkeypatch):
    """Each scorer equals ``nisqa_tpu.models.align._scores``; distance and
    bahd computed over one-row and three-row chunks of the queries equal
    their one-chunk form."""
    adef, mod = _scorer_pair(method)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 9, 6)).astype(np.float32)
    y = rng.standard_normal((2, 7, 6)).astype(np.float32)
    with torch.no_grad():
        whole = mod.scores(torch.from_numpy(q), torch.from_numpy(y)).numpy()
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jax_align._scores(method, adef["params"], jnp.asarray(q),
                                               jnp.asarray(y)))
        assert whole.shape == (2, 9, 7)
        np.testing.assert_allclose(whole, ref, rtol=1e-5, atol=1e-6)
        width = 10 if method == "bahd" else 6
        for rows in (1, 3):  # the byte budget of `rows` query rows
            monkeypatch.setattr(align, "_CHUNK_BYTES", rows * 2 * 7 * width * 4)
            got = mod.scores(torch.from_numpy(q), torch.from_numpy(y)).numpy()
            np.testing.assert_allclose(got, whole, rtol=0, atol=1e-6)


def test_cosine_scores_match_jax_on_small_norms():
    """``tests/test_round2_fixes.py``'s near-silent and all-zero frames: the
    per-norm clamp at 1e-8 gives ``_scores``'s values."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 8)).astype(np.float32)
    y = rng.standard_normal((2, 7, 8)).astype(np.float32)
    q[0, 0] *= 1e-5
    y[0, 3] *= 1e-6
    y[1, 2] = 0.0
    ours = align.Alignment("cosine", "hard", 8, 8).scores(torch.from_numpy(q), torch.from_numpy(y))
    ref = np.asarray(jax_align._scores("cosine", {}, jnp.asarray(q), jnp.asarray(y)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_eval_trunk_over_both_ends_equals_two_calls():
    """In eval the shared trunk runs once over both ends' rows; in train
    mode it runs twice, degraded end first. Both give the same features, so
    the eval output equals the two-call form within float rounding."""
    margs, _, params, state = _narrow_de("cosine_hard_xy_0")
    model = build_model("NISQA_DE", margs)
    model.load_state_dict(state_dict_from_jax(params, state, "NISQA_DE", margs), strict=True)
    model.eval()
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((3, 9, 2, 24, 7)) * 10 - 40).astype(np.float32))
    n = torch.tensor([[9, 4], [2, 9], [5, 5]])
    with torch.no_grad():
        y = model(x, n)
        feats = [model.time_dependency(model.cnn(x[:, :, e]), n[:, e]) for e in (0, 1)]
        for got, want in zip(model.trunk_ends(x[:, :, 0], n[:, 0], x[:, :, 1], n[:, 1]), feats):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
        h = model.time_dependency_2(model.fuse(feats[0], model.align(*feats, n[:, 1])), n[:, 0])
        np.testing.assert_allclose(y.numpy(), model.pool(h, n[:, 0]).numpy(), atol=1e-6)
