"""The port's single-ended model zoo held against the torch goldens and the
JAX package on the CPU.

Every zoo golden (StandardCNN, DFF, Skip, LSTM uni / bi / two-layer,
positional encoding, avg / max / last-step / last-step-bi pooling) loads its
released-format state dict with ``strict=True``. Random narrow models of
every framewise x time-dependency x td_2 x pool kind carry over from
``NisqaNet.init`` through ``state_dict_from_jax`` and give the JAX outputs
at "highest" precision on ragged lengths (1 and T included).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from nisqa_tpu.compat.model_args import model_args_from_ckpt_args
from nisqa_tpu.compat.torch_ckpt import params_to_torch
from nisqa_tpu.models import modules as jax_modules
from nisqa_tpu.models.nisqa import build_model as build_jax_model
from nisqa_tpu_torch.compat.jax_params import state_dict_from_jax
from nisqa_tpu_torch.models.modules import MaskedLSTM
from nisqa_tpu_torch.models.nisqa import build_model
from tests.test_e2e import TINY_ARGS

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
ZOO = ["g3_tts", "g4_cnn_lstm_avg", "g6_dff_poolatt", "g7_skip_max", "g8_lstm2_laststep",
       "g10_posenc"]


@pytest.mark.parametrize("name", ZOO)
def test_zoo_golden_loads_strict_and_matches(name):
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"), allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    model = build_model(meta["model"], meta["model_args"])
    model.load_state_dict(sd, strict=True)
    model.eval()
    assert sorted(model.state_dict()) == sorted(sd)
    x, n_wins = torch.from_numpy(z["x"][:, :, 0]), torch.from_numpy(z["n_wins"])
    with torch.no_grad():
        y = model(x, n_wins).numpy()
        cnn_out = model.cnn(x)
        td_out = model.time_dependency(cnn_out, n_wins).numpy()
    assert y.shape == z["y"].shape
    assert np.abs(y - z["y"]).max() <= 2e-4
    for b, nw in enumerate(z["n_wins"]):  # pad frames differ by design
        assert np.abs(cnn_out.numpy()[b, :nw] - z["tap::cnn_out"][b, :nw]).max() <= 1e-4
        assert np.abs(td_out[b, :nw] - z["tap::td_out"][b, :nw]).max() <= 1e-4


# narrow random models covering every stage option: framewise adapt /
# standard / dff / skip (with and without fc); td and td_2 self_att (with and
# without positional encoding), lstm uni / bi / two-layer, skip; pool att,
# att_ff, avg, max, last_step, last_step_bi
STD = {"ms_n_mels": 48, "ms_seg_length": 15, "cnn_model": "standard", "cnn_kernel_size": [3, 3]}
SA2 = {"td_2": "self_att", "td_2_sa_d_model": 8, "td_2_sa_nhead": 2, "td_2_sa_num_layers": 1,
       "td_2_sa_h": 8}


def _lstm(prefix, h, layers, bi):
    return {prefix: "lstm", f"{prefix}_lstm_h": h, f"{prefix}_lstm_num_layers": layers,
            f"{prefix}_lstm_bidirectional": bi, f"{prefix}_lstm_dropout": 0}


NARROW = {
    "standard_fc_lstmbi_lastbi": ("NISQA", {**STD, "cnn_fc_out_h": 12, **_lstm("td", 8, 1, True),
                                            "pool": "last_step_bi"}),
    "standard_lstmbi_avg_dim": ("NISQA_DIM", {**STD, **_lstm("td", 8, 1, True), "pool": "avg"}),
    "dff_sa_att": ("NISQA", {"cnn_model": "dff", "cnn_fc_out_h": 16, "pool_att_h": None}),
    "skip_sa_max": ("NISQA", {"cnn_model": "skip", "pool": "max"}),
    "skip_fc_lstm2_last": ("NISQA", {"cnn_model": "skip", "cnn_fc_out_h": 12,
                                     **_lstm("td", 8, 2, False), "pool": "last_step"}),
    "adapt_lstm2bi_attff": ("NISQA", {**_lstm("td", 6, 2, True)}),
    "adapt_posenc_att_dim": ("NISQA_DIM", {"td_sa_pos_enc": True, "pool_att_h": None}),
    "sa_td2_lstmbi_lastbi": ("NISQA", {**_lstm("td_2", 8, 1, True), "pool": "last_step_bi"}),
    "lstm_td2_sa_posenc_avg": ("NISQA", {**_lstm("td", 8, 1, False), **SA2,
                                         "td_2_sa_pos_enc": True, "pool": "avg"}),
    "skip_td_td2_lstm_max": ("NISQA", {"td": "skip", **_lstm("td_2", 8, 1, False),
                                       "pool": "max"}),
    "lstmbi_lastbi_dim": ("NISQA_DIM", {**_lstm("td", 8, 1, True), "pool": "last_step_bi"}),
}


def _narrow(key, seed=5):
    name, extra = NARROW[key]
    margs = model_args_from_ckpt_args({**TINY_ARGS, "model": name, **extra})
    jmodel = build_jax_model(name, margs)
    params, state = jmodel.init(jax.random.PRNGKey(seed))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return name, margs, jmodel, to_np(params), to_np(state)


@pytest.mark.parametrize("key", list(NARROW))
def test_narrow_zoo_model_matches_jax(key):
    name, margs, jmodel, params, state = _narrow(key)
    model = build_model(name, margs)
    model.load_state_dict(state_dict_from_jax(params, state, name, margs), strict=True)
    model.eval()
    # state dict names survive a round trip (the LSTM's are renamed by hooks)
    model.load_state_dict(model.state_dict(), strict=True)

    rng = np.random.default_rng(11)
    h, s = int(margs["ms_n_mels"]), int(margs["ms_seg_length"])
    x = (rng.standard_normal((4, 13, h, s)) * 10 - 40).astype(np.float32)
    n_wins = np.array([13, 7, 1, 10], np.int32)
    with jax.default_matmul_precision("highest"):
        y_ref, _ = jax.jit(jmodel.apply)(params, state, x, n_wins)
    with torch.no_grad():
        y = model(torch.from_numpy(x), torch.from_numpy(n_wins).long()).numpy()
    assert y.shape == (4, 5 if name == "NISQA_DIM" else 1)
    assert np.abs(y - np.asarray(y_ref)).max() <= 1e-5


@pytest.mark.parametrize("key", list(NARROW))
def test_zoo_state_dict_from_jax_equals_params_to_torch(key):
    name, margs, jmodel, params, state = _narrow(key)
    ours = state_dict_from_jax(params, state, name, margs)
    theirs = params_to_torch(jmodel, params, state)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert sorted(build_model(name, margs).state_dict()) == sorted(theirs)


@pytest.mark.parametrize("layers,bi", [(1, False), (1, True), (3, True)])
def test_masked_lstm_matches_jax_lstm(layers, bi):
    """The packed-sequence semantics on their own: outputs past n_wins are
    zero and the reverse direction starts at n_wins - 1, for every row."""
    params = jax_modules.lstm_init(jax.random.PRNGKey(layers), 5, 6, layers, bi)
    lstm = MaskedLSTM(5, 6, layers, bi)
    sd = {}
    for k, layer in enumerate(params["layers"]):
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            if direction in layer:
                d = {n: np.array(v) for n, v in layer[direction].items()}
                sd[f"weight_ih_l{k}{sfx}"] = torch.from_numpy(d["w_ih"].T.copy())
                sd[f"weight_hh_l{k}{sfx}"] = torch.from_numpy(d["w_hh"].T.copy())
                sd[f"bias_ih_l{k}{sfx}"] = torch.from_numpy(d["b_ih"])
                sd[f"bias_hh_l{k}{sfx}"] = torch.from_numpy(d["b_hh"])
    lstm.load_state_dict(sd, strict=True)
    assert sorted(lstm.state_dict()) == sorted(sd)
    x = np.random.default_rng(layers).standard_normal((5, 17, 5)).astype(np.float32)
    n_wins = np.array([17, 1, 9, 16, 2], np.int32)
    with jax.default_matmul_precision("highest"):
        y_ref = np.asarray(jax_modules.lstm(params, x, n_wins, bi))
    with torch.no_grad():
        y = lstm(torch.from_numpy(x), torch.from_numpy(n_wins).long()).numpy()
    assert y.shape == (5, 17, 6 * (2 if bi else 1))
    for b, nw in enumerate(n_wins):
        assert not y[b, nw:].any()
    assert np.abs(y - y_ref).max() <= 1e-5


@pytest.mark.parametrize("extra,match", [
    ({"cnn_model": "standard"}, "48 mels x seg_length 15"),
    ({**STD, "cnn_kernel_size": 5}, "kernel_size 3"),
    ({"cnn_model": "dff", "cnn_fc_out_h": None}, "cnn_fc_out_h"),
], ids=["standard_geometry", "standard_kernel", "dff_without_fc"])
def test_invalid_framewise_raises_like_jax(extra, match):
    margs = model_args_from_ckpt_args({**TINY_ARGS, **extra})
    with pytest.raises(ValueError, match=match):
        build_jax_model("NISQA", margs)
    with pytest.raises(ValueError, match=match):
        build_model("NISQA", margs)
