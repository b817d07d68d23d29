"""PyTorch port models held against the torch goldens and the JAX package.

The released state dicts ship in the goldens as ``sd::*`` and load into the
port with ``strict=True`` (no key converter). Random narrow models made by
``NisqaNet.init`` carry over through ``state_dict_from_jax`` and must give
the JAX outputs at "highest" precision.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from nisqa_tpu.compat.model_args import model_args_from_ckpt_args
from nisqa_tpu.compat.torch_ckpt import params_to_torch
from nisqa_tpu.models.nisqa import build_model as build_jax_model
from nisqa_tpu_torch.compat.jax_params import state_dict_from_jax
from nisqa_tpu_torch.models.nisqa import build_model
from tests.test_e2e import TINY_ARGS

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"), allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    model = build_model(meta["model"], meta["model_args"])
    model.load_state_dict(sd, strict=True)
    return model.eval(), z


@pytest.mark.parametrize("name", ["g1_mos_only", "g2_dim"])
def test_released_weights_load_strict_and_match_golden(name):
    model, z = _golden(name)
    with torch.no_grad():
        y = model(torch.from_numpy(z["x"][:, :, 0]), torch.from_numpy(z["n_wins"])).numpy()
    assert y.shape == z["y"].shape
    assert np.abs(y - z["y"]).max() <= 2e-4


def test_cnn_tap_matches_golden_on_valid_frames():
    model, z = _golden("g2_dim")
    with torch.no_grad():
        feats = model.cnn(torch.from_numpy(z["x"][:, :, 0])).numpy()
    ref = z["tap::cnn_out"]
    for b, nw in enumerate(z["n_wins"]):
        assert np.abs(feats[b, :nw] - ref[b, :nw]).max() <= 1e-4


# narrow random models: channels 4/8/8, d_model 16, one layer, att_h 8
NARROW = {
    "dim_attff": ("NISQA_DIM", {}),
    "mos_attff": ("NISQA", {}),
    "mos_att_fc_td2": ("NISQA", {"pool_att_h": None, "cnn_fc_out_h": 12, "td_2": "self_att",
                                 "td_2_sa_d_model": 8, "td_2_sa_nhead": 2,
                                 "td_2_sa_num_layers": 1, "td_2_sa_h": 8}),
}


def _narrow(key, seed=3):
    name, extra = NARROW[key]
    margs = model_args_from_ckpt_args({**TINY_ARGS, "model": name, **extra})
    jmodel = build_jax_model(name, margs)
    params, state = jmodel.init(jax.random.PRNGKey(seed))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return name, margs, jmodel, to_np(params), to_np(state)


@pytest.mark.parametrize("key", list(NARROW))
def test_narrow_random_model_matches_jax(key):
    name, margs, jmodel, params, state = _narrow(key)
    model = build_model(name, margs)
    model.load_state_dict(state_dict_from_jax(params, state, name, margs), strict=True)
    model.eval()

    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 9, 24, 7)) * 10 - 40).astype(np.float32)
    n_wins = np.array([9, 4, 1], np.int32)
    with jax.default_matmul_precision("highest"):
        y_ref, _ = jax.jit(jmodel.apply)(params, state, x, n_wins)
    with torch.no_grad():
        y = model(torch.from_numpy(x), torch.from_numpy(n_wins).long()).numpy()
    assert y.shape == (3, 5 if name == "NISQA_DIM" else 1)
    assert np.abs(y - np.asarray(y_ref)).max() <= 1e-5


@pytest.mark.parametrize("key", list(NARROW))
def test_state_dict_from_jax_equals_params_to_torch(key):
    name, margs, jmodel, params, state = _narrow(key)
    ours = state_dict_from_jax(params, state, name, margs)
    theirs = params_to_torch(jmodel, params, state)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("model_name,extra", [
    ("NISQA_DE", {"de_align": "bahd", "de_align_apply": "soft", "de_fuse": "+/-",
                  "de_fuse_dim": 12}),
    ("NISQA", {"td": "lstm", "td_lstm_h": 8, "td_lstm_num_layers": 1,
               "td_lstm_bidirectional": False}),
    ("NISQA", {"cnn_model": "standard", "ms_n_mels": 48, "ms_seg_length": 15,
               "cnn_kernel_size": 3}),
    ("NISQA", {"pool": "avg"}),
    ("NISQA", {"td_sa_pos_enc": True}),
], ids=["de", "lstm", "standard_cnn", "avg_pool", "pos_enc"])
def test_unported_families_raise(model_name, extra):
    """The families that once raised here build, with the state-dict keys
    of the JAX package's converter (their numerics: tests/test_torch_zoo.py
    and, for NISQA_DE, tests/test_torch_de.py)."""
    margs = model_args_from_ckpt_args({**TINY_ARGS, "model": model_name, **extra})
    jmodel = build_jax_model(model_name, margs)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    assert sorted(build_model(model_name, margs).state_dict()) == \
        sorted(params_to_torch(jmodel, params, state))
