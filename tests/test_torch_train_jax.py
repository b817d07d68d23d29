"""One train-mode forward, loss and gradient of the port against
``nisqa_tpu``'s ``model.apply(train=True)`` under ``jax.value_and_grad``, in
float32 on the CPU.

Small models (the test corpus widths: AdaptCNN 4/8/8 channels, self-attention
d_model 16 with one layer; NISQA_DE with cosine / hard alignment, x/y/-
fusion and an SA td_2) take the same numpy weights on both sides
(``state_dict_from_jax``) and the same batch of segments, every dropout at 0
(JAX's ``rng=None``). Bounds: the loss within 1e-5 relative and every
gradient within 1e-4 * max(1, max|jax|); measured on this CPU when the test
was written: the loss within 4.9e-7 relative, the gradients within 7.2e-6
(NISQA_DIM's ``bn1.bias``). The batch statistics the forward leaves in the
BN running statistics are compared too (1e-5 * max(1, max|jax|)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nisqa_tpu.compat.model_args import model_args_from_ckpt_args
from nisqa_tpu.compat.torch_ckpt import params_to_torch
from nisqa_tpu.models.nisqa import build_model as build_jax_model
from nisqa_tpu.train.loop import nan_mse as jax_nan_mse
from nisqa_tpu_torch.compat.jax_params import state_dict_from_jax
from nisqa_tpu_torch.models.nisqa import build_model
from nisqa_tpu_torch.train.loop import train_loss
from tests.test_e2e import TINY_ARGS
from tests.test_torch_train_epoch import one_torch_thread  # noqa: F401  (a fixture)

NO_DROPOUT = {"cnn_dropout": 0.0, "td_sa_dropout": 0.0, "td_2_sa_dropout": 0.0,
              "pool_att_dropout": 0.0}
DE_ARGS = {"td_2": "self_att", "td_2_sa_d_model": 16, "td_2_sa_nhead": 1, "td_2_sa_pos_enc": False,
           "td_2_sa_num_layers": 1, "td_2_sa_h": 16, "de_align": "cosine",
           "de_align_apply": "hard", "de_fuse": "x/y/-", "de_fuse_dim": None}


@pytest.mark.parametrize("name,k", [("NISQA", 1), ("NISQA_DIM", 5), ("NISQA_DE", 1)])
def test_train_step_matches_jax_value_and_grad(name, k):
    args = {**TINY_ARGS, **NO_DROPOUT, "model": name, **(DE_ARGS if name == "NISQA_DE" else {})}
    margs = model_args_from_ckpt_args(args)
    jmodel = build_jax_model(name, margs)
    params, state = jmodel.init(jax.random.PRNGKey(5))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = build_model(name, margs)
    model.load_state_dict(state_dict_from_jax(to_np(params), to_np(state), name, margs), strict=True)
    model.train()

    rng = np.random.default_rng(11)
    b, t = 4, 18
    ends = 2 if name == "NISQA_DE" else 1
    x = rng.uniform(-80.0, 0.0, (b, t, ends, 24, 7)).astype(np.float32)
    n_wins = np.stack([rng.permutation([t, 13, 9, 5]) for _ in range(ends)], axis=1)
    for i in range(b):
        for e in range(ends):
            x[i, n_wins[i, e]:, e] = 0.0
    if ends == 1:
        x, n_wins = x[:, :, 0], n_wins[:, 0]
    y = rng.uniform(1.0, 5.0, (b, k)).astype(np.float32)
    y[1, 0] = np.nan  # a missing label stays out of the loss
    bias_b = np.zeros((b, k, 4), np.float32)
    bias_b[..., 0], bias_b[..., 1] = 0.1, 0.9  # a non-identity bias mapping

    def loss_fn(p):
        y_hat, new_bn = jmodel.apply(p, state, jnp.asarray(x), jnp.asarray(n_wins), train=True,
                                     rng=None)
        mapped = sum(bias_b[..., j] * y_hat ** j for j in range(4))
        return sum(jax_nan_mse(mapped[:, j], y[:, j]) for j in range(k)), new_bn

    (loss_j, new_bn), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ref = params_to_torch(jmodel, grads, new_bn)

    y_hat = model(torch.from_numpy(x), torch.from_numpy(n_wins).long())
    loss = train_loss(y_hat, torch.from_numpy(y), torch.from_numpy(bias_b))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j)), (loss.item(), loss_j)

    after = model.state_dict(keep_vars=True)
    n_grads = 0
    for key, v in after.items():
        if isinstance(v, torch.nn.Parameter):
            want = np.asarray(ref[key])
            d = float(np.abs(v.grad.numpy() - want).max())
            assert d <= 1e-4 * max(1.0, float(np.abs(want).max())), (key, d)
            n_grads += 1
        elif "running_" in key:  # the train-mode forward's BN update
            want = np.asarray(ref[key])
            d = float(np.abs(v.numpy() - want).max())
            assert d <= 1e-5 * max(1.0, float(np.abs(want).max())), (key, d)
    assert n_grads == sum(1 for _ in model.parameters())
