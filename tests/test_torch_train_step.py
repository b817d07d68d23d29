"""The port's train-mode model against the torch training goldens, in float64.

The goldens (``tools/make_train_goldens.py``) are one step of the reference
NISQA in float64 with every dropout at 0: the state dict before (``sd0::``),
the gradients (``g::``), the state dict after one ``torch.optim.Adam(lr=1e-3)``
step (``sd1::``, with the BN running statistics of the train-mode forward),
the batch and the loss. The port's models load ``sd0::`` with
``strict=True`` and must give the same loss (1e-9), gradients
(1e-9 * max(1, max|ref|)) and post-Adam state (1e-7 * max(1, max|ref|)) --
the bounds of ``tests/test_train_step_parity.py``. Also: the six BN layers'
running statistics after one train-mode forward (``g_train_bn.npz``), a
padded batch with ``row_valid`` against the unpadded one, and dropout.
"""

import json
import os

import numpy as np
import pytest
import torch

from nisqa_tpu_torch.compat.model_args import model_args_from_ckpt_args
from nisqa_tpu_torch.models.modules import dropout, dropout2d, masked_batch_norm
from nisqa_tpu_torch.models.nisqa import build_model
from nisqa_tpu_torch.train.loop import nan_mse
from tests.test_torch_train_epoch import one_torch_thread  # noqa: F401  (a fixture)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
DROPOUT_KEYS = ("cnn_dropout", "td_sa_dropout", "td_2_sa_dropout", "td_lstm_dropout",
                "pool_att_dropout")


def _golden_model(z, prefix):
    if "meta" in z.files:
        meta = json.loads(str(z["meta"]))
        name, margs = meta["model"], dict(meta["model_args"])
    else:  # the first AdaptCNN + SA golden predates the meta field
        name, margs = "NISQA", model_args_from_ckpt_args({"model": "NISQA"})
    for k in DROPOUT_KEYS:
        if k in margs:
            margs[k] = 0.0
    sd = {k[len(prefix):]: torch.from_numpy(z[k]) for k in z.files if k.startswith(prefix)}
    model = build_model(name, margs)
    model.load_state_dict(sd, strict=True)
    return model.double().train()


def _inputs(model, z):
    x = torch.from_numpy(z["x"]).double()
    n_wins = torch.from_numpy(np.asarray(z["n_wins"])).long()
    return (x if model.double_ended else x[:, :, 0]), n_wins


@pytest.mark.parametrize("golden", ["g_train_step.npz", "g_train_step_lstm.npz",
                                    "g_train_step_dim.npz", "g_train_step_de.npz"])
def test_train_step_matches_golden(golden):
    z = np.load(os.path.join(GOLDEN_DIR, golden))
    model = _golden_model(z, "sd0::")
    x, n_wins = _inputs(model, z)
    y = torch.from_numpy(z["y"]).double()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    y_hat = model(x, n_wins)
    loss = sum(nan_mse(y_hat[:, k], y[:, k]) for k in range(y.shape[1]))
    assert abs(loss.item() - float(z["loss"])) < 1e-9, (loss.item(), float(z["loss"]))
    loss.backward()

    params = {k: v for k, v in model.state_dict(keep_vars=True).items()
              if isinstance(v, torch.nn.Parameter)}
    ref_grads = {k[3:]: z[k] for k in z.files if k.startswith("g::")}
    assert params.keys() == ref_grads.keys()
    for k, ref in ref_grads.items():
        d = float(np.abs(params[k].grad.numpy() - ref).max())
        assert d < 1e-9 * max(1.0, float(np.abs(ref).max())), (k, "grad diff", d)

    opt.step()
    after = model.state_dict()
    for k in (k for k in z.files if k.startswith("sd1::")):
        ref, got = z[k], after[k[5:]].numpy()
        if "num_batches_tracked" in k:  # one forward per end: 1, or 2 for NISQA_DE's trunk
            assert got == ref, (k, got, ref)
            continue
        d = float(np.abs(got - ref).max())
        assert d < 1e-7 * max(1.0, float(np.abs(ref).max())), (k, "param diff", d)


def test_masked_bn_running_stats_match_packed_golden():
    """All six BN layers of the AdaptCNN after one train-mode forward: batch
    statistics over the valid segments only, as the reference's packed
    sequences give them (mean 1e-7, variance 1e-6 relative)."""
    z = np.load(os.path.join(GOLDEN_DIR, "g_train_bn.npz"))
    model = _golden_model(z, "sd::")
    x, n_wins = _inputs(model, z)
    with torch.no_grad():
        model.cnn(x, n_wins)
    after = model.state_dict()
    for i in range(1, 7):
        rm = z[f"post::cnn.model.bn{i}.running_mean"]
        rv = z[f"post::cnn.model.bn{i}.running_var"]
        dm = float(np.abs(after[f"cnn.model.bn{i}.running_mean"].numpy() - rm).max())
        dv = float(np.abs(after[f"cnn.model.bn{i}.running_var"].numpy() - rv).max())
        assert dm < 1e-7, (i, "running mean", dm)
        assert dv / max(1.0, float(np.abs(rv).max())) < 1e-6, (i, "running var rel", dv)
        assert int(after[f"cnn.model.bn{i}.num_batches_tracked"]) == 1


def _fresh(name="NISQA", **over):
    margs = model_args_from_ckpt_args({"model": name, **over})
    torch.manual_seed(7)
    return build_model(name, margs).double().train()


def _step(model, segs, n_wins, y, row_valid=None):
    model.zero_grad()
    y_hat = model(segs, n_wins, row_valid)
    loss = nan_mse(y_hat[:, 0], y[:, 0])
    loss.backward()
    return (loss.item(), {k: v.clone() for k, v in model.state_dict().items()},
            {k: p.grad.clone() for k, p in model.named_parameters()})


@pytest.mark.parametrize("name", ["NISQA", "NISQA_DE"])
def test_padded_batch_matches_unpadded(name):
    """Rows padded onto a batch (row 0 repeated, NaN targets) and kept out
    by ``row_valid`` change neither the loss, nor the BN running statistics,
    nor any gradient (the data-parallel padding of the JAX loop)."""
    over = {k: 0.0 for k in DROPOUT_KEYS}
    rng = np.random.default_rng(0)
    t = 20
    shape = (3, t, 2, 48, 15) if name == "NISQA_DE" else (3, t, 48, 15)
    segs = torch.from_numpy(rng.standard_normal(shape))
    n_wins = torch.tensor([[t, t - 2], [17, 15], [12, 13]] if name == "NISQA_DE" else [t, 17, 12])
    y = torch.from_numpy(rng.uniform(1, 5, (3, 1)))
    model = _fresh(name, **over)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    loss_u, bn_u, g_u = _step(model, segs, n_wins, y)

    model.load_state_dict(sd0)
    pad = 5
    segs_p = torch.cat([segs, segs[:1].expand(pad, *segs.shape[1:])])
    n_p = torch.cat([n_wins, n_wins[:1].expand(pad, *n_wins.shape[1:])])
    y_p = torch.cat([y, torch.full((pad, 1), float("nan"), dtype=y.dtype)])
    loss_p, bn_p, g_p = _step(model, segs_p, n_p, y_p, torch.arange(3 + pad) < 3)

    assert abs(loss_u - loss_p) < 1e-12
    for k in bn_u:
        assert float((bn_u[k].double() - bn_p[k].double()).abs().max()) < 1e-12, k
    for k in g_u:
        assert float((g_u[k] - g_p[k]).abs().max()) < 1e-12, k


def test_de_trunk_takes_the_serial_bn_update():
    """NISQA_DE in train mode runs the shared trunk twice, degraded end
    first: BN's running statistics equal the trunk run on the degraded end
    and then on the reference (two counted batches)."""
    model = _fresh("NISQA_DE", **{k: 0.0 for k in DROPOUT_KEYS})
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 12, 2, 48, 15)))
    n = torch.tensor([[12, 9], [7, 12]])
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model(x, n)
        both = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(sd0)
        model.cnn(x[:, :, 0], n[:, 0])
        model.cnn(x[:, :, 1], n[:, 1])
    serial = model.state_dict()
    for k in (k for k in both if "running_" in k or "num_batches" in k):
        assert torch.equal(both[k], serial[k]), k
    assert int(both["cnn.model.bn1.num_batches_tracked"]) == 2


def test_masked_bn_equals_bn_on_valid_rows():
    """masked_batch_norm over a mask equals train-mode nn.BatchNorm2d on the
    valid rows alone (output rows and running statistics)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((9, 4, 5, 3)))
    w = torch.tensor([1, 1, 0, 1, 0, 0, 1, 1, 1], dtype=torch.bool)
    a, b = torch.nn.BatchNorm2d(4).double(), torch.nn.BatchNorm2d(4).double()
    with torch.no_grad():
        a.weight.uniform_(0.5, 1.5)
        b.weight.copy_(a.weight)
    y = masked_batch_norm(x, a, w)
    ref = b.train()(x[w])
    assert float((y[w] - ref).detach().abs().max()) < 1e-12
    for k in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.allclose(getattr(a, k), getattr(b, k), rtol=0, atol=1e-12), k


def test_dropout_in_train_mode_only():
    """Dropout is active in train mode, scales kept values by 1/(1-p), draws
    the same masks from the same generator seed, and is off in eval."""
    x = torch.ones(4000, 8, dtype=torch.float64)
    g = torch.Generator().manual_seed(5)
    y = dropout(x, 0.25, True, g)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(float(kept.double().mean()) - 0.75) < 0.02
    assert torch.equal(y, dropout(x, 0.25, True, torch.Generator().manual_seed(5)))
    assert dropout(x, 0.25, False, g) is x and dropout(x, 0.0, True, g) is x
    maps = dropout2d(torch.ones(64, 16, 3, 2), 0.5, True, torch.Generator().manual_seed(1))
    assert bool(((maps == 0).all(dim=(2, 3)) | (maps == 2).all(dim=(2, 3))).all())

    model = _fresh("NISQA", td_sa_pos_enc=True)  # shipped dropout rates, SA with pos. enc.
    rng = np.random.default_rng(2)
    segs = torch.from_numpy(rng.standard_normal((3, 10, 48, 15)))
    n = torch.tensor([10, 7, 4])
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}

    def train_out(seed):
        model.load_state_dict(sd0)
        model.set_dropout_generator(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return model(segs, n)

    assert torch.equal(train_out(3), train_out(3))
    assert not torch.equal(train_out(3), train_out(4))
    model.load_state_dict(sd0)
    model.eval()
    with torch.no_grad():
        e1 = model(segs, n)
        model.set_dropout_generator(torch.Generator().manual_seed(9))
        assert torch.equal(e1, model(segs, n))
