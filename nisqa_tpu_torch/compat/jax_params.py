"""JAX ``NisqaNet`` params / state pytrees -> the port's state dict.

Counterpart of ``nisqa_tpu/compat/torch_ckpt.py::params_to_torch`` for the
families the port has (AdaptCNN, self-attention / skip time dependency,
attention pooling). Takes the pytrees as numpy arrays, so it needs no JAX
object, and raises on any family it does not map. Layouts:

  * linear ``{"w": (in, out), "b"}``   -> ``weight`` (out, in), ``bias``;
  * conv HWIO                          -> OIHW;
  * BN ``scale/bias`` + ``mean/var``   -> ``weight/bias/running_mean/
    running_var`` plus ``num_batches_tracked`` = 0;
  * MHA fused ``w_in`` (D, 3D)         -> ``in_proj_weight`` (3D, D).
"""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_jax(params, state, model_name: str, model_args: dict) -> dict:
    """Returns {name: tensor} that ``load_state_dict(strict=True)`` accepts."""
    if model_name not in ("NISQA", "NISQA_DIM"):
        raise NotImplementedError(f"state_dict_from_jax: model {model_name!r} is not ported")
    cfg = model_args
    sd = {}

    def put(name, a):
        sd[name] = torch.from_numpy(np.array(a, order="C"))

    def lin(prefix, p):
        put(f"{prefix}.weight", np.asarray(p["w"]).T)
        put(f"{prefix}.bias", p["b"])

    def norm(prefix, p):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])

    cnn_kind = cfg.get("cnn_model") or "skip"
    if cnn_kind != "adapt":
        raise NotImplementedError(f"state_dict_from_jax: framewise {cnn_kind!r} is not ported")
    cp, cs = params["cnn"], state["cnn"]
    for i in range(1, 7):
        put(f"cnn.model.conv{i}.weight", np.asarray(cp[f"conv{i}"]["w"]).transpose(3, 2, 0, 1))
        put(f"cnn.model.conv{i}.bias", cp[f"conv{i}"]["b"])
        norm(f"cnn.model.bn{i}", cp[f"bn{i}"])
        put(f"cnn.model.bn{i}.running_mean", cs[f"bn{i}"]["mean"])
        put(f"cnn.model.bn{i}.running_var", cs[f"bn{i}"]["var"])
        put(f"cnn.model.bn{i}.num_batches_tracked", np.asarray(0, dtype=np.int64))
    if "fc" in cp:
        lin("cnn.model.fc", cp["fc"])

    for prefix, key, tp in (("time_dependency", "td", params["td"]),
                            ("time_dependency_2", "td_2", params["td2"])):
        kind = cfg.get(key) or "skip"
        if kind == "skip":
            continue
        if kind != "self_att" or "pe" in tp:
            raise NotImplementedError(f"state_dict_from_jax: {key} {kind!r} (pos_enc) is not ported")
        lin(f"{prefix}.model.linear", tp["linear"])
        norm(f"{prefix}.model.norm1", tp["norm1"])
        for i, layer in enumerate(tp["layers"]):
            lp = f"{prefix}.model.layers.{i}"
            put(f"{lp}.self_attn.in_proj_weight", np.asarray(layer["attn"]["w_in"]).T)
            put(f"{lp}.self_attn.in_proj_bias", layer["attn"]["b_in"])
            put(f"{lp}.self_attn.out_proj.weight", np.asarray(layer["attn"]["w_out"]).T)
            put(f"{lp}.self_attn.out_proj.bias", layer["attn"]["b_out"])
            lin(f"{lp}.linear1", layer["linear1"])
            lin(f"{lp}.linear2", layer["linear2"])
            norm(f"{lp}.norm1", layer["norm1"])
            norm(f"{lp}.norm2", layer["norm2"])

    if cfg.get("pool", "att") != "att":
        raise NotImplementedError(f"state_dict_from_jax: pool {cfg.get('pool')!r} is not ported")
    if model_name == "NISQA_DIM":
        heads = [(f"pool_layers.{i}.model", pp) for i, pp in enumerate(params["pools"])]
    else:
        heads = [("pool.model", params["pool"])]
    for prefix, pp in heads:
        for name in ("linear1", "linear2", "linear3"):
            if name in pp:
                lin(f"{prefix}.{name}", pp[name])
    return sd
