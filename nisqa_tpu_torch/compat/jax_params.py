"""JAX ``NisqaNet`` params / state pytrees -> the port's state dict.

Counterpart of ``nisqa_tpu/compat/torch_ckpt.py::params_to_torch`` for every
model family (every framewise, time-dependency, pooling, alignment and
fusion option), in the same key order. Takes the pytrees as numpy arrays,
so it needs no JAX object. Layouts:

  * linear ``{"w": (in, out), "b"}``   -> ``weight`` (out, in), ``bias``;
  * conv HWIO                          -> OIHW;
  * BN ``scale/bias`` + ``mean/var``   -> ``weight/bias/running_mean/
    running_var`` plus ``num_batches_tracked`` = 0 (DFF's ``bn1`` and
    Skip's ``bn`` are over one channel);
  * MHA fused ``w_in`` (D, 3D)         -> ``in_proj_weight`` (3D, D);
  * positional encoding ``pe`` (L, D)  -> ``pos_encoder.pe`` (L, 1, D);
  * LSTM ``w_ih`` (d_in, 4H) / ``w_hh`` (H, 4H) -> ``weight_ih_l{k}`` /
    ``weight_hh_l{k}`` (4H, ·), ``b_ih`` and ``b_hh`` kept apart, the
    backward direction with the suffix ``_reverse``; gate order (i, f, g, o)
    as it is;
  * the framewise fc: AdaptCNN ``fc``, StandardCNN ``fc_out``, Skip
    ``linear``;
  * NISQA_DE: ``align`` ``wq`` / ``wy`` / ``v`` -> ``align.att.Wq`` /
    ``Wy`` / ``v``, ``align`` ``w`` -> ``align.att.W``, ``fuse`` ``lin`` ->
    ``fuse.lin_fusion``, after the pooling head as in ``params_to_torch``.
"""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_jax(params, state, model_name: str, model_args: dict) -> dict:
    """Returns {name: tensor} that ``load_state_dict(strict=True)`` accepts."""
    if model_name not in ("NISQA", "NISQA_DIM", "NISQA_DE"):
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

    def bn(prefix, p, s):
        norm(prefix, p)
        put(f"{prefix}.running_mean", s["mean"])
        put(f"{prefix}.running_var", s["var"])
        put(f"{prefix}.num_batches_tracked", np.asarray(0, dtype=np.int64))

    cnn_kind = cfg.get("cnn_model") or "skip"
    cp, cs = params["cnn"], state["cnn"]
    if cnn_kind in ("adapt", "standard"):
        for i in range(1, 7):
            put(f"cnn.model.conv{i}.weight", np.asarray(cp[f"conv{i}"]["w"]).transpose(3, 2, 0, 1))
            put(f"cnn.model.conv{i}.bias", cp[f"conv{i}"]["b"])
            bn(f"cnn.model.bn{i}", cp[f"bn{i}"], cs[f"bn{i}"])
        if "fc" in cp:
            lin(f"cnn.model.{'fc' if cnn_kind == 'adapt' else 'fc_out'}", cp["fc"])
    elif cnn_kind == "dff":
        for i in range(1, 5):
            lin(f"cnn.model.lin{i}", cp[f"lin{i}"])
        for i in range(1, 6):
            bn(f"cnn.model.bn{i}", cp[f"bn{i}"], cs[f"bn{i}"])
    else:
        bn("cnn.model.bn", cp["bn"], cs["bn"])
        if "fc" in cp:
            lin("cnn.model.linear", cp["fc"])

    for prefix, key, tp in (("time_dependency", "td", params["td"]),
                            ("time_dependency_2", "td_2", params["td2"])):
        kind = cfg.get(key) or "skip"
        if kind == "self_att":
            lin(f"{prefix}.model.linear", tp["linear"])
            norm(f"{prefix}.model.norm1", tp["norm1"])
            if "pe" in tp:
                put(f"{prefix}.model.pos_encoder.pe", np.asarray(tp["pe"])[:, None, :])
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
        elif kind == "lstm":
            for k, layer in enumerate(tp["layers"]):
                for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
                    if direction not in layer:
                        continue
                    d, lp = layer[direction], f"{prefix}.model.lstm"
                    put(f"{lp}.weight_ih_l{k}{sfx}", np.asarray(d["w_ih"]).T)
                    put(f"{lp}.weight_hh_l{k}{sfx}", np.asarray(d["w_hh"]).T)
                    put(f"{lp}.bias_ih_l{k}{sfx}", d["b_ih"])
                    put(f"{lp}.bias_hh_l{k}{sfx}", d["b_hh"])

    if model_name == "NISQA_DIM":
        heads = [(f"pool_layers.{i}.model", pp) for i, pp in enumerate(params["pools"])]
    else:
        heads = [("pool.model", params["pool"])]
    for prefix, pp in heads:
        for name in ("linear1", "linear2", "linear3", "linear"):
            if name in pp:
                lin(f"{prefix}.{name}", pp[name])

    if model_name == "NISQA_DE":
        ap = params["align"]
        for key, name in (("wq", "Wq"), ("wy", "Wy"), ("v", "v"), ("w", "W")):
            if key in ap:
                lin(f"align.att.{name}", ap[key])
        if "lin" in params["fuse"]:
            lin("fuse.lin_fusion", params["fuse"]["lin"])
    return sd
