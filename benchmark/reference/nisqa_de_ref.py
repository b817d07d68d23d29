"""Plain PyTorch reference of the double-ended (full-reference) NISQA_DE.

Written from the published NISQA_DE (``NISQA_lib.py``'s ``NISQA_DE``,
``Alignment``, ``AlignCosine``, ``ApplyHardAttention`` and ``Fusion``;
``config/train_nisqa_double_ended.yaml``) on top of :mod:`nisqa_ref`'s
front end, segmentation, AdaptCNN, self-attention and PoolAttFF. It imports
no module of the port and no JAX, and takes only what the benchmark made
(PCM16 samples and weights). Per pair:

  * each end through the shared trunk (AdaptCNN, then the first 2 x SA) on
    its own segments;
  * cosine similarity of every degraded segment to every reference segment,
    each norm clamped at 1e-8 on its own;
  * hard alignment: the first argmax over the reference's segments, and the
    reference's features gathered there;
  * fusion ``x/y/-``: [x, y, x - y], 3 d features;
  * the second 2 x SA (``td_2``) over the degraded end's segments, and one
    PoolAttFF head.

Departures from the published code, none of which changes an answer of a
sound pair:

  * each end runs on its own segments with no padding and no bucket, so the
    published masks (the reference's padded segments set to -inf before the
    argmax, the padded keys of each attention) have nothing to mask;
  * the published cosine scorer calls ``F.cosine_similarity``, whose
    handling of small norms has changed between torch versions; this one
    clamps each norm at 1e-8 on its own (ATen's rule, which the program
    follows), which matters only for a norm under 1e-8;
  * TF32 is off inside the reference in cuBLAS and cuDNN (float32 products,
    a dtype below float32 for the control);
  * ``skip_align`` (off for the reference) is a planted fault, not a mode of
    the published code: the reference end's features are fused unaligned,
    row t with the reference's row t (its last row past its end).
"""

from __future__ import annotations

import contextlib

import torch

from . import nisqa_ref as ref


def _sa_spec(prefix: str, fan_in: int, d: int, h: int, layers: int):
    spec = [(f"{prefix}.norm1.weight", (d,), ("ln_weight",)), (f"{prefix}.norm1.bias", (d,), ("ln_bias",)),
            (f"{prefix}.linear.weight", (d, fan_in), ("fan", fan_in)),
            (f"{prefix}.linear.bias", (d,), ("fan", fan_in))]
    for layer in range(layers):
        p = f"{prefix}.layers.{layer}"
        spec += [(f"{p}.self_attn.in_proj_weight", (3 * d, d), ("xavier", 4 * d)),
                 (f"{p}.self_attn.in_proj_bias", (3 * d,), ("in_bias",)),
                 (f"{p}.self_attn.out_proj.weight", (d, d), ("fan", d)),
                 (f"{p}.self_attn.out_proj.bias", (d,), ("fan", d)),
                 (f"{p}.linear1.weight", (h, d), ("fan", d)), (f"{p}.linear1.bias", (h,), ("fan", d)),
                 (f"{p}.linear2.weight", (d, h), ("fan", h)), (f"{p}.linear2.bias", (d,), ("fan", h)),
                 (f"{p}.norm1.weight", (d,), ("ln_weight",)), (f"{p}.norm1.bias", (d,), ("ln_bias",)),
                 (f"{p}.norm2.weight", (d,), ("ln_weight",)), (f"{p}.norm2.bias", (d,), ("ln_bias",))]
    return spec


def fused_dim(cfg: dict) -> int:
    """Width of the fused features ``x/y/-``: three times td's d."""
    if cfg["de_fuse"] != "x/y/-" or cfg.get("de_fuse_dim"):
        raise NotImplementedError(f"fusion {cfg['de_fuse']!r} with fuse_dim {cfg.get('de_fuse_dim')!r}")
    return 3 * cfg["td_sa_d_model"]


def param_spec(cfg: dict):
    """[(state-dict name, shape, kind)] of NISQA_DE: the NISQA spec (AdaptCNN,
    td, one PoolAttFF head on td_2's width) with td_2 on the fused features
    before the head (cosine alignment and ``x/y/-`` fusion without
    ``fuse_dim`` have no parameters)."""
    if cfg["de_align"] != "cosine" or cfg["de_align_apply"] != "hard":
        raise NotImplementedError(f"alignment {cfg['de_align']!r} / {cfg['de_align_apply']!r}")
    d2 = cfg["td_2_sa_d_model"]
    trunk_spec = [e for e in ref.param_spec(cfg, 1) if not e[0].startswith("pool.")]
    # the head reads td_2's width
    head = [e for e in ref.param_spec({**cfg, "td_sa_d_model": d2}, 1) if e[0].startswith("pool.")]
    td2 = _sa_spec("time_dependency_2.model", fused_dim(cfg), d2, cfg["td_2_sa_h"],
                   cfg["td_2_sa_num_layers"])
    return trunk_spec + td2 + head


def td_2(p, cfg, x):
    """The second self-attention stage over one pair's fused features (n, 3 d)."""
    pre = "time_dependency_2.model."
    p2 = {"time_dependency.model." + k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}
    cfg2 = {**cfg, "td_sa_d_model": cfg["td_2_sa_d_model"],
            "td_sa_num_layers": cfg["td_2_sa_num_layers"]}
    return ref.self_attention(p2, cfg2, x)


def cosine_scores(q, y):
    """(n_q, n_y) cosine similarity, each norm clamped at 1e-8 on its own."""
    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-8)
    yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp(min=1e-8)
    return qn @ yn.T


def align_hard(q, y, skip_align: bool = False):
    """The reference end's features ``y`` aligned to the degraded end's ``q``."""
    if skip_align:
        return y[torch.clamp(torch.arange(len(q), device=y.device), max=len(y) - 1)]
    return y[cosine_scores(q, y).argmax(dim=1)]


def trunk(p, cfg, segs, block_rows: int = 8192):
    """Framewise + td features of one end, (n, d), over its own segments."""
    feats = torch.cat([ref.adapt_cnn(p, cfg, segs[i:i + block_rows, None])
                       for i in range(0, len(segs), block_rows)])
    return ref.self_attention(p, cfg, feats)


def predict_pair(p, cfg, segs_deg, segs_ref, skip_align: bool = False):
    """(1,) score of one pair from each end's (n, M, S) segments."""
    x = trunk(p, cfg, segs_deg)
    y = align_hard(x, trunk(p, cfg, segs_ref), skip_align)
    return ref.pool_att_ff(p, "pool.model", td_2(p, cfg, torch.cat([x, y, x - y], dim=1)))


@contextlib.contextmanager
def no_tf32():
    """TF32 off in cuBLAS and cuDNN, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def predict(p, cfg, pairs, skip_align: bool = False):
    """(len(pairs), 1) scores of ``pairs``, [(degraded segments, reference
    segments)], with TF32 off."""
    with no_tf32(), torch.no_grad():
        return torch.stack([predict_pair(p, cfg, d, r, skip_align) for d, r in pairs])
