"""Plain PyTorch reference of what the benchmark's cells compute.

Written from the published description of NISQA (Mittag et al., 2021, and
the upstream ``NISQA_lib.py``) and librosa's mel spectrogram, and nothing
else: it imports no module of the port and no JAX, builds its own
filterbank, window and DFT, and takes only what the benchmark made (PCM16
samples, weights, targets). It runs on any device in any floating dtype, so
the same code is the float32 reference and, in a lower precision, the
control.

  * front end: librosa ``melspectrogram(center=True, pad_mode="reflect",
    window="hann", power=1, htk=False, norm="slaney")`` of the samples
    scaled by 1/32768, then ``amplitude_to_db(ref=1, amin=1e-4,
    top_db=80)``: the per-file floor 80 dB under the file's loudest bin;
  * segmentation: ``segment_specs``: windows of ``seg_length`` frames, every
    ``seg_hop``-th of the full windows;
  * model: AdaptCNN (six conv + batch norm + ReLU blocks, adaptive max
    pools, channel dropout before blocks 3-6), the post-norm Transformer
    encoder (input projection + LayerNorm, layers of one-head attention
    and a ReLU feed-forward, dropout on the attention weights, the
    attention output, the feed-forward hidden layer and its output), and
    PoolAttFF heads (one for NISQA, five for NISQA_DIM);
  * training: the batch's mean squared error, batch-norm statistics over
    the batch's segments, the gradient by autograd, and one Adam step
    written out (torch's defaults: betas 0.9 / 0.999, eps 1e-8).

Each file runs on its own segments (no padding, no bucket). Dropout masks
are given from outside (``masks``), in the order the forward draws them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

DIM_HEADS = 5  # NISQA_DIM's heads: mos, noi, dis, col, loud


# ---------------------------------------------------------------------------
# front end
# ---------------------------------------------------------------------------


def hz_to_mel(f):
    """Slaney's mel scale: linear to 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_part = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log_part, mel)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    lin = m * (200.0 / 3.0)
    log_part = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log_part, lin)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmax: float) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) float64 triangles between mel-spaced edges
    from 0 Hz to ``fmax``, each scaled to unit area (slaney)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    edges = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, mid, hi = edges[i], edges[i + 1], edges[i + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[i] = np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))
    return fb


def hann(win: int) -> np.ndarray:
    """The periodic Hann window (scipy's ``get_window("hann", win)``)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)


class FrontEnd:
    """Mel dB of one sample rate, in ``dtype`` on ``device``.

    The DFT is a product with cos / sin tables over the analysis window's
    samples and the bins the filterbank reads (the other bins carry zero
    weight); tables are built in float64 and cast once."""

    def __init__(self, geo: dict, sr: int, device, dtype=torch.float32):
        self.n_fft = int(geo["ms_n_fft"])
        self.hop = int(sr * float(geo["ms_hop_length"]))
        self.win = int(sr * float(geo["ms_win_length"]))
        self.lpad = (self.n_fft - self.win) // 2
        self.dtype, self.device = dtype, device
        fb = mel_filterbank(sr, self.n_fft, int(geo["ms_n_mels"]), float(geo["ms_fmax"]))
        bins = np.nonzero(fb.any(axis=0))[0]
        n = self.lpad + np.arange(self.win)
        ang = 2.0 * np.pi * np.outer(n, bins) / self.n_fft
        w = hann(self.win)[:, None]
        self.cos = torch.tensor(w * np.cos(ang), dtype=dtype, device=device)
        self.sin = torch.tensor(w * np.sin(ang), dtype=dtype, device=device)
        self.fb = torch.tensor(fb[:, bins].T, dtype=dtype, device=device)

    def frames(self, n_samples: int) -> int:
        return 1 + n_samples // self.hop

    def db(self, pcm16) -> torch.Tensor:
        """int16 samples (n,) -> mel dB (frames, n_mels), in ``dtype``."""
        x = torch.as_tensor(pcm16).to(self.device, torch.float64) / 32768.0
        pad = self.n_fft // 2
        x = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0].to(self.dtype)
        fr = x[self.lpad:].unfold(0, self.win, self.hop)[: self.frames(len(pcm16))]
        mag = torch.sqrt((fr @ self.cos) ** 2 + (fr @ self.sin) ** 2)
        db = 20.0 * torch.log10(torch.clamp(mag @ self.fb, min=1e-4))
        return torch.maximum(db, db.max() - 80.0)


def n_wins(n_frames: int, seg_length: int, seg_hop: int) -> int:
    full = n_frames - (seg_length - 1)
    if full < 1:
        raise ValueError(f"{n_frames} frames: too short for one segment of {seg_length}")
    return -(-full // seg_hop)


def segments(db, seg_length: int, seg_hop: int):
    """mel dB (frames, M) -> (n_wins, M, seg_length): every seg_hop-th full window."""
    full = db.T.unfold(1, seg_length, 1)  # (M, full, S)
    return full[:, ::seg_hop].permute(1, 0, 2)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_spec(cfg: dict, heads: int):
    """[(state-dict name, shape, kind)] of NISQA (``heads`` 1) or NISQA_DIM
    (``heads`` 5) with AdaptCNN, self-attention and PoolAttFF, in the
    upstream module order. ``kind``: conv / linear weight or bias (with its
    fan-in), batch-norm weight / bias / running mean / running var / count,
    LayerNorm weight / bias, attention in-projection weight / bias."""
    k = tuple(cfg["cnn_kernel_size"])
    c1, c2, c3 = cfg["cnn_c_out_1"], cfg["cnn_c_out_2"], cfg["cnn_c_out_3"]
    p3 = cfg["cnn_pool_3"]
    d, h, att_h = cfg["td_sa_d_model"], cfg["td_sa_h"], cfg["pool_att_h"]
    spec = []
    chans = [(1, c1, k), (c1, c2, k), (c2, c3, k), (c3, c3, k), (c3, c3, k), (c3, c3, (k[0], p3[1]))]
    for i, (ci, co, kk) in enumerate(chans, start=1):
        fan = ci * kk[0] * kk[1]
        spec += [(f"cnn.model.conv{i}.weight", (co, ci, *kk), ("fan", fan)),
                 (f"cnn.model.conv{i}.bias", (co,), ("fan", fan))]
        spec += [(f"cnn.model.bn{i}.{n}", (co,), (n,)) for n in
                 ("weight", "bias", "running_mean", "running_var")]
        spec.append((f"cnn.model.bn{i}.num_batches_tracked", (), ("count",)))
    fan_cnn = c3 * p3[0]
    td = "time_dependency.model"
    spec += [(f"{td}.norm1.weight", (d,), ("ln_weight",)), (f"{td}.norm1.bias", (d,), ("ln_bias",)),
             (f"{td}.linear.weight", (d, fan_cnn), ("fan", fan_cnn)),
             (f"{td}.linear.bias", (d,), ("fan", fan_cnn))]
    for layer in range(cfg["td_sa_num_layers"]):
        p = f"{td}.layers.{layer}"
        spec += [(f"{p}.self_attn.in_proj_weight", (3 * d, d), ("xavier", 4 * d)),
                 (f"{p}.self_attn.in_proj_bias", (3 * d,), ("in_bias",)),
                 (f"{p}.self_attn.out_proj.weight", (d, d), ("fan", d)),
                 (f"{p}.self_attn.out_proj.bias", (d,), ("fan", d)),
                 (f"{p}.linear1.weight", (h, d), ("fan", d)), (f"{p}.linear1.bias", (h,), ("fan", d)),
                 (f"{p}.linear2.weight", (d, h), ("fan", h)), (f"{p}.linear2.bias", (d,), ("fan", h)),
                 (f"{p}.norm1.weight", (d,), ("ln_weight",)), (f"{p}.norm1.bias", (d,), ("ln_bias",)),
                 (f"{p}.norm2.weight", (d,), ("ln_weight",)), (f"{p}.norm2.bias", (d,), ("ln_bias",))]
    prefixes = ["pool.model"] if heads == 1 else [f"pool_layers.{i}.model" for i in range(heads)]
    for p in prefixes:
        spec += [(f"{p}.linear1.weight", (att_h, d), ("fan", d)),
                 (f"{p}.linear1.bias", (att_h,), ("fan", d)),
                 (f"{p}.linear2.weight", (1, att_h), ("fan", att_h)),
                 (f"{p}.linear2.bias", (1,), ("fan", att_h)),
                 (f"{p}.linear3.weight", (1, d), ("fan", d)), (f"{p}.linear3.bias", (1,), ("fan", d))]
    return spec


def leaves(spec):
    """The trainable names of ``spec`` (everything but batch-norm buffers)."""
    return [n for n, _, kind in spec if kind[0] not in ("running_mean", "running_var", "count")]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class Masks:
    """Dropout keep-masks (0 / 1) in the order the forward draws them, each
    with its keep probability; None: no dropout (eval)."""

    def __init__(self, masks=None, keep_cnn=1.0, keep_sa=1.0):
        self.masks, self.i = list(masks or []), 0
        self.keep = {"cnn": keep_cnn, "sa": keep_sa}

    def take(self, site: str, like):
        if self.keep[site] >= 1.0:
            return None
        if self.i >= len(self.masks):
            raise ValueError(f"dropout mask {self.i + 1} missing: {len(self.masks)} were given")
        m = self.masks[self.i]
        self.i += 1
        return m.to(like.dtype) / self.keep[site]


def _bn(x, p, name, batch_stats: bool):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if batch_stats:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    shape = (1, -1, 1, 1)
    return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-5) * w.view(shape) + b.view(shape)


def adapt_cnn(p, cfg, x, train=False, drop=None):
    """x (N, 1, M, S) -> (N, c3 * pool_3[0]). ``drop(name, x)`` gives the
    channel mask before blocks 3-6 in train mode (rows of N)."""
    pools = [tuple(cfg[f"cnn_pool_{i}"]) for i in (1, 2, 3)]

    def block(i, h):
        w = p[f"cnn.model.conv{i}.weight"]
        pad = (1, 0) if i == 6 else (1, 1 if w.shape[-1] > 1 else 0)
        h = F.conv2d(h, w, p[f"cnn.model.conv{i}.bias"], padding=pad)
        return F.relu(_bn(h, p, f"cnn.model.bn{i}", train))

    def dropped(h):
        return h if drop is None else h * drop(h)

    h = F.adaptive_max_pool2d(block(1, x), pools[0])
    h = F.adaptive_max_pool2d(block(2, h), pools[1])
    h = block(4, dropped(block(3, dropped(h))))
    h = F.adaptive_max_pool2d(h, pools[2])
    return block(6, dropped(block(5, dropped(h)))).flatten(1)


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def self_attention(p, cfg, x, take=None):
    """One file's features (n, fan_cnn) -> (n, d). ``take(like)`` returns
    the next dropout mask for a tensor shaped as ``like`` (train mode)."""
    td = "time_dependency.model"
    d = cfg["td_sa_d_model"]

    def drop(h):
        return h if take is None else h * take(h)

    h = _ln(F.linear(x, p[f"{td}.linear.weight"], p[f"{td}.linear.bias"]), p, f"{td}.norm1")
    for layer in range(cfg["td_sa_num_layers"]):
        lp = f"{td}.layers.{layer}"
        q, k, v = F.linear(h, p[f"{lp}.self_attn.in_proj_weight"],
                           p[f"{lp}.self_attn.in_proj_bias"]).chunk(3, dim=-1)
        att = drop(torch.softmax((q @ k.T) / math.sqrt(d), dim=-1))
        a = F.linear(att @ v, p[f"{lp}.self_attn.out_proj.weight"], p[f"{lp}.self_attn.out_proj.bias"])
        h = _ln(h + drop(a), p, f"{lp}.norm1")
        f = drop(F.relu(F.linear(h, p[f"{lp}.linear1.weight"], p[f"{lp}.linear1.bias"])))
        f = F.linear(f, p[f"{lp}.linear2.weight"], p[f"{lp}.linear2.bias"])
        h = _ln(h + drop(f), p, f"{lp}.norm2")
    return h


def pool_att_ff(p, prefix, h):
    """(n, d) -> (1,): attention weights from a ReLU hidden layer, softmax
    over the file's segments, then the output layer."""
    hid = F.relu(F.linear(h, p[f"{prefix}.linear1.weight"], p[f"{prefix}.linear1.bias"]))
    score = F.linear(hid, p[f"{prefix}.linear2.weight"], p[f"{prefix}.linear2.bias"])[:, 0]
    pooled = torch.softmax(score, dim=0) @ h
    return F.linear(pooled, p[f"{prefix}.linear3.weight"], p[f"{prefix}.linear3.bias"])


def heads_of(p):
    return ["pool.model"] if "pool.model.linear1.weight" in p else \
        [f"pool_layers.{i}.model" for i in range(DIM_HEADS)]


def predict(p, cfg, segs, block_rows: int = 8192):
    """Eval forward over files: ``segs`` a list of (n_i, M, S) -> (files,
    heads). The CNN runs over every file's segments in blocks of rows."""
    rows = torch.cat(segs)
    feats = torch.cat([adapt_cnn(p, cfg, rows[i:i + block_rows, None])
                       for i in range(0, len(rows), block_rows)])
    out, start = [], 0
    for s in segs:
        h = self_attention(p, cfg, feats[start:start + len(s)])
        start += len(s)
        out.append(torch.cat([pool_att_ff(p, pre, h) for pre in heads_of(p)]))
    return torch.stack(out)


def train_forward(p, cfg, segs, masks: Masks, t_bucket: int):
    """Train-mode forward of one batch: ``segs`` a list of (n_b, M, S) ->
    (B, heads). Batch norm takes its statistics over the batch's segments.
    The channel masks are laid out as the dense batch draws them, one row
    per (file, segment slot) of a ``t_bucket``-slot bucket; the attention
    and feature masks per (file, slot); each file takes its own rows."""
    rows = torch.cat(segs)
    idx = torch.cat([b * t_bucket + torch.arange(len(s)) for b, s in enumerate(segs)]).to(rows.device)
    feats = adapt_cnn(p, cfg, rows[:, None], train=True,
                      drop=lambda h: masks.take("cnn", h)[idx])
    sa_masks = []  # per layer: the four masks, each (B, T, ...) of the bucket
    for _ in range(cfg["td_sa_num_layers"]):
        sa_masks.append([masks.take("sa", feats) for _ in range(4)])
    out, start = [], 0
    for b, s in enumerate(segs):
        n = len(s)
        own = iter([m[b, 0, :n, :n] if m.dim() == 4 else m[b, :n] for layer in sa_masks for m in layer])
        h = self_attention(p, cfg, feats[start:start + n], take=lambda like: next(own))
        start += n
        out.append(torch.cat([pool_att_ff(p, pre, h) for pre in heads_of(p)]))
    return torch.stack(out)


def mse_loss(y_hat, y):
    return ((y_hat - y) ** 2).mean(dim=0).sum()


class Adam:
    """torch.optim.Adam's update with its defaults, written out."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params: dict, grads: dict):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, g in grads.items():
            m = self.m.get(n, torch.zeros_like(g)) * self.b1 + (1.0 - self.b1) * g
            v = self.v.get(n, torch.zeros_like(g)) * self.b2 + (1.0 - self.b2) * g * g
            self.m[n], self.v[n] = m, v
            params[n] = params[n] - self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
