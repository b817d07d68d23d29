"""Analytic FLOP count of a serving pass, the numerator of the tools' MFU.

Counterpart of the JAX package's ``tools/flops.py``. It counts, per batch
of the port's own plan (``InferenceEngine`` scan and ``_plan_for``: files
grouped by sample rate and transport, length-sorted, ``batch_size`` rows a
batch, each batch at the smallest T bucket that holds its longest file):

  * the cached pass: ``seg_fn`` and the model at (batch size, bucket), the
    work of the fetched, fetch-free and async regimes (the front-end ran
    once, on the cold pass);
  * the cold extra: the front-end of each batch and end, 4 * N * span * K
    for the windowed DFT's real and imaginary products plus 2 * N * K * M
    for the mel projection, with N = batch size x frames of the bucket, span
    the window in samples, K the kept DFT bins (1,792 at 48 kHz) and M the
    mel bands. The dense mel product is the convention of the MFU (XLA
    counts it so); the kernel itself does the mel step only over each
    64-bin tile's filterbank band, and ``chip_smoke.py``'s bound counts
    that band work beside the same DFT products.

NISQA_DE counts both ends' trunk rows, the alignment's scores (and, soft,
its product), ``td_2`` and the pooling over the pairs, and the front-end
twice; a pair takes the longer end's bucket. NISQA-TTS counts the
StandardCNN, the bidirectional LSTM's gate products over every step of the
bucket and ``last_step_bi``'s linear layer.

Convention: the count is what the card executes. Bucket padding counts:
every row of a batch, every segment of the bucket and every frame of the
front-end. Every convolution tap counts, padding taps included. The
masked LSTM's bidirectional layer runs 2B rows (the bucket and a
right-aligned copy) through both directions, and all of it counts. The
FLOPs are those of the products, two per multiply-add: convolutions,
linear layers, batched products, the LSTM's gates; elementwise work (batch
norm, activations, softmax, pooling, masks, the magnitude and the dB)
is not counted, as ``torch.utils.flop_counter.FlopCounterMode`` does not
count it either. The distance scorer of the alignment is elementwise and
counts nothing.

XLA's cost model in the JAX package's ``tools/flops.py`` counts the cached
pass of NISQA_DIM about 16% lower (2.873e9 against 3.415e9 for two files
of 3 s and 5 s at bs 2, bucket 163): it counts only a convolution's taps
that land on real input, not those on its zero padding (for a 3x3 kernel
at padding 1, (3H - 2)(3W - 2) taps of an H x W map instead of 9HW: the
AdaptCNN's 2.706e9 against 3.312e9 here), and some elementwise work. The
cold extras agree within 0.1%. The count is analytic, from the model's
parameter shapes and the plan, so it runs on the CPU with nothing on a
device.

Usage: python -m nisqa_tpu_torch.tools.flops <ckpt.tar> <corpus_dir> [batch_size]
A NISQA_DE checkpoint pairs each ``deg_<id>.wav`` of the directory with its
``ref_<id>.wav`` (the naming of ``corpus.de_corpus``). Prints one JSON line:
  {"cached_flops_per_pass", "cold_flops_per_pass", "total_audio_s",
   "n_files", "plan_batches", "flops_per_audio_s_cached", "cached_by_part"}
"""

from __future__ import annotations

import json
import os
import sys

from ..data.front_end import frame_geometry
from ..data.pipeline import InferenceEngine, MsConfig, front_end_consts
from ..models.framewise import DFF, AdaptCNN, Skip, StandardCNN
from ..models.pooling import PoolAtt, PoolAttFF
from ..models.td import LSTM, SelfAttention


def front_end_flops(n: int, span: int, k: int, m: int) -> int:
    """The DFT->mel step on ``n`` frames: 4*n*span*k (re and im) + 2*n*k*m (mel)."""
    return 4 * n * span * k + 2 * n * k * m


def _linear(rows: int, lin) -> int:
    return 2 * rows * lin.in_features * lin.out_features


def _conv(n: int, h: int, w: int, conv):
    """(FLOPs, h_out, w_out) of ``conv`` over n images of h x w: every tap."""
    c_out, c_in, kh, kw = conv.weight.shape
    (ph, pw), (sh, sw) = conv.padding, conv.stride
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    return 2 * n * c_out * ho * wo * c_in * kh * kw, ho, wo


def _convs(n: int, h: int, w: int, stages, convs):
    """FLOPs of a chain: ``stages`` lists, per conv of ``convs``, the (h, w)
    to pool to before it (None: none)."""
    total = 0
    for pool, conv in zip(stages, convs):
        if pool is not None:
            h, w = pool
        f, h, w = _conv(n, h, w, conv)
        total += f
    return total


def framewise_flops(fw, n: int, n_mels: int, seg_length: int) -> int:
    """The framewise stage over ``n`` segments of (n_mels, seg_length)."""
    convs = [getattr(fw, f"conv{i}", None) for i in range(1, 7)]
    if isinstance(fw, AdaptCNN):
        p1, p2, p3 = fw.pools
        f = _convs(n, n_mels, seg_length, [None, p1, p2, None, p3, None], convs)
        return f + (_linear(n, fw.fc) if fw.fc is not None else 0)
    if isinstance(fw, StandardCNN):
        # 2x2 max-pools: 48x15 -> 24x8 (width padded by 1) -> 12x4 -> 6x2
        f = _convs(n, n_mels, seg_length, [None, (24, 8), (12, 4), None, (6, 2), None], convs)
        return f + (_linear(n, fw.fc_out) if fw.fc_out is not None else 0)
    if isinstance(fw, DFF):
        return sum(_linear(n, getattr(fw, f"lin{i}")) for i in range(1, 5))
    if isinstance(fw, Skip):
        return _linear(n, fw.linear) if fw.linear is not None else 0
    raise TypeError(f"no FLOP count for framewise stage {type(fw).__name__}")


def lstm_flops(rows: int, t: int, lstm) -> int:
    """The gate products of a :class:`..models.modules.MaskedLSTM` over (rows, t):
    per layer, direction and executed row-step 2*4H*(I + H); a bidirectional
    layer runs 2*rows rows (the bucket and its right-aligned copy)."""
    total = 0
    for layer in lstm.layers:
        dirs = 2 if layer.bidirectional else 1
        run_rows = 2 * rows if layer.bidirectional else rows
        h = layer.hidden_size
        total += dirs * 2 * run_rows * t * 4 * h * (layer.input_size + h)
    return total


def td_flops(td, rows: int, t: int) -> int:
    """A time-dependency stage (``TimeDependency``) over (rows, t)."""
    m = td.model
    if m is None:
        return 0
    if isinstance(m, LSTM):
        return lstm_flops(rows, t, m.lstm)
    if isinstance(m, SelfAttention):
        bt, d = rows * t, m.linear.out_features
        f = _linear(bt, m.linear)
        for layer in m.layers:
            # in_proj (3d x d), scores and weighted sum (2 * t^2 * d per row), out_proj, FF
            f += 2 * bt * d * 3 * d + 2 * 2 * rows * t * t * d
            f += _linear(bt, layer.self_attn.out_proj)
            f += _linear(bt, layer.linear1) + _linear(bt, layer.linear2)
        return f
    raise TypeError(f"no FLOP count for time dependency {type(m).__name__}")


def pool_flops(pool, rows: int, t: int) -> int:
    """A pooling head (``Pooling``) over (rows, t)."""
    m = pool.model
    if isinstance(m, PoolAttFF):
        d = m.linear1.in_features
        return (_linear(rows * t, m.linear1) + _linear(rows * t, m.linear2)
                + 2 * rows * t * d + _linear(rows, m.linear3))
    if isinstance(m, PoolAtt):
        d = m.linear1.in_features
        return _linear(rows * t, m.linear1) + 2 * rows * t * d + _linear(rows, m.linear2)
    return _linear(rows, m.linear)  # avg / max / last_step / last_step_bi


def align_flops(align, rows: int, t: int, d: int) -> int:
    """The alignment of (rows, t, d) references to (rows, t, d) degraded ends."""
    method = align.method
    if method in ("none", None):
        return 0
    tt = rows * t * t
    if method in ("dot", "cosine"):
        f = 2 * tt * d
    elif method == "luong":
        f = _linear(rows * t, align.att["W"]) + 2 * tt * d
    elif method == "bahd":
        a = align.att["Wq"].out_features
        f = _linear(rows * t, align.att["Wq"]) + _linear(rows * t, align.att["Wy"]) + 2 * tt * a
    else:  # distance: -mean |q - y|, elementwise only
        f = 0
    return f + (2 * tt * d if align.apply_method == "soft" else 0)


def forward_flops(model, rows: int, t: int, n_mels: int, seg_length: int) -> dict:
    """FLOPs of one eval forward over ``rows`` rows (pairs, double-ended) at
    T bucket ``t``, by part."""
    ends = 2 if model.double_ended else 1
    parts = {
        "framewise": framewise_flops(model.cnn.model, ends * rows * t, n_mels, seg_length),
        "td": td_flops(model.time_dependency, ends * rows, t),
    }
    if model.double_ended:
        parts["align"] = align_flops(model.align, rows, t, model.time_dependency.fan_out)
        fusion = model.fuse.lin_fusion
        parts["fusion"] = _linear(rows * t, fusion) if fusion is not None else 0
    parts["td_2"] = td_flops(model.time_dependency_2, rows, t)
    heads = model.pool_layers if model.dim else [model.pool]
    parts["pool"] = sum(pool_flops(p, rows, t) for p in heads)
    return parts


def batch_front_end_flops(ms: MsConfig, sr: int, bucket: int, batch_size: int) -> int:
    """The front-end of one end of a batch at (sr, bucket): the DFT->mel step
    over every frame row of the bucket."""
    consts = front_end_consts(ms, sr, "f32")
    span, k = consts["w_re"].shape
    n = batch_size * frame_geometry(ms, sr, bucket)[3]
    return front_end_flops(n, span, k, ms.n_mels)


def count_plan(model, ms: MsConfig, plan, batch_size: int) -> dict:
    """The cached pass's FLOPs by part and the cold extra, over ``plan``."""
    ends = 2 if model.double_ended else 1
    by_part, cold_extra = {}, 0
    for (sr, bucket, _), _ in plan:
        for part, f in forward_flops(model, batch_size, bucket, ms.n_mels, ms.seg_length).items():
            by_part[part] = by_part.get(part, 0) + f
        cold_extra += ends * batch_front_end_flops(ms, sr, bucket, batch_size)
    return {"cached": sum(by_part.values()), "cold_extra": cold_extra, "by_part": by_part}


def _entry_seconds(entry) -> float:
    tag, data, sr = entry
    return (data if tag in ("native", "native_f32") else len(data)) / sr


def count_engine(engine: InferenceEngine, paths, paths_ref=None) -> dict:
    """The record of ``engine``'s plan over ``paths`` (and ``paths_ref``):
    FLOPs per cached and per cold pass, the degraded end's audio seconds."""
    paths = list(paths)
    audio, _, plan = engine._scan_plan(paths, engine._check_ref(paths, paths_ref))
    c = count_plan(engine.model, engine.ms, plan, engine.batch_size)
    total_audio_s = sum(_entry_seconds(e) for e in audio)
    return {
        "cached_flops_per_pass": c["cached"],
        "cold_flops_per_pass": c["cached"] + c["cold_extra"],
        "total_audio_s": round(total_audio_s, 2),
        "n_files": len(paths),
        "plan_batches": len(plan),
        "flops_per_audio_s_cached": round(c["cached"] / max(total_audio_s, 1e-9), 1),
        "cached_by_part": c["by_part"],
    }


def corpus_paths(corpus_dir: str, double_ended: bool):
    """The sorted WAVs of ``corpus_dir``; for a double-ended model the
    ``deg_<id>.wav`` files and their ``ref_<id>.wav``."""
    wavs = sorted(f for f in os.listdir(corpus_dir) if f.endswith(".wav"))
    if not double_ended:
        return [os.path.join(corpus_dir, f) for f in wavs], None
    deg = [f for f in wavs if f.startswith("deg_")]
    missing = [f for f in deg if "ref_" + f[4:] not in wavs]
    if not deg or missing:
        raise ValueError(f"{corpus_dir}: a NISQA_DE checkpoint needs deg_<id>.wav files with "
                         f"their ref_<id>.wav; {len(deg)} deg files, unpaired {missing[:3]}")
    return ([os.path.join(corpus_dir, f) for f in deg],
            [os.path.join(corpus_dir, "ref_" + f[4:]) for f in deg])


def count_flops(tar: str, corpus_dir: str, batch_size: int = 32) -> dict:
    """The record for checkpoint ``tar`` over the WAVs of ``corpus_dir``. The
    model is built from the checkpoint's args on the CPU (its weights are
    not needed) and nothing runs."""
    from ..compat.checkpoint import build_from_args, load_torch_checkpoint

    args = load_torch_checkpoint(tar)["args"]
    model = build_from_args(args)
    engine = InferenceEngine(model, MsConfig(args), "cpu", batch_size=batch_size, cache_mb=0)
    return count_engine(engine, *corpus_paths(corpus_dir, model.double_ended))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        raise SystemExit("usage: python -m nisqa_tpu_torch.tools.flops <ckpt.tar> <corpus_dir> "
                         "[batch_size]")
    rec = count_flops(argv[0], argv[1], int(argv[2]) if len(argv) > 2 else 32)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
