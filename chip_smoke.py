#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``nisqa_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed 0] [--reps 5]

Phases, each of which raises on failure (the script then exits non-zero and
never prints its last line):

  1. device: requires CUDA; prints versions and the card's name and power
     limit (nvidia-smi);
  2. build: compiles the CUDA kernel library from ``nisqa_tpu_torch/csrc``
     and counts the tensor-core (HGMMA) instructions in its SASS;
  3. kernel vs twin: ``fused_dft_mel`` against ``dft_mel_reference`` on the
     card at the main path's shapes (48 kHz with N = 32 x 5,211 and
     32 x 663 frame rows, the largest and smallest buckets; a ragged N of 43
     that splits K across blocks; 16 kHz with K = 2,049; 44.1 kHz with an
     882-sample span) and the TTS path's (48 kHz at fmax 8 kHz, K = 768,
     N = 8 x 6,014 and a ragged 1,001), both front-end modes, with
     CUDA-event times, TFLOP/s and the bound of each and a bitwise repeat;
  4. models: the released NISQA_DIM and NISQA-TTS weights
     (``tests/goldens/g2_dim.npz``, ``g3_tts.npz``) against their torch
     goldens at "highest" precision;
  5. main path: ``python -m nisqa_tpu_torch.run_predict --mode predict_dir
     --bs 32`` (through its ``main``) over a seeded corpus of 64 48 kHz and
     4 16 kHz WAVs with a reference-format ``.tar`` of those weights; counts
     the kernel's launches and constant preparations in that run, and times
     warm cold passes (``cache_mb=0``) at the default precision and at
     "highest", each with the kernel and with the twin front-end;
  6. serving: ``load_predictor(..., cache_mb=512)`` over the same corpus:
     ``warmup``, a cold ``interleaved`` pass (filler thread, pinned ring; one
     kernel launch per batch), a ``cached`` pass (no launch), two
     ``fetch="async"`` cached passes resolved after both were dispatched, a
     ``fuse_pass=False`` cached pass, a ``cached_partial`` pass with about
     half the mel blocks resident, and a fresh ``cache_mb=0`` engine; every
     result within 1e-5 of the cold pass; audio-s/s (median of 5 warm
     passes), ``stats["last"]`` and the device idle share (torch.profiler)
     of each regime;
  7. TTS path: ``run_predict --mode predict_dir --bs 8`` with the released
     NISQA-TTS weights at the TTS checkpoint geometry (seg_hop 1, up to
     6,000 segments, fmax 8 kHz) over 16 WAVs of 10-40 s at 48 kHz and 2 at
     16 kHz: one kernel launch per batch, "highest" precision through the
     LSTM upgrade, warm cold and cached passes within 1e-5 of the first and
     within 1e-3 of the twin front-end, audio-s/s, the profiler's top device
     kernels with the cuDNN LSTM's share, and the idle share;
  8. no sync: one forward of the TTS model at the largest bucket under
     ``torch.cuda.set_sync_debug_mode("error")``, returning while the device
     still runs;
  9. predict_csv + evaluate: ``run_predict --mode predict_csv --bs 32`` over
     a labelled CSV of phase 5's corpus in a shuffled order, then
     ``NisqaTorch.evaluate`` with a condition CSV: columns and row order,
     one launch per batch, predictions equal to phase 5's, finite metrics;
  10. double-ended: the trained NISQA_DE weights (``tests/goldens/
     de_trained.tar``, yaml geometry) through ``run_predict --mode
     predict_csv --bs 32`` over 96 degraded/reference pairs at 48 kHz (one
     with a float32 reference, so the f32 transport) and 4 at 16 kHz, the
     reference column from the checkpoint's ``csv_ref``: two kernel launches
     per cold batch; warm cold passes with the kernel and the twin
     front-end at "highest" (within 1e-3) and at the default precision;
     the serving regimes of phase 6 over the pairs at "highest" (each
     within 1e-5 of the cold pass) with degraded-side audio-s/s, idle share,
     top device kernels, peak device memory and the alignment's share of the
     forward, and a cached pass at the default precision;
     then each scorer x apply of the alignment once at T 1,300 and bs 32
     with random weights: finite outputs, time and peak device memory;
  11. imports: nothing of jax or ``nisqa_tpu`` was loaded, and a fresh import
     of every port module loads no jax, pandas, yaml, matplotlib or
     ``nisqa_tpu``.

The last two lines are a JSON record of the kernel and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# the released model's front-end (nisqa_tpu/config/train_nisqa_cnn_sa_ap.yaml)
YAML_GEOMETRY = {
    "ms_sr": None, "ms_fmax": 20000, "ms_n_fft": 4096, "ms_hop_length": 0.01,
    "ms_win_length": 0.02, "ms_n_mels": 48, "ms_seg_length": 15,
    "ms_seg_hop_length": 4, "ms_max_segments": 1300, "ms_channel": None,
}
# the released NISQA-TTS checkpoint's front-end (nisqa_tts.tar args; tools/bench_tts.py)
TTS_GEOMETRY = {**YAML_GEOMETRY, "ms_fmax": 8000, "ms_seg_hop_length": 1, "ms_max_segments": 6000}
BATCH = 32
TTS_BATCH = 8
# the trained double-ended weights: the shipped DE architecture at the yaml geometry
DE_TAR = os.path.join(REPO, "tests", "goldens", "de_trained.tar")
DE_SCORERS = ("dot", "cosine", "distance", "bahd", "luong")
EXACT_BOUND, FAST_BOUND = 1e-5, 1e-4  # kernel vs twin, relative to max|twin|
GOLDEN_BOUND = 2e-4                   # model vs torch golden, absolute
PASS_BOUND = 1e-3                     # kernel vs twin front-end predictions at "highest"
DEFAULT_PASS_BOUND = 1e-2             # the same at the default precision (TF32, bf16 DFT)
WARM_REPS = 5                         # timed warm passes per engine
SERVE_BOUND = 1e-5                    # every serving regime vs the cold pass, absolute
BF16_PEAK, TF32_PEAK, HBM_RATE = 989e12, 495e12, 3.35e12  # H100 SXM data sheet, dense


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 1) -> float:
    """Device time of one call of ``fn``, in ms, from CUDA events around
    ``iters`` calls."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def hgmma_count(lib_path: str) -> int:
    """HGMMA (wgmma) instructions in the library's SASS, from cuobjdump."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    r = subprocess.run([tool if os.path.exists(tool) else "cuobjdump", "-sass", lib_path],
                       capture_output=True, text=True, check=True, timeout=300)
    return sum("HGMMA" in line for line in r.stdout.splitlines())


def kernel_vs_twin(seed: int, reps: int, card: str):
    """Phase 3. Returns (rows of results, the main shape's row by mode, the
    TTS shape's row by mode)."""
    from nisqa_tpu_torch.data.pipeline import MsConfig, front_end_consts, matmul_precision
    from nisqa_tpu_torch.ops.dft_mel import (dft_mel_reference, fused_dft_mel, plan_grid,
                                             prepare_consts)

    ms, tts = MsConfig(YAML_GEOMETRY), MsConfig(TTS_GEOMETRY)
    n_main = BATCH * ms.frames_for_bucket(ms.max_segments)  # 32 x 5,211 = 166,752
    n_small = BATCH * ms.frames_for_bucket(ms.buckets()[0])  # 32 x 663 = 21,216
    n_tts = TTS_BATCH * tts.frames_for_bucket(tts.max_segments)  # 8 x 6,014 = 48,112
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(seed)
    results = []
    # the main path's shapes, then 44.1 kHz: a 882-sample span whose rows the
    # wrapper re-pads to the 16-byte stride the TMA wants; then the TTS
    # path's K = 768 at its largest bucket and at a ragged N that splits K
    cases = [("yaml", ms, 48000, n_main), ("yaml", ms, 48000, n_small), ("yaml", ms, 48000, 43),
             ("yaml", ms, 16000, n_main), ("yaml", ms, 44100, 4000),
             ("tts", tts, 48000, n_tts), ("tts", tts, 48000, 1001)]
    for geometry, g_ms, sr, n in cases:
        c = {k: torch.from_numpy(v).cuda() for k, v in front_end_consts(g_ms, sr, "i16").items()}
        span, k = c["w_re"].shape
        m = c["fb_t"].shape[1]
        frames = np.clip(np.round(rng.standard_normal((n, span)) * 3000), -32768, 32767)
        frames = torch.from_numpy(frames.astype(np.float32)).cuda()
        flop = 4.0 * n * span * k  # the DFT's re and im products, as counted for both
        n_tiles = len(prepare_consts(c["w_re"], c["w_im"], c["fb_t"], True)["tiles"])
        iters = 1 if n >= 10_000 else 20
        for mode, bf16, bound in (("exact", False, EXACT_BOUND), ("fast", True, FAST_BOUND)):
            # fast mode takes bf16 frames, as mel_fn hands them over
            args = (frames.to(torch.bfloat16) if bf16 else frames, c["w_re"], c["w_im"], c["fb_t"])
            with matmul_precision("highest"):  # the twin in float32, TF32 off
                out = fused_dft_mel(*args, bf16=bf16)
                again = fused_dft_mel(*args, bf16=bf16)
                ref = dft_mel_reference(*args, bf16=bf16)
                torch.cuda.synchronize()
                abs_err = (out - ref).abs().max().item()
                rel_err = abs_err / ref.abs().max().item()
                repeat_equal = bool(torch.equal(out, again))
                del out, again, ref
                k_ms, t_ms = [], []
                for _ in range(reps):  # alternate kernel and twin
                    k_ms.append(event_ms(lambda: fused_dft_mel(*args, bf16=bf16), iters))
                    t_ms.append(event_ms(lambda: dft_mel_reference(*args, bf16=bf16), iters))
            kernel_ms, twin_ms = float(np.median(k_ms)), float(np.median(t_ms))
            # least time for the same work: the products on the tensor cores
            # (3 TF32 products per exact one), or each input read and the
            # output written once at the HBM rate, whichever is longer
            ops_s = flop / BF16_PEAK if bf16 else 3 * flop / TF32_PEAK
            io_bytes = n * span * (2 if bf16 else 4) + (2 * span * k + k * m + n * m) * 4
            bound_ms = 1e3 * max(ops_s, io_bytes / HBM_RATE)
            row_tiles, splits, _ = plan_grid(n, n_tiles, sms)
            row = {"geometry": geometry, "sr": sr, "N": n, "span": span, "K": k, "M": m, "mode": mode,
                   "grid": [row_tiles, splits], "max_abs_err": abs_err, "rel_err": rel_err,
                   "bound": bound, "repeat_bitwise_equal": repeat_equal,
                   "kernel_ms": kernel_ms, "twin_ms": twin_ms,
                   "kernel_tflops": flop / kernel_ms / 1e9, "twin_tflops": flop / twin_ms / 1e9,
                   "bound_ms": bound_ms, "bound_by": "operations" if ops_s * HBM_RATE >= io_bytes
                   else "bytes", "share_of_bound": bound_ms / kernel_ms}
            print("kernel_vs_twin " + json.dumps(row) + f" card: {card}", flush=True)
            check(math.isfinite(rel_err) and rel_err <= bound,
                  f"fused_dft_mel disagrees with its twin: {row}")
            check(repeat_equal, f"two launches on the same input differ: {row}")
            results.append(row)
            del args
        del frames, c
        torch.cuda.empty_cache()
    main = {r["mode"]: r for r in results if r["sr"] == 48000 and r["N"] == n_main}
    tts_main = {r["mode"]: r for r in results if r["N"] == n_tts}
    return results, main, tts_main


def model_golden(name: str):
    """Phase 4: released weights (a golden's ``sd::*``) vs the torch golden
    on the card. Returns the golden's (meta, state dict)."""
    from nisqa_tpu_torch.data.pipeline import matmul_precision
    from nisqa_tpu_torch.models.nisqa import build_model

    z = np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npz"), allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    model = build_model(meta["model"], meta["model_args"])
    model.load_state_dict(sd, strict=True)
    model = model.cuda().eval()
    with torch.inference_mode(), matmul_precision("highest"):
        y = model(torch.from_numpy(z["x"][:, :, 0]).cuda(), torch.from_numpy(z["n_wins"]).cuda())
    err = float(np.abs(y.cpu().numpy() - z["y"]).max())
    print(f"model {name} ({meta['model']}) vs torch golden at 'highest': max_abs_err={err} "
          f"bound={GOLDEN_BOUND}", flush=True)
    check(y.shape == z["y"].shape and err <= GOLDEN_BOUND, f"{name} golden off by {err}")
    return meta, sd


def write_pcm16(path: str, y, sr: int):
    pcm = np.clip(np.round(y * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_float32(path: str, y, sr: int):
    """Mono IEEE-float WAV (format tag 3), which the ``wave`` module cannot write."""
    data = np.asarray(y, dtype="<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sr, sr * 4, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def write_corpus(out_dir: str, seed: int):
    """64 PCM16 WAVs at 48 kHz, 3-30 s log-uniform (the repo bench's
    recipe), plus 4 at 16 kHz. Returns the total audio seconds."""
    rng = np.random.default_rng(seed)
    total = 0.0
    for i, sr in enumerate([48000] * 64 + [16000] * 4):
        n = int(sr * float(np.exp(rng.uniform(np.log(3.0), np.log(30.0)))))
        t = np.arange(n) / sr
        f0 = rng.uniform(100, 300)
        y = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 3.1 * f0 * t)
             + 0.05 * rng.standard_normal(n))
        write_pcm16(os.path.join(out_dir, f"smoke_{sr // 1000}k_{i:03d}.wav"), y, sr)
        total += n / sr
    return total


def write_tts_corpus(out_dir: str, seed: int):
    """16 PCM16 WAVs at 48 kHz, 10-40 s log-uniform with an amplitude-
    modulated tone (``tools/bench_tts.py::make_corpus``'s recipe), plus 2
    at 16 kHz. Returns the total audio seconds."""
    rng = np.random.default_rng(seed)
    total = 0.0
    for i, sr in enumerate([48000] * 16 + [16000] * 2):
        n = int(sr * float(np.exp(rng.uniform(np.log(10.0), np.log(40.0)))))
        t = np.arange(n) / sr
        f0 = rng.uniform(90, 250)
        y = (0.3 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 1.7 * t))
             + 0.05 * rng.standard_normal(n))
        write_pcm16(os.path.join(out_dir, f"tts_{sr // 1000}k_{i:02d}.wav"), y, sr)
        total += n / sr
    return total


def write_de_corpus(out_dir: str, seed: int):
    """96 degraded/reference pairs at 48 kHz and 4 at 16 kHz
    (``tools/bench_de.py::make_de_corpus``'s recipe, lengths drawn): the
    reference a multi-harmonic tone of 3-12 s, log-uniform; the degraded end
    the reference plus white noise at an SNR uniform in 0-40 dB, cut 0-0.5 s
    shorter. The last 48 kHz pair's reference is a float32 WAV. Returns
    (degraded names, reference names, degraded audio-s)."""
    rng = np.random.default_rng(seed)
    deg, ref, total = [], [], 0.0
    for i, sr in enumerate([48000] * 96 + [16000] * 4):
        n = int(sr * float(np.exp(rng.uniform(np.log(3.0), np.log(12.0)))))
        t = np.arange(n) / sr
        f0 = rng.uniform(100, 300)
        y = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2.05 * f0 * t)
             + 0.05 * np.sin(2 * np.pi * 3.1 * f0 * t))
        noise = rng.standard_normal(n)
        noise *= np.sqrt((y ** 2).mean() / 10 ** (rng.uniform(0.0, 40.0) / 10) / (noise ** 2).mean())
        cut = n - int(sr * rng.uniform(0.0, 0.5))
        deg.append(f"de_{sr // 1000}k_{i:03d}_deg.wav")
        ref.append(f"de_{sr // 1000}k_{i:03d}_ref.wav")
        write_pcm16(os.path.join(out_dir, deg[-1]), np.clip(y + noise, -0.999, 0.999)[:cut], sr)
        (write_float32 if i == 95 else write_pcm16)(os.path.join(out_dir, ref[-1]), y, sr)
        total += cut / sr
    return deg, ref, total


def make_corpus(tmp: str, meta, sd, seed: int):
    """The seeded corpus and a reference-format ``.tar`` of the released
    NISQA_DIM weights with the yaml geometry. Returns (tar, paths, audio-s)."""
    corpus = os.path.join(tmp, "wavs")
    os.makedirs(corpus)
    audio_s = write_corpus(corpus, seed)
    tar = os.path.join(tmp, "nisqa_dim.tar")
    args = {**meta["model_args"], **YAML_GEOMETRY, "model": "NISQA_DIM", "name": "NISQA_DIM"}
    torch.save({"args": args, "model_state_dict": sd, "model_name": "NISQA_DIM"}, tar)
    paths = sorted(os.path.join(corpus, f) for f in os.listdir(corpus))
    return tar, paths, audio_s


def main_path(tar: str, paths, audio_s: float, card: str):
    """Phase 5. Returns the kernel's launch count in the predict_dir run and
    the run's predictions (rows in ``paths`` order)."""
    from nisqa_tpu_torch import run_predict
    from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar
    from nisqa_tpu_torch.data.pipeline import InferenceEngine, MsConfig, native_decode_available
    from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference, fused_dft_mel

    with tempfile.TemporaryDirectory(prefix="nisqa_smoke_out_") as out_dir:
        corpus = os.path.dirname(paths[0])
        print(f"host decode: {'native C++ loader' if native_decode_available() else 'Python decoder'}",
              flush=True)

        fused_dft_mel.LAUNCHES = fused_dft_mel.PREPARATIONS = 0
        t0 = time.perf_counter()
        runner = run_predict.main(["--mode", "predict_dir", "--pretrained_model", tar,
                                   "--data_dir", corpus, "--output_dir", out_dir, "--bs", str(BATCH)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, preparations = fused_dft_mel.LAUNCHES, fused_dft_mel.PREPARATIONS

        with open(os.path.join(out_dir, "NISQA_results.csv"), newline="") as f:
            table = list(csv.DictReader(f))
    pred_cols = ["mos_pred", "noi_pred", "dis_pred", "col_pred", "loud_pred"]
    check(len(table) == len(paths) == 68 and len(runner.ds_val.df) == 68,
          f"NISQA_results.csv has {len(table)} rows for {len(paths)} files")
    check(list(table[0]) == ["deg", *pred_cols, "model"], f"columns {list(table[0])}")
    check([r["deg"] for r in table] == [os.path.basename(p) for p in paths], "row order")
    y_cli = np.array([[float(r[c]) for c in pred_cols] for r in table])
    check(bool(np.isfinite(y_cli).all()), "non-finite predictions in NISQA_results.csv")

    model, ckpt_args = load_model_from_tar(tar, "cuda")
    ms = MsConfig(ckpt_args)
    plan = InferenceEngine(model, ms, "cuda", batch_size=BATCH).plan(paths)
    print(f"predict_dir: {len(table)} files, {len(plan)} batches "
          f"{[(g, len(c)) for g, c in plan]}, fused_dft_mel launches={launches}, "
          f"constant preparations={preparations}; "
          f"{audio_s:.1f} audio-s in {wall:.3f} s wall (checkpoint load and first-call "
          f"set-up included) = {audio_s / wall:.1f} audio-s/s on {card}", flush=True)
    check(launches == len(plan), f"fused_dft_mel launched {launches}x for {len(plan)} batches")
    groups = {(sr, kind) for (sr, _, kind), _ in plan}  # one front-end mode per engine
    check(preparations == len(groups),
          f"{preparations} constant preparations for {len(groups)} (sr, transport, mode) groups")

    # cold passes only (cache_mb=0): every pass runs the front-end
    engines = {
        (precision, name): InferenceEngine(model, ms, "cuda", batch_size=BATCH,
                                           precision=precision, fe_precision=fe,
                                           dft_mel=dft_mel, cache_mb=0)
        for precision, fe in (("default", "fast"), ("highest", "exact"))
        for name, dft_mel in (("kernel", fused_dft_mel), ("twin", dft_mel_reference))
    }
    for engine in engines.values():
        engine.predict_paths(paths)  # untimed: cuDNN set-up, constant preparation
    y, secs = {}, {key: [] for key in engines}
    for r in range(WARM_REPS):  # alternate the order: host noise hits both front-ends alike
        for key in list(engines)[:: 1 if r % 2 == 0 else -1]:
            t0 = time.perf_counter()
            y[key] = engines[key].predict_paths(paths)  # ends in a device readback
            secs[key].append(time.perf_counter() - t0)
    for (precision, name), engine in engines.items():
        dt = float(np.median(secs[precision, name]))
        print(f"warm pass precision={precision} fe={engine.fe_precision} front-end={name}: "
              f"{audio_s / dt:.1f} audio-s/s (median {dt:.4f} s of "
              f"{[round(t, 4) for t in secs[precision, name]]}) on {card}", flush=True)
    for precision, bound in (("default", DEFAULT_PASS_BOUND), ("highest", PASS_BOUND)):
        got = y[precision, "kernel"]
        diff = float(np.abs(got - y[precision, "twin"]).max())
        print(f"kernel vs twin front-end at {precision!r}: max_abs_diff={diff} bound={bound}",
              flush=True)
        check(bool(np.isfinite(got).all()) and diff <= bound,
              f"kernel and twin front-ends disagree by {diff} at {precision!r}")
    print("default-precision CLI vs 'highest': max_abs_diff="
          f"{float(np.abs(y_cli - y['highest', 'kernel']).max())}", flush=True)
    return launches, y_cli


def idle_share(fn):
    """(device busy s, wall s, idle share, {device item: ms}) of one call of
    ``fn``: the union of the device activity intervals in a
    ``torch.profiler`` trace over the host wall time of the call (which ends
    in a synchronise); prints the call's ten largest device items. Returns
    None for the busy time and the share when the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
    if not device:
        return None, wall, None, {}
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print("  device ms by kernel: " + "; ".join(f"{name[:60]} {ms:.3f}" for name, ms in top),
          flush=True)
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy_us + cur_e - cur_s) / 1e6
    return busy, wall, max(0.0, 1.0 - busy / wall), by_name


def serving(tar: str, paths, audio_s: float, card: str, paths_ref=None, precision=None):
    """Phase 6 (and phase 10's regimes, with ``paths_ref``): the serving
    engine through ``load_predictor`` at bs 32, at ``precision`` (None: the
    engine's default). Each cold batch launches the kernel once per end.
    Returns {regime: kernel launches in its pass}."""
    import nisqa_tpu_torch
    from nisqa_tpu_torch.ops.dft_mel import fused_dft_mel

    label = "serving" if paths_ref is None else f"de serving at {precision!r}"
    unit = "audio-s/s" if paths_ref is None else "degraded audio-s/s"
    ends = 1 if paths_ref is None else 2

    def launched(fn):
        fused_dft_mel.LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        return out, fused_dft_mel.LAUNCHES

    def report(regime, predict, fn, y_ref=None, profile_it=True, passes=1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(WARM_REPS):
            t0 = time.perf_counter()
            y = fn()
            secs.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dt = float(np.median(secs))
        if y_ref is not None:
            diff = float(np.abs(y - y_ref).max())
            check(diff <= SERVE_BOUND, f"{regime}: warm passes off by {diff} from the cold pass")
        busy, wall, idle, _ = idle_share(fn) if profile_it else (None, None, None, None)
        idle_txt = ("not measured" if idle is None else
                    f"{idle:.4f} (device busy {busy:.4f} s of {wall:.4f} s, torch.profiler)")
        print(f"{label} {regime}: {passes * audio_s / dt:.1f} {unit} (median {dt:.4f} s of "
              f"{[round(t, 4) for t in secs]}); idle share {idle_txt}; peak device memory "
              f"{peak_gb:.3f} GB; stats.last {json.dumps(predict.engine.stats['last'])} on {card}",
              flush=True)

    def load(**kw):
        predict = nisqa_tpu_torch.load_predictor(tar, batch_size=BATCH, precision=precision, **kw)
        return predict, lambda **f: predict(paths, paths_ref, **f)

    predict, run = load(cache_mb=512)
    eng = predict.engine
    n_batches = len(eng.plan(paths, paths_ref))
    t0 = time.perf_counter()
    warmed = eng.warmup(paths, paths_ref)
    print(f"{label} warmup: {len(warmed)} shapes {warmed} in {time.perf_counter() - t0:.3f} s",
          flush=True)

    launches = {}
    y_cold, launches["interleaved"] = launched(run)
    last = eng.stats["last"]
    print(f"{label} cold pass: stats.last {json.dumps(last)}, fused_dft_mel "
          f"launches={launches['interleaved']} for {n_batches} batches", flush=True)
    check(last["mode"] == "interleaved", f"first pass ran {last['mode']}, not interleaved")
    check(launches["interleaved"] == ends * n_batches,
          f"cold pass launched the kernel {launches['interleaved']}x for {n_batches} batches")
    out_dim = 5 if eng.model.dim else 1
    check(bool(np.isfinite(y_cold).all()) and y_cold.shape == (len(paths), out_dim),
          f"cold pass gave {y_cold.shape} or non-finite values")

    y_cached, launches["cached"] = launched(run)
    last = eng.stats["last"]
    diff = float(np.abs(y_cached - y_cold).max())
    print(f"{label} cached pass: stats.last {json.dumps(last)}, fused_dft_mel "
          f"launches={launches['cached']}, max_abs_diff vs cold={diff} bound={SERVE_BOUND}",
          flush=True)
    check(last["mode"] == "cached", f"second pass ran {last['mode']}, not cached")
    check(launches["cached"] == 0, f"a cached pass launched the kernel {launches['cached']}x")
    check(diff <= SERVE_BOUND, f"cached pass off by {diff} from the cold pass")

    def two_async():
        h1, h2 = run(fetch="async"), run(fetch="async")
        return h1(), h2()

    (ya, yb), launches["async"] = launched(two_async)
    diff = max(float(np.abs(ya - y_cold).max()), float(np.abs(yb - y_cold).max()))
    print(f"{label} two async cached passes: max_abs_diff vs cold={diff}, fused_dft_mel "
          f"launches={launches['async']}", flush=True)
    check(diff <= SERVE_BOUND and launches["async"] == 0, f"async passes off by {diff}")
    report("cached (fused)", predict, run, y_cold)
    report("cached, two async passes per timing", predict, lambda: two_async()[1], y_cold,
           profile_it=False, passes=2)
    if paths_ref is not None:
        alignment_share(eng, card)
    full_mb = eng._cache_bytes / (1 << 20)

    per_batch, run_pb = load(cache_mb=512, fuse_pass=False)
    run_pb()
    y_pb = run_pb()
    diff = float(np.abs(y_pb - y_cached).max())
    print(f"{label} fuse_pass=False cached pass: max_abs_diff vs fused={diff}; stats.last "
          f"{json.dumps(per_batch.engine.stats['last'])}", flush=True)
    check(per_batch.engine.stats["last"]["mode"] == "cached" and diff <= SERVE_BOUND,
          f"fuse_pass=False cached pass off by {diff} from the fused one")
    del per_batch, run_pb

    partial, run_part = load(cache_mb=full_mb / 2)
    partial.engine.warmup(paths, paths_ref)
    run_part()
    (y_part, launches["cached_partial"]) = launched(run_part)
    last = partial.engine.stats["last"]
    diff = float(np.abs(y_part - y_cold).max())
    print(f"{label} partial pass (cache_mb={full_mb / 2:.3f} of {full_mb:.3f} MB): stats.last "
          f"{json.dumps(last)}, fused_dft_mel launches={launches['cached_partial']}, "
          f"max_abs_diff vs cold={diff}", flush=True)
    check(last["mode"] == "cached_partial", f"partial pass ran {last['mode']}")
    check(last["resident_batches"] > 0 and last["cold_batches"] > 0,
          f"partial pass kept {last['resident_batches']} resident, {last['cold_batches']} cold")
    check(launches["cached_partial"] == ends * last["cold_batches"],
          f"partial pass launched the kernel {launches['cached_partial']}x for "
          f"{last['cold_batches']} cold batches")
    check(diff <= SERVE_BOUND, f"partial pass off by {diff} from the cold pass")
    report("cached_partial", partial, run_part, y_cold)
    del partial, run_part

    cold, run_cold = load(cache_mb=0)
    cold.engine.warmup(paths, paths_ref)
    run_cold()
    report("interleaved (cache_mb=0)", cold, run_cold, y_cold)
    check(cold.engine.stats["last"]["mode"] == "interleaved",
          f"cache_mb=0 pass ran {cold.engine.stats['last']['mode']}")
    return launches


def alignment_share(eng, card: str):
    """The alignment's share of the DE model's device time over the fused
    parts of ``eng``'s cached entry: CUDA-event times of ``model.align`` on
    each part's trunk features against the whole ``forward_ends``."""
    from nisqa_tpu_torch.data.front_end import seg_fn
    from nisqa_tpu_torch.data.pipeline import matmul_precision

    model, ms = eng.model, eng.ms
    entry = next(iter(eng._corpus_cache.values()))
    check(entry["mode"] == "mel_fused", f"cache entry {entry['mode']}, not mel_fused")
    align_ms = forward_ms = 0.0
    with torch.inference_mode(), matmul_precision(eng.precision):
        for gkey, db_d, n_d, db_r, n_r in entry["parts"]:
            (deg, nw_d), (ref, nw_r) = (seg_fn(ms, gkey[0], gkey[1], db, n)
                                        for db, n in ((db_d, n_d), (db_r, n_r)))
            fd, fr = model.trunk_ends(deg, nw_d, ref, nw_r)
            model.align(fd, fr, nw_r)  # warm
            align_ms += event_ms(lambda: model.align(fd, fr, nw_r), 5)
            forward_ms += event_ms(lambda: model.forward_ends(deg, nw_d, ref, nw_r), 5)
    print(f"de alignment ({model.align.method}/{model.align.apply_method}) over "
          f"{len(entry['parts'])} fused parts: {align_ms:.3f} ms of {forward_ms:.3f} ms forward "
          f"device time = {align_ms / forward_ms:.4f} (CUDA events) on {card}", flush=True)


def tts_path(tmp: str, meta, sd, seed: int, card: str):
    """Phase 7: the released NISQA-TTS weights at their checkpoint geometry
    through ``run_predict --mode predict_dir --bs 8``, then warm cold and
    cached passes. Returns (the kernel's launches in the CLI run, the
    runner's model)."""
    from nisqa_tpu_torch import run_predict
    from nisqa_tpu_torch.data.pipeline import InferenceEngine
    from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference, fused_dft_mel

    corpus, out_dir = os.path.join(tmp, "tts_wavs"), os.path.join(tmp, "tts_out")
    os.makedirs(corpus)
    os.makedirs(out_dir)
    audio_s = write_tts_corpus(corpus, seed)
    paths = sorted(os.path.join(corpus, f) for f in os.listdir(corpus))
    tar = os.path.join(tmp, "nisqa_tts.tar")
    args = {**meta["model_args"], **TTS_GEOMETRY, "model": "NISQA", "name": "NISQA_TTS"}
    torch.save({"args": args, "model_state_dict": sd, "model_name": "NISQA"}, tar)

    fused_dft_mel.LAUNCHES = 0
    t0 = time.perf_counter()
    runner = run_predict.main(["--mode", "predict_dir", "--pretrained_model", tar, "--data_dir",
                               corpus, "--output_dir", out_dir, "--bs", str(TTS_BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_dft_mel.LAUNCHES
    engine = runner.engine
    with open(os.path.join(out_dir, "NISQA_results.csv"), newline="") as f:
        table = list(csv.DictReader(f))
    check(len(table) == len(paths) == 18, f"NISQA_results.csv has {len(table)} rows for 18 files")
    check(list(table[0]) == ["deg", "mos_pred", "model"], f"columns {list(table[0])}")
    check([r["deg"] for r in table] == [os.path.basename(p) for p in paths], "row order")
    y_first = np.array([[float(r["mos_pred"])] for r in table])
    check(bool(np.isfinite(y_first).all()), "non-finite predictions in NISQA_results.csv")
    check(engine.precision == "highest" and engine.fe_precision == "exact",
          f"the TTS engine runs at {engine.precision!r} / {engine.fe_precision!r}, "
          "not 'highest' / 'exact' (the LSTM upgrade)")
    plan = engine.plan(paths)
    print(f"tts predict_dir: {len(table)} files, {len(plan)} batches "
          f"{[(g, len(c)) for g, c in plan]}, precision {engine.precision}, fused_dft_mel "
          f"launches={launches}; {audio_s:.1f} audio-s in {wall:.3f} s wall (checkpoint load "
          f"and first-call set-up included) = {audio_s / wall:.1f} audio-s/s on {card}", flush=True)
    check(launches == len(plan), f"fused_dft_mel launched {launches}x for {len(plan)} batches")

    # warm passes: cold (cache_mb=0) with the kernel and with the twin, and
    # cached passes of the CLI's engine, which holds the corpus's mels
    cold = InferenceEngine(runner.model, runner.ms, "cuda", batch_size=TTS_BATCH, cache_mb=0)
    twin = InferenceEngine(runner.model, runner.ms, "cuda", batch_size=TTS_BATCH, cache_mb=0,
                           dft_mel=dft_mel_reference)
    engines = {"cold": cold, "twin": twin, "cached": engine}
    for name in ("cold", "twin"):
        engines[name].predict_paths(paths)  # untimed: constant preparation, cuDNN set-up
    y, secs, launched = {}, {k: [] for k in engines}, {k: 0 for k in engines}
    for r in range(WARM_REPS):
        for name in list(engines)[:: 1 if r % 2 == 0 else -1]:
            before = fused_dft_mel.LAUNCHES
            t0 = time.perf_counter()
            y[name] = engines[name].predict_paths(paths)  # ends in a device readback
            secs[name].append(time.perf_counter() - t0)
            launched[name] += fused_dft_mel.LAUNCHES - before
    check(engine.stats["last"]["mode"] == "cached", f"CLI engine ran {engine.stats['last']['mode']}")
    check(launched == {"cold": WARM_REPS * len(plan), "twin": 0, "cached": 0},
          f"warm-pass launches {launched}")
    for name in engines:
        dt = float(np.median(secs[name]))
        print(f"tts warm pass {name}: {audio_s / dt:.1f} audio-s/s (median {dt:.4f} s of "
              f"{[round(t, 4) for t in secs[name]]}) on {card}", flush=True)
    for name in ("cold", "cached"):
        diff = float(np.abs(y[name] - y_first).max())
        print(f"tts {name} vs the CLI pass: max_abs_diff={diff} bound={SERVE_BOUND}", flush=True)
        check(diff <= SERVE_BOUND, f"tts {name} pass off by {diff} from the CLI pass")
    diff = float(np.abs(y["cold"] - y["twin"]).max())
    print(f"tts kernel vs twin front-end at 'highest': max_abs_diff={diff} bound={PASS_BOUND}",
          flush=True)
    check(diff <= PASS_BOUND, f"tts kernel and twin front-ends disagree by {diff}")

    for name in ("cold", "cached"):
        print(f"tts profiled {name} pass:", flush=True)
        busy, wall, idle, by_name = idle_share(lambda: engines[name].predict_paths(paths))
        if busy is None:
            print("  idle share not measured: the profiler recorded no device activity", flush=True)
            continue
        lstm_ms = sum(ms for k, ms in by_name.items() if "LSTM" in k or "RNN" in k)
        print(f"  idle share {idle:.4f} (device busy {busy:.4f} s of {wall:.4f} s); cuDNN LSTM "
              f"kernels {lstm_ms:.3f} ms = {lstm_ms / 1e3 / busy:.4f} of device busy time; "
              f"stats.last {json.dumps(engines[name].stats['last'])} on {card}", flush=True)
    return launches, runner.model


def lstm_takes_no_sync(model, card: str):
    """Phase 8: one forward of the TTS model over device inputs at the
    largest bucket under ``set_sync_debug_mode("error")`` (any synchronising
    call raises); the call returns while the device is still running it."""
    from nisqa_tpu_torch.data.pipeline import MsConfig, matmul_precision

    t = MsConfig(TTS_GEOMETRY).max_segments
    g = torch.Generator(device="cuda").manual_seed(0)
    segs = torch.randn((TTS_BATCH, t, 48, 15), device="cuda", generator=g) * 10 - 40
    n_wins = torch.tensor([t, t - 1, 4500, 3000, 1500, 750, 100, 1], device="cuda")
    with torch.inference_mode(), matmul_precision("highest"):
        model(segs, n_wins)  # warm: cuDNN set-up
    torch.cuda.synchronize()
    start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode(), matmul_precision("highest"):
            t0 = time.perf_counter()
            start.record()
            y = model(segs, n_wins)
            done.record()
            host_ms = 1e3 * (time.perf_counter() - t0)
            running = not done.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(done)
    print(f"no sync: TTS forward at T={t}, bs {TTS_BATCH} under sync debug mode 'error': host "
          f"returned after {host_ms:.3f} ms, device still running: {running}, device time "
          f"{device_ms:.3f} ms on {card}", flush=True)
    check(running, "the forward returned after the device finished: it synchronised")
    check(bool(torch.isfinite(y).all()) and y.shape == (TTS_BATCH, 1), "TTS forward output")


def csv_and_evaluate(tmp: str, tar: str, paths, y_dir, seed: int, card: str):
    """Phase 9: ``run_predict --mode predict_csv --bs 32`` over a labelled
    CSV of phase 5's corpus (rows shuffled), then ``NisqaTorch.evaluate``
    with a condition CSV. Returns {pass: kernel launches}."""
    from nisqa_tpu_torch import run_predict
    from nisqa_tpu_torch.model import NisqaTorch
    from nisqa_tpu_torch.ops.dft_mel import fused_dft_mel

    corpus = os.path.dirname(paths[0])
    rng = np.random.default_rng(seed)
    dims = ["mos", "noi", "dis", "col", "loud"]
    order = rng.permutation(len(paths))
    names = [os.path.basename(paths[i]) for i in order]
    dbs = ["db_a" if i % 2 else "db_b" for i in order]
    cons = [f"c{i // 2 % 6}" for i in order]  # every db holds all 6 conditions
    with open(os.path.join(corpus, "labels.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["filepath_deg", "db", "con", *dims])
        for row in zip(names, dbs, cons, *(rng.uniform(1, 5, len(paths)).round(2) for _ in dims)):
            w.writerow(row)
    with open(os.path.join(corpus, "labels_con.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["db", "con", *dims, *(f"{d}_ci" for d in dims)])
        for db in ("db_a", "db_b"):
            for c in range(6):
                w.writerow([db, f"c{c}", *rng.uniform(1, 5, 5).round(3), *rng.uniform(0.05, 0.3, 5)])

    launches = {}
    out_dir = os.path.join(tmp, "csv_out")
    os.makedirs(out_dir)
    fused_dft_mel.LAUNCHES = 0
    runner = run_predict.main(["--mode", "predict_csv", "--pretrained_model", tar, "--data_dir",
                               corpus, "--csv_file", "labels.csv", "--csv_deg", "filepath_deg",
                               "--output_dir", out_dir, "--bs", str(BATCH)])
    torch.cuda.synchronize()
    launches["predict_csv"] = fused_dft_mel.LAUNCHES
    n_batches = len(runner.engine.plan(runner.ds_val.paths()))
    with open(os.path.join(out_dir, "NISQA_results.csv"), newline="") as f:
        table = list(csv.DictReader(f))
    preds = [f"{d}_pred" for d in dims]
    check(list(table[0]) == ["filepath_deg", "db", "con", *dims, *preds, "model"],
          f"predict_csv columns {list(table[0])}")
    check([r["filepath_deg"] for r in table] == names, "predict_csv row order")
    check(launches["predict_csv"] == n_batches,
          f"predict_csv launched the kernel {launches['predict_csv']}x for {n_batches} batches")
    y_csv = np.array([[float(r[c]) for c in preds] for r in table])
    diff = float(np.abs(y_csv - y_dir[order]).max())
    print(f"predict_csv: {len(table)} rows in the CSV's order, {n_batches} batches, "
          f"fused_dft_mel launches={launches['predict_csv']}; max_abs_diff vs predict_dir="
          f"{diff} bound={SERVE_BOUND}", flush=True)
    check(diff <= SERVE_BOUND, f"predict_csv off by {diff} from predict_dir")

    fused_dft_mel.LAUNCHES = 0
    nisqa = NisqaTorch({"mode": "predict_csv", "pretrained_model": tar, "data_dir": corpus,
                        "output_dir": out_dir, "csv_file": "labels.csv", "csv_con": "labels_con.csv",
                        "csv_deg": "filepath_deg", "tr_bs_val": BATCH, "tr_num_workers": 8})
    nisqa.predict()
    nisqa.evaluate(mapping="first_order", do_print=True, do_plot=False)
    torch.cuda.synchronize()
    launches["predict_csv_evaluate"] = fused_dft_mel.LAUNCHES
    bad = {k: v for k, v in nisqa.r.items() if not np.isfinite(v)}
    print(f"evaluate: {len(nisqa.r)} metrics, r_p_mean_con={nisqa.r['r_p_mean_con']:.6f}, "
          f"rmse_all={nisqa.r['rmse_all']:.6f}; fused_dft_mel launches={launches['predict_csv_evaluate']}"
          f" on {card}", flush=True)
    check(len(nisqa.r) == 45 and not bad, f"evaluate gave non-finite metrics {bad}")
    check(launches["predict_csv_evaluate"] == n_batches, "evaluate run's kernel launches")
    check(float(np.abs(np.stack([nisqa.ds_val.df[c] for c in preds], 1) - y_csv).max()) <= SERVE_BOUND,
          "the evaluate run's predictions differ from the CLI's")
    return launches


def de_path(tmp: str, seed: int, card: str):
    """Phase 10: the trained NISQA_DE weights over the pair corpus through
    ``run_predict --mode predict_csv --bs 32``, warm cold passes with the
    kernel and the twin front-end, then the serving regimes. Returns
    {pass: kernel launches}."""
    from nisqa_tpu_torch import load_predictor, run_predict
    from nisqa_tpu_torch.data.pipeline import InferenceEngine
    from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference, fused_dft_mel

    corpus, out_dir = os.path.join(tmp, "de_wavs"), os.path.join(tmp, "de_out")
    os.makedirs(corpus)
    os.makedirs(out_dir)
    deg, ref, audio_s = write_de_corpus(corpus, seed)
    with open(os.path.join(corpus, "pairs.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["deg", "ref"])
        w.writerows(zip(deg, ref))
    paths = [os.path.join(corpus, d) for d in deg]
    paths_ref = [os.path.join(corpus, r) for r in ref]

    launches = {}
    fused_dft_mel.LAUNCHES = 0
    t0 = time.perf_counter()
    runner = run_predict.main(["--mode", "predict_csv", "--pretrained_model", DE_TAR,
                               "--csv_file", "pairs.csv", "--csv_deg", "deg", "--data_dir", corpus,
                               "--output_dir", out_dir, "--bs", str(BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["de_predict_csv"] = fused_dft_mel.LAUNCHES
    with open(os.path.join(out_dir, "NISQA_results.csv"), newline="") as f:
        table = list(csv.DictReader(f))
    check(runner.model.name == "NISQA_DE", f"the checkpoint built {runner.model.name}")
    check(len(table) == len(deg) and list(table[0]) == ["deg", "ref", "mos_pred", "model"],
          f"NISQA_results.csv: {len(table)} rows, columns {list(table[0])}")
    check([(r["deg"], r["ref"]) for r in table] == list(zip(deg, ref)), "row order")
    y_cli = np.array([[float(r["mos_pred"])] for r in table])
    check(bool(np.isfinite(y_cli).all()), "non-finite predictions in NISQA_results.csv")
    plan = runner.engine.plan(paths, paths_ref)
    print(f"de predict_csv: {len(table)} pairs, {len(plan)} batches "
          f"{[(g, len(c)) for g, c in plan]}, fused_dft_mel launches="
          f"{launches['de_predict_csv']}; {audio_s:.1f} degraded audio-s in {wall:.3f} s wall "
          f"(checkpoint load and first-call set-up included) = {audio_s / wall:.1f} audio-s/s "
          f"on {card}", flush=True)
    check(launches["de_predict_csv"] == 2 * len(plan),
          f"fused_dft_mel launched {launches['de_predict_csv']}x for {len(plan)} batches")
    check(any(kind == "f32" for (_, _, kind), _ in plan), "no pair took the f32 transport")

    # cold passes only (cache_mb=0), kernel and twin front-end, both precisions
    engines = {
        (precision, name): InferenceEngine(runner.model, runner.ms, "cuda", batch_size=BATCH,
                                           precision=precision, dft_mel=dft_mel, cache_mb=0)
        for precision in ("default", "highest")
        for name, dft_mel in (("kernel", fused_dft_mel), ("twin", dft_mel_reference))
    }
    for engine in engines.values():
        engine.predict_paths(paths, paths_ref)  # untimed: constant preparation, cuDNN set-up
    y, secs = {}, {key: [] for key in engines}
    for r in range(WARM_REPS):
        for key in list(engines)[:: 1 if r % 2 == 0 else -1]:
            t0 = time.perf_counter()
            y[key] = engines[key].predict_paths(paths, paths_ref)
            secs[key].append(time.perf_counter() - t0)
    for (precision, name), engine in engines.items():
        dt = float(np.median(secs[precision, name]))
        print(f"de warm cold pass precision={precision} fe={engine.fe_precision} "
              f"front-end={name}: {audio_s / dt:.1f} degraded audio-s/s (median {dt:.4f} s of "
              f"{[round(t, 4) for t in secs[precision, name]]}) on {card}", flush=True)
    diff = float(np.abs(y["highest", "kernel"] - y["highest", "twin"]).max())
    print(f"de kernel vs twin front-end at 'highest': max_abs_diff={diff} bound={PASS_BOUND}",
          flush=True)
    check(diff <= PASS_BOUND, f"de kernel and twin front-ends disagree by {diff} at 'highest'")
    gap = np.abs(y["default", "kernel"] - y["highest", "kernel"])
    print(f"de default vs 'highest' (kernel front-end): max_abs_diff={float(gap.max())}, "
          f"mean={float(gap.mean())} (a default-precision DE gap under 0.02 is not a fault)",
          flush=True)
    check(float(np.abs(y_cli - y["default", "kernel"]).max()) <= SERVE_BOUND,
          "the CLI pass differs from the warm default-precision cold passes")
    del engines, y

    # the regimes at "highest": at the default precision a fused part of
    # k*bs rows runs other TF32 kernels than its k batches of bs rows did,
    # and the hard alignment's argmax amplifies that beyond SERVE_BOUND
    for regime, n in serving(DE_TAR, paths, audio_s, card, paths_ref, "highest").items():
        launches[f"de_{regime}"] = n
    predict = load_predictor(DE_TAR, batch_size=BATCH, cache_mb=512)
    y_cold = predict(paths, paths_ref)
    secs = []
    for _ in range(WARM_REPS):
        t0 = time.perf_counter()
        y_cached = predict(paths, paths_ref)
        secs.append(time.perf_counter() - t0)
    dt = float(np.median(secs))
    print(f"de serving at 'default' cached (fused): {audio_s / dt:.1f} degraded audio-s/s "
          f"(median {dt:.4f} s of {[round(t, 4) for t in secs]}); max_abs_diff vs its cold pass "
          f"{float(np.abs(y_cached - y_cold).max())} (TF32, not bounded) on {card}", flush=True)
    return launches


def de_scorers(seed: int, card: str):
    """Phase 10, last part: each scorer x apply of the alignment in the
    trained DE architecture with random weights, once at the largest bucket
    (T 1,300) and bs 32 on ragged lengths, at the default precision: finite
    outputs, CUDA-event times of the forward and of the alignment alone,
    and the peak device memory of each (over what was allocated before)."""
    from nisqa_tpu_torch.compat.checkpoint import load_torch_checkpoint
    from nisqa_tpu_torch.compat.model_args import model_args_from_ckpt_args
    from nisqa_tpu_torch.data.pipeline import MsConfig, matmul_precision
    from nisqa_tpu_torch.models.nisqa import build_model

    args = load_torch_checkpoint(DE_TAR)["args"]
    ms = MsConfig(args)
    t = ms.max_segments
    g = torch.Generator(device="cuda").manual_seed(seed)
    deg, ref = (torch.randn((BATCH, t, ms.n_mels, ms.seg_length), device="cuda", generator=g)
                * 10 - 40 for _ in range(2))
    n_deg = torch.linspace(t, 1, BATCH, device="cuda").round().long()
    n_ref = n_deg.flip(0)

    def peak_gb(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 1e9

    for method in DE_SCORERS:
        for apply in ("hard", "soft"):
            torch.manual_seed(seed)
            model = build_model("NISQA_DE", model_args_from_ckpt_args(
                {**args, "de_align": method, "de_align_apply": apply})).cuda().eval()
            with torch.inference_mode(), matmul_precision("default"):
                y, fwd_gb = peak_gb(lambda: model.forward_ends(deg, n_deg, ref, n_ref))
                fd, fr = model.trunk_ends(deg, n_deg, ref, n_ref)
                _, align_gb = peak_gb(lambda: model.align(fd, fr, n_ref))
                fwd_ms = event_ms(lambda: model.forward_ends(deg, n_deg, ref, n_ref))
                align_ms = event_ms(lambda: model.align(fd, fr, n_ref), 3)
            print(f"de scorer {method}/{apply} at T={t}, bs {BATCH}: forward {fwd_ms:.3f} ms, "
                  f"peak {fwd_gb:.3f} GB; alignment {align_ms:.3f} ms, peak {align_gb:.3f} GB "
                  f"on {card}", flush=True)
            check(y.shape == (BATCH, 1) and bool(torch.isfinite(y).all()),
                  f"scorer {method}/{apply} gave {tuple(y.shape)} or non-finite values")
            del model, y, fd, fr
    del deg, ref
    torch.cuda.empty_cache()


def import_check():
    """The port loaded nothing of JAX or of the JAX package in this run, and
    importing it and all its submodules in a fresh process loads no jax,
    pandas, yaml, matplotlib or ``nisqa_tpu`` module (the card's machine has
    them all; ``eval/report.py`` imports matplotlib only to plot)."""
    banned = ("jax", "jaxlib", "nisqa_tpu")
    here = sorted(m for m in sys.modules if m.split(".")[0] in banned)
    check(not here, f"this run imported JAX code: {here[:10]}")
    code = ("import sys, importlib, pkgutil\n"
            "import nisqa_tpu_torch\n"
            "for m in pkgutil.walk_packages(nisqa_tpu_torch.__path__, 'nisqa_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'nisqa_tpu', 'pandas', 'yaml', 'matplotlib')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    check(r.returncode == 0, f"importing the port failed: {r.stderr[-2000:]}")
    check(r.stdout.strip() == "[]", f"importing the port loaded {r.stdout.strip()}")
    print("imports: no jax, jaxlib, nisqa_tpu, pandas, yaml or matplotlib module loaded by the port",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every generated input")
    ap.add_argument("--reps", type=int, default=5, help="timed repetitions per kernel case")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: chip_smoke.py runs on a CUDA card only")
    sys.path.insert(0, REPO)
    from nisqa_tpu_torch.ops import _build

    # 1. device
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"built {os.path.relpath(lib_path, REPO)} in {time.perf_counter() - t0:.2f} s", flush=True)
    with open(lib_path[: -len(".so")] + ".log") as f:
        print(f.read().strip(), flush=True)
    n_hgmma = hgmma_count(lib_path)
    print(f"SASS: {n_hgmma} HGMMA (wgmma) instructions", flush=True)
    check(n_hgmma > 0, "no HGMMA instruction in the kernel library: the tensor cores are unused")

    # 3-10
    results, main, tts = kernel_vs_twin(opts.seed, opts.reps, card)
    meta, sd = model_golden("g2_dim")
    meta_tts, sd_tts = model_golden("g3_tts")
    with tempfile.TemporaryDirectory(prefix="nisqa_smoke_") as tmp:
        tar, paths, audio_s = make_corpus(tmp, meta, sd, opts.seed)
        launches, y_dir = main_path(tar, paths, audio_s, card)
        serving_launches = serving(tar, paths, audio_s, card)
        tts_launches, tts_model = tts_path(tmp, meta_tts, sd_tts, opts.seed, card)
        lstm_takes_no_sync(tts_model, card)
        del tts_model
        csv_launches = csv_and_evaluate(tmp, tar, paths, y_dir, opts.seed, card)
        de_launches = de_path(tmp, opts.seed, card)
        de_scorers(opts.seed, card)
    import_check()

    fast, exact = main["fast"], main["exact"]
    record = {"kernels": [{
        "name": "fused_dft_mel",
        "route": "cuda",
        "source": "nisqa_tpu_torch/csrc/dft_mel.cu",
        "replaces": "nisqa_tpu/ops/pallas_mel.py:99",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": fast["kernel_ms"],
        "plain_ms": fast["twin_ms"],
        "bound_ms": fast["bound_ms"],
        "bound_by": fast["bound_by"],
        "library_ms": None,  # no one PyTorch call computes windowed DFT -> |.| -> mel
        "exact_ms": exact["kernel_ms"],
        "exact_plain_ms": exact["twin_ms"],
        "exact_bound_ms": exact["bound_ms"],
        "tts_shape": {k: tts["fast"][k] for k in ("sr", "N", "span", "K", "M")},
        "tts_ms": tts["fast"]["kernel_ms"],
        "tts_plain_ms": tts["fast"]["twin_ms"],
        "tts_bound_ms": tts["fast"]["bound_ms"],
        "tts_bound_by": tts["fast"]["bound_by"],
        "tts_exact_ms": tts["exact"]["kernel_ms"],
        "tts_exact_plain_ms": tts["exact"]["twin_ms"],
        "tts_exact_bound_ms": tts["exact"]["bound_ms"],
        "tts_exact_bound_by": tts["exact"]["bound_by"],
        "launches_by_pass": {"predict_dir": launches, **serving_launches,
                             "tts_predict_dir": tts_launches, **csv_launches, **de_launches},
    }]}
    print(card_line(), flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
