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
     N = 8 x 6,014 and a ragged 1,001), then 80 and 128 mel bands (two
     chunks of the kernel's 64-band tile) at the 48 and 16 kHz main shapes
     and 80 at N 43 (split K over two chunks), both front-end modes, with
     CUDA-event times, TFLOP/s and the bound of each, a bitwise repeat and
     the output's sha256 (frames seeded per case: ``--kernel-hashes``
     prints the hashes of the cases up to 64 bands alone, also for an
     older checkout's kernel);
  3b. the convolutions' eval epilogue (``--bn-pool`` runs it alone):
     ``bn_relu_adaptive_max_pool`` and ``bias_bn_relu``
     (``csrc/bn_relu_pool.cu``), given the convolution's bias, at AdaptCNN's
     pooled blocks (1, 2, 4) and blocks 3, 5 and 6 of a NISQA_DE batch (2 x
     32 rows at the bucket of 780 segments) and a NISQA_DIM one (32 rows),
     the 80-band first block, and odd shapes: bit-equal to its plain version
     on the card (the pooled kernel also to itself on the biased input),
     against the chain it replaces (ATen's bias ``add_``, cuDNN's batch norm,
     ReLU, ``F.adaptive_max_pool2d``): its largest difference and the
     outputs zero on one side only; CUDA-event times of the kernel, the
     chain and the plain version beside the bytes bound (x read and the
     output written once);
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
  11. training: ``python -m nisqa_tpu_torch.run_train --yaml`` (through its
     ``main``) on the shipped ``train_nisqa_cnn_sa_ap.yaml`` at full width:
     NISQA from scratch for 2 epochs at bs 32 over phase 5's corpus in a
     labelled CSV (52 files db TRAIN, the 16 kHz ones among them, 16 db VAL;
     MOS from each file's pitch) from the host fill: finite losses, one
     kernel launch per train step and per cold validation batch, both
     epochs' ``.tar`` files load with ``strict=True``, the final one served
     through ``run_predict`` gives the loop's last validation pass; per
     epoch train audio-s/s, step and validation times, peak memory; one
     train step's loss and gradients with the kernel and the twin front-end
     at "highest"; five more warm epochs (median train audio-s/s and step)
     and a profiled one (idle share). Then the device-resident
     corpus (``tr_ds_to_memory``): (a) the same run resident, whose only
     launches are the corpus build's 64-row chunks and the cold validation
     batch, with the resident MB per sample rate, the build time, the same
     epoch numbers and warm-epoch idle share beside the host fill's; (b) one
     unshuffled epoch at zero dropout from the same weights, resident and
     host-filled, within 1e-4 (loss, relative) and 1e-3 (predictions); the
     kernel alone at the build's shape (a 64-row chunk at 48 kHz, exact
     mode) against its twin; (c) partial residency: phase 10's 96 degraded
     48 kHz files under a budget of 80 rows (a 64-row head resident, the
     advisory, 3 steps an epoch, launches for the build and the tail steps
     only); then one epoch of the multidimensional finetune from phase 5's
     ``.tar``, and one of ``train_nisqa_double_ended.yaml`` on 32 of phase
     10's pairs from the host fill (two launches per step) and (d) resident
     (two per build chunk);
  12. data parallel: each launch a ``torchrun --standalone`` subprocess of
     this script (``--dp-worker``), killed whole on a timeout. (a) W = the
     card count (1 on one card; on several, held to the W = 2 bounds)
     over NCCL: ``run_train`` on the shipped
     ``train_nisqa_cnn_sa_ap.yaml`` at full width, bs 32, one epoch at zero
     dropout over phase 11's corpus, within 1e-6 (loss, parameters) of the
     same epoch in this process without a launcher, one launch per fill
     step and cold validation batch. (b) W = 2 on the one card over gloo:
     phase 5's corpus served by NISQA_DIM at "highest" and at the default
     precision and phase 10's pairs by NISQA_DE at "highest", within 1e-5
     of this process's passes, each rank launching the kernel for its own
     cold batches; the epoch of (a) from the host fill and resident (16
     rows a rank), within 1e-4 (loss, relative) and 1e-3 (train and
     validation predictions) of W = 1, parameters and BN buffers identical
     on both ranks. Each rank's wall time and a train step's collectives
     timed alone; the kernel at a W = 2 fill step's shape against its twin;
  13. imports (run last, after phases 14 to 16): nothing of jax or
     ``nisqa_tpu`` was loaded, and a fresh import of every port module, the
     tools (``nisqa_tpu_torch.tools.*``, ``tools.parity`` among them),
     ``graft_entry`` and ``features.segments`` included, loads no jax,
     pandas, yaml, tqdm, matplotlib or ``nisqa_tpu``;
  14. tools: each measurement tool's ``main`` (``nisqa_tpu_torch.tools``)
     on the card at a reduced size: ``bench`` over 96 files of its corpus
     with 3 fetched, 2 fetch-free and 2 blocks of 4 async passes,
     ``bench_tts`` over 4 files, ``bench_de`` over 32 pairs with the same
     passes, ``bench_train`` over 32 files for 2 epochs; each prints its
     JSON record on a line of its own. Finite fields, MFU in (0, 100], one
     kernel launch per cold batch and end and none in a cached pass, the
     cached passes within 1e-5 of the cold one (NISQA_DE at the default
     precision: 1e-2), ``bench_train``'s 2 launches (one build chunk, one
     cold validation batch); ``bench``'s front-end FLOPs at its largest
     batch equal phase 3's count of the DFT's products at that shape, where
     the kernel is held against its twin, plus the dense mel product;
  15. parity at corpus scale: ``nisqa_tpu_torch.tools.parity``'s ``main``
     over the full corpora (384 bench files and 32 TTS clips, completing
     phase 14's folders; 96 DE pairs written portably; 128 bench files at
     16 kHz), all eleven keys (``nisqa.tar@16k`` and the 80-band
     ``nisqa_dim80.tar`` among them),
     each key's predictions against ``nisqa_tpu``'s stored float32 ones
     (``tools/parity_ref.npz``): every key within its budget and within
     3 x its recorded MOS MAE + 2e-4 of the H100 baseline
     ``tools/parity_h100.json``, one kernel launch per cold batch and end;
     prints the record and its wall time. Then ``de_trained.tar::auto``'s
     distance from the float32 reference split by source: the bf16 DFT
     alone, TF32 in cuDNN alone, in cuBLAS alone, in both, and all of them
     (the key);
  16. the root entry points (``nisqa_tpu_torch.graft_entry``): (a)
     ``entry()`` on the card, its (4, 5) output at "highest" within 2e-4
     of the same weights on the CPU, the forward's median wall time over
     ``--reps`` runs at "highest" and at the default precision; (b)
     ``dryrun_multichip`` over W = 2 ranks (gloo on one card, NCCL on two
     or more) and, with more than two cards, over W = the card count
     (NCCL), each launch a ``torchrun`` subprocess killed whole after
     ``DP_TIMEOUT``: its three checks (a data-parallel train step of the
     full flagship model, a resident ``TrainEngine`` epoch, serving over
     the group against one process), each rank launching the CUDA kernel
     once per cold batch it owns; (c) the kernel against its twin at the
     dry run's shape (8 kHz, 24 mels, n_fft 512: one cold batch of W = 2
     rows), exact mode;
  17. 80 mel bands (run after phase 15): a seeded NISQA_DIM at the yaml
     geometry with ``ms_n_mels`` 80 (``g2_dim``'s weights perturbed from
     seed 80) over phase 5's corpus through ``load_predictor``: phase 6's
     regimes at "highest" (every regime within 1e-5 of the cold pass, one
     launch per cold batch), cold passes at "highest" and at the default
     precision within 1e-3 and 1e-2 of the same model on the CPU (the 4
     16 kHz files and 12 of the 48 kHz ones), ``run_predict --mode
     predict_dir`` within 1e-5 of the default-precision pass; the trained
     NISQA_DE weights at 80 mels over phase 10's pairs at "highest" (two
     launches per cold batch, within 1e-3 of the CPU on 4 pairs); then one
     epoch of ``train_nisqa_cnn_sa_ap.yaml`` at 80 mels from the host fill
     (one launch per train step) and resident (one per build chunk), plus
     one per cold validation batch.

The last two lines are a JSON record of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import hashlib
import io
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

# the released models' front-ends: the yaml geometry and the NISQA-TTS checkpoint's
from nisqa_tpu_torch.tools.corpus import TTS_GEOMETRY, YAML_GEOMETRY, golden_tar, load_golden

REPO = os.path.dirname(os.path.abspath(__file__))
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
TRAIN_LOSS_BOUND, TRAIN_GRAD_BOUND = 1e-4, 1e-3  # train step, kernel vs twin front-end
# H100 SXM data sheet, dense: tensor cores in bf16 and TF32, float32 outside them, HBM
BF16_PEAK, TF32_PEAK, FP32_PEAK, HBM_RATE = 989e12, 495e12, 67e12, 3.35e12
DP_TIMEOUT = 300                      # s, one torchrun launch of phase 12


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


def case_inputs(g_ms, sr: int, n: int, rng):
    """The constants of ``g_ms``'s front-end at ``sr`` and ``n`` seeded
    PCM16-valued float32 frame rows, on the card."""
    from nisqa_tpu_torch.data.pipeline import front_end_consts

    c = {k: torch.from_numpy(v).cuda() for k, v in front_end_consts(g_ms, sr, "i16").items()}
    frames = np.clip(np.round(rng.standard_normal((n, c["w_re"].shape[0])) * 3000), -32768, 32767)
    return c, torch.from_numpy(frames.astype(np.float32)).cuda()


def out_sha256(out) -> str:
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def kernel_case(geometry: str, g_ms, sr: int, n: int, modes, reps: int, rng, card: str):
    """``fused_dft_mel`` against ``dft_mel_reference`` on the card at ``n``
    frame rows of ``sr`` under ``g_ms``'s front-end, in each of ``modes``
    ("exact", "fast"): the error, a bitwise repeat, the output's sha256,
    CUDA-event times of both (median of ``reps``, kernel and twin in turns)
    and the bound. Returns the rows of results."""
    from nisqa_tpu_torch.data.pipeline import matmul_precision
    from nisqa_tpu_torch.ops.dft_mel import (MEL_CHUNK, dft_mel_reference, fused_dft_mel,
                                             plan_grid, prepare_consts)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    c, frames = case_inputs(g_ms, sr, n, rng)
    span, k = c["w_re"].shape
    m = c["fb_t"].shape[1]
    # the work the function needs: the DFT's re and im products over the K
    # kept bins once, and the mel step over each 64-bin tile's band
    # [m_lo, m_hi) only (fb is zero elsewhere; tiles with an empty band have
    # none). Over 64 bands the chunked plan clips each band to its chunk,
    # so its band-rows are the same; the DFT tiles a chunk re-runs are the
    # kernel's cost, not the function's
    kc = prepare_consts(c["w_re"], c["w_im"], c["fb_t"], True)
    n_tiles, rows = len(kc["tiles"]), kc["chunk_tiles"].cpu()
    chunks = len(kc["chunk_start"]) - 1
    dft_flop = 4 * n * span * k
    mel_flop = 2 * n * 64 * int((rows[:, 2] - rows[:, 1]).sum())
    flop = dft_flop + mel_flop
    iters = 1 if n >= 10_000 else 20
    results = []
    for mode in modes:
        bf16, bound = mode == "fast", FAST_BOUND if mode == "fast" else EXACT_BOUND
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
            sha = out_sha256(out)
            del out, again, ref
            k_ms, t_ms = [], []
            for _ in range(reps):  # alternate kernel and twin
                k_ms.append(event_ms(lambda: fused_dft_mel(*args, bf16=bf16), iters))
                t_ms.append(event_ms(lambda: dft_mel_reference(*args, bf16=bf16), iters))
        kernel_ms, twin_ms = float(np.median(k_ms)), float(np.median(t_ms))
        # least time for the same work: the DFT's products on the tensor
        # cores (3 TF32 products per exact one) and the float32 mel step at
        # the float32 rate, or each input read and the output written once
        # at the HBM rate, whichever is longer
        ops_s = (dft_flop / BF16_PEAK if bf16 else 3 * dft_flop / TF32_PEAK) + mel_flop / FP32_PEAK
        io_bytes = n * span * (2 if bf16 else 4) + (2 * span * k + k * m + n * m) * 4
        bound_ms = 1e3 * max(ops_s, io_bytes / HBM_RATE)
        row_tiles, splits, _ = plan_grid(n, n_tiles, sms, chunks)
        row = {"geometry": geometry, "sr": sr, "N": n, "span": span, "K": k, "M": m, "mode": mode,
               "mel_chunks": chunks, "tiles": n_tiles, "tile_runs": len(rows),
               "grid": [row_tiles * chunks, splits], "max_abs_err": abs_err, "rel_err": rel_err,
               "bound": bound, "repeat_bitwise_equal": repeat_equal, "sha256": sha,
               "operations": flop, "dft_operations": dft_flop,
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
    return results


def kernel_cases():
    """Phase 3's (geometry, MsConfig, sr, N): the main path's shapes, then
    44.1 kHz (a 882-sample span whose rows the wrapper re-pads to the
    16-byte stride the TMA wants), the TTS path's K = 768 at its largest
    bucket and at a ragged N that splits K; then 80 and 128 mel bands (two
    chunks of the kernel's 64-band tile) at the 48 and 16 kHz main shapes,
    and at N 43 (split K over two chunks)."""
    from nisqa_tpu_torch.data.pipeline import MsConfig

    ms, tts = MsConfig(YAML_GEOMETRY), MsConfig(TTS_GEOMETRY)
    n_main = BATCH * ms.frames_for_bucket(ms.max_segments)  # 32 x 5,211 = 166,752
    n_small = BATCH * ms.frames_for_bucket(ms.buckets()[0])  # 32 x 663 = 21,216
    n_tts = TTS_BATCH * tts.frames_for_bucket(tts.max_segments)  # 8 x 6,014 = 48,112
    cases = [("yaml", ms, 48000, n_main), ("yaml", ms, 48000, n_small), ("yaml", ms, 48000, 43),
             ("yaml", ms, 16000, n_main), ("yaml", ms, 44100, 4000),
             ("tts", tts, 48000, n_tts), ("tts", tts, 48000, 1001)]
    for m in (80, 128):
        g = MsConfig({**YAML_GEOMETRY, "ms_n_mels": m})
        cases += [(f"yaml m{m}", g, 48000, n_main), (f"yaml m{m}", g, 16000, n_main)]
    cases.append(("yaml m80", MsConfig({**YAML_GEOMETRY, "ms_n_mels": 80}), 48000, 43))
    return cases


def case_rng(seed: int, sr: int, n: int, m: int):
    """Phase 3's frames of one case: the same for every run and checkout."""
    return np.random.default_rng([seed, sr, n, m])


def kernel_vs_twin(seed: int, reps: int, card: str):
    """Phase 3. Returns (rows of results, the main shape's row by mode, the
    TTS shape's row by mode, the 80- and 128-band main shapes' rows by
    (M, sr, mode))."""
    results = []
    for geometry, g_ms, sr, n in kernel_cases():
        results += kernel_case(geometry, g_ms, sr, n, ("exact", "fast"), reps,
                               case_rng(seed, sr, n, g_ms.n_mels), card)
    n_main = max(r["N"] for r in results)
    main = {r["mode"]: r for r in results if r["sr"] == 48000 and r["N"] == n_main and r["M"] == 48}
    tts_main = {r["mode"]: r for r in results if r["geometry"] == "tts" and r["N"] > 10_000}
    wide = {(r["M"], r["sr"], r["mode"]): r for r in results if r["M"] > 64 and r["N"] == n_main}
    return results, main, tts_main, wide


def kernel_hashes(seed: int, reps: int) -> dict:
    """{case: {"sha256": of ``fused_dft_mel``'s output, "ms": its median
    CUDA-event time over ``reps``}} at phase 3's shapes of up to 64 mel
    bands, both modes, on phase 3's inputs. It calls only what every
    version of the port has (``front_end_consts``, ``fused_dft_mel``), so
    the same script can hash and time an older checkout's kernel: ``python
    -c 'import runpy, sys; sys.path.insert(0, "OLD"); sys.argv[1:] =
    ["--kernel-hashes"]; runpy.run_path("chip_smoke.py", run_name="__main__")'``."""
    from nisqa_tpu_torch.ops.dft_mel import fused_dft_mel

    out = {}
    for geometry, g_ms, sr, n in kernel_cases():
        if g_ms.n_mels > 64:
            continue
        c, frames = case_inputs(g_ms, sr, n, case_rng(seed, sr, n, g_ms.n_mels))
        for mode in ("exact", "fast"):
            bf16 = mode == "fast"
            args = (frames.to(torch.bfloat16) if bf16 else frames, c["w_re"], c["w_im"], c["fb_t"])
            sha = out_sha256(fused_dft_mel(*args, bf16=bf16))
            iters = 1 if n >= 10_000 else 20
            ms = [event_ms(lambda: fused_dft_mel(*args, bf16=bf16), iters) for _ in range(reps)]
            out[f"{geometry} {sr} Hz N {n} M {g_ms.n_mels} {mode}"] = {
                "sha256": sha, "ms": float(np.median(ms))}
    return out


def bn_pool_cases():
    """Phase 3b's (label, N, C, H, W, oh, ow): AdaptCNN's blocks at bs 32 and
    the bucket of 780 segments, both ends of a NISQA_DE batch (2 x 32 rows)
    and a NISQA_DIM batch; the pooled blocks (1, 2, 4), then blocks 3, 5 and
    6 (oh, ow None: no pool); the first block at 80 bands (overlapping bins);
    odd shapes (4-byte copies, a ragged last tile)."""
    blocks = [("block1", 16, 48, 15, 24, 7), ("block2", 32, 24, 7, 12, 5),
              ("block4", 64, 12, 5, 6, 3), ("block3", 64, 12, 5, None, None),
              ("block5", 64, 6, 3, None, None), ("block6", 64, 6, 1, None, None)]
    cases = [(f"{model} {name}", rows * 780, c, h, w, oh, ow)
             for model, rows in (("de", 2 * BATCH), ("dim", BATCH))
             for name, c, h, w, oh, ow in blocks]
    cases += [("dim block1 m80", BATCH * 780, 16, 80, 15, 24, 7),
              ("odd 7x9", 1001, 5, 7, 9, 3, 4), ("odd 13x11", 333, 3, 13, 11, 6, 4),
              ("odd 7x9 flat", 1001, 5, 7, 9, None, None)]
    return cases


def bn_pool_phase(seed: int, reps: int, card: str):
    """Phase 3b: rows of results, one per ``bn_pool_cases`` case. Each
    kernel takes the convolution's bias, as AdaptCNN's eval blocks give it;
    the chain is what it replaces: ATen's bias ``add_``, cuDNN's batch norm,
    ReLU (and ``F.adaptive_max_pool2d``)."""
    from nisqa_tpu_torch.ops.bn_relu_pool import (bias_bn_relu, bias_bn_relu_reference,
                                                  bn_relu_adaptive_max_pool,
                                                  bn_relu_adaptive_max_pool_reference)

    rows = []
    for label, n, c, h, w, oh, ow in bn_pool_cases():
        gen = torch.Generator("cuda").manual_seed(seed)
        x = torch.randn((n, c, h, w), generator=gen, device="cuda") * 2
        mean, bias, conv_bias = (torch.randn(c, generator=gen, device="cuda") * 0.5
                                 for _ in range(3))
        var = torch.rand(c, generator=gen, device="cuda") * 2 + 0.01
        weight = torch.randn(c, generator=gen, device="cuda")
        params, hw, pooled = (conv_bias, mean, var, weight, bias), (oh, ow), oh is not None
        if pooled:
            op = bn_relu_adaptive_max_pool

            def kernel():
                return bn_relu_adaptive_max_pool(x, *params, 1e-5, hw)

            def plain():
                return bn_relu_adaptive_max_pool_reference(x, *params, 1e-5, hw)
        else:
            op = bias_bn_relu

            def kernel():
                return bias_bn_relu(x, *params, 1e-5)

            def plain():
                return bias_bn_relu_reference(x, *params, 1e-5)

        def chain():
            y = x + conv_bias[:, None, None]
            y = torch.relu(torch.nn.functional.batch_norm(y, mean, var, weight, bias, False, 0.0,
                                                          1e-5))
            return torch.nn.functional.adaptive_max_pool2d(y, hw) if pooled else y

        before = op.LAUNCHES
        got, ref, lib = kernel(), plain(), chain()
        torch.cuda.synchronize()
        check(op.LAUNCHES == before + 1, f"{label}: no launch counted")
        err = float((got - lib).abs().max())
        row = {"case": label, "op": op.__name__, "x": [n, c, h, w], "out": [oh, ow],
               "equal_plain": bool(torch.equal(got, ref)),
               "zero_one_side_chain": int(((got == 0) != (lib == 0)).sum()),
               "max_abs_err_chain": err, "max_rel_err_chain": err / float(lib.abs().max()),
               "repeat_bitwise_equal": bool(torch.equal(got, kernel()))}
        del ref, lib
        if pooled:  # the parent's form: the bias added to x, then the same kernel with none
            row["equal_parent_form"] = bool(torch.equal(got, bn_relu_adaptive_max_pool(
                x + conv_bias[:, None, None], torch.zeros_like(conv_bias), *params[1:], 1e-5,
                hw)))
        del got
        # enough launches a timing that the queue runs ahead of the host's dispatch;
        # each function's timings in a row after one call, so that its outputs'
        # memory is in the allocator's cache and no timing waits for cudaMalloc
        iters = 10 if n * c * h * w >= 10_000_000 else 50
        for key, fn in (("kernel_ms", kernel), ("chain_ms", chain), ("plain_ms", plain)):
            fn()
            row[key] = float(np.median([event_ms(fn, iters) for _ in range(reps)]))
        out_floats = n * c * (oh * ow if pooled else h * w)
        io_bytes = 4 * (n * c * h * w + out_floats + 5 * c)
        row.update(bound_ms=1e3 * io_bytes / HBM_RATE, bound_by="bytes")
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        print("bn_pool " + json.dumps(row) + f" card: {card}", flush=True)
        check(row["equal_plain"] and row["repeat_bitwise_equal"]
              and row.get("equal_parent_form", True),
              f"{op.__name__} differs from its plain version or the parent's form on the card: "
              f"{row}")
        rows.append(row)
        del x, params
        torch.cuda.empty_cache()
    return rows


def model_golden(name: str):
    """Phase 4: released weights (a golden's ``sd::*``) vs the torch golden
    on the card."""
    from nisqa_tpu_torch.data.pipeline import matmul_precision
    from nisqa_tpu_torch.models.nisqa import build_model

    z = np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npz"), allow_pickle=False)
    meta, sd = load_golden(name)
    model = build_model(meta["model"], meta["model_args"])
    model.load_state_dict(sd, strict=True)
    model = model.cuda().eval()
    with torch.inference_mode(), matmul_precision("highest"):
        y = model(torch.from_numpy(z["x"][:, :, 0]).cuda(), torch.from_numpy(z["n_wins"]).cuda())
    err = float(np.abs(y.cpu().numpy() - z["y"]).max())
    print(f"model {name} ({meta['model']}) vs torch golden at 'highest': max_abs_err={err} "
          f"bound={GOLDEN_BOUND}", flush=True)
    check(y.shape == z["y"].shape and err <= GOLDEN_BOUND, f"{name} golden off by {err}")


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


def make_de_corpus(corpus: str, seed: int):
    """The pair corpus in ``corpus`` with ``pairs.csv`` (deg, ref).
    Returns (deg names, ref names, degraded audio-s)."""
    os.makedirs(corpus)
    deg, ref, audio_s = write_de_corpus(corpus, seed)
    with open(os.path.join(corpus, "pairs.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["deg", "ref"])
        w.writerows(zip(deg, ref))
    return deg, ref, audio_s


def make_corpus(tmp: str, seed: int):
    """The seeded corpus and a reference-format ``.tar`` of the released
    NISQA_DIM weights with the yaml geometry. Returns (tar, paths, audio-s)."""
    corpus = os.path.join(tmp, "wavs")
    os.makedirs(corpus)
    audio_s = write_corpus(corpus, seed)
    tar = golden_tar("g2_dim", YAML_GEOMETRY, os.path.join(tmp, "nisqa_dim.tar"))
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


def serving(tar: str, paths, audio_s: float, card: str, paths_ref=None, precision=None,
            label=None):
    """Phase 6 (and phase 10's regimes, with ``paths_ref``; phase 17's, with
    ``label``): the serving engine through ``load_predictor`` at bs 32, at
    ``precision`` (None: the engine's default). Each cold batch launches
    the kernel once per end. Returns {regime: kernel launches in its pass}."""
    import nisqa_tpu_torch
    from nisqa_tpu_torch.ops.dft_mel import fused_dft_mel
    from nisqa_tpu_torch.tools.measure import idle_share

    label = label or ("serving" if paths_ref is None else f"de serving at {precision!r}")
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


def tts_path(tmp: str, seed: int, card: str):
    """Phase 7: the released NISQA-TTS weights at their checkpoint geometry
    through ``run_predict --mode predict_dir --bs 8``, then warm cold and
    cached passes. Returns (the kernel's launches in the CLI run, the
    runner's model)."""
    from nisqa_tpu_torch import run_predict
    from nisqa_tpu_torch.data.pipeline import InferenceEngine
    from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference, fused_dft_mel
    from nisqa_tpu_torch.tools.measure import idle_share

    corpus, out_dir = os.path.join(tmp, "tts_wavs"), os.path.join(tmp, "tts_out")
    os.makedirs(corpus)
    os.makedirs(out_dir)
    audio_s = write_tts_corpus(corpus, seed)
    paths = sorted(os.path.join(corpus, f) for f in os.listdir(corpus))
    tar = golden_tar("g3_tts", TTS_GEOMETRY, os.path.join(tmp, "nisqa_tts.tar"), "NISQA_TTS")

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
    os.makedirs(out_dir)
    deg, ref, audio_s = make_de_corpus(corpus, seed)
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


def write_train_csv(paths):
    """``train.csv`` beside phase 5's corpus: every 4th 48 kHz file is db
    VAL, the rest (the 16 kHz files among them) db TRAIN; MOS from each
    file's pitch, the dimensions MOS plus seeded noise."""
    from nisqa_tpu_torch.tools.corpus import learnable_mos

    mos = learnable_mos(paths)
    rng = np.random.default_rng(1)
    names = [os.path.basename(p) for p in paths]
    dbs = ["VAL" if "_48k_" in n and i % 4 == 3 else "TRAIN" for i, n in enumerate(names)]
    with open(os.path.join(os.path.dirname(paths[0]), "train.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["filepath_deg", "db", "mos", "noi", "dis", "col", "loud"])
        for n, db, m in zip(names, dbs, mos):
            w.writerow([n, db, m, *np.round(np.clip(m + rng.normal(0, 0.3, 4), 1, 5), 2)])


def train_config(name: str, corpus: str, out_dir: str, csv_file: str, **over) -> str:
    """A shipped training YAML with the run's corpus, output and overrides;
    returns the path of the written YAML."""
    from nisqa_tpu_torch.compat import yaml_lite

    cfg = yaml_lite.load(os.path.join(REPO, "nisqa_tpu", "config", name))
    cfg.update({"name": name[: -len(".yaml")], "data_dir": corpus, "output_dir": out_dir,
                "csv_file": csv_file, "csv_db_train": ["TRAIN"], "csv_db_val": ["VAL"],
                "tr_bs": BATCH, "tr_bs_val": BATCH, "seed": 0, **over})
    path = os.path.join(out_dir, name)
    yaml_lite.dump(cfg, path)
    return path


def run_training(cfg_path: str, label: str, card: str):
    """``run_train.main`` on ``cfg_path`` with the kernel's count zeroed just
    before and read just after. Returns (runner, launches, results rows,
    run directory, wall s)."""
    from nisqa_tpu_torch import run_train
    from nisqa_tpu_torch.ops.dft_mel import fused_dft_mel

    out_dir = os.path.dirname(cfg_path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_dft_mel.LAUNCHES = 0
    t0 = time.perf_counter()
    runner = run_train.main(["--yaml", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_dft_mel.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run_dir = next(os.path.join(out_dir, d) for d in os.listdir(out_dir)
                   if os.path.isdir(os.path.join(out_dir, d)))
    with open(os.path.join(run_dir, os.path.basename(run_dir) + "__results.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    print(f"{label}: {len(rows)} epochs in {wall:.3f} s wall (set-up included), losses {losses}, "
          f"{runner.train_engine.steps} train steps, fused_dft_mel launches={launches}, peak "
          f"device memory {peak_gb:.3f} GB on {card}", flush=True)
    check(len(rows) == runner.args["tr_epochs"] and all(math.isfinite(v) for v in losses),
          f"{label}: results rows {len(rows)}, losses {losses}")
    return runner, launches, rows, run_dir, wall


def check_tars(run_dir: str, n: int, label: str):
    """Every epoch's .tar loads into the port with strict=True, beside its .pt."""
    from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar

    tars = sorted(f for f in os.listdir(run_dir) if f.endswith(".tar"))
    check(len(tars) == n, f"{label}: {len(tars)} .tar files for {n} epochs")
    for t in tars:
        load_model_from_tar(os.path.join(run_dir, t), "cuda")  # strict=True
        check(os.path.exists(os.path.join(run_dir, t[: -len(".tar")] + ".pt")),
              f"{label}: no full-state .pt beside {t}")
    return os.path.join(run_dir, tars[-1])


def train_step_kernel_vs_twin(runner, card: str):
    """One train step's loss and gradients from the same weights and batch
    (32 files at 48 kHz), with the kernel front-end and with the twin, at
    "highest"; the weights and BN statistics are restored after."""
    from nisqa_tpu_torch.data.pipeline import matmul_precision
    from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference, fused_dft_mel
    from nisqa_tpu_torch.train.loop import _bias_losses

    eng, model, ds = runner.train_engine, runner.model, runner.ds_train
    paths = ds.paths()
    entries = eng._entries(paths)
    idx = [i for i, e in enumerate(entries) if e[2] == 48000][:BATCH]
    kind = "i16" if all(entries[i][0] == "native" for i in idx) else "f32"
    bias = _bias_losses(runner, 1)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}

    def step(dft_mel):
        model.load_state_dict(sd0)
        model.train()
        eng.dft_mel = dft_mel
        eng.generator.manual_seed(0)  # the same dropout masks
        segs = eng._batch(idx, paths, None, entries, None, BATCH, kind)
        y, b = eng._targets(idx, ds.targets(), bias)
        with matmul_precision("highest"):
            loss, _ = eng._loss(segs, y, b)
            model.zero_grad(set_to_none=True)
            loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    try:
        loss_k, g_k = step(fused_dft_mel)
        loss_t, g_t = step(dft_mel_reference)
    finally:
        eng.dft_mel = fused_dft_mel
        model.load_state_dict(sd0)
        model.zero_grad(set_to_none=True)
    rel = abs(loss_k - loss_t) / abs(loss_t)
    worst = max((float((g_k[k] - g_t[k]).abs().max()) / max(1.0, float(g_t[k].abs().max())), k)
                for k in g_t)
    print(f"train step kernel vs twin front-end at 'highest' ({len(idx)} files, {kind}): loss "
          f"{loss_k} vs {loss_t}, rel {rel:.3e} (bound {TRAIN_LOSS_BOUND}); worst gradient "
          f"{worst[1]} {worst[0]:.3e} of max(1, max|twin|) (bound {TRAIN_GRAD_BOUND}) on {card}",
          flush=True)
    check(rel <= TRAIN_LOSS_BOUND, f"train-step loss: kernel vs twin rel {rel}")
    check(worst[0] <= TRAIN_GRAD_BOUND, f"train-step gradient {worst[1]} off by {worst[0]}")


def epoch_report(runner, rows, label: str, card: str):
    """Prints each epoch of a training run (train audio-s/s over
    ``run_epoch``'s wall, mean step, validation, loss; the corpus build) and
    returns the train audio-s of the run's train set."""
    from nisqa_tpu_torch.data.fill import n_samples

    eng = runner.train_engine
    train_audio_s = sum(n_samples(e) / e[2] for e in eng._entries(runner.ds_train.paths()))
    for h, row in zip(eng.history, rows):
        build = "" if h["build_s"] is None else f"; corpus build {h['build_s']:.4f} s of it"
        print(f"{label} epoch {h['epoch'] + 1}: {h['files']} files, {train_audio_s:.1f} audio-s in "
              f"{h['wall_s']:.4f} s = {train_audio_s / h['wall_s']:.1f} train audio-s/s{build}; "
              f"{h['steps']} steps, mean step {1e3 * h['wall_s'] / h['steps']:.2f} ms; validation "
              f"pass {h['val_s']:.4f} s ({len(runner.ds_val)} files); epoch wall "
              f"{row['ep_runtime']} s; loss {row['loss']} on {card}", flush=True)
    return train_audio_s


def warm_epochs(runner, train_audio_s: float, label: str, card: str):
    """``WARM_REPS`` more (warm) epochs of the run's engine, timed on the
    host clock (each ends in the epoch's readback), then one profiled for
    the device's idle share. Returns {audio_s_per_s, step_ms (medians),
    idle (None when the profiler records no device activity)}."""
    from nisqa_tpu_torch.tools.measure import idle_share
    from nisqa_tpu_torch.train.loop import _bias_losses

    eng = runner.train_engine
    bias = _bias_losses(runner, 5 if runner.args["dim"] else 1)
    lr = runner.args["tr_lr"]
    secs = []
    for _ in range(WARM_REPS):
        t0 = time.perf_counter()
        eng.run_epoch(runner.ds_train, bias, lr, len(eng.history), BATCH)
        secs.append(time.perf_counter() - t0)
    busy, wall, idle, _ = idle_share(
        lambda: eng.run_epoch(runner.ds_train, bias, lr, len(eng.history), BATCH))
    dt = float(np.median(secs))
    out = {"audio_s_per_s": train_audio_s / dt, "step_ms": 1e3 * dt / eng.history[-1]["steps"],
           "idle": idle}
    idle_txt = ("not measured (no device activity in the trace)" if idle is None else
                f"{idle:.4f} (device busy {busy:.4f} s of {wall:.4f} s, torch.profiler)")
    print(f"{label} {WARM_REPS} warm epochs: {out['audio_s_per_s']:.1f} train audio-s/s, mean step "
          f"{out['step_ms']:.2f} ms (median {dt:.4f} s of {[round(t, 4) for t in secs]}); one more, "
          f"profiled: idle share {idle_txt} on {card}", flush=True)
    return out


def corpus_report(eng, label: str, card: str):
    """Prints the resident groups of a train engine's device corpus; returns
    the number of 64-row chunks its build ran per end."""
    from nisqa_tpu_torch.train.loop import CHUNK

    chunks = 0
    for sr, c in sorted(eng._corpus.items()):
        mb = sum(c[k].numel() * c[k].element_size() for k in ("mel", "mel_ref") if k in c) / 2 ** 20
        chunks += c["mel"].shape[0] // CHUNK
        print(f"{label} device corpus sr {sr}: {len(c['local'])} files resident in "
              f"{c['mel'].shape[0]} rows x {tuple(c['mel'].shape[1:])} at bucket {c['bucket']} "
              f"({c['kind']} transport{', both ends' if 'mel_ref' in c else ''}), {mb:.3f} MB "
              f"on {card}", flush=True)
    return chunks


def train_runner(cfg_path: str, **over):
    """A ``NisqaTorch`` in mode main on ``cfg_path``'s args and ``over``, as
    ``run_train`` builds it (its fresh model drawn from the args' seed)."""
    from nisqa_tpu_torch import run_train
    from nisqa_tpu_torch.model import NisqaTorch

    return NisqaTorch({**run_train.parse_args(["--yaml", cfg_path]), **over})


def resident_vs_host_fill(cfg_path: str, card: str):
    """One unshuffled epoch from the same initial weights at zero dropout
    and "highest", from the device corpus and from the host fill: the loss
    within TRAIN_LOSS_BOUND relative, the train-mode predictions within
    PASS_BOUND."""
    from nisqa_tpu_torch.train.loop import TrainEngine, _bias_losses

    no_drop = {"cnn_dropout": 0.0, "td_sa_dropout": 0.0, "pool_att_dropout": 0.0,
               "td_2_sa_dropout": 0.0, "tr_verbose": 0}
    out = {}
    for mem in (True, False):
        runner = train_runner(cfg_path, tr_ds_to_memory=mem, **no_drop)
        eng = TrainEngine(runner)
        out[mem] = eng.run_epoch(runner.ds_train, _bias_losses(runner, 1), runner.args["tr_lr"], 0,
                                 BATCH, shuffle=False)
        check(bool(eng._corpus) == mem, f"tr_ds_to_memory={mem}: corpus {bool(eng._corpus)}")
        del runner, eng
    (loss_r, y_r), (loss_h, y_h) = out[True], out[False]
    rel, diff = abs(loss_r - loss_h) / abs(loss_h), float(np.abs(y_r - y_h).max())
    print(f"train NISQA resident vs host fill, one unshuffled epoch at zero dropout, 'highest': "
          f"loss {loss_r} vs {loss_h}, rel {rel:.3e} (bound {TRAIN_LOSS_BOUND}); train-mode "
          f"predictions max_abs_diff {diff:.3e} (bound {PASS_BOUND}) on {card}", flush=True)
    check(rel <= TRAIN_LOSS_BOUND, f"resident vs host fill: loss rel {rel}")
    check(bool(np.isfinite(y_r).all()) and diff <= PASS_BOUND,
          f"resident vs host fill: predictions off by {diff}")
    torch.cuda.empty_cache()


def training(tmp: str, dim_tar: str, paths, reps: int, card: str):
    """Phase 11: training through ``python -m nisqa_tpu_torch.run_train``'s
    ``main``, from the host fill and from the device-resident corpus.
    Returns ({run: kernel launches}, the corpus build's kernel rows)."""
    from nisqa_tpu_torch import run_predict
    from nisqa_tpu_torch.data.pipeline import MsConfig
    from nisqa_tpu_torch.tools.corpus import learnable_mos
    from nisqa_tpu_torch.train.loop import CHUNK

    corpus = os.path.dirname(paths[0])
    launches = {}
    write_train_csv(paths)

    # the main path: NISQA from scratch, full width, 2 epochs at bs 32, host fill
    out = os.path.join(tmp, "train_nisqa")
    os.makedirs(out)
    cfg = train_config("train_nisqa_cnn_sa_ap.yaml", corpus, out, "train.csv",
                       csv_deg="filepath_deg", tr_epochs=2)
    label = "train NISQA host fill"
    runner, launches["train_nisqa_2_epochs"], rows, run_dir, _ = run_training(
        cfg, f"{label} (train_nisqa_cnn_sa_ap.yaml, full width, bs 32)", card)
    eng = runner.train_engine
    host_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    val_paths = runner.ds_val.paths()
    n_val = len(runner.engine.plan(val_paths))
    check(runner.engine.stats["last"]["mode"] == "cached",
          f"the second validation pass ran {runner.engine.stats['last']['mode']}")
    check(launches["train_nisqa_2_epochs"] == eng.steps + n_val,
          f"{launches['train_nisqa_2_epochs']} launches for {eng.steps} train steps and "
          f"{n_val} cold validation batches")
    train_audio_s = epoch_report(runner, rows, label, card)
    final_tar = check_tars(run_dir, 2, "train NISQA")

    # the final .tar served through run_predict gives the loop's last validation pass
    with open(os.path.join(corpus, "val.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["filepath_deg"])
        w.writerows([os.path.basename(p)] for p in val_paths)
    pred_dir = os.path.join(tmp, "train_pred")
    os.makedirs(pred_dir)
    served = run_predict.main(["--mode", "predict_csv", "--pretrained_model", final_tar,
                               "--csv_file", "val.csv", "--csv_deg", "filepath_deg", "--data_dir",
                               corpus, "--output_dir", pred_dir, "--bs", str(BATCH)])
    diff = float(np.abs(np.asarray(served.ds_val.df["mos_pred"])
                        - np.asarray(runner.ds_val.df["mos_pred"])).max())
    print(f"final .tar through run_predict vs the loop's last validation pass: max_abs_diff={diff} "
          f"bound={SERVE_BOUND}", flush=True)
    check(diff <= SERVE_BOUND, f"the served final .tar differs from the loop's validation by {diff}")

    train_step_kernel_vs_twin(runner, card)
    host = warm_epochs(runner, train_audio_s, label, card)
    del runner, eng, served
    torch.cuda.empty_cache()

    # (a) the same run from the device-resident corpus: the build's chunks
    # are the only train launches
    out = os.path.join(tmp, "train_nisqa_resident")
    os.makedirs(out)
    cfg_res = train_config("train_nisqa_cnn_sa_ap.yaml", corpus, out, "train.csv",
                           csv_deg="filepath_deg", tr_epochs=2, tr_ds_to_memory=True)
    label = "train NISQA resident"
    runner, launches["train_nisqa_resident_2_epochs"], rows, run_dir, _ = run_training(
        cfg_res, f"{label} (tr_ds_to_memory, full width, bs 32)", card)
    eng = runner.train_engine
    res_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chunks = corpus_report(eng, label, card)
    check(sum(len(c["local"]) for c in eng._corpus.values()) == len(runner.ds_train),
          "the default budget left files on the host fill")
    check(launches["train_nisqa_resident_2_epochs"] == chunks + n_val,
          f"resident: {launches['train_nisqa_resident_2_epochs']} launches for {chunks} build "
          f"chunks and {n_val} cold validation batches")
    epoch_report(runner, rows, label, card)
    check_tars(run_dir, 2, "train NISQA resident")
    res = warm_epochs(runner, train_audio_s, label, card)
    build_frames = eng._corpus[48000]["mel"].shape[1]
    print(f"train NISQA warm epochs, host fill vs resident: {host['audio_s_per_s']:.1f} vs "
          f"{res['audio_s_per_s']:.1f} train audio-s/s, mean step {host['step_ms']:.2f} vs "
          f"{res['step_ms']:.2f} ms, idle share {host['idle']} vs {res['idle']}; peak device "
          f"memory {host_peak_gb:.3f} vs {res_peak_gb:.3f} GB on {card}", flush=True)
    del runner, eng
    torch.cuda.empty_cache()

    # (b) resident vs host fill from the same weights
    resident_vs_host_fill(cfg_res, card)

    # the kernel alone at the corpus build's shape: one 64-row chunk of the
    # 48 kHz group, exact mode
    ms = MsConfig(YAML_GEOMETRY)
    build_rows = kernel_case("corpus build", ms, 48000, CHUNK * build_frames, ("exact",), reps,
                             np.random.default_rng(2), card)

    # (c) partial residency: phase 10's 96 degraded 48 kHz files as a
    # single-ended corpus (db TRAIN), its 4 degraded 16 kHz files db VAL; a
    # budget of about 80 rows keeps a 64-row head resident
    de_corpus = os.path.join(tmp, "de_wavs")
    deg = sorted(f for f in os.listdir(de_corpus) if f.endswith("_deg.wav"))
    deg_paths = [os.path.join(de_corpus, d) for d in deg]
    with open(os.path.join(de_corpus, "partial.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["filepath_deg", "db", "mos"])
        for d, m in zip(deg, learnable_mos(deg_paths)):
            w.writerow([d, "TRAIN" if "_48k_" in d else "VAL", m])
    longest = 0
    for p in deg_paths:
        if "_48k_" in p:
            with wave.open(p) as w:
                longest = max(longest, w.getnframes())
    bucket = ms.bucket_for(ms.n_wins(ms.n_frames(longest, 48000)))
    row_mb = ms.frames_for_bucket(bucket) * ms.n_mels * 4 / 2 ** 20
    out = os.path.join(tmp, "train_partial")
    os.makedirs(out)
    cfg = train_config("train_nisqa_cnn_sa_ap.yaml", de_corpus, out, "partial.csv",
                       csv_deg="filepath_deg", tr_epochs=2, tr_ds_to_memory=True,
                       tr_device_cache_mb=80 * row_mb)
    label = "train NISQA partial residency"
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            runner, launches["train_nisqa_partial_2_epochs"], rows, _, _ = run_training(
                cfg, f"{label} (96 files, tr_device_cache_mb {80 * row_mb:.3f} = 80 rows of "
                f"{row_mb:.4f} MB at bucket {bucket})", card)
    finally:
        advisory = [line for line in err.getvalue().splitlines() if "nisqa_tpu_torch:" in line]
        print(f"{label} advisory: {advisory}", flush=True)
    check(any("64/96 rows (longest files) stay device-resident" in a for a in advisory),
          f"partial residency advisory {advisory}")
    eng = runner.train_engine
    n_val = len(runner.engine.plan(runner.ds_val.paths()))
    chunks = corpus_report(eng, label, card)
    check([h["steps"] for h in eng.history] == [3, 3], f"steps per epoch {eng.history}")
    epoch_report(runner, rows, label, card)
    # the build, one fill step per epoch for the 32-file tail, the cold validation batch
    check(launches["train_nisqa_partial_2_epochs"] == chunks + 2 + n_val,
          f"partial: {launches['train_nisqa_partial_2_epochs']} launches for {chunks} build "
          f"chunks, 2 tail steps and {n_val} cold validation batches")
    del runner, eng
    torch.cuda.empty_cache()

    # NISQA_DIM: one epoch of the multidimensional finetune from phase 5's .tar
    out = os.path.join(tmp, "train_dim")
    os.makedirs(out)
    cfg = train_config("finetune_nisqa_multidimensional.yaml", corpus, out, "train.csv",
                       csv_deg="filepath_deg", tr_epochs=1, pretrained_model=dim_tar)
    runner, launches["train_dim_1_epoch"], _, run_dir, _ = run_training(
        cfg, "finetune NISQA_DIM (finetune_nisqa_multidimensional.yaml from g2_dim, bs 32)", card)
    n_val = len(runner.engine.plan(runner.ds_val.paths()))
    check(runner.model.name == "NISQA_DIM", f"the finetune built {runner.model.name}")
    check(launches["train_dim_1_epoch"] == runner.train_engine.steps + n_val,
          f"DIM finetune: {launches['train_dim_1_epoch']} launches for "
          f"{runner.train_engine.steps} steps and {n_val} validation batches")
    check_tars(run_dir, 1, "DIM finetune")
    del runner

    # NISQA_DE: one epoch on 32 pairs of phase 10's corpus, two launches per
    # step from the host fill; then (d) from the device corpus, two per build chunk
    deg = [f"de_48k_{i:03d}_deg.wav" for i in range(32)]
    de_mos = learnable_mos([os.path.join(de_corpus, d) for d in deg])
    with open(os.path.join(de_corpus, "train_pairs.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["deg", "ref", "db", "mos"])
        for i, (d, m) in enumerate(zip(deg, de_mos)):
            w.writerow([d, d.replace("_deg", "_ref"), "VAL" if i % 4 == 3 else "TRAIN", m])
    for run, over in (("train_de_1_epoch", {}), ("train_de_resident_1_epoch",
                                                 {"tr_ds_to_memory": True})):
        out = os.path.join(tmp, run)
        os.makedirs(out)
        cfg = train_config("train_nisqa_double_ended.yaml", de_corpus, out, "train_pairs.csv",
                           csv_deg="deg", csv_ref="ref", tr_epochs=1, **over)
        runner, launches[run], rows, run_dir, _ = run_training(
            cfg, f"{run} (train_nisqa_double_ended.yaml, 24 + 8 pairs, bs 32)", card)
        eng = runner.train_engine
        n_val = len(runner.engine.plan(runner.ds_val.paths(), runner.ds_val.paths_ref()))
        if over:
            chunks = corpus_report(eng, run, card)
            check(all("mel_ref" in c for c in eng._corpus.values()), "DE corpus without mel_ref")
            epoch_report(runner, rows, run, card)
            check(launches[run] == 2 * (chunks + n_val),
                  f"DE resident: {launches[run]} launches for {chunks} build chunks and {n_val} "
                  "validation batches, two ends each")
        else:
            check(launches[run] == 2 * (eng.steps + n_val),
                  f"DE: {launches[run]} launches for {eng.steps} steps and {n_val} validation "
                  "batches, two ends each")
        check_tars(run_dir, 1, run)
        del runner, eng
    torch.cuda.empty_cache()
    return launches, build_rows


def eighty_mels(tmp: str, paths, audio_s: float, card: str):
    """Phase 17: a seeded NISQA_DIM at 80 mel bands (two chunks of the
    kernel's 64-band tile) over phase 5's corpus: every serving regime of
    phase 6 at "highest"; cold passes at "highest" and at the default
    precision, one launch per batch, held to the same model on the CPU
    over the 16 kHz files and 12 of the 48 kHz ones (1e-3 and 1e-2), and
    ``run_predict --mode predict_dir`` equal to the default-precision pass;
    the trained NISQA_DE weights at 80 mels (AdaptCNN takes any height)
    over phase 10's pairs at "highest", two launches per cold batch, held
    to the CPU on 4 pairs (1e-3); then one epoch of
    ``train_nisqa_cnn_sa_ap.yaml`` at 80 mels from the host fill (a launch
    per step) and resident (a launch per build chunk), plus the cold
    validation batches. Returns {pass: kernel launches}."""
    import nisqa_tpu_torch
    from nisqa_tpu_torch import run_predict
    from nisqa_tpu_torch.data.pipeline import matmul_precision
    from nisqa_tpu_torch.ops.dft_mel import fused_dft_mel
    from nisqa_tpu_torch.tools.corpus import MEL80_GEOMETRY

    tar = golden_tar("g2_dim", MEL80_GEOMETRY, os.path.join(tmp, "nisqa_dim80.tar"),
                     "NISQA_DIM_80", seed=80)
    launches = {f"m80_{k}": v for k, v in serving(tar, paths, audio_s, card, precision="highest",
                                                   label="80 mels serving").items()}
    subset = [p for p in paths if "_16k_" in p] + [p for p in paths if "_48k_" in p][:12]
    with matmul_precision("highest"):
        y_cpu = nisqa_tpu_torch.load_predictor(tar, batch_size=BATCH, tr_device="cpu",
                                               precision="highest")(subset)
    idx = [paths.index(p) for p in subset]
    ys = {}
    for precision, bound in (("highest", PASS_BOUND), ("default", DEFAULT_PASS_BOUND)):
        predict = nisqa_tpu_torch.load_predictor(tar, batch_size=BATCH, precision=precision,
                                                 cache_mb=0)
        n_batches = len(predict.engine.plan(paths))
        fused_dft_mel.LAUNCHES = 0
        y = ys[precision] = predict(paths)
        torch.cuda.synchronize()
        n = launches[f"m80_cold_{precision}"] = fused_dft_mel.LAUNCHES
        err = float(np.abs(y[idx] - y_cpu).max())
        print(f"80 mels cold pass at {precision!r}: {y.shape} predictions, fused_dft_mel "
              f"launches={n} for {n_batches} batches; max_abs_diff vs the CPU over {len(subset)} "
              f"files (4 at 16 kHz) {err:.3e} (bound {bound}) on {card}", flush=True)
        check(bool(np.isfinite(y).all()) and y.shape == (len(paths), 5), f"80 mels: {y.shape}")
        check(n == n_batches, f"80 mels at {precision!r}: {n} launches for {n_batches} batches")
        check(err <= bound, f"80 mels at {precision!r}: off the CPU by {err}")
        del predict

    # the CLI's predict_dir (the checkpoint sets no precision: the default)
    corpus = os.path.dirname(paths[0])
    out_dir = os.path.join(tmp, "m80_predict_dir")
    os.makedirs(out_dir)
    fused_dft_mel.LAUNCHES = 0
    runner = run_predict.main(["--mode", "predict_dir", "--pretrained_model", tar, "--data_dir",
                               corpus, "--output_dir", out_dir, "--bs", str(BATCH)])
    torch.cuda.synchronize()
    n = launches["m80_predict_dir"] = fused_dft_mel.LAUNCHES
    with open(os.path.join(out_dir, "NISQA_results.csv"), newline="") as f:
        table = list(csv.DictReader(f))
    check([r["deg"] for r in table] == [os.path.basename(p) for p in paths], "80 mels: row order")
    y_cli = np.array([[float(r[c]) for c in ("mos_pred", "noi_pred", "dis_pred", "col_pred",
                                             "loud_pred")] for r in table])
    diff = float(np.abs(y_cli - ys["default"]).max())
    print(f"80 mels run_predict predict_dir: {len(table)} files, fused_dft_mel launches={n}, "
          f"max_abs_diff vs the default-precision pass {diff} (bound {SERVE_BOUND})", flush=True)
    check(n == len(runner.engine.plan(paths)) and diff <= SERVE_BOUND,
          f"80 mels predict_dir: {n} launches, off by {diff}")
    del runner

    # NISQA_DE at 80 mels over phase 10's pairs: two launches per cold batch
    ckpt = torch.load(DE_TAR, map_location="cpu", weights_only=False)
    ckpt["args"] = {**ckpt["args"], "ms_n_mels": 80}
    de_tar = os.path.join(tmp, "de_trained_m80.tar")
    torch.save(ckpt, de_tar)
    de_dir = os.path.join(tmp, "de_wavs")
    with open(os.path.join(de_dir, "pairs.csv"), newline="") as f:
        pairs = [(os.path.join(de_dir, r["deg"]), os.path.join(de_dir, r["ref"]))
                 for r in csv.DictReader(f)]
    deg, ref = [p[0] for p in pairs], [p[1] for p in pairs]
    predict = nisqa_tpu_torch.load_predictor(de_tar, batch_size=BATCH, precision="highest",
                                             cache_mb=0)
    n_batches = len(predict.engine.plan(deg, ref))
    fused_dft_mel.LAUNCHES = 0
    y_de = predict(deg, ref)
    torch.cuda.synchronize()
    n = launches["m80_de_cold_highest"] = fused_dft_mel.LAUNCHES
    idx = [0, 1, len(deg) - 2, len(deg) - 1]
    with matmul_precision("highest"):
        y_de_cpu = nisqa_tpu_torch.load_predictor(de_tar, batch_size=BATCH, tr_device="cpu",
                                                  precision="highest")(
            [deg[i] for i in idx], [ref[i] for i in idx])
    err = float(np.abs(y_de[idx] - y_de_cpu).max())
    print(f"80 mels NISQA_DE cold pass at 'highest': {len(deg)} pairs, fused_dft_mel launches={n} "
          f"for {n_batches} batches x 2 ends; max_abs_diff vs the CPU over 4 pairs {err:.3e} "
          f"(bound {PASS_BOUND}) on {card}", flush=True)
    check(bool(np.isfinite(y_de).all()) and n == 2 * n_batches,
          f"80 mels DE: {n} launches for {n_batches} batches")
    check(err <= PASS_BOUND, f"80 mels DE: off the CPU by {err}")
    del predict

    # training: corpus holds phase 11's train.csv
    for mem in (False, True):
        label = f"train NISQA at 80 mels, {'resident' if mem else 'host fill'}"
        out = os.path.join(tmp, f"train_m80_{'resident' if mem else 'host'}")
        os.makedirs(out)
        cfg = train_config("train_nisqa_cnn_sa_ap.yaml", corpus, out, "train.csv",
                           csv_deg="filepath_deg", tr_epochs=1, tr_ds_to_memory=mem, ms_n_mels=80)
        runner, n, _, run_dir, _ = run_training(cfg, f"{label} (1 epoch, bs 32)", card)
        eng = runner.train_engine
        n_val = len(runner.engine.plan(runner.ds_val.paths()))
        work = corpus_report(eng, label, card) if mem else eng.steps
        check(bool(eng._corpus) == mem, f"{label}: device corpus {bool(eng._corpus)}")
        check(n == work + n_val, f"{label}: {n} launches for {work} "
              f"{'build chunks' if mem else 'train steps'} and {n_val} cold validation batches")
        check_tars(run_dir, 1, label)
        launches[f"train_m80_{'resident' if mem else 'host'}_1_epoch"] = n
        del runner, eng
        torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def cudnn_deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def dp_worker(job_path: str):
    """One rank of phase 12, run by ``torchrun ... chip_smoke.py --dp-worker
    JOB``: each serving run of the job through ``NisqaTorch.predict`` and
    each training run through ``run_train.main``, the kernel's count zeroed
    just before each and read just after; then the step's collectives
    timed alone. Writes ``rank<r>.pt`` into the job's ``out`` directory."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from nisqa_tpu_torch import run_train
    from nisqa_tpu_torch.model import NisqaTorch
    from nisqa_tpu_torch.ops.dft_mel import fused_dft_mel
    from nisqa_tpu_torch.parallel.mesh import all_reduce_grads, barrier

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cudnn.deterministic = True  # as phase 12's runs in the main process
    out = {}
    for name, args in job["serve"].items():
        fused_dft_mel.LAUNCHES = 0
        t0 = time.perf_counter()
        runner = NisqaTorch(args)
        runner.predict()
        torch.cuda.synchronize()
        ds = runner.ds_val
        out[f"serve/{name}"] = {
            "y": np.stack([np.asarray(ds.df[c], np.float64) for c in ds.df.columns
                           if c.endswith("_pred")], axis=1),
            "launches": fused_dft_mel.LAUNCHES, "wall_s": time.perf_counter() - t0,
            "batches": len(runner.engine.plan(ds.paths(), ds.paths_ref()))}
    for name, cfg in job["train"].items():
        fused_dft_mel.LAUNCHES = 0
        t0 = time.perf_counter()
        runner = run_train.main(["--yaml", cfg])
        torch.cuda.synchronize()
        eng = runner.train_engine
        out[f"train/{name}"] = {
            "loss": eng.history[-1]["loss"], "steps": eng.steps, "wall_s": time.perf_counter() - t0,
            "epoch_s": eng.history[-1]["wall_s"], "val_s": eng.history[-1]["val_s"],
            "launches": fused_dft_mel.LAUNCHES, "device": str(runner.device),
            "val_batches": len(runner.engine.plan(runner.ds_val.paths())),
            "chunks": sum(c["mel"].shape[0] // 64 for c in (eng._corpus or {}).values()),
            "y_train": np.asarray(runner.ds_train.df["mos_pred"], np.float64),
            "y_val": np.asarray(runner.ds_val.df["mos_pred"], np.float64),
            "sd": {k: v.detach().cpu() for k, v in runner.model.state_dict().items()}}
    dp = runner.dp
    # the collectives of one train step, alone: per BN call of the forward
    # the all-reduce of (n, sum w x) and of the squared deviations, and in
    # the backward one of each's gradient; then the gradients' all-reduce
    bns = [m for m in runner.model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    sizes = [c for m in bns for c in (m.num_features + 1, m.num_features) * 2]
    bufs = [torch.zeros(n, device=dp.device) for n in sizes]
    params = [p for p in runner.model.parameters() if p.grad is not None]

    def bn():
        for b in bufs:
            dist.all_reduce(b, group=dp.group)

    out["collectives"] = {"bn_calls": len(sizes), "grad_floats": sum(p.numel() for p in params)}
    for key, fn in (("bn_ms", bn), ("grad_ms", lambda: all_reduce_grads(params, dp.group))):
        fn()
        barrier(dp.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        out["collectives"][key] = 1e3 * (time.perf_counter() - t0) / 20
    out.update(rank=dp.rank, size=dp.size, backend=dp.backend)
    torch.save(out, os.path.join(job["out"], f"rank{dp.rank}.pt"))


def launch_ranks(n: int, job: dict, tmp: str, label: str):
    """``torchrun --standalone --nproc_per_node n chip_smoke.py --dp-worker``
    on ``job``, in a session of its own that is killed whole on a timeout;
    fails when any rank fails. Returns each rank's results and the wall s."""
    os.makedirs(job["out"])
    job_path = os.path.join(job["out"], "job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    log_path = os.path.join(tmp, f"{label}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", str(n), os.path.abspath(__file__),
                                 "--dp-worker", job_path], stdout=log, stderr=subprocess.STDOUT,
                                cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = "timeout"
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as f:
            print(f.read()[-6000:], flush=True)
    check(rc == 0, f"{label}: torchrun --nproc_per_node {n} ended with {rc}")
    return [torch.load(os.path.join(job["out"], f"rank{r}.pt"), weights_only=False)
            for r in range(n)], wall


def report_ranks(label: str, ranks, wall: float, card: str):
    for r in ranks:
        runs = ", ".join(
            f"{k} {v['wall_s']:.3f} s" + (f" (epoch {v['epoch_s']:.3f} s, validation "
                                           f"{v['val_s']:.3f} s)" if "epoch_s" in v else "")
            for k, v in r.items() if isinstance(v, dict) and "wall_s" in v)
        c = r["collectives"]
        print(f"{label} rank {r['rank']}/{r['size']} ({r['backend']}): {runs}; a train step's "
              f"collectives alone: {c['bn_calls']} BN all-reduces {c['bn_ms']:.3f} ms, gradient "
              f"all-reduce of {c['grad_floats']} floats {c['grad_ms']:.3f} ms on {card}",
              flush=True)
    print(f"{label}: torchrun wall {wall:.3f} s (process start, CUDA set-up and the group "
          f"included) on {card}", flush=True)


def max_param_diff(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a if a[k].numel())


def data_parallel(tmp: str, tar: str, paths, build_frames: int, reps: int, card: str):
    """Phase 12: serving and training over a ``torch.distributed`` group.
    (a) W = the card count (1 here) over NCCL: ``run_train`` on
    ``train_nisqa_cnn_sa_ap.yaml`` (full width, bs 32, one epoch at zero
    dropout and lr 3e-5 over phase 11's corpus) against the same epoch
    without a launcher. (b) W = 2 (over gloo on one card, NCCL on two or
    more): NISQA_DIM serving at both precisions and NISQA_DE at "highest"
    against this process's passes, and the training epoch from the host
    fill and resident against the epoch without a launcher. Returns ({run:
    launches per rank}, the kernel's rows at a W = 2 train step's shape).

    Every run of the phase takes cuDNN's deterministic algorithms
    (:func:`cudnn_deterministic` here, ``dp_worker`` in the ranks): Adam
    moves a weight whose gradient is zero in exact arithmetic (a conv bias
    ahead of a batch norm) by up to lr a step in a direction set by
    rounding noise, so two runs compare only where their arithmetic is the
    same (W = 1: bit-equal), and at an lr (3e-5, as
    ``tests/test_torch_train_epoch.py``) where the noise stays under the
    bounds when it differs (W > 1 sums BN statistics in another order)."""
    from nisqa_tpu_torch.data.pipeline import MsConfig
    from nisqa_tpu_torch.model import NisqaTorch

    corpus = os.path.dirname(paths[0])
    no_drop = {"cnn_dropout": 0.0, "td_sa_dropout": 0.0, "pool_att_dropout": 0.0,
               "td_2_sa_dropout": 0.0, "tr_epochs": 1, "tr_lr": 3e-5, "tr_parallel": True}
    cards = torch.cuda.device_count()
    launches = {}

    def train_cfg(run: str, **over):
        out = os.path.join(tmp, run)
        os.makedirs(out)
        return train_config("train_nisqa_cnn_sa_ap.yaml", corpus, out, "train.csv",
                            csv_deg="filepath_deg", **no_drop, **over)

    def backend(w: int) -> str:
        return "nccl" if w <= cards else "gloo"

    # the epoch without a launcher: this process, one card
    ref, _, _, _, _ = run_training(train_cfg("dp_ref"), "data parallel reference (no launcher)",
                                   card)
    ref_sd = {k: v.detach().cpu() for k, v in ref.model.state_dict().items()}
    ref_loss = ref.train_engine.history[-1]["loss"]
    ref_s = {k: ref.train_engine.history[-1][k] for k in ("wall_s", "val_s")}
    ref_y = {k: np.asarray(getattr(ref, f"ds_{k}").df["mos_pred"], np.float64)
             for k in ("train", "val")}
    del ref
    torch.cuda.empty_cache()

    def check_train(label: str, name: str, ranks):
        """The ranks' epoch against the one without a launcher: bit-equal
        at W = 1; else within the train bounds, every rank's weights and BN
        buffers identical. One launch per fill step (or build chunk) and
        cold validation batch of the rank."""
        got = [r[f"train/{name}"] for r in ranks]
        w = len(got)
        rel = abs(got[0]["loss"] - ref_loss) / abs(ref_loss)
        d_y = max(float(np.abs(g[f"y_{k}"] - ref_y[k]).max()) for g in got for k in ref_y)
        if w == 1:
            d_par = max_param_diff(got[0]["sd"], ref_sd)
            same = (f"parameters and buffers max |diff| {d_par:.3e} off the run without a "
                    f"launcher (bound 1e-6)")
            ok = abs(got[0]["loss"] - ref_loss) <= 1e-6 and d_par <= 1e-6
        else:
            d_par = max(max_param_diff(got[0]["sd"], g["sd"]) for g in got[1:])
            same = f"parameters and BN buffers rank 0 vs the others max |diff| {d_par} (bound 0.0)"
            ok = (rel <= TRAIN_LOSS_BOUND and d_y <= PASS_BOUND and d_par == 0.0
                  and all(g["loss"] == got[0]["loss"] for g in got))
        expect = [g["chunks" if "resident" in name else "steps"] + g["val_batches"] for g in got]
        print(f"{label} training {name} ({-(-BATCH // w)} rows a rank): loss {got[0]['loss']} vs "
              f"{ref_loss} without a launcher, rel {rel:.3e} (bound {TRAIN_LOSS_BOUND} at W > 1); "
              f"train and validation predictions max_abs_diff {d_y:.3e} (bound {PASS_BOUND}); "
              f"{same}; {got[0]['steps']} steps, fused_dft_mel launches per rank "
              f"{[g['launches'] for g in got]} (expected {expect}); epoch (first in its "
              f"process) per rank {[round(g['epoch_s'], 4) for g in got]} s, validation "
              f"{[round(g['val_s'], 4) for g in got]} s, vs {ref_s['wall_s']:.4f} s and "
              f"{ref_s['val_s']:.4f} s at W = 1 without a launcher on {card}", flush=True)
        check(ok, f"{label} {name} at W = {w}: off the run without a launcher")
        check([g["launches"] for g in got] == expect, f"{label} {name}: launches per rank")
        check([r["backend"] for r in ranks] == [backend(w)] * w, f"{label}: backend")
        launches[f"dp_{name}_train"] = [g["launches"] for g in got]

    # (a) W = the card count over NCCL
    ranks, wall = launch_ranks(cards, {"out": os.path.join(tmp, "dp_a"), "serve": {},
                                       "train": {f"w{cards}": train_cfg("dp_a_run")}}, tmp, "dp_a")
    report_ranks("data parallel (a)", ranks, wall, card)
    check_train("data parallel (a)", f"w{cards}", ranks)

    # (b) W = 2: two ranks on the one card over gloo (or on two cards over NCCL)
    serve_base = {"tr_bs_val": BATCH, "tr_num_workers": 4, "tr_parallel": True, "output_dir": None}
    serve = {
        "dim_highest": {**serve_base, "mode": "predict_dir", "pretrained_model": tar,
                        "data_dir": corpus, "precision": "highest"},
        "dim_default": {**serve_base, "mode": "predict_dir", "pretrained_model": tar,
                        "data_dir": corpus},
        "de_highest": {**serve_base, "mode": "predict_csv", "pretrained_model": DE_TAR,
                       "data_dir": os.path.join(tmp, "de_wavs"), "csv_file": "pairs.csv",
                       "csv_deg": "deg", "precision": "highest"}}
    ref_serve = {}
    for name, args in serve.items():
        r = NisqaTorch(dict(args))
        with contextlib.redirect_stdout(io.StringIO()):
            r.predict()
        ref_serve[name] = np.stack([np.asarray(r.ds_val.df[c], np.float64)
                                    for c in r.ds_val.df.columns if c.endswith("_pred")], axis=1)
        del r
    ranks, wall = launch_ranks(2, {"out": os.path.join(tmp, "dp_b"), "serve": serve, "train": {
        "w2": train_cfg("dp_w2"), "w2_resident": train_cfg("dp_w2_res", tr_ds_to_memory=True)}},
        tmp, "dp_b")
    report_ranks("data parallel (b)", ranks, wall, card)
    for name in serve:
        got = [r[f"serve/{name}"] for r in ranks]
        diff = max(float(np.abs(g["y"] - ref_serve[name]).max()) for g in got)
        ends = 2 if name.startswith("de") else 1
        print(f"data parallel (b) serving {name}: max_abs_diff vs one process {diff:.3e} (bound "
              f"{SERVE_BOUND}); fused_dft_mel launches per rank {[g['launches'] for g in got]} "
              f"for its {[g['batches'] for g in got]} cold batches x {ends} end(s) on {card}",
              flush=True)
        check(diff <= SERVE_BOUND, f"W = 2 serving {name} off by {diff}")
        check(all(g["launches"] == ends * g["batches"] and g["batches"] > 0 for g in got),
              f"W = 2 serving {name}: launches {[g['launches'] for g in got]}")
        launches[f"dp_w2_{name}"] = [g["launches"] for g in got]
    for name in ("w2", "w2_resident"):
        check_train("data parallel (b)", name, ranks)
    # the kernel at a W = 2 fill step's shape: 16 rows of the 48 kHz bucket
    rows = kernel_case("W = 2 train shard", MsConfig(YAML_GEOMETRY), 48000, 16 * build_frames,
                       ("exact",), reps, np.random.default_rng(3), card)
    return launches, rows


def tools_phase(tmp: str, reps: int, card: str):
    """Phase 14: each measurement tool's ``main`` on the card at a reduced
    size (``bench`` over 96 files with fewer passes, ``bench_tts`` over 4,
    ``bench_de`` over 32 pairs, ``bench_train`` over 32 files for 2 epochs);
    each prints its record on a line of its own. Checks: finite fields, MFU
    in (0, 100], one kernel launch per cold batch and end, none in a cached
    pass, the cached passes against the cold one, and ``bench``'s front-end
    FLOPs at its largest batch equal to phase 3's count of the DFT's
    products at that shape (the kernel there against its twin) plus the
    dense mel projection, 2 N K M, written out here: the MFU counts the
    mel product whole, the bound only its bands. Returns ({tool: kernel
    launches in its run}, the kernel row at ``bench``'s shape)."""
    from nisqa_tpu_torch.data.pipeline import InferenceEngine, MsConfig
    from nisqa_tpu_torch.models.nisqa import build_model
    from nisqa_tpu_torch.ops.dft_mel import fused_dft_mel
    from nisqa_tpu_torch.tools import bench, bench_de, bench_train, bench_tts, corpus, flops

    few = ["--passes", "3", "--devrate-passes", "2", "--async-blocks", "2", "--async-depth", "4"]
    runs = [
        ("bench", bench, ["--files", "96", *few], 1, SERVE_BOUND),
        ("bench_tts", bench_tts, ["--files", "4"], 1, SERVE_BOUND),
        # default precision: TF32 kernels differ between fused and single batches
        ("bench_de", bench_de, ["--pairs", "32", *few], 2, DEFAULT_PASS_BOUND),
    ]
    launches, records = {}, {}
    for name, tool, argv, ends, bound in runs:
        fused_dft_mel.LAUNCHES = 0
        t0 = time.perf_counter()
        rec = tool.main([*argv, "--corpus-dir", os.path.join(tmp, name)])
        wall = time.perf_counter() - t0
        launches[f"tool_{name}"] = fused_dft_mel.LAUNCHES
        records[name] = rec
        print(f"tool {name}: {rec['value']:.1f} {rec['unit']}, mfu {rec['mfu_pct']:.4f}% of "
              f"{rec['peak_tflops']} TFLOP/s, cold pass launches {rec['launches_cold_pass']} for "
              f"{rec['plan_batches']} batches, cached max_abs_diff {rec['cached_max_abs_diff']}, "
              f"{wall:.1f} s wall on {card}", flush=True)
        bad = [k for k, v in rec.items() if isinstance(v, float) and not math.isfinite(v)]
        check(not bad, f"tool {name}: non-finite fields {bad}")
        check(0 < rec["mfu_pct"] <= 100, f"tool {name}: mfu_pct {rec['mfu_pct']}")
        check(rec["launches_cold_pass"] == ends * rec["plan_batches"]
              and rec["launches_cached_passes"] == 0,
              f"tool {name}: {rec['launches_cold_pass']} launches in the cold pass and "
              f"{rec['launches_cached_passes']} in the cached ones for {rec['plan_batches']} "
              f"batches and {ends} end(s)")
        check(rec["cached_max_abs_diff"] <= bound,
              f"tool {name}: cached passes off by {rec['cached_max_abs_diff']} from the cold one")

    # bench's front-end count against phase 3's at its largest batch
    ms = MsConfig(YAML_GEOMETRY)
    _, paths = corpus.bench_corpus(os.path.join(tmp, "bench"), 96)
    meta, _ = load_golden("g2_dim")
    plan = InferenceEngine(build_model("NISQA_DIM", meta["model_args"]), ms, "cuda",
                           batch_size=BATCH, cache_mb=0).plan(paths)
    (sr, bucket, _), _ = max(plan, key=lambda b: b[0][1])
    row = kernel_case("tools bench", ms, sr, BATCH * ms.frames_for_bucket(bucket), ("fast",),
                      reps, np.random.default_rng(3), card)[0]
    per_batch = flops.batch_front_end_flops(ms, sr, bucket, BATCH)
    dense_mel = 2 * row["N"] * row["K"] * row["M"]
    band_mel = row["operations"] - row["dft_operations"]
    extra = sum(flops.batch_front_end_flops(ms, g[0], g[1], BATCH) for g, _ in plan)
    rec = records["bench"]
    print(f"tool bench front-end FLOPs at bucket {bucket}: {per_batch} (tools.flops) vs "
          f"{row['dft_operations']} + {dense_mel} (phase 3's DFT products at N {row['N']} and "
          f"the dense mel product; the bound's band-limited mel step {band_mel}); cold extra "
          f"over the plan {extra} vs the record's "
          f"{rec['cold_flops_per_pass'] - rec['cached_flops_per_pass']}", flush=True)
    check(per_batch == row["dft_operations"] + dense_mel,
          "tools.flops and phase 3 count the front-end apart")
    check(extra == rec["cold_flops_per_pass"] - rec["cached_flops_per_pass"],
          "bench's cold extra is not its plan's front-end")

    fused_dft_mel.LAUNCHES = 0
    rec = bench_train.main(["--files", "32", "--epochs", "2",
                            "--corpus-dir", os.path.join(tmp, "bench_train")])
    launches["tool_bench_train"] = fused_dft_mel.LAUNCHES
    print(f"tool bench_train: {rec['value']:.1f} train audio-s/s, epochs {rec['epoch_sec']} s, "
          f"idle share of a warm epoch {rec['idle_warm_epoch']}, launches {rec['launches']} on "
          f"{card}", flush=True)
    bad = [k for k, v in rec.items() if isinstance(v, float) and not math.isfinite(v)]
    check(not bad, f"tool bench_train: non-finite fields {bad}")
    # 26 train files: one 64-row build chunk; 6 validation files: one cold batch
    check(rec["launches"] == 2, f"tool bench_train: {rec['launches']} launches, not 2")
    return launches, row


def parity_phase(tmp: str, card: str):
    """Phase 15: ``tools.parity``'s ``main`` on the card over the full
    corpora in ``tmp`` (phase 14's folders, completed), every key held to
    its budget and to the recorded H100 baseline by the tool itself (it
    raises), and here to one kernel launch per cold batch and end; then
    :func:`de_precision_split`. Returns {"parity": kernel launches}."""
    from nisqa_tpu_torch.ops.dft_mel import fused_dft_mel
    from nisqa_tpu_torch.tools import parity

    fused_dft_mel.LAUNCHES = 0
    t0 = time.perf_counter()
    rec = parity.main(["--corpus-dir", tmp, "--check-record", parity.H100_RECORD])
    wall = time.perf_counter() - t0
    launches = fused_dft_mel.LAUNCHES
    keys = {k: m for k, m in rec.items() if not k.startswith("_")}
    check(set(keys) == set(parity.KEYS), f"parity: keys {sorted(keys)}")
    for key, m in keys.items():
        name = parity.CHECKPOINT_CORPUS[key.split("::")[0]]
        ends = 2 if name == "de" else 1
        check(m["n"] == parity.CORPORA[name][0], f"parity {key}: n {m['n']}")
        check(m["batches"] > 0 and m["launches"] == ends * m["batches"],
              f"parity {key}: {m['launches']} launches for {m['batches']} batches and {ends} "
              "end(s)")
    check(launches == sum(m["launches"] for m in keys.values()),
          f"parity: {launches} launches in the run, the keys count otherwise")
    print(f"parity at corpus scale: {len(keys)} keys within budget and within 3 x recorded + "
          f"2e-4 of {os.path.relpath(parity.H100_RECORD, REPO)}, {launches} kernel launches, "
          f"{wall:.1f} s wall on {card}", flush=True)
    de_precision_split(tmp, card)
    return {"parity": launches}


def de_precision_split(tmp: str, card: str):
    """``de_trained.tar::auto``'s distance from the float32 reference over
    the 96 DE pairs, by source: the bf16 DFT alone ("highest", fast
    front-end), TF32 in cuDNN alone, in cuBLAS alone and in both (the exact
    front-end at "default", one flag held off around each pass), and the
    key itself (bf16 DFT and TF32 in both). Prints; checks nothing."""
    from nisqa_tpu_torch import load_predictor
    from nisqa_tpu_torch.data import pipeline
    from nisqa_tpu_torch.tools import corpus, parity

    arrays, meta = parity.load_reference()
    n, bs, folder = parity.CORPORA["de"]
    _, deg, ref, _ = corpus.de_corpus(os.path.join(tmp, folder), n, portable=True)
    parity.check_corpus(arrays, meta, "de", parity.corpus_files(deg, ref))
    plain = pipeline.matmul_precision

    def tf32_only(cudnn: bool, cublas: bool):
        @contextlib.contextmanager
        def flags(precision):
            prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, cublas
            try:
                yield
            finally:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        return flags

    cases = (("bf16 DFT alone", "highest", "fast", None),
             ("TF32 in cuDNN alone", "default", "exact", tf32_only(True, False)),
             ("TF32 in cuBLAS alone", "default", "exact", tf32_only(False, True)),
             ("TF32 in both", "default", "exact", None),
             ("bf16 DFT and TF32 in both (the key)", "default", "fast", None))
    try:
        for label, precision, fe, flags in cases:
            pipeline.matmul_precision = flags or plain
            predict = load_predictor(parity.DE_TAR, batch_size=bs, precision=precision,
                                     fe_precision=fe, num_workers=4, cache_mb=0)
            m = parity.compare(predict(deg, ref), arrays["ref::de_trained.tar"])
            print(f"parity de_trained.tar, {label}: MOS MAE {m['mos_mae']:.6f}, max "
                  f"{m['max_abs']:.6f}, pearson_r {m['pearson_r']:.7f} on {card}", flush=True)
    finally:
        pipeline.matmul_precision = plain


def entry_points(reps: int, card: str):
    """Phase 16: ``entry()`` on the card against the same weights on the
    CPU, with the forward's median wall time; ``dryrun_multichip`` over W =
    2 ranks and, with more than two cards, over the card count, each rank's
    kernel launches held to its cold batches; the kernel against its twin
    at the dry run's shape. Returns ({run: launches per rank}, the kernel's
    rows)."""
    from nisqa_tpu_torch.data.pipeline import MsConfig, matmul_precision
    from nisqa_tpu_torch.graft_entry import DRYRUN_ARGS, DRYRUN_SR, dryrun_multichip, entry

    # (a) entry(): the card against the same weights on the CPU, then its time
    fn, args = entry()
    cpu_fn, cpu_args = entry(device="cpu",
                             state_dict={k: v.cpu() for k, v in fn.state_dict().items()})
    with torch.inference_mode():
        with matmul_precision("highest"):
            y = fn(*args).cpu().numpy()
        y_cpu = cpu_fn(*cpu_args).numpy()
        err = float(np.abs(y - y_cpu).max())
        times = {}
        for precision in ("highest", "default"):
            with matmul_precision(precision):
                fn(*args)
                torch.cuda.synchronize()
                ms = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    fn(*args)
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
            times[precision] = float(np.median(ms))
    print(f"entry(): NISQA_DIM forward of segs {tuple(args[0].shape)} -> {y.shape} on the card "
          f"at 'highest', max_abs_err vs the same weights on the CPU {err:.3e} (bound "
          f"{GOLDEN_BOUND}); median wall of {reps} forwards {times['highest']:.3f} ms at "
          f"'highest', {times['default']:.3f} ms at the default precision on {card}", flush=True)
    check(y.shape == (4, 5) and bool(np.isfinite(y).all()) and err <= GOLDEN_BOUND,
          f"entry() on the card off the CPU by {err}")

    # (b) dryrun_multichip over the group, a torchrun subprocess each
    cards = torch.cuda.device_count()
    launches = {}
    for w in sorted({2, cards} if cards > 2 else {2}):
        t0 = time.perf_counter()
        rec = dryrun_multichip(w, timeout=DP_TIMEOUT)
        wall = time.perf_counter() - t0
        backend = "nccl" if w <= cards else "gloo"
        print(f"dryrun_multichip({w}) ({rec['backend']}): step loss {rec['step_loss']:.4f}, epoch "
              f"loss {rec['epoch_loss']:.4f}, serving max_abs_diff vs one process "
              f"{rec['max_abs_diff']:.3e}; fused_dft_mel launches per rank "
              f"{rec['launches_by_rank']} for their {rec['batches_by_rank']} cold batches; "
              f"rank 0's checks {json.dumps(rec['wall_s'])} s, {wall:.3f} s wall with torchrun "
              f"on {card}", flush=True)
        check(rec["device"] == "cuda" and rec["backend"] == backend,
              f"dryrun_multichip({w}) ran on {rec['device']} over {rec['backend']}")
        check(rec["launches_by_rank"] == rec["batches_by_rank"]
              and sum(rec["batches_by_rank"]) > 0, f"dryrun_multichip({w}): launches per rank")
        check(w > 2 or min(rec["launches_by_rank"]) >= 1,
              f"dryrun_multichip({w}): a rank launched no kernel")
        launches[f"dryrun_w{w}"] = rec["launches_by_rank"]

    # (c) the kernel at the dry run's shape: one cold batch of 2 rows of 0.7 s at 8 kHz
    ms = MsConfig(DRYRUN_ARGS)
    bucket = ms.bucket_for(ms.n_wins(ms.n_frames(int(DRYRUN_SR * 0.7), DRYRUN_SR)))
    rows = kernel_case("dryrun", ms, DRYRUN_SR, 2 * ms.frames_for_bucket(bucket), ("exact",),
                       reps, np.random.default_rng(4), card)
    return launches, rows


def import_check():
    """The port loaded nothing of JAX or of the JAX package in this run, and
    importing it and all its submodules in a fresh process after torch loads
    no jax, pandas, yaml, tqdm, matplotlib or ``nisqa_tpu`` module (the card's machine has
    them all; ``eval/report.py`` imports matplotlib only to plot)."""
    banned = ("jax", "jaxlib", "nisqa_tpu")
    here = sorted(m for m in sys.modules if m.split(".")[0] in banned)
    check(not here, f"this run imported JAX code: {here[:10]}")
    code = ("import sys, importlib, pkgutil, torch\n"
            "base = set(sys.modules)  # what torch itself loads (it takes tqdm where installed)\n"
            "import nisqa_tpu_torch\n"
            "for m in pkgutil.walk_packages(nisqa_tpu_torch.__path__, 'nisqa_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'nisqa_tpu_torch.parallel.mesh' in sys.modules\n"
            "assert 'nisqa_tpu_torch.tools.bench_train' in sys.modules\n"
            "assert 'nisqa_tpu_torch.tools.parity' in sys.modules\n"
            "assert 'nisqa_tpu_torch.graft_entry' in sys.modules\n"
            "assert 'nisqa_tpu_torch.features.segments' in sys.modules\n"
            "print(sorted(m for m in sys.modules if m not in base and m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'nisqa_tpu', 'pandas', 'yaml', 'tqdm', 'matplotlib')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    check(r.returncode == 0, f"importing the port failed: {r.stderr[-2000:]}")
    check(r.stdout.strip() == "[]", f"importing the port loaded {r.stdout.strip()}")
    print("imports: no jax, jaxlib, nisqa_tpu, pandas, yaml, tqdm or matplotlib module loaded by "
          "the port",
          flush=True)


def wide_fields(wide, m: int, sr: int) -> dict:
    """The kernel record's fields of phase 3's main shape at ``m`` bands and ``sr``."""
    fast, exact = wide[m, sr, "fast"], wide[m, sr, "exact"]
    return {"shape": {k: fast[k] for k in ("sr", "N", "span", "K", "M", "mel_chunks", "tile_runs")},
            "ms": fast["kernel_ms"], "plain_ms": fast["twin_ms"], "bound_ms": fast["bound_ms"],
            "bound_by": fast["bound_by"], "exact_ms": exact["kernel_ms"],
            "exact_plain_ms": exact["twin_ms"], "exact_bound_ms": exact["bound_ms"],
            "exact_bound_by": exact["bound_by"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every generated input")
    ap.add_argument("--reps", type=int, default=5, help="timed repetitions per kernel case")
    ap.add_argument("--dp-worker", metavar="JOB", help=argparse.SUPPRESS)  # a rank of phase 12
    ap.add_argument("--bn-pool", action="store_true",
                    help="only run phase 3b (bn_relu_adaptive_max_pool and bias_bn_relu "
                         "against their plain versions and the chain they replace, with "
                         "times)")
    ap.add_argument("--kernel-hashes", action="store_true",
                    help="only print the sha256 of the kernel's outputs at phase 3's shapes of "
                         "up to 64 mel bands and the kernel's times (kernel_hashes)")
    opts = ap.parse_args(argv)
    if opts.dp_worker:
        return dp_worker(opts.dp_worker)
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: chip_smoke.py runs on a CUDA card only")
    if opts.kernel_hashes:
        print(card_line(), flush=True)
        print(json.dumps(kernel_hashes(opts.seed, opts.reps), sort_keys=True), flush=True)
        return
    sys.path.insert(0, REPO)
    from nisqa_tpu_torch.ops import _build

    if opts.bn_pool:
        card = card_line()
        print(card, flush=True)
        bn_pool_phase(opts.seed, opts.reps, card)
        return

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

    # 3-12
    results, main, tts, wide = kernel_vs_twin(opts.seed, opts.reps, card)
    bn_pool_rows = bn_pool_phase(opts.seed, opts.reps, card)
    model_golden("g2_dim")
    model_golden("g3_tts")
    with tempfile.TemporaryDirectory(prefix="nisqa_smoke_") as tmp:
        tar, paths, audio_s = make_corpus(tmp, opts.seed)
        launches, y_dir = main_path(tar, paths, audio_s, card)
        serving_launches = serving(tar, paths, audio_s, card)
        tts_launches, tts_model = tts_path(tmp, opts.seed, card)
        lstm_takes_no_sync(tts_model, card)
        del tts_model
        csv_launches = csv_and_evaluate(tmp, tar, paths, y_dir, opts.seed, card)
        de_launches = de_path(tmp, opts.seed, card)
        de_scorers(opts.seed, card)
        train_launches, build_rows = training(tmp, tar, paths, opts.reps, card)
        with cudnn_deterministic():
            dp_launches, dp_rows = data_parallel(tmp, tar, paths, build_rows[0]["N"] // 64,
                                                 opts.reps, card)
        tool_launches, tool_row = tools_phase(tmp, opts.reps, card)
        parity_launches = parity_phase(tmp, card)
        m80_launches = eighty_mels(tmp, paths, audio_s, card)
    entry_launches, entry_rows = entry_points(opts.reps, card)
    import_check()  # phase 13, last: it covers the imports of phases 14 to 16

    fast, exact = main["fast"], main["exact"]
    record = {"kernels": [{
        "name": "fused_dft_mel",
        "route": "cuda",
        "source": "nisqa_tpu_torch/csrc/dft_mel.cu",
        "replaces": "nisqa_tpu/ops/pallas_mel.py:99",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results + build_rows + dp_rows + [tool_row]
                           + entry_rows),
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
        # phase 3 over 64 mel bands: m80 / m128 at 48 kHz, m80_16k / m128_16k at 16 kHz
        **{f"m{m}{'' if sr == 48000 else '_16k'}_{key}": value
           for m in (80, 128) for sr in (48000, 16000)
           for key, value in wide_fields(wide, m, sr).items()},
        # the device corpus's build: one 64-row chunk of the 48 kHz group, exact mode
        "corpus_build_shape": {k: build_rows[0][k] for k in ("sr", "N", "span", "K", "M")},
        "corpus_build_ms": build_rows[0]["kernel_ms"],
        "corpus_build_plain_ms": build_rows[0]["twin_ms"],
        "corpus_build_bound_ms": build_rows[0]["bound_ms"],
        "corpus_build_bound_by": build_rows[0]["bound_by"],
        # a W = 2 train step's fill: 16 rows of the 48 kHz group's bucket, exact mode
        "dp_shard_shape": {k: dp_rows[0][k] for k in ("sr", "N", "span", "K", "M")},
        "dp_shard_ms": dp_rows[0]["kernel_ms"],
        "dp_shard_plain_ms": dp_rows[0]["twin_ms"],
        "dp_shard_bound_ms": dp_rows[0]["bound_ms"],
        "dp_shard_bound_by": dp_rows[0]["bound_by"],
        # phase 14: bench's largest cold batch, fast mode
        "tools_bench_shape": {k: tool_row[k] for k in ("sr", "N", "span", "K", "M")},
        "tools_bench_ms": tool_row["kernel_ms"],
        "tools_bench_plain_ms": tool_row["twin_ms"],
        "tools_bench_bound_ms": tool_row["bound_ms"],
        "tools_bench_bound_by": tool_row["bound_by"],
        # phase 16: the dry run's cold batch of 2 rows at 8 kHz / 24 mels, exact mode
        "dryrun_shape": {k: entry_rows[0][k] for k in ("sr", "N", "span", "K", "M")},
        "dryrun_ms": entry_rows[0]["kernel_ms"],
        "dryrun_plain_ms": entry_rows[0]["twin_ms"],
        "dryrun_bound_ms": entry_rows[0]["bound_ms"],
        "dryrun_bound_by": entry_rows[0]["bound_by"],
        "launches_by_pass": {"predict_dir": launches, **serving_launches,
                             "tts_predict_dir": tts_launches, **csv_launches, **de_launches,
                             **train_launches, **tool_launches, **parity_launches,
                             **m80_launches},
        # phases 12 and 16: per rank
        "launches_by_rank": {**dp_launches, **entry_launches},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "nisqa_tpu_torch/csrc/bn_relu_pool.cu",
        "replaces": None,  # no TPU kernel: nisqa_tpu's batch norms and pools are plain XLA
        "max_rel_err_chain": max(r["max_rel_err_chain"] for r in bn_pool_rows if r["op"] == name),
        # phase 3b by case: the kernel, the chain it replaces, its plain version, the bound
        "cases": {r["case"]: {k: r[k] for k in ("x", "kernel_ms", "chain_ms", "plain_ms",
                                                "bound_ms")}
                  for r in bn_pool_rows if r["op"] == name},
    } for name in ("bn_relu_adaptive_max_pool", "bias_bn_relu")]}
    print(card_line(), flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
