"""What the tools share: the serving regimes, the record's rate and MFU
fields, the device idle share and the peak rates of the card.

``chip_smoke.py`` takes :func:`idle_share` from here too.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops.dft_mel import fused_dft_mel

# Dense peaks of one NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data
# sheet: TF32 Tensor Core 989.4 TFLOP/s with sparsity, so 494.7 dense; FP32
# 66.9 TFLOP/s) at the 700 W limit, by the precision a pass runs at: TF32
# for matmuls and cuDNN at "default" (data/pipeline.py::matmul_precision),
# float32 at "highest".
PEAK_TFLOPS = {"default": 494.7, "highest": 66.9}


def device_args(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, which raises without a card; 'cpu' runs "
                         "the kernel's plain twin)")


def card(device: torch.device) -> str:
    """The device's name and power limit as ``nvidia-smi`` prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                        "-i", str(device.index or 0)],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def idle_share(fn, out=None):
    """(device busy s, wall s, idle share, {device item: ms}) of one call of
    ``fn``: the union of the device activity intervals in a
    ``torch.profiler`` trace over the host wall time of the call (which ends
    in a synchronise); prints the call's ten largest device items to ``out``
    (None: standard output). Returns None for the busy time and the share
    when the profiler records no device activity."""
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
          file=out or sys.stdout, flush=True)
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


def idle_of(fn, device) -> float | None:
    """The idle share of one call of ``fn`` on a CUDA ``device``; None on the
    CPU, or when the trace holds no device activity."""
    if device.type != "cuda":
        return None
    return idle_share(fn, out=sys.stderr)[2]


def _finite(y, what: str):
    if not np.isfinite(y).all():
        raise RuntimeError(f"{what}: non-finite predictions")


class Regimes:
    """``bench.py``'s run order over one warmed-up engine: ``passes``
    fetched passes (pass 0 cold, the rest cached), ``devrate_passes``
    fetch-free cached passes (``fetch=False``) and ``async_blocks`` blocks of
    ``async_depth`` cached ``fetch="async"`` passes, every handle resolved
    after its block was dispatched. With ``devrate_only`` the passes after
    the first are fetch-free and nothing else runs. Every pass's result is
    checked finite and held to the cold pass (``max_abs_diff``); each pass's
    kernel launches are counted."""

    def __init__(self, engine, paths, paths_ref=None):
        self.engine, self.paths, self.paths_ref = engine, list(paths), paths_ref
        self.walls = {}
        self.max_abs_diff = 0.0
        self.launches_cold = self.launches_cached = 0
        self.y_cold = None

    def _pass(self, fetch):
        return self.engine.predict_paths(self.paths, self.paths_ref, fetch=fetch)

    def _hold(self, y, what):
        _finite(y, what)
        self.max_abs_diff = max(self.max_abs_diff, float(np.abs(y - self.y_cold).max()))

    def run(self, passes=7, devrate_passes=3, async_blocks=3, async_depth=8, devrate_only=False):
        if passes < 2:
            raise ValueError(f"passes must be at least 2 (one cold, one cached), got {passes}")
        fetched = []
        for i in range(passes):
            fetch = not (devrate_only and i > 0)
            before = fused_dft_mel.LAUNCHES
            tic = time.perf_counter()
            y = self._pass(fetch)
            fetched.append(time.perf_counter() - tic)
            if i == 0:
                self.launches_cold = fused_dft_mel.LAUNCHES - before
                self.y_cold = y
                _finite(y, "cold pass")
            else:
                self.launches_cached += fused_dft_mel.LAUNCHES - before
                if fetch:
                    self._hold(y, f"fetched pass {i}")
            log(f"pass {i}: {self.engine.stats['last']}")
        self.walls["cold"] = fetched[0]
        if devrate_only:
            self.walls["devrate"] = fetched[1:]
            return self
        self.walls["fetched"] = fetched
        before = fused_dft_mel.LAUNCHES
        dev = []
        for _ in range(devrate_passes):
            tic = time.perf_counter()
            self._pass(False)
            dev.append(time.perf_counter() - tic)
        if dev:
            self.walls["devrate"] = dev
        blocks = []
        for b in range(async_blocks):
            tic = time.perf_counter()
            handles = [self._pass("async") for _ in range(async_depth)]
            ys = [h() for h in handles]
            blocks.append((time.perf_counter() - tic) / async_depth)
            for y in ys:
                self._hold(y, f"async block {b}")
            log(f"async block {b}: {self.engine.stats['last']}")
        if blocks:
            self.walls["async"] = blocks
        self.launches_cached += fused_dft_mel.LAUNCHES - before
        return self


def rate_fields(prefix: str, walls, audio_s: float) -> dict:
    """``<prefix>_best_pass``, ``_median`` (audio-s/s) and ``_n`` of a regime's walls."""
    return {f"{prefix}_best_pass": audio_s / min(walls),
            f"{prefix}_median": audio_s / float(np.median(walls)),
            f"{prefix}_n": len(walls)}


def regime_fields(reg: Regimes, audio_s: float) -> dict:
    """The rate fields of every regime ``reg`` ran, ``bench.py``'s names."""
    w = reg.walls
    out = {"cold_pass_rate": audio_s / w["cold"]}
    if "fetched" in w:
        out["fetched_best_pass"] = audio_s / min(w["fetched"])
        out.update(rate_fields("fetched_cached", w["fetched"][1:], audio_s))
    for regime in ("devrate", "async"):
        if regime in w:
            out.update(rate_fields(regime, w[regime], audio_s))
    return out


def mfu_fields(cached_flops: float, audio_s: float, headline_rate: float, peak_tflops: float,
               devrate_walls=None) -> dict:
    """``bench.py``'s MFU fields: the fetched, fetch-free and async regimes
    all run the cached pass, so one per-pass count turns the headline rate
    into sustained TFLOP/s and an MFU against ``peak_tflops``."""
    tflops = headline_rate / audio_s * cached_flops / 1e12
    out = {"flops_per_audio_s": cached_flops / audio_s, "tflops_sustained": tflops,
           "peak_tflops": peak_tflops, "mfu_pct": tflops / peak_tflops * 100}
    if devrate_walls:
        out["mfu_devrate_pct"] = cached_flops / min(devrate_walls) / 1e12 / peak_tflops * 100
    return out


def serving_extras(engine, paths, paths_ref, reg: Regimes, device, peak_bytes) -> dict:
    """The fields beside the rates: the idle share of one warm cached pass
    and of one warm cold pass (an engine without the corpus cache, warmed
    up and run once first), peak device memory of the regimes, the kernel's
    launches in the cold pass and in all the cached ones, and how far the
    cached passes came from the cold one."""
    from ..data.pipeline import InferenceEngine

    idle_cached = idle_of(lambda: engine.predict_paths(paths, paths_ref), device)
    idle_cold = None
    if device.type == "cuda":
        cold = InferenceEngine(engine.model, engine.ms, device, batch_size=engine.batch_size,
                               num_workers=engine.num_workers, precision=engine.precision,
                               fe_precision=engine.fe_precision, cache_mb=0)
        cold.warmup(paths, paths_ref)
        cold.predict_paths(paths, paths_ref)
        idle_cold = idle_of(lambda: cold.predict_paths(paths, paths_ref), device)
    return {"idle_cached_pass": idle_cached, "idle_cold_pass": idle_cold,
            "max_memory_allocated_gb": None if peak_bytes is None else peak_bytes / 1e9,
            "launches_cold_pass": reg.launches_cold, "launches_cached_passes": reg.launches_cached,
            "cached_max_abs_diff": reg.max_abs_diff, "precision": engine.precision,
            "fe_precision": engine.fe_precision}


def bench_serving(tar: str, paths, paths_ref, audio_s: float, device, *, batch_size: int,
                  precision=None, fe_precision=None, fuse_pass=None, cache_mb: float = 512,
                  passes: int = 7, devrate_passes: int = 3, async_blocks: int = 3,
                  async_depth: int = 8, devrate_only: bool = False, peak_tflops=None,
                  headline: str = "async") -> dict:
    """One serving tool's run: the checkpoint's engine on ``device``, its
    FLOP count over the plan (before anything is timed; a failure ends the
    run), ``warmup``, the :class:`Regimes`, and the record's fields:
    ``value`` (the best pass of the ``headline`` regime), the rate fields of
    every regime, the MFU fields against ``peak_tflops`` (None: the card's
    peak at the engine's precision) and :func:`serving_extras`."""
    from ..compat.checkpoint import load_model_from_tar
    from ..data.pipeline import InferenceEngine, MsConfig
    from .flops import count_engine

    model, args = load_model_from_tar(tar, device)
    engine = InferenceEngine(model, MsConfig(args), device, batch_size=batch_size,
                             precision=precision, fe_precision=fe_precision, fuse_pass=fuse_pass,
                             cache_mb=cache_mb)
    fl = count_engine(engine, paths, paths_ref)
    log(f"flops: {fl}")
    t0 = time.perf_counter()
    warmed = engine.warmup(paths, paths_ref)
    log(f"warmup: {len(warmed)} shapes in {time.perf_counter() - t0:.3f} s")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    reg = Regimes(engine, paths, paths_ref).run(passes, devrate_passes, async_blocks, async_depth,
                                                devrate_only)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if devrate_only:
        headline = "devrate"
    if headline not in reg.walls:
        raise ValueError(f"the headline regime {headline!r} did not run: {sorted(reg.walls)}")
    value = audio_s / min(reg.walls[headline])
    peak_tflops = peak_tflops or PEAK_TFLOPS[engine.precision]
    return {
        "value": value,
        "unit": "audio-sec/sec/chip",
        "total_audio_s": audio_s,
        "batch_size": batch_size,
        "plan_batches": fl["plan_batches"],
        **regime_fields(reg, audio_s),
        "cached_flops_per_pass": fl["cached_flops_per_pass"],
        "cold_flops_per_pass": fl["cold_flops_per_pass"],
        **mfu_fields(fl["cached_flops_per_pass"], audio_s, value, peak_tflops,
                     reg.walls.get("devrate")),
        **serving_extras(engine, paths, paths_ref, reg, device, peak),
        "device": card(device),
    }
