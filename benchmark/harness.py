"""The benchmark of nisqa_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to a configuration, a traffic mix, a cell or a
per-layer metric is a file of its own, found by the names in
``BENCHMARK.json``: ``configs/<config>.json`` (the sizes as run),
``traffic/<mix>.json`` (the mix's parameters and the driver that runs it,
``drivers/<driver>.py``), ``workloads/<cell>.json`` (the limits of the
comparison that decides ``correct``) and ``metrics/<metric>.py`` (a reader
of one per-layer metric).

A run: set-up (corpus, weights, the program's engine, warm-up), the
measured window, the device's peak memory, then the program's state freed
and its outputs compared with the plain reference (``reference/``). With
``--trace 1`` the window runs under ``torch.profiler`` and the line carries
the per-layer metrics, ``busy_s`` / ``window_s`` and the breakdown; with
``--trace 0``, the end-to-end metrics. The last line of standard output is
the result; the numbers compared, each with its limit, are the last lines
of standard error and the last key of the result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "nisqa_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cache_env(root: str = ROOT):
    """Build and kernel caches at fixed paths inside the checkout. (The
    port's own build directory, ``nisqa_tpu_torch/_build/``, is there too.)"""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """A module of the benchmark by its path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``BENCHMARK.json``'s workloads and the files it names.
    A cell file (``workloads/<cell>.json``) of a cell that BENCHMARK.json
    does not hold carries the entry itself (``entry``), so that the sweep
    tool and the tests can run it."""

    def __init__(self, name: str, root: str = ROOT):
        self.bench = read_json(root, "BENCHMARK.json")
        path = os.path.join(HERE, "workloads", name + ".json")
        cell = read_json(path) if os.path.isfile(path) else {}
        entry = {w["name"]: w for w in self.bench["workloads"]}.get(name) or cell.get("entry")
        if entry is None or "limits" not in cell:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                             f"{sorted(w['name'] for w in self.bench['workloads'])}")
        self.name, self.entry = name, entry
        conf = {c["name"]: c for c in self.bench["configs"]}[entry["config"]]
        self.config = read_json(root, conf["file"])
        self.traffic = read_json(HERE, "traffic", entry["traffic"] + ".json")
        self.limits = cell["limits"]
        self.chips = int(entry["chips"])

    def metrics(self, kind: str):
        """The cell's ``end_to_end`` or ``per_layer`` entries."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


class Ctx:
    """What a driver gets: the cell, the run's seed, window and device, a
    scratch directory under TMPDIR, and the time the process started."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
                 t_start: float, tmp: str):
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device, self.t_start, self.tmp = device, t_start, tmp
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_name() -> str:
    """``name, power.limit`` of card 0 from nvidia-smi, or the torch name alone."""
    import torch

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=30, check=True)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def run_cell(cell: Cell, seed, seconds, trace, t_start, device="cuda") -> dict:
    """Runs the cell once and returns the result (without printing it)."""
    import torch

    tmp = tempfile.mkdtemp(prefix=f"bench_{cell.name}_")
    try:
        ctx = Ctx(cell, seed, seconds, trace, device, t_start, tmp)
        driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
        out = driver.run(ctx)
        cuda = torch.device(device).type == "cuda"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        out.release()
        if cuda:
            torch.cuda.empty_cache()
        checks = out.check()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct = out.failed == 0 and all(v <= lim for _, v, lim in checks)
    res = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed}
    if trace:
        metrics = {}
        for m in cell.metrics("per_layer"):
            reader = load_file(os.path.join(HERE, "metrics", m["name"] + ".py"), f"metric_{m['name']}")
            v = reader.read(out)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    res["metrics"] = metrics
    res["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                     "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and out.trace is not None:
        res["device"]["busy_s"] = out.trace.busy_s
        res["device"]["window_s"] = out.trace.window_s
        res["breakdown"] = out.trace.breakdown()
    res["check"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return res


def forbidden_modules():
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None, t_start=None) -> int:
    import time

    t_start = time.perf_counter() if t_start is None else t_start
    opts = parse(argv)
    cache_env()
    cell = Cell(opts.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_name()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = run_cell(cell, opts.seed, opts.seconds, bool(opts.trace), t_start)
    found = forbidden_modules()
    if found:
        log(f"the run imported {found}: the benchmark runs the port alone")
        return 3
    for name, c in res["check"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(res), flush=True)
    return 0
