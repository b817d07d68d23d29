"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 --seconds 3 [--control]

For each seed it runs the cell as a run does (set-up, a short window of the
timed path at the cell's sizes, the comparison with the reference) and
prints one JSON line: the numbers compared (the lower readings: sound runs
of the program) and, with ``--control``, the same numbers of the control
put in the program's place:

  * scoring cells: the reference in bfloat16, the precision below the
    configuration's (TF32 products with bfloat16 DFT operands), against the
    float32 reference over every file of the corpus;
  * training cells: the reference with TF32 on in cuBLAS and cuDNN (the
    configuration trains in float32), and the reference with half of each
    batch left out, the mean taken over the rest (a planted fault), each
    against the float32 reference over the same steps and masks; a step
    that returns its state unchanged reads 1 on ``step_gap`` by its
    definition and needs no run; the program's masks read against keep
    probabilities 0.05 off the configuration's (``mask_z`` of dropout drawn
    at a rate it does not state); and, for the look at the program's own
    readings, its worst leaves and each step's loss gap.

The benchmark's own runs never run this; it is how the limits in
``workloads/<cell>.json`` were read (PERF.md gives the readings).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def control(out, cell) -> dict:
    import torch

    if cell.traffic["driver"] == "train_epochs":
        from benchmark.reference import nisqa_ref, train_ref

        i = out.inputs
        args = (i["state"], i["spec"], i["pcm"], i["mos"], i["cfg"], i["sr"], i["bs"], i["order"],
                i["masks"], i["n_steps"], i["device"])
        base = train_ref.steps(*args)
        p0 = {n: i["state"][n].float() for n in nisqa_ref.leaves(i["spec"])}
        tf32 = train_ref.compare(train_ref.steps(*args, tf32=True), base, p0)
        half = train_ref.compare(train_ref.steps(*args, half=True), base, p0)
        prog = out.program
        sound = train_ref.compare((prog["losses"], prog["grads"], prog["params"]), base, p0)
        rate = {"mask_z": min(train_ref.mask_z(i["masks"], i["cfg"], s) for s in (-0.05, 0.05))}
        return {"program_leaves": sound, "tf32": tf32, "half_batch": half, "dropout_rate": rate}
    sc = out.scoring
    files = list(range(len(sc.paths)))
    y_ctrl = sc.reference(files, torch.bfloat16)
    return {"bf16": {"pred_gap": sc.gap(y_ctrl, files)}}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    opts = ap.parse_args(argv)
    harness.cache_env()
    import importlib

    import torch

    cell = harness.Cell(opts.workload)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in opts.seeds.split(",")):
        tmp = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"readings_{os.getpid()}_{seed}")
        os.makedirs(tmp)
        t0 = time.perf_counter()
        ctx = harness.Ctx(cell, seed, opts.seconds, False, device, t0, tmp)
        out = driver.run(ctx)
        out.release()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        rec = {"seed": seed, "program": {n: v for n, v, _ in out.check()},
               "e2e": out.e2e, "failed": out.failed}
        if opts.control:
            rec["control"] = control(out, cell)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        shutil.rmtree(tmp, ignore_errors=True)
        del out
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
