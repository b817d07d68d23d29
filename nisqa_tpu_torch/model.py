"""Runtime orchestrator for prediction: args -> checkpoint -> engine -> CSV.

Counterpart of ``nisqa_tpu/model.py::NisqaTPU`` for ``predict_file`` and
``predict_dir``: the same flat args dict, the checkpoint args as the base
config that runtime args overwrite, the DIM / DE flags, and the same
``NISQA_results.csv`` (columns ``deg``, the ``*_pred`` columns, ``model``),
written with the standard library instead of pandas.

The device is the args key ``tr_device`` (the reference's): None means
"cuda", and a missing card raises instead of running on the CPU. Only an
explicit ``tr_device="cpu"`` runs on the CPU, with the kernels' plain twins.
"""

from __future__ import annotations

import csv
import os
from glob import glob

import torch

from .compat.checkpoint import build_from_args, load_torch_checkpoint
from .data.pipeline import InferenceEngine, MsConfig
from .models.nisqa import DIM_TARGETS


def resolve_device(tr_device) -> torch.device:
    """``tr_device`` (None = "cuda") -> torch.device; raises when CUDA is
    asked for and absent."""
    device = torch.device(tr_device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"tr_device={tr_device!r} needs CUDA, which is not available; "
            "pass tr_device='cpu' (--tr_device cpu) to run on the CPU"
        )
    return device


class NisqaTorch:
    """``NisqaTorch(args).predict()`` for modes predict_file / predict_dir."""

    def __init__(self, args: dict):
        self.args = dict(args)
        self.args.setdefault("mode", "main")
        self._load_model()
        self._load_paths()

    def _load_model(self):
        path = self.args.get("pretrained_model")
        if not path:
            raise ValueError(
                "pretrained_model is required: the port predicts from a checkpoint "
                "(training is not ported yet, ROADMAP.md Queue 1)")
        if not os.path.isabs(path):
            path = os.path.join(os.getcwd(), path)
        ckpt = load_torch_checkpoint(path)
        # checkpoint args are the base config; runtime args overwrite
        args = dict(ckpt["args"])
        args.update(self.args)
        self.args = args
        args["dim"] = args.get("model") == "NISQA_DIM"
        args["double_ended"] = args.get("model") == "NISQA_DE"

        self.device = resolve_device(args.get("tr_device"))
        model = build_from_args(args)
        print("Model architecture: " + args["model"])
        model.load_state_dict(ckpt["state_dict"], strict=True)
        self.model = model.to(self.device).eval()
        print("Loaded pretrained model from " + args["pretrained_model"])
        self.ms = MsConfig(args)

    def _load_paths(self):
        mode = self.args["mode"]
        if mode == "predict_file":
            self.paths = [self.args["deg"]]
        elif mode == "predict_dir":
            # *.wav like the reference, plus *.flac, which the decoder reads
            files = sorted(
                f for e in ("*.wav", "*.flac") for f in glob(os.path.join(self.args["data_dir"], e))
            )
            print(f"# files: {len(files)}")
            if not files:
                raise ValueError("No wav/flac files found in data_dir")
            self.paths = files
        elif mode in ("predict_csv", "main"):
            raise NotImplementedError(
                f"mode {mode!r} is not ported to nisqa_tpu_torch yet (ROADMAP.md Queue 1)")
        else:
            raise NotImplementedError(f"mode not available: {mode}")

    def _engine(self) -> InferenceEngine:
        args = self.args
        return InferenceEngine(
            self.model, self.ms, self.device,
            batch_size=int(args.get("tr_bs_val") or 1),
            num_workers=int(args.get("tr_num_workers") or 8),
            precision=args.get("precision") or "default",
            fe_precision=args.get("fe_precision"),
            # absent/null/true: cached passes run fused parts; false: per batch
            fuse_pass=args.get("fuse_pass"),
            # null keeps the default; an explicit 0 turns the cache off
            cache_mb=512 if args.get("serving_cache_mb") is None else args["serving_cache_mb"],
        )

    def predict(self) -> list[dict]:
        """Scores every path; returns one dict per file in CSV column order
        and writes ``NISQA_results.csv`` when ``output_dir`` is set."""
        print("---> Predicting ...")
        y = self._engine().predict_paths(self.paths)
        cols = [f"{t}_pred" for t in DIM_TARGETS] if self.args["dim"] else ["mos_pred"]
        rows = [
            {"deg": os.path.basename(p), **{c: float(y[i, j]) for j, c in enumerate(cols)}}
            for i, p in enumerate(self.paths)
        ]
        out_dir = self.args.get("output_dir")
        if out_dir:
            for r in rows:
                r["model"] = self.args["name"]
            with open(os.path.join(out_dir, "NISQA_results.csv"), "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
        _print_table(rows)
        return rows


def _print_table(rows):
    cols = list(rows[0])
    cells = [[str(r[c]) for c in cols] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells)) for i, c in enumerate(cols)]
    print(" ".join(c.rjust(w) for c, w in zip(cols, widths)))
    for row in cells:
        print(" ".join(v.rjust(w) for v, w in zip(row, widths)))
