"""Runtime orchestrator for prediction and evaluation: args -> checkpoint ->
engine -> CSV -> metrics.

Counterpart of ``nisqa_tpu/model.py::NisqaTPU`` for the modes predict_file,
predict_dir and predict_csv and for ``evaluate``: the same flat args dict,
the checkpoint args as the base config that runtime args overwrite, the DIM
/ DE flags, the same ``NISQA_results.csv`` (every input column in input
order, the ``*_pred`` columns, ``model``) and the same metrics, on the
port's pandas-free :class:`.data.dataset.Table`.

The device is the args key ``tr_device`` (the reference's): None means
"cuda", and a missing card raises instead of running on the CPU. Only an
explicit ``tr_device="cpu"`` runs on the CPU, with the kernels' plain twins.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
import torch

from .audio import codec
from .compat.checkpoint import build_from_args, load_torch_checkpoint
from .data.dataset import SpeechDataset, Table
from .data.pipeline import InferenceEngine, MsConfig
from .eval.report import eval_results


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
    """``NisqaTorch(args).predict()`` / ``.evaluate()`` for modes
    predict_file, predict_dir and predict_csv."""

    def __init__(self, args: dict):
        self.args = dict(args)
        self.args.setdefault("mode", "main")
        self.engine = None
        self._load_model()
        self._load_datasets()

    def _load_model(self):
        path = self.args.get("pretrained_model")
        if not path:
            raise ValueError(
                "pretrained_model is required: the port predicts from a checkpoint "
                "(training is not ported yet, ROADMAP.md Queue 1 item 6)")
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

    # -- datasets ------------------------------------------------------------

    def _load_datasets(self):
        mode = self.args["mode"]
        if self.args["double_ended"] and mode in ("predict_file", "predict_dir"):
            raise ValueError(
                f"NISQA_DE scores a degraded file against its reference: mode {mode} has no "
                "reference column; use predict_csv with csv_deg and csv_ref")
        if mode == "predict_file":
            deg = self.args["deg"]
            df = Table({"deg": np.array([os.path.basename(deg)], dtype=object)})
            self.ds_val = self._mk_ds(df, None, os.path.dirname(deg), "deg")
        elif mode == "predict_dir":
            self._load_dir()
        elif mode == "predict_csv":
            data_dir = self.args.get("data_dir") or ""
            df = Table.read_csv(os.path.join(data_dir, self.args["csv_file"]))
            if self.args["double_ended"] and not self.args.get("csv_ref"):
                raise ValueError("NISQA_DE needs csv_ref, the csv column of the reference files")
            dcon = None
            if self.args.get("csv_con"):
                dcon = Table.read_csv(os.path.join(data_dir, self.args["csv_con"]))
            self.ds_val = self._mk_ds(df, dcon, data_dir, self.args["csv_deg"],
                                      ref_col=self.args.get("csv_ref"))
        elif mode == "main":
            raise NotImplementedError(
                "mode 'main' (training) is not ported to nisqa_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 6)")
        else:
            raise NotImplementedError(f"mode not available: {mode}")

    def _mk_ds(self, df, df_con, data_dir, filename_column, ref_col=None):
        return SpeechDataset(df, df_con=df_con, data_dir=data_dir,
                             filename_column=filename_column, mos_column="predict_only",
                             filename_column_ref=ref_col, dim=self.args["dim"],
                             double_ended=self.args["double_ended"])

    def _load_dir(self):
        # *.wav like the reference, plus *.flac, which the decoder reads, and
        # the compressed formats when the FFmpeg libraries are present
        exts = ["*.wav", "*.flac"]
        if codec.available():
            exts += ["*.mp3", "*.ogg", "*.m4a", "*.opus"]
        files = sorted(f for e in exts for f in glob(os.path.join(self.args["data_dir"], e)))
        print(f"# files: {len(files)}")
        if not files:
            raise ValueError("No wav/flac files found in data_dir")
        df = Table({"deg": np.array([os.path.basename(f) for f in files], dtype=object)})
        self.ds_val = self._mk_ds(df, None, self.args["data_dir"], "deg")

    # -- prediction ----------------------------------------------------------

    def _engine(self) -> InferenceEngine:
        if self.engine is None:
            args = self.args
            self.engine = InferenceEngine(
                self.model, self.ms, self.device,
                batch_size=int(args.get("tr_bs_val") or 1),
                num_workers=int(args.get("tr_num_workers") or 8),
                precision=args.get("precision") or None,  # None = engine auto
                fe_precision=args.get("fe_precision"),
                # absent/null/true: cached passes run fused parts; false: per batch
                fuse_pass=args.get("fuse_pass"),
                # null keeps the default; an explicit 0 turns the cache off
                cache_mb=512 if args.get("serving_cache_mb") is None else args["serving_cache_mb"],
            )
        return self.engine

    def predict(self) -> Table:
        """Scores every path; adds the ``*_pred`` columns to the dataset's
        table, writes it as ``NISQA_results.csv`` (with ``model``) when
        ``output_dir`` is set, prints it and returns it."""
        print("---> Predicting ...")
        y_hat = self._engine().predict_paths(self.ds_val.paths(), self.ds_val.paths_ref())
        self.ds_val.write_predictions(y_hat)
        df = self.ds_val.df
        if self.args.get("output_dir"):
            df["model"] = self.args["name"]
            df.to_csv(os.path.join(self.args["output_dir"], "NISQA_results.csv"))
        print(df.to_string())
        return df

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, mapping="first_order", do_print=True, do_plot=False):
        """Metrics of the predictions against the table's labels (after
        :meth:`predict`): ``self.r`` and the per-db results, as
        ``NisqaTPU.evaluate`` sets them."""
        if self.args["dim"]:
            self._evaluate_dim(mapping, do_print, do_plot)
        else:
            print("--> MOS:")
            self.db_results, self.r = self._eval_one("mos", "mos_pred", mapping, do_print, do_plot)

    def _eval_one(self, target, pred, mapping, do_print, do_plot):
        db_results, r = eval_results(
            self.ds_val.df, dcon=self.ds_val.df_con, target_mos=target,
            target_ci=f"{target}_ci", pred=pred, mapping=mapping, do_print=do_print,
            do_plot=do_plot, plot_dir=self.args.get("output_dir"),
        )
        if self.ds_val.df_con is None:
            print(f"r_p_mean_file: {r['r_p_mean_file']:0.2f}, rmse_mean_file: {r['rmse_mean_file']:0.2f}")
        else:
            print(
                f"r_p_mean_con: {r['r_p_mean_con']:0.2f}, rmse_mean_con: {r['rmse_mean_con']:0.2f}, "
                f"rmse_star_map_mean_con: {r['rmse_star_map_mean_con']:0.2f}"
            )
        return db_results, r

    def _evaluate_dim(self, mapping, do_print, do_plot):
        targets = [("mos", "MOS"), ("noi", "NOI"), ("dis", "DIS"), ("col", "COL"), ("loud", "LOUD")]
        self.r = {}
        for t, label in targets:
            print(f"--> {label}:")
            db_res, r = self._eval_one(t, f"{t}_pred", mapping, do_print, do_plot)
            setattr(self, f"db_results_val_{t}", db_res)
            self.r.update({(k if t == "mos" else f"{k}_{t}"): v for k, v in r.items()})
        # printed whether or not a condition CSV was given, like the
        # reference: without one the con averages, and so this line, are NaN
        r_mean = np.mean(
            [self.r["r_p_mean_con"]] + [self.r[f"r_p_mean_con_{t}"] for t, _ in targets[1:]]
        )
        print(f"\nAverage over MOS and dimensions: r_p={r_mean:0.3f}")
