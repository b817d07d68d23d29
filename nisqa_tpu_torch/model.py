"""Runtime orchestrator: args -> model -> datasets -> train / predict /
evaluate.

Counterpart of ``nisqa_tpu/model.py::NisqaTPU`` for the modes predict_file,
predict_dir, predict_csv and main (training), and for ``evaluate``: the same
flat args dict, the checkpoint args as the base config that runtime args
overwrite, the same argument normalisation (DIM / DE flags; NISQA_DIM has no
``csv_mos_*`` column, a single-ended model no ``csv_ref``), the same
``NISQA_results.csv`` (every input column in input order, the ``*_pred``
columns, ``model``), the same per-run YAML and the same metrics, on the
port's pandas-free :class:`.data.dataset.Table`.

The device is the args key ``tr_device`` (the reference's): None means
"cuda", and a missing card raises instead of running on the CPU. Only an
explicit ``tr_device="cpu"`` runs on the CPU, with the kernels' plain twins.

Data parallel (``tr_parallel`` under ``torchrun``): the runner joins the
process group (:func:`.parallel.mesh.init_data_parallel`) before it builds
anything on the device, takes its rank's card, starts from rank 0's
weights, and gives the group to the serving engine and the train engine.
Files (the results CSV, the run's YAML, checkpoints) are written and the
runner's prints made on rank 0 only. ``profile_dir`` traces ``predict``
and ``train`` with ``torch.profiler`` into one Chrome trace per rank.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from glob import glob

import numpy as np
import torch

from .audio import codec
from .compat import yaml_lite
from .compat.checkpoint import build_from_args, load_torch_checkpoint
from .data.dataset import SpeechDataset, Table
from .data.pipeline import InferenceEngine, MsConfig
from .eval.report import eval_results
from .parallel.mesh import broadcast_module, init_data_parallel


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
    predict_file, predict_dir and predict_csv; ``.train()`` for mode main."""

    def __init__(self, args: dict):
        self.args = dict(args)
        self.args.setdefault("mode", "main")
        self.runinfos = {}
        self.engine = None
        self.dp = None  # the rank's DataParallel record under a launcher
        self.log = print  # the runner's prints: a no-op on ranks other than 0
        self._load_model()
        self._load_datasets()
        now = [datetime.datetime.today()]
        if self.dp is not None:  # one run name on every rank
            torch.distributed.broadcast_object_list(now, src=0, group=self.dp.group)
        self.args["now"] = now[0]
        if self.args["mode"] == "main":
            self.log(yaml_lite.dumps(self.args))

    @property
    def is_main(self) -> bool:
        """Whether this process writes the run's files: rank 0, or the only one."""
        return self.dp is None or self.dp.rank == 0

    def _load_model(self):
        ckpt = None
        if self.args.get("pretrained_model"):
            path = self.args["pretrained_model"]
            if not os.path.isabs(path):
                path = os.path.join(os.getcwd(), path)
            ckpt = load_torch_checkpoint(path)
            # checkpoint args are the base config; runtime args overwrite
            args = dict(ckpt["args"])
            args.update(self.args)
            self.args = args
        args = self.args
        args["dim"] = args.get("model") == "NISQA_DIM"
        if args["dim"]:
            args["csv_mos_train"] = None
            args["csv_mos_val"] = None
        args["double_ended"] = args.get("model") == "NISQA_DE"
        if not args["double_ended"]:
            args["csv_ref"] = None

        self.device = resolve_device(args.get("tr_device"))
        # the group and the rank's card come before any stream or generator
        self.dp = init_data_parallel(args, self.device)
        if self.dp is not None:
            self.device = self.dp.device
            if self.dp.rank != 0:
                self.log = _no_print
        if ckpt is not None:
            model = build_from_args(args)
            self.log("Model architecture: " + args["model"])
            model.load_state_dict(ckpt["state_dict"], strict=True)
            self.log("Loaded pretrained model from " + args["pretrained_model"])
        else:
            # a fresh model from the args' seed, leaving the global generator as it was
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(int(args.get("seed") or 0))
                model = build_from_args(args)
            self.log("Model architecture: " + args["model"])
        self.model = model.to(self.device).eval()
        if self.dp is not None:
            broadcast_module(self.model, self.dp.group)
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
            self._load_csv_train()
        else:
            raise NotImplementedError(f"mode not available: {mode}")

    def _mk_ds(self, df, df_con, data_dir, filename_column, ref_col=None,
               mos_column="predict_only"):
        return SpeechDataset(df, df_con=df_con, data_dir=data_dir,
                             filename_column=filename_column, mos_column=mos_column,
                             filename_column_ref=ref_col, dim=self.args["dim"],
                             double_ended=self.args["double_ended"])

    def _load_csv_train(self):
        """The train and validation sets: the rows of ``csv_file`` (and of
        ``csv_con``) whose ``db`` is in ``csv_db_train`` / ``csv_db_val``,
        each with the ``index`` column of its rows in the file (pandas'
        ``reset_index``)."""
        args = self.args
        data_dir = args["data_dir"]
        dfile = Table.read_csv(os.path.join(data_dir, args["csv_file"]))
        requested = list(args["csv_db_train"]) + list(args["csv_db_val"])
        missing = set(requested).difference(dfile["db"].tolist())
        if missing:
            raise ValueError(f"Not all dbs found in csv: {missing}")

        def select(table, dbs):
            mask = np.isin(table["db"], list(dbs))
            return Table({"index": np.nonzero(mask)[0],
                          **{c: table[c][mask] for c in table.columns}})

        dcon_train = dcon_val = None
        if args.get("csv_con"):
            dcon = Table.read_csv(os.path.join(data_dir, args["csv_con"]))
            dcon_train, dcon_val = select(dcon, args["csv_db_train"]), select(dcon, args["csv_db_val"])
        df_train, df_val = select(dfile, args["csv_db_train"]), select(dfile, args["csv_db_val"])
        self.log(f"Training size: {len(df_train)}, Validation size: {len(df_val)}")
        self.ds_train = self._mk_ds(df_train, dcon_train, data_dir, args["csv_deg"],
                                    ref_col=args.get("csv_ref"),
                                    mos_column=args.get("csv_mos_train"))
        self.ds_val = self._mk_ds(df_val, dcon_val, data_dir, args["csv_deg"],
                                  ref_col=args.get("csv_ref"), mos_column=args.get("csv_mos_val"))
        self.runinfos["ds_train_len"] = len(self.ds_train)
        self.runinfos["ds_val_len"] = len(self.ds_val)

    def _load_dir(self):
        # *.wav like the reference, plus *.flac, which the decoder reads, and
        # the compressed formats when the FFmpeg libraries are present
        exts = ["*.wav", "*.flac"]
        if codec.available():
            exts += ["*.mp3", "*.ogg", "*.m4a", "*.opus"]
        files = sorted(f for e in exts for f in glob(os.path.join(self.args["data_dir"], e)))
        self.log(f"# files: {len(files)}")
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
                mesh=self.dp,
            )
        return self.engine

    def _profiled(self):
        """A ``torch.profiler`` trace of the enclosed work (host and, on the
        card, device activity) written to ``profile_dir`` as one Chrome trace
        per rank, when the args set ``profile_dir``; else nothing."""
        trace_dir = self.args.get("profile_dir")
        if not trace_dir:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        rank = 0 if self.dp is None else self.dp.rank
        path = os.path.join(trace_dir, f"{self.args['mode']}_rank{rank}.pt.trace.json")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=lambda p: p.export_chrome_trace(path))

    def predict(self) -> Table:
        """Scores every path; adds the ``*_pred`` columns to the dataset's
        table, writes it as ``NISQA_results.csv`` (with ``model``) when
        ``output_dir`` is set, prints it and returns it."""
        self.log("---> Predicting ...")
        with self._profiled():
            y_hat = self._engine().predict_paths(self.ds_val.paths(), self.ds_val.paths_ref())
        self.ds_val.write_predictions(y_hat)
        df = self.ds_val.df
        if self.args.get("output_dir"):
            df["model"] = self.args["name"]
            if self.is_main:
                df.to_csv(os.path.join(self.args["output_dir"], "NISQA_results.csv"))
        self.log(df.to_string())
        return df

    # -- training ------------------------------------------------------------

    def train(self):
        """Mode main: trains as the args say (``train_dim`` for NISQA_DIM,
        ``train_mos`` otherwise); the train engine stays in ``train_engine``."""
        from .train.loop import train_dim, train_mos

        with self._profiled():
            if self.args["dim"]:
                train_dim(self)
            else:
                train_mos(self)

    def _make_runname_and_write_yaml(self):
        """``<name>_<now>``: creates ``output_dir/<runname>/`` and writes the
        args (without ``now``) there as ``<runname>.yaml`` (on rank 0)."""
        runname = self.args["name"] + "_" + self.args["now"].strftime("%y%m%d_%H%M%S%f")
        self.log("runname: " + runname)
        if self.is_main:
            run_dir = os.path.join(self.args["output_dir"], runname)
            os.makedirs(run_dir, exist_ok=True)
            yaml_lite.dump({k: v for k, v in self.args.items() if k != "now"},
                           os.path.join(run_dir, runname + ".yaml"))
        return runname

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, mapping="first_order", do_print=True, do_plot=False):
        """Metrics of the predictions against the table's labels (after
        :meth:`predict`): ``self.r`` and the per-db results, as
        ``NisqaTPU.evaluate`` sets them."""
        if self.args["dim"]:
            self._evaluate_dim(mapping, do_print, do_plot)
        else:
            self.log("--> MOS:")
            self.db_results, self.r = self._eval_one("mos", "mos_pred", mapping, do_print, do_plot)

    def _eval_one(self, target, pred, mapping, do_print, do_plot):
        db_results, r = eval_results(
            self.ds_val.df, dcon=self.ds_val.df_con, target_mos=target,
            target_ci=f"{target}_ci", pred=pred, mapping=mapping,
            do_print=do_print and self.is_main, do_plot=do_plot and self.is_main,
            plot_dir=self.args.get("output_dir"),
        )
        if self.ds_val.df_con is None:
            self.log(f"r_p_mean_file: {r['r_p_mean_file']:0.2f}, "
                     f"rmse_mean_file: {r['rmse_mean_file']:0.2f}")
        else:
            self.log(
                f"r_p_mean_con: {r['r_p_mean_con']:0.2f}, rmse_mean_con: {r['rmse_mean_con']:0.2f}, "
                f"rmse_star_map_mean_con: {r['rmse_star_map_mean_con']:0.2f}"
            )
        return db_results, r

    def _evaluate_dim(self, mapping, do_print, do_plot):
        targets = [("mos", "MOS"), ("noi", "NOI"), ("dis", "DIS"), ("col", "COL"), ("loud", "LOUD")]
        self.r = {}
        for t, label in targets:
            self.log(f"--> {label}:")
            db_res, r = self._eval_one(t, f"{t}_pred", mapping, do_print, do_plot)
            setattr(self, f"db_results_val_{t}", db_res)
            self.r.update({(k if t == "mos" else f"{k}_{t}"): v for k, v in r.items()})
        # printed whether or not a condition CSV was given, like the
        # reference: without one the con averages, and so this line, are NaN
        r_mean = np.mean(
            [self.r["r_p_mean_con"]] + [self.r[f"r_p_mean_con_{t}"] for t, _ in targets[1:]]
        )
        self.log(f"\nAverage over MOS and dimensions: r_p={r_mean:0.3f}")


def _no_print(*args, **kwargs):
    """The runner's ``log`` on ranks other than 0."""
