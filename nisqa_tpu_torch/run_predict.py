"""Prediction CLI of the PyTorch port: the flags of the JAX package's
``run_predict.py`` plus ``--tr_device``.

Examples:
  python -m nisqa_tpu_torch.run_predict --mode predict_file --pretrained_model weights/nisqa.tar --deg /path/to/wav --output_dir out/
  python -m nisqa_tpu_torch.run_predict --mode predict_dir  --pretrained_model weights/nisqa.tar --data_dir /folder/with/wavs --output_dir out/ --bs 32
  python -m nisqa_tpu_torch.run_predict --mode predict_csv  --pretrained_model weights/nisqa.tar --csv_file f.csv --csv_deg column_name --data_dir dir --output_dir out/

The device defaults to CUDA; ``--tr_device cpu`` is the only way to run on
the CPU. Under ``torchrun`` with ``tr_parallel`` in the checkpoint's args,
each rank scores whole batches and rank 0 writes the results.
"""

from __future__ import annotations

import argparse

from .model import NisqaTorch
from .parallel.mesh import destroy_data_parallel


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m nisqa_tpu_torch.run_predict")
    parser.add_argument("--mode", required=True, type=str,
                        help="prediction mode: predict_file | predict_dir | predict_csv")
    parser.add_argument("--pretrained_model", required=True, type=str,
                        help="checkpoint .tar to load (path relative to the working directory)")
    parser.add_argument("--deg", type=str, help="degraded speech wav to score (predict_file mode)")
    parser.add_argument("--data_dir", type=str, help="directory whose wavs are scored (predict_dir mode)")
    parser.add_argument("--output_dir", type=str, help="where NISQA_results.csv is written")
    parser.add_argument("--csv_file", type=str, help="dataset csv listing the files to score (predict_csv mode)")
    parser.add_argument("--csv_deg", type=str, help="csv column holding each file's name or path")
    parser.add_argument("--num_workers", type=int, default=0, help="host-side decode thread count")
    parser.add_argument("--bs", type=int, default=1, help="inference batch size")
    parser.add_argument("--ms_channel", type=int, help="which channel to use for stereo inputs")
    parser.add_argument("--tr_device", type=str,
                        help="torch device (default cuda; 'cpu' runs the plain kernel twins)")
    args = vars(parser.parse_args(argv))

    if args["mode"] == "predict_file":
        if args["deg"] is None:
            raise ValueError("--deg argument with path to input file needed")
    elif args["mode"] == "predict_dir":
        if args["data_dir"] is None:
            raise ValueError("--data_dir argument with folder with input files needed")
    elif args["mode"] == "predict_csv":
        if args["csv_file"] is None:
            raise ValueError("--csv_file argument with csv file name needed")
        if args["csv_deg"] is None:
            raise ValueError("--csv_deg argument with csv column name of the filenames needed")
        if args["data_dir"] is None:
            args["data_dir"] = ""
    else:
        raise NotImplementedError("--mode given not available")

    args["tr_bs_val"] = args["bs"]
    args["tr_num_workers"] = args["num_workers"]
    return args


def main(argv=None) -> NisqaTorch:
    """Predicts as the CLI does; returns the runner (its ``ds_val.df`` holds
    the results, its ``engine`` the serving engine)."""
    nisqa = NisqaTorch(parse_args(argv))
    nisqa.predict()
    return nisqa


if __name__ == "__main__":
    try:
        main()
    finally:
        destroy_data_parallel()
