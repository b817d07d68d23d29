"""Evaluation / conformance script of the PyTorch port, the counterpart of
the JAX package's ``run_evaluate.py``.

Evaluates a trained model on a labelled dataset CSV: predicts, then
computes per-db / per-condition metrics with a first-order mapping. If a
'csv_con' CSV with per-condition MOS is given, both CSVs need a 'con'
column. Edit the args dict below (paths to the NISQA Corpus) and run

    python -m nisqa_tpu_torch.run_evaluate

The device is CUDA; set "tr_device" to "cpu" to run on the CPU.
"""

from nisqa_tpu_torch.model import NisqaTorch
from nisqa_tpu_torch.parallel.mesh import destroy_data_parallel

if __name__ == "__main__":
    args = {
        "mode": "predict_csv",
        "pretrained_model": "weights/nisqa.tar",
        "data_dir": "/path/to/NISQA_Corpus",
        "output_dir": "/path/to/NISQA_Corpus",
        "csv_file": "NISQA_corpus_file.csv",
        "csv_con": "NISQA_corpus_con.csv",
        "csv_deg": "filepath_deg",
        "csv_mos_val": "mos",
        "tr_num_workers": 6,
        "tr_bs_val": 40,
        "ms_channel": None,
        "tr_device": None,
    }

    try:
        nisqa = NisqaTorch(args)
        nisqa.predict()
        nisqa.evaluate(mapping="first_order", do_print=True, do_plot=True)
    finally:
        destroy_data_parallel()
