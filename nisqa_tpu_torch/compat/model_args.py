"""Model-argument extraction from the flat ~70-key args dict.

Mirrors the key list the reference passes to its model constructors
(`nisqa/NISQA_model.py:958-1009`): mel-geometry, framewise,
two time-dependency blocks, pooling, and (for NISQA_DE) alignment/fusion.

The port's copy of ``nisqa_tpu/compat/model_args.py`` (same functions, same names), so the
port imports nothing of the JAX package; tests hold the two equal.
"""

from __future__ import annotations

MODEL_ARG_KEYS = (
    "ms_seg_length",
    "ms_n_mels",
    "cnn_model",
    "cnn_c_out_1",
    "cnn_c_out_2",
    "cnn_c_out_3",
    "cnn_kernel_size",
    "cnn_dropout",
    "cnn_pool_1",
    "cnn_pool_2",
    "cnn_pool_3",
    "cnn_fc_out_h",
    "td",
    "td_sa_d_model",
    "td_sa_nhead",
    "td_sa_pos_enc",
    "td_sa_num_layers",
    "td_sa_h",
    "td_sa_dropout",
    "td_lstm_h",
    "td_lstm_num_layers",
    "td_lstm_dropout",
    "td_lstm_bidirectional",
    "td_2",
    "td_2_sa_d_model",
    "td_2_sa_nhead",
    "td_2_sa_pos_enc",
    "td_2_sa_num_layers",
    "td_2_sa_h",
    "td_2_sa_dropout",
    "td_2_lstm_h",
    "td_2_lstm_num_layers",
    "td_2_lstm_dropout",
    "td_2_lstm_bidirectional",
    "pool",
    "pool_att_h",
    "pool_att_dropout",
)

DE_ARG_KEYS = ("de_align", "de_align_apply", "de_fuse_dim", "de_fuse")

DEFAULTS = {
    "ms_seg_length": 15,
    "ms_n_mels": 48,
    "cnn_model": "adapt",
    "cnn_c_out_1": 16,
    "cnn_c_out_2": 32,
    "cnn_c_out_3": 64,
    "cnn_kernel_size": 3,
    "cnn_dropout": 0.2,
    "cnn_pool_1": [24, 7],
    "cnn_pool_2": [12, 5],
    "cnn_pool_3": [6, 3],
    "cnn_fc_out_h": None,
    "td": "self_att",
    "td_sa_d_model": 64,
    "td_sa_nhead": 1,
    "td_sa_pos_enc": None,
    "td_sa_num_layers": 2,
    "td_sa_h": 64,
    "td_sa_dropout": 0.1,
    "td_lstm_h": 128,
    "td_lstm_num_layers": 1,
    "td_lstm_dropout": 0,
    "td_lstm_bidirectional": True,
    "td_2": "skip",
    "td_2_sa_d_model": 64,
    "td_2_sa_nhead": 1,
    "td_2_sa_pos_enc": None,
    "td_2_sa_num_layers": 2,
    "td_2_sa_h": 64,
    "td_2_sa_dropout": 0.1,
    "td_2_lstm_h": 128,
    "td_2_lstm_num_layers": 1,
    "td_2_lstm_dropout": 0,
    "td_2_lstm_bidirectional": True,
    "pool": "att",
    "pool_att_h": 128,
    "pool_att_dropout": 0.1,
    # DE defaults follow the shipped reference config
    # (`config/train_nisqa_double_ended.yaml:102-105`)
    "de_align": "cosine",
    "de_align_apply": "hard",
    "de_fuse_dim": None,
    "de_fuse": "x/y/-",
}


def model_args_from_ckpt_args(args: dict) -> dict:
    """Extract the model-architecture sub-dict from a full args dict."""
    out = {}
    keys = MODEL_ARG_KEYS + (DE_ARG_KEYS if args.get("model") == "NISQA_DE" else ())
    for k in keys:
        out[k] = args.get(k, DEFAULTS.get(k))
    return out
