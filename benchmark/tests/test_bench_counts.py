"""The frozen counts against the port's own FLOP tool at unpadded shapes,
and against closed forms."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.counts import peaks
from benchmark.counts.work import FrontEndWork, Tally, cnn_flops_per_segment, model_flops


def _dim():
    return harness.Cell("dim_corpus_cold").config


def test_adaptcnn_is_10160640_flops_a_segment():
    assert cnn_flops_per_segment(_dim()["args"]) == 10_160_640


@pytest.mark.parametrize("n", [1, 7, 150, 749])
@pytest.mark.parametrize("model", ["NISQA_DIM", "NISQA"])
def test_model_flops_equal_the_port_tool_at_unpadded_shapes(model, n):
    from nisqa_tpu_torch.models.nisqa import build_model
    from nisqa_tpu_torch.tools.flops import forward_flops

    args = _dim()["args"]
    m = build_model(model, args)
    port = sum(forward_flops(m, 1, n, args["ms_n_mels"], args["ms_seg_length"]).values())
    assert model_flops(args, 5 if model == "NISQA_DIM" else 1, n) == port


def test_front_end_counts_each_files_own_frames():
    from nisqa_tpu_torch.data.pipeline import MsConfig, front_end_consts

    args = _dim()["args"]
    fe = FrontEndWork(args, 48000)
    ms = MsConfig(args)
    for n in (48000 * 3, 48000 * 30 + 479):
        assert fe.frames(n) == ms.n_frames(n, 48000)
        assert fe.segments(n) == ms.n_wins(ms.n_frames(n, 48000))
    kept = front_end_consts(ms, 48000)["w_re"].shape[1]
    # the bins the filterbank reads (bins 1..1706 at 20 kHz), not the
    # program's kept bins padded to 128, and the band entries, not M x K
    assert fe.k == 1706 < kept == 1792
    assert fe.nnz < fe.k * args["ms_n_mels"] / 10
    assert fe.dft_flops(48000) == 4 * 101 * 960 * 1706


def test_tally_adds_files():
    t = Tally(_dim()["args"], 5, 48000)
    one, two = t.of([48000 * 3], True), t.of([48000 * 3] * 2, True)
    assert all(two[k] == 2 * one[k] for k in one)


def test_kernel_seconds_is_bound_by_the_operations_here():
    t = Tally(_dim()["args"], 5, 48000).of([48000 * 10], True)
    ops = t["dft"] / peaks.FLOPS["bf16"] + t["mel"] / peaks.FLOPS["fp32"]
    assert peaks.kernel_seconds(t, "fast") == pytest.approx(ops)
    assert peaks.kernel_seconds(t, "exact") > 5 * peaks.kernel_seconds(t, "fast")
    assert np.isclose(peaks.FLOPS["tf32"] * 2, 989.4e12)
