"""Fused windowed-DFT magnitude -> mel projection: CUDA kernel and its twin.

Counterpart of ``nisqa_tpu/ops/pallas_mel.py::fused_dft_mel``:

    mel (N, M) = |frames @ w_re + i * frames @ w_im| @ fb

``fused_dft_mel`` launches the hand-written sm_90a kernel
(``csrc/dft_mel.cu``) for CUDA tensors and uses the plain PyTorch twin
``dft_mel_reference`` only for tensors that lie on the CPU. There is no
fallback from the kernel to the twin on the card: a build or launch failure
raises.

``bf16=True`` is the fast front-end: frames and DFT weights are rounded to
bf16, products and sums stay float32. The twin rounds the same operands the
same way, so kernel and twin differ only in summation order.
"""

from __future__ import annotations

import torch


def dft_mel_reference(frames, w_re, w_im, fb, bf16: bool = False):
    """Plain PyTorch version: materialises the (N, K) re / im products."""
    if bf16:
        frames, w_re, w_im = (t.to(torch.bfloat16).float() for t in (frames, w_re, w_im))
    return torch.sqrt((frames @ w_re) ** 2 + (frames @ w_im) ** 2) @ fb


def _check(frames, w_re, w_im, fb):
    ts = (frames, w_re, w_im, fb)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"fused_dft_mel takes float32 tensors, got {[t.dtype for t in ts]}")
    if any(t.dim() != 2 for t in ts):
        raise ValueError(f"fused_dft_mel takes 2-D tensors, got {[tuple(t.shape) for t in ts]}")
    n, span = frames.shape
    k = w_re.shape[1]
    if n < 1 or w_re.shape != (span, k) or w_im.shape != (span, k) or fb.shape[0] != k:
        raise ValueError(
            "fused_dft_mel wants frames (N>=1, span), w_re/w_im (span, K), fb (K, M); got "
            f"{tuple(frames.shape)}, {tuple(w_re.shape)}, {tuple(w_im.shape)}, {tuple(fb.shape)}"
        )
    if any(t.device != frames.device for t in ts):
        raise ValueError(f"fused_dft_mel inputs on several devices: {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_dft_mel takes contiguous tensors")


def fused_dft_mel(frames, w_re, w_im, fb, bf16: bool = False):
    """frames (N, span), w_re / w_im (span, K), fb (K, M), float32 -> (N, M).

    On a CUDA device this launches the kernel on the current stream, does
    not synchronise, and counts the launch in ``fused_dft_mel.LAUNCHES``.
    On the CPU it computes ``dft_mel_reference`` and counts nothing.
    """
    _check(frames, w_re, w_im, fb)
    if frames.device.type == "cpu":
        return dft_mel_reference(frames, w_re, w_im, fb, bf16)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_dft_mel runs on cuda or cpu tensors, got {frames.device}")

    from ._build import load_library

    lib = load_library()
    n, span = frames.shape
    k, m = fb.shape
    out = torch.empty((n, m), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        code = lib.nisqa_dft_mel(
            frames.data_ptr(), w_re.data_ptr(), w_im.data_ptr(), fb.data_ptr(),
            out.data_ptr(), n, span, k, m, int(bool(bf16)),
            torch.cuda.current_stream(frames.device).cuda_stream,
        )
    if code != 0:
        msg = lib.nisqa_cuda_error_string(code).decode()
        raise RuntimeError(
            f"dft_mel kernel launch failed: CUDA error {code} ({msg}) for "
            f"N={n} span={span} K={k} M={m} bf16={bool(bf16)}"
        )
    fused_dft_mel.LAUNCHES += 1
    return out


fused_dft_mel.LAUNCHES = 0
