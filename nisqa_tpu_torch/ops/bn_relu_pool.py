"""The eval epilogue of AdaptCNN's convolutions: CUDA kernels and their plain
versions. Every AdaptCNN block in eval without autograd (serving,
validation) runs its convolution without the bias, then one of these:

    bias_bn_relu (blocks 3, 5, 6):
        out = relu(batch_norm(x + b, running stats))
    bn_relu_adaptive_max_pool (blocks 1, 2, 4):
        out = adaptive_max_pool2d(relu(batch_norm(x + b, running stats)), (oh, ow))

with x the convolution's output and b its bias. Each launches a
hand-written kernel (``csrc/bn_relu_pool.cu``) for CUDA tensors and uses the
plain PyTorch version (``*_reference``) only for tensors that lie on the
CPU. There is no fallback from a kernel to the plain version on the card: a
build or launch failure raises.

They replace no TPU kernel: ``nisqa_tpu``'s convolutions, batch norms and
adaptive pools are plain XLA. They are bound by bytes: each reads the
convolution's output once and writes its result once (the pooled values
only, no indices), where the chain of ATen's bias ``add_``, cuDNN's batch
norm, ``F.relu`` (and ``F.adaptive_max_pool2d``) read and wrote the whole
activation three or four times.

Both compute the eval batch norm as ATen does on the CPU: alpha =
rsqrt(var + eps) * weight, beta = fma(-mean, alpha, bias), one FMA an
element, on x + b rounded to float32 (the chain's ``add_``). The plain
versions do so element by element (so on the CPU they equal that chain to
the bit); ``bias_bn_relu``'s kernel does the same, and the pooled kernel
once per output, on the bin's max or min (see the source); each equals its
plain version run on the card. cuDNN's batch norm, the chain's on the card,
rounds a few ulps away.

A tile of ``tile_planes`` consecutive (n, c) planes is the pooled kernel's
unit of copy into shared memory; two tiles a block are in flight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TILE_FLOATS = 8192      # a tile's target size: 32 KB of float32
PLANES_ALIGN = 8        # a tile's planes come in multiples of this, where they fit
MAX_SMEM = 232448       # csrc/bn_relu_pool.cu kMaxSmem: an H100 block's dynamic shared memory
FLAT_MAX_CHANNELS = 3072  # bias_bn_relu's table: 16 bytes a channel in 48 KB of shared memory


def fma(a, b, c):
    """a * b + c, rounded once in float32: the product of two float32 values
    is exact in float64, and the float64 sum rounds to the same float32 save
    on a tie that the first rounding made. Other types round twice, in their
    own precision."""
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def bias_bn_relu_reference(x, conv_bias, mean, var, weight, bias, eps: float):
    """Plain PyTorch version, element by element: ``x + conv_bias`` (as the
    chain's ``add_``), ATen's CPU eval batch norm (``torch.rsqrt`` and an
    FMA), ReLU."""
    alpha = torch.rsqrt(var + eps) * weight
    beta = fma(-mean, alpha, bias)
    y = fma(x + conv_bias[:, None, None], alpha[:, None, None], beta[:, None, None])
    return F.relu(y)


def bn_relu_adaptive_max_pool_reference(x, conv_bias, mean, var, weight, bias, eps: float,
                                        output_size):
    """Plain PyTorch version: :func:`bias_bn_relu_reference`, then
    ``F.adaptive_max_pool2d``."""
    return F.adaptive_max_pool2d(bias_bn_relu_reference(x, conv_bias, mean, var, weight, bias,
                                                        eps), output_size)


def smem_bytes(tile_planes: int, plane: int, channels: int, oh: int, ow: int) -> int:
    """The pooled kernel's shared memory: two tile buffers (each rounded up
    to 4 floats), the conv bias, alpha and beta for channels + tile_planes
    planes, each output's bin (first element, size)."""
    tile_ld = -(-tile_planes * plane // 4) * 4
    return 4 * (2 * tile_ld + 3 * (channels + tile_planes) + 2 * oh * ow)


def tile_planes(plane: int, channels: int, oh: int, ow: int) -> int:
    """Planes per tile for planes of ``plane`` floats: a multiple of 8 near
    ``TILE_FLOATS`` (so a tile is whole 16-byte copies, and its outputs
    keep the block's threads busy), halved to 4, 2 or 1 only where two
    tiles would not fit a block's shared memory. Raises where not even one
    plane fits."""
    n = PLANES_ALIGN * max(1, TILE_FLOATS // (PLANES_ALIGN * plane))
    while n > 1 and smem_bytes(n, plane, channels, oh, ow) > MAX_SMEM:
        n //= 2
    if smem_bytes(n, plane, channels, oh, ow) > MAX_SMEM:
        raise ValueError(f"bn_relu_adaptive_max_pool's kernel holds two planes of {plane} floats "
                         f"in shared memory; that needs {smem_bytes(1, plane, channels, oh, ow)} "
                         f"bytes, over {MAX_SMEM}")
    return n


def _check(name, x, params):
    """Raises unless x is (N, C, H, W) and the per-channel inputs (C,) on its
    device; on a CUDA device, unless all are float32 and contiguous."""
    if x.dim() != 4:
        raise ValueError(f"{name} takes x (N, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    if any(p.shape != (c,) for p in params):
        raise ValueError(f"{name} wants conv_bias, mean, var, weight, bias of shape ({c},), "
                         f"got {[tuple(p.shape) for p in params]}")
    if any(p.device != x.device for p in params):
        raise ValueError(f"{name} inputs on several devices: "
                         f"{[str(t.device) for t in (x, *params)]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")
    if x.device.type == "cuda":
        if any(t.dtype != torch.float32 for t in (x, *params)):
            raise TypeError(f"{name}'s kernel takes float32 tensors, got "
                            f"{[t.dtype for t in (x, *params)]}")
        if not all(t.is_contiguous() for t in (x, *params)):
            raise ValueError(f"{name}'s kernel takes contiguous tensors")


def _launch(name, fn, x, out, params, eps, *geometry):
    """Calls the library's ``fn`` on x -> out with the per-channel inputs
    (conv_bias, mean, var, weight, bias) on the current stream."""
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        code = getattr(lib, fn)(x.data_ptr(), out.data_ptr(), *(p.data_ptr() for p in params),
                                float(eps), *geometry,
                                torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = lib.nisqa_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: error {code} ({msg}) for "
                           f"x {tuple(x.shape)}, geometry {geometry}")


def bn_relu_adaptive_max_pool(x, conv_bias, mean, var, weight, bias, eps: float, output_size):
    """x (N, C, H, W), the convolution's output without its bias; conv_bias
    (that bias), mean / var / weight / bias (C,) -> (N, C, oh, ow).

    On a CUDA device x and the parameters must be float32 and contiguous;
    this launches the kernel on the current stream, does not synchronise,
    and counts the launch in ``bn_relu_adaptive_max_pool.LAUNCHES``. On the
    CPU it computes ``bn_relu_adaptive_max_pool_reference`` and counts
    nothing.
    """
    if len(output_size) != 2 or min(output_size) < 1:
        raise ValueError(f"bn_relu_adaptive_max_pool wants output_size (oh, ow) >= 1, "
                         f"got {output_size}")
    oh, ow = (int(v) for v in output_size)
    params = (conv_bias, mean, var, weight, bias)
    _check("bn_relu_adaptive_max_pool", x, params)
    if x.device.type == "cpu":
        return bn_relu_adaptive_max_pool_reference(x, *params, eps, (oh, ow))
    n, c, h, w = x.shape
    out = torch.empty((n, c, oh, ow), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _launch("bn_relu_pool", "nisqa_bn_relu_pool", x, out, params, eps,
            n * c, c, h, w, oh, ow, tile_planes(h * w, c, oh, ow))
    bn_relu_adaptive_max_pool.LAUNCHES += 1
    return out


bn_relu_adaptive_max_pool.LAUNCHES = 0


def bias_bn_relu(x, conv_bias, mean, var, weight, bias, eps: float):
    """x (N, C, H, W), the convolution's output without its bias; conv_bias
    (that bias), mean / var / weight / bias (C,) -> a new (N, C, H, W).

    On a CUDA device x and the parameters must be float32 and contiguous;
    this launches the kernel on the current stream, does not synchronise,
    and counts the launch in ``bias_bn_relu.LAUNCHES``. On the CPU it
    computes ``bias_bn_relu_reference`` and counts nothing.
    """
    params = (conv_bias, mean, var, weight, bias)
    _check("bias_bn_relu", x, params)
    if x.device.type == "cpu":
        return bias_bn_relu_reference(x, *params, eps)
    n, c, h, w = x.shape
    if c * h * w >= 2**31 or c > FLAT_MAX_CHANNELS:
        raise ValueError(f"bias_bn_relu's kernel takes C <= {FLAT_MAX_CHANNELS} and rows of "
                         f"C * H * W < 2**31 floats, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _launch("bias_bn_relu", "nisqa_bias_bn_relu", x, out, params, eps, x.numel(), c, h * w)
    bias_bn_relu.LAUNCHES += 1
    return out


bias_bn_relu.LAUNCHES = 0
