"""The eval epilogue of AdaptCNN's convolutions
(``nisqa_tpu_torch/ops/bn_relu_pool.py``, ``csrc/bn_relu_pool.cu``): conv
bias, batch norm and ReLU with the adaptive max-pool
(``bn_relu_adaptive_max_pool``, blocks 1, 2 and 4) and without it
(``bias_bn_relu``, blocks 3, 5 and 6).

On the CPU: the plain versions against torch's chain (the bias added, eval
batch norm, ReLU, the pool) at every pool geometry of the released
checkpoints and shipped YAMLs, blocks 3, 5 and 6's shapes, the 80- and
128-band heights (overlapping bins) and odd shapes, with negative, zero and
zero-variance channels; an emulation of the pooled kernel's arithmetic (both
extremes of each bin, the bias and the affine once per output in ATen's CPU
formula) held bit-equal to the chain; the pooled kernel's tile plan;
AdaptCNN's routing (eval without autograd through the two ops within a few
ulps of the parent's forward, whose CPU convolution adds its bias inside
its sums; train and eval with autograd as before, outputs and gradients
equal to the parent's forward). On a card (marker ``cuda``): each kernel
against its plain version run on the card, the pooled kernel given the
conv bias against the same kernel on the biased input, the launch counts
per trunk forward, and the inputs the kernels refuse.
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from nisqa_tpu_torch.data.pipeline import matmul_precision
from nisqa_tpu_torch.models import framewise
from nisqa_tpu_torch.models.framewise import AdaptCNN
from nisqa_tpu_torch.ops import bn_relu_pool as bp
from nisqa_tpu_torch.ops.bn_relu_pool import (bias_bn_relu, bias_bn_relu_reference,
                                              bn_relu_adaptive_max_pool,
                                              bn_relu_adaptive_max_pool_reference)

EPS = 1e-5
# (N, C, H, W, oh, ow): AdaptCNN's three pools at 48 bands (the released
# checkpoints and shipped YAMLs), the first pool at 80 and 128 bands, odd shapes
GEOMS = [
    (6, 16, 48, 15, 24, 7), (6, 32, 24, 7, 12, 5), (6, 64, 12, 5, 6, 3),
    (4, 16, 80, 15, 24, 7), (4, 16, 128, 15, 24, 7),
    (3, 5, 7, 9, 3, 4), (2, 3, 13, 11, 6, 4), (2, 3, 5, 5, 5, 5), (2, 3, 3, 2, 4, 5),
    (1, 7, 1, 1, 1, 1),
]
GEOM_IDS = ["x".join(map(str, g)) for g in GEOMS]
# (N, C, H, W) of the epilogue without a pool: AdaptCNN's blocks 3, 5 and 6
# at 48 bands (any band count: blocks 3 to 6 follow the second pool), then
# the pooled geometries' inputs as generic shapes (rows of C * H * W floats
# not a multiple of 4 among them)
FLAT_GEOMS = [(6, 64, 12, 5), (6, 64, 6, 3), (6, 64, 6, 1)] + [g[:4] for g in GEOMS]
FLAT_IDS = ["x".join(map(str, g)) for g in FLAT_GEOMS]
DIM_CFG = {"cnn_kernel_size": 3, "cnn_c_out_1": 16, "cnn_c_out_2": 32, "cnn_c_out_3": 64,
           "cnn_pool_1": [24, 7], "cnn_pool_2": [12, 5], "cnn_pool_3": [6, 3],
           "cnn_dropout": 0.2, "cnn_fc_out_h": None}


def bn_params(c, gen, device="cpu"):
    """mean, var, weight, bias (C,): a zero-variance channel, a negative and a
    zero weight among them."""
    mean = torch.randn(c, generator=gen) * 0.5
    var = torch.rand(c, generator=gen) * 2
    weight = torch.randn(c, generator=gen)
    bias = torch.randn(c, generator=gen) * 0.5
    var[0] = 0.0
    weight[min(1, c - 1)] = -abs(float(weight[min(1, c - 1)])) - 0.1
    if c > 2:
        weight[2] = 0.0
    return tuple(t.to(device) for t in (mean, var, weight, bias))


def flat_chain(x, conv_bias, mean, var, weight, bias):
    """The parent's eval block after its convolution: ``add_`` of the bias,
    ``F.batch_norm`` with the running statistics, ReLU."""
    y = F.batch_norm(x + conv_bias[:, None, None], mean, var, weight, bias, training=False,
                     momentum=0.0, eps=EPS)
    return F.relu(y)


def chain(x, conv_bias, mean, var, weight, bias, out_hw):
    return F.adaptive_max_pool2d(flat_chain(x, conv_bias, mean, var, weight, bias), out_hw)


def emulate_kernel(x, conv_bias, mean, var, weight, bias, out_hw):
    """The pooled kernel's arithmetic: alpha, beta once a channel, each
    bin's max and min, the bias added and the affine applied once per output
    on the max (alpha >= 0) or the min."""
    oh, ow = out_hw
    h, w = x.shape[2:]
    alpha = torch.rsqrt(var + EPS) * weight
    beta = bp.fma(-mean, alpha, bias)
    out = torch.empty(x.shape[:2] + (oh, ow))
    for i in range(oh):
        h0, h1 = i * h // oh, -(-(i + 1) * h // oh)
        for j in range(ow):
            w0, w1 = j * w // ow, -(-(j + 1) * w // ow)
            win = x[:, :, h0:h1, w0:w1]
            m = torch.where(alpha < 0, win.amin(dim=(2, 3)), win.amax(dim=(2, 3)))
            out[:, :, i, j] = bp.fma(m + conv_bias, alpha, beta).clamp_min(0.0)
    return out


def case(geom, seed=0, device="cpu"):
    """x (N, C, H, W) drawn where it is used (the card's shapes reach 1.2
    GB); the per-channel inputs (conv bias, mean, var, weight, bias) drawn
    on the CPU; the pool's (oh, ow) where ``geom`` gives one."""
    n, c, h, w = geom[:4]
    x = torch.randn((n, c, h, w), generator=torch.Generator(device).manual_seed(seed),
                    device=device) * 2
    gen = torch.Generator().manual_seed(seed + 1)
    conv_bias = (torch.randn(c, generator=gen) * 0.5).to(device)
    return x, (conv_bias, *bn_params(c, gen, device)), tuple(geom[4:])


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_plain_version_and_kernel_emulation_equal_the_chain(geom):
    """The bias added once per output, to the bin's extreme, gives the bits
    of adding it to every element first (rounding is monotone)."""
    x, params, out_hw = case(geom)
    ref = chain(x, *params, out_hw)
    assert torch.equal(bn_relu_adaptive_max_pool_reference(x, *params, EPS, out_hw), ref)
    assert torch.equal(emulate_kernel(x, *params, out_hw), ref)
    before = bn_relu_adaptive_max_pool.LAUNCHES
    assert torch.equal(bn_relu_adaptive_max_pool(x, *params, EPS, out_hw), ref)
    assert bn_relu_adaptive_max_pool.LAUNCHES == before  # CPU: the plain version


@pytest.mark.parametrize("geom", FLAT_GEOMS, ids=FLAT_IDS)
def test_epilogue_plain_version_equals_the_chain(geom):
    x, params, _ = case(geom)
    ref = flat_chain(x, *params)
    assert torch.equal(bias_bn_relu_reference(x, *params, EPS), ref)
    before = bias_bn_relu.LAUNCHES
    assert torch.equal(bias_bn_relu(x, *params, EPS), ref)
    assert bias_bn_relu.LAUNCHES == before  # CPU: the plain version


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_tile_plan_fits_and_keeps_tiles_aligned(geom):
    _, c, h, w, oh, ow = geom
    tp = bp.tile_planes(h * w, c, oh, ow)
    assert tp % bp.PLANES_ALIGN == 0 and (tp * h * w) % 4 == 0  # whole 16-byte copies
    assert tp == bp.PLANES_ALIGN or tp * h * w <= bp.TILE_FLOATS
    assert bp.smem_bytes(tp, h * w, c, oh, ow) <= bp.MAX_SMEM


def test_tile_plan_shrinks_then_refuses_planes_over_shared_memory():
    assert bp.tile_planes(200 * 15, 16, 24, 7) == 8  # 200 bands: two tiles of 8 planes fit
    assert bp.tile_planes(6000, 16, 24, 7) == 4
    assert bp.tile_planes(28000, 16, 24, 7) == 1
    with pytest.raises(ValueError, match="shared memory"):
        bp.tile_planes(30000, 16, 24, 7)


def test_wrapper_checks_shapes():
    x, params, out_hw = case(GEOMS[0])
    for k in range(len(params)):  # each per-channel input cut short
        cut = params[:k] + (params[k][:3],) + params[k + 1:]
        with pytest.raises(ValueError, match="shape"):
            bn_relu_adaptive_max_pool(x, *cut, EPS, out_hw)
        with pytest.raises(ValueError, match="shape"):
            bias_bn_relu(x, *cut, EPS)
    with pytest.raises(ValueError, match="N, C, H, W"):
        bn_relu_adaptive_max_pool(x[0], *params, EPS, out_hw)
    with pytest.raises(ValueError, match="N, C, H, W"):
        bias_bn_relu(x[0], *params, EPS)
    with pytest.raises(ValueError, match="output_size"):
        bn_relu_adaptive_max_pool(x, *params, EPS, (0, 7))


def parent_forward(m, x, w=None):
    """AdaptCNN.forward as it was before the fused ops: every block through
    its modules (convolution with its bias, batch norm, ReLU)."""
    block = m._chain
    x = F.adaptive_max_pool2d(block(1, x, w), m.pools[0])
    x = F.adaptive_max_pool2d(block(2, x, w), m.pools[1])
    x = block(4, m._drop2d(block(3, m._drop2d(x), w)), w)
    x = F.adaptive_max_pool2d(x, m.pools[2])
    x = block(6, m._drop2d(block(5, m._drop2d(x), w)), w).flatten(1)
    return m.fc(x) if m.fc is not None else x


def adapt_cnn(h=48, device="cpu"):
    """A NISQA_DIM AdaptCNN with its batch norms' running statistics and
    affine moved off their initial values."""
    torch.manual_seed(0)
    m = AdaptCNN(DIM_CFG)
    gen = torch.Generator().manual_seed(1)
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mean, var, weight, bias = bn_params(mod.num_features, gen)
            with torch.no_grad():
                mod.running_mean.copy_(mean)
                mod.running_var.copy_(var + 0.05)
                mod.weight.copy_(weight)
                mod.bias.copy_(bias)
    x = torch.randn((10, 1, h, 15), generator=gen)
    return m.to(device), x.to(device)


@pytest.fixture
def op_calls(monkeypatch):
    """AdaptCNN's calls of the two epilogue ops, in order: (op, x's shape,
    the conv bias given)."""
    calls = []

    def spy(op):
        def call(x, conv_bias, *args):
            calls.append((op.__name__, x.shape, conv_bias))
            return op(x, conv_bias, *args)
        return call

    for op in (bn_relu_adaptive_max_pool, bias_bn_relu):
        monkeypatch.setattr(framewise, op.__name__, spy(op))
    return calls


@pytest.mark.parametrize("h", [48, 80])
@pytest.mark.parametrize("grad_off", ["inference_mode", "no_grad"])
def test_adaptcnn_eval_without_autograd_takes_the_op(op_calls, h, grad_off):
    """Every block through an epilogue op, with its convolution's bias;
    within 8 float32 ulps of the largest output of the parent's forward
    (read: 2), whose CPU convolution adds the bias inside its sums where the
    eval path adds it to the sums' result."""
    m, x = adapt_cnn(h)
    m.eval()
    with torch.no_grad():
        ref = parent_forward(m, x)
    with getattr(torch, grad_off)():
        got = m(x)
    pooled, flat = "bn_relu_adaptive_max_pool", "bias_bn_relu"
    assert [(op, s[1:]) for op, s, _ in op_calls] == [
        (pooled, (16, h, 15)), (pooled, (32, 24, 7)), (flat, (64, 12, 5)),
        (pooled, (64, 12, 5)), (flat, (64, 6, 3)), (flat, (64, 6, 1))]
    assert all(b is getattr(m, f"conv{i}").bias for i, (_, _, b) in enumerate(op_calls, 1))
    ulp = torch.finfo(torch.float32).eps * float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=0, atol=8 * ulp)


def grads(m, x, out):
    out.square().sum().backward()
    return [x.grad] + [p.grad for p in m.parameters()]


@pytest.mark.parametrize("mode", ["eval_with_grad", "train"])
def test_adaptcnn_with_autograd_keeps_the_chain(op_calls, mode):
    m, x = adapt_cnn()
    m.train(mode == "train")
    valid = torch.tensor([True] * 7 + [False] * 3) if mode == "train" else None
    sides = []
    for forward in (parent_forward, type(m).forward):
        mm, xx = copy.deepcopy(m), x.clone().requires_grad_(True)
        torch.manual_seed(5)  # the same dropout masks on both sides
        out = forward(mm, xx, valid)
        sides.append((out.detach(), grads(mm, xx, out)))
    assert op_calls == []
    (ref, ref_g), (got, got_g) = sides
    assert torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(got_g, ref_g))


# --- on a card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


# bs 32 at buckets 255 and 780 of the cells' plans (segments a file), each pooled block
MAIN_GEOMS = [(32 * t, c, h, w, oh, ow) for t in (255, 780)
              for c, h, w, oh, ow in ((16, 48, 15, 24, 7), (32, 24, 7, 12, 5), (64, 12, 5, 6, 3))]
# blocks 3, 5 and 6 at a NISQA_DIM batch (32 rows) and a NISQA_DE one (2 x 32)
# at the bucket of 780 segments; block 1's 80-band input as a generic shape
MAIN_FLAT = [(rows * 780, 64, h, w) for rows in (32, 64) for h, w in ((12, 5), (6, 3), (6, 1))]
MAIN_FLAT += [(32 * 780, 16, 80, 15)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", MAIN_GEOMS + GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_kernel_equals_plain_version_on_the_card(card, geom):
    """Tolerance 0 ulps: the kernel computes the plain version's formula
    (the bias added, rsqrt as the card's, one FMA an element) on each bin's
    extreme, and max, min and ReLU are exact; so zeros fall exactly where
    the plain version's do."""
    x, params, out_hw = case(geom, seed=3, device=card)
    before = bn_relu_adaptive_max_pool.LAUNCHES
    got = bn_relu_adaptive_max_pool(x, *params, EPS, out_hw)
    assert bn_relu_adaptive_max_pool.LAUNCHES == before + 1
    assert torch.equal(got, bn_relu_adaptive_max_pool_reference(x, *params, EPS, out_hw))


@pytest.mark.cuda
def test_kernel_propagates_nan_and_takes_an_offset_input(card):
    x, params, out_hw = case((3, 5, 7, 9, 3, 4), seed=4, device=card)
    x[1, 2, 3, 4] = float("nan")
    ref = bn_relu_adaptive_max_pool_reference(x, *params, EPS, out_hw)
    got = bn_relu_adaptive_max_pool(x, *params, EPS, out_hw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    assert got.isnan().sum() == ref.isnan().sum() > 0
    # a contiguous view one float into its storage: the kernel's 4-byte copies
    flat = torch.randn(1 + 2 * 16 * 48 * 15, device=card)
    xs = flat[1:].view(2, 16, 48, 15)
    _, params, _ = case((1, 16, 1, 1), seed=5, device=card)
    assert torch.equal(bn_relu_adaptive_max_pool(xs, *params, EPS, (24, 7)),
                       bn_relu_adaptive_max_pool_reference(xs, *params, EPS, (24, 7)))


@pytest.mark.cuda
@pytest.mark.parametrize("geom", MAIN_GEOMS + GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_pooled_kernel_with_conv_bias_equals_the_parent_form(card, geom):
    """The bias given to the kernel against the parent's form, ``add_``
    then the same kernel with no bias (a zero one): 0 ulps (rounding is
    monotone, so the bias added to a bin's extreme is the extreme of the
    biased elements)."""
    x, (conv_bias, *params), out_hw = case(geom, seed=6, device=card)
    got = bn_relu_adaptive_max_pool(x, conv_bias, *params, EPS, out_hw)
    x.add_(conv_bias[:, None, None])
    parent = bn_relu_adaptive_max_pool(x, torch.zeros_like(conv_bias), *params, EPS, out_hw)
    assert torch.equal(got, parent)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", MAIN_FLAT + FLAT_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_epilogue_kernel_equals_plain_version_on_the_card(card, geom):
    """Tolerance 0 ulps: the kernel computes the plain version's formula
    (the bias added, rsqrt as the card's, one FMA an element, ReLU)."""
    x, params, _ = case(geom, seed=7, device=card)
    before = bias_bn_relu.LAUNCHES
    got = bias_bn_relu(x, *params, EPS)
    assert bias_bn_relu.LAUNCHES == before + 1
    assert torch.equal(got, bias_bn_relu_reference(x, *params, EPS))


@pytest.mark.cuda
def test_epilogue_kernel_propagates_nan_and_takes_an_offset_input(card):
    x, params, _ = case((3, 64, 6, 3), seed=8, device=card)
    x[1, 2, 3, 1] = float("nan")
    ref = bias_bn_relu_reference(x, *params, EPS)
    got = bias_bn_relu(x, *params, EPS)
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    assert got.isnan().sum() == ref.isnan().sum() == 1
    # a contiguous view one float into its storage: the kernel's 4-byte accesses
    flat = torch.randn(1 + 5 * 64 * 12 * 5, device=card)
    xs = flat[1:].view(5, 64, 12, 5)
    assert torch.equal(bias_bn_relu(xs, *params, EPS), bias_bn_relu_reference(xs, *params, EPS))


@pytest.mark.cuda
def test_launches_per_trunk_forward(card):
    """6 epilogue launches per eval forward without autograd (3 pooled, 3
    not); 0 in a train step and in an eval forward with autograd."""
    m, x = adapt_cnn(device=card)
    count = lambda: (bn_relu_adaptive_max_pool.LAUNCHES, bias_bn_relu.LAUNCHES)  # noqa: E731
    m.eval()
    p0, f0 = count()
    with torch.inference_mode():
        m(x)
        m(x)
    assert count() == (p0 + 6, f0 + 6)
    with torch.no_grad(), matmul_precision("highest"):
        got, ref = m(x), parent_forward(m, x)
    # cuDNN's batch norm rounds a few ulps away (in TF32 convolutions an ulp
    # can flip a rounding to 10 bits, hence float32 here)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    before = count()
    m(x.requires_grad_(True)).sum().backward()
    m.train()
    m(x, torch.ones(x.shape[0], dtype=torch.bool, device=card)).sum().backward()
    assert count() == before


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["bn_relu_adaptive_max_pool", "bias_bn_relu"])
def test_kernel_refuses_other_inputs(card, op):
    x, params, out_hw = case(GEOMS[2], device=card)
    pool = op == "bn_relu_adaptive_max_pool"

    def call(x, *params, out_hw=out_hw):
        if pool:
            return bn_relu_adaptive_max_pool(x, *params, EPS, out_hw)
        return bias_bn_relu(x, *params, EPS)

    with pytest.raises(ValueError, match="contiguous"):
        call(x.to(memory_format=torch.channels_last), *params)
    with pytest.raises(ValueError, match="contiguous"):
        call(x.transpose(2, 3), *params, out_hw=out_hw[::-1])
    for k in range(len(params)):  # each per-channel input in turn
        other = torch.stack([params[k], params[k]], 1)[:, 0]  # strided
        with pytest.raises(ValueError, match="contiguous"):
            call(x, *params[:k], other, *params[k + 1:])
        for dtype in (torch.float64, torch.bfloat16):
            with pytest.raises(TypeError, match="float32"):
                call(x, *params[:k], params[k].to(dtype), *params[k + 1:])
        with pytest.raises(ValueError, match="several devices"):
            call(x, *params[:k], params[k].cpu(), *params[k + 1:])
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError, match="float32"):
            call(x.to(dtype), *params)
    with pytest.raises(ValueError, match="N, C, H, W"):
        call(x.flatten(2), *params)
    with pytest.raises(ValueError, match="shape"):
        call(x[:, :32], *params)
