"""Published dense peaks of one NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU
data sheet, without sparsity) at its 700 W limit. A card set below that
limit reaches less; every share is printed beside the card's power limit."""

FLOPS = {
    "bf16": 989.4e12,   # tensor cores, bfloat16 operands (1,978.9 with sparsity)
    "tf32": 494.7e12,   # tensor cores, TF32 operands (989.4 with sparsity)
    "fp32": 66.9e12,    # CUDA cores, float32
}
HBM_BYTES_PER_S = 3.35e12

# The least time one FLOP of each kind of work takes. The model at the
# precision the configuration names: "default" runs convolutions and
# matmuls in TF32, "highest" in float32. The DFT by the front end's mode:
# "fast" with bfloat16 operands, "exact" as three TF32 products. The mel
# step in float32 on the CUDA cores.
MODEL_PEAK = {"default": FLOPS["tf32"], "highest": FLOPS["fp32"]}
DFT_SECONDS_PER_FLOP = {"fast": 1.0 / FLOPS["bf16"], "exact": 3.0 / FLOPS["tf32"]}
MEL_PEAK = FLOPS["fp32"]


def kernel_seconds(work: dict, mode: str) -> float:
    """The least time the DFT->mel step of ``work`` takes: the larger of
    its operations at the peaks and its bytes at HBM bandwidth."""
    ops = work["dft"] * DFT_SECONDS_PER_FLOP[mode] + work["mel"] / MEL_PEAK
    return max(ops, work["bytes"] / HBM_BYTES_PER_S)
