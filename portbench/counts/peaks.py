"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit), which every roofline and ``mfu`` share is taken over."""

BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# The SFU's exp rate: 16 a clock per SM, 132 SMs, 1.98 GHz boost.
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def bound_s(ops_s: dict, bytes_moved: float) -> float:
    """Least seconds for the work: the larger of each resource's time."""
    return max(bytes_moved / HBM_BYTES_PER_S, *ops_s.values())
