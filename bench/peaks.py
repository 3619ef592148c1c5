"""Published peaks of the card the benchmark runs on (NVIDIA H100 SXM
data sheet, dense rates, at the full 700 W power limit). A share of a
roofline or of a peak is taken against these, with the card's power
limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_FLOPS_PER_S = 67e12       # fp32 outside the tensor cores (TF32 off)
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12


def least_seconds(moved_bytes: float, flops: float,
                  flops_per_s: float = FP32_FLOPS_PER_S) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the compute rate."""
    return max(moved_bytes / HBM_BYTES_PER_S, flops / flops_per_s)
