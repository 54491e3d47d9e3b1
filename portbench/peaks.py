"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3; NVIDIA's data sheet,
dense rates, at the full 700 W limit), and the roofline bound."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores


def bound_s(nbytes: float, flops: float, flops_per_s: float) -> float:
    """The least time the card could take: bytes over the HBM rate or the
    operations over their peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)
