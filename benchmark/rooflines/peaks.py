"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit): FP32 outside the tensor cores and HBM3 bandwidth.
A card set below 700 W runs slower under load; the harness prints the
card's ``power.limit`` beside every roofline share."""

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: the larger of the
    operations over the FP32 peak and the bytes over the memory rate."""
    return max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
