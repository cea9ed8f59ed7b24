"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): HBM bandwidth and float32 outside the tensor cores."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time a call can take: bytes once at the bandwidth, or its
    operations at the float32 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
