"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): float32 outside the tensor cores, the
precision both configurations state, and HBM3 bandwidth."""

F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: bytes over bandwidth or FLOPs
    over the float32 peak, whichever is longer."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
