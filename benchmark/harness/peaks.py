"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): the yardstick of every roofline and
utilisation share, whatever dtype a kernel computes in."""

DENSE_FLOPS = 989e12  # bf16 / fp16 tensor cores, dense: the chip's highest dense rate
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take for `ops` operations moving
    `nbytes` bytes."""
    return max(ops / DENSE_FLOPS, nbytes / HBM_BYTES_PER_S)
