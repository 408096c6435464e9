"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

BF16_FLOPS = 989e12          # tensor cores, bf16 in, f32 accumulate
HBM_BYTES_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The roofline: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_S)
