"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12        # bfloat16 / float16 tensor cores, dense


def least_seconds(nbytes: float, ops: float,
                  ops_per_s: float = F32_FLOP_PER_S) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory's rate and the operations over the arithmetic peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)
