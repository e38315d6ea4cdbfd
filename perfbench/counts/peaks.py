"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W limit): the yardstick of every
utilisation and roofline share.  A card set below 700 W reaches less; the
run prints the card's limit beside its numbers."""

FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12}
BYTES_PER_S = 3.35e12


def least_time(flop: float, nbytes: float, kind: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate of ``kind`` and the bytes over the memory's rate."""
    return max(flop / FLOPS[kind], nbytes / BYTES_PER_S)
