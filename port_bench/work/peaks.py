"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity, at the full 700 W power limit). A share of a peak is stated
against these, with the card's power limit beside it."""
from __future__ import annotations

FLOPS = {  # operations a second
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,  # outside the tensor cores
}
HBM_BYTES_S = 3.35e12


def least_time(flops: float, bytes_: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations over
    the peak rate of ``dtype`` and the bytes over the memory bandwidth."""
    return max(flops / FLOPS[dtype], bytes_ / HBM_BYTES_S)
