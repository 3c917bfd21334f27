"""Operations and bytes of single layers, from their shapes.

Each byte of an input is counted read once and each byte of an output written
once, whatever a kernel reads again. A multiply-add is two operations.
"""
from __future__ import annotations

from typing import Tuple


_SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def linear(rows: int, k: int, n: int, dtype: str, bias: bool = True) -> Tuple[float, float]:
    """(flops, bytes) of ``rows`` x ``k`` times ``k`` x ``n`` (plus a bias)."""
    s = _SIZE[dtype]
    return 2.0 * rows * k * n, float(s * (rows * k + k * n + (n if bias else 0) + rows * n))


def attention(batch: int, heads: int, lq: int, lk: int, dh: int, dtype: str) -> Tuple[float, float]:
    """(flops, bytes) of softmax(q k^T) v: the two products; q, k, v read, out written."""
    s = _SIZE[dtype]
    flops = 4.0 * batch * heads * lq * lk * dh
    return flops, float(s * batch * heads * dh * (2 * lq + 2 * lk))


def msdeform_sampling(batch: int, len_in: int, lq: int, heads: int, levels: int, points: int,
                      dh: int, value_dtype: str, weight_dtype: str) -> Tuple[float, float]:
    """(flops, bytes) of the deformable sampling alone (the projections are
    ``linear``): each of the B x Lq x M x L x P samples reads four corners of
    Dh channels and adds each, weighted, to the output: 8 Dh operations. Bytes:
    the value (B, Len, M, Dh), the fp32 locations (B, Lq, M, L, P, 2), the
    weights (B, Lq, M, L, P) read, the output (B, Lq, M, Dh) written."""
    samples = batch * lq * heads * levels * points
    vs, ws = _SIZE[value_dtype], _SIZE[weight_dtype]
    bytes_ = (vs * batch * len_in * heads * dh + 8 * samples + ws * samples
              + vs * batch * lq * heads * dh)
    return 8.0 * dh * samples, float(bytes_)

