"""COCO run-length encoding of binary masks in numpy: the twin of the port's
native codec (``utils/rle.py`` binds ``native/rle.cpp``).

The evaluation calls the native codec on every device; the tests hold the
two to identical count strings. Column-major run lengths (the first run
counts zeros) and pycocotools' compressed count string (the third count on
is delta-coded against the count two before, five bits per character with a
continuation bit, offset by 48).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def mask_counts(mask: np.ndarray) -> np.ndarray:
    """(h, w) binary mask -> column-major run lengths, starting with zeros."""
    flat = np.asarray(mask, bool).T.reshape(-1)
    if flat.size == 0:
        return np.zeros(1, np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    return np.concatenate([[0], runs]) if flat[0] else runs


_MAX_CHARS = 13  # 5 bits per character covers any int64 delta


def counts_to_string(cnts: np.ndarray) -> bytes:
    """pycocotools' ``rleToString``, vectorized over all counts: character
    k of a count holds bits [5k, 5k+5) of its (delta-coded) value, with
    0x20 set while more characters follow."""
    x = np.asarray(cnts, np.int64).copy()
    if x.size > 3:
        x[3:] -= np.asarray(cnts, np.int64)[1:-2]
    chars = np.empty((x.size, _MAX_CHARS), np.int64)
    more = np.empty((x.size, _MAX_CHARS), bool)
    for k in range(_MAX_CHARS):
        c = x & 0x1F
        x = x >> 5  # arithmetic shift, as on the C int64
        more[:, k] = np.where(c & 0x10, x != -1, x != 0)
        chars[:, k] = c | (more[:, k] << 5)
    n_chars = np.argmin(more, axis=1) + 1  # stop after the first "no more"
    keep = np.arange(_MAX_CHARS)[None, :] < n_chars[:, None]
    return (chars[keep] + 48).astype(np.uint8).tobytes()


def string_to_counts(s: bytes) -> np.ndarray:
    cnts = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and c & 0x10:
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, np.int64)


def encode(mask: np.ndarray) -> Dict:
    """(h, w) binary mask -> {"size": [h, w], "counts": bytes}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": counts_to_string(mask_counts(mask))}


def decode(rle: Dict) -> np.ndarray:
    """COCO RLE dict -> (h, w) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    cnts = string_to_counts(counts.encode() if isinstance(counts, str) else counts)
    vals = np.arange(len(cnts)) % 2
    return np.repeat(vals, cnts).astype(np.uint8).reshape(w, h).T


def area(rle: Dict) -> int:
    """Number of set pixels: the sum of the odd-indexed run lengths."""
    counts = rle["counts"]
    cnts = string_to_counts(counts.encode() if isinstance(counts, str) else counts)
    return int(cnts[1::2].sum())


def merge(rles, intersect: bool = False) -> Dict:
    """Union (or intersection) of same-size RLE masks, as an RLE dict."""
    masks = [decode(r).astype(bool) for r in rles]
    out = masks[0]
    for m in masks[1:]:
        out = (out & m) if intersect else (out | m)
    return encode(out)


def encode_packed(packed_rows: np.ndarray, h: int, w: int) -> Dict:
    """Row-major MSB-first bit-packed mask (h, ceil(w/8)) -> COCO RLE dict."""
    return encode(np.unpackbits(packed_rows, axis=-1)[:, :w])


def encode_colruns(rows: np.ndarray, m_col: np.ndarray, jumps: np.ndarray,
                   first: bool, h: int, w: int) -> Optional[Dict]:
    """Per-column change rows (w, k) + their counts (w,) + MSB-first packed
    column-boundary change bits + pixel (0, 0) -> COCO RLE dict; None when a
    column holds more than k changes (the caller then encodes the frame from
    its packed pixels)."""
    rows, m_col = np.asarray(rows, np.int64), np.asarray(m_col, np.int64)
    if (m_col > rows.shape[-1]).any():
        return None
    jump = np.unpackbits(np.asarray(jumps, np.uint8))[:w].astype(bool)
    jump[0] = False  # bit 0 has no column before it
    cols = np.arange(w)
    within = cols[:, None] * h + rows  # (w, k) column-major change positions
    take = np.arange(rows.shape[-1])[None, :] < m_col[:, None]
    # per column: its boundary change first, then its change rows, ascending
    pos = np.concatenate([(cols * h)[:, None], within], axis=1)
    keep = np.concatenate([jump[:, None], take], axis=1)
    change = pos[keep]
    cnts = np.diff(np.concatenate([[0], change, [h * w]]))
    if first:
        cnts = np.concatenate([[0], cnts])
    return {"size": [int(h), int(w)], "counts": counts_to_string(cnts)}
