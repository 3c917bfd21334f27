"""COCO run-length encoding of binary masks: the port's native codec.

Counterpart: ``dvis_plus_tpu/utils/rle.py`` (``encode``, ``encode_packed``
:73, ``_counts_to_rle`` :105, ``encode_colruns`` :112, ``ColRunMasks`` :136,
``PackedMasks``, ``decode``, ``area``, ``merge``), which binds the JAX
package's C++ codec. The port carries its own copy of that source
(``dvis_plus_tpu_torch/native/rle.cpp``) and binds it with ctypes. It is
built with ``g++ -O3 -shared -fPIC`` at its first use into
``build/dvis_plus_tpu_torch_kernels/`` under the repository root, named by a
hash of the source and the flags, written under a private name and renamed
into place (a concurrent build never sees a half-written file). A failed
build raises: there is no quiet fallback. The numpy twin
(``utils/rle_numpy.py``) writes the same strings and serves the tests.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Dict, Optional

import numpy as np

from dvis_plus_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "rle.cpp")
CXXFLAGS = ["-O3", "-shared", "-fPIC"]
_BUILD_LOCK = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librle_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the codec unless its library exists; returns its path."""
    so = library_path()
    with _BUILD_LOCK:
        if os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_so = os.path.join(tmp, os.path.basename(so))
            res = subprocess.run(["g++", *CXXFLAGS, "-o", tmp_so, SOURCE],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"building the RLE codec failed ({res.returncode}):\n"
                                   + res.stdout + res.stderr)
            os.replace(tmp_so, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded codec with every entry point's C signature set."""
    lib = ctypes.CDLL(build())
    i64 = ctypes.c_int64
    u8p, u16p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    sigs = {
        "rle_encode": (i64, [u8p, i64, i64, u32p]),
        "rle_encode_packed": (i64, [u8p, i64, i64, i64, u32p]),
        "rle_from_colruns": (i64, [u16p, u16p, u8p, i64, i64, i64, i64, u32p]),
        "rle_decode": (None, [u32p, i64, u8p, i64]),
        "rle_area": (ctypes.c_uint64, [u32p, i64]),
        "rle_merge": (i64, [u32p, i64, u32p, i64, u32p, ctypes.c_int32]),
        "rle_to_string": (i64, [u32p, i64, ctypes.c_char_p]),
        "rle_from_string": (i64, [ctypes.c_char_p, i64, u32p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _counts_to_rle(cnts: np.ndarray, m: int, h: int, w: int) -> Dict:
    """The first ``m`` uint32 counts -> COCO RLE dict with the compressed
    string (a count's delta takes at most 7 characters)."""
    buf = ctypes.create_string_buffer(int(7 * m + 1))
    n = library().rle_to_string(_ptr(cnts, ctypes.c_uint32), m, buf)
    return {"size": [int(h), int(w)], "counts": buf.raw[:n]}


def _counts_of(rle: Dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    if not isinstance(counts, (bytes, bytearray)):  # uncompressed list
        return np.asarray(counts, np.uint32)
    cnts = np.empty(len(counts) + 2, np.uint32)
    m = library().rle_from_string(bytes(counts), len(counts), _ptr(cnts, ctypes.c_uint32))
    return cnts[:m].copy()


def encode(mask: np.ndarray) -> Dict:
    """(h, w) binary mask -> {"size": [h, w], "counts": bytes}."""
    h, w = mask.shape
    fmask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8, copy=False).T)
    cnts = np.empty(h * w + 1, np.uint32)
    m = library().rle_encode(_ptr(fmask, ctypes.c_uint8), h, w, _ptr(cnts, ctypes.c_uint32))
    return _counts_to_rle(cnts, m, h, w)


def encode_packed(packed_rows: np.ndarray, h: int, w: int) -> Dict:
    """Row-major MSB-first bit-packed mask (h, ceil(w/8)) uint8 (numpy
    ``packbits`` order) -> COCO RLE dict, without unpacking: the codec walks
    the columns over the packed bits."""
    packed_rows = np.ascontiguousarray(packed_rows, np.uint8)
    if packed_rows.ndim != 2 or packed_rows.shape[0] != h:
        raise ValueError(f"packed rows must be ({h}, ceil(w/8)), got {packed_rows.shape}")
    cnts = np.empty(h * w + 1, np.uint32)
    m = library().rle_encode_packed(_ptr(packed_rows, ctypes.c_uint8), h, w,
                                    packed_rows.shape[1], _ptr(cnts, ctypes.c_uint32))
    return _counts_to_rle(cnts, m, h, w)


def encode_colruns(rows: np.ndarray, m_col: np.ndarray, jumps: np.ndarray,
                   first: bool, h: int, w: int) -> Optional[Dict]:
    """Per-column change rows (w, k) uint16, their counts (w,) uint16, the
    MSB-first packed column-boundary change bits and pixel (0, 0) -> COCO
    RLE dict, identical to ``encode`` of the mask they describe (the device
    extracts them, ``engine/inference.py::_upsample_runs``). None when a
    column holds more than k changes: the caller encodes that frame from
    its packed pixels."""
    rows = np.ascontiguousarray(rows, np.uint16)
    m_col = np.ascontiguousarray(m_col, np.uint16)
    jumps = np.ascontiguousarray(jumps, np.uint8)
    if rows.ndim != 2 or rows.shape[0] != w or m_col.shape != (w,) or jumps.size < (w + 7) // 8:
        raise ValueError(f"change rows ({rows.shape}), counts ({m_col.shape}) and boundary bits "
                         f"({jumps.shape}) do not describe {w} columns")
    k = rows.shape[-1]
    cnts = np.empty(w * (k + 1) + 2, np.uint32)  # a leading 0, per column a jump and k rows, the tail
    m = library().rle_from_colruns(_ptr(rows, ctypes.c_uint16), _ptr(m_col, ctypes.c_uint16),
                                   _ptr(jumps, ctypes.c_uint8), int(bool(first)), h, w, k,
                                   _ptr(cnts, ctypes.c_uint32))
    return None if m < 0 else _counts_to_rle(cnts, m, h, w)


def decode(rle: Dict) -> np.ndarray:
    """COCO RLE dict -> (h, w) uint8 mask."""
    h, w = rle["size"]
    cnts = _counts_of(rle)
    mask = np.zeros(h * w, np.uint8)
    library().rle_decode(_ptr(cnts, ctypes.c_uint32), len(cnts), _ptr(mask, ctypes.c_uint8), h * w)
    return mask.reshape(w, h).T.copy()


def area(rle: Dict) -> int:
    """Number of set pixels: the sum of the odd-indexed run lengths."""
    cnts = _counts_of(rle)
    return int(library().rle_area(_ptr(cnts, ctypes.c_uint32), len(cnts)))


def merge(rles, intersect: bool = False) -> Dict:
    """Union (or intersection) of same-size RLE masks, as an RLE dict."""
    lib = library()
    acc = _counts_of(rles[0])
    h, w = rles[0]["size"]
    for r in rles[1:]:
        b = _counts_of(r)
        out = np.empty(len(acc) + len(b) + 2, np.uint32)
        m = lib.rle_merge(_ptr(acc, ctypes.c_uint32), len(acc), _ptr(b, ctypes.c_uint32), len(b),
                          _ptr(out, ctypes.c_uint32), int(intersect))
        acc = out[:m].copy()
    return _counts_to_rle(acc, len(acc), h, w)


class PackedMasks:
    """A (n, T, H, W) bool mask stack bit-packed along W (numpy ``packbits``
    order): ``bits`` is (n, T, H, ceil(W/8)) uint8. Same interface as the JAX
    package's ``PackedMasks``, so either evaluator takes it."""

    def __init__(self, bits: np.ndarray, height: int, width: int):
        if bits.ndim != 4 or bits.dtype != np.uint8:
            raise ValueError(f"bits must be (n, T, H, ceil(W/8)) uint8, got {bits.shape} {bits.dtype}")
        self.bits = bits
        self.height = int(height)
        self.width = int(width)

    @property
    def shape(self):
        return (self.bits.shape[0], self.bits.shape[1], self.height, self.width)

    def frame_any(self, i: int, t: int) -> bool:
        return bool(self.bits[i, t].any())

    def encode_frame(self, i: int, t: int) -> Dict:
        return encode_packed(self.bits[i, t], self.height, self.width)

    def unpack(self) -> np.ndarray:
        return np.unpackbits(self.bits, axis=-1)[..., : self.width].astype(bool)

    def __getitem__(self, i):
        return np.unpackbits(self.bits[i], axis=-1)[..., : self.width].astype(bool)

    def __len__(self) -> int:
        return self.bits.shape[0]


class ColRunMasks:
    """A (n, T, H, W) bool mask stack held as per-column run boundaries: for
    each (instance, frame, column) the ascending rows (1..H-1) where the
    column's value changes (``rows`` (n, T, W, k) uint16, valid prefix
    ``m_col`` (n, T, W)), the packed cross-column change bits ``jumps``
    (n, T, ceil(W/8)) and pixel (0, 0) in ``first`` (n, T). Frames where a
    column holds more than k changes carry their packed (H, ceil(W/8)) rows
    in ``fallback`` and encode from those; the strings are the same either
    way. Same interface as :class:`PackedMasks`."""

    def __init__(self, rows: np.ndarray, m_col: np.ndarray, jumps: np.ndarray,
                 first: np.ndarray, height: int, width: int,
                 fallback: Optional[Dict] = None):
        if rows.ndim != 4 or rows.dtype != np.uint16:
            raise ValueError(f"rows must be (n, T, W, k) uint16, got {rows.shape} {rows.dtype}")
        self.rows, self.m_col, self.jumps, self.first = rows, m_col, jumps, first
        self.height, self.width = int(height), int(width)
        self.k = rows.shape[-1]
        self.fallback = fallback or {}  # {(i, t): (H, ceil(W/8)) uint8}
        self._any = (first.astype(bool) | (m_col.sum(-1, dtype=np.int64) > 0)
                     | (jumps != 0).any(-1))

    @property
    def shape(self):
        return (self.rows.shape[0], self.rows.shape[1], self.height, self.width)

    def frame_any(self, i: int, t: int) -> bool:
        return bool(self._any[i, t])

    def encode_frame(self, i: int, t: int) -> Dict:
        fb = self.fallback.get((i, t))
        if fb is not None:
            return encode_packed(fb, self.height, self.width)
        e = encode_colruns(self.rows[i, t], self.m_col[i, t], self.jumps[i, t],
                           bool(self.first[i, t]), self.height, self.width)
        if e is None:
            raise ValueError(f"frame ({i}, {t}) overflows k={self.k} and has no packed fallback")
        return e

    def unpack(self) -> np.ndarray:
        """The full (n, T, H, W) bool array (tests and debugging)."""
        out = np.zeros(self.shape, bool)
        for i, t in np.argwhere(self._any):
            out[i, t] = decode(self.encode_frame(i, t)).astype(bool)
        return out

    def __len__(self) -> int:
        return self.rows.shape[0]
