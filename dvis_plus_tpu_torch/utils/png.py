"""8-bit grayscale and RGB PNG files with the standard library (``zlib``,
``struct``): the VPS and VSS evaluators write their label maps with
:func:`write_png`. :func:`read_png` reads back files of this writer (one
IDAT stream, no interlace, filter type 0 on every row) and nothing else:
dataset files are read with OpenCV.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (grayscale, truecolour)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", zlib.crc32(tag + payload))


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> PNG bytes (each row filter 0, zlib
    ``level``)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    if channels not in _COLOR_TYPE:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3) arrays, got {img.shape}")
    rows = np.zeros((h, 1 + w * channels), np.uint8)  # a leading filter byte of 0 per row
    rows[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """A file of :func:`write_png` -> (H, W) or (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, payload = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: not a file of this writer (IHDR {header})")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: row filters other than 0 are not read")
    img = rows[:, 1:]
    return img.reshape(h, w) if channels == 1 else img.reshape(h, w, 3)
