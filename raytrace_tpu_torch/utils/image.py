"""PNG output with the reference's vertical flip (ui_util.rs:46-49).

Pixel row 0 is the bottom scanline; PNGs are written top row first.
The encoder is the standard library's zlib, so writing an image needs
no imaging package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode_png(rgba_or_rgb: np.ndarray) -> bytes:
    """(H, W, 3|4) u8 with row 0 = bottom -> PNG bytes, flipped."""
    img = np.ascontiguousarray(rgba_or_rgb[::-1], dtype=np.uint8)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {c}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(path: str, rgba_or_rgb: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(rgba_or_rgb))


def load_png(path: str) -> np.ndarray:
    """Inverse of save_png: (H, W, C) u8 with row 0 = bottom. Decoded by
    PIL, imported here only."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)[::-1]
