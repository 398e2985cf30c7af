"""Image output: BMP (reference-compatible) and PNG.

The reference writes 24-bit BMPs via CImg (`save_bmp`,
simple_raytracer.cpp:488-494) to ``images/generation/output{angle}.bmp``.
``write_bmp`` emits the same format (BITMAPINFOHEADER, bottom-up BGR rows,
4-byte row padding) and ``write_png`` an 8-bit RGB PNG (zlib), both with no
dependency beyond numpy.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def write_bmp(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] uint8 RGB as a 24-bit BMP."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    row_size = (3 * w + 3) & ~3
    pad = row_size - 3 * w
    data_size = row_size * h
    header = struct.pack(
        "<2sIHHI", b"BM", 14 + 40 + data_size, 0, 0, 14 + 40)
    info = struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, 0, data_size, 2835, 2835, 0, 0)
    bgr = img[::-1, :, ::-1]                 # bottom-up rows, BGR
    if pad:
        rows = np.zeros((h, row_size), np.uint8)
        rows[:, :3 * w] = bgr.reshape(h, 3 * w)
    else:
        rows = bgr.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(header)
        f.write(info)
        f.write(rows.tobytes())


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] uint8 RGB as an 8-bit truecolor PNG."""
    img = np.ascontiguousarray(np.asarray(img, np.uint8))
    h, w = img.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    # filter type 0 (None) at the start of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, 3 * w)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def save_image(path: str, img: np.ndarray) -> None:
    """Dispatch on extension (.bmp / .png)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.lower().endswith(".bmp"):
        write_bmp(path, img)
    else:
        write_png(path, img)
