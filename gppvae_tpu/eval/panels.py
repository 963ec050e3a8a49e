"""Per-epoch PNG image panels (reference: callbacks.py, SURVEY.md §2.1).

Rows of images (e.g. input / reconstruction / out-of-sample prediction)
written as one PNG grid for eyeball parity with the reference's panels.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a (H, W) grayscale or (H, W, 3) RGB uint8 array as a PNG
    (8-bit, filter type 0 on every scanline), with the stdlib alone."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0  # truecolor | grayscale
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1
    ).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def save_panel(path: str, rows: list[np.ndarray], *, pad: int = 2) -> None:
    """rows: list of (B, H, W, C) arrays in [0,1]; one grid row each."""
    rows = [np.asarray(r) for r in rows]
    B = min(r.shape[0] for r in rows)
    H, W, C = rows[0].shape[1:]
    grid = np.ones(
        (len(rows) * (H + pad) + pad, B * (W + pad) + pad, 3 if C == 3 else 1),
        dtype=np.float32,
    )
    for i, row in enumerate(rows):
        for j in range(B):
            img = np.clip(row[j], 0.0, 1.0)
            y0 = pad + i * (H + pad)
            x0 = pad + j * (W + pad)
            grid[y0 : y0 + H, x0 : x0 + W] = img
    arr = (grid * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, arr)
