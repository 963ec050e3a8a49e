"""Host-side image transforms for dataset building (pure numpy).

Dataset construction is a one-shot, cached host pass (SURVEY.md §3.5) — it
never touches the device hot path — so these are plain vectorized numpy. The
bilinear rotator is framework-owned (rather than scipy's) to keep the builder
deterministic across library versions; `gppvae_tpu/native/` provides an
optional C++ drop-in for bulk builds.
"""

from __future__ import annotations

import numpy as np


def rotate_bilinear(
    images: np.ndarray, angles: np.ndarray, *, use_native: bool | None = None
) -> np.ndarray:
    """Rotate a batch of images about their centers with bilinear sampling.

    images: (B, H, W) float; angles: (B,) radians, counter-clockwise.
    Out-of-bounds samples are zero. Returns (B, H, W) float32.

    Dispatches to the C++ kernel (gppvae_tpu/native/rotate.cpp) when built;
    the numpy path below is the tested-identical fallback.
    """
    images = np.asarray(images, dtype=np.float32)
    angles = np.broadcast_to(np.asarray(angles, dtype=np.float32), images.shape[:1])
    if use_native is not False:
        try:
            from gppvae_tpu.native import native_available, rotate_bilinear_native

            if native_available():
                return rotate_bilinear_native(images, angles)
        except Exception:
            if use_native:  # explicit request — surface the failure
                raise
    B, H, W = images.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0

    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    yy = yy - cy
    xx = xx - cx
    cos = np.cos(angles)[:, None, None]
    sin = np.sin(angles)[:, None, None]
    # inverse map: source coords that land on each output pixel
    src_x = cos * xx + sin * yy + cx
    src_y = -sin * xx + cos * yy + cy

    x0 = np.floor(src_x).astype(np.int32)
    y0 = np.floor(src_y).astype(np.int32)
    fx = src_x - x0
    fy = src_y - y0

    out = np.zeros_like(images)
    batch = np.arange(B)[:, None, None]
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            w = np.where(dx == 1, fx, 1.0 - fx) * np.where(dy == 1, fy, 1.0 - fy)
            vals = images[batch, np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
            out += np.where(valid, w * vals, 0.0)
    return out


def resize_bilinear(images: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize (B, H, W) → (B, h, w), align_corners=False convention."""
    images = np.asarray(images, dtype=np.float32)
    B, H, W = images.shape
    h, w = out_hw
    sy, sx = H / h, W / w
    src_y = (np.arange(h, dtype=np.float32) + 0.5) * sy - 0.5
    src_x = (np.arange(w, dtype=np.float32) + 0.5) * sx - 0.5
    y0 = np.clip(np.floor(src_y).astype(np.int32), 0, H - 1)
    x0 = np.clip(np.floor(src_x).astype(np.int32), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(src_y - y0, 0.0, 1.0)[None, :, None]
    fx = np.clip(src_x - x0, 0.0, 1.0)[None, None, :]
    a = images[:, y0][:, :, x0]
    b = images[:, y0][:, :, x1]
    c = images[:, y1][:, :, x0]
    d = images[:, y1][:, :, x1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx).astype(np.float32)


def pad_to(images: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Center-pad (B, H, W) with zeros to (B, h, w)."""
    B, H, W = images.shape
    h, w = out_hw
    top, left = (h - H) // 2, (w - W) // 2
    out = np.zeros((B, h, w), dtype=np.float32)
    out[:, top : top + H, left : left + W] = images
    return out
