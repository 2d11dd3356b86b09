"""Bilinear resize of uint8 images, bit for bit ``cv2.resize(img, (w, h),
interpolation=cv2.INTER_LINEAR)`` (the JAX package's ``Resize`` calls it),
in numpy, so the port needs no cv2.

cv2's fixed-point path: per axis, ``f = float32((d + 0.5) · s/d_size −
0.5)``, source ``floor(f)`` and 11-bit weights ``round(2048 · (1 − f))``
and their complement.  Columns clamp at the edges (weight and source);
rows keep their weights and clamp only the source rows.  The horizontal
pass sums ``S·c`` in int32; the vertical pass rounds as cv2's SIMD loop
does, ``(((b0·(D0 >> 4)) >> 16) + ((b1·(D1 >> 4)) >> 16) + 2) >> 2``.  An
exact 2× reduction on both axes takes cv2's area path (2×2 means), the
same size a copy, as cv2 decides.
"""
from __future__ import annotations

import numpy as np

COEF_SCALE = 2048           # INTER_RESIZE_COEF_SCALE, 11 bits


def _weights(dsize: int, ssize: int):
    """(source index, float32 fraction) per destination index."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _coefs(f: np.ndarray):
    c0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)).astype(np.int32)
    return c0, COEF_SCALE - c0


def resize_bilinear_u8(img: np.ndarray, dsize) -> np.ndarray:
    """``img`` (H, W, C) or (H, W) uint8 resized to ``dsize`` = (width,
    height), as ``cv2.resize(img, dsize, interpolation=INTER_LINEAR)``."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bilinear_u8 takes uint8 images, not "
                        f"{img.dtype} (float images are not ported)")
    dw, dh = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad target size {dsize}")
    if (dw, dh) == (sw, sh):
        return img.copy()
    if sw == 2 * dw and sh == 2 * dh:
        return _halve(img)
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img

    sx, fx = _weights(dw, sw)
    low = sx < 0
    fx[low], sx[low] = 0, 0
    high = sx >= sw - 1
    fx[high], sx[high] = 0, sw - 1
    cx0, cx1 = _coefs(fx)
    sx1 = np.minimum(sx + 1, sw - 1)

    sy, fy = _weights(dh, sh)
    by0, by1 = _coefs(fy)
    sy0 = np.clip(sy, 0, sh - 1)
    sy1 = np.clip(sy + 1, 0, sh - 1)

    # rows as (H, W·C): each output column gathers its two source pixels'
    # channels at once
    c = src.shape[2]
    lane = np.arange(c)
    cols0 = (sx[:, None] * c + lane).reshape(-1)
    cols1 = (sx1[:, None] * c + lane).reshape(-1)
    w0, w1 = np.repeat(cx0, c), np.repeat(cx1, c)
    flat = src.reshape(sh, sw * c)
    rows = np.unique(np.concatenate([sy0, sy1]))
    horiz = np.empty((sh, dw * c), np.int32)
    part = flat[rows]
    horiz[rows] = (part[:, cols0].astype(np.int32) * w0
                   + part[:, cols1].astype(np.int32) * w1) >> 4
    top = (by0[:, None] * horiz[sy0]) >> 16
    top += (by1[:, None] * horiz[sy1]) >> 16
    top += 2
    top >>= 2
    out = np.clip(top, 0, 255).astype(np.uint8).reshape(dh, dw, c)
    return out[..., 0] if squeeze else out


def _halve(img: np.ndarray) -> np.ndarray:
    """cv2's area path for an exact 2× reduction: rounded 2×2 means."""
    s = img.astype(np.int32)
    total = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
    return ((total + 2) >> 2).astype(np.uint8)
