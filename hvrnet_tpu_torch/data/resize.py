"""Bilinear resize, bit for bit ``cv2.resize(img, (w, h),
interpolation=cv2.INTER_LINEAR)`` (the JAX package's ``Resize`` calls it),
in numpy, so the port needs no cv2: uint8 images (the test pipeline) and
float32 ones (the training pipeline, after ``PhotoMetricDistortion``).

cv2's fixed-point path: per axis, ``f = float32((d + 0.5) · s/d_size −
0.5)``, source ``floor(f)`` and 11-bit weights ``round(2048 · (1 − f))``
and their complement.  Columns clamp at the edges (weight and source);
rows keep their weights and clamp only the source rows.  The horizontal
pass sums ``S·c`` in int32; the vertical pass rounds as cv2's SIMD loop
does, ``(((b0·(D0 >> 4)) >> 16) + ((b1·(D1 >> 4)) >> 16) + 2) >> 2``.  An
exact 2× reduction on both axes takes cv2's area path (2×2 means), the
same size a copy, as cv2 decides.

cv2's float32 path: per axis ``f = (d + 0.5) · (s_size / d_size) − 0.5``
in double, source ``floor(f)`` and the weight ``a = float32(f − floor(f))``,
columns clamped as above.  Each pass is one fused multiply-add per value,
``fma(S1 − S0, a, S0)`` rounded once to float32 (``fma_f32``), the
horizontal pass first.  One exception on a 3-channel image: cv2 takes each
side's clamped columns (an upscale's edges) in runs of 16, and where the
run left over has 5 columns or more, the vertical step of their first two
channels is ``S0 + (S1 − S0)·a`` rounded twice (past a ~4.5× upscale).
No area path: an exact 2× reduction interpolates too.  A source one pixel
high or wide takes cv2's older float path: the uint8 path's float32
coordinates, the weights ``1 − a`` and ``a``, and ``S0·(1 − a) + S1·a``
with each product rounded.  Held bit for bit to cv2 5.0.
"""
from __future__ import annotations

import numpy as np

COEF_SCALE = 2048           # INTER_RESIZE_COEF_SCALE, 11 bits
# float path, 3 channels: the clamped columns (see the module docstring)
BORDER_CHUNK, BORDER_TAIL = 16, 5


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
                        f"{img.dtype} (resize_bilinear_f32 takes float32)")
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


def fma_f32(a: np.ndarray, b, c) -> np.ndarray:
    """``a · b + c`` for float32 operands rounded once to float32, as a
    fused multiply-add does.  The product is exact in float64 (24 + 24
    bits); where the float64 sum lands exactly halfway between two float32
    values (rounding twice could then go the wrong way), its rounding
    error, found by TwoSum, decides."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.broadcast_to(np.asarray(c, np.float64), p.shape)
    s = p + c
    out = s.astype(np.float32)
    # halfway: the 29 bits float32 drops from float64's mantissa are 1 then
    # 0s; below float32's normal range the dropped bits differ, so check
    # those sums too
    bits = s.view(np.uint64) & np.uint64((1 << 29) - 1)
    tie = (bits == np.uint64(1 << 28)) | (np.abs(s) < 2.0 ** -126)
    if np.any(tie):
        pt, ct, st = p[tie], c[tie], s[tie]
        bb = st - pt
        err = (pt - (st - bb)) + (ct - bb)
        ot = out[tie]
        back = ot.astype(np.float64)
        near = np.where(err > 0, np.nextafter(ot, np.float32(np.inf)),
                        np.nextafter(ot, np.float32(-np.inf)))
        # the true sum lies beyond s on err's side: take the float32 value
        # on that side when s was rounded away from it
        wrong = (err != 0) & ((back - st) * err < 0) & (
            np.abs(near.astype(np.float64) - st) == np.abs(back - st))
        out[tie] = np.where(wrong, near, ot)
    return out


def _weights_f32(dsize: int, ssize: int):
    """(source index, float32 weight) per destination index, cv2's float
    path."""
    f = (np.arange(dsize, dtype=np.float64) + 0.5) * (ssize / dsize) - 0.5
    s = np.floor(f).astype(np.int64)
    return s, (f - s).astype(np.float32)


def resize_bilinear_f32(img: np.ndarray, dsize) -> np.ndarray:
    """``img`` (H, W, 3) or (H, W) float32 resized to ``dsize`` = (width,
    height), as ``cv2.resize(img, dsize, interpolation=INTER_LINEAR)``."""
    if img.dtype != np.float32 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise TypeError(f"resize_bilinear_f32 takes (H, W, 3) or (H, W) "
                        f"float32 images, not {img.dtype} {img.shape}")
    dw, dh = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad target size {dsize}")
    if (dw, dh) == (sw, sh):
        return img.copy()
    one_pixel = min(sh, sw) == 1
    sx, fx = (_weights if one_pixel else _weights_f32)(dw, sw)
    low = sx < 0
    fx[low], sx[low] = 0, 0
    high = sx >= sw - 1
    fx[high], sx[high] = 0, sw - 1
    sx1 = np.minimum(sx + 1, sw - 1)
    sy, fy = (_weights if one_pixel else _weights_f32)(dh, sh)
    sy0 = np.clip(sy, 0, sh - 1)
    sy1 = np.clip(sy + 1, 0, sh - 1)
    lerp = _mul_add if one_pixel else _fma_lerp

    # only the source rows the vertical pass reads
    rows = np.unique(np.concatenate([sy0, sy1]))
    part = img[rows]
    ax = (None, slice(None)) + (None,) * (img.ndim - 2)
    s0, s1 = part[:, sx], part[:, sx1]
    horiz = np.empty((sh,) + s0.shape[1:], np.float32)
    horiz[rows] = lerp(s0, s1, fx[ax])
    ay = (slice(None),) + (None,) * (img.ndim - 1)
    t0, t1 = horiz[sy0], horiz[sy1]
    out = lerp(t0, t1, fy[ay])
    if not one_pixel and img.ndim == 3:
        # the clamped columns of each side go in runs of BORDER_CHUNK; a
        # remainder of BORDER_TAIL or more columns has the vertical step of
        # its first two channels rounded unfused
        for side in (np.flatnonzero(low), np.flatnonzero(high)):
            tail = len(side) % BORDER_CHUNK
            if tail >= BORDER_TAIL:
                cols = side[len(side) - tail:]
                a, b = t0[:, cols, :2], t1[:, cols, :2]
                out[:, cols, :2] = a + (b - a) * fy[:, None, None]
    return out


def _fma_lerp(s0, s1, a):
    return fma_f32(s1 - s0, a, s0)


def _mul_add(s0, s1, a):
    return s0 * (np.float32(1) - a) + s1 * a
