"""BGR ↔ HSV on float32 images, bit for bit ``cv2.cvtColor(img,
COLOR_BGR2HSV)`` and ``COLOR_HSV2BGR`` (``PhotoMetricDistortion`` calls
them), in numpy, so the port needs no cv2.  H in [0, 360), S in [0, 1],
V unbounded.

cv2 converts each image row in vectors of ``LANES`` pixels (its AVX2
build, 8 float32 lanes) and the row's last ``W mod LANES`` pixels one at a
time, and the two round the hue differently:
- vectors: ``h = fma(x, float32(60 / (diff + ε)), offset)``, one rounding,
  the offset 0 / 120 / 240 by the channel that holds the maximum (red, then
  green, then blue on ties) and 360 for a red maximum with G < B;
- the row's tail: ``h = x · float32(60. / (diff + ε))`` (the quotient in
  double), ``fma`` with the 120 / 240 offset, then + 360 where h < 0.
``x`` is G − B, B − R or R − G, ``diff`` = max − min, ε = FLT_EPSILON.
S = diff / (|V| + ε) and V = max, the same on both.  HSV → BGR is one
formula on both: ``h · (6/360)`` (float32), sector ``floor``, fraction, and
the table ``v``, ``v·(1 − s)``, ``v·fma(−s, f, 1)``, ``v·fma(−s, 1 − f,
1)``.  Held bit for bit to cv2 5.0; hues below 0 (which the distortion
never hands over: it wraps them) take different sectors in cv2's two
routes and are refused.
"""
from __future__ import annotations

import numpy as np

from .resize import fma_f32

LANES = 8
EPS = np.float32(np.finfo(np.float32).eps)
# HSV → BGR: per sector, the table entries that B, G and R take
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def _check(img: np.ndarray, name: str) -> None:
    if img.dtype != np.float32 or img.ndim != 3 or img.shape[2] != 3:
        raise TypeError(f"{name} takes (H, W, 3) float32 images, not "
                        f"{img.dtype} {img.shape}")


def bgr2hsv_f32(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` of an (H, W, 3) float32
    BGR image."""
    _check(img, "bgr2hsv_f32")
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + EPS)
    red, green = r == v, g == v
    x = np.where(red, g - b, np.where(green, b - r, r - g))
    offset = np.where(red, 0, np.where(green, 120, 240)).astype(np.float32)
    body = img.shape[1] // LANES * LANES
    h = np.empty_like(v)
    # vectors: the 360 folded into the one rounding
    rev = np.float32(60) / (diff[:, :body] + EPS)
    wrap = red[:, :body] & (g[:, :body] < b[:, :body])
    h[:, :body] = fma_f32(x[:, :body], rev,
                          offset[:, :body] + np.float32(360) * wrap)
    # the scalar tail
    if body < img.shape[1]:
        rev = (60.0 / (diff[:, body:] + EPS).astype(np.float64)
               ).astype(np.float32)
        t = np.where(red[:, body:], x[:, body:] * rev,
                     fma_f32(x[:, body:], rev, offset[:, body:]))
        h[:, body:] = np.where(t < 0, t + np.float32(360), t)
    return np.stack([h, s, v], axis=-1)


def hsv2bgr_f32(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` of an (H, W, 3) float32
    HSV image with H ≥ 0."""
    _check(hsv, "hsv2bgr_f32")
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    if np.any(h < 0):
        raise ValueError("hsv2bgr_f32 takes hues ≥ 0 (cv2's vector and "
                         "scalar routes disagree below 0)")
    h = h * np.float32(6.0 / 360.0)
    sector = np.floor(h)
    f = h - sector
    one = np.ones_like(f)
    tab = np.stack([v, v * (np.float32(1) - s),
                    v * fma_f32(-s, f, one),
                    v * fma_f32(-s, np.float32(1) - f, one)], axis=-1)
    pick = _SECTORS[sector.astype(np.int64) % 6]
    return np.take_along_axis(tab, pick, axis=-1)
