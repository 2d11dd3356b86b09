"""The cv2 image operations that ``Albu`` needs, in numpy, bit for bit
cv2 5.0, so the port needs no cv2 (``data/albu_mini.py`` calls them; the
HSV conversions are in ``data/color.py``):

- ``blur(img, k)``: ``cv2.blur(img, (k, k))`` with ``BORDER_REFLECT_101``.
  uint8: ``round(S / k²)`` of the integer window sum S (never a tie, as k²
  is odd).  float32: the window sum in float64, rows then columns, times
  float64 ``1 / k²``, rounded once to float32.
- ``median_blur(img, k)``: ``cv2.medianBlur`` on uint8 with
  ``BORDER_REPLICATE``, the exact median of each window.
- ``rotation_matrix_2d``: ``cv2.getRotationMatrix2D``, in libm
  (``math.cos`` / ``math.sin``; numpy's vectorised ones may differ by an
  ulp), the angle times float64 ``π / 180`` and the centre rounded to
  float32, as cv2 takes it.
- ``warp_affine(img, M, dsize)``: ``cv2.warpAffine`` with ``INTER_LINEAR``
  and ``BORDER_REFLECT_101``, on uint8 and float32.  cv2 5.0 no longer
  rounds coordinates to a 1/32 grid (``AB_BITS`` / ``INTER_BITS``, 15-bit
  weights): it inverts M in float64, rounds its six entries to float32 and
  maps each destination pixel in float32.  Each row runs in vectors of
  ``WARP_VECTOR`` pixels (8 float lanes, two per step, the AVX2 build),
  ``x' = fma(M0, x, float32(y·M1 + M2))``, and its last ``W mod
  WARP_VECTOR`` pixels one at a time, ``x' = fma(x, M0, y·M1) + M2`` (y
  alike with M3..M5).  The source pixel is ``floor(x')``, the weights
  ``α = x' − floor(x')`` and β; each of the four neighbours outside the
  image is reflected (101) on its own axis.  The value is
  ``fma(β, v1 − v0, v0)`` of ``v0 = fma(α, p01 − p00, p00)`` and ``v1 =
  fma(α, p11 − p10, p10)`` in float32, rounded half to even and saturated
  for uint8.  Any other interpolation or border raises.

Held bit for bit to cv2 5.0 (``tests/test_torch_port_albu.py``).
"""
from __future__ import annotations

import math

import numpy as np

from .resize import fma_f32

INTER_LINEAR = 1            # cv2's flag values, which Albu configs name
BORDER_REFLECT_101 = 4
WARP_VECTOR = 16
MEDIAN_ROWS = 64            # rows of windows held at once by median_blur


def _check_ksize(k: int) -> int:
    k = int(k)
    if k < 1 or k % 2 == 0:
        raise ValueError(f"the kernel size must be odd and positive, not {k}")
    return k


def reflect101(i: np.ndarray, n: int) -> np.ndarray:
    """Indices ``i`` reflected into [0, n) without repeating the edge
    (``BORDER_REFLECT_101``: ``gfedcb|abcdefgh|gfedcba``)."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def _box_sum(img: np.ndarray, k: int, dtype) -> np.ndarray:
    """Each pixel's k × k window sum under ``BORDER_REFLECT_101``, summed
    along the rows first, in ``dtype``."""
    r = k // 2
    h, w = img.shape[:2]
    cols = reflect101(np.arange(-r, w + r), w)
    rows = reflect101(np.arange(-r, h + r), h)
    src = img.astype(dtype)[:, cols]
    row_sum = src[:, 0:w].copy()
    for d in range(1, k):
        row_sum += src[:, d:d + w]
    src = row_sum[rows]
    out = src[0:h].copy()
    for d in range(1, k):
        out += src[d:d + h]
    return out


def blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` of an (H, W) or (H, W, C) uint8 or float32
    image, odd ``k``."""
    k = _check_ksize(k)
    if img.dtype == np.uint8:
        s = _box_sum(img, k, np.int64)
        return ((2 * s + k * k) // (2 * k * k)).astype(np.uint8)
    if img.dtype == np.float32:
        s = _box_sum(img, k, np.float64)
        return (s * (1.0 / (k * k))).astype(np.float32)
    raise TypeError(f"blur takes uint8 or float32 images, not {img.dtype}")


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(img, k)`` of an (H, W) or (H, W, C) uint8 image."""
    k = _check_ksize(k)
    if img.dtype != np.uint8:
        raise TypeError(f"median_blur takes uint8 images, not {img.dtype}")
    r = k // 2
    h, w = img.shape[:2]
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    src = np.pad(img, pad, mode="edge")
    out = np.empty_like(img)
    mid = k * k // 2
    for y0 in range(0, h, MEDIAN_ROWS):
        y1 = min(y0 + MEDIAN_ROWS, h)
        win = np.stack([src[y0 + dy:y1 + dy, dx:dx + w]
                        for dy in range(k) for dx in range(k)])
        out[y0:y1] = np.partition(win, mid, axis=0)[mid]
    return out


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64,
    ``angle`` in degrees, counter-clockwise."""
    a = float(angle) * (math.pi / 180)
    alpha = math.cos(a) * float(scale)
    beta = math.sin(a) * float(scale)
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def _invert_affine(M: np.ndarray):
    """cv2's inverse of a (2, 3) affine map, in float64, as six floats."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _source_coords(m, h: int, w: int):
    """(x', y') float32 (h, w): each destination pixel's source position,
    the vectors' formula on the first ``w - w mod WARP_VECTOR`` columns of
    each row and the scalar one on the rest."""
    m = [np.float32(v) for v in m]
    f32 = np.float32
    x = np.arange(w, dtype=f32)[None, :]
    y = np.arange(h, dtype=f32)[:, None]
    nv = w // WARP_VECTOR * WARP_VECTOR
    out = []
    for a, b, c in ((m[0], m[1], m[2]), (m[3], m[4], m[5])):
        s = np.empty((h, w), f32)
        row = y * b + c
        xv = np.broadcast_to(x[:, :nv], (h, nv))
        s[:, :nv] = fma_f32(np.full((h, nv), a, f32), xv,
                            np.broadcast_to(row, (h, nv)))
        xs = np.broadcast_to(x[:, nv:], (h, w - nv))
        yb = np.broadcast_to(y * b, (h, w - nv))
        s[:, nv:] = fma_f32(xs, np.full(xs.shape, a, f32), yb) + c
        out.append(s)
    return out


def warp_affine(img: np.ndarray, M: np.ndarray, dsize,
                flags: int = INTER_LINEAR,
                border_mode: int = BORDER_REFLECT_101) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_REFLECT_101)`` of an (H, W) or (H, W, C) uint8 or
    float32 image; ``dsize`` = (width, height)."""
    if flags != INTER_LINEAR or border_mode != BORDER_REFLECT_101:
        raise NotImplementedError(
            f"warp_affine reproduces cv2's INTER_LINEAR ({INTER_LINEAR}) "
            f"with BORDER_REFLECT_101 ({BORDER_REFLECT_101}) only, not "
            f"interpolation {flags} with border {border_mode}")
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"warp_affine takes uint8 or float32 images, not "
                        f"{img.dtype}")
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    sx, sy = _source_coords(_invert_affine(M), h, w)
    fx, fy = np.floor(sx), np.floor(sy)
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    x0, x1 = reflect101(ix, sw), reflect101(ix + 1, sw)
    y0, y1 = reflect101(iy, sh), reflect101(iy + 1, sh)
    src = img.astype(np.float32)
    p00, p01 = src[y0, x0], src[y0, x1]
    p10, p11 = src[y1, x0], src[y1, x1]
    extra = (slice(None), slice(None)) + (None,) * (img.ndim - 2)
    alpha = np.broadcast_to((sx - fx)[extra], p00.shape)
    beta = np.broadcast_to((sy - fy)[extra], p00.shape)
    v0 = fma_f32(alpha, p01 - p00, p00)
    v1 = fma_f32(alpha, p11 - p10, p10)
    v = fma_f32(beta, v1 - v0, v0)
    if img.dtype == np.uint8:
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return v
