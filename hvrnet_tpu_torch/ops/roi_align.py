"""RoIAlign in the separable-matmul form (counterpart of
``hvrnet_tpu/ops/roi_align.py:roi_align``).

The sampling math of mmdet's RoIAlign kernel (sample_num per bin per axis,
no aligned corners):
  * roi_end = (coord + 1) · spatial_scale  (the +1 pixel convention)
  * no half-pixel offset on roi_start
  * sample y = roi_start_h + (ph + (iy + .5) / sample_num) · bin_h
  * bilinear with the kernel's edge rules: zero outside [−1, dim], clamp at
    0, collapse high == low at the far edge.

The sample positions of one RoI form a (row × column) grid and the bilinear
weights factorize, so pooling is two batched matrix products,
``pooled = Wy · C5 · Wxᵀ``, with the mean over the sn × sn samples of a bin
folded into the per-axis weights (pooling is linear).  Several images fold
into the row axis: a RoI's row weights sit at its image's B·H rows
(``_sep_pooled_weights`` of the JAX package), which is the one-image form
exactly when B = 1.  Autograd through the two products gives the features
their gradient; the RoIs get none, as in the reference.

The feature dtype picks the arithmetic, as in the JAX package.  bf16
features of one image take its bf16 branch: the axis weights are rounded to
bf16, the first product is rounded to bf16 from its float32 accumulation,
and the second accumulates and returns float32.  bf16 features of several
images take its gather branch, which computes in float32 on the bf16
values: here the float32 form on the widened features.  The result is
float32 either way.
"""
from __future__ import annotations

import torch

from ..core.precision import widen


def _axis_taps(start: torch.Tensor, bin_size: torch.Tensor, dim: int,
               out_size: int, sample_num: int):
    """The bilinear taps of each RoI's sample positions along one axis,
    with the kernel's edge rules: (low, high, frac, inside), each (R,
    out_size·sample_num)."""
    dev = start.device
    ph = torch.arange(out_size, dtype=torch.float32, device=dev)
    iy = (torch.arange(sample_num, dtype=torch.float32, device=dev) + 0.5) \
        / sample_num
    off = (ph[:, None] + iy[None, :]).reshape(-1)              # (s·sn,)
    v = start[:, None] + off[None, :] * bin_size[:, None]      # (R, s·sn)
    inside = (v >= -1.0) & (v <= dim)
    v = v.clamp_min(0.0)
    low = v.to(torch.int64)
    at_edge = low >= dim - 1
    low = torch.where(at_edge, torch.full_like(low, dim - 1), low)
    high = torch.where(at_edge, low, low + 1)
    frac = torch.where(at_edge, torch.zeros_like(v), v - low.float())
    return low, high, frac, inside


def _axis_weights(start: torch.Tensor, bin_size: torch.Tensor, dim: int,
                  out_size: int, sample_num: int,
                  offset=None, width=None) -> torch.Tensor:
    """(R, out_size, width) per-axis sampling matrix, sample mean folded
    in; the taps of RoI r sit at ``offset[r]`` + their index along an axis of
    ``width`` (default: no offset, width ``dim``)."""
    low, high, frac, inside = _axis_taps(start, bin_size, dim, out_size,
                                         sample_num)
    if offset is not None:
        low, high = low + offset[:, None], high + offset[:, None]
    ar = torch.arange(dim if width is None else width, device=start.device)
    w = ((1.0 - frac)[..., None] * (ar == low[..., None])
         + frac[..., None] * (ar == high[..., None]))
    w = w * inside[..., None]                                # (R, s·sn, width)
    return w.reshape(w.shape[0], out_size, sample_num, -1).mean(dim=2)


def _roi_extent(rois: torch.Tensor, spatial_scale: float, out_size: int):
    """(start_w, start_h, bin_w, bin_h) of (R, 5) RoIs: the +1 pixel end, no
    half-pixel start."""
    rois = rois.detach().float()
    start_w = rois[:, 1] * spatial_scale
    start_h = rois[:, 2] * spatial_scale
    bin_w = ((rois[:, 3] + 1.0) * spatial_scale - start_w).clamp_min(0.0) \
        / out_size
    bin_h = ((rois[:, 4] + 1.0) * spatial_scale - start_h).clamp_min(0.0) \
        / out_size
    return start_w, start_h, bin_w, bin_h


def roi_align_gather(raster: torch.Tensor, rois: torch.Tensor,
                     out_size: int, spatial_scale: float = 1.0,
                     sample_num: int = 2) -> torch.Tensor:
    """RoIAlign of one-channel (B, H, W) rasters in the JAX package's gather
    form (its several-image branch), the same arithmetic in the same order:
    per sample the four taps' weighted sum, then the mean of a bin's
    samples, summed in row-major order.  A RoI reads the raster of its
    index; the work is the RoIs' taps, not the rasters' size, so it pools
    (G, H, W) image-size masks cheaply.  Returns (R, out_size, out_size)
    float32."""
    B, H, W = raster.shape
    R, s, sn = rois.shape[0], out_size, sample_num
    start_w, start_h, bin_w, bin_h = _roi_extent(rois, spatial_scale, s)
    y_lo, y_hi, ly, y_in = _axis_taps(start_h, bin_h, H, s, sn)
    x_lo, x_hi, lx, x_in = _axis_taps(start_w, bin_w, W, s, sn)
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = raster.float().reshape(-1)
    base = (rois[:, 0].long() * (H * W))[:, None, None]

    def tap(yi, xi):
        return flat[base + yi[:, :, None] * W + xi[:, None, :]]

    val = (hy[:, :, None] * hx[:, None, :] * tap(y_lo, x_lo)
           + hy[:, :, None] * lx[:, None, :] * tap(y_lo, x_hi)
           + ly[:, :, None] * hx[:, None, :] * tap(y_hi, x_lo)
           + ly[:, :, None] * lx[:, None, :] * tap(y_hi, x_hi))
    val = (val * (y_in[:, :, None] & x_in[:, None, :])).reshape(
        R, s, sn, s, sn)
    total = torch.zeros(R, s, s, device=raster.device)
    for iy in range(sn):
        for ix in range(sn):
            total = total + val[:, :, iy, :, ix]
    return total / (sn * sn)


def roi_align(feats: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0 / 16.0,
              sample_num: int = 2) -> torch.Tensor:
    """RoIAlign over a batch of images.

    Args:
        feats: (B, C, H, W) feature maps.
        rois: (R, 5) rows of [batch_idx, x1, y1, x2, y2] in image coords.

    Returns:
        (R, C, out_size, out_size) pooled features (float32 for bf16
        features).
    """
    B, C, H, W = feats.shape
    if feats.dtype == torch.bfloat16 and B > 1:
        feats = widen(feats)
    R = rois.shape[0]
    s = out_size
    start_w, start_h, bin_w, bin_h = _roi_extent(rois, spatial_scale, s)
    wy = _axis_weights(start_h, bin_h, H, s, sample_num,
                       rois[:, 0].long() * H, B * H).to(feats.dtype)
    wx = _axis_weights(start_w, bin_w, W, s, sample_num).to(feats.dtype)
    # rows: (R·s, B·H) @ (B·H, C·W) → (R, s, C, W)
    f = feats.permute(0, 2, 1, 3).reshape(B * H, C * W)
    t = (wy.reshape(R * s, B * H) @ f).reshape(R, s * C, W)
    # columns: (R, s·C, W) @ (R, W, s) → (R, s, C, s)
    val = torch.bmm(widen(t), widen(wx).transpose(1, 2)).reshape(R, s, C, s)
    return val.permute(0, 2, 1, 3).contiguous()
