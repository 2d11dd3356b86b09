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
folded into the per-axis weights (pooling is linear).
"""
from __future__ import annotations

import torch


def _axis_weights(start: torch.Tensor, bin_size: torch.Tensor, dim: int,
                  out_size: int, sample_num: int) -> torch.Tensor:
    """(R, out_size, dim) per-axis sampling matrix, sample mean folded in."""
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
    ar = torch.arange(dim, device=dev)
    w = ((1.0 - frac)[..., None] * (ar == low[..., None])
         + frac[..., None] * (ar == high[..., None]))
    w = w * inside[..., None]                                  # (R, s·sn, dim)
    return w.reshape(w.shape[0], out_size, sample_num, dim).mean(dim=2)


def roi_align(feats: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0 / 16.0,
              sample_num: int = 2) -> torch.Tensor:
    """RoIAlign over one image.

    Args:
        feats: (1, C, H, W) feature map.
        rois: (R, 5) rows of [batch_idx, x1, y1, x2, y2] in image coords
            (batch_idx must be 0).

    Returns:
        (R, C, out_size, out_size) pooled features.
    """
    if feats.shape[0] != 1:
        raise ValueError(f"roi_align takes one image, got {feats.shape[0]}")
    _, C, H, W = feats.shape
    R = rois.shape[0]
    s = out_size
    rois = rois.float()
    start_w = rois[:, 1] * spatial_scale
    start_h = rois[:, 2] * spatial_scale
    bin_w = ((rois[:, 3] + 1.0) * spatial_scale - start_w).clamp_min(0.0) / s
    bin_h = ((rois[:, 4] + 1.0) * spatial_scale - start_h).clamp_min(0.0) / s
    wy = _axis_weights(start_h, bin_h, H, s, sample_num).to(feats.dtype)
    wx = _axis_weights(start_w, bin_w, W, s, sample_num).to(feats.dtype)
    # rows: (R·s, H) @ (H, C·W) → (R, s, C, W)
    f = feats[0].permute(1, 0, 2).reshape(H, C * W)
    t = (wy.reshape(R * s, H) @ f).reshape(R, s * C, W)
    # columns: (R, s·C, W) @ (R, W, s) → (R, s, C, s)
    val = torch.bmm(t, wx.transpose(1, 2)).reshape(R, s, C, s)
    return val.permute(0, 2, 1, 3).contiguous()
