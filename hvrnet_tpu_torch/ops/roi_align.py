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
"""
from __future__ import annotations

import torch


def _axis_weights(start: torch.Tensor, bin_size: torch.Tensor, dim: int,
                  out_size: int, sample_num: int,
                  offset=None, width=None) -> torch.Tensor:
    """(R, out_size, width) per-axis sampling matrix, sample mean folded
    in; the taps of RoI r sit at ``offset[r]`` + their index along an axis of
    ``width`` (default: no offset, width ``dim``)."""
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
    if offset is not None:
        low, high = low + offset[:, None], high + offset[:, None]
    ar = torch.arange(dim if width is None else width, device=dev)
    w = ((1.0 - frac)[..., None] * (ar == low[..., None])
         + frac[..., None] * (ar == high[..., None]))
    w = w * inside[..., None]                                # (R, s·sn, width)
    return w.reshape(w.shape[0], out_size, sample_num, -1).mean(dim=2)


def roi_align(feats: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0 / 16.0,
              sample_num: int = 2) -> torch.Tensor:
    """RoIAlign over a batch of images.

    Args:
        feats: (B, C, H, W) feature maps.
        rois: (R, 5) rows of [batch_idx, x1, y1, x2, y2] in image coords.

    Returns:
        (R, C, out_size, out_size) pooled features.
    """
    B, C, H, W = feats.shape
    R = rois.shape[0]
    s = out_size
    rois = rois.detach().float()
    start_w = rois[:, 1] * spatial_scale
    start_h = rois[:, 2] * spatial_scale
    bin_w = ((rois[:, 3] + 1.0) * spatial_scale - start_w).clamp_min(0.0) / s
    bin_h = ((rois[:, 4] + 1.0) * spatial_scale - start_h).clamp_min(0.0) / s
    wy = _axis_weights(start_h, bin_h, H, s, sample_num,
                       rois[:, 0].long() * H, B * H).to(feats.dtype)
    wx = _axis_weights(start_w, bin_w, W, s, sample_num).to(feats.dtype)
    # rows: (R·s, B·H) @ (B·H, C·W) → (R, s, C, W)
    f = feats.permute(0, 2, 1, 3).reshape(B * H, C * W)
    t = (wy.reshape(R * s, B * H) @ f).reshape(R, s * C, W)
    # columns: (R, s·C, W) @ (R, W, s) → (R, s, C, s)
    val = torch.bmm(t, wx.transpose(1, 2)).reshape(R, s, C, s)
    return val.permute(0, 2, 1, 3).contiguous()
