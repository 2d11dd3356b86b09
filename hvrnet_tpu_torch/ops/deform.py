"""Deformable convolution and pooling, and the masked convolution (NCHW),
counterparts of ``hvrnet_tpu/ops/deform.py``.

The JAX functions are an XLA gather and an einsum, not Pallas kernels, and
so are these: a bilinear gather of every tap (``bilinear_gather``) and one
matrix product over (channel, tap), the im2col form of mmdet's
``DeformConv`` / ``ModulatedDeformConv``.

* **Offsets** keep the JAX channel layout: ``g·2K + 2k + {0: dy, 1: dx}``
  for deformable group g and tap k (K = k×k taps in row-major order); a
  v2 ``mask`` is ``g·K + k``, already through its sigmoid.
* **The border rule is the JAX one, not mmdet's CUDA kernel's.** A sample
  is zero outside (−1, H) × (−1, W); inside, its corner rows are
  ``y0 = clip(floor(y), 0, H − 1)`` and ``y1 = clip(y0 + 1, 0, H − 1)``
  with the weight ``ly = y − floor(y)``.  So a sample at y ∈ (−1, 0)
  blends rows 0 and 1 by 1 − ly and ly, and one at y ∈ (H − 1, H) reads
  row H − 1 at full weight (mmdet zero-pads the outside corner instead).
  Columns alike.
* **Precision.** The bilinear weights are float32 and the taps are widened
  to them (JAX promotes a bf16 tap times a float32 weight to float32), the
  product over (channel, tap) runs in float32 on the widened weight, and
  only its output is cast to the input's dtype: a bf16 engine's deformable
  convolutions compute in float32 on bf16 inputs and weights.
* ``deformable_groups`` G splits the input channels in G parts, each
  sampled at its own offsets; the JAX function sums the parts' products
  and adds the bias once after, here one product over all groups (equal
  within rounding).

Gradients flow to the input (through the gather), the weight, the bias,
the offsets (through the bilinear weights; ``floor`` has none) and the
mask, as in the JAX function.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import to_compute, widen


def bilinear_gather(img: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img`` (B, G, c, H, W) at float coordinates
    ``ys`` / ``xs`` (B, G, N): (B, G, c, N) float32, with the JAX border
    rule (the module docstring)."""
    B, G, c, H, W = img.shape
    inside = (ys > -1.0) & (ys < H) & (xs > -1.0) & (xs < W)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    y0i = y0.to(torch.int64).clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    x0i = x0.to(torch.int64).clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    flat = widen(img.reshape(B, G, c, H * W))
    n = ys.shape[-1]

    def tap(yi, xi):
        idx = (yi * W + xi)[:, :, None, :].expand(B, G, c, n)
        return torch.gather(flat, 3, idx)

    w00 = ((1 - ly) * (1 - lx))[:, :, None]
    w01 = ((1 - ly) * lx)[:, :, None]
    w10 = (ly * (1 - lx))[:, :, None]
    w11 = (ly * lx)[:, :, None]
    out = (w00 * tap(y0i, x0i) + w01 * tap(y0i, x1i)
           + w10 * tap(y1i, x0i) + w11 * tap(y1i, x1i))
    return out * inside[:, :, None].to(out.dtype)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1, dilation: int = 1,
                  mask: Optional[torch.Tensor] = None,
                  deformable_groups: int = 1) -> torch.Tensor:
    """Deformable convolution v1 (v2 with ``mask``).

    x: (B, C, H, W); offset: (B, G·2K, Ho, Wo) (dy, dx) pairs; weight: (O,
    C, k, k) OIHW; mask: optional (B, G·K, Ho, Wo), sigmoided.  Returns
    (B, O, Ho, Wo) in ``x``'s dtype, computed in float32."""
    B, C, H, W = x.shape
    O, _, k, _ = weight.shape
    K = k * k
    G = deformable_groups
    if C % G or offset.shape[1] != G * 2 * K:
        raise ValueError(f"deform_conv2d: {C} channels, {G} deformable "
                         f"groups, offsets of {offset.shape[1]} channels "
                         f"(want {G * 2 * K})")
    Ho = (H + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    dev = x.device
    base_y = (torch.arange(Ho, device=dev) * stride - padding).float()
    base_x = (torch.arange(Wo, device=dev) * stride - padding).float()
    taps = torch.arange(k, device=dev, dtype=torch.float32) * dilation
    ky = taps[:, None].expand(k, k).reshape(K)
    kx = taps[None, :].expand(k, k).reshape(K)
    off = widen(offset).reshape(B, G, K, 2, Ho, Wo)
    ys = (base_y[None, None, None, :, None] + ky[None, None, :, None, None]
          + off[:, :, :, 0])                         # (B, G, K, Ho, Wo)
    xs = (base_x[None, None, None, None, :] + kx[None, None, :, None, None]
          + off[:, :, :, 1])
    n = K * Ho * Wo
    sampled = bilinear_gather(x.reshape(B, G, C // G, H, W),
                              ys.reshape(B, G, n), xs.reshape(B, G, n))
    sampled = sampled.reshape(B, C, K, Ho * Wo)
    if mask is not None:
        m = widen(mask).reshape(B, G, 1, K, Ho * Wo)
        sampled = (sampled.reshape(B, G, C // G, K, Ho * Wo) * m).reshape(
            B, C, K, Ho * Wo)
    out = torch.matmul(widen(weight).reshape(O, C * K),
                       sampled.reshape(B, C * K, Ho * Wo))
    out = out.reshape(B, O, Ho, Wo).to(x.dtype)
    return out if bias is None else out + bias[:, None, None]


class DeformConv2d(nn.Conv2d):
    """mmdet's ``DeformConv`` (``weight``, and a ``bias`` only where asked:
    the reference's deformable layers have none): ``forward(x, offset,
    mask=None)`` is ``deform_conv2d`` at the layer's stride, padding,
    dilation and ``deformable_groups``, its weight first cast to
    ``compute_dtype`` (float32 where the JAX module leaves its kernel in
    float32, as RepPoints' deformable convs).  A subclass of ``nn.Conv2d``
    so the seeded init (``engine/detector.py:init_weights``) draws its
    weight."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, deformable_groups: int = 1,
                 bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, dilation=dilation,
                         bias=bias)
        self.deformable_groups = deformable_groups
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, offset: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        weight = to_compute(self.weight, self.compute_dtype)
        return deform_conv2d(x, offset, weight, self.bias,
                             self.stride[0], self.padding[0],
                             self.dilation[0], mask, self.deformable_groups)


def deform_roi_pooling(feats: torch.Tensor, rois: torch.Tensor,
                       offsets: Optional[torch.Tensor] = None,
                       out_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                       sample_num: int = 2, gamma: float = 0.1
                       ) -> torch.Tensor:
    """Deformable RoI pooling: RoIAlign-style bins of ``sample_num``² samples
    (the JAX border rule), each bin shifted by its learned (dy, dx) offset
    times ``gamma`` times the RoI's height / width.

    feats: (B, C, H, W); rois: (R, 5) (batch index, x1, y1, x2, y2);
    offsets: optional (R, out_size², 2).  Returns (R, C, out_size,
    out_size) float32."""
    B, C, H, W = feats.shape
    R = rois.shape[0]
    s, sn = out_size, sample_num
    rois = rois.float()
    batch_idx = rois[:, 0].to(torch.int64)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = (rois[:, 3] + 1.0) * spatial_scale
    y2 = (rois[:, 4] + 1.0) * spatial_scale
    rw = (x2 - x1).clamp_min(0.1)
    rh = (y2 - y1).clamp_min(0.1)
    bw, bh = rw / s, rh / s
    dev = feats.device
    ph = torch.arange(s, dtype=torch.float32, device=dev)
    frac = (torch.arange(sn, dtype=torch.float32, device=dev) + 0.5) / sn
    grid = (ph[:, None] + frac[None, :]).reshape(-1)          # (s·sn,)
    ys = (y1[:, None] + grid[None, :] * bh[:, None])[:, :, None].expand(
        R, s * sn, s * sn)
    xs = (x1[:, None] + grid[None, :] * bw[:, None])[:, None, :].expand(
        R, s * sn, s * sn)
    if offsets is not None:
        o = widen(offsets).reshape(R, s, s, 2)
        o = o.repeat_interleave(sn, 1).repeat_interleave(sn, 2)
        ys = ys + o[..., 0] * gamma * rh[:, None, None]
        xs = xs + o[..., 1] * gamma * rw[:, None, None]
    img = feats[batch_idx][:, None]                    # (R, 1, C, H, W)
    sampled = bilinear_gather(img, ys.reshape(R, 1, -1),
                              xs.reshape(R, 1, -1))[:, 0]       # (R, C, n)
    return sampled.reshape(R, C, s, sn, s, sn).mean(dim=(3, 5))


def masked_conv2d(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, padding: int = 1
                  ) -> torch.Tensor:
    """mmdet's ``MaskedConv2d``: the dense convolution, zero where ``mask``
    (B, H, W) or (B, 1, H, W) is not positive (mmdet computes only the
    masked positions; the values there are the same)."""
    out = F.conv2d(x, weight, bias, padding=padding)
    if mask.dim() == 3:
        mask = mask[:, None]
    return out * (mask > 0).to(out.dtype)
