"""Backbone plugins (NCHW), counterparts of ``hvrnet_tpu/models/plugins.py``:
the embedded-gaussian ``NonLocal2D``, the global context block
``ContextBlock`` (the ResNet ``gcb`` plugin) and ``GeneralizedAttention``
(the ResNet ``gen_attention`` plugin).

They follow the JAX modules where those part from mmdet:

* ``ContextBlock``'s bottleneck norm is flax's ``LayerNorm`` over the
  channels with epsilon 1e-6 (mmdet: 1e-5), computed in float32; the
  fusions apply in the order ``fusion_types`` lists them.
* ``GeneralizedAttention`` takes its queries and keys by strided slicing
  (``x[..., ::stride, ::stride]``; mmdet average-pools) and does not
  upsample its output; its energies are unscaled, its position terms are
  divided by √2; the position tables (``sine_position_embedding``) and the
  spatial-range mask (``local_constraint_mask``) are built in numpy as the
  JAX module builds them, bit for bit; forbidden keys get −inf; with the
  key-saliency term alone (``'0010'``) one energy row per head is broadcast
  over the queries and the constraint window is query (0, 0)'s.
* Every product the JAX module takes with ``preferred_element_type=f32``
  widens its operands to float32 here (``core/precision.py:widen``): a
  bf16 × bf16 product is exact in float32.

These are XLA einsums in the JAX package, not Pallas kernels, so plain
PyTorch is their port.  Parameters keep mmdet's names: ``g`` / ``theta`` /
``phi`` / ``conv_out`` (``.conv``); ``conv_mask``, ``channel_add_conv`` /
``channel_mul_conv`` (``.0`` the 1×1 reduction, ``.1`` the LayerNorm of
shape (planes, 1, 1), ``.3`` the 1×1 expansion); ``query_conv``,
``key_conv``, ``value_conv``, ``appr_geom_fc_x`` / ``_y``, ``appr_bias``,
``geom_bias``, ``proj_conv`` and ``gamma``.  The zero-initialised layers of
the JAX modules (``conv_out``, the fusions' last conv, ``gamma``) start at
zero here too (``init_std`` 0 for ``engine/detector.py:init_weights``).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import to_compute, widen
from .layers import Conv2d, ConvModule


class NonLocal2D(nn.Module):
    """Embedded-gaussian non-local block: softmax(θ·φᵀ [/ √inter]) · g,
    a 1×1 ``conv_out`` back to the input width, added to the input."""

    def __init__(self, in_channels: int, reduction: int = 2,
                 use_scale: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        inter = max(in_channels // reduction, 1)
        self.inter, self.use_scale, self.dtype = inter, use_scale, dtype
        for name in ("g", "theta", "phi"):
            setattr(self, name, ConvModule(in_channels, inter, 1, dtype,
                                           activation=None))
        self.conv_out = ConvModule(inter, in_channels, 1, dtype,
                                   activation=None)
        self.conv_out.conv.init_std = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        x = to_compute(x, self.dtype)

        def rows(conv):                                 # (B, HW, inter)
            return conv(x).flatten(2).transpose(1, 2)

        g, theta, phi = rows(self.g), rows(self.theta), rows(self.phi)
        aff = widen(theta) @ widen(phi).transpose(1, 2)
        if self.use_scale:
            aff = aff / math.sqrt(self.inter)
        w = torch.softmax(aff, dim=-1)
        y = (widen(w.to(g.dtype)) @ widen(g)).to(x.dtype)
        y = y.transpose(1, 2).reshape(B, self.inter, H, W)
        return x + self.conv_out(y)


class ContextBlock(nn.Module):
    """Global context block (GCNet): attention or average pooling to one
    context vector, then per fusion a 1×1 → LayerNorm → ReLU → 1×1
    bottleneck added to (``channel_add``) or gating by its sigmoid
    (``channel_mul``) the input."""

    def __init__(self, in_channels: int, ratio: float = 1.0 / 16,
                 pooling_type: str = "att",
                 fusion_types: Sequence[str] = ("channel_add",),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pooling_type not in ("att", "avg"):
            raise ValueError(f"pooling_type {pooling_type!r}: 'att' or 'avg'")
        for fusion in fusion_types:
            if fusion not in ("channel_add", "channel_mul"):
                raise ValueError(f"fusion type {fusion!r}: 'channel_add' or "
                                 "'channel_mul'")
        planes = max(int(in_channels * ratio), 1)
        self.pooling_type, self.dtype = pooling_type, dtype
        self.fusion_types = tuple(fusion_types)
        if pooling_type == "att":
            self.conv_mask = Conv2d(in_channels, 1, 1, compute_dtype=dtype)
        for fusion in self.fusion_types:
            expand = Conv2d(planes, in_channels, 1, compute_dtype=dtype)
            expand.init_std = 0.0
            setattr(self, f"{fusion}_conv", nn.Sequential(
                Conv2d(in_channels, planes, 1, compute_dtype=dtype),
                nn.LayerNorm([planes, 1, 1], eps=1e-6), nn.ReLU(), expand))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        x = to_compute(x, self.dtype)
        if self.pooling_type == "att":
            attn = torch.softmax(self.conv_mask(x).reshape(B, H * W, 1),
                                 dim=1)
            ctx = (x.reshape(B, C, H * W) @ attn).reshape(B, C, 1, 1)
        else:
            ctx = x.mean(dim=(2, 3), keepdim=True)
        out = x
        for fusion in self.fusion_types:
            reduce, norm, _, expand = getattr(self, f"{fusion}_conv")
            t = expand(F.relu(norm(widen(reduce(ctx)))))
            out = out + t if fusion == "channel_add" else \
                out * torch.sigmoid(t)
        return out


def sine_position_embedding(length_q: int, length_kv: int, q_stride: int,
                            kv_stride: int, magnitude, feat_dim: int,
                            wave_length: float = 1000.0) -> np.ndarray:
    """The relative-coordinate sinusoid table (length_q, length_kv,
    feat_dim / 2), [sin(diff/λ_i) ‖ cos(diff/λ_i)], in numpy float32 with
    the JAX module's operations in its order (``_sine_position_embedding``),
    so bit for bit its table."""
    q_idx = np.arange(length_q, dtype=np.float32) * q_stride
    kv_idx = np.arange(length_kv, dtype=np.float32) * kv_stride
    diff = (q_idx[:, None] - kv_idx[None, :]) * magnitude
    feat_range = np.arange(int(feat_dim / 4), dtype=np.float32)
    dim_mat = wave_length ** ((4.0 / feat_dim) * feat_range)
    phase = diff[:, :, None] / dim_mat[None, None, :]
    return np.concatenate([np.sin(phase), np.cos(phase)], axis=2)


def local_constraint_mask(h: int, w: int, h_kv: int, w_kv: int,
                          spatial_range: int, kv_stride: int) -> np.ndarray:
    """(h·w, h_kv·w_kv) booleans, True where a key is forbidden: query
    (i, j) sees the keys (ky, kx) with max((i − range) // kv, 0) ≤ ky ≤
    (i + range + 1) // kv, and the same across."""
    iy = np.arange(h)[:, None]
    ky = np.arange(h_kv)[None, :]
    y_ok = (ky >= np.maximum((iy - spatial_range) // kv_stride, 0)) & \
           (ky <= (iy + spatial_range + 1) // kv_stride)
    ix = np.arange(w)[:, None]
    kx = np.arange(w_kv)[None, :]
    x_ok = (kx >= np.maximum((ix - spatial_range) // kv_stride, 0)) & \
           (kx <= (ix + spatial_range + 1) // kv_stride)
    allowed = y_ok[:, None, :, None] & x_ok[None, :, None, :]
    return ~allowed.reshape(h * w, h_kv * w_kv)


class GeneralizedAttention(nn.Module):
    """Generalized empirical attention over the four energy terms
    ``attention_type`` selects ('1000' query content × key content,
    '0100' query content × relative position, '0010' key saliency, '0001'
    relative position alone); the output ``gamma · proj_conv(attention)``
    added to the input."""

    def __init__(self, in_channels: int, spatial_range: int = -1,
                 num_heads: int = 9, position_embedding_dim: int = -1,
                 position_magnitude: int = 1, kv_stride: int = 2,
                 q_stride: int = 1, attention_type: str = "1111",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.at = [c == "1" for c in attention_type]
        if len(self.at) != 4 or not any(self.at):
            raise ValueError(f"attention_type {attention_type!r}: four 0/1 "
                             "digits, at least one 1")
        self.heads = num_heads
        self.qk_dim = in_channels // num_heads
        out_c = self.qk_dim * num_heads
        self.pos_dim = (position_embedding_dim if position_embedding_dim > 0
                        else in_channels)
        self.spatial_range, self.kv_stride = spatial_range, kv_stride
        self.q_stride, self.magnitude = q_stride, position_magnitude
        self.dtype = dtype
        at = self.at
        if at[0] or at[1]:
            self.query_conv = Conv2d(in_channels, out_c, 1, bias=False,
                                     compute_dtype=dtype)
        if at[0] or at[2]:
            self.key_conv = Conv2d(in_channels, out_c, 1, bias=False,
                                   compute_dtype=dtype)
        self.value_conv = Conv2d(in_channels, out_c, 1, bias=False,
                                 compute_dtype=dtype)
        if at[1] or at[3]:
            self.appr_geom_fc_x = nn.Linear(self.pos_dim // 2, out_c,
                                            bias=False)
            self.appr_geom_fc_y = nn.Linear(self.pos_dim // 2, out_c,
                                            bias=False)
        self.bias_bound = 1.0 / math.sqrt(self.qk_dim * 2)
        if at[2]:
            self.appr_bias = nn.Parameter(torch.zeros(out_c))
        if at[3]:
            self.geom_bias = nn.Parameter(torch.zeros(out_c))
        self.proj_conv = Conv2d(out_c, in_channels, 1, compute_dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def draw_params(self, gen: torch.Generator) -> None:
        """The seeded draw ``init_weights`` leaves to the module: the
        biases uniform in ±1/√(2·qk_dim), as the JAX module's init;
        ``gamma`` stays 0."""
        for name in ("appr_bias", "geom_bias"):
            p = getattr(self, name, None)
            if p is not None:
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                        * self.bias_bound)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, heads·d, h, w) → (B, h·w, heads, d), the channels head-major
        as the JAX reshape of the NHWC map."""
        B, _, h, w = x.shape
        return x.reshape(B, self.heads, -1, h * w).permute(0, 3, 1, 2)

    def _positions(self, fc, n_q: int, n_kv: int, device) -> torch.Tensor:
        emb = torch.from_numpy(sine_position_embedding(
            n_q, n_kv, self.q_stride, self.kv_stride, self.magnitude,
            self.pos_dim)).to(device)
        out = F.linear(to_compute(emb, self.dtype),
                       to_compute(fc.weight, self.dtype))
        return out.reshape(n_q, n_kv, self.heads, self.qk_dim) / math.sqrt(2)

    def _forbid(self, energy, h, w, hk, wk):
        forbid = torch.from_numpy(local_constraint_mask(
            h, w, hk, wk, self.spatial_range, self.kv_stride)).to(
                energy.device)
        return energy.masked_fill(forbid[None, None], float("-inf"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        at, dt = self.at, self.dtype
        x = to_compute(x, dt)
        x_q = x[:, :, ::self.q_stride, ::self.q_stride]
        x_kv = x[:, :, ::self.kv_stride, ::self.kv_stride]
        B, _, H, W = x_q.shape
        Hk, Wk = x_kv.shape[2:]
        heads, d = self.heads, self.qk_dim
        if at[0] or at[1]:
            q = self._heads(self.query_conv(x_q))
        if at[0] or at[2]:
            k = self._heads(self.key_conv(x_kv))
        v = self._heads(self.value_conv(x_kv))
        if at[1] or at[3]:
            pos_x = self._positions(self.appr_geom_fc_x, W, Wk, x.device)
            pos_y = self._positions(self.appr_geom_fc_y, H, Hk, x.device)
        if at[2]:
            appr_bias = to_compute(self.appr_bias, dt).reshape(heads, d)
        if at[3]:
            geom_bias = to_compute(self.geom_bias, dt).reshape(heads, d)

        if sum(at) == 1 and at[2]:
            energy = torch.einsum("hd,bkhd->bhk", widen(appr_bias),
                                  widen(k))[:, :, None, :]
            if self.spatial_range >= 0:
                energy = self._forbid(energy, 1, 1, Hk, Wk)
            Hq, Wq = 1, 1
        else:
            Hq, Wq = H, W
            energy = torch.zeros((B, heads, H, W, Hk, Wk),
                                 dtype=torch.float32, device=x.device)
            if at[0]:
                qa = q + appr_bias if at[2] else q
                energy = energy + torch.einsum(
                    "bqhd,bkhd->bhqk", widen(qa), widen(k)).reshape(
                        B, heads, H, W, Hk, Wk)
            elif at[2]:
                e = torch.einsum("hd,bkhd->bhk", widen(appr_bias), widen(k))
                energy = energy + e.reshape(B, heads, 1, 1, Hk, Wk)
            if at[1]:
                qg = (q + geom_bias if at[3] else q).reshape(B, H, W, heads,
                                                             d)
                energy = energy + torch.einsum(
                    "byxhd,xkhd->bhyxk", widen(qg),
                    widen(pos_x))[..., None, :]
                energy = energy + torch.einsum(
                    "byxhd,ykhd->bhyxk", widen(qg), widen(pos_y))[..., None]
            elif at[3]:
                ex = torch.einsum("xkhd,hd->hxk", widen(pos_x),
                                  widen(geom_bias))
                ey = torch.einsum("ykhd,hd->hyk", widen(pos_y),
                                  widen(geom_bias))
                energy = energy + ex[None, :, None, :, None, :]
                energy = energy + ey[None, :, :, None, :, None]
            energy = energy.reshape(B, heads, H * W, Hk * Wk)
            if self.spatial_range >= 0:
                energy = self._forbid(energy, H, W, Hk, Wk)

        attn = torch.softmax(energy, dim=3)
        out = torch.einsum("bhqk,bkhd->bqhd", widen(attn.to(v.dtype)),
                           widen(v))
        out = out.reshape(B, Hq, Wq, heads * d).permute(0, 3, 1, 2)
        out = self.proj_conv(out.to(x.dtype))
        return to_compute(self.gamma, dt) * out + x
