"""SELSA non-local block and head (counterparts of
``hvrnet_tpu/models/bbox_heads/selsa_bbox_head.py:SelsaAttention`` and
``SelsaBBoxHead``).

One block: q/k linear → scaled masked softmax → ·V (V = the block's
key-side input) → 1×1 ``linear_out`` conv.  Padded proposal slots leave the
key set through a −1e30 additive bias.  Parameter names follow mmdet
(``q_data_fc_<i>``, ``k_data_fc_<i>``, ``linear_out_<i>`` inside
``selsa_<i>``).

The head: fc_new_1 → NL1 (every row) → fc_new_2 → NL2 (the key frame's
rows) → fc_cls / class-agnostic fc_reg.  Both blocks take their keys from
the first ``nongt_dim = min(sampler_num·t_dim, N)`` rows, as the reference
does: at test time every cached row; in training (sampler_num 128, t_dim 3,
900 rows of 300 RoIs per frame) the first 384.

Every layer computes in ``dtype`` (``core/precision.py``); the attention's
logits and softmax are float32 whatever the dtype, and its float32 output
goes back to ``dtype`` before ``linear_out``.

The block and ``forward_fc1`` also take a leading lane axis (B video
streams in lockstep, each with its own key mask): the rows of all lanes go
through each layer together and each block's attention is one kernel call
for all lanes (the JAX package vmaps the window body).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.precision import widen
from ...ops.attention import (NEG_INF, masked_attention,
                              masked_attention_kv_sharded, pad_keys)
from ..layers import Conv2d, Linear, conv1x1_as_linear
from ..registry import HEADS
from .bbox_head import flatten_roi_feats


class SelsaAttention(nn.Module):
    """``kv_devices``, a device list (``enable_kv_sharded_attention``),
    splits the block's keys over those devices
    (``masked_attention_kv_sharded``, the keys padded to a multiple of the
    device count with −1e30 biases); None keeps the kernel."""

    kv_devices = None

    def __init__(self, index: int, dim=(1024, 1024, 1024),
                 fc_feat_dim: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.index = index
        self.scale = 1.0 / math.sqrt(float(dim[1]))
        self.add_module(f"q_data_fc_{index}", Linear(
            fc_feat_dim, dim[0], compute_dtype=dtype))
        self.add_module(f"k_data_fc_{index}", Linear(
            fc_feat_dim, dim[1], compute_dtype=dtype))
        self.add_module(f"linear_out_{index}", Conv2d(
            fc_feat_dim, dim[2], 1, compute_dtype=dtype))

    # the block's projections one by one, for the streaming ring's caches
    # of stationary rows (ops/streaming_attention.py)
    def q_proj(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"q_data_fc_{self.index}")(x)

    def k_proj(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"k_data_fc_{self.index}")(x)

    def out_proj(self, att: torch.Tensor) -> torch.Tensor:
        return conv1x1_as_linear(getattr(self, f"linear_out_{self.index}"),
                                 att)

    def forward(self, roi_feat: torch.Tensor, nongt_feat: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                return_aff: bool = False):
        """roi_feat: (Q, D) queries; nongt_feat: (K, D) keys/values; or
        (B, Q, D) and (B, K, D) over B lanes, ``key_mask`` (B, K).

        ``return_aff`` takes the explicit-affinity path the HRNMP mining
        needs, in plain torch (the JAX package computes it outside its
        kernel): returns (out, aff) with aff the (Q, K) scaled float32
        logits, −1e30 at masked keys; the softmax weights are rounded to
        v's dtype before their float32 product with v."""
        q = self.q_proj(roi_feat)
        k = self.k_proj(nongt_feat)
        v = nongt_feat.contiguous()
        if return_aff:
            aff = (widen(q) @ widen(k).T) * self.scale
            if key_mask is not None:
                aff = torch.where(key_mask[None, :], aff, NEG_INF)
            w = torch.softmax(aff, dim=-1)
            out = widen(w.to(v.dtype)) @ widen(v)
            return self.out_proj(out.to(roi_feat.dtype)), aff
        if key_mask is None:
            bias = torch.zeros(k.shape[:-1], dtype=torch.float32,
                               device=k.device)
        else:
            bias = torch.where(key_mask, 0.0, NEG_INF).float()
        if self.kv_devices:
            out = masked_attention_kv_sharded(
                q, *pad_keys(k, v, bias, len(self.kv_devices)), self.scale,
                self.kv_devices)
        else:
            out = masked_attention(q, k, v, bias, self.scale)
        return self.out_proj(out.to(roi_feat.dtype))


@HEADS.register_module
class SelsaBBoxHead(nn.Module):
    """Two stacked SELSA blocks over the RoI rows of several frames."""

    def __init__(self, sampler_num: int = 128, t_dim: int = 3,
                 fc_feat_dim: int = 1024,
                 dim: Sequence[int] = (1024, 1024, 1024),
                 roi_feat_size: int = 7, in_channels: int = 256,
                 num_classes: int = 31, reg_class_agnostic: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sampler_num = sampler_num
        self.t_dim = t_dim
        F_ = fc_feat_dim

        def linear(n_in, n_out):
            return Linear(n_in, n_out, compute_dtype=dtype)

        self.fc_new_1 = linear(in_channels * roi_feat_size ** 2, F_)
        self.selsa_1 = SelsaAttention(1, tuple(dim), F_, dtype)
        self.fc_new_2 = linear(F_, F_)
        self.selsa_2 = SelsaAttention(2, tuple(dim), F_, dtype)
        self.fc_cls = linear(F_, num_classes)
        self.fc_reg = linear(F_, 4 if reg_class_agnostic
                             else 4 * num_classes)

    def precompute_fc1(self, bbox_feat: torch.Tensor) -> torch.Tensor:
        """(N, C, 7, 7) pooled RoIs → (N, fc_feat_dim) fc_new_1 rows."""
        return self.fc_new_1(flatten_roi_feats(bbox_feat))

    def forward_fc1(self, fc1: torch.Tensor, cur_start: int, cur_len: int,
                    valid_mask: Optional[torch.Tensor] = None,
                    output_all: bool = False):
        """fc1: (N, D) rows, oldest frame first, or (B, N, D) over B lanes;
        the key frame's rows are [cur_start, cur_start + cur_len);
        ``valid_mask`` (N,) or (B, N) takes padded rows out of the keys.
        Returns (cls, reg) for the key rows, or for every row with
        ``output_all``."""
        nongt = min(self.sampler_num * self.t_dim, fc1.shape[-2])
        kmask = valid_mask[..., :nongt] if valid_mask is not None else None
        fc_all_1 = F.relu(fc1 + self.selsa_1(fc1, fc1[..., :nongt, :], kmask))
        fc2 = self.fc_new_2(fc_all_1)
        q2 = fc2 if output_all else fc2[..., cur_start:cur_start + cur_len, :]
        fc_all_2 = F.relu(q2 + self.selsa_2(q2, fc2[..., :nongt, :], kmask))
        return self.fc_cls(fc_all_2), self.fc_reg(fc_all_2)

    def forward(self, bbox_feat: torch.Tensor, cur_start: int, cur_len: int,
                valid_mask: Optional[torch.Tensor] = None,
                output_all: bool = False):
        """The head from (N, C, 7, 7) pooled RoIs (training, and the
        reference's test loop): ``precompute_fc1`` then ``forward_fc1``."""
        return self.forward_fc1(self.precompute_fc1(bbox_feat), cur_start,
                                cur_len, valid_mask, output_all)
