"""SELSA non-local block (counterpart of
``hvrnet_tpu/models/bbox_heads/selsa_bbox_head.py:SelsaAttention``).

One block: q/k linear → scaled masked softmax → ·V (V = the block's
key-side input) → 1×1 ``linear_out`` conv.  Padded proposal slots leave the
key set through a −1e30 additive bias.  Parameter names follow mmdet
(``q_data_fc_<i>``, ``k_data_fc_<i>``, ``linear_out_<i>`` inside
``selsa_<i>``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...ops.attention import NEG_INF, masked_attention
from ..layers import conv1x1_as_linear


class SelsaAttention(nn.Module):

    def __init__(self, index: int, dim=(1024, 1024, 1024),
                 fc_feat_dim: int = 1024):
        super().__init__()
        self.index = index
        self.scale = 1.0 / math.sqrt(float(dim[1]))
        self.add_module(f"q_data_fc_{index}", nn.Linear(fc_feat_dim, dim[0]))
        self.add_module(f"k_data_fc_{index}", nn.Linear(fc_feat_dim, dim[1]))
        self.add_module(f"linear_out_{index}",
                        nn.Conv2d(fc_feat_dim, dim[2], 1))

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
        """roi_feat: (Q, D) queries; nongt_feat: (K, D) keys/values.

        ``return_aff`` takes the explicit-affinity path the HRNMP mining
        needs, in plain torch (the JAX package computes it outside its
        kernel): returns (out, aff) with aff the (Q, K) scaled logits,
        −1e30 at masked keys."""
        q = self.q_proj(roi_feat)
        k = self.k_proj(nongt_feat)
        v = nongt_feat.contiguous()
        if return_aff:
            aff = (q @ k.T) * self.scale
            if key_mask is not None:
                aff = torch.where(key_mask[None, :], aff, NEG_INF)
            w = torch.softmax(aff, dim=-1)
            out = w.to(v.dtype) @ v
            return self.out_proj(out.to(roi_feat.dtype)), aff
        if key_mask is None:
            bias = torch.zeros(k.shape[0], dtype=torch.float32,
                               device=k.device)
        else:
            bias = torch.where(key_mask, 0.0, NEG_INF).float()
        out = masked_attention(q, k, v, bias, self.scale)
        return self.out_proj(out.to(roi_feat.dtype))
