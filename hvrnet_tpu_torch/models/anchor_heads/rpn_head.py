"""RPN head (counterpart of ``hvrnet_tpu/models/anchor_heads/rpn_head.py``):
3×3 conv → ReLU → 1×1 sigmoid cls + 1×1 reg."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import HEADS


@HEADS.register_module
class RPNHead(nn.Module):

    def __init__(self, in_channels: int = 1024, feat_channels: int = 512,
                 anchor_scales: Sequence[float] = (4, 8, 16, 32),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0)):
        super().__init__()
        a = len(anchor_scales) * len(anchor_ratios)
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, a, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, a * 4, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, C, Hf, Wf) → cls (B, A, Hf, Wf), reg (B, 4A, Hf, Wf)."""
        h = F.relu(self.rpn_conv(x))
        return self.rpn_cls(h), self.rpn_reg(h)


def rpn_flat_logits_deltas(cls: torch.Tensor, reg: torch.Tensor):
    """Flatten one image's (A, H, W) / (4A, H, W) maps to anchor order:
    logits (H·W·A,), deltas (H·W·A, 4).

    Anchor index = ((y·W) + x)·A + a, the order of the canvas anchors (and of
    the JAX package's NHWC flattening), so the maps are permuted to (H, W, ·)
    before they are reshaped.
    """
    return (cls.permute(1, 2, 0).reshape(-1),
            reg.permute(1, 2, 0).reshape(-1, 4))


def rpn_flat_scores_deltas(cls: torch.Tensor, reg: torch.Tensor):
    """Sigmoid scores and deltas of one image in anchor order, float32."""
    logits, deltas = rpn_flat_logits_deltas(cls, reg)
    return torch.sigmoid(logits.float()), deltas.float()
