"""The HVRNet head's losses (counterparts of
``hvrnet_tpu/models/losses.py:softmax_cross_entropy/accuracy`` and
``hvrnet_tpu/engine/train.py:_smooth_l1``), elementwise: the trainer
weights and normalises them."""
from __future__ import annotations

from typing import Optional

import torch


def softmax_cross_entropy(pred: torch.Tensor,
                          label: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy with integer labels."""
    gold = pred.gather(-1, label[..., None])[..., 0]
    return torch.logsumexp(pred, dim=-1) - gold


def accuracy(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-1 accuracy × 100, over the rows of ``mask`` when given."""
    correct = (pred.argmax(dim=-1) == target).float()
    if mask is None:
        return 100.0 * correct.mean()
    m = mask.float()
    return 100.0 * (correct * m).sum() / m.sum().clamp_min(1.0)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
