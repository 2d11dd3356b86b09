"""Losses (counterparts of ``hvrnet_tpu/models/losses.py:20-112, 295-306``
and ``hvrnet_tpu/engine/train.py:_smooth_l1``): the elementwise ones the
trainers weight and normalise themselves, and the config-built loss
classes with mmdet's weighted reduction (``build_loss``, ``LOSSES``).
Focal, IoU, GHM and balanced-L1 are not ported yet."""
from __future__ import annotations

from typing import Optional

import torch

from .registry import LOSSES


def weight_reduce_loss(loss: torch.Tensor, weight=None,
                       reduction: str = "mean", avg_factor=None):
    """mmdet's ``losses/utils.py:weight_reduce_loss``: weight elementwise,
    then reduce by ``reduction``, or divide the sum by ``avg_factor``."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        if reduction == "mean":
            return loss.mean()
        if reduction == "sum":
            return loss.sum()
        return loss
    if reduction == "mean":
        return loss.sum() / avg_factor
    if reduction == "none":
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


def softmax_cross_entropy(pred: torch.Tensor,
                          label: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy with integer labels."""
    gold = pred.gather(-1, label[..., None])[..., 0]
    return torch.logsumexp(pred, dim=-1) - gold


def binary_cross_entropy_with_logits(pred: torch.Tensor,
                                     target: torch.Tensor) -> torch.Tensor:
    """Elementwise, in the JAX package's form
    ``max(x, 0) - x·t + log1p(exp(-|x|))``."""
    return pred.clamp_min(0) - pred * target + torch.log1p(
        torch.exp(-pred.abs()))


def expand_binary_labels(labels: torch.Tensor,
                         label_weights: Optional[torch.Tensor],
                         label_channels: int):
    """1-based foreground labels → (…, label_channels) one-hot rows (label 0
    all zero), and the weights broadcast over the channels."""
    chan = torch.arange(label_channels, device=labels.device)
    bin_labels = ((labels[..., None] - 1 == chan)
                  & (labels >= 1)[..., None]).float()
    if label_weights is None:
        return bin_labels, None
    return bin_labels, label_weights[..., None].expand(bin_labels.shape)


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


class _WeightedLoss:
    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def _reduce(self, loss, weight, avg_factor, reduction_override):
        return self.loss_weight * weight_reduce_loss(
            loss, weight, reduction_override or self.reduction, avg_factor)


@LOSSES.register_module
class CrossEntropyLoss(_WeightedLoss):
    """Softmax cross entropy with integer labels, or with ``use_sigmoid``
    the binary one against one-hot rows of 1-based labels (or targets of
    the prediction's shape)."""

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = "mean", loss_weight: float = 1.0):
        if use_mask:
            raise ValueError("CrossEntropyLoss(use_mask=True) is not "
                             "supported, as in the JAX package")
        super().__init__(reduction, loss_weight)
        self.use_sigmoid = use_sigmoid

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override=None):
        if self.use_sigmoid:
            if cls_score.ndim != label.ndim:
                label, weight = expand_binary_labels(label, weight,
                                                     cls_score.shape[-1])
            loss = binary_cross_entropy_with_logits(cls_score, label.float())
        else:
            loss = softmax_cross_entropy(cls_score, label)
        return self._reduce(loss, weight, avg_factor, reduction_override)


@LOSSES.register_module
class SmoothL1Loss(_WeightedLoss):
    def __init__(self, beta: float = 1.0, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.beta = beta

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._reduce(smooth_l1(pred, target, self.beta), weight,
                            avg_factor, reduction_override)


@LOSSES.register_module
class MSELoss(_WeightedLoss):
    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._reduce((pred - target) ** 2, weight, avg_factor,
                            reduction_override)


def build_loss(cfg):
    """A loss from its config (``type`` one of ``LOSSES``)."""
    from ..utils.registry import build_from_cfg
    return build_from_cfg(cfg, LOSSES)
