"""Losses (counterparts of ``hvrnet_tpu/models/losses.py`` and
``hvrnet_tpu/engine/train.py:_smooth_l1``): the elementwise ones the
trainers weight and normalise themselves (``sigmoid_focal_loss`` among
them, mmdet's CUDA focal loss as a plain expression, as the JAX package has
it), and the config-built loss classes with mmdet's weighted reduction
(``build_loss``, ``LOSSES``): cross entropy, smooth-L1, MSE, focal, IoU,
bounded IoU, balanced-L1 and the gradient-harmonized GHM-C / GHM-R."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
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


def sigmoid_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25
                       ) -> torch.Tensor:
    """Elementwise sigmoid focal loss of (…, C) logits against integer
    labels (…,), 1-based foreground and 0 background (a row of zeros):
    ``α_t (1 − p_t)^γ · BCE``."""
    t, _ = expand_binary_labels(target, None, pred.shape[-1])
    p = torch.sigmoid(pred)
    pos = t == 1
    pt = torch.where(pos, p, 1 - p)
    at = torch.where(pos, alpha, 1 - alpha)
    return at * (1 - pt) ** gamma * binary_cross_entropy_with_logits(pred, t)


@LOSSES.register_module
class FocalLoss(_WeightedLoss):
    """Sigmoid focal loss (mmdet's ``use_sigmoid=True`` only); a weight of
    one value per row covers the row's classes."""

    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0,
                 alpha: float = 0.25, reduction: str = "mean",
                 loss_weight: float = 1.0):
        if not use_sigmoid:
            raise ValueError("FocalLoss is sigmoid only, as in the JAX "
                             "package")
        super().__init__(reduction, loss_weight)
        self.gamma, self.alpha = gamma, alpha

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        loss = sigmoid_focal_loss(pred, target, self.gamma, self.alpha)
        if weight is not None and weight.ndim < loss.ndim:
            weight = weight[..., None]
        return self._reduce(loss, weight, avg_factor, reduction_override)


@LOSSES.register_module
class IoULoss(_WeightedLoss):
    """−log IoU of aligned (N, 4) boxes (+1 pixel convention), the IoU
    clamped below at ``eps``; a weight of (N, 4) is read in its first
    column."""

    def __init__(self, eps: float = 1e-6, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.eps = eps

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        lt = torch.maximum(pred[:, :2], target[:, :2])
        rb = torch.minimum(pred[:, 2:4], target[:, 2:4])
        wh = (rb - lt + 1).clamp_min(0)
        overlap = wh[:, 0] * wh[:, 1]
        a1 = (pred[:, 2] - pred[:, 0] + 1) * (pred[:, 3] - pred[:, 1] + 1)
        a2 = ((target[:, 2] - target[:, 0] + 1)
              * (target[:, 3] - target[:, 1] + 1))
        ious = overlap / (a1 + a2 - overlap).clamp_min(self.eps)
        loss = -torch.log(ious.clamp_min(self.eps))
        if weight is not None and weight.ndim > 1:
            weight = weight[:, 0]
        return self._reduce(loss, weight, avg_factor, reduction_override)


@LOSSES.register_module
class BoundedIoULoss(_WeightedLoss):
    """Bounded IoU loss of aligned (N, 4) boxes: per coordinate (centre x,
    centre y, width, height) a bounded IoU surrogate, smooth-L1'd at
    ``beta`` and summed over the four; a weight of (N, 4) is read in its
    first column."""

    def __init__(self, beta: float = 0.2, eps: float = 1e-3,
                 reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.beta, self.eps = beta, eps

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        eps = self.eps

        def centre_size(b):
            return ((b[:, 0] + b[:, 2]) * 0.5, (b[:, 1] + b[:, 3]) * 0.5,
                    b[:, 2] - b[:, 0] + 1, b[:, 3] - b[:, 1] + 1)

        px, py, pw, ph = centre_size(pred)
        tx, ty, tw, th = centre_size(target)
        dx, dy = (tx - px).abs(), (ty - py).abs()
        comb = torch.stack([
            1 - ((tw - 2 * dx) / (tw + 2 * dx + eps)).clamp_min(0),
            1 - ((th - 2 * dy) / (th + 2 * dy + eps)).clamp_min(0),
            1 - torch.minimum(tw / (pw + eps), pw / (tw + eps)),
            1 - torch.minimum(th / (ph + eps), ph / (th + eps))], dim=-1)
        loss = torch.where(comb < self.beta,
                           0.5 * comb * comb / self.beta,
                           comb - 0.5 * self.beta).sum(-1)
        if weight is not None and weight.ndim > 1:
            weight = weight[:, 0]
        return self._reduce(loss, weight, avg_factor, reduction_override)


@LOSSES.register_module
class BalancedL1Loss(_WeightedLoss):
    """Libra R-CNN's balanced-L1: ``α/b (b|x| + 1) log(b|x|/β + 1) − α|x|``
    below ``beta``, ``γ|x| + γ/b − αβ`` above, with ``b = e^{γ/α} − 1``."""

    def __init__(self, alpha: float = 0.5, gamma: float = 1.5,
                 beta: float = 1.0, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__(reduction, loss_weight)
        self.alpha, self.gamma, self.beta = alpha, gamma, beta

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        a, g, beta = self.alpha, self.gamma, self.beta
        diff = (pred - target).abs()
        b = math.e ** (g / a) - 1
        loss = torch.where(
            diff < beta,
            a / b * (b * diff + 1) * torch.log(b * diff / beta + 1) - a * diff,
            g * diff + g / b - a * beta)
        return self._reduce(loss, weight, avg_factor, reduction_override)


def _ghm_weights(g: torch.Tensor, valid: torch.Tensor, edges) -> tuple:
    """GHM's per-element weights: ``tot / count`` of the gradient-norm bin
    each valid element falls in (``edges``, a Python list), 0 outside, over
    the number of bins; and ``tot``, the valid count (at least 1)."""
    tot = valid.sum().float().clamp_min(1.0)
    weights = torch.zeros_like(g)
    for lo, hi in zip(edges[:-1], edges[1:]):
        inds = (g >= lo) & (g < hi) & valid
        num_in_bin = inds.sum()
        weights = torch.where(inds & (num_in_bin > 0),
                              tot / num_in_bin.float().clamp_min(1), weights)
    return weights / (len(edges) - 1), tot


def _ghm_edges(bins: int, top: float) -> list:
    """The JAX package's bin edges, ``jnp.linspace(0, 1, bins + 1)`` with
    ``top`` added to the last: in float32, i times the reciprocal of
    ``bins`` (XLA's division by a constant; 9 · 0.1 rounds to 0.90000004
    where 9 / 10 gives 0.9), then 1 + ``top``."""
    edges = np.append(np.arange(bins, dtype=np.float32)
                      * np.float32(1.0 / bins), np.float32(1.0))
    edges[-1] = np.float32(edges[-1] + np.float32(top))
    return [float(e) for e in edges]


@LOSSES.register_module
class GHMC:
    """Gradient-harmonized classification loss (sigmoid only, ``momentum``
    unused, as in the JAX package): BCE weighted by the inverse density of
    each valid element's gradient norm |σ(x) − t| over ``bins`` bins, summed
    and divided by the valid count."""

    def __init__(self, bins: int = 10, momentum: float = 0,
                 use_sigmoid: bool = True, loss_weight: float = 1.0):
        if not use_sigmoid:
            raise ValueError("GHMC is sigmoid only, as in the JAX package")
        self.bins = bins
        self.loss_weight = loss_weight

    def __call__(self, pred, target, label_weight, avg_factor=None,
                 reduction_override=None):
        if pred.ndim != target.ndim:
            target, label_weight = expand_binary_labels(target, label_weight,
                                                        pred.shape[-1])
        target = target.float()
        g = (torch.sigmoid(pred) - target).abs()
        weights, tot = _ghm_weights(g, label_weight > 0,
                                    _ghm_edges(self.bins, 1e-6))
        loss = binary_cross_entropy_with_logits(pred, target) * weights
        return self.loss_weight * loss.sum() / tot


@LOSSES.register_module
class GHMR:
    """Gradient-harmonized regression loss (``momentum`` unused, as in the
    JAX package): the authentic smooth-L1 ``sqrt(d² + μ²) − μ`` weighted by
    the inverse density of each valid element's gradient norm
    ``|d| / sqrt(d² + μ²)`` over ``bins`` bins, summed and divided by the
    valid count."""

    def __init__(self, mu: float = 0.02, bins: int = 10, momentum: float = 0,
                 loss_weight: float = 1.0):
        self.mu = mu
        self.bins = bins
        self.loss_weight = loss_weight

    def __call__(self, pred, target, label_weight, avg_factor=None):
        mu = self.mu
        diff = pred - target
        loss = torch.sqrt(diff * diff + mu * mu) - mu
        g = (diff / torch.sqrt(mu * mu + diff * diff)).abs()
        weights, tot = _ghm_weights(g, label_weight > 0,
                                    _ghm_edges(self.bins, 1e3))
        return self.loss_weight * (loss * weights).sum() / tot


def build_loss(cfg):
    """A loss from its config (``type`` one of ``LOSSES``)."""
    from ..utils.registry import build_from_cfg
    return build_from_cfg(cfg, LOSSES)
