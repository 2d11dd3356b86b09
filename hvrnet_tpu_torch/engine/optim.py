"""Optimizer and learning-rate schedule of the reference training recipe
(counterpart of ``hvrnet_tpu/engine/optim.py``).

SGD (momentum 0.9, weight decay 1e-4, no dampening, no Nesterov) with the
gradients clipped to global L2 norm 35 first, over the trainable parameters
only; mmcv's step policy with linear warmup.  Frozen tensors (every
FrozenBN buffer, the stem and stages ≤ ``frozen_stages``, and for HVRNet the
whole backbone and RPN) get ``requires_grad=False`` and stay out of the
optimizer, so neither the clip nor the weight decay sees them.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence

import torch


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     milestones_epochs: Sequence[int], gamma: float = 0.1,
                     warmup_iters: int = 500,
                     warmup_ratio: float = 1.0 / 3) -> Callable[[int], float]:
    """lr of step i (before the step counter moves): base_lr decayed by
    ``gamma`` at each milestone, ramped linearly from ``warmup_ratio`` over
    the first ``warmup_iters`` steps."""
    milestones = [m * steps_per_epoch for m in milestones_epochs]

    def schedule(step: int) -> float:
        lr = base_lr * gamma ** sum(step >= m for m in milestones)
        if warmup_iters > 0 and step < warmup_iters:
            k = (1.0 - step / warmup_iters) * (1.0 - warmup_ratio)
            lr = lr * (1.0 - k)
        return lr

    return schedule


def default_trainable_mask(model: torch.nn.Module, frozen_stages: int = 1,
                           freeze_backbone: bool = False,
                           freeze_rpn: bool = False) -> Dict[str, bool]:
    """Parameter name → whether it trains.  FrozenBN tensors are buffers,
    so they never appear here; the stem (``backbone.conv1``) and
    ``backbone.layer1..frozen_stages`` are frozen, and the whole backbone
    and ``rpn_head`` when asked."""
    frozen_prefixes = ["backbone.conv1."] + [
        f"backbone.layer{s}." for s in range(1, frozen_stages + 1)]
    if freeze_backbone:
        frozen_prefixes.append("backbone.")
    if freeze_rpn:
        frozen_prefixes.append("rpn_head.")
    return {name: not name.startswith(tuple(frozen_prefixes))
            for name, _ in model.named_parameters()}


def clip_grad_global_norm_(params: Iterable[torch.nn.Parameter],
                           max_norm: float) -> torch.Tensor:
    """Scale the gradients to global L2 norm ``max_norm`` when above it,
    as ``optax.clip_by_global_norm`` does (t / norm · max_norm, no epsilon);
    returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> torch.optim.SGD:
    """torch SGD over the trainable parameters: +wd·param → momentum
    buffer → −lr·buffer, after the caller clipped the gradients."""
    return torch.optim.SGD(list(params), lr=lr, momentum=momentum,
                           dampening=0.0, nesterov=False,
                           weight_decay=weight_decay)
