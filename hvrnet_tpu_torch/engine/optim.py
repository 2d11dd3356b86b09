"""Optimizer and learning-rate schedule of the reference training recipe
(counterpart of ``hvrnet_tpu/engine/optim.py``).

SGD (momentum 0.9, weight decay 1e-4, no dampening, no Nesterov) with the
gradients clipped to global L2 norm 35 first, over the trainable parameters
only; mmcv's step policy with linear warmup.  Frozen tensors (every
FrozenBN buffer, the stem and stages ≤ ``frozen_stages``, and for HVRNet the
whole backbone and RPN) get ``requires_grad=False`` and stay out of the
optimizer, so neither the clip nor the weight decay sees them.

``optimizer.paramwise_options`` (``bias_lr_mult``, ``bias_decay_mult``,
``norm_decay_mult``) become parameter groups with their own lr multiplier
and weight decay, as mmdet's ``build_optimizer`` makes them.
"""
from __future__ import annotations

import re
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

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


# mmdet's norm-layer rule (``mmdet/apis/train.py:155``) on mmdet names; the
# JAX package matches flax keys ``bn*`` / ``gn*`` the same way
_NORM_PARAM = re.compile(r"(bn|gn)(\d+)?.(weight|bias)")


def paramwise_mults(name: str,
                    paramwise_options: dict) -> Tuple[float, float]:
    """(lr multiplier, weight-decay multiplier) of the parameter ``name``:
    ``norm_decay_mult`` for every tensor of a norm layer, ``bias_lr_mult``
    and ``bias_decay_mult`` for the other layers' biases.  (Every norm
    layer of the shipped configs is a frozen BN, whose tensors are buffers
    and never train.)"""
    if _NORM_PARAM.search(name):
        return 1.0, float(paramwise_options.get("norm_decay_mult", 1.0))
    if name.endswith(".bias"):
        return (float(paramwise_options.get("bias_lr_mult", 1.0)),
                float(paramwise_options.get("bias_decay_mult", 1.0)))
    return 1.0, 1.0


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   momentum: float = 0.9, weight_decay: float = 1e-4,
                   names: Optional[Sequence[str]] = None,
                   paramwise_options: Optional[dict] = None
                   ) -> torch.optim.SGD:
    """torch SGD over the trainable parameters: +wd·param → momentum
    buffer → −lr·buffer, after the caller clipped the gradients.

    With ``paramwise_options`` (and the parameters' ``names``) the
    parameters fall into groups by their (lr, decay) multipliers; a group's
    ``lr_mult`` scales the lr the trainer sets (torch applies a group's lr
    after the momentum buffer, as the JAX chain scales the update) and its
    weight decay is ``weight_decay`` times the decay multiplier.  Without
    them there is one group, with ``lr_mult`` 1."""
    params = list(params)
    if not paramwise_options:
        groups = [dict(params=params, lr_mult=1.0)]
    else:
        if names is None or len(names) != len(params):
            raise ValueError("paramwise_options needs the parameters' names")
        by_mults: Dict[Tuple[float, float], List] = {}
        for name, p in zip(names, params):
            by_mults.setdefault(paramwise_mults(name, paramwise_options),
                                []).append(p)
        groups = [dict(params=ps, lr_mult=lr_m,
                       weight_decay=weight_decay * wd_m)
                  for (lr_m, wd_m), ps in by_mults.items()]
    for g in groups:
        g["lr"] = lr * g["lr_mult"]
    return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                           dampening=0.0, nesterov=False,
                           weight_decay=weight_decay)
