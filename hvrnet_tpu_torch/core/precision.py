"""Mixed-precision policy and dynamic loss scaling (counterpart of
``hvrnet_tpu/core/precision.py``).

The policy: bf16 compute, f32 parameters, and f32 for the softmaxes, the
losses and the box arithmetic.  It is no autocast: each module carries its
compute ``dtype``, casts its input and its f32 weights to it at the call
(``to_compute``) and keeps f32 parameters, so gradients reach f32 master
weights.  Products whose result the policy keeps in f32 (the attention
logits, RoIAlign's second contraction, the streaming accumulators) widen
their bf16 operands first (``widen``): a bf16 × bf16 product is exact in
f32.  Under ``FP32_POLICY`` every cast is the identity, so the f32 path is
the port's f32 path bit for bit (and a float64 recompute stays float64).

``DynamicLossScale`` is the ``fp16 = dict(loss_scale=...)`` config key
(mmdet's ``Fp16OptimizerHook``): scale the loss, unscale the gradients,
skip the step and back off the scale on non-finite gradients, grow it every
``growth_interval`` good steps.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple, Tuple

import torch

_HALF = (torch.bfloat16, torch.float16)


class Policy(NamedTuple):
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(torch.float32, torch.float32, torch.float32)


def cast_floating(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` when it is a floating tensor, else unchanged."""
    return x.to(dtype) if x.is_floating_point() else x


def to_compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in a module's compute ``dtype``; float32 compute casts
    nothing."""
    return x if dtype == torch.float32 else x.to(dtype)


def widen(x: torch.Tensor) -> torch.Tensor:
    """A 16-bit float tensor in float32; any other unchanged."""
    return x.float() if x.dtype in _HALF else x


class LossScaleState(NamedTuple):
    scale: torch.Tensor        # () float32
    good_steps: torch.Tensor   # () int32


class DynamicLossScale:
    """Fp16OptimizerHook-style dynamic scaling (reference
    ``mmdet/core/fp16/hooks.py:11-85``)."""

    def __init__(self, init_scale: float = 512.0, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, growth_interval: int = 2000):
        self.init_scale = init_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval

    @classmethod
    def from_config(cls, fp16: dict) -> "DynamicLossScale":
        """``loss_scale='dynamic'``: mmcv's growth and backoff; a number:
        that scale, fixed (growth 1, backoff 1), the reference's
        semantics."""
        ls = fp16.get("loss_scale", 512.0)
        if ls == "dynamic":
            return cls()
        return cls(init_scale=float(ls), growth_factor=1.0,
                   backoff_factor=1.0, growth_interval=1 << 30)

    def init(self, device=None) -> LossScaleState:
        return LossScaleState(
            torch.tensor(self.init_scale, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))

    def scale_loss(self, loss: torch.Tensor,
                   state: LossScaleState) -> torch.Tensor:
        return loss * state.scale

    def unscale_and_check(self, grads: Iterable[torch.Tensor],
                          state: LossScaleState
                          ) -> Tuple[torch.Tensor, LossScaleState]:
        """Unscale ``grads`` in place; returns (finite flag, next state).
        The flag is a device bool: the caller skips the step when it is
        false."""
        grads = list(grads)
        inv = 1.0 / state.scale
        for g in grads:
            g.mul_(inv)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        good = torch.where(finite, state.good_steps + 1,
                           torch.zeros_like(state.good_steps))
        grow = good >= self.growth_interval
        scale = torch.where(
            finite,
            torch.where(grow, state.scale * self.growth_factor, state.scale),
            state.scale * self.backoff_factor)
        good = torch.where(grow, torch.zeros_like(good), good)
        return finite, LossScaleState(scale, good)
