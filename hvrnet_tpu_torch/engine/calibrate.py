"""Frozen-BN statistic calibration (counterpart of
``hvrnet_tpu/engine/calibrate.py``), the stand-in for pretrained running
statistics when the weights are random.

With random convolutions and frozen (mean 0, var 1) statistics the
caffe-style bottlenecks compound activation scale block after block, up to
~1e9-1e11 at C5 for depth 101.  In-pass calibration runs the backbone and
shared head once per image with every ``FrozenBN`` normalising by its own
input's per-channel moments, so each downstream BN sees its final input;
the moments, averaged over the images, become the stored statistics.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..models.layers import FrozenBN
from .detector import f32_precision

_VAR_FLOOR = 1e-8


@torch.no_grad()
def calibrate_frozen_bn(engine, frames: Sequence[dict]) -> int:
    """Set every frozen-BN running statistic of the backbone and shared head
    from ``frames``: frame dicts as the runner takes them (``img`` a
    (1, H, W, 3) canvas, normalised float32 or raw uint8, and
    ``img_shape``).  Returns the number of BNs written."""
    model = engine.model
    bns = [m for part in (model.backbone, model.shared_head)
           if part is not None
           for m in part.modules() if isinstance(m, FrozenBN)]
    sums = {bn: [0.0, 0.0] for bn in bns}

    def observe(bn, inputs):
        x = inputs[0].float()
        mu = x.mean(dim=(0, 2, 3))
        m2 = (x * x).mean(dim=(0, 2, 3))
        sums[bn][0] = sums[bn][0] + mu
        sums[bn][1] = sums[bn][1] + m2
        bn.running_mean.copy_(mu)
        bn.running_var.copy_((m2 - mu * mu).clamp_min(_VAR_FLOOR))

    hooks = [bn.register_forward_pre_hook(observe) for bn in bns]
    try:
        with f32_precision():
            for frame in frames:
                x = engine._to_input(frame["img"], frame["img_shape"])
                model.shared(model.extract_feat(x))
    finally:
        for h in hooks:
            h.remove()
    n = float(len(frames))
    for bn, (mu, m2) in sums.items():
        mu, m2 = mu / n, m2 / n
        bn.running_mean.copy_(mu)
        bn.running_var.copy_((m2 - mu * mu).clamp_min(_VAR_FLOOR))
    return len(bns)
