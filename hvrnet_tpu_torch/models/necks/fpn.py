"""Necks (NCHW), counterparts of ``hvrnet_tpu/models/necks/fpn.py``:
the Feature Pyramid Network (``FPN``, ``:26-70``) and the Balanced
Feature Pyramid (``BFP``, ``:74-101``).  ``HRFPN`` is in ``hrfpn.py``.

``FPN`` keeps mmdet's names: ``lateral_convs.{i}.conv`` and
``fpn_convs.{i}.conv``, the extra stride-2 convs appended to
``fpn_convs`` after the output convs.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import ConvModule, resize_nearest
from ..registry import NECKS


@NECKS.register_module
class FPN(nn.Module):
    """1×1 laterals on the used levels (``start_level`` to ``end_level``),
    the top-down sum with nearest 2× upsampling (each level exactly twice
    the next, as the JAX package's pixel repetition requires), a 3×3 output
    conv per level, then ``num_outs`` − levels extra outputs: stride-2 1×1
    max pools of the last output, or with ``add_extra_convs`` stride-2 3×3
    convs, the first on the last used input (``extra_convs_on_inputs``) or
    the last output, the rest on the previous extra output (through a ReLU
    with ``relu_before_extra_convs``).  Returns the tuple of outputs."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs: bool = False,
                 extra_convs_on_inputs: bool = True,
                 relu_before_extra_convs: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = list(in_channels)
        end = len(self.in_channels) if end_level == -1 else end_level + 1
        self.start_level, self.end = start_level, end
        self.num_outs = num_outs
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        self.extra_convs_on_inputs = extra_convs_on_inputs
        used = self.in_channels[start_level:end]
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, dtype, activation=None)
            for c in used)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, dtype, padding=1,
                       activation=None) for _ in used)
        if add_extra_convs:
            for i in range(num_outs - len(used)):
                src = (used[-1] if i == 0 and extra_convs_on_inputs
                       else out_channels)
                self.fpn_convs.append(ConvModule(
                    src, out_channels, 3, dtype, padding=1, stride=2,
                    activation=None))

    def forward(self, inputs):
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"FPN takes {len(self.in_channels)} maps, got "
                             f"{len(inputs)}")
        used = list(inputs[self.start_level:self.end])
        n = len(used)
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], scale_factor=2, mode="nearest")
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        if self.num_outs > n and not self.add_extra_convs:
            for _ in range(self.num_outs - n):
                outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        elif self.num_outs > n:
            src = used[-1] if self.extra_convs_on_inputs else outs[-1]
            outs.append(self.fpn_convs[n](src))
            for conv in self.fpn_convs[n + 1:]:
                x = outs[-1]
                outs.append(conv(F.relu(x) if self.relu_before_extra_convs
                                 else x))
        return tuple(outs)


@NECKS.register_module
class BFP(nn.Module):
    """Balanced Feature Pyramid as the JAX package has it: every level
    resized to ``refine_level``'s size with half-pixel nearest sampling
    (``jax.image.resize(..., "nearest")``, torch's ``nearest-exact``; mmdet
    gathers by adaptive max pooling), averaged, and the mean resized back
    and added to each level.  No refinement whatever the config's
    ``refine_type`` says (the JAX module omits it); no parameters."""

    def __init__(self, num_levels: int = 5, refine_level: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_levels = num_levels
        self.refine_level = refine_level

    def forward(self, inputs):
        if len(inputs) != self.num_levels:
            raise ValueError(f"BFP takes {self.num_levels} maps, got "
                             f"{len(inputs)}")
        size = inputs[self.refine_level].shape[2:]
        bsf = sum(resize_nearest(x, size) for x in inputs) / len(inputs)
        return tuple(x + resize_nearest(bsf, x.shape[2:]) for x in inputs)

