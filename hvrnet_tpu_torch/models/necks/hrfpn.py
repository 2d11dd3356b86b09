"""The HRNet neck (NCHW), counterpart of
``hvrnet_tpu/models/necks/hrfpn.py:16-44``: every branch resized to the
first's size (``jax.image.resize(..., "bilinear")``, which samples
half-pixel centres: ``F.interpolate(bilinear, align_corners=False)``; it
upsamples, so no antialiasing applies) and concatenated, a 1×1
``reduction_conv``, then ``num_outs`` levels, level i a VALID 2^i × 2^i
average (or, with ``pooling_type`` 'MAX', max) pool of the reduced map,
each through its 3×3 ``fpn_convs.{i}``.  mmdet's names
(``reduction_conv.conv``, ``fpn_convs.{i}.conv``); the JAX module's
``reduction_conv`` and ``fpn_conv{i}``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import ConvModule
from ..registry import NECKS


@NECKS.register_module
class HRFPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 256, num_outs: int = 5,
                 pooling_type: str = "AVG",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pooling_type not in ("AVG", "MAX"):
            raise ValueError(f"pooling_type {pooling_type!r}: 'AVG' or 'MAX'")
        self.in_channels = list(in_channels)
        self.num_outs, self.pooling_type = num_outs, pooling_type
        self.reduction_conv = ConvModule(sum(self.in_channels), out_channels,
                                         1, dtype, activation=None)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, dtype, padding=1,
                       activation=None) for _ in range(num_outs))

    def forward(self, inputs):
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"HRFPN takes {len(self.in_channels)} maps, got "
                             f"{len(inputs)}")
        size = tuple(inputs[0].shape[2:])
        ups = [inputs[0]] + [
            F.interpolate(x, size=size, mode="bilinear", align_corners=False)
            for x in inputs[1:]]
        feat = self.reduction_conv(torch.cat(ups, dim=1))
        pool = F.avg_pool2d if self.pooling_type == "AVG" else F.max_pool2d
        outs = [feat] + [pool(feat, 2 ** i, 2 ** i)
                         for i in range(1, self.num_outs)]
        return tuple(conv(o) for conv, o in zip(self.fpn_convs, outs))
