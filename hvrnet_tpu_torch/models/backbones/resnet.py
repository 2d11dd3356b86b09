"""Caffe-style ResNet backbone (NCHW), counterpart of
``hvrnet_tpu/models/backbones/resnet.py``.

The configuration both shipped configs use: bottleneck blocks, caffe style
(the stride sits on the first 1×1 of each bottleneck), partial stages with
per-stage strides and dilations, every BN frozen.  Module names follow mmdet
(``conv1``/``bn1``/``layerN.M.convK``/``downsample.{0,1}``) so a reference
checkpoint loads by name.

The stem is the plain 7×7/2 conv + BN + ReLU + 3×3/2 maxpool.  The JAX
package lowers the same stored (7, 7, 3, 64) kernel as a space-to-depth
pipeline for the TPU (``StemBlock``); that is a layout rewrite with the same
result, so it has no counterpart here.  Every convolution and frozen BN
computes in ``dtype`` (``core/precision.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, FrozenBN, max_pool_3x3_s2_p1
from ..registry import BACKBONES

ARCH_SETTINGS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 style: str = "caffe", dtype: torch.dtype = torch.float32):
        super().__init__()
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, stride=s1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBN(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride=s2, padding=dilation,
                            dilation=dilation, bias=False,
                            compute_dtype=dtype)
        self.bn2 = FrozenBN(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, out, 1, bias=False, compute_dtype=dtype)
        self.bn3 = FrozenBN(out, dtype=dtype)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out, 1, stride=stride, bias=False,
                       compute_dtype=dtype),
                FrozenBN(out, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def make_res_layer(inplanes: int, planes: int, num_blocks: int,
                   stride: int = 1, dilation: int = 1,
                   style: str = "caffe",
                   dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """One ResNet stage (mmdet ``make_res_layer``)."""
    need_ds = stride != 1 or inplanes != planes * Bottleneck.expansion
    blocks = [Bottleneck(inplanes, planes, stride, dilation, need_ds, style,
                         dtype)]
    for _ in range(1, num_blocks):
        blocks.append(Bottleneck(planes * Bottleneck.expansion, planes, 1,
                                 dilation, False, style, dtype))
    return nn.Sequential(*blocks)


@BACKBONES.register_module
class ResNet(nn.Module):
    """ResNet with partial stages; returns the maps of ``out_indices``."""

    def __init__(self, depth: int = 101, num_stages: int = 3,
                 strides: Sequence[int] = (1, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1),
                 out_indices: Sequence[int] = (2,), style: str = "caffe",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        stage_blocks = ARCH_SETTINGS[depth]
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBN(64, dtype=dtype)
        inplanes = 64
        for i in range(num_stages):
            planes = 64 * 2 ** i
            self.add_module(f"layer{i + 1}", make_res_layer(
                inplanes, planes, stage_blocks[i], strides[i], dilations[i],
                style, dtype))
            inplanes = planes * Bottleneck.expansion

    def forward(self, x: torch.Tensor):
        x = max_pool_3x3_s2_p1(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
