"""Res2Net-v1b (NCHW) and the two C5 shared heads on grouped and
scale-split bottlenecks, counterparts of
``hvrnet_tpu/models/backbones/res2net.py``: ``Bottle2neck``,
``Res2NetV1b`` and ``Res2Layer`` (``:21-141``), and ``ResXLayer``
(``:143-173``) on ``resnext.GroupedBottleneck``.

``Bottle2neck`` follows the JAX module: a 1×1 to ``width · scales``
channels (``width = int(planes · base_width / 64)``), split into
``scales`` groups; the first ``scales − 1`` go through a 3×3 each, every
one after the first adding the previous 3×3's output to its input (the
running add), except in a stage's first block (``stage_first``), where the
3×3s take the block's stride and no add; the last group passes through,
average-pooled 3×3 with padding 1 (the pad counted, torch's default and
flax's) in a ``stage_first`` block of stride > 1 only; the concatenation
goes through the last 1×1.  The v1b downsample is a ``stride × stride``
average pool over whole windows (floor), then a 1×1: on a map of odd size
at a stride-2 block it is one row or column short of the strided 3×3
(which rounds up), the JAX module fails there, and the port raises
``ValueError`` rather than pad.  HVRNet's 608×1008 canvas (152×252 →
76×126 → 38×63) and 800×1344 never reach it.

``Res2NetV1b`` has the v1b deep stem (three 3×3 conv + BN + ReLU, the
first of stride 2) and the 3×3/2 max pool, then ``num_stages`` stages of
``Bottle2neck`` at their strides and dilations; it returns the maps of
``out_indices`` (``frozen_stages`` is the trainer's business).
``Res2Layer`` and ``ResXLayer`` are the dilated stage 4 of the C5
configuration, each with ``external_conv`` (``new_layer_1``, the 1×1 →
256 + ReLU), in the form ``shared_heads/res_layer.py:C5Head`` gives the
ResNet head.

The names are the reference Res2Net-v1b checkpoint's: the stem
``conv1.0`` / ``conv1.1`` (conv, BN), ``conv1.3`` / ``conv1.4``,
``conv1.6`` and ``bn1`` (the JAX ``stem1`` … ``stem3``); a block's
``conv1`` / ``bn1``, ``convs.{s}`` / ``bns.{s}`` (the JAX ``conv2_{s}``),
``conv3`` / ``bn3`` and ``downsample.1`` / ``.2`` (conv, BN; index 0 is
the parameterless pool); ``layer{i}.{j}``.  ``ResXLayer``'s blocks keep
the ResNeXt names (``resnext.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, FrozenBN, max_pool_3x3_s2_p1
from ..registry import BACKBONES, SHARED_HEADS
from ..shared_heads.res_layer import C5Head
from .resnet import ARCH_SETTINGS
from .resnext import GroupedBottleneck, grouped_layer

RES2NET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Bottle2neck(nn.Module):
    """The scale-split bottleneck (the module docstring)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, scales: int = 4, base_width: int = 26,
                 downsample: bool = False, stage_first: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64.0))
        out = planes * self.expansion
        self.width, self.scales, self.stride = width, scales, stride
        self.stage_first = stage_first
        self.conv1 = Conv2d(inplanes, width * scales, 1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBN(width * scales, dtype=dtype)
        s2 = stride if stage_first else 1
        self.convs = nn.ModuleList(
            Conv2d(width, width, 3, stride=s2, padding=dilation,
                   dilation=dilation, bias=False, compute_dtype=dtype)
            for _ in range(scales - 1))
        self.bns = nn.ModuleList(FrozenBN(width, dtype=dtype)
                                 for _ in range(scales - 1))
        self.conv3 = Conv2d(width * scales, out, 1, bias=False,
                            compute_dtype=dtype)
        self.bn3 = FrozenBN(out, dtype=dtype)
        self.downsample = None
        if downsample:
            pool = (nn.AvgPool2d(stride, stride) if stride > 1
                    else nn.Identity())
            self.downsample = nn.Sequential(
                pool, Conv2d(inplanes, out, 1, bias=False,
                             compute_dtype=dtype),
                FrozenBN(out, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1 and (x.shape[2] % self.stride
                                or x.shape[3] % self.stride):
            raise ValueError(
                f"a stride-{self.stride} Res2Net block takes a map whose "
                f"sides divide by its stride, not {tuple(x.shape[2:])}: its "
                "downsample pools whole windows, its 3×3 rounds up (the JAX "
                "module fails there too)")
        out = F.relu(self.bn1(self.conv1(x)))
        splits = torch.split(out, self.width, dim=1)
        ys, prev = [], None
        for s, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            inp = splits[s]
            if prev is not None and not self.stage_first:
                inp = inp + prev
            prev = F.relu(bn(conv(inp)))
            ys.append(prev)
        last = splits[-1]
        if self.stage_first and self.stride > 1:
            last = F.avg_pool2d(last, 3, self.stride, 1)
        ys.append(last)
        out = self.bn3(self.conv3(torch.cat(ys, dim=1)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def res2_layer(inplanes: int, planes: int, num_blocks: int, stride: int,
               dilation: int, scales: int, base_width: int,
               dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """One Res2Net stage: the first block ``stage_first``, downsampling
    where its stride or width asks."""
    need_ds = stride != 1 or inplanes != planes * Bottle2neck.expansion
    return nn.Sequential(*(
        Bottle2neck(inplanes if j == 0 else planes * Bottle2neck.expansion,
                    planes, stride if j == 0 else 1, dilation, scales,
                    base_width, need_ds and j == 0, stage_first=j == 0,
                    dtype=dtype)
        for j in range(num_blocks)))


@BACKBONES.register_module
class Res2NetV1b(nn.Module):
    """Res2Net-v1b (depth 50 or 101) with partial stages; returns the maps
    of ``out_indices``."""

    def __init__(self, depth: int = 101, scales: int = 4,
                 base_width: int = 26, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth not in RES2NET_BLOCKS:
            raise KeyError(f"invalid depth {depth} for res2net")
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Sequential(
            Conv2d(3, 32, 3, stride=2, padding=1, bias=False,
                   compute_dtype=dtype),
            FrozenBN(32, dtype=dtype), nn.ReLU(),
            Conv2d(32, 32, 3, padding=1, bias=False, compute_dtype=dtype),
            FrozenBN(32, dtype=dtype), nn.ReLU(),
            Conv2d(32, 64, 3, padding=1, bias=False, compute_dtype=dtype))
        self.bn1 = FrozenBN(64, dtype=dtype)
        inplanes = 64
        for i in range(num_stages):
            planes = 64 * 2 ** i
            self.add_module(f"layer{i + 1}", res2_layer(
                inplanes, planes, RES2NET_BLOCKS[depth][i], strides[i],
                dilations[i], scales, base_width, dtype))
            inplanes = planes * Bottle2neck.expansion

    def forward(self, x: torch.Tensor):
        x = max_pool_3x3_s2_p1(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@SHARED_HEADS.register_module
class Res2Layer(C5Head):
    """The Res2Net stage-4 shared head (C4 → C5)."""

    def __init__(self, depth: int = 101, stage: int = 3, stride: int = 1,
                 dilation: int = 2, scales: int = 4, base_width: int = 26,
                 external_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        planes = 64 * 2 ** stage
        out = planes * Bottle2neck.expansion
        super().__init__(res2_layer(
            out // 2, planes, RES2NET_BLOCKS[depth][stage], stride, dilation,
            scales, base_width, dtype), stage, out, external_conv, dtype)


@SHARED_HEADS.register_module
class ResXLayer(C5Head):
    """The ResNeXt stage-4 shared head (C4 → C5): pytorch-style grouped
    bottlenecks."""

    def __init__(self, depth: int = 101, stage: int = 3, stride: int = 1,
                 dilation: int = 2, groups: int = 32, base_width: int = 4,
                 external_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        planes = 64 * 2 ** stage
        out = planes * GroupedBottleneck.expansion
        super().__init__(grouped_layer(
            out // 2, planes, ARCH_SETTINGS[depth][1][stage], stride,
            dilation, "pytorch", groups, base_width, dtype), stage, out,
            external_conv, dtype)
