"""ResNet backbone (NCHW), counterpart of
``hvrnet_tpu/models/backbones/resnet.py:24-227``.

Depths 18 and 34 (``BasicBlock``) and 50, 101 and 152 (``Bottleneck``);
caffe style (the stride sits on the first 1×1 of each bottleneck, as both
shipped configs have it) or pytorch style (on the 3×3, as the FPN zoo has
it); partial stages (the C4 trunk's 3) or all 4 with ``out_indices`` over
them; per-stage strides and dilations; every BN frozen.  Module names
follow mmdet (``conv1``/``bn1``/``layerN.M.convK``/``downsample.{0,1}``)
so a reference checkpoint loads by name.

The stem is the plain 7×7/2 conv + BN + ReLU + 3×3/2 maxpool.  The JAX
package lowers the same stored (7, 7, 3, 64) kernel as a space-to-depth
pipeline for the TPU (``StemBlock``); that is a layout rewrite with the same
result, so it has no counterpart here.  Every convolution and frozen BN
computes in ``dtype`` (``core/precision.py``).

``with_cp`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, the JAX package's ``nn.remat``).
``frozen_stages`` is not the module's business: the trainer leaves the
stem and stages ≤ ``frozen_stages`` out of its parameters
(``engine/optim.py:default_trainable_mask``), which is the JAX package's
``stop_gradient`` for every parameter.

The ``dcn`` plugin (``resnet.py:85-112`` of the JAX package) turns a
bottleneck's 3×3 into a deformable convolution (``ops/deform.py``):
``conv2_offset``, a regular 3×3 at the block's stride and dilation with a
bias, zero-initialised, gives 18 offset channels (27 when ``modulated``:
the first 18 the offsets, the sigmoid of the last 9 the mask), then
``conv2`` (``DeformConv2d``, no bias) and ``bn2``, mmdet's names.
``fallback_on_stride`` keeps the plain 3×3 on a strided block;
``deformable_groups`` must be 1, as in the JAX package.  The other plugins
(``gcb``, ``gen_attention``) are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.deform import DeformConv2d
from ..layers import Conv2d, FrozenBN, max_pool_3x3_s2_p1
from ..registry import BACKBONES


class BasicBlock(nn.Module):
    """Two 3×3 conv + frozen BN, the stride on the first (``BasicBlock``,
    ``resnet.py:34``); ``style`` is accepted and changes nothing."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 style: str = "pytorch", dtype: torch.dtype = torch.float32,
                 dcn=None):
        super().__init__()
        if dcn is not None:
            raise ValueError("the ResNet plugins need bottleneck blocks "
                             "(as in the JAX package)")
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBN(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False,
                            compute_dtype=dtype)
        self.bn2 = FrozenBN(planes, dtype=dtype)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride=stride, bias=False,
                       compute_dtype=dtype),
                FrozenBN(planes, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 (×4) with frozen BNs (``Bottleneck``,
    ``resnet.py:56``): caffe style strides the first 1×1, pytorch style
    the 3×3; with ``dcn`` the 3×3 is deformable (the module docstring)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 style: str = "caffe", dtype: torch.dtype = torch.float32,
                 dcn=None):
        super().__init__()
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, stride=s1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBN(planes, dtype=dtype)
        self.with_dcn = dcn is not None and not (
            dcn.get("fallback_on_stride", False) and s2 > 1)
        if self.with_dcn:
            if int(dcn.get("deformable_groups", 1)) != 1:
                raise ValueError("the ResNet dcn plugin takes "
                                 "deformable_groups=1 (as the JAX package)")
            self.modulated = bool(dcn.get("modulated", False))
            self.conv2_offset = Conv2d(
                planes, 27 if self.modulated else 18, 3, stride=s2,
                padding=dilation, dilation=dilation, compute_dtype=dtype)
            self.conv2_offset.init_std = 0.0
            self.conv2 = DeformConv2d(planes, planes, 3, stride=s2,
                                      padding=dilation, dilation=dilation,
                                      compute_dtype=dtype)
        else:
            self.conv2 = Conv2d(planes, planes, 3, stride=s2,
                                padding=dilation, dilation=dilation,
                                bias=False, compute_dtype=dtype)
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
        if self.with_dcn:
            off = self.conv2_offset(out)
            mask = None
            if self.modulated:
                off, mask = off[:, :18], torch.sigmoid(off[:, 18:])
            out = self.conv2(out, off, mask)
        else:
            out = self.conv2(out)
        out = F.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class ResLayer(nn.Sequential):
    """One ResNet stage (mmdet ``make_res_layer``, ``ResLayerBlock`` in
    the JAX package): its blocks under ``{i}``, each recomputed in the
    backward pass with ``with_cp`` when its input needs a gradient."""

    def __init__(self, block, inplanes: int, planes: int, num_blocks: int,
                 stride: int = 1, dilation: int = 1, style: str = "caffe",
                 with_cp: bool = False, dtype: torch.dtype = torch.float32,
                 dcn=None):
        need_ds = stride != 1 or inplanes != planes * block.expansion
        blocks = [block(inplanes, planes, stride, dilation, need_ds, style,
                        dtype, dcn)]
        for _ in range(1, num_blocks):
            blocks.append(block(planes * block.expansion, planes, 1,
                                dilation, False, style, dtype, dcn))
        super().__init__(*blocks)
        self.with_cp = with_cp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self:
            x = (checkpoint(blk, x, use_reentrant=False)
                 if self.with_cp and x.requires_grad else blk(x))
        return x


def make_res_layer(inplanes: int, planes: int, num_blocks: int,
                   stride: int = 1, dilation: int = 1,
                   style: str = "caffe",
                   dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """One bottleneck stage (mmdet ``make_res_layer``), the shared head's."""
    return ResLayer(Bottleneck, inplanes, planes, num_blocks, stride,
                    dilation, style, dtype=dtype)


@BACKBONES.register_module
class ResNet(nn.Module):
    """ResNet with partial stages; returns the maps of ``out_indices``."""

    def __init__(self, depth: int = 101, num_stages: int = 3,
                 strides: Sequence[int] = (1, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1),
                 out_indices: Sequence[int] = (2,), style: str = "caffe",
                 with_cp: bool = False, dcn=None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4, gcb=None,
                 stage_with_gcb: Sequence[bool] = (False,) * 4,
                 gen_attention=None,
                 stage_with_gen_attention: Sequence = ((),) * 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for name, plugin, stages in (
                ("gcb", gcb, stage_with_gcb),
                ("gen_attention", gen_attention, stage_with_gen_attention)):
            if plugin is not None and any(stages[:num_stages]):
                raise NotImplementedError(
                    f"the ResNet plugin {name} is not ported yet (it waits "
                    "for the plugins slice)")
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"invalid depth {depth} for resnet")
        block, stage_blocks = ARCH_SETTINGS[depth]
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBN(64, dtype=dtype)
        inplanes = 64
        for i in range(num_stages):
            planes = 64 * 2 ** i
            self.add_module(f"layer{i + 1}", ResLayer(
                block, inplanes, planes, stage_blocks[i], strides[i],
                dilations[i], style, with_cp, dtype,
                dcn if stage_with_dcn[i] else None))
            inplanes = planes * block.expansion

    def forward(self, x: torch.Tensor):
        x = max_pool_3x3_s2_p1(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
