"""ResNeXt and SSD's VGG16 backbones (NCHW), counterparts of
``hvrnet_tpu/models/backbones/resnext.py``: ``GroupedBottleneck`` and
``ResNeXt`` (``:16-95``), ``SSDVGG`` (``:98``).

``GroupedBottleneck`` is the ResNet bottleneck with a grouped 3×3 of width
``int(planes · base_width / 64) · groups``; ``style`` puts the stride on
the first 1×1 (caffe) or on the 3×3 (pytorch).  ``ResNeXt`` is the 7×7
stem, the 3×3/2 max pool and ``num_stages`` stages of grouped bottlenecks
at their strides and dilations, returning the maps of ``out_indices``;
``frozen_stages`` is the trainer's business, as for ``ResNet``
(``engine/optim.py:default_trainable_mask``).  Its names are mmdet's: the
stem ``conv1`` / ``bn1``, ``layer{i}.{j}.conv{k}`` / ``bn{k}`` and
``downsample.0`` / ``.1`` (the JAX module's ``stem_conv`` / ``stem_bn``,
``layer{i}_block{j}`` and ``ds_conv`` / ``ds_bn``).  The grouped 3×3 is
``F.conv2d(groups=...)``: the JAX module's is a plain XLA convolution,
not a Pallas kernel.

``SSDVGG`` follows the JAX module, not mmdet's ``ssd_vgg.py``, where they
part:

* the first output is conv4_1's (the first 512-wide conv of the fourth
  block), L2-normalised over the channels with 1e-10 under the square root
  and scaled by ``l2_norm.weight``; mmdet's ``out_feature_indices`` (22,
  34) takes conv4_3.  It is an output only when 3 is in ``out_indices``;
* every 2×2 max pool floors (no ``ceil_mode``): at 300×300 the six maps
  are 37², 18², 9², 5², 3² and 1² (mmdet: 38², 19², 10², 5², 3², 1²).
  mmdet's ``input_size``, ``ceil_mode``, ``with_last_pool`` and
  ``out_feature_indices`` are config keys ``build_submodule`` drops, as
  the JAX package's ``build_submodule`` does.

The parameters keep mmdet's names: the VGG convs ``features.{k}`` at
mmdet's layer indices (conv1_1 ``features.0`` … conv5_3 ``features.28``),
fc6 ``features.31`` and fc7 ``features.33`` (the 3×3 / 1 pool before them
is index 30), the extra layers ``extra.{i}`` and the L2 norm's scale
``l2_norm.weight``.  ``port_name`` maps the JAX module's names
(``conv{i}`` over its layer list, ``fc6``, ``fc7``, ``extra{i}``,
``l2_norm_scale``) onto them.  Every conv computes in ``dtype`` (float32
parameters); the L2 norm in float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.precision import widen
from ..layers import Conv2d, FrozenBN, max_pool_3x3_s2_p1
from ..registry import BACKBONES
from .resnet import ARCH_SETTINGS, ResLayer

# VGG16's layers as the JAX module lists them: widths and "M" (a 2×2 pool)
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512)
# (out channels, kernel, stride, padding) of SSD300's extra layers
EXTRA = ((256, 1, 1, 0), (512, 3, 2, 1), (128, 1, 1, 0), (256, 3, 2, 1),
         (128, 1, 1, 0), (256, 3, 1, 0), (128, 1, 1, 0), (256, 3, 1, 0))
FC6, FC7 = 31, 33


def _vgg_indices():
    """Each VGG16 conv's place in the JAX list → its mmdet layer index (a
    conv and its ReLU take two indices, a pool one)."""
    out, k = {}, 0
    for i, v in enumerate(VGG16):
        if v == "M":
            k += 1
        else:
            out[i] = k
            k += 2
    return out


def port_name(jax_name: str) -> str:
    """The port (mmdet) name of a JAX ``SSDVGG`` parameter subtree."""
    if jax_name == "l2_norm_scale":
        return "l2_norm.weight"
    if jax_name in ("fc6", "fc7"):
        return f"features.{FC6 if jax_name == 'fc6' else FC7}"
    if jax_name.startswith("extra"):
        return f"extra.{int(jax_name[len('extra'):])}"
    return f"features.{_vgg_indices()[int(jax_name[len('conv'):])]}"


class L2Norm(nn.Module):
    """x / sqrt(Σ_c x² + 1e-10) · weight, per position, in float32."""

    def __init__(self, channels: int, scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = widen(x)
        norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True) + 1e-10)
        return xf / norm * self.weight[None, :, None, None]


@BACKBONES.register_module
class SSDVGG(nn.Module):
    """VGG16 with SSD's extra layers: conv4_1 L2-normalised (with 3 in
    ``out_indices``), fc7 and four extra maps."""

    def __init__(self, depth: int = 16, out_indices: Sequence[int] = (3, 4),
                 l2_norm_scale: float = 20.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth != 16:
            raise ValueError(f"SSDVGG is VGG16 (depth 16), not depth {depth}")
        self.with_l2 = 3 in out_indices
        convs, c = {}, 3
        for i, v in enumerate(VGG16):
            if v != "M":
                convs[str(_vgg_indices()[i])] = Conv2d(
                    c, v, 3, padding=1, compute_dtype=dtype)
                c = v
        convs[str(FC6)] = Conv2d(c, 1024, 3, padding=6, dilation=6,
                                 compute_dtype=dtype)
        convs[str(FC7)] = Conv2d(1024, 1024, 1, compute_dtype=dtype)
        self.features = nn.ModuleDict(convs)
        extra, c = [], 1024
        for out, k, s, p in EXTRA:
            extra.append(Conv2d(c, out, k, stride=s, padding=p,
                                compute_dtype=dtype))
            c = out
        self.extra = nn.ModuleList(extra)
        self.l2_norm = L2Norm(512, l2_norm_scale) if self.with_l2 else None

    def forward(self, x: torch.Tensor):
        outs = []
        block = 0
        index = _vgg_indices()
        for i, v in enumerate(VGG16):
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                block += 1
            else:
                x = F.relu(self.features[str(index[i])](x))
            if block == 3 and v == 512 and self.with_l2 and not outs:
                outs.append(self.l2_norm(x))
        x = F.max_pool2d(x, 3, 1, 1)
        x = F.relu(self.features[str(FC6)](x))
        x = F.relu(self.features[str(FC7)](x))
        outs.append(x)
        for i, conv in enumerate(self.extra):
            x = F.relu(conv(x))
            if i % 2 == 1:
                outs.append(x)
        return tuple(outs)


class GroupedBottleneck(nn.Module):
    """1×1 → grouped 3×3 → 1×1 (×4) with frozen BNs (the JAX
    ``GroupedBottleneck``): the stride on conv1 (caffe) or conv2
    (pytorch), the 3×3 padded and dilated by ``dilation``."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 style: str = "pytorch", dtype: torch.dtype = torch.float32,
                 groups: int = 32, base_width: int = 4):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, width, 1, stride=s1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBN(width, dtype=dtype)
        self.conv2 = Conv2d(width, width, 3, stride=s2, padding=dilation,
                            dilation=dilation, groups=groups, bias=False,
                            compute_dtype=dtype)
        self.bn2 = FrozenBN(width, dtype=dtype)
        self.conv3 = Conv2d(width, out, 1, bias=False, compute_dtype=dtype)
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


def grouped_layer(inplanes: int, planes: int, num_blocks: int, stride: int,
                  dilation: int, style: str, groups: int, base_width: int,
                  dtype: torch.dtype = torch.float32) -> ResLayer:
    """One stage of grouped bottlenecks, the first downsampling where its
    stride or width asks (mmdet's ``make_res_layer``)."""
    return ResLayer(GroupedBottleneck, inplanes, planes, num_blocks, stride,
                    dilation, style, dtype=dtype, groups=groups,
                    base_width=base_width)


@BACKBONES.register_module
class ResNeXt(nn.Module):
    """ResNeXt (depth 50, 101 or 152) with partial stages; returns the
    maps of ``out_indices``."""

    def __init__(self, depth: int = 101, groups: int = 32,
                 base_width: int = 4, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 style: str = "pytorch", dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth not in (50, 101, 152):
            raise KeyError(f"invalid depth {depth} for resnext")
        stage_blocks = ARCH_SETTINGS[depth][1]
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBN(64, dtype=dtype)
        inplanes = 64
        for i in range(num_stages):
            planes = 64 * 2 ** i
            self.add_module(f"layer{i + 1}", grouped_layer(
                inplanes, planes, stage_blocks[i], strides[i], dilations[i],
                style, groups, base_width, dtype))
            inplanes = planes * GroupedBottleneck.expansion

    def forward(self, x: torch.Tensor):
        x = max_pool_3x3_s2_p1(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
