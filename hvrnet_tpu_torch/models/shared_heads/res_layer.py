"""Shared head: dilated ResNet stage 4 + the external 1×1→256 conv
(counterpart of ``hvrnet_tpu/models/shared_heads/res_layer.py``).

With ``feat_from_shared_head=True`` it runs on the whole C4 map before
RoIAlign, so it is a map-level module: C4 → C5.  ``C5Head`` is the form
the ResNet, ResNeXt and Res2Net heads share (``backbones/res2net.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..backbones.resnet import ARCH_SETTINGS, Bottleneck, make_res_layer
from ..layers import ConvModule
from ..registry import SHARED_HEADS


class C5Head(nn.Module):
    """Stage ``stage`` (``layer``) under ``layer{stage + 1}``, then the
    optional external 1×1 → 256 + ReLU (``new_layer_1``)."""

    def __init__(self, layer: nn.Module, stage: int, out_channels: int,
                 external_conv: bool, dtype: torch.dtype):
        super().__init__()
        self.stage = stage
        self.add_module(f"layer{stage + 1}", layer)
        self.new_layer_1 = (ConvModule(out_channels, 256, 1, dtype)
                            if external_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"layer{self.stage + 1}")(x)
        if self.new_layer_1 is not None:
            x = self.new_layer_1(x)
        return x


@SHARED_HEADS.register_module
class ResLayer(C5Head):

    def __init__(self, depth: int = 101, stage: int = 3, stride: int = 1,
                 dilation: int = 2, style: str = "caffe",
                 external_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        planes = 64 * 2 ** stage
        out = planes * Bottleneck.expansion
        super().__init__(make_res_layer(
            out // 2, planes, ARCH_SETTINGS[depth][1][stage], stride,
            dilation, style, dtype), stage, out, external_conv, dtype)
