"""Shared head: dilated ResNet stage 4 + the external 1×1→256 conv
(counterpart of ``hvrnet_tpu/models/shared_heads/res_layer.py``).

With ``feat_from_shared_head=True`` it runs on the whole C4 map before
RoIAlign, so it is a map-level module: C4 → C5.
"""
from __future__ import annotations

import torch
from torch import nn

from ..backbones.resnet import ARCH_SETTINGS, Bottleneck, make_res_layer
from ..layers import ConvModule
from ..registry import SHARED_HEADS


@SHARED_HEADS.register_module
class ResLayer(nn.Module):

    def __init__(self, depth: int = 101, stage: int = 3, stride: int = 1,
                 dilation: int = 2, style: str = "caffe",
                 external_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        planes = 64 * 2 ** stage
        inplanes = planes * Bottleneck.expansion // 2
        self.stage = stage
        self.add_module(f"layer{stage + 1}", make_res_layer(
            inplanes, planes, ARCH_SETTINGS[depth][1][stage], stride, dilation,
            style, dtype))
        self.new_layer_1 = (ConvModule(planes * Bottleneck.expansion, 256, 1,
                                       dtype) if external_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"layer{self.stage + 1}")(x)
        if self.new_layer_1 is not None:
            x = self.new_layer_1(x)
        return x
