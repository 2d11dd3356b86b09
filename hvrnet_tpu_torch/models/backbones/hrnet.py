"""HRNet (NCHW), counterpart of ``hvrnet_tpu/models/backbones/hrnet.py``:
``HRModule`` and ``HRNet`` (``:20-129``).

The stem is two stride-2 3×3 conv + BN + ReLU, stage 1 a layer of
pytorch-style bottlenecks, and each later stage a transition (a 3×3 conv +
BN + ReLU on a branch whose width changes, a stride-2 one from the last
branch for each new branch) followed by ``num_modules`` ``HRModule``s.  A
module runs each branch's blocks, then fuses: output branch i is the ReLU
of its own map plus, for each other branch j in ascending order, branch j
brought to i's resolution — from a lower resolution a 1×1 conv + BN and a
nearest resize to i's size, from a higher one a chain of stride-2 3×3
conv + BN (ReLU between them, none after the last).  The nearest resize
is the JAX module's ``jax.image.resize(..., "nearest")``, which samples
half-pixel centres: torch's ``nearest-exact`` (``nearest`` differs at a
non-integer ratio, as 19×32 → 38×63 on HVRNet's canvas).  Every branch is
an output; ``extra`` is mmdet's stage dict (the JAX module's default,
HRNetV2p-W32's, when None).

The names are mmdet's: ``conv1`` / ``bn1``, ``conv2`` / ``bn2``,
``layer1.{i}``, ``transition{s}.{b}.0`` / ``.1`` (an adapted branch) or
``transition{s}.{b}.0.0`` / ``.0.1`` (a new one),
``stage{s}.{m}.branches.{b}.{i}`` and ``stage{s}.{m}.fuse_layers.{i}.{j}``
with ``.0`` / ``.1`` (upsampling) or ``.{k}.0`` / ``.{k}.1``
(downsampling).  The JAX module's names: ``stem1``, ``stem2``,
``layer1_block{i}``, ``trans{s + 1}_{b}``, ``stage{s}_module{m}`` with
``branch{b}_block{i}``, ``fuse_{j}_to_{i}`` and ``fuse_{j}_to_{i}_{k}``.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, FrozenBN, resize_nearest
from ..registry import BACKBONES
from .resnet import BasicBlock, Bottleneck

# HRNetV2p-W32, the JAX module's default
DEFAULT_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(4, 4), num_channels=(32, 64)),
    stage3=dict(num_modules=4, num_branches=3, block="BASIC",
                num_blocks=(4, 4, 4), num_channels=(32, 64, 128)),
    stage4=dict(num_modules=3, num_branches=4, block="BASIC",
                num_blocks=(4, 4, 4, 4), num_channels=(32, 64, 128, 256)))
BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def conv_bn(cin: int, cout: int, k: int, stride: int, relu: bool,
            dtype: torch.dtype) -> nn.Sequential:
    """conv (no bias) + frozen BN [+ ReLU] as mmdet's ``nn.Sequential``."""
    layers = [Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False, compute_dtype=dtype),
              FrozenBN(cout, dtype=dtype)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class HRModule(nn.Module):
    """One stage module: per-branch blocks, then the full fusion."""

    def __init__(self, in_channels: Sequence[int], num_blocks: Sequence[int],
                 num_channels: Sequence[int], block,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = len(num_channels)
        width = [c * block.expansion for c in num_channels]
        branches = []
        for b in range(n):
            blocks, cin = [], in_channels[b]
            for i in range(num_blocks[b]):
                blocks.append(block(cin, num_channels[b], 1, 1,
                                    i == 0 and cin != width[b], "pytorch",
                                    dtype))
                cin = width[b]
            branches.append(nn.Sequential(*blocks))
        self.branches = nn.ModuleList(branches)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(conv_bn(width[j], width[i], 1, 1, False,
                                       dtype))
                else:
                    row.append(nn.Sequential(*(
                        conv_bn(width[j], width[i] if k == i - j - 1
                                else width[j], 3, 2, k != i - j - 1, dtype)
                        for k in range(i - j))))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = outs[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                y = layer(outs[j])
                if j > i:
                    y = resize_nearest(y, outs[i].shape[2:])
                acc = acc + y
            fused.append(F.relu(acc))
        return fused


@BACKBONES.register_module
class HRNet(nn.Module):
    """HRNet with every branch an output (the module docstring)."""

    def __init__(self, extra: Dict[str, Any] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        extra = extra or DEFAULT_EXTRA
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBN(64, dtype=dtype)
        self.conv2 = Conv2d(64, 64, 3, stride=2, padding=1, bias=False,
                            compute_dtype=dtype)
        self.bn2 = FrozenBN(64, dtype=dtype)
        # stage 1 is bottlenecks whatever its "block" says, the first
        # downsampling, as in the JAX module
        s1 = extra["stage1"]
        planes = s1["num_channels"][0]
        cin = planes * Bottleneck.expansion
        self.layer1 = nn.Sequential(*(
            Bottleneck(64 if i == 0 else cin, planes, 1, 1, i == 0,
                       "pytorch", dtype)
            for i in range(s1["num_blocks"][0])))
        prev = [cin]
        for s in (2, 3, 4):
            cfg = extra[f"stage{s}"]
            block = BLOCKS[cfg["block"]]
            want = [c * block.expansion for c in cfg["num_channels"]]
            trans = []
            for b in range(cfg["num_branches"]):
                if b < len(prev):
                    trans.append(None if prev[b] == want[b] else conv_bn(
                        prev[b], want[b], 3, 1, True, dtype))
                else:
                    trans.append(nn.Sequential(conv_bn(
                        prev[-1], want[b], 3, 2, True, dtype)))
            self.add_module(f"transition{s - 1}", nn.ModuleList(trans))
            self.add_module(f"stage{s}", nn.Sequential(*(
                HRModule(want, cfg["num_blocks"], cfg["num_channels"],
                         block, dtype) for _ in range(cfg["num_modules"]))))
            prev = want

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        branches = [self.layer1(x)]
        for s in (2, 3, 4):
            trans = getattr(self, f"transition{s - 1}")
            branches = [
                (branches[b] if t is None else t(branches[b]))
                if b < len(branches) else t(branches[-1])
                for b, t in enumerate(trans)]
            for module in getattr(self, f"stage{s}"):
                branches = module(branches)
        return tuple(branches)
