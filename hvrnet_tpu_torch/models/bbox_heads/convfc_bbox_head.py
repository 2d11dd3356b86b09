"""Conv + FC bbox heads (counterparts of
``hvrnet_tpu/models/bbox_heads/convfc_bbox_head.py:19-120``): the
multi-stage zoo's per-stage heads.

``ConvFCBBoxHead`` keeps mmdet's names (``shared_convs.i``,
``shared_fcs.i``, ``cls_convs.i``, ``cls_fcs.i``, ``reg_convs.i``,
``reg_fcs.i``, ``fc_cls``, ``fc_reg``), so a reference checkpoint's head
loads by name; its convs are conv → frozen BN → ReLU (``layers.ConvBN``),
as in the JAX module.  ``DoubleConvFCBBoxHead`` mirrors the JAX module's
own structure and names (``conv{i}``, ``fc{i}``), which are not mmdet's.

Each head lists in ``flat_map_fcs`` the dense layers whose input is the
flattened (C, 7, 7) RoI map: the first dense layer of a branch that still
holds a 4-D map (none after ``with_avg_pool``), the layers whose input axis
``utils/weights.py`` permutes from the JAX package's HWC flattening.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import ConvBN, Linear
from ..registry import HEADS
from .bbox_head import flatten_roi_feats


def _fcs(in_dim: int, width: int, n: int, dtype) -> nn.ModuleList:
    return nn.ModuleList(Linear(in_dim if i == 0 else width, width,
                                compute_dtype=dtype) for i in range(n))


@HEADS.register_module
class ConvFCBBoxHead(nn.Module):
    """Shared convs and fcs, then a cls branch and a reg branch of their own
    convs and fcs, then ``fc_cls`` and ``fc_reg`` (4 deltas, or 4 per class
    unless ``reg_class_agnostic``).  With ``with_avg_pool`` the shared part
    averages the map before its fcs.  Dense layers draw normal(0, 0.01)
    weights, ``fc_reg`` normal(0, 0.001) (``init_std``)."""

    def __init__(self, num_shared_convs: int = 0, num_shared_fcs: int = 0,
                 num_cls_convs: int = 0, num_cls_fcs: int = 0,
                 num_reg_convs: int = 0, num_reg_fcs: int = 0,
                 conv_out_channels: int = 256, fc_out_channels: int = 1024,
                 with_avg_pool: bool = False, with_cls: bool = True,
                 with_reg: bool = True, roi_feat_size: int = 7,
                 in_channels: int = 256, num_classes: int = 81,
                 target_means: Sequence[float] = (0., 0., 0., 0.),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 reg_class_agnostic: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.with_avg_pool = with_avg_pool
        self.reg_class_agnostic = reg_class_agnostic
        area = roi_feat_size ** 2
        ch = in_channels

        def convs(n, c):
            return nn.ModuleList(ConvBN(c if i == 0 else conv_out_channels,
                                        conv_out_channels, dtype=dtype)
                                 for i in range(n))

        self.shared_convs = convs(num_shared_convs, ch)
        ch = conv_out_channels if num_shared_convs else ch
        flat = set()
        if num_shared_fcs:
            self.shared_fcs = _fcs(ch * (1 if with_avg_pool else area),
                                   fc_out_channels, num_shared_fcs, dtype)
            if not with_avg_pool:
                flat.add("shared_fcs.0")
            branch_in, branch_map = fc_out_channels, False
        else:
            self.shared_fcs = nn.ModuleList()
            branch_in, branch_map = ch, True

        def branch(n_convs, n_fcs, with_out, name):
            """(convs, fcs, output width); the first dense layer of a branch
            that holds the map reads it flattened."""
            if n_convs and not branch_map:
                raise ValueError(f"{name} convs need a map: the shared fcs "
                                 "flatten it")
            width = conv_out_channels if n_convs else branch_in
            in_dim = width * area if branch_map else width
            if branch_map and (n_fcs or with_out):
                flat.add(f"{name}_fcs.0" if n_fcs else f"fc_{name}")
            return (convs(n_convs, branch_in),
                    _fcs(in_dim, fc_out_channels, n_fcs, dtype),
                    fc_out_channels if n_fcs else in_dim)

        self.cls_convs, self.cls_fcs, cls_dim = branch(
            num_cls_convs, num_cls_fcs, with_cls, "cls")
        self.reg_convs, self.reg_fcs, reg_dim = branch(
            num_reg_convs, num_reg_fcs, with_reg, "reg")
        out_reg = 4 if reg_class_agnostic else 4 * num_classes
        self.fc_cls = (Linear(cls_dim, num_classes, compute_dtype=dtype)
                       if with_cls else None)
        self.fc_reg = (Linear(reg_dim, out_reg, compute_dtype=dtype)
                       if with_reg else None)
        if self.fc_reg is not None:
            self.fc_reg.init_std = 0.001
        self.flat_map_fcs = frozenset(flat)

    @staticmethod
    def _branch(x, convs, fcs):
        for conv in convs:
            x = conv(x)
        if x.ndim > 2:
            x = flatten_roi_feats(x)
        for fc in fcs:
            x = F.relu(fc(x))
        return x

    def forward(self, x: torch.Tensor, *unused):
        """(N, C, 7, 7) → (cls (N, num_classes) or None, reg (N, 4·k) or
        None).  Further arguments are ignored."""
        for conv in self.shared_convs:
            x = conv(x)
        if len(self.shared_fcs):
            if self.with_avg_pool and x.ndim == 4:
                x = x.mean(dim=(2, 3))
            x = self._branch(x, (), self.shared_fcs)
        x_cls = self._branch(x, self.cls_convs, self.cls_fcs)
        x_reg = self._branch(x, self.reg_convs, self.reg_fcs)
        return (None if self.fc_cls is None else self.fc_cls(x_cls),
                None if self.fc_reg is None else self.fc_reg(x_reg))


@HEADS.register_module
class SharedFCBBoxHead(ConvFCBBoxHead):
    """Two shared fcs, then ``fc_cls`` and ``fc_reg`` (mmdet's
    ``SharedFCBBoxHead``; the multi-stage zoo's stage head): the
    ``ConvFCBBoxHead`` constructor with ``num_shared_fcs`` 2 by default, as
    the JAX module overrides only that field."""

    __init__ = functools.partialmethod(ConvFCBBoxHead.__init__,
                                       num_shared_fcs=2)


@HEADS.register_module
class DoubleConvFCBBoxHead(nn.Module):
    """Double-Head R-CNN's head, as the JAX module builds it: a conv branch
    (``conv{i}``, conv → frozen BN → ReLU, then the spatial mean) into
    ``fc_reg``, an fc branch (``fc{i}`` on the flattened map) into
    ``fc_cls``."""

    def __init__(self, num_convs: int = 4, num_fcs: int = 2,
                 conv_out_channels: int = 1024, fc_out_channels: int = 1024,
                 with_avg_pool: bool = True, roi_feat_size: int = 7,
                 in_channels: int = 256, num_classes: int = 81,
                 target_means: Sequence[float] = (0., 0., 0., 0.),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 reg_class_agnostic: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs, self.num_fcs = num_convs, num_fcs
        self.reg_class_agnostic = reg_class_agnostic
        for i in range(num_convs):
            self.add_module(f"conv{i}", ConvBN(
                in_channels if i == 0 else conv_out_channels,
                conv_out_channels, dtype=dtype))
        conv_dim = conv_out_channels if num_convs else in_channels
        out_reg = 4 if reg_class_agnostic else 4 * num_classes
        self.fc_reg = Linear(conv_dim, out_reg, compute_dtype=dtype)
        self.fc_reg.init_std = 0.001
        fc_dim = in_channels * roi_feat_size ** 2
        for i in range(num_fcs):
            self.add_module(f"fc{i}", Linear(
                fc_dim if i == 0 else fc_out_channels, fc_out_channels,
                compute_dtype=dtype))
        self.fc_cls = Linear(fc_out_channels if num_fcs else fc_dim,
                             num_classes, compute_dtype=dtype)
        self.flat_map_fcs = frozenset({"fc0" if num_fcs else "fc_cls"})

    def forward(self, x: torch.Tensor, *unused):
        """(N, C, 7, 7) → (cls (N, num_classes), reg (N, 4·k))."""
        x_conv = x
        for i in range(self.num_convs):
            x_conv = getattr(self, f"conv{i}")(x_conv)
        bbox_pred = self.fc_reg(x_conv.mean(dim=(2, 3)))
        x_fc = flatten_roi_feats(x)
        for i in range(self.num_fcs):
            x_fc = F.relu(getattr(self, f"fc{i}")(x_fc))
        return self.fc_cls(x_fc), bbox_pred
