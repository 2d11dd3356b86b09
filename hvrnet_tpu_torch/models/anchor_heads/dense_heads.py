"""Single-stage dense heads (NCHW), counterparts of
``hvrnet_tpu/models/anchor_heads/dense_heads.py``: ``RetinaHead`` and
``FreeAnchorRetinaHead``, ``SSDHead``, ``FCOSHead`` (with ``Scale``) and
``FoveaHead``.  Each maps the neck's (or backbone's) tuple of maps to
per-level output maps; the engine and the trainers flatten a level's
(1, A·K, h, w) map in (h, w, anchor, K) order, the order of the JAX
package's NHWC maps and of the anchors.

Names are mmdet's: the towers ``cls_convs.{i}.conv`` / ``reg_convs.{i}.conv``
(FCOS: and ``.gn``), ``retina_cls`` / ``retina_reg``, ``fcos_cls`` /
``fcos_reg`` / ``fcos_centerness``, ``scales.{i}.scale``, ``fovea_cls`` /
``fovea_reg``, SSD's per-level ``cls_convs.{i}`` / ``reg_convs.{i}``.
Seeded weights follow the JAX init: normal(0, 0.01) towers and outputs
(``init_std``), the classifiers' bias at the prior −log(99)
(``init_bias``, ``_bias_prior``), He-normal SSD convs.

Where the JAX heads part from mmdet the port follows them: FCOS's tower
convs keep a bias before their GroupNorm (flax's, epsilon 1e-6, ``min(32,
feat_channels)`` groups), and its regression is ``exp(scale · reg)``.

The deformable half (``ops/deform.py``): ``GARetinaHead``,
``GuidedAnchorHead`` / ``GARPNHead`` (mmdet's ``feature_adaption*.
conv_offset`` / ``.conv_adaption``, ``conv_loc``, ``conv_shape``,
``conv_cls``, ``conv_reg``) and ``RepPointsHead`` (``pts_convs.{i}.conv``,
``reppoints_*``, ``moment_transfer``).  RepPoints' towers have no
GroupNorm: the JAX head reads no ``norm_cfg``, and neither does the port.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.precision import widen
from ...ops.deform import DeformConv2d
from ..layers import Conv2d, ConvModule
from ..registry import HEADS


def _bias_prior(prior_prob: float = 0.01) -> float:
    """The classifier bias whose sigmoid is ``prior_prob``."""
    return -math.log((1 - prior_prob) / prior_prob)


def _conv(cin: int, cout: int, dtype, std=0.01, bias=0.0, k=3) -> Conv2d:
    """A k×k conv with the JAX head's init (``init_std``, ``init_bias``)."""
    conv = Conv2d(cin, cout, k, padding=k // 2, compute_dtype=dtype)
    conv.init_std, conv.init_bias = std, bias
    return conv


def _tower(cin: int, feat: int, n: int, dtype) -> nn.ModuleList:
    """``n`` stacked 3×3 ConvModules (conv with bias, ReLU in forward)."""
    mods = nn.ModuleList()
    for i in range(n):
        m = ConvModule(cin if i == 0 else feat, feat, 3, dtype, padding=1)
        m.conv.init_std = 0.01
        mods.append(m)
    return mods


@HEADS.register_module
class RetinaHead(nn.Module):
    """``stacked_convs`` ReLU'd 3×3 convs per branch (shared across
    levels), then ``retina_cls`` (A·(K − 1) sigmoid logits) and
    ``retina_reg`` (A·4 deltas), A = scales_per_octave · ratios."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 octave_base_scale: int = 4, scales_per_octave: int = 3,
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_anchors = scales_per_octave * len(anchor_ratios)
        self.cls_out_channels = num_classes - 1
        self.cls_convs = _tower(in_channels, feat_channels, stacked_convs,
                                dtype)
        self.reg_convs = _tower(in_channels, feat_channels, stacked_convs,
                                dtype)
        self.retina_cls = _conv(feat_channels,
                                self.num_anchors * self.cls_out_channels,
                                dtype, bias=_bias_prior())
        self.retina_reg = _conv(feat_channels, self.num_anchors * 4, dtype)

    def forward(self, feats):
        """feats: tuple of (B, C, h, w) → (cls maps, reg maps)."""
        outs_cls, outs_reg = [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            outs_cls.append(self.retina_cls(c))
            outs_reg.append(self.retina_reg(r))
        return tuple(outs_cls), tuple(outs_reg)


@HEADS.register_module
class FreeAnchorRetinaHead(RetinaHead):
    """RetinaNet's network; FreeAnchor's matching objective is the
    trainer's (``engine/train_single_stage.py:free_anchor_loss``)."""


@HEADS.register_module
class SSDHead(nn.Module):
    """Per level one 3×3 classifier (A·K softmax logits, background first)
    and one 3×3 regressor (A·4), A = 2 + 2·len(ratios of the level)."""

    def __init__(self, num_classes: int = 81,
                 in_channels: Sequence[int] = (512, 1024, 512, 256, 256, 256),
                 anchor_ratios: Sequence[Sequence[int]] = (
                     [2], [2, 3], [2, 3], [2, 3], [2], [2]),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        anchors = [2 + 2 * len(r) for r in anchor_ratios]
        self.cls_convs = nn.ModuleList(
            Conv2d(c, a * num_classes, 3, padding=1, compute_dtype=dtype)
            for c, a in zip(in_channels, anchors))
        self.reg_convs = nn.ModuleList(
            Conv2d(c, a * 4, 3, padding=1, compute_dtype=dtype)
            for c, a in zip(in_channels, anchors))

    def forward(self, feats):
        return (tuple(conv(x) for conv, x in zip(self.cls_convs, feats)),
                tuple(conv(x) for conv, x in zip(self.reg_convs, feats)))


class Scale(nn.Module):
    """x · a learnable scalar ``scale``."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


def flax_group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """``gn``'s GroupNorm as flax computes it, in float32: the variance
    ``E[x²] − E[x]²`` clipped at 0 (a group of one value normalises to 0),
    then ``(x − mean) · (rsqrt(var + eps) · weight) + bias``."""
    n, c, h, w = x.shape
    g = gn.num_groups
    xg = widen(x).reshape(n, g, c // g, h * w)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = ((xg * xg).mean(dim=(2, 3), keepdim=True)
           - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + gn.eps) * gn.weight.reshape(1, g, c // g, 1)
    y = (xg - mean) * mul + gn.bias.reshape(1, g, c // g, 1)
    return y.reshape(n, c, h, w)


class _GNConvModule(nn.Module):
    """FCOS's tower unit as the JAX head has it: a 3×3 conv with a bias,
    GroupNorm (``flax_group_norm``, epsilon 1e-6) and ReLU; mmdet's names
    ``conv`` and ``gn``."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.conv = _conv(cin, cout, dtype)
        self.gn = nn.GroupNorm(min(32, cout), cout, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return F.relu(flax_group_norm(y, self.gn).to(y.dtype))


@HEADS.register_module
class FCOSHead(nn.Module):
    """GroupNorm towers; per level the classifier (K − 1 sigmoid logits),
    the centerness logit off the classification tower, and the distances
    ``exp(scale_l · reg)`` (to be multiplied by the level's stride)."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = tuple(strides)
        self.cls_convs = nn.ModuleList(
            _GNConvModule(in_channels if i == 0 else feat_channels,
                          feat_channels, dtype) for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            _GNConvModule(in_channels if i == 0 else feat_channels,
                          feat_channels, dtype) for i in range(stacked_convs))
        self.fcos_cls = _conv(feat_channels, num_classes - 1, dtype,
                              bias=_bias_prior())
        self.fcos_reg = _conv(feat_channels, 4, dtype)
        self.fcos_centerness = _conv(feat_channels, 1, dtype)
        self.scales = nn.ModuleList(Scale(1.0) for _ in self.strides)

    def forward(self, feats):
        """→ (cls maps, distance maps (float32), centerness maps)."""
        cls_outs, reg_outs, ctr_outs = [], [], []
        for lvl, x in enumerate(feats):
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_outs.append(self.fcos_cls(c))
            ctr_outs.append(self.fcos_centerness(c))
            reg_outs.append(torch.exp(self.scales[lvl](
                widen(self.fcos_reg(r)))))
        return tuple(cls_outs), tuple(reg_outs), tuple(ctr_outs)


@HEADS.register_module
class FoveaHead(nn.Module):
    """Plain ReLU'd towers, ``fovea_cls`` (K − 1 sigmoid logits) and
    ``fovea_reg`` (4 log-space distances, exponentiated at decode)."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_convs = _tower(in_channels, feat_channels, stacked_convs,
                                dtype)
        self.reg_convs = _tower(in_channels, feat_channels, stacked_convs,
                                dtype)
        self.fovea_cls = _conv(feat_channels, num_classes - 1, dtype,
                               bias=_bias_prior())
        self.fovea_reg = _conv(feat_channels, 4, dtype)

    def forward(self, feats):
        cls_outs, reg_outs = [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_outs.append(self.fovea_cls(c))
            reg_outs.append(self.fovea_reg(r))
        return tuple(cls_outs), tuple(reg_outs)


class FeatureAdaption(nn.Module):
    """mmdet's ``FeatureAdaption`` (the JAX heads' ``feature_adaption*``):
    a bias-free 1×1 ``conv_offset`` (normal(0, 0.1)) on the detached
    2-channel shape prediction gives the offsets of ``conv_adaption``, a
    k×k deformable conv of ``deformable_groups`` groups, then ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, deformable_groups: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_offset = Conv2d(2, deformable_groups * 2 * kernel_size ** 2,
                                  1, bias=False, compute_dtype=dtype)
        self.conv_offset.init_std = 0.1
        self.conv_adaption = DeformConv2d(
            in_channels, out_channels, kernel_size,
            padding=(kernel_size - 1) // 2,
            deformable_groups=deformable_groups, compute_dtype=dtype)
        self.conv_adaption.init_std = 0.01

    def forward(self, x: torch.Tensor, shape: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv_adaption(x, self.conv_offset(shape.detach())))


@HEADS.register_module
class GARetinaHead(nn.Module):
    """Guided-anchoring RetinaNet (``dense_heads.py:85-172`` of the JAX
    package): RetinaNet's towers; ``conv_loc`` (1×1, the prior bias) on the
    classification tower and ``conv_shape`` (1×1, (dw, dh)) on the
    regression tower; per branch a ``FeatureAdaption``
    (``feature_adaption_cls`` / ``feature_adaption_reg``) from the shape,
    then the 3×3 ``retina_cls`` (K − 1 sigmoid logits) and ``retina_reg``
    (4 deltas), one guided anchor per position.  mmdet's ``MaskedConv2d``
    skips the positions the location branch filters out; the values it
    computes are the dense conv's, and the engine zeroes those scores.
    Returns (cls, reg, shape, loc) maps."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 deformable_groups: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_convs = _tower(in_channels, feat_channels, stacked_convs,
                                dtype)
        self.reg_convs = _tower(in_channels, feat_channels, stacked_convs,
                                dtype)
        self.conv_loc = _conv(feat_channels, 1, dtype, bias=_bias_prior(),
                              k=1)
        self.conv_shape = _conv(feat_channels, 2, dtype, k=1)
        self.feature_adaption_cls = FeatureAdaption(
            feat_channels, feat_channels, 3, deformable_groups, dtype)
        self.feature_adaption_reg = FeatureAdaption(
            feat_channels, feat_channels, 3, deformable_groups, dtype)
        self.retina_cls = _conv(feat_channels, num_classes - 1, dtype,
                                bias=_bias_prior())
        self.retina_reg = _conv(feat_channels, 4, dtype)

    def forward(self, feats):
        outs = ([], [], [], [])
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            loc = self.conv_loc(c)
            shape = self.conv_shape(r)
            c = self.feature_adaption_cls(c, shape)
            r = self.feature_adaption_reg(r, shape)
            for out, o in zip(outs, (self.retina_cls(c), self.retina_reg(r),
                                     shape, loc)):
                out.append(o)
        return tuple(tuple(o) for o in outs)


@HEADS.register_module
class GuidedAnchorHead(nn.Module):
    """The guided-anchor head (``dense_heads.py:382-437``): 1×1
    ``conv_loc`` (the prior bias) and ``conv_shape`` on the input map, a
    3×3 ``feature_adaption`` of ``deformable_groups`` groups from the
    detached shape, then the 1×1 ``conv_cls`` (K − 1 sigmoid logits, a zero
    bias) and ``conv_reg`` on the adapted map.  Returns (cls, reg, shape,
    loc) maps."""

    def __init__(self, num_classes: int = 2, in_channels: int = 256,
                 feat_channels: int = 256, deformable_groups: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_loc = _conv(in_channels, 1, dtype, bias=_bias_prior(), k=1)
        self.conv_shape = _conv(in_channels, 2, dtype, k=1)
        self.feature_adaption = FeatureAdaption(
            in_channels, feat_channels, 3, deformable_groups, dtype)
        self.conv_cls = _conv(feat_channels, num_classes - 1, dtype, k=1)
        self.conv_reg = _conv(feat_channels, 4, dtype, k=1)

    def forward(self, feats):
        outs = ([], [], [], [])
        for x in feats:
            shape = self.conv_shape(x)
            adapted = self.feature_adaption(x, shape)
            for out, o in zip(outs, (self.conv_cls(adapted),
                                     self.conv_reg(adapted), shape,
                                     self.conv_loc(x))):
                out.append(o)
        return tuple(tuple(o) for o in outs)


@HEADS.register_module
class GARPNHead(GuidedAnchorHead):
    """The guided-anchor RPN (binary objectness): ``GuidedAnchorHead``, as
    the JAX package has it (without mmdet's ``rpn_conv``)."""


@HEADS.register_module
class RepPointsHead(nn.Module):
    """RepPoints (``dense_heads.py:306-379``): ReLU'd towers ``cls_convs``
    and ``pts_convs``; the init points ``reppoints_pts_init_out`` (1×1, 2N
    y-first offsets) on ``reppoints_pts_init_conv``; the detached init
    points themselves, with no base grid subtracted, are the offsets of two
    k×k deformable convs (k² = N points, float32 weights, as the JAX head
    leaves its kernels), ``reppoints_cls_conv`` → ``reppoints_cls_out``
    (1×1, K − 1 sigmoid logits) and ``reppoints_pts_refine_conv`` →
    ``reppoints_pts_refine_out``, to which the init points are added.
    ``moment_transfer`` (2,), zeros, is the head's parameter for the moment
    transform.  Returns (cls, init points, refined points) maps."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_points: int = 9,
                 transform_method: str = "moment",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = int(math.isqrt(num_points))
        if k * k != num_points:
            raise ValueError(f"RepPointsHead: num_points {num_points} is not "
                             "a square")
        if transform_method == "moment":
            self.moment_transfer = nn.Parameter(torch.zeros(2))
        self.cls_convs = _tower(in_channels, feat_channels, stacked_convs,
                                dtype)
        self.pts_convs = _tower(in_channels, feat_channels, stacked_convs,
                                dtype)
        self.reppoints_pts_init_conv = _conv(feat_channels,
                                             point_feat_channels, dtype)
        self.reppoints_pts_init_out = _conv(point_feat_channels,
                                            2 * num_points, dtype, k=1)

        def dcn():
            conv = DeformConv2d(feat_channels, point_feat_channels, k,
                                padding=k // 2)
            conv.init_std = 0.01
            return conv

        self.reppoints_cls_conv = dcn()
        self.reppoints_cls_out = _conv(point_feat_channels, num_classes - 1,
                                       dtype, bias=_bias_prior(), k=1)
        self.reppoints_pts_refine_conv = dcn()
        self.reppoints_pts_refine_out = _conv(point_feat_channels,
                                              2 * num_points, dtype, k=1)

    def forward(self, feats):
        cls_outs, init_outs, refine_outs = [], [], []
        for x in feats:
            c = p = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.pts_convs:
                p = conv(p)
            pts_init = self.reppoints_pts_init_out(
                F.relu(self.reppoints_pts_init_conv(p)))
            off = pts_init.detach()
            c = F.relu(self.reppoints_cls_conv(c, off))
            p = F.relu(self.reppoints_pts_refine_conv(p, off))
            cls_outs.append(self.reppoints_cls_out(c))
            init_outs.append(pts_init)
            refine_outs.append(self.reppoints_pts_refine_out(p) + off)
        return tuple(cls_outs), tuple(init_outs), tuple(refine_outs)
