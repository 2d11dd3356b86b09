"""Mask heads (counterparts of ``hvrnet_tpu/models/mask_heads.py``):
``FCNMaskHead`` (``:23``), HTC's ``HTCMaskHead`` (``:64``) and
``FusedSemanticHead`` (``:97``), Mask Scoring R-CNN's ``MaskIoUHead``
(``:131``), Grid R-CNN's ``GridHead`` (``:160``), the mask training
target ``mask_target`` (``:186``) and the host paste of predicted masks
into the image, ``paste_masks`` (the counterpart of ``paste_masks_np``,
``:206``).

The heads compute NCHW and keep mmdet's names where the structure is
mmdet's (``convs.i.conv``, ``upsample``, ``conv_logits``, ``conv_res``,
``lateral_convs.i.conv``, ``fcs.i``); where the JAX module's structure
differs from mmdet's (the semantic head's laterals and embedding, the
grid head) they mirror the JAX module.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import widen
from ..data.resize import resize_bilinear_f32
from ..ops.roi_align import roi_align_gather
from .layers import Conv2d, ConvModule, ConvTranspose2d, Linear
from .registry import HEADS


@HEADS.register_module
class FCNMaskHead(nn.Module):
    """``num_convs`` 3×3 convs with ReLU, an upsample (``deconv``: a
    stride-``upsample_ratio`` transposed conv with ReLU; ``nearest``: pixel
    repetition), then the 1×1 ``conv_logits``: one channel per foreground
    class, or one with ``class_agnostic``."""

    def __init__(self, num_convs: int = 4, roi_feat_size: int = 14,
                 in_channels: int = 256, conv_kernel_size: int = 3,
                 conv_out_channels: int = 256, upsample_method: str = "deconv",
                 upsample_ratio: int = 2, num_classes: int = 81,
                 class_agnostic: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if upsample_method not in ("deconv", "nearest"):
            raise ValueError(f"upsample_method {upsample_method!r}: the port "
                             "has 'deconv' and 'nearest'")
        k = conv_kernel_size
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, k, padding=k // 2, dtype=dtype)
            for i in range(num_convs))
        ch = conv_out_channels if num_convs else in_channels
        self.upsample_method = upsample_method
        self.upsample_ratio = upsample_ratio
        self.upsample = (ConvTranspose2d(ch, conv_out_channels, upsample_ratio,
                                         stride=upsample_ratio,
                                         compute_dtype=dtype)
                         if upsample_method == "deconv" else None)
        if self.upsample is not None:
            ch = conv_out_channels
        self.conv_logits = Conv2d(ch, 1 if class_agnostic else num_classes - 1,
                                  1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, C, 14, 14) pooled RoIs → (R, K, 28, 28) mask logits."""
        for conv in self.convs:
            x = conv(x)
        if self.upsample is not None:
            x = F.relu(self.upsample(x))
        else:
            r = self.upsample_ratio
            x = x.repeat_interleave(r, dim=2).repeat_interleave(r, dim=3)
        return self.conv_logits(x)


@HEADS.register_module
class HTCMaskHead(FCNMaskHead):
    """HTC's per-stage mask head (``mask_heads.py:64``, mmdet's
    ``htc_mask_head.py``): with the previous stage's post-conv features
    ``res_feat``, a 1×1 ``conv_res`` + ReLU of them is added to the pooled
    input first (the mask information flow); ``return_logits=False`` runs
    only the conv trunk and returns its features, ``return_feat`` returns
    them beside the logits.  As in the JAX module the upsample is the
    transposed conv or none: ``nearest`` leaves the logits at the RoI size.
    ``with_conv_res=False`` builds no ``conv_res`` (the first stage's
    head, which the JAX tree has none for)."""

    def __init__(self, num_convs: int = 4, roi_feat_size: int = 14,
                 in_channels: int = 256, conv_kernel_size: int = 3,
                 conv_out_channels: int = 256, upsample_method: str = "deconv",
                 upsample_ratio: int = 2, num_classes: int = 81,
                 class_agnostic: bool = False, with_conv_res: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_convs, roi_feat_size, in_channels,
                         conv_kernel_size, conv_out_channels, upsample_method,
                         upsample_ratio, num_classes, class_agnostic, dtype)
        self.conv_res = (ConvModule(conv_out_channels, conv_out_channels, 1,
                                    dtype) if with_conv_res else None)

    def forward(self, x: torch.Tensor, res_feat=None,
                return_logits: bool = True, return_feat: bool = False):
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for conv in self.convs:
            x = conv(x)
        res_feat = x
        if not return_logits:
            return res_feat
        if self.upsample is not None:
            x = F.relu(self.upsample(x))
        logits = self.conv_logits(x)
        return (logits, res_feat) if return_feat else logits


def resize_bilinear_antialiased(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of NCHW maps: half-pixel
    centres, and a triangle filter widened by the scale when downsampling
    (torch's ``antialias=True``; without it a 2× downsample is off by up
    to 0.6), a 16-bit map in float32."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(widen(x), size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True).to(x.dtype)


@HEADS.register_module
class FusedSemanticHead(nn.Module):
    """HTC's semantic branch (``mask_heads.py:97``, mmdet's
    ``fused_semantic_head.py``) as the JAX module computes it: every level
    but ``fusion_level`` resized to that level's size
    (``resize_bilinear_antialiased``), a 1×1 lateral conv per level, their
    sum, ``num_convs`` 3×3 convs with ReLU, then the segmentation logits
    (``conv_logits``, ``num_classes``) and the embedding
    (``conv_embedding``).  mmdet's names (``lateral_convs.{i}.conv``,
    ``convs.{i}.conv``, ``conv_embedding.conv``, ``conv_logits``); unlike
    mmdet's, the laterals and the embedding have no ReLU and the laterals
    run after the resize, as in the JAX module.  ``ignore_label`` and
    ``loss_weight`` are the trainer's."""

    def __init__(self, num_ins: int = 5, fusion_level: int = 1,
                 num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 183,
                 ignore_label: int = 255, loss_weight: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fusion_level = fusion_level
        self.ignore_label = ignore_label
        self.loss_weight = loss_weight
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels, in_channels, 1, dtype, activation=None)
            for _ in range(num_ins))
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, dtype, padding=1)
            for i in range(num_convs))
        ch = conv_out_channels if num_convs else in_channels
        self.conv_embedding = ConvModule(ch, conv_out_channels, 1, dtype,
                                         activation=None)
        self.conv_logits = Conv2d(ch, num_classes, 1, compute_dtype=dtype)

    def forward(self, feats, with_logits: bool = True):
        """The neck's maps → (logits (B, num_classes, h, w) or None without
        ``with_logits``, embedding (B, C, h, w)) at ``fusion_level``'s
        size."""
        size = feats[self.fusion_level].shape[2:]
        x = self.lateral_convs[self.fusion_level](feats[self.fusion_level])
        for i, f in enumerate(feats):
            if i != self.fusion_level:
                x = x + self.lateral_convs[i](
                    resize_bilinear_antialiased(f, size))
        for conv in self.convs:
            x = conv(x)
        return (self.conv_logits(x) if with_logits else None,
                self.conv_embedding(x))


@HEADS.register_module
class MaskIoUHead(nn.Module):
    """Mask Scoring R-CNN's MaskIoU head (``mask_heads.py:131``, mmdet's
    ``maskiou_head.py``): the (R, C, 14, 14) mask features beside the 2×2
    max pool of the (R, 1, 28, 28) sigmoided mask, ``num_convs`` 3×3 convs
    with ReLU (the last at stride 2), ``num_fcs`` dense layers with ReLU,
    then ``fc_mask_iou``: one IoU per foreground class.  mmdet's names
    (``convs.{i}.conv``, ``fcs.{i}``, ``fc_mask_iou``) and its
    ``in_channels``, the mask features' (the first conv reads one more);
    ``fcs.0`` reads the flattened (C, 7, 7) map (``flat_map_fcs``)."""

    def __init__(self, num_convs: int = 4, num_fcs: int = 2,
                 roi_feat_size: int = 14, in_channels: int = 256,
                 conv_out_channels: int = 256, fc_out_channels: int = 1024,
                 num_classes: int = 81, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvModule(in_channels + 1 if i == 0 else conv_out_channels,
                       conv_out_channels, 3, dtype, padding=1,
                       stride=2 if i == num_convs - 1 else 1)
            for i in range(num_convs))
        hw = (roi_feat_size + 1) // 2 if num_convs else roi_feat_size
        self.flat_map_hw = hw
        ch = conv_out_channels if num_convs else in_channels + 1
        self.fcs = nn.ModuleList(
            Linear(ch * hw * hw if i == 0 else fc_out_channels,
                   fc_out_channels, compute_dtype=dtype)
            for i in range(num_fcs))
        self.fc_mask_iou = Linear(fc_out_channels if num_fcs else ch * hw * hw,
                                  num_classes - 1, compute_dtype=dtype)
        self.flat_map_fcs = frozenset({"fcs.0" if num_fcs else
                                       "fc_mask_iou"})

    def forward(self, mask_feat: torch.Tensor,
                mask_pred: torch.Tensor) -> torch.Tensor:
        x = torch.cat([mask_feat, F.max_pool2d(mask_pred.to(
            mask_feat.dtype), 2, 2)], dim=1)
        for conv in self.convs:
            x = conv(x)
        x = x.flatten(1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return self.fc_mask_iou(x)


@HEADS.register_module
class GridHead(nn.Module):
    """Grid R-CNN's head as the JAX module has it (``mask_heads.py:160``;
    mmdet's ``grid_head.py`` differs: grouped 4×4 deconvolutions and the
    grid fusion): ``num_convs`` 3×3 convs each with GroupNorm(36, eps 1e-6,
    flax's) and ReLU, a 2×2 stride-2 transposed conv with ReLU
    (``deconv1``), then one to ``grid_points`` heatmaps (``deconv2``): (R,
    C, 14, 14) → (R, grid_points, 56, 56).  Names ``convs.{i}.conv``,
    ``convs.{i}.gn``, ``deconv1``, ``deconv2``."""

    def __init__(self, grid_points: int = 9, num_convs: int = 8,
                 in_channels: int = 256, conv_out_channels: int = 576,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList()
        for i in range(num_convs):
            block = nn.Module()
            block.conv = Conv2d(in_channels if i == 0 else conv_out_channels,
                                conv_out_channels, 3, padding=1,
                                compute_dtype=dtype)
            block.gn = nn.GroupNorm(36, conv_out_channels, eps=1e-6)
            self.convs.append(block)
        ch = conv_out_channels if num_convs else in_channels
        self.deconv1 = ConvTranspose2d(ch, conv_out_channels, 2, stride=2,
                                       compute_dtype=dtype)
        self.deconv2 = ConvTranspose2d(conv_out_channels, grid_points, 2,
                                       stride=2, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.convs:
            x = block.conv(x)
            x = F.relu(F.group_norm(
                widen(x), block.gn.num_groups, block.gn.weight,
                block.gn.bias, block.gn.eps).to(x.dtype))
        x = F.relu(self.deconv1(x))
        return self.deconv2(x)


def mask_target(gt_masks: torch.Tensor, rois: torch.Tensor,
                mask_size: int = 28) -> torch.Tensor:
    """The RoIs' binary mask targets on the ``mask_size`` grid: RoIAlign
    (sample_num 2, spatial scale 1) of each RoI on the mask raster its
    first column indexes, thresholded at 0.5.

    gt_masks: (G, H, W) image-size binary masks; rois: (R, 5) rows of
    [mask index, x1, y1, x2, y2].  The JAX package gathers one (H, W) mask
    per RoI and pools RoI r on mask r; indexing the G masks reads the same
    rasters with the same arithmetic (``roi_align_gather``), so the targets
    are the same bits without an (R, H, W) stack."""
    pooled = roi_align_gather(gt_masks, rois, mask_size, 1.0, 2)
    return (pooled >= 0.5).float()


def paste_masks(mask_pred: np.ndarray, dets: np.ndarray, labels: np.ndarray,
                img_h: int, img_w: int, thr: float = 0.5) -> list:
    """The host decode of ``paste_masks_np``: each detection's (28, 28)
    probabilities of its class (``mask_pred`` (n, K, 28, 28), sigmoided),
    resized to its box (``resize_bilinear_f32``, cv2's float rounding),
    thresholded and placed in an (img_h, img_w) uint8 mask; per class the
    list of its detections' masks."""
    num_classes = mask_pred.shape[1]
    segms = [[] for _ in range(num_classes)]
    for i in range(dets.shape[0]):
        x1, y1, x2, y2 = dets[i, :4]
        w = max(int(round(x2 - x1 + 1)), 1)
        h = max(int(round(y2 - y1 + 1)), 1)
        cls = int(labels[i])
        m = mask_pred[i, cls if num_classes > 1 else 0]
        m = resize_bilinear_f32(np.ascontiguousarray(m, np.float32), (w, h))
        full = np.zeros((img_h, img_w), np.uint8)
        x1i, y1i = int(round(x1)), int(round(y1))
        full[y1i:y1i + h, x1i:x1i + w] = (m >= thr).astype(np.uint8)[
            :max(min(h, img_h - y1i), 0), :max(min(w, img_w - x1i), 0)]
        segms[cls].append(full)
    return segms
