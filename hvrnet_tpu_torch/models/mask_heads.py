"""Mask heads (counterparts of ``hvrnet_tpu/models/mask_heads.py``):
``FCNMaskHead`` (``:23``), its training target ``mask_target`` (``:186``)
and the host paste of predicted masks into the image, ``paste_masks``
(the counterpart of ``paste_masks_np``, ``:206``).

``FCNMaskHead`` keeps mmdet's names (``convs.i.conv``, ``upsample``,
``conv_logits``) and computes NCHW: (R, C, 14, 14) → (R, K, 28, 28)
logits.  HTC's ``HTCMaskHead`` and ``FusedSemanticHead``, Mask Scoring
R-CNN's ``MaskIoUHead`` and Grid R-CNN's ``GridHead`` are registered under
their names and raise when a config builds them: they are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.resize import resize_bilinear_f32
from ..ops.roi_align import roi_align_gather
from .layers import Conv2d, ConvModule, ConvTranspose2d
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


def _not_ported(name: str):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (it waits for "
                                  "the HTC / Mask Scoring / Grid R-CNN slice)")
    return type(name, (nn.Module,), {"__init__": __init__, "__doc__": (
        f"``hvrnet_tpu/models/mask_heads.py:{name}``: not ported yet.")})


for _name in ("HTCMaskHead", "FusedSemanticHead", "MaskIoUHead",
              "GridHead"):
    HEADS.register_module(_not_ported(_name))


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
