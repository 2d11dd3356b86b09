"""The plain RoI head and RoI bbox decoding (counterparts of
``hvrnet_tpu/models/bbox_heads/bbox_head.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.boxes import delta2bbox
from ...ops.nms import multiclass_nms_static
from ..layers import Linear
from ..registry import HEADS


def flatten_roi_feats(x: torch.Tensor) -> torch.Tensor:
    """(N, C, 7, 7) → (N, C·49), flattened in mmdet's CHW order, so the
    reference ``fc_new_1`` weights apply unchanged.  (The JAX package keeps
    NHWC and flattens HWC; its checkpoint converter permutes the weights.)"""
    return x.reshape(x.shape[0], -1)


@HEADS.register_module
class BBoxHead(nn.Module):
    """mmdet's plain RoI head, the still-image Faster R-CNN's: the (N, C,
    7, 7) RoI maps, average-pooled to (N, C) when ``with_avg_pool``, else
    flattened (``flatten_roi_feats``), into ``fc_cls`` (``num_classes``
    logits) and ``fc_reg`` (4 deltas per class, or 4 when
    ``reg_class_agnostic``).  Dense layers draw normal(0, 0.01) and
    normal(0, 0.001) weights (``init_std``, read by the engine's seeded
    init) and compute in ``dtype``."""

    def __init__(self, with_avg_pool: bool = False, roi_feat_size: int = 7,
                 in_channels: int = 256, num_classes: int = 81,
                 reg_class_agnostic: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.with_avg_pool = with_avg_pool
        in_dim = in_channels * (1 if with_avg_pool else roi_feat_size ** 2)
        out_reg = 4 if reg_class_agnostic else 4 * num_classes
        self.fc_cls = Linear(in_dim, num_classes, compute_dtype=dtype)
        self.fc_reg = Linear(in_dim, out_reg, compute_dtype=dtype)
        self.fc_reg.init_std = 0.001
        # the dense layers over the flattened RoI map (utils/weights.py)
        self.flat_map_fcs = frozenset() if with_avg_pool else frozenset(
            {"fc_cls", "fc_reg"})

    def forward(self, x: torch.Tensor, *unused):
        """(N, C, 7, 7) → (cls (N, num_classes), reg (N, 4·k)).  Further
        arguments (a relation head's row range and mask) are ignored."""
        if self.with_avg_pool and x.ndim == 4:
            x = x.mean(dim=(2, 3))
        x = flatten_roi_feats(x)
        return self.fc_cls(x), self.fc_reg(x)


def get_det_bboxes(rois: torch.Tensor, cls_score: torch.Tensor,
                   bbox_pred: torch.Tensor, img_shape, scale_factor,
                   target_means, target_stds, rescale: bool = False,
                   cfg: Optional[dict] = None,
                   valid: Optional[torch.Tensor] = None):
    """mmdet ``get_det_bboxes`` with a static output: softmax → delta2bbox
    (clamped to ``img_shape``) → rescale → multiclass NMS.

    rois: (N, 4).  Returns (dets (max, 5), labels (max,), mask (max,)) when
    ``cfg`` has nms, else (boxes, scores).
    """
    scores = torch.softmax(cls_score.float(), dim=-1)
    bboxes = delta2bbox(rois, bbox_pred, target_means, target_stds, img_shape)
    if rescale:
        sf = torch.as_tensor(scale_factor, dtype=torch.float32,
                             device=bboxes.device)
        if sf.ndim == 0:
            bboxes = bboxes / sf
        else:
            bboxes = (bboxes.reshape(bboxes.shape[0], -1, 4) / sf).reshape(
                bboxes.shape[0], -1)
    if cfg is None or "nms" not in cfg:
        return bboxes, scores
    return multiclass_nms_static(
        bboxes, scores, float(cfg["score_thr"]), float(cfg["nms"]["iou_thr"]),
        int(cfg["max_per_img"]), valid=valid)
