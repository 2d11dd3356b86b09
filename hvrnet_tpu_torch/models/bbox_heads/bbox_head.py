"""RoI bbox decoding (counterpart of
``hvrnet_tpu/models/bbox_heads/bbox_head.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from ...ops.boxes import delta2bbox
from ...ops.nms import multiclass_nms_static


def flatten_roi_feats(x: torch.Tensor) -> torch.Tensor:
    """(N, C, 7, 7) → (N, C·49), flattened in mmdet's CHW order, so the
    reference ``fc_new_1`` weights apply unchanged.  (The JAX package keeps
    NHWC and flattens HWC; its checkpoint converter permutes the weights.)"""
    return x.reshape(x.shape[0], -1)


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
