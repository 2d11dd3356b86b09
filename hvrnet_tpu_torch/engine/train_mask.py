"""The mask branch's and SSD's training objectives (counterparts of
``hvrnet_tpu/engine/train_mask.py``: ``mask_branch_loss``, mmdet's
``fcn_mask_head.py:loss`` with ``mask_target.py``; ``ssd_targets_and_loss``,
mmdet's ``ssd_head.py:loss``)."""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.targets import _rank, max_iou_assign
from ..models.losses import (binary_cross_entropy_with_logits, smooth_l1,
                             softmax_cross_entropy)
from ..models.mask_heads import mask_target
from ..ops.boxes import bbox2delta


def mask_branch_loss(mask_pred: torch.Tensor, gt_masks: torch.Tensor,
                     rois: torch.Tensor, labels: torch.Tensor,
                     pos_mask: torch.Tensor, mask_size: int = 28,
                     class_agnostic: bool = False) -> torch.Tensor:
    """Binary cross entropy of the positive RoIs' predicted masks at their
    ground-truth class, against ``mask_target``: per RoI the mean over the
    grid, then the mean over the positives.

    mask_pred: (R, K, 28, 28) float32 logits; gt_masks: (G, H, W) binary
    masks; rois: (R, 5) rows of [the RoI's ground-truth index, x1, y1, x2,
    y2]; labels: (R,) 1-based classes; pos_mask: (R,) bool."""
    targets = mask_target(gt_masks, rois, mask_size)
    if class_agnostic:
        pred = mask_pred[:, 0]
    else:
        idx = (labels - 1).clamp_min(0)
        pred = torch.gather(mask_pred, 1, idx[:, None, None, None].expand(
            -1, 1, *mask_pred.shape[2:]))[:, 0]
    per_roi = binary_cross_entropy_with_logits(pred, targets).mean(
        dim=(1, 2))
    w = pos_mask.float()
    return (per_roi * w).sum() / w.sum().clamp_min(1.0)


def ssd_targets_and_loss(logits: torch.Tensor, deltas: torch.Tensor,
                         anchors: torch.Tensor, gt_bboxes: torch.Tensor,
                         gt_mask: torch.Tensor, gt_labels: torch.Tensor,
                         neg_pos_ratio: int = 3,
                         target_means=(0., 0., 0., 0.),
                         target_stds=(0.1, 0.1, 0.2, 0.2),
                         smoothl1_beta: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD's loss over one image's flat anchor set: max-IoU assignment at
    0.5 / 0.5 / ``min_pos_iou`` 0.2 (as the JAX objective fixes them,
    whatever ``train_cfg`` says), softmax cross entropy over the positives
    and the ``neg_pos_ratio``·#pos negatives of highest cross entropy (the
    rank a stable double argsort, ties to the lower anchor), smooth-L1 on
    the positives; both divided by #pos (at least 1).

    logits: (A, C) float32, column 0 background; deltas (A, 4); anchors
    (A, 4).  Returns (loss_cls, loss_bbox)."""
    ar = max_iou_assign(anchors, gt_bboxes, gt_mask, gt_labels,
                        pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.2)
    pos = ar.gt_inds > 0
    neg = ar.gt_inds == 0
    n_pos = pos.sum().clamp_min(1).float()
    ce = softmax_cross_entropy(logits, ar.labels)
    neg_ce = torch.where(neg, ce.detach(), float("-inf"))
    hard_neg = neg & (_rank(neg_ce) < neg_pos_ratio * n_pos)
    loss_cls = (ce * (pos | hard_neg).float()).sum() / n_pos
    gi = (ar.gt_inds - 1).clamp_min(0)
    t = bbox2delta(anchors, gt_bboxes[gi][:, :4], target_means, target_stds)
    l1 = smooth_l1(deltas, t, smoothl1_beta).sum(-1)
    return loss_cls, (l1 * pos.float()).sum() / n_pos
