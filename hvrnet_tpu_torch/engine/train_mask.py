"""The mask branch's training objective (counterpart of
``hvrnet_tpu/engine/train_mask.py:mask_branch_loss``, mmdet's
``fcn_mask_head.py:loss`` with ``mask_target.py``).  The SSD objective of
that file is not ported yet."""
from __future__ import annotations

import torch

from ..models.losses import binary_cross_entropy_with_logits
from ..models.mask_heads import mask_target


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
