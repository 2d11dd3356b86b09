"""Merging the augmentations of a flip-augmented test (counterpart of
``hvrnet_tpu/core/merge_augs.py``, the reference mmdet's
``core/post_processing/merge_augs.py``): proposals, boxes, scores and masks
of A augmentations of one image mapped back to original-image coordinates
and merged, with static shapes and validity masks."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.boxes import bbox_mapping_back
from ..ops.nms import nms_static


def merge_aug_proposals(aug_proposals: Sequence[torch.Tensor],
                        img_metas: Sequence[dict], rpn_test_cfg,
                        valid_masks: Optional[Sequence[torch.Tensor]] = None):
    """Each augmentation's (P, 5) [x1, y1, x2, y2, score] proposals mapped
    back to original coordinates, then one greedy NMS at
    ``rpn_test_cfg["nms_thr"]`` over all A·P rows keeping ``max_num``.

    Returns (proposals (max_num, 5), keep (max_num,)): the picked rows in
    score order; a dropped slot is all zero, its score included."""
    recovered, masks = [], []
    for i, (proposals, meta) in enumerate(zip(aug_proposals, img_metas)):
        boxes = bbox_mapping_back(proposals[:, :4], meta["img_shape"],
                                  meta["scale_factor"], meta["flip"])
        recovered.append(torch.cat([boxes, proposals[:, 4:5]], dim=1))
        masks.append(valid_masks[i] if valid_masks is not None else
                     torch.ones(proposals.shape[0], dtype=torch.bool,
                                device=proposals.device))
    allp = torch.cat(recovered)
    idx, keep = nms_static(allp[:, :4], allp[:, 4],
                           float(rpn_test_cfg["nms_thr"]),
                           int(rpn_test_cfg["max_num"]), valid=torch.cat(masks))
    return allp[idx] * keep[:, None], keep


def merge_aug_bboxes(aug_bboxes: Sequence[torch.Tensor],
                     aug_scores: Optional[Sequence[torch.Tensor]],
                     img_metas: Sequence[dict], rcnn_test_cfg=None):
    """The mean of the augmentations' (N, 4·k) boxes mapped back, and the
    mean of their scores (None without scores)."""
    recovered = [bbox_mapping_back(b.reshape(-1, 4), meta["img_shape"],
                                   meta["scale_factor"],
                                   meta["flip"]).reshape(b.shape)
                 for b, meta in zip(aug_bboxes, img_metas)]
    bboxes = sum(recovered) / len(recovered)
    if aug_scores is None:
        return bboxes, None
    return bboxes, merge_aug_scores(aug_scores)


def merge_aug_scores(aug_scores: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(aug_scores) / len(aug_scores)


def merge_aug_masks(aug_masks: Sequence[np.ndarray],
                    img_metas: Sequence[dict], rcnn_test_cfg=None,
                    weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Host mean of mask probabilities, each flipped one unflipped
    (weighted by ``weights`` when given)."""
    recovered = []
    for mask, meta in zip(aug_masks, img_metas):
        m = np.asarray(mask)
        if meta.get("flip", False):
            m = m[:, :, ::-1] if m.ndim == 3 else m[:, :, ::-1, :]
        recovered.append(m)
    if weights is None:
        return np.mean(recovered, axis=0)
    w = np.asarray(weights, np.float32)
    return np.average(np.stack(recovered), axis=0, weights=w)
