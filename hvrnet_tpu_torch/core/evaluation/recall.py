"""Proposal recall (counterpart of ``hvrnet_tpu/core/evaluation/recall.py``,
mmdet's ``recall.py``): per image the IoU of every ground-truth box with
the first N proposals (by score where they have one), matched greedily,
best pair first; the recall is the share of ground-truth boxes whose
matched IoU reaches each threshold, over all images.  The images' IoU
blocks stay a list: the JAX function stacks them into one object array,
which fails when every image has as many ground-truth boxes and their
proposal counts differ."""
from __future__ import annotations

import numpy as np

from .mean_ap import bbox_overlaps_np


def _recalls(all_ious, proposal_nums, thrs):
    total_gt_num = sum(ious.shape[0] for ious in all_ious)
    ious_list = []
    for num in proposal_nums:
        tmp = np.zeros((0,), np.float32)
        for img_ious in all_ious:
            ious = img_ious[:, :num].copy()
            gt_ious = np.zeros(ious.shape[0])
            if ious.size:
                for j in range(ious.shape[0]):
                    gt_max = ious.max(axis=1)
                    max_idx = gt_max.argmax()
                    gt_ious[j] = gt_max[max_idx]
                    box_idx = ious[max_idx].argmax()
                    ious[max_idx, :] = -1
                    ious[:, box_idx] = -1
            tmp = np.hstack((tmp, gt_ious))
        ious_list.append(tmp)
    all_flat = np.array(ious_list)
    recalls = np.zeros((len(proposal_nums), len(thrs)))
    for i, thr in enumerate(thrs):
        recalls[:, i] = ((all_flat >= thr).sum(axis=1)
                         / float(max(total_gt_num, 1)))
    return recalls


def eval_recalls(gts, proposals, proposal_nums=None, iou_thrs=None,
                 print_summary: bool = True):
    """Recalls (len(proposal_nums), len(iou_thrs)) of ``proposals`` (per
    image (n, 4), or (n, 5) sorted by their score) against ``gts`` (per
    image (m, 4)); ``proposal_nums`` default (100, 300, 1000), ``iou_thrs``
    0.5."""
    if iou_thrs is None:
        iou_thrs = np.array([0.5])
    elif np.isscalar(iou_thrs):
        iou_thrs = np.array([iou_thrs])
    else:
        iou_thrs = np.asarray(iou_thrs)
    if proposal_nums is None:
        proposal_nums = np.array([100, 300, 1000])
    else:
        proposal_nums = np.atleast_1d(np.asarray(proposal_nums))
    if len(gts) != len(proposals):
        raise ValueError(f"{len(gts)} images of ground truth, "
                         f"{len(proposals)} of proposals")
    all_ious = []
    for gt, prop in zip(gts, proposals):
        if prop.ndim == 2 and prop.shape[1] == 5:
            prop = prop[np.argsort(-prop[:, 4])][:, :4]
        prop = prop[:proposal_nums[-1]]
        all_ious.append(bbox_overlaps_np(gt, prop) if gt.size and prop.size
                        else np.zeros((gt.shape[0], prop.shape[0]),
                                      np.float32))
    recalls = _recalls(all_ious, proposal_nums, iou_thrs)
    if print_summary:
        print("proposal recall:")
        for i, num in enumerate(proposal_nums):
            row = " ".join(f"{recalls[i, j]:.4f}"
                           for j in range(len(iou_thrs)))
            print(f"  @{num}: {row}")
    return recalls
