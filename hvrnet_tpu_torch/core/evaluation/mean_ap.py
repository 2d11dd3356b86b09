"""mAP evaluation, host numpy (counterpart of
``hvrnet_tpu/core/evaluation/mean_ap.py``, the same arithmetic line for
line, held equal to it by the tests):
  * `average_precision`, 'area' and '11points' modes;
  * `tpfp_default`: fixed IoU-threshold matching with ignore regions and
    scale ranges;
  * `tpfp_imagenet`: per-GT adaptive IoU thresholds
    min(wh/((w+10)(h+10)), thr) with a GT−1-pixel offset;
  * `eval_map` and `print_map_summary`;
  * `tpfp_analysis` / `analysis_map`: the confusion-analysis variant.

A class-name tuple as ``dataset`` selects `tpfp_default` (what
``tools/vid_eval.py`` passes); the strings 'det' / 'vid' select
`tpfp_imagenet`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def bbox_overlaps_np(b1: np.ndarray, b2: np.ndarray, mode: str = "iou") -> np.ndarray:
    """+1-convention pairwise IoU/IoF, (M,4)x(N,4) → (M,N)."""
    if b1.shape[0] == 0 or b2.shape[0] == 0:
        return np.zeros((b1.shape[0], b2.shape[0]), np.float32)
    b1 = b1.astype(np.float32)
    b2 = b2.astype(np.float32)
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:4], b2[None, :, 2:4])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[:, 2] - b1[:, 0] + 1) * (b1[:, 3] - b1[:, 1] + 1)
    a2 = (b2[:, 2] - b2[:, 0] + 1) * (b2[:, 3] - b2[:, 1] + 1)
    if mode == "iou":
        denom = a1[:, None] + a2[None, :] - inter
    else:
        denom = a1[:, None]
    return inter / np.maximum(denom, np.finfo(np.float32).eps)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> np.ndarray:
    """AP from PR points (mmdet mean_ap.py:9-55).

    Deliberate divergence: in '11points' mode mmdet divides
    ``ap /= 11`` INSIDE its per-scale loop (mean_ap.py:41-46), so with
    num_scales > 1 every scale after the first gets divided repeatedly —
    a bug.  We divide once after the loop (correct 11-point VOC AP).  The
    VID protocol always evaluates with mode='area', so no shipped result
    is affected; flagged here because this repo otherwise preserves
    reference quirks.
    """
    no_scale = recalls.ndim == 1
    if no_scale:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == "area":
        # pad each PR curve to recall endpoints 0/1 (precision 0 at both),
        # take the running max from the right so precision is monotone
        # non-increasing, then integrate over the recall jumps — must stay
        # numerically identical to the canonical VOC-area routine the
        # mmdet evaluates with (mean_ap.py:24-35)
        pad_lo = np.zeros((num_scales, 1), recalls.dtype)
        pad_hi = np.ones((num_scales, 1), recalls.dtype)
        rec = np.hstack((pad_lo, recalls, pad_hi))
        prec = np.hstack((pad_lo, precisions, pad_lo))
        prec = np.flip(np.maximum.accumulate(np.flip(prec, axis=1), axis=1),
                       axis=1)
        for s in range(num_scales):
            jumps = np.flatnonzero(np.diff(rec[s]) != 0)
            ap[s] = np.sum((rec[s, jumps + 1] - rec[s, jumps])
                           * prec[s, jumps + 1])
    elif mode == "11points":
        for s in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[s, recalls[s, :] >= thr]
                ap[s] += precs.max() if precs.size else 0
        ap /= 11
    else:
        raise ValueError('mode must be "area" or "11points"')
    return ap[0] if no_scale else ap


def _sorted_by_score(det: np.ndarray):
    order = np.argsort(-det[:, -1])
    return det[order]


def tpfp_default(det_bboxes: np.ndarray, gt_bboxes: np.ndarray,
                 gt_ignore: Optional[np.ndarray], iou_thr: float,
                 area_ranges=None):
    """Fixed-threshold TP/FP marking (mmdet mean_ap.py:376-473)."""
    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    if area_ranges is None:
        area_ranges = [(None, None)]
    num_scales = len(area_ranges)
    tp = np.zeros((num_scales, num_dets), np.float32)
    fp = np.zeros((num_scales, num_dets), np.float32)
    if gt_ignore is None:
        gt_ignore = np.zeros(num_gts, bool)

    if num_gts == 0:
        for i, (min_a, max_a) in enumerate(area_ranges):
            if min_a is None:
                fp[i] = 1
            else:
                a = ((det_bboxes[:, 2] - det_bboxes[:, 0] + 1)
                     * (det_bboxes[:, 3] - det_bboxes[:, 1] + 1))
                fp[i, (a >= min_a) & (a < max_a)] = 1
        return tp, fp

    ious = bbox_overlaps_np(det_bboxes[:, :4], gt_bboxes)
    ious_max = ious.max(axis=1) if num_gts else np.zeros(num_dets)
    ious_argmax = ious.argmax(axis=1) if num_gts else np.zeros(num_dets, int)
    order = np.argsort(-det_bboxes[:, -1])
    for k, (min_a, max_a) in enumerate(area_ranges):
        covered = np.zeros(num_gts, bool)
        if min_a is None:
            gt_area_ignore = np.zeros_like(gt_ignore)
        else:
            a = ((gt_bboxes[:, 2] - gt_bboxes[:, 0] + 1)
                 * (gt_bboxes[:, 3] - gt_bboxes[:, 1] + 1))
            gt_area_ignore = (a < min_a) | (a >= max_a)
        for i in order:
            if ious_max[i] >= iou_thr:
                j = ious_argmax[i]
                if not (gt_ignore[j] or gt_area_ignore[j]):
                    if not covered[j]:
                        covered[j] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
                # det matched to an ignored gt: neither tp nor fp
            elif min_a is None:
                fp[k, i] = 1
            else:
                a = ((det_bboxes[i, 2] - det_bboxes[i, 0] + 1)
                     * (det_bboxes[i, 3] - det_bboxes[i, 1] + 1))
                if min_a <= a < max_a:
                    fp[k, i] = 1
    return tp, fp


def tpfp_imagenet(det_bboxes: np.ndarray, gt_bboxes: np.ndarray,
                  gt_ignore: Optional[np.ndarray], default_iou_thr: float,
                  area_ranges=None):
    """ImageNet-style adaptive-threshold matching (mmdet mean_ap.py:56-135).

    Per-GT threshold = min(default, wh/((w+10)(h+10))) with a −1 pixel GT
    offset; the det is matched to the gt with the LARGEST iou-vs-threshold
    margin.
    """
    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    if area_ranges is None:
        area_ranges = [(None, None)]
    num_scales = len(area_ranges)
    tp = np.zeros((num_scales, num_dets), np.float32)
    fp = np.zeros((num_scales, num_dets), np.float32)
    if gt_ignore is None:
        gt_ignore = np.zeros(num_gts, bool)
    if num_gts == 0:
        for i, (min_a, max_a) in enumerate(area_ranges):
            if min_a is None:
                fp[i] = 1
            else:
                a = ((det_bboxes[:, 2] - det_bboxes[:, 0] + 1)
                     * (det_bboxes[:, 3] - det_bboxes[:, 1] + 1))
                fp[i, (a >= min_a) & (a < max_a)] = 1
        return tp, fp

    ious = bbox_overlaps_np(det_bboxes[:, :4], gt_bboxes - 1)
    gt_w = gt_bboxes[:, 2] - gt_bboxes[:, 0] + 1
    gt_h = gt_bboxes[:, 3] - gt_bboxes[:, 1] + 1
    iou_thrs = np.minimum((gt_w * gt_h) / ((gt_w + 10.0) * (gt_h + 10.0)),
                          default_iou_thr)
    order = np.argsort(-det_bboxes[:, -1])
    for k, (min_a, max_a) in enumerate(area_ranges):
        covered = np.zeros(num_gts, bool)
        if min_a is None:
            gt_area_ignore = np.zeros_like(gt_ignore)
        else:
            gt_area_ignore = ((gt_w * gt_h) < min_a) | ((gt_w * gt_h) >= max_a)
        for i in order:
            max_iou = -1.0
            matched = -1
            # Unlike PASCAL VOC, a det may match another uncovered gt when
            # the best-overlapped one is already taken (mmdet
            # mean_ap.py:113-116);
            # ignored gts ARE matchable and then count as neither tp nor fp.
            for j in range(num_gts):
                if covered[j]:
                    continue
                if ious[i, j] >= iou_thrs[j] and ious[i, j] > max_iou:
                    max_iou = ious[i, j]
                    matched = j
            if matched >= 0:
                covered[matched] = True
                if not (gt_ignore[matched] or gt_area_ignore[matched]):
                    tp[k, i] = 1
            elif min_a is None:
                fp[k, i] = 1
            else:
                a = ((det_bboxes[i, 2] - det_bboxes[i, 0] + 1)
                     * (det_bboxes[i, 3] - det_bboxes[i, 1] + 1))
                if min_a <= a < max_a:
                    fp[k, i] = 1
    return tp, fp


def get_cls_results(det_results, gt_bboxes, gt_labels, gt_ignore, class_id: int):
    """Pull one class's dets/gts across images (mmdet mean_ap.py:440-473)."""
    cls_dets = [det[class_id] for det in det_results]
    cls_gts, cls_gt_ignore = [], []
    for j in range(len(gt_bboxes)):
        gt_bbox = gt_bboxes[j]
        cls_inds = gt_labels[j] == class_id + 1
        cls_gts.append(gt_bbox[cls_inds, :] if gt_bbox.shape[0] > 0
                       else np.zeros((0, 4), np.float32))
        if gt_ignore is None:
            cls_gt_ignore.append(np.zeros(int(cls_inds.sum()), bool))
        else:
            cls_gt_ignore.append(gt_ignore[j][cls_inds])
    return cls_dets, cls_gts, cls_gt_ignore


def eval_map(det_results, gt_bboxes, gt_labels, scale_ranges=None,
             iou_thr: float = 0.5, dataset=None, print_summary: bool = True,
             gt_ignore=None):
    """Mean AP over classes (mmdet mean_ap.py:475-586).

    det_results: list (images) of list (classes) of (n, 5) arrays.
    Returns (mAP, per-class eval dicts).
    """
    assert len(det_results) == len(gt_bboxes) == len(gt_labels)
    num_classes = len(det_results[0])
    area_ranges = ([(r[0] ** 2, r[1] ** 2) for r in scale_ranges]
                   if scale_ranges is not None else None)
    num_scales = len(scale_ranges) if scale_ranges is not None else 1
    eval_results = []
    use_imagenet = dataset in ("det", "vid")
    for i in range(num_classes):
        cls_dets, cls_gts, cls_gt_ignore = get_cls_results(
            det_results, gt_bboxes, gt_labels, gt_ignore, i)
        tpfp_fn = tpfp_imagenet if use_imagenet else tpfp_default
        tpfp = [tpfp_fn(cls_dets[j], cls_gts[j], cls_gt_ignore[j], iou_thr,
                        area_ranges) for j in range(len(cls_dets))]
        tps, fps = tuple(zip(*tpfp))
        num_gts = np.zeros(num_scales, int)
        for j, bbox in enumerate(cls_gts):
            if area_ranges is None:
                num_gts[0] += int(np.sum(np.logical_not(cls_gt_ignore[j])))
            else:
                gt_areas = ((bbox[:, 2] - bbox[:, 0] + 1)
                            * (bbox[:, 3] - bbox[:, 1] + 1))
                for k, (min_a, max_a) in enumerate(area_ranges):
                    num_gts[k] += int(np.sum(
                        np.logical_not(cls_gt_ignore[j])
                        & (gt_areas >= min_a) & (gt_areas < max_a)))
        cls_dets_all = np.vstack(cls_dets)
        num_dets = cls_dets_all.shape[0]
        sort_inds = np.argsort(-cls_dets_all[:, -1])
        tp = np.hstack(tps)[:, sort_inds]
        fp = np.hstack(fps)[:, sort_inds]
        tp = np.cumsum(tp, axis=1)
        fp = np.cumsum(fp, axis=1)
        eps = np.finfo(np.float32).eps
        recalls = tp / np.maximum(num_gts[:, None], eps)
        precisions = tp / np.maximum(tp + fp, eps)
        if scale_ranges is None:
            recalls = recalls[0, :]
            precisions = precisions[0, :]
            num_gts = num_gts.item()
        mode = ("11points" if dataset == "voc07" else "area")
        ap = average_precision(recalls, precisions, mode)
        eval_results.append(dict(num_gts=num_gts, num_dets=num_dets,
                                 recall=recalls, precision=precisions, ap=ap))
    if scale_ranges is not None:
        all_ap = np.vstack([res["ap"] for res in eval_results])
        all_num_gts = np.vstack([res["num_gts"] for res in eval_results])
        mean_ap = [all_ap[all_num_gts[:, i] > 0, i].mean()
                   if np.any(all_num_gts[:, i] > 0) else 0.0
                   for i in range(num_scales)]
    else:
        aps = [res["ap"] for res in eval_results if res["num_gts"] > 0]
        mean_ap = float(np.mean(aps)) if aps else 0.0
    if print_summary:
        print_map_summary(mean_ap, eval_results, dataset)
    return mean_ap, eval_results


def print_map_summary(mean_ap, results, dataset=None):
    """Per-class table (mmdet mean_ap.py:588+, plain text instead of
    terminaltables)."""
    num_classes = len(results)
    if dataset is None:
        label_names = [str(i) for i in range(num_classes)]
    elif isinstance(dataset, (list, tuple)):
        label_names = list(dataset)
    else:
        label_names = [str(i) for i in range(num_classes)]
    header = f"{'class':>14} {'gts':>7} {'dets':>7} {'recall':>7} {'ap':>7}"
    print(header)
    for i, res in enumerate(results):
        recall = (res["recall"][-1] if np.ndim(res["recall"]) and
                  len(np.atleast_1d(res["recall"])) else 0.0)
        name = label_names[i] if i < len(label_names) else str(i)
        print(f"{name:>14} {res['num_gts']!s:>7} {res['num_dets']:>7} "
              f"{float(np.atleast_1d(recall)[-1]) if res['num_dets'] else 0:>7.3f} "
              f"{float(np.atleast_1d(res['ap'])[0]):>7.3f}")
    print(f"{'mAP':>14} {'':>7} {'':>7} {'':>7} "
          f"{(mean_ap if np.isscalar(mean_ap) else np.mean(mean_ap)):>7.3f}")


def tpfp_analysis(det_bboxes, gt_bboxes, other_gts, gt_ignore, iou_thr,
                  area_ranges=None):
    """TP/FP split by confusion source (mmdet mean_ap.py:136-228): FP
    that overlap another class's GT above thr are flagged 'confusion'."""
    num_dets = det_bboxes.shape[0]
    tp, fp = tpfp_default(det_bboxes, gt_bboxes, gt_ignore, iou_thr, area_ranges)
    confusion = np.zeros_like(fp)
    if num_dets and other_gts.shape[0]:
        ious = bbox_overlaps_np(det_bboxes[:, :4], other_gts)
        conf = (ious.max(axis=1) >= iou_thr) & (fp[0] > 0)
        confusion[0, conf] = 1
    return tp, fp, confusion


def analysis_map(det_results, gt_bboxes, gt_labels, scale_ranges=None,
                 iou_thr: float = 0.5, dataset=None, file_dir: str = ".",
                 print_summary: bool = True, gt_ignore=None):
    """Per-class confusion analysis (mmdet mean_ap.py:229-373): eval_map plus a
    count of false positives explained by other-class GT overlap, written to
    `<file_dir>/analysis_map.txt`."""
    import os.path as osp
    mean_ap, results = eval_map(det_results, gt_bboxes, gt_labels,
                                scale_ranges, iou_thr, dataset,
                                print_summary=False, gt_ignore=gt_ignore)
    num_classes = len(det_results[0])
    lines = []
    for i in range(num_classes):
        cls_dets, cls_gts, cls_gt_ignore = get_cls_results(
            det_results, gt_bboxes, gt_labels, gt_ignore, i)
        n_conf = 0
        for j in range(len(cls_dets)):
            other = (gt_bboxes[j][gt_labels[j] != i + 1]
                     if gt_bboxes[j].shape[0] else np.zeros((0, 4), np.float32))
            _, _, conf = tpfp_analysis(cls_dets[j], cls_gts[j], other,
                                       cls_gt_ignore[j], iou_thr)
            n_conf += int(conf.sum())
        name = (dataset[i] if isinstance(dataset, (list, tuple))
                and i < len(dataset) else str(i))
        lines.append(f"{name}: ap={float(np.atleast_1d(results[i]['ap'])[0]):.4f} "
                     f"confused_fp={n_conf}")
    out_path = osp.join(file_dir, "analysis_map.txt")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + f"\nmAP: {mean_ap}\n")
    if print_summary:
        print("\n".join(lines))
        print(f"mAP: {mean_ap}")
    return mean_ap, results
