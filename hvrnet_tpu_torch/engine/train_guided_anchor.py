"""Guided-anchoring training (counterpart of
``hvrnet_tpu/engine/train_guided_anchor.py``): the location and shape
targets and ``GATrainer``, GA-RetinaNet's objective on ``RetinaTrainer``'s
plumbing.

* **Location** (``ga_loc_targets``, mmdet ``guided_anchor_target.py:32-131``):
  each ground truth goes to the level ``floor(log2(sqrt((w + 1)(h + 1))) −
  log2(octave_base_scale · s₀) + 0.5)``, clipped, and there paints its
  centre region (``center_ratio``: target 1, weight 1) inside its ignore
  region (``ignore_ratio``: weight 0), and its ignore region on the two
  adjacent levels (weight 0); elsewhere weight 0.1.  Where regions of
  several ground truths meet, centre wins over ignore, ignore over
  adjacent ignore, and that over negative (the JAX package's priority in
  place of mmdet's painting order).  The regions' corners are rounded half
  to even.  Focal loss per level, weighted, over Σ(h·w) / 200.
* **Shape** (``ga_shape_target_single``): the squares
  (``AnchorGenerator(s, (octave,), (1.0,))``) take each ground truth's
  largest IoU over their group of approx anchors (RetinaNet's scales and
  ratios at the square's position), then the max-IoU rules
  (``train_cfg.ga_assigner``) over the canvas's squares of every level;
  the bounded-IoU loss of the guided anchors (``delta2bbox(square, [0, 0,
  dw, dh], anchoring means and stds, wh_ratio_clip=1e-6)``) at the
  positives, over their count.
* **Classification and boxes**: RetinaNet's focal and smooth-L1 losses
  (``loss_bbox.beta``, default 1/9) on the detached guided anchors,
  assigned by ``train_cfg.assigner``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.targets import max_iou_assign
from ..models.losses import BoundedIoULoss, sigmoid_focal_loss, smooth_l1
from ..ops.anchors import AnchorGenerator
from ..ops.boxes import bbox2delta, bbox_overlaps, delta2bbox
from .single_stage import flat
from .train_single_stage import RetinaTrainer

DEFAULT_ASSIGNER = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)


def _calc_region(gt: torch.Tensor, ratio: float, fh: int, fw: int):
    """mmdet ``calc_region`` of (G, 4) boxes in feature coordinates: the
    (x1, y1, x2, y2) corners, each (G,), rounded and clipped to the map."""
    r = 1 - ratio
    x1 = torch.round(r * gt[:, 0] + ratio * gt[:, 2]).clamp(0, fw - 1)
    y1 = torch.round(r * gt[:, 1] + ratio * gt[:, 3]).clamp(0, fh - 1)
    x2 = torch.round(ratio * gt[:, 0] + r * gt[:, 2]).clamp(0, fw - 1)
    y2 = torch.round(ratio * gt[:, 1] + r * gt[:, 3]).clamp(0, fh - 1)
    return x1, y1, x2, y2


def ga_loc_targets(gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
                   featmap_sizes: Sequence[Tuple[int, int]],
                   strides: Sequence[int], octave_base_scale: int,
                   center_ratio: float = 0.2, ignore_ratio: float = 0.5):
    """One image's location targets (the module docstring): (targets,
    weights), each a list of (h·w,) float32 per level, and the loss's
    average factor."""
    n_lvls = len(featmap_sizes)
    r1 = (1 - center_ratio) / 2
    r2 = (1 - ignore_ratio) / 2
    scale = torch.sqrt((gt_bboxes[:, 2] - gt_bboxes[:, 0] + 1)
                       * (gt_bboxes[:, 3] - gt_bboxes[:, 1] + 1))
    min_sz = float(octave_base_scale * strides[0])
    tl = torch.floor(torch.log2(scale.clamp_min(1e-6))
                     - np.float32(np.log2(min_sz)) + 0.5)
    lvls = tl.clamp(0, n_lvls - 1).to(torch.int64)
    dev = gt_bboxes.device
    targets, weights = [], []
    for lvl, (fh, fw) in enumerate(featmap_sizes):
        yy = torch.arange(fh, dtype=torch.float32, device=dev)[None, :, None]
        xx = torch.arange(fw, dtype=torch.float32, device=dev)[None, None, :]

        def regions(ratio, on):
            x1, y1, x2, y2 = (c[:, None, None] for c in _calc_region(
                gt_bboxes[:, :4] / strides[lvl], ratio, fh, fw))
            inside = (yy >= y1) & (yy <= y2) & (xx >= x1) & (xx <= x2)
            return (inside & on[:, None, None]).any(dim=0)

        on_lvl = (lvls == lvl) & gt_mask
        ctr = regions(r1, on_lvl)
        ign = regions(r2, on_lvl)
        adj = regions(r2, gt_mask & ((lvls == lvl + 1) | (lvls == lvl - 1)))
        w = torch.where(ctr, 1.0, torch.where(ign | adj, 0.0, 0.1))
        targets.append(ctr.float().reshape(-1))
        weights.append(w.reshape(-1))
    return targets, weights, sum(h * w for h, w in featmap_sizes) / 200.0


def ga_shape_target_single(approxs: torch.Tensor, squares: torch.Tensor,
                           inside: torch.Tensor, gt_bboxes: torch.Tensor,
                           gt_mask: torch.Tensor, approxs_per_octave: int,
                           pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                           min_pos_iou: float = 0.0):
    """One image's shape targets (the module docstring): (the assigned
    boxes (S, 4), 0 off the positives; positive weights (S,) float32; the
    positive count, at least 1)."""
    S = squares.shape[0]
    ov = bbox_overlaps(gt_bboxes[:, :4], approxs)
    ov = ov.reshape(ov.shape[0], S, approxs_per_octave).max(dim=2).values
    ov = torch.where(gt_mask[:, None] & inside[None, :], ov, -1.0)
    ar = max_iou_assign(squares, gt_bboxes, gt_mask, None, pos_iou_thr,
                        neg_iou_thr, min_pos_iou, box_mask=inside,
                        overlaps=ov)
    pos = ar.gt_inds > 0
    gi = (ar.gt_inds - 1).clamp_min(0)
    bbox_gts = torch.where(pos[:, None], gt_bboxes[gi][:, :4], 0.0)
    return bbox_gts, pos.float(), pos.sum().clamp_min(1)


class GATrainer(RetinaTrainer):
    """GA-RetinaNet's objective: location, shape, and RetinaNet's losses on
    the guided anchors (the module docstring)."""

    def generators(self, canvas_hw):
        """The canvas's per-level (h, w), strides, octave base scale, approx
        anchors per square, and the approxs and squares of every level,
        concatenated (on the device, made once per canvas)."""
        head = self.head_cfg
        strides = tuple(head.get("anchor_strides", (8, 16, 32, 64, 128)))
        ratios = tuple(head.get("octave_ratios",
                                head.get("anchor_ratios", (0.5, 1.0, 2.0))))
        octave = int(head.get("octave_base_scale", 8))
        spo = int(head.get("scales_per_octave", 3))
        scales = tuple(octave * 2 ** (i / spo) for i in range(spo))
        h, w = canvas_hw
        sizes = [(-(-h // s), -(-w // s)) for s in strides]

        def grids(scales, ratios):
            return np.concatenate([AnchorGenerator(s, scales, ratios)
                                   .grid_anchors(hw, s)
                                   for s, hw in zip(strides, sizes)])

        key = ("ga", tuple(canvas_hw), strides)
        return (sizes, strides, octave, len(scales) * len(ratios),
                self.engine._grid(key + ("approxs",),
                                  lambda: grids(scales, ratios)),
                self.engine._grid(key + ("squares",),
                                  lambda: grids((octave,), (1.0,))))

    def losses(self, outs, gt, s):
        eng = self.engine
        head = self.head_cfg
        tcfg = eng.train_cfg or {}
        cls_maps, reg_maps, shape_maps, loc_maps = outs
        sizes, strides, octave, opo, approxs, squares = self.generators(
            s["imgs"].shape[1:3])
        gt_b, gt_m, gt_l = gt["gt_bboxes"], gt["gt_mask"], gt["gt_labels"]

        loc_t, loc_w, loc_avg = ga_loc_targets(
            gt_b, gt_m, sizes, strides, octave,
            float(tcfg.get("center_ratio", 0.2)),
            float(tcfg.get("ignore_ratio", 0.5)))
        loc_weight = float((head.get("loss_loc") or {}).get("loss_weight",
                                                           1.0))
        loss_loc = sum(loc_weight * (sigmoid_focal_loss(
            flat(m, 1), t.to(torch.int64))[:, 0] * w).sum() / loc_avg
            for m, t, w in zip(loc_maps, loc_t, loc_w))

        allowed = float(tcfg.get("allowed_border", -1))
        if allowed < 0:
            inside = torch.ones_like(squares[:, 0], dtype=torch.bool)
        else:
            h, w = (float(np.float32(v))
                    for v in np.asarray(s["img_shape"])[:2])
            inside = ((squares[:, 0] >= -allowed)
                      & (squares[:, 1] >= -allowed)
                      & (squares[:, 2] < w + allowed)
                      & (squares[:, 3] < h + allowed))
        ga = tcfg.get("ga_assigner", DEFAULT_ASSIGNER)
        bbox_gts, pos_w, fg_num = ga_shape_target_single(
            approxs, squares, inside, gt_b, gt_m, opo,
            float(ga["pos_iou_thr"]), float(ga["neg_iou_thr"]),
            float(ga["min_pos_iou"]))
        shape = torch.cat([flat(m, 2) for m in shape_maps])
        pred_anchors = delta2bbox(
            squares, torch.cat([torch.zeros_like(shape), shape], 1),
            tuple(head.get("anchoring_means", (0., 0., 0., 0.))),
            tuple(head.get("anchoring_stds", (1., 1., 1., 1.))),
            wh_ratio_clip=1e-6)
        shape_cfg = head.get("loss_shape") or {}
        loss_shape = BoundedIoULoss(
            beta=float(shape_cfg.get("beta", 0.2)),
            loss_weight=float(shape_cfg.get("loss_weight", 1.0)),
            reduction="sum")(pred_anchors, bbox_gts,
                             weight=pos_w[:, None].expand(-1, 4)) \
            / fg_num.float().clamp_min(1.0)

        anchors = pred_anchors.detach()
        logits = torch.cat([flat(c, self.fg) for c in cls_maps])
        deltas = torch.cat([flat(r, 4) for r in reg_maps])
        acfg = tcfg.get("assigner", DEFAULT_ASSIGNER)
        ar = max_iou_assign(anchors, gt_b, gt_m, gt_l,
                            float(acfg["pos_iou_thr"]),
                            float(acfg["neg_iou_thr"]),
                            float(acfg["min_pos_iou"]), box_mask=inside)
        pos = (ar.gt_inds > 0).float()
        valid = (ar.gt_inds >= 0).float()
        num_pos = pos.sum().clamp_min(1.0)
        loss_cls = (sigmoid_focal_loss(logits, ar.labels).sum(-1)
                    * valid).sum() / num_pos
        t = bbox2delta(anchors, gt_b[(ar.gt_inds - 1).clamp_min(0)][:, :4],
                       eng.target_means, eng.target_stds)
        beta = float((head.get("loss_bbox") or {}).get("beta", 1.0 / 9.0))
        loss_bbox = (smooth_l1(deltas, t, beta).sum(-1) * pos).sum() / num_pos
        return loss_cls + loss_bbox + loss_loc + loss_shape, dict(
            loss_cls=loss_cls, loss_bbox=loss_bbox, loss_loc=loss_loc,
            loss_shape=loss_shape, num_pos=num_pos)
