"""The single-stage detectors' training (counterpart of
``hvrnet_tpu/engine/train_single_stage.py``): RetinaNet's objective
(``RetinaTrainer``), FreeAnchor's (``free_anchor_loss``,
``FreeAnchorTrainer``) and SSD's (``SSDTrainer``), on the plumbing every
dense trainer shares (``DenseTrainer``; FCOS and FoveaBox in
``engine/train_fcos.py``).

One step on one still image (``still_image``): the backbone from
``layer2`` and the neck with gradient, the dense head ("head"), the
objective on the flattened levels ("loss"), backward, the global-norm clip
and SGD.  The objectives read what the JAX trainers read and no more:

* RetinaNet: max-IoU assignment (``train_cfg.assigner``) of the anchors of
  the canvas (``-(-H // s)`` × ``-(-W // s)`` per level) inside the image
  by ``allowed_border`` (< 0: all), no sampling; sigmoid focal loss at γ 2,
  α 0.25 over the non-ignored anchors and smooth-L1 at β 1/9 on the
  positives, both divided by #pos (at least 1), whatever the config's
  ``loss_cls`` / ``loss_bbox`` say;
* FreeAnchor: the head's ``pre_anchor_topk``, ``bbox_thr``, ``gamma``,
  ``alpha`` and its ``loss_bbox`` β and weight, on the same anchors;
* SSD: ``ssd_targets_and_loss`` (``engine/train_mask.py``) on the anchors
  of the maps' own shapes, ``train_cfg.neg_pos_ratio`` and
  ``smoothl1_beta``.

Without ``optimizer`` / ``lr_config`` keys a dense trainer takes the JAX
trainers' defaults: lr 0.01, momentum 0.9, decay 1e-4, steps at epochs 8
and 11 after 500 warmup steps.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.targets import max_iou_assign
from ..models.losses import sigmoid_focal_loss, smooth_l1
from ..ops.boxes import bbox2delta, bbox_overlaps, delta2bbox
from .single_stage import SingleStageEngine, flat
from .train import BaseTrainer, still_image
from .train_mask import ssd_targets_and_loss


class DenseTrainer(BaseTrainer):
    """A single-stage engine's step: ``losses(outs, gt, sample)`` of the
    head's outputs is the objective."""

    default_optimizer = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)
    default_lr_config = dict(step=[8, 11], warmup_iters=500,
                             warmup_ratio=1.0 / 3)

    def __init__(self, engine, cfg, steps_per_epoch: int = 1000,
                 seed: int = 0):
        if not isinstance(engine, SingleStageEngine):
            raise TypeError(f"{type(self).__name__} trains a "
                            "SingleStageEngine")
        super().__init__(engine, cfg, steps_per_epoch, seed)
        self.head_cfg = engine.model_cfg["bbox_head"]
        self.fg = engine.num_classes - 1

    def backbone(self, sample: Dict[str, Any]):
        return super().backbone(still_image(sample))

    def loss_from_c4(self, feats, sample: Dict[str, Any], noise=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, logs) of one step from the image's tuple of maps
        (the neck's, or the backbone's); the dense objectives draw no
        noise."""
        eng = self.engine
        s = still_image(sample)
        gt = {k: torch.as_tensor(np.asarray(s[k]), device=eng.device)
              for k in ("gt_bboxes", "gt_labels", "gt_mask")}
        with self._phase("head"):
            outs = eng.model.bbox_head(feats)
        with self._phase("loss"):
            return self.losses(outs, gt, s)

    def losses(self, outs, gt, s):
        raise NotImplementedError

    def canvas_anchors(self, canvas_hw) -> torch.Tensor:
        """RetinaNet's anchors of a canvas: per level the
        ``-(-H // s)`` × ``-(-W // s)`` grid, concatenated."""
        h, w = canvas_hw
        strides = tuple(self.head_cfg.get("anchor_strides",
                                          (8, 16, 32, 64, 128)))
        return torch.cat([self.engine.level_anchors(-(-h // st), -(-w // st),
                                                    lvl)
                          for lvl, st in enumerate(strides)])


class RetinaTrainer(DenseTrainer):
    """RetinaNet's focal-loss objective (the module docstring)."""

    def losses(self, outs, gt, s):
        eng = self.engine
        cls_maps, reg_maps = outs
        anchors = self.canvas_anchors(s["imgs"].shape[1:3])
        logits = torch.cat([flat(c, self.fg) for c in cls_maps])
        deltas = torch.cat([flat(r, 4) for r in reg_maps])
        tcfg = eng.train_cfg or {}
        acfg = tcfg.get("assigner", dict(pos_iou_thr=0.5, neg_iou_thr=0.4,
                                         min_pos_iou=0.0))
        border = float(tcfg.get("allowed_border", 0))
        h, w = (float(np.float32(v)) for v in np.asarray(s["img_shape"])[:2])
        if border < 0:
            inside = torch.ones_like(anchors[:, 0], dtype=torch.bool)
        else:
            inside = ((anchors[:, 0] >= -border) & (anchors[:, 1] >= -border)
                      & (anchors[:, 2] < w + border)
                      & (anchors[:, 3] < h + border))
        ar = max_iou_assign(anchors, gt["gt_bboxes"], gt["gt_mask"],
                            gt["gt_labels"], float(acfg["pos_iou_thr"]),
                            float(acfg["neg_iou_thr"]),
                            float(acfg["min_pos_iou"]), box_mask=inside)
        pos = (ar.gt_inds > 0).float()
        valid = (ar.gt_inds >= 0).float()
        num_pos = pos.sum().clamp_min(1.0)
        loss_cls = (sigmoid_focal_loss(logits, ar.labels).sum(-1)
                    * valid).sum() / num_pos
        gi = (ar.gt_inds - 1).clamp_min(0)
        t = bbox2delta(anchors, gt["gt_bboxes"][gi][:, :4], eng.target_means,
                       eng.target_stds)
        loss_bbox = (smooth_l1(deltas, t, 1.0 / 9.0).sum(-1)
                     * pos).sum() / num_pos
        return loss_cls + loss_bbox, dict(loss_cls=loss_cls,
                                          loss_bbox=loss_bbox,
                                          num_pos=num_pos)


def free_anchor_loss(cls_prob: torch.Tensor, bbox_preds: torch.Tensor,
                     anchors: torch.Tensor, gt_bboxes: torch.Tensor,
                     gt_mask: torch.Tensor, gt_labels: torch.Tensor,
                     num_fg_classes: int,
                     target_means=(0., 0., 0., 0.),
                     target_stds=(0.1, 0.1, 0.2, 0.2),
                     pre_anchor_topk: int = 50, bbox_thr: float = 0.6,
                     gamma: float = 2.0, alpha: float = 0.5,
                     smoothl1_beta: float = 0.11,
                     bbox_loss_weight: float = 0.75):
    """FreeAnchor's detection-customized likelihood for one image (mmdet
    ``free_anchor_retina_head.py:35-188``) over fixed ground-truth slots
    with a validity mask, as the JAX function has it.

    cls_prob: (A, C) sigmoid class probabilities; bbox_preds: (A, 4);
    anchors: (A, 4); gt_labels 1-based.  The anchor-box probability comes
    from the detached predicted boxes, and the per-class image box
    probability (a max over the class's ground truths, 0 for a class
    without one; invalid slots fall out) is detached as well.  Each ground
    truth's bag is its ``pre_anchor_topk`` anchors of highest IoU (ties to
    the lower anchor, as ``lax.top_k``).  Returns (positive bag loss sum,
    negative bag loss sum, #valid ground truths): the trainer divides them
    by max(1, #pos) and max(1, #pos)·K."""
    A, C, K = anchors.shape[0], num_fg_classes, pre_anchor_topk
    labels0 = (gt_labels.long() - 1).clamp_min(0)
    gt_valid = gt_mask.to(cls_prob.dtype)
    with torch.no_grad():
        pred_boxes = delta2bbox(anchors, bbox_preds, target_means,
                                target_stds)
        obj_iou = bbox_overlaps(gt_bboxes[:, :4], pred_boxes) \
            * gt_valid[:, None]
        t2 = obj_iou.max(dim=1, keepdim=True).values.clamp_min(
            bbox_thr + 1e-12)
        obj_box_prob = ((obj_iou - bbox_thr) / (t2 - bbox_thr)).clamp(
            0.0, 1.0) * gt_valid[:, None]
        seg = torch.where(gt_mask, labels0, C)
        image_box_prob = obj_box_prob.new_full(
            (C + 1, A), float("-inf")).scatter_reduce(
                0, seg[:, None].expand(-1, A), obj_box_prob, "amax")[:C]
        image_box_prob = image_box_prob.clamp_min(0.0).T        # (A, C)
        anchor_iou = bbox_overlaps(gt_bboxes[:, :4], anchors)
        anchor_iou = torch.where(gt_mask[:, None], anchor_iou, -1.0)
        matched = torch.sort(anchor_iou, dim=1, descending=True,
                             stable=True).indices[:, :K]        # (G, K)
    matched_cls_prob = torch.gather(
        cls_prob[matched], 2, labels0[:, None, None].expand(-1, K, 1))[..., 0]
    matched_anchors = anchors[matched]                          # (G, K, 4)
    tgt = bbox2delta(matched_anchors.reshape(-1, 4),
                     gt_bboxes[:, :4].repeat_interleave(K, dim=0),
                     target_means, target_stds).reshape(matched_anchors.shape)
    l1 = bbox_loss_weight * smooth_l1(bbox_preds[matched], tgt,
                                      smoothl1_beta).sum(-1)    # (G, K)
    mp = matched_cls_prob * torch.exp(-l1)
    w = 1.0 / (1.0 - mp).clamp_min(1e-12)
    w = w / w.sum(dim=1, keepdim=True)
    bag_prob = (w * mp).sum(dim=1)
    pos_loss = -alpha * torch.log(bag_prob.clamp(1e-12, 1.0))
    prob = cls_prob * (1.0 - image_box_prob)
    neg = prob ** gamma * -torch.log((1.0 - prob).clamp(1e-12, 1.0))
    return ((pos_loss * gt_valid).sum(), (1.0 - alpha) * neg.sum(),
            gt_mask.sum())


class FreeAnchorTrainer(RetinaTrainer):
    """FreeAnchor's objective on RetinaNet's anchors: the positive bag
    loss over max(1, #gt) and the negative over max(1, #gt)·K."""

    def losses(self, outs, gt, s):
        head = self.head_cfg
        loss_bbox_cfg = head.get("loss_bbox") or {}
        kw = dict(
            num_fg_classes=self.fg,
            target_means=tuple(head.get("target_means", (0., 0., 0., 0.))),
            target_stds=tuple(head.get("target_stds", (0.1, 0.1, 0.2, 0.2))),
            pre_anchor_topk=int(head.get("pre_anchor_topk", 50)),
            bbox_thr=float(head.get("bbox_thr", 0.6)),
            gamma=float(head.get("gamma", 2.0)),
            alpha=float(head.get("alpha", 0.5)),
            smoothl1_beta=float(loss_bbox_cfg.get("beta", 0.11)),
            bbox_loss_weight=float(loss_bbox_cfg.get("loss_weight", 0.75)))
        cls_maps, reg_maps = outs
        cls_prob = torch.sigmoid(torch.cat([flat(c, self.fg)
                                            for c in cls_maps]))
        deltas = torch.cat([flat(r, 4) for r in reg_maps])
        pos_sum, neg_sum, n_pos = free_anchor_loss(
            cls_prob, deltas, self.canvas_anchors(s["imgs"].shape[1:3]),
            gt["gt_bboxes"], gt["gt_mask"], gt["gt_labels"], **kw)
        npos = n_pos.float().clamp_min(1.0)
        loss_pos = pos_sum / npos
        loss_neg = neg_sum / (npos * kw["pre_anchor_topk"])
        return loss_pos + loss_neg, dict(positive_bag_loss=loss_pos,
                                         negative_bag_loss=loss_neg,
                                         num_pos=n_pos.float())


class SSDTrainer(DenseTrainer):
    """SSD's objective (``ssd_targets_and_loss``) on the SSD anchors of
    the maps' own shapes."""

    def losses(self, outs, gt, s):
        eng = self.engine
        head = self.head_cfg
        tcfg = eng.train_cfg or {}
        cls_maps, reg_maps = outs
        logits = torch.cat([flat(c, eng.num_classes) for c in cls_maps])
        deltas = torch.cat([flat(r, 4) for r in reg_maps])
        anchors = torch.cat([eng.level_anchors(c.shape[2], c.shape[3], lvl)
                             for lvl, c in enumerate(cls_maps)])
        loss_cls, loss_bbox = ssd_targets_and_loss(
            logits, deltas, anchors, gt["gt_bboxes"], gt["gt_mask"],
            gt["gt_labels"], neg_pos_ratio=int(tcfg.get("neg_pos_ratio", 3)),
            target_means=tuple(head.get("target_means", (0., 0., 0., 0.))),
            target_stds=tuple(head.get("target_stds", (0.1, 0.1, 0.2, 0.2))),
            smoothl1_beta=float(tcfg.get("smoothl1_beta", 1.0)))
        return loss_cls + loss_bbox, dict(loss_cls=loss_cls,
                                          loss_bbox=loss_bbox)
