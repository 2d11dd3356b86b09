"""FCOS and FoveaBox training (counterpart of
``hvrnet_tpu/engine/train_fcos.py``): per-point targets and the two
anchor-free objectives on ``DenseTrainer``'s plumbing.

FCOS (mmdet ``fcos_head.py``): a point of level l is positive for a
ground truth that contains it (every distance > 0) with its largest
distance within the level's regress range; of several, the smallest area
wins (``argmin``: the first on a tie).  Focal loss (γ 2, α 0.25) over all
points, the IoU loss of the decoded boxes weighted by the centerness
target, and the centerness BCE, the first and last over #pos (at least
1), the IoU loss over the centerness weights' sum.  ``FCOSTrainer``'s
default strides are (8, 16, 32, 64, 128), the head's and the engine's
(4, 8, 16, 32, 64): the JAX package's, mirrored.

FoveaBox (mmdet ``fovea_head.py:186-312``): each ground truth whose
sqrt-area falls in a level's scale range paints its σ-shrunk fovea on that
level; where foveae overlap the smallest area wins.  Focal loss (the
default γ and α, whatever ``loss_cls`` says) over all points divided by
#pos + 1, smooth-L1 of the log-space distances at the positives with
``loss_bbox``'s ``beta`` and ``loss_weight`` (defaults 0.11 and 0.1) over
#pos (at least 1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.losses import (binary_cross_entropy_with_logits,
                             sigmoid_focal_loss, smooth_l1)
from .single_stage import flat
from .train_single_stage import DenseTrainer

INF = 1e8
DEFAULT_REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512),
                          (512, INF))


def fcos_points(canvas_hw, strides):
    """Every level's points on a canvas (``-(-H // s)`` × ``-(-W // s)``,
    ``i·s + s//2``), concatenated: (points (P, 2) float32 x, y, level
    index (P,) int64), numpy."""
    h, w = canvas_hw
    pts, levels = [], []
    for li, s in enumerate(strides):
        fh, fw = -(-h // s), -(-w // s)
        ys = (np.arange(fh) * s + s // 2).astype(np.float32)
        xs = (np.arange(fw) * s + s // 2).astype(np.float32)
        xx, yy = np.meshgrid(xs, ys)
        pts.append(np.stack([xx.reshape(-1), yy.reshape(-1)], -1))
        levels.append(np.full(fh * fw, li, np.int64))
    return np.concatenate(pts), np.concatenate(levels)


def fcos_targets(points: torch.Tensor, level_idx: torch.Tensor,
                 regress_ranges: torch.Tensor, gt_bboxes: torch.Tensor,
                 gt_mask: torch.Tensor, gt_labels: torch.Tensor):
    """Per point (label (P,) 1-based or 0, ltrb target (P, 4), centerness
    target (P,), positive (P,)) against (G, 4) ground truths;
    ``regress_ranges`` (L, 2) float32 indexed by ``level_idx``."""
    px = points[:, 0][:, None]
    py = points[:, 1][:, None]
    ltrb = torch.stack([px - gt_bboxes[None, :, 0], py - gt_bboxes[None, :, 1],
                        gt_bboxes[None, :, 2] - px, gt_bboxes[None, :, 3] - py],
                       dim=-1)                                  # (P, G, 4)
    inside = ltrb.min(dim=-1).values > 0
    max_dist = ltrb.max(dim=-1).values
    lo = regress_ranges[level_idx][:, 0][:, None]
    hi = regress_ranges[level_idx][:, 1][:, None]
    in_range = (max_dist >= lo) & (max_dist <= hi)
    areas = ((gt_bboxes[:, 2] - gt_bboxes[:, 0])
             * (gt_bboxes[:, 3] - gt_bboxes[:, 1]))[None, :]
    cand = inside & in_range & gt_mask[None, :]
    gi = torch.where(cand, areas, INF).argmin(dim=1)
    pos = cand.any(dim=1)
    labels = torch.where(pos, gt_labels[gi], 0)
    tgt = torch.gather(ltrb, 1, gi[:, None, None].expand(-1, 1, 4))[:, 0]
    lr_min = torch.minimum(tgt[:, 0], tgt[:, 2])
    lr_max = torch.maximum(tgt[:, 0], tgt[:, 2])
    tb_min = torch.minimum(tgt[:, 1], tgt[:, 3])
    tb_max = torch.maximum(tgt[:, 1], tgt[:, 3])
    centerness = torch.sqrt(((lr_min / lr_max.clamp_min(1e-6))
                             * (tb_min / tb_max.clamp_min(1e-6))).clamp_min(0))
    return labels, tgt, centerness, pos


def fovea_level_targets(gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
                        gt_labels: torch.Tensor, feat_hw, stride: int,
                        base_len: float, lower: float, upper: float,
                        sigma: float = 0.4):
    """One level's FoveaBox targets for one image: (labels (h·w,),
    log-space ltrb targets (h·w, 4), 0 off the positives, positive
    (h·w,)); the points are ``(i + 0.5)·stride``."""
    h, w = feat_hw
    dev = gt_bboxes.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    g = gt_bboxes
    areas = torch.sqrt((g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1]))
    hit = (areas >= lower) & (areas <= upper) & gt_mask
    gs = g / stride
    half_w = 0.5 * (gs[:, 2] - gs[:, 0])
    half_h = 0.5 * (gs[:, 3] - gs[:, 1])
    px1 = torch.ceil(gs[:, 0] + (1 - sigma) * half_w - 0.5).clamp(0, w - 1)
    px2 = torch.floor(gs[:, 0] + (1 + sigma) * half_w - 0.5).clamp(0, w - 1)
    py1 = torch.ceil(gs[:, 1] + (1 - sigma) * half_h - 0.5).clamp(0, h - 1)
    py2 = torch.floor(gs[:, 1] + (1 + sigma) * half_h - 0.5).clamp(0, h - 1)
    cover = ((xx[None] >= px1[:, None, None]) & (xx[None] <= px2[:, None, None])
             & (yy[None] >= py1[:, None, None])
             & (yy[None] <= py2[:, None, None])
             & hit[:, None, None])                              # (G, h, w)
    winner = torch.where(cover, areas[:, None, None], INF).argmin(dim=0)
    pos = cover.any(dim=0)
    labels = torch.where(pos, gt_labels[winner], 0).reshape(-1)
    gt_w = g[winner]                                            # (h, w, 4)
    sx = stride * (xx + 0.5)
    sy = stride * (yy + 0.5)
    t = torch.stack([(sx - gt_w[..., 0]) / base_len,
                     (sy - gt_w[..., 1]) / base_len,
                     (gt_w[..., 2] - sx) / base_len,
                     (gt_w[..., 3] - sy) / base_len], dim=-1)
    t = torch.log(t.clamp(1.0 / 16, 16.0))
    t = torch.where(pos[..., None], t, 0.0)                     # log(1) = 0
    return labels, t.reshape(-1, 4), pos.reshape(-1)


def _decode(points: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.stack([points[:, 0] - d[:, 0], points[:, 1] - d[:, 1],
                        points[:, 0] + d[:, 2], points[:, 1] + d[:, 3]], -1)


class FCOSTrainer(DenseTrainer):
    """FCOS's objective (the module docstring)."""

    def losses(self, outs, gt, s):
        eng = self.engine
        cls_maps, reg_maps, ctr_maps = outs
        strides = tuple(self.head_cfg.get("strides", (8, 16, 32, 64, 128)))
        canvas = tuple(s["imgs"].shape[1:3])
        points = eng._grid(("fcos points", canvas, strides),
                           lambda: fcos_points(canvas, strides)[0])
        level_idx = eng._grid(("fcos levels", canvas, strides),
                              lambda: fcos_points(canvas, strides)[1])
        ranges = torch.tensor(DEFAULT_REGRESS_RANGES[:len(strides)],
                              dtype=torch.float32, device=eng.device)
        logits = torch.cat([flat(c, self.fg) for c in cls_maps])
        regs = torch.cat([flat(r, 4) * st for r, st in zip(reg_maps,
                                                          strides)])
        ctrs = torch.cat([flat(c, 1)[:, 0] for c in ctr_maps])
        labels, tgt, ctr_tgt, pos = fcos_targets(
            points, level_idx, ranges, gt["gt_bboxes"], gt["gt_mask"],
            gt["gt_labels"])
        posf = pos.float()
        num_pos = posf.sum().clamp_min(1.0)
        loss_cls = sigmoid_focal_loss(logits, labels).sum() / num_pos
        pb, tb = _decode(points, regs), _decode(points, tgt)
        lt = torch.maximum(pb[:, :2], tb[:, :2])
        rb = torch.minimum(pb[:, 2:], tb[:, 2:])
        wh = (rb - lt).clamp_min(0)
        inter = wh[:, 0] * wh[:, 1]
        ap = ((pb[:, 2] - pb[:, 0]) * (pb[:, 3] - pb[:, 1])).clamp_min(0)
        at = ((tb[:, 2] - tb[:, 0]) * (tb[:, 3] - tb[:, 1])).clamp_min(0)
        iou = inter / (ap + at - inter).clamp_min(1e-6)
        w = ctr_tgt * posf
        loss_reg = (-torch.log(iou.clamp_min(1e-6)) * w).sum() \
            / w.sum().clamp_min(1e-6)
        loss_ctr = (binary_cross_entropy_with_logits(ctrs, ctr_tgt)
                    * posf).sum() / num_pos
        return loss_cls + loss_reg + loss_ctr, dict(
            loss_cls=loss_cls, loss_bbox=loss_reg, loss_centerness=loss_ctr,
            num_pos=num_pos)


class FoveaTrainer(DenseTrainer):
    """FoveaBox's objective (the module docstring)."""

    def losses(self, outs, gt, s):
        head = self.head_cfg
        strides = tuple(head.get("strides", (4, 8, 16, 32, 64)))
        base_lens = tuple(head.get("base_edge_list", (16, 32, 64, 128, 256)))
        ranges = tuple(tuple(r) for r in head.get(
            "scale_ranges", ((8, 32), (16, 64), (32, 128), (64, 256),
                             (128, 512))))
        sigma = float(head.get("sigma", 0.4))
        loss_bbox_cfg = head.get("loss_bbox") or {}
        beta = float(loss_bbox_cfg.get("beta", 0.11))
        bbox_w = float(loss_bbox_cfg.get("loss_weight", 0.1))
        parts = []
        for lvl, (cm, rm) in enumerate(zip(*outs)):
            labels, tgt, pos = fovea_level_targets(
                gt["gt_bboxes"], gt["gt_mask"], gt["gt_labels"],
                cm.shape[2:], strides[lvl], base_lens[lvl], ranges[lvl][0],
                ranges[lvl][1], sigma)
            parts.append((labels, tgt, pos, flat(cm, self.fg), flat(rm, 4)))
        labels, tgt, pos, logits, regs = (torch.cat(p) for p in zip(*parts))
        posf = pos.float()
        num_pos = posf.sum()
        loss_cls = sigmoid_focal_loss(logits, labels).sum() / (num_pos + 1.0)
        loss_bbox = bbox_w * (smooth_l1(regs, tgt, beta).sum(-1)
                              * posf).sum() / num_pos.clamp_min(1.0)
        return loss_cls + loss_bbox, dict(loss_cls=loss_cls,
                                          loss_bbox=loss_bbox,
                                          num_pos=num_pos)
