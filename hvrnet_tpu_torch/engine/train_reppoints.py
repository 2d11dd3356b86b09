"""RepPoints training (counterpart of
``hvrnet_tpu/engine/train_reppoints.py``): the point generator,
``points2bbox``, the point assigner and the two-stage points objective on
``DenseTrainer``'s plumbing.

* **Points**: per level of the canvas (``-(-H // s)`` × ``-(-W // s)``)
  the points ``i·s``, no half stride, with each point's stride.
* **``points2bbox``** (mmdet ``reppoints_head.py:164-214``, x-first point
  sets): ``minmax``, ``partial_minmax`` (the first 4 points) or
  ``moment`` (the mean ± the standard deviation, ``ddof=1``, times
  ``exp(moment_transfer)``, whose gradient is damped to ``moment_mul``:
  ``mt·mul + sg(mt)·(1 − mul)``).
* **Init stage** (``point_assign``, mmdet ``point_assigner.py``): each
  ground truth goes to the level ``int((log2(w / scale) + log2(h /
  scale)) / 2)``, a cast that truncates toward zero, clipped to the
  points' levels, and claims its ``pos_num`` nearest points there by the
  distance normalised by its (w, h), ranked by a stable double argsort,
  unless a ground truth nearer to the point claimed it first, in slot
  order.  Smooth-L1 of the init boxes normalised by ``point_base_scale``
  times the stride, over #pos.
* **Refine stage**: max-IoU assignment (``train_cfg.refine.assigner``) of
  the detached init boxes; focal loss over the non-ignored points and
  smooth-L1 of the refined boxes at its positives, both over its #pos.

The offsets are the head's y-first maps, turned to x, y pairs, times the
stride plus the point (mmdet ``offset_to_pts``).  The losses' ``beta`` and
``loss_weight`` come from ``loss_bbox_init`` / ``loss_bbox_refine`` (0.5
and 1.0 by default, β 1/9); the focal loss takes its defaults, whatever
``loss_cls`` says, as in the JAX trainer.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.targets import max_iou_assign
from ..models.losses import sigmoid_focal_loss, smooth_l1
from .single_stage import flat
from .train_single_stage import DenseTrainer

INF = 1e8


def reppoints_points(canvas_hw, strides):
    """Every level's points on a canvas, concatenated: (points (P, 2)
    float32 x, y at ``i·stride``, stride of each point (P,) float32),
    numpy."""
    h, w = canvas_hw
    pts, st = [], []
    for s in strides:
        fh, fw = -(-h // s), -(-w // s)
        xx, yy = np.meshgrid((np.arange(fw) * s).astype(np.float32),
                             (np.arange(fh) * s).astype(np.float32))
        pts.append(np.stack([xx.reshape(-1), yy.reshape(-1)], -1))
        st.append(np.full(fh * fw, s, np.float32))
    return np.concatenate(pts), np.concatenate(st)


def points2bbox(pts_xy: torch.Tensor, method: str = "moment",
                moment_transfer=None, moment_mul: float = 0.01
                ) -> torch.Tensor:
    """(N, 2K) x-first point sets → (N, 4) boxes (the module
    docstring)."""
    p = pts_xy.reshape(pts_xy.shape[0], -1, 2)
    px, py = p[..., 0], p[..., 1]
    if method == "partial_minmax":
        px, py = px[:, :4], py[:, :4]
        method = "minmax"
    if method == "minmax":
        return torch.stack([px.min(1).values, py.min(1).values,
                            px.max(1).values, py.max(1).values], -1)
    if method != "moment":
        raise ValueError(f"points2bbox: unknown transform {method!r}")
    mx, my = px.mean(1), py.mean(1)
    sx = torch.std(px - mx[:, None], dim=1, correction=1)
    sy = torch.std(py - my[:, None], dim=1, correction=1)
    mt = (moment_transfer * moment_mul
          + moment_transfer.detach() * (1 - moment_mul))
    half_w = sx * torch.exp(mt[0])
    half_h = sy * torch.exp(mt[1])
    return torch.stack([mx - half_w, my - half_h, mx + half_w, my + half_h],
                       -1)


def point_assign(points: torch.Tensor, point_strides: torch.Tensor,
                 gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
                 scale: float = 4, pos_num: int = 1) -> torch.Tensor:
    """The point assigner over fixed ground-truth slots: (P,) int64, 0 for
    a negative, i + 1 for ground truth i (the module docstring)."""
    pts_lvl = torch.floor(torch.log2(point_strides)).to(torch.int32)
    lo, hi = int(pts_lvl.min()), int(pts_lvl.max())
    ctr = (gt_bboxes[:, :2] + gt_bboxes[:, 2:4]) / 2
    wh = (gt_bboxes[:, 2:4] - gt_bboxes[:, :2]).clamp_min(1e-6)
    gt_lvl = ((torch.log2(wh[:, 0] / scale) + torch.log2(wh[:, 1] / scale))
              / 2).to(torch.int32).clamp(lo, hi)
    rel = (points[None, :, :] - ctr[:, None, :]) / wh[:, None, :]
    d = torch.sqrt((rel * rel).sum(-1))                          # (G, P)
    d = torch.where(pts_lvl[None, :] == gt_lvl[:, None], d, INF)
    d = torch.where(gt_mask[:, None], d, INF)
    assigned = torch.zeros(points.shape[0], dtype=torch.int64,
                           device=points.device)
    best = torch.full_like(d[0], float("inf"))
    for i in range(gt_bboxes.shape[0]):
        di = d[i]
        rank = torch.argsort(torch.argsort(di, stable=True), stable=True)
        chosen = (rank < pos_num) & (di < INF / 2) & (di < best)
        assigned = torch.where(chosen, i + 1, assigned)
        best = torch.where(chosen, di, best)
    return assigned


class RepPointsTrainer(DenseTrainer):
    """RepPoints' two-stage points objective (the module docstring)."""

    def losses(self, outs, gt, s):
        eng = self.engine
        head = self.head_cfg
        cls_maps, init_maps, refine_maps = outs
        strides = tuple(head.get("point_strides", (8, 16, 32, 64, 128)))
        num_points = int(head.get("num_points", 9))
        base_scale = float(head.get("point_base_scale", 4))
        method = str(head.get("transform_method", "moment"))
        mul = float(head.get("moment_mul", 0.01))
        mt = eng.model.bbox_head.moment_transfer if method == "moment" \
            else None
        tcfg = eng.train_cfg or {}
        icfg = tcfg.get("init", dict(assigner=dict(
            type="PointAssigner", scale=4, pos_num=1)))["assigner"]
        rcfg = tcfg.get("refine", dict(assigner=dict(
            pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)))["assigner"]
        init_cfg = head.get("loss_bbox_init") or {}
        refine_cfg = head.get("loss_bbox_refine") or {}
        canvas = tuple(s["imgs"].shape[1:3])
        points = eng._grid(("rep points", canvas, strides),
                           lambda: reppoints_points(canvas, strides)[0])
        pstride = eng._grid(("rep strides", canvas, strides),
                            lambda: reppoints_points(canvas, strides)[1])

        def coords(maps):
            parts, start = [], 0
            for lvl, m in enumerate(maps):
                o = flat(m, 2 * num_points).reshape(-1, num_points, 2)
                xy = torch.stack([o[..., 1], o[..., 0]], -1)
                c = points[start:start + o.shape[0]]
                parts.append((xy * strides[lvl] + c[:, None, :]).reshape(
                    o.shape[0], 2 * num_points))
                start += o.shape[0]
            return torch.cat(parts)

        gt_b, gt_m, gt_l = gt["gt_bboxes"], gt["gt_mask"], gt["gt_labels"]
        logits = torch.cat([flat(c, self.fg) for c in cls_maps])
        box_init = points2bbox(coords(init_maps), method, mt, mul)
        box_refine = points2bbox(coords(refine_maps), method, mt, mul)
        norm = (base_scale * pstride)[:, None]

        gi = point_assign(points, pstride, gt_b, gt_m,
                          scale=float(icfg.get("scale", 4)),
                          pos_num=int(icfg.get("pos_num", 1)))
        pos_i = (gi > 0).float()
        n_init = pos_i.sum().clamp_min(1.0)
        tgt_i = gt_b[(gi - 1).clamp_min(0)][:, :4]
        l1_i = smooth_l1(box_init / norm, tgt_i / norm,
                         float(init_cfg.get("beta", 1.0 / 9.0))).sum(-1)
        loss_init = float(init_cfg.get("loss_weight", 0.5)) \
            * (l1_i * pos_i).sum() / n_init

        ar = max_iou_assign(box_init.detach(), gt_b, gt_m, gt_l,
                            float(rcfg["pos_iou_thr"]),
                            float(rcfg["neg_iou_thr"]),
                            float(rcfg["min_pos_iou"]))
        pos_r = (ar.gt_inds > 0).float()
        valid = (ar.gt_inds >= 0).float()
        n_ref = pos_r.sum().clamp_min(1.0)
        loss_cls = (sigmoid_focal_loss(logits, ar.labels).sum(-1)
                    * valid).sum() / n_ref
        tgt_r = gt_b[(ar.gt_inds - 1).clamp_min(0)][:, :4]
        l1_r = smooth_l1(box_refine / norm, tgt_r / norm,
                         float(refine_cfg.get("beta", 1.0 / 9.0))).sum(-1)
        loss_refine = float(refine_cfg.get("loss_weight", 1.0)) \
            * (l1_r * pos_r).sum() / n_ref
        return loss_cls + loss_init + loss_refine, dict(
            loss_cls=loss_cls, loss_pts_init=loss_init,
            loss_pts_refine=loss_refine, num_pos_init=n_init, num_pos=n_ref)
