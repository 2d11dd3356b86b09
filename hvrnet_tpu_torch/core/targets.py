"""RoI and anchor assignment, sampling and targets (counterpart of
``hvrnet_tpu/core/targets.py``): mmdet's ``MaxIoUAssigner`` →
``RandomSampler(add_gt_as_proposals)`` → ``bbox_target`` chain with fixed
shapes, validity masks for padded boxes and ground truths, and positives in
the leading slots; the RPN's ``anchor_target`` over the whole anchor grid;
and the OHEM re-weighting of a sampled RoI set to its hardest members.

Random subsets use uniform priorities: eligible items get iid U(0, 1)
noise and the top k win.  The JAX package draws that noise from
``jax.random``, whose bits torch cannot reproduce, so the sampler takes its
two noise vectors as arguments (tests hand both packages the same noise)
and draws them from the caller's generator when they are absent.  Sorts are
stable, so ties go to the lower index as in ``lax.top_k`` and
``jnp.argsort``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.boxes import bbox2delta, bbox_overlaps

NEG_INF = -1e30


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor       # (N,) int64: -1 ignore, 0 negative, i+1 → gt i
    max_overlaps: torch.Tensor  # (N,) float32
    labels: torch.Tensor        # (N,) int64, 0 where not positive


def max_iou_assign(bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
                   gt_mask: torch.Tensor, gt_labels: Optional[torch.Tensor],
                   pos_iou_thr: float, neg_iou_thr: float,
                   min_pos_iou: float,
                   box_mask: Optional[torch.Tensor] = None) -> AssignResult:
    """``assign_wrt_overlaps`` over (N, 4) boxes and (G, 4) ground truths,
    with masks for padded ground truths and boxes.  Each ground truth then
    claims the boxes at its best IoU (≥ ``min_pos_iou``); where two claim
    one box the later ground truth wins, as in the reference's loop."""
    overlaps = bbox_overlaps(gt_bboxes, bboxes)                  # (G, N)
    overlaps = torch.where(gt_mask[:, None], overlaps, -1.0)
    if box_mask is not None:
        overlaps = torch.where(box_mask[None, :], overlaps, -1.0)

    max_overlaps = overlaps.max(dim=0).values
    argmax_overlaps = overlaps.argmax(dim=0)
    assigned = torch.full_like(argmax_overlaps, -1)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps + 1,
                           assigned)

    gt_max = overlaps.max(dim=1, keepdim=True).values            # (G, 1)
    claim = (gt_mask[:, None] & (gt_max >= min_pos_iou)
             & (overlaps == gt_max))
    order = torch.arange(1, overlaps.shape[0] + 1, device=overlaps.device)
    last = (claim * order[:, None]).max(dim=0).values            # 0: none
    assigned = torch.where(last > 0, last, assigned)
    if box_mask is not None:
        assigned = torch.where(box_mask, assigned, -1)

    if gt_labels is None:
        labels = torch.zeros_like(assigned)
    else:
        labels = torch.where(assigned > 0,
                             gt_labels[(assigned - 1).clamp_min(0)], 0)
    return AssignResult(assigned, max_overlaps, labels.long())


def _noise(pos_noise, neg_noise, n, generator, device, who):
    """The two U(0, 1) priority vectors, drawn from ``generator`` where the
    caller gave none."""
    if generator is None and (pos_noise is None or neg_noise is None):
        raise ValueError(f"{who} draws its noise from an explicit "
                         "torch.Generator: pass generator= or both noise "
                         "vectors")
    if pos_noise is None:
        pos_noise = torch.rand(n, generator=generator, device=device)
    if neg_noise is None:
        neg_noise = torch.rand(n, generator=generator, device=device)
    return pos_noise.float(), neg_noise.float()


def _rank(priority: torch.Tensor) -> torch.Tensor:
    """Each item's place in descending order, ties to the lower index
    (``jnp.argsort(jnp.argsort(-priority))``)."""
    return torch.argsort(torch.argsort(-priority, stable=True), stable=True)


class SampleResult(NamedTuple):
    rois: torch.Tensor           # (num, 4) sampled boxes
    labels: torch.Tensor         # (num,) int64 gt label (0 = background)
    label_weights: torch.Tensor  # (num,) float32
    bbox_targets: torch.Tensor   # (num, 4)
    bbox_weights: torch.Tensor   # (num, 4)
    valid: torch.Tensor          # (num,) bool, False: padded slot
    pos_mask: torch.Tensor       # (num,) bool
    gt_inds: torch.Tensor        # (num,) assigned gt row (0-clamped)


def random_sample_and_target(proposals: torch.Tensor,
                             proposal_mask: torch.Tensor,
                             gt_bboxes: torch.Tensor,
                             gt_mask: torch.Tensor,
                             gt_labels: torch.Tensor,
                             num: int,
                             pos_fraction: float,
                             add_gt_as_proposals: bool = True,
                             pos_iou_thr: float = 0.5,
                             neg_iou_thr: float = 0.5,
                             min_pos_iou: float = 0.5,
                             target_means=(0., 0., 0., 0.),
                             target_stds=(0.1, 0.1, 0.2, 0.2),
                             pos_weight: float = -1.0,
                             pos_noise: Optional[torch.Tensor] = None,
                             neg_noise: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> SampleResult:
    """Assign, sample ``num`` RoIs (at most ``num·pos_fraction`` positives)
    and compute their targets.  ``pos_noise`` / ``neg_noise``: (N,) U(0, 1)
    priorities over the N candidates (ground truths first when
    ``add_gt_as_proposals``), drawn from ``generator`` when absent."""
    if add_gt_as_proposals:
        cand = torch.cat([gt_bboxes[:, :4], proposals[:, :4]])
        cand_mask = torch.cat([gt_mask, proposal_mask])
    else:
        cand, cand_mask = proposals[:, :4], proposal_mask
    ar = max_iou_assign(cand, gt_bboxes, gt_mask, gt_labels, pos_iou_thr,
                        neg_iou_thr, min_pos_iou, box_mask=cand_mask)

    pos_noise, neg_noise = _noise(pos_noise, neg_noise, cand.shape[0],
                                  generator, cand.device,
                                  "random_sample_and_target")
    k_pos = int(num * pos_fraction)
    eligible_pos = ar.gt_inds > 0
    # rank positives by their noise; the first k_pos win
    pos_noise = torch.where(eligible_pos, pos_noise, NEG_INF)
    chosen_pos = eligible_pos & (_rank(pos_noise) < k_pos)
    # chosen positives first, then random negatives
    score = torch.where(chosen_pos, 2.0 + pos_noise,
                        torch.where(ar.gt_inds == 0, neg_noise, NEG_INF))
    top = torch.sort(score, descending=True, stable=True)
    vals, idx = top.values[:num], top.indices[:num]
    valid = vals > NEG_INF / 2
    pos_sel = vals > 1.5

    rois = cand[idx] * valid[:, None]
    gi = (ar.gt_inds[idx] - 1).clamp_min(0)
    labels = torch.where(pos_sel, gt_labels[gi], 0).long()
    pw = 1.0 if pos_weight <= 0 else pos_weight
    label_weights = torch.where(pos_sel, pw, valid.float())
    targets = bbox2delta(rois, gt_bboxes[gi][:, :4], target_means,
                         target_stds)
    bbox_targets = torch.where(pos_sel[:, None], targets, 0.0)
    bbox_weights = pos_sel[:, None].float().expand(-1, 4).contiguous()
    return SampleResult(rois, labels, label_weights, bbox_targets,
                        bbox_weights, valid, pos_sel, gi)


class AnchorTargets(NamedTuple):
    labels: torch.Tensor         # (A,) int64: 1 sampled positive, else 0
    label_weights: torch.Tensor  # (A,) float32
    bbox_targets: torch.Tensor   # (A, 4)
    bbox_weights: torch.Tensor   # (A, 4)
    num_total_samples: torch.Tensor  # () float32


def anchor_target_single(anchors: torch.Tensor, valid_flags: torch.Tensor,
                         gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
                         img_shape, cfg: dict,
                         target_means=(0., 0., 0., 0.),
                         target_stds=(1., 1., 1., 1.),
                         pos_noise: Optional[torch.Tensor] = None,
                         neg_noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> AnchorTargets:
    """The RPN's targets for one image over the whole (A, 4) anchor grid
    (mmdet ``anchor_target_single`` after its ``unmap``): anchors inside the
    image (``valid_flags`` and ``allowed_border``) are assigned by max IoU
    (``cfg.assigner``), and ``cfg.sampler.num`` of them sampled, at most
    ``num·pos_fraction`` positives and negatives filling the rest.
    ``pos_noise`` / ``neg_noise``: (A,) U(0, 1) priorities, drawn from
    ``generator`` when absent."""
    border = float(cfg.get("allowed_border", 0))
    h, w = (float(np.float32(x)) for x in (img_shape[0], img_shape[1]))
    inside = valid_flags
    if border >= 0:
        inside = (valid_flags & (anchors[:, 0] >= -border)
                  & (anchors[:, 1] >= -border)
                  & (anchors[:, 2] < w + border)
                  & (anchors[:, 3] < h + border))
    acfg = cfg["assigner"]
    ar = max_iou_assign(anchors, gt_bboxes, gt_mask, None,
                        float(acfg["pos_iou_thr"]), float(acfg["neg_iou_thr"]),
                        float(acfg["min_pos_iou"]), box_mask=inside)
    scfg = cfg["sampler"]
    num = int(scfg["num"])
    k_pos = int(num * float(scfg["pos_fraction"]))
    pos_noise, neg_noise = _noise(pos_noise, neg_noise, anchors.shape[0],
                                  generator, anchors.device,
                                  "anchor_target_single")
    eligible_pos = ar.gt_inds > 0
    chosen_pos = eligible_pos & (
        _rank(torch.where(eligible_pos, pos_noise, NEG_INF)) < k_pos)
    n_pos = chosen_pos.sum()
    eligible_neg = ar.gt_inds == 0
    chosen_neg = eligible_neg & (
        _rank(torch.where(eligible_neg, neg_noise, NEG_INF)) < num - n_pos)
    n_neg = chosen_neg.sum()

    gi = (ar.gt_inds - 1).clamp_min(0)
    pos_weight = float(cfg.get("pos_weight", -1))
    pw = 1.0 if pos_weight <= 0 else pos_weight
    label_weights = torch.where(chosen_pos, pw, chosen_neg.float())
    t = bbox2delta(anchors, gt_bboxes[gi][:, :4], target_means, target_stds)
    bbox_targets = torch.where(chosen_pos[:, None], t, 0.0)
    bbox_weights = chosen_pos[:, None].float().expand(-1, 4).contiguous()
    num_total = (n_pos.clamp_min(1) + n_neg.clamp_min(1)).float()
    return AnchorTargets(chosen_pos.long(), label_weights, bbox_targets,
                         bbox_weights, num_total)


def ohem_weights(labels: torch.Tensor, loss_per_roi: torch.Tensor,
                 valid: torch.Tensor, num: int, pos_fraction: float):
    """``OHEMHNLSampler.get_ohem_weights``: re-weight a sampled RoI set to
    its ``num`` hardest members by ``loss_per_roi`` (detached), at most
    ``num·pos_fraction`` positives and negatives filling the rest, ties to
    the lower index.  Returns (label_weights (N,), bbox_weights (N, 4),
    selected, positive selected); the reference also takes the sampler's
    weights, which it only replaces."""
    loss = loss_per_roi.detach().float()
    k_pos = int(num * pos_fraction)
    pos_elig = (labels > 0) & valid
    neg_elig = (labels == 0) & valid
    chosen_pos = pos_elig & (
        _rank(torch.where(pos_elig, loss, NEG_INF)) < k_pos)
    # float32 as in the reference: 1e9 + loss rounds, so the chosen
    # positives tie among themselves and keep index order
    score = torch.where(chosen_pos, 1e9 + loss,
                        torch.where(neg_elig, loss, NEG_INF))
    top = torch.sort(score, descending=True, stable=True)
    sel = torch.zeros_like(labels, dtype=torch.bool)
    sel[top.indices[:num]] = top.values[:num] > NEG_INF / 2
    pos_sel = sel & chosen_pos
    new_bw = pos_sel[:, None].float().expand(-1, 4).contiguous()
    return sel.float(), new_bw, sel, pos_sel
