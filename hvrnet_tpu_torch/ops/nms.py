"""Greedy NMS with a static number of outputs (counterpart of
``hvrnet_tpu/ops/nms.py``: ``nms_static``, ``multiclass_nms_static`` and
their lanes variants ``nms_static_lanes``, ``multiclass_nms_static_lanes``).

Exact: the same picks in the same order as sequential greedy NMS over the
candidates sorted by descending score (ties toward the lower index, as
``lax.top_k`` orders them), truncated to its first ``max_out`` survivors,
with mmdet's +1-pixel IoU.  The lanes variants solve B independent
problems (one per video stream) at once: per lane the same picks, order,
quota and lane-local indices as the single-image call.

The greedy rule — keep i iff no kept j before i overlaps it — is resolved as
the fixpoint of the JAX package's ``_tile_greedy_keep``, over all live
candidates at once: a candidate whose higher-scored overlapping neighbours
are all dead becomes kept, one that overlaps a kept neighbour becomes dead.
Each pass is a few boolean reductions over a block-diagonal (B, n, n)
adjacency on the device (n the most live candidates of any lane; lanes
never interact, and (B·n)² over their union would be B times larger).
The pass count is data-dependent, so the loop reads one flag for the whole
batch back to the host every ``_PASSES_PER_CHECK`` passes (a device sync
each time); it also stops as soon as every lane's first ``max_out``
survivors are final.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_PASSES_PER_CHECK = 4


def _pairwise_iou(b: torch.Tensor) -> torch.Tensor:
    """(n, n) IoU, +1 convention, the JAX package's operation order."""
    x1, y1, x2, y2 = b.unbind(dim=1)

    def overlap(lo, hi):
        return (torch.minimum(hi[:, None], hi[None])
                - torch.maximum(lo[:, None], lo[None]) + 1.0).clamp_min(0.0)

    inter = overlap(x1, x2) * overlap(y1, y2)
    area = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    return inter / (area[:, None] + area[None, :] - inter).clamp_min(1e-10)


def _greedy_keep(upper: torch.Tensor, live: torch.Tensor,
                 max_out: int) -> torch.Tensor:
    """Greedy keep flags (B, n) over each lane's score-sorted candidates;
    ``upper[b, j, i]`` says that the higher-scored j (j < i) suppresses i,
    ``live[b]`` marks the lane's candidates (a prefix)."""
    n = upper.shape[-1]
    undecided = live.clone()
    kept = torch.zeros_like(undecided)
    idx = torch.arange(n, device=upper.device)
    while True:
        for _ in range(_PASSES_PER_CHECK):
            blocked = (upper & undecided[..., None]).any(dim=-2)
            killed = (upper & kept[..., None]).any(dim=-2)
            newly = undecided & ~blocked & ~killed
            kept = kept | newly
            dead = (upper & kept[..., None]).any(dim=-2)
            undecided = undecided & ~newly & ~dead
        # a lane is done when nothing is undecided, or when the keeps before
        # its first undecided candidate already fill the quota (later ones
        # can only land behind them)
        first = torch.where(undecided, idx, n).min(dim=-1, keepdim=True)
        full = (kept & (idx < first.values)).sum(dim=-1) >= max_out
        if bool((full | (first.values[:, 0] == n)).all()):
            return kept


def nms_static_lanes(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thr: float, max_out: int,
                     valid: Optional[torch.Tensor] = None,
                     sup_groups: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B independent greedy NMS problems in one shared fixpoint.

    Args:
        boxes: (B, N, 4) float32; scores: (B, N) float32.
        max_out: per-lane survivor quota.
        valid: optional (B, N) bool, False rows are ignored entirely.
        sup_groups: optional (B, N) int — suppression only within a group of
            a lane (grouped NMS over a union of per-class candidates is
            per-class NMS).

    Returns:
        keep_idx: (B, max_out) int64 indices into each lane's N rows (0
            where unused).
        keep_mask: (B, max_out) bool.
    """
    B = scores.shape[0]
    dev = boxes.device
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, NEG_INF))
    order = torch.sort(live, dim=-1, descending=True, stable=True)
    n_live = (order.values > NEG_INF / 2).sum(dim=-1)
    m = int(n_live.max()) if B else 0
    keep_idx = torch.zeros((B, max_out + 1), dtype=torch.int64, device=dev)
    keep_mask = torch.zeros((B, max_out + 1), dtype=torch.bool, device=dev)
    if m == 0:
        return keep_idx[:, :max_out], keep_mask[:, :max_out]
    cand = order.indices[:, :m]
    cand_live = torch.arange(m, device=dev) < n_live[:, None]
    cand_boxes = torch.gather(boxes.float(), 1,
                              cand[..., None].expand(B, m, 4))
    adj = torch.empty((B, m, m), dtype=torch.bool, device=dev)
    for b in range(B):              # one lane's float IoU at a time
        adj[b] = _pairwise_iou(cand_boxes[b]) > iou_thr
    if sup_groups is not None:
        g = torch.gather(sup_groups, 1, cand)
        adj &= g[:, :, None] == g[:, None, :]
    kept = _greedy_keep(torch.triu(adj, diagonal=1), cand_live, max_out)
    rank = kept.long().cumsum(dim=-1) - 1
    slot = torch.where(kept & (rank < max_out), rank, max_out)  # dump slot
    keep_idx.scatter_(1, slot, cand)
    keep_mask.scatter_(1, slot, kept)
    return keep_idx[:, :max_out], keep_mask[:, :max_out]


def nms_static(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
               max_out: int, valid: Optional[torch.Tensor] = None,
               groups: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS emitting exactly ``max_out`` slots: one lane of
    ``nms_static_lanes``.

    Args:
        boxes: (N, 4) float32; scores: (N,) float32.
        valid: optional (N,) bool, False rows are ignored entirely.
        groups: optional (N,) int — suppression only within a group.

    Returns:
        keep_idx: (max_out,) int64 indices into the input (0 where unused).
        keep_mask: (max_out,) bool.
    """
    keep_idx, keep_mask = nms_static_lanes(
        boxes[None], scores[None], iou_thr, max_out,
        None if valid is None else valid[None],
        None if groups is None else groups[None])
    return keep_idx[0], keep_mask[0]


def multiclass_nms_static_lanes(multi_bboxes: torch.Tensor,
                                multi_scores: torch.Tensor, score_thr: float,
                                iou_thr: float, max_num: int,
                                valid: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """B independent multi-class NMS decodes (mmdet ``multiclass_nms``) in
    one shared fixpoint, static output.

    Args:
        multi_bboxes: (B, N, 4) class-agnostic boxes or (B, N, C·4).
        multi_scores: (B, N, C); column 0 is background and is skipped.
        valid: optional (B, N) mask of padded proposal rows.

    Returns:
        dets (B, max_num, 5) [x1, y1, x2, y2, score] zero-padded, labels
        (B, max_num) 0-based foreground labels, mask (B, max_num) bool.
    """
    flat_boxes, flat_scores, flat_valid, labels = _multiclass_candidates(
        multi_bboxes, multi_scores, score_thr, valid)
    groups = labels.expand(flat_scores.shape[0], -1)
    keep_idx, mask = nms_static_lanes(flat_boxes, flat_scores, iou_thr,
                                      max_num, flat_valid, groups)
    out_boxes = torch.gather(
        flat_boxes, 1, keep_idx[..., None].expand(-1, -1, 4)) \
        * mask[..., None]
    out_scores = torch.gather(flat_scores, 1, keep_idx)
    out_scores = torch.where(mask, out_scores, torch.zeros_like(out_scores))
    out_labels = torch.where(mask, labels[0][keep_idx],
                             torch.zeros_like(keep_idx))
    dets = torch.cat([out_boxes, out_scores[..., None]], dim=-1)
    return dets, out_labels, mask


def multiclass_nms_static(multi_bboxes: torch.Tensor,
                          multi_scores: torch.Tensor, score_thr: float,
                          iou_thr: float, max_num: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-class NMS (mmdet ``multiclass_nms``), static output: one lane
    of ``multiclass_nms_static_lanes``.

    Args:
        multi_bboxes: (N, 4) class-agnostic boxes or (N, C·4).
        multi_scores: (N, C); column 0 is background and is skipped.
        valid: optional (N,) mask of padded proposal rows.

    Returns:
        dets (max_num, 5) [x1, y1, x2, y2, score] zero-padded, labels
        (max_num,) 0-based foreground labels, mask (max_num,) bool.
    """
    dets, labels, mask = multiclass_nms_static_lanes(
        multi_bboxes[None], multi_scores[None], score_thr, iou_thr, max_num,
        None if valid is None else valid[None])
    return dets[0], labels[0], mask[0]


def _multiclass_candidates(multi_bboxes, multi_scores, score_thr, valid):
    """Per-class candidate rows in class-major order, under the leading
    lane axis: (B, fg·N, 4) boxes, (B, fg·N) scores and validity, and the
    (1, fg·N) class ids."""
    B, n, num_classes = multi_scores.shape
    fg = num_classes - 1
    if multi_bboxes.shape[-1] == 4:
        cls_boxes = multi_bboxes[:, None].expand(B, fg, n, 4)
    else:
        cls_boxes = multi_bboxes.reshape(B, n, num_classes, 4)[
            :, :, 1:].transpose(1, 2)
    cls_scores = multi_scores[..., 1:].transpose(1, 2)          # (B, fg, N)
    cls_valid = cls_scores > score_thr
    if valid is not None:
        cls_valid = cls_valid & valid[:, None, :]
    labels = torch.arange(fg, device=multi_scores.device).repeat_interleave(n)
    return (cls_boxes.reshape(B, fg * n, 4), cls_scores.reshape(B, fg * n),
            cls_valid.reshape(B, fg * n), labels[None])
