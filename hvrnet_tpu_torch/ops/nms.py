"""Greedy NMS with a static number of outputs (counterpart of
``hvrnet_tpu/ops/nms.py:nms_static`` / ``multiclass_nms_static``).

Exact: the same picks in the same order as sequential greedy NMS over the
candidates sorted by descending score (ties toward the lower index, as
``lax.top_k`` orders them), truncated to its first ``max_out`` survivors,
with mmdet's +1-pixel IoU.

The greedy rule — keep i iff no kept j before i overlaps it — is resolved as
the fixpoint of the JAX package's ``_tile_greedy_keep``, over all live
candidates at once: a candidate whose higher-scored overlapping neighbours
are all dead becomes kept, one that overlaps a kept neighbour becomes dead.
Each pass is a few (n × n) boolean reductions on the device.  The pass count
is data-dependent, so the loop reads one flag back to the host every
``_PASSES_PER_CHECK`` passes (a device sync each time); it also stops as soon
as the first ``max_out`` survivors are final.
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


def _greedy_keep(upper: torch.Tensor, max_out: int) -> torch.Tensor:
    """Greedy keep flags over score-sorted candidates; ``upper[j, i]`` says
    that the higher-scored j (j < i) suppresses i."""
    n = upper.shape[0]
    undecided = torch.ones(n, dtype=torch.bool, device=upper.device)
    kept = torch.zeros_like(undecided)
    idx = torch.arange(n, device=upper.device)
    while True:
        for _ in range(_PASSES_PER_CHECK):
            blocked = (upper & undecided[:, None]).any(dim=0)
            killed = (upper & kept[:, None]).any(dim=0)
            newly = undecided & ~blocked & ~killed
            kept = kept | newly
            dead = (upper & kept[:, None]).any(dim=0)
            undecided = undecided & ~newly & ~dead
        # done when nothing is undecided, or when the keeps before the first
        # undecided candidate already fill the quota (later ones can only
        # land behind them)
        first = torch.where(undecided, idx, n).min()
        if bool(((kept & (idx < first)).sum() >= max_out) | (first == n)):
            return kept


def nms_static(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
               max_out: int, valid: Optional[torch.Tensor] = None,
               groups: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS emitting exactly ``max_out`` slots.

    Args:
        boxes: (N, 4) float32; scores: (N,) float32.
        valid: optional (N,) bool, False rows are ignored entirely.
        groups: optional (N,) int — suppression only within a group (grouped
            NMS over a union of per-class candidates is per-class NMS).

    Returns:
        keep_idx: (max_out,) int64 indices into the input (0 where unused).
        keep_mask: (max_out,) bool.
    """
    dev = boxes.device
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, NEG_INF))
    order = torch.sort(live, descending=True, stable=True)
    n_live = int((order.values > NEG_INF / 2).sum())
    cand = order.indices[:n_live]
    keep_idx = torch.zeros(max_out, dtype=torch.int64, device=dev)
    keep_mask = torch.zeros(max_out, dtype=torch.bool, device=dev)
    if n_live == 0:
        return keep_idx, keep_mask
    adj = _pairwise_iou(boxes[cand].float()) > iou_thr
    if groups is not None:
        g = groups[cand]
        adj &= g[:, None] == g[None, :]
    kept = _greedy_keep(torch.triu(adj, diagonal=1), max_out)
    picks = cand[kept][:max_out]
    keep_idx[:picks.shape[0]] = picks
    keep_mask[:picks.shape[0]] = True
    return keep_idx, keep_mask


def multiclass_nms_static(multi_bboxes: torch.Tensor,
                          multi_scores: torch.Tensor, score_thr: float,
                          iou_thr: float, max_num: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-class NMS (mmdet ``multiclass_nms``), static output.

    Args:
        multi_bboxes: (N, 4) class-agnostic boxes or (N, C·4).
        multi_scores: (N, C); column 0 is background and is skipped.
        valid: optional (N,) mask of padded proposal rows.

    Returns:
        dets (max_num, 5) [x1, y1, x2, y2, score] zero-padded, labels
        (max_num,) 0-based foreground labels, mask (max_num,) bool.
    """
    flat_boxes, flat_scores, flat_valid, labels = _multiclass_candidates(
        multi_bboxes, multi_scores, score_thr, valid)
    keep_idx, mask = nms_static(flat_boxes, flat_scores, iou_thr, max_num,
                                flat_valid, groups=labels)
    out_boxes = flat_boxes[keep_idx] * mask[:, None]
    out_scores = torch.where(mask, flat_scores[keep_idx],
                             torch.zeros_like(flat_scores[keep_idx]))
    out_labels = torch.where(mask, labels[keep_idx],
                             torch.zeros_like(labels[keep_idx]))
    dets = torch.cat([out_boxes, out_scores[:, None]], dim=1)
    return dets, out_labels, mask


def _multiclass_candidates(multi_bboxes, multi_scores, score_thr, valid):
    """Per-class candidate rows in class-major order: (fg·N, 4) boxes,
    (fg·N,) scores / validity / class ids."""
    n, num_classes = multi_scores.shape
    fg = num_classes - 1
    if multi_bboxes.shape[-1] == 4:
        cls_boxes = multi_bboxes[None].expand(fg, n, 4)
    else:
        cls_boxes = multi_bboxes.reshape(n, num_classes, 4)[:, 1:].transpose(
            0, 1)
    cls_scores = multi_scores[:, 1:].transpose(0, 1)            # (fg, N)
    cls_valid = cls_scores > score_thr
    if valid is not None:
        cls_valid = cls_valid & valid[None, :]
    labels = torch.arange(fg, device=multi_scores.device).repeat_interleave(n)
    return (cls_boxes.reshape(fg * n, 4), cls_scores.reshape(fg * n),
            cls_valid.reshape(fg * n), labels)
