"""Streaming-softmax accumulators for sliding-window attention (counterpart
of ``hvrnet_tpu/ops/streaming_attention.py``).

The blocks whose queries and keys are row-wise functions of per-frame
cached features (HRNMP NL1 and the non-key rows of NL3) have logits that
do not change while the window slides.  Instead of recomputing the block
for every detection, each query row keeps its softmax in streaming form,
the (m, l, a) triple flash attention carries per query tile:

    m_i = anchor (running max) of the scaled logits row i has seen   (R,)
    l_i = Σ_j exp(s_ij − m_i) over the live key set                  (R,)
    a_i = Σ_j exp(s_ij − m_i) · v_j                                   (R, D)
    out_i = a_i / l_i

When the window slides, one frame's P keys leave and P arrive: ``slide``
subtracts the departing contributions and adds the arriving ones (rescaling
by exp(m_old − m_new) when the max grows), and ``init_rows`` builds fresh
accumulators for the arriving frame's query rows in one (P, R) pass.  A
slide costs O(R·P·D) instead of the block's O(R²·D).

Eviction is exact in real arithmetic but not in float32: a contribution
added under a much larger anchor underflows and is lost if the dominant key
later leaves, and subtracting most of a row's mass amplifies the rest's
rounding error.  Both show in one scalar per row, the gap between the anchor
m_i and the true max live logit, so an (R, T) table of per-(row, slot) logit
maxima rides beside the accumulators; ``degenerate_rows`` flags rows whose
gap exceeds ``theta`` nats or whose mass collapsed, and ``repair`` rebuilds
every row exactly when any is flagged.

Every function is mask-aware (an invalid key contributes exactly zero, as
the −1e30 bias of ``ops/attention.py`` does); accumulators are dicts with
keys ``m``, ``l`` and ``a``, always float32.  q, k and v are float32 or
bf16 (a bf16 engine's row caches): bf16 operands are widened, so the logits
are the float32 products of the bf16 values and v enters the accumulators
unrounded.  The products are plain ``torch.matmul``: the callers keep TF32
off (``f32_precision``) since they decide a 10-nat health test.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

TINY = 1e-30
THETA = 10.0      # anchor gap (nats) beyond which a row must be rebuilt
L_FLOOR = 1e-6    # a healthy l is ≥ e^-THETA ≈ 4.5e-5; below this it is corrupt

Acc = Dict[str, torch.Tensor]


def acc_init(rows: int, d: int, device=None) -> Acc:
    """Empty accumulators for ``rows`` query rows of value width ``d``."""
    return dict(m=torch.full((rows,), -torch.inf, device=device),
                l=torch.zeros((rows,), device=device),
                a=torch.zeros((rows, d), device=device))


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return (q.float() @ k.float().T) * scale


def _anchor_rescale(m_old: torch.Tensor, m_new: torch.Tensor) -> torch.Tensor:
    """exp(m_old − m_new), 0 where both are −inf (exp(−inf + inf) is NaN;
    rows that stay empty keep l = a = 0)."""
    return torch.where(torch.isneginf(m_new), 0.0, torch.exp(m_old - m_new))


def evict(acc: Acc, q: torch.Tensor, k_dep: torch.Tensor,
          v_dep: torch.Tensor, mask_dep: torch.Tensor, scale: float) -> Acc:
    """Remove the departing keys' contributions from every row.  q: (R, Dk)
    the rows' stationary queries; k_dep, v_dep: (P, Dk), (P, Dv);
    mask_dep: (P,)."""
    s = _logits(q, k_dep, scale)                           # (R, P)
    w = torch.where(mask_dep[None, :], torch.exp(s - acc["m"][:, None]), 0.0)
    return dict(m=acc["m"], l=acc["l"] - w.sum(dim=1),
                a=acc["a"] - w @ v_dep.float())


def insert(acc: Acc, q: torch.Tensor, k_new: torch.Tensor,
           v_new: torch.Tensor, mask_new: torch.Tensor, scale: float
           ) -> Tuple[Acc, torch.Tensor]:
    """Add the arriving keys' contributions to every row, rescaling on a new
    running max.  Returns (acc, col_max): col_max (R,) is each row's max
    masked logit against the new keys, the arriving slot's column of the
    health table."""
    s = _logits(q, k_new, scale).masked_fill(~mask_new[None, :], -torch.inf)
    col_max = s.amax(dim=1)
    m_new = torch.maximum(acc["m"], col_max)
    r = _anchor_rescale(acc["m"], m_new)
    p = torch.where(mask_new[None, :], torch.exp(s - m_new[:, None]), 0.0)
    return dict(m=m_new, l=acc["l"] * r + p.sum(dim=1),
                a=acc["a"] * r[:, None] + p @ v_new.float()), col_max


def slide(acc: Acc, q: torch.Tensor,
          k_dep: torch.Tensor, v_dep: torch.Tensor, mask_dep: torch.Tensor,
          k_new: torch.Tensor, v_new: torch.Tensor, mask_new: torch.Tensor,
          scale: float) -> Tuple[Acc, torch.Tensor]:
    """``evict`` then ``insert`` in one pass over the accumulators: the
    eviction weights are taken against the old anchor and the combined
    rescale is applied once.  Returns (acc, col_max) as ``insert`` does.
    The inputs are not modified."""
    s_dep = _logits(q, k_dep, scale)
    w = torch.where(mask_dep[None, :],
                    torch.exp(s_dep - acc["m"][:, None]), 0.0)
    s_new = _logits(q, k_new, scale).masked_fill(~mask_new[None, :],
                                                 -torch.inf)
    col_max = s_new.amax(dim=1)
    m_new = torch.maximum(acc["m"], col_max)
    r = _anchor_rescale(acc["m"], m_new)
    p = torch.where(mask_new[None, :], torch.exp(s_new - m_new[:, None]), 0.0)
    l = (acc["l"] - w.sum(dim=1)) * r + p.sum(dim=1)
    a = (acc["a"] - w @ v_dep.float()) * r[:, None] + p @ v_new.float()
    return dict(m=m_new, l=l, a=a), col_max


def init_rows(q_new: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
              mask_all: torch.Tensor, scale: float, slots: int = 0,
              slot_rows: int = 0):
    """Fresh accumulators for query rows over the whole live key set.

    q_new: (Q, Dk); k_all, v_all: (R, Dk), (R, Dv); mask_all: (R,).  With
    ``slots`` > 0 the keys are slot-major blocks of R // slots rows, and the
    per-slot logit maxima (Q, slots) are returned too (the new rows of the
    health table); ``slot_rows`` bounds the slot-covered key prefix."""
    s = _logits(q_new, k_all, scale).masked_fill(~mask_all[None, :],
                                                 -torch.inf)
    m = s.amax(dim=1)
    p = torch.where(mask_all[None, :], torch.exp(s - m[:, None]), 0.0)
    acc = dict(m=m, l=p.sum(dim=1), a=p @ v_all.float())
    if not slots:
        return acc
    cov = slot_rows or s.shape[1]
    slot_max = s[:, :cov].reshape(s.shape[0], slots, -1).amax(dim=2)
    return acc, slot_max


def finalize(acc: Acc) -> torch.Tensor:
    """(R, D) attention outputs; rows with an empty key set give zeros."""
    return acc["a"] / torch.clamp(acc["l"], min=TINY)[:, None]


def degenerate_rows(acc: Acc, slot_max: torch.Tensor, theta: float = THETA,
                    l_floor: float = L_FLOOR) -> torch.Tensor:
    """(R,) bool: rows whose accumulators can no longer be trusted.  The
    anchor sits more than ``theta`` nats above the true max live logit, the
    mass collapsed or is not finite, or the true max vanished while the
    anchor remains."""
    m_true = slot_max.amax(dim=1)
    alive = torch.isfinite(acc["m"])
    return alive & (~torch.isfinite(m_true)
                    | (acc["m"] - m_true > theta)
                    | (acc["l"] <= l_floor)
                    | ~torch.isfinite(acc["l"]))


def repair(acc: Acc, slot_max: torch.Tensor, q_all: torch.Tensor,
           k_all: torch.Tensor, v_all: torch.Tensor, mask_all: torch.Tensor,
           scale: float, slots: int, theta: float = THETA,
           slot_rows: int = 0) -> Tuple[Acc, torch.Tensor]:
    """Exact rebuild of every row's accumulators and health table when
    ``degenerate_rows`` flags any row; otherwise the inputs unchanged.

    The branch is taken on the host: ``bool(bad.any())`` reads one flag
    from the device and waits for the work queued before it.  That read is
    the price of repairing inside the step; the speculative rollback
    protocol (``engine/video_runner.py``) avoids it."""
    bad = degenerate_rows(acc, slot_max, theta)
    if bool(bad.any()):
        return init_rows(q_all, k_all, v_all, mask_all, scale, slots=slots,
                         slot_rows=slot_rows)
    return acc, slot_max
