"""RoIPool (max pooling), counterpart of ``hvrnet_tpu/ops/roi_pool.py``.

The JAX op's rules, from mmdet's ``roi_pool_kernel.cu``: start and end =
``round(coord · spatial_scale)`` (half to even, as ``jnp.round`` and
``torch.round``), width ``max(end − start + 1, 1)``, bin size width / out
(as XLA computes it: width · float32(1 / out));
bin ph spans rows [start + floor(ph · bin), start + ceil((ph + 1) · bin)),
the low end clamped to [0, H − 1] and the high end to [0, H]; a bin reads
at most ``MAX_BIN`` rows (and columns) from its low end, so a wider bin is
truncated; an empty bin, and a bin whose max is not finite, is 0.

The JAX op gathers a (R, s, s, MAX_BIN, MAX_BIN, C) block and takes its
max, ~62 GB at 300 RoIs on a 1024-channel map.  A max is exact in any
order, so this op answers each bin's rectangle from a two-dimensional
sparse table instead: table (p, q) holds the max over the 2^p × 2^q
window at each position, built by doubling, and a rectangle of h × w
cells (2^p ≤ h < 2^(p+1), likewise q) is the max of four overlapping
lookups.  Only the levels this call's bins reach are built
((p_max + 1) · (q_max + 1) maps of the features' size); the result is bit
for bit the JAX op's.
"""
from __future__ import annotations

import torch

MAX_BIN = 32


def _bin_ranges(start: torch.Tensor, bin_size: torch.Tensor, dim: int,
                out_size: int):
    """(low, length) of each RoI's bins along one axis, (R, out) each;
    length ≤ 0 for an empty bin, ≤ MAX_BIN always."""
    ph = torch.arange(out_size, dtype=torch.float32, device=start.device)
    lo = torch.floor(ph[None, :] * bin_size[:, None]).to(torch.int64) \
        + start[:, None]
    hi = torch.ceil((ph[None, :] + 1.0) * bin_size[:, None]).to(
        torch.int64) + start[:, None]
    lo = lo.clamp(0, dim - 1)
    hi = hi.clamp(0, dim)
    return lo, torch.minimum(hi, lo + MAX_BIN) - lo


def _floor_log2(n: torch.Tensor) -> torch.Tensor:
    """floor(log2 n) of integers 1 … MAX_BIN (0 elsewhere)."""
    table = torch.tensor([0, 0] + [k.bit_length() - 1
                                   for k in range(2, MAX_BIN + 1)],
                         device=n.device)
    return table[n.clamp(0, MAX_BIN)]


def _shift_max(t: torch.Tensor, step: int, dim: int) -> torch.Tensor:
    """max(t[i], t[min(i + step, n − 1)]) along ``dim``."""
    n = t.shape[dim]
    idx = torch.arange(n, device=t.device).add_(step).clamp_(max=n - 1)
    return torch.maximum(t, t.index_select(dim, idx))


def roi_pool(feats: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
             spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """feats (B, C, H, W); rois (R, 5) rows of [batch index, x1, y1, x2,
    y2] → (R, C, out_size, out_size) in the features' dtype."""
    B, C, H, W = feats.shape
    R, s = rois.shape[0], out_size
    if R == 0:
        return feats.new_zeros((0, C, s, s))
    rois = rois.float()
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * spatial_scale).to(
        torch.int32).to(torch.int64) for k in range(1, 5))
    roi_w = torch.clamp(x2 - x1 + 1, min=1).float()
    roi_h = torch.clamp(y2 - y1 + 1, min=1).float()
    # the bin size as XLA computes width / out: times the float32
    # reciprocal (11 / 7 rounds to 1.5714285, 11 · (1 / 7) to 1.5714287,
    # and ceil(7 · bin) then gives 11 or 12)
    inv = torch.full((), 1.0 / s, dtype=torch.float32, device=rois.device)
    y_lo, y_n = _bin_ranges(y1, roi_h * inv, H, s)
    x_lo, x_n = _bin_ranges(x1, roi_w * inv, W, s)
    py, qx = _floor_log2(y_n), _floor_log2(x_n)          # (R, s)
    p_max, q_max = int(py.max()), int(qx.max())
    # tables[p][q] (B, C, H, W): the max over rows y … y + 2^p − 1 and
    # columns x … x + 2^q − 1 (clamped at the edge, which no lookup reads)
    rows = [feats]
    for p in range(1, p_max + 1):
        rows.append(_shift_max(rows[-1], 2 ** (p - 1), 2))
    tables = []
    for t in rows:
        level = [t]
        for q in range(1, q_max + 1):
            level.append(_shift_max(level[-1], 2 ** (q - 1), 3))
        tables.append(torch.stack(level))
    table = torch.stack(tables)                    # (P, Q, B, C, H, W)
    # per bin (R, s, s): its levels, and the four corners' positions
    p = py[:, :, None].expand(R, s, s)
    q = qx[:, None, :].expand(R, s, s)
    y0 = y_lo[:, :, None].expand(R, s, s)
    x0 = x_lo[:, None, :].expand(R, s, s)
    y1_ = (y_lo + y_n - 2 ** py)[:, :, None].expand(R, s, s).clamp(min=0)
    x1_ = (x_lo + x_n - 2 ** qx)[:, None, :].expand(R, s, s).clamp(min=0)
    bb = b[:, None, None].expand(R, s, s)
    out = torch.maximum(
        torch.maximum(table[p, q, bb, :, y0, x0], table[p, q, bb, :, y0, x1_]),
        torch.maximum(table[p, q, bb, :, y1_, x0],
                      table[p, q, bb, :, y1_, x1_]))        # (R, s, s, C)
    # empty bins, and (as the JAX op's isfinite) non-finite maxima, → 0
    empty = ((y_n <= 0)[:, :, None] | (x_n <= 0)[:, None, :])[..., None]
    out = out.masked_fill(empty | ~torch.isfinite(out), 0)
    return out.permute(0, 3, 1, 2).contiguous()
