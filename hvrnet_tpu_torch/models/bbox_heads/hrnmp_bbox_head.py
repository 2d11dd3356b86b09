"""HRNMP head (counterpart of
``hvrnet_tpu/models/bbox_heads/hrnmp_bbox_head.py``): the test path
``forward_fc1``, the streaming ring, and the training path
``forward_train`` with ``triplet_nonlocal_loss``.

Training graph, per video (its key frame's ``sampler_num`` rows first):
fc1 → NL1 (all rows) → fc2 → NL2 (key rows) → branch cls/reg → fc3 over
[NL2 output, fc1 of the other frames] → NL3 (key rows); then the key rows
of all videos together → fc4 → NL4 with explicit affinities, which also
feed the margin triplet loss.  NL1–NL3 go through the kernel.

Test graph: fc1 → NL1 (all rows) → fc2 → NL2 (key-frame query rows) →
branch cls/reg → fc3 over the spliced input [fc1 rows before the key frame,
NL2 output, fc1 rows after] → NL3 (all rows) → fc4 → NL4 (key-frame query
rows) → final cls/reg.  Queries are computed only for the rows each stage
keeps; the reference computes all rows and slices afterwards, with the same
result.  ``fc_new_1`` is row-wise and window-independent, so the runner
computes it once per frame (``precompute_fc1``) and caches its rows.

The streaming ring (``stream_*``, counterpart of the JAX head's
``stream_project`` … ``stream_rebuild``): NL1's q/k/v rows and NL3's rows
outside the key frame are row-wise functions of the per-frame fc1, so their
softmaxes are kept as streaming accumulators (``ops/streaming_attention.py``)
and updated by one frame per slide instead of recomputed over the window.
NL2 and NL4 have fresh key-frame queries at every step and stay exact
attentions through the kernel.  Valid when every cached row is a key
(t_dim·sampler_num ≥ T·P, which the engine checks).

Every layer computes in ``dtype`` (``core/precision.py``).  In bf16 the
ring's row caches are bf16 and its accumulators float32; an attention
output, float32, goes back to bf16 in ``out_proj`` before it meets the bf16
rows it is added to.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import NEG_INF
from ...ops.streaming_attention import (THETA, degenerate_rows, finalize,
                                        init_rows, repair, slide)
from ..layers import Linear
from ..registry import HEADS
from .bbox_head import flatten_roi_feats
from .selsa_bbox_head import SelsaAttention

POS_INF = 1e30


def triplet_nonlocal_loss(aff_scale: torch.Tensor, labels: torch.Tensor,
                          all_labels: torch.Tensor, margin: float,
                          key_mask: Optional[torch.Tensor] = None,
                          compat_inverted_mining: bool = True
                          ) -> torch.Tensor:
    """Hardest-proposal mining and the margin triplet loss over (Q, K)
    scaled affinities.  For each foreground query: the most similar key of
    another class and the least similar key of its own class (among valid
    keys); a query counts when it has both.  The reference puts the two in
    inverted slots (``compat_inverted_mining=True``), so its hinge is
    max(0, margin + sim_same_min − sim_diff_max)."""
    diff = labels[:, None] != all_labels[None, :]
    same = ~diff
    if key_mask is not None:
        diff = diff & key_mask[None, :]
        same = same & key_mask[None, :]
    sim_dc = torch.where(diff, aff_scale, NEG_INF).amax(dim=1)
    sim_sc = torch.where(same, aff_scale, POS_INF).amin(dim=1)
    valid = (labels > 0) & diff.any(dim=1) & same.any(dim=1)
    if compat_inverted_mining:
        sim_pos, sim_neg = sim_dc, sim_sc
    else:
        sim_pos, sim_neg = sim_sc, sim_dc
    per_anchor = torch.where(valid, (margin + sim_neg - sim_pos).clamp_min(0),
                             0.0)
    return per_anchor.sum() / valid.sum().float().clamp_min(1.0)


@HEADS.register_module
class HRNMPBBoxHead(nn.Module):

    def __init__(self, sampler_num: int = 128, t_dim: int = 9,
                 imgs_per_video: int = 3, fc_feat_dim: int = 1024,
                 dim: Sequence[int] = (1024, 1024, 1024),
                 roi_feat_size: int = 7, in_channels: int = 256,
                 num_classes: int = 31, reg_class_agnostic: bool = True,
                 triplet_margin: float = 10.0,
                 compat_inverted_mining: bool = True,
                 stream_theta: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sampler_num = sampler_num
        self.t_dim = t_dim
        self.imgs_per_video = imgs_per_video
        self.triplet_margin = triplet_margin
        self.compat_inverted_mining = compat_inverted_mining
        # the streaming ring's anchor-gap threshold in nats (None: THETA);
        # a config sets it to force the health flag on benign inputs
        self.stream_theta = THETA if stream_theta is None else \
            float(stream_theta)
        F_ = fc_feat_dim

        def linear(n_in, n_out):
            return Linear(n_in, n_out, compute_dtype=dtype)

        self.fc_new_1 = linear(in_channels * roi_feat_size ** 2, F_)
        self.fc_new_2 = linear(F_, F_)
        self.fc_new_3 = linear(F_, F_)
        self.fc_new_4 = linear(F_, F_)
        for i in (1, 2, 3, 4):
            self.add_module(f"selsa_{i}",
                            SelsaAttention(i, tuple(dim), F_, dtype))
        out_dim = 4 if reg_class_agnostic else 4 * num_classes
        self.fc_cls = linear(F_, num_classes)
        self.fc_cls_2 = linear(F_, num_classes)
        self.fc_reg = linear(F_, out_dim)
        self.fc_reg_2 = linear(F_, out_dim)

    def precompute_fc1(self, bbox_feat: torch.Tensor) -> torch.Tensor:
        """(N, C, 7, 7) pooled RoIs → (N, fc_feat_dim) fc_new_1 rows."""
        return self.fc_new_1(flatten_roi_feats(bbox_feat))

    def forward_train(self, bbox_feats: torch.Tensor,
                      labels_key: torch.Tensor,
                      valid_mask: Optional[torch.Tensor] = None):
        """bbox_feats: (V, N, C, 7, 7) pooled RoIs of V videos, N =
        imgs_per_video·sampler_num rows each with the key frame's first;
        labels_key: (V·sampler_num,) key-frame labels; valid_mask: (V, N).
        Returns ([cls_branch, cls_final], [reg_branch, reg_final],
        loss_trip), each over the V·sampler_num key rows."""
        V, N = bbox_feats.shape[0], bbox_feats.shape[1]
        S = self.sampler_num
        nongt = min(self.imgs_per_video * S, N)
        cls_b, reg_b, feats3, masks3 = [], [], [], []
        for v in range(V):
            vmask = valid_mask[v] if valid_mask is not None else None
            kmask = vmask[:nongt] if vmask is not None else None
            fc1 = self.fc_new_1(flatten_roi_feats(bbox_feats[v]))
            fc_all_1 = F.relu(fc1 + self.selsa_1(fc1, fc1[:nongt], kmask))
            fc2 = self.fc_new_2(fc_all_1)
            fc_all_2 = F.relu(fc2[:S] + self.selsa_2(fc2[:S], fc2[:nongt],
                                                     kmask))
            cls_b.append(self.fc_cls(fc_all_2))
            reg_b.append(self.fc_reg(fc_all_2))
            fc3 = self.fc_new_3(torch.cat([fc_all_2, fc1[S:]]))
            feats3.append(F.relu(fc3[:S] + self.selsa_3(fc3[:S], fc3[:nongt],
                                                        kmask)))
            masks3.append(vmask[:S] if vmask is not None else
                          torch.ones(S, dtype=torch.bool,
                                     device=bbox_feats.device))
        feats4 = torch.cat(feats3)
        mask4 = torch.cat(masks3)
        nongt4 = min(S * self.t_dim, feats4.shape[0])
        fc4 = self.fc_new_4(feats4)
        att4, aff4 = self.selsa_4(fc4, fc4[:nongt4], mask4[:nongt4],
                                  return_aff=True)
        fc_all_4 = F.relu(fc4 + att4)
        loss_trip = triplet_nonlocal_loss(
            aff4, labels_key, labels_key[:nongt4], self.triplet_margin,
            key_mask=mask4[:nongt4],
            compat_inverted_mining=self.compat_inverted_mining)
        return ([torch.cat(cls_b), self.fc_cls_2(fc_all_4)],
                [torch.cat(reg_b), self.fc_reg_2(fc_all_4)], loss_trip)

    def forward_fc1(self, fc1: torch.Tensor, cur_start: int, cur_len: int,
                    valid_mask: Optional[torch.Tensor] = None):
        """fc1: (N, D) window rows, oldest frame first, or (B, N, D) over B
        lanes with ``valid_mask`` (B, N); the key frame's rows are
        [cur_start, cur_start + cur_len).  Returns
        ([cls_branch, cls_final], [reg_branch, reg_final]) for the key rows."""
        N = fc1.shape[-2]
        nongt = min(self.sampler_num * self.t_dim, N)
        kmask = valid_mask[..., :nongt] if valid_mask is not None else None
        s, e = cur_start, cur_start + cur_len

        def rows(x, a=None, b=None):
            return x[..., a:b, :]

        fc_all_1 = F.relu(fc1 + self.selsa_1(fc1, rows(fc1, b=nongt), kmask))

        fc2 = self.fc_new_2(fc_all_1)
        q2 = rows(fc2, s, e)
        fc_all_2_cur = F.relu(q2 + self.selsa_2(q2, rows(fc2, b=nongt),
                                                kmask))
        cls_branch = self.fc_cls(fc_all_2_cur)
        reg_branch = self.fc_reg(fc_all_2_cur)

        fc3 = self.fc_new_3(torch.cat([rows(fc1, b=s), fc_all_2_cur,
                                       rows(fc1, a=e)], dim=-2))
        fc_all_3 = F.relu(fc3 + self.selsa_3(fc3, rows(fc3, b=nongt), kmask))

        fc4 = self.fc_new_4(fc_all_3)
        q4 = rows(fc4, s, e)
        fc_all_4 = F.relu(q4 + self.selsa_4(q4, rows(fc4, b=nongt), kmask))
        return ([cls_branch, self.fc_cls_2(fc_all_4)],
                [reg_branch, self.fc_reg_2(fc_all_4)])

    # ------------------------------------------------------ streaming ring
    # The state ``st`` holds mask (T, P) and, flat over the R = T·P rows
    # (slot-major), the stationary caches fc1, q1, k1, fc3s, q3, k3 (R, D),
    # the accumulators m1, l1, m3, l3 (R,) and a1, a3 (R, D), and the health
    # tables M1, M3 (R, T) of per-(row, slot) logit maxima.

    def stream_project(self, fc1_new: torch.Tensor):
        """A frame's stationary rows: NL1's q/k, the fc_new_3 projection
        (NL3's input rows outside the key frame) and its q/k."""
        fc3s = self.fc_new_3(fc1_new)
        return dict(q1=self.selsa_1.q_proj(fc1_new),
                    k1=self.selsa_1.k_proj(fc1_new), fc3s=fc3s,
                    q3=self.selsa_3.q_proj(fc3s),
                    k3=self.selsa_3.k_proj(fc3s))

    def stream_update(self, st: dict, fc1_new: torch.Tensor,
                      mask_new: torch.Tensor, slot: int,
                      rollback: bool = False):
        """Slide the window, in place: ring slot ``slot``'s keys leave the
        NL1/NL3 accumulators and the arriving frame's enter, the slot's
        stationary caches are overwritten, and the arriving rows get exact
        fresh accumulators.

        ``rollback=False`` rebuilds both blocks exactly when either is
        degenerate (``ops/streaming_attention.repair``: one host read) and
        returns ``st``.  ``rollback=True`` commits the slid accumulators as
        they are and returns ``(st, bad)``, ``bad`` a device bool the caller
        keeps as a sticky flag."""
        T, P = st["mask"].shape
        R = T * P
        rows = slice(slot * P, (slot + 1) * P)
        proj = self.stream_project(fc1_new)
        # the departing keys and values, read before their rows are written
        mask_dep = st["mask"][slot].clone()
        dep = {k: st[k][rows].clone() for k in ("k1", "fc1", "k3", "fc3s")}
        st["mask"][slot] = mask_new
        st["fc1"][rows] = fc1_new
        for k in ("q1", "k1", "fc3s", "q3", "k3"):
            st[k][rows] = proj[k]
        mask_all = st["mask"].reshape(R)

        def slide_block(name, vkey, scale):
            # the slot's own rows slide too, then take fresh accumulators
            acc = dict(m=st["m" + name], l=st["l" + name], a=st["a" + name])
            acc, col = slide(acc, st["q" + name], dep["k" + name], dep[vkey],
                             mask_dep, proj["k" + name], st[vkey][rows],
                             mask_new, scale)
            M = st["M" + name].clone()
            M[:, slot] = col
            fresh, fresh_M = init_rows(proj["q" + name], st["k" + name],
                                       st[vkey], mask_all, scale, slots=T,
                                       slot_rows=R)
            for key in ("m", "l", "a"):
                acc[key][rows] = fresh[key]
            M[rows] = fresh_M
            return acc, M

        acc1, M1 = slide_block("1", "fc1", self.selsa_1.scale)
        acc3, M3 = slide_block("3", "fc3s", self.selsa_3.scale)
        bad = (degenerate_rows(acc1, M1, self.stream_theta).any()
               | degenerate_rows(acc3, M3, self.stream_theta).any())
        if not rollback and bool(bad):
            # rebuilding a healthy block beside a degenerate one is exact too
            self._commit(st, *self._rebuild_blocks(st))
            return st
        self._commit(st, acc1, M1, acc3, M3)
        return (st, bad) if rollback else st

    def stream_forward(self, st: dict, center: int, rollback: bool = False):
        """The key frame's predictions from the streaming state: equal to
        ``forward_fc1`` with the key frame at ring slot ``center``, up to the
        accumulators' rounding.  ``st`` is left unchanged.

        NL1's output comes from the accumulators.  NL3 applies the key-frame
        splice as a temporary slide of the centre slot's stationary rows out
        and the fresh fc_all_2 rows in, plus one exact pass for the centre
        rows' fresh queries.  ``rollback=False`` repairs the slid NL3
        accumulators when degenerate (a host read) and returns
        (cls_list, reg_list); ``rollback=True`` returns (cls_list, reg_list,
        bad) instead."""
        T, P = st["mask"].shape
        R = T * P
        rows = slice(center * P, (center + 1) * P)
        mask_all = st["mask"].reshape(R)

        att1 = self.selsa_1.out_proj(
            finalize(dict(m=st["m1"], l=st["l1"], a=st["a1"])))
        fc_all_1 = F.relu(st["fc1"] + att1)
        fc2 = self.fc_new_2(fc_all_1)
        fc2_c = fc2[rows]
        fc_all_2_cur = F.relu(fc2_c + self.selsa_2(fc2_c, fc2, mask_all))
        cls_branch = self.fc_cls(fc_all_2_cur)
        reg_branch = self.fc_reg(fc_all_2_cur)

        fc3f = self.fc_new_3(fc_all_2_cur)
        q3f = self.selsa_3.q_proj(fc3f)
        k3f = self.selsa_3.k_proj(fc3f)
        scale3 = self.selsa_3.scale
        k3_eff = st["k3"].clone()
        k3_eff[rows] = k3f
        fc3_eff = st["fc3s"].clone()
        fc3_eff[rows] = fc3f
        mask_c = st["mask"][center]
        acc3, col3 = slide(dict(m=st["m3"], l=st["l3"], a=st["a3"]),
                           st["q3"], st["k3"][rows], st["fc3s"][rows],
                           mask_c, k3f, fc3f, mask_c, scale3)
        M3 = st["M3"].clone()
        M3[:, center] = col3
        if rollback:
            bad = degenerate_rows(acc3, M3, self.stream_theta).any()
        else:
            acc3, _ = repair(acc3, M3, st["q3"], k3_eff, fc3_eff, mask_all,
                             scale3, T, theta=self.stream_theta, slot_rows=R)
        att3 = finalize(acc3)
        att3[rows] = finalize(init_rows(q3f, k3_eff, fc3_eff, mask_all,
                                        scale3))
        fc_all_3 = F.relu(fc3_eff + self.selsa_3.out_proj(att3))

        fc4 = self.fc_new_4(fc_all_3)
        fc4_c = fc4[rows]
        fc_all_4 = F.relu(fc4_c + self.selsa_4(fc4_c, fc4, mask_all))
        cls = [cls_branch, self.fc_cls_2(fc_all_4)]
        reg = [reg_branch, self.fc_reg_2(fc_all_4)]
        return (cls, reg, bad) if rollback else (cls, reg)

    def stream_rebuild(self, st: dict) -> dict:
        """Exact rebuild of both blocks' accumulators and health tables from
        the ring's caches, in place: one (R, R) pass per block."""
        self._commit(st, *self._rebuild_blocks(st))
        return st

    def _rebuild_blocks(self, st):
        T, P = st["mask"].shape
        mask_all = st["mask"].reshape(T * P)
        acc1, M1 = init_rows(st["q1"], st["k1"], st["fc1"], mask_all,
                             self.selsa_1.scale, slots=T, slot_rows=T * P)
        acc3, M3 = init_rows(st["q3"], st["k3"], st["fc3s"], mask_all,
                             self.selsa_3.scale, slots=T, slot_rows=T * P)
        return acc1, M1, acc3, M3

    @staticmethod
    def _commit(st, acc1, M1, acc3, M3):
        for name, acc, M in (("1", acc1, M1), ("3", acc3, M3)):
            for key in ("m", "l", "a"):
                st[key + name] = acc[key]
            st["M" + name] = M
