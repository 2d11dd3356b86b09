"""HRNMP head, test path (counterpart of
``hvrnet_tpu/models/bbox_heads/hrnmp_bbox_head.py:forward_fc1``).

Test graph: fc1 → NL1 (all rows) → fc2 → NL2 (key-frame query rows) →
branch cls/reg → fc3 over the spliced input [fc1 rows before the key frame,
NL2 output, fc1 rows after] → NL3 (all rows) → fc4 → NL4 (key-frame query
rows) → final cls/reg.  Queries are computed only for the rows each stage
keeps; the reference computes all rows and slices afterwards, with the same
result.  ``fc_new_1`` is row-wise and window-independent, so the runner
computes it once per frame (``precompute_fc1``) and caches its rows.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import HEADS
from .bbox_head import flatten_roi_feats
from .selsa_bbox_head import SelsaAttention


@HEADS.register_module
class HRNMPBBoxHead(nn.Module):

    def __init__(self, sampler_num: int = 128, t_dim: int = 9,
                 fc_feat_dim: int = 1024,
                 dim: Sequence[int] = (1024, 1024, 1024),
                 roi_feat_size: int = 7, in_channels: int = 256,
                 num_classes: int = 31, reg_class_agnostic: bool = True):
        super().__init__()
        self.sampler_num = sampler_num
        self.t_dim = t_dim
        F_ = fc_feat_dim
        self.fc_new_1 = nn.Linear(in_channels * roi_feat_size ** 2, F_)
        self.fc_new_2 = nn.Linear(F_, F_)
        self.fc_new_3 = nn.Linear(F_, F_)
        self.fc_new_4 = nn.Linear(F_, F_)
        for i in (1, 2, 3, 4):
            self.add_module(f"selsa_{i}", SelsaAttention(i, tuple(dim), F_))
        out_dim = 4 if reg_class_agnostic else 4 * num_classes
        self.fc_cls = nn.Linear(F_, num_classes)
        self.fc_cls_2 = nn.Linear(F_, num_classes)
        self.fc_reg = nn.Linear(F_, out_dim)
        self.fc_reg_2 = nn.Linear(F_, out_dim)

    def precompute_fc1(self, bbox_feat: torch.Tensor) -> torch.Tensor:
        """(N, C, 7, 7) pooled RoIs → (N, fc_feat_dim) fc_new_1 rows."""
        return self.fc_new_1(flatten_roi_feats(bbox_feat))

    def forward_fc1(self, fc1: torch.Tensor, cur_start: int, cur_len: int,
                    valid_mask: Optional[torch.Tensor] = None):
        """fc1: (N, D) window rows, oldest frame first; the key frame's rows
        are [cur_start, cur_start + cur_len).  Returns
        ([cls_branch, cls_final], [reg_branch, reg_final]) for the key rows."""
        N = fc1.shape[0]
        nongt = min(self.sampler_num * self.t_dim, N)
        kmask = valid_mask[:nongt] if valid_mask is not None else None
        s, e = cur_start, cur_start + cur_len

        fc_all_1 = F.relu(fc1 + self.selsa_1(fc1, fc1[:nongt], kmask))

        fc2 = self.fc_new_2(fc_all_1)
        q2 = fc2[s:e]
        fc_all_2_cur = F.relu(q2 + self.selsa_2(q2, fc2[:nongt], kmask))
        cls_branch = self.fc_cls(fc_all_2_cur)
        reg_branch = self.fc_reg(fc_all_2_cur)

        fc3 = self.fc_new_3(torch.cat([fc1[:s], fc_all_2_cur, fc1[e:]]))
        fc_all_3 = F.relu(fc3 + self.selsa_3(fc3, fc3[:nongt], kmask))

        fc4 = self.fc_new_4(fc_all_3)
        q4 = fc4[s:e]
        fc_all_4 = F.relu(q4 + self.selsa_4(q4, fc4[:nongt], kmask))
        return ([cls_branch, self.fc_cls_2(fc_all_4)],
                [reg_branch, self.fc_reg_2(fc_all_4)])
