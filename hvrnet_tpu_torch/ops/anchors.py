"""Anchor generation — numpy host constants (the port's copy of
``hvrnet_tpu/ops/anchors.py:AnchorGenerator``).

Matches mmdet's ``AnchorGenerator`` exactly, including the round() of base
anchors and the −1/+1 centre convention.  Anchors for a fixed canvas are
constants, so they are generated once on the host.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class AnchorGenerator:
    def __init__(self, base_size: float, scales: Sequence[float],
                 ratios: Sequence[float], scale_major: bool = True):
        self.base_size = base_size
        self.scales = np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.scale_major = scale_major
        self.base_anchors = self.gen_base_anchors()

    @property
    def num_base_anchors(self) -> int:
        return self.base_anchors.shape[0]

    def gen_base_anchors(self) -> np.ndarray:
        w = h = self.base_size
        x_ctr = 0.5 * (w - 1)
        y_ctr = 0.5 * (h - 1)
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        else:
            ws = (w * self.scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * self.scales[:, None] * h_ratios[None, :]).reshape(-1)
        base = np.stack([
            x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)
        ], axis=-1)
        # torch.round rounds half-to-even; np.round matches
        return np.round(base).astype(np.float32)

    def grid_anchors(self, featmap_size: Tuple[int, int],
                     stride: int = 16) -> np.ndarray:
        feat_h, feat_w = featmap_size
        shift_x = np.arange(0, feat_w, dtype=np.float32) * stride
        shift_y = np.arange(0, feat_h, dtype=np.float32) * stride
        xx = np.tile(shift_x, feat_h)
        yy = np.repeat(shift_y, feat_w)
        shifts = np.stack([xx, yy, xx, yy], axis=-1)
        all_anchors = self.base_anchors[None, :, :] + shifts[:, None, :]
        return all_anchors.reshape(-1, 4).astype(np.float32)
