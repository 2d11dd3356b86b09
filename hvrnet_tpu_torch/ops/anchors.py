"""Anchor generation — numpy host constants (the port's copy of
``hvrnet_tpu/ops/anchors.py``: ``AnchorGenerator``, and SSD's per-level
generators ``ssd_anchor_generators`` / ``ssd_anchor_generators_from_cfg``).

Matches mmdet's ``AnchorGenerator`` exactly, including the round() of base
anchors and the −1/+1 centre convention.  Anchors for a fixed canvas are
constants, so they are generated once on the host.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class AnchorGenerator:
    def __init__(self, base_size: float, scales: Sequence[float],
                 ratios: Sequence[float], scale_major: bool = True,
                 ctr=None):
        self.base_size = base_size
        self.scales = np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.scale_major = scale_major
        self.ctr = ctr
        self.base_anchors = self.gen_base_anchors()

    @property
    def num_base_anchors(self) -> int:
        return self.base_anchors.shape[0]

    def gen_base_anchors(self) -> np.ndarray:
        w = h = self.base_size
        if self.ctr is None:
            x_ctr = 0.5 * (w - 1)
            y_ctr = 0.5 * (h - 1)
        else:
            x_ctr, y_ctr = self.ctr
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

    def reorder_base_anchors(self, indices: Sequence[int]):
        """Keep the base anchors at ``indices``, in that order."""
        self.base_anchors = self.base_anchors[np.asarray(indices)]
        return self


def ssd_anchor_generators_from_cfg(head_cfg):
    """SSD's per-level generators and strides from an ``SSDHead`` config
    (``input_size``, ``anchor_strides``, ``basesize_ratio_range``,
    ``anchor_ratios``): the one source of the training and test anchors."""
    strides = tuple(head_cfg.get("anchor_strides", (8, 16, 32, 64, 100, 300)))
    gens = ssd_anchor_generators(
        input_size=int(head_cfg.get("input_size", 300)),
        num_levels=len(strides), anchor_strides=strides,
        basesize_ratio_range=tuple(head_cfg.get("basesize_ratio_range",
                                                (0.1, 0.9))),
        anchor_ratios=head_cfg.get(
            "anchor_ratios", ([2], [2, 3], [2, 3], [2, 3], [2], [2])))
    return gens, strides


def ssd_anchor_generators(input_size: int = 300, num_levels: int = 6,
                          anchor_strides: Sequence[int] = (8, 16, 32, 64,
                                                           100, 300),
                          basesize_ratio_range: Tuple[float, float] = (0.1,
                                                                       0.9),
                          anchor_ratios: Sequence[Sequence[float]] = (
                              [2], [2, 3], [2, 3], [2, 3], [2], [2])):
    """Per-level SSD anchor generators (mmdet ``ssd_head.py:47-90``): min
    and max sizes from the basesize ratio range, with the first level
    special-cased for SSD300 (COCO 0.15, VOC 0.2) and SSD512 (COCO 0.1, VOC
    0.15); per level scales [1, sqrt(max/min)], ratios [1, 1/r, r, …],
    ``scale_major=False``, the centre at (stride − 1)/2, and the base
    anchors reordered so that the scale-2 square comes second."""
    min_ratio, max_ratio = basesize_ratio_range
    min_ratio = int(min_ratio * 100)
    max_ratio = int(max_ratio * 100)
    step = int(np.floor(max_ratio - min_ratio) / (num_levels - 2))
    min_sizes, max_sizes = [], []
    for r in range(min_ratio, max_ratio + 1, step):
        min_sizes.append(int(input_size * r / 100))
        max_sizes.append(int(input_size * (r + step) / 100))
    first = {(300, 0.15): (7, 15), (300, 0.2): (10, 20),
             (512, 0.1): (4, 10), (512, 0.15): (7, 15)}.get(
                 (input_size, basesize_ratio_range[0]))
    if first is not None:
        min_sizes.insert(0, int(input_size * first[0] / 100))
        max_sizes.insert(0, int(input_size * first[1] / 100))
    gens = []
    for k in range(num_levels):
        stride = anchor_strides[k]
        ctr = ((stride - 1) / 2.0, (stride - 1) / 2.0)
        scales = [1.0, np.sqrt(max_sizes[k] / min_sizes[k])]
        ratios = [1.0]
        for r in anchor_ratios[k]:
            ratios += [1.0 / r, r]
        gen = AnchorGenerator(min_sizes[k], scales, ratios, scale_major=False,
                              ctr=ctr)
        indices = list(range(len(ratios)))
        indices.insert(1, len(indices))
        gens.append(gen.reorder_base_anchors(indices))
    return gens
