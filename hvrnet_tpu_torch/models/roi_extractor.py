"""Single-level RoI extractor (counterpart of
``hvrnet_tpu/models/roi_extractor.py``): the shipped configs pool one
stride-16 map with RoIAlign(out 7, sample 2); training pools the frames of
a video in one call, by the frame index in each RoI."""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops.roi_align import roi_align


class SingleRoIExtractor:
    def __init__(self, roi_layer: dict, out_channels: int,
                 featmap_strides: Sequence[int],
                 feat_from_shared_head: bool = False):
        cfg = dict(roi_layer)
        if cfg.pop("type", "RoIAlign") != "RoIAlign" or \
                len(featmap_strides) != 1:
            raise ValueError("the port pools one map with RoIAlign")
        self.out_size = int(cfg.get("out_size", 7))
        self.sample_num = int(cfg.get("sample_num", 2))
        self.stride = int(featmap_strides[0])
        self.out_channels = out_channels
        self.feat_from_shared_head = feat_from_shared_head

    def __call__(self, feat: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """feat: (B, C, H, W); rois: (R, 5) rows of [frame index, x1, y1,
        x2, y2] → (R, C, out, out), differentiable in ``feat``."""
        return roi_align(feat, rois, self.out_size, 1.0 / self.stride,
                         self.sample_num)
