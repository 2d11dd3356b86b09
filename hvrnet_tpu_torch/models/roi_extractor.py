"""Single-level RoI extractor (counterpart of
``hvrnet_tpu/models/roi_extractor.py``): the shipped configs pool one
stride-16 map with RoIAlign(out 7, sample 2)."""
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
        """feat: (1, C, H, W); rois: (R, 5) → (R, C, out, out)."""
        return roi_align(feat, rois, self.out_size, 1.0 / self.stride,
                         self.sample_num)
