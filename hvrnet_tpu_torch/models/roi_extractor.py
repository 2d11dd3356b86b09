"""RoI extractor (counterpart of ``hvrnet_tpu/models/roi_extractor.py``):
RoIAlign over one map or a list of maps.  The shipped configs pool one
stride-16 map with RoIAlign(out 7, sample 2); training pools the frames of
a video in one call, by the frame index in each RoI.  Over several maps
each RoI goes to one level by its scale (``map_roi_levels``, mmdet's
``finest_scale`` rule) and the levels' pools are summed under their 0/1
masks, as in the JAX package.  ``RoIPool`` is not ported yet."""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops.roi_align import roi_align


class SingleRoIExtractor:
    def __init__(self, roi_layer: dict, out_channels: int,
                 featmap_strides: Sequence[int],
                 feat_from_shared_head: bool = False,
                 finest_scale: int = 56):
        cfg = dict(roi_layer)
        layer = cfg.pop("type", "RoIAlign")
        if layer == "RoIPool":
            raise NotImplementedError("RoIPool is not ported yet (it waits "
                                      "for ops/roi_pool.py)")
        if layer != "RoIAlign":
            raise ValueError(f"unknown roi layer {layer}")
        self.out_size = int(cfg.get("out_size", 7))
        self.sample_num = int(cfg.get("sample_num", 2))
        self.featmap_strides = [int(s) for s in featmap_strides]
        self.out_channels = out_channels
        self.feat_from_shared_head = feat_from_shared_head
        self.finest_scale = finest_scale

    def map_roi_levels(self, rois: torch.Tensor,
                       num_levels: int) -> torch.Tensor:
        """Each RoI's level: floor(log2(sqrt(w·h) / finest_scale + 1e-6)),
        clamped to [0, num_levels - 1] (mmdet's ``single_level.py:54-73``,
        +1 widths)."""
        scale = torch.sqrt((rois[:, 3] - rois[:, 1] + 1)
                           * (rois[:, 4] - rois[:, 2] + 1))
        target = torch.floor(torch.log2(scale / self.finest_scale + 1e-6))
        return target.clamp(0, num_levels - 1).long()

    def _pool(self, feat, rois, stride):
        return roi_align(feat, rois, self.out_size, 1.0 / stride,
                         self.sample_num)

    def __call__(self, feats, rois: torch.Tensor) -> torch.Tensor:
        """feats: a (B, C, H, W) map or a list of them, one per stride;
        rois: (R, 5) rows of [frame index, x1, y1, x2, y2] → (R, C, out,
        out), differentiable in the maps."""
        if not isinstance(feats, (list, tuple)):
            feats = [feats]
        num_levels = min(len(feats), len(self.featmap_strides))
        if num_levels == 1:
            return self._pool(feats[0], rois, self.featmap_strides[0])
        levels = self.map_roi_levels(rois, num_levels)
        out = None
        for lvl in range(num_levels):
            pooled = self._pool(feats[lvl], rois, self.featmap_strides[lvl])
            sel = (levels == lvl)[:, None, None, None].to(pooled.dtype)
            out = pooled * sel if out is None else out + pooled * sel
        return out
