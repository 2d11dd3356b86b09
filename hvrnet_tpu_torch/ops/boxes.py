"""Box geometry (counterpart of ``hvrnet_tpu/ops/boxes.py``), with mmdet's
+1-pixel box conventions."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.),
               max_shape: Optional[Sequence[float]] = None,
               wh_ratio_clip: float = 16. / 1000.) -> torch.Tensor:
    """Decode (N, 4k) deltas on top of (N, 4) rois; ``max_shape`` = (h, w)
    clamps the boxes to the image."""
    rois = rois.float()
    deltas = deltas.float()
    k = deltas.shape[-1] // 4
    means = torch.tensor(means, dtype=torch.float32,
                         device=deltas.device).repeat(k)
    stds = torch.tensor(stds, dtype=torch.float32,
                        device=deltas.device).repeat(k)
    denorm = deltas * stds + means
    dx = denorm[..., 0::4]
    dy = denorm[..., 1::4]
    max_ratio = abs(float(np.log(wh_ratio_clip)))
    dw = denorm[..., 2::4].clamp(-max_ratio, max_ratio)
    dh = denorm[..., 3::4].clamp(-max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0] + 1.0)[..., None]
    ph = (rois[..., 3] - rois[..., 1] + 1.0)[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1 = gx - gw * 0.5 + 0.5
    y1 = gy - gh * 0.5 + 0.5
    x2 = gx + gw * 0.5 - 0.5
    y2 = gy + gh * 0.5 - 0.5
    if max_shape is not None:
        h = float(np.float32(max_shape[0]))
        w = float(np.float32(max_shape[1]))
        x1 = x1.clamp(0., w - 1.)
        y1 = y1.clamp(0., h - 1.)
        x2 = x2.clamp(0., w - 1.)
        y2 = y2.clamp(0., h - 1.)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(deltas.shape)


def bbox2result_np(bboxes: np.ndarray, labels: np.ndarray, num_classes: int):
    """Split (n, 5) dets into per-class numpy lists (mmdet ``bbox2result``);
    callers pre-filter padding rows with the validity mask."""
    if bboxes.shape[0] == 0:
        return [np.zeros((0, 5), dtype=np.float32)
                for _ in range(num_classes - 1)]
    return [bboxes[labels == i, :] for i in range(num_classes - 1)]
