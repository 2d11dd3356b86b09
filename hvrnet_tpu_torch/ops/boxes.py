"""Box geometry (counterpart of ``hvrnet_tpu/ops/boxes.py``), with mmdet's
+1-pixel box conventions."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.)) -> torch.Tensor:
    """Encode (N, 4) gt boxes relative to (N, 4) proposals."""
    proposals = proposals.float()
    gt = gt.float()
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    means = torch.tensor(means, dtype=torch.float32, device=deltas.device)
    stds = torch.tensor(stds, dtype=torch.float32, device=deltas.device)
    return (deltas - means) / stds


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (M, 4) and (N, 4) boxes → (M, N)."""
    b1 = bboxes1.float()
    b2 = bboxes2.float()
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:4], b2[None, :, 2:4])
    wh = (rb - lt + 1.0).clamp_min(0.0)
    overlap = wh[..., 0] * wh[..., 1]
    area1 = (b1[:, 2] - b1[:, 0] + 1.0) * (b1[:, 3] - b1[:, 1] + 1.0)
    area2 = (b2[:, 2] - b2[:, 0] + 1.0) * (b2[:, 3] - b2[:, 1] + 1.0)
    union = area1[:, None] + area2[None, :] - overlap
    return overlap / union.clamp_min(1e-10)


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


def bbox_flip(bboxes: torch.Tensor, img_shape) -> torch.Tensor:
    """Horizontal flip of (..., 4·k) boxes in an image of ``img_shape``
    (h, w, …), mmdet's +1 convention: x ↦ w − x − 1."""
    w = float(np.float32(img_shape[1]))
    flipped = bboxes.clone()
    flipped[..., 0::4] = w - bboxes[..., 2::4] - 1
    flipped[..., 2::4] = w - bboxes[..., 0::4] - 1
    return flipped


def bbox_mapping(bboxes: torch.Tensor, img_shape, scale_factor,
                 flip: bool) -> torch.Tensor:
    """Original-image boxes into an augmentation's coordinates: scaled,
    then flipped in its ``img_shape``."""
    new = bboxes * _as_factor(scale_factor, bboxes)
    return bbox_flip(new, img_shape) if flip else new


def bbox_mapping_back(bboxes: torch.Tensor, img_shape, scale_factor,
                      flip: bool) -> torch.Tensor:
    """An augmentation's boxes back into original-image coordinates."""
    new = bbox_flip(bboxes, img_shape) if flip else bboxes
    return new / _as_factor(scale_factor, bboxes)


def _as_factor(scale_factor, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(scale_factor, dtype=torch.float32,
                           device=like.device)


def bbox2result_np(bboxes: np.ndarray, labels: np.ndarray, num_classes: int):
    """Split (n, 5) dets into per-class numpy lists (mmdet ``bbox2result``);
    callers pre-filter padding rows with the validity mask."""
    if bboxes.shape[0] == 0:
        return [np.zeros((0, 5), dtype=np.float32)
                for _ in range(num_classes - 1)]
    return [bboxes[labels == i, :] for i in range(num_classes - 1)]
