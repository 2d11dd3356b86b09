"""Static canvas and its anchors (counterpart of ``hvrnet_tpu/engine/canvas.py``).

Frames are padded onto a static canvas (608×1008 landscape or its portrait
twin for the (1000, 600) keep-ratio operating point).  The canvas anchors
are constants; per-frame anchor validity over the true padded extent
(mmdet ``valid_flags``) is a mask over the static grid.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.anchors import AnchorGenerator


class Canvas:
    """One static (H, W) image canvas and its anchor constants on a device."""

    def __init__(self, height: int, width: int, stride: int = 16,
                 scales: Sequence[float] = (4, 8, 16, 32),
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 device: torch.device = torch.device("cpu")):
        if height % stride or width % stride:
            raise ValueError(f"canvas {height}x{width} is not a multiple of "
                             f"the stride {stride}")
        self.height, self.width, self.stride = height, width, stride
        self.feat_h, self.feat_w = height // stride, width // stride
        gen = AnchorGenerator(stride, scales, ratios)
        anchors = gen.grid_anchors((self.feat_h, self.feat_w), stride)
        self.anchors = torch.from_numpy(anchors).to(device)
        cell = np.arange(anchors.shape[0]) // gen.num_base_anchors
        self.cell_y = torch.from_numpy(cell // self.feat_w).to(device)
        self.cell_x = torch.from_numpy(cell % self.feat_w).to(device)

    def anchor_valid(self, pad_shape) -> torch.Tensor:
        """(A,) bool — anchors whose grid cell lies inside the true padded
        extent (valid_feat = ceil(pad / stride))."""
        stride = np.float32(self.stride)
        vh = min(int(np.ceil(np.float32(pad_shape[0]) / stride)), self.feat_h)
        vw = min(int(np.ceil(np.float32(pad_shape[1]) / stride)), self.feat_w)
        return (self.cell_y < vh) & (self.cell_x < vw)


def pick_canvas_shape(img_h: int, img_w: int, max_long: int = 1008,
                      max_short: int = 608) -> Tuple[int, int]:
    """The landscape canvas for a landscape or square frame, else its
    portrait twin."""
    if img_w >= img_h:
        return (max_short, max_long)
    return (max_long, max_short)


class FrameTooLarge(ValueError):
    """A frame larger than its canvas."""


def pad_to_canvas(img: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad an (h, w, C) image to the canvas, top-left aligned."""
    h, w = img.shape[:2]
    ch, cw = canvas_hw
    if h > ch or w > cw:
        raise FrameTooLarge(f"a {h}x{w} frame does not fit the {ch}x{cw} "
                            f"canvas")
    out = np.zeros((ch, cw, img.shape[2]), dtype=img.dtype)
    out[:h, :w] = img
    return out
