"""The single-stage detectors' engine (counterpart of
``hvrnet_tpu/engine/single_stage.py``): RetinaNet and FreeAnchor, SSD, FCOS,
FoveaBox, guided-anchoring RetinaNet and RPN, and RepPoints, under the
registered names ``RetinaNet``, ``SingleStageDetector``, ``FCOS``,
``FOVEA``, ``RepPointsDetector`` and ``RPN``.

``simple_test`` runs the backbone (and the neck), the dense head, then per
level a decode with a static ``nms_pre`` cut, and one class-wise NMS over
the levels' union, in the JAX engine's three routes:

* anchors (``:83-142``): sigmoid scores, the ``nms_pre`` rows of highest
  row maximum (ties to the lower row, as ``lax.top_k``), ``delta2bbox`` on
  the level's anchors clamped to ``img_shape``.  A guided-anchoring head
  (four outputs: cls, reg, shape, loc) brings its own anchors
  (``guided_anchors``, ``:282-304``): the level's squares
  (``AnchorGenerator(stride, (octave,), (1.0,))``) reshaped by the shape
  map through ``delta2bbox(…, wh_ratio_clip=1e-6)``, and its scores times
  ``sigmoid(loc) ≥ loc_filter_thr``; the zeroed scores tie in the
  ``nms_pre`` cut, where the lower row goes first;
* SSD (``:144-180``): softmax scores with the background column, the
  ``nms_pre`` cut ranked on the foreground maximum, SSD's anchors;
* points (``:182-280``): FCOS's ``i·s + s//2`` points, scores times the
  sigmoid centerness, distances times the stride; FoveaBox's ``(i + 0.5)·s``
  points and ``exp(reg)·base_len`` distances; RepPoints' ``i·s`` points
  (no half stride), its refined y-first offsets turned to x, y pairs,
  ``points2bbox`` (``engine/train_reppoints.py``, with the head's
  ``moment_transfer``) times the stride plus the point; boxes clipped to
  ``img_shape − 1`` before the ``nms_pre`` cut.

The boxes are divided by the mean of ``scale_factor[:4]``; the sigmoid
routes prepend a zero background column.  A level's (1, A·K, h, w) map is
flattened in (h, w, anchor, K) order, the order of its anchors and points.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..core.precision import widen
from ..models.registry import BACKBONES, DETECTORS, HEADS, NECKS
from ..models.two_stage import build_submodule
from ..ops.anchors import AnchorGenerator, ssd_anchor_generators_from_cfg
from ..ops.boxes import delta2bbox
from ..ops.nms import multiclass_nms_static
from .detector import BaseEngine, f32_precision
from .multi_stage import mean_scale

DEFAULT_TEST_CFG = dict(score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                        max_per_img=100, nms_pre=1000)
POINT_HEADS = ("FCOSHead", "FoveaHead", "RepPointsHead")


class SingleStageModule(nn.Module):
    """``backbone``, an optional ``neck`` and the dense ``bbox_head``
    (mmdet's names); ``shared`` is the identity (no shared head)."""

    def __init__(self, backbone: dict, bbox_head: dict, neck=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = build_submodule(backbone, BACKBONES, dtype)
        self.neck = build_submodule(neck, NECKS, dtype) if neck else None
        self.bbox_head = build_submodule(bbox_head, HEADS, dtype)
        self.shared_head = None

    def extract_feat(self, img):
        """(B, 3, H, W) → the neck's tuple of maps, or the backbone's."""
        feats = self.backbone(img)
        return self.neck(feats) if self.neck is not None else feats

    def shared(self, feats):
        return feats


def flat(level_map: torch.Tensor, k: int) -> torch.Tensor:
    """One image's (1, A·k, h, w) map → (h·w·A, k) float32 rows in (h, w,
    anchor) order."""
    return widen(level_map[0].permute(1, 2, 0).reshape(-1, k))


def top_rows(rank: torch.Tensor, n: int) -> torch.Tensor:
    """The indices of the ``n`` largest of ``rank``, in descending order,
    ties to the lower index (``lax.top_k``)."""
    return torch.sort(rank, descending=True, stable=True).indices[:n]


def level_points(h: int, w: int, stride: int, half_px: bool) -> np.ndarray:
    """(h·w, 2) float32 x, y of a level's points, row by row: FoveaBox's
    ``(i + 0.5)·stride`` (``half_px``) or FCOS's ``i·stride + stride//2``."""
    if half_px:
        xs = (np.arange(w, dtype=np.float32) + 0.5) * stride
        ys = (np.arange(h, dtype=np.float32) + 0.5) * stride
    else:
        xs = np.arange(w, dtype=np.float32) * stride + stride // 2
        ys = np.arange(h, dtype=np.float32) * stride + stride // 2
    xx, yy = np.meshgrid(xs, ys)
    return np.stack([xx.reshape(-1), yy.reshape(-1)], -1)


def retina_scales(head_cfg: Dict[str, Any]) -> tuple:
    """RetinaNet's per-level anchor scales: ``octave_base_scale · 2^(i /
    scales_per_octave)``."""
    octave = int(head_cfg.get("octave_base_scale", 4))
    spo = int(head_cfg.get("scales_per_octave", 3))
    return tuple(octave * 2 ** (i / spo) for i in range(spo))


class SingleStageEngine(BaseEngine):
    """A dense single-stage detector on one device, computing in float32
    or bfloat16 (float32 parameters; scores and box math in float32).
    ``timer``: an object whose ``phase(name)`` context wraps each stage of
    ``simple_test`` ("backbone": backbone and neck, "head", "decode": the
    levels' decode and ``nms_pre`` cut, "nms")."""

    def _head_config(self, model_cfg: Dict[str, Any]) -> Dict[str, Any]:
        return model_cfg

    def _build_model(self, model_cfg, dtype) -> torch.nn.Module:
        return SingleStageModule(backbone=model_cfg["backbone"],
                                 bbox_head=model_cfg["bbox_head"],
                                 neck=model_cfg.get("neck"), dtype=dtype)

    def _setup_heads(self, model_cfg: Dict[str, Any]) -> None:
        head = model_cfg["bbox_head"]
        self.head_cfg = head
        self.head_type = str(head.get("type", ""))
        self.num_classes = int(head.get("num_classes", 81))
        self.target_means = tuple(head.get("target_means", (0., 0., 0., 0.)))
        self.target_stds = tuple(head.get("target_stds", (1., 1., 1., 1.)))
        self.decode_cfg = self.test_cfg or DEFAULT_TEST_CFG
        self._grids: Dict[tuple, torch.Tensor] = {}
        self.timer = None

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer else \
            contextlib.nullcontext()

    def _grid(self, key: tuple, make) -> torch.Tensor:
        """A level's anchors or points on the device, made once per key."""
        if key not in self._grids:
            self._grids[key] = torch.as_tensor(make(), device=self.device)
        return self._grids[key]

    def level_anchors(self, h: int, w: int, lvl: int) -> torch.Tensor:
        """(h·w·A, 4) anchors of level ``lvl``'s (h, w) map: RetinaNet's
        octave scales at ``anchor_strides[lvl]``, or SSD's generator."""
        if self.head_type == "SSDHead":
            def ssd():
                gens, strides = ssd_anchor_generators_from_cfg(self.head_cfg)
                return gens[lvl].grid_anchors((h, w), strides[lvl])
            return self._grid(("ssd", h, w, lvl), ssd)
        stride = tuple(self.head_cfg.get("anchor_strides",
                                         (8, 16, 32, 64, 128)))[lvl]
        ratios = tuple(self.head_cfg.get("anchor_ratios", (0.5, 1.0, 2.0)))
        return self._grid(("retina", h, w, stride), lambda: AnchorGenerator(
            stride, retina_scales(self.head_cfg), ratios).grid_anchors(
                (h, w), stride))

    @torch.no_grad()
    @f32_precision()
    def backbone_maps(self, img, img_shape):
        """The neck's (or the backbone's) tuple of NCHW maps of (B, H, W,
        3) canvases."""
        return self.model.extract_feat(self._to_input(img, img_shape))

    def _nms_pre(self, n_rows: int) -> int:
        """The ``nms_pre`` cut of a level of ``n_rows``, 0 for none (the
        reference's default ``nms_pre`` is −1: disabled)."""
        nms_pre = int(self.decode_cfg.get("nms_pre", -1))
        return nms_pre if 0 < nms_pre < n_rows else 0

    def guided_anchors(self, shape_map: torch.Tensor, loc_map: torch.Tensor,
                       lvl: int):
        """A guided-anchoring level's anchors and location filter: the
        squares of the level's (h, w) map reshaped by its (1, 2, h, w) shape
        map (dw, dh), and (h·w,) float32 ones where ``sigmoid(loc) ≥
        loc_filter_thr``."""
        head = self.head_cfg
        h, w = shape_map.shape[2], shape_map.shape[3]
        stride = tuple(head.get("anchor_strides", (8, 16, 32, 64, 128)))[lvl]
        octave = float(head.get("octave_base_scale", 8))
        squares = self._grid(
            ("squares", h, w, stride), lambda: AnchorGenerator(
                stride, (octave,), (1.0,)).grid_anchors((h, w), stride))
        shape = flat(shape_map, 2)
        anchors = delta2bbox(
            squares, torch.cat([torch.zeros_like(shape), shape], 1),
            tuple(head.get("anchoring_means", (0., 0., 0., 0.))),
            tuple(head.get("anchoring_stds", (1., 1., 1., 1.))),
            wh_ratio_clip=1e-6)
        thr = float(head.get("loc_filter_thr", 0.01))
        keep = (torch.sigmoid(flat(loc_map, 1)[:, 0]) >= thr).float()
        return anchors, keep

    def decode_anchors(self, cls_maps, reg_maps, img_shape, shape_maps=None,
                       loc_maps=None):
        """The anchor and SSD routes: per level the scores (sigmoid, or
        softmax with the background column), the ``nms_pre`` cut and
        ``delta2bbox`` clamped to ``img_shape``; with a guided-anchoring
        head's ``shape_maps`` and ``loc_maps``, on its guided anchors with
        the filtered-out scores zeroed."""
        ssd = self.head_type == "SSDHead"
        k = self.num_classes if ssd else self.num_classes - 1
        boxes, scores = [], []
        for lvl, (cm, rm) in enumerate(zip(cls_maps, reg_maps)):
            logits = flat(cm, k)
            s = (torch.softmax(logits, dim=-1) if ssd
                 else torch.sigmoid(logits))
            deltas = flat(rm, 4)
            if shape_maps is None:
                anchors = self.level_anchors(cm.shape[2], cm.shape[3], lvl)
            else:
                anchors, keep = self.guided_anchors(shape_maps[lvl],
                                                    loc_maps[lvl], lvl)
                s = s * keep[:, None]
            n = self._nms_pre(s.shape[0])
            if n:
                idx = top_rows((s[:, 1:] if ssd else s).max(dim=1).values, n)
                s, deltas, anchors = s[idx], deltas[idx], anchors[idx]
            boxes.append(delta2bbox(anchors, deltas, self.target_means,
                                    self.target_stds, max_shape=img_shape))
            scores.append(s)
        return torch.cat(boxes), torch.cat(scores)

    def decode_points(self, outs, img_shape):
        """The point route (FCOS, FoveaBox, RepPoints): per level the
        points, the scores (FCOS: times the sigmoid centerness), the boxes
        clipped to ``img_shape − 1``, then the ``nms_pre`` cut."""
        fcos = self.head_type == "FCOSHead"
        reppoints = self.head_type == "RepPointsHead"
        if reppoints:
            from .train_reppoints import points2bbox
            strides = tuple(self.head_cfg.get("point_strides",
                                              (8, 16, 32, 64, 128)))
            method = str(self.head_cfg.get("transform_method", "moment"))
            mt = (self.model.bbox_head.moment_transfer
                  if method == "moment" else None)
            mul = float(self.head_cfg.get("moment_mul", 0.01))
        else:
            strides = tuple(self.head_cfg.get("strides",
                                              (4, 8, 16, 32, 64)))
        base_lens = tuple(self.head_cfg.get("base_edge_list",
                                            (16, 32, 64, 128, 256)))
        h_img, w_img = (np.float32(v) for v in np.asarray(img_shape)[:2])
        hi = torch.tensor([w_img - 1, h_img - 1, w_img - 1, h_img - 1],
                          dtype=torch.float32, device=self.device)
        boxes, scores = [], []
        for lvl, (cm, rm) in enumerate(zip(outs[0], outs[1])):
            h, w = cm.shape[2], cm.shape[3]
            s = torch.sigmoid(flat(cm, self.num_classes - 1))
            if reppoints:
                st = strides[lvl]
                pts = self._grid(("rep points", h, w, st),
                                 lambda: level_points(h, w, st, False)
                                 - np.float32(st // 2))
                off = flat(outs[2][lvl], rm.shape[1]).reshape(h * w, -1, 2)
                xy = torch.stack([off[..., 1], off[..., 0]], -1)
                b = (points2bbox(xy.reshape(h * w, -1), method, mt, mul) * st
                     + torch.cat([pts, pts], 1))
            else:
                reg = flat(rm, 4)
                pts = self._grid(("points", h, w, strides[lvl], not fcos),
                                 lambda: level_points(h, w, strides[lvl],
                                                      not fcos))
                if fcos:
                    s = s * torch.sigmoid(flat(outs[2][lvl], 1))
                    d = reg * strides[lvl]
                else:
                    d = torch.exp(reg) * base_lens[lvl]
                b = torch.stack([pts[:, 0] - d[:, 0], pts[:, 1] - d[:, 1],
                                 pts[:, 0] + d[:, 2], pts[:, 1] + d[:, 3]],
                                -1)
            b = torch.clamp(b, torch.zeros_like(hi), hi)
            n = self._nms_pre(s.shape[0])
            if n:
                idx = top_rows(s.max(dim=1).values, n)
                s, b = s[idx], b[idx]
            boxes.append(b)
            scores.append(s)
        return torch.cat(boxes), torch.cat(scores)

    def decode(self, outs, img_shape, scale_factor):
        """The head's outputs → (boxes (N, 4) in original-image
        coordinates, scores (N, num_classes), background column first)."""
        if self.head_type in POINT_HEADS:
            boxes, scores = self.decode_points(outs, img_shape)
        else:
            boxes, scores = self.decode_anchors(outs[0], outs[1], img_shape,
                                                *outs[2:])
        if self.head_type != "SSDHead":
            scores = torch.cat([torch.zeros_like(scores[:, :1]), scores], 1)
        return boxes / mean_scale(scale_factor), scores

    @torch.no_grad()
    @f32_precision()
    def simple_test(self, img, img_shape, pad_shape, scale_factor):
        """img: (1, H, W, 3) canvas-padded image (normalised float32 or raw
        uint8) with its (2,) img_shape and (4,) scale_factor; ``pad_shape``
        is not read (the dense head scores every position of the canvas,
        as in the JAX engine).  Returns (dets (max, 5) in original-image
        coordinates, labels (max,) 0-based, mask (max,))."""
        with self._phase("backbone"):
            feats = self.backbone_maps(img, img_shape)
        with self._phase("head"):
            outs = self.model.bbox_head(feats)
        with self._phase("decode"):
            boxes, scores = self.decode(outs, img_shape, scale_factor)
        with self._phase("nms"):
            cfg = self.decode_cfg
            return multiclass_nms_static(
                boxes, scores, float(cfg["score_thr"]),
                float(cfg["nms"]["iou_thr"]), int(cfg["max_per_img"]))


@DETECTORS.register_module
class RetinaNet(SingleStageEngine):
    pass


@DETECTORS.register_module
class SingleStageDetector(SingleStageEngine):
    pass


@DETECTORS.register_module
class FCOS(SingleStageEngine):
    pass


@DETECTORS.register_module
class FOVEA(SingleStageEngine):
    pass


@DETECTORS.register_module
class RepPointsDetector(SingleStageEngine):
    """RepPoints (mmdet ``detectors/reppoints_detector.py``): the point
    route with ``RepPointsHead``."""


@DETECTORS.register_module
class RPN(SingleStageEngine):
    """Proposal-only detector (mmdet ``detectors/rpn.py``)."""
