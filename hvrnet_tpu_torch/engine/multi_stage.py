"""The multi-stage R-CNN zoo's engines (counterpart of
``hvrnet_tpu/engine/multi_stage.py``): Cascade R-CNN, Mask R-CNN and
Hybrid Task Cascade on the C4 trunk or an FPN, and the registered names of
the family (``MaskScoringRCNN``, ``GridRCNN``, ``DoubleHeadRCNN``).

``simple_test`` follows the JAX engine (``multi_stage.py:192-262``): the
backbone (and the neck), the image's proposals, then per stage RoIAlign on
the pooled map, the stage's head and its softmax; between stages each box
is refined by the deltas of its arg-max foreground class (``refine``,
mmdet's ``regress_by_class``).  The stages' mean softmax goes to
``get_det_bboxes`` as ``log(clip(mean, 1e-12, 1))`` with the last stage's
deltas.  With a mask head, the kept detections are scaled back to the
canvas by the mean of ``scale_factor[:4]``, pooled (the mask RoI
extractor, 14×14) and through the head's sigmoid; HTC's per-stage mask
heads give the mean of their sigmoids.

With a neck the JAX engine runs one level only: the RPN on the first
output (P2, anchors at ``anchor_strides[0]``) and every RoI pooled from
it at ``featmap_strides[0]``.  HTC's semantic branch embeds the neck's
maps at its fusion level; its 14×14 RoIAlign (``semantic_roi_extractor``)
is added to the box stages' pooled RoIs after a 2×2 average pool and to
the mask RoIs as it is (``semantic_fusion``).  HTC's mask information
flow feeds each stage's mask head the previous heads' trunk features
(``MultiStageModule.mask_stage``); at test time every stage pools the
same RoIs, so ``mask_probs`` runs each trunk once and hands its features
on.

Mask Scoring R-CNN's ``mask_iou_head`` and Grid R-CNN's ``grid_head`` are
built by neither engine and not run (the JAX engine ignores the keys):
those configs detect as Mask R-CNN and Faster R-CNN do, with a warning.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import widen
from ..models.bbox_heads.bbox_head import get_det_bboxes
from ..models.builder import build_roi_extractor
from ..models.registry import DETECTORS, HEADS, NECKS
from ..models.two_stage import TwoStageModule, build_submodule
from ..ops.boxes import delta2bbox
from .detector import BaseEngine, f32_precision

NOT_RUN = {"mask_iou_head": "Mask Scoring R-CNN's MaskIoU head",
           "grid_head": "Grid R-CNN's grid head"}


class MultiStageModule(TwoStageModule):
    """The trunk, an optional ``neck``, the RPN, one bbox head per stage
    (``bbox_head.{i}``; a single head keeps mmdet's ``bbox_head``), an
    optional ``mask_head`` (HTC: one per stage, ``mask_head.{i}``, the
    first without ``conv_res``) and an optional ``semantic_head``."""

    def __init__(self, backbone: dict, shared_head: Optional[dict],
                 rpn_head: dict, bbox_head, mask_head=None,
                 neck: Optional[dict] = None,
                 semantic_head: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(backbone, shared_head, rpn_head, bbox_head, dtype)
        self.neck = build_submodule(neck, NECKS, dtype) if neck else None
        if isinstance(mask_head, (list, tuple)):
            self.mask_head = nn.ModuleList(
                build_submodule(dict({"with_conv_res": i > 0}, **m), HEADS,
                                dtype) for i, m in enumerate(mask_head))
        else:
            self.mask_head = (build_submodule(mask_head, HEADS, dtype)
                              if mask_head else None)
        if semantic_head and neck is None:
            raise ValueError("a semantic_head fuses the levels of a neck: "
                             "the config has none")
        self.semantic_head = (build_submodule(semantic_head, HEADS, dtype)
                              if semantic_head else None)

    def extract_feat(self, img):
        """(B, 3, H, W) → the neck's tuple of maps, or without a neck the
        backbone's first output (C4)."""
        feats = self.backbone(img)
        return self.neck(feats) if self.neck is not None else feats[0]

    def mask_stage(self, pooled, stage: int, mask_info_flow: bool = True):
        """HTC's mask head ``stage`` on (N, C, 14, 14) pooled RoIs with the
        information flow as the JAX module computes it (``mask_stage``,
        ``multi_stage.py:85``): heads 0..stage-1 replayed trunk-only on
        these RoIs, each feeding the next, then head ``stage``."""
        last = None
        if mask_info_flow:
            for j in range(stage):
                last = self.mask_head[j](pooled, last, return_logits=False)
        return self.mask_head[stage](pooled, last)


def mean_scale(scale_factor) -> float:
    """The mean of ``scale_factor[:4]`` in float32, summed in order."""
    total = np.float32(0.0)
    for v in np.asarray(scale_factor, np.float32).reshape(-1)[:4]:
        total = np.float32(total + v)
    return float(total / np.float32(4.0))


class MultiStageEngine(BaseEngine):
    """A multi-stage or mask detector on one device, computing in float32
    or bfloat16 (float32 parameters; softmaxes, box math and the sigmoid in
    float32).  ``timer``: an object whose ``phase(name)`` context wraps each
    stage of ``simple_test`` ("backbone", "proposals", "stage{s}",
    "decode", "mask")."""

    def __init__(self, model_cfg, test_cfg=None, device="cuda",
                 seed: int = 0, train_cfg=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(model_cfg, test_cfg, device, seed, train_cfg, dtype)
        m = self.model_cfg
        heads = m["bbox_head"]
        self.head_cfgs = list(heads) if isinstance(heads, (list, tuple)) \
            else [heads]
        self.num_stages = len(self.head_cfgs)
        self.stage_means = [tuple(h.get("target_means", (0., 0., 0., 0.)))
                            for h in self.head_cfgs]
        self.stage_stds = [tuple(h.get("target_stds", (0.1, 0.1, 0.2, 0.2)))
                           for h in self.head_cfgs]
        mh = m.get("mask_head")
        self.with_mask = mh is not None
        self.num_mask_stages = (len(mh) if isinstance(mh, (list, tuple))
                                else int(self.with_mask))
        last_mh = mh[-1] if isinstance(mh, (list, tuple)) else (mh or {})
        self.mask_class_agnostic = bool(last_mh.get("class_agnostic", False))
        self.mask_roi_extractor = (
            build_roi_extractor(m["mask_roi_extractor"])
            if m.get("mask_roi_extractor") else self.roi_extractor)
        self.with_semantic = m.get("semantic_head") is not None
        self.semantic_fusion = tuple(m.get("semantic_fusion",
                                           ("bbox", "mask")))
        self.semantic_roi_extractor = (
            build_roi_extractor(m["semantic_roi_extractor"])
            if m.get("semantic_roi_extractor") else None)
        self.key_dim = 0
        self.timer = None

    def _head_config(self, model_cfg: Dict[str, Any]) -> Dict[str, Any]:
        for key, what in NOT_RUN.items():
            if model_cfg.get(key):
                warnings.warn(f"{what} ({key}) is built and run by neither "
                              f"the port nor the JAX engine: "
                              f"{model_cfg['type']} detects without it",
                              stacklevel=3)
        return model_cfg

    def _build_model(self, model_cfg, dtype) -> torch.nn.Module:
        return MultiStageModule(
            backbone=model_cfg["backbone"],
            shared_head=model_cfg.get("shared_head"),
            rpn_head=model_cfg["rpn_head"], bbox_head=model_cfg["bbox_head"],
            mask_head=model_cfg.get("mask_head"),
            neck=model_cfg.get("neck"),
            semantic_head=model_cfg.get("semantic_head"), dtype=dtype)

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer else \
            contextlib.nullcontext()

    @torch.no_grad()
    @f32_precision()
    def backbone_maps(self, img, img_shape):
        """(maps, rpn cls, rpn reg), NCHW, of (B, H, W, 3) canvases: maps
        is the neck's tuple (the RPN runs on its first map) or, without a
        neck, the shared head's map C5 (the RPN on C4)."""
        feats = self.model.extract_feat(self._to_input(img, img_shape))
        f0 = feats[0] if isinstance(feats, tuple) else feats
        cls_map, reg_map = self.model.rpn(f0)
        maps = feats if isinstance(feats, tuple) else self.model.shared(f0)
        return maps, cls_map, reg_map

    def pool_map(self, maps):
        """The map the RoIs are pooled from: the shared head's output of
        the neck's first map, or C5 itself."""
        return self.model.shared(maps[0]) if isinstance(maps, tuple) \
            else maps

    @torch.no_grad()
    @f32_precision()
    def semantic_embedding(self, maps):
        """HTC's semantic embedding (1, C, h, w) of the neck's maps at the
        fusion level, or None without a semantic branch."""
        if not self.with_semantic:
            return None
        return self.model.semantic_head(maps, with_logits=False)[1]

    def fuse_semantic(self, pooled, emb, rois, branch: str):
        """``pooled`` plus the semantic embedding's RoIAlign of the same
        RoIs (``_fuse_semantic``, ``multi_stage.py:177``), brought to the
        pooled size by an integer-factor average pool (14 → 7 for the box
        stages, mmdet's ``adaptive_avg_pool2d`` at these sizes); ``pooled``
        itself without an embedding, a semantic extractor or ``branch`` in
        ``semantic_fusion``."""
        if (emb is None or branch not in self.semantic_fusion
                or self.semantic_roi_extractor is None):
            return pooled
        sem = self.semantic_roi_extractor(emb, rois)
        if sem.shape[2:] != pooled.shape[2:]:
            fh = sem.shape[2] // pooled.shape[2]
            fw = sem.shape[3] // pooled.shape[3]
            sem = F.avg_pool2d(sem, (fh, fw), (fh, fw))
        return pooled + sem.to(pooled.dtype)

    def stage_forward(self, c5, boxes, stage: int, emb=None):
        """RoIAlign of (N, 4) boxes on one image's (1, C, h, w) map (plus
        the semantic RoI features with ``emb``), then stage ``stage``'s
        head: (cls (N, C), reg (N, 4·k)) in float32."""
        rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], dim=1)
        pooled = self.fuse_semantic(self.roi_extractor(c5, rois), emb, rois,
                                    "bbox")
        cls, reg = self.model.bbox_stage(pooled, stage)
        return widen(cls), widen(reg)

    def refine(self, boxes, cls, reg, stage: int, img_shape):
        """mmdet's ``bbox_head.regress_by_class`` at stage ``stage``: each
        of the (N, 4) boxes moved by the deltas of its arg-max foreground
        class (ties to the lower class, as ``jnp.argmax``; the one set of
        deltas when class-agnostic), clamped to ``img_shape``."""
        if self.head_cfgs[stage].get("reg_class_agnostic", False):
            deltas = reg.reshape(-1, 4)
        else:
            label = cls[:, 1:].argmax(dim=1) + 1
            deltas = torch.gather(reg.reshape(reg.shape[0], -1, 4), 1,
                                  label[:, None, None].expand(-1, 1, 4))[:, 0]
        return delta2bbox(boxes, deltas, self.stage_means[stage],
                          self.stage_stds[stage], img_shape)

    def mask_probs(self, c5, dets, scale_factor, emb=None):
        """The sigmoid masks (n, K, 28, 28) float32 of (n, 5) detections in
        original-image coordinates on one image's map (plus the semantic
        RoI features with ``emb``); with per-stage heads the mean of their
        sigmoids (``simple_test``, ``multi_stage.py:251``), each trunk run
        once: bit for bit the JAX form's ``mask_stage`` of every stage."""
        rois = dets[:, :4] * mean_scale(scale_factor)
        rois = torch.cat([torch.zeros_like(rois[:, :1]), rois], dim=1)
        with self._phase("mask roi"):
            pooled = self.fuse_semantic(self.mask_roi_extractor(c5, rois),
                                        emb, rois, "mask")
        if self.num_mask_stages <= 1:
            with self._phase("mask"):
                return torch.sigmoid(widen(self.model.mask_head(pooled)))
        probs, last = [], None
        for s, head in enumerate(self.model.mask_head):
            with self._phase(f"mask{s}"):
                logits, last = head(pooled, last, return_feat=True)
                probs.append(torch.sigmoid(widen(logits)))
        return sum(probs) / len(probs)

    @torch.no_grad()
    @f32_precision()
    def simple_test(self, img, img_shape, pad_shape, scale_factor):
        """img: (1, H, W, 3) canvas-padded image (normalised float32 or raw
        uint8) with its (2,) img_shape and pad_shape and (4,)
        scale_factor.  Returns (dets (max, 5) in original-image
        coordinates, labels (max,), mask (max,)), and with a mask head also
        the detections' sigmoid masks (max, K, 28, 28): K foreground
        classes, or 1 when class-agnostic."""
        with self._phase("backbone"):
            maps, cls_map, reg_map = self.backbone_maps(img, img_shape)
            c5 = self.pool_map(maps)
        emb = None
        if self.with_semantic:
            with self._phase("semantic"):
                emb = self.semantic_embedding(maps)
        with self._phase("proposals"):
            boxes, _, valid = self._proposals_lanes(
                c5, cls_map, reg_map, [img_shape], [pad_shape])
            boxes, valid = boxes[0], valid[0]
        scores = []
        for stage in range(self.num_stages):
            with self._phase(f"stage{stage}"):
                cls, reg = self.stage_forward(c5, boxes, stage, emb)
                scores.append(torch.softmax(cls, dim=-1))
                if stage < self.num_stages - 1:
                    boxes = self.refine(boxes, cls, reg, stage, img_shape)
        with self._phase("decode"):
            mean = sum(scores) / len(scores)
            out = get_det_bboxes(
                boxes, torch.log(mean.clamp(1e-12, 1.0)), reg, img_shape,
                scale_factor, self.stage_means[-1], self.stage_stds[-1],
                rescale=True, cfg=self.test_cfg["rcnn"], valid=valid)
        if not self.with_mask:
            return out
        return (*out, self.mask_probs(c5, out[0], scale_factor, emb))


@DETECTORS.register_module
class CascadeRCNN(MultiStageEngine):
    pass


@DETECTORS.register_module
class HybridTaskCascade(MultiStageEngine):
    pass


@DETECTORS.register_module
class MaskRCNN(MultiStageEngine):
    pass


@DETECTORS.register_module
class MaskScoringRCNN(MultiStageEngine):
    pass


@DETECTORS.register_module
class GridRCNN(MultiStageEngine):
    pass


@DETECTORS.register_module
class DoubleHeadRCNN(MultiStageEngine):
    pass
