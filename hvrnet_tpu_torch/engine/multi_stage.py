"""The multi-stage R-CNN zoo's engines (counterpart of
``hvrnet_tpu/engine/multi_stage.py``): Cascade R-CNN and Mask R-CNN on
the two-stage trunk, and the registered names of the family
(``HybridTaskCascade``, ``MaskScoringRCNN``, ``GridRCNN``,
``DoubleHeadRCNN``).

``simple_test`` follows the JAX engine (``multi_stage.py:192-262``): the
backbone, the image's proposals, then per stage RoIAlign on the shared
head's map, the stage's head and its softmax; between stages each box is
refined by the deltas of its arg-max foreground class (``refine``,
mmdet's ``regress_by_class``).  The stages' mean softmax goes to
``get_det_bboxes`` as ``log(clip(mean, 1e-12, 1))`` with the last stage's
deltas.  With a mask head, the kept detections are scaled back to the
canvas by the mean of ``scale_factor[:4]``, pooled (the mask RoI
extractor, 14×14) and through the head's sigmoid.

The FPN neck, HTC's semantic branch and per-stage mask heads are not
ported yet: a config that has them raises when the engine is built.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.precision import widen
from ..models.bbox_heads.bbox_head import get_det_bboxes
from ..models.builder import build_roi_extractor
from ..models.registry import DETECTORS, HEADS
from ..models.two_stage import TwoStageModule, build_submodule
from ..ops.boxes import delta2bbox
from .detector import BaseEngine, f32_precision

NOT_PORTED = {"neck": "the FPN neck",
              "semantic_head": "HTC's semantic branch",
              "mask_iou_head": "Mask Scoring R-CNN's MaskIoU head",
              "grid_head": "Grid R-CNN's grid head"}


class MultiStageModule(TwoStageModule):
    """The trunk, the RPN, one bbox head per stage (``bbox_head.{i}``; a
    single head keeps mmdet's ``bbox_head``) and an optional ``mask_head``."""

    def __init__(self, backbone: dict, shared_head: Optional[dict],
                 rpn_head: dict, bbox_head, mask_head: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        if isinstance(mask_head, (list, tuple)):
            raise NotImplementedError("per-stage mask heads (HTC) are not "
                                      "ported yet")
        super().__init__(backbone, shared_head, rpn_head, bbox_head, dtype)
        self.mask_head = (build_submodule(mask_head, HEADS, dtype)
                          if mask_head else None)


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
        self.mask_class_agnostic = bool((mh or {}).get("class_agnostic",
                                                       False))
        self.mask_roi_extractor = (
            build_roi_extractor(m["mask_roi_extractor"])
            if m.get("mask_roi_extractor") else self.roi_extractor)
        self.key_dim = 0
        self.timer = None

    def _head_config(self, model_cfg: Dict[str, Any]) -> Dict[str, Any]:
        for key, what in NOT_PORTED.items():
            if model_cfg.get(key):
                raise NotImplementedError(f"{what} ({key}) is not ported "
                                          "yet")
        return model_cfg

    def _build_model(self, model_cfg, dtype) -> torch.nn.Module:
        return MultiStageModule(
            backbone=model_cfg["backbone"],
            shared_head=model_cfg.get("shared_head"),
            rpn_head=model_cfg["rpn_head"], bbox_head=model_cfg["bbox_head"],
            mask_head=model_cfg.get("mask_head"), dtype=dtype)

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer else \
            contextlib.nullcontext()

    def stage_forward(self, c5, boxes, stage: int):
        """RoIAlign of (N, 4) boxes on one image's (1, C, h, w) map, then
        stage ``stage``'s head: (cls (N, C), reg (N, 4·k)) in float32."""
        rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], dim=1)
        cls, reg = self.model.bbox_stage(self.roi_extractor(c5, rois), stage)
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

    def mask_probs(self, c5, dets, scale_factor):
        """The sigmoid masks (n, K, 28, 28) float32 of (n, 5) detections in
        original-image coordinates on one image's map."""
        rois = dets[:, :4] * mean_scale(scale_factor)
        rois = torch.cat([torch.zeros_like(rois[:, :1]), rois], dim=1)
        pooled = self.mask_roi_extractor(c5, rois)
        return torch.sigmoid(widen(self.model.mask_head(pooled)))

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
            c5, cls_map, reg_map = self.backbone_maps(img, img_shape)
        with self._phase("proposals"):
            boxes, _, valid = self._proposals_lanes(
                c5, cls_map, reg_map, [img_shape], [pad_shape])
            boxes, valid = boxes[0], valid[0]
        scores = []
        for stage in range(self.num_stages):
            with self._phase(f"stage{stage}"):
                cls, reg = self.stage_forward(c5, boxes, stage)
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
        with self._phase("mask"):
            return (*out, self.mask_probs(c5, out[0], scale_factor))


@DETECTORS.register_module
class CascadeRCNN(MultiStageEngine):
    pass


@DETECTORS.register_module
class HybridTaskCascade(MultiStageEngine):
    """HTC's name; its semantic branch and per-stage mask heads are not
    ported yet."""


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
