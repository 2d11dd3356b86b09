"""The multi-stage zoo's training step (counterpart of
``hvrnet_tpu/engine/train_two_stage.py:38-208``, ``_stage_cfgs`` and
``TwoStageTrainer``; mmdet's ``cascade_rcnn.py:forward_train``,
``htc.py:forward_train`` and ``two_stage.py:forward_train`` with a mask
branch).

On one still image: the backbone (and the neck), the RPN loss and the
``rpn_proposal`` proposals (``FasterRCNNTrainer.image_rpn``, on the neck's
first map); with HTC's semantic branch its embedding and, where the
sample has ``gt_semantic_seg``, the semantic loss; then per stage s the
stage's assignment and sample (``train_cfg.rcnn[s]``, one config for
every stage when there is one), RoIAlign on the pooled map plus the
semantic RoI features, the stage's head, cross entropy and smooth-L1
(``FasterRCNNTrainer.rcnn_stage``, Faster R-CNN's one stage) weighted by
``stage_loss_weights[s]``; HTC's per-stage mask heads train on their own
stage's sample through the replayed trunks of the heads before
(``MultiStageModule.mask_stage``), weighted the same; between stages the
sampled boxes are refined by the arg-max class's deltas without gradient
and become the next stage's proposals.  A single mask head trains on the
last stage's sample: 14×14 RoIAlign, the head, ``mask_branch_loss``.

The samplers' noise comes in the JAX step's draw order (``split(rng,
n_stages + 1)``: [0] the anchors, [1 + s] stage s) or from the trainer's
generator.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.precision import widen
from ..models.losses import softmax_cross_entropy
from .multi_stage import MultiStageEngine
from .train import FasterRCNNTrainer, still_image
from .train_mask import mask_branch_loss


def _stage_cfgs(rcnn_cfg) -> list:
    return list(rcnn_cfg) if isinstance(rcnn_cfg, (list, tuple)) \
        else [rcnn_cfg]


def semantic_loss(seg: torch.Tensor, gt_seg: torch.Tensor,
                  ignore_label: int = 255,
                  loss_weight: float = 0.2) -> torch.Tensor:
    """HTC's semantic loss (``train_two_stage.py:76-94``): the per-pixel
    cross entropy of one image's (K, h, w) logits in float32 against the
    (h, w) labels at the same size, averaged over the pixels whose label
    is not ``ignore_label`` (at least 1), times ``loss_weight``.  Labels
    are clamped into [0, K - 1] before the gather, as XLA clamps the JAX
    package's gather indices; the ignored pixels weigh nothing."""
    logits = widen(seg).permute(1, 2, 0).reshape(-1, seg.shape[0])
    labels = gt_seg.reshape(-1).long()
    ce = softmax_cross_entropy(logits, labels.clamp(0, seg.shape[0] - 1))
    valid = (labels != ignore_label).float()
    return loss_weight * (ce * valid).sum() / valid.sum().clamp_min(1.0)


class TwoStageTrainer(FasterRCNNTrainer):
    """Training step of a ``MultiStageEngine`` (Cascade, Mask R-CNN and
    HTC): backbone (from ``layer2``), the neck, RPN, shared head, every
    stage's head, the mask heads and the semantic head train."""

    def __init__(self, engine, cfg, steps_per_epoch: int = 1000,
                 seed: int = 0):
        if not isinstance(engine, MultiStageEngine):
            raise TypeError("TwoStageTrainer trains a MultiStageEngine")
        super().__init__(engine, cfg, steps_per_epoch, seed)
        n = engine.num_stages
        stages = _stage_cfgs(engine.train_cfg["rcnn"])
        self.stages = stages * n if len(stages) == 1 and n > 1 else stages
        self.stage_weights = list(engine.train_cfg.get(
            "stage_loss_weights", [1.0] * n))
        self.mask_size = int(self.stages[-1].get("mask_size", 28))

    def loss_from_c4(self, c4, sample: Dict[str, Any], noise=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, logs) of one step from the image's (1, 1024, h, w)
        C4 or, with a neck, its tuple of maps.  ``noise``: ((pos, neg) (A,)
        over the anchors, [(pos, neg) per stage over its G + P
        candidates]), U(0, 1); from the trainer's generator when absent.
        Logs ``loss_cls_s{s}``, ``loss_bbox_s{s}``, ``acc_s{s}`` per stage
        (no suffix with one stage), ``loss_mask_s{s}`` per mask stage or
        ``loss_mask``, and ``loss_semantic_seg``."""
        eng = self.engine
        n = eng.num_stages
        s = still_image(sample)
        anchor_noise, stage_noise = noise or ((None, None),
                                              [(None, None)] * n)
        f0 = c4[0] if isinstance(c4, tuple) else c4
        logs, boxes, pmask, gt = self.image_rpn(f0, s, anchor_noise)
        total = logs["loss_rpn_cls"] + logs["loss_rpn_bbox"]
        c5 = eng.model.shared(f0)
        emb = loss_seg = None
        if eng.with_semantic:
            with self._phase("semantic"):
                seg, emb = eng.model.semantic_head(c4)
                if "gt_semantic_seg" in s:
                    head = eng.model.semantic_head
                    loss_seg = semantic_loss(
                        seg[0], torch.as_tensor(np.asarray(
                            s["gt_semantic_seg"]), device=eng.device),
                        head.ignore_label, head.loss_weight)
        masks = (torch.as_tensor(s["gt_masks"], device=eng.device)
                 if eng.with_mask else None)
        for st in range(n):
            hc = eng.head_cfgs[st]
            w = float(self.stage_weights[st]) \
                if st < len(self.stage_weights) else 1.0
            with self._phase(f"stage{st}"):
                sr, cls, reg, (lc, lb, acc) = self.rcnn_stage(
                    c5, boxes, pmask, gt, self.stages[st],
                    eng.stage_means[st], eng.stage_stds[st], stage_noise[st],
                    lambda pooled, st=st: eng.model.bbox_stage(pooled, st),
                    hc.get("reg_class_agnostic", False),
                    float((hc.get("loss_bbox") or {}).get("beta", 1.0)),
                    lambda pooled, rois: eng.fuse_semantic(pooled, emb, rois,
                                                           "bbox"))
                total = total + w * (lc + lb)
                suf = f"_s{st}" if n > 1 else ""
                logs.update({f"loss_cls{suf}": lc, f"loss_bbox{suf}": lb,
                             f"acc{suf}": acc})
                if st < n - 1:
                    with torch.no_grad():
                        boxes = eng.refine(sr.rois, cls, reg, st,
                                           gt["img_shape"])
                    pmask = sr.valid
            if eng.num_mask_stages > 1:
                with self._phase(f"mask{st}"):
                    lm = self.mask_loss(c5, emb, sr, masks, st)
                    total = total + w * lm
                    logs[f"loss_mask_s{st}"] = lm
        if loss_seg is not None:
            total = total + loss_seg
            logs["loss_semantic_seg"] = loss_seg
        if eng.num_mask_stages == 1:
            with self._phase("mask"):
                lm = self.mask_loss(c5, emb, sr, masks)
                total = total + lm
                logs["loss_mask"] = lm
        return total, logs

    def mask_loss(self, c5, emb, sr, masks, stage=None):
        """``mask_branch_loss`` of one stage's sample ``sr``: its RoIs'
        14×14 RoIAlign plus the semantic RoI features, then the single mask
        head or, with ``stage``, HTC's head ``stage`` through the replayed
        trunks of the heads before it."""
        eng = self.engine
        rois = torch.cat([torch.zeros_like(sr.rois[:, :1]), sr.rois], 1)
        pooled = eng.fuse_semantic(eng.mask_roi_extractor(c5, rois), emb,
                                   rois, "mask")
        pred = (eng.model.mask_head(pooled) if stage is None
                else eng.model.mask_stage(pooled, stage))
        mrois = torch.cat([sr.gt_inds[:, None].float(), sr.rois], 1)
        return mask_branch_loss(widen(pred), masks, mrois, sr.labels,
                                sr.pos_mask, self.mask_size,
                                eng.mask_class_agnostic)
