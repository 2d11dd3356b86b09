"""The multi-stage zoo's training step (counterpart of
``hvrnet_tpu/engine/train_two_stage.py:38-208``, ``_stage_cfgs`` and
``TwoStageTrainer``; mmdet's ``cascade_rcnn.py:forward_train`` and
``two_stage.py:forward_train`` with a mask branch).

On one still image: the RPN loss and the ``rpn_proposal`` proposals
(``FasterRCNNTrainer.image_rpn``); then per stage s the stage's
assignment and sample (``train_cfg.rcnn[s]``, one config for every stage
when there is one), RoIAlign on the shared head's map, the stage's head,
cross entropy and smooth-L1 (``FasterRCNNTrainer.rcnn_stage``, Faster
R-CNN's one stage) weighted by ``stage_loss_weights[s]``; between stages the sampled boxes are refined by
the arg-max class's deltas without gradient and become the next stage's
proposals.  A mask head trains on the last stage's sample: 14×14 RoIAlign,
the head, ``mask_branch_loss``.

The samplers' noise comes in the JAX step's draw order (``split(rng,
n_stages + 1)``: [0] the anchors, [1 + s] stage s) or from the trainer's
generator.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..core.precision import widen
from .multi_stage import MultiStageEngine
from .train import FasterRCNNTrainer, still_image
from .train_mask import mask_branch_loss


def _stage_cfgs(rcnn_cfg) -> list:
    return list(rcnn_cfg) if isinstance(rcnn_cfg, (list, tuple)) \
        else [rcnn_cfg]


class TwoStageTrainer(FasterRCNNTrainer):
    """Training step of a ``MultiStageEngine`` (Cascade and Mask R-CNN):
    backbone (from ``layer2``), RPN, shared head, every stage's head and
    the mask head train."""

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

    def loss_from_c4(self, c4: torch.Tensor, sample: Dict[str, Any],
                     noise=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, logs) of one step from the image's (1, 1024, h, w)
        C4.  ``noise``: ((pos, neg) (A,) over the anchors, [(pos, neg) per
        stage over its G + P candidates]), U(0, 1); from the trainer's
        generator when absent.  Logs ``loss_cls_s{s}``, ``loss_bbox_s{s}``,
        ``acc_s{s}`` per stage (no suffix with one stage) and
        ``loss_mask``."""
        eng = self.engine
        n = eng.num_stages
        s = still_image(sample)
        anchor_noise, stage_noise = noise or ((None, None),
                                              [(None, None)] * n)
        logs, boxes, pmask, gt = self.image_rpn(c4, s, anchor_noise)
        total = logs["loss_rpn_cls"] + logs["loss_rpn_bbox"]
        c5 = eng.model.shared(c4)
        for st in range(n):
            hc = eng.head_cfgs[st]
            with self._phase(f"stage{st}"):
                sr, cls, reg, (lc, lb, acc) = self.rcnn_stage(
                    c5, boxes, pmask, gt, self.stages[st],
                    eng.stage_means[st], eng.stage_stds[st], stage_noise[st],
                    lambda pooled, st=st: eng.model.bbox_stage(pooled, st),
                    hc.get("reg_class_agnostic", False),
                    float((hc.get("loss_bbox") or {}).get("beta", 1.0)))
                w = float(self.stage_weights[st]) \
                    if st < len(self.stage_weights) else 1.0
                total = total + w * (lc + lb)
                suf = f"_s{st}" if n > 1 else ""
                logs.update({f"loss_cls{suf}": lc, f"loss_bbox{suf}": lb,
                             f"acc{suf}": acc})
                if st < n - 1:
                    with torch.no_grad():
                        boxes = eng.refine(sr.rois, cls, reg, st,
                                           gt["img_shape"])
                    pmask = sr.valid
        if eng.with_mask:
            with self._phase("mask"):
                rois = torch.cat([torch.zeros_like(sr.rois[:, :1]),
                                  sr.rois], 1)
                pooled = eng.mask_roi_extractor(c5, rois)
                masks = torch.as_tensor(s["gt_masks"], device=eng.device)
                mrois = torch.cat([sr.gt_inds[:, None].float(), sr.rois], 1)
                lm = mask_branch_loss(
                    widen(eng.model.mask_head(pooled)), masks, mrois,
                    sr.labels, sr.pos_mask, self.mask_size,
                    eng.mask_class_agnostic)
                total = total + lm
                logs["loss_mask"] = lm
        return total, logs
