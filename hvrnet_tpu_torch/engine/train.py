"""Training steps (counterpart of ``hvrnet_tpu/engine/train.py``:
``BaseTrainer`` on one device, ``SelsaTrainer`` and ``HNMBTrainer``; and of
``hvrnet_tpu/engine/train_two_stage.py:FasterRCNNTrainer``, the still-image
detector's).

SELSA, one step (``selsa_rcnn.py:85-246``) over F frames of one video, the
key frame ``key_dim`` among them:
  1. the backbone over the F frames with gradient (stem and ``layer1``
     frozen), the RPN with gradient, and its loss on the key frame's
     sampled anchors (``core/targets.py:anchor_target_single``);
  2. per frame, proposals from the detached RPN maps
     (``train_cfg.rpn_proposal``) and ``sampler[0].num`` RoIs sampled
     against the key frame's ground truth;
  3. the shared head (C5) with gradient, RoIAlign over the F frames and the
     SELSA head over their F·num rows (NL1 and NL2 through the attention
     kernel), the key frame's rows out;
  4. cross entropy re-weighted to the ``sampler[1].num`` hardest RoIs
     (OHEM; with a single sampler every sampled RoI) and smooth-L1;
  5. backward, the global-norm clip and SGD (``engine/optim.py``).

HVRNet, one step, in the reference's order (``hnmb_rcnn.py:224-569``):
  1. the frozen backbone over every frame (V videos × ``imgs_per_video``),
     without gradient;
  2. triplet-video selection from max-pooled C5 descriptors: the key video
     0, its hardest same-class video and the most confusing other-class
     video;
  3. per chosen frame, RPN proposals (``train_cfg.rpn_proposal``) and
     ``sampler.num`` RoIs sampled against its video's key-frame ground
     truth;
  4. the trainable shared head and RoIAlign over the chosen frames, then
     the HRNMP head's training forward (NL1–NL3 through the attention
     kernel, NL4 with explicit affinities and the triplet loss);
  5. branch and final cross-entropy and smooth-L1 losses;
  6. backward, the global-norm clip and SGD (``engine/optim.py``).
All of it runs under ``f32_precision``: no TF32 in any forward or backward
convolution or matmul.  A bf16 engine trains with float32 parameters: its
modules compute in bf16, its gradients reach the float32 weights, and the
losses are computed in float32 from the widened logits and deltas.

The config's ``fp16 = dict(loss_scale=...)`` (mmdet's
``Fp16OptimizerHook``) scales the loss before the backward and unscales
the gradients before the clip; on non-finite gradients the step leaves the
weights and the momentum untouched and still advances
(``core/precision.py:DynamicLossScale``).

The samplers' noise comes from the trainer's ``torch.Generator`` unless
the caller hands it in (the tests hand both packages the same noise).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.precision import DynamicLossScale, widen
from ..core.targets import (anchor_target_single, ohem_weights,
                            random_sample_and_target)
from ..models.anchor_heads.rpn_head import rpn_flat_logits_deltas
from ..models.losses import accuracy, smooth_l1, softmax_cross_entropy
from .detector import _rpn_proposals, f32_precision
from .optim import (clip_grad_global_norm_, default_trainable_mask,
                    make_optimizer, step_lr_schedule)


class BaseTrainer:
    """The optimizer side: trainable mask, schedule, loss scale, clip, SGD
    step."""

    freeze_backbone = False
    freeze_rpn = False
    # the optimizer and schedule of a config without those keys
    default_optimizer = dict(lr=2.5e-4, momentum=0.9, weight_decay=1e-4)
    default_lr_config = dict(step=[12], warmup_iters=500,
                             warmup_ratio=1.0 / 3)

    def __init__(self, engine, cfg, steps_per_epoch: int = 1000,
                 seed: int = 0):
        self.engine = engine
        opt = cfg.get("optimizer") or self.default_optimizer
        lrc = cfg.get("lr_config") or self.default_lr_config
        clip = ((cfg.get("optimizer_config") or {}).get("grad_clip")
                or {}).get("max_norm", 35.0)
        self.schedule = step_lr_schedule(
            float(opt["lr"]), steps_per_epoch, list(lrc.get("step", [])),
            warmup_iters=int(lrc.get("warmup_iters", 500)),
            warmup_ratio=float(lrc.get("warmup_ratio", 1.0 / 3)))
        self.clip_norm = float(clip)
        mask = default_trainable_mask(
            engine.model,
            frozen_stages=int(engine.model_cfg["backbone"].get(
                "frozen_stages", 1)),
            freeze_backbone=self.freeze_backbone, freeze_rpn=self.freeze_rpn)
        self.params: List[torch.nn.Parameter] = []
        names = []
        for name, p in engine.model.named_parameters():
            p.requires_grad_(mask[name])
            if mask[name]:
                self.params.append(p)
                names.append(name)
        self.optimizer = make_optimizer(
            self.params, self.schedule(0),
            momentum=float(opt.get("momentum", 0.9)),
            weight_decay=float(opt.get("weight_decay", 1e-4)), names=names,
            paramwise_options=opt.get("paramwise_options"))
        fp16 = cfg.get("fp16")
        self.loss_scale = DynamicLossScale.from_config(fp16) if fp16 else None
        self.scale_state = (self.loss_scale.init(engine.device)
                            if self.loss_scale else None)
        bh = engine.model_cfg["bbox_head"]
        bh = bh[-1] if isinstance(bh, (list, tuple)) else bh
        # the head's smooth-L1 β (the RPN's is 1/9, as in the reference)
        self.loss_beta = float((bh.get("loss_bbox") or {}).get("beta", 1.0))
        self.step = 0
        self.generator = torch.Generator(device=engine.device)
        self.generator.manual_seed(seed)
        # ``timer.phase(name)`` context manager around each stage of a step
        self.timer = None

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer else \
            contextlib.nullcontext()

    def apply_update(self) -> Dict[str, Any]:
        """Unscale the gradients (under a loss scale), clip them, take one
        SGD step at ``schedule(step)`` (each group at its ``lr_mult``) and
        advance the step.  Returns the logs it adds: ``lr``, and under a
        loss scale the next scale and ``overflow``, 1.0 when the gradients
        were not finite and the step was skipped."""
        lr = self.schedule(self.step)
        logs: Dict[str, Any] = dict(lr=lr)
        apply = True
        if self.loss_scale is not None:
            finite, self.scale_state = self.loss_scale.unscale_and_check(
                (p.grad for p in self.params if p.grad is not None),
                self.scale_state)
            apply = bool(finite)          # one host read per step
            logs.update(loss_scale=self.scale_state.scale,
                        overflow=0.0 if apply else 1.0)
        if apply:
            clip_grad_global_norm_(self.params, self.clip_norm)
            for group in self.optimizer.param_groups:
                group["lr"] = lr * group.get("lr_mult", 1.0)
            self.optimizer.step()
        self.step += 1
        return logs

    def train_step(self, sample: Dict[str, Any],
                   noise=None) -> Dict[str, Any]:
        """One step on a ``collate_train`` sample; returns the logs (device
        scalars, and ``lr`` the step's learning rate)."""
        with f32_precision():
            with self._phase("backbone"):
                c4 = self.backbone(sample)
            loss, logs = self.loss_from_c4(c4, sample, noise)
            with self._phase("backward"):
                self.optimizer.zero_grad(set_to_none=True)
                scaled = (loss if self.loss_scale is None else
                          self.loss_scale.scale_loss(loss, self.scale_state))
                scaled.backward()
            with self._phase("optimizer"):
                update_logs = self.apply_update()
        logs = {k: v.detach() for k, v in logs.items()}
        logs.update(loss=loss.detach(), **update_logs)
        return logs

    def backbone(self, sample: Dict[str, Any]) -> torch.Tensor:
        """C4 (F, 1024, H/16, W/16) of the sample's (F, H, W, 3)
        normalised float32 frames; without gradient when the trainer
        freezes the backbone."""
        with f32_precision(), torch.set_grad_enabled(
                not self.freeze_backbone):
            x = self.engine._to_input(sample["imgs"], None)
            return self.engine.model.extract_feat(x)

    def loss_from_c4(self, c4, sample, noise=None):
        raise NotImplementedError


def _rpn_loss(cls_map: torch.Tensor, reg_map: torch.Tensor, tgt,
              beta: float = 1.0 / 9.0):
    """One image's RPN loss over its sampled anchors: sigmoid binary cross
    entropy and smooth-L1 (``beta`` 1/9), each summed and divided by the
    sampled count, in float32 for bf16 maps.  cls_map: (A, H, W) logits,
    reg_map: (4A, H, W)."""
    logits, reg = rpn_flat_logits_deltas(cls_map, reg_map)
    n = tgt.num_total_samples
    ce = F.binary_cross_entropy_with_logits(
        logits, (tgt.labels > 0).to(logits.dtype), reduction="none")
    loss_cls = (ce * tgt.label_weights).sum() / n
    loss_bbox = (smooth_l1(reg, tgt.bbox_targets, beta)
                 * tgt.bbox_weights).sum() / n
    return loss_cls, loss_bbox


class SelsaTrainer(BaseTrainer):
    """SELSA training: backbone (from ``layer2``), RPN, shared head and
    SELSA head all train; the RPN loss on the key frame and the head's
    losses on the key frame's RoIs, after OHEM when ``train_cfg.rcnn``
    names a second sampler (with one sampler, every sampled RoI at its
    label weight, normalised by their count, as the JAX trainer does)."""

    def loss_from_c4(self, c4: torch.Tensor, sample: Dict[str, Any],
                     noise=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, logs) of one step from the frames' C4 maps.

        ``noise``: ((pos, neg), (pos, neg)) U(0, 1) priorities, the first
        pair (A,) over the anchors of the RPN sampler, the second (F, G + P)
        over each frame's RoI candidates (G ground-truth slots, then P
        proposals); drawn from the trainer's generator when absent."""
        eng = self.engine
        model = eng.model
        tcfg = eng.train_cfg
        rcnn = tcfg["rcnn"]
        assigner = rcnn["assigner"]
        samplers = rcnn["sampler"]
        if not isinstance(samplers, (list, tuple)):
            first, ohem = samplers, None
        elif len(samplers) >= 2:
            first, ohem = samplers[0], samplers[1]
        else:
            raise ValueError("SelsaTrainer takes train_cfg.rcnn.sampler as "
                             "one sampler, or [first-stage sampler, OHEM "
                             "sampler]")
        kd, P = eng.key_dim, int(first["num"])
        n_frames = c4.shape[0]
        stride = eng.anchor_stride
        canvas = eng._canvas(c4.shape[2] * stride, c4.shape[3] * stride)
        img_shape = np.asarray(sample["img_shape"])
        pad_shape = np.asarray(sample["pad_shape"])
        gt = {k: torch.as_tensor(np.asarray(sample[k])[kd],
                                 device=eng.device)
              for k in ("gt_bboxes", "gt_labels", "gt_mask")}
        (apos, aneg), (rpos, rneg) = noise or ((None, None), (None, None))

        with self._phase("rpn"):
            cls_map, reg_map = model.rpn(c4)
            tgt = anchor_target_single(
                canvas.anchors, canvas.anchor_valid(pad_shape[kd]),
                gt["gt_bboxes"], gt["gt_mask"], img_shape[kd], tcfg["rpn"],
                eng.rpn_means, eng.rpn_stds, pos_noise=apos, neg_noise=aneg,
                generator=self.generator)
            loss_rpn_cls, loss_rpn_bbox = _rpn_loss(cls_map[kd], reg_map[kd],
                                                    tgt)

        with self._phase("proposals"), torch.no_grad():
            rois, valid, srs = [], [], []
            for i in range(n_frames):
                boxes, _, pmask = _rpn_proposals(
                    cls_map[i], reg_map[i], canvas, pad_shape[i],
                    img_shape[i], tcfg["rpn_proposal"], eng.rpn_means,
                    eng.rpn_stds)
                sr = random_sample_and_target(
                    boxes, pmask, gt["gt_bboxes"], gt["gt_mask"],
                    gt["gt_labels"], num=P,
                    pos_fraction=float(first["pos_fraction"]),
                    add_gt_as_proposals=bool(
                        first.get("add_gt_as_proposals", True)),
                    pos_iou_thr=float(assigner["pos_iou_thr"]),
                    neg_iou_thr=float(assigner["neg_iou_thr"]),
                    min_pos_iou=float(assigner["min_pos_iou"]),
                    target_means=eng.target_means,
                    target_stds=eng.target_stds,
                    pos_weight=float(rcnn.get("pos_weight", -1)),
                    pos_noise=None if rpos is None else rpos[i],
                    neg_noise=None if rneg is None else rneg[i],
                    generator=self.generator)
                idx = torch.full((P, 1), float(i), device=eng.device)
                rois.append(torch.cat([idx, sr.rois], dim=1))
                valid.append(sr.valid)
                srs.append(sr)

        with self._phase("head"):
            c5 = model.shared(c4)
            pooled = eng.roi_extractor(c5, torch.cat(rois))
            cls, reg = model.bbox_head(pooled, kd * P, P, torch.cat(valid))
            key = srs[kd]
            cls, reg = widen(cls), widen(reg)
            ce = softmax_cross_entropy(cls, key.labels)
            if ohem is None:
                lw, bw = key.label_weights, key.bbox_weights
                navg = (lw > 0).sum().float().clamp_min(1.0)
            else:
                lw, bw, sel, _ = ohem_weights(
                    key.labels, ce, key.valid, int(ohem["num"]),
                    float(ohem["pos_fraction"]))
                navg = sel.sum().float().clamp_min(1.0)
            loss_cls = (ce * lw).sum() / navg
            loss_bbox = (smooth_l1(reg.reshape(-1, 4), key.bbox_targets,
                                   self.loss_beta) * bw).sum() / navg
            logs = dict(loss_rpn_cls=loss_rpn_cls, loss_rpn_bbox=loss_rpn_bbox,
                        loss_cls=loss_cls, loss_bbox=loss_bbox,
                        acc=accuracy(cls.detach(), key.labels, mask=lw > 0))
        return loss_rpn_cls + loss_rpn_bbox + loss_cls + loss_bbox, logs


def still_image(sample: Dict[str, Any]) -> Dict[str, Any]:
    """A sample in the still-image layout: ``imgs`` (1, H, W, 3),
    ``gt_bboxes`` (G, 4), ``gt_labels`` and ``gt_mask`` (G,), ``img_shape``
    and ``pad_shape`` (2,), and ``gt_masks`` (G, H, W) and
    ``gt_semantic_seg`` (h, w) where the sample has them.  From the
    still-image layout (``img`` (H, W, 3) or (1, H, W, 3)) or the video
    layout (``imgs`` (F, H, W, 3): frame 0)."""
    keys = [k for k in ("gt_bboxes", "gt_labels", "gt_mask", "img_shape",
                        "pad_shape", "gt_masks", "gt_semantic_seg")
            if k in sample]
    if "img" in sample:
        img = sample["img"]
        return dict(imgs=img[None] if img.ndim == 3 else img,
                    **{k: sample[k] for k in keys})
    return dict(imgs=sample["imgs"][:1], **{k: sample[k][0] for k in keys})


def rcnn_losses(cls: torch.Tensor, reg: torch.Tensor, sr, agnostic: bool,
                beta: float):
    """One RCNN stage's losses on its sampled RoIs (float32 ``cls`` and
    ``reg``): softmax cross entropy at the label weights and the labelled
    class's smooth-L1 (the one set of deltas when ``agnostic``) at the box
    weights, both divided by the count of weighted RoIs; and the accuracy
    over them.  Returns (loss_cls, loss_bbox, acc)."""
    lw = sr.label_weights
    navg = (lw > 0).sum().float().clamp_min(1.0)
    loss_cls = (softmax_cross_entropy(cls, sr.labels) * lw).sum() / navg
    reg = reg.reshape(reg.shape[0], -1, 4)
    if not agnostic:
        reg = torch.gather(reg, 1, sr.labels.clamp_min(0)[
            :, None, None].expand(-1, 1, 4))
    loss_bbox = (smooth_l1(reg[:, 0], sr.bbox_targets, beta)
                 * sr.bbox_weights).sum() / navg
    return loss_cls, loss_bbox, accuracy(cls.detach(), sr.labels,
                                         mask=lw > 0)


class FasterRCNNTrainer(BaseTrainer):
    """The still-image Faster R-CNN objective (counterpart of
    ``hvrnet_tpu/engine/train_two_stage.py:FasterRCNNTrainer``, the
    reference's ``two_stage.py:forward_train`` with one RCNN stage): the RPN
    loss on the image's sampled anchors; ``train_cfg.rpn_proposal``
    proposals from the detached maps; one assign/sample stage
    (``train_cfg.rcnn``, its first sampler); softmax cross entropy and the
    labelled class's smooth-L1 over the sampled RoIs, both divided by the
    count of weighted RoIs.  Backbone (from ``layer2``), RPN, shared head
    and head train.  A sample is in the still-image or the video layout
    (``still_image``)."""

    def backbone(self, sample: Dict[str, Any]) -> torch.Tensor:
        return super().backbone(still_image(sample))

    def loss_from_c4(self, c4: torch.Tensor, sample: Dict[str, Any],
                     noise=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, logs) of one step from the image's (1, 1024, h, w)
        C4.  ``noise``: ((pos, neg) (A,) U(0, 1) priorities over the
        anchors, (pos, neg) (G + P,) over the RoI candidates), the JAX
        step's ``split(rng, 2)`` draws; from the trainer's generator when
        absent."""
        eng = self.engine
        rcnn = eng.train_cfg["rcnn"]
        rcnn = rcnn[0] if isinstance(rcnn, (list, tuple)) else rcnn
        agnostic = eng.model_cfg["bbox_head"].get("reg_class_agnostic", False)
        s = still_image(sample)
        anchor_noise, roi_noise = noise or ((None, None), (None, None))
        logs, boxes, pmask, gt = self.image_rpn(c4, s, anchor_noise)
        with self._phase("head"):
            c5 = eng.model.shared(c4)
            losses = self.rcnn_stage(c5, boxes, pmask, gt, rcnn,
                                     eng.target_means, eng.target_stds,
                                     roi_noise, eng.model.bbox_forward,
                                     agnostic, self.loss_beta)[3]
            logs["loss_cls"], logs["loss_bbox"], logs["acc"] = losses
        return (logs["loss_rpn_cls"] + logs["loss_rpn_bbox"]
                + logs["loss_cls"] + logs["loss_bbox"]), logs

    def image_rpn(self, c4, s, anchor_noise):
        """The RPN's loss on one still image ``s`` (``still_image``) and its
        ``train_cfg.rpn_proposal`` proposals from the detached maps:
        (logs with ``loss_rpn_cls`` and ``loss_rpn_bbox``, boxes (P, 4),
        mask (P,), the ground truth as device tensors with ``img_shape``)."""
        eng = self.engine
        tcfg = eng.train_cfg
        stride = eng.anchor_stride
        canvas = eng._canvas(c4.shape[2] * stride, c4.shape[3] * stride)
        img_shape = np.asarray(s["img_shape"])
        pad_shape = np.asarray(s["pad_shape"])
        gt = {k: torch.as_tensor(np.asarray(s[k]), device=eng.device)
              for k in ("gt_bboxes", "gt_labels", "gt_mask")}
        gt["img_shape"] = img_shape
        apos, aneg = anchor_noise
        with self._phase("rpn"):
            cls_map, reg_map = eng.model.rpn(c4)
            tgt = anchor_target_single(
                canvas.anchors, canvas.anchor_valid(pad_shape),
                gt["gt_bboxes"], gt["gt_mask"], img_shape, tcfg["rpn"],
                eng.rpn_means, eng.rpn_stds, pos_noise=apos, neg_noise=aneg,
                generator=self.generator)
            loss_rpn_cls, loss_rpn_bbox = _rpn_loss(cls_map[0], reg_map[0],
                                                    tgt)
        with self._phase("proposals"), torch.no_grad():
            boxes, _, pmask = _rpn_proposals(
                cls_map[0], reg_map[0], canvas, pad_shape, img_shape,
                tcfg["rpn_proposal"], eng.rpn_means, eng.rpn_stds)
        return (dict(loss_rpn_cls=loss_rpn_cls, loss_rpn_bbox=loss_rpn_bbox),
                boxes, pmask, gt)

    def rcnn_stage(self, c5, boxes, pmask, gt, rcnn, means, stds, noise,
                   head, agnostic, beta, fuse=None):
        """One RCNN stage on the shared head's map ``c5``: the assignment
        and sample of the (P, 4) ``boxes`` (``sample_rois``), RoIAlign
        (then ``fuse(pooled, rois)`` where given), ``head`` on the pooled
        RoIs and the stage's losses (``rcnn_losses``).  Returns (sample,
        cls, reg, (loss_cls, loss_bbox, acc)), ``cls`` and ``reg`` in
        float32."""
        with torch.no_grad():
            sr = self.sample_rois(boxes, pmask, gt, rcnn, means, stds, noise)
        rois = torch.cat([torch.zeros_like(sr.rois[:, :1]), sr.rois], 1)
        pooled = self.engine.roi_extractor(c5, rois)
        cls, reg = head(pooled if fuse is None else fuse(pooled, rois))
        cls, reg = widen(cls), widen(reg)
        return sr, cls, reg, rcnn_losses(cls, reg, sr, agnostic, beta)

    def sample_rois(self, boxes, pmask, gt, rcnn, means, stds, noise):
        """One RCNN stage's assignment and sample (``rcnn``: its assigner,
        its first sampler, ``pos_weight``) of (P, 4) boxes against the
        image's ground truth, with the stage's target means and stds;
        ``noise`` (pos, neg) over the G + P candidates or (None, None)."""
        assigner, samp = rcnn["assigner"], rcnn["sampler"]
        samp = samp[0] if isinstance(samp, (list, tuple)) else samp
        return random_sample_and_target(
            boxes, pmask, gt["gt_bboxes"], gt["gt_mask"], gt["gt_labels"],
            num=int(samp["num"]), pos_fraction=float(samp["pos_fraction"]),
            add_gt_as_proposals=bool(samp.get("add_gt_as_proposals", True)),
            pos_iou_thr=float(assigner["pos_iou_thr"]),
            neg_iou_thr=float(assigner["neg_iou_thr"]),
            min_pos_iou=float(assigner["min_pos_iou"]),
            target_means=means, target_stds=stds,
            pos_weight=float(rcnn.get("pos_weight", -1)),
            pos_noise=noise[0], neg_noise=noise[1], generator=self.generator)


class HNMBTrainer(BaseTrainer):
    """HVRNet triplet-video training (the reference trains the backbone and
    RPN under no_grad, with no RPN loss)."""

    freeze_backbone = True
    freeze_rpn = True
    video_per_cls = 3      # same-class videos at the head of the pool

    def __init__(self, engine, cfg, steps_per_epoch: int = 1000,
                 seed: int = 0):
        super().__init__(engine, cfg, steps_per_epoch, seed)
        self.ipv = int(engine.model_cfg["bbox_head"].get("imgs_per_video",
                                                         3))

    def select_videos(self, c5: torch.Tensor) -> List[int]:
        """The chosen videos' indices from the (F, C, h, w) C5 maps of the
        whole pool: videos 0..video_per_cls-1 share the key video's class,
        the rest are of other classes."""
        vpc = self.video_per_cls
        n_videos = c5.shape[0] // self.ipv
        if n_videos <= vpc:
            raise ValueError(f"HVRNet training needs extra-class videos "
                             f"beyond the {vpc} same-class ones (got "
                             f"{n_videos} videos)")
        frame_desc = widen(c5).mean(dim=(2, 3))
        video_desc = frame_desc.reshape(n_videos, self.ipv, -1).amax(dim=1)
        root_d = math.sqrt(video_desc.shape[-1])
        sim = torch.softmax(video_desc[:1] @ video_desc[:vpc].T / root_d,
                            dim=1)
        hard_same = int(sim[0, 1:].argmin()) + 1
        pair = video_desc[[0, hard_same]]
        esim = torch.softmax(pair @ video_desc[vpc:].T / root_d,
                             dim=1).sum(0)
        return [0, hard_same, int(esim.argmax()) + vpc]

    def loss_from_c4(self, c4: torch.Tensor, sample: Dict[str, Any],
                     noise: Optional[Sequence[torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, logs) of one step from the pool's C4 maps.

        ``noise``: (pos_noise, neg_noise), each (chosen·ipv, G + P) U(0, 1)
        sampler priorities for the chosen frames in order (G ground-truth
        slots, then P proposals); drawn from the trainer's generator when
        absent."""
        eng = self.engine
        model = eng.model
        tcfg = eng.train_cfg
        rcnn = tcfg["rcnn"]
        assigner, sampler = rcnn["assigner"], rcnn["sampler"]
        S, ipv, kd = int(sampler["num"]), self.ipv, eng.key_dim
        stride = eng.anchor_stride
        canvas = eng._canvas(c4.shape[2] * stride, c4.shape[3] * stride)

        with self._phase("selection"), torch.no_grad():
            chosen = self.select_videos(model.shared(c4))
        frames = [v * ipv + i for v in chosen for i in range(ipv)]
        gt = {k: torch.as_tensor(np.asarray(sample[k])[frames],
                                 device=eng.device)
              for k in ("gt_bboxes", "gt_labels", "gt_mask")}
        img_shape = np.asarray(sample["img_shape"])[frames]
        pad_shape = np.asarray(sample["pad_shape"])[frames]
        c4_v = c4[frames]

        with self._phase("proposals"), torch.no_grad():
            cls_map, reg_map = model.rpn(c4_v)
            rois, valid, keys = [], [], []
            for j in range(len(frames)):
                key = j - j % ipv + kd
                boxes, _, pmask = _rpn_proposals(
                    cls_map[j], reg_map[j], canvas, pad_shape[j],
                    img_shape[j], tcfg["rpn_proposal"], eng.rpn_means,
                    eng.rpn_stds)
                sr = random_sample_and_target(
                    boxes, pmask, gt["gt_bboxes"][key], gt["gt_mask"][key],
                    gt["gt_labels"][key], num=S,
                    pos_fraction=float(sampler["pos_fraction"]),
                    add_gt_as_proposals=bool(
                        sampler.get("add_gt_as_proposals", True)),
                    pos_iou_thr=float(assigner["pos_iou_thr"]),
                    neg_iou_thr=float(assigner["neg_iou_thr"]),
                    min_pos_iou=float(assigner["min_pos_iou"]),
                    target_means=eng.target_means,
                    target_stds=eng.target_stds,
                    pos_weight=float(rcnn.get("pos_weight", -1)),
                    pos_noise=None if noise is None else noise[0][j],
                    neg_noise=None if noise is None else noise[1][j],
                    generator=self.generator)
                idx = torch.full((S, 1), float(j % ipv), device=eng.device)
                rois.append(torch.cat([idx, sr.rois], dim=1))
                valid.append(sr.valid)
                if j % ipv == kd:
                    keys.append(sr)

        with self._phase("head"):
            c5 = model.shared(c4_v)              # the shared head trains
            per_video = range(0, len(frames), ipv)
            pooled = torch.stack([
                eng.roi_extractor(c5[f:f + ipv], torch.cat(rois[f:f + ipv]))
                for f in per_video])
            valid_mask = torch.stack([torch.cat(valid[f:f + ipv])
                                      for f in per_video])
            labels = torch.cat([k.labels for k in keys])
            lw = torch.cat([k.label_weights for k in keys])
            bt = torch.cat([k.bbox_targets for k in keys])
            bw = torch.cat([k.bbox_weights for k in keys])
            cls_list, reg_list, loss_trip = model.bbox_head.forward_train(
                pooled, labels, valid_mask)
            # cls normalised by the weighted rows, bbox by all key rows
            navg = (lw > 0).sum().float().clamp_min(1.0)
            logs = dict(loss_trip=loss_trip)
            total = loss_trip
            for b, (cls, reg) in enumerate(zip(cls_list, reg_list), 1):
                cls, reg = widen(cls), widen(reg)
                lc = (softmax_cross_entropy(cls, labels) * lw).sum() / navg
                lb = (smooth_l1(reg.reshape(-1, 4), bt, self.loss_beta)
                      * bw).sum() / labels.shape[0]
                logs[f"loss_cls_{b}"] = lc
                logs[f"loss_bbox_{b}"] = lb
                logs[f"acc_{b}"] = accuracy(cls.detach(), labels,
                                            mask=lw > 0)
                total = total + lc + lb
        return total, logs
