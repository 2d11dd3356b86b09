"""Detector engines (counterpart of ``hvrnet_tpu/engine/detector.py``:
``BaseEngine`` frame program, ``_RingMixin`` exact ring, ``SelsaRCNN`` and
``HNMBRCNN`` single-pass windows).

Per frame, ``frame_features`` runs once: backbone C4 → dilated C5 shared
head → RPN → static-NMS proposals → RoIAlign → ``fc_new_1``.  Per-frame
quantities do not depend on the window, so the window keeps only their
(fc1, boxes, mask) caches.  ``ring_step`` pushes a frame into the ring and
detects the window centre: the relation head (SELSA's 2 blocks, HRNMP's 4)
over all T·P cached rows, then class-wise NMS.

The ring lives on the device as (T, …) tensors updated in place (the JAX
package's pure version allocates a new ring per push); a detect reads it in
oldest→newest order, so the centre frame sits at ``key_dim``.

``HNMBRCNN.stream`` switches to the streaming ring: the ring also carries
NL1/NL3 softmax accumulators (``ops/streaming_attention.py``), and a
detection costs a slide of one frame plus NL2/NL4 instead of the whole
window head.

Lanes (``*_batched``, for B video streams in lockstep): the frame program
runs B frames through one backbone, proposes per lane and picks every
lane's proposals in one ``nms_static_lanes``; RoIAlign and ``fc_new_1``
stay per lane (one image each, as in the JAX package, so a bf16 lane takes
RoIAlign's one-image bf16 branch).  The batched ring is the exact ring, (B,
T, …) tensors with a position per lane; its detect runs the window head
over all lanes at once (each NL block one kernel call) and every lane's
decode through one ``multiclass_nms_static_lanes``.

``dtype`` is the engine's compute dtype (``core/precision.py``): float32,
or bfloat16 with float32 parameters, as ``bench.py`` serves.  In bf16 the
ring's row caches are bf16; boxes, scores, the streaming accumulators, the
softmaxes and the decode stay float32.  TF32 stays off either way.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.anchor_heads.rpn_head import rpn_flat_scores_deltas
from ..models.bbox_heads.bbox_head import get_det_bboxes
from ..models.builder import build_model_module, build_roi_extractor
from ..models.layers import FrozenBN
from ..models.registry import DETECTORS
from ..ops.boxes import delta2bbox
from ..ops.nms import multiclass_nms_static_lanes, nms_static_lanes
from ..utils.config import unwrap
from .canvas import Canvas


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller names the CPU;
    with no card they raise instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@contextlib.contextmanager
def f32_precision():
    """The engine's float32 work (all of it in a float32 engine, the
    softmaxes, accumulators and box math in a bf16 one) runs without TF32 in
    its convolutions and matmuls, whatever the process-wide flags say (they
    are restored on exit)."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def init_weights(model: torch.nn.Module, seed: int) -> None:
    """Random weights from a seed, with the JAX package's init scheme:
    He-normal convolutions, normal(0, 0.01) dense layers and RPN convs, zero
    biases, identity frozen BNs."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = (0.01 if name.startswith("rpn_head")
                       or "linear_out" in name else (2.0 / fan_in) ** 0.5)
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
            elif isinstance(m, torch.nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.01)
            elif isinstance(m, FrozenBN):
                for buf, val in (("weight", 1.0), ("bias", 0.0),
                                 ("running_mean", 0.0), ("running_var", 1.0)):
                    getattr(m, buf).fill_(val)
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and \
                    m.bias is not None:
                m.bias.zero_()


def _rpn_candidates(cls_map, reg_map, canvas: Canvas, pad_shape, img_shape,
                    rpn_cfg, means, stds):
    """Top-``nms_pre`` anchors by score (ties toward the lower index, as
    ``lax.top_k``), decoded and clamped: (proposals (k, 4), scores (k,),
    valid (k,)), the input of the proposal NMS."""
    scores, deltas = rpn_flat_scores_deltas(cls_map, reg_map)
    avalid = canvas.anchor_valid(pad_shape)
    masked = torch.where(avalid, scores, torch.full_like(scores, -1.0))
    k = min(int(rpn_cfg["nms_pre"]), masked.shape[0])
    order = torch.sort(masked, descending=True, stable=True)
    top_scores, topk = order.values[:k], order.indices[:k]
    proposals = delta2bbox(canvas.anchors[topk], deltas[topk], means, stds,
                           max_shape=img_shape)
    valid = avalid[topk]
    min_size = float(rpn_cfg.get("min_bbox_size", 0))
    if min_size > 0:
        w = proposals[:, 2] - proposals[:, 0] + 1
        h = proposals[:, 3] - proposals[:, 1] + 1
        valid = valid & (w >= min_size) & (h >= min_size)
    return proposals, top_scores, valid


def _rpn_proposals(cls_map, reg_map, canvas: Canvas, pad_shape, img_shape,
                   rpn_cfg, means, stds):
    """One frame's proposals: its candidates, then the ``nms_post``
    greedy-NMS picks.  Returns (boxes (P, 4), scores (P,), mask (P,));
    unused slots are 0."""
    cand = _rpn_candidates(cls_map, reg_map, canvas, pad_shape, img_shape,
                           rpn_cfg, means, stds)
    boxes, scores, mask = _rpn_pick(*(c[None] for c in cand), rpn_cfg)
    return boxes[0], scores[0], mask[0]


def _rpn_pick(proposals, scores, valid, rpn_cfg):
    """The ``nms_post`` greedy-NMS picks of every lane's (B, k) candidates,
    in one shared fixpoint: (boxes (B, P, 4), scores (B, P), mask (B, P));
    unused slots are 0."""
    keep_idx, keep_mask = nms_static_lanes(
        proposals, scores, float(rpn_cfg["nms_thr"]),
        int(rpn_cfg["nms_post"]), valid=valid)
    boxes = torch.gather(proposals, 1,
                         keep_idx[..., None].expand(-1, -1, 4)) \
        * keep_mask[..., None]
    out_scores = torch.gather(scores, 1, keep_idx)
    out_scores = torch.where(keep_mask, out_scores,
                             torch.zeros_like(out_scores))
    return boxes, out_scores, keep_mask


class BaseEngine:
    """Model construction, weights and the per-frame program.

    A serving engine takes a ``test_cfg``, whose ``bbox_head`` overrides
    the head's ``t_dim`` and ``sampler_num``; a training engine takes a
    ``train_cfg`` and no ``test_cfg``, and keeps the model config's."""

    def __init__(self, model_cfg: Dict[str, Any],
                 test_cfg: Optional[Dict[str, Any]] = None, device="cuda",
                 seed: int = 0, train_cfg: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"an engine computes in float32 or bfloat16, "
                             f"not {dtype}")
        model_cfg = unwrap(model_cfg)
        self.test_cfg = unwrap(test_cfg) if test_cfg else None
        self.train_cfg = unwrap(train_cfg) if train_cfg else None
        bh = dict(model_cfg["bbox_head"])
        if self.test_cfg is not None:
            bh["t_dim"] = int(self.test_cfg["bbox_head"]["t_dim"])
            bh["sampler_num"] = int(self.test_cfg["bbox_head"]["sampler_num"])
        self.model_cfg = model_cfg = dict(model_cfg, bbox_head=bh)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = build_model_module(model_cfg, dtype).eval()
        init_weights(self.model, seed)
        self.model.to(self.device)
        self.roi_extractor = build_roi_extractor(
            model_cfg["bbox_roi_extractor"])
        self.num_classes = int(bh["num_classes"])
        self.target_means = tuple(bh.get("target_means", (0., 0., 0., 0.)))
        self.target_stds = tuple(bh.get("target_stds", (0.1, 0.1, 0.2, 0.2)))
        rh = model_cfg["rpn_head"]
        self.rpn_means = tuple(rh.get("target_means", (0., 0., 0., 0.)))
        self.rpn_stds = tuple(rh.get("target_stds", (1., 1., 1., 1.)))
        self.anchor_scales = tuple(rh.get("anchor_scales", (8, 16, 32)))
        self.anchor_ratios = tuple(rh.get("anchor_ratios", (0.5, 1.0, 2.0)))
        self.anchor_stride = int(rh.get("anchor_strides", [16])[0])
        self.proposal_num = (int(self.test_cfg["rpn"]["nms_post"])
                             if self.test_cfg else 300)
        # uint8 frames are normalised on the device with the shipped
        # configs' img_norm_cfg
        self.img_norm = dict(mean=(103.06, 115.90, 123.15),
                             std=(1.0, 1.0, 1.0))
        self._canvases: Dict[tuple, Canvas] = {}

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load mmdet-named weights (a reference checkpoint's ``state_dict``
        or ``utils.weights.state_dict_from_jax``), all keys required."""
        self.model.load_state_dict(state_dict, strict=True)

    @torch.no_grad()
    def cast_head_params_bf16(self) -> None:
        """Store the bbox head's weights of rank ≥ 2 in bf16, for inference:
        a bf16 head would otherwise cast them at every call (fc_new_1 alone
        is 205 MB per frame).  The same cast done once, so bit for bit the
        same outputs; biases and the backbone keep float32.  A no-op on a
        float32 engine; a training engine must not call it."""
        if self.dtype != torch.bfloat16:
            return
        for p in self.model.bbox_head.parameters():
            if p.dtype == torch.float32 and p.ndim >= 2:
                p.data = p.data.to(torch.bfloat16)

    def _canvas(self, h: int, w: int) -> Canvas:
        key = (h, w)
        if key not in self._canvases:
            self._canvases[key] = Canvas(h, w, self.anchor_stride,
                                         self.anchor_scales,
                                         self.anchor_ratios, self.device)
        return self._canvases[key]

    def _to_input(self, img, img_shape) -> torch.Tensor:
        """(B, H, W, 3) canvases — normalised float32, or raw uint8, which
        is normalised here and zeroed beyond each frame's ``img_shape``
        ((2,), or (B, 2)) (the reference normalises, then pads with zeros)
        → (B, 3, H, W) float32."""
        x = torch.as_tensor(img, device=self.device)
        if x.dtype == torch.uint8:
            mean = torch.tensor(self.img_norm["mean"], dtype=torch.float32,
                                device=self.device)
            inv = 1.0 / torch.tensor(self.img_norm["std"], dtype=torch.float32,
                                     device=self.device)
            x = (x.float() - mean) * inv
            h, w = x.shape[1], x.shape[2]
            ish = torch.as_tensor(
                np.asarray(img_shape, np.float32).reshape(-1, 2),
                device=self.device)
            yy = torch.arange(h, dtype=torch.float32, device=self.device)
            xx = torch.arange(w, dtype=torch.float32, device=self.device)
            valid = ((yy[None, :, None] < ish[:, 0, None, None])
                     & (xx[None, None, :] < ish[:, 1, None, None]))
            x = x * valid[..., None]
        return x.float().permute(0, 3, 1, 2).contiguous()

    @torch.no_grad()
    @f32_precision()
    def backbone_maps(self, img, img_shape):
        """(c5, rpn cls, rpn reg) maps, NCHW, of (B, H, W, 3) canvases
        (one frame: B = 1)."""
        x = self._to_input(img, img_shape)
        c4 = self.model.extract_feat(x)
        cls_map, reg_map = self.model.rpn(c4)
        return self.model.shared(c4), cls_map, reg_map

    @torch.no_grad()
    def frame_features(self, img, img_shape, pad_shape) -> Dict[str, Any]:
        """img: (1, H, W, 3) canvas-padded frame (normalised float32 or raw
        uint8).  Returns the frame's window caches: fc1 (P, D), boxes (P, 4),
        scores (P,), mask (P,)."""
        c5, cls_map, reg_map = self.backbone_maps(img, img_shape)
        return self.frame_post(c5, cls_map, reg_map, img_shape, pad_shape)

    @torch.no_grad()
    @f32_precision()
    def frame_post(self, c5, cls_map, reg_map, img_shape, pad_shape):
        """Proposals → RoIAlign → fc_new_1 from one frame's NCHW maps."""
        out = self.frame_post_batched(c5, cls_map, reg_map, [img_shape],
                                      [pad_shape])
        return {k: v[0] for k, v in out.items()}

    @torch.no_grad()
    def frame_features_batched(self, imgs, img_shapes, pad_shapes
                               ) -> Dict[str, Any]:
        """imgs: (B, H, W, 3), one canvas-padded frame from each of B video
        streams (normalised float32 or raw uint8); img_shapes, pad_shapes
        (B, 2).  Returns the frames' window caches with a leading lane
        axis: fc1 (B, P, D), boxes (B, P, 4), scores (B, P), mask (B, P)."""
        c5, cls_map, reg_map = self.backbone_maps(imgs, img_shapes)
        return self.frame_post_batched(c5, cls_map, reg_map, img_shapes,
                                       pad_shapes)

    @torch.no_grad()
    @f32_precision()
    def frame_post_batched(self, c5, cls_map, reg_map, img_shapes,
                           pad_shapes) -> Dict[str, Any]:
        """Proposals → RoIAlign → fc_new_1 from B frames' NCHW maps: the
        candidates per lane, one NMS fixpoint for all lanes, then RoIAlign
        and fc_new_1 per lane (one image each)."""
        stride = self.anchor_stride
        canvas = self._canvas(c5.shape[2] * stride, c5.shape[3] * stride)
        rpn_cfg = self.test_cfg["rpn"]
        cands = [_rpn_candidates(cls_map[b], reg_map[b], canvas,
                                 pad_shapes[b], img_shapes[b], rpn_cfg,
                                 self.rpn_means, self.rpn_stds)
                 for b in range(c5.shape[0])]
        boxes, scores, mask = _rpn_pick(*(torch.stack(c) for c in
                                          zip(*cands)), rpn_cfg)
        fc1 = []
        for b in range(c5.shape[0]):
            rois = torch.cat([torch.zeros_like(boxes[b, :, :1]), boxes[b]],
                             dim=1)
            pooled = self.roi_extractor(c5[b:b + 1], rois)
            fc1.append(self.model.bbox_head.precompute_fc1(pooled))
        return dict(fc1=torch.stack(fc1), boxes=boxes, scores=scores,
                    mask=mask)


class _RingMixin:
    """Device-resident sliding-window ring of per-frame caches (the exact
    ring: every detection recomputes the whole window head)."""

    def ring_reset(self, fc1_dim: int) -> Dict[str, Any]:
        T, P = self.window, self.proposal_num
        dev = self.device
        return dict(fc1=torch.zeros((T, P, fc1_dim), dtype=self.dtype,
                                    device=dev),
                    boxes=torch.zeros((T, P, 4), device=dev),
                    masks=torch.zeros((T, P), dtype=torch.bool, device=dev),
                    pos=-1)

    def ring_push(self, state, feats) -> Dict[str, Any]:
        """Write a frame's caches over the oldest slot (in place)."""
        pos = (state["pos"] + 1) % self.window
        state["fc1"][pos] = feats["fc1"]
        state["boxes"][pos] = feats["boxes"]
        state["masks"][pos] = feats["mask"]
        state["pos"] = pos
        return state

    def ring_detect(self, state, img_shape, scale_factor, branch=None):
        order = (torch.arange(self.window, device=self.device)
                 + state["pos"] + 1) % self.window       # oldest → newest
        return self.window_detect(state["fc1"][order], state["boxes"][order],
                                  state["masks"][order], img_shape,
                                  scale_factor, branch)

    def ring_step(self, state, feats, img_shape, scale_factor, branch=None):
        """Push a frame's caches and detect the window centre."""
        state = self.ring_push(state, feats)
        return state, self.ring_detect(state, img_shape, scale_factor,
                                       branch)

    def window_detect(self, fc1_stack, boxes, masks, img_shape, scale_factor,
                      branch=None):
        """fc1_stack: (T, P, D), boxes: (T, P, 4), masks: (T, P), oldest
        frame first.  Decodes the centre frame ``key_dim`` in original-image
        coords: a (dets (max, 5), labels (max,), mask (max,)) triple, or on
        a multi-branch engine one per head branch unless ``branch`` is
        given.  One lane of ``window_detect_batched``."""
        outs = self.window_detect_batched(
            fc1_stack[None], boxes[None], masks[None], [img_shape],
            [scale_factor], branch)
        if isinstance(outs, list):
            return [tuple(t[0] for t in out) for out in outs]
        return tuple(t[0] for t in outs)

    # ------------------------------------------------ batched ring (lanes)
    # B exact rings, one per video stream, as (B, T, …) tensors with a
    # host-side position per lane.  It is the exact ring on every engine,
    # a streaming one included, as in the JAX package.

    def ring_reset_batched(self, batch: int, fc1_dim: int) -> Dict[str, Any]:
        T, P = self.window, self.proposal_num
        dev = self.device
        return dict(fc1=torch.zeros((batch, T, P, fc1_dim), dtype=self.dtype,
                                    device=dev),
                    boxes=torch.zeros((batch, T, P, 4), device=dev),
                    masks=torch.zeros((batch, T, P), dtype=torch.bool,
                                      device=dev),
                    pos=np.full(batch, -1, np.int64))

    @torch.no_grad()
    def ring_push_batched(self, state, feats, reset) -> Dict[str, Any]:
        """Write each lane's frame caches (``feats`` with a leading lane
        axis) over its oldest slot, in place; ``reset`` (B,) bool instead
        fills that lane's whole ring with its frame (a video's front
        padding in one push)."""
        reset = np.asarray(reset, bool)
        pos = np.where(reset, 0, (state["pos"] + 1) % self.window)
        dev = self.device
        lanes = torch.arange(len(pos), device=dev)
        fill = torch.as_tensor(np.flatnonzero(reset), device=dev)
        for key, src in (("fc1", "fc1"), ("boxes", "boxes"),
                         ("masks", "mask")):
            new = feats[src].to(state[key].dtype)
            state[key][lanes, torch.as_tensor(pos, device=dev)] = new
            if len(fill):
                state[key][fill] = new[fill][:, None]
        state["pos"] = pos
        return state

    def ring_detect_batched(self, state, img_shapes, scale_factors,
                            branch=None):
        """Every lane's window centre from its own ring, oldest frame first
        (each lane rolled by its own position): ``window_detect_batched``
        on (B, T, …) stacks."""
        T = self.window
        order = (np.arange(T)[None] + state["pos"][:, None] + 1) % T
        dev = self.device
        lanes = torch.arange(order.shape[0], device=dev)[:, None]
        order = torch.as_tensor(order, device=dev)
        return self.window_detect_batched(
            state["fc1"][lanes, order], state["boxes"][lanes, order],
            state["masks"][lanes, order], img_shapes, scale_factors, branch)

    def _decode_lanes(self, pairs, rois, img_shapes, scale_factors, valid):
        """Each head output pair (cls (B, P, C), reg (B, P, 4·k)) decoded
        per lane (``get_det_bboxes`` without its NMS) and then the class-wise
        NMS of all lanes in one fixpoint: a (dets (B, max, 5), labels (B,
        max), mask (B, max)) triple per pair."""
        rcnn = self.test_cfg["rcnn"]
        outs = []
        for cls, reg in pairs:
            dec = [get_det_bboxes(rois[b], cls[b], reg[b], img_shapes[b],
                                  scale_factors[b], self.target_means,
                                  self.target_stds, rescale=True)
                   for b in range(rois.shape[0])]
            bboxes, scores = (torch.stack(x) for x in zip(*dec))
            outs.append(multiclass_nms_static_lanes(
                bboxes, scores, float(rcnn["score_thr"]),
                float(rcnn["nms"]["iou_thr"]), int(rcnn["max_per_img"]),
                valid=valid))
        return outs

    def _window_lanes(self, fc1_stack, masks):
        """The head over B lanes' (B, T, P, D) windows: its (cls, reg)
        pairs, the key frame's rows of each lane."""
        B, T = fc1_stack.shape[:2]
        P = self.proposal_num
        cls, reg = self.model.bbox_head.forward_fc1(
            fc1_stack.reshape(B, T * P, -1), self.key_dim * P, P,
            masks.reshape(B, T * P))
        if isinstance(cls, list):
            return list(zip(cls, reg))
        return [(cls, reg)]


@DETECTORS.register_module
class SelsaRCNN(_RingMixin, BaseEngine):
    """SELSA video detector: the 2-block SELSA head over the window's rows,
    one prediction per detection (exact ring only)."""

    stream = False     # SELSA has no streaming ring

    def __init__(self, model_cfg, test_cfg=None, device="cuda",
                 seed: int = 0, train_cfg=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(model_cfg, test_cfg, device, seed, train_cfg, dtype)
        if self.train_cfg is not None:
            self.key_dim = int(self.train_cfg["rcnn"]["key_dim"])
        else:
            self.key_dim = int(
                self.test_cfg["relation_setup"]["frame_interval"])
        self.window = (2 * int(
            self.test_cfg["relation_setup"]["frame_interval"]) + 1
            if self.test_cfg else None)

    @torch.no_grad()
    @f32_precision()
    def window_detect_batched(self, fc1_stack, boxes, masks, img_shapes,
                              scale_factors, branch=None):
        """fc1_stack: (B, T, P, D), boxes: (B, T, P, 4), masks: (B, T, P),
        each lane's window oldest frame first.  Decodes each lane's centre
        frame ``key_dim`` with its row of ``img_shapes`` (B, 2) and
        ``scale_factors`` (B, 4): (dets (B, max, 5), labels (B, max), mask
        (B, max)); ``branch`` is ignored (one branch)."""
        kd = self.key_dim
        return self._decode_lanes(self._window_lanes(fc1_stack, masks),
                                  boxes[:, kd], img_shapes, scale_factors,
                                  masks[:, kd])[0]


@DETECTORS.register_module
class HNMBRCNN(_RingMixin, BaseEngine):
    """HVRNet detector: the SELSA machine with the 4-block HRNMP head.  The
    branch and final predictions both decode through ``get_det_bboxes``; the
    runner keeps one branch (final by default, the one mAP uses)."""

    multi_branch = True   # the head emits [branch, final] prediction pairs

    #: the streaming ring: NL1/NL3 kept as softmax accumulators updated by
    #: one frame per slide (exact up to their rounding; the health tables
    #: catch the float32 failure modes, ops/streaming_attention.py)
    stream: bool = False

    #: speculative streaming: a slide commits without the exact repair and
    #: ORs its health verdict into a sticky device flag (``state["flag"]``);
    #: ``SlidingWindowRunner`` reads the flag with each chunk of detections,
    #: replays a flagged chunk exactly and calls ``stream_rebuild``.  The
    #: in-step repair (False) must read the verdict on the host, a device
    #: sync in the slide and another in the decode of every step; the
    #: runner turns this on for its run unless told otherwise.
    stream_rollback: bool = False

    _STREAM_KEYS = ("fc1", "q1", "k1", "fc3s", "q3", "k3",
                    "m1", "l1", "a1", "m3", "l3", "a3", "M1", "M3")

    def __init__(self, model_cfg, test_cfg=None, device="cuda",
                 seed: int = 0, train_cfg=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(model_cfg, test_cfg, device, seed, train_cfg, dtype)
        if self.test_cfg is None:
            # training: the key frame of each sampled video
            self.key_dim = int(self.train_cfg["rcnn"].get("key_dim", 0))
            self.window = None
        else:
            self.key_dim = int(self.test_cfg["bbox_head"]["key_dim"])
            self.window = 2 * int(
                self.test_cfg["relation_setup"]["frame_interval"]) + 1

    @torch.no_grad()
    @f32_precision()
    def window_detect_batched(self, fc1_stack, boxes, masks, img_shapes,
                              scale_factors, branch=None):
        """fc1_stack: (B, T, P, D), boxes: (B, T, P, 4), masks: (B, T, P),
        each lane's window oldest frame first.  Decodes each lane's centre
        frame ``key_dim`` with its row of ``img_shapes`` (B, 2) and
        ``scale_factors`` (B, 4): one (dets (B, max, 5), labels (B, max),
        mask (B, max)) triple per head branch, or only ``branch``'s."""
        kd = self.key_dim
        pairs = self._window_lanes(fc1_stack, masks)
        if branch is not None:
            pairs = [pairs[branch]]
        outs = self._decode_lanes(pairs, boxes[:, kd], img_shapes,
                                  scale_factors, masks[:, kd])
        return outs[0] if branch is not None else outs

    # --------------------------------------------------- streaming ring
    def ring_reset(self, fc1_dim: int) -> Dict[str, Any]:
        if not self.stream:
            return super().ring_reset(fc1_dim)
        T, P = self.window, self.proposal_num
        R = T * P
        bh = self.model_cfg["bbox_head"]
        key_rows = int(bh["t_dim"]) * int(bh.get("sampler_num", P))
        if key_rows < R:
            raise ValueError("streaming ring requires every cached row to be "
                             "a key (t_dim·sampler_num ≥ window·proposals; "
                             f"got {key_rows} < {R})")
        dim = tuple(bh.get("dim", (1024, 1024, 1024)))
        fc_feat = int(bh.get("fc_feat_dim", 1024))
        dev = self.device

        def zeros(*shape):
            return torch.zeros(shape, device=dev)

        def rows(width):          # row caches, in the compute dtype
            return torch.zeros((R, width), dtype=self.dtype, device=dev)

        def neg_inf(*shape):
            return torch.full(shape, -torch.inf, device=dev)

        state = dict(boxes=zeros(T, P, 4),
                     masks=torch.zeros((T, P), dtype=torch.bool, device=dev),
                     pos=-1,
                     fc1=rows(fc1_dim), q1=rows(dim[0]), k1=rows(dim[1]),
                     fc3s=rows(fc_feat), q3=rows(dim[0]), k3=rows(dim[1]),
                     m1=neg_inf(R), l1=zeros(R), a1=zeros(R, fc1_dim),
                     m3=neg_inf(R), l3=zeros(R), a3=zeros(R, fc_feat),
                     M1=neg_inf(R, T), M3=neg_inf(R, T))
        if self.stream_rollback:
            state["flag"] = torch.zeros((), dtype=torch.bool, device=dev)
        return state

    def head_state(self, state):
        """The head's view of a streaming ring state (the same tensors;
        the mask under the head's key ``mask``)."""
        hst = {k: state[k] for k in self._STREAM_KEYS}
        hst["mask"] = state["masks"]
        return hst

    def _stream_push(self, state, feats):
        """Slide the frame into the next slot (under rollback, its health
        verdict sticks in the flag)."""
        pos = (state["pos"] + 1) % self.window
        upd = self.model.bbox_head.stream_update(
            self.head_state(state), feats["fc1"], feats["mask"], pos,
            self.stream_rollback)
        if self.stream_rollback:
            upd, bad = upd
            state["flag"] |= bad
        state.update({k: upd[k] for k in self._STREAM_KEYS})
        state["boxes"][pos] = feats["boxes"]
        state["pos"] = pos

    def _stream_decode(self, state, img_shape, scale_factor, branch):
        center = (state["pos"] + 1 + self.key_dim) % self.window
        fwd = self.model.bbox_head.stream_forward(
            self.head_state(state), center, self.stream_rollback)
        if self.stream_rollback:
            cls_list, reg_list, bad = fwd
            state["flag"] |= bad
        else:
            cls_list, reg_list = fwd
        pairs = list(zip(cls_list, reg_list))
        if branch is not None:
            pairs = [pairs[branch]]
        outs = [get_det_bboxes(state["boxes"][center], cls, reg, img_shape,
                               scale_factor, self.target_means,
                               self.target_stds, rescale=True,
                               cfg=self.test_cfg["rcnn"],
                               valid=state["masks"][center])
                for cls, reg in pairs]
        return outs[0] if branch is not None else outs

    @torch.no_grad()
    @f32_precision()
    def ring_push(self, state, feats) -> Dict[str, Any]:
        if not self.stream:
            return super().ring_push(state, feats)
        self._stream_push(state, feats)
        return state

    @torch.no_grad()
    @f32_precision()
    def ring_detect(self, state, img_shape, scale_factor, branch=None):
        if not self.stream:
            return super().ring_detect(state, img_shape, scale_factor, branch)
        if self.stream_rollback:
            # a detect alone returns no state to carry the health flag in, and
            # repairing here would hide what the flag protocol must surface
            raise ValueError("stream_rollback detects via ring_step; set "
                             "stream_rollback=False for split push/detect")
        return self._stream_decode(state, img_shape, scale_factor, branch)

    @torch.no_grad()
    @f32_precision()
    def ring_step(self, state, feats, img_shape, scale_factor, branch=None):
        """Push a frame's caches and detect the window centre; on the
        streaming ring under rollback, both the slide's and the decode's
        health verdicts stick in ``state["flag"]``."""
        if not self.stream:
            return super().ring_step(state, feats, img_shape, scale_factor,
                                     branch)
        self._stream_push(state, feats)
        return state, self._stream_decode(state, img_shape, scale_factor,
                                          branch)

    @torch.no_grad()
    @f32_precision()
    def stream_rebuild(self, state) -> Dict[str, Any]:
        """Exact rebuild of the streaming accumulators from the ring's
        caches, clearing the health flag: the recovery half of the rollback
        protocol (one (R, R) pass per block)."""
        hst = self.model.bbox_head.stream_rebuild(self.head_state(state))
        state.update({k: hst[k] for k in self._STREAM_KEYS})
        if "flag" in state:
            state["flag"] = torch.zeros_like(state["flag"])
        return state


@DETECTORS.register_module
class HNLRCNN(HNMBRCNN):
    """The config's intra+inter-video variant (``net_type = 'HNLRCNN'``):
    HVRNet's engine and trainer under its own name, as in the JAX
    package."""
