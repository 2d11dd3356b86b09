"""The port's multi-device rehearsal on the CPU (counterpart of
``__graft_entry__.py:dryrun_multichip``):

    python -m hvrnet_tpu_torch.parallel.dryrun 2

With n gloo ranks on the CPU (n processes) and n replicas in this process,
on tiny engines (R50-C4 at 64×96, 8 RoIs, the JAX dryrun's configs):

1. one HVRNet data-parallel training step (``HNMBTrainer``, 5 videos × 3
   frames per rank): finite, the parameters equal bit for bit across the
   ranks, and equal to one process that averages the n samples'
   gradients (``mean_gradient_step``);
2. ``masked_attention_kv_sharded`` over n shards against
   ``attention_plain``;
3. SELSA's lockstep lanes split over n replicas
   (``enable_spmd_lanes``) against the unsharded batched engine: the frame
   program's picks and fc1, and the ring's detections on the same caches.

``dp_step_rank`` and ``mean_gradient_step`` are the two sides of the
data-parallel check, for any engine, sample maker and device (the card
check runs them at full width).
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch

from ..apis import build_detector, trainer_class
from ..ops.attention import (NEG_INF, attention_plain, masked_attention,
                             masked_attention_kv_sharded)
from .launch import free_coordinator, spawn
from .mesh import broadcast_, init_distributed, rank_seed

# one data-parallel step against the one-process mean of the gradients:
# |Δ| ≤ PARAM_TOL · max(1, |w|) (float32; at two ranks the two means add
# the same two terms, so the CPU run is bit for bit)
PARAM_TOL = 1e-6
# the kv-sharded attention against attention_plain, float32 (the JAX
# test's limit, tests/test_attention.py:52)
KV_TOL = 2e-5
# lanes split over replicas against the unsharded engine, boxes (px) and
# scores of the same detections (the JAX dryrun's limit)
LANES_TOL = 5e-3


def tiny_model_cfg(head_type="SelsaBBoxHead", sampler_num=8, t_dim=3,
                   **head_kw) -> Dict[str, Any]:
    """The JAX dryrun's tiny detector: caffe R50 C4, a 64-channel RPN,
    the relation head ``head_type``."""
    head = dict(type=head_type, sampler_num=sampler_num, t_dim=t_dim,
                in_channels=256, num_classes=31, reg_class_agnostic=True,
                loss_bbox=dict(type="SmoothL1Loss", beta=1.0), **head_kw)
    return dict(
        type="HNMBRCNN" if head_type == "HRNMPBBoxHead" else "SelsaRCNN",
        backbone=dict(type="ResNet", depth=50, num_stages=3,
                      strides=(1, 2, 2), dilations=(1, 1, 1),
                      out_indices=(2,), frozen_stages=1, style="caffe",
                      norm_eval=True),
        shared_head=dict(type="ResLayer", depth=50, stage=3, stride=1,
                         dilation=2, style="caffe", norm_eval=True,
                         external_conv=True),
        rpn_head=dict(type="RPNHead", in_channels=1024, feat_channels=64,
                      anchor_scales=[4, 8, 16, 32],
                      anchor_ratios=[0.5, 1.0, 2.0], anchor_strides=[16]),
        bbox_roi_extractor=dict(
            type="SingleRoIExtractor",
            roi_layer=dict(type="RoIAlign", out_size=7, sample_num=2),
            out_channels=1024, featmap_strides=[16],
            feat_from_shared_head=True),
        bbox_head=head)


def tiny_train_cfg(num: int = 8) -> Dict[str, Any]:
    """The JAX dryrun's training config: 32 anchors, ``num`` RoIs."""
    return dict(
        rpn=dict(
            assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7,
                          neg_iou_thr=0.3, min_pos_iou=0.3,
                          ignore_iof_thr=-1),
            sampler=dict(type="RandomSampler", num=32, pos_fraction=0.5,
                         neg_pos_ub=-1, add_gt_as_proposals=False),
            allowed_border=0, pos_weight=-1, debug=False),
        rpn_proposal=dict(nms_pre=100, nms_post=num, max_num=num,
                          nms_thr=0.7, min_bbox_size=0),
        rcnn=dict(
            assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                          neg_iou_thr=0.5, min_pos_iou=0.5,
                          ignore_iof_thr=-1),
            sampler=dict(type="RandomSampler", num=num, pos_fraction=0.25,
                         neg_pos_ub=-1, add_gt_as_proposals=True),
            key_dim=0, pos_weight=-1, debug=False))


def tiny_test_cfg(interval: int = 1, proposals: int = 8) -> Dict[str, Any]:
    t = 2 * interval + 1
    return dict(
        rpn=dict(nms_pre=200, nms_post=proposals, max_num=proposals,
                 nms_thr=0.7, min_bbox_size=0),
        rcnn=dict(score_thr=0.001, nms=dict(type="nms", iou_thr=0.3),
                  max_per_img=20, key_dim=interval),
        bbox_head=dict(sampler_num=proposals, t_dim=t, key_dim=interval),
        relation_setup=dict(shuffle=False, video_shuffle=True, has_rpn=True,
                            frame_interval=interval, frame_stride=1))


def tiny_sample(seed: int, frames: int = 15, h: int = 64, w: int = 96,
                gmax: int = 4) -> Dict[str, np.ndarray]:
    """One ``collate_train`` sample of noise frames with two boxes each
    (the JAX dryrun's shapes: 5 videos × 3 frames at 64×96)."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((frames, gmax, 4), np.float32)
    gt[..., 2], gt[..., 3] = 40.0, 30.0
    gt[:, 1] += np.array([20.0, 16.0, 20.0, 16.0], np.float32)
    mask = np.zeros((frames, gmax), bool)
    mask[:, :2] = True
    return dict(
        imgs=rng.normal(size=(frames, h, w, 3)).astype(np.float32) * 40,
        gt_bboxes=gt, gt_labels=np.ones((frames, gmax), np.int64),
        gt_mask=mask,
        img_shape=np.tile([h - 4.0, w - 2.0], (frames, 1)).astype(np.float32),
        pad_shape=np.tile([float(h), float(w)], (frames, 1)).astype(
            np.float32))


def _trainer(spec: Dict[str, Any], device):
    """A training engine of ``spec`` on ``device``, seeded, with the
    weights of ``spec["weights"]`` (a saved ``state_dict``) where it names
    them, and its trainer."""
    engine = build_detector(spec["model_cfg"], train_cfg=spec["train_cfg"],
                            device=device, seed=spec.get("seed", 0))
    if spec.get("weights"):
        engine.model.load_state_dict(torch.load(spec["weights"],
                                                map_location=device,
                                                weights_only=True))
    return trainer_class(engine)(engine, spec["cfg"], 1000,
                                 spec.get("seed", 0))


def _sample(spec: Dict[str, Any], rank: int):
    make, args = spec["make_sample"], spec["sample_args"][rank]
    return make(*args)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dp_step_rank(local_rank: int, world: int, coordinator: str,
                 spec: Dict[str, Any], out_dir: str, device="cpu",
                 backend=None, threads=None, steps: int = 1,
                 collectives: bool = False) -> None:
    """Rank ``local_rank`` of a ``world``-rank data-parallel run on
    ``device`` (or on ``device[local_rank]`` of a list): joins the group
    (``init_distributed``), builds the trainer of ``spec`` (``model_cfg``,
    ``train_cfg``, ``cfg``, ``seed`` and optionally ``weights``) and takes
    ``steps`` steps on its sample
    (``spec["make_sample"](*spec["sample_args"][rank])``).  Writes
    ``out_dir/rank_<r>.pt``: the trainable parameters after the first
    step, its logs, the backend, each step's wall ms, the attention
    kernel's launches over the steps and the peak memory (GiB, on a
    card); with ``collectives``, also ``collective_check``'s record."""
    if isinstance(device, (list, tuple)):
        device = device[local_rank]
    if threads:
        torch.set_num_threads(threads)
    backend = init_distributed(coordinator, world, local_rank, device,
                               backend)
    try:
        trainer = _trainer(spec, device)
        sample = _sample(spec, local_rank)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        times, first = [], None
        masked_attention.launches = 0
        for _ in range(steps):
            _sync(device)
            t0 = time.perf_counter()
            logs = trainer.train_step(sample)
            _sync(device)
            times.append(1e3 * (time.perf_counter() - t0))
            if first is None:
                first = dict(params=trainable_state(trainer),
                             logs={k: float(v) for k, v in logs.items()})
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if torch.device(device).type == "cuda" else None)
        launches = masked_attention.launches
        extra = (dict(collectives=collective_check(trainer, sample, device))
                 if collectives else {})
        torch.save(dict(first, backend=backend, ms=times, peak_gib=peak,
                        launches=launches, **extra),
                   os.path.join(out_dir, f"rank_{local_rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def collective_check(trainer, sample, device, repeats: int = 2
                     ) -> Dict[str, Any]:
    """The step's collectives alone, after the steps: one more backward on
    ``sample``, then ``repeats`` times the gradient all-reduce of
    ``trainer.reduce`` (every gradient, the loss and the logs in one flat
    buffer) and a broadcast of the parameters from rank 0, each timed on
    the host around a synchronisation.  Raises unless the broadcast leaves
    the parameters as they were (the ranks hold equal ones) and, at world
    1, the all-reduce leaves the gradients as they were.  Returns the
    times (ms), the world and the MiB the all-reduce carries."""
    loss, logs = trainer.forward_backward(sample)
    grads = [None if p.grad is None else p.grad.clone()
             for p in trainer.params]
    params = [p.detach().clone() for p in trainer.params]
    reduce_ms, broadcast_ms = [], []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        loss, logs = trainer.reduce(loss, logs)
        _sync(device)
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        broadcast_([p.data for p in trainer.params])
        _sync(device)
        broadcast_ms.append(1e3 * (time.perf_counter() - t0))
    world = torch.distributed.get_world_size()
    if not all(torch.equal(p, w) for p, w in zip(trainer.params, params)):
        raise RuntimeError("the broadcast from rank 0 changed the "
                           "parameters")
    if world == 1 and not all(
            (g is None) == (p.grad is None)
            and (g is None or torch.equal(p.grad, g))
            for p, g in zip(trainer.params, grads)):
        raise RuntimeError("the all-reduce over one rank changed the "
                           "gradients")
    mib = sum(p.numel() * p.element_size() for p in trainer.params) / 2**20
    return dict(world=world, reduce_ms=reduce_ms, broadcast_ms=broadcast_ms,
                mib=mib)


def trainable_state(trainer) -> Dict[str, torch.Tensor]:
    """The trainer's trainable parameters by name, on the host."""
    names = {id(p): n for n, p in trainer.engine.model.named_parameters()}
    return {names[id(p)]: p.detach().cpu().clone() for p in trainer.params}


def mean_gradient_step(spec: Dict[str, Any], world: int, device="cpu"):
    """The data-parallel step of ``world`` ranks in one process: each
    rank's sample through the loss and its backward with rank r's sampler
    generator (seed ``rank_seed(seed, r)``), the gradients' mean (their
    sum in rank order over ``world``), then one update.  Returns the
    trainable parameters by name, on the host."""
    trainer = _trainer(spec, device)
    seed = spec.get("seed", 0)
    total = [None] * len(trainer.params)
    for r in range(world):
        trainer.generator.manual_seed(rank_seed(seed, r))
        trainer.forward_backward(_sample(spec, r))
        for i, p in enumerate(trainer.params):
            if p.grad is not None:
                total[i] = p.grad.clone() if total[i] is None \
                    else total[i] + p.grad
    for p, g in zip(trainer.params, total):
        p.grad = None if g is None else g / world
    trainer.apply_update()
    return trainable_state(trainer)


def data_parallel_check(spec: Dict[str, Any], world: int, work: str,
                        device="cpu", backend=None, timeout: float = 600.0,
                        threads=None, steps: int = 1,
                        collectives: bool = False) -> Dict[str, Any]:
    """``world`` ranks of ``dp_step_rank`` (spawned, ``steps`` steps each,
    within ``timeout`` s; ``device`` one for all or a list, one per rank),
    then ``mean_gradient_step`` in this process on the first rank's
    device: raises unless every rank's logs are finite, the ranks'
    parameters are equal bit for bit and within ``PARAM_TOL`` of the
    one-process mean.  Returns each rank's record, the largest difference
    and the ranks' wall seconds, their start included."""
    t0 = time.perf_counter()
    spawn(dp_step_rank, world, (world, free_coordinator(), spec, work,
                                device, backend, threads, steps,
                                collectives), timeout=timeout)
    ranks_s = time.perf_counter() - t0
    first_device = device[0] if isinstance(device, (list, tuple)) else device
    want = mean_gradient_step(spec, world, first_device)
    ranks = [torch.load(os.path.join(work, f"rank_{r}.pt"),
                        weights_only=False) for r in range(world)]
    for r, rec in enumerate(ranks):
        if not all(np.isfinite(v) for v in rec["logs"].values()):
            raise RuntimeError(f"rank {r}: non-finite logs {rec['logs']}")
    first = ranks[0]["params"]
    for r, rec in enumerate(ranks[1:], 1):
        for name, t in rec["params"].items():
            if not torch.equal(t, first[name]):
                raise RuntimeError(f"rank {r}'s {name} differs from rank "
                                   f"0's after the step")
    err = max(((first[n] - w).abs().max()
               / w.abs().max().clamp_min(1.0)).item()
              for n, w in want.items())
    if err > PARAM_TOL:
        raise RuntimeError(f"{world} ranks against one process's mean "
                           f"gradient: {err:.3g} of max(1, |w|) "
                           f"(limit {PARAM_TOL})")
    return dict(ranks=ranks, max_rel_err=err, ranks_s=ranks_s)


def kv_sharded_check(n: int, devices=None, seed: int = 0) -> float:
    """``masked_attention_kv_sharded`` over ``n`` shards (on ``devices``,
    default the CPU) against ``attention_plain``, 40 queries over 16·n
    keys, ~20 % masked: returns the largest difference, raises past
    ``KV_TOL``."""
    g = torch.Generator().manual_seed(seed)
    nk = 16 * n
    q, k, v = (torch.randn(m, 64, generator=g) for m in (40, nk, nk))
    bias = torch.where(torch.rand(nk, generator=g) < 0.2, NEG_INF, 0.0)
    got = masked_attention_kv_sharded(q, k, v, bias, 0.125,
                                      devices or ["cpu"] * n)
    err = (got - attention_plain(q, k, v, bias, 0.125)).abs().max().item()
    if err > KV_TOL:
        raise RuntimeError(f"kv-sharded attention over {n} shards: {err}")
    return err


def spmd_lanes_check(n: int, steps: int = 3, seed: int = 2) -> float:
    """SELSA's lockstep lanes (B = n streams of noise frames) split over n
    CPU replicas against the unsharded batched engine, the JAX dryrun's
    rules: the frame program's picks agree on at least 3/4 of the rows
    (a replica's smaller batch rounds its convolutions otherwise, and
    random weights on noise leave near-tied RPN scores) and fc1 on those
    rows within 1e-3 of max(1, max|fc1|); pushed the same caches, the
    rings' detections: masks and labels equal, boxes and scores within
    ``LANES_TOL`` (each replica's head multiplies fewer rows at once, which
    rounds otherwise).  Returns the pick agreement."""
    from ..engine.detector import SelsaRCNN
    model_cfg, test_cfg = tiny_model_cfg(), tiny_test_cfg()
    plain = SelsaRCNN(model_cfg, test_cfg, device="cpu", seed=seed)
    spmd = SelsaRCNN(model_cfg, test_cfg, device="cpu", seed=seed)
    spmd.enable_spmd_lanes(["cpu"] * n)
    rng = np.random.default_rng(seed)
    shapes = np.tile([60.0, 90.0], (n, 1)).astype(np.float32)
    sfs = np.ones((n, 4), np.float32)
    state_p = state_s = None
    agree = 1.0
    for step in range(steps):
        frames = (rng.normal(size=(n, 64, 96, 3)) * 40).astype(np.float32)
        f_p = plain.frame_features_batched(frames, shapes, shapes)
        f_s = spmd.frame_features_batched(frames, shapes, shapes)
        same = ((f_p["boxes"] - f_s["boxes"]).abs() < 1e-2).all(-1)
        agree = min(agree, same.float().mean().item())
        scale = max(1.0, f_p["fc1"].abs().max().item())
        err = (f_p["fc1"] - f_s["fc1"])[same].abs().max().item()
        if agree < 0.75 or err > 1e-3 * scale:
            raise RuntimeError(f"step {step}: the replicas' frame program "
                               f"agrees on {agree:.0%} of the picks, fc1 "
                               f"{err:.3g} off (scale {scale:.3g})")
        if state_p is None:
            d = int(f_p["fc1"].shape[-1])
            state_p = plain.ring_reset_batched(n, d)
            state_s = spmd.ring_reset_batched(n, d)
        reset = np.full(n, step == 0)
        state_p = plain.ring_push_batched(state_p, f_p, reset)
        state_s = spmd.ring_push_batched(state_s, f_p, reset)
    out_p = plain.ring_detect_batched(state_p, shapes, sfs)
    out_s = spmd.ring_detect_batched(state_s, shapes, sfs)
    (dp, lp, mp), (ds, ls, ms) = out_p, out_s
    if not (torch.equal(mp, ms) and torch.equal(lp[mp], ls[ms])
            and (dp[mp] - ds[ms]).abs().max().item() <= LANES_TOL):
        raise RuntimeError("the replicas' detections differ from the "
                           "unsharded engine's")
    return agree


def hvrnet_spec(seed: int = 0) -> Dict[str, Any]:
    """The dryrun's HVRNet training spec: the tiny HRNMP model (t_dim 9,
    3 frames per video) with its seeded weights, rank r on
    ``tiny_sample(r)``."""
    return dict(model_cfg=tiny_model_cfg("HRNMPBBoxHead", sampler_num=8,
                                         t_dim=9, imgs_per_video=3),
                train_cfg=tiny_train_cfg(),
                cfg=dict(optimizer=dict(lr=1e-3, momentum=0.9,
                                        weight_decay=1e-4)),
                seed=seed, make_sample=tiny_sample,
                sample_args=[(r,) for r in range(64)])


def dryrun_multichip(n_devices: int = 2, timeout: float = 600.0
                     ) -> Dict[str, Any]:
    """The three checks at ``n_devices`` ranks and replicas on the CPU;
    prints one line and returns their numbers."""
    with tempfile.TemporaryDirectory() as work:
        dp = data_parallel_check(hvrnet_spec(), n_devices, work,
                                 timeout=timeout,
                                 threads=torch.get_num_threads())
    loss = dp["ranks"][0]["logs"]["loss"]
    kv_err = kv_sharded_check(n_devices)
    agree = spmd_lanes_check(n_devices)
    print(f"dryrun_multichip({n_devices}) OK — loss {loss:.4f} over "
          f"{n_devices} gloo ranks (parameters equal across ranks, "
          f"{dp['max_rel_err']:.2e} from the one-process mean gradient); "
          f"kv-sharded attention max err {kv_err:.2e}; SPMD lanes: "
          f"{agree:.0%} of the picks agree, the same detections")
    return dict(loss=loss, dp_err=dp["max_rel_err"], kv_err=kv_err,
                lanes_pick_agreement=agree)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
