#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA.  Phases, each printing its own lines; any failure
stops the script with a non-zero exit:

1. Device: name, count, ``nvidia-smi`` name and power limit; TF32 off for
   the plain references.
2. Build: every kernel under ``hvrnet_tpu_torch/csrc/``, one ``nvcc`` per
   source.
3. Kernels against their plain versions at the main path's shapes, with
   times (CUDA events) of the whole call and of each phase, the plain
   version's, one PyTorch library call's, and the bound the card's
   published peaks give; a second call on the same inputs must give the
   same bits.
4. Main path: HVRNet (``configs/faster_rcnn_r101_hrnmp_c5.py``, R101-C5,
   T = 21, key_dim 10, 300 proposals, f32) with seeded random weights
   (frozen-BN statistics calibrated on the first frame) through
   ``SlidingWindowRunner`` over a synthetic 30-frame uint8 video of 600×1000
   content on the 608×1008 canvas.  Every kernel's launch count is zeroed
   just before and read just after.  The output is checked: a 30-class
   result for every frame, finite boxes, and the window head's logits with
   the kernel against the same head with the plain attention.
5. ``[stream]``: the streaming ring at T=21 (speculative, in-step repair,
   forced rollback) and both rings at T=63, with stage times.
6. ``[selsa]``: SELSA (``configs/faster_rcnn_r101_selsa_c5.py``, R101-C5,
   T = 21, key_dim 10, 300 proposals, f32, seeded random weights,
   frozen-BN calibration on the first frame) through the same runner over
   the same video: 2 kernel launches per detection, the window head's
   logits with the kernel against the plain attention, the head and
   decode stages alone.
7. ``[train]``: HVRNet training at the config's full width (27 frames = 9
   videos × 3, 3 chosen videos, 128 RoIs per frame, 608×1008, f32) with
   seeded random weights and frozen-BN calibration on the first batch:
   the kernel under autograd at the training shapes against the plain
   version, then ``train_detector`` for 2 + 5 steps on a synthetic batch
   with a stage split per step, the launch count zeroed before and read
   after, frozen tensors checked bit for bit, and a checkpoint resumed.
8. ``[selsa-train]``: SELSA training at the config's full width (3 frames
   of 600×1000 on 608×1008, 300 RoIs per frame, OHEM 128, f32): the kernel
   under autograd at 900×384 and 300×384, then ``train_detector`` for 2 +
   5 steps with the backbone (from ``layer2``) and the RPN training, a
   stage split, 2 launches per step, frozen tensors bit for bit and every
   trainable one moved.
9. ``[bf16]``: the precision policy HVRNet's benchmark serves in (bf16
   compute, float32 parameters, the bbox head's weights pre-cast): on the
   same seeded, calibrated weights as the f32 phases, the HVRNet streaming
   ring (speculative) and exact ring at T=21, SELSA at T=21, 2 + 3 steps
   of each trainer and one HVRNet step under ``fp16=dict(loss_scale=512.)``.
   Kernel launches per detection and step as in f32; each of the window
   heads' bf16 kernel calls held to its plain version (``bf16_agreement``)
   and their logits to the plain attention's; bf16 raw head outputs
   against f32 on the same fc1, and the streaming ring against the exact
   one, within the JAX package's bf16 budget (|Δcls| ≤ 0.05·max(max|cls|,
   1), |Δreg| ≤ 0.05); frozen tensors bit for bit, trainable ones moved,
   parameters float32.  ``[busy]``: for the f32 and the bf16 HVRNet
   engine, each stage's device time (``torch.profiler``) against its
   CUDA-event span, the card's idle share over it.
10. ``[cli]``: the port's whole-video CLIs from disk.  A synthetic VID
    tree (videos of 40 and 17 frames at 1280×720 and 12 portrait frames at
    540×960, one or two moving boxes of VID classes, a VOC XML per frame;
    binary PPM frames under VID's ``.JPEG`` names, read by ``read_ppm``)
    and the f32 engines' weights saved as ``.pth`` files: ``hnl_test`` at
    T=21 on the exact and the streaming ring, at T=63 streaming over the
    40-frame video, in bf16 at T=21; SELSA's ``test`` with float and with
    uint8 frames; ``vid_eval`` on a results pickle.  Checked: every frame
    a 30-class result with finite boxes, the kernel's launches per
    detection and per replay, an mAP in [0, 1] equal to ``vid_eval``'s, the
    exact-ring CLI against ``SlidingWindowRunner`` over
    ``test_frame_stream`` in this process, and the uint8 SELSA run's engine
    inputs (bitwise) and detections against the float run's.  Printed: the
    host data time per frame by pipeline step, the frame program and
    window step (CUDA events), the CLI's frames/s and the share of its
    wall time the runner waited on the frame stream.
11. ``[train-cli]``: ``tools/train.py`` from disk at full width in f32.
    A synthetic training tree (30 classes × 3 videos × 3 frames at
    1280×720, a portrait 540×960 video, the class lists; 6 distinct PPM
    scenes linked), 6 DET images and a 20-frame val tree; the configs'
    whole training pipeline.  HVRNet (27 frames, 128 RoIs, 608×1008)
    with ``--calibrate-bn --validate`` for 2 epochs of one step, resumed
    from ``latest.pth`` for a third; SELSA on the VID + DET
    concatenation for 2 steps.  Checked: finite losses, 9 and 2 launches
    per step, frozen tensors bitwise and trainable ones moved, the first
    sample the CLI trained on bitwise equal to ``train_batch_iterator``'s
    in this process, the step carried on, the hook's mAP per epoch equal to
    ``hnl_test --eval`` on that epoch's checkpoint.  Printed: each
    training transform's host ms per frame alone, wall and device ms per
    step, the wait for samples and its share of the wall, peak memory.
12. ``[lanes]``: the lockstep multi-stream runner (``test --batched B``).
    The kernel on 4 lanes at (4, 6300, 6300) and (4, 300, 6300), f32 and
    bf16, against its plain version, a 1-lane call bitwise the 2-D call,
    timed beside 4 separate calls, the plain version and SDPA.  A
    landscape PPM tree of 5 videos of 12–30 frames at 1280×720: HVRNet
    f32 and bf16 and SELSA f32 at full width through
    ``BatchedSlidingWindowRunner`` with 4 streams (streams refill, one
    runs dry) and 4 loader threads: every frame emitted once, 4 and 2
    launches per lockstep detection.  Each lane held against the
    sequential runner fed the lanes' own frame caches: every window bit
    for bit a lane's, the head within 1e-4 (f32) or the bf16 budget, the
    detections bitwise; the batched backbone per lane by depth within
    ``LANES_MAP_LIMIT`` of one frame at a time (f32 at every depth, bf16
    to layer2, where its rounding is not yet amplified) and farther from
    every other lane's frame, the post bitwise.  The lockstep step at
    B = 1, 2, 4, 8 on synthetic frames, by stage, with frames/s, peak
    memory and launches; ``[busy]`` of the batched bf16 frame program.
    ``[cli]``: ``test --batched 4 --loader-workers 4 --u8-transfer`` from
    disk equal to ``--batched 4`` with no loader threads, frames/s beside
    the sequential ``hnl_test``; on 4 videos of 32 frames against the
    sequential ``test`` with the same loader threads.
13. ``[aug]``: flip-augmented testing (``test --aug-test``).  The kernel
    on 2 lanes at (2, 6300, 6300) and (2, 300, 6300), f32 and bf16, as
    ``[lanes]`` holds and times it.  For HVRNet f32 and bf16 and SELSA f32
    on one T=21 window of the synthetic video: duplicate augmentations
    (the frame twice, unflipped, from the frame's own maps) hold the
    frame's own proposals and fc1, a window head whose lanes are within
    the head's limits of the one-lane head and, in f32, merged scores and
    boxes within 1e-4 and 0.128 px of the plain decode; the frame and its
    mirror hold the window head with the kernel against the plain
    attention, 4 (HVRNet) or 2 (SELSA) calls of 2 lanes.  Then ``test
    --aug-test`` from disk over the [cli] tree for the three: 4 and 2
    launches per detection, frames/s, frame program and window step,
    peak memory.
14. ``[multipass]``: HVRNet's 3-pass test graph at T=63.  The kernel on 3
    lanes at 6300², the window head of one T=63 window with the kernel
    against the plain attention in f32 and bf16 (NL1 and NL2 one call of 3
    lanes each, NL3 one of 300 × 18900); ``hnl_test --window 63
    --multi-pass 3`` from disk over the [cli] tree's 40-frame video in f32
    and bf16, 3 launches per detection, beside the exact ring's ``hnl_test
    --window 63``; ``--stream --multi-pass 3`` stops the CLI.
15. ``[trace]``: ``test --trace DIR --timing`` over an 8-frame video: the
    printed phase summary lists ``frame_features`` and ``window_detect``,
    and the trace file holds one ``logits_kernel`` and one
    ``output_kernel`` CUDA event per launch the kernel counted.
16. ``[image]``: the single-image API and the still-image Faster R-CNN at
    full width.  ``inference_detector`` on a 1280×720 BGR image with
    HVRNet's and SELSA's seeded, calibrated weights, f32 and bf16: ms per
    image (wall and CUDA events, after a warm-up), 4 and 2 launches per
    image, the result bitwise ``window_detect`` over T=21 copies of the
    canvas's frame caches.  ``FasterRCNN`` from HVRNet's config
    (``BBoxHead``, 31 classes; seeded weights calibrated on the image):
    the API and ``simple_test`` in f32 and bf16 with times and peak
    memory, the bf16 head on the f32 engine's pooled RoIs within the bf16
    budget, ``aug_test`` of two unflipped copies of a 600×1000 image at
    scale factor 1 within 2e-3 of ``simple_test`` and of the image and
    its mirror valid rows; ``FasterRCNNTrainer`` and ``SelsaTrainer``
    with a single sampler through ``train_detector`` for 2 + 2 steps,
    finite losses, frozen tensors bitwise, trainable ones moved.
17. ``[zoo]``: the multi-stage R-CNN zoo at full width on HVRNet's R101-C5
    trunk (``zoo_configs``): Cascade R-CNN (3 ``SharedFCBBoxHead`` stages,
    31 classes, 600×1000 on the 608×1008 canvas) and Mask R-CNN (81
    classes, ``FCNMaskHead``, 800×1333 on 800×1344), seeded weights (the
    heads' ``fc_cls`` / ``fc_reg`` spread so that scores clear 0.05), frozen
    BNs calibrated on the image.  ``simple_test`` in f32 and bf16: ms per
    image (CUDA events), stages, the host paste of the masks, peak memory;
    the card's f32 result against the port's CPU run fed the card's trunk
    maps (picks and labels identical, boxes, scores and mask probabilities
    within the CPU tests' limits); the bf16 heads on the f32 pooled RoIs
    within the bf16 budget; ``TwoStageTrainer`` through ``train_detector``
    for 2 + 2 steps with stage times, frozen tensors bitwise and trainable
    ones moved; no attention launch and no cv2 import on the path.  Hybrid
    Task Cascade R50-FPN (``htc_config``: mmdetection v1.0rc1's
    htc_r50_fpn_1x, the pytorch-style ResNet-50 over 4 stages, FPN, the
    semantic branch, 3 stages with per-stage ``HTCMaskHead``s; 800×1333 on
    800×1344, 1000 proposals, score_thr 0.001) the same way, its stage
    heads drawn for the image (``zoo_scale_heads``): the stages' times
    (backbone + FPN, semantic, proposals, 3 stages, decode, the mask
    RoIs, 3 mask heads), the card's FPN outputs against the CPU's and its
    detections against the CPU run fed the card's FPN maps and semantic
    embedding (HTC's masks at ``ZOO_MASK_TOLS``), bf16 against f32 by
    depth (semantic head, each stage, each mask head), training on an
    image with a stride-8 ``gt_semantic_seg``: the neck, the semantic
    head and ``mask_head.2`` move.
18. ``[dense]``: the single-stage dense detectors at full width
    (``dense_configs``: mmdetection v1.0rc1's RetinaNet, FreeAnchor,
    FCOS and FoveaBox R50-FPN at 800×1333 on 800×1344, SSD300 VGG16 at
    300×300; 81 classes), seeded weights, frozen BNs calibrated on the
    image and the heads' output convs drawn for it
    (``dense_scale_heads``).  ``simple_test`` in f32 (and bf16 for
    RetinaNet and FCOS): ms per image (CUDA events), stages (backbone +
    FPN, head towers, decode + ``nms_pre``, NMS), peak memory; the card's
    f32 result held to the port's CPU run on the card's maps on two
    images (the head's outputs, then the picks with their labels, boxes
    and scores, ``match_picks``); bf16 against f32 by depth; each
    model's trainer through ``train_detector`` for 2 + 2 steps with
    stage times, frozen tensors bitwise and trainable ones moved; no
    attention launch and no cv2 import on the path.
19. ``[deform]``: the deformable half of the dense family at full width
    (``deform_configs``: mmdetection v1.0rc1's GA-RetinaNet and GA-RPN
    R50-caffe-FPN, RepPoints moment R50-FPN and Cascade R-CNN R50-FPN
    with dcn on c3-c5, 800×1333 on 800×1344, 81 classes), seeded weights,
    frozen BNs calibrated on the image, the heads' offset, location, shape
    and output convs (or the dcn offsets and the stage heads) drawn for
    it, so that samples move about 1.5 px and some fall in the border
    rule's (−1, 0) and (H − 1, H).  ``simple_test`` in f32 (and bf16 for
    GA-RetinaNet and RepPoints): ms per image, stages, the deformable
    convs or dcn blocks timed apart, peak memory; the card's f32 result
    held to the port's CPU run on the card's maps on one image (Cascade
    R-CNN: each dcn block on the card's input to it); bf16 against f32 by
    depth; GA-RetinaNet, RepPoints and Cascade R-CNN through
    ``train_detector`` for 2 + 2 steps (``conv2_offset`` and the adaption
    kernels move); ``deform_conv2d`` alone at the models' shapes (f32,
    bf16; FLOPs, bytes, bound) and v2 at R50's stage 4 card against CPU;
    no attention launch and no cv2 import on the path.
20. ``[trunks]``: HVRNet on the ResNeXt-101 64x4d and Res2Net-101-v1b
    26w-4s C5 trunks (``TRUNK_CONFIGS``: the config with its backbone and
    shared head swapped; T=21, 300 proposals, 608×1008, seeded weights
    calibrated on the first frame) over the synthetic video: X101's exact
    and streaming rings in f32 and bf16, Res2Net's exact ring in f32;
    4 launches per exact detection, 2 per streaming one plus 4 per replay;
    the window head with the kernel against the plain attention on the
    trunk's own window (bf16: its kernel calls held to their plain
    version and to the f32 head), streaming against exact as ``[stream]``
    compares them, the card's trunk against the port's CPU run by depth,
    stage times (backbone, shared head, RPN head, window head) and the
    backbone's idle share.
21. ``[plugins]``: the rest of the backbone zoo at full width
    (``plugin_configs``: mmdetection v1.0's Mask R-CNN R50-FPN with the
    context block on c3-c5, Faster R-CNN R50-FPN with generalized
    attention '1111' on c4-c5 run by the multi-stage engine at one stage,
    Cascade R-CNN HRNetV2p-W32 + HRFPN; 800×1333 on 800×1344), seeded
    weights with the plugins made live: ``simple_test`` in f32 and bf16,
    the plugin blocks' time and peak memory, the card against the CPU
    (plugin blocks on their card inputs, HRFPN's outputs, the detections
    on the card's maps), bf16 against f32 by depth; ``roi_pool`` alone at
    HVRNet's shapes (300 RoIs on the 38×63×1024 C4 map) bit for bit the
    CPU's, timed.
22. ``[datasets]``: the still-image data layer on the still-image Faster
    R-CNN R101-C5 (``faster_rcnn_config``, seeded random weights, frozen
    BNs calibrated on the first image).  A COCO-format tree (COCO's 80
    categories under their ids 1-90, 8 images of 360-640 px, landscape and
    portrait, crowd and sub-pixel boxes) and a VOC2007 tree (6 images, an
    object of a class outside VOC's), written at run time as PPM bytes
    under ``.jpg`` names and deleted after; both built by ``build_dataset``
    and iterated by ``build_dataloader`` in test mode through
    ``inference_detector`` at 81 and 21 classes (ms per image, CUDA
    events).  Checked: the annotations equal what was written,
    ``results2json`` maps back to the detections, and the ground truth as
    detections scores 1.0 in ``coco_style_eval``, ``voc_eval`` and
    ``eval_recalls`` (the RPN's 300 proposals at 100 and 300, IoU
    0.5:0.95); then one ``FasterRCNNTrainer`` step (the trainer
    ``train_detector`` picks for this engine) on a
    COCO item through ``Albu`` (mmdet's example block) packed by
    ``collate_train`` (portrait items skipped), finite losses, frozen
    tensors bitwise, trainable ones moved.  Printed: the host's ms per
    item of ``Albu`` and of the whole training pipeline,
    ``PrefetchLoader`` items/s at 1, 2 and 4 workers.  No attention
    launch on the path.
23. ``[multi]``: the multi-device paths on this machine's one card.
    HVRNet training at full width (the [train] phase's calibrated
    weights, 27-frame samples): a data-parallel step at world 1 over NCCL
    (``parallel/mesh.py:init_distributed``; NCCL takes one rank per card,
    so one card shows it at one rank only), held to one process's step,
    and two ranks sharing the card over gloo (spawned processes with a
    timeout), each on its own sample: their parameters equal bit for bit
    and equal within ``dryrun.PARAM_TOL`` to one process that averages
    the two samples' gradients; ms per step and peak memory per rank.
    B = 4 lockstep lanes over two replicas on the card
    (``enable_spmd_lanes``): each replica's backbone by depth within
    ``LANES_MAP_LIMIT`` of the unsharded batched engine's lanes, the post
    bit for bit, the ring's detections against the unsharded ring fed the
    same caches, 4 launches per replica and lockstep detection.  The
    K/V-sharded attention (``masked_attention_kv_sharded``, 2 and 4
    shards side by side on the card) at the T=21 shapes in f32 and bf16
    against ``attention_plain`` and the kernel, timed beside it; one
    HVRNet window detection with ``enable_kv_sharded_attention`` against
    the unsharded engine, launching no kernel.
24. One JSON line of per-kernel numbers (the kernel's f32 and bf16 routes
    as two entries), then the result line.

Every path runs at full width and depth, the SELSA ones included.

Exits non-zero without a result when no CUDA device is present, or when the
``hvrnet_tpu_torch`` package is not beside this file.
"""
from __future__ import annotations

import contextlib
import json
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "faster_rcnn_r101_hrnmp_c5.py"
# HVRNet's C5 trunks beside the config's R101 ([trunks]): mmdetection's
# resnext101_64x4d widths and Res2Net-101-v1b 26w-4s; only the backbone and
# the shared head change
TRUNK_CONFIGS = {
    "X101-64x4d": dict(
        backbone=dict(type="ResNeXt", depth=101, groups=64, base_width=4,
                      num_stages=3, strides=(1, 2, 2), dilations=(1, 1, 1),
                      out_indices=(2,), frozen_stages=1, style="pytorch"),
        shared_head=dict(type="ResXLayer", depth=101, stage=3, stride=1,
                         dilation=2, groups=64, base_width=4,
                         external_conv=True)),
    "Res2Net-101-v1b-26w-4s": dict(
        backbone=dict(type="Res2NetV1b", depth=101, scales=4, base_width=26,
                      num_stages=3, strides=(1, 2, 2), dilations=(1, 1, 1),
                      out_indices=(2,), frozen_stages=1),
        shared_head=dict(type="Res2Layer", depth=101, stage=3, stride=1,
                         dilation=2, scales=4, base_width=26,
                         external_conv=True))}
N_FRAMES = 30
CANVAS = (608, 1008)
CONTENT = (600, 1000)

# published H100 SXM peaks (dense), at the full 700 W power limit
PEAK_F32_FLOPS = 67e12          # CUDA cores, no tensor cores
PEAK_TF32_FLOPS = 495e12        # tensor cores; f32 work as 3xTF32 takes 3×
PEAK_BF16_FLOPS = 989e12        # tensor cores
PEAK_BYTES = 3.35e12            # HBM3
# (nq, nk, label): the exact ring's attention calls per detected frame
ATTN_SHAPES = ((6300, 6300, "NL1/NL3"), (300, 6300, "NL2/NL4"))
# the same calls at the 63-frame cache
ATTN_SHAPES_63 = ((18900, 18900, "NL1/NL3 T=63"), (300, 18900, "NL2/NL4 T=63"))
D = 1024
FLUSH_FORCED = 4      # chunk size of the forced-rollback run
# the HRNMP head's training calls per chosen video: NL1 over its 3 × 128
# RoIs, NL2 and NL3 from its key frame's 128
TRAIN_SHAPES = ((384, 384, "train NL1"), (128, 384, "train NL2/NL3"))
TRAIN_VIDEOS = 9          # the triplet loader's pool: 3 of the key class +
TRAIN_IPV = 3             # 2 other classes × 3, 3 frames each
TRAIN_GT_MAX = 32         # collate_train's ground-truth slots
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
TRAIN_STAGES = ("backbone", "selection", "proposals", "head", "backward",
                "optimizer")
SELSA_CONFIG = ROOT / "configs" / "faster_rcnn_r101_selsa_c5.py"
# SELSA's head calls: at test time NL1 over the window's 21 × 300 rows and
# NL2 from the key frame's 300 (the 6300² and 300×6300 of ATTN_SHAPES); in
# training NL1 over 3 × 300 RoIs against the first 384 (sampler_num 128 ×
# t_dim 3) and NL2 from the key frame's 300
SELSA_TRAIN_SHAPES = ((900, 384, "selsa train NL1"),
                      (300, 384, "selsa train NL2"))
SELSA_TRAIN_STAGES = ("backbone", "rpn", "proposals", "head", "backward",
                      "optimizer")
BF16_TIMED = 3            # timed bf16 training steps (after TRAIN_WARMUP)
# the JAX package's bf16 budget for raw head outputs against f32
# (tests/test_bf16_budget.py:test_hvrnet_bf16_budget_random)
BF16_CLS_BUDGET, BF16_REG_BUDGET = 0.05, 0.05


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, iters=5, warmup=2):
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class PhaseTimer:
    """CUDA-event spans around the runner's stages."""

    def __init__(self, torch):
        self.torch = torch
        self.spans = {}

    @contextlib.contextmanager
    def phase(self, name):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        yield
        ev[1].record()
        self.spans.setdefault(name, []).append(ev)

    def mean_ms(self, name):
        self.torch.cuda.synchronize()
        spans = self.spans[name]
        return sum(a.elapsed_time(b) for a, b in spans) / len(spans)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; device count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    global CARD
    CARD = smi
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")
    # for the plain references the kernels are held against (the engine
    # turns TF32 off for its own work)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmuls and convolutions")
    return name


def phase_build():
    from hvrnet_tpu_torch.ops import kernel_build as kb
    version = subprocess.run([kb.nvcc_path(), "--version"],
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout
    log(f"[build] {version.strip().splitlines()[-1]}")
    t0 = time.time()
    for name in kb.SOURCES:
        report = kb.build(name)
        log(f"[build] {name}: {kb.library_path(name).relative_to(ROOT)}")
        kernel = "?"
        for line in report.splitlines():
            if "Compiling entry function" in line:
                kernel = demangle(line.split("'")[1])
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line or "warning" in line):
                log(f"[build]   {kernel}: {line.strip()}")
    log(f"[build] {len(kb.SOURCES)} kernel source(s) in "
        f"{time.time() - t0:.1f} s")


def demangle(symbol):
    """A kernel's name from its mangled symbol (c++filt where present)."""
    try:
        name = subprocess.run(["c++filt", symbol], capture_output=True,
                              text=True, timeout=10).stdout.strip()
    except OSError:
        return symbol
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0] or symbol


def attention_bound_ms(nq, nk, dtype_bytes, peak_flops, products=1):
    """Least time for one call: the larger of its FLOPs (``products`` times
    4·nq·nk·d: 3 for f32 as 3xTF32 on the tensor cores) over the peak rate
    and its bytes (q, k, v, bias read once, f32 output written once) over
    the memory rate."""
    flops = products * 4.0 * nq * nk * D
    nbytes = (nq + 2 * nk) * D * dtype_bytes + 4 * nk + 4 * nq * D
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_attention(torch):
    """The kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F
    from hvrnet_tpu_torch.ops.attention import (NEG_INF, attention_plain,
                                                bf16_agreement,
                                                masked_attention, plan)
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = D ** -0.5
    cases = []
    for nq, nk, label in (ATTN_SHAPES + ATTN_SHAPES_63
                          + ((300, 6299, "ragged nk"),)):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(n, D, device="cuda", generator=gen).to(dt)
                       for n in (nq, nk, nk))
            live = torch.rand(nk, device="cuda", generator=gen) >= 0.1
            for masking in ("10% masked", "all masked"):
                if masking == "all masked":
                    if label != "NL2/NL4":
                        continue
                    live = torch.zeros_like(live)
                bias = torch.where(live, 0.0, NEG_INF).float()
                got = masked_attention(q, k, v, bias, scale)
                case = dict(label=label, nq=nq, nk=nk,
                            dtype=str(dt).replace("torch.", ""),
                            masking=masking)
                if dt == torch.float32:
                    want = attention_plain(q, k, v, bias, scale)
                    err = (got - want).abs().max().item()
                    rel = err / want.abs().max().item()
                    case.update(max_abs_err=err, tol=1e-4, rel_err=rel,
                                rel_tol=1e-5)
                    ok = err <= 1e-4 and rel <= 1e-5
                    del want
                else:
                    # limits from rounding the softmax weights to bf16 (see
                    # bf16_agreement): elementwise, rms, and proof that the
                    # kernel rounds at all
                    case.update(bf16_agreement(got, q, k, v, bias, scale))
                    ok = (case["worst"] <= 1 and case["rms"] <= 1
                          and (masking == "all masked"
                               or case["rounds"] >= 0.1))
                ok = ok and bool(torch.isfinite(got).all())
                # no atomics: a second call gives the same bits
                case["bitwise_repeat"] = bool(torch.equal(
                    got, masked_attention(q, k, v, bias, scale)))
                ok = ok and case["bitwise_repeat"]
                if masking == "10% masked" and label != "ragged nk":
                    case.update(attention_times(
                        torch, F, plan, attention_plain, masked_attention,
                        q, k, v, bias, scale))
                log("[attention] " + json.dumps(case))
                if not ok:
                    raise RuntimeError(f"masked_attention kernel disagrees "
                                       f"with its plain version: {case}")
                cases.append(case)
                del got
            del q, k, v
    torch.cuda.empty_cache()
    return cases


def attention_times(torch, F, plan, attention_plain, masked_attention,
                    q, k, v, bias, scale):
    """The call's time, each phase's, the plain version's and the library
    call's; the bound at the tensor-core rate of the call's precision (and,
    for f32, at the CUDA cores' rate), the achieved rate of the function's
    4·nq·nk·d FLOPs and the share of the bound reached."""
    nq, nk = q.shape[0], k.shape[0]
    f32 = q.dtype == torch.float32
    t = dict(ms=cuda_ms(torch, lambda: masked_attention(
        q, k, v, bias, scale)))
    call = plan(q, k, v, bias, scale)
    call.run()
    t["phases_ms"] = {name: cuda_ms(torch, fn) for name, fn in call.phases}
    t["nsplit"] = call.nsplit
    del call
    t["plain_ms"] = cuda_ms(torch, lambda: attention_plain(
        q, k, v, bias, scale))
    mask4 = bias[None, None, None, :].to(q.dtype)
    t["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q[None, None], k[None, None], v[None, None], attn_mask=mask4,
        scale=scale))
    if f32:
        t["bound_ms"], t["bound_by"] = attention_bound_ms(
            nq, nk, 4, PEAK_TF32_FLOPS, products=3)
        t["bound_rate"] = "3xTF32: 3 x 4*nq*nk*d at 495 TFLOP/s (tf32)"
        t["cuda_core_bound_ms"], _ = attention_bound_ms(nq, nk, 4,
                                                        PEAK_F32_FLOPS)
    else:
        t["bound_ms"], t["bound_by"] = attention_bound_ms(
            nq, nk, 2, PEAK_BF16_FLOPS)
        t["bound_rate"] = "4*nq*nk*d at 989 TFLOP/s (bf16)"
    t["tflops"] = 4.0 * nq * nk * D / (t["ms"] * 1e-3) / 1e12
    t["bound_fraction"] = t["bound_ms"] / t["ms"]
    return t


def synthetic_video(np, n, seed=0):
    """Frame dicts as engine/stream.py yields them: a smooth random scene
    panning across 600×1000 content, uint8, zero-padded to the canvas."""
    rng = np.random.default_rng(seed)
    scene = rng.integers(0, 256, size=(48, 80, 3), dtype=np.uint8)
    scene = np.repeat(np.repeat(scene, 16, axis=0), 16, axis=1)
    for i in range(n):
        img = np.zeros((1,) + CANVAS + (3,), np.uint8)
        y, x = 2 * i, 5 * i % 281      # in the scene for up to 84 frames
        img[0, :CONTENT[0], :CONTENT[1]] = \
            scene[y:y + CONTENT[0], x:x + CONTENT[1]]
        yield dict(img=img,
                   img_shape=np.array(CONTENT, np.float32),
                   pad_shape=np.array(CANVAS, np.float32),
                   scale_factor=np.full(4, 1.6, np.float32),
                   key_frame_flag=0 if i == 0 else (1 if i == n - 1 else 2),
                   frame_offset=i, seg_len=n, frame_start_id=1)


def warm_up(torch, np, engine):
    """One window of frames through the frame program and a detection on
    each of the engine's rings, so first-use costs (cuBLAS and cuDNN
    handles and plans for the engine's dtype) stay out of the timed
    runs."""
    frames = list(synthetic_video(np, engine.window, seed=3))
    feats = [engine.frame_features(f["img"], f["img_shape"], f["pad_shape"])
             for f in frames]
    saved = engine.stream
    for stream in ((False, True) if hasattr(engine, "stream_rebuild")
                   else (False,)):
        engine.stream = stream
        ring = engine.ring_reset(int(feats[0]["fc1"].shape[-1]))
        for f in feats[:-1]:
            engine.ring_push(ring, f)
        engine.ring_step(ring, feats[-1], frames[-1]["img_shape"],
                         frames[-1]["scale_factor"])
    engine.stream = saved
    torch.cuda.synchronize()


def run_video(torch, np, engine, tag, **runner_kw):
    """The synthetic video through ``SlidingWindowRunner`` with the
    kernel's launch count set to 0 just before and read just after; checks
    one detection and a 30-class result with finite boxes per frame."""
    from hvrnet_tpu_torch.engine import SlidingWindowRunner
    from hvrnet_tpu_torch.ops.attention import masked_attention
    timer = PhaseTimer(torch)
    detections = []
    runner = SlidingWindowRunner(engine, branch=-1, timer=timer,
                                 progress_hook=detections.append,
                                 **runner_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    masked_attention.launches = 0
    t0 = time.time()
    results = runner.run(synthetic_video(np, N_FRAMES), N_FRAMES)
    torch.cuda.synchronize()
    wall = time.time() - t0
    run = dict(results=results, launches=masked_attention.launches,
               detections=sum(detections), replayed=runner.replayed,
               rebuilds=runner.rebuilds, wall_s=wall,
               frame_ms=timer.mean_ms("frame_features"),
               step_ms=timer.mean_ms("window_detect"),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if run["detections"] != N_FRAMES:
        raise RuntimeError(f"{tag} {run['detections']} detections for "
                           f"{N_FRAMES} frames")
    n_boxes = 0
    for i, res in enumerate(results):
        if res is None or len(res) != engine.num_classes - 1:
            raise RuntimeError(f"{tag} frame {i} has no 30-class result")
        for dets in res:
            if dets.shape[1:] != (5,) or not np.isfinite(dets).all():
                raise RuntimeError(f"{tag} frame {i}: bad detections "
                                   f"{dets.shape}")
            n_boxes += len(dets)
    log(f"{tag} {N_FRAMES} frames, {run['detections']} detections, "
        f"{n_boxes} boxes, every frame a 30-class result; kernel launches "
        f"{run['launches']}; replayed detections {run['replayed']}, "
        f"rebuilds {run['rebuilds']}")
    log(f"{tag} frame_features {run['frame_ms']:.3f} ms/frame, window step "
        f"{run['step_ms']:.3f} ms/detection (CUDA events); peak device "
        f"memory {run['peak_gib']:.2f} GiB; {N_FRAMES / wall:.2f} frames/s "
        f"over the whole video (a smoke figure)")
    return run


def build_engine(torch, np, window=None, stream_theta=None, weights=None,
                 dtype=None, trunk=None):
    """HNMBRCNN from the shipped config, with ``trunk``'s backbone and
    shared head (``TRUNK_CONFIGS``) where given, optionally at another window
    (frame_interval, t_dim and key_dim set together, as the 63-frame
    cache sets them) or with a head ``stream_theta``; ``weights`` is a
    state_dict to load, else seeded random weights with frozen-BN
    statistics calibrated on the first frame.  ``dtype`` bfloat16: the
    bf16 policy, with the bbox head's weights pre-cast after the load."""
    from hvrnet_tpu_torch.engine import HNMBRCNN
    from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
    from hvrnet_tpu_torch.utils.config import Config, unwrap
    cfg = Config.fromfile(str(CONFIG))
    model_cfg, test_cfg = unwrap(cfg.model), unwrap(cfg.test_cfg)
    if window:
        test_cfg["relation_setup"]["frame_interval"] = (window - 1) // 2
        test_cfg["bbox_head"].update(t_dim=window, key_dim=(window - 1) // 2)
    if stream_theta is not None:
        model_cfg["bbox_head"]["stream_theta"] = stream_theta
    if trunk:
        model_cfg.update(TRUNK_CONFIGS[trunk])
    t0 = time.time()
    engine = HNMBRCNN(model_cfg, test_cfg, device="cuda", seed=0,
                      dtype=dtype or torch.float32)
    if weights is None:
        n_bn = calibrate_frozen_bn(engine, [next(synthetic_video(np, 1))])
        how = f"seeded random weights, {n_bn} frozen BNs calibrated"
    else:
        engine.load_state_dict(weights)
        how = "the T=21 engine's weights"
    engine.cast_head_params_bf16()
    torch.cuda.synchronize()
    bh = engine.model_cfg["bbox_head"]
    log(f"[build] HNMBRCNN {trunk or 'R101'}-C5 {str(engine.dtype)[6:]} in "
        f"{time.time() - t0:.1f} s ({how}): "
        f"window {engine.window}, t_dim {bh['t_dim']}, key_dim "
        f"{engine.key_dim}, {engine.proposal_num} proposals/frame, "
        f"stream_theta {engine.model.bbox_head.stream_theta}")
    return engine


def logit_err(got, want):
    """max |Δ|/max(|ref|, 1) over the head's (cls list, reg list)."""
    worst = 0.0
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        scale = max(b.abs().max().item(), 1.0)
        worst = max(worst, (a - b).abs().max().item() / scale)
    return worst


def head_outputs(out):
    """A window head's output as ([cls per branch], [reg per branch]):
    HRNMP's two branches, SELSA's one."""
    cls, reg = out
    if isinstance(cls, (list, tuple)):
        return list(cls), list(reg)
    return [cls], [reg]


def head_budget(got, want):
    """(max |Δcls|/max(max|cls|, 1), max |Δreg|) over the branches, the two
    quantities of the JAX package's bf16 budget."""
    got, want = head_outputs(got), head_outputs(want)
    cls = max((a.float() - b.float()).abs().max().item()
              / max(b.float().abs().max().item(), 1.0)
              for a, b in zip(got[0], want[0]))
    reg = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got[1], want[1]))
    return cls, reg


def phase_main_path(torch, np):
    engine = build_engine(torch, np)
    warm_up(torch, np, engine)
    run = run_video(torch, np, engine, "[main]")
    if run["launches"] != 4 * run["detections"]:
        raise RuntimeError("the main path did not run the attention kernel "
                           "4 times per detection")
    stage_times(torch, np, engine, *window_head_check(torch, np, engine,
                                                      "[main]"))
    return engine, run


def window_head_check(torch, np, engine, tag):
    """The window head on the last full window of the synthetic video with
    the kernel and with the plain attention (these launches are not part
    of any run's count): logits within 1e-4.  Returns the window's frame
    caches, fc1 rows, masks and the head's output."""
    from hvrnet_tpu_torch.models.bbox_heads import selsa_bbox_head
    from hvrnet_tpu_torch.ops.attention import (attention_plain,
                                                masked_attention)
    feats = [engine.frame_features(f["img"], f["img_shape"], f["pad_shape"])
             for f in synthetic_video(np, engine.window, seed=1)]
    fc1 = torch.cat([f["fc1"] for f in feats])
    valid = torch.cat([f["mask"] for f in feats])
    kd, P = engine.key_dim, engine.proposal_num
    head = engine.model.bbox_head
    with torch.no_grad():
        got = head.forward_fc1(fc1, kd * P, P, valid)
        selsa_bbox_head.masked_attention = attention_plain
        try:
            want = head.forward_fc1(fc1, kd * P, P, valid)
        finally:
            selsa_bbox_head.masked_attention = masked_attention
    worst = logit_err(got, want)
    log(f"{tag} window head logits, kernel vs plain attention: max "
        f"|Δ|/max(|ref|, 1) = {worst:.3g}")
    if not worst <= 1e-4:
        raise RuntimeError(f"{tag} window head with the kernel disagrees "
                           "with the plain attention")
    return feats, fc1, valid, got


def final_window_check(torch, np, engine):
    """Push T + 9 frames into a fresh streaming ring (speculative, rebuilt
    if flagged) and hold ``stream_forward``'s branch and final logits at
    the centre against ``forward_fc1`` on the last T frames' rows, oldest
    first with the centre at key_dim.  Returns the ring, the last frame's
    caches and the window's (fc1, mask) rows, for the stage times."""
    from hvrnet_tpu_torch.engine.detector import f32_precision
    T, P, kd = engine.window, engine.proposal_num, engine.key_dim
    feats = [engine.frame_features(f["img"], f["img_shape"], f["pad_shape"])
             for f in synthetic_video(np, T + 9, seed=1)]
    engine.stream_rollback = True
    ring = engine.ring_reset(int(feats[0]["fc1"].shape[-1]))
    for f in feats:
        engine.ring_push(ring, f)
    flagged = bool(ring["flag"])
    if flagged:
        engine.stream_rebuild(ring)
    head = engine.model.bbox_head
    centre = (ring["pos"] + 1 + kd) % T
    rows = (torch.cat([f["fc1"] for f in feats[-T:]]),
            torch.cat([f["mask"] for f in feats[-T:]]))
    with torch.no_grad(), f32_precision():
        cls, reg, bad = head.stream_forward(engine.head_state(ring), centre,
                                            rollback=True)
        want = head.forward_fc1(rows[0], kd * P, P, rows[1])
    if engine.dtype == torch.bfloat16:
        cls_d, reg_d = head_budget((cls, reg), want)
        log(f"[bf16] T={T} final window after {len(feats)} pushes (flag "
            f"{flagged}, decode flag {bool(bad)}): stream_forward vs "
            f"forward_fc1 in bf16, max |Δcls|/max(|cls|, 1) = {cls_d:.3g}, "
            f"max |Δreg| = {reg_d:.3g} (limits {BF16_CLS_BUDGET}, "
            f"{BF16_REG_BUDGET}: the bf16 budget)")
        if not (cls_d <= BF16_CLS_BUDGET and reg_d <= BF16_REG_BUDGET):
            raise RuntimeError(f"bf16 streaming ring at T={T} disagrees "
                               "with the exact head")
        return ring, feats[-1], rows
    worst = logit_err((cls, reg), want)
    log(f"[stream] T={T} final window after {len(feats)} pushes (flag "
        f"{flagged}, decode flag {bool(bad)}): stream_forward vs forward_fc1 "
        f"branch and final logits, max |Δ|/max(|ref|, 1) = {worst:.3g} "
        f"(limit 1e-3)")
    if not worst <= 1e-3:
        raise RuntimeError(f"streaming ring at T={T} disagrees with the "
                           "exact head")
    return ring, feats[-1], rows


def compare_results(a_results, b_results):
    """(max |Δ| over every frame's detections as emitted, bitwise equal,
    per-class lists that differ by more than 1e-3 once each list's rows are
    sorted, per-class lists); raises when a frame's per-class detection
    counts differ."""
    import numpy as np
    worst, same, differ, lists = 0.0, True, 0, 0
    for i, (fa, fb) in enumerate(zip(a_results, b_results)):
        for ca, cb in zip(fa, fb):
            if ca.shape != cb.shape:
                raise RuntimeError(f"frame {i}: {cb.shape} detections "
                                   f"against {ca.shape}")
            lists += 1
            if len(ca):
                worst = max(worst, float(abs(ca - cb).max()))
                sa, sb = (c[np.lexsort(c.T[::-1])] for c in (ca, cb))
                differ += bool(abs(sa - sb).max() > 1e-3)
            same = same and ca.tobytes() == cb.tobytes()
    return worst, same, differ, lists


def log_agreement(tag, exact, stream):
    """Detections of the streaming ring against the exact ring's, printed
    (no limit: near-tied scores of random weights may swap rows or flip a
    class-wise NMS pick; the limit is on the logits)."""
    err, same, differ, lists = compare_results(exact["results"],
                                               stream["results"])
    log(f"{tag} detections streaming vs exact: max |Δ| as emitted "
        f"{err:.3g}, bitwise equal {same}; {differ} of {lists} per-class "
        f"lists differ by more than 1e-3 once their rows are sorted")


def phase_stream(torch, np, engine, exact):
    """The streaming ring at T=21, speculative and with the in-step repair,
    then the forced rollback; returns the three runs."""
    engine.stream = True
    run = run_video(torch, np, engine, "[stream] T=21")
    want = 2 * run["detections"] + 4 * run["replayed"]
    if run["launches"] != want:
        raise RuntimeError(f"streaming ring launched the kernel "
                           f"{run['launches']} times, not {want}")
    log(f"[stream] T=21 window step {run['step_ms']:.3f} ms/detection "
        f"streaming against {exact['step_ms']:.3f} exact")
    log_agreement("[stream] T=21", exact, run)
    crun = run_video(torch, np, engine, "[stream] T=21 in-step repair",
                     speculative_stream=False)
    if crun["launches"] != 2 * crun["detections"]:
        raise RuntimeError(f"in-step repair launched the kernel "
                           f"{crun['launches']} times, not 2 per detection")
    log_agreement("[stream] T=21 in-step repair", exact, crun)
    stream_stages(torch, engine, *final_window_check(torch, np, engine))

    forced = build_engine(torch, np, stream_theta=-1.0,
                          weights=engine.model.state_dict())
    forced.stream = True
    frun = run_video(torch, np, forced, "[stream] forced rollback",
                     flush_every=FLUSH_FORCED)
    chunks = -(-frun["detections"] // FLUSH_FORCED)
    if (frun["replayed"], frun["rebuilds"]) != (frun["detections"], chunks):
        raise RuntimeError(f"forced rollback replayed {frun['replayed']} "
                           f"detections in {frun['rebuilds']} rebuilds, not "
                           f"{frun['detections']} in {chunks}")
    if frun["launches"] != 6 * frun["detections"]:
        raise RuntimeError(f"forced rollback launched the kernel "
                           f"{frun['launches']} times, not 2 + 4 per "
                           "detection")
    err, same, _, _ = compare_results(exact["results"], frun["results"])
    log(f"[stream] forced rollback: every one of {chunks} chunks replayed "
        f"and rebuilt; detections against the exact ring max |Δ| = "
        f"{err:.3g} (limit 1e-5), bitwise equal: {same}")
    if not err <= 1e-5:
        raise RuntimeError("replayed detections differ from the exact ring")
    del forced
    torch.cuda.empty_cache()
    return run, crun, frun


def phase_63(torch, np, engine):
    """Both rings at the 63-frame cache on the same weights."""
    eng = build_engine(torch, np, window=63,
                       weights=engine.model.state_dict())
    exact = run_video(torch, np, eng, "[stream] T=63 exact ring")
    if exact["launches"] != 4 * exact["detections"]:
        raise RuntimeError("the T=63 exact ring did not run the kernel 4 "
                           "times per detection")
    eng.stream = True
    stream = run_video(torch, np, eng, "[stream] T=63 streaming ring")
    want = 2 * stream["detections"] + 4 * stream["replayed"]
    if stream["launches"] != want:
        raise RuntimeError(f"T=63 streaming ring launched the kernel "
                           f"{stream['launches']} times, not {want}")
    log(f"[stream] T=63 window step {stream['step_ms']:.3f} ms/detection "
        f"streaming against {exact['step_ms']:.3f} exact")
    log_agreement("[stream] T=63", exact, stream)
    stream_stages(torch, eng, *final_window_check(torch, np, eng))
    del eng
    torch.cuda.empty_cache()
    return exact, stream


def stream_stages(torch, engine, ring, feats, rows):
    """The streaming ring's stages alone on ``ring`` (CUDA events, 5 calls
    after 2): the slide, the decode and the rebuild of the head, the exact
    head on the same window's ``rows`` for comparison, then the whole step
    speculative and with the in-step repair (its two host reads)."""
    import numpy as np
    from hvrnet_tpu_torch.engine.detector import f32_precision
    T = engine.window
    head = engine.model.bbox_head
    hst = engine.head_state(ring)
    centre = (ring["pos"] + 1 + engine.key_dim) % T
    ish, sf = np.array(CONTENT, np.float32), np.full(4, 1.6, np.float32)

    def step(rollback):
        engine.stream_rollback = rollback
        engine.ring_step(ring, feats, ish, sf, branch=-1)

    head_stages = {
        "stream_update (speculative)": lambda: head.stream_update(
            hst, feats["fc1"], feats["mask"], 0, rollback=True),
        "stream_forward (speculative)": lambda: head.stream_forward(
            hst, centre, rollback=True),
        "stream_rebuild": lambda: head.stream_rebuild(hst),
        "exact head forward_fc1, same window": lambda: head.forward_fc1(
            rows[0], engine.key_dim * engine.proposal_num,
            engine.proposal_num, rows[1]),
    }
    step_stages = {
        "ring_step speculative": lambda: step(True),
        "ring_step with in-step repair (2 host reads)": lambda: step(False),
    }
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), f32_precision():
        for name, fn in head_stages.items():
            log(f"[stream] T={T} stage {name}: "
                f"{cuda_ms(torch, fn):.3f} ms")
    # the head stages rewrote slot 0's caches under the ring's accumulators
    engine.stream_rebuild(ring)
    for name, fn in step_stages.items():
        log(f"[stream] T={T} stage {name}: {cuda_ms(torch, fn):.3f} ms")
    log(f"[stream] T={T} peak device memory over the stages "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def stage_times(torch, np, engine, feats, fc1, valid, head_out):
    """Where the time goes: each stage of one frame and one window alone,
    CUDA events around a few repeats (after the counts were read)."""
    from hvrnet_tpu_torch.engine.detector import _rpn_proposals
    from hvrnet_tpu_torch.models.bbox_heads.bbox_head import get_det_bboxes
    frame = next(synthetic_video(np, 1, seed=2))
    img, ish, psh = frame["img"], frame["img_shape"], frame["pad_shape"]
    kd, P = engine.key_dim, engine.proposal_num
    maps = engine.backbone_maps(img, ish)
    canvas = engine._canvas(*CANVAS)
    head = engine.model.bbox_head
    rcnn = engine.test_cfg["rcnn"]
    stages = {
        "backbone: C4, C5, RPN maps": lambda: engine.backbone_maps(img, ish),
        "proposals: top-6000, decode, NMS": lambda: _rpn_proposals(
            maps[1][0], maps[2][0], canvas, psh, ish, engine.test_cfg["rpn"],
            engine.rpn_means, engine.rpn_stds),
        "frame post: proposals, RoIAlign, fc_new_1": lambda: engine.frame_post(
            *maps, ish, psh),
        "window head: NL1-NL4 and fcs": lambda: head.forward_fc1(
            fc1, kd * P, P, valid),
        "decode + class-wise NMS": lambda: get_det_bboxes(
            feats[kd]["boxes"], head_out[0][-1], head_out[1][-1], ish,
            frame["scale_factor"], engine.target_means, engine.target_stds,
            rescale=True, cfg=rcnn, valid=feats[kd]["mask"]),
    }
    with torch.no_grad():
        for name, fn in stages.items():
            log(f"[stages] {name}: {cuda_ms(torch, fn, iters=3, warmup=1):.3f} ms")


def train_attention(torch, shapes=TRAIN_SHAPES, tag="[train]", dtype=None):
    """The kernel under autograd at the training ``shapes`` with 10 % of
    the keys masked, then its times.  f32: its forward (and
    ``attention_backward_plain``) against the plain version differentiated
    by autograd.  bf16: its forward against the plain version by
    ``bf16_agreement``, its gradients against autograd of the unrounded
    attention in float64: within u = 2^-8 of max |grad| (the f32 recompute
    rounded once to bf16, u/2, and f32 slack)."""
    import torch.nn.functional as F
    from hvrnet_tpu_torch.ops.attention import (NEG_INF, attention_plain,
                                                bf16_agreement,
                                                masked_attention, plan)
    if dtype == torch.bfloat16:
        return [bf16_train_attention(torch, F, plan, attention_plain,
                                     bf16_agreement, masked_attention,
                                     NEG_INF, nq, nk, label, tag)
                for nq, nk, label in shapes]
    gen = torch.Generator(device="cuda").manual_seed(1)
    scale = D ** -0.5
    cases = []
    for nq, nk, label in shapes:
        q, k, v = (torch.randn(n, D, device="cuda", generator=gen)
                   for n in (nq, nk, nk))
        bias = torch.where(torch.rand(nk, device="cuda", generator=gen)
                           >= 0.1, 0.0, NEG_INF).float()
        g = torch.randn(nq, D, device="cuda", generator=gen)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        got = masked_attention(*ins, bias, scale)
        got.backward(g)
        want = attention_plain(*ref, bias, scale)
        want.backward(g)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        grad_rel = max(((a.grad - b.grad).abs().max()
                        / b.grad.abs().max()).item()
                       for a, b in zip(ins, ref))
        case = dict(label=label, nq=nq, nk=nk, dtype="float32",
                    masking="10% masked", max_abs_err=err, rel_err=rel,
                    rel_tol=1e-5, grad_rel_err=grad_rel, grad_rel_tol=1e-4,
                    bitwise_repeat=bool(torch.equal(
                        got, masked_attention(q, k, v, bias, scale))))
        case.update(attention_times(torch, F, plan, attention_plain,
                                    masked_attention, q, k, v, bias, scale))
        log(f"{tag} attention " + json.dumps(case))
        if not (rel <= 1e-5 and grad_rel <= 1e-4 and case["bitwise_repeat"]
                and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"masked_attention under autograd disagrees "
                               f"with the plain version: {case}")
        cases.append(case)
    return cases


def bf16_train_attention(torch, F, plan, attention_plain, bf16_agreement,
                         masked_attention, neg_inf, nq, nk, label, tag):
    """One bf16 training shape under autograd (``train_attention``)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    scale = D ** -0.5
    q, k, v = (torch.randn(n, D, device="cuda", generator=gen).bfloat16()
               for n in (nq, nk, nk))
    bias = torch.where(torch.rand(nk, device="cuda", generator=gen) >= 0.1,
                       0.0, neg_inf).float()
    g = torch.randn(nq, D, device="cuda", generator=gen)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = masked_attention(*ins, bias, scale)
    got.backward(g)
    ref = [t.double().requires_grad_() for t in (q, k, v)]
    attention_plain(*ref, bias.double(), scale).backward(g.double())
    grad_rel = max(((a.grad.double() - b.grad).abs().max()
                    / b.grad.abs().max()).item() for a, b in zip(ins, ref))
    case = dict(label=label, nq=nq, nk=nk, dtype="bfloat16",
                masking="10% masked", grad_rel_err=grad_rel,
                grad_rel_tol=2.0 ** -8,
                grad_dtypes=[str(t.grad.dtype)[6:] for t in ins],
                bitwise_repeat=bool(torch.equal(
                    got, masked_attention(q, k, v, bias, scale))))
    case.update(bf16_agreement(got.detach(), q, k, v, bias, scale))
    case.update(attention_times(torch, F, plan, attention_plain,
                                masked_attention, q, k, v, bias, scale))
    log(f"{tag} attention " + json.dumps(case))
    if not (case["worst"] <= 1 and case["rms"] <= 1
            and case["rounds"] >= 0.1 and grad_rel <= 2.0 ** -8
            and all(t.grad.dtype == torch.bfloat16 for t in ins)
            and case["bitwise_repeat"] and bool(torch.isfinite(got).all())):
        raise RuntimeError(f"bf16 masked_attention under autograd disagrees "
                           f"with the plain version: {case}")
    return case


def synthetic_train_batch(np, seed=0, videos=TRAIN_VIDEOS):
    """A ``collate_train`` batch as the triplet loader lays it out: 27
    frames, 9 videos × 3, of 600×1000 smooth random content panning on the
    608×1008 canvas, normalised float32 NHWC; 1-4 ground-truth boxes per
    video drifting across its frames; videos 0-2 of one class, 3-5 and 6-8
    of two others.  ``videos=1``: SELSA's 3 frames of one video."""
    rng = np.random.default_rng(seed)
    F = videos * TRAIN_IPV
    mean = np.array([103.06, 115.90, 123.15], np.float32)
    imgs = np.zeros((F,) + CANVAS + (3,), np.float32)
    gt_bboxes = np.zeros((F, TRAIN_GT_MAX, 4), np.float32)
    gt_labels = np.zeros((F, TRAIN_GT_MAX), np.int64)
    gt_mask = np.zeros((F, TRAIN_GT_MAX), bool)
    classes = rng.choice(np.arange(1, 31), 3, replace=False)
    for v in range(videos):
        scene = rng.integers(0, 256, size=(48, 80, 3), dtype=np.uint8)
        scene = np.repeat(np.repeat(scene, 16, axis=0), 16, axis=1)
        n = int(rng.integers(1, 5))
        hw = np.array(CONTENT[::-1], np.float64)          # (w, h)
        xy = rng.uniform(0, 0.66 * hw, (n, 2))
        wh = rng.uniform(0.08 * hw, 0.3 * hw, (n, 2))
        for i in range(TRAIN_IPV):
            f = v * TRAIN_IPV + i
            y, x = 4 * i, 7 * i
            imgs[f, :CONTENT[0], :CONTENT[1]] = (
                scene[y:y + CONTENT[0], x:x + CONTENT[1]] - mean)
            shift = 6.0 * i
            gt_bboxes[f, :n] = np.concatenate([xy + shift, xy + wh + shift],
                                              1)
            gt_labels[f, :n] = classes[min(v // 3, 2)]
            gt_mask[f, :n] = True
    return dict(imgs=imgs, gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                gt_mask=gt_mask,
                img_shape=np.tile(np.array(CONTENT, np.float32), (F, 1)),
                pad_shape=np.tile(np.array(CANVAS, np.float32), (F, 1)))


class StepTimer(PhaseTimer):
    """PhaseTimer that also reads each training step's peak device memory
    (the allocator's host-side count: no synchronisation), from the first
    of a step's ``stages`` to the end of its last."""

    def __init__(self, torch, stages):
        super().__init__(torch)
        self.stages = stages
        self.peaks = []

    @contextlib.contextmanager
    def phase(self, name):
        if name == self.stages[0]:
            self.torch.cuda.reset_peak_memory_stats()
        with super().phase(name):
            yield
        if name == self.stages[-1]:
            self.peaks.append(self.torch.cuda.max_memory_allocated() / 2**30)


def phase_selsa(torch, np):
    """SELSA (``configs/faster_rcnn_r101_selsa_c5.py``: R101-C5, T = 21,
    key_dim 10, 300 proposals, f32) with seeded random weights and
    frozen-BN statistics calibrated on the first frame, through
    ``SlidingWindowRunner`` over the synthetic video: 2 kernel launches
    per detection (NL1 6300², NL2 300×6300), the window head's logits with
    the kernel against the same head with the plain attention, and the
    head and decode stages alone.  Returns the run and the engine."""
    from hvrnet_tpu_torch.engine import SelsaRCNN
    from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
    from hvrnet_tpu_torch.models.bbox_heads import selsa_bbox_head
    from hvrnet_tpu_torch.models.bbox_heads.bbox_head import get_det_bboxes
    from hvrnet_tpu_torch.ops.attention import (attention_plain,
                                                masked_attention)
    from hvrnet_tpu_torch.utils.config import Config, unwrap
    cfg = Config.fromfile(str(SELSA_CONFIG))
    t0 = time.time()
    engine = SelsaRCNN(unwrap(cfg.model), unwrap(cfg.test_cfg),
                       device="cuda", seed=0)
    n_bn = calibrate_frozen_bn(engine, [next(synthetic_video(np, 1))])
    torch.cuda.synchronize()
    bh = engine.model_cfg["bbox_head"]
    log(f"[build] SelsaRCNN R101-C5 in {time.time() - t0:.1f} s (seeded "
        f"random weights, {n_bn} frozen BNs calibrated): window "
        f"{engine.window}, t_dim {bh['t_dim']}, key_dim {engine.key_dim}, "
        f"{engine.proposal_num} proposals/frame")
    warm_up(torch, np, engine)
    run = run_video(torch, np, engine, "[selsa]")
    if run["launches"] != 2 * run["detections"]:
        raise RuntimeError("the SELSA path did not run the attention kernel "
                           "2 times per detection")

    # the window head on a full window, with the kernel and with the plain
    # attention (these launches are not part of the counts above)
    feats = [engine.frame_features(f["img"], f["img_shape"], f["pad_shape"])
             for f in synthetic_video(np, engine.window, seed=1)]
    fc1 = torch.cat([f["fc1"] for f in feats])
    valid = torch.cat([f["mask"] for f in feats])
    kd, P = engine.key_dim, engine.proposal_num
    head = engine.model.bbox_head
    with torch.no_grad():
        got = head.forward_fc1(fc1, kd * P, P, valid)
        selsa_bbox_head.masked_attention = attention_plain
        try:
            want = head.forward_fc1(fc1, kd * P, P, valid)
        finally:
            selsa_bbox_head.masked_attention = masked_attention
        worst = logit_err(([got[0]], [got[1]]), ([want[0]], [want[1]]))
        log(f"[selsa] window head logits, kernel vs plain attention: max "
            f"|Δ|/max(|ref|, 1) = {worst:.3g} (limit 1e-4)")
        if not worst <= 1e-4:
            raise RuntimeError("SELSA window head with the kernel disagrees "
                               "with the plain attention")
        frame = next(synthetic_video(np, 1, seed=2))
        run["head_ms"] = cuda_ms(torch, lambda: head.forward_fc1(
            fc1, kd * P, P, valid), iters=3, warmup=1)
        run["decode_ms"] = cuda_ms(torch, lambda: get_det_bboxes(
            feats[kd]["boxes"], got[0], got[1], frame["img_shape"],
            frame["scale_factor"], engine.target_means, engine.target_stds,
            rescale=True, cfg=engine.test_cfg["rcnn"],
            valid=feats[kd]["mask"]), iters=3, warmup=1)
    log(f"[selsa] T={engine.window} window step {run['step_ms']:.3f} "
        f"ms/detection; stages alone: window head (NL1, NL2, fcs) "
        f"{run['head_ms']:.3f} ms, decode + class-wise NMS "
        f"{run['decode_ms']:.3f} ms; peak device memory over the video "
        f"{run['peak_gib']:.2f} GiB")
    return run, engine


def timed_training(torch, np, engine, batch, cfg, work_dir, stages, tag,
                   launches_per_step, timed=None):
    """``train_detector`` for TRAIN_WARMUP + ``timed`` (TRAIN_TIMED) steps
    on ``batch``
    with the kernel's launch count set to 0 just before and read just
    after: per-step stage times (CUDA events), peak memory and losses, the
    mean over the timed steps, finite losses and ``launches_per_step``
    launches checked.  Returns (trainer, summary)."""
    from hvrnet_tpu_torch.apis import train_detector
    from hvrnet_tpu_torch.ops.attention import masked_attention
    timer = StepTimer(torch, stages)
    timed = timed or TRAIN_TIMED
    steps = TRAIN_WARMUP + timed
    torch.cuda.synchronize()
    masked_attention.launches = 0
    t0 = time.time()
    trainer = train_detector(engine, [batch], cfg, str(work_dir),
                             total_epochs=1, steps_per_epoch=steps,
                             log_interval=1, seed=0, timer=timer)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = masked_attention.launches
    peak = max(timer.peaks)
    logs = [json.loads(line) for line in
            (work_dir / "train_log.jsonl").read_text().splitlines()]
    spans = timer.spans
    step_ms = [spans[stages[0]][i][0].elapsed_time(spans[stages[-1]][i][1])
               for i in range(steps)]
    for i, (ms, gib, lg) in enumerate(zip(step_ms, timer.peaks, logs)):
        times = {name: spans[name][i][0].elapsed_time(spans[name][i][1])
                 for name in stages}
        kind = "warmup" if i < TRAIN_WARMUP else "timed"
        log(f"{tag} step {i} ({kind}) {ms:.3f} ms (CUDA events), peak "
            f"device memory {gib:.2f} GiB; stages ms "
            + json.dumps({k: round(v, 3) for k, v in times.items()})
            + "; losses " + json.dumps(
                {k: lg[k] for k in lg if k.startswith(("loss", "acc"))}))
    span = slice(TRAIN_WARMUP, steps)
    mean = {name: sum(a.elapsed_time(b) for a, b in spans[name][span])
            / timed for name in stages}
    step_mean = sum(step_ms[span]) / timed
    log(f"{tag} {timed} timed steps: {step_mean:.3f} ms/step; "
        f"stages ms " + json.dumps({k: round(v, 3) for k, v in mean.items()})
        + f"; peak device memory {peak:.2f} GiB; kernel launches {launches}"
        f" over {steps} steps; {steps / wall:.3f} steps/s wall")
    bad = [lg for lg in logs
           if not all(np.isfinite(v) for k, v in lg.items()
                      if k.startswith(("loss", "acc")))]
    if len(logs) != steps or bad:
        raise RuntimeError(f"{tag} logged {len(logs)} steps, non-finite "
                           f"losses in {bad}")
    if launches != launches_per_step * steps:
        raise RuntimeError(f"{tag} launched the kernel {launches} times, "
                           f"not {launches_per_step} per step over {steps} "
                           "steps")
    return trainer, dict(launches=launches, step_ms=step_mean,
                         stages_ms=mean, peak_gib=peak)


def calibrated_training_engine(torch, engine_cls, cfg, batch, tag,
                               trunk="R101-C5"):
    """A training engine on seeded random weights with its frozen BNs
    calibrated on the batch's first (up to) four frames."""
    from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
    t0 = time.time()
    engine = engine_cls(cfg["model"], train_cfg=cfg["train_cfg"],
                        device="cuda", seed=0)
    n_bn = calibrate_frozen_bn(engine, [
        dict(img=batch["imgs"][f:f + 1], img_shape=batch["img_shape"][f])
        for f in range(min(4, len(batch["imgs"])))])
    torch.cuda.synchronize()
    bh = engine.model.bbox_head
    head = (f"head sampler_num {bh.sampler_num}, t_dim {bh.t_dim}"
            if hasattr(bh, "t_dim") else f"head {type(bh).__name__}")
    log(f"{tag} {engine_cls.__name__} {trunk} training engine in "
        f"{time.time() - t0:.1f} s (seeded random weights, {n_bn} frozen "
        f"BNs calibrated on the first batch): {len(batch['imgs'])} frames, "
        f"{head}, canvas {tuple(batch['imgs'].shape[1:3])}")
    return engine


def phase_train(torch, np):
    """HVRNet training at full width through ``train_detector``: 2 warmup
    and 5 timed steps with a stage split, the launch count, frozen tensors
    bitwise unchanged, trainable ones moved, and a bitwise resume.
    Returns the summary and the calibrated weights it started from."""
    import shutil
    from hvrnet_tpu_torch.apis import train_detector
    from hvrnet_tpu_torch.engine import HNMBRCNN
    from hvrnet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(str(CONFIG)).as_dict()
    work_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work_dir, ignore_errors=True)
    batch = synthetic_train_batch(np)
    engine = calibrated_training_engine(torch, HNMBRCNN, cfg, batch,
                                        "[train]")
    before = {k: t.clone() for k, t in engine.model.state_dict().items()}
    trainer, summary = timed_training(torch, np, engine, batch, cfg,
                                      work_dir, TRAIN_STAGES, "[train]", 9)
    check_train_weights(torch, engine, before, "[train]",
                        ("shared_head.", "bbox_head."))

    # a resume from the checkpoint restores the step and the weights
    steps = TRAIN_WARMUP + TRAIN_TIMED
    resumed = HNMBRCNN(cfg["model"], train_cfg=cfg["train_cfg"],
                       device="cuda", seed=1)
    again = train_detector(resumed, [batch], cfg, str(work_dir),
                           total_epochs=1, steps_per_epoch=steps,
                           resume_from=str(work_dir / "latest.pth"))
    same = all(torch.equal(t, resumed.model.state_dict()[k])
               for k, t in engine.model.state_dict().items())
    mom = all(torch.equal(again.optimizer.state[a]["momentum_buffer"],
                          trainer.optimizer.state[b]["momentum_buffer"])
              for a, b in zip(again.params, trainer.params))
    log(f"[train] resumed from {(work_dir / 'latest.pth').relative_to(ROOT)}"
        f": step {again.step}, weights bitwise equal {same}, momentum "
        f"bitwise equal {mom}")
    if not (again.step == trainer.step == steps and same and mom):
        raise RuntimeError("the checkpoint did not resume the training state")
    shutil.rmtree(work_dir, ignore_errors=True)
    del engine, resumed, trainer, again
    torch.cuda.empty_cache()
    return summary, before


def phase_selsa_train(torch, np):
    """SELSA training at the config's full width through
    ``train_detector``: 3 frames of one video, 300 RoIs per frame, OHEM
    128, the backbone from ``layer2``, the RPN, the shared head and the
    SELSA head trained; 2 warmup and 5 timed steps with a stage split, 2
    launches per step, frozen tensors bitwise unchanged and every
    trainable one moved.  Returns the summary and the calibrated weights
    it started from."""
    import shutil
    from hvrnet_tpu_torch.engine import SelsaRCNN
    from hvrnet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(str(SELSA_CONFIG)).as_dict()
    work_dir = ROOT / "build" / "chip_smoke_selsa_train"
    shutil.rmtree(work_dir, ignore_errors=True)
    batch = synthetic_train_batch(np, seed=1, videos=1)
    engine = calibrated_training_engine(torch, SelsaRCNN, cfg, batch,
                                        "[selsa-train]")
    before = {k: t.clone() for k, t in engine.model.state_dict().items()}
    _, summary = timed_training(torch, np, engine, batch, cfg, work_dir,
                                SELSA_TRAIN_STAGES, "[selsa-train]", 2)
    check_train_weights(torch, engine, before, "[selsa-train]",
                        ("backbone.layer2.", "backbone.layer3.",
                         "rpn_head.", "shared_head.", "bbox_head."))
    shutil.rmtree(work_dir, ignore_errors=True)
    del engine
    torch.cuda.empty_cache()
    return summary, before


def check_train_weights(torch, engine, before, tag, trained, idle=()):
    """Every tensor outside the ``trained`` prefixes (the frozen stages and
    every frozen-BN buffer) bit for bit as before; every trainable tensor
    moved, except the key projections' biases, whose gradient is 0 (a
    constant per softmax row) and whose decay of 0 is 0, and the ``idle``
    ones, which the objective does not reach (they keep no gradient, so
    the step leaves them)."""
    params = dict(engine.model.named_parameters())
    frozen_moved, still = [], []
    for name, t in engine.model.state_dict().items():
        trains = name in params and params[name].requires_grad
        if not trains and not torch.equal(t, before[name]):
            frozen_moved.append(name)
        if trains and torch.equal(t, before[name]) and not (
                ".k_data_fc_" in name and name.endswith(".bias")) \
                and not name.startswith(idle):
            still.append(name)
    n_train = sum(p.requires_grad for p in params.values())
    log(f"{tag} {len(before) - n_train} frozen tensors bitwise unchanged: "
        f"{not frozen_moved}; {n_train} trainable tensors "
        f"({', '.join(p.rstrip('.') for p in trained)}) moved: {not still}")
    if frozen_moved or still or any(
            p.requires_grad != n.startswith(trained)
            for n, p in params.items()):
        raise RuntimeError(f"{tag} moved frozen tensors {frozen_moved} or "
                           f"left trainable ones {still}, or trains another "
                           "set than its prefixes")


def device_ms(torch, fn):
    """Device time of one call of ``fn`` (after a warm call): the summed
    durations of the kernels and copies ``torch.profiler`` traces on the
    card (one stream: they do not overlap); 0.0 when it traced none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def busy_report(torch, np, engine, tag):
    """Where the card waits on the host: for each stage of one frame and
    one detection, the device time ``torch.profiler`` traces against the
    stage's CUDA-event span (``cuda_ms``); 1 − device/span is the card's
    idle share over the stage."""
    from hvrnet_tpu_torch.models.bbox_heads.bbox_head import get_det_bboxes
    T, P, kd = engine.window, engine.proposal_num, engine.key_dim
    frames = list(synthetic_video(np, T + 1, seed=4))
    feats = [engine.frame_features(f["img"], f["img_shape"], f["pad_shape"])
             for f in frames]
    f0 = frames[0]
    ish, psh, sf = f0["img_shape"], f0["pad_shape"], f0["scale_factor"]
    maps = engine.backbone_maps(f0["img"], ish)
    fc1 = torch.cat([f["fc1"] for f in feats[:T]])
    valid = torch.cat([f["mask"] for f in feats[:T]])
    head = engine.model.bbox_head
    saved = engine.stream, engine.stream_rollback
    engine.stream = engine.stream_rollback = True
    ring = engine.ring_reset(int(fc1.shape[-1]))
    for f in feats[:T]:
        engine.ring_push(ring, f)
    with torch.no_grad():
        cls, reg = head.forward_fc1(fc1, kd * P, P, valid)
        stages = {
            "backbone: C4, C5, RPN maps": lambda: engine.backbone_maps(
                f0["img"], ish),
            "frame post: proposals, RoIAlign, fc_new_1":
                lambda: engine.frame_post(*maps, ish, psh),
            "exact window head": lambda: head.forward_fc1(fc1, kd * P, P,
                                                          valid),
            "streaming ring_step, speculative": lambda: engine.ring_step(
                ring, feats[T], ish, sf, branch=-1),
            "decode + class-wise NMS": lambda: get_det_bboxes(
                feats[kd]["boxes"], cls[-1], reg[-1], ish, sf,
                engine.target_means, engine.target_stds, rescale=True,
                cfg=engine.test_cfg["rcnn"], valid=feats[kd]["mask"]),
        }
        for name, fn in stages.items():
            span = cuda_ms(torch, fn, iters=3, warmup=1)
            busy = device_ms(torch, fn)
            idle = (f"idle {1 - busy / span:.2f}" if busy > 0
                    else "device time not traced")
            log(f"{tag} {name}: device {busy:.3f} ms of a {span:.3f} ms "
                f"span, {idle}")
    engine.stream, engine.stream_rollback = saved


def bf16_window_checks(torch, np, engine, engine32, tag):
    """The bf16 window head on one full window of the f32 engine's fc1
    rows: every kernel call held to its plain version (``bf16_agreement``'s
    elementwise ``worst`` ≤ 1; its ``rms`` is printed, not held: it assumes
    the weights' roundings independent, and the near-uniform softmax rows
    of random-weight projections round coherently), its logits to the same
    head with the plain attention and to the f32 head on the same rows (the
    bf16 budget).
    Returns the bf16 engine's own caches of that window and its head
    output on them, for the stage times."""
    from hvrnet_tpu_torch.models.bbox_heads import selsa_bbox_head
    from hvrnet_tpu_torch.ops.attention import (attention_plain,
                                                bf16_agreement,
                                                masked_attention)
    frames = list(synthetic_video(np, engine.window, seed=1))
    feats = [engine32.frame_features(f["img"], f["img_shape"],
                                     f["pad_shape"]) for f in frames]
    fc1 = torch.cat([f["fc1"] for f in feats])
    valid = torch.cat([f["mask"] for f in feats])
    kd, P = engine.key_dim, engine.proposal_num
    head = engine.model.bbox_head
    agreements = []

    def probed(q, k, v, bias, scale):
        out = masked_attention(q, k, v, bias, scale)
        agreements.append(bf16_agreement(out, q, k, v, bias, scale))
        return out

    with torch.no_grad():
        want32 = engine32.model.bbox_head.forward_fc1(fc1, kd * P, P, valid)
        try:
            selsa_bbox_head.masked_attention = probed
            got = head.forward_fc1(fc1.bfloat16(), kd * P, P, valid)
            selsa_bbox_head.masked_attention = attention_plain
            plain = head.forward_fc1(fc1.bfloat16(), kd * P, P, valid)
        finally:
            selsa_bbox_head.masked_attention = masked_attention
    worst = max(a["worst"] for a in agreements)
    rms = max(a["rms"] for a in agreements)
    kernel = head_budget(got, plain)
    f32 = head_budget(got, want32)
    log(f"{tag} window head, {len(agreements)} bf16 kernel calls against "
        f"their plain version: worst {worst:.3g} (limit 1), rms {rms:.3g}; "
        f"logits with the kernel vs the plain attention: max "
        f"|Δcls|/max(|cls|, 1) {kernel[0]:.3g}, max |Δreg| {kernel[1]:.3g}; "
        f"bf16 vs f32 head on the same fc1: {f32[0]:.3g}, {f32[1]:.3g} "
        f"(limits {BF16_CLS_BUDGET}, {BF16_REG_BUDGET})")
    if not (worst <= 1 and all(
            c <= BF16_CLS_BUDGET and r <= BF16_REG_BUDGET
            for c, r in (kernel, f32))):
        raise RuntimeError(f"{tag} bf16 window head out of its limits")
    if not all(t.dtype == torch.bfloat16 for t in sum(
            head_outputs(got), [])):
        raise RuntimeError(f"{tag} the bf16 head did not compute in bf16")
    feats16 = [engine.frame_features(f["img"], f["img_shape"],
                                     f["pad_shape"]) for f in frames]
    fc1_16 = torch.cat([f["fc1"] for f in feats16])
    valid16 = torch.cat([f["mask"] for f in feats16])
    with torch.no_grad():
        out16 = head.forward_fc1(fc1_16, kd * P, P, valid16)
    return feats16, fc1_16, valid16, out16


def count_agreement(a_results, b_results):
    """Frames whose per-class detection counts all agree, of all frames."""
    same = sum(all(ca.shape == cb.shape for ca, cb in zip(fa, fb))
               for fa, fb in zip(a_results, b_results))
    return same, len(a_results)


def phase_bf16_hvrnet(torch, np, engine32, exact32, stream32):
    """HVRNet in bf16 on the f32 engine's weights: the streaming ring
    (speculative) and the exact ring at T=21 through the runner, the
    window head's checks, streaming against exact, stage times."""
    engine = build_engine(torch, np, weights=engine32.model.state_dict(),
                          dtype=torch.bfloat16)
    warm_up(torch, np, engine)
    engine.stream = True
    stream = run_video(torch, np, engine, "[bf16] stream T=21")
    want = 2 * stream["detections"] + 4 * stream["replayed"]
    if stream["launches"] != want:
        raise RuntimeError(f"bf16 streaming ring launched the kernel "
                           f"{stream['launches']} times, not {want}")
    engine.stream = False
    exact = run_video(torch, np, engine, "[bf16] exact T=21")
    if exact["launches"] != 4 * exact["detections"]:
        raise RuntimeError("the bf16 exact ring did not run the kernel 4 "
                           "times per detection")
    for name, r16, r32 in (("streaming", stream, stream32),
                           ("exact", exact, exact32)):
        log(f"[bf16] T=21 {name} ring: window step {r16['step_ms']:.3f} "
            f"ms/detection against {r32['step_ms']:.3f} in f32; "
            f"frame_features {r16['frame_ms']:.3f} against "
            f"{r32['frame_ms']:.3f}; peak {r16['peak_gib']:.2f} GiB against "
            f"{r32['peak_gib']:.2f}")
    log("[bf16] T=21 frames with the same per-class detection counts: "
        "streaming vs exact %d of %d, bf16 vs f32 exact %d of %d (no limit)"
        % (count_agreement(exact["results"], stream["results"])
           + count_agreement(exact32["results"], exact["results"])))
    feats, fc1, valid, out = bf16_window_checks(torch, np, engine, engine32,
                                                "[bf16] T=21")
    stage_times(torch, np, engine, feats, fc1, valid, out)
    engine.stream = True
    stream_stages(torch, engine, *final_window_check(torch, np, engine))
    busy_report(torch, np, engine32, "[busy] f32")
    busy_report(torch, np, engine, "[busy] bf16")
    del engine
    torch.cuda.empty_cache()
    return stream, exact


def phase_bf16_selsa(torch, np, engine32):
    """SELSA in bf16 on the f32 engine's weights through the runner: 2
    launches per detection, the window head's checks, head and decode
    times."""
    from hvrnet_tpu_torch.engine import SelsaRCNN
    from hvrnet_tpu_torch.models.bbox_heads.bbox_head import get_det_bboxes
    engine = SelsaRCNN(engine32.model_cfg, engine32.test_cfg, device="cuda",
                       dtype=torch.bfloat16)
    engine.load_state_dict(engine32.model.state_dict())
    engine.cast_head_params_bf16()
    warm_up(torch, np, engine)
    run = run_video(torch, np, engine, "[bf16] selsa T=21")
    if run["launches"] != 2 * run["detections"]:
        raise RuntimeError("the bf16 SELSA path did not run the attention "
                           "kernel 2 times per detection")
    feats, fc1, valid, (cls, reg) = bf16_window_checks(
        torch, np, engine, engine32, "[bf16] selsa")
    kd, P = engine.key_dim, engine.proposal_num
    head = engine.model.bbox_head
    frame = next(synthetic_video(np, 1, seed=2))
    with torch.no_grad():
        run["head_ms"] = cuda_ms(torch, lambda: head.forward_fc1(
            fc1, kd * P, P, valid), iters=3, warmup=1)
        run["decode_ms"] = cuda_ms(torch, lambda: get_det_bboxes(
            feats[kd]["boxes"], cls, reg, frame["img_shape"],
            frame["scale_factor"], engine.target_means, engine.target_stds,
            rescale=True, cfg=engine.test_cfg["rcnn"],
            valid=feats[kd]["mask"]), iters=3, warmup=1)
    log(f"[bf16] selsa T={engine.window} window step {run['step_ms']:.3f} "
        f"ms/detection; stages alone: window head {run['head_ms']:.3f} ms, "
        f"decode + class-wise NMS {run['decode_ms']:.3f} ms; frame_features "
        f"{run['frame_ms']:.3f} ms; peak device memory {run['peak_gib']:.2f} "
        "GiB")
    del engine
    torch.cuda.empty_cache()
    return run


def phase_bf16_train(torch, np, engine_cls, config, weights, batch, stages,
                     tag, launches_per_step, trained, fp16_step=False):
    """A bf16 training engine of ``engine_cls`` on the f32 phase's
    calibrated ``weights``: ``train_detector`` for TRAIN_WARMUP +
    BF16_TIMED steps, float32 parameters, frozen tensors bitwise unchanged
    and trainable ones moved; with ``fp16_step`` one more step under
    ``fp16=dict(loss_scale=512.)``."""
    import shutil
    from hvrnet_tpu_torch.apis import build_detector, train_detector
    from hvrnet_tpu_torch.ops.attention import masked_attention
    from hvrnet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(str(config)).as_dict()
    work_dir = ROOT / "build" / "chip_smoke_bf16_train"
    shutil.rmtree(work_dir, ignore_errors=True)
    engine = build_detector(cfg["model"], train_cfg=cfg["train_cfg"],
                            dtype=torch.bfloat16)
    if not isinstance(engine, engine_cls):
        raise RuntimeError(f"{tag} build_detector gave {type(engine)}")
    engine.load_state_dict(weights)
    before = {k: t.clone() for k, t in engine.model.state_dict().items()}
    _, summary = timed_training(torch, np, engine, batch, cfg, work_dir,
                                stages, tag, launches_per_step,
                                timed=BF16_TIMED)
    check_train_weights(torch, engine, before, tag, trained)
    if any(p.dtype != torch.float32 for p in engine.model.parameters()):
        raise RuntimeError(f"{tag} parameters left float32")
    if fp16_step:
        shutil.rmtree(work_dir, ignore_errors=True)
        masked_attention.launches = 0
        train_detector(engine, [batch],
                       dict(cfg, fp16=dict(loss_scale=512.0)), str(work_dir),
                       total_epochs=1, steps_per_epoch=1, log_interval=1)
        torch.cuda.synchronize()
        lg = json.loads((work_dir / "train_log.jsonl").read_text())
        log(f"{tag} one step under fp16=dict(loss_scale=512.): loss "
            f"{lg['loss']:.6g}, loss_scale {lg['loss_scale']}, overflow "
            f"{lg['overflow']}, kernel launches {masked_attention.launches}")
        if not (np.isfinite(lg["loss"]) and lg["loss_scale"] == 512.0
                and lg["overflow"] == 0.0
                and masked_attention.launches == launches_per_step):
            raise RuntimeError(f"{tag} the loss-scaled step failed: {lg}")
    shutil.rmtree(work_dir, ignore_errors=True)
    del engine
    torch.cuda.empty_cache()
    return summary


# the [cli] phase's synthetic VID tree: (video, frames, (height, width));
# a 1280×720 video longer than the 63-frame cache's half, one shorter than a
# T=21 window, and a portrait one
CLI_VIDEOS = (("val/ILSVRC2015_val_00000000", 40, (720, 1280)),
              ("val/ILSVRC2015_val_00000001", 17, (720, 1280)),
              ("val/ILSVRC2015_val_00000002", 12, (960, 540)))
# (wnid, box colour BGR) per moving box; the last video has two boxes
CLI_OBJECTS = (("n02691156", (40, 40, 220)), ("n02958343", (220, 160, 40)))
CARD = ""                 # nvidia-smi's name and power limit, for the lines


def write_ppm(path, img_bgr):
    """A binary PPM (P6, RGB) of a BGR image."""
    h, w = img_bgr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img_bgr[..., ::-1].tobytes())


def read_ppm(path):
    """The CLIs' decoder here: the card machine has no JPEG codec (neither
    cv2 nor PIL), so the synthetic tree stores binary PPM under VID's
    ``.JPEG`` names and this reader hands the pipeline (H, W, 3) uint8 BGR,
    what ``cv2.imread`` gives."""
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:            # magic, width, height, maxval
        while data[pos:pos + 1].isspace():
            pos += 1
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P6" or fields[3] != b"255":
        raise ValueError(f"{path}: not an 8-bit binary PPM")
    w, h = int(fields[1]), int(fields[2])
    rgb = np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos + 1)
    return np.ascontiguousarray(rgb.reshape(h, w, 3)[..., ::-1])


def write_cli_tree(np, root, videos, seed=0):
    """A VID tree of ``videos`` (``CLI_VIDEOS``' form): each frame a smooth random scene panning
    under one or two moving boxes of VID classes, a VOC XML per frame, and
    ``ImageSets/VID_val_videos.txt``.  Returns the imageset's path and each
    frame's truth in dataset order, as (wnid, 0-based box) pairs."""
    import xml.etree.ElementTree as ET
    rng = np.random.default_rng(seed)
    lines, frame_id, truth = [], 1, []
    for v, (vpath, n, (h, w)) in enumerate(videos):
        scene = rng.integers(0, 256, size=(h // 16 + 8, w // 16 + 8, 3),
                             dtype=np.uint8)
        scene = np.repeat(np.repeat(scene, 16, axis=0), 16, axis=1)
        objects = CLI_OBJECTS[:2 if v == len(videos) - 1 else 1]
        for i in range(n):
            img = np.ascontiguousarray(scene[i % 64:i % 64 + h,
                                             2 * i % 64:2 * i % 64 + w])
            truth.append([])
            ann = ET.Element("annotation")
            size = ET.SubElement(ann, "size")
            ET.SubElement(size, "width").text = str(w)
            ET.SubElement(size, "height").text = str(h)
            for k, (wnid, colour) in enumerate(objects):
                x1 = w // 8 + 6 * i + k * w // 3
                y1 = h // 5 + 3 * i + k * h // 4
                box = (x1, y1, x1 + w // 4, y1 + h // 3)
                img[box[1]:box[3], box[0]:box[2]] = colour
                truth[-1].append((wnid, [c - 1 for c in box]))
                obj = ET.SubElement(ann, "object")
                ET.SubElement(obj, "name").text = wnid
                bnd = ET.SubElement(obj, "bndbox")
                for key, val in zip(("xmin", "ymin", "xmax", "ymax"), box):
                    ET.SubElement(bnd, key).text = str(val)
            for kind, ext in (("JPEGImages", ".JPEG"),
                              ("Annotations", ".xml")):
                (root / kind / vpath).mkdir(parents=True, exist_ok=True)
            write_ppm(root / "JPEGImages" / vpath / f"{i:06d}.JPEG", img)
            ET.ElementTree(ann).write(root / "Annotations" / vpath
                                      / f"{i:06d}.xml")
        lines.append(f"{vpath} {frame_id} 0 {n}")
        frame_id += n
    (root / "ImageSets").mkdir(exist_ok=True)
    imageset = root / "ImageSets" / f"VID_val_{len(videos)}_videos.txt"
    imageset.write_text("\n".join(lines) + "\n")
    return imageset, truth


def truth_results(np, truth):
    """Per frame the 30-class results that are the frame's truth, each box
    at score 1."""
    from hvrnet_tpu_torch.data.vid_dataset import VID_WNIDS
    results = []
    for objects in truth:
        frame = [np.zeros((0, 5), np.float32) for _ in VID_WNIDS]
        for wnid, box in objects:
            c = VID_WNIDS.index(wnid)
            frame[c] = np.concatenate(
                [frame[c], np.float32([box + [1.0]])])
        results.append(frame)
    return results


def cli_config(config, root, imageset, out):
    """The shipped config with its ``data.test`` pointed at the tree."""
    out.write_text(Path(config).read_text()
                   + f"\ndata['test']['ann_file'] = {str(imageset)!r}\n"
                   f"data['test']['img_prefix'] = {str(root)!r}\n")
    return str(out)


class CliTimer(PhaseTimer):
    """The CLIs' ``timer``: host wall time of every phase (the stream's
    ``pipeline`` and ``canvas`` on its thread, the runner's wait for a
    frame), CUDA events around the runner's device stages."""
    DEVICE = ("frame_features", "window_detect")

    def __init__(self, torch):
        super().__init__(torch)
        self.host = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        with (super().phase(name) if name in self.DEVICE
              else contextlib.nullcontext()):
            yield
        self.host.setdefault(name, []).append(time.perf_counter() - t0)

    def host_s(self, name):
        return sum(self.host.get(name, ()))


def cli_run(torch, np, module, argv, tag, per_det, per_replay=0):
    """One CLI run in this process with the PPM decoder and a timer, the
    kernel's launch count set to 0 just before and read just after.
    Checks a 30-class result with finite boxes for every frame, the
    launches (``per_det`` per detection, ``per_replay`` per replayed one)
    and an mAP in [0, 1].  Returns the run's record."""
    import importlib
    from hvrnet_tpu_torch.ops.attention import masked_attention
    main = importlib.import_module(f"hvrnet_tpu_torch.tools.{module}").main
    timer = CliTimer(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    masked_attention.launches = 0
    run = main(argv, imread=read_ppm, timer=timer)
    torch.cuda.synchronize()
    launches = masked_attention.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    runner = run.pop("runner")
    # the lockstep runner detects every stream at once, and replays nothing
    detects = getattr(runner, "detects", run["frames"])
    run.update(launches=launches, detects=detects,
               runner_steps=getattr(runner, "steps", None),
               replayed=getattr(runner, "replayed", 0),
               rebuilds=getattr(runner, "rebuilds", 0), timer=timer,
               dtype=str(runner.engine.dtype)[6:])
    del runner
    n = run["frames"]
    for i, res in enumerate(run["results"]):
        if res is None or len(res) != 30:
            raise RuntimeError(f"{tag} frame {i} has no 30-class result")
        for dets in res:
            if dets.shape[1:] != (5,) or not np.isfinite(dets).all():
                raise RuntimeError(f"{tag} frame {i}: bad detections")
    want = per_det * detects + per_replay * run["replayed"]
    if launches != want:
        raise RuntimeError(f"{tag} launched the kernel {launches} times, "
                           f"not {want} ({per_det} per detection of its "
                           f"{detects}, {per_replay} per replayed one)")
    if run["map"] is not None and not 0.0 <= run["map"] <= 1.0:
        raise RuntimeError(f"{tag} mAP {run['map']} outside [0, 1]")
    run["detections"] = n
    fps = n / run["wall_s"]
    # the wait for frames: the sequential runner's on its stream, the
    # lockstep runner's own loading
    wait = (timer.host_s("stream_wait") + timer.host_s("load")) \
        / run["wall_s"]
    pipe = 1e3 * timer.host_s("pipeline") / n
    log(f"[cli] {tag}: {n} frames, {detects} detections, every frame a "
        f"30-class result with finite boxes; kernel launches {launches} "
        f"(replayed detections {run['replayed']}, rebuilds "
        f"{run['rebuilds']}); mAP {run['map']}")
    log(f"[cli] {tag} ({CARD}): frame program "
        f"{timer.mean_ms('frame_features'):.3f} ms/frame, window step "
        f"{timer.mean_ms('window_detect'):.3f} ms/detection (CUDA "
        f"events); CLI wall {fps:.3f} frames/s over {run['wall_s']:.3f} s; "
        f"the runner waited on the stream {wait:.3f} of the wall time; "
        f"host pipeline on the stream's thread {pipe:.3f} ms/frame; peak "
        f"device memory {peak:.2f} GiB")
    run.update(fps=fps, wait_share=wait, pipeline_ms=pipe, peak_gib=peak)
    torch.cuda.empty_cache()
    return run


def host_data_probe(np, config, n=12):
    """Host data time per 1280×720 frame, each step of the test pipeline
    alone (decode, resize, flip, normalise, pad, collect) and the canvas
    padding, over the first ``n`` frames of the tree's first video."""
    from hvrnet_tpu_torch.engine.stream import runner_frame
    from hvrnet_tpu_torch.tools.test import canvas_of, test_dataset
    from hvrnet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(config)
    ds = test_dataset(cfg, 1, 0, read_ppm)
    canvas = canvas_of(cfg)
    video = ds.img_infos[0]
    n = min(n, video["frame_seg_len"])
    ms = {}
    for i in range(n):
        r = dict(img_info=ds._frame_info(video, i))
        ds.pre_pipeline(r)
        for t in ds.pipeline.transforms:
            t0 = time.perf_counter()
            r = t(r)
            name = type(t).__name__
            ms[name] = ms.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        runner_frame(r, max(canvas), min(canvas))
        ms["canvas"] = ms.get("canvas", 0.0) + 1e3 * (time.perf_counter()
                                                     - t0)
    ms = {k: v / n for k, v in ms.items()}
    total = sum(ms.values())
    log(f"[cli] ({CARD}) host data per {video['width']}x{video['height']} "
        f"frame, ms (mean of {n}; decode = LoadImageFromFile of a binary "
        f"PPM): " + json.dumps({k: round(v, 3) for k, v in ms.items()})
        + f"; total {total:.3f} ms")
    return ms


def engine_inputs(torch, store, indices):
    """Wrap ``BaseEngine._to_input`` to keep a host copy of the engine
    input of the calls numbered in ``indices``; returns the restore
    function."""
    from hvrnet_tpu_torch.engine import detector
    original = detector.BaseEngine._to_input
    count = [0]

    def recording(self, img, img_shape):
        x = original(self, img, img_shape)
        if count[0] in indices:
            store.append(x.cpu())
        count[0] += 1
        return x

    detector.BaseEngine._to_input = recording
    return lambda: setattr(detector.BaseEngine, "_to_input", original)


def compare_cli(tag, got, want, box_tol, score_tol=1e-4, prefix="[cli]"):
    """Per frame and class the same number of detections, and each of
    ``want``'s within ``box_tol`` / ``score_tol`` of a distinct one of
    ``got``'s (rows of near-equal score may swap); returns whether the
    results were also bitwise equal."""
    bitwise, worst_box, worst_score = True, 0.0, 0.0
    for i, (fg, fw) in enumerate(zip(got, want)):
        bitwise = bitwise and all(cg.tobytes() == cw.tobytes()
                                  for cg, cw in zip(fg, fw))
        problem, box, score = match_frame(fg, fw, box_tol, score_tol)
        if problem:
            raise RuntimeError(f"{tag} frame {i}: {problem}")
        worst_box, worst_score = max(worst_box, box), max(worst_score, score)
    log(f"{prefix} {tag}: per frame and class the same detections, boxes "
        f"within {worst_box:.3g} px (limit {box_tol:.3g}), scores within "
        f"{worst_score:.3g} (limit {score_tol:.3g}); bitwise equal: "
        f"{bitwise}")
    return bitwise


def match_frame(fg, fw, box_tol, score_tol):
    """(what differs or "", worst box |Δ|, worst score |Δ|) of one frame's
    per-class detections: the same counts, and each of ``fw``'s rows within
    the limits of a distinct row of ``fg`` (nearest first)."""
    import numpy as np
    worst_box = worst_score = 0.0
    for cg, cw in zip(fg, fw):
        if cg.shape != cw.shape:
            return f"{cg.shape} detections against {cw.shape}", 0.0, 0.0
        free = list(range(len(cg)))
        for row in cw:
            cost = [max(abs(cg[j, :4] - row[:4]).max() / box_tol,
                        abs(cg[j, 4] - row[4]) / score_tol) for j in free]
            if not cost or min(cost) > 1:
                return (f"detection {row} has no counterpart within the "
                        f"limits"), 0.0, 0.0
            j = free.pop(int(np.argmin(cost)))
            worst_box = max(worst_box, float(abs(cg[j, :4] - row[:4]).max()))
            worst_score = max(worst_score, float(abs(cg[j, 4] - row[4])))
    return "", worst_box, worst_score


def host_state_dict(engine):
    """A host copy of an engine's weights."""
    return {k: v.detach().cpu().clone()
            for k, v in engine.model.state_dict().items()}


def phase_cli(torch, np, hvr_weights, selsa_weights):
    """The port's CLIs over a synthetic VID tree on disk (1280×720 and a
    portrait 540×960 video, PPM frames read by ``read_ppm``) with the f32
    engines' seeded, calibrated weights saved as ``.pth`` files: HVRNet's
    ``hnl_test`` on the exact and streaming rings at T=21, the streaming
    ring at T=63 over the 40-frame video, bf16 at T=21; SELSA's ``test``
    in f32 with and without ``--u8-transfer``; ``vid_eval`` on a results
    pickle.  Returns the runs whose launches the kernels line counts."""
    import shutil
    from hvrnet_tpu_torch.engine import HNMBRCNN, SlidingWindowRunner
    from hvrnet_tpu_torch.engine.stream import test_frame_stream
    from hvrnet_tpu_torch.tools import vid_eval
    from hvrnet_tpu_torch.tools.hnl_test import set_head_window
    from hvrnet_tpu_torch.tools.test import (canvas_of, set_window,
                                             test_dataset)
    from hvrnet_tpu_torch.utils.config import Config, unwrap
    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "VID"
    t0 = time.time()
    imageset, truth = write_cli_tree(np, root, CLI_VIDEOS)
    # a tree of its own: its one video is its last, which has two boxes
    root63 = work / "VID63"
    long_only, _ = write_cli_tree(np, root63, CLI_VIDEOS[:1])
    hvr_ckpt, selsa_ckpt = work / "hvrnet.pth", work / "selsa.pth"
    torch.save({"state_dict": hvr_weights}, hvr_ckpt)
    torch.save({"state_dict": selsa_weights}, selsa_ckpt)
    hvr_cfg = cli_config(CONFIG, root, imageset, work / "hvrnet.py")
    hvr63_cfg = cli_config(CONFIG, root63, long_only, work / "hvrnet63.py")
    selsa_cfg = cli_config(SELSA_CONFIG, root, imageset, work / "selsa.py")
    n_frames = sum(n for _, n, _ in CLI_VIDEOS)
    sizes = ", ".join(f"{n} of {w}x{h}" for _, n, (h, w) in CLI_VIDEOS)
    log(f"[cli] tree of {len(CLI_VIDEOS)} videos, {n_frames} PPM frames "
        f"({sizes}), and the two .pth files in {time.time() - t0:.1f} s")
    host_data_probe(np, hvr_cfg)

    def argv(cfg, ckpt, name, *extra):
        return [cfg, str(ckpt), "--out", str(work / f"{name}.pkl"),
                "--tmpdir", str(work / name), *extra]

    hnl = ("--window", "21", "--pre-padding", "repeat", "--eval")
    runs = {}
    runs["cli exact T=21"] = cli_run(torch, np, "hnl_test", argv(
        hvr_cfg, hvr_ckpt, "exact", *hnl), "hnl_test exact T=21", 4)
    runs["cli stream T=21"] = cli_run(torch, np, "hnl_test", argv(
        hvr_cfg, hvr_ckpt, "stream", *hnl, "--stream"),
        "hnl_test stream T=21", 2, 4)
    runs["cli stream T=63"] = cli_run(torch, np, "hnl_test", argv(
        hvr63_cfg, hvr_ckpt, "stream63", "--window", "63", "--pre-padding",
        "repeat", "--stream", "--eval"), "hnl_test stream T=63", 2, 4)
    bf16 = cli_run(torch, np, "hnl_test", argv(
        hvr_cfg, hvr_ckpt, "bf16", *hnl, "--bf16"),
        "hnl_test bf16 exact T=21", 4)

    # mAP against vid_eval on the same pickle
    exact = runs["cli exact T=21"]
    mean_ap, _ = vid_eval.main([str(work / "exact.pkl"), hvr_cfg])
    log(f"[cli] vid_eval on the exact run's pickle: mAP {mean_ap} (the CLI "
        f"printed {exact['map']})")
    if mean_ap != exact["map"]:
        raise RuntimeError("the CLI's mAP differs from vid_eval's")
    # random weights score 0 above; the tree's own truth as results must
    # score 1 at IoU 0.99, which a frame read out of order misses (the
    # boxes move 6 px a frame)
    with open(work / "truth.pkl", "wb") as f:
        pickle.dump(truth_results(np, truth), f)
    truth_ap, _ = vid_eval.main([str(work / "truth.pkl"), hvr_cfg,
                                 "--iou-thr", "0.99"])
    log(f"[cli] vid_eval of the tree's own truth at IoU 0.99: mAP "
        f"{truth_ap} (1.0 expected)")
    if truth_ap != 1.0:
        raise RuntimeError("vid_eval scores the tree's truth below 1")

    # the exact-ring CLI against SlidingWindowRunner over the port's
    # test_frame_stream in this process, on the same weights
    cfg = Config.fromfile(hvr_cfg)
    set_head_window(cfg, 21)
    test_cfg = unwrap(cfg.test_cfg)
    engine = HNMBRCNN(unwrap(cfg.model), test_cfg, device="cuda")
    set_window(engine, 21)
    engine.load_state_dict(hvr_weights)

    ds = test_dataset(cfg, 1, 0, read_ppm)
    canvas = canvas_of(cfg)
    direct = SlidingWindowRunner(engine).run(
        test_frame_stream(ds, max_long=max(canvas), max_short=min(canvas)),
        len(ds))
    del engine
    torch.cuda.empty_cache()
    compare_cli("hnl_test exact T=21 against SlidingWindowRunner over "
                "test_frame_stream in-process", exact["results"], direct,
                1e-4 * 1280)

    # SELSA: float frames and uint8 frames, the engine input of each
    # video's first frame kept
    firsts = [sum(n for _, n, _ in CLI_VIDEOS[:v])
              for v in range(len(CLI_VIDEOS))]
    inputs = {}
    for name, extra in (("selsa", ()), ("selsa u8", ("--u8-transfer",))):
        inputs[name] = []
        restore = engine_inputs(torch, inputs[name], firsts)
        try:
            runs[f"{name} cli"] = cli_run(torch, np, "test", argv(
                selsa_cfg, selsa_ckpt, name.replace(" ", "_"), "--eval",
                *extra), f"test (SELSA) {name} T=21", 2)
        finally:
            restore()
    same = [torch.equal(a, b) for a, b in zip(inputs["selsa"],
                                               inputs["selsa u8"])]
    log(f"[cli] SELSA engine inputs of each video's first frame, uint8 "
        f"frames normalised on the card against host-normalised float "
        f"frames: bitwise equal {same}")
    if len(same) != len(firsts) or not all(same):
        raise RuntimeError("the u8 SELSA run's engine inputs differ from "
                           "the float run's")
    compare_cli("test (SELSA) --u8-transfer against float frames",
                runs["selsa u8 cli"]["results"],
                runs["selsa cli"]["results"], 1e-4 * 1280)
    shutil.rmtree(work, ignore_errors=True)
    return runs, {"cli exact T=21": bf16}


# the [train-cli] phase's synthetic training tree: 30 classes × 3 videos of
# 3 frames at 1280×720 (hnl=True samples 3 videos of the key class and 3 of
# each of 2 others), one portrait video of class 1 at 540×960, and DET
# images of 500×375; the frames link to a few distinct PPM files
TRAIN_CLI_HW, TRAIN_CLI_PORTRAIT_HW, TRAIN_CLI_DET_HW = ((720, 1280),
                                                         (960, 540),
                                                         (375, 500))
TRAIN_CLI_FRAMES, TRAIN_CLI_SCENES, TRAIN_CLI_DET = 3, 6, 6
TRAIN_CLI_VAL = (("val/ILSVRC2015_val_00000000", 14, (720, 1280)),
                 ("val/ILSVRC2015_val_00000001", 6, (960, 540)))
TRAIN_CLI_DEVICE = "cuda"
TRAIN_CLI_PROBE_FRAMES = 8


def write_train_tree(np, root):
    """The VID training tree, its class lists and a DET tree beside it;
    returns (VID imageset, DET imageset)."""
    import os
    import xml.etree.ElementTree as ET
    from hvrnet_tpu_torch.data.vid_dataset import VID_WNIDS
    rng = np.random.default_rng(5)

    def scene(h, w):
        s = rng.integers(0, 256, size=(h // 16 + 1, w // 16 + 1, 3),
                         dtype=np.uint8)
        return np.repeat(np.repeat(s, 16, axis=0), 16, axis=1)[:h, :w]

    def xml(path, w, h, objects):
        ann = ET.Element("annotation")
        size = ET.SubElement(ann, "size")
        ET.SubElement(size, "width").text = str(w)
        ET.SubElement(size, "height").text = str(h)
        for wnid, box in objects:
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = wnid
            bnd = ET.SubElement(obj, "bndbox")
            for key, val in zip(("xmin", "ymin", "xmax", "ymax"), box):
                ET.SubElement(bnd, key).text = str(val)
        path.parent.mkdir(parents=True, exist_ok=True)
        ET.ElementTree(ann).write(path)

    scenes = root / "scenes"
    scenes.mkdir(parents=True)
    h, w = TRAIN_CLI_HW
    for k in range(TRAIN_CLI_SCENES):
        write_ppm(scenes / f"{k}.ppm", scene(h, w))
    ph, pw = TRAIN_CLI_PORTRAIT_HW
    write_ppm(scenes / "portrait.ppm", scene(ph, pw))
    vid = root / "VID"
    lines, lists, k = [], {c: [] for c in range(1, 31)}, 0
    videos = [(c, f"train/ILSVRC2015_train_{c:02d}{v}", (h, w))
              for c in range(1, 31) for v in range(3)]
    videos.append((1, "train/ILSVRC2015_train_portrait", (ph, pw)))
    for c, vpath, (vh, vw) in videos:
        for i in range(TRAIN_CLI_FRAMES):
            image = vid / "JPEGImages" / vpath / f"{i:06d}.JPEG"
            image.parent.mkdir(parents=True, exist_ok=True)
            os.symlink(scenes / ("portrait.ppm" if vh > vw else
                                 f"{k % TRAIN_CLI_SCENES}.ppm"), image)
            x1 = vw // 6 + vw // 40 * (2 * i + k % 7)
            y1 = vh // 5 + vh // 40 * i
            xml(vid / "Annotations" / vpath / f"{i:06d}.xml", vw, vh,
                [(VID_WNIDS[c - 1], (x1, y1, x1 + vw // 3, y1 + vh // 3))])
            k += 1
        lines.append(f"{vpath} 1 {TRAIN_CLI_FRAMES // 2} {TRAIN_CLI_FRAMES}")
        lists[c].append(f"{vpath} 1")
    (vid / "ImageSets" / "VID").mkdir(parents=True)
    vid_set = vid / "ImageSets" / "VID_train_15frames.txt"
    vid_set.write_text("\n".join(lines) + "\n")
    for c, entries in lists.items():
        (vid / "ImageSets" / "VID" / f"train_{c}.txt").write_text(
            "\n".join(entries) + "\n")
    det = root / "DET"
    dh, dw = TRAIN_CLI_DET_HW
    ids = []
    for j in range(TRAIN_CLI_DET):
        image_id = f"train/ILSVRC2014_train_0000/ILSVRC2014_train_{j:08d}"
        image = det / "JPEGImages" / f"{image_id}.JPEG"
        image.parent.mkdir(parents=True, exist_ok=True)
        write_ppm(image, scene(dh, dw))
        xml(det / "Annotations" / f"{image_id}.xml", dw, dh,
            [(VID_WNIDS[j], (dw // 10 + j * dw // 60, dh // 10, dw * 3 // 5,
                             dh * 2 // 3))])
        ids.append(f"{image_id} 1")
    (det / "ImageSets").mkdir(parents=True)
    det_set = det / "ImageSets" / "DET_train_30classes.txt"
    det_set.write_text("\n".join(ids) + "\n")
    return vid_set, det_set


def train_cli_config(config, out, train, val_root, val_set):
    """The shipped config with ``data.train`` entries pointed at
    ``train`` ((imageset, root) per entry), ``data.val`` and ``data.test``
    at the val tree, and no ``load_from``."""
    text = Path(config).read_text()
    for i, (imageset, root) in enumerate(train):
        text += (f"\ndata['train'][{i}]['ann_file'] = {str(imageset)!r}\n"
                 f"data['train'][{i}]['img_prefix'] = {str(root)!r}\n")
    for split in ("val", "test"):
        text += (f"data[{split!r}]['ann_file'] = {str(val_set)!r}\n"
                 f"data[{split!r}]['img_prefix'] = {str(val_root)!r}\n")
    out.write_text(text + "load_from = None\n")
    return str(out)


class TrainCliTimer(StepTimer):
    """``StepTimer`` that also keeps each step's host times: the wait for
    its sample ("data") and the step's wall time from that wait's start to
    the end of its last stage (synchronised there), and the kernel's
    launches within each step."""

    def __init__(self, torch, stages):
        super().__init__(torch, stages)
        from hvrnet_tpu_torch.ops.attention import masked_attention
        self.kernel = masked_attention
        self.data_s, self.wall_s, self.step_launches = [], [], []

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        if name == self.stages[0]:
            self._launches = self.kernel.launches
        with super().phase(name):
            yield
        if name == "data":
            self._start = t0
            self.data_s.append(time.perf_counter() - t0)
        elif name == self.stages[-1]:
            self.torch.cuda.synchronize()
            self.wall_s.append(time.perf_counter() - self._start)
            self.step_launches.append(self.kernel.launches - self._launches)


def train_cli_run(torch, np, argv, tag, stages, per_step):
    """``tools/train.py``'s ``main`` in this process with the PPM decoder,
    the kernel's launch count set to 0 just before and read just after.
    Keeps the first sample trained on, each step's losses and the weights
    before the first step (after the frozen-BN calibration); checks finite
    losses and ``per_step`` launches in every step; prints the per-step
    wall, data and device times.  Returns the run's record."""
    from hvrnet_tpu_torch.engine import train as train_module
    from hvrnet_tpu_torch.ops.attention import masked_attention
    from hvrnet_tpu_torch.tools import train as train_cli
    timer = TrainCliTimer(torch, stages)
    kept = dict(losses=[], first=None, before=None)
    step = train_module.BaseTrainer.train_step

    def recording(self, sample, noise=None):
        if kept["before"] is None:
            kept["before"] = {k: t.clone() for k, t in
                              self.engine.model.state_dict().items()}
            kept["first"] = {k: v.copy() for k, v in sample.items()}
        logs = step(self, sample, noise)
        kept["losses"].append({k: float(v) for k, v in logs.items()
                               if k.startswith(("loss", "acc"))})
        return logs

    torch.cuda.synchronize()
    masked_attention.launches = 0
    train_module.BaseTrainer.train_step = recording
    try:
        run = train_cli.main(argv, imread=read_ppm, timer=timer)
    finally:
        train_module.BaseTrainer.train_step = step
    torch.cuda.synchronize()
    run.update(launches=masked_attention.launches, timer=timer, **kept)
    n = len(kept["losses"])
    bad = [lg for lg in kept["losses"]
           if not all(np.isfinite(v) for v in lg.values())]
    if n == 0 or bad:
        raise RuntimeError(f"{tag} {n} steps, non-finite losses in {bad}")
    if timer.step_launches != [per_step] * n:
        raise RuntimeError(f"{tag} kernel launches per step "
                           f"{timer.step_launches}, not {per_step}")
    spans = timer.spans
    for i in range(n):
        times = {s: spans[s][i][0].elapsed_time(spans[s][i][1])
                 for s in stages}
        device = spans[stages[0]][i][0].elapsed_time(spans[stages[-1]][i][1])
        log(f"{tag} step {i}: wall {1e3 * timer.wall_s[i]:.3f} ms, of it "
            f"waiting for the sample {1e3 * timer.data_s[i]:.3f} ms; "
            f"device step {device:.3f} ms (CUDA events), stages ms "
            + json.dumps({k: round(v, 3) for k, v in times.items()})
            + f"; peak {timer.peaks[i]:.2f} GiB; kernel launches "
            f"{timer.step_launches[i]}; losses "
            + json.dumps({k: round(v, 5) for k, v in
                          kept["losses"][i].items()}))
    wall, data = sum(timer.wall_s), sum(timer.data_s)
    device = [spans[stages[0]][i][0].elapsed_time(spans[stages[-1]][i][1])
              for i in range(n)]
    run.update(steps=n, wall_ms=1e3 * wall / n, data_ms=1e3 * data / n,
               step_ms=sum(device) / n, data_share=data / wall,
               peak_gib=max(timer.peaks))
    log(f"{tag} ({CARD}): {n} steps, wall {run['wall_ms']:.3f} ms/step "
        f"({1e3 / run['wall_ms']:.4f} steps/s), waiting for samples "
        f"{run['data_ms']:.3f} ms/step (the card idle on data "
        f"{run['data_share']:.3f} of the wall), device step "
        f"{run['step_ms']:.3f} ms (CUDA events); peak device memory "
        f"{run['peak_gib']:.2f} GiB; kernel launches "
        f"{masked_attention.launches} in the run, {per_step} in each step")
    return run


def train_transform_probe(np, config, n=TRAIN_CLI_PROBE_FRAMES):
    """Host ms per 1280×720 frame of each training transform alone, over
    the key frames of ``n`` videos, eagerly (decoded) with the dataset's
    own draws."""
    from hvrnet_tpu_torch.data.vid_dataset import build_dataset
    from hvrnet_tpu_torch.utils.config import Config, unwrap
    cfg = Config.fromfile(config)
    ds = build_dataset(unwrap(cfg.data.train), dict(seed=1, imread=read_ppm))
    vid = ds.datasets[0]
    ms = {}
    for i in range(n):
        r = dict(img_info=vid.img_infos[3 * i],
                 ann_info=vid.get_ann_info(3 * i))
        vid.pre_pipeline(r)
        for t in vid.pipeline.transforms:
            t0 = time.perf_counter()
            r = t(r)
            name = type(t).__name__
            ms[name] = ms.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
    ms = {k: v / n for k, v in ms.items()}
    h, w = TRAIN_CLI_HW
    log(f"[train-cli] ({CARD}) host ms per {w}x{h} frame of each training "
        f"transform alone (mean of {n}; LoadImageFromFile reads a binary "
        f"PPM): " + json.dumps({k: round(v, 3) for k, v in ms.items()})
        + f"; total {sum(ms.values()):.3f} ms")
    return ms


def phase_train_cli(torch, np):
    """``tools/train.py`` from a synthetic VID training tree on disk at
    full width, f32: HVRNet with ``--calibrate-bn --validate`` for 2 epochs
    of one step, resumed from ``latest.pth`` for a third, then SELSA on
    the VID + DET concatenation for 2 steps.  Checked: finite losses, 9 /
    2 launches per step, frozen tensors bitwise and trainable ones moved,
    the first sample bitwise the in-process ``train_batch_iterator``'s, the
    step carried on, the hook's mAP equal to ``hnl_test --eval`` on
    ``epoch_1.pth``.  Returns the runs for the kernels line."""
    import shutil
    from hvrnet_tpu_torch.data.vid_dataset import build_dataset
    from hvrnet_tpu_torch.engine.stream import (planned_batches,
                                                train_batch_iterator)
    from hvrnet_tpu_torch.tools import hnl_test
    from hvrnet_tpu_torch.utils.config import Config, unwrap
    work = ROOT / "build" / "chip_smoke_train_cli"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.time()
    vid_set, det_set = write_train_tree(np, work)
    val_set, _ = write_cli_tree(np, work / "val", TRAIN_CLI_VAL)
    hvr_cfg = train_cli_config(CONFIG, work / "hvrnet.py",
                               [(vid_set, work / "VID")], work / "val",
                               val_set)
    selsa_cfg = train_cli_config(SELSA_CONFIG, work / "selsa.py",
                                 [(vid_set, work / "VID"),
                                  (det_set, work / "DET")], work / "val",
                                 val_set)
    log(f"[train-cli] training tree of 91 videos × {TRAIN_CLI_FRAMES} frames "
        f"({TRAIN_CLI_SCENES} distinct 1280x720 PPM scenes and a portrait "
        f"540x960 one, linked), {TRAIN_CLI_DET} DET images, a val tree of "
        f"{sum(n for _, n, _ in TRAIN_CLI_VAL)} frames, in "
        f"{time.time() - t0:.1f} s")
    probe = train_transform_probe(np, hvr_cfg)
    canvas = [str(c) for c in CANVAS]
    common = ["--device", TRAIN_CLI_DEVICE, "--canvas", *canvas, "--seed",
              "0", "--max-steps-per-epoch", "2"]
    out = work / "hvrnet"
    one_step = ["--max-steps-per-epoch", "1"]     # HVRNet's steps, ~13 s
    hvr = train_cli_run(torch, np, [hvr_cfg, "--work-dir", str(out),
                                    "--total-epochs", "2", "--calibrate-bn",
                                    "--validate", *common, *one_step],
                        "[train-cli] hvrnet", TRAIN_STAGES, 9)
    check_train_weights(torch, hvr["engine"], hvr["before"],
                        "[train-cli] hvrnet", ("shared_head.", "bbox_head."))
    maps = [json.loads(line) for line in
            (out / "train_log.jsonl").read_text().splitlines()]
    maps = [m["mAP"] for m in maps if "mAP" in m]

    # the first sample trained on, against train_batch_iterator in this
    # process (the calibration's probe planned first, as a rank above 0
    # plans it: its draws, no decode)
    cfg = Config.fromfile(hvr_cfg)
    dataset = build_dataset(unwrap(cfg.data.train),
                            dict(seed=0, imread=read_ppm))
    plans, plan = [0], dataset.plan

    def counted(idx):
        plans[0] += 1
        return plan(idx)

    dataset.plan = counted
    next(planned_batches(dataset, CANVAS, seed=0))
    probe_plans = plans[0]
    t0 = time.perf_counter()
    first = next(train_batch_iterator(dataset, CANVAS, seed=0))
    loader_s = time.perf_counter() - t0
    same = all(np.array_equal(first[k], hvr["first"][k]) for k in first)
    log(f"[train-cli] ({CARD}) loader in this process: the probe planned "
        f"from {probe_plans} items, then the first kept 27-frame sample "
        f"from {plans[0] - probe_plans} planned (the others skipped for a "
        f"frame off the {CANVAS[0]}x{CANVAS[1]} canvas) in "
        f"{1e3 * loader_s:.3f} ms; the first sample the CLI trained on "
        f"bitwise equal to train_batch_iterator's: {same}")
    if not same:
        raise RuntimeError("the CLI's first sample differs from "
                           "train_batch_iterator's")
    del first, dataset

    # the hook against hnl_test on the checkpoints, same seed and window
    hnl = []
    for epoch in (1, 2):
        hnl.append(hnl_test.main(
            [hvr_cfg, str(out / f"epoch_{epoch}.pth"), "--device",
             TRAIN_CLI_DEVICE, "--window", "21", "--pre-padding", "repeat",
             "--seed", "0", "--eval", "--out", str(work / f"hnl{epoch}.pkl"),
             "--tmpdir", str(work / f"hnl{epoch}")], imread=read_ppm))
        del hnl[-1]["runner"]
    log(f"[train-cli] the hook's mAP per epoch {maps}; hnl_test --eval on "
        f"epoch_1.pth, epoch_2.pth: {[r['map'] for r in hnl]}")
    if maps != [r["map"] for r in hnl]:
        raise RuntimeError("the hook's mAP differs from hnl_test's")
    compare_cli("[train-cli] the hook's last detections against hnl_test "
                "on epoch_2.pth", hvr["eval_hook"].results,
                hnl[1]["results"], 1e-4 * 1280)

    # a resume from latest.pth carries the step on for one more epoch
    resumed = train_cli_run(torch, np, [hvr_cfg, "--work-dir", str(out),
                                        "--total-epochs", "3",
                                        "--resume-from",
                                        str(out / "latest.pth"), *common,
                                        *one_step],
                            "[train-cli] hvrnet resumed", TRAIN_STAGES, 9)
    log(f"[train-cli] resumed from latest.pth (step {hvr['trainer'].step}): "
        f"step {resumed['trainer'].step} after one more epoch")
    if not (hvr["trainer"].step == 2 and resumed["trainer"].step == 3):
        raise RuntimeError("the resumed run did not carry the step on")
    numbers = ("launches", "steps", "wall_ms", "data_ms", "step_ms",
               "data_share", "peak_gib")
    summary = {"train-cli hvrnet": {k: hvr[k] for k in numbers},
               "train-cli hvrnet resumed": {k: resumed[k] for k in numbers}}
    del hvr, resumed, hnl
    torch.cuda.empty_cache()

    selsa = train_cli_run(torch, np, [selsa_cfg, "--work-dir",
                                      str(work / "selsa"), "--total-epochs",
                                      "1", "--calibrate-bn", *common],
                          "[train-cli] selsa", SELSA_TRAIN_STAGES, 2)
    check_train_weights(torch, selsa["engine"], selsa["before"],
                        "[train-cli] selsa",
                        ("backbone.layer2.", "backbone.layer3.", "rpn_head.",
                         "shared_head.", "bbox_head."))
    kinds = [type(d).__name__ for d in selsa["dataset"].datasets]
    if kinds != ["VIDSeqDataset", "DETSeqDataset"]:
        raise RuntimeError(f"[train-cli] SELSA trained on {kinds}")
    summary["train-cli selsa"] = {k: selsa[k] for k in numbers}
    del selsa
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return summary, probe


# [lanes]: B = 4 lockstep streams over landscape videos of unequal lengths
# (12–30 frames), so that streams end, take the next video, and one runs
# dry; the kernel's lane shapes; the lockstep step at B = 1, 2, 4, 8
LANES_B = 4
LANES_SWEEP = (1, 2, 4, 8)
LANES_VIDEOS = tuple((f"val/ILSVRC2015_val_{i:08d}", n, (720, 1280))
                     for i, n in enumerate((30, 12, 21, 16, 25)))
# B videos long enough that a lockstep step rarely runs a padded push:
# ``test --batched 4`` against the sequential ``test`` from disk
LANES_LONG = tuple((f"val/ILSVRC2015_val_{i:08d}", 32, (720, 1280))
                   for i in range(LANES_B))
LANES_ATTN = ((6300, 6300, "lanes NL1/NL3"), (300, 6300, "lanes NL2/NL4"))
# the batched backbone's outputs of each lane against the same frame's
# alone, by depth (the stem conv, layer1-3 = C4, then C5 and the RPN
# maps), as |Δ|₂ / |alone|₂.  The batched convolutions round differently
# (cuDNN picks its algorithms by batch size) and the seeded random
# weights amplify a rounding ~25× per stage (f32 layer2 2e-6 → C5 1.7e-4,
# bf16 6.5e-3 → 0.36; a lane holding another lane's frame is 0.7-1.4 off
# at every depth), so f32 is held at every depth and bf16 up to layer2,
# where its rounding is not yet amplified past a lane fault's size
LANES_MAP_DEPTHS = ("conv1", "layer1", "layer2", "layer3", "c5", "rpn cls",
                    "rpn reg")
LANES_MAP_LIMIT = {"float32": (1e-3, LANES_MAP_DEPTHS),
                   "bfloat16": (0.05, LANES_MAP_DEPTHS[:3])}


def lanes_attention(torch, shapes=None, lanes=None, tag="[lanes]"):
    """The kernel on B lanes (``LANES_B`` at ``LANES_ATTN``, the exact
    ring's shapes, unless given; each lane its own keys and mask; lane 1
    with half its keys masked) against its plain version, f32 and bf16 at
    their limits; a 1-lane call bitwise equal to the 2-D call; times of the
    lane call, of B separate 2-D calls, of the plain version and of SDPA on
    the same batched shapes; the bound B × one call's."""
    import torch.nn.functional as F
    from hvrnet_tpu_torch.ops.attention import (NEG_INF, attention_plain,
                                                bf16_agreement,
                                                masked_attention, plan)
    gen = torch.Generator(device="cuda").manual_seed(1)
    scale, B = D ** -0.5, lanes or LANES_B
    cases = []
    for nq, nk, label in shapes or LANES_ATTN:
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            q, k, v = (torch.randn(B, n, D, device="cuda",
                                   generator=gen).to(dt)
                       for n in (nq, nk, nk))
            live = torch.rand(B, nk, device="cuda", generator=gen) >= 0.1
            live[1, nk // 2:] = False
            bias = torch.where(live, 0.0, NEG_INF).float()
            got = masked_attention(q, k, v, bias, scale)
            case = dict(label=label, lanes=B, nq=nq, nk=nk,
                        dtype=str(dt).replace("torch.", ""),
                        masking="10% masked, lane 1 half")
            if f32:
                want = attention_plain(q, k, v, bias, scale)
                err = (got - want).abs().max().item()
                rel = err / want.abs().max().item()
                case.update(max_abs_err=err, tol=1e-4, rel_err=rel,
                            rel_tol=1e-5)
                ok = err <= 1e-4 and rel <= 1e-5
                del want
            else:
                case.update(bf16_agreement(got, q, k, v, bias, scale))
                ok = (case["worst"] <= 1 and case["rms"] <= 1
                      and case["rounds"] >= 0.1)
            one = masked_attention(q[:1], k[:1], v[:1], bias[:1], scale)[0]
            case["one_lane_bitwise_2d"] = bool(torch.equal(
                one, masked_attention(q[0], k[0], v[0], bias[0], scale)))
            case["bitwise_repeat"] = bool(torch.equal(
                got, masked_attention(q, k, v, bias, scale)))
            ok = (ok and case["one_lane_bitwise_2d"] and case["bitwise_repeat"]
                  and bool(torch.isfinite(got).all()))
            sep = torch.stack([masked_attention(q[b], k[b], v[b], bias[b],
                                                scale) for b in range(B)])
            case["vs_separate_max_abs"] = (got - sep).abs().max().item()
            del sep, one
            t = dict(ms=cuda_ms(torch, lambda: masked_attention(
                q, k, v, bias, scale)))
            t["separate_ms"] = cuda_ms(torch, lambda: [masked_attention(
                q[b], k[b], v[b], bias[b], scale) for b in range(B)])
            call = plan(q, k, v, bias, scale)
            call.run()
            t["phases_ms"] = {name: cuda_ms(torch, fn)
                              for name, fn in call.phases}
            t["nsplit"] = call.nsplit
            del call
            t["plain_ms"] = cuda_ms(torch, lambda: attention_plain(
                q, k, v, bias, scale))
            mask4 = bias[:, None, None, :].to(dt)
            t["library_ms"] = cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], attn_mask=mask4,
                    scale=scale))
            bound, t["bound_by"] = attention_bound_ms(
                nq, nk, 4 if f32 else 2,
                PEAK_TF32_FLOPS if f32 else PEAK_BF16_FLOPS,
                products=3 if f32 else 1)
            t["bound_ms"] = B * bound
            t["bound_fraction"] = t["bound_ms"] / t["ms"]
            case.update(t)
            log(f"{tag} attention ({CARD}) " + json.dumps(case))
            if not ok:
                raise RuntimeError(f"masked_attention on lanes disagrees "
                                   f"with its plain version: {case}")
            cases.append(case)
            del got, q, k, v
    torch.cuda.empty_cache()
    return cases


def lanes_engines(torch, hvr_weights, selsa_weights):
    """The f32 engines' seeded, calibrated weights on fresh engines: HVRNet
    f32 and bf16, SELSA f32 (the bf16 one with its head pre-cast)."""
    from hvrnet_tpu_torch.engine import HNMBRCNN, SelsaRCNN
    from hvrnet_tpu_torch.utils.config import Config, unwrap
    out = {}
    for name, engine_cls, config, weights, dtype in (
            ("hvrnet", HNMBRCNN, CONFIG, hvr_weights, torch.float32),
            ("hvrnet bf16", HNMBRCNN, CONFIG, hvr_weights, torch.bfloat16),
            ("selsa", SelsaRCNN, SELSA_CONFIG, selsa_weights,
             torch.float32)):
        cfg = Config.fromfile(str(config))
        engine = engine_cls(unwrap(cfg.model), unwrap(cfg.test_cfg),
                            device="cuda", dtype=dtype)
        engine.load_state_dict(weights)
        engine.cast_head_params_bf16()
        out[name] = engine
    return out


def lanes_dataset(config, seed=0):
    from hvrnet_tpu_torch.tools.test import test_dataset
    from hvrnet_tpu_torch.utils.config import Config
    return test_dataset(Config.fromfile(config), 1, seed, read_ppm)


def lanes_run(torch, np, engine, config, tag, per_detect, n_frames,
              batch=LANES_B, record=None):
    """The lockstep runner (``batch`` streams, 4 loader threads) over the
    [lanes] tree with the kernel's launch count set to 0 just before and
    read just after: every frame emitted once with a 30-class result and
    finite boxes, ``per_detect`` launches per lockstep detection.  With
    ``record`` (a dict), each lane's frame caches and windows go into it
    (``lanes_recorded``)."""
    from hvrnet_tpu_torch.engine import BatchedSlidingWindowRunner
    from hvrnet_tpu_torch.ops.attention import masked_attention
    emitted = []
    timer = CliTimer(torch)
    runner = BatchedSlidingWindowRunner(engine, batch=batch,
                                        loader_workers=4, timer=timer,
                                        progress_hook=emitted.append)
    ds = lanes_dataset(config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    masked_attention.launches = 0
    t0 = time.perf_counter()
    with (lanes_recorded(torch, engine, record) if record is not None
          else contextlib.nullcontext()):
        results = runner.run(ds, max_long=CANVAS[1], max_short=CANVAS[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = dict(results=results, launches=masked_attention.launches,
               steps=runner.steps, detects=runner.detects, wall_s=wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if sum(emitted) != n_frames or any(r is None for r in results):
        raise RuntimeError(f"{tag} emitted {sum(emitted)} of {n_frames} "
                           f"frames")
    for i, res in enumerate(results):
        if len(res) != 30 or not all(d.shape[1:] == (5,)
                                     and np.isfinite(d).all() for d in res):
            raise RuntimeError(f"{tag} frame {i}: bad result")
    if run["launches"] != per_detect * run["detects"]:
        raise RuntimeError(f"{tag} launched the kernel {run['launches']} "
                           f"times in {run['detects']} lockstep detections, "
                           f"not {per_detect} per detection")
    log(f"[lanes] {tag} ({CARD}): {n_frames} frames of {len(LANES_VIDEOS)} "
        f"videos on {batch} streams, every frame emitted once with a "
        f"30-class result; {run['steps']} lockstep steps, {run['detects']} "
        f"with a detection; kernel launches {run['launches']} "
        f"({per_detect} per lockstep detection); frame program "
        f"{timer.mean_ms('frame_features'):.3f} ms/step, window detect "
        f"{timer.mean_ms('window_detect'):.3f} ms/step (CUDA events); "
        f"{n_frames / wall:.3f} frames/s over {wall:.3f} s, loading "
        f"{timer.host_s('load') / wall:.3f} of the wall; peak "
        f"{run['peak_gib']:.2f} GiB")
    return run


def lanes_sequential(engine, config):
    """The sequential runner over the threaded stream of the [lanes] tree
    (its shuffles drawn before any frame, as the lockstep runner draws
    them, so every video in the same order)."""
    from hvrnet_tpu_torch.engine import SlidingWindowRunner
    from hvrnet_tpu_torch.engine.stream import parallel_test_frame_stream
    ds = lanes_dataset(config)
    return SlidingWindowRunner(engine).run(parallel_test_frame_stream(
        ds, workers=4, max_long=CANVAS[1], max_short=CANVAS[0]), len(ds))


def frame_key(img):
    """The bytes of a frame's canvas, hashed: which frame a lane loaded."""
    import hashlib
    import numpy as np
    if hasattr(img, "cpu"):
        img = img.cpu().numpy()
    return hashlib.sha1(np.ascontiguousarray(img).tobytes()).hexdigest()


def window_key(fc1, masks):
    """A fingerprint of one lane's window (oldest frame first): every 4099th
    cached value and the whole mask; candidates are compared in full."""
    import hashlib
    import torch
    sample = torch.cat([fc1.reshape(-1)[::4099].float(),
                        masks.reshape(-1).float()])
    return hashlib.sha1(sample.cpu().numpy().tobytes()).hexdigest()


@contextlib.contextmanager
def lanes_recorded(torch, engine, record):
    """Within the block, each lane's frame caches from the batched frame
    program (by its canvas's bytes) and each lane's window with the
    lockstep head's outputs on it go into ``record``."""
    feats_of, heads = record.setdefault("feats", {}), record.setdefault(
        "heads", {})
    program, window = engine.frame_features_batched, engine._window_lanes

    def frame_features_batched(imgs, img_shapes, pad_shapes):
        out = program(imgs, img_shapes, pad_shapes)
        for b in range(len(img_shapes)):
            feats_of[frame_key(imgs[b])] = {k: v[b] for k, v in out.items()}
        return out

    def window_lanes(fc1_stack, masks, passes=None):
        pairs = window(fc1_stack, masks, passes)
        for b in range(fc1_stack.shape[0]):
            heads.setdefault(window_key(fc1_stack[b], masks[b]),
                             []).append((fc1_stack[b].clone(),
                                         masks[b].clone(),
                                         [(c[b].clone(), r[b].clone())
                                          for c, r in pairs]))
        return pairs

    engine.frame_features_batched = frame_features_batched
    engine._window_lanes = window_lanes
    try:
        yield record
    finally:
        del engine.frame_features_batched, engine._window_lanes


def same_results(a, b):
    """Two runs' per-frame, per-class detections bit for bit."""
    return len(a) == len(b) and all(
        len(fa) == len(fb) and all(x.tobytes() == y.tobytes()
                                   for x, y in zip(fa, fb))
        for fa, fb in zip(a, b))


def lanes_fed(torch, engine, config, record, lockstep, tag):
    """The sequential runner over the same videos, fed every frame's caches
    as the lockstep run's batched frame program made them (found by the
    canvas's bytes): this takes the backbone's batched rounding out, so
    what is left is the ring, the head and the decode of each lane.
    Held: every frame the sequential runner loads was loaded by a lane;
    every window its exact ring detects is, bit for bit, a window a lane
    detected (the lane's ring and its roll); the sequential head on it
    against that lane's head outputs, f32 within 1e-4 of max(|logit|, 1)
    (the head checks' kernel-vs-plain limit), bf16 within the JAX
    package's bf16 budget (0.05, the [bf16] phase's); and, with the lane's
    head outputs put in the sequential decode, every frame's detections
    bit for bit the lockstep run's (decode and class-wise NMS exact per
    lane)."""
    f32 = engine.dtype == torch.float32
    heads, worst = record["heads"], [0.0, 0]

    def frame_features(img, img_shape, pad_shape):
        key = frame_key(img)
        if key not in record["feats"]:
            raise RuntimeError(f"{tag}: the sequential runner loaded a "
                               f"frame no lockstep lane loaded")
        return record["feats"][key]

    window = engine._window_lanes

    def window_lanes(fc1_stack, masks, passes=None):
        own = window(fc1_stack, masks, passes)
        for fc1, mask, pairs in heads.get(
                window_key(fc1_stack[0], masks[0]), ()):
            if torch.equal(fc1, fc1_stack[0]) and torch.equal(mask, masks[0]):
                got = ([c for c, _ in pairs], [r for _, r in pairs])
                want = ([c[0] for c, _ in own], [r[0] for _, r in own])
                err = (logit_err(got, want) if f32
                       else max(head_budget(got, want)))
                worst[0] = max(worst[0], err)
                worst[1] += 1
                return [(c[None], r[None]) for c, r in pairs]
        raise RuntimeError(f"{tag}: the sequential ring detected a window "
                           f"no lockstep lane detected")

    engine.frame_features, engine._window_lanes = frame_features, window_lanes
    try:
        seq = lanes_sequential(engine, config)
    finally:
        del engine.frame_features, engine._window_lanes
    same = same_results(lockstep, seq)
    limit = 1e-4 if f32 else BF16_CLS_BUDGET
    log(f"[lanes] {tag} against the sequential runner fed the lanes' frame "
        f"caches: every loaded frame and all {worst[1]} detected windows "
        f"found bit for bit among the lanes'; the sequential head against "
        f"the lanes' {worst[0]:.3g} (limit {limit}); with the lanes' head "
        f"outputs every frame's detections bitwise equal: {same}")
    if not (same and worst[0] <= limit and worst[1] == len(seq)):
        raise RuntimeError(f"{tag}: the lanes disagree with the sequential "
                           f"runner fed the same frame caches")


def backbone_depths(torch, engine, imgs, img_shapes):
    """The backbone's outputs by ``LANES_MAP_DEPTHS`` for (B, H, W, 3)
    canvases, and the frame program's maps (c5, RPN cls, RPN reg)."""
    out = {}
    hooks = [getattr(engine.model.backbone, name).register_forward_hook(
        lambda mod, args, res, name=name: out.__setitem__(name, res))
        for name in LANES_MAP_DEPTHS[:4]]
    try:
        maps = engine.backbone_maps(imgs, img_shapes)
    finally:
        for h in hooks:
            h.remove()
    out.update(zip(LANES_MAP_DEPTHS[4:], maps))
    return out, maps


def lanes_frame_check(torch, np, engine, tag, ref=None):
    """The batched frame program on 4 frames of 4 different scenes against
    one frame at a time, held: each lane's backbone output at every depth
    of ``LANES_MAP_DEPTHS`` against its frame alone (|Δ|₂ / |alone|₂) within
    ``LANES_MAP_LIMIT`` at the depths it names, and its distance to each
    other lane's frame over 10× that limit there (a lane holding the wrong
    frame fails); with ``ref`` (the f32 engine's distances) the growth of
    the distance per stage printed beside f32's, the yardstick of the
    depths not held; then each lane's post (proposals, RoIAlign, fc_new_1)
    of the batched maps bit for bit the single-frame post on that lane's
    maps.  Returns the own-frame distances by depth."""
    frames = [next(synthetic_video(np, 1, seed=20 + b))
              for b in range(LANES_B)]
    imgs = np.concatenate([f["img"] for f in frames])
    ishs = np.stack([f["img_shape"] for f in frames])
    pshs = np.stack([f["pad_shape"] for f in frames])
    limit, held = LANES_MAP_LIMIT[str(engine.dtype)[6:]]

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).norm() / b.norm()).item()

    with torch.no_grad():
        batched, maps = backbone_depths(torch, engine, imgs, ishs)
        alone = [backbone_depths(torch, engine, f["img"], f["img_shape"])[0]
                 for f in frames]
        own = {d: max(rel(batched[d][b], alone[b][d][0])
                      for b in range(LANES_B)) for d in LANES_MAP_DEPTHS}
        other = {d: min(rel(batched[d][b], alone[a][d][0])
                        for b in range(LANES_B) for a in range(LANES_B)
                        if a != b) for d in LANES_MAP_DEPTHS}
        post = engine.frame_post_batched(*maps, ishs, pshs)
        bitwise = all(
            all(torch.equal(post[k][b], v) for k, v in engine.frame_post(
                *(m[b:b + 1] for m in maps), ishs[b], pshs[b]).items())
            for b in range(LANES_B))
    log(f"[lanes] {tag} batched frame program on {LANES_B} scenes against "
        f"one frame at a time, |Δ|₂/|alone|₂ by depth, each lane against "
        f"its own frame "
        + json.dumps({d: float(f"{v:.3g}") for d, v in own.items()})
        + f" (limit {limit} to {held[-1]}), against the nearest other "
        f"lane's frame "
        + json.dumps({d: float(f"{v:.3g}") for d, v in other.items()})
        + f"; post of each lane's batched maps bitwise the single-frame "
        f"post: {bitwise}")
    if ref is not None:
        def growth(dist):
            return {d: float(f"{dist[d] / dist[p]:.3g}") for p, d in zip(
                LANES_MAP_DEPTHS[1:5], LANES_MAP_DEPTHS[2:5]) if dist[p] > 0}
        log(f"[lanes] {tag} own-frame distance growth per stage "
            + json.dumps(growth(own)) + ", f32 " + json.dumps(growth(ref)))
    if not (bitwise and all(own[d] <= limit and other[d] > 10 * limit
                            for d in held)):
        raise RuntimeError(f"{tag}: the batched frame program's lanes "
                           f"differ from one frame at a time")
    return own


def lanes_step_times(torch, np, engine, tag, per_detect):
    """One lockstep step at B = 1, 2, 4, 8 on synthetic frames (ring
    full), each stage alone by CUDA events (3 calls after 1): backbone
    (C4, C5, RPN maps of B frames), post (proposals of every lane and one
    NMS fixpoint, RoIAlign and fc_new_1 per lane), push, detect (the
    window head over B lanes) and decode + NMS (every lane's decode, one
    class-wise NMS fixpoint); the whole step; peak memory; the kernel's
    launches per detection.  Beside them the sequential step (one frame
    program and one ring step)."""
    from hvrnet_tpu_torch.ops.attention import masked_attention
    kd = engine.key_dim
    frames = list(synthetic_video(np, max(LANES_SWEEP), seed=5))
    f0 = frames[0]
    feats0 = engine.frame_features(f0["img"], f0["img_shape"],
                                   f0["pad_shape"])
    seq_ring = engine.ring_reset(int(feats0["fc1"].shape[-1]))
    for _ in range(engine.window):
        engine.ring_push(seq_ring, feats0)
    seq_ms = cuda_ms(torch, lambda: engine.ring_step(
        seq_ring, engine.frame_features(f0["img"], f0["img_shape"],
                                        f0["pad_shape"]),
        f0["img_shape"], f0["scale_factor"], branch=-1), iters=3, warmup=1)
    del seq_ring
    log(f"[lanes] {tag} sequential step ({CARD}): {seq_ms:.3f} ms/frame, "
        f"{1e3 / seq_ms:.3f} frames/s")
    out = {}
    for B in LANES_SWEEP:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        imgs = np.concatenate([f["img"] for f in frames[:B]])
        ishs = np.stack([f["img_shape"] for f in frames[:B]])
        pshs = np.stack([f["pad_shape"] for f in frames[:B]])
        sfs = np.stack([f["scale_factor"] for f in frames[:B]])
        feats = engine.frame_features_batched(imgs, ishs, pshs)
        ring = engine.ring_reset_batched(B, int(feats["fc1"].shape[-1]))
        engine.ring_push_batched(ring, feats, np.ones(B, bool))
        with torch.no_grad():
            maps = engine.backbone_maps(imgs, ishs)
            fc1s = ring["fc1"]
            pairs = engine._window_lanes(fc1s, ring["masks"])
        masked_attention.launches = 0
        engine.ring_detect_batched(ring, ishs, sfs, branch=lanes_branch(
            engine))
        launches = masked_attention.launches
        if launches != per_detect:
            raise RuntimeError(f"{tag} B={B}: {launches} kernel launches "
                               f"per lockstep detection, not {per_detect}")
        if B == LANES_B:
            lanes_head_check(torch, engine, ring, pairs, tag)
        no_reset = np.zeros(B, bool)
        with torch.no_grad():
            stages = {
                "backbone": lambda: engine.backbone_maps(imgs, ishs),
                "post": lambda: engine.frame_post_batched(*maps, ishs, pshs),
                "push": lambda: engine.ring_push_batched(ring, feats,
                                                         no_reset),
                "detect": lambda: engine._window_lanes(fc1s, ring["masks"]),
                "decode + NMS": lambda: engine._decode_lanes(
                    pairs[-1:], ring["boxes"][:, kd], ishs, sfs,
                    ring["masks"][:, kd]),
            }
            ms = {name: cuda_ms(torch, fn, iters=3, warmup=1)
                  for name, fn in stages.items()}

            def step():
                f = engine.frame_features_batched(imgs, ishs, pshs)
                engine.ring_push_batched(ring, f, no_reset)
                return engine.ring_detect_batched(
                    ring, ishs, sfs, branch=lanes_branch(engine))
            ms["step"] = cuda_ms(torch, step, iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[B] = dict(ms=ms, fps=1e3 * B / ms["step"], peak_gib=peak,
                      launches=launches)
        log(f"[lanes] {tag} B={B} ({CARD}): step {ms['step']:.3f} ms, "
            f"{out[B]['fps']:.3f} frames/s (sequential "
            f"{1e3 / seq_ms:.3f}); stages alone, ms: "
            + json.dumps({k: round(v, 3) for k, v in ms.items()
                          if k != "step"})
            + f"; {launches} kernel launches per lockstep detection; peak "
            f"{peak:.2f} GiB")
        del maps, feats, ring, pairs, fc1s
    out["sequential_ms"] = seq_ms
    return out


def lanes_head_check(torch, engine, ring, pairs, tag):
    """The window head over B lanes (``pairs``, one lockstep detection's
    head outputs) against its 2-D call on each lane's window: f32 within
    1e-4 of max(|logit|, 1) (the kernel-vs-plain limit of the head checks),
    bf16 within the JAX package's bf16 budget (0.05)."""
    T, P, kd = engine.window, engine.proposal_num, engine.key_dim
    head = engine.model.bbox_head
    f32 = engine.dtype == torch.float32
    worst = 0.0
    with torch.no_grad():
        for b in range(ring["fc1"].shape[0]):
            want = head_outputs(head.forward_fc1(
                ring["fc1"][b].reshape(T * P, -1), kd * P, P,
                ring["masks"][b].reshape(T * P)))
            got = ([cls[b] for cls, _ in pairs], [reg[b] for _, reg in pairs])
            err = (logit_err(got, want) if f32
                   else max(head_budget(got, want)))
            worst = max(worst, err)
    limit = 1e-4 if f32 else 0.05
    log(f"[lanes] {tag} window head on {ring['fc1'].shape[0]} lanes against "
        f"its 2-D call per lane: {worst:.3g} (limit {limit})")
    if not worst <= limit:
        raise RuntimeError(f"{tag}: the window head's lanes differ from "
                           f"its 2-D calls")


def lanes_branch(engine):
    """The branch the runners keep: the final one of a multi-branch head."""
    return -1 if getattr(engine, "multi_branch", False) else None


def lanes_busy(torch, np, engine, tag):
    """The batched frame program at B = 4: device time (``torch.profiler``)
    against its CUDA-event span, backbone alone and whole."""
    frames = list(synthetic_video(np, LANES_B, seed=6))
    imgs = np.concatenate([f["img"] for f in frames])
    ishs = np.stack([f["img_shape"] for f in frames])
    pshs = np.stack([f["pad_shape"] for f in frames])
    for name, fn in (
            ("backbone: C4, C5, RPN maps of 4 frames",
             lambda: engine.backbone_maps(imgs, ishs)),
            ("frame_features_batched, 4 frames",
             lambda: engine.frame_features_batched(imgs, ishs, pshs))):
        span = cuda_ms(torch, fn, iters=3, warmup=1)
        busy = device_ms(torch, fn)
        idle = (f"idle {1 - busy / span:.2f}" if busy > 0
                else "device time not traced")
        log(f"{tag} {name}: device {busy:.3f} ms of a {span:.3f} ms span, "
            f"{idle}")


def phase_lanes(torch, np, hvr_weights, selsa_weights, cli_runs):
    """The lockstep multi-stream runner on the card: the kernel on lanes;
    HVRNet (f32, bf16) and SELSA (f32) at full width, B = 4 streams over
    the [lanes] tree against the sequential runner fed the lanes' frame
    caches (``lanes_fed``, on a second run that records them), the
    batched frame program against one frame at a time
    (``lanes_frame_check``); the lockstep step at B = 1, 2, 4, 8 with the
    window head's lanes against its 2-D calls; the batched bf16 frame program's
    idle share; and ``test --batched 4`` from disk, on the [lanes] tree
    and on 4 long videos against the sequential ``test``.  Returns the
    cases and the runs whose launches the kernels line counts."""
    import shutil
    cases = lanes_attention(torch)
    work = ROOT / "build" / "chip_smoke_lanes"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "VID"
    t0 = time.time()
    imageset, _ = write_cli_tree(np, root, LANES_VIDEOS)
    n_frames = sum(n for _, n, _ in LANES_VIDEOS)
    configs = {"hvrnet": cli_config(CONFIG, root, imageset,
                                    work / "hvrnet.py"),
               "selsa": cli_config(SELSA_CONFIG, root, imageset,
                                   work / "selsa.py")}
    h, w = LANES_VIDEOS[0][2]
    log(f"[lanes] tree of {len(LANES_VIDEOS)} landscape videos, "
        f"{n_frames} PPM frames at {w}x{h} ("
        + ", ".join(str(n) for _, n, _ in LANES_VIDEOS)
        + f" frames) in {time.time() - t0:.1f} s")
    engines = lanes_engines(torch, hvr_weights, selsa_weights)
    runs, runs16, distances = {}, {}, {}
    for name, per_detect in (("hvrnet", 4), ("hvrnet bf16", 4),
                             ("selsa", 2)):
        engine = engines[name]
        warm_up(torch, np, engine)
        config = configs[name.split()[0]]
        run = lanes_run(torch, np, engine, config, f"{name} B={LANES_B}",
                        per_detect, n_frames)
        # the checks' run: the same again with each lane's caches and
        # windows recorded (kept apart from the timed run, whose wall time
        # and peak memory they would change)
        record = {}
        again = lanes_run(torch, np, engine, config,
                          f"{name} B={LANES_B} recorded", per_detect,
                          n_frames, record=record)
        if not same_results(run["results"], again["results"]):
            raise RuntimeError(f"{name}: two lockstep runs over the same "
                               f"videos differ")
        lanes_fed(torch, engine, config, record, again["results"],
                  f"{name} B={LANES_B}")
        del record, again
        distances[name] = lanes_frame_check(
            torch, np, engine, name,
            distances["hvrnet"] if name == "hvrnet bf16" else None)
        key = f"lanes {name.split()[0]} B={LANES_B}"
        (runs if engine.dtype == torch.float32 else runs16)[key] = run
        run["sweep"] = lanes_step_times(torch, np, engine, name, per_detect)
        if name == "hvrnet bf16":
            lanes_busy(torch, np, engine, "[busy] lanes bf16")
    del engines
    torch.cuda.empty_cache()
    runs.update(lanes_cli(torch, np, work, configs["hvrnet"], hvr_weights,
                          n_frames, cli_runs))
    shutil.rmtree(work, ignore_errors=True)
    return cases, runs, runs16


def lanes_cli(torch, np, work, config, weights, n_frames, cli_runs):
    """``test --batched 4 --loader-workers 4 --u8-transfer`` from disk on
    the [lanes] tree (landscape only) with HVRNet's weights as a ``.pth``,
    against ``--batched 4`` with no loader threads: the same results, bit
    for bit; frames/s beside the sequential ``hnl_test`` of [cli]."""
    ckpt = work / "hvrnet.pth"
    torch.save({"state_dict": weights}, ckpt)

    def argv(name, *extra):
        return [config, str(ckpt), "--out", str(work / f"{name}.pkl"),
                "--tmpdir", str(work / name), "--batched", str(LANES_B),
                *extra]

    fast = cli_run(torch, np, "test", argv(
        "batched_w4_u8", "--loader-workers", "4", "--u8-transfer"),
        "test --batched 4 --loader-workers 4 --u8-transfer", 4)
    plain = cli_run(torch, np, "test", argv(
        "batched_w0", "--loader-workers", "0"), "test --batched 4", 4)
    same = compare_cli("test --batched 4 --loader-workers 4 --u8-transfer "
                       "against --batched 4 with no loader threads",
                       fast["results"], plain["results"], 1e-4 * 1280)
    if not same:
        raise RuntimeError("--loader-workers 4 --u8-transfer changed the "
                           "lockstep results")
    seq = cli_runs["cli exact T=21"]
    log(f"[cli] ({CARD}) test --batched 4 --loader-workers 4 --u8-transfer "
        f"{fast['fps']:.3f} frames/s, --batched 4 {plain['fps']:.3f}, "
        f"beside the sequential hnl_test exact T=21 {seq['fps']:.3f} "
        f"(its tree; {n_frames} frames here)")
    long_runs = lanes_long(torch, np, work, ckpt)
    return {"cli batched 4 workers 4 u8": fast, "cli batched 4": plain,
            **long_runs}


def lanes_long(torch, np, work, ckpt):
    """``test --batched 4 --loader-workers 4 --u8-transfer`` against the
    sequential ``test --loader-workers 4 --u8-transfer`` from disk on
    ``LANES_LONG`` (4 videos of 32 frames: every stream busy to the end,
    10 padded pushes per 32 frames): frames/s of both, and the frame
    programs per emitted frame."""
    import shutil
    root = work / "LONG"
    t0 = time.time()
    imageset, _ = write_cli_tree(np, root, LANES_LONG)
    config = cli_config(CONFIG, root, imageset, work / "hvrnet_long.py")
    n = sum(n for _, n, _ in LANES_LONG)
    h, w = LANES_LONG[0][2]
    log(f"[cli] long tree of {len(LANES_LONG)} videos, {n} PPM frames at "
        f"{w}x{h} in {time.time() - t0:.1f} s")

    def argv(name, *extra):
        return [config, str(ckpt), "--out", str(work / f"{name}.pkl"),
                "--tmpdir", str(work / name), "--loader-workers", "4",
                "--u8-transfer", *extra]

    lock = cli_run(torch, np, "test", argv("long_b4", "--batched",
                                           str(LANES_B)),
                   "long: test --batched 4 --loader-workers 4 "
                   "--u8-transfer", 4)
    seq = cli_run(torch, np, "test", argv("long_seq"),
                  "long: test --loader-workers 4 --u8-transfer", 4)
    programs = LANES_B * lock["runner_steps"] / n
    log(f"[cli] ({CARD}) long tree, {n} frames: lockstep "
        f"{lock['fps']:.3f} frames/s ({programs:.3f} frame programs per "
        f"frame), sequential {seq['fps']:.3f} frames/s, both with 4 loader "
        f"threads and uint8 transfer")
    shutil.rmtree(root, ignore_errors=True)
    return {"cli long batched 4": lock, "cli long sequential": seq}


# [aug] and [multipass]: a frame and its mirror are 2 lanes of each window
# head call; the 3 passes of a T=63 window are 3 lanes of NL1 and of NL2,
# whose NL3 is one call of the key frame's 300 rows against all 18900
AUG_LANES, MULTIPASS_LANES = 2, 3
AUG_ATTN = ((6300, 6300, "aug NL1/NL3"), (300, 6300, "aug NL2/NL4"))
MULTIPASS_ATTN = ((6300, 6300, "multipass NL1/NL2"),)
# [trace]: a short video for test --trace --timing, and the names of the
# attention kernel's CUDA kernels (csrc/masked_attention.cu) in a trace
TRACE_VIDEOS = (("val/ILSVRC2015_val_00000000", 8, (720, 1280)),)
ATTENTION_KERNELS = ("split_rows", "namespace)::transpose<", "logits_kernel",
                     "rowstats_kernel", "output_kernel", "combine_kernel")


def window_kernel_hold(torch, engine, fc1_stack, masks, tag, passes=None):
    """The engine's window head on (B, T, P, D) rows (``passes``: the
    multi-pass graph) with the kernel against the same head with the plain
    attention: f32 logits within 1e-4 of max(|ref|, 1); bf16 every kernel
    call within ``bf16_agreement``'s ``worst`` ≤ 1 and the logits within
    the bf16 budget.  Returns the kernel calls' (lanes, nq, nk)."""
    from hvrnet_tpu_torch.engine.detector import f32_precision
    from hvrnet_tpu_torch.models.bbox_heads import selsa_bbox_head
    from hvrnet_tpu_torch.ops.attention import (attention_plain,
                                                bf16_agreement,
                                                masked_attention)
    calls = []

    def probed(q, k, v, bias, scale):
        out = masked_attention(q, k, v, bias, scale)
        call = dict(shape=(q.shape[0], q.shape[1], k.shape[1]))
        if q.dtype == torch.bfloat16:
            call.update(bf16_agreement(out, q, k, v, bias, scale))
        calls.append(call)
        return out

    def as_lists(pairs):
        return [c for c, _ in pairs], [r for _, r in pairs]

    with torch.no_grad(), f32_precision():
        try:
            selsa_bbox_head.masked_attention = probed
            got = engine._window_lanes(fc1_stack, masks, passes)
            selsa_bbox_head.masked_attention = attention_plain
            want = engine._window_lanes(fc1_stack, masks, passes)
        finally:
            selsa_bbox_head.masked_attention = masked_attention
    shapes = [c["shape"] for c in calls]
    if engine.dtype == torch.bfloat16:
        worst = max(c["worst"] for c in calls)
        cls_d, reg_d = head_budget(as_lists(got), as_lists(want))
        log(f"{tag} window head on {tuple(fc1_stack.shape)} rows, kernel "
            f"calls {shapes}: bf16 against their plain version worst "
            f"{worst:.3g} (limit 1); logits with the kernel vs the plain "
            f"attention max |Δcls|/max(|cls|, 1) {cls_d:.3g}, max |Δreg| "
            f"{reg_d:.3g} (limits {BF16_CLS_BUDGET}, {BF16_REG_BUDGET})")
        ok = (worst <= 1 and cls_d <= BF16_CLS_BUDGET
              and reg_d <= BF16_REG_BUDGET)
    else:
        err = logit_err(as_lists(got), as_lists(want))
        log(f"{tag} window head on {tuple(fc1_stack.shape)} rows, kernel "
            f"calls {shapes}: logits with the kernel vs the plain attention "
            f"max |Δ|/max(|ref|, 1) = {err:.3g} (limit 1e-4)")
        ok = err <= 1e-4
    if not ok:
        raise RuntimeError(f"{tag} window head with the kernel disagrees "
                           "with the plain attention")
    return shapes


def aug_holds(torch, np, engine, tag):
    """One T=21 window of the synthetic video through the aug path.
    Duplicate augmentations (the frame twice, unflipped, at scale factor 1:
    the merge's NMS runs in original-image coordinates, where mmdet's +1
    box widths make IoU depend on the scale) from the frame's own maps
    (``frame_post_aug`` of the plain frame program's maps, so the
    backbone's batch does not enter): the merged proposals are the frame's
    own (mask equal, boxes within 1e-3 px), each lane's fc1 within 1e-4 of
    max|fc1|; the two-lane window head within the head's limits of
    the plain one-lane head (f32 1e-4 of max(|logit|, 1), bf16 the bf16
    budget), and in f32 ``window_scores_aug`` within 1e-4 in scores and
    1e-4 × 1280 px in boxes of the plain decode of the same window (the
    class-wise NMS after it is one function on both paths; the detections'
    cut at max_per_img among near-tied random-weight scores is not a
    limit).  Then the frame and its mirror: the kernel against the plain
    attention on the window's two lanes (``window_kernel_hold``).  Returns
    the kernel calls' shapes."""
    from hvrnet_tpu_torch.engine.detector import f32_precision
    from hvrnet_tpu_torch.engine.stream import mirrored
    from hvrnet_tpu_torch.models.bbox_heads.bbox_head import get_det_bboxes
    f32 = engine.dtype == torch.float32
    frames = list(synthetic_video(np, engine.window, seed=1))
    kd, dup_pair, flip_pair = engine.key_dim, (False, False), (False, True)
    plain, dup, flipped = [], [], []
    fc1_err = box_err = 0.0
    unit = np.ones(4, np.float32)
    for f in frames:
        ish, psh, sf = f["img_shape"], f["pad_shape"], f["scale_factor"]
        maps = engine.backbone_maps(f["img"], ish)
        one = engine.frame_post(*maps, ish, psh)
        two = engine.frame_post_aug(*(m.expand(2, *m.shape[1:])
                                      for m in maps), [ish] * 2, [psh] * 2,
                                    [unit] * 2, dup_pair)
        if not torch.equal(two["mask"], one["mask"]):
            raise RuntimeError(f"{tag} duplicate augmentations merged "
                               "another proposal set than the frame's own")
        box_err = max(box_err, (two["boxes"] - one["boxes"]).abs().max()
                      .item())
        scale = one["fc1"].float().abs().max().item()
        fc1_err = max(fc1_err, (two["fc1"].float() - one["fc1"].float())
                      .abs().max().item() / scale)
        plain.append(one)
        dup.append(two)
        flipped.append(engine.frame_features_aug(
            [f["img"], mirrored(f)], [ish] * 2, [psh] * 2, [sf] * 2,
            flip_pair))
    fc1_limit = 1e-4 if f32 else 2 * 2.0 ** -8
    log(f"{tag} duplicate augmentations over {len(frames)} frames: the "
        f"frame's own proposals, boxes within {box_err:.3g} px "
        f"(limit 1e-3), fc1 within {fc1_err:.3g} of max|fc1| (limit "
        f"{fc1_limit:.3g})")
    if not (box_err <= 1e-3 and fc1_err <= fc1_limit):
        raise RuntimeError(f"{tag} duplicate augmentations' frame caches "
                           "differ from the frame's own")

    def stack(feats, key, dim=0):
        return torch.stack([x[key] for x in feats], dim=dim)

    masks = stack(plain, "mask")
    with torch.no_grad(), f32_precision():
        one_pairs = engine._window_lanes(stack(plain, "fc1")[None],
                                         masks[None])
        two_pairs = engine._window_lanes(stack(dup, "fc1", 1),
                                         masks[None].expand(2, -1, -1))
    for lane in range(2):
        got = ([c[lane:lane + 1] for c, _ in two_pairs],
               [r[lane:lane + 1] for _, r in two_pairs])
        want = ([c for c, _ in one_pairs], [r for _, r in one_pairs])
        if f32:
            err = logit_err(got, want)
            ok, what = err <= 1e-4, f"{err:.3g} (limit 1e-4)"
        else:
            cls_d, reg_d = head_budget(got, want)
            ok = cls_d <= BF16_CLS_BUDGET and reg_d <= BF16_REG_BUDGET
            what = (f"cls {cls_d:.3g}, reg {reg_d:.3g} (limits "
                    f"{BF16_CLS_BUDGET}, {BF16_REG_BUDGET})")
        log(f"{tag} duplicate augmentations, lane {lane} of the window "
            f"head against the one-lane head: {what}")
        if not ok:
            raise RuntimeError(f"{tag} a duplicate augmentation's window "
                               "head differs from the plain head")
    if f32:
        ish = frames[kd]["img_shape"]
        cls, reg = one_pairs[-1]
        want_b, want_s = get_det_bboxes(
            stack(plain, "boxes")[kd], cls[0], reg[0], ish, unit,
            engine.target_means, engine.target_stds, rescale=True)
        got_b, got_s = engine.window_scores_aug(
            stack(dup, "fc1", 1), stack(dup, "boxes"), masks, [ish] * 2,
            [unit] * 2, dup_pair)
        valid = masks[kd]
        s_err = (got_s - want_s)[valid].abs().max().item()
        b_err = (got_b - want_b)[valid].abs().max().item()
        log(f"{tag} duplicate augmentations' merged scores and boxes "
            f"against the plain decode of the key frame's {int(valid.sum())} "
            f"rows: scores within {s_err:.3g} (limit 1e-4), boxes within "
            f"{b_err:.3g} px (limit {1e-4 * 1280:.3g})")
        if not (s_err <= 1e-4 and b_err <= 1e-4 * 1280):
            raise RuntimeError(f"{tag} duplicate augmentations' decode "
                               "differs from the plain decode")
    return window_kernel_hold(
        torch, engine, stack(flipped, "fc1", 1), stack(flipped, "mask")[None]
        .expand(2, -1, -1), f"{tag} frame and mirror")


def phase_aug(torch, np, hvr_weights, selsa_weights):
    """Flip-augmented testing on the card: the kernel on 2 lanes at the
    window head's shapes; ``aug_holds`` for HVRNet f32 and bf16 and SELSA
    f32; then ``test --aug-test`` from disk over the [cli] PPM tree for the
    same three, 4 (HVRNet) and 2 (SELSA) launches per detection.  Returns
    the cases and the runs whose launches the kernels line counts."""
    import shutil
    cases = lanes_attention(torch, AUG_ATTN, AUG_LANES, "[aug]")
    engines = lanes_engines(torch, hvr_weights, selsa_weights)
    for name, engine in engines.items():
        shapes = aug_holds(torch, np, engine, f"[aug] {name}")
        want = 2 if name == "selsa" else 4
        if len(shapes) != want or any(s[0] != AUG_LANES for s in shapes):
            raise RuntimeError(f"[aug] {name}: kernel calls {shapes}, not "
                               f"{want} calls of {AUG_LANES} lanes")
    del engines
    torch.cuda.empty_cache()
    work = ROOT / "build" / "chip_smoke_aug"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "VID"
    imageset, _ = write_cli_tree(np, root, CLI_VIDEOS)
    runs, runs16 = {}, {}
    for name, config, weights, per_det, extra, out in (
            ("hvrnet", CONFIG, hvr_weights, 4, (), runs),
            ("selsa", SELSA_CONFIG, selsa_weights, 2, (), runs),
            ("hvrnet", CONFIG, hvr_weights, 4, ("--bf16",), runs16)):
        ckpt = work / f"{name}.pth"
        torch.save({"state_dict": weights}, ckpt)
        cfg = cli_config(config, root, imageset, work / f"{name}.py")
        tag = f"{name}{' bf16' if extra else ''}"
        out[f"aug {name}"] = cli_run(torch, np, "test", [
            cfg, str(ckpt), "--out", str(work / f"{name}.pkl"), "--tmpdir",
            str(work / name), "--aug-test", "--eval", *extra],
            f"test --aug-test ({tag}) T=21", per_det)
    shutil.rmtree(work, ignore_errors=True)
    return cases, runs, runs16


def phase_multipass(torch, np, hvr_weights):
    """HVRNet's multi-pass test graph at T=63, 3 passes, on the card: the
    kernel on 3 lanes at 6300²; one T=63 window's head with the kernel
    against the plain attention, f32 and bf16 (3 calls: NL1 and NL2 one
    call of 3 lanes each, NL3 one of 300 × 18900); ``hnl_test --window 63
    --multi-pass 3`` from disk over the [cli] tree's 40-frame video, f32
    and bf16, 3 launches per detection, beside the exact ring's ``hnl_test
    --window 63`` on the same video; ``--stream --multi-pass 3`` stops the
    CLI.  Returns the cases and the runs whose launches the kernels line
    counts."""
    import shutil
    from hvrnet_tpu_torch.tools import hnl_test
    cases = lanes_attention(torch, MULTIPASS_ATTN, MULTIPASS_LANES,
                            "[multipass]")
    for dtype in (torch.float32, torch.bfloat16):
        engine = build_engine(torch, np, window=63, weights=hvr_weights,
                              dtype=dtype)
        engine.multi_pass = L = MULTIPASS_LANES
        T, P = engine.window, engine.proposal_num
        want = [(L, T // L * P, T // L * P)] * 2 + [(1, P, T * P)]
        feats = [engine.frame_features(f["img"], f["img_shape"],
                                       f["pad_shape"])
                 for f in synthetic_video(np, engine.window, seed=1)]
        shapes = window_kernel_hold(
            torch, engine, torch.stack([f["fc1"] for f in feats])[None],
            torch.stack([f["mask"] for f in feats])[None],
            f"[multipass] T=63 {str(dtype)[6:]}", passes=engine.multi_pass)
        if shapes != want:
            raise RuntimeError(f"[multipass] kernel calls {shapes}, not "
                               f"{want}")
        del engine, feats
        torch.cuda.empty_cache()
    work = ROOT / "build" / "chip_smoke_multipass"
    shutil.rmtree(work, ignore_errors=True)
    imageset, _ = write_cli_tree(np, work / "VID63", CLI_VIDEOS[:1])
    ckpt = work / "hvrnet.pth"
    torch.save({"state_dict": hvr_weights}, ckpt)
    cfg = cli_config(CONFIG, work / "VID63", imageset, work / "hvrnet63.py")

    def argv(name, *extra):
        return [cfg, str(ckpt), "--out", str(work / f"{name}.pkl"),
                "--tmpdir", str(work / name), "--window", "63",
                "--pre-padding", "repeat", "--eval", *extra]

    runs = {"multipass T=63": cli_run(
        torch, np, "hnl_test", argv("mp", "--multi-pass", "3"),
        "hnl_test --window 63 --multi-pass 3", 3),
        "exact T=63 beside multipass": cli_run(
        torch, np, "hnl_test", argv("exact"), "hnl_test --window 63 "
        "(exact ring, beside --multi-pass 3)", 4)}
    runs16 = {"multipass T=63": cli_run(
        torch, np, "hnl_test", argv("mp16", "--multi-pass", "3", "--bf16"),
        "hnl_test --window 63 --multi-pass 3 --bf16", 3)}
    try:
        hnl_test.main(argv("never", "--multi-pass", "3", "--stream"),
                      imread=read_ppm)
    except SystemExit as stop:
        log(f"[multipass] --stream --multi-pass 3 stopped the CLI: {stop}")
    else:
        raise RuntimeError("hnl_test ran --stream with --multi-pass 3")
    shutil.rmtree(work, ignore_errors=True)
    return cases, runs, runs16


def phase_trace(torch, np, hvr_weights):
    """``test --trace DIR --timing`` on a short video with HVRNet's config:
    the printed summary lists ``frame_features`` and ``window_detect``, and
    the trace holds one ``logits_kernel`` and one ``output_kernel`` CUDA
    event per launch the kernel counted (4 per detection).  Returns the
    run."""
    import io
    import shutil
    from hvrnet_tpu_torch.ops.attention import masked_attention
    from hvrnet_tpu_torch.tools import test as test_cli
    work = ROOT / "build" / "chip_smoke_trace"
    shutil.rmtree(work, ignore_errors=True)
    imageset, _ = write_cli_tree(np, work / "VID", TRACE_VIDEOS)
    ckpt = work / "hvrnet.pth"
    torch.save({"state_dict": hvr_weights}, ckpt)
    cfg = cli_config(CONFIG, work / "VID", imageset, work / "hvrnet.py")
    printed = io.StringIO()
    torch.cuda.synchronize()
    masked_attention.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        run = test_cli.main([cfg, str(ckpt), "--out", str(work / "r.pkl"),
                             "--tmpdir", str(work / "parts"), "--trace",
                             str(work / "trace"), "--timing"],
                            imread=read_ppm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = masked_attention.launches
    n = run["frames"]
    summary = printed.getvalue().strip().splitlines()
    for line in summary:
        log(f"[trace] {line}")
    phases = {line.split()[0] for line in summary if line.strip()}
    if not {"frame_features", "window_detect"} <= phases:
        raise RuntimeError("[trace] --timing's summary lacks frame_features "
                           "or window_detect")
    files = sorted((work / "trace").glob("*.json"))
    if len(files) != 1:
        raise RuntimeError(f"[trace] {len(files)} trace files, not 1")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = {name: sum(name in e.get("name", "") for e in kernels)
              for name in ("logits_kernel", "output_kernel")}
    device_ms = sum(float(e.get("dur", 0)) for e in kernels) / 1e3
    attn_ms = sum(float(e.get("dur", 0)) for e in kernels
                  if any(k in e.get("name", "") for k in ATTENTION_KERNELS)
                  ) / 1e3
    log(f"[trace] ({CARD}) test --trace --timing over {n} frames in "
        f"{wall:.3f} s: {files[0].stat().st_size / 2**20:.1f} MiB of trace, "
        f"{len(kernels)} CUDA kernel events, {device_ms:.3f} ms of device "
        f"time, {attn_ms:.3f} ms of it the attention kernel's phases; "
        f"kernel events {counts} against {launches} launches counted")
    if launches != 4 * n or any(c != launches for c in counts.values()):
        raise RuntimeError(f"[trace] the trace's attention kernel events "
                           f"{counts} do not match the {launches} launches "
                           f"counted ({4 * n} expected)")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, frames=n, wall_s=wall,
                kernel_events=counts, device_ms=device_ms,
                attention_ms=attn_ms)


# [image]: the single-image API's input, the still-image engine's test_cfg
# rcnn as the JAX tests take it, and its trainer's steps
IMAGE_HW = (720, 1280)
IMAGE_CALLS = 3           # timed calls per engine, after one warm-up call
FASTER_RCNN_TEST = dict(score_thr=0.02, nms=dict(type="nms", iou_thr=0.5),
                        max_per_img=20)
IMAGE_TRAIN_TIMED = 2     # timed steps after TRAIN_WARMUP, per trainer


def synthetic_image(np, hw, seed=0):
    """A BGR uint8 image of ``hw``: a random scene of 16-px blocks."""
    rng = np.random.default_rng(seed)
    h, w = hw
    scene = rng.integers(0, 256, size=(-(-h // 16), -(-w // 16), 3),
                         dtype=np.uint8)
    return np.repeat(np.repeat(scene, 16, 0), 16, 1)[:h, :w].copy()


def faster_rcnn_config(config=None):
    """The still-image Faster R-CNN from HVRNet's config (a ``Config``):
    its backbone, shared head, RPN and RoI extractor with a ``BBoxHead``
    of 31 classes and per-class deltas; ``test_cfg.rpn`` and
    ``FASTER_RCNN_TEST``; ``train_cfg.rpn``, ``rpn_proposal`` and the
    config's RCNN assigner with its first sampler; its optimizer keys."""
    from hvrnet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(str(config or CONFIG)).as_dict()
    m, test, train = cfg["model"], cfg["test_cfg"], cfg["train_cfg"]
    model = dict(type="FasterRCNN", bbox_head=dict(
        type="BBoxHead", in_channels=256, roi_feat_size=7, num_classes=31,
        reg_class_agnostic=False), **{k: m[k] for k in (
            "backbone", "shared_head", "rpn_head", "bbox_roi_extractor")})
    rcnn = train["rcnn"]
    first = rcnn["sampler"]
    first = first[0] if isinstance(first, (list, tuple)) else first
    return Config(dict(cfg, model=model, test_cfg=dict(
        rpn=test["rpn"], rcnn=FASTER_RCNN_TEST), train_cfg=dict(
        rpn=train["rpn"], rpn_proposal=train["rpn_proposal"],
        rcnn=dict(assigner=rcnn["assigner"], sampler=first,
                  pos_weight=rcnn.get("pos_weight", -1)))))


def image_calls(torch, np, engine, img, tag):
    """``inference_detector`` on ``img``: one warm-up call, then
    IMAGE_CALLS with the kernel's launch count set to 0 just before and
    read just after, each timed by the host clock and by CUDA events (the
    host's resize and normalisation included).  Returns the run."""
    from hvrnet_tpu_torch.apis import (detect_image, image_input,
                                       inference_detector)
    from hvrnet_tpu_torch.ops.attention import masked_attention
    inference_detector(engine, img)
    t0 = time.perf_counter()
    x = image_input(engine.cfg, img)
    host_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    masked_attention.launches = 0
    t0 = time.perf_counter()
    ev[0].record()
    for _ in range(IMAGE_CALLS):
        result = inference_detector(engine, img)
    ev[1].record()
    torch.cuda.synchronize()
    run = dict(launches=masked_attention.launches, images=IMAGE_CALLS,
               wall_ms=(time.perf_counter() - t0) * 1e3 / IMAGE_CALLS,
               cuda_ms=ev[0].elapsed_time(ev[1]) / IMAGE_CALLS,
               host_input_ms=host_ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    run["detect_ms"] = cuda_ms(torch, lambda: detect_image(engine, x),
                               iters=IMAGE_CALLS, warmup=1)
    n_boxes = sum(len(c) for c in result)
    log(f"[image] {tag} ({CARD}): inference_detector on a "
        f"{IMAGE_HW[1]}x{IMAGE_HW[0]} image {run['wall_ms']:.3f} ms/image "
        f"wall, {run['cuda_ms']:.3f} ms/image CUDA events (mean of "
        f"{IMAGE_CALLS} after a warm-up; image_input alone "
        f"{host_ms:.3f} ms on the host, detect_image alone "
        f"{run['detect_ms']:.3f} ms CUDA events); peak device memory "
        f"{run['peak_gib']:.2f} GiB; kernel launches {run['launches']}; "
        f"{n_boxes} boxes in {len(result)} classes")
    if len(result) != engine.num_classes - 1 or not all(
            c.shape[1:] == (5,) and np.isfinite(c).all() for c in result):
        raise RuntimeError(f"[image] {tag}: not a {engine.num_classes - 1}"
                           "-class result of finite boxes")
    return run, result


def image_window_hold(torch, np, engine, img, result, tag):
    """The API's result bitwise ``window_detect`` over T copies of the
    same canvas's ``frame_features`` (the final branch on HVRNet)."""
    from hvrnet_tpu_torch.apis import image_input
    from hvrnet_tpu_torch.ops.boxes import bbox2result_np
    x = image_input(engine.cfg, img)
    feats = engine.frame_features(x["img"], x["img_shape"], x["pad_shape"])
    out = engine.window_detect(
        *(torch.stack([feats[k]] * engine.window)
          for k in ("fc1", "boxes", "mask")),
        x["img_shape"], x["scale_factor"])
    dets, labels, mask = (t.cpu().numpy() for t in (
        out[-1] if isinstance(out, list) else out))
    want = bbox2result_np(dets[mask], labels[mask], engine.num_classes)
    same = all(np.array_equal(g, w) for g, w in zip(result, want))
    log(f"[image] {tag}: the result bitwise window_detect over "
        f"{engine.window} copies of the canvas's frame_features: {same}")
    if not same:
        raise RuntimeError(f"[image] {tag}: inference_detector differs from "
                           "the window of copies")


def faster_holds(torch, np, engine, engine16):
    """``simple_test`` in f32 and bf16 (ms per image, CUDA events, and peak
    memory); the bf16 head on the f32 engine's pooled RoIs within the bf16
    budget of the f32 head; ``aug_test`` of two unflipped copies of a
    600×1000 image at scale factor 1 within 2e-3 of ``simple_test``, and of
    the image and its mirror valid rows."""
    from hvrnet_tpu_torch.apis import image_input
    from hvrnet_tpu_torch.engine.detector import f32_precision
    from hvrnet_tpu_torch.engine.stream import mirrored
    x = image_input(engine.cfg, synthetic_image(np, IMAGE_HW, seed=1))
    args = (x["img"], x["img_shape"], x["pad_shape"], x["scale_factor"])
    for eng in (engine, engine16):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, lambda: eng.simple_test(*args), iters=5,
                     warmup=1)
        log(f"[image] FasterRCNN {str(eng.dtype)[6:]} ({CARD}): simple_test "
            f"{ms:.3f} ms/image on the {tuple(x['img'].shape[1:3])} canvas "
            f"(CUDA events, mean of 5 after a warm-up); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with torch.no_grad(), f32_precision():
        c5, cls_map, reg_map = engine.backbone_maps(x["img"],
                                                    x["img_shape"])
        boxes, _, _ = engine._proposals_lanes(
            c5, cls_map, reg_map, [x["img_shape"]], [x["pad_shape"]])
        rois = torch.cat([torch.zeros_like(boxes[0][:, :1]), boxes[0]], 1)
        pooled = engine.roi_extractor(c5, rois)
        want = engine.model.bbox_forward(pooled)
        got = engine16.model.bbox_forward(pooled)
    cls_d, reg_d = head_budget(got, want)
    log(f"[image] FasterRCNN bf16 head on the f32 engine's "
        f"{tuple(pooled.shape)} pooled RoIs against the f32 head: max "
        f"|Δcls|/max(|cls|, 1) {cls_d:.3g}, max |Δreg| {reg_d:.3g} (limits "
        f"{BF16_CLS_BUDGET}, {BF16_REG_BUDGET})")
    if not (cls_d <= BF16_CLS_BUDGET and reg_d <= BF16_REG_BUDGET):
        raise RuntimeError("[image] the bf16 BBoxHead is outside the bf16 "
                           "budget")

    # two copies at scale factor 1, where the merge's NMS in original
    # coordinates sees the plain proposals' IoUs
    mean = np.asarray(engine.cfg.img_norm_cfg["mean"], np.float32)
    img = np.zeros((1,) + CANVAS + (3,), np.float32)
    img[0, :CONTENT[0], :CONTENT[1]] = synthetic_image(np, CONTENT,
                                                       seed=2) - mean
    ish = np.array(CONTENT, np.float32)
    psh = np.array(CANVAS, np.float32)
    one = np.ones(4, np.float32)
    plain = engine.simple_test(img, ish, psh, one)
    dup = engine.aug_test([img, img], [ish] * 2, [psh] * 2, [one] * 2,
                          (False, False))
    a, b = (out[0][out[2]].cpu().numpy() for out in (plain, dup))
    err = (np.abs(a - b) - 2e-3 * np.abs(a)).max() if a.shape == b.shape \
        and len(a) else float("inf")
    log(f"[image] FasterRCNN aug_test of two unflipped copies of a "
        f"{CONTENT[1]}x{CONTENT[0]} image at scale factor 1 against "
        f"simple_test: {len(b)} and {len(a)} detections, max |Δ| - 2e-3·|ref|"
        f" {err:.3g} (limit 2e-3)")
    if not err <= 2e-3:
        raise RuntimeError("[image] aug_test of duplicates differs from "
                           "simple_test")
    flip = engine.aug_test(
        [img, mirrored(dict(img=img, img_shape=ish))], [ish] * 2, [psh] * 2,
        [one] * 2, (False, True))
    dets, labels, mask = (t.cpu().numpy() for t in flip)
    kept = dets[mask]
    ok = (np.isfinite(kept).all() and (kept[:, 4] >= 0).all()
          and (kept[:, 4] <= 1).all() and (labels[mask] >= 0).all()
          and (labels[mask] < engine.num_classes - 1).all())
    log(f"[image] FasterRCNN aug_test of the image and its mirror: "
        f"{len(kept)} valid rows, finite boxes and scores in [0, 1]: {ok}")
    if not (ok and len(kept)):
        raise RuntimeError("[image] aug_test of the image and its mirror "
                           "gave invalid rows")


def image_training(torch, np, engine_cls, cfg, tag, launches_per_step,
                   trained):
    """``train_detector`` at full width (f32) for TRAIN_WARMUP +
    IMAGE_TRAIN_TIMED steps on a synthetic batch, seeded weights with
    frozen BNs calibrated on it: finite losses, the launches, frozen
    tensors bitwise and trainable ones moved."""
    import shutil
    work_dir = ROOT / "build" / f"chip_smoke_image_{engine_cls.__name__}"
    shutil.rmtree(work_dir, ignore_errors=True)
    batch = synthetic_train_batch(np, seed=3, videos=1)
    engine = calibrated_training_engine(torch, engine_cls, cfg, batch, tag)
    before = {k: t.clone() for k, t in engine.model.state_dict().items()}
    _, summary = timed_training(torch, np, engine, batch, cfg, work_dir,
                                SELSA_TRAIN_STAGES, tag, launches_per_step,
                                timed=IMAGE_TRAIN_TIMED)
    log(f"{tag} ({CARD}): {summary['step_ms']:.3f} ms/step (CUDA events), "
        f"peak device memory {summary['peak_gib']:.2f} GiB")
    check_train_weights(torch, engine, before, tag, trained)
    shutil.rmtree(work_dir, ignore_errors=True)
    del engine
    torch.cuda.empty_cache()
    return summary


def phase_image(torch, np, hvr_weights, selsa_weights):
    """The single-image API and the still-image Faster R-CNN at full
    width.  HVRNet and SELSA (the configs' R101-C5, 300 proposals, T=21,
    the earlier phases' seeded, calibrated weights), f32 and bf16:
    ``inference_detector`` on a 1280×720 BGR image, 4 (HVRNet) and 2
    (SELSA) launches per image, the result bitwise the window of T copies.
    ``FasterRCNN`` from HVRNet's config (``faster_rcnn_config``, seeded
    weights calibrated on the image): the API, ``simple_test``, its bf16
    head, ``aug_test``; ``FasterRCNNTrainer`` and ``SelsaTrainer`` with a
    single sampler through ``train_detector``.  Returns the runs whose
    launches the kernels line counts, f32 and bf16."""
    from hvrnet_tpu_torch.apis import image_input, init_detector
    from hvrnet_tpu_torch.engine import FasterRCNN, SelsaRCNN
    from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
    from hvrnet_tpu_torch.utils.config import Config
    img = synthetic_image(np, IMAGE_HW)
    runs, runs16 = {}, {}
    for name, config, weights, per_image in (
            ("hvrnet", CONFIG, hvr_weights, 4),
            ("selsa", SELSA_CONFIG, selsa_weights, 2)):
        for dtype, out in ((torch.float32, runs), (torch.bfloat16, runs16)):
            tag = f"{name} {str(dtype)[6:]}"
            engine = init_detector(str(config), dtype=dtype, device="cuda")
            engine.load_state_dict(weights)
            run, result = image_calls(torch, np, engine, img, tag)
            if run["launches"] != per_image * IMAGE_CALLS:
                raise RuntimeError(f"[image] {tag}: {run['launches']} kernel "
                                   f"launches, not {per_image} per image")
            image_window_hold(torch, np, engine, img, result, tag)
            out[f"image {name}"] = run
            del engine
            torch.cuda.empty_cache()

    fcfg = faster_rcnn_config()
    engine = init_detector(fcfg, device="cuda")
    n_bn = calibrate_frozen_bn(engine, [image_input(engine.cfg, img)])
    log(f"[image] FasterRCNN R101-C5 from {CONFIG.name} (BBoxHead, 31 "
        f"classes, {engine.proposal_num} proposals), seeded random weights, "
        f"{n_bn} frozen BNs calibrated on the image")
    engine16 = init_detector(fcfg, dtype=torch.bfloat16, device="cuda")
    engine16.load_state_dict(engine.model.state_dict())
    for eng in (engine, engine16):
        image_calls(torch, np, eng, img, f"FasterRCNN {str(eng.dtype)[6:]}")
    faster_holds(torch, np, engine, engine16)
    del engine, engine16
    torch.cuda.empty_cache()

    trained = ("backbone.layer2.", "backbone.layer3.", "rpn_head.",
               "shared_head.", "bbox_head.")
    image_training(torch, np, FasterRCNN, fcfg.as_dict(),
                   "[image] FasterRCNNTrainer", 0, trained)
    selsa = Config.fromfile(str(SELSA_CONFIG)).as_dict()
    rcnn = selsa["train_cfg"]["rcnn"]
    selsa["train_cfg"]["rcnn"] = dict(rcnn, sampler=rcnn["sampler"][0])
    runs["image selsa train"] = image_training(
        torch, np, SelsaRCNN, selsa, "[image] SelsaTrainer one sampler", 2,
        trained)
    return runs, runs16


# [zoo]: the multi-stage R-CNN zoo.  Cascade and Mask R-CNN on HVRNet's
# R101-C5 trunk: Cascade R-CNN's stage heads and train settings are
# mmdetection v1.0rc1 configs/cascade_rcnn_r50_fpn_1x.py's, Mask R-CNN's
# mask branch its configs/mask_rcnn_r50_fpn_1x.py's; their training
# proposals are the C4 config's (configs/faster_rcnn_r50_caffe_c4_1x.py:
# 12000 → 2000), since each stage samples 512 RoIs.  Hybrid Task Cascade
# R50-FPN is configs/htc/htc_r50_fpn_1x.py's whole.
ZOO_STDS = ([0.1, 0.1, 0.2, 0.2], [0.05, 0.05, 0.1, 0.1],
            [0.033, 0.033, 0.067, 0.067])
ZOO_RCNN_TEST = dict(score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                     max_per_img=100)
ZOO_RPN_PROPOSAL = dict(nms_across_levels=False, nms_pre=12000,
                        nms_post=2000, max_num=2000, nms_thr=0.7,
                        min_bbox_size=0)
# content (h, w), canvas, the scale from an original image to the content
ZOO_SIZES = {"cascade": ((600, 1000), (608, 1008), 0.78125),
             "mask": ((800, 1333), (800, 1344), 0.625),
             "htc": ((800, 1333), (800, 1344), 0.625),
             "cascade_dcn": ((800, 1333), (800, 1344), 0.625),   # [deform]
             "mask_gcb": ((800, 1333), (800, 1344), 0.625),      # [plugins]
             "faster_attention": ((800, 1333), (800, 1344), 0.625),
             "cascade_hrnet": ((800, 1333), (800, 1344), 0.625)}
ZOO_TRUNKS = {"cascade": "R101-C5", "mask": "R101-C5", "htc": "R50-FPN",
              "cascade_dcn": "R50-FPN, dcn c3-c5",
              "mask_gcb": "R50-FPN, gcb c3-c5",
              "faster_attention": "R50-FPN, gen_attention 1111 c4-c5",
              "cascade_hrnet": "HRNetV2p-W32 + HRFPN"}
ZOO_CALLS = 3             # timed simple_test calls after one warm-up call
ZOO_TRAIN_TIMED = 2       # timed training steps after TRAIN_WARMUP
ZOO_HOLD_SEEDS = (0, 1, 2, 3)   # the images of the card-against-CPU hold
# the card's f32 result against the port's CPU run on the card's trunk
# maps: boxes and mask probabilities at the CPU tests' limits
# (tests/test_torch_port_zoo.py); scores at 1e-5, not the CPU tests' 2e-6:
# those heads are 32 wide with small logits, these 1024 wide with fc_cls
# spread to std 0.5 (``zoo_spread_heads``), so their logits, and the
# rounding by which the card's and the CPU's summation orders part them,
# are larger.  On the H100 the four images read up to 7.75e-7 (Cascade)
# and 1.67e-6 to 4.35e-6 (Mask R-CNN): the limit is over twice the largest
ZOO_BOX_TOL, ZOO_SCORE_TOL, ZOO_MASK_TOL = 1e-3, 1e-5, 1e-5
# HTC's mask probabilities go through three chained 256-channel heads (12
# convs, the information flow, the semantic RoI features) from detections
# the card and the CPU round 1-5 ulps apart: on the H100 eight images read
# 4.14e-5 to 1.30e-4 (boxes ≤ 6.1e-4 px, scores ≤ 3.25e-6); the limit is
# over twice the largest, and a wrong flow or fusion is off by O(0.1)
# The gcb Mask R-CNN's FCN mask head ([plugins]) reads P2 of an R50-FPN, as
# HTC's heads do, whose 256-channel outputs give it larger logits than the
# C5 models' RoIs: on the H100 one image read 8.66e-5 (boxes 2.4e-4 px,
# scores 4.9e-6), under a third of HTC's limit, which it is held to
ZOO_MASK_TOLS = {"htc": 3e-4, "mask_gcb": 3e-4}
# the card's f32 FPN outputs against the port's CPU run of the same
# backbone and neck on the same image, max |Δ| / max |CPU| per level: the
# f32 limit [lanes] holds a batched backbone's maps to at every depth
# (LANES_MAP_LIMIT), the same seeded weights' amplified rounding
ZOO_FPN_TOL = 1e-3
ZOO_TRAINED = ("backbone.layer2.", "backbone.layer3.", "rpn_head.",
               "shared_head.", "bbox_head.", "mask_head.")
ZOO_TRAINED_FPN = ("backbone.layer2.", "backbone.layer3.",
                   "backbone.layer4.", "neck.", "rpn_head.", "bbox_head.",
                   "mask_head.", "semantic_head.")


def htc_config():
    """Hybrid Task Cascade R50-FPN as mmdetection v1.0rc1's
    configs/htc/htc_r50_fpn_1x.py has it (a ``Config``): the pytorch-style
    ResNet-50 over 4 stages, FPN 256 × 5 levels, the RPN with 32-px
    anchors, 3 ``SharedFCBBoxHead`` stages of 81 classes with
    class-agnostic deltas, a per-stage list of 3 ``HTCMaskHead``s (4 convs,
    256 channels), the ``FusedSemanticHead`` of 183 classes fused into the
    box and mask RoIs; its test_cfg (1000 proposals, score_thr 0.001, 100
    detections), train_cfg (2000 → 2000 proposals, 512 RoIs per stage at
    IoU 0.5 / 0.6 / 0.7, weights 1 / 0.5 / 0.25) and optimizer keys."""
    from hvrnet_tpu_torch.utils.config import Config

    def extractor(size, strides):
        return dict(type="SingleRoIExtractor", roi_layer=dict(
            type="RoIAlign", out_size=size, sample_num=2), out_channels=256,
            featmap_strides=strides)

    def stage(iou):
        return dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=iou,
                                  neg_iou_thr=iou, min_pos_iou=iou,
                                  ignore_iof_thr=-1),
                    sampler=dict(type="RandomSampler", num=512,
                                 pos_fraction=0.25, neg_pos_ub=-1,
                                 add_gt_as_proposals=True),
                    mask_size=28, pos_weight=-1, debug=False)

    model = dict(
        type="HybridTaskCascade", num_stages=3, interleaved=True,
        mask_info_flow=True,
        backbone=dict(type="ResNet", depth=50, num_stages=4,
                      strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      style="pytorch"),
        neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                  out_channels=256, num_outs=5),
        rpn_head=dict(type="RPNHead", in_channels=256, feat_channels=256,
                      anchor_scales=[8], anchor_ratios=[0.5, 1.0, 2.0],
                      anchor_strides=[4, 8, 16, 32, 64],
                      target_means=[.0] * 4, target_stds=[1.0] * 4),
        bbox_roi_extractor=extractor(7, [4, 8, 16, 32]),
        bbox_head=[dict(type="SharedFCBBoxHead", num_fcs=2, in_channels=256,
                        fc_out_channels=1024, roi_feat_size=7,
                        num_classes=81, target_means=[0.] * 4,
                        target_stds=stds, reg_class_agnostic=True)
                   for stds in ZOO_STDS],
        mask_roi_extractor=extractor(14, [4, 8, 16, 32]),
        mask_head=[dict(type="HTCMaskHead", num_convs=4, in_channels=256,
                        conv_out_channels=256, num_classes=81)
                   for _ in ZOO_STDS],
        semantic_roi_extractor=extractor(14, [8]),
        semantic_head=dict(type="FusedSemanticHead", num_ins=5,
                           fusion_level=1, num_convs=4, in_channels=256,
                           conv_out_channels=256, num_classes=183,
                           ignore_label=255, loss_weight=0.2),
        semantic_fusion=("bbox", "mask"))
    return Config(dict(
        model=model,
        train_cfg=dict(
            rpn=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7,
                                   neg_iou_thr=0.3, min_pos_iou=0.3,
                                   ignore_iof_thr=-1),
                     sampler=dict(type="RandomSampler", num=256,
                                  pos_fraction=0.5, neg_pos_ub=-1,
                                  add_gt_as_proposals=False),
                     allowed_border=0, pos_weight=-1, debug=False),
            rpn_proposal=dict(nms_across_levels=False, nms_pre=2000,
                              nms_post=2000, max_num=2000, nms_thr=0.7,
                              min_bbox_size=0),
            rcnn=[stage(iou) for iou in (0.5, 0.6, 0.7)],
            stage_loss_weights=[1, 0.5, 0.25]),
        test_cfg=dict(
            rpn=dict(nms_across_levels=False, nms_pre=1000, nms_post=1000,
                     max_num=1000, nms_thr=0.7, min_bbox_size=0),
            rcnn=dict(score_thr=0.001, nms=dict(type="nms", iou_thr=0.5),
                      max_per_img=100, mask_thr_binary=0.5),
            keep_all_stages=False),
        img_norm_cfg=dict(mean=[123.675, 116.28, 103.53],
                          std=[58.395, 57.12, 57.375], to_rgb=True),
        optimizer=dict(type="SGD", lr=0.02, momentum=0.9,
                       weight_decay=0.0001),
        optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
        lr_config=dict(policy="step", warmup="linear", warmup_iters=500,
                       warmup_ratio=1.0 / 3, step=[16, 19])))


def zoo_configs(config=None):
    """Cascade R-CNN (three ``SharedFCBBoxHead`` stages, 31 classes,
    class-agnostic deltas) and Mask R-CNN (one ``SharedFCBBoxHead`` of 81
    classes, ``FCNMaskHead`` on 14×14 RoIs) on HVRNet's config's trunk
    (caffe R101 C4, the dilated stage-4 shared head, RPN at stride 16 with
    scales 4-32, RoIAlign 7) as ``Config`` objects: the model, its
    test_cfg (the config's rpn, ``ZOO_RCNN_TEST``), train_cfg and optimizer
    keys; and HTC R50-FPN (``htc_config``)."""
    from hvrnet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(str(config or CONFIG)).as_dict()
    m, test, train = cfg["model"], cfg["test_cfg"], cfg["train_cfg"]
    trunk = {k: m[k] for k in ("backbone", "shared_head", "rpn_head",
                                "bbox_roi_extractor")}

    def head(num_classes, stds, agnostic):
        return dict(type="SharedFCBBoxHead", num_fcs=2, in_channels=256,
                    fc_out_channels=1024, roi_feat_size=7,
                    num_classes=num_classes, target_means=[0.] * 4,
                    target_stds=stds, reg_class_agnostic=agnostic)

    def stage(iou, **extra):
        return dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=iou,
                                  neg_iou_thr=iou, min_pos_iou=iou,
                                  ignore_iof_thr=-1),
                    sampler=dict(type="RandomSampler", num=512,
                                 pos_fraction=0.25, neg_pos_ub=-1,
                                 add_gt_as_proposals=True),
                    pos_weight=-1, debug=False, **extra)

    base = {k: cfg[k] for k in ("optimizer", "optimizer_config",
                                "lr_config", "img_norm_cfg") if k in cfg}
    train_base = dict(rpn=train["rpn"], rpn_proposal=ZOO_RPN_PROPOSAL)
    cascade = dict(
        base, model=dict(type="CascadeRCNN", num_stages=3, **trunk,
                         bbox_head=[head(31, s, True) for s in ZOO_STDS]),
        test_cfg=dict(rpn=test["rpn"], rcnn=ZOO_RCNN_TEST),
        train_cfg=dict(train_base, rcnn=[stage(t) for t in (0.5, 0.6, 0.7)],
                       stage_loss_weights=[1, 0.5, 0.25]))
    mask = dict(
        base, model=dict(
            type="MaskRCNN", **trunk,
            bbox_head=head(81, ZOO_STDS[0], False),
            mask_roi_extractor=dict(
                type="SingleRoIExtractor",
                roi_layer=dict(type="RoIAlign", out_size=14, sample_num=2),
                out_channels=256, featmap_strides=[16]),
            mask_head=dict(type="FCNMaskHead", num_convs=4, in_channels=256,
                           conv_out_channels=256, num_classes=81)),
        test_cfg=dict(rpn=test["rpn"],
                      rcnn=dict(ZOO_RCNN_TEST, mask_thr_binary=0.5)),
        train_cfg=dict(train_base, rcnn=stage(0.5, mask_size=28)))
    return {"cascade": Config(cascade), "mask": Config(mask),
            "htc": htc_config()}


def zoo_image(np, name, seed=0):
    """The model's operating size: a synthetic BGR scene of its content size
    normalised onto its canvas (HVRNet's mean for the C5 models; HTC's
    ``img_norm_cfg``, RGB, mean and std); (img (1, H, W, 3), img_shape,
    pad_shape, scale_factor (4,))."""
    content, canvas, scale = ZOO_SIZES[name]
    scene = synthetic_image(np, content, seed).astype(np.float32)
    if name in ("htc", "cascade_dcn") or name in PLUGIN_SOURCES:
        cfg = htc_config().img_norm_cfg
        scene = ((scene[..., ::-1] - np.float32(cfg.mean))
                 / np.float32(cfg.std))
    else:
        scene = scene - np.array([103.06, 115.90, 123.15], np.float32)
    img = np.zeros((1,) + canvas + (3,), np.float32)
    img[0, :content[0], :content[1]] = scene
    return (img, np.array(content, np.float32), np.array(canvas, np.float32),
            np.full(4, scale, np.float32))


def zoo_spread_heads(torch, engine, seed=0):
    """Every bbox head's ``fc_cls`` drawn at std 0.5 and ``fc_reg`` at 0.1
    (seeded): at the init stds of 0.01 and 0.001 every softmax is near
    uniform, no score clears ``score_thr`` 0.05 and no stage moves a box."""
    gen = torch.Generator().manual_seed(seed)
    heads = engine.model.bbox_head
    with torch.no_grad():
        for h in heads if isinstance(heads, torch.nn.ModuleList) else [heads]:
            for fc, std in ((h.fc_cls, 0.5), (h.fc_reg, 0.1)):
                fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen)
                                * std)


def zoo_scale_heads(torch, np, engine, name, logit_std=3.0,
                    delta_std=0.5, seed=0):
    """HTC's stage heads drawn for the image: each stage's ``fc_cls`` and
    ``fc_reg`` seeded normals scaled so that on the stage's RoIs of the
    model's image its logits have std ``logit_std`` and its deltas
    ``delta_std`` (the stages' boxes refined in turn).  A fixed std
    (``zoo_spread_heads``) gives these calibrated FPN features logits in
    the hundreds: saturated softmaxes, scores exactly 1/3 or 2/3 tied
    across detections, whose order then rests on rounding."""
    x = zoo_image(np, name)
    gen = torch.Generator().manual_seed(seed)
    feats = {}
    with torch.no_grad():
        maps, cls_map, reg_map = engine.backbone_maps(*x[:2])
        c5 = engine.pool_map(maps)
        emb = engine.semantic_embedding(maps)
        boxes = engine._proposals_lanes(c5, cls_map, reg_map, [x[1]],
                                        [x[2]])[0][0]
        heads = engine.model.bbox_head
        for st, head in enumerate(heads if isinstance(
                heads, torch.nn.ModuleList) else [heads]):
            hook = head.fc_cls.register_forward_pre_hook(
                lambda mod, args: feats.__setitem__("x", args[0]))
            try:
                engine.stage_forward(c5, boxes, st, emb)
            finally:
                hook.remove()
            for fc, std in ((head.fc_cls, logit_std),
                            (head.fc_reg, delta_std)):
                w = torch.randn(fc.weight.shape, generator=gen).to(
                    fc.weight.device)
                out = feats["x"].float() @ w.T
                fc.weight.copy_(w * (std / out.std()))
            cls, reg = engine.stage_forward(c5, boxes, st, emb)
            if st < engine.num_stages - 1:
                boxes = engine.refine(boxes, cls, reg, st, x[1])


def zoo_engines(torch, np, name, cfg, prefix="[zoo]", prepare=None):
    """The f32 serving engine on seeded weights (``prepare(engine)`` first
    where given, then frozen BNs calibrated on the image, heads spread)
    and a bf16 one on the same weights, heads pre-cast."""
    from hvrnet_tpu_torch.apis import build_detector
    from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
    t0 = time.time()
    img, ish = zoo_image(np, name)[:2]
    engine = build_detector(cfg.model, test_cfg=cfg.test_cfg, device="cuda")
    if prepare is not None:
        prepare(engine)
    n_bn = calibrate_frozen_bn(engine, [dict(img=img, img_shape=ish)])
    if engine.model.neck is not None:
        zoo_scale_heads(torch, np, engine, name)
    else:
        zoo_spread_heads(torch, engine)
    engine16 = build_detector(cfg.model, test_cfg=cfg.test_cfg,
                              device="cuda", dtype=torch.bfloat16)
    engine16.load_state_dict(engine.model.state_dict())
    engine16.cast_head_params_bf16()
    origin = {"htc": "htc_r50_fpn_1x's settings",
              "cascade_dcn": DEFORM_SOURCES["cascade_dcn"],
              **PLUGIN_SOURCES}.get(name, f"{CONFIG.name}'s trunk")
    log(f"{prefix} {type(engine).__name__} {ZOO_TRUNKS[name]} from {origin}: "
        f"{engine.num_stages} stage(s), {engine.num_classes} classes, "
        f"{engine.proposal_num} proposals, mask heads "
        f"{engine.num_mask_stages}, semantic branch {engine.with_semantic}; "
        f"seeded random weights, {n_bn} frozen BNs calibrated on the "
        f"{ZOO_SIZES[name][0][1]}x{ZOO_SIZES[name][0][0]} image; f32 and bf16 "
        f"engines in {time.time() - t0:.1f} s")
    return engine, engine16


def zoo_serving(torch, np, engine, name, tag, prefix="[zoo]"):
    """``simple_test`` on the operating-size image: one warm-up call, then
    ZOO_CALLS timed by CUDA events with the peak memory; one more call with
    the engine's stage timer; the host paste of the kept masks
    (``paste_masks``).  The attention kernel's count is set to 0 before
    the warm-up call and read after the last: no launch.  Checks finite
    boxes, scores in [score_thr, 1], labels and mask probabilities in
    range.  Returns (run, the output)."""
    from hvrnet_tpu_torch.models.mask_heads import paste_masks
    from hvrnet_tpu_torch.ops.attention import masked_attention
    x = zoo_image(np, name)
    thr = float(engine.test_cfg["rcnn"]["score_thr"])
    masked_attention.launches = 0
    engine.simple_test(*x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: engine.simple_test(*x), iters=ZOO_CALLS,
                 warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    engine.timer = PhaseTimer(torch)
    out = engine.simple_test(*x)
    stages = {k: engine.timer.mean_ms(k) for k in engine.timer.spans}
    engine.timer = None
    launches = masked_attention.launches
    if launches:
        raise RuntimeError(f"{prefix} {tag}: {launches} attention launches in "
                           "simple_test, which has no relation head")
    dets, labels, keep = (t.cpu().numpy() for t in out[:3])
    kept = dets[keep]
    ok = (np.isfinite(kept).all() and ((kept[:, 4] >= thr)
                                        & (kept[:, 4] <= 1)).all()
          and ((labels[keep] >= 0)
               & (labels[keep] < engine.num_classes - 1)).all())
    run = dict(ms=ms, peak_gib=peak, stages_ms=stages, kept=int(keep.sum()),
               launches=launches)
    if engine.with_mask:
        probs = out[3].cpu().numpy()
        ok = ok and probs.shape[1:] == (engine.num_classes - 1, 28, 28) \
            and ((probs >= 0) & (probs <= 1)).all()
        h, w = (np.array(ZOO_SIZES[name][0]) / ZOO_SIZES[name][2]).round()
        t0 = time.perf_counter()
        segms = paste_masks(probs[keep], kept, labels[keep], int(h), int(w),
                            thr=0.5)
        run["paste_ms"] = (time.perf_counter() - t0) * 1e3
        ok = ok and sum(len(c) for c in segms) == len(kept)
    log(f"{prefix} {tag} ({CARD}): simple_test {ms:.3f} ms/image on the "
        f"{ZOO_SIZES[name][1]} canvas (CUDA events, mean of {ZOO_CALLS} "
        f"after a warm-up); stages ms " + json.dumps(
            {k: round(v, 3) for k, v in stages.items()})
        + (f"; host paste of {len(kept)} masks into the "
           f"{int(w)}x{int(h)} original {run['paste_ms']:.3f} ms"
           if engine.with_mask else "")
        + f"; peak device memory {peak:.2f} GiB; {len(kept)} detections "
        f"kept; valid rows: {ok}; attention launches {launches}")
    if not (ok and len(kept)):
        raise RuntimeError(f"{prefix} {tag}: simple_test gave no or invalid "
                           "detections")
    return run, out


def to_device(obj, device):
    """A tensor, or a tuple of them, on ``device``."""
    if isinstance(obj, tuple):
        return tuple(to_device(o, device) for o in obj)
    return obj.to(device)


def zoo_fpn_hold(torch, np, engine, cpu, name, prefix="[zoo]"):
    """The card's f32 FPN outputs (backbone and neck) of the model's image
    against the port's CPU run of the same weights on the same image: max
    |Δ| / max |CPU| per level within ZOO_FPN_TOL.  Returns the worst."""
    x = zoo_image(np, name)
    with torch.no_grad():
        card = engine.backbone_maps(*x[:2])[0]
        want = cpu.backbone_maps(*x[:2])[0]
    errs = [((c.cpu() - w).abs().max() / w.abs().max()).item()
            for c, w in zip(card, want)]
    log(f"{prefix} {type(engine).__name__} f32 FPN outputs P2-P6 on the card "
        f"against the port's CPU run of the same backbone and neck: max "
        f"|Δ|/max|CPU| " + ", ".join(f"{e:.3g}" for e in errs)
        + f" (limit {ZOO_FPN_TOL})")
    if max(errs) > ZOO_FPN_TOL:
        raise RuntimeError(f"{prefix} the card's {type(engine).__name__} FPN "
                           "outputs are not the CPU's")
    return max(errs)


def zoo_cpu_hold(torch, np, engine, cfg, name, prefix="[zoo]",
                 seeds=ZOO_HOLD_SEEDS, fpn_hold=True):
    """The card's f32 ``simple_test`` against the port's CPU run of the same
    engine, both fed the card's trunk maps (with a neck: its maps and the
    semantic embedding), on each image of ``seeds``: the same NMS
    picks in the same rows with the same labels, boxes, scores and mask
    probabilities within the CPU tests' limits (scores at ZOO_SCORE_TOL,
    HTC's masks at ZOO_MASK_TOLS).
    With a neck and ``fpn_hold`` the card's FPN outputs are held to the
    CPU's first (``zoo_fpn_hold``).  Returns the worst (box, score, mask)
    differences and the FPN's."""
    from hvrnet_tpu_torch.apis import build_detector
    cpu = build_detector(cfg.model, test_cfg=cfg.test_cfg, device="cpu")
    cpu.load_state_dict(host_state_dict(engine))
    fpn = (zoo_fpn_hold(torch, np, engine, cpu, name, prefix)
           if engine.model.neck is not None and fpn_hold else None)
    real = engine.backbone_maps, engine.semantic_embedding
    mask_tol = ZOO_MASK_TOLS.get(name, ZOO_MASK_TOL)
    worst = [0.0, 0.0, 0.0]
    for seed in seeds:
        x = zoo_image(np, name, seed)
        maps = real[0](*x[:2])
        emb = real[1](maps[0])
        cpu.backbone_maps = lambda img, ish: to_device(maps, "cpu")
        cpu.semantic_embedding = lambda m: (None if emb is None
                                            else emb.cpu())
        engine.backbone_maps = lambda img, ish: maps
        engine.semantic_embedding = lambda m: emb
        try:
            got = [t.cpu() for t in engine.simple_test(*x)]
        finally:
            engine.backbone_maps, engine.semantic_embedding = real
        want = cpu.simple_test(*x)
        keep = want[2]
        same = torch.equal(got[2], keep) and torch.equal(got[1][keep],
                                                         want[1][keep])
        box = (got[0][keep, :4] - want[0][keep, :4]).abs().max().item()
        score = (got[0][keep, 4] - want[0][keep, 4]).abs().max().item()
        masks = ((got[3] - want[3]).abs().max().item() if engine.with_mask
                 else 0.0)
        worst = [max(a, b) for a, b in zip(worst, (box, score, masks))]
        log(f"{prefix} {type(engine).__name__} f32 on the card against the "
            f"port's CPU run on the card's trunk maps"
            + (" and semantic embedding" if emb is not None else "")
            + f", image seed {seed}: {int(keep.sum())} picks and labels "
            f"identical {same}; max |Δbox| {box:.3g} px (limit "
            f"{ZOO_BOX_TOL}), max |Δscore| {score:.3g} ({ZOO_SCORE_TOL})"
            + (f", max |Δmask prob| {masks:.3g} ({mask_tol})"
               if engine.with_mask else ""))
        if not (same and keep.any() and box <= ZOO_BOX_TOL
                and score <= ZOO_SCORE_TOL and masks <= mask_tol):
            raise RuntimeError(f"{prefix} {type(engine).__name__}, image seed "
                               f"{seed}: the card's f32 result is not the "
                               "CPU's")
    log(f"{prefix} {type(engine).__name__} card against CPU over "
        f"{len(seeds)} images: worst |Δbox| {worst[0]:.3g} px, "
        f"|Δscore| {worst[1]:.3g}, |Δmask prob| {worst[2]:.3g}")
    return dict(worst=worst, fpn=fpn)


def zoo_bf16_hold(torch, np, engine, engine16, name, prefix="[zoo]"):
    """Each bf16 head on the f32 engine's inputs against the f32 head, by
    depth: the semantic head on the f32 FPN maps (its embedding and
    logits as the cls), each box stage on the f32 pooled RoIs (the stages'
    boxes from the f32 engine), each mask head on the f32 pooled mask RoIs
    and the f32 trunk features of the stage before; within the bf16 budget
    (``head_budget``; the mask logits as the cls)."""
    from hvrnet_tpu_torch.engine.detector import f32_precision
    from hvrnet_tpu_torch.engine.multi_stage import mean_scale
    x = zoo_image(np, name)
    worst = [0.0, 0.0]

    def rel(got, want):
        return ((got.float() - want).abs().max().item()
                / max(want.abs().max().item(), 1.0))

    with torch.no_grad(), f32_precision():
        maps, cls_map, reg_map = engine.backbone_maps(*x[:2])
        c5 = engine.pool_map(maps)
        emb = engine.semantic_embedding(maps)
        if emb is not None:
            want = engine.model.semantic_head(maps)
            got = engine16.model.semantic_head(maps)
            worst[0] = max(worst[0], *(rel(g, w) for g, w in zip(got, want)))
        boxes = engine._proposals_lanes(c5, cls_map, reg_map, [x[1]],
                                        [x[2]])[0][0]
        for st in range(engine.num_stages):
            rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)
            pooled = engine.fuse_semantic(engine.roi_extractor(c5, rois),
                                          emb, rois, "bbox")
            want = engine.model.bbox_stage(pooled, st)
            got = engine16.model.bbox_stage(pooled, st)
            worst = [max(a, b) for a, b in zip(worst, head_budget(got, want))]
            if st < engine.num_stages - 1:
                boxes = engine.refine(boxes, *want, st, x[1])
        if engine.with_mask:
            dets = engine.simple_test(*x)[0]
            rois = torch.cat([torch.zeros_like(dets[:, :1]), dets[:, :4]
                              * mean_scale(x[3])], 1)
            pooled = engine.fuse_semantic(engine.mask_roi_extractor(c5, rois),
                                          emb, rois, "mask")
            if engine.num_mask_stages == 1:
                worst[0] = max(worst[0], rel(engine16.model.mask_head(pooled),
                                             engine.model.mask_head(pooled)))
            else:
                last = None
                for head, head16 in zip(engine.model.mask_head,
                                        engine16.model.mask_head):
                    want, feat = head(pooled, last, return_feat=True)
                    worst[0] = max(worst[0], rel(head16(pooled, last), want))
                    last = feat
    log(f"{prefix} {type(engine).__name__} bf16 heads on the f32 engine's inputs "
        f"against the f32 heads ("
        + ("the semantic head, " if emb is not None else "")
        + f"{engine.num_stages} box stage(s)"
        + (f", {engine.num_mask_stages} mask head(s)" if engine.with_mask
           else "")
        + f"): max |Δcls|/max(|cls|, 1) {worst[0]:.3g}, max |Δreg| "
        f"{worst[1]:.3g} (limits {BF16_CLS_BUDGET}, {BF16_REG_BUDGET})")
    if not (worst[0] <= BF16_CLS_BUDGET and worst[1] <= BF16_REG_BUDGET):
        raise RuntimeError(f"{prefix} the bf16 {type(engine).__name__} heads are "
                           "outside the bf16 budget")
    return worst


def zoo_train_batch(np, name, seed=4):
    """One image of the model's operating size in the video layout (1
    frame) with 4 ground truths and their masks, rectangles and ellipses
    (for the FPN models two of them 28-44 px); for HTC also a
    ``gt_semantic_seg`` at the fusion level's stride of 8 (100×168): each
    box's class inside it, 255 (ignored) on a border around it, 0
    elsewhere."""
    img, ish, psh, _ = zoo_image(np, name, seed)
    h, w = ZOO_SIZES[name][1]
    rng = np.random.default_rng(seed)
    g = 4
    boxes = np.zeros((1, g, 4), np.float32)
    masks = np.zeros((1, g, h, w), np.float32)
    yy, xx = np.mgrid[:h, :w]
    ch, cw = ZOO_SIZES[name][0]
    for i in range(g):
        if name in ("htc", "cascade_dcn") and i >= 2:
            # near the 32-px anchors of the one-level RPN on P2: the only
            # boxes its anchors reach IoU 0.3 with
            bw, bh = rng.uniform(28, 44), rng.uniform(28, 44)
        else:
            bw, bh = rng.uniform(0.15, 0.4) * cw, rng.uniform(0.15, 0.4) * ch
        x0, y0 = rng.uniform(0, cw - bw), rng.uniform(0, ch - bh)
        boxes[0, i] = [x0, y0, x0 + bw - 1, y0 + bh - 1]
        if i % 2:
            masks[0, i] = (((xx - x0 - bw / 2) / (bw / 2)) ** 2
                           + ((yy - y0 - bh / 2) / (bh / 2)) ** 2) <= 1
        else:
            masks[0, i, int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = 1
    n_cls = 31 if name == "cascade" else 81
    labels = rng.integers(1, n_cls, (1, g))
    batch = dict(imgs=img, gt_bboxes=boxes, gt_labels=labels,
                 gt_mask=np.ones((1, g), bool), gt_masks=masks,
                 img_shape=ish[None], pad_shape=psh[None])
    if name == "htc":
        seg = np.zeros((1, h // 8, w // 8), np.int64)
        for i in range(g):
            x1, y1, x2, y2 = (boxes[0, i] / 8).round().astype(int)
            seg[0, max(y1 - 1, 0):y2 + 2, max(x1 - 1, 0):x2 + 2] = 255
            seg[0, y1 + 1:y2, x1 + 1:x2] = labels[0, i]
        batch["gt_semantic_seg"] = seg
    return batch


def zoo_training(torch, np, name, cfg, prefix="[zoo]"):
    """``TwoStageTrainer`` through ``train_detector`` at full width (f32)
    for TRAIN_WARMUP + ZOO_TRAIN_TIMED steps on one synthetic image, frozen
    BNs calibrated on it: finite losses, no attention launch, stage times,
    frozen tensors bitwise and every trainable one moved (HTC: the neck,
    the semantic head and every stage's mask head among them)."""
    import shutil
    from hvrnet_tpu_torch.models.registry import DETECTORS
    work_dir = ROOT / "build" / f"chip_smoke_zoo_{name}"
    shutil.rmtree(work_dir, ignore_errors=True)
    batch = zoo_train_batch(np, name)
    c = cfg.as_dict()
    engine = calibrated_training_engine(
        torch, DETECTORS.get(c["model"]["type"]), c, batch,
        f"{prefix} {name} train", ZOO_TRUNKS[name])
    before = {k: t.clone() for k, t in engine.model.state_dict().items()}
    htc = engine.num_mask_stages > 1
    stages = (("backbone", "rpn", "proposals")
              + (("semantic",) if engine.with_semantic else ())
              + tuple(s for st in range(engine.num_stages)
                      for s in (f"stage{st}",) + ((f"mask{st}",) if htc
                                                  else ()))
              + (("mask",) if engine.with_mask and not htc else ())
              + ("backward", "optimizer"))
    _, summary = timed_training(torch, np, engine, batch, c, work_dir,
                                stages, f"{prefix} {name} train", 0,
                                timed=ZOO_TRAIN_TIMED)
    log(f"{prefix} {type(engine).__name__} training ({CARD}): "
        f"{summary['step_ms']:.3f} ms/step (CUDA events), peak device memory "
        f"{summary['peak_gib']:.2f} GiB")
    trained = ZOO_TRAINED_FPN if engine.model.neck is not None else \
        tuple(p for p in ZOO_TRAINED
              if engine.with_mask or p != "mask_head.")
    # without a semantic head only P2 is read (the RPN runs on it and every
    # RoI is pooled from it, as in the JAX engine): the smoothing convs of
    # the other levels take no gradient
    idle = () if engine.with_semantic or engine.model.neck is None else \
        tuple(f"neck.fpn_convs.{i}." for i in range(
            1, len(engine.model.neck.fpn_convs)))
    check_train_weights(torch, engine, before, f"{prefix} {name} train",
                        trained, idle)
    shutil.rmtree(work_dir, ignore_errors=True)
    del engine
    torch.cuda.empty_cache()
    return summary


def phase_zoo(torch, np):
    """The multi-stage zoo at full width (``zoo_configs``): per model, f32
    and bf16 ``simple_test`` with times, stages, the host paste and peak
    memory; the card's f32 result held to the port's CPU run on the card's
    maps (HTC: its FPN outputs too); the bf16 heads held to the f32 ones;
    ``TwoStageTrainer`` steps; no cv2 on the path.  Returns the runs, each
    with its attention launches (0: the zoo has no relation head), counted
    and checked by ``zoo_serving`` and ``timed_training``."""
    runs = {}
    for name, cfg in zoo_configs().items():
        t0 = time.time()
        engine, engine16 = zoo_engines(torch, np, name, cfg)
        for eng in (engine, engine16):
            tag = f"{type(eng).__name__} {str(eng.dtype)[6:]}"
            runs[f"zoo {name} {str(eng.dtype)[6:]}"] = zoo_serving(
                torch, np, eng, name, tag)[0]
        runs[f"zoo {name} float32"]["cpu_hold"] = zoo_cpu_hold(
            torch, np, engine, cfg, name)
        runs[f"zoo {name} bfloat16"]["bf16_hold"] = zoo_bf16_hold(
            torch, np, engine, engine16, name)
        del engine, engine16
        torch.cuda.empty_cache()
        runs[f"zoo {name} train"] = zoo_training(torch, np, name, cfg)
        log(f"[zoo] {name}: {time.time() - t0:.1f} s")
    if "cv2" in sys.modules:
        raise RuntimeError("[zoo] the zoo's path imported cv2")
    log("[zoo] no attention launch in any serving or training run and no "
        "cv2 import on the zoo's path")
    return runs


DENSE_SIZES = {"retina": ((800, 1333), (800, 1344)),
               "free_anchor": ((800, 1333), (800, 1344)),
               "fcos": ((800, 1333), (800, 1344)),
               "fovea": ((800, 1333), (800, 1344)),
               "ssd": ((300, 300), (300, 300)),
               # [deform]'s single-stage models
               "ga_retina": ((800, 1333), (800, 1344)),
               "ga_rpn": ((800, 1333), (800, 1344)),
               "reppoints": ((800, 1333), (800, 1344)),
               "cascade_dcn": ((800, 1333), (800, 1344))}
DENSE_SOURCES = {
    "retina": "configs/retinanet_r50_fpn_1x.py",
    "free_anchor": "configs/free_anchor/retinanet_free_anchor_r50_fpn_1x.py",
    "fcos": "configs/fcos/fcos_r50_caffe_fpn_gn_1x_4gpu.py",
    "fovea": "configs/foveabox/fovea_r50_fpn_4gpu_1x.py",
    "ssd": "configs/ssd300_coco.py"}
DENSE_BF16 = ("retina", "fcos")     # served in bf16 as well
DENSE_CALLS = 3           # timed simple_test calls after one warm-up call
DENSE_TRAIN_TIMED = 2     # timed training steps after TRAIN_WARMUP
DENSE_HOLD_SEEDS = (0, 1)  # the images of the card-against-CPU hold
# the card's f32 detections against the port's CPU run on the card's maps:
# boxes at the CPU tests' limit (tests/test_torch_port_dense.py), scores at
# [zoo]'s card limit of 1e-5, not the CPU tests' 2e-6: those heads are 16-
# to 64-wide, these four towers of 256 (2304-long dot products each) whose
# summation order the card and the CPU part: on the H100 two images per
# model read 1.03e-6 (SSD300) to 2.41e-6 (FCOS, whose scores are products
# of two sigmoids); boxes up to 2.44e-4 px
DENSE_BOX_TOL, DENSE_SCORE_TOL = 1e-3, 1e-5
# the head's outputs (logits, deltas) at every position, card against CPU
# on the card's maps, max |Δ| / max(|CPU|, 1): 1.5e-6 (SSD300) to 4.3e-6
# (FCOS) on the H100
DENSE_HEAD_TOL = 1e-5
DENSE_STAGES = ("backbone", "head", "loss", "backward", "optimizer")
DENSE_TRAINED = {"ssd": ("backbone.", "bbox_head."),
                 "fpn": ("backbone.layer2.", "backbone.layer3.",
                         "backbone.layer4.", "neck.", "bbox_head.")}


def dense_configs():
    """The single-stage detectors at full width as mmdetection v1.0rc1's
    configs have them (``Config`` objects, 81 classes): RetinaNet and
    FreeAnchor R50-FPN (pytorch style, FPN from C3 with extra convs on C5),
    FCOS R50-caffe-FPN-GN (extra convs on P5 through a ReLU, GroupNorm
    towers), FoveaBox R50-FPN and SSD300 VGG16; each with its test_cfg,
    train_cfg, img_norm_cfg and optimizer keys (FCOS's and FoveaBox's
    ``grad_clip=None`` left out: the port clips at 35 without one)."""
    from hvrnet_tpu_torch.utils.config import Config

    def resnet(style):
        return dict(type="ResNet", depth=50, num_stages=4,
                    strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                    out_indices=(0, 1, 2, 3), frozen_stages=1, style=style)

    def fpn(**extra):
        return dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                    out_channels=256, start_level=1, add_extra_convs=True,
                    num_outs=5, **extra)

    strides = [8, 16, 32, 64, 128]
    focal = dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
                 loss_weight=1.0)
    assigner = dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                                  neg_iou_thr=0.4, min_pos_iou=0,
                                  ignore_iof_thr=-1),
                    allowed_border=-1, pos_weight=-1, debug=False)
    test = dict(nms_pre=1000, min_bbox_size=0, score_thr=0.05,
                nms=dict(type="nms", iou_thr=0.5), max_per_img=100)
    pytorch_norm = dict(mean=[123.675, 116.28, 103.53],
                        std=[58.395, 57.12, 57.375], to_rgb=True)
    sgd = dict(optimizer=dict(type="SGD", lr=0.01, momentum=0.9,
                              weight_decay=0.0001),
               lr_config=dict(policy="step", warmup="linear",
                              warmup_iters=500, warmup_ratio=1.0 / 3,
                              step=[8, 11]))

    def retina_head(kind, stds, loss_weight):
        return dict(type=kind, num_classes=81, in_channels=256,
                    stacked_convs=4, feat_channels=256, octave_base_scale=4,
                    scales_per_octave=3, anchor_ratios=[0.5, 1.0, 2.0],
                    anchor_strides=strides, target_means=[.0] * 4,
                    target_stds=stds, loss_cls=focal,
                    loss_bbox=dict(type="SmoothL1Loss", beta=0.11,
                                   loss_weight=loss_weight))

    clip = dict(optimizer_config=dict(grad_clip=dict(max_norm=35,
                                                     norm_type=2)))
    cfgs = {
        "retina": dict(model=dict(
            type="RetinaNet", backbone=resnet("pytorch"), neck=fpn(),
            bbox_head=retina_head("RetinaHead", [1.0] * 4, 1.0)),
            train_cfg=assigner, test_cfg=test, img_norm_cfg=pytorch_norm,
            **sgd, **clip),
        "free_anchor": dict(model=dict(
            type="RetinaNet", backbone=resnet("pytorch"), neck=fpn(),
            bbox_head=retina_head("FreeAnchorRetinaHead",
                                  [0.1, 0.1, 0.2, 0.2], 0.75)),
            train_cfg=assigner, test_cfg=test, img_norm_cfg=pytorch_norm,
            **sgd, **clip),
        "fcos": dict(model=dict(
            type="FCOS", backbone=resnet("caffe"),
            neck=fpn(extra_convs_on_inputs=False,
                     relu_before_extra_convs=True),
            bbox_head=dict(
                type="FCOSHead", num_classes=81, in_channels=256,
                stacked_convs=4, feat_channels=256, strides=strides,
                loss_cls=focal, loss_bbox=dict(type="IoULoss",
                                               loss_weight=1.0),
                loss_centerness=dict(type="CrossEntropyLoss",
                                     use_sigmoid=True, loss_weight=1.0))),
            train_cfg=assigner, test_cfg=test,
            img_norm_cfg=dict(mean=[102.9801, 115.9465, 122.7717],
                              std=[1.0, 1.0, 1.0], to_rgb=False),
            optimizer=dict(sgd["optimizer"], paramwise_options=dict(
                bias_lr_mult=2., bias_decay_mult=0.)),
            lr_config=dict(sgd["lr_config"], warmup="constant")),
        "fovea": dict(model=dict(
            type="FOVEA", backbone=resnet("pytorch"), neck=fpn(),
            bbox_head=dict(
                type="FoveaHead", num_classes=81, in_channels=256,
                stacked_convs=4, feat_channels=256, strides=strides,
                base_edge_list=[16, 32, 64, 128, 256],
                scale_ranges=((1, 64), (32, 128), (64, 256), (128, 512),
                              (256, 2048)),
                sigma=0.4, with_deform=False,
                loss_cls=dict(focal, gamma=1.50, alpha=0.4),
                loss_bbox=dict(type="SmoothL1Loss", beta=0.11,
                               loss_weight=1.0))),
            train_cfg=dict(), test_cfg=dict(
                nms_pre=1000, score_thr=0.05,
                nms=dict(type="nms", iou_thr=0.5), max_per_img=100),
            img_norm_cfg=pytorch_norm, **sgd),
        "ssd": dict(model=dict(
            type="SingleStageDetector",
            backbone=dict(type="SSDVGG", input_size=300, depth=16,
                          with_last_pool=False, ceil_mode=True,
                          out_indices=(3, 4), out_feature_indices=(22, 34),
                          l2_norm_scale=20),
            neck=None,
            bbox_head=dict(type="SSDHead", input_size=300,
                           in_channels=(512, 1024, 512, 256, 256, 256),
                           num_classes=81,
                           anchor_strides=(8, 16, 32, 64, 100, 300),
                           basesize_ratio_range=(0.15, 0.9),
                           anchor_ratios=([2], [2, 3], [2, 3], [2, 3], [2],
                                          [2]),
                           target_means=(.0, .0, .0, .0),
                           target_stds=(0.1, 0.1, 0.2, 0.2))),
            train_cfg=dict(assigner=dict(type="MaxIoUAssigner",
                                         pos_iou_thr=0.5, neg_iou_thr=0.5,
                                         min_pos_iou=0., ignore_iof_thr=-1,
                                         gt_max_assign_all=False),
                           smoothl1_beta=1., allowed_border=-1, pos_weight=-1,
                           neg_pos_ratio=3, debug=False),
            test_cfg=dict(nms=dict(type="nms", iou_thr=0.45), min_bbox_size=0,
                          score_thr=0.02, max_per_img=200),
            img_norm_cfg=dict(mean=[123.675, 116.28, 103.53], std=[1, 1, 1],
                              to_rgb=True),
            optimizer=dict(type="SGD", lr=2e-3, momentum=0.9,
                           weight_decay=5e-4),
            optimizer_config=dict(),
            lr_config=dict(policy="step", warmup="linear", warmup_iters=500,
                           warmup_ratio=1.0 / 3, step=[16, 22]))}
    return {name: Config(c) for name, c in cfgs.items()}


def dense_image(np, name, cfg, seed=0):
    """The model's operating size: a synthetic BGR scene of its content size
    normalised by its ``img_norm_cfg`` onto its canvas, as from a 1280×768
    original (RetinaNet's family: the keep-ratio resize to 1333×800, scale
    1.0414; SSD: 300×300, scales 0.234 and 0.391); (img (1, H, W, 3),
    img_shape, pad_shape, scale_factor (4,))."""
    content, canvas = DENSE_SIZES[name]
    norm = cfg.img_norm_cfg
    scene = synthetic_image(np, content, seed).astype(np.float32)
    if norm.to_rgb:
        scene = scene[..., ::-1]
    scene = (scene - np.float32(norm.mean)) / np.float32(norm.std)
    img = np.zeros((1,) + canvas + (3,), np.float32)
    img[0, :content[0], :content[1]] = scene
    sx = content[1] / 1280
    sy = sx if name != "ssd" else content[0] / 768
    return (img, np.array(content, np.float32), np.array(canvas, np.float32),
            np.array([sx, sy, sx, sy], np.float32))


# each output conv's logits (or deltas) drawn to this std on the model's
# image; the sigmoid classifiers keep their prior bias −log(99), so a few
# per cent of their scores clear 0.05, and SSD's background logits get a
# bias of DENSE_SSD_BG_BIAS, so that a few per cent of its foreground
# scores clear 0.02 (as a trained detector's mostly-background anchors: a
# few hundred candidates per class reach the NMS)
DENSE_DRAW = {"retina_cls": 1.0, "retina_reg": 0.5, "fcos_cls": 1.5,
              "fcos_reg": 0.5, "fcos_centerness": 1.0, "fovea_cls": 1.0,
              "fovea_reg": 0.5, "cls_convs": 1.0, "reg_convs": 0.5}
DENSE_SSD_BG_BIAS = 5.0


def dense_output_convs(head):
    """(name, conv) of a dense head's output convs: the classifier, the
    regressor (FCOS: and the centerness), or SSD's per-level pairs."""
    from hvrnet_tpu_torch.models.anchor_heads.dense_heads import SSDHead
    if isinstance(head, SSDHead):
        return [(f"{b}.{i}", c) for b in ("cls_convs", "reg_convs")
                for i, c in enumerate(getattr(head, b))]
    return [(n, getattr(head, n)) for n in DENSE_DRAW if hasattr(head, n)
            and n not in ("cls_convs", "reg_convs")]


def dense_scale_heads(torch, np, engine, name, cfg, seed=0):
    """The head's output convs drawn for the image: each one's seeded
    normal kernel scaled so that on its inputs (every level's, from one
    forward pass on the model's image) its outputs have the std of
    ``DENSE_DRAW``; biases kept (the classifiers' prior, zeros elsewhere)
    but SSD's background logits', set to DENSE_SSD_BG_BIAS.  At the init
    (std 0.01; He-normal for SSD) the scores sit at the prior's 0.01, below
    every score_thr, or saturate."""
    import torch.nn.functional as F
    x = dense_image(np, name, cfg)
    head = engine.model.bbox_head
    gen = torch.Generator().manual_seed(seed)
    convs = dense_output_convs(head)
    inputs = {n: [] for n, _ in convs}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, n=n: inputs[n].append(args[0])) for n, m in convs]
    try:
        with torch.no_grad():
            head(engine.backbone_maps(*x[:2]))
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        for n, conv in convs:
            w = torch.randn(conv.weight.shape, generator=gen).to(
                conv.weight.device)
            out = torch.cat([F.conv2d(i.float(), w, None, conv.stride,
                                      conv.padding).flatten()
                             for i in inputs[n]])
            conv.weight.copy_(w * (DENSE_DRAW[n.split(".")[0]] / out.std()))
            if n.startswith("cls_convs"):
                conv.bias[::engine.num_classes] = DENSE_SSD_BG_BIAS


def dense_engines(torch, np, name, cfg):
    """The f32 serving engine on seeded weights (frozen BNs calibrated on
    the image, the output convs drawn for it) and, for DENSE_BF16, a bf16
    one on the same weights, the head's weights pre-cast."""
    from hvrnet_tpu_torch.apis import build_detector
    from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
    t0 = time.time()
    img, ish = dense_image(np, name, cfg)[:2]
    engine = build_detector(cfg.model, test_cfg=cfg.test_cfg, device="cuda")
    n_bn = calibrate_frozen_bn(engine, [dict(img=img, img_shape=ish)])
    dense_scale_heads(torch, np, engine, name, cfg)
    engine16 = None
    if name in DENSE_BF16:
        engine16 = build_detector(cfg.model, test_cfg=cfg.test_cfg,
                                  device="cuda", dtype=torch.bfloat16)
        engine16.load_state_dict(engine.model.state_dict())
        engine16.cast_head_params_bf16()
    log(f"[dense] {type(engine).__name__} ({engine.head_type}) from "
        f"mmdetection v1.0rc1's {DENSE_SOURCES[name]}: "
        f"{engine.num_classes} classes, {n_bn} frozen BNs calibrated on the "
        f"{DENSE_SIZES[name][0][1]}x{DENSE_SIZES[name][0][0]} image, output "
        f"convs drawn for it; f32" + (" and bf16" if engine16 else "")
        + f" engines in {time.time() - t0:.1f} s")
    return engine, engine16


def dense_serving(torch, np, engine, name, cfg, tag, prefix="[dense]"):
    """``simple_test`` on the operating-size image: one warm-up call, then
    DENSE_CALLS timed by CUDA events with the peak memory; one more call
    with the engine's stage timer (backbone + FPN, head towers, decode +
    ``nms_pre``, class-wise NMS).  The attention kernel's count is set to
    0 before the warm-up and read after the last call: no launch.  Checks
    finite boxes, scores in [score_thr, 1] and labels in range.  Returns
    (run, the output)."""
    from hvrnet_tpu_torch.ops.attention import masked_attention
    x = dense_image(np, name, cfg)
    thr = float(engine.decode_cfg["score_thr"])
    masked_attention.launches = 0
    engine.simple_test(*x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: engine.simple_test(*x), iters=DENSE_CALLS,
                 warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    engine.timer = PhaseTimer(torch)
    out = engine.simple_test(*x)
    stages = {k: engine.timer.mean_ms(k) for k in engine.timer.spans}
    engine.timer = None
    launches = masked_attention.launches
    if launches:
        raise RuntimeError(f"{prefix} {tag}: {launches} attention launches")
    dets, labels, keep = (t.cpu().numpy() for t in out)
    kept = dets[keep]
    ok = (np.isfinite(kept).all()
          and ((kept[:, 4] >= thr) & (kept[:, 4] <= 1)).all()
          and ((labels[keep] >= 0)
               & (labels[keep] < engine.num_classes - 1)).all())
    run = dict(ms=ms, peak_gib=peak, stages_ms=stages, kept=int(keep.sum()),
               launches=launches)
    log(f"{prefix} {tag} ({CARD}): simple_test {ms:.3f} ms/image on the "
        f"{DENSE_SIZES[name][1]} canvas (CUDA events, mean of {DENSE_CALLS} "
        f"after a warm-up); stages ms " + json.dumps(
            {k: round(v, 3) for k, v in stages.items()})
        + f"; peak device memory {peak:.2f} GiB; {len(kept)} detections "
        f"kept; valid rows: {ok}; attention launches {launches}")
    if not (ok and len(kept)):
        raise RuntimeError(f"{prefix} {tag}: simple_test gave no or invalid "
                           "detections")
    return run, out


def match_picks(got, want, box_tol, score_tol):
    """Pairs two runs' kept detections (dets, labels, mask): the same
    label, boxes within ``box_tol``, scores within ``score_tol``, each
    pick of ``got`` in row order taking the nearest free row of ``want``.
    Returns (pairs (i, j), got's unmatched rows, want's unmatched rows)."""
    g_rows = got[2].nonzero()[:, 0].tolist()
    free = want[2].nonzero()[:, 0].tolist()
    pairs, lone = [], []
    for i in g_rows:
        hits = [j for j in free if int(want[1][j]) == int(got[1][i])
                and (want[0][j, :4] - got[0][i, :4]).abs().max() <= box_tol
                and abs(float(want[0][j, 4] - got[0][i, 4])) <= score_tol]
        if hits:
            j = min(hits, key=lambda j: abs(j - i))
            free.remove(j)
            pairs.append((i, j))
        else:
            lone.append(i)
    return pairs, lone, free


def dense_cpu_hold(torch, np, engine, name, cfg, prefix="[dense]",
                   seeds=DENSE_HOLD_SEEDS):
    """The card's f32 ``simple_test`` against the port's CPU run of the same
    weights, both fed the card's neck (or backbone) maps, on each image of
    DENSE_HOLD_SEEDS: the head's outputs at every position within
    DENSE_HEAD_TOL of max(|CPU|, 1); the same picks with the same labels,
    boxes within DENSE_BOX_TOL px and scores within DENSE_SCORE_TOL
    (``match_picks``), in the same rows except where two picks' scores lie
    within DENSE_SCORE_TOL of each other (an order the rounding may swap);
    a pick without a partner only where both runs fill ``max_per_img`` and
    its score is within DENSE_SCORE_TOL of the last kept (the quota's edge,
    where a candidate just below may take its place).  First, the card's
    maps against the CPU's own on the first image (max |Δ| / max |CPU| per
    level within ZOO_FPN_TOL).  Returns the worst differences and the
    counts of reordered and edge picks."""
    from hvrnet_tpu_torch.apis import build_detector
    cpu = build_detector(cfg.model, test_cfg=cfg.test_cfg, device="cpu")
    cpu.load_state_dict(host_state_dict(engine))
    x = dense_image(np, name, cfg)
    with torch.no_grad():
        card = engine.backbone_maps(*x[:2])
        want = cpu.backbone_maps(*x[:2])
    map_err = max(((c.cpu() - w).abs().max() / w.abs().max()).item()
                  for c, w in zip(card, want))
    log(f"{prefix} {type(engine).__name__} f32 maps on the card against the "
        f"port's CPU run of the same backbone"
        + (" and neck" if engine.model.neck is not None else "")
        + f": worst level max |Δ|/max|CPU| {map_err:.3g} (limit "
        f"{ZOO_FPN_TOL})")
    if map_err > ZOO_FPN_TOL:
        raise RuntimeError(f"{prefix} the card's {name} maps are not the "
                           "CPU's")
    real = engine.backbone_maps
    worst = dict(maps=map_err, head=0.0, box=0.0, score=0.0, reordered=0,
                 edge=0)
    for seed in seeds:
        x = dense_image(np, name, cfg, seed)
        with torch.no_grad():
            maps = real(*x[:2])
            host = to_device(maps, "cpu")
            head = max(((a.cpu() - b).abs().max()
                        / b.abs().max().clamp_min(1.0)).item()
                       for a, b in zip(sum(engine.model.bbox_head(maps), ()),
                                       sum(cpu.model.bbox_head(host), ())))
        cpu.backbone_maps = lambda img, ish: host
        engine.backbone_maps = lambda img, ish: maps
        try:
            got = [t.cpu() for t in engine.simple_test(*x)]
        finally:
            engine.backbone_maps = real
        want = cpu.simple_test(*x)
        pairs, lone_g, lone_w = match_picks(got, want, DENSE_BOX_TOL,
                                            DENSE_SCORE_TOL)
        full = bool(got[2].all() and want[2].all())
        last = min(got[0][got[2], 4].min(), want[0][want[2], 4].min())
        at_edge = all(full and float(d[r, 4] - last) <= DENSE_SCORE_TOL
                      for d, rows in ((got[0], lone_g), (want[0], lone_w))
                      for r in rows)
        swapped = [(i, j) for i, j in pairs if i != j]
        tie = all(abs(float(want[0][i, 4] - want[0][j, 4]))
                  <= DENSE_SCORE_TOL for i, j in swapped)
        box = max((got[0][i, :4] - want[0][j, :4]).abs().max().item()
                  for i, j in pairs) if pairs else 0.0
        score = max(abs(float(got[0][i, 4] - want[0][j, 4]))
                    for i, j in pairs) if pairs else 0.0
        same = (int(got[2].sum()) == int(want[2].sum()) and at_edge and tie)
        worst = dict(maps=map_err, head=max(worst["head"], head),
                     box=max(worst["box"], box),
                     score=max(worst["score"], score),
                     reordered=max(worst["reordered"], len(swapped)),
                     edge=max(worst["edge"], len(lone_g)))
        log(f"{prefix} {type(engine).__name__} {engine.head_type} f32 on the "
            f"card against the port's CPU run on the card's maps, image "
            f"seed {seed}: head outputs max |Δ|/max(|CPU|, 1) {head:.3g} "
            f"(limit {DENSE_HEAD_TOL}); {len(pairs)} of {int(want[2].sum())} "
            f"picks matched (label, box, score), {len(swapped)} of them in "
            f"other rows across a score tie within {DENSE_SCORE_TOL}, "
            f"{len(lone_g)} / {len(lone_w)} unmatched at the quota's edge; "
            f"max |Δbox| {box:.3g} px (limit {DENSE_BOX_TOL}), max |Δscore| "
            f"{score:.3g} ({DENSE_SCORE_TOL}); held {same}")
        if not (same and pairs and head <= DENSE_HEAD_TOL):
            raise RuntimeError(f"{prefix} {name}, image seed {seed}: the "
                               "card's f32 result is not the CPU's")
    return worst


def dense_bf16_hold(torch, np, engine, engine16, name, cfg, prefix="[dense]"):
    """bf16 against f32 by depth on the model's image: the bf16 engine's
    neck maps against the f32 ones (max |Δ|/max|f32| per level, reported),
    then the bf16 head on the f32 maps against the f32 head within the
    bf16 budget (``head_budget``: the classifier logits, and FCOS's
    centerness, as the cls; the deltas, FCOS's log-distances, as the
    reg)."""
    from hvrnet_tpu_torch.engine.detector import f32_precision
    x = dense_image(np, name, cfg)
    with torch.no_grad(), f32_precision():
        maps = engine.backbone_maps(*x[:2])
        maps16 = engine16.backbone_maps(*x[:2])
        depth = [((m16.float() - m).abs().max() / m.abs().max()).item()
                 for m16, m in zip(maps16, maps)]
        want = engine.model.bbox_head(maps)
        got = engine16.model.bbox_head(maps)

    def cls_reg(out):
        if len(out) == 3:       # FCOS: logits and centerness; log-distances
            return list(out[0]) + list(out[2]), [torch.log(r) for r in out[1]]
        return list(out[0]), list(out[1])

    cls, reg = head_budget(cls_reg(got), cls_reg(want))
    log(f"{prefix} {type(engine).__name__} {engine.head_type} bf16 by depth: "
        f"neck maps max |Δ|/max|f32| per level "
        + ", ".join(f"{d:.3g}" for d in depth)
        + f"; the bf16 head on the f32 maps: max |Δcls|/max(|cls|, 1) "
        f"{cls:.3g}, max |Δreg| {reg:.3g} (limits {BF16_CLS_BUDGET}, "
        f"{BF16_REG_BUDGET})")
    if not (cls <= BF16_CLS_BUDGET and reg <= BF16_REG_BUDGET
            and all(np.isfinite(depth))):
        raise RuntimeError(f"{prefix} the bf16 {name} head is outside the "
                           "bf16 budget")
    return dict(maps=depth, cls=cls, reg=reg)


def dense_train_batch(np, name, cfg, seed=4):
    """One image of the model's operating size in the video layout (1
    frame) with ground truths: for the FPN models 4 boxes of 0.1-0.5 of
    the content; for SSD300 one per level, each of its level's anchor size
    and centred on one of its anchors, so that every level's output convs
    (SSD's are per level) get a positive and move."""
    img, ish, psh, _ = dense_image(np, name, cfg, seed)
    rng = np.random.default_rng(seed)
    ch, cw = DENSE_SIZES[name][0]
    if name == "ssd":
        # per level a square of about its anchors' geometric mean size
        # (21-315 px) on the level's anchor centre nearest the middle
        boxes = []
        for s, st in zip((30, 70, 125, 180, 235, 280),
                         (8, 16, 32, 64, 100, 300)):
            c = (st - 1) / 2 + st * (-(-300 // st) // 2)
            boxes.append([c - s / 2, c - s / 2, c + s / 2 - 1,
                          c + s / 2 - 1])
        boxes = np.array(boxes, np.float32)[None]
    else:
        g = 4
        boxes = np.zeros((1, g, 4), np.float32)
        for i in range(g):
            bw, bh = rng.uniform(0.1, 0.5) * cw, rng.uniform(0.1, 0.5) * ch
            x0, y0 = rng.uniform(0, cw - bw), rng.uniform(0, ch - bh)
            boxes[0, i] = [x0, y0, x0 + bw - 1, y0 + bh - 1]
    g = boxes.shape[1]
    return dict(imgs=img, gt_bboxes=boxes,
                gt_labels=rng.integers(1, 81, (1, g)),
                gt_mask=np.ones((1, g), bool), img_shape=ish[None],
                pad_shape=psh[None])


def dense_training(torch, np, name, cfg, prefix="[dense]"):
    """The model's trainer through ``train_detector`` at full width (f32)
    for TRAIN_WARMUP + DENSE_TRAIN_TIMED steps on one synthetic image,
    frozen BNs calibrated on it: finite losses, ``num_pos`` ≥ 1 where the
    trainer logs it, no attention launch, stage times (backbone and neck,
    head, loss, backward, optimizer), frozen tensors bitwise (the stem and
    ``layer1``, every frozen-BN statistic) and every trainable one moved
    (the neck and the head's output convs among them)."""
    import shutil
    from hvrnet_tpu_torch.models.registry import DETECTORS
    work_dir = ROOT / "build" / f"chip_smoke_dense_{name}"
    shutil.rmtree(work_dir, ignore_errors=True)
    batch = dense_train_batch(np, name, cfg)
    c = cfg.as_dict()
    engine = calibrated_training_engine(
        torch, DETECTORS.get(c["model"]["type"]), c, batch,
        f"{prefix} {name} train", "VGG16" if name == "ssd" else "R50-FPN")
    before = {k: t.clone() for k, t in engine.model.state_dict().items()}
    trainer, summary = timed_training(
        torch, np, engine, batch, c, work_dir, DENSE_STAGES,
        f"{prefix} {name} train", 0, timed=DENSE_TRAIN_TIMED)
    logs = [json.loads(line) for line in
            (work_dir / "train_log.jsonl").read_text().splitlines()]
    n_pos = [lg["num_pos"] for lg in logs if "num_pos" in lg]
    log(f"{prefix} {type(engine).__name__} {engine.head_type} training via "
        f"{type(trainer).__name__} ({CARD}): {summary['step_ms']:.3f} "
        f"ms/step (CUDA events), peak device memory "
        f"{summary['peak_gib']:.2f} GiB; num_pos per step {n_pos}")
    if n_pos and min(n_pos) < 1:
        raise RuntimeError(f"{prefix} {name} trained without positives")
    check_train_weights(torch, engine, before, f"{prefix} {name} train",
                        DENSE_TRAINED["ssd" if name == "ssd" else "fpn"])
    summary["trainer"] = type(trainer).__name__
    shutil.rmtree(work_dir, ignore_errors=True)
    del engine, trainer
    torch.cuda.empty_cache()
    return summary


def phase_dense(torch, np):
    """The single-stage detectors at full width (``dense_configs``): per
    model, f32 ``simple_test`` (and bf16 for DENSE_BF16) with times,
    stages and peak memory; the card's f32 result held to the port's CPU
    run on the card's maps on DENSE_HOLD_SEEDS; bf16 against f32 by depth;
    the model's trainer for 2 + 2 steps; no attention launch and no cv2
    on the path.  Returns the runs, each with its attention launches (0)."""
    runs = {}
    for name, cfg in dense_configs().items():
        t0 = time.time()
        engine, engine16 = dense_engines(torch, np, name, cfg)
        for eng in (engine, engine16):
            if eng is None:
                continue
            tag = f"{name} {str(eng.dtype)[6:]}"
            runs[f"dense {tag}"] = dense_serving(torch, np, eng, name, cfg,
                                                 f"{type(eng).__name__} "
                                                 f"{tag}")[0]
        runs[f"dense {name} float32"]["cpu_hold"] = dense_cpu_hold(
            torch, np, engine, name, cfg)
        if engine16 is not None:
            runs[f"dense {name} bfloat16"]["bf16_hold"] = dense_bf16_hold(
                torch, np, engine, engine16, name, cfg)
        del engine, engine16
        torch.cuda.empty_cache()
        runs[f"dense {name} train"] = dense_training(torch, np, name, cfg)
        log(f"[dense] {name}: {time.time() - t0:.1f} s")
    if "cv2" in sys.modules:
        raise RuntimeError("[dense] the dense detectors' path imported cv2")
    log("[dense] no attention launch in any serving or training run and no "
        "cv2 import on the path")
    return runs


# [deform]: the deformable half of the dense family at full width, as
# mmdetection v1.0rc1's configs have them (DEFORM_SOURCES), 81 classes,
# 800×1333 on 800×1344.  Config keys the JAX modules do not read are left
# out, as ``dense_configs`` leaves them: RepPoints' GroupNorm ``norm_cfg``
# (the FPN's and the head's) and ``gradient_mul``, the GA heads'
# ``anchor_base_sizes`` and samplers; GA-RPN's test_cfg is the JAX RPN
# engine's single-stage form (one NMS over the levels' union: ``nms_pre``,
# ``nms.iou_thr`` = ``nms_thr``, ``max_per_img`` = ``max_num``, score_thr
# 0), and GA-RPN serves only (the JAX package trains no RPN).
DEFORM_SOURCES = {
    "ga_retina": "configs/guided_anchoring/ga_retinanet_r50_caffe_fpn_1x.py",
    "ga_rpn": "configs/guided_anchoring/ga_rpn_r50_caffe_fpn_1x.py",
    "reppoints": "configs/reppoints/reppoints_moment_r50_fpn_1x.py",
    "cascade_dcn": "configs/dcn/cascade_rcnn_dconv_c3-c5_r50_fpn_1x.py"}
DEFORM_BF16 = ("ga_retina", "reppoints")    # served in bf16 as well
DEFORM_TRAIN = ("ga_retina", "reppoints", "cascade_dcn")
DEFORM_HOLD_SEEDS = (0,)  # the image of the card-against-CPU hold
# each dense head's drawn convs in the order they feed each other, with the
# std of their outputs on the image's maps (``deform_draw_heads``): the
# location branch (bias at the prior −log(99)) spreads across
# loc_filter_thr, the shape branch reshapes the squares, the offset convs
# and RepPoints' init points move the deformable samples by about 1.5 px
DEFORM_DRAW = {
    "ga_retina": (("conv_shape", 0.5), ("conv_loc", 2.0),
                  ("feature_adaption_cls.conv_offset", 1.5),
                  ("feature_adaption_reg.conv_offset", 1.5),
                  ("retina_cls", 1.0), ("retina_reg", 0.5)),
    "ga_rpn": (("conv_shape", 0.5), ("conv_loc", 2.0),
               ("feature_adaption.conv_offset", 1.5), ("conv_cls", 1.0),
               ("conv_reg", 0.5)),
    "reppoints": (("reppoints_pts_init_out", 1.5), ("reppoints_cls_out", 1.0),
                  ("reppoints_pts_refine_out", 0.5))}
DEFORM_DCN_PX = 1.5       # the std of the dcn blocks' drawn offsets, px
# a dcn block on the card against the same block on the CPU fed the card's
# input, max |Δ| / max |CPU|: one block's rounding, not compounded (the
# trunk's maps are not held whole: offsets read from random calibrated
# maps feed the rounding back into the sampling, so the card's and the
# CPU's trunks part by orders of magnitude more than a plain one's)
DEFORM_BLOCK_TOL = 1e-4
DEFORM_OP_TOL = 1e-5      # deform_conv2d card against CPU, of max |CPU|
DEFORM_OP_HW = (800, 1344)  # the canvas whose shapes deform_op_times times


def deform_configs():
    """The deformable models at full width (``Config`` objects):
    GA-RetinaNet and GA-RPN R50-caffe-FPN, RepPoints moment R50-FPN and
    Cascade R-CNN R50-FPN with dcn on c3-c5, each with its test_cfg,
    train_cfg, img_norm_cfg and optimizer keys (the module comments above
    say what was left out)."""
    from hvrnet_tpu_torch.utils.config import Config

    def resnet(style):
        return dict(type="ResNet", depth=50, num_stages=4,
                    strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                    out_indices=(0, 1, 2, 3), frozen_stages=1, style=style)

    def fpn(**kw):
        return dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                    out_channels=256, num_outs=5, **kw)

    focal = dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
                 loss_weight=1.0)
    caffe_norm = dict(mean=[102.9801, 115.9465, 122.7717],
                      std=[1.0, 1.0, 1.0], to_rgb=False)
    pytorch_norm = dict(mean=[123.675, 116.28, 103.53],
                        std=[58.395, 57.12, 57.375], to_rgb=True)
    sgd = dict(optimizer=dict(type="SGD", lr=0.01, momentum=0.9,
                              weight_decay=0.0001),
               optimizer_config=dict(grad_clip=dict(max_norm=35,
                                                    norm_type=2)),
               lr_config=dict(policy="step", warmup="linear",
                              warmup_iters=500, warmup_ratio=1.0 / 3,
                              step=[8, 11]))
    ga = dict(octave_base_scale=4, scales_per_octave=3,
              octave_ratios=[0.5, 1.0, 2.0], anchoring_means=[.0] * 4,
              anchoring_stds=[0.07, 0.07, 0.14, 0.14], target_means=[.0] * 4,
              target_stds=[0.07, 0.07, 0.11, 0.11], loc_filter_thr=0.01,
              loss_loc=focal, loss_shape=dict(type="BoundedIoULoss",
                                              beta=0.2, loss_weight=1.0))
    test = dict(nms_pre=1000, min_bbox_size=0, score_thr=0.05,
                nms=dict(type="nms", iou_thr=0.5), max_per_img=100)
    cascade = htc_config().as_dict()
    model = cascade["model"]
    for key in ("mask_roi_extractor", "mask_head", "semantic_roi_extractor",
                "semantic_head", "semantic_fusion", "interleaved",
                "mask_info_flow"):
        model.pop(key)
    model.update(type="CascadeRCNN", backbone=dict(
        model["backbone"], dcn=dict(modulated=False, deformable_groups=1,
                                    fallback_on_stride=False),
        stage_with_dcn=(False, True, True, True)))
    for stage in cascade["train_cfg"]["rcnn"]:
        stage.pop("mask_size")
    cascade["test_cfg"]["rcnn"] = dict(score_thr=0.05, nms=dict(
        type="nms", iou_thr=0.5), max_per_img=100)
    cascade["lr_config"]["step"] = [8, 11]
    cfgs = {
        "ga_retina": dict(model=dict(
            type="RetinaNet", backbone=resnet("caffe"),
            neck=fpn(start_level=1, add_extra_convs=True),
            bbox_head=dict(type="GARetinaHead", num_classes=81,
                           in_channels=256, stacked_convs=4,
                           feat_channels=256, anchor_strides=[8, 16, 32, 64,
                                                              128],
                           loss_cls=focal, loss_bbox=dict(
                               type="SmoothL1Loss", beta=0.04,
                               loss_weight=1.0), **ga)),
            train_cfg=dict(
                ga_assigner=dict(type="ApproxMaxIoUAssigner",
                                 pos_iou_thr=0.5, neg_iou_thr=0.4,
                                 min_pos_iou=0.4, ignore_iof_thr=-1),
                assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                              neg_iou_thr=0.5, min_pos_iou=0.0,
                              ignore_iof_thr=-1),
                allowed_border=-1, pos_weight=-1, center_ratio=0.2,
                ignore_ratio=0.5, debug=False),
            test_cfg=test, img_norm_cfg=caffe_norm, **sgd),
        "ga_rpn": dict(model=dict(
            type="RPN", backbone=resnet("caffe"), neck=fpn(),
            bbox_head=dict(type="GARPNHead", in_channels=256,
                           feat_channels=256, num_classes=2,
                           anchor_strides=[4, 8, 16, 32, 64],
                           **dict(ga, octave_base_scale=8))),
            test_cfg=dict(nms_pre=1000, score_thr=0.0,
                          nms=dict(type="nms", iou_thr=0.7),
                          max_per_img=300),
            img_norm_cfg=caffe_norm),
        "reppoints": dict(model=dict(
            type="RepPointsDetector", backbone=resnet("pytorch"),
            neck=fpn(start_level=1, add_extra_convs=True),
            bbox_head=dict(
                type="RepPointsHead", num_classes=81, in_channels=256,
                feat_channels=256, point_feat_channels=256, stacked_convs=3,
                num_points=9, point_strides=[8, 16, 32, 64, 128],
                point_base_scale=4, loss_cls=focal,
                loss_bbox_init=dict(type="SmoothL1Loss", beta=0.11,
                                    loss_weight=0.5),
                loss_bbox_refine=dict(type="SmoothL1Loss", beta=0.11,
                                      loss_weight=1.0),
                transform_method="moment")),
            train_cfg=dict(
                init=dict(assigner=dict(type="PointAssigner", scale=4,
                                        pos_num=1),
                          allowed_border=-1, pos_weight=-1, debug=False),
                refine=dict(assigner=dict(type="MaxIoUAssigner",
                                          pos_iou_thr=0.5, neg_iou_thr=0.4,
                                          min_pos_iou=0, ignore_iof_thr=-1),
                            allowed_border=-1, pos_weight=-1, debug=False)),
            test_cfg=test, img_norm_cfg=pytorch_norm, **sgd),
        "cascade_dcn": cascade}
    return {name: Config(c) for name, c in cfgs.items()}


def module_spans(torch, modules):
    """A context that records a CUDA-event span around every forward call
    of ``modules`` (hooks); ``ms()`` sums them after a synchronisation,
    ``calls()`` counts them."""
    spans = []

    def start(mod, args):
        spans.append([torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)])
        spans[-1][0].record()

    def stop(mod, args, out):
        spans[-1][1].record()

    class Spans(contextlib.AbstractContextManager):
        def __enter__(self):
            self.hooks = [h for m in modules for h in (
                m.register_forward_pre_hook(start),
                m.register_forward_hook(stop))]
            return self

        def __exit__(self, *exc):
            for h in self.hooks:
                h.remove()

        def ms(self):
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in spans)

        def calls(self):
            return len(spans)

    return Spans()


def deform_draw_heads(torch, np, engine, name, cfg, seed=0):
    """The dense head's DEFORM_DRAW convs drawn in turn for the image: each
    one's seeded normal kernel scaled so that on its inputs (one forward
    pass of the head on the model's image, after the convs drawn before
    it) its outputs have their std; biases kept."""
    import torch.nn.functional as F
    x = dense_image(np, name, cfg)
    head = engine.model.bbox_head
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        maps = engine.backbone_maps(*x[:2])
        for n, std in DEFORM_DRAW[name]:
            conv = head.get_submodule(n)
            inputs = []
            hook = conv.register_forward_pre_hook(
                lambda mod, args: inputs.append(args[0]))
            try:
                head(maps)
            finally:
                hook.remove()
            w = torch.randn(conv.weight.shape, generator=gen).to(
                conv.weight.device)
            out = torch.cat([F.conv2d(i.float(), w, None, conv.stride,
                                      conv.padding).flatten()
                             for i in inputs])
            conv.weight.copy_(w * (std / out.std()))


def deform_draw_offsets(torch, np, engine, name, seed=0):
    """Every dcn block's ``conv2_offset`` (zero at the init, where the
    deformable conv is the plain 3×3) drawn in turn, block by block, so
    that on the model's image its 18 offsets have a std of DEFORM_DCN_PX
    pixels; returns the blocks."""
    import torch.nn.functional as F
    x = zoo_image(np, name)
    gen = torch.Generator().manual_seed(seed)
    blocks = [m for m in engine.model.backbone.modules()
              if getattr(m, "with_dcn", False)]
    with torch.no_grad():
        for blk in blocks:
            conv = blk.conv2_offset
            inputs = []
            hook = conv.register_forward_pre_hook(
                lambda mod, args: inputs.append(args[0]))
            try:
                engine.backbone_maps(*x[:2])
            finally:
                hook.remove()
            w = torch.randn(conv.weight.shape, generator=gen).to(
                conv.weight.device)
            out = F.conv2d(inputs[0].float(), w, None, conv.stride,
                           conv.padding, conv.dilation)[:, :18]
            conv.weight.copy_(w * (DEFORM_DCN_PX / out.std()))
    return blocks


def deform_engines(torch, np, name, cfg):
    """The f32 serving engine on seeded weights: frozen BNs calibrated on
    the image, then the dense heads' convs drawn for it
    (``deform_draw_heads``), or the dcn offsets drawn and the BNs
    calibrated again (Cascade R-CNN, whose stage heads are drawn as
    HTC's, ``zoo_scale_heads``); and, for DEFORM_BF16, a bf16 engine on
    the same weights, the head's weights pre-cast."""
    from hvrnet_tpu_torch.apis import build_detector
    from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
    t0 = time.time()
    dense = name != "cascade_dcn"
    img, ish = (dense_image(np, name, cfg) if dense
                else zoo_image(np, name))[:2]
    engine = build_detector(cfg.model, test_cfg=cfg.test_cfg, device="cuda")
    n_bn = calibrate_frozen_bn(engine, [dict(img=img, img_shape=ish)])
    if dense:
        deform_draw_heads(torch, np, engine, name, cfg)
    else:
        n_dcn = len(deform_draw_offsets(torch, np, engine, name))
        calibrate_frozen_bn(engine, [dict(img=img, img_shape=ish)])
        zoo_scale_heads(torch, np, engine, name)
    engine16 = None
    if name in DEFORM_BF16:
        engine16 = build_detector(cfg.model, test_cfg=cfg.test_cfg,
                                  device="cuda", dtype=torch.bfloat16)
        engine16.load_state_dict(engine.model.state_dict())
        engine16.cast_head_params_bf16()
    head = (engine.head_type if dense else
            f"{engine.num_stages} stages, {n_dcn} dcn blocks")
    log(f"[deform] {type(engine).__name__} ({head}) from mmdetection "
        f"v1.0rc1's {DEFORM_SOURCES[name]}: {engine.num_classes} classes, "
        f"{n_bn} frozen BNs calibrated on the {DENSE_SIZES[name][0][1]}x"
        f"{DENSE_SIZES[name][0][0]} image, "
        + ("the head's offset, location, shape and output convs"
           if dense else "the dcn offsets and the stage heads")
        + " drawn for it; f32" + (" and bf16" if engine16 else "")
        + f" engines in {time.time() - t0:.1f} s")
    return engine, engine16


def deform_parts(torch, np, engine, name, cfg):
    """One more ``simple_test`` of the f32 engine with CUDA-event spans
    around its deformable parts: the head's deformable convs (their
    offset convs apart) or the backbone's dcn blocks; and, in another call,
    the samples' spread: the std of the offsets and the share of samples
    off the integer grid by more than 0.1 px and outside the map by up to
    a pixel (the border rule's (−1, 0) and (H − 1, H))."""
    from hvrnet_tpu_torch.ops.deform import DeformConv2d
    dense = name != "cascade_dcn"
    x = (dense_image if dense else zoo_image)(np, name, *(
        (cfg,) if dense else ()))
    model = engine.model
    convs = [m for m in model.modules() if isinstance(m, DeformConv2d)]
    blocks = [m for m in model.backbone.modules()
              if getattr(m, "with_dcn", False)]
    stats = []

    def sample(mod, args, out):
        xin, off = args[0], args[1]
        h, w = xin.shape[-2:]
        k = mod.kernel_size[0]
        ho, wo = off.shape[-2:]
        taps = torch.arange(k, device=off.device, dtype=torch.float32)
        o = off.float().reshape(off.shape[0], -1, k, k, 2, ho, wo)
        base_y = torch.arange(ho, device=off.device) * mod.stride[0] \
            - mod.padding[0]
        base_x = torch.arange(wo, device=off.device) * mod.stride[0] \
            - mod.padding[0]
        ys = base_y[:, None] + taps[:, None, None, None] * mod.dilation[0] \
            + o[..., 0, :, :]
        xs = base_x[None, :] + taps[None, :, None, None] * mod.dilation[0] \
            + o[..., 1, :, :]
        frac = torch.minimum((ys - ys.round()).abs(), (xs - xs.round()).abs())
        edge = ((ys > -1) & (ys < 0)) | ((ys > h - 1) & (ys < h)) \
            | ((xs > -1) & (xs < 0)) | ((xs > w - 1) & (xs < w))
        stats.append((float(o.std()), float((frac > 0.1).float().mean()),
                      float(edge.float().mean()), ys.numel()))

    with torch.no_grad():
        with module_spans(torch, convs) as conv_t, \
                module_spans(torch, blocks) as block_t:
            engine.simple_test(*x)
        parts = dict(deform_convs_ms=conv_t.ms(), dcn_blocks_ms=block_t.ms(),
                     deform_calls=conv_t.calls())
        hooks = [m.register_forward_hook(sample) for m in convs]
        try:
            engine.simple_test(*x)      # the samples' spread, untimed
        finally:
            for hk in hooks:
                hk.remove()
    n = sum(s[3] for s in stats)
    spread = dict(offset_std=max(s[0] for s in stats),
                  off_grid=sum(s[1] * s[3] for s in stats) / n,
                  at_border=sum(s[2] * s[3] for s in stats) / n,
                  convs=len(stats))
    log(f"[deform] {type(engine).__name__} f32 deformable parts ({CARD}): "
        f"{parts['deform_calls']} calls of its {len(convs)} deformable convs "
        f"{parts['deform_convs_ms']:.3f} ms"
        + (f" ({len(blocks)} dcn blocks whole {parts['dcn_blocks_ms']:.3f} "
           "ms)" if blocks else "")
        + f" of one simple_test (CUDA events); samples: offsets' std up to "
        f"{spread['offset_std']:.3g} px, {spread['off_grid']:.3f} of them "
        f"off the integer grid by > 0.1 px, {spread['at_border']:.4f} in "
        f"(-1, 0) or (H-1, H) on an axis")
    if not (spread["off_grid"] > 0.5 and spread["at_border"] > 0):
        raise RuntimeError(f"[deform] {name}: the drawn offsets leave the "
                           "samples on the grid or away from the borders")
    return dict(parts, **spread)


def deform_block_hold(torch, np, engine, name):
    """Each dcn block of the card's f32 backbone on the model's image
    against the same block's CPU run fed the card's input to it: max |Δ| /
    max |CPU| within DEFORM_BLOCK_TOL.  Returns the worst."""
    import copy
    x = zoo_image(np, name)
    blocks = [(n, m) for n, m in engine.model.backbone.named_modules()
              if getattr(m, "with_dcn", False)]
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, (args[0], out)))
        for n, m in blocks]
    try:
        with torch.no_grad():
            engine.backbone_maps(*x[:2])
    finally:
        for h in hooks:
            h.remove()
    errs = []
    with torch.no_grad():
        for n, m in blocks:
            inp, out = seen[n]
            want = copy.deepcopy(m).cpu()(inp.cpu())
            errs.append(((out.cpu() - want).abs().max()
                         / want.abs().max()).item())
    log(f"[deform] {type(engine).__name__} f32 dcn blocks ({len(blocks)}: "
        "layer2-layer4) on the card against each block's CPU run on the "
        "card's input to it: max |Δ|/max|CPU| per block "
        + ", ".join(f"{e:.3g}" for e in errs)
        + f" (limit {DEFORM_BLOCK_TOL})")
    if max(errs) > DEFORM_BLOCK_TOL:
        raise RuntimeError("[deform] a dcn block on the card is not the "
                           "CPU's")
    return max(errs)


def deform_bf16_hold(torch, np, engine, engine16, name, cfg):
    """bf16 against f32 by depth on the model's image: the bf16 engine's
    neck maps against the f32 ones (max |Δ|/max|f32| per level, reported);
    then every conv of the bf16 head, deformable ones included, on the
    f32 head's inputs to it (its maps, offsets and masks) against the f32
    conv: max |Δ|/max(|f32|, 1) within the bf16 budget's cls limit.  The
    whole bf16 head on the f32 maps is reported (``head_budget``: the
    classifier and location logits as the cls; the deltas, shapes and
    points as the reg), not held: its offsets (GA's offset convs,
    RepPoints' init points) come out of bf16 convs rounded to bf16, as in
    the JAX head, and a random map's rough texture turns that rounding
    into sampled values that part from f32 by more than one layer's."""
    from hvrnet_tpu_torch.engine.detector import f32_precision
    x = dense_image(np, name, cfg)
    head, head16 = engine.model.bbox_head, engine16.model.bbox_head
    convs = {n: m for n, m in head.named_modules()
             if isinstance(m, torch.nn.Conv2d)}
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=n: seen.setdefault(n, []).append(
            (args, out))) for n, m in convs.items()]
    with torch.no_grad(), f32_precision():
        maps = engine.backbone_maps(*x[:2])
        maps16 = engine16.backbone_maps(*x[:2])
        depth = [((m16.float() - m).abs().max() / m.abs().max()).item()
                 for m16, m in zip(maps16, maps)]
        try:
            want = head(maps)
        finally:
            for h in hooks:
                h.remove()
        layers = {}
        for n, calls in seen.items():
            mod16 = head16.get_submodule(n)
            layers[n] = max(
                ((mod16(*args).float() - out).abs().max()
                 / out.abs().max().clamp_min(1.0)).item()
                for args, out in calls)
        got = head16(maps)

    def cls_reg(out):
        if len(out) == 4:       # guided anchoring: cls and loc; reg, shape
            return list(out[0]) + list(out[3]), list(out[1]) + list(out[2])
        return list(out[0]), list(out[1]) + list(out[2])   # RepPoints

    cls, reg = head_budget(cls_reg(got), cls_reg(want))
    worst = max(layers, key=layers.get)
    log(f"[deform] {type(engine).__name__} {engine.head_type} bf16 by depth: "
        f"neck maps max |Δ|/max|f32| per level "
        + ", ".join(f"{d:.3g}" for d in depth)
        + f"; each of the head's {len(layers)} convs on the f32 head's "
        f"inputs: max |Δ|/max(|f32|, 1) up to {layers[worst]:.3g} ({worst}; "
        f"limit {BF16_CLS_BUDGET}); the whole bf16 head on the f32 maps "
        f"(reported): max |Δcls|/max(|cls|, 1) {cls:.3g}, max |Δreg| "
        f"{reg:.3g}")
    if not (layers[worst] <= BF16_CLS_BUDGET and all(np.isfinite(depth))
            and np.isfinite(cls) and np.isfinite(reg)):
        raise RuntimeError(f"[deform] a bf16 {name} head conv is outside the "
                           "bf16 budget")
    return dict(maps=depth, layers=layers, cls=cls, reg=reg)


def deform_op_times(torch, np):
    """``deform_conv2d`` alone (the plain PyTorch im2col, no kernel): GA-
    RetinaNet's 3×3 adaption conv (256 → 256, 4 deformable groups) at each
    FPN level of the DEFORM_OP_HW canvas and the dcn plugin's 3×3 at each R50
    stage it replaces (128, 256, 512 channels at strides 8, 16, 32), f32
    and bf16, offsets of std 1.5 px: ms (CUDA events, mean of 5 after 2),
    FLOPs (the product over (channel, tap) and the bilinear blend), the
    bytes a kernel must move (input, offsets, weight read once, output
    written once) and the bound at the card's f32 peak (the product runs
    in f32 either way) or its memory rate.  Then the modulated (v2) op at
    R50's stage-4 shape on the card against the CPU, within
    DEFORM_OP_TOL.  Returns the cases."""
    from hvrnet_tpu_torch.ops.deform import deform_conv2d
    h, w = DEFORM_OP_HW
    shapes = [(f"GA adaption P{3 + i}", 256, 256, 4, -(-h // s), -(-w // s))
              for i, s in enumerate((8, 16, 32, 64, 128))]
    shapes += [(f"dcn c{3 + i}", c, c, 1, h // s, w // s)
               for i, (c, s) in enumerate(((128, 8), (256, 16), (512, 32)))]
    gen = torch.Generator().manual_seed(3)
    cases = []
    for label, cin, cout, groups, ho, wo in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            xin = torch.randn(1, cin, ho, wo, generator=gen).to("cuda", dtype)
            off = (torch.randn(1, groups * 18, ho, wo, generator=gen)
                   * 1.5).to("cuda", dtype)
            wt = (torch.randn(cout, cin, 3, 3, generator=gen)
                  * (2 / (9 * cin)) ** 0.5).to("cuda", dtype)
            ms = cuda_ms(torch, lambda: deform_conv2d(
                xin, off, wt, None, 1, 1, 1, None, groups))
            n = ho * wo
            flops = 2.0 * cout * cin * 9 * n + 8.0 * cin * 9 * n
            elt = torch.finfo(dtype).bits // 8
            nbytes = elt * (cin * n + groups * 18 * n + cout * cin * 9
                            + cout * n)
            bound = max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS) * 1e3
            cases.append(dict(label=label, dtype=str(dtype)[6:], ms=ms,
                              gflop=flops / 1e9, mbytes=nbytes / 1e6,
                              bound_ms=bound,
                              bound_by=("bytes" if nbytes / PEAK_BYTES
                                        > flops / PEAK_F32_FLOPS
                                        else "operations")))
            log(f"[deform] deform_conv2d {label} ({cin}->{cout}, {groups} "
                f"group(s), {ho}x{wo}) {str(dtype)[6:]} ({CARD}): "
                f"{ms:.3f} ms (CUDA events, mean of 5 after 2); "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; bound "
                f"{bound:.4f} ms ({cases[-1]['bound_by']}); "
                f"{bound / ms:.3f} of bound")
    # v2 at R50's stage 4 on 800×1344: 512 → 512 on 25×42
    xin = torch.randn(1, 512, 25, 42, generator=gen)
    off = torch.randn(1, 18, 25, 42, generator=gen) * 1.5
    mask = torch.sigmoid(torch.randn(1, 9, 25, 42, generator=gen))
    wt = torch.randn(512, 512, 3, 3, generator=gen) * (2 / 4608) ** 0.5
    want = deform_conv2d(xin, off, wt, None, 1, 1, 1, mask)
    got = deform_conv2d(*(t.cuda() for t in (xin, off, wt)), None, 1, 1, 1,
                        mask.cuda()).cpu()
    err = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[deform] modulated deform_conv2d (v2) at R50 stage 4 (512->512, "
        f"25x42, 27 offset and mask channels) on the card against the CPU: "
        f"max |Δ|/max|CPU| {err:.3g} (limit {DEFORM_OP_TOL})")
    if err > DEFORM_OP_TOL:
        raise RuntimeError("[deform] the card's modulated deform_conv2d is "
                           "not the CPU's")
    return cases, err


def phase_deform(torch, np):
    """The deformable half of the dense family at full width
    (``deform_configs``): per model, f32 ``simple_test`` (and bf16 for
    DEFORM_BF16) with times, stages and peak memory, the deformable parts
    timed apart and the samples' spread (``deform_parts``); the card's f32
    result held to the port's CPU run on the card's maps on one image (the
    dense models: their maps and head outputs too; Cascade R-CNN: each
    dcn block on its card input, ``deform_block_hold``); bf16 against f32
    by depth; each trainable model through ``train_detector`` for 2 + 2
    steps; ``deform_conv2d`` alone at the models' shapes and v2 card
    against CPU (``deform_op_times``); no attention launch and no cv2 on
    the path.  Returns (runs, each with its attention launches (0), the op
    cases)."""
    runs = {}
    for name, cfg in deform_configs().items():
        t0 = time.time()
        engine, engine16 = deform_engines(torch, np, name, cfg)
        dense = name != "cascade_dcn"
        for eng in (engine, engine16):
            if eng is None:
                continue
            tag = f"{type(eng).__name__} {name} {str(eng.dtype)[6:]}"
            key = f"deform {name} {str(eng.dtype)[6:]}"
            runs[key] = (dense_serving(torch, np, eng, name, cfg, tag,
                                       prefix="[deform]") if dense else
                         zoo_serving(torch, np, eng, name, tag,
                                     prefix="[deform]"))[0]
        run = runs[f"deform {name} float32"]
        run["parts"] = deform_parts(torch, np, engine, name, cfg)
        if dense:
            run["cpu_hold"] = dense_cpu_hold(torch, np, engine, name, cfg,
                                             prefix="[deform]",
                                             seeds=DEFORM_HOLD_SEEDS)
        else:
            run["block_hold"] = deform_block_hold(torch, np, engine, name)
            run["cpu_hold"] = zoo_cpu_hold(torch, np, engine, cfg, name,
                                           prefix="[deform]",
                                           seeds=DEFORM_HOLD_SEEDS,
                                           fpn_hold=False)
        if engine16 is not None:
            runs[f"deform {name} bfloat16"]["bf16_hold"] = deform_bf16_hold(
                torch, np, engine, engine16, name, cfg)
        del engine, engine16
        torch.cuda.empty_cache()
        if name in DEFORM_TRAIN:
            runs[f"deform {name} train"] = (
                dense_training(torch, np, name, cfg, prefix="[deform]")
                if dense else zoo_training(torch, np, name, cfg,
                                           prefix="[deform]"))
        log(f"[deform] {name}: {time.time() - t0:.1f} s")
    cases, v2_err = deform_op_times(torch, np)
    if "cv2" in sys.modules:
        raise RuntimeError("[deform] the deformable models' path imported "
                           "cv2")
    log("[deform] no attention launch in any serving or training run and no "
        "cv2 import on the path")
    return runs, dict(cases=cases, v2_card_vs_cpu=v2_err)


# ------------------------------------------------------------------ [trunks]
TRUNK_DEPTH_LIMIT = LANES_MAP_LIMIT["float32"][0]


def trunk_depth_check(torch, np, engine, tag):
    """The card's f32 trunk on one frame against the port's CPU run of the
    same engine's weights on the same frame, by depth (the stem, layer1-3
    = C4, then C5 and the RPN maps), |Δ|₂ / |CPU|₂ within the f32 limit
    ``[lanes]`` holds a batched backbone to at every depth (the seeded
    weights' rounding amplified per stage).  Returns the distances."""
    from hvrnet_tpu_torch.engine import HNMBRCNN
    frame = next(synthetic_video(np, 1, seed=20))
    cpu = HNMBRCNN(engine.model_cfg, engine.test_cfg, device="cpu")
    cpu.load_state_dict(host_state_dict(engine))
    t0 = time.time()
    with torch.no_grad():
        card = backbone_depths(torch, engine, frame["img"],
                               frame["img_shape"])[0]
        want = backbone_depths(torch, cpu, frame["img"],
                               frame["img_shape"])[0]
    dist = {d: ((card[d].float().cpu() - want[d]).norm()
                / want[d].norm()).item() for d in LANES_MAP_DEPTHS}
    log(f"{tag} f32 trunk on the card against the port's CPU run of the "
        f"same weights on the same frame ({time.time() - t0:.1f} s), "
        f"|Δ|₂/|CPU|₂ by depth " + json.dumps(
            {d: float(f"{v:.3g}") for d, v in dist.items()})
        + f" (limit {TRUNK_DEPTH_LIMIT})")
    if max(dist.values()) > TRUNK_DEPTH_LIMIT:
        raise RuntimeError(f"{tag}: the card's trunk is not the CPU's")
    return dist


def trunk_stage_times(torch, np, engine, tag, fc1, valid):
    """The trunk's stages alone on one frame (CUDA events, mean of 3 after
    one): the backbone (C4), the shared head (C5), the RPN head, and the
    exact window head on ``fc1``; then the backbone's device time
    (``torch.profiler``) against its span, the card's idle share."""
    from hvrnet_tpu_torch.engine.detector import f32_precision
    frame = next(synthetic_video(np, 1, seed=2))
    x = engine._to_input(frame["img"], frame["img_shape"])
    model, head = engine.model, engine.model.bbox_head
    kd, P = engine.key_dim, engine.proposal_num
    with torch.no_grad(), f32_precision():
        c4 = model.extract_feat(x)
        stages = {"backbone (C4)": lambda: model.extract_feat(x),
                  "shared head (C5)": lambda: model.shared(c4),
                  "RPN head": lambda: model.rpn(c4),
                  "window head NL1-NL4 and fcs": lambda: head.forward_fc1(
                      fc1, kd * P, P, valid)}
        ms = {name: cuda_ms(torch, fn, iters=3, warmup=1)
              for name, fn in stages.items()}
        busy = device_ms(torch, stages["backbone (C4)"])
    idle = (f"idle {1 - busy / ms['backbone (C4)']:.2f}" if busy > 0
            else "device time not traced")
    log(f"{tag} stages ({CARD}; CUDA events, ms): " + json.dumps(
        {k: round(v, 3) for k, v in ms.items()}))
    log(f"{tag} [busy] backbone (C4): device {busy:.3f} ms of a "
        f"{ms['backbone (C4)']:.3f} ms span, {idle}")
    return dict(stages_ms=ms, backbone_device_ms=busy)


def trunk_rings(torch, np, engine, tag, stream=True):
    """The exact ring (4 launches per detection) and, with ``stream``, the
    streaming ring (2 per detection + 4 per replay) at T=21 over the
    synthetic video, streaming against exact as ``[stream]`` (f32) and
    ``[bf16]`` (bf16) compare them.  Returns the runs by ring."""
    runs = {}
    for ring in ("exact", "stream") if stream else ("exact",):
        engine.stream = ring == "stream"
        run = run_video(torch, np, engine, f"{tag} {ring} T=21")
        want = (4 * run["detections"] if ring == "exact"
                else 2 * run["detections"] + 4 * run["replayed"])
        if run["launches"] != want:
            raise RuntimeError(f"{tag} {ring} ring launched the kernel "
                               f"{run['launches']} times, not {want}")
        runs[ring] = run
    if stream and engine.dtype == torch.bfloat16:
        log(f"{tag} T=21 frames with the same per-class detection counts, "
            "streaming vs exact: %d of %d (no limit)" % count_agreement(
                runs["exact"]["results"], runs["stream"]["results"]))
    elif stream:
        log_agreement(f"{tag} T=21", runs["exact"], runs["stream"])
    if stream:
        final_window_check(torch, np, engine)
    engine.stream = False
    return runs


def phase_trunks(torch, np):
    """HVRNet on the ResNeXt-101 64x4d and Res2Net-101-v1b 26w-4s C5
    trunks (``TRUNK_CONFIGS``) at full width, T=21, 300 proposals, on the
    synthetic video, seeded weights calibrated on the first frame: X101's
    exact and streaming rings in f32 and bf16, Res2Net's exact ring in
    f32; launches per detection, the window head with the kernel against
    the plain attention on the trunk's own window (bf16: its kernel calls
    against their plain version and the f32 head), the card's trunk
    against the port's CPU run by depth, stage times and the backbone's
    idle share.  Returns the f32 and bf16 runs by path."""
    runs, runs16 = {}, {}
    for trunk in TRUNK_CONFIGS:
        t0 = time.time()
        short = trunk.split("-v1b")[0]
        tag = f"[trunks] {short}"
        stream = trunk.startswith("X101")
        engine = build_engine(torch, np, trunk=trunk)
        warm_up(torch, np, engine)
        for ring, run in trunk_rings(torch, np, engine, tag, stream).items():
            runs[f"trunks {short} {ring} T=21"] = run
        _, fc1, valid, _ = window_head_check(torch, np, engine, tag)
        trunk_stage_times(torch, np, engine, tag, fc1, valid)
        trunk_depth_check(torch, np, engine, tag)
        if stream:
            engine16 = build_engine(torch, np, trunk=trunk,
                                    weights=engine.model.state_dict(),
                                    dtype=torch.bfloat16)
            warm_up(torch, np, engine16)
            for ring, run in trunk_rings(torch, np, engine16,
                                         f"{tag} bf16").items():
                runs16[f"trunks {short} {ring} T=21"] = run
            bf16_window_checks(torch, np, engine16, engine, f"{tag} bf16")
            del engine16
        del engine
        torch.cuda.empty_cache()
        log(f"{tag}: {time.time() - t0:.1f} s")
    return runs, runs16


# ----------------------------------------------------------------- [plugins]
PLUGIN_SOURCES = {
    "mask_gcb": "configs/gcnet/mask_rcnn_r16_gcb_c3-c5_r50_fpn_1x.py",
    "faster_attention":
        "configs/empirical_attention/faster_rcnn_r50_fpn_attention_1111_1x.py",
    "cascade_hrnet": "configs/hrnet/cascade_rcnn_hrnetv2p_w32_20e.py"}
PLUGIN_HOLD_SEEDS = (0,)  # the image of the card-against-CPU hold
# a plugin block (context block, generalized attention) on the card against
# the same block on the CPU fed the card's input to it, max |Δ| / max |CPU|:
# one block's rounding, not compounded over the calibrated trunk
PLUGIN_BLOCK_TOL = 1e-4
ROI_POOL_SHAPE = (1, 1024, 38, 63)    # HVRNet's C4 on the 608×1008 canvas
ROI_POOL_ROIS = 300


def plugin_configs():
    """The plugin models at full width (``Config`` objects, from
    ``htc_config``'s R50-FPN settings with mmdetection v1.0's changes for
    each, ``PLUGIN_SOURCES``): Mask R-CNN with the context block (ratio
    1/16) on c3-c5; Faster R-CNN with generalized attention ('1111', 8
    heads, kv stride 2) in every block of c4 and the first three of c5,
    run by the multi-stage engine at one stage (``CascadeRCNN`` with one
    ``bbox_head``, as the JAX engine runs it); Cascade R-CNN on
    HRNetV2p-W32 with HRFPN (256 channels, 5 levels).  81 classes,
    1000 proposals, score_thr 0.05."""
    from hvrnet_tpu_torch.utils.config import Config
    base = htc_config().as_dict()
    model = base["model"]
    for key in ("mask_roi_extractor", "mask_head", "semantic_roi_extractor",
                "semantic_head", "semantic_fusion", "interleaved",
                "mask_info_flow"):
        model.pop(key)
    head = dict(model["bbox_head"][0], reg_class_agnostic=False)
    test = dict(rpn=base["test_cfg"]["rpn"], rcnn=dict(
        score_thr=0.05, nms=dict(type="nms", iou_thr=0.5), max_per_img=100))
    mask = dict(model, type="MaskRCNN", bbox_head=head,
                backbone=dict(model["backbone"], gcb=dict(ratio=1. / 16.),
                              stage_with_gcb=(False, True, True, True)),
                mask_roi_extractor=dict(model["bbox_roi_extractor"],
                                        roi_layer=dict(type="RoIAlign",
                                                       out_size=14,
                                                       sample_num=2)),
                mask_head=dict(type="FCNMaskHead", num_convs=4,
                               in_channels=256, conv_out_channels=256,
                               num_classes=81))
    attention = dict(
        model, type="CascadeRCNN", num_stages=1, bbox_head=head,
        backbone=dict(model["backbone"], gen_attention=dict(
            spatial_range=-1, num_heads=8, attention_type="1111",
            kv_stride=2), stage_with_gen_attention=(
                (), (), (0, 1, 2, 3, 4, 5), (0, 1, 2))))
    hrnet = dict(model, type="CascadeRCNN",
                 backbone=dict(type="HRNet"),
                 neck=dict(type="HRFPN", in_channels=[32, 64, 128, 256],
                           out_channels=256, num_outs=5))
    return {"mask_gcb": Config(dict(
                model=mask, test_cfg=dict(test, rcnn=dict(
                    test["rcnn"], mask_thr_binary=0.5)))),
            "faster_attention": Config(dict(model=attention, test_cfg=test)),
            "cascade_hrnet": Config(dict(model=hrnet, test_cfg=test))}


def plugin_blocks(engine):
    """The backbone's plugin modules by name."""
    from hvrnet_tpu_torch.models.plugins import (ContextBlock,
                                                 GeneralizedAttention)
    return [(n, m) for n, m in engine.model.backbone.named_modules()
            if isinstance(m, (ContextBlock, GeneralizedAttention))]


def plugin_draw(torch, engine, seed=0):
    """The plugins made live before calibration: at their zero inits a
    context block and a generalized attention block are identities.  Each
    attention block's ``gamma`` at 0.1; each context block's last conv
    drawn at std 0.02 and its first conv's bias at std 0.5 (on a
    calibrated map the pooled context nearly cancels, and the LayerNorm
    would rescale that sum's rounding to O(1))."""
    gen = torch.Generator().manual_seed(seed)

    def draw(t, std):
        t.copy_((torch.randn(t.shape, generator=gen) * std).to(t.device))

    with torch.no_grad():
        for _, m in plugin_blocks(engine):
            if hasattr(m, "gamma"):
                m.gamma.fill_(0.1)
                continue
            for fusion in m.fusion_types:
                reduce, _, _, expand = getattr(m, f"{fusion}_conv")
                draw(expand.weight, 0.02)
                draw(reduce.bias, 0.5)


def plugin_block_hold(torch, np, engine, name, prefix="[plugins]"):
    """Each plugin block of the card's f32 backbone on the model's image
    against the same block's CPU run fed the card's input to it: max |Δ| /
    max |CPU| within PLUGIN_BLOCK_TOL.  Returns the worst."""
    import copy
    x = zoo_image(np, name)
    blocks = plugin_blocks(engine)
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, (args[0], out)))
        for n, m in blocks]
    try:
        with torch.no_grad():
            engine.backbone_maps(*x[:2])
    finally:
        for h in hooks:
            h.remove()
    errs = []
    with torch.no_grad():
        for n, m in blocks:
            inp, out = seen[n]
            want = copy.deepcopy(m).cpu()(inp.cpu())
            errs.append(((out.cpu() - want).abs().max()
                         / want.abs().max()).item())
    log(f"{prefix} {type(engine).__name__} {name} f32 plugin blocks "
        f"({len(blocks)}) on the card against each block's CPU run on the "
        "card's input to it: max |Δ|/max|CPU| per block "
        + ", ".join(f"{e:.3g}" for e in errs)
        + f" (limit {PLUGIN_BLOCK_TOL})")
    if max(errs) > PLUGIN_BLOCK_TOL:
        raise RuntimeError(f"{prefix} a plugin block on the card is not the "
                           "CPU's")
    return max(errs)


def plugin_spans(torch, np, engine, name, prefix="[plugins]"):
    """The plugin blocks' share of one ``simple_test`` (CUDA-event spans
    around every call of each, summed) and the peak memory of that call
    above what was allocated before it."""
    x = zoo_image(np, name)
    blocks = [m for _, m in plugin_blocks(engine)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with module_spans(torch, blocks) as spans:
        engine.simple_test(*x)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"{prefix} {type(engine).__name__} {name} ({CARD}): the "
        f"{spans.calls()} plugin block calls of one simple_test "
        f"{spans.ms():.3f} ms (CUDA events); the call's peak {peak:.2f} GiB "
        "above its start")
    return dict(ms=spans.ms(), calls=spans.calls(), peak_gib=peak)


def roi_pool_times(torch, np):
    """``roi_pool`` alone at HVRNet's shapes: 300 seeded RoIs of 16-600 px
    on the 608×1008 canvas over a seeded 38×63×1024 map at stride 16, the
    card's result bit for bit the port's CPU result; time (CUDA events,
    mean of 10 after 3), the bound (the map read once, the RoIs, the
    pooled output written once, at 3.35 TB/s) and the call's peak memory
    above its inputs."""
    from hvrnet_tpu_torch.ops.roi_pool import roi_pool
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(ROI_POOL_SHAPE, generator=gen)
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 1, (ROI_POOL_ROIS, 2)) * [CANVAS[1], CANVAS[0]]
    wh = np.exp(rng.uniform(np.log(16), np.log(600), (ROI_POOL_ROIS, 2)))
    hi = np.minimum(lo + wh, [CANVAS[1] - 1, CANVAS[0] - 1])
    rois = torch.from_numpy(np.concatenate(
        [np.zeros((ROI_POOL_ROIS, 1)), lo, hi], 1).astype(np.float32))
    want = roi_pool(feats, rois, 7, 1 / 16)
    fc, rc = feats.cuda(), rois.cuda()
    got = roi_pool(fc, rc, 7, 1 / 16)
    bitwise = torch.equal(got.cpu(), want)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: roi_pool(fc, rc, 7, 1 / 16), iters=10,
                 warmup=3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    nbytes = 4 * (feats.numel() + rois.numel() + want.numel())
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"[plugins] roi_pool ({CARD}): {ROI_POOL_ROIS} RoIs on the "
        f"{ROI_POOL_SHAPE[2]}x{ROI_POOL_SHAPE[3]}x{ROI_POOL_SHAPE[1]} map, "
        f"card bit for bit the CPU: {bitwise}; {ms:.3f} ms (CUDA events, "
        f"mean of 10 after 3) against a {bound:.4f} ms bound "
        f"({nbytes / 1e6:.1f} MB at 3.35 TB/s); peak {peak:.3f} GiB above "
        "its inputs")
    if not bitwise:
        raise RuntimeError("[plugins] roi_pool on the card is not the CPU's")
    return dict(ms=ms, bound_ms=bound, peak_gib=peak)


def phase_plugins(torch, np):
    """The rest of the backbone zoo at full width (``plugin_configs``) at
    800×1333 on 800×1344, seeded weights, the plugins made live
    (``plugin_draw``), frozen BNs calibrated on the image, the stage heads
    drawn for it: ``simple_test`` in f32 and bf16 with times, stages and
    peak memory; the plugin blocks' share of a call; the card's f32 result
    held to the port's CPU run on the card's maps (the gcb and attention
    models: each plugin block on its card input; HRNet: the HRFPN outputs
    whole), bf16 against f32 by depth; then ``roi_pool`` alone at HVRNet's
    shapes.  No attention launch on the path.  Returns the runs."""
    runs = {}
    for name, cfg in plugin_configs().items():
        t0 = time.time()
        plugged = name != "cascade_hrnet"
        engine, engine16 = zoo_engines(
            torch, np, name, cfg, prefix="[plugins]",
            prepare=(lambda e: plugin_draw(torch, e)) if plugged else None)
        for eng in (engine, engine16):
            tag = f"{type(eng).__name__} {name} {str(eng.dtype)[6:]}"
            runs[f"plugins {name} {str(eng.dtype)[6:]}"] = zoo_serving(
                torch, np, eng, name, tag, prefix="[plugins]")[0]
        run = runs[f"plugins {name} float32"]
        if plugged:
            run["spans"] = plugin_spans(torch, np, engine, name)
            run["block_hold"] = plugin_block_hold(torch, np, engine, name)
        run["cpu_hold"] = zoo_cpu_hold(torch, np, engine, cfg, name,
                                       prefix="[plugins]",
                                       seeds=PLUGIN_HOLD_SEEDS,
                                       fpn_hold=not plugged)
        runs[f"plugins {name} bfloat16"]["bf16_hold"] = zoo_bf16_hold(
            torch, np, engine, engine16, name, prefix="[plugins]")
        del engine, engine16
        torch.cuda.empty_cache()
        log(f"[plugins] {name}: {time.time() - t0:.1f} s")
    runs["plugins roi_pool"] = dict(roi_pool_times(torch, np), launches=0)
    return runs


# [datasets]: the still-image data layer on the still-image Faster R-CNN.
# A COCO-format tree (COCO's 80 categories under their real ids, 1-90 with
# ten gaps) and a VOC2007-format tree written at run time, their images
# binary PPM under the datasets' ``.jpg`` names, read by ``read_ppm``.
COCO_IDS = (tuple(range(1, 12)) + tuple(range(13, 26)) + (27, 28)
            + tuple(range(31, 45)) + tuple(range(46, 66)) + (67, 70)
            + tuple(range(72, 83)) + tuple(range(84, 91)))
# (width, height) of each COCO image (landscape and portrait, as COCO's)
COCO_SIZES = ((640, 480), (480, 640), (640, 427), (427, 640), (500, 375),
              (640, 360), (375, 500), (612, 612))
VOC_SIZES = ((500, 375), (375, 500), (500, 333), (353, 500), (500, 400),
             (480, 360))
DATASETS_CANVAS = (608, 1008)
DATASETS_WORKERS = (1, 2, 4)   # PrefetchLoader throughput, items/s
DATASETS_PASSES = 2            # passes over the train set per worker count
DATASETS_ALBU = dict(
    type="Albu", transforms=[
        dict(type="ShiftScaleRotate", shift_limit=0.0625, scale_limit=0.0,
             rotate_limit=0, interpolation=1, p=0.5),
        dict(type="RandomBrightnessContrast", brightness_limit=[0.1, 0.3],
             contrast_limit=[0.1, 0.3], p=0.2),
        dict(type="OneOf", transforms=[
            dict(type="Blur", blur_limit=3, p=1.0),
            dict(type="MedianBlur", blur_limit=3, p=1.0)], p=0.1),
        dict(type="HueSaturationValue", hue_shift_limit=20,
             sat_shift_limit=30, val_shift_limit=20, p=0.1),
        dict(type="ChannelShuffle", p=0.1)],
    bbox_params=dict(type="BboxParams", format="pascal_voc",
                     label_fields=["gt_labels"], min_visibility=0.0,
                     filter_lost_elements=True),
    keymap={"img": "image", "gt_bboxes": "bboxes"},
    update_pad_shape=False, skip_img_without_anno=True)


def datasets_scene(np, w, h, boxes, seed):
    """A BGR uint8 scene of 16-px blocks with each box filled with a
    colour of its own."""
    img = synthetic_image(np, (h, w), seed)
    rng = np.random.default_rng(seed + 100)
    for x1, y1, x2, y2 in boxes:
        img[int(y1):int(y2) + 1, int(x1):int(x2) + 1] = rng.integers(
            0, 256, 3, dtype=np.uint8)
    return img


def write_coco_tree(np, root):
    """``annotations.json`` and ``images/*.jpg`` (PPM bytes): per image 2–4
    objects of random categories, a crowd box on images 1 and 4, a box 0.5
    px wide on image 2 and one 0.5 px high on image 5.  Returns the json's
    path and, per image, the annotation the dataset must give."""
    from hvrnet_tpu_torch.core.evaluation import coco_classes
    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    images, anns, truth = [], [], []
    for i, (w, h) in enumerate(COCO_SIZES):
        boxes, labels, ignore = [], [], []
        for _ in range(int(rng.integers(2, 5))):
            bw, bh = (float(v) for v in rng.uniform(0.08, 0.4, 2) * (w, h))
            x, y = float(rng.uniform(0, w - bw)), float(rng.uniform(0, h - bh))
            label = int(rng.integers(80)) + 1
            anns.append(dict(image_id=i + 1, bbox=[x, y, bw, bh], iscrowd=0,
                             category_id=COCO_IDS[label - 1]))
            boxes.append([x, y, x + bw - 1, y + bh - 1])
            labels.append(label)
        # crowds on images 1 and 4, a box 0.5 px wide on 2, high on 5
        extra = {1: (0.02, 0.03, 0.3, 0.2, 1), 4: (0.05, 0.05, 0.25, 0.2, 1),
                 2: (0.1, 0.15, 0.5 / w, 0.1, 0), 5: (0.1, 0.1, 0.05, 0.5 / h,
                                                      0)}
        if i in extra:
            fx, fy, fw, fh, crowd = extra[i]
            x, y, bw, bh = fx * w, fy * h, fw * w, fh * h
            anns.append(dict(image_id=i + 1, bbox=[x, y, bw, bh],
                             iscrowd=crowd, category_id=COCO_IDS[i]))
            if crowd:
                ignore.append([x, y, x + bw - 1, y + bh - 1])
        name = f"{i + 1:012d}.jpg"
        write_ppm(root / "images" / name, datasets_scene(np, w, h, boxes, i))
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
        truth.append(dict(bboxes=np.float32(boxes).reshape(-1, 4),
                          labels=np.int64(labels),
                          bboxes_ignore=np.float32(ignore).reshape(-1, 4)))
    for k, a in enumerate(anns):
        a.update(id=k + 1, area=a["bbox"][2] * a["bbox"][3])
    path = root / "annotations.json"
    path.write_text(json.dumps(dict(
        images=images, annotations=anns, categories=[
            dict(id=c, name=n) for c, n in zip(COCO_IDS, coco_classes())])))
    return path, truth


def write_voc_tree(np, root):
    """``VOC2007/{Annotations,ImageSets/Main/test.txt,JPEGImages}``: per
    image 1–3 objects of VOC classes and one of a class outside them
    (dropped).  Returns the imageset's path and the truth per image."""
    import xml.etree.ElementTree as ET
    from hvrnet_tpu_torch.core.evaluation import voc_classes
    classes = voc_classes()
    rng = np.random.default_rng(1)
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        (root / sub).mkdir(parents=True)
    ids, truth = [], []
    for i, (w, h) in enumerate(VOC_SIZES):
        img_id = f"{i + 1:06d}"
        objs = []
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = (int(v) for v in rng.uniform(0.1, 0.4, 2) * (w, h))
            x1 = int(rng.integers(1, w - bw))
            y1 = int(rng.integers(1, h - bh))
            objs.append((classes[int(rng.integers(20))],
                         (x1, y1, x1 + bw, y1 + bh)))
        objs.insert(1, ("cyclops", (5, 5, w // 4, h // 4)))
        ann = ET.Element("annotation")
        size = ET.SubElement(ann, "size")
        for key, v in (("width", w), ("height", h), ("depth", 3)):
            ET.SubElement(size, key).text = str(v)
        for name, box in objs:
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = name
            ET.SubElement(obj, "difficult").text = "0"
            bnd = ET.SubElement(obj, "bndbox")
            for key, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
                ET.SubElement(bnd, key).text = str(v)
        ET.ElementTree(ann).write(root / "Annotations" / f"{img_id}.xml")
        kept = [(n, b) for n, b in objs if n in classes]
        boxes = np.float32([b for _, b in kept]) - 1
        write_ppm(root / "JPEGImages" / f"{img_id}.jpg",
                  datasets_scene(np, w, h, boxes, 50 + i))
        ids.append(img_id)
        truth.append(dict(bboxes=boxes, labels=np.int64(
            [classes.index(n) + 1 for n, _ in kept]),
            bboxes_ignore=np.zeros((0, 4), np.float32)))
    listing = root / "ImageSets" / "Main" / "test.txt"
    listing.write_text("\n".join(ids) + "\n")
    return listing, truth


def check_annotations(np, dataset, truth, tag):
    """The dataset's annotations equal what the tree holds: boxes, labels,
    ignored boxes (crowds) and no dropped box."""
    for i, want in enumerate(truth):
        got = dataset.get_ann_info(i)
        for key, value in want.items():
            if got[key].shape != value.shape or not np.array_equal(
                    got[key], value):
                raise RuntimeError(f"[datasets] {tag} image {i}: {key} "
                                   f"{got[key].tolist()} is not "
                                   f"{value.tolist()}")
    n = sum(len(t["bboxes"]) for t in truth)
    n_ignore = sum(len(t["bboxes_ignore"]) for t in truth)
    log(f"[datasets] {tag}: {len(truth)} images, {n} boxes, {n_ignore} "
        f"ignored, labels and boxes equal to the tree's")


def datasets_engine(torch, np, num_classes, img):
    """``init_detector`` on ``faster_rcnn_config`` with ``num_classes``
    (seeded random weights), frozen BNs calibrated on ``img``."""
    from hvrnet_tpu_torch.apis import image_input, init_detector
    from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
    from hvrnet_tpu_torch.utils.config import Config
    cfg = faster_rcnn_config().as_dict()
    cfg["model"]["bbox_head"]["num_classes"] = num_classes
    cfg = Config(cfg)
    engine = init_detector(cfg, device="cuda")
    calibrate_frozen_bn(engine, [image_input(engine.cfg, img)])
    return engine


def datasets_inference(torch, np, engine, loader, tag, proposals=False):
    """``inference_detector`` on every item ``loader`` yields, each timed
    by CUDA events; with ``proposals`` also each image's RPN proposals in
    original-image coordinates (n, 5), by score.  Returns (results,
    proposals, ms per image)."""
    from hvrnet_tpu_torch.apis import image_input, inference_detector
    from hvrnet_tpu_torch.engine.detector import f32_precision
    results, props, ms = [], [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for item in loader:
        img = item["img"]
        inference_detector(engine, img)         # warm for this canvas
        torch.cuda.synchronize()
        ev[0].record()
        result = inference_detector(engine, img)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        if len(result) != engine.num_classes - 1 or not all(
                c.shape[1:] == (5,) and np.isfinite(c).all() for c in result):
            raise RuntimeError(f"[datasets] {tag}: not a "
                               f"{engine.num_classes - 1}-class result of "
                               "finite boxes")
        results.append(result)
        if proposals:
            x = image_input(engine.cfg, img)
            with torch.no_grad(), f32_precision():
                maps = engine.backbone_maps(x["img"], x["img_shape"])
                boxes, scores, mask = engine._proposals_lanes(
                    *maps, [x["img_shape"]], [x["pad_shape"]])
            keep = mask[0].cpu().numpy()
            b = boxes[0].cpu().numpy()[keep] / x["scale_factor"]
            props.append(np.concatenate(
                [b, scores[0].cpu().numpy()[keep, None]], 1))
    mean = sum(ms) / len(ms)
    log(f"[datasets] {tag} ({CARD}): Faster R-CNN R101-C5 "
        f"{engine.num_classes} classes, inference_detector "
        f"{mean:.3f} ms per image (CUDA events, each image once after a "
        f"warm-up call; min {min(ms):.3f}, max {max(ms):.3f}) over "
        f"{len(ms)} images; {sum(sum(len(c) for c in r) for r in results)} "
        "boxes")
    return results, props, mean


def truth_detections(np, truth, n_classes):
    """The ground truth as detections of score 1, per image per class."""
    out = []
    for t in truth:
        per = [np.zeros((0, 5), np.float32) for _ in range(n_classes)]
        for b, lab in zip(t["bboxes"], t["labels"]):
            per[lab - 1] = np.concatenate([per[lab - 1], np.concatenate(
                [b, [1.0]])[None].astype(np.float32)])
        out.append(per)
    return out


def datasets_evaluation(np, work, coco, coco_truth, coco_results, props,
                        voc, voc_truth, voc_results):
    """``results2json`` (and back), ``coco_style_eval``, ``voc_eval`` and
    ``eval_recalls`` on the card's detections and proposals, and each on
    the ground truth as detections (1.0)."""
    import io
    from hvrnet_tpu_torch.core.evaluation import eval_recalls
    from hvrnet_tpu_torch.tools.coco_eval import coco_style_eval, results2json
    from hvrnet_tpu_torch.tools.voc_eval import voc_eval
    path = results2json(coco, coco_results, str(work / "dets.json"))
    entries = json.loads(Path(path).read_text())
    back = [[[] for _ in coco.CLASSES] for _ in coco_results]
    ids = [info["id"] for info in coco.img_infos]
    for d in entries:
        x, y, w, h = d["bbox"]
        back[ids.index(d["image_id"])][coco.cat2label[d["category_id"]] - 1
                                       ].append([x, y, x + w - 1, y + h - 1,
                                                 d["score"]])
    err = max([float(np.abs(np.asarray(b, np.float64).reshape(-1, 5)
                            - dets).max()) for res, row in zip(
        coco_results, back) for dets, b in zip(res, row) if len(dets)] or [0])
    if len(entries) != sum(len(d) for r in coco_results for d in r) \
            or err > 1e-9:
        raise RuntimeError(f"[datasets] results2json: {len(entries)} "
                           f"entries, back to the detections within {err}")
    log(f"[datasets] results2json: {len(entries)} entries, category ids in "
        f"{sorted({d['category_id'] for d in entries})[:3]}..., mapped back "
        f"to the detections within {err:.1e} px")
    gts = [t["bboxes"] for t in coco_truth]
    labels = [t["labels"] for t in coco_truth]
    scores = {}
    quiet = contextlib.redirect_stdout(io.StringIO())
    with quiet:
        scores["coco AP@[0.50:0.95]"] = coco_style_eval(
            coco_results, gts, labels, coco.CLASSES)
        scores["coco AP, truth"] = coco_style_eval(
            truth_detections(np, coco_truth, 80), gts, labels, coco.CLASSES)
        for name, dets in (("voc mAP", voc_results), ("voc mAP, truth",
                           truth_detections(np, voc_truth, 20))):
            pkl = work / "voc_results.pkl"
            pkl.write_bytes(pickle.dumps(dets))
            scores[name] = voc_eval(str(pkl), voc)[0]
        thrs = np.arange(0.5, 0.951, 0.05)
        recall = eval_recalls(gts, props, (100, 300), thrs)
        truth_recall = eval_recalls(
            gts, [np.concatenate([g, np.ones((len(g), 1), np.float32)], 1)
                  for g in gts], (100, 300), thrs)
    scores["recall@100 IoU 0.5:0.95"] = float(recall[0].mean())
    scores["recall@300 IoU 0.5:0.95"] = float(recall[1].mean())
    scores["recall, truth"] = float(truth_recall.min())
    log(f"[datasets] evaluation on the card's detections (seeded random "
        f"weights) and on the ground truth as detections: "
        + json.dumps({k: round(v, 6) for k, v in scores.items()})
        + f"; proposals per image {[len(p) for p in props]}")
    truth_keys = ("coco AP, truth", "voc mAP, truth", "recall, truth")
    if any(scores[k] != 1.0 for k in truth_keys) or not all(
            0.0 <= v <= 1.0 for v in scores.values()):
        raise RuntimeError(f"[datasets] evaluation: {scores}")
    return scores


def datasets_train_pipeline(norm):
    return [dict(type="LoadImageFromFile"),
            dict(type="LoadAnnotations", with_bbox=True), DATASETS_ALBU,
            dict(type="Resize", img_scale=(1000, 600), keep_ratio=True),
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="Normalize", **norm),
            dict(type="Pad", size_divisor=16),
            dict(type="DefaultFormatBundle"),
            dict(type="Collect", keys=["img", "gt_bboxes", "gt_labels"])]


def datasets_host_times(np, train_cfg):
    """Host ms per item of ``Albu`` alone and of the whole training
    pipeline, and ``PrefetchLoader`` items/s over the training set at
    ``DATASETS_WORKERS`` workers."""
    from hvrnet_tpu_torch.data import build_dataset, pipelines
    from hvrnet_tpu_torch.data.loader import PrefetchLoader
    ds = build_dataset(dict(train_cfg), dict(seed=1, imread=read_ppm))
    load = pipelines.Compose(train_cfg["pipeline"][:2], ds.rng, read_ppm)
    albu = pipelines.build_transform(DATASETS_ALBU, ds.rng)
    albu_ms, item_ms = [], []
    ds[0]                               # warm
    for i in range(len(ds)):
        r = dict(img_info=ds.img_infos[i], ann_info=ds.get_ann_info(i))
        ds.pre_pipeline(r)
        r = load(r)
        t0 = time.perf_counter()
        albu(r)
        albu_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ds[i]
        item_ms.append((time.perf_counter() - t0) * 1e3)
    rates = {}
    for workers in DATASETS_WORKERS:
        order = list(range(len(ds))) * DATASETS_PASSES
        t0 = time.perf_counter()
        n = sum(1 for _ in PrefetchLoader(lambda i: ds[i], iter(order),
                                          workers))
        rates[workers] = n / (time.perf_counter() - t0)
    log(f"[datasets] host ({CARD}): Albu (mmdet's example block) "
        f"{sum(albu_ms) / len(albu_ms):.3f} ms per item alone, the whole "
        f"training pipeline {sum(item_ms) / len(item_ms):.3f} ms per item "
        f"(mean over {len(ds)} COCO images of 360-640 px, after one warm "
        f"item); PrefetchLoader "
        + ", ".join(f"{w} worker{'s' * (w > 1)} {r:.2f} items/s"
                    for w, r in rates.items())
        + f" over {len(ds) * DATASETS_PASSES} items")
    return dict(albu_ms=sum(albu_ms) / len(albu_ms),
                item_ms=sum(item_ms) / len(item_ms),
                items_per_s=rates)


def datasets_training(torch, np, train_cfg, model_cfg):
    """One training step of the Faster R-CNN R101-C5 on the first item of
    the training loader's epoch that fits the canvas, packed by
    ``collate_train`` (the epoch's portrait items do not fit and are
    skipped, as ``train_batch_iterator`` skips them), by
    ``FasterRCNNTrainer``, the trainer ``train_detector`` picks for the
    ``FasterRCNN`` engine, on seeded weights with frozen BNs calibrated on
    the item.  Returns the step."""
    from hvrnet_tpu_torch.data import build_dataloader, build_dataset
    from hvrnet_tpu_torch.engine import FasterRCNN
    from hvrnet_tpu_torch.engine.canvas import FrameTooLarge
    from hvrnet_tpu_torch.engine.stream import collate_train
    from hvrnet_tpu_torch.engine.train import FasterRCNNTrainer
    ds = build_dataset(dict(train_cfg), dict(seed=0, imread=read_ppm))
    skipped, sample = 0, None
    for item in build_dataloader(ds, imgs_per_gpu=1, workers_per_gpu=1):
        try:
            packed = collate_train([item], DATASETS_CANVAS)
        except FrameTooLarge:
            skipped += 1
            continue
        sample = sample or packed
    if sample is None or not skipped:
        raise RuntimeError(f"[datasets] of {len(ds)} training items "
                           f"{skipped} were skipped and "
                           f"{'one' if sample else 'none'} fits the canvas")
    tag = "[datasets] train FasterRCNNTrainer"
    engine = calibrated_training_engine(torch, FasterRCNN, model_cfg, sample,
                                        tag)
    before = {k: t.clone() for k, t in engine.model.state_dict().items()}
    trainer = FasterRCNNTrainer(engine, model_cfg, 1, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = trainer.train_step(sample)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    logs = {k: float(v) for k, v in logs.items()}
    log(f"{tag} ({CARD}): one step (the first, host wall) on the first "
        f"COCO item of the loader's epoch that fits the canvas "
        f"{DATASETS_CANVAS} ({skipped} of {len(ds)} portrait items "
        f"skipped in the epoch, {int(sample['gt_mask'].sum())} boxes): "
        f"{ms:.3f} ms; " + json.dumps(
            {k: round(v, 6) for k, v in logs.items()
             if k.startswith(("loss", "acc"))}))
    if not all(np.isfinite(v) for v in logs.values()):
        raise RuntimeError(f"{tag}: non-finite logs {logs}")
    check_train_weights(torch, engine, before, tag, (
        "backbone.layer2.", "backbone.layer3.", "rpn_head.",
        "shared_head.", "bbox_head."))
    del engine, trainer
    torch.cuda.empty_cache()
    return dict(step_ms=ms, loss=logs["loss"], skipped=skipped)


def phase_datasets(torch, np):
    """The still-image data layer at full width.  A COCO-format and a
    VOC2007-format tree written at run time (deleted after): both built by
    ``build_dataset`` from config dicts, their annotations held to what was
    written, iterated by ``build_dataloader`` in test mode through
    ``inference_detector`` on the still-image Faster R-CNN R101-C5
    (``faster_rcnn_config``, 81 and 21 classes, seeded random weights,
    frozen BNs calibrated on the first image); ``coco_eval``, ``voc_eval``
    and ``eval_recalls`` over the RPN's proposals; one
    ``FasterRCNNTrainer`` step on a COCO item through ``Albu``; the
    host's times.  No attention launch on
    the path.  Returns the run."""
    import shutil
    from hvrnet_tpu_torch.data import build_dataloader, build_dataset
    from hvrnet_tpu_torch.ops.attention import masked_attention
    from hvrnet_tpu_torch.utils.config import Config
    work = ROOT / "build" / "chip_smoke_datasets"
    shutil.rmtree(work, ignore_errors=True)
    try:
        ann_file, coco_truth = write_coco_tree(np, work / "coco")
        listing, voc_truth = write_voc_tree(
            np, work / "VOCdevkit" / "VOC2007")
        test = [dict(type="LoadImageFromFile")]
        coco_cfg = dict(type="CocoDataset", ann_file=str(ann_file),
                        img_prefix=str(work / "coco" / "images") + "/",
                        pipeline=test)
        voc_cfg = dict(type="VOCDataset", ann_file=str(listing),
                       img_prefix=str(work / "VOCdevkit" / "VOC2007") + "/",
                       pipeline=test)
        args = dict(test_mode=True, imread=read_ppm)
        coco = build_dataset(dict(coco_cfg), dict(args))
        voc = build_dataset(dict(voc_cfg), dict(args))
        check_annotations(np, coco, coco_truth, "CocoDataset")
        check_annotations(np, voc, voc_truth, "VOCDataset")
        if coco.cat_ids != list(COCO_IDS) or voc.year != 2007:
            raise RuntimeError("[datasets] category ids or VOC year wrong")
        masked_attention.launches = 0
        first = read_ppm(work / "coco" / "images" / coco.img_infos[0][
            "filename"])
        engine = datasets_engine(torch, np, 81, first)
        coco_results, props, coco_ms = datasets_inference(
            torch, np, engine, build_dataloader(coco, 1, 2), "COCO",
            proposals=True)
        del engine
        engine = datasets_engine(torch, np, 21, read_ppm(
            work / "VOCdevkit" / "VOC2007" / voc.img_infos[0]["filename"]))
        voc_results, _, voc_ms = datasets_inference(
            torch, np, engine, build_dataloader(voc, 1, 2), "VOC")
        del engine
        torch.cuda.empty_cache()
        scores = datasets_evaluation(np, work, coco, coco_truth,
                                     coco_results, props, voc, voc_truth,
                                     voc_results)
        hvr = Config.fromfile(str(CONFIG)).as_dict()
        norm = hvr["img_norm_cfg"]
        train_cfg = dict(coco_cfg, pipeline=datasets_train_pipeline(norm))
        model_cfg = faster_rcnn_config().as_dict()
        model_cfg["model"]["bbox_head"]["num_classes"] = 81
        train = datasets_training(torch, np, train_cfg, model_cfg)
        launches = masked_attention.launches
        host = datasets_host_times(np, train_cfg)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[datasets] attention kernel launches on the path: {launches}")
    if launches:
        raise RuntimeError(f"[datasets] {launches} attention launches on a "
                           "path without a relation head")
    return {"datasets": dict(launches=launches, coco_ms=coco_ms,
                             voc_ms=voc_ms, scores=scores, train=train,
                             host=host)}

# [multi]: the multi-device paths on the check machine's one card.  NCCL
# takes one rank per card, so it runs at world 1; two ranks share the card
# over gloo, which reduces CUDA tensors through the host.  ``--cards``
# (``main_cards``) spreads the ranks, replicas and shards over every
# visible card instead, the ranks over NCCL
MULTI_DEVICE = "cuda:0"
MULTI_CARDS = False
MULTI_BACKENDS = ("nccl", "gloo")       # world 1, then MULTI_RANKS ranks
MULTI_RANKS = 2
MULTI_STEPS = 2                         # per rank; the last one timed
MULTI_TIMEOUT = 300.0                   # s, the spawned ranks together
MULTI_LANES, MULTI_REPLICAS = 4, 2
MULTI_LANE_STEPS = 3                    # lockstep steps of the ring check
MULTI_SHARDS = (2, 4)
MULTI_WINDOW_SHARDS = 2
# detections of the split or sharded path against the unsharded one: the
# CLI comparisons' limits (boxes 1e-4 of the 1280-px frame, scores 1e-4)
MULTI_BOX_TOL, MULTI_SCORE_TOL = 1e-4 * 1280, 1e-4


def multi_sample(seed):
    """A [multi] rank's training sample: ``synthetic_train_batch``'s
    27-frame HVRNet batch of ``seed`` (built in the rank's process)."""
    import numpy as np
    return synthetic_train_batch(np, seed=seed)


# the ranks' sample maker (a module-level function: the ranks import it)
MULTI_SAMPLE = multi_sample


def multi_devices(n):
    """The devices of n ranks, replicas or shards: ``MULTI_DEVICE`` n
    times, or under ``--cards`` the visible cards in turn."""
    if not MULTI_CARDS:
        return [MULTI_DEVICE] * n
    import torch
    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]


def sync_cards(torch):
    """Wait for every visible card (the split runs queue work on each)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_multi(torch, np, train_weights, hvr_weights):
    """Data-parallel training (world 1 over NCCL, two ranks over gloo on
    one card), the lockstep lanes over two replicas on the card and the
    K/V-sharded attention.  Returns the kernel cases and the runs whose
    launches the kernels line counts."""
    import shutil
    t0 = time.time()
    log(f"[multi] {torch.cuda.device_count()} CUDA card(s) visible: NCCL "
        f"runs at world 1 on {MULTI_DEVICE}, then {MULTI_RANKS} ranks on "
        f"{', '.join(multi_devices(MULTI_RANKS))} over {MULTI_BACKENDS[1]}")
    work = ROOT / "build" / "chip_smoke_multi"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    runs = multi_training(torch, np, work, train_weights)
    lap_s = time.time() - t0
    engine = build_engine(torch, np, weights=hvr_weights)
    warm_up(torch, np, engine)
    runs.update(multi_lanes(torch, np, engine))
    cases, kv_runs = multi_kv(torch, np, engine)
    runs.update(kv_runs)
    shutil.rmtree(work, ignore_errors=True)
    del engine
    torch.cuda.empty_cache()
    log(f"[multi] ({CARD}) the phase took {time.time() - t0:.1f} s, "
        f"training {lap_s:.1f} s")
    return cases, runs


def multi_training(torch, np, work, weights):
    """One HVRNet data-parallel step at full width: at world 1 over NCCL
    in this process (held to the one-process step), with the step's
    collectives alone after it (``dryrun.collective_check``: the gradients'
    all-reduce and the parameters' broadcast over NCCL, unchanged at one
    rank), then ``MULTI_RANKS`` ranks (sharing one card over gloo, or one
    card each over NCCL under ``--cards``) against one process's mean
    gradient (``dryrun.data_parallel_check``)."""
    from hvrnet_tpu_torch.parallel import dryrun
    from hvrnet_tpu_torch.parallel.launch import free_coordinator
    from hvrnet_tpu_torch.utils.config import Config
    cfg = Config.fromfile(str(CONFIG)).as_dict()
    path = work / "weights.pt"
    torch.save({k: v.detach().cpu() for k, v in weights.items()}, path)
    spec = dict(model_cfg=cfg["model"], train_cfg=cfg["train_cfg"], cfg=cfg,
                weights=str(path), seed=0, make_sample=MULTI_SAMPLE,
                sample_args=[(r,) for r in range(MULTI_RANKS)])
    one = work / "world1"
    one.mkdir()
    dryrun.dp_step_rank(0, 1, free_coordinator(), spec, str(one),
                        MULTI_DEVICE, MULTI_BACKENDS[0], steps=MULTI_STEPS,
                        collectives=True)
    rec = torch.load(one / "rank_0.pt", weights_only=False)
    want = dryrun.mean_gradient_step(spec, 1, MULTI_DEVICE)
    err1 = max(((rec["params"][n] - w).abs().max()
                / w.abs().max().clamp_min(1.0)).item()
               for n, w in want.items())
    del want
    log(f"[multi] ({CARD}) backend {rec['backend']}, world 1: HVRNet step "
        f"{rec['ms'][-1]:.3f} ms (the first {rec['ms'][0]:.3f}), peak "
        f"{rec['peak_gib']} GiB, kernel launches {rec['launches']} over "
        f"{MULTI_STEPS} steps; against one process's step "
        f"{err1:.3g} of max(1, |w|) (limit {dryrun.PARAM_TOL}); losses "
        + json.dumps({k: round(v, 4) for k, v in rec["logs"].items()
                      if k.startswith("loss")}))
    log_collectives(rec, "one process")
    if (rec["backend"] != MULTI_BACKENDS[0] or err1 > dryrun.PARAM_TOL
            or not all(np.isfinite(v) for v in rec["logs"].values())
            or rec["launches"] != 9 * MULTI_STEPS):
        raise RuntimeError("[multi] the world-1 step over NCCL differs from "
                           "the one-process step")
    two = work / "ranks"
    two.mkdir()
    t0 = time.time()
    devices = multi_devices(MULTI_RANKS)
    out = dryrun.data_parallel_check(
        spec, MULTI_RANKS, str(two), device=devices,
        backend=MULTI_BACKENDS[1], timeout=MULTI_TIMEOUT, steps=MULTI_STEPS,
        collectives=MULTI_CARDS)
    ranks = out["ranks"]
    log(f"[multi] ({CARD}) backend {ranks[0]['backend']}, {MULTI_RANKS} "
        f"ranks on {', '.join(devices)}: the ranks' parameters bitwise "
        f"equal, "
        f"{out['max_rel_err']:.3g} of max(1, |w|) from one process's mean "
        f"of the {MULTI_RANKS} samples' gradients (limit "
        f"{dryrun.PARAM_TOL}); per rank ms/step "
        + ", ".join(f"{r['ms'][-1]:.3f} (first {r['ms'][0]:.3f})"
                    for r in ranks)
        + ", peak GiB " + ", ".join(str(r["peak_gib"]) for r in ranks)
        + ", kernel launches " + ", ".join(str(r["launches"]) for r in ranks)
        + f"; {out['ranks_s']:.1f} s for the ranks with their start, "
        f"{time.time() - t0:.1f} s with the one-process reference after "
        f"them; mean loss {ranks[0]['logs']['loss']:.4f}")
    if MULTI_CARDS:
        log_collectives(ranks[0], f"{MULTI_RANKS} ranks, rank 0")
    if any(r["backend"] != MULTI_BACKENDS[1]
           or r["launches"] != 9 * MULTI_STEPS for r in ranks):
        raise RuntimeError("[multi] a rank ran another backend or skipped "
                           "the kernel")
    return {"multi train world 1 nccl": dict(launches=rec["launches"]),
            f"multi train {MULTI_RANKS} ranks {MULTI_BACKENDS[1]}": dict(
                launches=sum(r["launches"] for r in ranks))}


def log_collectives(rec, tag):
    """A rank's ``collective_check`` record on one line."""
    c = rec["collectives"]
    log(f"[multi] ({CARD}) collectives over {rec['backend']}, {tag} (world "
        f"{c['world']}): the gradients' all-reduce of {c['mib']:.1f} MiB "
        f"(trainer.reduce) ms " + ", ".join(f"{v:.3f}" for v in c["reduce_ms"])
        + "; the parameters' broadcast ms "
        + ", ".join(f"{v:.3f}" for v in c["broadcast_ms"])
        + ("; the gradients and parameters unchanged, bitwise"
           if c["world"] == 1 else "; the parameters unchanged, bitwise"))


def multi_match(np, engine, got, want, worst, tag):
    """Each lane's detections of ``got`` against ``want`` (``(dets,
    labels, mask)`` with or without a lane axis) per class
    (``match_frame``, rows of near-equal score may swap) within
    ``MULTI_BOX_TOL`` and ``MULTI_SCORE_TOL``; returns the worst box and
    score differences so far."""
    from hvrnet_tpu_torch.ops.boxes import bbox2result_np

    def per_class(out):
        dets, labels, mask = (t.detach().cpu().numpy() for t in out)
        if dets.ndim == 2:
            dets, labels, mask = dets[None], labels[None], mask[None]
        return [bbox2result_np(d[m], lab[m], engine.num_classes)
                for d, lab, m in zip(dets, labels, mask)]

    for fg, fw in zip(per_class(got), per_class(want)):
        problem, box, score = match_frame(fg, fw, MULTI_BOX_TOL,
                                          MULTI_SCORE_TOL)
        if problem:
            raise RuntimeError(f"[multi] {tag}: {problem}")
        worst = [max(worst[0], box), max(worst[1], score)]
    return worst


def multi_lanes(torch, np, engine):
    """``MULTI_LANES`` lockstep lanes over ``MULTI_REPLICAS`` replicas
    (``multi_devices``) against the unsharded batched engine: each replica's
    backbone by depth (``LANES_MAP_LIMIT``; cuDNN picks its algorithms by
    batch size, so not bitwise), its post of its maps bitwise the
    unsharded post of the same maps, then ``MULTI_LANE_STEPS`` lockstep
    steps (frame program, ring push, ring detect) with the unsharded ring
    fed the replicas' caches: the same detections within the CLI limits,
    4 launches per replica and detection; step times."""
    from hvrnet_tpu_torch.ops.attention import masked_attention
    B, n = MULTI_LANES, MULTI_REPLICAS
    per = B // n
    devices = multi_devices(n)
    limit, held = LANES_MAP_LIMIT["float32"]
    videos = [synthetic_video(np, MULTI_LANE_STEPS, seed=20 + b)
              for b in range(B)]
    steps = [[next(v) for v in videos] for _ in range(MULTI_LANE_STEPS)]

    def stack(frames, key):
        return np.stack([f[key][0] if key == "img" else f[key]
                         for f in frames])

    def rel(a, b):
        a, b = a.float().to(b.device), b.float()
        return ((a - b).norm() / b.norm()).item()

    imgs, ishs, pshs = (stack(steps[0], k) for k in ("img", "img_shape",
                                                      "pad_shape"))
    home = engine.device
    with torch.no_grad():
        whole, _ = backbone_depths(torch, engine, imgs, ishs)
        engine.enable_spmd_lanes(devices)
        parts = [backbone_depths(torch, rep, imgs[i * per:(i + 1) * per],
                                 ishs[i * per:(i + 1) * per])
                 for i, rep in enumerate(engine.lane_replicas)]
        lane = [(i, j) for i in range(n) for j in range(per)]
        own = {d: max(rel(parts[i][0][d][j], whole[d][i * per + j])
                      for i, j in lane) for d in LANES_MAP_DEPTHS}
        other = {d: min(rel(parts[i][0][d][j], whole[d][a])
                        for i, j in lane for a in range(B)
                        if a != i * per + j) for d in LANES_MAP_DEPTHS}
        post = [rep.frame_post_batched(*parts[i][1],
                                       ishs[i * per:(i + 1) * per],
                                       pshs[i * per:(i + 1) * per])
                for i, rep in enumerate(engine.lane_replicas)]
        engine.enable_spmd_lanes(None)
        unsplit = engine.frame_post_batched(
            *(torch.cat([p[1][m].to(home) for p in parts])
              for m in range(3)), ishs, pshs)
        bitwise = all(torch.equal(torch.cat([p[k].to(home) for p in post]),
                                  v) for k, v in unsplit.items())
    log(f"[multi] lanes ({CARD}): {B} lanes over {n} replicas on "
        f"{', '.join(devices)}, "
        f"each replica's backbone against the unsharded batch, "
        f"|Δ|₂/|unsharded|₂ by depth, own lane "
        + json.dumps({d: float(f"{v:.3g}") for d, v in own.items()})
        + f" (limit {limit}), nearest other lane "
        + json.dumps({d: float(f"{v:.3g}") for d, v in other.items()})
        + f"; the replicas' post bitwise the unsharded post of their maps: "
        f"{bitwise}")
    if not (bitwise and all(own[d] <= limit and other[d] > 10 * limit
                            for d in held)):
        raise RuntimeError("[multi] the replicas' frame program differs "
                           "from the unsharded engine's lanes")
    del whole, parts, post, unsplit

    sfs = np.tile(np.asarray(steps[0][0]["scale_factor"], np.float32),
                  (B, 1))
    split_ms, whole_ms, worst = [], [], [0.0, 0.0]
    state_s = state_u = None
    detections = launches = 0
    for s, frames in enumerate(steps):
        imgs, ishs, pshs = (stack(frames, k) for k in ("img", "img_shape",
                                                        "pad_shape"))
        reset = np.full(B, s == 0)
        engine.enable_spmd_lanes(devices)
        sync_cards(torch)
        masked_attention.launches = 0
        t0 = time.perf_counter()
        feats = engine.frame_features_batched(imgs, ishs, pshs)
        if state_s is None:
            state_s = engine.ring_reset_batched(B, D)
        state_s = engine.ring_push_batched(state_s, feats, reset)
        got = engine.ring_detect_batched(state_s, ishs, sfs, branch=-1)
        sync_cards(torch)
        split_ms.append(1e3 * (time.perf_counter() - t0))
        launches += masked_attention.launches
        detections += 1
        engine.enable_spmd_lanes(None)
        fed = {k: feats[k] for k in feats[0]}     # the replicas' lanes
        t0 = time.perf_counter()
        engine.frame_features_batched(imgs, ishs, pshs)
        if state_u is None:
            state_u = engine.ring_reset_batched(B, D)
        state_u = engine.ring_push_batched(state_u, fed, reset)
        want = engine.ring_detect_batched(state_u, ishs, sfs, branch=-1)
        torch.cuda.synchronize()
        whole_ms.append(1e3 * (time.perf_counter() - t0))
        worst = multi_match(np, engine, got, want, worst,
                            "the replicas' detections against the "
                            "unsharded ring's")
    log(f"[multi] lanes ({CARD}): {MULTI_LANE_STEPS} lockstep steps of {B} "
        f"lanes, the same detections as the unsharded ring fed the "
        f"replicas' caches (boxes within {worst[0]:.3g} px, limit "
        f"{MULTI_BOX_TOL:.3g}; scores within {worst[1]:.3g}, limit "
        f"{MULTI_SCORE_TOL}); kernel launches {launches} over {detections} "
        f"lockstep detections ({4 * n} = 4 per replica expected); wall ms "
        f"per step (frame program, push, detect, synchronised) over {n} "
        f"replicas " + ", ".join(f"{v:.3f}" for v in split_ms)
        + ", unsharded " + ", ".join(f"{v:.3f}" for v in whole_ms))
    if launches != 4 * n * detections:
        raise RuntimeError("[multi] the split lanes did not launch the "
                           "kernel 4 times per replica and detection")
    return {f"multi lanes {n} replicas": dict(launches=launches)}


def multi_kv(torch, np, engine):
    """``masked_attention_kv_sharded`` at the T=21 shapes, f32 and bf16,
    over ``MULTI_SHARDS`` shards (``multi_devices``), against
    ``attention_plain`` (f32: within 1e-4 and 1e-5 of max; bf16:
    ``bf16_agreement``'s worst and rms ≤ 1) and the kernel, ms per call
    beside the kernel's; then one HVRNet window detection with
    ``enable_kv_sharded_attention`` against the unsharded head, no kernel
    launch."""
    from hvrnet_tpu_torch.ops.attention import (NEG_INF, attention_plain,
                                                bf16_agreement,
                                                masked_attention,
                                                masked_attention_kv_sharded)
    gen = torch.Generator(device="cuda").manual_seed(3)
    scale = D ** -0.5
    cases = []
    for nq, nk, label in ATTN_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(m, D, device="cuda", generator=gen).to(dt)
                       for m in (nq, nk, nk))
            live = torch.rand(nk, device="cuda", generator=gen) >= 0.1
            bias = torch.where(live, 0.0, NEG_INF).float()
            plain = attention_plain(q, k, v, bias, scale)
            kernel = masked_attention(q, k, v, bias, scale)
            kernel_ms = cuda_ms(torch, lambda: masked_attention(
                q, k, v, bias, scale))
            for n in MULTI_SHARDS:
                devices = multi_devices(n)
                got = masked_attention_kv_sharded(q, k, v, bias, scale,
                                                  devices)
                case = dict(label=f"kv-sharded {label}", shards=n, nq=nq,
                            nk=nk, dtype=str(dt)[6:],
                            devices=",".join(dict.fromkeys(devices)),
                            kernel_diff=(got - kernel).abs().max().item())
                if dt == torch.float32:
                    err = (got - plain).abs().max().item()
                    case.update(max_abs_err=err, tol=1e-4,
                                rel_err=err / plain.abs().max().item(),
                                rel_tol=1e-5)
                    ok = err <= 1e-4 and case["rel_err"] <= 1e-5
                else:
                    case.update(bf16_agreement(got, q, k, v, bias, scale))
                    ok = case["worst"] <= 1 and case["rms"] <= 1
                case.update(
                    ms=cuda_ms(torch, lambda: masked_attention_kv_sharded(
                        q, k, v, bias, scale, devices)),
                    kernel_ms=kernel_ms)
                log(f"[multi] kv-sharded ({CARD}) " + json.dumps(case))
                if not (ok and bool(torch.isfinite(got).all())):
                    raise RuntimeError(f"[multi] the kv-sharded attention "
                                       f"disagrees: {case}")
                cases.append(case)
            del q, k, v, plain, kernel, got
    torch.cuda.empty_cache()

    frames = list(synthetic_video(np, engine.window, seed=5))
    feats = [engine.frame_features(f["img"], f["img_shape"], f["pad_shape"])
             for f in frames]
    fc1, boxes, masks = (torch.stack([f[k] for f in feats])
                         for k in ("fc1", "boxes", "mask"))
    key = frames[engine.key_dim]
    args = (fc1, boxes, masks, key["img_shape"], key["scale_factor"])
    base = engine.window_detect(*args)
    base_ms = cuda_ms(torch, lambda: engine.window_detect(*args))
    engine.enable_kv_sharded_attention(multi_devices(MULTI_WINDOW_SHARDS))
    try:
        masked_attention.launches = 0
        got = engine.window_detect(*args)
        launches = masked_attention.launches
        kv_ms = cuda_ms(torch, lambda: engine.window_detect(*args))
    finally:
        engine.enable_kv_sharded_attention(None)
    worst = [0.0, 0.0]
    for g, w in zip(got, base):
        worst = multi_match(np, engine, g, w, worst, "the kv-sharded "
                            "window's detections against the kernel's")
    log(f"[multi] kv-sharded HVRNet window ({CARD}): T={engine.window}, "
        f"{MULTI_WINDOW_SHARDS} shards, both branches' detections as the "
        f"kernel's (boxes within {worst[0]:.3g} px, limit "
        f"{MULTI_BOX_TOL:.3g}; scores within {worst[1]:.3g}, limit "
        f"{MULTI_SCORE_TOL}); {launches} kernel launches; "
        f"{kv_ms:.3f} ms per detection against the kernel's {base_ms:.3f}")
    if launches:
        raise RuntimeError("[multi] the kv-sharded window launched the "
                           "kernel")
    return cases, {"multi kv-sharded window": dict(launches=launches)}



def kernel_summary(cases, runs, runs16):
    """Per-kernel numbers, one entry per precision route of the one kernel:
    one detected frame of the exact ring at T=21 (NL1..NL4, two calls at
    each shape) at f32 (``runs``, its paths' launches) and at bf16
    (``runs16``)."""
    return {"kernels": [route_summary(cases, runs, "float32"),
                        route_summary(cases, runs16, "bfloat16")]}


def route_summary(cases, runs, dtype):
    """One route's entry: the cases of ``dtype`` with times, keyed by
    label, summed per detected frame and per training step."""
    timed = {c["label"]: c for c in cases
             if c["dtype"] == dtype and "ms" in c}
    f32 = dtype == "float32"

    def per_frame(get, shapes=ATTN_SHAPES):
        return sum(2 * get(timed[label]) for *_, label in shapes)

    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    sums = {key: per_frame(lambda c: c[key]) for key in keys}
    names = dict.fromkeys(name for *_, label in ATTN_SHAPES
                          for name in timed[label]["phases_ms"])
    phases = {name: per_frame(lambda c: c["phases_ms"].get(name, 0.0))
              for name in names}
    bound_by = {timed[label]["bound_by"] for *_, label in ATTN_SHAPES}
    launches = {path: run["launches"] for path, run in runs.items()}
    entry = dict(
        name="masked_attention" if f32 else "masked_attention_bf16",
        route="cuda",
        source="hvrnet_tpu_torch/csrc/masked_attention.cu",
        replaces="hvrnet_tpu/ops/attention.py:42",
        launches=sum(launches.values()),
        launches_by_path=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases
                        if c["dtype"] == dtype and "max_abs_err" in c),
        ms=sums["ms"], plain_ms=sums["plain_ms"],
        bound_ms=sums["bound_ms"], bound_by="/".join(sorted(bound_by)),
        library_ms=sums["library_ms"],
        phases_ms=phases,
        bound_fraction=sums["bound_ms"] / sums["ms"],
        per_frame_t63={key: per_frame(lambda c: c[key], ATTN_SHAPES_63)
                       for key in keys},
        per_step_train={key: 3 * sum(
            calls * timed[label][key] for calls, (*_, label) in
            zip((1, 2), TRAIN_SHAPES)) for key in keys},
        per_frame_selsa={key: per_frame(lambda c: c[key]) / 2
                         for key in keys},
        per_step_selsa_train={key: sum(timed[label][key] for *_, label in
                                       SELSA_TRAIN_SHAPES) for key in keys},
        per_lockstep_detect_b4={key: per_frame(lambda c: c[key], LANES_ATTN)
                                for key in keys + ("separate_ms",)},
        per_aug_detect={key: per_frame(lambda c: c[key], AUG_ATTN)
                        for key in keys + ("separate_ms",)},
        per_aug_detect_selsa={key: per_frame(lambda c: c[key], AUG_ATTN) / 2
                              for key in keys + ("separate_ms",)},
        per_multipass_detect_t63={
            key: 2 * timed["multipass NL1/NL2"][key]
            + timed["NL2/NL4 T=63"][key] for key in keys},
        unit=f"per detected frame of the exact ring at T=21: 2 calls at "
             f"6300x6300 + 2 at 300x6300, d 1024, {dtype} "
             + ("(3xTF32 bound)" if f32 else
                "(bound at 989 TFLOP/s dense bf16, or bytes at 3.35 TB/s)")
             + "; per_frame_t63 the same at 18900x18900 and 300x18900; "
             "per_step_train one training step's 9 calls: per chosen "
             "video 1 at 384x384 and 2 at 128x384; per_frame_selsa one "
             "SELSA detection's 2 calls, 6300x6300 and 300x6300; "
             "per_step_selsa_train one SELSA training step's 2 calls, "
             "900x384 and 300x384; per_lockstep_detect_b4 one HVRNet "
             "lockstep detection of 4 lanes, 2 calls at (4, 6300, 6300) + "
             "2 at (4, 300, 6300), separate_ms the same as 4 separate 2-D "
             "calls each; per_aug_detect one HVRNet flip-augmented detection "
             "(a frame and its mirror as 2 lanes), 2 calls at (2, 6300, "
             "6300) + 2 at (2, 300, 6300), per_aug_detect_selsa SELSA's one "
             "of each; per_multipass_detect_t63 one detection of the "
             "3-pass graph at T=63, 2 calls at (3, 6300, 6300) + 1 at 300x"
             "18900; launches summed over the paths in "
             "launches_by_path, each counted from 0 over its run (30 "
             "frames; train: the warmup + timed steps; cli: the CLI's "
             "run over the [cli] tree, 69 frames, 40 at T=63; train-cli: "
             "tools/train.py's steps and its hook's evaluations; lanes: "
             "4 streams over the [lanes] tree, 104 frames, and the CLI over "
             "it and over 4 videos of 32 frames, 4 launches per HVRNet "
             "lockstep detection and 2 per SELSA one, whatever the lane "
             "count; aug: test --aug-test over the [cli] tree, 4 per HVRNet "
             "detection and 2 per SELSA one; multipass: hnl_test --window "
             "63 --multi-pass 3 over the 40-frame video, 3 per detection, "
             "beside the exact ring's 4; trace: test --trace --timing over "
             "8 frames, 4 per detection; zoo: Cascade R-CNN, Mask R-CNN "
             "and HTC serving and training, 0: no relation head; dense: "
             "RetinaNet, FreeAnchor, FCOS, FoveaBox and SSD300 serving and "
             "training, 0: no relation head; deform: GA-RetinaNet, GA-RPN, "
             "RepPoints and Cascade R-CNN with dcn serving and training, 0: "
             "no relation head; trunks: HVRNet on the X101-64x4d and "
             "Res2Net-101 C5 trunks over the 30-frame video, 4 per exact "
             "detection, 2 per streaming detection and 4 per replay; "
             "plugins: Mask R-CNN gcb, Faster R-CNN gen_attention and "
             "Cascade R-CNN HRNet serving, and roi_pool alone, 0: no "
             "relation head; datasets: Faster R-CNN over the COCO and VOC "
             "trees and one training step, 0: no relation head; multi: "
             "HVRNet training at world 1 over NCCL and on 2 ranks over "
             "gloo (2 steps each, 9 per step and rank, counted in the "
             "ranks), 4 lockstep lanes over 2 replicas (4 per replica and "
             "detection), the kv-sharded window, 0: its shards bypass the "
             "kernel, as the JAX route bypasses the Pallas one)",
        cases=[c for c in cases if c["dtype"] == dtype])
    if f32:
        entry["cuda_core_bound_ms"] = per_frame(
            lambda c: c["cuda_core_bound_ms"])
    return entry


def main() -> int:
    if not (ROOT / "hvrnet_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository (no "
              "hvrnet_tpu_torch package beside it)", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from hvrnet_tpu_torch.engine import HNMBRCNN, SelsaRCNN
    start = time.time()

    def lap(name):
        log(f"[time] {time.time() - start:.1f} s in, after {name}")

    kind = phase_device(torch)
    phase_build()
    cases = phase_attention(torch)
    lap("[attention]")
    engine, exact = phase_main_path(torch, np)
    stream, repair, forced = phase_stream(torch, np, engine, exact)
    exact63, stream63 = phase_63(torch, np, engine)
    lap("[main] and [stream]")
    stream16, exact16 = phase_bf16_hvrnet(torch, np, engine, exact, stream)
    lap("[bf16] HVRNet")
    hvr_weights = host_state_dict(engine)
    del engine
    torch.cuda.empty_cache()
    selsa, selsa_engine = phase_selsa(torch, np)
    selsa16 = phase_bf16_selsa(torch, np, selsa_engine)
    lap("[selsa]")
    selsa_weights = host_state_dict(selsa_engine)
    del selsa_engine
    torch.cuda.empty_cache()
    cli, cli16 = phase_cli(torch, np, hvr_weights, selsa_weights)
    lap("[cli]")
    lane_cases, lanes, lanes16 = phase_lanes(torch, np, hvr_weights,
                                             selsa_weights, cli)
    cases += lane_cases
    lap("[lanes]")
    aug_cases, aug, aug16 = phase_aug(torch, np, hvr_weights, selsa_weights)
    cases += aug_cases
    lap("[aug]")
    mp_cases, multipass, multipass16 = phase_multipass(torch, np, hvr_weights)
    cases += mp_cases
    lap("[multipass]")
    traced = phase_trace(torch, np, hvr_weights)
    lap("[trace]")
    image, image16 = phase_image(torch, np, hvr_weights, selsa_weights)
    lap("[image]")
    zoo = phase_zoo(torch, np)
    lap("[zoo]")
    dense = phase_dense(torch, np)
    lap("[dense]")
    deform, _ = phase_deform(torch, np)
    lap("[deform]")
    del selsa_weights
    trunks, trunks16 = phase_trunks(torch, np)
    lap("[trunks]")
    plugins = phase_plugins(torch, np)
    lap("[plugins]")
    datasets = phase_datasets(torch, np)
    lap("[datasets]")
    bf16 = torch.bfloat16
    cases += train_attention(torch)
    cases += train_attention(torch, dtype=bf16)
    train, weights = phase_train(torch, np)
    train16 = phase_bf16_train(
        torch, np, HNMBRCNN, CONFIG, weights,
        synthetic_train_batch(np), TRAIN_STAGES, "[bf16] train", 9,
        ("shared_head.", "bbox_head."), fp16_step=True)
    train_weights = {k: v.cpu() for k, v in weights.items()}
    del weights
    cases += train_attention(torch, SELSA_TRAIN_SHAPES, "[selsa-train]")
    cases += train_attention(torch, SELSA_TRAIN_SHAPES, "[selsa-train]",
                             dtype=bf16)
    selsa_train, weights = phase_selsa_train(torch, np)
    selsa_train16 = phase_bf16_train(
        torch, np, SelsaRCNN, SELSA_CONFIG, weights,
        synthetic_train_batch(np, seed=1, videos=1), SELSA_TRAIN_STAGES,
        "[bf16] selsa-train", 2,
        ("backbone.layer2.", "backbone.layer3.", "rpn_head.",
         "shared_head.", "bbox_head."))
    del weights
    lap("[train] and [selsa-train]")
    train_cli, _ = phase_train_cli(torch, np)
    lap("[train-cli]")
    _, multi = phase_multi(torch, np, train_weights, hvr_weights)
    del train_weights, hvr_weights
    lap("[multi]")
    runs = {"exact T=21": exact, "stream T=21": stream,
            "stream T=21 in-step repair": repair,
            "forced rollback T=21": forced, "exact T=63": exact63,
            "stream T=63": stream63, "selsa T=21": selsa, "train": train,
            "selsa train": selsa_train, **cli, **train_cli, **lanes, **aug,
            **multipass, "trace": traced, **image, **trunks, **datasets,
            **multi,
            **{k: v for k, v in {**zoo, **dense, **deform,
                                 **plugins}.items()
               if "bfloat16" not in k}}
    runs16 = {"stream T=21": stream16, "exact T=21": exact16,
              "selsa T=21": selsa16, "train": train16,
              "selsa train": selsa_train16, **cli16, **lanes16, **aug16,
              **multipass16, **image16, **trunks16,
              **{k: v for k, v in {**zoo, **dense, **deform,
                                   **plugins}.items()
                 if "bfloat16" in k}}
    print(json.dumps(kernel_summary(cases, runs, runs16)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_cards() -> int:
    """``python3 chip_smoke.py --cards``: ``[multi]`` alone, its ranks,
    lane replicas and key shards spread over every visible card (two or
    more), the ranks joined over NCCL; the same checks as in the one-card
    run, on the same weights."""
    if not (ROOT / "hvrnet_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository (no "
              "hvrnet_tpu_torch package beside it)", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --cards: needs two CUDA cards or more",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from hvrnet_tpu_torch.engine import HNMBRCNN
    from hvrnet_tpu_torch.utils.config import Config
    global MULTI_CARDS, MULTI_RANKS, MULTI_BACKENDS, MULTI_REPLICAS
    global MULTI_WINDOW_SHARDS
    n = torch.cuda.device_count()
    MULTI_CARDS, MULTI_RANKS, MULTI_BACKENDS = True, n, ("nccl", "nccl")
    MULTI_REPLICAS = n if MULTI_LANES % n == 0 else 2
    MULTI_WINDOW_SHARDS = n
    start = time.time()
    kind = phase_device(torch)
    phase_build()
    engine = build_engine(torch, np)
    hvr_weights = host_state_dict(engine)
    del engine
    cfg = Config.fromfile(str(CONFIG)).as_dict()
    engine = calibrated_training_engine(torch, HNMBRCNN, cfg,
                                        synthetic_train_batch(np), "[multi]")
    train_weights = host_state_dict(engine)
    del engine
    torch.cuda.empty_cache()
    phase_multi(torch, np, train_weights, hvr_weights)
    log(f"[time] {time.time() - start:.1f} s in, after [multi] over {n} "
        f"cards")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": n}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_cards() if sys.argv[1:] == ["--cards"] else main())
