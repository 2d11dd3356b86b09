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
    with ``--calibrate-bn --validate`` for 2 epochs × 2 steps, resumed
    from ``latest.pth`` for a third; SELSA on the VID + DET concatenation
    for 2 steps.  Checked: finite losses, 9 and 2 launches per step,
    frozen tensors bitwise and trainable ones moved, the first sample the
    CLI trained on bitwise equal to ``train_batch_iterator``'s in this
    process, the step carried on, the hook's mAP per epoch equal to
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
    the sequential ``hnl_test``; on 4 videos of 64 frames against the
    sequential ``test`` with the same loader threads.
13. One JSON line of per-kernel numbers (the kernel's f32 and bf16 routes
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
                 dtype=None):
    """HNMBRCNN from the shipped config, optionally at another window
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
    log(f"[build] HNMBRCNN R101-C5 {str(engine.dtype)[6:]} in "
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
    from hvrnet_tpu_torch.models.bbox_heads import selsa_bbox_head
    from hvrnet_tpu_torch.ops.attention import (attention_plain,
                                                masked_attention)

    engine = build_engine(torch, np)
    warm_up(torch, np, engine)
    run = run_video(torch, np, engine, "[main]")
    if run["launches"] != 4 * run["detections"]:
        raise RuntimeError("the main path did not run the attention kernel "
                           "4 times per detection")

    # the window head on the last full window, with the kernel and with the
    # plain attention (these launches are not part of the counts above)
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
    log(f"[main] window head logits, kernel vs plain attention: max "
        f"|Δ|/max(|ref|, 1) = {worst:.3g}")
    if not worst <= 1e-4:
        raise RuntimeError("window head with the kernel disagrees with the "
                           "plain attention")
    stage_times(torch, np, engine, feats, fc1, valid, got)
    return engine, run


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


def calibrated_training_engine(torch, engine_cls, cfg, batch, tag):
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
    log(f"{tag} {engine_cls.__name__} R101-C5 training engine in "
        f"{time.time() - t0:.1f} s (seeded random weights, {n_bn} frozen "
        f"BNs calibrated on the first batch): {len(batch['imgs'])} frames, "
        f"head sampler_num {bh.sampler_num}, t_dim {bh.t_dim}, canvas "
        f"{CANVAS}")
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


def check_train_weights(torch, engine, before, tag, trained):
    """Every tensor outside the ``trained`` prefixes (the frozen stages and
    every frozen-BN buffer) bit for bit as before; every trainable tensor
    moved, except the key projections' biases, whose gradient is 0 (a
    constant per softmax row) and whose decay of 0 is 0."""
    params = dict(engine.model.named_parameters())
    frozen_moved, still = [], []
    for name, t in engine.model.state_dict().items():
        trains = name in params and params[name].requires_grad
        if not trains and not torch.equal(t, before[name]):
            frozen_moved.append(name)
        if trains and torch.equal(t, before[name]) and not (
                ".k_data_fc_" in name and name.endswith(".bias")):
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
    masked_attention.launches = 0
    run = main(argv, imread=read_ppm, timer=timer)
    torch.cuda.synchronize()
    launches = masked_attention.launches
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
        f"host pipeline on the stream's thread {pipe:.3f} ms/frame")
    run.update(fps=fps, wait_share=wait, pipeline_ms=pipe)
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
    set_window(cfg, 21)
    test_cfg = unwrap(cfg.test_cfg)
    engine = HNMBRCNN(unwrap(cfg.model), test_cfg, device="cuda")
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
    × 2 steps, resumed from ``latest.pth`` for a third epoch, then SELSA on
    the VID + DET concatenation for 2 steps.  Checked: finite losses, 9 /
    2 launches per step, frozen tensors bitwise and trainable ones moved,
    the first sample bitwise the in-process ``train_batch_iterator``'s, the
    step carried on, the hook's mAP equal to ``hnl_test --eval`` on
    ``epoch_1.pth``.  Returns the runs for the kernels line."""
    import shutil
    from hvrnet_tpu_torch.data.vid_dataset import build_dataset
    from hvrnet_tpu_torch.engine.stream import train_batch_iterator
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
    hvr = train_cli_run(torch, np, [hvr_cfg, "--work-dir", str(out),
                                    "--total-epochs", "2", "--calibrate-bn",
                                    "--validate", *common],
                        "[train-cli] hvrnet", TRAIN_STAGES, 9)
    check_train_weights(torch, hvr["engine"], hvr["before"],
                        "[train-cli] hvrnet", ("shared_head.", "bbox_head."))
    maps = [json.loads(line) for line in
            (out / "train_log.jsonl").read_text().splitlines()]
    maps = [m["mAP"] for m in maps if "mAP" in m]

    # the first sample trained on, against train_batch_iterator in this
    # process (the calibration's probe drawn first, as the loop draws it)
    cfg = Config.fromfile(hvr_cfg)
    dataset = build_dataset(unwrap(cfg.data.train),
                            dict(seed=0, imread=read_ppm))
    plans, plan = [0], dataset.plan

    def counted(idx):
        plans[0] += 1
        return plan(idx)

    dataset.plan = counted
    t0 = time.perf_counter()
    next(train_batch_iterator(dataset, CANVAS, seed=0))
    first = next(train_batch_iterator(dataset, CANVAS, seed=0))
    loader_s = time.perf_counter() - t0
    same = all(np.array_equal(first[k], hvr["first"][k]) for k in first)
    log(f"[train-cli] ({CARD}) loader in this process: 2 kept 27-frame "
        f"samples from {plans[0]} planned ({plans[0] - 2} skipped for a "
        f"frame off the {CANVAS[0]}x{CANVAS[1]} canvas), "
        f"{1e3 * loader_s / 2:.3f} ms per kept sample; the first sample "
        f"the CLI trained on bitwise equal to train_batch_iterator's: "
        f"{same}")
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
                                        str(out / "latest.pth"), *common],
                            "[train-cli] hvrnet resumed", TRAIN_STAGES, 9)
    log(f"[train-cli] resumed from latest.pth (step {hvr['trainer'].step}): "
        f"step {resumed['trainer'].step} after one more epoch")
    if not (hvr["trainer"].step == 4 and resumed["trainer"].step == 6):
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
LANES_LONG = tuple((f"val/ILSVRC2015_val_{i:08d}", 64, (720, 1280))
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


def lanes_attention(torch):
    """The kernel on B = 4 lanes at the exact ring's shapes (each lane its
    own keys and mask; lane 1 with half its keys masked) against its plain
    version, f32 and bf16 at their limits; a 1-lane call bitwise equal to
    the 2-D call; times of the lane call, of B separate 2-D calls, of the
    plain version and of SDPA on the same batched shapes; the bound B ×
    one call's."""
    import torch.nn.functional as F
    from hvrnet_tpu_torch.ops.attention import (NEG_INF, attention_plain,
                                                bf16_agreement,
                                                masked_attention, plan)
    gen = torch.Generator(device="cuda").manual_seed(1)
    scale, B = D ** -0.5, LANES_B
    cases = []
    for nq, nk, label in LANES_ATTN:
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
            log(f"[lanes] attention ({CARD}) " + json.dumps(case))
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

    def window_lanes(fc1_stack, masks):
        pairs = window(fc1_stack, masks)
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

    def window_lanes(fc1_stack, masks):
        own = window(fc1_stack, masks)
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
    ``LANES_LONG`` (4 videos of 64 frames: every stream busy to the end,
    10 padded pushes per 64 frames): frames/s of both, and the frame
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
             "calls each; launches summed over the paths in "
             "launches_by_path, each counted from 0 over its run (30 "
             "frames; train: the warmup + timed steps; cli: the CLI's "
             "run over the [cli] tree, 69 frames, 40 at T=63; train-cli: "
             "tools/train.py's steps and its hook's evaluations; lanes: "
             "4 streams over the [lanes] tree, 104 frames, and the CLI over "
             "it and over 4 videos of 64 frames, 4 launches per HVRNet "
             "lockstep detection and 2 per SELSA one, whatever the lane "
             "count)",
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
    del hvr_weights, selsa_weights
    bf16 = torch.bfloat16
    cases += train_attention(torch)
    cases += train_attention(torch, dtype=bf16)
    train, weights = phase_train(torch, np)
    train16 = phase_bf16_train(
        torch, np, HNMBRCNN, CONFIG, weights,
        synthetic_train_batch(np), TRAIN_STAGES, "[bf16] train", 9,
        ("shared_head.", "bbox_head."), fp16_step=True)
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
    runs = {"exact T=21": exact, "stream T=21": stream,
            "stream T=21 in-step repair": repair,
            "forced rollback T=21": forced, "exact T=63": exact63,
            "stream T=63": stream63, "selsa T=21": selsa, "train": train,
            "selsa train": selsa_train, **cli, **train_cli, **lanes}
    runs16 = {"stream T=21": stream16, "exact T=21": exact16,
              "selsa T=21": selsa16, "train": train16,
              "selsa train": selsa_train16, **cli16, **lanes16}
    print(json.dumps(kernel_summary(cases, runs, runs16)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
