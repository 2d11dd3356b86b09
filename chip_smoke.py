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
9. One JSON line of per-kernel numbers, then the result line.

Every path runs at full width and depth, the SELSA ones included; the
whole script, kernel builds included, took about 90 s on an H100 80GB
HBM3.

Exits non-zero without a result when no CUDA device is present, or when the
``hvrnet_tpu_torch`` package is not beside this file.
"""
from __future__ import annotations

import contextlib
import json
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


def build_engine(torch, np, window=None, stream_theta=None, weights=None):
    """HNMBRCNN from the shipped config, optionally at another window
    (frame_interval, t_dim and key_dim set together, as the 63-frame
    cache sets them) or with a head ``stream_theta``; ``weights`` is a
    state_dict to load, else seeded random weights with frozen-BN
    statistics calibrated on the first frame."""
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
    engine = HNMBRCNN(model_cfg, test_cfg, device="cuda", seed=0)
    if weights is None:
        n_bn = calibrate_frozen_bn(engine, [next(synthetic_video(np, 1))])
        how = f"seeded random weights, {n_bn} frozen BNs calibrated"
    else:
        engine.load_state_dict(weights)
        how = "the T=21 engine's weights"
    torch.cuda.synchronize()
    bh = engine.model_cfg["bbox_head"]
    log(f"[build] HNMBRCNN R101-C5 in {time.time() - t0:.1f} s ({how}): "
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


def phase_main_path(torch, np):
    from hvrnet_tpu_torch.models.bbox_heads import selsa_bbox_head
    from hvrnet_tpu_torch.ops.attention import (attention_plain,
                                                masked_attention)

    engine = build_engine(torch, np)
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


def train_attention(torch, shapes=TRAIN_SHAPES, tag="[train]"):
    """The kernel under autograd at the training ``shapes``, f32 with 10 %
    of the keys masked: its forward (and ``attention_backward_plain``)
    against the plain version differentiated by autograd, then its
    times."""
    import torch.nn.functional as F
    from hvrnet_tpu_torch.ops.attention import (NEG_INF, attention_plain,
                                                masked_attention, plan)
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
    head and decode stages alone."""
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
    del engine
    torch.cuda.empty_cache()
    return run


def timed_training(torch, np, engine, batch, cfg, work_dir, stages, tag,
                   launches_per_step):
    """``train_detector`` for TRAIN_WARMUP + TRAIN_TIMED steps on
    ``batch`` with the kernel's launch count set to 0 just before and read
    just after: per-step stage times (CUDA events), peak memory and
    losses, the mean over the timed steps, finite losses and
    ``launches_per_step`` launches checked.  Returns (trainer, summary)."""
    from hvrnet_tpu_torch.apis import train_detector
    from hvrnet_tpu_torch.ops.attention import masked_attention
    timer = StepTimer(torch, stages)
    steps = TRAIN_WARMUP + TRAIN_TIMED
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
    timed = slice(TRAIN_WARMUP, steps)
    mean = {name: sum(a.elapsed_time(b) for a, b in spans[name][timed])
            / TRAIN_TIMED for name in stages}
    step_mean = sum(step_ms[timed]) / TRAIN_TIMED
    log(f"{tag} {TRAIN_TIMED} timed steps: {step_mean:.3f} ms/step; "
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
    bitwise unchanged, trainable ones moved, and a bitwise resume."""
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
    return summary


def phase_selsa_train(torch, np):
    """SELSA training at the config's full width through
    ``train_detector``: 3 frames of one video, 300 RoIs per frame, OHEM
    128, the backbone from ``layer2``, the RPN, the shared head and the
    SELSA head trained; 2 warmup and 5 timed steps with a stage split, 2
    launches per step, frozen tensors bitwise unchanged and every
    trainable one moved."""
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
    return summary


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


def kernel_summary(cases, runs):
    """Per-kernel numbers for one detected frame of the exact ring at T=21:
    NL1..NL4 at f32 (two calls at each shape); launches on each path."""
    f32 = {c["label"]: c for c in cases
           if c["dtype"] == "float32" and "ms" in c}

    def per_frame(get, shapes=ATTN_SHAPES):
        return sum(2 * get(f32[label]) for *_, label in shapes)

    sums = {key: per_frame(lambda c: c[key])
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "cuda_core_bound_ms")}
    names = dict.fromkeys(name for *_, label in ATTN_SHAPES
                          for name in f32[label]["phases_ms"])
    phases = {name: per_frame(lambda c: c["phases_ms"].get(name, 0.0))
              for name in names}
    bound_by = {f32[label]["bound_by"] for *_, label in ATTN_SHAPES}
    launches = {path: run["launches"] for path, run in runs.items()}
    return {"kernels": [dict(
        name="masked_attention", route="cuda",
        source="hvrnet_tpu_torch/csrc/masked_attention.cu",
        replaces="hvrnet_tpu/ops/attention.py:42",
        launches=sum(launches.values()),
        launches_by_path=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases
                        if c["dtype"] == "float32"),
        ms=sums["ms"], plain_ms=sums["plain_ms"],
        bound_ms=sums["bound_ms"], bound_by="/".join(sorted(bound_by)),
        library_ms=sums["library_ms"],
        phases_ms=phases,
        cuda_core_bound_ms=sums["cuda_core_bound_ms"],
        bound_fraction=sums["bound_ms"] / sums["ms"],
        per_frame_t63={key: per_frame(lambda c: c[key], ATTN_SHAPES_63)
                       for key in ("ms", "plain_ms", "library_ms",
                                   "bound_ms")},
        per_step_train={key: 3 * sum(
            calls * f32[label][key] for calls, (*_, label) in
            zip((1, 2), TRAIN_SHAPES))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        per_frame_selsa={key: per_frame(lambda c: c[key]) / 2
                         for key in ("ms", "plain_ms", "library_ms",
                                     "bound_ms")},
        per_step_selsa_train={key: sum(f32[label][key] for *_, label in
                                       SELSA_TRAIN_SHAPES)
                              for key in ("ms", "plain_ms", "library_ms",
                                          "bound_ms")},
        unit="per detected frame of the exact ring at T=21: 2 calls at "
             "6300x6300 + 2 at 300x6300, d 1024, float32 (3xTF32 bound); "
             "per_frame_t63 the same at 18900x18900 and 300x18900; "
             "per_step_train one training step's 9 calls: per chosen "
             "video 1 at 384x384 and 2 at 128x384; per_frame_selsa one "
             "SELSA detection's 2 calls, 6300x6300 and 300x6300; "
             "per_step_selsa_train one SELSA training step's 2 calls, "
             "900x384 and 300x384; launches summed over the paths in "
             "launches_by_path, each counted from 0 over its run (30 "
             "frames; train: the 2 + 5 steps)",
        cases=cases)]}


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
    kind = phase_device(torch)
    phase_build()
    cases = phase_attention(torch)
    engine, exact = phase_main_path(torch, np)
    stream, repair, forced = phase_stream(torch, np, engine, exact)
    exact63, stream63 = phase_63(torch, np, engine)
    del engine
    torch.cuda.empty_cache()
    selsa = phase_selsa(torch, np)
    cases += train_attention(torch)
    train = phase_train(torch, np)
    cases += train_attention(torch, SELSA_TRAIN_SHAPES, "[selsa-train]")
    selsa_train = phase_selsa_train(torch, np)
    runs = {"exact T=21": exact, "stream T=21": stream,
            "stream T=21 in-step repair": repair,
            "forced rollback T=21": forced, "exact T=63": exact63,
            "stream T=63": stream63, "selsa T=21": selsa, "train": train,
            "selsa train": selsa_train}
    print(json.dumps(kernel_summary(cases, runs)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
