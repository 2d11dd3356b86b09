"""Time the sequential inference path of one checkout, for comparing two
builds on one card.

    python3 hvrnet_tpu_torch/tools/ab_sequential.py --root <checkout> \\
        --tag parent --out results.jsonl

imports ``hvrnet_tpu_torch`` from ``--root`` (this file's own checkout by
default) and ``chip_smoke.py``'s helpers from this file's checkout, then
appends one JSON line to ``--out``:

- ``hashes``: sha256 of the 2-D ``masked_attention`` output at the exact
  ring's shapes and at ragged and small ones, f32 and bf16, on inputs made
  on the host from a seed (equal hashes: the same bits);
- for HVRNet (``configs/faster_rcnn_r101_hrnmp_c5.py``, R101-C5, T = 21,
  300 proposals, seeded random weights with frozen BNs calibrated on the
  first frame) in f32 and bf16: each ``[stages]`` stage of
  ``chip_smoke.py`` alone, the exact ring's window step (``ring_detect``
  on a full ring) and the sequential step (a frame program and a
  ``ring_step``), in ms from CUDA events, ``ITERS`` calls after
  ``WARMUP``, each the median of ``ROUNDS`` rounds;
- where the checkout has the lanes (``frame_features_batched``), the
  lockstep step at B = 1 and its stages, timed in the same rounds as the
  sequential step, alternating with it.

Run the two checkouts as separate processes in the order parent, change,
change, parent, and compare within the call.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
ITERS, WARMUP, ROUNDS = 10, 2, 3
HASH_SHAPES = ((6300, 6300), (300, 6300), (300, 6299), (40, 200),
               (700, 130))


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def kernel_hashes(torch):
    from hvrnet_tpu_torch.ops.attention import NEG_INF, masked_attention
    out = {}
    for nq, nk in HASH_SHAPES:
        gen = torch.Generator().manual_seed(nq * 7919 + nk)
        q, k, v = (torch.randn(n, 1024, generator=gen) for n in (nq, nk, nk))
        live = torch.rand(nk, generator=gen) >= 0.1
        bias = torch.where(live, 0.0, NEG_INF).float().cuda()
        for dt in (torch.float32, torch.bfloat16):
            got = masked_attention(q.to(dt).cuda(), k.to(dt).cuda(),
                                   v.to(dt).cuda(), bias, 1024 ** -0.5)
            out[f"{nq}x{nk} {dt}"] = hashlib.sha256(
                got.float().cpu().numpy().tobytes()).hexdigest()
    return out


def median_ms(smoke, torch, fns):
    """{name: median over ROUNDS of the mean ms of ITERS calls}, the
    functions interleaved round by round."""
    spans = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            spans[name].append(smoke.cuda_ms(torch, fn, iters=ITERS,
                                             warmup=WARMUP))
    return {name: statistics.median(v) for name, v in spans.items()}


def engine_times(smoke, torch, np, dtype):
    from hvrnet_tpu_torch.engine.detector import _rpn_proposals
    from hvrnet_tpu_torch.models.bbox_heads.bbox_head import get_det_bboxes
    engine = smoke.build_engine(torch, np, dtype=dtype)
    smoke.warm_up(torch, np, engine)
    frames = list(smoke.synthetic_video(np, engine.window + 1, seed=1))
    feats = [engine.frame_features(f["img"], f["img_shape"], f["pad_shape"])
             for f in frames]
    kd, P = engine.key_dim, engine.proposal_num
    fc1 = torch.cat([f["fc1"] for f in feats[:engine.window]])
    valid = torch.cat([f["mask"] for f in feats[:engine.window]])
    f0 = frames[-1]
    img, ish, psh, sf = (f0["img"], f0["img_shape"], f0["pad_shape"],
                         f0["scale_factor"])
    head = engine.model.bbox_head
    ring = engine.ring_reset(int(feats[0]["fc1"].shape[-1]))
    for f in feats[:engine.window]:
        engine.ring_push(ring, f)
    with torch.no_grad():
        maps = engine.backbone_maps(img, ish)
        head_out = head.forward_fc1(fc1, kd * P, P, valid)
    canvas = engine._canvas(*smoke.CANVAS)
    rcnn = engine.test_cfg["rcnn"]
    fns = {
        "backbone": lambda: engine.backbone_maps(img, ish),
        "proposals": lambda: _rpn_proposals(
            maps[1][0], maps[2][0], canvas, psh, ish,
            engine.test_cfg["rpn"], engine.rpn_means, engine.rpn_stds),
        "frame post": lambda: engine.frame_post(*maps, ish, psh),
        "window head": lambda: head.forward_fc1(fc1, kd * P, P, valid),
        "decode + NMS": lambda: get_det_bboxes(
            feats[kd]["boxes"], head_out[0][-1], head_out[1][-1], ish, sf,
            engine.target_means, engine.target_stds, rescale=True,
            cfg=rcnn, valid=feats[kd]["mask"]),
        "exact window step": lambda: engine.ring_detect(ring, ish, sf,
                                                        branch=-1),
        "sequential step": lambda: engine.ring_step(
            ring, engine.frame_features(img, ish, psh), ish, sf, branch=-1),
    }
    if hasattr(engine, "frame_features_batched"):
        lane = engine.ring_reset_batched(1, int(feats[0]["fc1"].shape[-1]))
        engine.ring_push_batched(lane, {k: v[None] for k, v in
                                        feats[0].items()}, np.ones(1, bool))
        ishs, pshs, sfs = ish[None], psh[None], sf[None]
        no_reset = np.zeros(1, bool)

        def lockstep():
            f = engine.frame_features_batched(img, ishs, pshs)
            engine.ring_push_batched(lane, f, no_reset)
            return engine.ring_detect_batched(lane, ishs, sfs, branch=-1)

        fns.update({
            "B=1 frame program": lambda: engine.frame_features_batched(
                img, ishs, pshs),
            "B=1 window step": lambda: engine.ring_detect_batched(
                lane, ishs, sfs, branch=-1),
            "B=1 lockstep step": lockstep,
        })
    with torch.no_grad():
        out = median_ms(smoke, torch, fns)
    del engine, ring, maps
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="the checkout whose hvrnet_tpu_torch is timed")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--out", required=True, help="JSON lines appended here")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import hvrnet_tpu_torch
    if Path(hvrnet_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {hvrnet_tpu_torch.__file__}, not the "
                           f"package under {root}")
    if not torch.cuda.is_available():
        print("ab_sequential: no CUDA device", file=sys.stderr)
        return 2
    smoke = load_smoke()
    card = smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(tag=args.tag, root=str(root), card=card.strip(),
               iters=ITERS, warmup=WARMUP, rounds=ROUNDS,
               hashes=kernel_hashes(torch),
               f32_ms=engine_times(smoke, torch, np, torch.float32),
               bf16_ms=engine_times(smoke, torch, np, torch.bfloat16))
    line = json.dumps(rec)
    print(line, flush=True)
    with open(args.out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
