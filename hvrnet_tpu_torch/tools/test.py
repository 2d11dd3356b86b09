"""Whole-video VID test CLI, single process per rank (counterpart of the
JAX package's ``tools/test.py`` single-chip path, which ``tools/selsa_test.py``
runs for SELSA):

    python -m hvrnet_tpu_torch.tools.test configs/faster_rcnn_r101_selsa_c5.py \\
        work_dirs/selsa.pth --out results.pkl --eval

reads the config's ``data.test`` VID tree, runs the sliding window over
every video on the card, writes the per-frame results (per class an
(n, 5) array of x1, y1, x2, y2, score) and, with ``--eval``, prints the
VID mAP.  ``--rank r --world-size n`` runs one of n processes, each on its
own whole videos; rank 0 merges the part files.  ``--device cpu`` runs on
the CPU.  Images are read with ``--decoder``: ``cv2`` (the default, needs
cv2), ``native`` (the port's own decoder, ``data/jpeg.py``: baseline JPEG
and binary PPM/PGM, bit for bit cv2; what a real VID tree needs on a
machine without cv2) or ``module:function``, an importable callable
``path -> (H, W, 3) uint8 BGR`` array.

Throughput: ``--batched B`` runs B videos in lockstep
(``engine.batched_runner``: one batched frame program and one batched
window detection per step, the same windows and detections per video);
``--loader-workers N`` decodes frames in N threads (on the sequential
runner a threaded stream whose shuffles are drawn before any frame, as in
the JAX CLI); ``--pair-features P`` runs P consecutive interior frames
through one frame program on the sequential runner.

``--spmd-lanes [N]`` with ``--batched B`` splits the B lanes over every
visible card (or the first N), one replica of the engine per card in this
process (``engine.enable_spmd_lanes``); on the CPU, N replicas.

``--aug-test`` runs flip-augmented testing (the reference's
``MultiScaleFlipAug(flip=True)``): every frame and its mirror, proposals
merged per frame, the two heads' scores and boxes averaged per detection,
on the sequential stream.  ``--timing`` prints the host wall time per
phase after the run (``utils/profiling.py:PhaseTimer``); ``--trace DIR``
writes a ``torch.profiler`` trace of the run, host and card, into DIR.

Flags of the JAX CLI that the port does not run yet (``--show``) stop the
CLI with the ROADMAP item that will port them; none is accepted and
ignored.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import logging
import os
import pickle
import time
from typing import Dict, Tuple

import torch

from ..apis import build_detector, load_params_for_engine
from ..data.pipelines import resolve_decoder
from ..data.vid_dataset import build_dataset
from ..engine.detector import resolve_device
from ..engine.batched_runner import BatchedSlidingWindowRunner
from ..engine.stream import (parallel_test_frame_stream, prefetch_stream,
                             test_frame_stream)
from ..engine.video_runner import SlidingWindowRunner
from ..parallel.mesh import make_mesh
from ..utils.config import Config
from ..utils.dist_io import (collect_results, dump_part, trim_to_local,
                             wait_for_parts)
from ..utils.profiling import PhaseTimer, trace

logger = logging.getLogger("hvrnet_tpu_torch")

# flags of the JAX CLI that stop this one: flag → (refused when, ROADMAP item)
REFUSED = {
    "show": (bool, "Queue 1 item 7 (--show, which draws with cv2)"),
}


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The flags both test CLIs share."""
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--world-size", type=int, default=1,
                   help="number of video shards (ranks)")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--tmpdir", default=None,
                   help="directory for the ranks' part files (default: "
                        "the directory of --out)")
    p.add_argument("--eval", action="store_true",
                   help="print the VID mAP of the merged results")
    p.add_argument("--json_out", default=None,
                   help="COCO-results json file name WITHOUT extension: "
                        "rank 0 writes <json_out>.bbox.json after the merge")
    p.add_argument("--merge-timeout", type=float, default=3600.0,
                   help="rank 0's wait (s) for the other ranks' part files")
    p.add_argument("--branch", type=int, default=-1,
                   help="which head branch to keep (HVRNet)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute with float32 parameters, the bbox "
                        "head's weights pre-cast")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the dataset's frame shuffles and flip draws")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--decoder", default="cv2",
                   help="image decoder: cv2, native (the port's baseline "
                        "JPEG and PPM/PGM decoder, bit for bit cv2), or "
                        "module:function taking a path and returning an "
                        "(H, W, 3) uint8 BGR array")
    p.add_argument("--show", action="store_true")


def exclusive(args: argparse.Namespace) -> None:
    """The JAX CLI's rules for flags that do not combine, with its
    messages."""
    if getattr(args, "spmd_lanes", None) is not None and not args.batched:
        raise SystemExit("--spmd-lanes requires --batched B (the lanes are "
                         "the batched runner's streams)")
    if args.batched:
        if args.aug_test:
            raise SystemExit("--batched and --aug-test are exclusive")
        if args.timing:
            raise SystemExit("--timing is not supported with --batched "
                             "(the lockstep runner has no per-phase timer)")
        if args.pair_features > 1:
            raise SystemExit("--pair-features applies to the sequential "
                             "runner; --batched already batches the feature "
                             "stage across streams")
    elif args.u8_transfer and args.aug_test:
        raise SystemExit("--u8-transfer is not supported with --aug-test")


def spmd_devices(args: argparse.Namespace):
    """The devices of ``--spmd-lanes [N]``: every visible card, or the
    first N; on the CPU, N times the CPU.  ``--batched`` must divide by
    their count."""
    n = args.spmd_lanes
    if torch.device(args.device).type == "cpu" and n < 1:
        raise SystemExit("--spmd-lanes on the CPU takes the replica count "
                         "(--spmd-lanes N)")
    try:
        devices = make_mesh(n if n >= 1 else None, args.device)
    except ValueError as e:
        raise SystemExit(f"--spmd-lanes: {e}") from e
    if args.batched % len(devices):
        raise SystemExit(f"--spmd-lanes needs --batched divisible by the "
                         f"device count ({len(devices)})")
    return devices


def refuse(args: argparse.Namespace) -> None:
    """Stop on a flag whose path is not ported yet."""
    for name, (when, item) in REFUSED.items():
        value = getattr(args, name, None)
        if value is not None and when(value):
            raise SystemExit(f"--{name.replace('_', '-')} is not ported yet "
                             f"(ROADMAP {item})")


def decoder_from_flag(name: str):
    """``cv2``, ``native`` or ``module:function`` → an imread callable."""
    if name in ("cv2", "native"):
        return resolve_decoder(name)
    module, _, func = name.partition(":")
    if not func:
        raise SystemExit(f"--decoder {name!r}: give cv2, native or "
                         f"module:function")
    return getattr(importlib.import_module(module), func)


def set_window(engine, window: int) -> None:
    """``--window W`` as the JAX ``test`` sets it: the engine's window
    (the ring's length) and its key frame ``(W - 1) // 2``.  The head keeps
    the config's t_dim, so it keys the first ``sampler_num·t_dim`` rows of
    a longer window, as the JAX head does."""
    if window < 1:
        raise SystemExit(f"--window {window}: the window is at least 1 frame")
    engine.window = window
    engine.key_dim = (window - 1) // 2


def canvas_of(cfg) -> Tuple[int, int]:
    """The landscape canvas (H, W) that holds every frame of the test
    pipeline: its keep-ratio ``Resize`` scale rounded up by its ``Pad``
    divisor (608 × 1008 for the shipped configs); portrait frames take
    W × H."""
    steps = {t["type"]: t for t in cfg.data.test["pipeline"]}
    resize, pad = steps.get("Resize"), steps.get("Pad")
    if not (resize and resize.get("keep_ratio", True) and pad
            and pad.get("size_divisor")):
        raise SystemExit("the test pipeline needs a keep-ratio Resize and "
                         "a Pad(size_divisor=...) to size the canvas")
    d = int(pad["size_divisor"])
    scale = resize.get("img_scale", (1000, 600))
    return -(-min(scale) // d) * d, -(-max(scale) // d) * d


def test_dataset(cfg, world_size: int, seed: int, imread):
    """The config's ``data.test`` with its ``relation_setup``, in test
    mode."""
    data = dict(cfg.data.test)
    data.update(dict(cfg.test_cfg.relation_setup))
    data.pop("frame_stride", None)
    return build_dataset(data, dict(test_mode=True, world_size=world_size,
                                    seed=seed, imread=imread))


def test_engine(cfg, args):
    engine = build_detector(
        cfg.model, None, cfg.test_cfg,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device)
    load_params_for_engine(engine, args.checkpoint)
    engine.cast_head_params_bf16()      # a no-op without --bf16
    return engine


def setup(args) -> None:
    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(message)s",
                        level=logging.INFO)
    logger.setLevel(logging.INFO if args.rank == 0 else logging.ERROR)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"no CUDA device is available; pass --device cpu "
                         f"to run on the CPU ({e})") from e


def run_test(args, cfg, dataset, engine, imread, prepad_provider=None,
             u8_transfer: bool = False, timer=None) -> Dict:
    """The runner over this rank's videos (under ``--trace``, traced), its
    part file, and on rank 0 the merge, ``--json_out`` and ``--eval``.
    Returns the run's record: ``results`` (merged on rank 0, else this
    rank's), ``map`` (with ``--eval``), ``runner``, ``dataset``, ``wall_s``
    (the runner's) and ``frames`` (this rank's)."""
    done = [0]

    def progress(k):
        done[0] += k
        if done[0] % 100 < k:
            logger.info("rank %d: %d frames done", args.rank, done[0])

    h, w = canvas_of(cfg)
    canvas = dict(max_long=max(h, w), max_short=min(h, w))
    workers = getattr(args, "loader_workers", 1)
    aug = getattr(args, "aug_test", False)
    trace_dir = getattr(args, "trace", None)
    traced = trace(trace_dir) if trace_dir else contextlib.nullcontext()
    if getattr(args, "batched", 0):
        runner = BatchedSlidingWindowRunner(
            engine, batch=args.batched, branch=args.branch,
            progress_hook=progress, loader_workers=max(workers, 0),
            u8_transfer=u8_transfer, timer=timer)
        t0 = time.perf_counter()
        with traced:
            results = runner.run(dataset, rank=args.rank, **canvas)
    else:
        runner = SlidingWindowRunner(engine, branch=args.branch,
                                     progress_hook=progress, timer=timer,
                                     prepad_provider=prepad_provider,
                                     pair_features=args.pair_features,
                                     aug=aug)
        if workers > 1 and not aug:
            stream = parallel_test_frame_stream(
                dataset, rank=args.rank, workers=workers,
                u8_transfer=u8_transfer, **canvas)
        else:
            stream = prefetch_stream(test_frame_stream(
                dataset, rank=args.rank, u8_transfer=u8_transfer,
                timer=timer, aug_flip=aug, **canvas))
        if timer is not None:
            stream = _waited(stream, timer)
        t0 = time.perf_counter()
        with traced:
            results = runner.run(stream, num_frames=len(dataset))
    wall = time.perf_counter() - t0
    tmpdir = args.tmpdir or os.path.dirname(os.path.abspath(args.out)) or "."
    local = trim_to_local(results, dataset, args.rank)
    dump_part(local, tmpdir, args.rank)
    logger.info("rank %d wrote its part file", args.rank)
    run = dict(results=local, map=None, runner=runner, dataset=dataset,
               wall_s=wall, frames=len(local))
    if args.rank != 0:
        return run
    parts = [os.path.join(tmpdir, f"part_{r}.pkl")
             for r in range(args.world_size)]
    wait_for_parts(parts, timeout=args.merge_timeout)
    merged = collect_results(tmpdir, args.world_size, len(dataset))
    with open(args.out, "wb") as f:
        pickle.dump(merged, f)
    logger.info("merged results → %s", args.out)
    run["results"] = merged
    if args.json_out:
        path = vid_results2json(dataset, merged, args.json_out + ".bbox.json")
        logger.info("COCO-json results → %s", path)
    if args.eval:
        from .vid_eval import evaluate_results
        run["map"], _ = evaluate_results(args.out, args.config, imread=imread)
    return run


def _waited(stream, timer):
    """The stream with the runner's wait for each frame in the
    ``stream_wait`` phase."""
    it = iter(stream)
    while True:
        with timer.phase("stream_wait"):
            frame = next(it, None)
        if frame is None:
            return
        yield frame


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SELSA / HVRNet VID test")
    add_common_args(p)
    p.add_argument("--out", default="results.pkl")
    p.add_argument("--window", type=int, default=None,
                   help="window length W: the ring holds W frames and "
                        "detects frame (W - 1) // 2; the head keeps the "
                        "config's t_dim")
    p.add_argument("--u8-transfer", action="store_true",
                   help="move frames to the device as uint8 and normalise "
                        "there (4× fewer bytes, the same engine input)")
    p.add_argument("--aug-test", action="store_true",
                   help="flip-augmented testing: each frame and its mirror, "
                        "proposals merged per frame, scores and boxes "
                        "averaged per detection")
    p.add_argument("--loader-workers", type=int, default=1,
                   help="> 1: decode frames in this many threads (the "
                        "sequential runner's threaded stream draws every "
                        "video's shuffle first); with --batched, the "
                        "threads that decode each step's frames")
    p.add_argument("--pair-features", type=int, default=1, metavar="P",
                   help="run P consecutive interior frames through one "
                        "frame program (sequential runner)")
    p.add_argument("--batched", type=int, default=0, metavar="B",
                   help="drive B video streams in lockstep through the "
                        "batched frame program and ring")
    p.add_argument("--spmd-lanes", type=int, nargs="?", const=0,
                   default=None, metavar="N",
                   help="with --batched B: split the B lanes over every "
                        "visible card (or the first N; on the CPU, N "
                        "replicas), one engine replica per card")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run (host and "
                        "card) into DIR")
    p.add_argument("--timing", action="store_true",
                   help="print the host wall time per phase after the run")
    return p.parse_args(argv)


def main(argv=None, imread=None, timer=None) -> Dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``).  ``imread``, a
    decoder callable, overrides ``--decoder``; ``timer.phase(name)``, when
    given, wraps the runner's stages, the stream's pipeline and canvas
    steps and the runner's wait for each frame, in place of the
    ``PhaseTimer`` that ``--timing`` makes; with ``--timing`` the timer's
    ``summary()`` is printed after the run."""
    args = parse_args(argv)
    exclusive(args)
    refuse(args)
    setup(args)
    devices = spmd_devices(args) if args.spmd_lanes is not None else None
    imread = imread or decoder_from_flag(args.decoder)
    cfg = Config.fromfile(args.config)
    dataset = test_dataset(cfg, args.world_size, args.seed, imread)
    engine = test_engine(cfg, args)
    if args.window:
        set_window(engine, args.window)
    if devices is not None:
        engine.enable_spmd_lanes(devices)
        logger.info("SPMD lanes: %d streams over %d devices", args.batched,
                    len(devices))
    if args.u8_transfer:
        # the device normalises with THIS config's values
        norm = next((t for t in cfg.data.test["pipeline"]
                     if t["type"] == "Normalize"), None)
        if norm is not None:
            if norm.get("to_rgb", False):
                raise SystemExit("--u8-transfer supports to_rgb=False "
                                 "pipelines only (BGR, like both shipped "
                                 "configs)")
            engine.img_norm = dict(mean=tuple(norm["mean"]),
                                   std=tuple(norm["std"]))
    if timer is None and args.timing:
        timer = PhaseTimer()
    run = run_test(args, cfg, dataset, engine, imread,
                   u8_transfer=args.u8_transfer, timer=timer)
    if args.timing:
        print(timer.summary())
    return run


def _iter_frames(dataset):
    """(global frame index, video info, in-video offset) in dataset order."""
    fid = 0
    for vinfo in dataset.img_infos:
        for off in range(vinfo["frame_seg_len"]):
            yield fid, vinfo, off
            fid += 1


def vid_results2json(dataset, results, out_file):
    """Merged per-frame results → COCO results json: xywh with the +1 VOC
    width, ``category_id`` = label + 1, image ids ``pattern % offset``."""
    json_results = []
    for fid, vinfo, off in _iter_frames(dataset):
        if fid >= len(results) or results[fid] is None:
            continue
        res = results[fid]
        if isinstance(res, list) and len(res) == 2 and isinstance(res[0],
                                                                  list):
            res = res[1]      # (branch, final) pairs
        for label, dets in enumerate(res):
            for det in dets:
                x1, y1, x2, y2, score = [float(v) for v in det[:5]]
                json_results.append(dict(
                    image_id=vinfo["pattern"] % off,
                    bbox=[x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                    score=score, category_id=label + 1))
    with open(out_file, "w") as f:
        json.dump(json_results, f)
    return out_file


if __name__ == "__main__":
    main()
