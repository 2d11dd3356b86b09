"""Lockstep multi-stream sliding-window inference (counterpart of
``hvrnet_tpu/engine/batched_runner.py``).

The sequential runner moves one frame through the backbone and one window
through the head per step, which leaves the card waiting on the host.  For
throughput (the ImageNet-VID val sweep, ``tools/test.py --batched B``) this
runner drives B video streams in lockstep: each step runs one frame of
every stream through one batched frame program
(``engine.frame_features_batched``) and, when any stream emits, one window
detection per stream through the batched ring
(``engine.ring_detect_batched``: each NL block one kernel call for all
lanes, one NMS fixpoint for all decodes).

Each stream replays the reference's sliding-window loop exactly:
``make_window_schedule`` simulates it per video and gives a flat list of
(push offset, reset, emit offset) actions, so the windows and the order of
emissions equal the sequential runner's; streams at different phases mask
their emissions.  A stream that finishes its video takes the rank's next
one; a stream with none left repeats its last frame and never emits.

Draws: every video's frame order is shuffled (``video_shuffle``) from the
dataset's generator before any frame loads, then each step plans its
frames' pipelines (the per-frame draws) serially in stream order.  With
``loader_workers`` only the decode, resize and padding of the planned
frames go to a thread pool, so the results are bit for bit those of
``loader_workers=0``.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.pipelines import render
from ..ops.boxes import bbox2result_np
from .stream import runner_frame, u8_pipeline

Action = Tuple[int, bool, Optional[int]]
# lockstep detections stay on the device until this many are pending, then
# come to the host in one copy
FLUSH_EVERY = 8


def make_window_schedule(offsets: List[int], T: int) -> List[Action]:
    """Simulate the reference sliding-window loop over one video.

    Args:
        offsets: the order the video's frame offsets are visited in.
        T: window length.

    Returns:
        (push offset, reset, emit offset or None) per push; ``reset`` marks
        the video's first action, which fills the ring with that frame (the
        front padding); an emit offset names the frame whose detection the
        push completes.
    """
    L = len(offsets)
    half = (T + 1) // 2
    actions: List[Action] = []
    window: deque = deque(maxlen=T)

    def push(off):
        window.append(off)
        actions.append((off, False, None))

    def emit():
        off, reset, _ = actions[-1]
        actions[-1] = (off, reset, window[half - 1])

    for i, off in enumerate(offsets):
        if i == 0:
            # the reset fills the ring with the frame; the slots past the
            # first half are overwritten before the first emission
            for _ in range(half):
                window.append(off)
            actions.append((off, True, None))
        elif i < L - 1:
            push(off)
            if len(window) == T:
                emit()
        else:                       # the last frame: pad the tail, drain
            while len(window) < T - 1:
                push(off)
            for _ in range(min(L, half)):
                push(off)
                emit()
    return actions


class BatchedSlidingWindowRunner:
    """B video streams of one rank's whole-video shard in lockstep."""

    def __init__(self, engine, batch: int = 4, branch: int = -1,
                 progress_hook=None, loader_workers: int = 0,
                 u8_transfer: bool = False, timer=None):
        if batch < 1:
            raise ValueError(f"batch {batch}: the runner needs a stream")
        self.engine = engine
        self.batch = batch
        self.window = engine.window
        self.branch = branch            # which head branch to keep
        self.device_branch = (branch if getattr(engine, "multi_branch", False)
                              else None)
        self.num_classes = engine.num_classes
        self.progress_hook = progress_hook
        # > 0: a step's planned frames decode in a pool of this many threads
        self.loader_workers = int(loader_workers)
        # frames move to the card as uint8 and are normalised there
        self.u8_transfer = u8_transfer
        # ``timer.phase(name)`` around "load", "frame_features", "ring_push",
        # "window_detect" and "flush"
        self.timer = timer
        self.steps = 0                  # lockstep steps of the last run()
        self.detects = 0                # of which with a detection

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer else \
            contextlib.nullcontext()

    def run(self, dataset, rank: int = 0, max_long: int = 1008,
            max_short: int = 608) -> List:
        """Results per frame (per class an (n, 5) array), indexed by the
        rank-rebased frame id − 1, over ``len(dataset)`` slots."""
        pool = (cf.ThreadPoolExecutor(max_workers=self.loader_workers)
                if self.loader_workers > 0 else None)
        try:
            return self._run(dataset, rank, max_long, max_short, pool)
        finally:
            if pool is not None:
                pool.shutdown()

    def _run(self, dataset, rank, max_long, max_short, pool) -> List:
        eng, T, B = self.engine, self.window, self.batch
        pipeline = u8_pipeline(dataset) if self.u8_transfer \
            else dataset.pipeline
        results: List = [None] * len(dataset)

        # the rank's videos, each visited in its own (shuffled) order, all
        # drawn before any frame loads
        videos = sorted(set(dataset.global_video_list[i]
                            for i in dataset.indices_list[rank]))
        jobs = []
        for v in videos:
            order = list(range(dataset.img_infos[v]["frame_seg_len"]))
            if dataset.video_shuffle:
                dataset.rng.shuffle(order)
            jobs.append((v, make_window_schedule(order, T)))
        jobs = iter(jobs)

        def plan(video: int, offset: int):
            info = dataset.img_infos[video]
            r = dict(img_info=dataset._frame_info(info, offset))
            dataset.pre_pipeline(r, lazy=True)
            return pipeline(r), int(info["frame_id"])

        def load(planned):
            out, start_id = planned
            out["img"] = render(out["img"])
            frame = runner_frame(out, max_long, max_short, self.u8_transfer)
            frame["img"] = frame["img"][0]
            frame["frame_start_id"] = start_id
            return frame

        streams = [dict(actions=None, step=0, video=None, cache={},
                        last=None) for _ in range(B)]

        def refill(s) -> None:
            s["video"], s["actions"] = next(jobs, (None, None))
            s["step"], s["cache"] = 0, {}

        for s in streams:
            refill(s)

        state = None
        pending: List = []        # (device (B, max, 7) detections, emits)

        def flush():
            if not pending:
                return
            with self._phase("flush"):
                host = torch.stack([p[0] for p in pending]).cpu().numpy()
                for rows_b, (_, emits) in zip(host, pending):
                    for rows, e in zip(rows_b, emits):
                        if e is None:
                            continue
                        mask = rows[:, 6] > 0.5
                        results[e - 1] = bbox2result_np(
                            rows[mask, :5], rows[mask, 5].astype(np.int64),
                            self.num_classes)
                        if self.progress_hook:
                            self.progress_hook(1)
            pending.clear()

        self.steps = self.detects = 0
        while any(s["actions"] is not None for s in streams):
            resets = np.zeros(B, bool)
            emits: List[Optional[int]] = [None] * B   # frame ids emitted
            frames: List[Optional[Dict]] = [None] * B
            to_load: Dict[int, Tuple] = {}            # lane → (plan, emit)
            with self._phase("load"):
                # advance every stream's schedule; plan the loads serially,
                # in stream order (the pipeline's draws)
                for b, s in enumerate(streams):
                    if s["actions"] is not None and \
                            s["step"] >= len(s["actions"]):
                        refill(s)
                    if s["actions"] is None:
                        continue
                    off, reset, emit = s["actions"][s["step"]]
                    s["step"] += 1
                    resets[b] = reset
                    if off in s["cache"]:
                        frames[b] = s["cache"][off]
                        if emit is not None:
                            emits[b] = frames[b]["frame_start_id"] + emit
                    else:
                        to_load[b] = (plan(s["video"], off), off, emit)
                if pool is None:
                    loaded = {b: load(p) for b, (p, _, _) in to_load.items()}
                else:
                    futs = {b: pool.submit(load, p)
                            for b, (p, _, _) in to_load.items()}
                    loaded = {b: f.result() for b, f in futs.items()}
                for b, frame in loaded.items():
                    _, off, emit = to_load[b]
                    streams[b]["cache"] = {off: frame}   # the latest only
                    frames[b] = frame
                    if emit is not None:
                        emits[b] = frame["frame_start_id"] + emit
                live = [f for f in frames if f is not None]
                for b, s in enumerate(streams):
                    if frames[b] is None:
                        # a stream with no video left repeats a frame and
                        # never emits
                        frames[b] = s["last"] if s["last"] is not None \
                            else _blank_frame(live[0] if live else None,
                                              max_long, max_short,
                                              self.u8_transfer)
                    elif s["actions"] is not None:
                        s["last"] = frames[b]
                shapes = {f["img"].shape for f in frames}
                if len(shapes) > 1:
                    raise ValueError(
                        f"lockstep streams need one canvas per step, got "
                        f"{sorted(shapes)}: portrait and landscape videos "
                        f"cannot share a batch; run them on separate ranks "
                        f"(--world-size) or sequentially")
                imgs = np.stack([f["img"] for f in frames])
                ishs = np.stack([f["img_shape"] for f in frames])
                pshs = np.stack([f["pad_shape"] for f in frames])
                sfs = np.stack([f["scale_factor"] for f in frames])
            with self._phase("frame_features"):
                feats = eng.frame_features_batched(imgs, ishs, pshs)
            with self._phase("ring_push"):
                if state is None:
                    state = eng.ring_reset_batched(
                        B, int(feats["fc1"].shape[-1]))
                state = eng.ring_push_batched(state, feats, resets)
            self.steps += 1
            if any(e is not None for e in emits):
                with self._phase("window_detect"):
                    out = eng.ring_detect_batched(state, ishs, sfs,
                                                  branch=self.device_branch)
                    if isinstance(out, list):   # one det set per branch
                        out = out[self.branch]
                    dets, labels, mask = out
                    pending.append((torch.cat(
                        [dets, labels.float()[..., None],
                         mask.float()[..., None]], dim=-1), emits))
                self.detects += 1
                if len(pending) >= FLUSH_EVERY:
                    flush()
        flush()
        return results


def _blank_frame(like: Optional[Dict], max_long: int, max_short: int,
                 u8: bool) -> Dict:
    """A zero canvas for a stream that never had a video: the canvas of
    this step's other frames, else the landscape one."""
    hw = like["img"].shape[:2] if like is not None else (max_short, max_long)
    return dict(img=np.zeros(hw + (3,), np.uint8 if u8 else np.float32),
                img_shape=np.asarray(hw, np.float32),
                pad_shape=np.asarray(hw, np.float32),
                scale_factor=np.ones(4, np.float32), frame_start_id=1)
