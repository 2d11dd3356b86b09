"""Sliding-window video inference runner (counterpart of
``hvrnet_tpu/engine/video_runner.py:SlidingWindowRunner``, exact ring).

The reference's stateful test loop, per frame ``key_frame_flag``:
  * 0, video start: a fresh ring, front-padded with the first frame (or
    with ``prepad_provider``'s frames) to (T+1)/2 entries;
  * 2, interior: push the frame; once T entries are cached, detect the
    centre frame;
  * 1, video end: pad the tail with the last frame and drain the remaining
    centres (≤ min(seg_len, (T+1)/2) detections).
Results land by absolute frame id, as the reference places them, so
``vid_eval`` ordering matches.  Detections stay on the device and are pulled
to the host in chunks of ``flush_every``.

On a streaming engine (``engine.stream``) the runner speculates by default:
the steps run without the in-step exact repair and carry a sticky health
flag, read in the same pull as each chunk's detections.  A flagged chunk's
detections are recomputed exactly (``window_detect`` over a history of the
last T + ``flush_every`` pushes) and the accumulators rebuilt
(``engine.stream_rebuild``), so every emitted detection is either a healthy
streaming one or exact.

``pair_features`` P > 1 buffers P consecutive interior frames and runs
their frame programs as one ``engine.frame_features_batched`` call, then
pushes and detects each in order: only the frame program batches, so the
windows and the order of emissions are unchanged (a partial buffer at a
video's end goes frame by frame).

``aug`` runs flip-augmented testing: each frame carries its augmentations
(``img_augs``, ``flips``, as ``test_frame_stream(aug_flip=True)`` gives
them), ``engine.frame_features_aug`` merges their proposals, and each
detection is ``engine.window_detect_aug`` over the exact window of the last
T frames' (A, P, D) caches, oldest first.  It never takes the streaming
ring, and combines with neither ``prepad_provider`` nor ``pair_features``.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..ops.boxes import bbox2result_np


class SlidingWindowRunner:
    """Runs a video engine (``HNMBRCNN`` or ``SelsaRCNN``) over a sequential
    frame stream."""

    def __init__(self, engine, branch: int = -1, progress_hook=None,
                 timer=None, prepad_provider=None, flush_every: int = 16,
                 speculative_stream=None, pair_features: int = 1,
                 aug: bool = False):
        if aug and prepad_provider is not None:
            raise ValueError("aug testing and random pre-padding do not "
                             "combine: pre-padding frames carry one "
                             "augmentation's caches")
        if aug and pair_features > 1:
            raise ValueError("aug testing and pair_features > 1 do not "
                             "combine: the augmentations already batch the "
                             "frame program")
        self.engine = engine
        self.aug = aug
        self.window = engine.window
        self.key_dim = engine.key_dim   # the centre the engine decodes
        self.branch = branch            # which head branch to keep
        # multi-branch engines decode only the stored branch
        self.device_branch = (branch if getattr(engine, "multi_branch", False)
                              else None)
        self.num_classes = engine.num_classes
        self.progress_hook = progress_hook
        # ``timer.phase(name)`` context manager around the "frame_features"
        # and "window_detect" stages
        self.timer = timer
        self.flush_every = max(int(flush_every), 1)
        # start-of-video padding: maps the video's first frame dict to frame
        # dicts pushed before it (the reference pads with random frames of
        # the same video)
        self.prepad_provider = prepad_provider
        # speculative rollback on a streaming engine: on unless the caller
        # says otherwise here or set engine.stream_rollback on the instance
        if speculative_stream is None:
            spec = bool(vars(engine).get("stream_rollback", True))
        else:
            spec = bool(speculative_stream)
        self.speculative = spec and engine.stream and not aug
        # interior frames per frame program
        self.pair_features = max(int(pair_features), 1)
        # chunks replayed and detections recomputed by the last run()
        self.rebuilds = 0
        self.replayed = 0

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer else \
            contextlib.nullcontext()

    def run(self, frame_stream: Iterable[Dict], num_frames: int) -> List:
        """frame_stream yields dicts with keys img ((1, H, W, 3) canvas,
        normalised float32 or raw uint8), img_shape (2,), pad_shape (2,),
        scale_factor, key_frame_flag, frame_offset, seg_len, frame_start_id.

        Returns per-frame per-class det lists indexed by absolute frame
        id − 1.
        """
        # ring_step reads engine.stream_rollback, so it follows this runner
        # while it runs; the caller's setting comes back afterwards
        eng = self.engine
        if not eng.stream:
            return self._run(frame_stream, num_frames)
        prior = vars(eng).get("stream_rollback")
        eng.stream_rollback = self.speculative
        try:
            return self._run(frame_stream, num_frames)
        finally:
            if prior is None:
                del eng.stream_rollback
            else:
                eng.stream_rollback = prior

    def _run(self, frame_stream: Iterable[Dict], num_frames: int) -> List:
        eng = self.engine
        T = self.window
        half = (T + 1) // 2
        results: List = [None] * num_frames
        ring = None
        cache: deque = deque(maxlen=T)      # the aug window's frame caches
        n_cached = 0
        offsets: deque = deque(maxlen=T)
        meta: deque = deque(maxlen=T)
        pending: List = []
        # the frames' own feats for exact replay: a chunk's oldest detection
        # looks back at most T + flush_every − 1 pushes
        hist: deque = deque(maxlen=T + self.flush_every)
        push_count = 0
        self.rebuilds = self.replayed = 0

        def pack(outs):
            return torch.cat([
                torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]).float()[..., None],
                torch.stack([o[2] for o in outs]).float()[..., None]],
                dim=-1)

        def replay_exact(push_no, m):
            """The detection emitted at push ``push_no``, recomputed over
            the whole window from the feats history."""
            newest = len(hist) - 1 - (push_count - push_no)
            window = [hist[newest - T + 1 + j] for j in range(T)]
            out = eng.window_detect(
                torch.stack([c["fc1"] for c in window]),
                torch.stack([c["boxes"] for c in window]),
                torch.stack([c["mask"] for c in window]),
                m["img_shape"], m["scale_factor"], branch=self.device_branch)
            return out[self.branch] if isinstance(out, list) else out

        def flush():
            nonlocal ring
            if not pending:
                return
            packed = pack([p[0] for p in pending])
            if self.speculative:
                # the flag rides in the detections' one device→host pull
                flat = torch.cat([packed.reshape(-1),
                                  ring["flag"].reshape(1).float()]).cpu()
                packed, flagged = flat[:-1].reshape(packed.shape), \
                    bool(flat[-1] > 0.5)
                if flagged:
                    packed = pack([replay_exact(pno, m)
                                   for _, _, m, pno in pending])
                    ring = eng.stream_rebuild(ring)
                    self.rebuilds += 1
                    self.replayed += len(pending)
            packed = packed.cpu().numpy()
            for (_, fid, _, _), rows in zip(pending, packed):
                mask = rows[:, 6] > 0.5
                results[fid - 1] = bbox2result_np(
                    rows[mask, :5], rows[mask, 5].astype(np.int64),
                    self.num_classes)
            if self.progress_hook:
                self.progress_hook(len(pending))
            pending.clear()

        def push(feats, frame, fmeta, detect: bool = False):
            nonlocal ring, n_cached, push_count
            n_cached = min(n_cached + 1, T)
            offsets.append(frame["frame_offset"])
            meta.append(fmeta)
            push_count += 1
            if self.speculative:
                hist.append(feats)
            if self.aug:
                cache.append(feats)
            if not (detect and n_cached == T):
                if not self.aug:
                    ring = eng.ring_push(ring, feats)
                return
            m = meta[self.key_dim]
            with self._phase("window_detect"):
                if self.aug:
                    out = eng.window_detect_aug(
                        torch.stack([c["fc1"] for c in cache], dim=1),
                        torch.stack([c["boxes"] for c in cache]),
                        torch.stack([c["mask"] for c in cache]),
                        m["img_shapes"], m["scale_factors"], m["flips"],
                        branch=self.device_branch)
                else:
                    ring, out = eng.ring_step(ring, feats, m["img_shape"],
                                              m["scale_factor"],
                                              branch=self.device_branch)
            if isinstance(out, list):       # one det set per head branch
                out = out[self.branch]
            pending.append((out, m["frame_start_id"] + offsets[self.key_dim],
                            m, push_count))
            if len(pending) >= self.flush_every:
                flush()

        def fmeta_of(frame):
            return dict(img_shape=frame["img_shape"],
                        scale_factor=frame["scale_factor"],
                        frame_start_id=frame["frame_start_id"])

        pairs: List[Dict] = []      # interior frames waiting for a program

        def flush_pairs():
            if not pairs:
                return
            with self._phase("frame_features"):
                if len(pairs) == self.pair_features:
                    fb = eng.frame_features_batched(
                        torch.cat([torch.as_tensor(fr["img"])
                                   for fr in pairs]),
                        np.stack([fr["img_shape"] for fr in pairs]),
                        np.stack([fr["pad_shape"] for fr in pairs]))
                    flist = [{k: v[j] for k, v in fb.items()}
                             for j in range(len(pairs))]
                else:               # a partial buffer: frame by frame
                    flist = [eng.frame_features(fr["img"], fr["img_shape"],
                                                fr["pad_shape"])
                             for fr in pairs]
            for fr, feats in zip(pairs, flist):
                push(feats, fr, fmeta_of(fr), detect=True)
            pairs.clear()

        for frame in frame_stream:
            flag = frame["key_frame_flag"]
            if flag == 2 and self.pair_features > 1:
                pairs.append(frame)
                if len(pairs) == self.pair_features:
                    flush_pairs()
                continue
            flush_pairs()
            fmeta = fmeta_of(frame)
            with self._phase("frame_features"):
                if self.aug:
                    A = len(frame["img_augs"])
                    fmeta.update(img_shapes=[frame["img_shape"]] * A,
                                 scale_factors=[frame["scale_factor"]] * A,
                                 flips=tuple(frame["flips"]))
                    feats = eng.frame_features_aug(
                        frame["img_augs"], fmeta["img_shapes"],
                        [frame["pad_shape"]] * A, fmeta["scale_factors"],
                        fmeta["flips"])
                else:
                    feats = eng.frame_features(
                        frame["img"], frame["img_shape"], frame["pad_shape"])
            if flag == 0:      # new video: reset + front-pad
                if self.speculative:
                    # the previous video's last chunk is checked against
                    # its own ring before the reset drops it
                    flush()
                    hist.clear()
                if self.aug:
                    cache.clear()
                else:
                    ring = eng.ring_reset(int(feats["fc1"].shape[-1]))
                offsets = deque(maxlen=T)
                meta = deque(maxlen=T)
                n_cached = 0
                if self.prepad_provider is not None:
                    for pre in self.prepad_provider(frame):
                        pre_feats = eng.frame_features(
                            pre["img"], pre["img_shape"], pre["pad_shape"])
                        push(pre_feats, pre, dict(
                            img_shape=pre["img_shape"],
                            scale_factor=pre["scale_factor"],
                            frame_start_id=pre.get("frame_start_id",
                                                   frame["frame_start_id"])))
                        if n_cached >= half - 1:
                            break
                while n_cached < half:
                    push(feats, frame, fmeta)
            elif flag == 2:    # interior
                push(feats, frame, fmeta, detect=True)
            elif flag == 1:    # video end: tail-pad and drain
                while n_cached < T - 1:
                    push(feats, frame, fmeta)
                for _ in range(min(frame["seg_len"], half)):
                    push(feats, frame, fmeta, detect=True)
            else:
                raise ValueError(f"bad key_frame_flag {flag}")
        flush_pairs()
        flush()
        return results
