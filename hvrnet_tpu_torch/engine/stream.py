"""Host frame streams for ``SlidingWindowRunner`` and training samples
for the trainers (counterpart of ``hvrnet_tpu/engine/stream.py``:
``test_frame_stream``, ``prefetch_stream``, ``collate_train`` and
``train_batch_iterator``).

``test_frame_stream`` walks one rank's whole-video shard of a test
``VIDSeqDataset`` and yields the runner's frame dicts, each frame's image
padded onto its canvas as a numpy (1, H, W, 3) array (the engine moves it to
the device).  With ``u8_transfer`` the dataset's ``Normalize`` is skipped
and the canvas stays uint8, normalised on the device by the engine (4×
fewer bytes to move; the same engine input, since the pipeline resizes in
uint8 before it normalises).

``parallel_test_frame_stream`` gives the same kind of frames with the
decode, resize and padding in a thread pool, in order.  Its draws follow
the JAX package's parallel stream: every video's shuffle first, then each
frame's pipeline draws, planned serially in frame order, so the frames do
not depend on the number of workers.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import queue
import threading
from collections import deque
from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np
import torch

from ..data.pipelines import Compose, render
from .canvas import FrameTooLarge, pad_to_canvas, pick_canvas_shape


def u8_pipeline(dataset) -> Compose:
    """The dataset's pipeline without ``Normalize``, on the dataset's own
    generator and decoder (the same draws as the full pipeline)."""
    return Compose([t for t in dataset.pipeline_cfg
                    if t["type"] != "Normalize"], dataset.rng,
                   dataset.imread)


def runner_frame(out: Dict, max_long: int = 1008, max_short: int = 608,
                 u8: bool = False) -> Dict:
    """A pipeline output as the runner's frame dict (meta values as the
    JAX stream gives them)."""
    meta = out["img_meta"]
    img = (np.ascontiguousarray(out["img"], np.uint8) if u8
           else out["img"].astype(np.float32))
    ch, cw = pick_canvas_shape(int(meta["pad_shape"][0]),
                               int(meta["pad_shape"][1]), max_long, max_short)
    frame = dict(
        img=pad_to_canvas(img, (ch, cw))[None],
        img_shape=np.asarray(meta["img_shape"][:2], np.float32),
        pad_shape=np.asarray(meta["pad_shape"][:2], np.float32),
        scale_factor=np.asarray(meta["scale_factor"], np.float32))
    for key in ("key_frame_flag", "frame_offset", "seg_len",
                "frame_start_id"):
        if key in meta:
            frame[key] = int(meta[key])
    return frame


def test_frame_stream(dataset, rank: int = 0, max_long: int = 1008,
                      max_short: int = 608, u8_transfer: bool = False,
                      timer=None, aug_flip: bool = False) -> Iterator[Dict]:
    """Runner-format frames of one rank's whole-video shard, in the
    dataset's stateful order.  ``timer.phase(name)``, when given, wraps the
    pipeline ("pipeline") and the canvas padding ("canvas") of each frame.

    ``aug_flip``: each frame also carries its augmentations for
    flip-augmented testing (the reference's ``MultiScaleFlipAug(flip=True)``
    operating point), ``img_augs`` = [the canvas, its mirror] and ``flips``
    = (False, True).  The mirror flips the resized, normalised image within
    its valid width ``round(img_shape[1])``, before the padding (the
    reference flips before ``Pad``), so the canvas pad stays on the right."""
    saved = dataset.pipeline
    if u8_transfer:
        dataset.pipeline = u8_pipeline(dataset)
    try:
        for idx in dataset.indices_list[rank]:
            with _phase(timer, "pipeline"):
                item = dataset[idx]
            with _phase(timer, "canvas"):
                frame = runner_frame(item, max_long, max_short, u8_transfer)
                if aug_flip:
                    frame["img_augs"] = [frame["img"], mirrored(frame)]
                    frame["flips"] = (False, True)
            yield frame
    finally:
        dataset.pipeline = saved


def mirrored(frame: Dict) -> np.ndarray:
    """A runner frame's (1, H, W, 3) canvas with the image mirrored within
    its valid width and the pad left where it was."""
    iw = int(round(float(frame["img_shape"][1])))
    img = frame["img"].copy()
    img[:, :, :iw] = img[:, :, :iw][:, :, ::-1]
    return img


PREFETCH = 8        # frames of the threaded stream in flight


def parallel_test_frame_stream(dataset, rank: int = 0, workers: int = 4,
                               max_long: int = 1008, max_short: int = 608,
                               u8_transfer: bool = False,
                               transfer_batch: int = 1, device=None
                               ) -> Iterator[Dict]:
    """Order-preserving threaded ``test_frame_stream`` (counterpart of the
    JAX package's ``parallel_test_frame_stream``).

    A serial pass first replays the stateful test iterator (flags,
    offsets, shuffles, the rank's shard), drawing every video's shuffle
    from the dataset's generator; under ``video_shuffle`` that is another
    sample of the orders than the sequential stream's, whose shuffles
    interleave with the frames' draws.  Each frame's pipeline is then
    planned in frame order (its draws, nothing decoded) as it is handed to
    ``workers`` threads, which decode, resize and pad it; frames come out
    in order, up to ``PREFETCH`` of them in flight.

    ``device``: the canvases arrive as tensors on it, moved by the worker
    that made them, or, with ``transfer_batch`` > 1, that many consecutive
    same-canvas frames in one copy, sliced back per frame (a change of
    canvas ends a batch early).  Without it they stay numpy."""
    pipeline = u8_pipeline(dataset) if u8_transfer else dataset.pipeline
    entries = []
    cur_tid, video, order = 0, None, None
    for idx in dataset.indices_list[rank]:
        vid = dataset.global_video_list[idx]
        if cur_tid == 0:
            video = dataset.img_infos[vid]
            order = list(range(video["frame_seg_len"]))
            if dataset.video_shuffle:
                dataset.rng.shuffle(order)
            flag = 0
        else:
            flag = 2
        offset = order[cur_tid]
        cur_tid += 1
        if cur_tid == video["frame_seg_len"]:
            flag, cur_tid = 1, 0
        entries.append((video, offset, flag))
    one_by_one = device is not None and transfer_batch <= 1

    def plan(entry):
        video, offset, flag = entry
        r = dict(img_info=dataset._frame_info(video, offset))
        dataset.pre_pipeline(r, lazy=True)
        out = pipeline(r)
        out["img_meta"].update(key_frame_flag=flag, frame_offset=offset,
                               seg_len=video["frame_seg_len"],
                               frame_start_id=video["frame_id"])
        return out

    def load(out):
        out["img"] = render(out["img"])
        frame = runner_frame(out, max_long, max_short, u8_transfer)
        if one_by_one:
            frame["img"] = torch.from_numpy(frame["img"]).to(device)
        return frame

    def batches(frames):
        """Frames, their canvases moved to ``device`` transfer_batch at a
        time."""
        group = []

        def moved():
            imgs = torch.from_numpy(np.concatenate(
                [f["img"] for f in group])).to(device)
            out = [dict(f, img=imgs[i:i + 1]) for i, f in enumerate(group)]
            group.clear()
            return out

        for f in frames:
            if group and group[0]["img"].shape != f["img"].shape:
                yield from moved()
            group.append(f)
            if len(group) >= transfer_batch:
                yield from moved()
        if group:
            yield from moved()

    def frames():
        with cf.ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
            todo = iter(entries)
            futs: deque = deque(pool.submit(load, plan(e))
                                for e in _take(todo, PREFETCH))
            while futs:
                frame = futs.popleft().result()
                for e in _take(todo, 1):
                    futs.append(pool.submit(load, plan(e)))
                yield frame

    if device is not None and transfer_batch > 1:
        return batches(frames())
    return frames()


def _take(it, n):
    for _, item in zip(range(n), it):
        yield item


def collate_train(frames: Sequence[Dict], canvas_hw, gt_max: int = 32
                  ) -> Dict:
    """A dataset item (pipelined frames, decoded or planned) as one
    fixed-shape training
    sample: ``imgs`` (F, H, W, 3) float32 on the canvas, ``gt_bboxes``
    (F, gt_max, 4), ``gt_labels`` (F, gt_max), ``gt_mask`` (F, gt_max)
    (boxes past ``gt_max`` dropped), ``img_shape`` and ``pad_shape`` (F,
    2).  A frame larger than the canvas raises ``FrameTooLarge``."""
    F = len(frames)
    ch, cw = canvas_hw
    too_large = oversized(frames, canvas_hw)   # before decoding any image
    if too_large:
        raise FrameTooLarge(f"a {too_large[0]}x{too_large[1]} frame does "
                            f"not fit the {ch}x{cw} canvas")
    imgs = np.zeros((F, ch, cw, 3), np.float32)
    gt_bboxes = np.zeros((F, gt_max, 4), np.float32)
    gt_labels = np.zeros((F, gt_max), np.int64)
    gt_mask = np.zeros((F, gt_max), bool)
    img_shape = np.zeros((F, 2), np.float32)
    pad_shape = np.zeros((F, 2), np.float32)
    for i, fr in enumerate(frames):
        imgs[i] = pad_to_canvas(render(fr["img"]).astype(np.float32),
                                (ch, cw))
        meta = fr["img_meta"]
        img_shape[i] = meta["img_shape"][:2]
        pad_shape[i] = meta["pad_shape"][:2]
        b = fr.get("gt_bboxes", np.zeros((0, 4), np.float32))
        lab = fr.get("gt_labels", np.zeros((0,), np.int64))
        n = min(len(b), gt_max)
        gt_bboxes[i, :n] = b[:n]
        gt_labels[i, :n] = lab[:n]
        gt_mask[i, :n] = True
    return dict(imgs=imgs, gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                gt_mask=gt_mask, img_shape=img_shape, pad_shape=pad_shape)


def oversized(frames: Sequence[Dict], canvas_hw):
    """(h, w) of the first frame (decoded or planned) larger than the
    canvas, or None."""
    ch, cw = canvas_hw
    for fr in frames:
        h, w = fr["img"].shape[:2]
        if h > ch or w > cw:
            return h, w
    return None


def planned_batches(dataset, canvas_hw=(608, 1008), batch_size: int = 1,
                    shuffle: bool = True, seed: int = 0
                    ) -> Iterator[List]:
    """The JAX ``train_batch_iterator(batch_size=n)``'s batches, planned
    (``dataset.plan``) and not decoded: lists of ``batch_size`` items, the
    order from ``np.random.default_rng(seed)`` reshuffled each pass, an
    item with a frame larger than the canvas skipped (its draws consumed)
    and the last items of a pass that do not fill a batch dropped."""
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    while True:
        if shuffle:
            rng.shuffle(order)
        batch = []
        for idx in order:
            frames = dataset.plan(int(idx))
            if oversized(frames, canvas_hw):
                continue
            batch.append(frames)
            if len(batch) == batch_size:
                yield batch
                batch = []


def train_batch_iterator(dataset, canvas_hw=(608, 1008), gt_max: int = 32,
                         shuffle: bool = True, seed: int = 0,
                         world: int = 1, rank: int = 0) -> Iterator[Dict]:
    """Training samples, one dataset item each, endlessly: step s of a
    ``world``-rank run takes the s-th batch of ``world`` items of
    ``planned_batches`` and rank ``rank`` decodes its item alone (every
    rank plans every draw, so the draws stay in the JAX order).  A sample
    equals the JAX iterator's batch ``[rank]`` at batch size ``world``."""
    for items in planned_batches(dataset, canvas_hw, world, shuffle, seed):
        yield collate_train(items[rank], canvas_hw, gt_max)


def _phase(timer, name):
    return timer.phase(name) if timer is not None else \
        contextlib.nullcontext()


def prefetch_stream(gen: Iterable[Dict], depth: int = 3) -> Iterator[Dict]:
    """Run a frame generator ``depth`` items ahead on a background thread,
    overlapping the host pipeline with the device.  An exception in the
    generator is raised here; closing this iterator stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
            put(end)
        except BaseException as e:     # raised in the consumer
            put(_Failure(e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, _Failure):
                raise item.error
            yield item
    finally:
        stop.set()
        t.join(timeout=10)


class _Failure:
    def __init__(self, error):
        self.error = error
