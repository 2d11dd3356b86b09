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
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Dict, Iterable, Iterator, Sequence

import numpy as np

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
                      timer=None) -> Iterator[Dict]:
    """Runner-format frames of one rank's whole-video shard, in the
    dataset's stateful order.  ``timer.phase(name)``, when given, wraps the
    pipeline ("pipeline") and the canvas padding ("canvas") of each frame."""
    saved = dataset.pipeline
    if u8_transfer:
        dataset.pipeline = u8_pipeline(dataset)
    try:
        for idx in dataset.indices_list[rank]:
            with _phase(timer, "pipeline"):
                item = dataset[idx]
            with _phase(timer, "canvas"):
                frame = runner_frame(item, max_long, max_short, u8_transfer)
            yield frame
    finally:
        dataset.pipeline = saved


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
    for fr in frames:           # before decoding any planned image
        h, w = fr["img"].shape[:2]
        if h > ch or w > cw:
            raise FrameTooLarge(f"a {h}x{w} frame does not fit the "
                                f"{ch}x{cw} canvas")
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


def train_batch_iterator(dataset, canvas_hw=(608, 1008), gt_max: int = 32,
                         shuffle: bool = True, seed: int = 0
                         ) -> Iterator[Dict]:
    """Training samples, one dataset item each, endlessly: the order from
    ``np.random.default_rng(seed)`` reshuffled each pass.  An item with a
    frame that does not fit the canvas (a portrait video or crop in a
    landscape run) is skipped, its draws consumed; items are planned
    (``dataset.plan``) and only the kept ones decoded.  A sample equals
    the JAX iterator's batch ``[0]`` at batch size 1."""
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    while True:
        if shuffle:
            rng.shuffle(order)
        for idx in order:
            frames = dataset.plan(int(idx))
            try:
                sample = collate_train(frames, canvas_hw, gt_max)
            except FrameTooLarge:
                continue
            yield sample


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
