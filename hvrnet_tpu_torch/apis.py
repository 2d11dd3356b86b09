"""The training entry point (counterpart of ``hvrnet_tpu/apis.py``:
``train_detector``), on one device in float32.

    engine = HNMBRCNN(cfg.model, train_cfg=cfg.train_cfg)     # on the card
    train_detector(engine, batches, cfg, work_dir="work_dirs/hvrnet",
                   calibrate_bn=True)

The engine's type picks the trainer: ``HNMBRCNN`` → ``HNMBTrainer``,
``SelsaRCNN`` → ``SelsaTrainer``.  ``batches`` yields ``collate_train``
batches (``hvrnet_tpu/engine/stream.py`` format): ``imgs`` (F, H, W, 3)
normalised float32 NHWC canvases, ``gt_bboxes`` (F, G, 4), ``gt_labels``
(F, G), ``gt_mask`` (F, G), ``img_shape`` and ``pad_shape`` (F, 2); for
HVRNet F = 27, 9 videos × 3 frames with videos 0-2 of the key video's
class; for SELSA F = 3 frames of one video.  The trainer moves them to the
engine's device as NCHW.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import time
from typing import Any, Dict, Iterable, Iterator, Optional

from .engine.calibrate import calibrate_frozen_bn
from .engine.detector import HNMBRCNN, SelsaRCNN
from .engine.train import HNMBTrainer, SelsaTrainer
from .utils.checkpoint import load_checkpoint, save_checkpoint

logger = logging.getLogger("hvrnet_tpu_torch")


def _endless(batches: Iterable[Dict[str, Any]]) -> Iterator[Dict[str, Any]]:
    """``batches`` over and over (a list); a one-shot iterator must hold
    every step's batch."""
    while True:
        n = 0
        for batch in batches:
            n += 1
            yield batch
        if n == 0 or iter(batches) is batches:
            raise ValueError("train_detector ran out of batches")


def train_detector(engine, batches: Iterable[Dict[str, Any]],
                   cfg: Dict[str, Any], work_dir: str = "work_dir",
                   total_epochs: Optional[int] = None,
                   steps_per_epoch: Optional[int] = None,
                   resume_from: Optional[str] = None,
                   load_from: Optional[str] = None, log_interval: int = 50,
                   seed: int = 0, calibrate_bn: bool = False, timer=None):
    """Epoch loop: ``steps_per_epoch`` steps (default ``len(batches)``) per
    epoch, logs every ``log_interval`` steps to ``train_log.jsonl``, a
    checkpoint ``epoch_<n>.pth`` and ``latest.pth`` after each epoch (and
    ``latest.pth`` every ``checkpoint_config.iter_interval`` steps).

    ``load_from``: weights to start from (the port's checkpoint or a
    reference ``.pth`` state_dict; tensors it lacks keep their values).
    ``resume_from``: a checkpoint of this loop, whose weights, optimizer
    state, step, sampler generator and epoch carry on.  ``calibrate_bn``
    sets the frozen-BN statistics from the first batch's first four frames,
    the stand-in for pretrained statistics when the weights are random.
    ``timer``: an object whose ``phase(name)`` context wraps each stage of a
    step.  Returns the trainer."""
    if isinstance(engine, HNMBRCNN):
        trainer_cls = HNMBTrainer
    elif isinstance(engine, SelsaRCNN):
        trainer_cls = SelsaTrainer
    else:
        raise NotImplementedError(f"no port trainer for "
                                  f"{type(engine).__name__}")
    os.makedirs(work_dir, exist_ok=True)
    steps_per_epoch = steps_per_epoch or len(batches)
    trainer = trainer_cls(engine, cfg, steps_per_epoch, seed)
    trainer.timer = timer
    if load_from:
        missing, unexpected = engine.model.load_state_dict(
            load_checkpoint(load_from)["state_dict"], strict=False)
        if missing or unexpected:
            logger.warning("load_from %s: %d tensors missing (kept), %d "
                           "unused", load_from, len(missing), len(unexpected))
    stream = _endless(batches)
    if calibrate_bn:
        probe = next(stream)
        stream = itertools.chain([probe], stream)
        frames = [dict(img=probe["imgs"][f:f + 1],
                       img_shape=probe["img_shape"][f])
                  for f in range(min(4, len(probe["imgs"])))]
        n_bn = calibrate_frozen_bn(engine, frames)
        logger.info("FrozenBN calibration: %d BNs from %d frames", n_bn,
                    len(frames))
    start_epoch = 0
    if resume_from:
        state = load_checkpoint(resume_from)
        engine.model.load_state_dict(state["state_dict"])
        trainer.optimizer.load_state_dict(state["optimizer"])
        trainer.step = int(state["step"])
        if state.get("rng") is not None:
            trainer.generator.set_state(state["rng"])
        start_epoch = int(state["meta"].get("epoch", 0))
        logger.info("resumed from %s at epoch %d, step %d", resume_from,
                    start_epoch, trainer.step)

    total_epochs = total_epochs or int(cfg.get("total_epochs", 12))
    iter_interval = (cfg.get("checkpoint_config") or {}).get("iter_interval")
    log_path = os.path.join(work_dir, "train_log.jsonl")

    def save(name, **meta):
        save_checkpoint(os.path.join(work_dir, name), engine.model,
                        trainer.optimizer, trainer.step, meta,
                        trainer.generator)

    for epoch in range(start_epoch, total_epochs):
        t0 = time.time()
        for it in range(steps_per_epoch):
            logs = trainer.train_step(next(stream))
            if it % log_interval == 0:
                logs_f = {k: float(v) for k, v in logs.items()}
                logs_f.update(epoch=epoch, iter=it, time=time.time() - t0)
                logger.info("epoch %d iter %d: %s", epoch, it, logs_f)
                with open(log_path, "a") as f:
                    f.write(json.dumps(logs_f) + "\n")
            if iter_interval and it > 0 and it % iter_interval == 0:
                save("latest.pth", epoch=epoch, iter=it)
        save(f"epoch_{epoch + 1}.pth", epoch=epoch + 1)
        save("latest.pth", epoch=epoch + 1)
    return trainer
