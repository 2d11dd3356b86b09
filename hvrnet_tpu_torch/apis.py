"""The entry points (counterparts of ``hvrnet_tpu/apis.py:train_detector``
and ``hvrnet_tpu/models/builder.py:build_detector``), on one device.

    engine = build_detector(cfg.model, train_cfg=cfg.train_cfg,
                            dtype=torch.bfloat16)              # on the card
    dataset = build_dataset(cfg.data.train, dict(seed=0))
    train_detector(engine, dataset, cfg, work_dir="work_dirs/hvrnet",
                   calibrate_bn=True)

The engine's dtype is the training's compute dtype (float32 parameters
either way); the config's ``fp16`` and ``optimizer.paramwise_options``
keys reach the trainer.  The engine's type picks the trainer:
``HNMBRCNN`` and ``HNLRCNN`` → ``HNMBTrainer``, ``SelsaRCNN`` →
``SelsaTrainer``.  ``data`` is a training dataset (``data/vid_dataset.py``;
``engine/stream.py:train_batch_iterator`` makes its samples) or a list of
``collate_train`` samples: ``imgs`` (F, H, W, 3)
normalised float32 NHWC canvases, ``gt_bboxes`` (F, G, 4), ``gt_labels``
(F, G), ``gt_mask`` (F, G), ``img_shape`` and ``pad_shape`` (F, 2); for
HVRNet F = 27, 9 videos × 3 frames with videos 0-2 of the key video's
class; for SELSA F = 3 frames of one video.  The trainer moves them to the
engine's device as NCHW.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import time
from typing import Any, Dict, Iterable, Iterator, Optional

import torch

from .core.precision import LossScaleState
from .engine.calibrate import calibrate_frozen_bn
from .engine.detector import HNMBRCNN, SelsaRCNN
from .engine.stream import train_batch_iterator
from .engine.train import HNMBTrainer, SelsaTrainer
from .models.registry import DETECTORS
from .utils.checkpoint import (load_checkpoint, resolve_checkpoint,
                               save_checkpoint)
from .utils.config import unwrap

logger = logging.getLogger("hvrnet_tpu_torch")


def build_detector(model_cfg: Dict[str, Any], train_cfg=None, test_cfg=None,
                   dtype: torch.dtype = torch.float32, device="cuda",
                   seed: int = 0):
    """The engine of ``model_cfg['type']`` (``HNMBRCNN``, ``HNLRCNN`` or
    ``SelsaRCNN``) computing in ``dtype``, with seeded random weights: a
    serving engine with a ``test_cfg``, a training engine with a
    ``train_cfg``."""
    model_cfg = unwrap(model_cfg)
    cls = DETECTORS.get(model_cfg["type"])
    if cls is None:
        raise NotImplementedError(f"no port engine for {model_cfg['type']}")
    return cls(model_cfg, test_cfg, device=device, seed=seed,
               train_cfg=train_cfg, dtype=dtype)


def load_params_for_engine(engine, path: Optional[str]) -> None:
    """Load a checkpoint's weights onto ``engine``'s model: the port's own
    checkpoint or a reference mmdet ``.pth`` (both mmdet ``state_dict``
    names).  Tensors the file lacks keep the engine's values, with a
    warning that counts them; a tensor of another shape or a name the
    model does not have raises.  ``path`` None keeps the seeded weights."""
    if path is None:
        return
    path = resolve_checkpoint(path)
    state_dict = load_checkpoint(path)["state_dict"]
    own = engine.model.state_dict()
    # a reference BatchNorm2d also saves its update counter, which the
    # frozen BNs drop on load (models/layers.py FrozenBN)
    counter = "num_batches_tracked"
    state_dict = {k: v for k, v in state_dict.items()
                  if not (k.endswith(counter) and
                          k[:-len(counter)] + "running_var" in own)}
    unexpected = [k for k in state_dict if k not in own]
    if unexpected:
        raise KeyError(f"{path}: {len(unexpected)} tensors the model does "
                       f"not have, e.g. {unexpected[:5]}")
    wrong = [f"{k}: {tuple(v.shape)} against {tuple(own[k].shape)}"
             for k, v in state_dict.items() if v.shape != own[k].shape]
    if wrong:
        raise ValueError(f"{path}: shape mismatch, {wrong[:5]}")
    missing = [k for k in own if k not in state_dict]
    engine.model.load_state_dict(state_dict, strict=False)
    if missing:
        logger.warning("checkpoint %s missing %d tensors (kept the "
                       "engine's)", path, len(missing))


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


def _phase(timer, name: str):
    return timer.phase(name) if timer is not None else \
        contextlib.nullcontext()


def train_detector(engine, data, cfg: Dict[str, Any],
                   work_dir: str = "work_dir",
                   total_epochs: Optional[int] = None,
                   steps_per_epoch: Optional[int] = None,
                   canvas_hw=(608, 1008), resume_from: Optional[str] = None,
                   load_from: Optional[str] = None, log_interval: int = 50,
                   seed: int = 0, calibrate_bn: bool = False, eval_hook=None,
                   timer=None):
    """Epoch loop: ``steps_per_epoch`` steps (default ``len(data)``) per
    epoch, logs every ``log_interval`` steps to ``train_log.jsonl``, a
    checkpoint ``epoch_<n>.pth`` and ``latest.pth`` after each epoch (and
    ``latest.pth`` every ``checkpoint_config.iter_interval`` steps), then
    ``eval_hook(engine, epoch)`` when given (``engine/eval_hook.py``).

    ``engine``: a training engine (``build_detector`` with a
    ``train_cfg``), float32 or bfloat16.
    ``data``: a training dataset, whose samples ``train_batch_iterator``
    draws on ``canvas_hw`` in the order ``seed`` gives, or a list of
    ``collate_train`` samples, taken in turn.
    ``load_from``: weights to start from (``load_params_for_engine``: the
    port's checkpoint or a reference ``.pth``).  ``resume_from``: a
    checkpoint of this loop, whose weights, optimizer state, step, sampler
    generator and epoch carry on.  ``calibrate_bn`` sets the frozen-BN
    statistics from the first sample's first four frames (of a dataset: the
    first sample of an iterator of its own, drawn before training's), the
    stand-in for pretrained statistics when the weights are random.
    ``timer``: an object whose ``phase(name)`` context wraps the wait for
    each sample ("data") and each stage of a step.  Returns the trainer."""
    if isinstance(engine, HNMBRCNN):
        trainer_cls = HNMBTrainer
    elif isinstance(engine, SelsaRCNN):
        trainer_cls = SelsaTrainer
    else:
        raise NotImplementedError(f"no port trainer for "
                                  f"{type(engine).__name__}")
    os.makedirs(work_dir, exist_ok=True)
    steps_per_epoch = steps_per_epoch or max(len(data), 1)
    trainer = trainer_cls(engine, cfg, steps_per_epoch, seed)
    trainer.timer = timer
    load_params_for_engine(engine, load_from)
    from_dataset = hasattr(data, "plan")
    if from_dataset:
        probe = (next(train_batch_iterator(data, canvas_hw, seed=seed))
                 if calibrate_bn else None)
        stream = train_batch_iterator(data, canvas_hw, seed=seed)
    else:
        stream = _endless(data)
        probe = next(stream) if calibrate_bn else None
        if calibrate_bn:
            stream = itertools.chain([probe], stream)
    if calibrate_bn:
        frames = [dict(img=probe["imgs"][f:f + 1],
                       img_shape=probe["img_shape"][f])
                  for f in range(min(4, len(probe["imgs"])))]
        n_bn = calibrate_frozen_bn(engine, frames)
        logger.info("FrozenBN calibration: %d BNs from %d frames", n_bn,
                    len(frames))
        del probe, frames
    start_epoch = 0
    if resume_from:
        resume_from = resolve_checkpoint(resume_from)
        state = load_checkpoint(resume_from)
        engine.model.load_state_dict(state["state_dict"])
        trainer.optimizer.load_state_dict(state["optimizer"])
        trainer.step = int(state["step"])
        if state.get("rng") is not None:
            trainer.generator.set_state(state["rng"])
        scale = state["meta"].get("loss_scale")
        if trainer.loss_scale is not None and scale is not None:
            trainer.scale_state = LossScaleState(
                torch.tensor(scale[0], dtype=torch.float32,
                             device=engine.device),
                torch.tensor(scale[1], dtype=torch.int32,
                             device=engine.device))
        start_epoch = int(state["meta"].get("epoch", 0))
        logger.info("resumed from %s at epoch %d, step %d", resume_from,
                    start_epoch, trainer.step)

    total_epochs = total_epochs or int(cfg.get("total_epochs", 12))
    iter_interval = (cfg.get("checkpoint_config") or {}).get("iter_interval")
    log_path = os.path.join(work_dir, "train_log.jsonl")

    def save(name, **meta):
        if trainer.scale_state is not None:
            meta["loss_scale"] = [float(trainer.scale_state.scale),
                                  int(trainer.scale_state.good_steps)]
        save_checkpoint(os.path.join(work_dir, name), engine.model,
                        trainer.optimizer, trainer.step, meta,
                        trainer.generator)

    for epoch in range(start_epoch, total_epochs):
        t0 = time.time()
        for it in range(steps_per_epoch):
            with _phase(timer, "data"):
                sample = next(stream)
            logs = trainer.train_step(sample)
            del sample
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
        if eval_hook is not None:
            mean_ap = eval_hook(engine, epoch)
            if mean_ap is not None:
                logger.info("epoch %d mAP: %.4f", epoch, mean_ap)
    return trainer
