"""Training CLI, one process on one device (counterpart of the JAX
package's ``tools/train.py``):

    python -m hvrnet_tpu_torch.tools.train configs/faster_rcnn_r101_selsa_c5.py
    python -m hvrnet_tpu_torch.tools.train configs/faster_rcnn_r101_hrnmp_c5.py \\
        --load-from work_dirs/faster_rcnn_r101_selsa_c5/latest.pth --validate

builds the config's ``data.train`` (a list is concatenated), the detector
(``HNMBRCNN`` / ``HNLRCNN`` train with ``HNMBTrainer``, ``SelsaRCNN`` with
``SelsaTrainer``) and runs the epoch loop on the card, writing
``epoch_<n>.pth``, ``latest.pth`` and ``train_log.jsonl`` to the work
directory.  ``--validate`` runs the VID evaluation on ``data.val`` after
every ``evaluation.interval`` epochs.  ``--device cpu`` runs on the CPU;
``--decoder`` reads images as the test CLIs do (``cv2`` or
``module:function``).  ``--seed`` seeds the dataset's draws, the sample
order, the samplers and the evaluation's frame order.

The JAX CLI's multi-device flags stop this one with the ROADMAP item that
will port them; none is accepted and ignored.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Dict

import torch

from ..apis import build_detector, train_detector
from ..data.vid_dataset import build_dataset
from ..engine.detector import resolve_device
from ..engine.eval_hook import VidEvalHook
from ..utils.config import Config, unwrap
from .test import decoder_from_flag

logger = logging.getLogger("hvrnet_tpu_torch")

MULTI_DEVICE = "Queue 1 item 6 (multi-GPU)"
# the JAX CLI's multi-device flags, each with the one value that means a
# single device here (None: refused whatever its value)
REFUSED = dict(n_devices=1, coordinator=None, num_processes=1, process_id=0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a video detector")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--total-epochs", type=int, default=None)
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--autoscale-lr", action="store_true",
                   help="scale lr by the device count / 4 (one device: "
                        "lr / 4)")
    p.add_argument("--canvas", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="training canvas (default: the config's canvas_hw "
                        "or 608 1008)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute with float32 parameters")
    p.add_argument("--calibrate-bn", action="store_true",
                   help="set the frozen-BN statistics from the first "
                        "training sample (for random weights)")
    p.add_argument("--validate", action="store_true",
                   help="VID evaluation on data.val every "
                        "evaluation.interval epochs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--decoder", default="cv2",
                   help="image decoder: cv2, or module:function taking a "
                        "path and returning an (H, W, 3) uint8 BGR array")
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    for name, single in REFUSED.items():
        value = getattr(args, name)
        if value is not None and value != single:
            raise SystemExit(f"--{name.replace('_', '-')} is not ported yet "
                             f"(ROADMAP {MULTI_DEVICE})")
    return args


def main(argv=None, imread=None, timer=None) -> Dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``).  ``imread``, a
    decoder callable, overrides ``--decoder``; ``timer`` goes to
    ``train_detector``.  Returns the run: ``trainer``, ``dataset``,
    ``engine``, ``eval_hook``, ``work_dir``, ``wall_s``."""
    args = parse_args(argv)
    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(message)s",
                        level=logging.INFO)
    logger.setLevel(logging.INFO)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"no CUDA device is available; pass --device cpu "
                         f"to run on the CPU ({e})") from e
    imread = imread or decoder_from_flag(args.decoder)
    cfg = Config.fromfile(args.config)
    if args.autoscale_lr:       # linear in the device count, 4 the base
        cfg.optimizer["lr"] = cfg.optimizer["lr"] * 1 / 4.0
    seed = args.seed or 0
    work_dir = args.work_dir or cfg.get("work_dir", "work_dir")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    canvas = tuple(args.canvas or cfg.get("canvas_hw", (608, 1008)))

    dataset = build_dataset(unwrap(cfg.data.train),
                            dict(seed=seed, imread=imread))
    engine = build_detector(cfg.model, train_cfg=cfg.train_cfg, dtype=dtype,
                            device=args.device, seed=seed)
    eval_hook = None
    if args.validate:
        val_engine = build_detector(cfg.model, test_cfg=cfg.test_cfg,
                                    dtype=dtype, device=args.device,
                                    seed=seed)
        val_cfg = dict(cfg.data.val)
        val_cfg.update(dict(cfg.test_cfg.relation_setup))
        val_cfg.pop("frame_stride", None)
        eval_hook = VidEvalHook(
            val_engine, val_cfg,
            interval=(cfg.get("evaluation") or {}).get("interval", 1),
            work_dir=work_dir, canvas_hw=canvas, seed=seed, imread=imread)
    t0 = time.perf_counter()
    trainer = train_detector(
        engine, dataset, cfg.as_dict(), work_dir=work_dir,
        total_epochs=args.total_epochs or cfg.get("total_epochs"),
        steps_per_epoch=args.max_steps_per_epoch, canvas_hw=canvas,
        resume_from=args.resume_from or cfg.get("resume_from"),
        load_from=args.load_from or cfg.get("load_from"), seed=seed,
        calibrate_bn=args.calibrate_bn, eval_hook=eval_hook, timer=timer)
    return dict(trainer=trainer, dataset=dataset, engine=engine,
                eval_hook=eval_hook, work_dir=work_dir,
                wall_s=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
