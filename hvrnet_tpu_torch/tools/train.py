"""Training CLI (counterpart of the JAX package's ``tools/train.py``):

    python -m hvrnet_tpu_torch.tools.train configs/faster_rcnn_r101_selsa_c5.py
    python -m hvrnet_tpu_torch.tools.train configs/faster_rcnn_r101_hrnmp_c5.py \\
        --load-from work_dirs/faster_rcnn_r101_selsa_c5/latest.pth --validate
    python -m hvrnet_tpu_torch.tools.train configs/faster_rcnn_r101_hrnmp_c5.py \\
        --n-devices 4

builds the config's ``data.train`` (a list is concatenated), the detector
(``HNMBRCNN`` / ``HNLRCNN`` train with ``HNMBTrainer``, ``SelsaRCNN`` with
``SelsaTrainer``) and runs the epoch loop on the card, writing
``epoch_<n>.pth``, ``latest.pth`` and ``train_log.jsonl`` to the work
directory.  ``--validate`` runs the VID evaluation on ``data.val`` after
every ``evaluation.interval`` epochs.  ``--device cpu`` runs on the CPU;
``--decoder`` reads images as the test CLIs do (``cv2``, ``native`` or
``module:function``).  ``--seed`` seeds the dataset's draws, the sample
order, the samplers and the evaluation's frame order.

Data parallel (the JAX CLI's mesh over every local device and its
multi-host flags): ``--n-devices N`` trains with N ranks on this host, one
process per card (``cuda:0`` … ``cuda:N-1``; with ``--device cpu``, N gloo
ranks on the CPU), joined by ``torch.distributed`` (NCCL on the cards).
``--coordinator host:port --num-processes P --process-id i`` add hosts:
the P processes each start N ranks, rank ``i·N + local rank`` of P·N, and
meet at the coordinator.  ``--autoscale-lr`` scales the rate by the world
size / 4.  Each step takes one sample per rank and averages the gradients
(``apis.train_detector``); the validation shards the val videos over the
ranks and rank 0 merges them.
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
from ..parallel.launch import free_coordinator, spawn
from ..parallel.mesh import init_distributed
from ..utils.config import Config, unwrap
from .test import decoder_from_flag

logger = logging.getLogger("hvrnet_tpu_torch")


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
                   help="scale lr by the world size / 4")
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
                   help="image decoder: cv2, native (the port's baseline "
                        "JPEG and PPM/PGM decoder, bit for bit cv2), or "
                        "module:function taking a path and returning an "
                        "(H, W, 3) uint8 BGR array")
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks on this host, one process per card (with "
                        "--device cpu, gloo ranks on the CPU)")
    p.add_argument("--coordinator", default=None,
                   help="host:port where the ranks of several processes "
                        "meet")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes (hosts) in all, each with --n-devices "
                        "ranks")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index among --num-processes")
    args = p.parse_args(argv)
    if any(n is not None and n < 1
           for n in (args.n_devices, args.num_processes)):
        raise SystemExit("--n-devices and --num-processes are at least 1")
    n_proc = args.num_processes or 1
    if n_proc > 1 and args.coordinator is None:
        raise SystemExit(f"--num-processes {n_proc} needs --coordinator "
                         f"host:port")
    if not 0 <= (args.process_id or 0) < n_proc:
        raise SystemExit(f"--process-id {args.process_id} is outside 0.."
                         f"{n_proc - 1} (--num-processes {n_proc})")
    return args


def log_to_stderr() -> None:
    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(message)s",
                        level=logging.INFO)
    logger.setLevel(logging.INFO)


def world_of(args) -> int:
    """The ranks in all: --n-devices × --num-processes."""
    return (args.n_devices or 1) * (args.num_processes or 1)


def global_rank(args, local_rank: int) -> int:
    """``process_id · n_devices + local_rank``."""
    return (args.process_id or 0) * (args.n_devices or 1) + local_rank


def main(argv=None, imread=None, timer=None) -> Dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``).  ``imread``, a
    decoder callable, overrides ``--decoder``; ``timer`` goes to
    ``train_detector``.  Returns the run: ``trainer``, ``dataset``,
    ``engine``, ``eval_hook``, ``work_dir``, ``wall_s``; with several local
    ranks (each in its own process; ``imread`` must then be a module-level
    function, and ``timer`` is not used) ``world``, ``work_dir`` and
    ``wall_s``."""
    args = parse_args(argv)
    log_to_stderr()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"no CUDA device is available; pass --device cpu "
                         f"to run on the CPU ({e})") from e
    n_local = args.n_devices or 1
    if dev.type == "cuda" and n_local > torch.cuda.device_count():
        raise SystemExit(f"--n-devices {n_local}: {torch.cuda.device_count()}"
                         f" CUDA cards visible")
    if world_of(args) == 1:
        return run(args, args.device, 0, imread, timer)
    coordinator = args.coordinator or free_coordinator()
    t0 = time.perf_counter()
    if n_local == 1:
        rank_main(0, args, coordinator, imread)
    else:
        threads = max(1, torch.get_num_threads() // n_local)
        spawn(rank_main, n_local, (args, coordinator, imread, threads))
    work_dir = args.work_dir or Config.fromfile(args.config).get(
        "work_dir", "work_dir")
    return dict(world=world_of(args), work_dir=work_dir,
                wall_s=time.perf_counter() - t0)


def rank_main(local_rank: int, args, coordinator: str, imread=None,
              threads=None) -> Dict:
    """One rank of a data-parallel run: its card (``cuda:<local rank>``,
    or the CPU), the process group, then ``run``."""
    log_to_stderr()                 # a spawned rank starts without
    cuda = torch.device(args.device).type == "cuda"
    device = f"cuda:{local_rank}" if cuda else "cpu"
    if threads:
        torch.set_num_threads(threads)
    rank = global_rank(args, local_rank)
    init_distributed(coordinator, world_of(args), rank, device)
    try:
        return run(args, device, rank, imread, None)
    finally:
        torch.distributed.destroy_process_group()


def run(args, device, rank: int, imread=None, timer=None) -> Dict:
    """The training run of one rank on ``device``."""
    world = world_of(args)
    if rank:
        logger.setLevel(logging.ERROR)
    imread = imread or decoder_from_flag(args.decoder)
    cfg = Config.fromfile(args.config)
    if args.autoscale_lr:       # linear in the world size, 4 the base
        cfg.optimizer["lr"] = cfg.optimizer["lr"] * world / 4.0
    seed = args.seed or 0
    work_dir = args.work_dir or cfg.get("work_dir", "work_dir")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    canvas = tuple(args.canvas or cfg.get("canvas_hw", (608, 1008)))

    dataset = build_dataset(unwrap(cfg.data.train),
                            dict(seed=seed, imread=imread))
    engine = build_detector(cfg.model, train_cfg=cfg.train_cfg, dtype=dtype,
                            device=device, seed=seed)
    eval_hook = None
    if args.validate:
        val_engine = build_detector(cfg.model, test_cfg=cfg.test_cfg,
                                    dtype=dtype, device=device, seed=seed)
        val_cfg = dict(cfg.data.val)
        val_cfg.update(dict(cfg.test_cfg.relation_setup))
        val_cfg.pop("frame_stride", None)
        eval_hook = VidEvalHook(
            val_engine, val_cfg,
            interval=(cfg.get("evaluation") or {}).get("interval", 1),
            work_dir=work_dir, world_size=world, rank=rank,
            canvas_hw=canvas, seed=seed, imread=imread)
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
