"""HVRNet whole-video VID test CLI (counterpart of the JAX package's
``tools/hnl_test.py``):

    python -m hvrnet_tpu_torch.tools.hnl_test configs/faster_rcnn_r101_hrnmp_c5.py \\
        work_dirs/hvrnet.pth --eval --stream

runs the 4-block HRNMP head over every video of the config's ``data.test``
tree on the card, at a window of ``--window`` frames (63 by default, the
reference harness's cache; the window sets frame_interval, t_dim and
key_dim together), and with ``--eval`` prints the VID mAP.  ``--stream``
runs the streaming ring (speculative, replaying flagged chunks exactly).
``--pre-padding random`` (the default) front-pads each video's window with
half − 1 random frames of the same video, drawn from a generator of their
own seeded by ``--seed``; ``repeat`` pads with copies of the first frame.
``--pair-features P`` runs P consecutive interior frames through one frame
program.  The shared flags (ranks, ``--device``, ``--decoder``,
``--bf16``, …) are those of ``hvrnet_tpu_torch.tools.test``.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from ..data.pipelines import Compose
from ..engine.stream import runner_frame
from ..utils.config import Config
from .test import (add_common_args, canvas_of, decoder_from_flag, refuse,
                   run_test, set_window, setup, test_dataset, test_engine)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HVRNet VID test")
    add_common_args(p)
    p.add_argument("--out", default="results_hnl.pkl")
    p.add_argument("--window", type=int, default=63,
                   help="window length (2·k + 1); sets frame_interval, "
                        "t_dim and key_dim together")
    p.add_argument("--pre-padding", choices=["random", "repeat"],
                   default="random")
    p.add_argument("--stream", action="store_true",
                   help="the streaming-softmax ring")
    p.add_argument("--multi-pass", type=int, default=0)
    p.add_argument("--pair-features", type=int, default=1, metavar="P",
                   help="run P consecutive interior frames through one "
                        "frame program")
    args = p.parse_args(argv)
    if args.multi_pass:
        raise SystemExit("--multi-pass is not ported yet (ROADMAP Queue 1 "
                         "item 5, forward_test_multi_passes)")
    return args


def random_prepad(dataset, rank: int, window: int, seed: int, canvas,
                  imread):
    """The start-of-video provider of ``SlidingWindowRunner``: half − 1
    random frames of the first frame's video through the test pipeline,
    drawn (offsets and flips) from a generator of its own.  The video is
    found by its rank-rebased ``frame_start_id`` among this rank's
    videos (ids repeat across ranks)."""
    half = (window + 1) // 2
    rng = np.random.RandomState(seed)
    pipeline = Compose(dataset.pipeline_cfg, rng, imread)
    videos = sorted(set(dataset.global_video_list[i]
                        for i in dataset.indices_list[rank]))
    start2info = {int(dataset.img_infos[v]["frame_id"]): dataset.img_infos[v]
                  for v in videos}

    def prepad(first_frame):
        info = start2info[int(first_frame["frame_start_id"])]
        n = info["frame_seg_len"]
        frames = []
        for off in rng.randint(0, n, size=half - 1):
            r = dict(img_info=dataset._frame_info(info, int(off)))
            dataset.pre_pipeline(r)
            frame = runner_frame(pipeline(r), max(canvas), min(canvas))
            frame.update(frame_offset=int(off), seg_len=n,
                         frame_start_id=info["frame_id"])
            frames.append(frame)
        return frames

    return prepad


def main(argv=None, imread=None, timer=None) -> Dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); ``imread`` and
    ``timer`` as ``hvrnet_tpu_torch.tools.test.main``'s."""
    args = parse_args(argv)
    refuse(args)
    setup(args)
    imread = imread or decoder_from_flag(args.decoder)
    cfg = Config.fromfile(args.config)
    set_window(cfg, args.window)
    dataset = test_dataset(cfg, args.world_size, args.seed, imread)
    engine = test_engine(cfg, args)
    engine.stream = args.stream
    prepad = None
    if args.pre_padding == "random":
        prepad = random_prepad(dataset, args.rank, args.window, args.seed,
                               canvas_of(cfg), imread)
    return run_test(args, cfg, dataset, engine, imread,
                    prepad_provider=prepad, timer=timer)


if __name__ == "__main__":
    main()
