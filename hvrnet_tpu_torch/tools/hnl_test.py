"""HVRNet whole-video VID test CLI (counterpart of the JAX package's
``tools/hnl_test.py``):

    python -m hvrnet_tpu_torch.tools.hnl_test configs/faster_rcnn_r101_hrnmp_c5.py \\
        work_dirs/hvrnet.pth --eval --stream

runs the 4-block HRNMP head over every video of the config's ``data.test``
tree on the card, at a window of ``--window`` frames (63 by default, the
reference harness's cache; the window sets the head's t_dim and key_dim
and the ring's length, as the JAX ``hnl_test`` does), and with ``--eval``
prints the VID mAP.  ``--stream`` runs the streaming ring (speculative,
replaying flagged chunks exactly).  ``--pre-padding random`` (the default)
front-pads each video's window with half − 1 random frames of the same
video, drawn from a generator of their own seeded by ``--seed``;
``repeat`` pads with copies of the first frame.
``--pair-features P`` runs P consecutive interior frames through one frame
program.  ``--multi-pass P`` runs the head's multi-pass test graph
(``forward_fc1_multi_passes``) over P equal segments of the window on the
exact ring (``--window 63 --multi-pass 3``: HVRNet's three-segment graph);
P must divide the window, and ``--stream`` does not run it.  The shared
flags (ranks, ``--device``, ``--decoder``,
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


def set_head_window(cfg, window: int) -> None:
    """``--window W`` as the JAX ``hnl_test`` sets it before it builds the
    engine: the head's t_dim W and key_dim ``(W - 1) // 2`` (the engine's
    window follows with ``set_window``); the dataset keeps the config's
    frame_interval."""
    if window < 1:
        raise SystemExit(f"--window {window}: the window is at least 1 frame")
    cfg.test_cfg["bbox_head"]["t_dim"] = window
    cfg.test_cfg["bbox_head"]["key_dim"] = (window - 1) // 2


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HVRNet VID test")
    add_common_args(p)
    p.add_argument("--out", default="results_hnl.pkl")
    p.add_argument("--window", type=int, default=63,
                   help="window length W: the head's t_dim, the ring's "
                        "length, key frame (W - 1) // 2")
    p.add_argument("--pre-padding", choices=["random", "repeat"],
                   default="random")
    p.add_argument("--stream", action="store_true",
                   help="the streaming-softmax ring")
    p.add_argument("--multi-pass", type=int, default=0, metavar="P",
                   help="split the window into P segments and run the "
                        "head's multi-pass test graph; 0 is the spliced "
                        "single-pass graph")
    p.add_argument("--pair-features", type=int, default=1, metavar="P",
                   help="run P consecutive interior frames through one "
                        "frame program")
    return p.parse_args(argv)


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
    if args.multi_pass:
        if args.window % args.multi_pass:
            raise SystemExit(f"--multi-pass {args.multi_pass} must divide "
                             f"the window length {args.window}")
        if args.stream:
            raise SystemExit("--stream caches the single-pass spliced graph; "
                             "combine with --multi-pass is unsupported")
    setup(args)
    imread = imread or decoder_from_flag(args.decoder)
    cfg = Config.fromfile(args.config)
    set_head_window(cfg, args.window)
    dataset = test_dataset(cfg, args.world_size, args.seed, imread)
    engine = test_engine(cfg, args)
    set_window(engine, args.window)
    engine.stream = args.stream
    engine.multi_pass = args.multi_pass or None
    prepad = None
    if args.pre_padding == "random":
        prepad = random_prepad(dataset, args.rank, args.window, args.seed,
                               canvas_of(cfg), imread)
    return run_test(args, cfg, dataset, engine, imread,
                    prepad_provider=prepad, timer=timer)


if __name__ == "__main__":
    main()
