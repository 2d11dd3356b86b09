"""The training loop's evaluation (counterpart of
``hvrnet_tpu/engine/eval_hook.py:VidEvalHook``).

Every ``interval`` epochs: the training engine's weights go into a serving
engine (its own ``test_cfg``: the window's t_dim, proposals), which runs the
sliding window over every video of the config's ``data.val`` on its ring;
with ``world_size`` > 1 each rank writes its part file and rank 0 merges
them; rank 0 scores the VID mAP against the world-size-1 ground truth and
appends ``{"epoch", "mAP"}`` to ``train_log.jsonl``.

The val dataset is built as the test CLI builds it
(``tools/test.py:test_dataset``), its frame shuffles and flips from
``seed``: the hook's mAP on an epoch is the one ``hnl_test --eval --seed
<seed> --window <t_dim> --pre-padding repeat`` (or SELSA's ``test --eval``)
gives on that epoch's checkpoint.  (In the JAX package the val shuffles
draw from numpy's global state between training steps instead.)
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..core.evaluation import eval_map
from ..data.vid_dataset import VID_CLASSES, build_dataset
from ..utils.dist_io import (collect_results, dump_part, trim_to_local,
                             wait_for_parts)
from .stream import prefetch_stream, test_frame_stream
from .video_runner import SlidingWindowRunner


class VidEvalHook:
    def __init__(self, engine, dataset_cfg: dict, interval: int = 1,
                 work_dir: str = ".", world_size: int = 1, rank: int = 0,
                 merge_timeout: float = 3600.0, canvas_hw=(608, 1008),
                 seed: int = 0, imread="cv2"):
        """``engine``: the serving engine that runs the evaluation (built
        with the config's ``test_cfg``); ``dataset_cfg``: ``data.val`` with
        the ``relation_setup`` keys; ``canvas_hw``: the landscape canvas
        (the training one, as in the JAX package)."""
        self.engine = engine
        self.dataset_cfg = dict(dataset_cfg)
        self.interval = interval
        self.work_dir = work_dir
        self.world_size = world_size
        self.rank = rank
        self.merge_timeout = merge_timeout
        self.canvas_hw = tuple(canvas_hw)
        self.seed = seed
        self.imread = imread
        self.results = None         # the last evaluation's merged results

    def _dataset(self, world_size: int):
        return build_dataset(self.dataset_cfg,
                             dict(test_mode=True, world_size=world_size,
                                  seed=self.seed, imread=self.imread))

    def __call__(self, train_engine, epoch: int) -> Optional[float]:
        if (epoch + 1) % self.interval:
            return None
        # every tensor, frozen-BN statistics included; a bf16 engine's head
        # copies cast again
        self.engine.model.load_state_dict(train_engine.model.state_dict(),
                                          strict=True)
        self.engine.cast_head_params_bf16()
        dataset = self._dataset(self.world_size)
        results = SlidingWindowRunner(self.engine).run(
            prefetch_stream(test_frame_stream(
                dataset, rank=self.rank, max_long=max(self.canvas_hw),
                max_short=min(self.canvas_hw))),
            num_frames=len(dataset))
        results = trim_to_local(results, dataset, self.rank)
        if self.world_size > 1:
            tmpdir = os.path.join(self.work_dir, f"eval_tmp_ep{epoch}")
            dump_part(results, tmpdir, self.rank)
            if self.rank != 0:
                return None
            wait_for_parts([os.path.join(tmpdir, f"part_{r}.pkl")
                            for r in range(self.world_size)],
                           timeout=self.merge_timeout)
            results = collect_results(tmpdir, self.world_size, len(dataset))
        elif self.rank != 0:
            return None

        # ground truth in global frame order (a world-size-1 build: a
        # sharded one rebases each rank's frame ids)
        gt = self._dataset(1)
        gt_bboxes, gt_labels = [], []
        for i in range(len(gt)):
            ann = gt.get_ann_info(i)
            gt_bboxes.append(ann["bboxes"])
            gt_labels.append(ann["labels"])
        empty = [np.zeros((0, 5), np.float32)
                 for _ in range(self.engine.num_classes - 1)]
        self.results = results = [r if r is not None else empty
                                  for r in results]
        mean_ap, _ = eval_map(results, gt_bboxes, gt_labels,
                              dataset=VID_CLASSES, print_summary=True)
        with open(os.path.join(self.work_dir, "train_log.jsonl"), "a") as f:
            f.write(json.dumps(dict(epoch=epoch, mAP=float(mean_ap))) + "\n")
        return float(mean_ap)
