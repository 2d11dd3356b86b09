"""VID mAP of a results pickle (counterpart of the JAX package's
``tools/vid_eval.py``):

    python -m hvrnet_tpu_torch.tools.vid_eval results.pkl <config>

reads each frame's ground truth through a fresh test dataset's stateful
iterator in dataset order (XML only, no image is decoded) and runs
``eval_map`` over the 30 VID classes with ``tpfp_default`` matching
(``--imagenet-tpfp``: the adaptive ``tpfp_imagenet`` rule).  Results stored
as [branch, final] pairs are scored on the final branch; frames without
results count as empty.
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..core.evaluation import analysis_map, eval_map
from ..data.vid_dataset import VID_CLASSES, build_dataset
from ..utils.config import Config


def evaluate_results(result_file: str, config_file: str, iou_thr: float = 0.5,
                     analysis: bool = False, imagenet_tpfp: bool = False,
                     quiet: bool = False, imread="cv2"):
    """(mAP, per-class results) of ``result_file`` against the config's
    ``data.test`` ground truth."""
    cfg = Config.fromfile(config_file)
    dataset = build_dataset(dict(cfg.data.test),
                            dict(test_mode=True, world_size=1,
                                 imread=imread))
    with open(result_file, "rb") as f:
        det_results = pickle.load(f)
    if det_results and isinstance(det_results[0], list) \
            and len(det_results[0]) == 2 \
            and isinstance(det_results[0][0], list):
        det_results = [r[1] if r is not None else None for r in det_results]
    n_missing = sum(r is None for r in det_results)
    if n_missing:
        print(f"warning: {n_missing} frames without results → empty dets")
        empty = [np.zeros((0, 5), np.float32) for _ in range(30)]
        det_results = [r if r is not None else empty for r in det_results]

    gt_bboxes, gt_labels = [], []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        gt_bboxes.append(ann["bboxes"])
        gt_labels.append(ann["labels"])

    if analysis:
        return analysis_map(det_results, gt_bboxes, gt_labels,
                            iou_thr=iou_thr, dataset=VID_CLASSES,
                            file_dir=".", print_summary=not quiet)
    return eval_map(det_results, gt_bboxes, gt_labels, iou_thr=iou_thr,
                    dataset="vid" if imagenet_tpfp else VID_CLASSES,
                    print_summary=not quiet)


def main(argv=None):
    parser = argparse.ArgumentParser(description="VID mAP evaluation")
    parser.add_argument("result")
    parser.add_argument("config")
    parser.add_argument("--iou-thr", type=float, default=0.5)
    parser.add_argument("--analysis", action="store_true")
    parser.add_argument("--imagenet-tpfp", action="store_true")
    args = parser.parse_args(argv)
    return evaluate_results(args.result, args.config, args.iou_thr,
                            args.analysis, args.imagenet_tpfp)


if __name__ == "__main__":
    main()
