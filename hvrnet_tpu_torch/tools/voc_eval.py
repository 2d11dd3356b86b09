"""VOC mAP of a results pickle (counterpart of the JAX package's
``tools/voc_eval.py``):

    python -m hvrnet_tpu_torch.tools.voc_eval results.pkl <config> \
        [--iou-thr 0.5]

builds the config's ``data.test`` dataset in test mode (annotations only)
and prints ``eval_map``'s summary: a dataset's ignored boxes are ground
truth that neither counts nor penalises, and a VOC2007 dataset is scored
as ``voc07`` (11-point AP), any other by its class names.
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..core.evaluation import eval_map
from ..data import build_dataset
from ..utils.config import Config


def voc_eval(result_file, dataset, iou_thr=0.5):
    """(mAP, per-class results) of the pickled detections in
    ``result_file`` against ``dataset``'s annotations."""
    with open(result_file, "rb") as f:
        det_results = pickle.load(f)
    gt_bboxes, gt_labels, gt_ignore = [], [], []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        bboxes, labels = ann["bboxes"], ann["labels"]
        if ann.get("bboxes_ignore") is not None and len(ann["bboxes_ignore"]):
            gt_ignore.append(np.concatenate([
                np.zeros(bboxes.shape[0], bool),
                np.ones(ann["bboxes_ignore"].shape[0], bool)]))
            bboxes = np.vstack([bboxes, ann["bboxes_ignore"]])
            labels = np.concatenate([labels, ann["labels_ignore"]])
        gt_bboxes.append(bboxes)
        gt_labels.append(labels)
    dataset_name = ("voc07" if getattr(dataset, "year", None) == 2007
                    else dataset.CLASSES)
    return eval_map(det_results, gt_bboxes, gt_labels,
                    gt_ignore=gt_ignore or None, iou_thr=iou_thr,
                    dataset=dataset_name, print_summary=True)


def main(argv=None):
    p = argparse.ArgumentParser(description="VOC evaluation")
    p.add_argument("result")
    p.add_argument("config")
    p.add_argument("--iou-thr", type=float, default=0.5)
    args = p.parse_args(argv)
    cfg = Config.fromfile(args.config)
    dataset = build_dataset(dict(cfg.data.test), dict(test_mode=True))
    return voc_eval(args.result, dataset, args.iou_thr)


if __name__ == "__main__":
    main()
