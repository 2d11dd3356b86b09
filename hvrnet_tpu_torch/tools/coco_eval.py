"""COCO-protocol evaluation of a results pickle (counterpart of the JAX
package's ``tools/coco_eval.py``):

    python -m hvrnet_tpu_torch.tools.coco_eval results.pkl <config> \
        [--json-out dets.json]

builds the config's ``data.test`` dataset in test mode (annotations only,
no image is decoded), writes the detections as a COCO results json with
``--json-out``, and prints AP at IoU 0.50, 0.55, …, 0.95 by ``eval_map``
(the port has no pycocotools either) and their mean, AP@[0.50:0.95].
"""
from __future__ import annotations

import argparse
import json
import pickle

import numpy as np

from ..core.evaluation import eval_map
from ..data import build_dataset
from ..utils.config import Config


def results2json(dataset, results, out_file):
    """Per-image, per-class (n, 5) detections as COCO results: one entry
    per box, ``bbox`` ``[x1, y1, x2 − x1 + 1, y2 − y1 + 1]``, the class's
    ``cat_ids`` entry (1-based ids without ``cat_ids``); images whose
    result is None are skipped.  Returns ``out_file``."""
    json_results = []
    cat_ids = getattr(dataset, "cat_ids",
                      list(range(1, len(dataset.CLASSES) + 1)))
    for idx, res in enumerate(results):
        if res is None:
            continue
        img_id = dataset.img_infos[idx]["id"]
        for label, dets in enumerate(res):
            for det in dets:
                x1, y1, x2, y2, score = det[:5].tolist()
                json_results.append(dict(
                    image_id=img_id,
                    bbox=[x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                    score=float(score),
                    category_id=cat_ids[label]))
    with open(out_file, "w") as f:
        json.dump(json_results, f)
    return out_file


def coco_style_eval(det_results, gt_bboxes, gt_labels, classes):
    """The mean over IoU 0.50:0.95 (step 0.05) of ``eval_map``'s mAP,
    each printed."""
    aps = []
    for thr in np.arange(0.5, 1.0, 0.05):
        m, _ = eval_map(det_results, gt_bboxes, gt_labels, iou_thr=float(thr),
                        dataset=classes, print_summary=False)
        aps.append(m)
        print(f"AP@{thr:.2f}: {m:.4f}")
    print(f"AP@[0.50:0.95]: {float(np.mean(aps)):.4f}")
    return float(np.mean(aps))


def main(argv=None):
    p = argparse.ArgumentParser(description="COCO-protocol evaluation")
    p.add_argument("result")
    p.add_argument("config")
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)
    cfg = Config.fromfile(args.config)
    dataset = build_dataset(dict(cfg.data.test), dict(test_mode=True))
    with open(args.result, "rb") as f:
        results = pickle.load(f)
    if args.json_out:
        results2json(dataset, results, args.json_out)
        print(f"wrote {args.json_out}")
    anns = [dataset.get_ann_info(i) for i in range(len(dataset))]
    return coco_style_eval(results, [a["bboxes"] for a in anns],
                           [a["labels"] for a in anns], dataset.CLASSES)


if __name__ == "__main__":
    main()
