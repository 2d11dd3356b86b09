"""Still-image datasets (counterpart of ``hvrnet_tpu/data/datasets.py``,
mmdet's ``custom.py``, ``xml_style.py``, ``voc.py``, ``wider_face.py``,
``coco.py``, ``cityscapes.py``, ``imagenet_vid.py`` and
``imagenet_det_img.py``), registered in ``DATASETS``:

- ``CustomDataset``: the annotation list, each image's aspect group
  ``flag`` (1 where width / height > 1) in training, and the retry loop: a
  training item the pipeline drops, or that keeps no box, is replaced by a
  random other one;
- ``XMLDataset`` (``VOCDataset``, ``WIDERFaceDataset``): VOC XML under
  ``Annotations/{id}.xml``, images ``JPEGImages/{id}.jpg``, labels
  1-based in ``CLASSES`` order through ``parse_vid_xml`` (its 256-object
  cap); ``VOCDataset.year`` from ``img_prefix``;
- ``CocoDataset`` (``CityscapesDataset``): COCO json without pycocotools;
  labels 1-based in the order of the json's categories (``cat_ids``,
  ``cat2label``), ``CLASSES`` from the json when the class names none; a
  crowd box goes to ``bboxes_ignore``; a box under 1 pixel wide or high is
  dropped; boxes ``[x, y, x + w − 1, y + h − 1]``;
- ``VIDDataset`` / ``DETIMGDataset``: single ImageNet frames (``.JPEG``,
  the id ``video/%06d`` from an imageset line of 3 or more fields).

Randomness: the JAX package's retry draws from numpy's global state; here
from the dataset's own ``np.random.RandomState(seed)`` (or a pair handed
in as ``rngs``, shared with other datasets), the same generator its
pipeline's random transforms draw from, so ``np.random.seed(s)`` before
the JAX dataset and ``seed=s`` here give the same items.
"""
from __future__ import annotations

import json
import os.path as osp
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

from .pipelines import Compose
from .vid_dataset import (DATASETS, VID_WNIDS, generators, list_from_file,
                          parse_vid_xml)


class CustomDataset:
    CLASSES: Sequence[str] = ()

    def __init__(self, ann_file: str, img_prefix: str, pipeline: Sequence,
                 test_mode: bool = False, proposal_file: Optional[str] = None,
                 min_size: Optional[int] = None, seed: int = 0,
                 imread="cv2", rngs=None, **kwargs):
        """``rngs``: a (``random.Random``, ``np.random.RandomState``) pair
        to draw from; by default a pair of its own from ``seed``.
        ``kwargs``: the config's other keys, unused."""
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.min_size = min_size
        self.proposals = None
        self.py_rng, self.rng = rngs if rngs is not None else generators(seed)
        self.pipeline = Compose(pipeline, self.rng, imread)
        self.img_infos = self.load_annotations(ann_file)
        if not test_mode:
            self._set_group_flag()

    def load_annotations(self, ann_file: str) -> List[Dict]:
        raise NotImplementedError

    def get_ann_info(self, idx: int) -> Dict:
        raise NotImplementedError

    def _set_group_flag(self):
        self.flag = np.array([info["width"] / info["height"] > 1
                              for info in self.img_infos], np.uint8)

    def pre_pipeline(self, results: Dict):
        results["img_prefix"] = self.img_prefix
        results["bbox_fields"] = []

    def _rand_another(self, idx):
        return int(self.rng.randint(len(self)))

    def __len__(self):
        return len(self.img_infos)

    def __getitem__(self, idx):
        if self.test_mode:
            results = dict(img_info=self.img_infos[idx])
            self.pre_pipeline(results)
            return self.pipeline(results)
        while True:
            results = dict(img_info=self.img_infos[idx],
                           ann_info=self.get_ann_info(idx))
            self.pre_pipeline(results)
            data = self.pipeline(results)
            if data is None or len(data.get("gt_bboxes", [1])) == 0:
                idx = self._rand_another(idx)
                continue
            return data


def _image_size(xml_path: str):
    size = ET.parse(xml_path).getroot().find("size")
    return int(size.find("width").text), int(size.find("height").text)


@DATASETS.register_module
class XMLDataset(CustomDataset):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.cat2label = {c: i + 1 for i, c in enumerate(self.CLASSES)}

    def load_annotations(self, ann_file):
        img_infos = []
        for img_id in list_from_file(ann_file):
            img_id = img_id.strip().split(" ")[0]
            w, h = _image_size(osp.join(self.img_prefix, "Annotations",
                                        img_id + ".xml"))
            img_infos.append(dict(id=img_id,
                                  filename=f"JPEGImages/{img_id}.jpg",
                                  width=w, height=h))
        return img_infos

    def get_ann_info(self, idx):
        xml_path = osp.join(self.img_prefix, "Annotations",
                            self.img_infos[idx]["id"] + ".xml")
        class_to_index = {c: i + 1 for i, c in enumerate(self.CLASSES)}
        return parse_vid_xml(xml_path, class_to_index)[0]


@DATASETS.register_module
class VOCDataset(XMLDataset):
    CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
               "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
               "tvmonitor")

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if "VOC2007" in self.img_prefix:
            self.year = 2007
        elif "VOC2012" in self.img_prefix:
            self.year = 2012
        else:
            self.year = None


@DATASETS.register_module
class WIDERFaceDataset(XMLDataset):
    CLASSES = ("face",)


@DATASETS.register_module
class CocoDataset(CustomDataset):
    CLASSES = ()

    def load_annotations(self, ann_file):
        with open(ann_file) as f:
            coco = json.load(f)
        categories = coco.get("categories", [])
        self.cat_ids = [c["id"] for c in categories]
        self.cat2label = {cid: i + 1 for i, cid in enumerate(self.cat_ids)}
        if not self.CLASSES:
            self.CLASSES = tuple(c["name"] for c in categories)
        self._anns_by_img: Dict[int, list] = {}
        for a in coco.get("annotations", []):
            self._anns_by_img.setdefault(a["image_id"], []).append(a)
        return [dict(id=img["id"], filename=img["file_name"],
                     width=img["width"], height=img["height"])
                for img in coco.get("images", [])]

    def get_ann_info(self, idx):
        anns = self._anns_by_img.get(self.img_infos[idx]["id"], [])
        bboxes, labels, bboxes_ignore = [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            if a.get("iscrowd", 0):
                bboxes_ignore.append([x, y, x + w - 1, y + h - 1])
                continue
            if w < 1 or h < 1:
                continue
            bboxes.append([x, y, x + w - 1, y + h - 1])
            labels.append(self.cat2label[a["category_id"]])

        def boxes(lst):
            return (np.asarray(lst, np.float32) if lst
                    else np.zeros((0, 4), np.float32))

        return dict(bboxes=boxes(bboxes),
                    labels=np.asarray(labels, np.int64) if labels
                    else np.zeros((0,), np.int64),
                    bboxes_ignore=boxes(bboxes_ignore),
                    labels_ignore=np.zeros((len(bboxes_ignore),), np.int64))


@DATASETS.register_module
class CityscapesDataset(CocoDataset):
    CLASSES = ("person", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")


@DATASETS.register_module
class VIDDataset(XMLDataset):
    """Single ImageNet-VID frames: an imageset line of 3 or more fields
    names frame ``%06d`` of the video in its first field."""
    CLASSES = VID_WNIDS

    def load_annotations(self, ann_file):
        img_infos = []
        for raw in list_from_file(ann_file):
            parts = raw.strip().split(" ")
            img_id = (parts[0] if len(parts) < 3
                      else "%s/%06d" % (parts[0], int(parts[2])))
            w, h = _image_size(osp.join(self.img_prefix, "Annotations",
                                        img_id + ".xml"))
            img_infos.append(dict(id=img_id,
                                  filename=f"JPEGImages/{img_id}.JPEG",
                                  width=w, height=h))
        return img_infos


@DATASETS.register_module
class DETIMGDataset(VIDDataset):
    """Single ImageNet-DET images."""
