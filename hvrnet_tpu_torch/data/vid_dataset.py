"""ImageNet VID sequence dataset, test side (counterpart of
``hvrnet_tpu/data/vid_dataset.py``).

- the 30-class VID label space (WordNet ids and names);
- imageset lines of 4 fields: video path, frame id, frame seg id, seg len;
- VOC XML annotations, parsed with ElementTree (boxes −1 to 0-based,
  labels 1-based);
- the stateful test iterator over whole videos: ``key_frame_flag`` 0 at a
  video's first frame, 2 inside, 1 at its last; ``frame_offset``,
  ``seg_len`` and ``frame_start_id``; each video's frames shuffled when
  ``video_shuffle`` is set;
- whole videos dealt to ranks, with each rank's ``frame_id`` rebased.

Randomness comes from one ``np.random.RandomState(seed)`` per dataset: the
video shuffles and ``RandomFlip``'s per-frame draw, in the reference's
order, so ``np.random.seed(seed)`` before the JAX package's iterator and
``seed`` here give the same frames.  Train mode raises.
"""
from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence

import numpy as np

from ..utils.registry import Registry, build_from_cfg
from .pipelines import Compose

DATASETS = Registry("dataset")

VID_WNIDS = (
    "n02691156", "n02419796", "n02131653", "n02834778", "n01503061",
    "n02924116", "n02958343", "n02402425", "n02084071", "n02121808",
    "n02503517", "n02118333", "n02510455", "n02342885", "n02374451",
    "n02129165", "n01674464", "n02484322", "n03790512", "n02324045",
    "n02509815", "n02411705", "n01726692", "n02355227", "n02129604",
    "n04468005", "n01662784", "n04530566", "n02062744", "n02391049")

VID_CLASSES = (
    "airplane", "antelope", "bear", "bicycle", "bird", "bus", "car",
    "cattle", "dog", "domestic_cat", "elephant", "fox", "giant_panda",
    "hamster", "horse", "lion", "lizard", "monkey", "motorcycle", "rabbit",
    "red_panda", "sheep", "snake", "squirrel", "tiger", "train", "turtle",
    "watercraft", "whale", "zebra")

TRAIN_NOT_PORTED = ("VIDSeqDataset's train side (triplet sampling, "
                    "condition frames) is not ported yet (ROADMAP Queue 1 "
                    "item 6)")


def list_from_file(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def parse_vid_xml(xml_path: str, class_to_index: Dict[str, int]):
    """VOC-style XML → (ann dict, (width, height), number of kept boxes);
    boxes −1 to 0-based float32, labels 1-based int64, names outside
    ``class_to_index`` skipped."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)
    bboxes, labels = [], []
    for obj in root.findall("object"):
        name = obj.find("name").text
        if name not in class_to_index:
            continue
        bnd = obj.find("bndbox")
        bboxes.append([int(bnd.find(k).text)
                       for k in ("xmin", "ymin", "xmax", "ymax")])
        labels.append(class_to_index[name])
    if bboxes:
        bboxes_np = np.asarray(bboxes, np.float32) - 1
        labels_np = np.asarray(labels, np.int64)
    else:
        bboxes_np = np.zeros((0, 4), np.float32)
        labels_np = np.zeros((0,), np.int64)
    ann = dict(bboxes=bboxes_np, labels=labels_np,
               bboxes_ignore=np.zeros((0, 4), np.float32),
               labels_ignore=np.zeros((0,), np.int64))
    return ann, (width, height), len(bboxes)


@DATASETS.register_module
class VIDSeqDataset:
    def __init__(self, ann_file: str, img_prefix: str, pipeline: Sequence,
                 test_mode: bool = False, world_size: int = 1,
                 video_shuffle: bool = True, seed: int = 0, imread="cv2",
                 **kwargs):
        """``kwargs``: the config's other keys (``shuffle``, ``has_rpn``,
        ``frame_interval``, the training-side flags), unused at test
        time."""
        if not test_mode:
            raise NotImplementedError(TRAIN_NOT_PORTED)
        self.img_prefix = img_prefix
        self.rng = np.random.RandomState(seed)
        self.imread = imread
        self.pipeline_cfg = [dict(t) for t in pipeline]
        self.pipeline = Compose(self.pipeline_cfg, self.rng, imread)
        self.class_to_index = {c: i for i, c in
                               enumerate(("__background__",) + VID_WNIDS)}
        self.img_infos = self.load_annotations(ann_file)
        self.video_shuffle = video_shuffle
        self.size = sum(v["frame_seg_len"] for v in self.img_infos)
        self.cur_tid = 0
        self.cur_video_index = 0
        self.key_frame_flag = 0
        self.get_indices(world_size)

    def load_annotations(self, ann_file: str) -> List[Dict]:
        img_infos = []
        for raw in list_from_file(ann_file):
            parts = raw.strip().split(" ")
            if len(parts) != 4:
                raise ValueError(f"{ann_file}: VIDSeq imageset lines need 4 "
                                 f"fields, got {raw!r}")
            video_path, frame_id, seg_id, seg_len = (
                parts[0], int(parts[1]), int(parts[2]), int(parts[3]))
            image_id = "%s/%06d" % (video_path, seg_id)
            root = ET.parse(osp.join(self.img_prefix, "Annotations",
                                     image_id + ".xml")).getroot()
            size = root.find("size")
            img_infos.append(dict(
                id=image_id,
                filename=f"JPEGImages/{image_id}.JPEG",
                width=int(size.find("width").text),
                height=int(size.find("height").text),
                num_annos=len(root.findall("object")),
                pattern=video_path + "/%06d",
                frame_id=frame_id,
                frame_seg_id=seg_id,
                frame_seg_len=seg_len))
        return img_infos

    def get_indices(self, world_size: int):
        """Deal WHOLE videos to ranks in order, and rebase each rank's
        ``frame_id`` so that its frames start at 1."""
        avg = -(-self.size // world_size)
        indices_list = [[] for _ in range(world_size)]
        local_video_list = [[] for _ in range(world_size)]
        self.global_video_list: List[int] = []
        tmp_len, tmp_rank, pos, local_vid = 0, 0, 0, 0
        for i, info in enumerate(self.img_infos):
            n = info["frame_seg_len"]
            self.global_video_list.extend([i] * n)
            if tmp_len + n > avg and tmp_rank != world_size - 1:
                tmp_rank += 1
                local_vid = 0
                tmp_len = 0
            base = sum(len(v) for v in local_video_list[:tmp_rank])
            self.img_infos[i]["frame_id"] -= 0 if tmp_rank == 0 else base
            indices_list[tmp_rank].extend(list(np.arange(n) + pos))
            local_video_list[tmp_rank].extend([local_vid] * n)
            local_vid += 1
            tmp_len += n
            pos += n
        self.indices_list = indices_list
        self.local_frame_size_list = [len(x) for x in indices_list]
        return indices_list

    def __len__(self):
        return self.size

    def get_ann_info(self, idx: int) -> Dict:
        """The ground truth of the NEXT frame in dataset order: a stateful
        iterator, as the reference's.  ``idx`` selects only the video; the
        frame within it is the iterator's own count."""
        self.cur_video_index = self.global_video_list[idx]
        info = self.img_infos[self.cur_video_index]
        xml = osp.join(self.img_prefix, "Annotations",
                       (info["pattern"] % self.cur_tid) + ".xml")
        ann, _, _ = parse_vid_xml(xml, self.class_to_index)
        self.cur_tid += 1
        if self.cur_tid == info["frame_seg_len"]:
            self.cur_video_index += 1
            self.cur_tid = 0
        return ann

    def _frame_info(self, video_info: Dict, seg_id: int) -> Dict:
        """The image info of frame ``seg_id`` of a video."""
        info = video_info.copy()
        image_id = video_info["pattern"] % seg_id
        info["id"] = image_id
        info["filename"] = f"JPEGImages/{image_id}.JPEG"
        info["frame_seg_id"] = seg_id
        return info

    def pre_pipeline(self, results: Dict):
        results["img_prefix"] = self.img_prefix
        results["bbox_fields"] = []

    def prepare_test_img(self, idx: int) -> Dict:
        """The next frame of the stateful sequential iterator."""
        self.cur_video_index = self.global_video_list[idx]
        if self.cur_tid == 0:
            self.key_frame_flag = 0
            self.cur_video = self.img_infos[self.cur_video_index].copy()
            self.cur_seg_len = self.cur_video["frame_seg_len"]
            self.video_index = np.arange(self.cur_seg_len).tolist()
            if self.video_shuffle:
                self.rng.shuffle(self.video_index)
        else:
            self.key_frame_flag = 2
        offset = (self.video_index[self.cur_tid] if self.video_shuffle
                  else self.cur_tid)
        results = dict(img_info=self._frame_info(self.cur_video, offset))
        self.pre_pipeline(results)
        out = self.pipeline(results)
        out["img_meta"].update(dict(
            frame_offset=offset,
            key_frame_flag=self.key_frame_flag,
            seg_len=self.cur_video["frame_seg_len"],
            frame_start_id=self.cur_video["frame_id"]))
        return out

    def __getitem__(self, idx: int):
        out = self.prepare_test_img(idx)
        self.cur_tid += 1
        if self.cur_tid == self.cur_seg_len:
            self.cur_video_index += 1
            self.cur_tid = 0
            self.key_frame_flag = 1
            out["img_meta"]["key_frame_flag"] = 1
        return out


@DATASETS.register_module
class DETSeqDataset:
    """Still-image DET data behind the sequence interface (training only)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("DETSeqDataset feeds training, which is "
                                  "not ported yet (ROADMAP Queue 1 item 6)")


def build_dataset(cfg, default_args=None):
    """A dataset from its config dict (a list, the training concat, is not
    ported)."""
    if isinstance(cfg, (list, tuple)):
        raise NotImplementedError("concatenated datasets feed training, "
                                  "which is not ported yet (ROADMAP Queue 1 "
                                  "item 6)")
    return build_from_cfg(dict(cfg), DATASETS, default_args)
