"""ImageNet VID / DET sequence datasets (counterpart of
``hvrnet_tpu/data/vid_dataset.py``).

- the 30-class VID label space (WordNet ids and names);
- imageset lines of 4 fields: video path, frame id, frame seg id, seg len
  (DET: one image id per line, a 1-frame pseudo-video);
- VOC XML annotations, parsed with ElementTree (boxes −1 to 0-based,
  labels 1-based);
- TRAIN: each index yields 3 frames per sampled video, the key frame and
  two condition frames at random offsets in ±1000 clipped to the video,
  run through the pipeline with the key frame's flip; ``hnl=True`` samples
  9 videos, the key video, 2 more of its class and 3 each of 2 other
  classes (``ImageSets/VID/train_<c>.txt``);
- TEST: the stateful iterator over whole videos: ``key_frame_flag`` 0 at a
  video's first frame, 2 inside, 1 at its last; ``frame_offset``,
  ``seg_len`` and ``frame_start_id``; each video's frames shuffled when
  ``video_shuffle`` is set; whole videos dealt to ranks, with each rank's
  ``frame_id`` rebased.

Randomness: the JAX package draws from Python's global ``random`` (the
video sampling) and numpy's global state (everything else: offsets,
re-draws, the retry index, every random transform, the test shuffles).
Here a dataset owns one ``random.Random(seed)`` and one
``np.random.RandomState(seed)`` and draws from them in the reference's
order, so ``random.seed(s); np.random.seed(s)`` before the JAX package's
dataset and ``seed=s`` here give the same frames.  The members of a
concatenated dataset share one pair, as the JAX ones share the globals.
"""
from __future__ import annotations

import os.path as osp
import random
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.registry import Registry, build_from_cfg
from .pipelines import Compose, render

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


def generators(seed: int) -> Tuple[random.Random, np.random.RandomState]:
    """The pair a dataset draws from, as ``random.seed(seed);
    np.random.seed(seed)`` leaves the JAX package's globals."""
    return random.Random(seed), np.random.RandomState(seed)


@DATASETS.register_module
class VIDSeqDataset:
    MIN_OFFSET = -1000
    MAX_OFFSET = 1000

    def __init__(self, ann_file: str, img_prefix: str, pipeline: Sequence,
                 test_mode: bool = False, world_size: int = 1,
                 hnl: bool = False, selsa_with_aug: bool = False,
                 condition_random_flip: bool = False,
                 video_shuffle: bool = True, cls_map_dir: Optional[str] = None,
                 seed: int = 0, imread="cv2", rngs=None, **kwargs):
        """``rngs``: a (``random.Random``, ``np.random.RandomState``) pair
        to draw from, shared with other datasets; by default a pair of its
        own from ``seed``.  ``kwargs``: the config's other keys
        (``shuffle``, ``has_rpn``, ``frame_interval``), unused."""
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.py_rng, self.rng = rngs if rngs is not None else generators(seed)
        self.imread = imread
        self.pipeline_cfg = [dict(t) for t in pipeline]
        self.pipeline = Compose(self.pipeline_cfg, self.rng, imread)
        self.selsa_with_aug = selsa_with_aug
        self.condition_random_flip = condition_random_flip
        self.class_map = ("__background__",) + VID_WNIDS
        self.class_to_index = {c: i for i, c in enumerate(self.class_map)}
        self.extra_cls = 2 if hnl else 0
        self.video_per_cls = 3 if hnl else 1
        self.cls_map_dir = cls_map_dir or osp.join(img_prefix, "ImageSets")
        self.img_infos = self.load_annotations(ann_file)
        self._get_video2idx()
        if self.extra_cls:
            self._get_cls2video()
        if test_mode:
            self.video_shuffle = video_shuffle
            self.size = sum(v["frame_seg_len"] for v in self.img_infos)
            self.cur_tid = 0
            self.cur_video_index = 0
            self.key_frame_flag = 0
            self.get_indices(world_size)
        else:
            self._set_group_flag()

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

    def _set_group_flag(self):
        """1 for a landscape frame, 0 otherwise (the reference's aspect
        groups)."""
        self.flag = np.array([info["width"] / info["height"] > 1
                              for info in self.img_infos], np.uint8)

    def _get_video2idx(self):
        video2idx: Dict[str, List[int]] = {}
        idx2video: Dict[int, str] = {}
        for i, info in enumerate(self.img_infos):
            vid = info["pattern"].split("/")[-2]
            video2idx.setdefault(vid, []).append(i)
            idx2video[i] = vid
        self.video_2_idx = video2idx
        self.idx_2_video = idx2video

    def _get_cls2video(self):
        """Class ↔ video maps from ``<cls_map_dir>/VID/train_<c>.txt``, one
        list per class (first field of a line, its last path part)."""
        video2cls: Dict[str, int] = {}
        cls2video: List[List[str]] = []
        for i in range(len(self.class_map) - 1):
            cls2video.append([])
            path = osp.join(self.cls_map_dir, "VID", f"train_{i + 1}.txt")
            for line in list_from_file(path):
                vid = line.strip().split(" ")[0].strip().split("/")[-1]
                video2cls[vid] = i
                cls2video[i].append(vid)
        self.video_2_cls = video2cls
        self.cls_2_video = cls2video

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
        return self.size if self.test_mode else len(self.img_infos)

    # ------------------------------------------------------------- train
    def sample_videos(self, idx: int, extra_cls_num: int = 0,
                      video_per_cls: int = 1) -> List[int]:
        """The key frame ``idx``, then with ``extra_cls_num``: one frame of
        each of ``video_per_cls`` − 1 other videos of its class and of
        ``video_per_cls`` videos of each of ``extra_cls_num`` other
        classes."""
        sampled = [idx]
        if extra_cls_num:
            rand = self.py_rng
            vid = self.idx_2_video[idx]
            cls = self.video_2_cls[vid]
            same = [v for v in self.cls_2_video[cls] if v != vid]
            for v in rand.sample(same, video_per_cls - 1):
                sampled.extend(rand.sample(self.video_2_idx[v], 1))
            other = [c for c in range(len(self.class_map) - 1) if c != cls]
            for c in rand.sample(other, extra_cls_num):
                for v in rand.sample(self.cls_2_video[c], video_per_cls):
                    sampled.extend(rand.sample(self.video_2_idx[v], 1))
        return sampled

    def get_ann_info(self, idx: int) -> Dict:
        """Train mode: frame ``idx``'s annotation.  Test mode: the ground
        truth of the NEXT frame in dataset order, a stateful iterator as
        the reference's: ``idx`` selects only the video; the frame within
        it is the iterator's own count."""
        if not self.test_mode:
            xml = osp.join(self.img_prefix, "Annotations",
                           self.img_infos[idx]["id"] + ".xml")
            return parse_vid_xml(xml, self.class_to_index)[0]
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

    def _condition_frame(self, video_info: Dict, seg_id: int):
        """(image info, annotation, discard) of a condition frame: its own
        size from its XML, discarded under ``selsa_with_aug`` when it has
        no box."""
        info = self._frame_info(video_info, seg_id)
        xml = osp.join(self.img_prefix, "Annotations", info["id"] + ".xml")
        ann, (info["width"], info["height"]), n = parse_vid_xml(
            xml, self.class_to_index)
        return info, ann, self.selsa_with_aug and n == 0

    def _condition_pipeline(self, key_flipped: bool) -> Compose:
        """The pipeline with ``RandomFlip`` at the key frame's flip (ratio 0
        or 1, still one draw per frame), or at 0.5 with
        ``condition_random_flip``."""
        cfg = []
        for t in self.pipeline_cfg:
            t = dict(t)
            if t.get("type") == "RandomFlip":
                t["flip_ratio"] = (0.5 if self.condition_random_flip
                                   else float(key_flipped))
            cfg.append(t)
        return Compose(cfg, self.rng, self.imread)

    def pre_pipeline(self, results: Dict, lazy: bool = False):
        results["img_prefix"] = self.img_prefix
        results["bbox_fields"] = []
        if lazy:
            results["lazy"] = True

    def _rand_another(self, idx):
        return self.rng.randint(len(self.img_infos))

    def _offsets(self, info: Dict) -> List[int]:
        """Two distinct offsets in [MIN_OFFSET, MAX_OFFSET] from the key
        frame, clipped to the video."""
        span = self.MAX_OFFSET - self.MIN_OFFSET + 1
        offsets = self.rng.choice(span, 2, replace=False) + self.MIN_OFFSET
        return [int(np.clip(info["frame_seg_id"] + o, 0,
                            info["frame_seg_len"] - 1)) for o in offsets]

    def prepare_train_img(self, idx: int, extra_cls: int = 0,
                          video_per_cls: int = 1, lazy: bool = False
                          ) -> Optional[List[Dict]]:
        """Per sampled video its key frame and two condition frames through
        the pipeline, in the order [key, cond0, cond1]; None when the
        pipeline drops a frame.  ``lazy``: images planned, not decoded
        (``pipelines.LazyImage``)."""
        res_list = []
        for vid_idx in self.sample_videos(idx, extra_cls, video_per_cls):
            info = self.img_infos[vid_idx]
            ann = self.get_ann_info(vid_idx)
            results = dict(img_info=info, ann_info=ann)
            self.pre_pipeline(results, lazy)
            key_res = self.pipeline(results)
            if key_res is None:
                return None
            key_flipped = bool(key_res["img_meta"]["flip"])

            ids = self._offsets(info)
            con = [self._condition_frame(info, i) for i in ids]
            if ids[0] == ids[1] and self.selsa_with_aug:
                i = self.rng.randint(0, 2)
                con[i] = (con[i][0], con[i][1], True)
            fixed = []
            for ci, (cinfo, cann, discard) in enumerate(con):
                while discard:     # re-draw both, keep this slot's
                    nid = self._offsets(info)[ci]
                    cinfo, cann, discard = self._condition_frame(info, nid)
                fixed.append((cinfo, cann))

            pipe = self._condition_pipeline(key_flipped)
            for cinfo, cann in fixed:
                r = dict(img_info=cinfo,
                         ann_info=cann if self.selsa_with_aug else ann)
                self.pre_pipeline(r, lazy)
                out = pipe(r)
                if out is None:
                    return None
                res_list.append(out)
            res_list.insert(len(res_list) - 2, key_res)
        return res_list

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

    def plan(self, idx: int) -> List[Dict]:
        """The training item ``__getitem__`` gives, with the same draws,
        its images planned and not decoded (``pipelines.render`` decodes
        one)."""
        if self.test_mode:
            raise TypeError("plan() takes a training dataset")
        while True:
            data = self.prepare_train_img(idx, self.extra_cls,
                                          self.video_per_cls, lazy=True)
            if data is not None:
                return data
            idx = self._rand_another(idx)

    def __getitem__(self, idx: int):
        if not self.test_mode:
            frames = self.plan(idx)
            for f in frames:
                f["img"] = render(f["img"])
            return frames
        out = self.prepare_test_img(idx)
        self.cur_tid += 1
        if self.cur_tid == self.cur_seg_len:
            self.cur_video_index += 1
            self.cur_tid = 0
            self.key_frame_flag = 1
            out["img_meta"]["key_frame_flag"] = 1
        return out


@DATASETS.register_module
class DETSeqDataset(VIDSeqDataset):
    """Still-image DET data behind the sequence interface: each image is a
    1-frame pseudo-video (its pattern ignores the frame number), so its
    condition frames are itself."""

    def load_annotations(self, ann_file: str) -> List[Dict]:
        img_infos = []
        for raw in list_from_file(ann_file):
            image_id = raw.strip().split(" ")[0]
            root = ET.parse(osp.join(self.img_prefix, "Annotations",
                                     image_id + ".xml")).getroot()
            size = root.find("size")
            img_infos.append(dict(
                id=image_id,
                filename=f"JPEGImages/{image_id}.JPEG",
                width=int(size.find("width").text),
                height=int(size.find("height").text),
                num_annos=len(root.findall("object")),
                pattern=image_id + "%.0s",     # pattern % i == image_id
                frame_id=1,
                frame_seg_id=0,
                frame_seg_len=1))
        return img_infos

    def _get_cls2video(self):
        # DET images play no part in triplet-video mining
        self.video_2_cls = {}
        self.cls_2_video = [[] for _ in range(len(self.class_map) - 1)]


def build_dataset(cfg, default_args=None):
    """A dataset from its config dict; a list of them concatenated, every
    member drawing from ONE pair of generators (seeded by
    ``default_args['seed']``, default 0)."""
    if isinstance(cfg, (list, tuple)):
        args = dict(default_args or {})
        if "rngs" not in args:
            args["rngs"] = generators(int(args.pop("seed", 0)))
        return ConcatDataset([build_dataset(c, args) for c in cfg])
    return build_from_cfg(dict(cfg), DATASETS, default_args)


class ConcatDataset:
    """Datasets end to end (training)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])
        if all(hasattr(d, "flag") for d in self.datasets):
            self.flag = np.concatenate([d.flag for d in self.datasets])

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def _member(self, idx):
        ds = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        base = 0 if ds == 0 else int(self.cumulative_sizes[ds - 1])
        return self.datasets[ds], idx - base

    def __getitem__(self, idx):
        ds, i = self._member(idx)
        return ds[i]

    def plan(self, idx):
        ds, i = self._member(idx)
        return ds.plan(i)


class RepeatDataset:
    """A dataset ``times`` over."""

    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        if hasattr(dataset, "flag"):
            self.flag = np.tile(dataset.flag, times)

    def __len__(self):
        return self.times * len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def plan(self, idx):
        return self.dataset.plan(idx % len(self.dataset))
