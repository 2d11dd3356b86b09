"""Host-side pipelines (counterpart of ``hvrnet_tpu/data/pipelines.py``):
the test transforms (load, keep-ratio resize, flip, normalise, pad,
collect) and the training ones (float loading, annotations,
``PhotoMetricDistortion``, ``Expand``, ``MinIoURandomCrop``, ``Albu``,
``LoadProposals``).  numpy only.

Two things the caller hands in rather than the module importing them:
- ``imread(path) -> (H, W, 3) uint8 BGR``, the image decoder.  The default
  ``"cv2"`` imports cv2 when the first image is read; ``"native"`` is the
  port's own decoder (``data/jpeg.py``: baseline JPEG and binary PPM/PGM,
  bit for bit cv2), for a machine without cv2; a caller may also pass any
  callable.
- ``rng``, the ``np.random.RandomState`` that every random transform
  draws from (the JAX package draws from numpy's global state; one explicit
  generator per dataset, drawn in the reference's order, gives the same
  draws from the same seed).

``Resize`` resizes with ``data/resize.py``, the distortion converts
colours with ``data/color.py`` and ``Albu`` runs ``data/albu_mini.py``
on ``data/imgproc.py``, all bit for bit cv2.

A pipeline run on ``results`` with ``lazy`` set decodes nothing: the image
is a ``LazyImage``, its shape and dtype known from ``img_info`` and each
transform's pixel work queued behind its draws, which never depend on the
pixels.  ``render()`` then decodes and applies the queue: the same
operations on the same draws, so the same bits as the eager run.  The
training loader plans whole samples this way and decodes only those whose
frames fit its canvas.
"""
from __future__ import annotations

import os.path as osp
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from .color import bgr2hsv_f32, hsv2bgr_f32
from .jpeg import imread_native
from .resize import resize_bilinear_f32, resize_bilinear_u8

Decoder = Callable[[str], np.ndarray]


def cv2_imread(path: str) -> np.ndarray:
    """The JAX package's decoder, ``cv2.imread(path, IMREAD_COLOR)``."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "cv2 is not installed: use the port's own decoder, 'native' "
            "(--decoder native on the CLIs; baseline JPEG and binary "
            "PPM/PGM), or pass a decoder, imread(path) -> (H, W, 3) uint8 "
            "BGR array, to the dataset or the CLI instead of 'cv2'"
        ) from e
    return cv2.imread(path, cv2.IMREAD_COLOR)


def resolve_decoder(imread: Union[str, Decoder]) -> Decoder:
    if imread == "cv2":
        return cv2_imread
    if imread == "native":
        return imread_native
    if not callable(imread):
        raise TypeError(f"imread must be 'cv2', 'native' or a callable, "
                        f"not {imread!r}")
    return imread


class LazyImage:
    """An image not decoded yet: ``load()`` gives it, ``shape`` and
    ``dtype`` are what the queued pixel operations leave."""

    def __init__(self, load: Callable[[], np.ndarray], shape, dtype,
                 ops=()):
        self.load = load
        self.shape = tuple(int(n) for n in shape)
        self.dtype = np.dtype(dtype)
        self.ops = tuple(ops)
        self.planned = self.shape if not ops else None

    def then(self, op: Callable[[np.ndarray], np.ndarray], shape=None,
             dtype=None) -> "LazyImage":
        out = LazyImage(self.load, self.shape if shape is None else shape,
                        self.dtype if dtype is None else dtype,
                        self.ops + (op,))
        out.planned = self.planned
        return out

    def render(self) -> np.ndarray:
        img = self.load()
        if img.shape != self.planned:
            raise ValueError(f"decoded {img.shape}, but the annotation "
                             f"says {self.planned}")
        for op in self.ops:
            img = op(img)
        return img


def pixels(img, op, shape=None, dtype=None):
    """``op(img)`` now, or queued on a ``LazyImage`` whose result has
    ``shape`` and ``dtype`` (default: unchanged)."""
    if isinstance(img, LazyImage):
        return img.then(op, shape, dtype)
    return op(img)


def render(img) -> np.ndarray:
    return img.render() if isinstance(img, LazyImage) else img


class Compose:
    def __init__(self, transforms: Sequence, rng=None,
                 imread: Union[str, Decoder] = "cv2"):
        self.transforms = [build_transform(t, rng, imread)
                           if isinstance(t, dict) else t for t in transforms]

    def __call__(self, results: Dict) -> Optional[Dict]:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


class LoadImageFromFile:
    def __init__(self, to_float32: bool = False,
                 imread: Union[str, Decoder] = "cv2"):
        self.to_float32 = to_float32
        self.imread = resolve_decoder(imread)

    def read(self, filename: str) -> np.ndarray:
        img = self.imread(filename)
        if img is None:
            raise FileNotFoundError(filename)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"the decoder returned {img.dtype} "
                             f"{img.shape} for {filename}, not (H, W, 3) "
                             f"uint8")
        return img.astype(np.float32) if self.to_float32 else img

    def __call__(self, results):
        filename = osp.join(results["img_prefix"],
                            results["img_info"]["filename"])
        if results.get("lazy"):
            info = results["img_info"]
            img = LazyImage(lambda: self.read(filename),
                            (info["height"], info["width"], 3),
                            np.float32 if self.to_float32 else np.uint8)
        else:
            img = self.read(filename)
        results["filename"] = filename
        results["img"] = img
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        return results


class LoadAnnotations:
    def __init__(self, with_bbox: bool = True, with_label: bool = True,
                 with_mask: bool = False, with_seg: bool = False):
        self.with_bbox = with_bbox
        self.with_label = with_label

    def __call__(self, results):
        ann = results["ann_info"]
        if self.with_bbox:
            results["gt_bboxes"] = ann["bboxes"].copy()
            results.setdefault("bbox_fields", []).append("gt_bboxes")
            if ann.get("bboxes_ignore") is not None:
                results["gt_bboxes_ignore"] = ann["bboxes_ignore"].copy()
                results["bbox_fields"].append("gt_bboxes_ignore")
        if self.with_label:
            results["gt_labels"] = ann["labels"].copy()
        return results


def rescale_size(h: int, w: int, scale) -> float:
    """mmcv.imrescale's factor: long edge ≤ max(scale), short ≤ min(scale)."""
    max_long, max_short = max(scale), min(scale)
    return min(max_long / max(h, w), max_short / min(h, w))


class Resize:
    def __init__(self, img_scale=(1000, 600), keep_ratio: bool = True,
                 multiscale_mode: str = "range", ratio_range=None):
        self.img_scale = img_scale
        self.keep_ratio = keep_ratio

    def __call__(self, results):
        img = results["img"]
        h, w = img.shape[:2]
        if self.keep_ratio:
            f = rescale_size(h, w, self.img_scale)
            new_w, new_h = int(w * f + 0.5), int(h * f + 0.5)
        else:
            new_w, new_h = self.img_scale
        resize = (resize_bilinear_f32 if img.dtype == np.float32
                  else resize_bilinear_u8)
        img = pixels(img, lambda a: resize(a, (new_w, new_h)),
                     (new_h, new_w) + img.shape[2:])
        w_scale, h_scale = new_w / w, new_h / h
        results["img"] = img
        results["img_shape"] = img.shape
        results["pad_shape"] = img.shape
        scale_factor = np.array([w_scale, h_scale, w_scale, h_scale],
                                np.float32)
        results["scale_factor"] = scale_factor
        results["keep_ratio"] = self.keep_ratio
        for key in results.get("bbox_fields", []):
            bboxes = results[key] * scale_factor
            bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, img.shape[1] - 1)
            bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, img.shape[0] - 1)
            results[key] = bboxes
        return results


class RandomFlip:
    """Draws once per image from ``rng`` whatever the ratio (the reference
    draws at ratio 0 too, and a video's frame order depends on it)."""

    def __init__(self, flip_ratio: float = 0.0, rng=None):
        self.flip_ratio = flip_ratio
        self.rng = rng if rng is not None else np.random.RandomState(0)

    def __call__(self, results):
        if "flip" not in results:
            results["flip"] = self.rng.rand() < self.flip_ratio
        if results["flip"]:
            results["img"] = pixels(
                results["img"],
                lambda a: np.ascontiguousarray(a[:, ::-1, :]))
            w = results["img_shape"][1]
            for key in results.get("bbox_fields", []):
                b = results[key].copy()
                b[..., 0::4] = w - results[key][..., 2::4] - 1
                b[..., 2::4] = w - results[key][..., 0::4] - 1
                results[key] = b
        return results


class Normalize:
    def __init__(self, mean, std, to_rgb: bool = False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def normalize(self, img: np.ndarray) -> np.ndarray:
        img = img.astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        return (img - self.mean) / self.std

    def __call__(self, results):
        results["img"] = pixels(results["img"], self.normalize,
                                dtype=np.float32)
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


class Pad:
    def __init__(self, size=None, size_divisor: Optional[int] = None,
                 pad_val: float = 0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        img = results["img"]
        h, w = img.shape[:2]
        if self.size is not None:
            ph, pw = self.size
        else:
            d = self.size_divisor
            ph, pw = -(-h // d) * d, -(-w // d) * d
        def pad(a):
            out = np.full((ph, pw, a.shape[2]), self.pad_val, a.dtype)
            out[:h, :w] = a
            return out

        out = pixels(img, pad, (ph, pw, img.shape[2]))
        results["img"] = out
        results["pad_shape"] = out.shape
        results["pad_fixed_size"] = self.size
        results["pad_size_divisor"] = self.size_divisor
        return results


class PhotoMetricDistortion:
    """Brightness, contrast, saturation and hue jitter and a channel swap
    on a float32 image, each applied with probability 1/2 (mmdet
    ``transforms.py:430``), the contrast before or after the HSV step."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18, rng=None):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta
        self.rng = rng if rng is not None else np.random.RandomState(0)

    def __call__(self, results):
        rng = self.rng
        brightness = contrast = saturation = hue = perm = None
        if rng.randint(2):
            brightness = rng.uniform(-self.brightness_delta,
                                     self.brightness_delta)
        mode = rng.randint(2)
        if mode == 1 and rng.randint(2):
            contrast = rng.uniform(self.contrast_lower, self.contrast_upper)
        if rng.randint(2):
            saturation = rng.uniform(self.saturation_lower,
                                     self.saturation_upper)
        if rng.randint(2):
            hue = rng.uniform(-self.hue_delta, self.hue_delta)
        if mode == 0 and rng.randint(2):
            contrast = rng.uniform(self.contrast_lower, self.contrast_upper)
        if rng.randint(2):
            perm = rng.permutation(3)

        def distort(img):
            img = img.astype(np.float32)
            if brightness is not None:
                img = img + brightness
            if mode == 1 and contrast is not None:
                img = img * contrast
            hsv = bgr2hsv_f32(np.clip(img, 0, 255).astype(np.float32)
                              / 255.0)
            if saturation is not None:
                hsv[..., 1] *= saturation
            if hue is not None:
                hsv[..., 0] += hue
                hsv[..., 0][hsv[..., 0] > 360] -= 360
                hsv[..., 0][hsv[..., 0] < 0] += 360
            hsv[..., 1] = np.clip(hsv[..., 1], 0, 1)
            img = hsv2bgr_f32(hsv) * 255.0
            if mode == 0 and contrast is not None:
                img = img * contrast
            if perm is not None:
                img = img[..., perm]
            return img

        results["img"] = pixels(results["img"], distort, dtype=np.float32)
        return results


class Expand:
    """Paste the image onto a canvas ``ratio`` times larger filled with
    the mean, with probability 1/2 (mmdet ``transforms.py:519``)."""

    def __init__(self, mean=(0, 0, 0), to_rgb=False, ratio_range=(1, 4),
                 rng=None):
        self.mean = mean if not to_rgb else mean[::-1]
        self.min_ratio, self.max_ratio = ratio_range
        self.rng = rng if rng is not None else np.random.RandomState(0)

    def __call__(self, results):
        rng = self.rng
        if rng.randint(2):
            return results
        img = results["img"]
        h, w, c = img.shape
        ratio = rng.uniform(self.min_ratio, self.max_ratio)
        shape = (int(h * ratio), int(w * ratio), c)
        left = int(rng.uniform(0, w * ratio - w))
        top = int(rng.uniform(0, h * ratio - h))

        def paste(a):
            out = np.full(shape, self.mean, dtype=a.dtype)
            out[top:top + h, left:left + w] = a
            return out

        expand = pixels(img, paste, shape)
        results["img"] = expand
        results["img_shape"] = expand.shape
        if "gt_bboxes" in results:
            results["gt_bboxes"] = results["gt_bboxes"] + np.tile(
                (left, top), 2).astype(results["gt_bboxes"].dtype)
        return results


def _iou_patch(patch: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one patch against each box, +1 pixel extents (mmdet's numpy
    ``bbox_overlaps``)."""
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.float32)
    lt = np.maximum(patch[:2], boxes[:, :2])
    rb = np.minimum(patch[2:], boxes[:, 2:4])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    a1 = (patch[2] - patch[0] + 1) * (patch[3] - patch[1] + 1)
    a2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (a1 + a2 - inter)


class MinIoURandomCrop:
    """SSD's crop: a random patch whose IoU with every box reaches a
    randomly chosen minimum, keeping the boxes whose centres it holds
    (mmdet ``transforms.py:595``).  The offsets are drawn as mmdet draws
    them, ``uniform(w - new_w)``: one argument, the LOW bound, with the
    default high of 1.0."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size=0.3,
                 rng=None):
        self.sample_mode = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size
        self.rng = rng if rng is not None else np.random.RandomState(0)

    def __call__(self, results):
        rng = self.rng
        img = results["img"]
        boxes = results.get("gt_bboxes")
        labels = results.get("gt_labels")
        h, w, c = img.shape
        while True:
            mode = self.sample_mode[rng.randint(len(self.sample_mode))]
            if mode == 1:
                return results
            min_iou = mode
            for _ in range(50):
                new_w = rng.uniform(self.min_crop_size * w, w)
                new_h = rng.uniform(self.min_crop_size * h, h)
                if new_h / new_w < 0.5 or new_h / new_w > 2:
                    continue
                left = rng.uniform(w - new_w)
                top = rng.uniform(h - new_h)
                patch = np.array([int(left), int(top),
                                  int(left + new_w), int(top + new_h)])
                if boxes is not None and boxes.shape[0] > 0:
                    overlaps = _iou_patch(patch.astype(np.float32), boxes)
                    if overlaps.min() < min_iou:
                        continue
                    centers = (boxes[:, :2] + boxes[:, 2:4]) / 2
                    m = ((centers[:, 0] > patch[0])
                         * (centers[:, 1] > patch[1])
                         * (centers[:, 0] < patch[2])
                         * (centers[:, 1] < patch[3]))
                    if not m.any():
                        continue
                    b = boxes[m].copy()
                    b[:, 2:4] = np.minimum(b[:, 2:4], patch[2:])
                    b[:, :2] = np.maximum(b[:, :2], patch[:2])
                    b -= np.tile(patch[:2], 2)
                    results["gt_bboxes"] = b
                    if labels is not None:
                        results["gt_labels"] = labels[m]
                window = (slice(patch[1], patch[3]),
                          slice(patch[0], patch[2]))
                shape = np.broadcast_to(np.uint8(0), img.shape)[window].shape
                img = pixels(img, lambda a: a[window], shape)
                results["img"] = img
                results["img_shape"] = img.shape
                return results


class LoadProposals:
    """Precomputed proposals on the sample (mmdet ``loading.py:131``): the
    first four columns of ``results["proposals"]`` ((n, 4) or (n, 5)), at
    most ``num_max_proposals`` of them, one all-zero box when none is left,
    added to ``bbox_fields``.  A sample without proposals passes as it
    is."""

    def __init__(self, num_max_proposals: Optional[int] = None):
        self.num_max_proposals = num_max_proposals

    def __call__(self, results):
        proposals = results.get("proposals")
        if proposals is None:
            return results
        if proposals.shape[1] not in (4, 5):
            raise AssertionError(
                f"proposals should be (n, 4|5), got {proposals.shape}")
        proposals = proposals[:, :4]
        if self.num_max_proposals is not None:
            proposals = proposals[:self.num_max_proposals]
        if len(proposals) == 0:
            proposals = np.array([[0, 0, 0, 0]], np.float32)
        results["proposals"] = proposals
        results.setdefault("bbox_fields", []).append("proposals")
        return results


class Albu:
    """The albumentations bridge (mmdet ``transforms.py:705-817``) on the
    port's own backend (``data/albu_mini.py``): probability gates,
    pascal_voc boxes, ``min_visibility``, and with ``filter_lost_elements``
    in ``bbox_params`` the label fields re-indexed by the boxes that
    survive (an index field rides with the boxes in their place); a sample
    left with no box is dropped (None) under ``skip_img_without_anno``.
    Draws from the pipeline's ``rng`` in the JAX package's order.  A
    planned image is decoded first: the transforms need its pixels."""

    def __init__(self, transforms, bbox_params=None, keymap=None,
                 update_pad_shape=False, skip_img_without_anno=False,
                 rng=None):
        from .albu_mini import AlbuCompose
        self.filter_lost_elements = False
        self.update_pad_shape = update_pad_shape
        self.skip_img_without_anno = skip_img_without_anno
        bbox_params = dict(bbox_params) if bbox_params else None
        if (isinstance(bbox_params, dict) and "label_fields" in bbox_params
                and "filter_lost_elements" in bbox_params):
            self.filter_lost_elements = True
            self.origin_label_fields = list(bbox_params["label_fields"])
            bbox_params = dict(bbox_params, label_fields=["idx_mapper"])
            del bbox_params["filter_lost_elements"]
        rng = rng if rng is not None else np.random.RandomState(0)
        self.aug = AlbuCompose(transforms, bbox_params, rng)
        self.keymap_to_albu = keymap or {"img": "image",
                                         "gt_bboxes": "bboxes"}
        self.keymap_back = {v: k for k, v in self.keymap_to_albu.items()}

    @staticmethod
    def mapper(d, keymap):
        return {keymap.get(k, k): v for k, v in d.items()}

    def __call__(self, results):
        results["img"] = render(results["img"])
        data = self.mapper(results, self.keymap_to_albu)
        had_boxes = "bboxes" in data
        if self.filter_lost_elements and had_boxes:
            data["idx_mapper"] = np.arange(len(data["bboxes"]))
        kw = {k: data[k] for k in ("image", "bboxes", "idx_mapper")
              if k in data}
        # label fields move with the boxes (the reference hands the whole
        # results dict to albumentations)
        for f in self.aug.label_fields:
            if f in data and f not in kw:
                kw[f] = data[f]
        data.update(self.aug(**kw))
        if self.filter_lost_elements and had_boxes:
            idx = np.asarray(data.pop("idx_mapper"), int)
            for f in self.origin_label_fields:
                data[f] = np.asarray(data[f])[idx]
            if not len(data["bboxes"]) and self.skip_img_without_anno:
                return None
        if had_boxes:
            data["bboxes"] = np.asarray(data["bboxes"],
                                        np.float32).reshape(-1, 4)
        results = self.mapper(data, self.keymap_back)
        results["img_shape"] = results["img"].shape
        if self.update_pad_shape:
            results["pad_shape"] = results["img"].shape
        return results


class MultiScaleFlipAug:
    """The reference's ``test_aug.py:8``: one sample expanded into its
    scale × flip augmentations, a LIST of results dicts (one per
    augmentation, scales outer, unflipped first), which the caller merges
    with ``core/merge_augs.py``.  Each scale runs ``transforms`` with its
    ``Resize`` rebuilt at that scale; ``flip`` is set before the
    transforms, so a ``RandomFlip`` among them follows it without
    drawing."""

    def __init__(self, transforms, img_scale, flip: bool = False, rng=None,
                 imread: Union[str, Decoder] = "cv2"):
        self.transforms = Compose(transforms, rng, imread)
        self.img_scales = (img_scale if isinstance(img_scale, list)
                           else [img_scale])
        self.flip = flip

    def __call__(self, results):
        augs = []
        for scale in self.img_scales:
            for flip in ([False, True] if self.flip else [False]):
                out = dict(results, img=pixels(results["img"], np.copy),
                           scale_override=tuple(scale), flip=flip)
                for t in self.transforms.transforms:
                    if isinstance(t, Resize):
                        t = Resize(img_scale=tuple(scale),
                                   keep_ratio=t.keep_ratio)
                    out = t(out)
                    if out is None:
                        break
                if out is not None:
                    augs.append(out)
        return augs


class ImageToTensor:
    """Arrays stay numpy on the host; the stream moves the canvas."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        return results


class DefaultFormatBundle:
    def __call__(self, results):
        return results


class Collect:
    def __init__(self, keys, meta_keys=("filename", "ori_shape", "img_shape",
                                        "pad_shape", "scale_factor", "flip",
                                        "img_norm_cfg")):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        data = {k: results[k] for k in self.keys if k in results}
        data["img_meta"] = {k: results.get(k) for k in self.meta_keys}
        return data


TRANSFORMS = {
    "LoadImageFromFile": LoadImageFromFile,
    "LoadAnnotations": LoadAnnotations,
    "Resize": Resize,
    "RandomFlip": RandomFlip,
    "Normalize": Normalize,
    "Pad": Pad,
    "PhotoMetricDistortion": PhotoMetricDistortion,
    "Expand": Expand,
    "MinIoURandomCrop": MinIoURandomCrop,
    "ImageToTensor": ImageToTensor,
    "DefaultFormatBundle": DefaultFormatBundle,
    "Collect": Collect,
    "MultiScaleFlipAug": MultiScaleFlipAug,
    "LoadProposals": LoadProposals,
    "Albu": Albu,
}

# the transforms that draw from the dataset's generator
RANDOM = ("RandomFlip", "PhotoMetricDistortion", "Expand",
          "MinIoURandomCrop", "Albu")

# the JAX package's augmentation transforms still to port, and the ROADMAP
# item that ports each
NOT_PORTED = {
    "Corrupt": "Queue 1 item 9",
}


def build_transform(cfg: Dict, rng=None,
                    imread: Union[str, Decoder] = "cv2"):
    cfg = dict(cfg)
    t = cfg.pop("type")
    if t in NOT_PORTED:
        raise NotImplementedError(f"transform {t} is not ported yet "
                                  f"(ROADMAP {NOT_PORTED[t]})")
    if t not in TRANSFORMS:
        raise KeyError(f"unknown transform {t}")
    if t in RANDOM:
        cfg["rng"] = rng
    elif t == "LoadImageFromFile":
        cfg["imread"] = imread
    elif t == "MultiScaleFlipAug":
        cfg.update(rng=rng, imread=imread)
    return TRANSFORMS[t](**cfg)
