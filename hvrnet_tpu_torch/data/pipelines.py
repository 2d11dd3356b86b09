"""Host-side test pipeline (counterpart of ``hvrnet_tpu/data/pipelines.py``,
the transforms a test config names): load, keep-ratio resize, flip,
normalise, pad, collect.  numpy only.

Two things the caller hands in rather than the module importing them:
- ``imread(path) -> (H, W, 3) uint8 BGR``, the image decoder.  The default
  ``"cv2"`` imports cv2 when the first image is read; a machine without
  cv2 passes its own decoder.
- ``rng``, the ``np.random.RandomState`` that ``RandomFlip`` draws from
  (the JAX package draws from numpy's global state; one explicit generator
  per dataset gives the same draws from the same seed).

``Resize`` resizes with ``data/resize.py``, bit for bit cv2's bilinear.
The training-only transforms are not ported yet and raise.
"""
from __future__ import annotations

import os.path as osp
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from .resize import resize_bilinear_u8

Decoder = Callable[[str], np.ndarray]


def cv2_imread(path: str) -> np.ndarray:
    """The JAX package's decoder, ``cv2.imread(path, IMREAD_COLOR)``."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "cv2 is not installed: pass a decoder, imread(path) -> (H, W, 3) "
            "uint8 BGR array, to the dataset or the CLI instead of 'cv2'"
        ) from e
    return cv2.imread(path, cv2.IMREAD_COLOR)


def resolve_decoder(imread: Union[str, Decoder]) -> Decoder:
    if imread == "cv2":
        return cv2_imread
    if not callable(imread):
        raise TypeError(f"imread must be 'cv2' or a callable, not {imread!r}")
    return imread


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
        if to_float32:
            raise NotImplementedError(
                "LoadImageFromFile(to_float32=True) feeds the training "
                "pipeline, which is not ported yet (ROADMAP Queue 1 item 6)")
        self.imread = resolve_decoder(imread)

    def __call__(self, results):
        filename = osp.join(results["img_prefix"],
                            results["img_info"]["filename"])
        img = self.imread(filename)
        if img is None:
            raise FileNotFoundError(filename)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"the decoder returned {img.dtype} "
                             f"{img.shape} for {filename}, not (H, W, 3) "
                             f"uint8")
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
        img = resize_bilinear_u8(img, (new_w, new_h))
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
            results["img"] = np.ascontiguousarray(results["img"][:, ::-1, :])
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

    def __call__(self, results):
        img = results["img"].astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        results["img"] = (img - self.mean) / self.std
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
        out = np.full((ph, pw, img.shape[2]), self.pad_val, img.dtype)
        out[:h, :w] = img
        results["img"] = out
        results["pad_shape"] = out.shape
        results["pad_fixed_size"] = self.size
        results["pad_size_divisor"] = self.size_divisor
        return results


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
    "ImageToTensor": ImageToTensor,
    "DefaultFormatBundle": DefaultFormatBundle,
    "Collect": Collect,
}

# the JAX package's training and augmentation transforms, and the ROADMAP
# item that ports each
NOT_PORTED = {
    "PhotoMetricDistortion": "Queue 1 item 6",
    "Expand": "Queue 1 item 6",
    "MinIoURandomCrop": "Queue 1 item 6",
    "Corrupt": "Queue 1 item 8",
    "Albu": "Queue 1 item 8",
    "LoadProposals": "Queue 1 item 8",
    "MultiScaleFlipAug": "Queue 1 item 5",
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
    if t == "RandomFlip":
        cfg["rng"] = rng
    elif t == "LoadImageFromFile":
        cfg["imread"] = imread
    return TRANSFORMS[t](**cfg)
