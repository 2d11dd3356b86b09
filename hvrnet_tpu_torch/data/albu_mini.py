"""The ``Albu`` transform's backend (counterpart of
``hvrnet_tpu/data/albu_mini.py``): the albumentations transforms that
mmdet-era configs use (flips, ``ShiftScaleRotate``,
``RandomBrightnessContrast``, ``ChannelShuffle``, ``Blur`` /
``MedianBlur``, ``GaussNoise``, ``HueSaturationValue``,
``RandomRotate90``, ``OneOf``) with albumentations' conventions: a
probability gate per transform, absolute pascal_voc boxes,
``min_visibility`` filtering and label fields that move with the boxes.

Every draw comes from the ``np.random.RandomState`` handed to
``build_albu`` / ``AlbuCompose`` (the pipeline's, shared with the other
random transforms), in the JAX package's order, which draws from numpy's
global state: seeding that with the same seed gives the same draws.  The
cv2 calls are ``data/imgproc.py`` and ``data/color.py``, bit for bit cv2
5.0, so no image library is imported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .color import bgr2hsv_u8, hsv2bgr_u8
from .imgproc import (BORDER_REFLECT_101, INTER_LINEAR, blur, median_blur,
                      rotation_matrix_2d, warp_affine)

ALBU_TRANSFORMS = {}


def register(cls):
    ALBU_TRANSFORMS[cls.__name__] = cls
    return cls


def _pair(v):
    return (-v, v) if np.isscalar(v) else (v[0], v[1])


def _pair_float(v):
    return (-v, v) if np.isscalar(v) else (float(v[0]), float(v[1]))


class _Transform:
    """A probability gate around ``apply``; ``force`` applies it without
    the gate (``OneOf``'s pick)."""

    def __init__(self, p: float = 0.5, rng=None, **unused):
        self.p = float(p)
        self.rng = rng if rng is not None else np.random.RandomState(0)

    # data: dict(image=..., bboxes=(n, 4) float absolute, label fields)
    def __call__(self, data: Dict) -> Dict:
        if self.rng.rand() < self.p:
            data = self.apply(data)
        return data

    def force(self, data: Dict) -> Dict:
        return self.apply(data)

    def apply(self, data: Dict) -> Dict:
        raise NotImplementedError


@register
class HorizontalFlip(_Transform):
    def apply(self, data):
        img = data["image"]
        data["image"] = np.ascontiguousarray(img[:, ::-1])
        if len(data["bboxes"]):
            b = data["bboxes"].copy()
            b[:, [0, 2]] = img.shape[1] - data["bboxes"][:, [2, 0]]
            data["bboxes"] = b
        return data


@register
class VerticalFlip(_Transform):
    def apply(self, data):
        img = data["image"]
        data["image"] = np.ascontiguousarray(img[::-1])
        if len(data["bboxes"]):
            b = data["bboxes"].copy()
            b[:, [1, 3]] = img.shape[0] - data["bboxes"][:, [3, 1]]
            data["bboxes"] = b
        return data


@register
class RandomRotate90(_Transform):
    def apply(self, data):
        k = self.rng.randint(0, 4)
        img = data["image"]
        h, w = img.shape[:2]
        data["image"] = np.ascontiguousarray(np.rot90(img, k))
        b = data["bboxes"]
        for _ in range(k):      # one counter-clockwise quarter turn each
            if len(b):
                x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
                b = np.stack([y1, w - x2, y2, w - x1], axis=1)
            h, w = w, h
        data["bboxes"] = b
        return data


@register
class RandomBrightnessContrast(_Transform):
    def __init__(self, brightness_limit=0.2, contrast_limit=0.2,
                 brightness_by_max=True, p=0.5, rng=None, **unused):
        super().__init__(p, rng)
        self.brightness_limit = _pair_float(brightness_limit)
        self.contrast_limit = _pair_float(contrast_limit)
        self.brightness_by_max = brightness_by_max

    def apply(self, data):
        alpha = 1.0 + self.rng.uniform(*self.contrast_limit)
        beta = self.rng.uniform(*self.brightness_limit)
        img = data["image"].astype(np.float32)
        max_v = 255.0 if data["image"].dtype == np.uint8 else 1.0
        # the shift is beta times the maximum (brightness_by_max) or the mean
        shift = beta * (max_v if self.brightness_by_max else img.mean())
        out = img * alpha + shift
        if data["image"].dtype == np.uint8:
            out = np.clip(out, 0, 255).astype(np.uint8)
        data["image"] = out
        return data


@register
class ChannelShuffle(_Transform):
    def apply(self, data):
        perm = self.rng.permutation(data["image"].shape[2])
        data["image"] = np.ascontiguousarray(data["image"][:, :, perm])
        return data


@register
class Blur(_Transform):
    def __init__(self, blur_limit=7, p=0.5, rng=None, **unused):
        super().__init__(p, rng)
        self.blur_limit = (3, blur_limit) if np.isscalar(blur_limit) \
            else tuple(blur_limit)

    def _ksize(self):
        lo, hi = self.blur_limit
        ks = self.rng.randint(lo, hi + 1)
        return ks + 1 - ks % 2      # odd

    def apply(self, data):
        data["image"] = blur(data["image"], self._ksize())
        return data


@register
class MedianBlur(Blur):
    def apply(self, data):
        img = data["image"]
        as_u8 = img.dtype != np.uint8
        if as_u8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        out = median_blur(img, self._ksize())
        data["image"] = out.astype(data["image"].dtype) if as_u8 else out
        return data


@register
class GaussNoise(_Transform):
    def __init__(self, var_limit=(10.0, 50.0), mean=0.0, p=0.5, rng=None,
                 **unused):
        super().__init__(p, rng)
        self.var_limit = (0, var_limit) if np.isscalar(var_limit) \
            else tuple(var_limit)
        self.mean = mean

    def apply(self, data):
        var = self.rng.uniform(*self.var_limit)
        noise = self.rng.normal(self.mean, var ** 0.5,
                                data["image"].shape).astype(np.float32)
        img = data["image"].astype(np.float32) + noise
        if data["image"].dtype == np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        data["image"] = img
        return data


@register
class HueSaturationValue(_Transform):
    """The shifts are drawn as floats and rounded with Python's ``round``
    (half to even), as the JAX transform rounds them."""

    def __init__(self, hue_shift_limit=20, sat_shift_limit=30,
                 val_shift_limit=20, p=0.5, rng=None, **unused):
        super().__init__(p, rng)
        self.h = _pair(hue_shift_limit)
        self.s = _pair(sat_shift_limit)
        self.v = _pair(val_shift_limit)

    def apply(self, data):
        img = data["image"]
        as_f = img.dtype != np.uint8
        u8 = np.clip(img, 0, 255).astype(np.uint8) if as_f else img
        hsv = bgr2hsv_u8(u8).astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + round(self.rng.uniform(*self.h))) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + round(self.rng.uniform(*self.s)),
                              0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] + round(self.rng.uniform(*self.v)),
                              0, 255)
        out = hsv2bgr_u8(hsv.astype(np.uint8))
        data["image"] = out.astype(img.dtype) if as_f else out
        return data


@register
class ShiftScaleRotate(_Transform):
    """Bilinear with reflected borders only: ``data/imgproc.py`` reproduces
    cv2's ``warpAffine`` for that pair, and any other raises."""

    def __init__(self, shift_limit=0.0625, scale_limit=0.1, rotate_limit=45,
                 interpolation=INTER_LINEAR, border_mode=BORDER_REFLECT_101,
                 p=0.5, rng=None, **unused):
        super().__init__(p, rng)
        if interpolation != INTER_LINEAR or border_mode != BORDER_REFLECT_101:
            raise NotImplementedError(
                f"ShiftScaleRotate takes interpolation {INTER_LINEAR} "
                f"(INTER_LINEAR) with border_mode {BORDER_REFLECT_101} "
                f"(BORDER_REFLECT_101) only, not {interpolation} with "
                f"{border_mode}")
        self.shift = _pair(shift_limit)
        self.scale = _pair(scale_limit)
        self.rot = _pair(rotate_limit)

    def apply(self, data):
        img = data["image"]
        h, w = img.shape[:2]
        angle = self.rng.uniform(*self.rot)
        scale = 1.0 + self.rng.uniform(*self.scale)
        dx = self.rng.uniform(*self.shift) * w
        dy = self.rng.uniform(*self.shift) * h
        M = rotation_matrix_2d((w / 2, h / 2), angle, scale)
        M[0, 2] += dx
        M[1, 2] += dy
        data["image"] = warp_affine(img, M, (w, h))
        b = data["bboxes"]
        if len(b):
            # the corners mapped, then their axis-aligned envelope
            corners = np.stack([b[:, [0, 1]], b[:, [2, 1]],
                                b[:, [0, 3]], b[:, [2, 3]]], axis=1)
            ones = np.ones((*corners.shape[:2], 1), np.float32)
            pts = np.concatenate([corners, ones], axis=2) @ M.T
            data["bboxes"] = np.concatenate(
                [pts.min(axis=1), pts.max(axis=1)], axis=1).astype(np.float32)
        return data


@register
class OneOf:
    """One member, drawn by the members' ``p`` as weights, run without its
    gate."""

    def __init__(self, transforms: Sequence, p: float = 0.5, rng=None,
                 **unused):
        self.p = float(p)
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.members = [build_albu(t, self.rng) for t in transforms]
        ps = np.asarray([m.p for m in self.members], np.float64)
        self.weights = ps / ps.sum() if ps.sum() > 0 else None

    def __call__(self, data):
        if self.members and self.rng.rand() < self.p:
            data = self.force(data)
        return data

    def force(self, data):
        if not self.members:
            return data
        idx = self.rng.choice(len(self.members), p=self.weights)
        return self.members[idx].force(data)


def build_albu(cfg: Dict, rng=None):
    cfg = dict(cfg)
    t = cfg.pop("type")
    if t not in ALBU_TRANSFORMS:
        raise KeyError(f"albu_mini does not implement {t!r}; available: "
                       f"{sorted(ALBU_TRANSFORMS)}")
    return ALBU_TRANSFORMS[t](rng=rng, **cfg)


class AlbuCompose:
    """albumentations' ``Compose`` with pascal_voc ``bbox_params``."""

    def __init__(self, transforms: Sequence[Dict],
                 bbox_params: Optional[Dict] = None, rng=None):
        self.transforms = [build_albu(t, rng) for t in transforms]
        bbox_params = dict(bbox_params or {})
        bbox_params.pop("type", None)
        fmt = bbox_params.get("format", "pascal_voc")
        if fmt != "pascal_voc":
            raise ValueError(f"only pascal_voc boxes are supported, not "
                             f"{fmt}")
        self.min_visibility = float(bbox_params.get("min_visibility", 0.0))
        self.label_fields: List[str] = list(bbox_params.get("label_fields",
                                                            []))

    def __call__(self, **data):
        data.setdefault("bboxes", np.zeros((0, 4), np.float32))
        data["bboxes"] = np.asarray(data["bboxes"], np.float32).reshape(-1, 4)
        for t in self.transforms:
            data = t(data)
        # clip, then keep the boxes whose clipped area is at least
        # min_visibility of their transformed area before the clip
        h, w = data["image"].shape[:2]
        b = data["bboxes"]
        if len(b):
            pre_clip = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            b = b.copy()
            b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
            b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
            area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            vis = np.where(pre_clip > 0, area / np.maximum(pre_clip, 1e-6), 0)
            keep = (area > 0) & (vis >= self.min_visibility)
            data["bboxes"] = b[keep]
            for f in self.label_fields:
                if f in data:
                    data[f] = np.asarray(data[f])[keep]
        return data
