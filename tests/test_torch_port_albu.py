"""The port's ``Albu`` backend against cv2 and the JAX package.

- ``data/imgproc.py`` and the uint8 HSV pair of ``data/color.py`` against
  cv2 (5.0), bit for bit: the uint8 box blur at every window sum
  for each odd size ``Blur`` draws at its limits up to 15, the float32
  blur, the median, every BGR value through ``BGR2HSV`` and every HSV
  value (H < 180) through ``HSV2BGR`` on both of cv2's routes,
  ``getRotationMatrix2D``, and ``warpAffine`` on random rotations,
  sub-pixel shifts on the 1/32 grid and off it, 1-pixel sources and other
  output sizes, uint8 and float32;
- each ``albu_mini`` transform, ``OneOf`` and ``AlbuCompose`` against
  ``hvrnet_tpu/data/albu_mini.py`` with numpy's global state seeded as the
  port's ``RandomState``: outputs bitwise, and the port's generator left
  where the global state is.
"""
import zlib

import cv2
import numpy as np
import pytest
import torch

from hvrnet_tpu.data import albu_mini as jax_albu
from hvrnet_tpu_torch.data import albu_mini, imgproc
from hvrnet_tpu_torch.data.color import bgr2hsv_u8, hsv2bgr_u8

torch.set_num_threads(2)


def np_states_equal(a, b):
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2:] == b[2:]


# -------------------------------------------------------------- imgproc
def sum_blocks(k):
    """An image of k × k blocks, one per window sum 0 .. 255·k², the sum's
    pixels shuffled within the block; the window centred on a block is the
    block.  Returns the image and the sums in block order."""
    d = k * k
    s = np.arange(255 * d + 1)
    q, r = s // d, s % d
    vals = (q[:, None] + (np.arange(d)[None] < r[:, None])).astype(np.uint8)
    vals = np.random.default_rng(k).permuted(vals, axis=1)
    cols = 101
    rows = -(-len(s) // cols)
    vals = np.concatenate([vals, np.zeros((rows * cols - len(s), d),
                                          np.uint8)])
    img = vals.reshape(rows, cols, k, k).transpose(0, 2, 1, 3)
    return img.reshape(rows * k, cols * k), s


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 13, 15])
def test_blur_u8_every_window_sum(k):
    """The uint8 blur's output is a function of the window's integer sum:
    every sum at ``k`` (the centres of ``sum_blocks``), and random images
    with borders, equal cv2's."""
    img, s = sum_blocks(k)
    got = imgproc.blur(img, k)
    want = cv2.blur(img, (k, k))
    np.testing.assert_array_equal(got, want)
    centre = got[k // 2::k, k // 2::k].reshape(-1)[:len(s)]
    np.testing.assert_array_equal(centre, (2 * s + k * k) // (2 * k * k))
    rng = np.random.default_rng(k)
    for shape in ((1, 1, 3), (2, 5, 3), (k + 1, 3 * k, 3), (37, 53),
                  (64, 97, 3)):
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(imgproc.blur(x, k), cv2.blur(x, (k, k)))


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
def test_blur_f32(k):
    rng = np.random.default_rng(k)
    for x in (rng.integers(0, 256, (41, 67, 3)).astype(np.float32),
              (rng.random((40, 33, 3)) * 255).astype(np.float32),
              (rng.standard_normal((29, 45)) * 10.0 ** rng.integers(
                  -6, 4, (29, 45))).astype(np.float32),
              rng.random((3, 2, 3)).astype(np.float32)):
        np.testing.assert_array_equal(imgproc.blur(x, k), cv2.blur(x, (k, k)))


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
def test_median_blur(k):
    rng = np.random.default_rng(k)
    for shape in ((1, 1, 3), (2, 3, 3), (5, 4, 3), (37, 61, 3), (130, 7, 3),
                  (50, 41)):
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(imgproc.median_blur(x, k),
                                      cv2.medianBlur(x, k))
    x = (rng.integers(0, 4, (70, 90, 3)) * 85).astype(np.uint8)   # ties
    np.testing.assert_array_equal(imgproc.median_blur(x, k),
                                  cv2.medianBlur(x, k))


def test_bgr2hsv_u8_every_value():
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    for r0 in range(0, 4096, 512):
        part = img[r0:r0 + 512]
        np.testing.assert_array_equal(bgr2hsv_u8(part),
                                      cv2.cvtColor(part, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [256, 31, 100])
def test_hsv2bgr_u8_every_value(width):
    """Every HSV value with H < 180 at a width of vectors only (256), of
    the scalar tail only (31) and of both (100)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 3)
    n = len(hsv) // width * width
    img = np.concatenate([hsv[:n], hsv[-width:]]).reshape(-1, width, 3)
    for r0 in range(0, len(img), 4096):
        part = img[r0:r0 + 4096]
        np.testing.assert_array_equal(hsv2bgr_u8(part),
                                      cv2.cvtColor(part, cv2.COLOR_HSV2BGR))
    with pytest.raises(ValueError, match="below 180"):
        hsv2bgr_u8(np.full((1, 1, 3), 180, np.uint8))


def test_rotation_matrix_2d():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        h, w = rng.integers(1, 1500, 2)
        args = ((w / 2, h / 2), rng.uniform(-180, 180), rng.uniform(0.5, 1.5))
        np.testing.assert_array_equal(imgproc.rotation_matrix_2d(*args),
                                      cv2.getRotationMatrix2D(*args))


def warp_cases():
    rng = np.random.default_rng(0)
    for i in range(24):
        h, w = (int(n) for n in rng.integers(1, 140, 2))
        M = imgproc.rotation_matrix_2d((w / 2, h / 2), rng.uniform(-90, 90),
                                       1 + rng.uniform(-0.4, 0.4))
        M[:, 2] += rng.uniform(-0.3, 0.3, 2) * (w, h)
        dsize = (w, h) if i % 3 else tuple(int(n) for n in
                                            rng.integers(1, 150, 2))
        yield f"rotation{i}", (h, w), M, dsize
    for k in range(-33, 34, 3):          # shifts on the 1/32 grid
        M = np.float64([[1, 0, k / 32], [0, 1, -k / 64]])
        yield f"shift{k}/32", (37, 70), M, (70, 37)
    for t in (0.1, 1 / 3, -0.49, 1e-7, 5.5):     # and off it
        yield (f"shift{t}", (20, 47), np.float64([[1, 0, t], [0, 1, t]]),
               (47, 20))
    yield "identity", (33, 48), np.float64([[1, 0, 0], [0, 1, 0]]), (48, 33)
    yield ("one column", (9, 1),
           np.float64([[0.9, 0.1, 0.3], [-0.1, 1, 2]]), (17, 9))


@pytest.mark.parametrize("name,hw,M,dsize", list(warp_cases()),
                         ids=[c[0] for c in warp_cases()])
def test_warp_affine(name, hw, M, dsize):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    u8 = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    f32 = u8.astype(np.float32) + rng.random(u8.shape, np.float32)
    for img in (u8, f32, u8[..., 0], f32[..., 1]):
        want = cv2.warpAffine(img, M, dsize, flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_REFLECT_101)
        np.testing.assert_array_equal(imgproc.warp_affine(img, M, dsize),
                                      want)


def test_warp_affine_refuses_other_modes():
    img = np.zeros((4, 4, 3), np.uint8)
    M = np.float64([[1, 0, 0], [0, 1, 0]])
    for flags, border in ((cv2.INTER_NEAREST, cv2.BORDER_REFLECT_101),
                          (cv2.INTER_LINEAR, cv2.BORDER_CONSTANT)):
        with pytest.raises(NotImplementedError, match="INTER_LINEAR"):
            imgproc.warp_affine(img, M, (4, 4), flags, border)
    with pytest.raises(NotImplementedError, match="BORDER_REFLECT_101"):
        albu_mini.build_albu(dict(type="ShiftScaleRotate", border_mode=0))


# ------------------------------------------------------------ albu_mini
def albu_data(seed, dtype=np.uint8, h=53, w=71):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if dtype == np.float32:
        img = img.astype(np.float32) + rng.random(img.shape, np.float32)
    boxes = np.float32([[5, 6, 30, 40], [20, 2, 60, 20], [0, 30, 70, 52],
                        [50, 40, 69, 51]])
    return dict(image=img, bboxes=boxes, gt_labels=np.int64([3, 7, 1, 2]))


TRANSFORMS = {
    "HorizontalFlip": dict(type="HorizontalFlip"),
    "VerticalFlip": dict(type="VerticalFlip"),
    "RandomRotate90": dict(type="RandomRotate90"),
    "RandomBrightnessContrast": dict(type="RandomBrightnessContrast",
                                     brightness_limit=[0.1, 0.3],
                                     contrast_limit=[0.1, 0.3]),
    "RandomBrightnessContrast mean": dict(type="RandomBrightnessContrast",
                                          brightness_by_max=False),
    "ChannelShuffle": dict(type="ChannelShuffle"),
    "Blur": dict(type="Blur", blur_limit=7),
    "MedianBlur": dict(type="MedianBlur", blur_limit=(3, 7)),
    "GaussNoise": dict(type="GaussNoise", var_limit=(10.0, 50.0)),
    "HueSaturationValue": dict(type="HueSaturationValue",
                               hue_shift_limit=20, sat_shift_limit=30,
                               val_shift_limit=20),
    "ShiftScaleRotate": dict(type="ShiftScaleRotate", shift_limit=0.0625,
                             scale_limit=0.2, rotate_limit=30),
}


def run_both(cfg_fn, data_fn, seed, calls=3):
    """``calls`` calls of the JAX transform under ``np.random.seed(seed)``
    and of the port's on ``RandomState(seed)``: every output equal, and
    the generators in step after each."""
    rng = np.random.RandomState(seed)
    port = cfg_fn(albu_mini, rng)
    np.random.seed(seed)
    ref = cfg_fn(jax_albu, None)
    for c in range(calls):
        if isinstance(ref, jax_albu.AlbuCompose):
            want, got = ref(**data_fn(c)), port(**data_fn(c))
        else:
            want, got = ref(data_fn(c)), port(data_fn(c))
        assert set(got) == set(want)
        for key in want:
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np_states_equal(rng.get_state(), np.random.get_state())


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, p, dtype):
    cfg = dict(TRANSFORMS[name], p=p)

    def build(mod, rng):
        return (mod.build_albu(cfg, rng) if rng is not None
                else mod.build_albu(cfg))

    run_both(build, lambda c: albu_data(c, dtype), seed=len(name) + int(p * 7))


def test_one_of_matches_jax():
    cfg = dict(type="OneOf", p=0.7, transforms=[
        dict(type="Blur", blur_limit=3, p=1.0),
        dict(type="MedianBlur", blur_limit=3, p=0.5),
        dict(type="HueSaturationValue", p=2.0)])

    def build(mod, rng):
        return (mod.build_albu(cfg, rng) if rng is not None
                else mod.build_albu(cfg))

    run_both(build, albu_data, seed=3, calls=8)


MMDET_EXAMPLE = [
    dict(type="ShiftScaleRotate", shift_limit=0.0625, scale_limit=0.0,
         rotate_limit=0, interpolation=1, p=0.5),
    dict(type="RandomBrightnessContrast", brightness_limit=[0.1, 0.3],
         contrast_limit=[0.1, 0.3], p=0.2),
    dict(type="OneOf", transforms=[dict(type="Blur", blur_limit=3, p=1.0),
                                   dict(type="MedianBlur", blur_limit=3,
                                        p=1.0)], p=0.1),
    dict(type="HueSaturationValue", p=0.3),
    dict(type="ChannelShuffle", p=0.1),
    dict(type="ShiftScaleRotate", shift_limit=0.3, scale_limit=0.3,
         rotate_limit=45, p=0.5),
]


@pytest.mark.parametrize("min_visibility", [0.0, 0.6])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_compose_matches_jax(min_visibility, dtype):
    """mmdet's example block (and a wide rotation, so boxes leave the
    image) with ``min_visibility`` and a label field: images, boxes and
    labels equal over 10 calls."""
    params = dict(type="BboxParams", format="pascal_voc",
                  label_fields=["gt_labels"], min_visibility=min_visibility)

    def build(mod, rng):
        if rng is None:
            return mod.AlbuCompose(MMDET_EXAMPLE, params)
        return mod.AlbuCompose(MMDET_EXAMPLE, params, rng)

    run_both(build, lambda c: albu_data(c, dtype, 40 + c, 90 - c), seed=11,
             calls=10)
