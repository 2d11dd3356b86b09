"""The port's frame program against the JAX package's, on the same weights.

Weights: the JAX engine's parameter tree (its structure from
``init_params``, values drawn from a seed with numpy in the JAX init scheme)
crosses to the port through ``state_dict_from_jax``.  The port calibrates
the frozen-BN statistics on the test frame (random convolutions otherwise
compound activation scale block after block), and the calibrated weights
cross back through the JAX package's ``convert_torch_checkpoint``, so both
packages run the same weights with O(1) activations.  Sizes are the tiny
HNMB config (R50 stages, 8 proposals, T = 3) on a 96×128 canvas.
"""
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu.utils.checkpoint import convert_torch_checkpoint, merge_params
from hvrnet_tpu_torch.engine import HNMBRCNN
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_engine_hnmb import tiny_hnmb_cfg

torch.set_num_threads(2)

CANVAS = (96, 128)
IMG_SHAPE = np.array([86.0, 122.0], np.float32)
PAD_SHAPE = np.array([96.0, 128.0], np.float32)


_SHAPES = weakref.WeakKeyDictionary()   # engine → its traced param shapes


def jax_param_tree(engine, seed: int):
    """A parameter tree with the JAX engine's exact structure (traced once
    per engine, not run), filled from numpy in its init scheme: He-normal
    conv kernels, normal(0, 0.01) dense kernels and RPN convs, zero
    biases, identity frozen BNs."""
    if engine not in _SHAPES:
        _SHAPES[engine] = jax.eval_shape(engine.init_params,
                                         jax.random.PRNGKey(0))
    shapes = _SHAPES[engine]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            std = (0.01 if len(s.shape) == 2 or path[1].key == "rpn_head"
                   else np.sqrt(2.0 / np.prod(s.shape[:-1])))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def uint8_frame(rng, img_shape=IMG_SHAPE, canvas=CANVAS):
    """(1, H, W, 3) uint8 canvas: random content inside img_shape, zero
    padding outside."""
    img = np.zeros((1,) + canvas + (3,), np.uint8)
    h, w = int(img_shape[0]), int(img_shape[1])
    img[0, :h, :w] = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return img


def normalized(engine, img_u8, img_shape=IMG_SHAPE):
    """The port's on-device uint8 normalisation, as a float32 NHWC canvas."""
    x = engine._to_input(img_u8, img_shape)
    return x.permute(0, 2, 3, 1).numpy()


def shared_engines(seed: int = 0, window_interval: int = 1):
    """(jax engine, jax params, port engine) on the same calibrated weights."""
    model_cfg, test_cfg = tiny_hnmb_cfg(window_interval=window_interval)
    jeng = JaxHNMBRCNN(model_cfg, None, test_cfg)
    tree = jax_param_tree(jeng, seed)
    port = HNMBRCNN(model_cfg, test_cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(tree))
    calib = uint8_frame(np.random.default_rng(seed + 100))
    calibrate_frozen_bn(port, [dict(img=calib, img_shape=IMG_SHAPE)])
    back = convert_torch_checkpoint(
        {k: v.numpy() for k, v in port.model.state_dict().items()})
    merged, missing = merge_params(tree["params"], back["params"])
    assert missing == []
    return jeng, {"params": merged}, port


@pytest.fixture(scope="module")
def engines():
    return shared_engines()


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def assert_close_to_scale(got, want, tol):
    """|got − want| ≤ tol · max|want| elementwise.  Used where f32 rounding
    differences compound through many layers: measured on these weights,
    each ResNet stage alone differs by ≤ 4e-5 from the JAX stage on the same
    input, and the 16 chained bottlenecks carry that to ~3e-5 of c4's peak
    and ~7e-5 of c5's; entries near zero (ReLU edges) then differ by more
    than a pointwise rtol allows."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["float32", "uint8"])
def test_backbone_maps_match_jax(engines, kind):
    """c5 and the RPN cls/reg maps of the JAX frame program at f32, within
    1e-4 of each map's peak (conv reduction order); the uint8 input also
    exercises the on-device normalisation and the zeroed padding."""
    jeng, params, port = engines
    img = uint8_frame(np.random.default_rng(1))
    if kind == "float32":
        img = normalized(port, img)
    want = jeng._backbone_dispatch(params, jnp.asarray(img), IMG_SHAPE)
    got = port.backbone_maps(img, IMG_SHAPE)
    for w, g in zip(want, got):
        assert g.shape == _nchw(w).shape
        assert_close_to_scale(g.numpy(), _nchw(w), 1e-4)


def test_frame_post_matches_jax(engines):
    """From the same backbone maps: identical proposal picks (slots, masks,
    boxes, scores) and fc1 rows within 1e-4."""
    jeng, params, port = engines
    img = uint8_frame(np.random.default_rng(2))
    maps = jeng._backbone_dispatch(params, jnp.asarray(img), IMG_SHAPE)
    want = jax.device_get(jeng._frame_post_fn(*CANVAS)(
        jeng._bb(params), *maps, IMG_SHAPE, PAD_SHAPE))
    got = port.frame_post(*[torch.from_numpy(_nchw(m).copy()) for m in maps],
                          IMG_SHAPE, PAD_SHAPE)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert want["mask"].sum() > 0
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"],
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["fc1"].numpy(), want["fc1"],
                               rtol=1e-4, atol=1e-4)


def test_frame_features_match_jax(engines):
    """The whole frame program from a uint8 frame, a smoke check end to
    end: the same proposal slots, boxes within 1e-4 of their scale (the
    backbone's rounding, see ``assert_close_to_scale``, moves the box
    deltas), and fc1 within 1e-3 of its scale (those box shifts also move
    RoIAlign's sample points; up to 2e-4 measured over three frames).  From
    the same maps the tight limits hold (``test_frame_post_matches_jax``)."""
    jeng, params, port = engines
    img = uint8_frame(np.random.default_rng(3))
    want = jax.device_get(jeng.frame_features(params, jnp.asarray(img),
                                              IMG_SHAPE, PAD_SHAPE))
    got = port.frame_features(img, IMG_SHAPE, PAD_SHAPE)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert_close_to_scale(got["boxes"].numpy(), want["boxes"], 1e-4)
    assert_close_to_scale(got["fc1"].numpy(), want["fc1"], 1e-3)
