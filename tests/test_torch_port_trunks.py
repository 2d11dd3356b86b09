"""HVRNet's ResNeXt and Res2Net trunks in the port against the JAX package:
``GroupedBottleneck`` / ``ResNeXt`` / ``ResXLayer`` and ``Bottle2neck`` /
``Res2NetV1b`` / ``Res2Layer`` module by module, ``state_dict_from_jax``
on the HVRNet and SELSA engines with either trunk, and the HVRNet engine
with either trunk through the sliding-window runner.

Module tests fill the JAX module's parameter tree from numpy (He-normal
kernels, random positive frozen-BN scales and variances, random means and
shifts) and load it through ``utils/weights.py``.  The engine tests use the
tiny HVRNet config (``tests/test_engine_hnmb.py:tiny_hnmb_cfg``) with the
trunk swapped in at depth 50 and narrow groups (ResNeXt 2×4d, Res2Net
8w-4s), their frozen BNs calibrated by the JAX package on the first frame
and the weights carried to the port by ``state_dict_from_jax``.  Each JAX
reference is computed once, in a module fixture.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu.engine import SelsaRCNN as JaxSelsaRCNN
from hvrnet_tpu.engine import SlidingWindowRunner as JaxRunner
from hvrnet_tpu.engine.calibrate import \
    calibrate_frozen_bn as jax_calibrate_frozen_bn
from hvrnet_tpu.models.backbones.res2net import Bottle2neck as JaxBottle2neck
from hvrnet_tpu.models.backbones.res2net import Res2Layer as JaxRes2Layer
from hvrnet_tpu.models.backbones.res2net import Res2NetV1b as JaxRes2NetV1b
from hvrnet_tpu.models.backbones.res2net import ResXLayer as JaxResXLayer
from hvrnet_tpu.models.backbones.resnext import \
    GroupedBottleneck as JaxGroupedBottleneck
from hvrnet_tpu.models.backbones.resnext import ResNeXt as JaxResNeXt
from hvrnet_tpu_torch.engine import HNMBRCNN, SelsaRCNN, SlidingWindowRunner
from hvrnet_tpu_torch.models.backbones.res2net import (Bottle2neck,
                                                       Res2Layer, Res2NetV1b,
                                                       ResXLayer)
from hvrnet_tpu_torch.models.backbones.resnext import (GroupedBottleneck,
                                                       ResNeXt)
from hvrnet_tpu_torch.utils.weights import (_block, _res_layers,
                                            backbone_state_dict,
                                            state_dict_from_jax)
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_engine_selsa import tiny_selsa_cfg
from tests.test_torch_port_backbone import (CANVAS, jax_param_tree,
                                            normalized, uint8_frame)
from tests.test_torch_port_fpn import _filled
from tests.test_torch_port_image import _nchw, _rel_close
from tests.test_torch_port_slice import _JaxMaps, _video
from tests.test_torch_port_zoo import _tensors

torch.set_num_threads(2)

# one block or stage alone: 1e-5 of the output's max |·|; a whole trunk,
# whose f32 roundings compound over 16 blocks (as ResNet's,
# tests/test_torch_port_backbone.py): 1e-4
BLOCK_TOL, TRUNK_TOL = 1e-5, 1e-4

TRUNKS = {
    "resnext": dict(
        backbone=dict(type="ResNeXt", depth=50, groups=2, base_width=4,
                      num_stages=3, strides=(1, 2, 2), dilations=(1, 1, 1),
                      out_indices=(2,), frozen_stages=1, style="pytorch"),
        shared_head=dict(type="ResXLayer", depth=50, stage=3, stride=1,
                         dilation=2, groups=2, base_width=4,
                         external_conv=True)),
    "res2net": dict(
        backbone=dict(type="Res2NetV1b", depth=50, scales=4, base_width=8,
                      num_stages=3, strides=(1, 2, 2), dilations=(1, 1, 1),
                      out_indices=(2,), frozen_stages=1),
        shared_head=dict(type="Res2Layer", depth=50, stage=3, stride=1,
                         dilation=2, scales=4, base_width=8,
                         external_conv=True)),
}


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _block_sd(tree):
    """One JAX block's subtree → the port block's ``state_dict``."""
    out = {}
    _block("b", tree, out)
    return {k[len("b."):]: v for k, v in out.items()}


def _check(module, sd, x, want, tol):
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = module(_nchw(x))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        _rel_close(g.numpy(), w, tol)


# ------------------------------------------------------------- ResNeXt
GROUPED = {
    # (style, inplanes, planes, stride, dilation, downsample)
    "pytorch stride 2 downsample": ("pytorch", 32, 16, 2, 1, True),
    "caffe stride 2 downsample": ("caffe", 32, 16, 2, 1, True),
    "pytorch dilated": ("pytorch", 64, 16, 1, 2, False),
    "caffe widening downsample": ("caffe", 32, 16, 1, 1, True),
}


@pytest.mark.parametrize("case", list(GROUPED))
def test_grouped_bottleneck_matches_jax(case):
    """``GroupedBottleneck`` (4 groups of base width 8: a 3×3 of width 8
    in 4 groups) with and without a downsample, the stride on the 1×1
    (caffe) or the 3×3 (pytorch), dilated, from the JAX block's
    parameters: within 1e-5 of the output's max |·|."""
    style, inplanes, planes, stride, dilation, ds = GROUPED[case]
    x = _x(1, (1, 13, 18, inplanes))
    jblk = JaxGroupedBottleneck(planes, 4, 8, stride, dilation, ds, style)
    params = _filled(jblk, jnp.asarray(x), 2, bn_stats=True)
    want = jblk.apply(params, jnp.asarray(x))
    blk = GroupedBottleneck(inplanes, planes, stride, dilation, ds, style,
                            groups=4, base_width=8)
    assert blk.conv2.groups == 4 and blk.conv2.weight.shape == (8, 2, 3, 3)
    _check(blk, _block_sd(params["params"]), x, want, BLOCK_TOL)


def test_resnext_matches_jax():
    """ResNeXt-50 (2 groups × 4d, pytorch style) over 4 stages on a 64×96
    image: the 4 maps at strides 4 to 32 with 256 to 2048 channels, within
    1e-4 of their max |·| (``backbone_state_dict``: ``stem_conv`` /
    ``stem_bn`` → ``conv1`` / ``bn1``, ``ds_conv`` / ``ds_bn`` →
    ``downsample.0`` / ``.1``)."""
    kw = dict(depth=50, groups=2, base_width=4, num_stages=4,
              strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
              out_indices=(0, 1, 2, 3), style="pytorch")
    x = _x(3, (1, 64, 96, 3))
    jnet = JaxResNeXt(**kw)
    params = _filled(jnet, jnp.asarray(x), 4, bn_stats=True)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x))
    net = ResNeXt(**kw)
    sd = backbone_state_dict(params["params"])
    assert "layer1.0.downsample.0.weight" in sd
    _check(net, sd, x, want, TRUNK_TOL)


def test_resx_layer_matches_jax():
    """``ResXLayer`` (depth 50: 3 grouped bottlenecks of 512 planes, 2
    groups × 4d, stride 1, dilation 2) with ``external_conv``: C4 (1024
    channels) → the 256-channel C5, within 1e-5 of its max |·|."""
    kw = dict(depth=50, stage=3, stride=1, dilation=2, groups=2,
              base_width=4, external_conv=True)
    x = _x(5, (1, 5, 7, 1024))
    jhead = JaxResXLayer(**kw)
    params = _filled(jhead, jnp.asarray(x), 6, bn_stats=True)
    want = jhead.apply(params, jnp.asarray(x))
    head = ResXLayer(**kw)
    sd = {}
    _res_layers("", params["params"], sd)
    conv = params["params"]["new_layer_1"]["conv"]
    sd["new_layer_1.conv.weight"] = np.transpose(conv["kernel"],
                                                 (3, 2, 0, 1))
    sd["new_layer_1.conv.bias"] = np.asarray(conv["bias"])
    _check(head, sd, x, want, BLOCK_TOL)


# ------------------------------------------------------------- Res2Net
SPLITS = {
    # (inplanes, planes, stride, dilation, downsample, stage_first)
    "stage first stride 1": (32, 16, 1, 1, True, True),
    "stage first stride 2": (64, 16, 2, 1, True, True),
    "running add dilated": (64, 16, 1, 2, False, False),
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_bottle2neck_matches_jax(case):
    """``Bottle2neck`` (4 scales of base width 16: splits of 4 channels)
    as a stage's first block at stride 1 (3×3s at stride 1, the last split
    through) and 2 (3×3s strided, the last split average-pooled, the v1b
    downsample's pool and 1×1), and as a later block (the running add),
    dilated: within 1e-5 of the output's max |·|."""
    inplanes, planes, stride, dilation, ds, first = SPLITS[case]
    x = _x(7, (1, 12, 18, inplanes))
    jblk = JaxBottle2neck(planes, stride, dilation, 4, 16, ds,
                          stage_first=first)
    params = _filled(jblk, jnp.asarray(x), 8, bn_stats=True)
    want = jblk.apply(params, jnp.asarray(x))
    blk = Bottle2neck(inplanes, planes, stride, dilation, 4, 16, ds,
                      stage_first=first)
    sd = _block_sd(params["params"])
    assert ("downsample.1.weight" in sd) == ds
    assert "convs.2.weight" in sd and "bns.2.running_var" in sd
    _check(blk, sd, x, want, BLOCK_TOL)


def test_bottle2neck_refuses_an_odd_map_at_stride_2():
    """On a map of odd size a stride-2 block's downsample (whole windows)
    and 3×3 (rounded up) disagree by one row: the JAX block fails, the
    port raises ``ValueError`` instead of padding."""
    blk = Bottle2neck(64, 16, 2, 1, 4, 16, True, stage_first=True)
    with pytest.raises(ValueError, match="divide by its stride"):
        blk(torch.zeros(1, 64, 13, 18))
    jblk = JaxBottle2neck(16, 2, 1, 4, 16, True, stage_first=True)
    with pytest.raises(TypeError, match="add got incompatible shapes"):
        jax.eval_shape(jblk.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 13, 18, 64)))


def test_res2net_matches_jax():
    """Res2Net-50-v1b (8w-4s) over 4 stages on a 64×96 image: the deep
    stem (``stem1`` … ``stem3`` → ``conv1.0`` … ``conv1.6`` / ``bn1``) and
    the 4 maps at strides 4 to 32, within 1e-4 of their max |·|."""
    kw = dict(depth=50, scales=4, base_width=8, num_stages=4,
              strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
              out_indices=(0, 1, 2, 3))
    x = _x(9, (1, 64, 96, 3))
    jnet = JaxRes2NetV1b(**kw)
    params = _filled(jnet, jnp.asarray(x), 10, bn_stats=True)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x))
    net = Res2NetV1b(**kw)
    sd = backbone_state_dict(params["params"])
    assert {"conv1.0.weight", "conv1.1.running_mean", "conv1.6.weight",
            "bn1.weight", "layer2.0.downsample.2.running_var"} <= set(sd)
    _check(net, sd, x, want, TRUNK_TOL)


def test_res2_layer_matches_jax():
    """``Res2Layer`` (depth 50: 3 blocks of 512 planes, 8w-4s, stride 1,
    dilation 2) with ``external_conv``: C4 → the 256-channel C5 within
    1e-5 of its max |·|."""
    kw = dict(depth=50, stage=3, stride=1, dilation=2, scales=4,
              base_width=8, external_conv=True)
    x = _x(11, (1, 5, 7, 1024))
    jhead = JaxRes2Layer(**kw)
    params = _filled(jhead, jnp.asarray(x), 12, bn_stats=True)
    want = jhead.apply(params, jnp.asarray(x))
    head = Res2Layer(**kw)
    sd = {}
    _res_layers("", params["params"], sd)
    conv = params["params"]["new_layer_1"]["conv"]
    sd["new_layer_1.conv.weight"] = np.transpose(conv["kernel"],
                                                 (3, 2, 0, 1))
    sd["new_layer_1.conv.bias"] = np.asarray(conv["bias"])
    _check(head, sd, x, want, BLOCK_TOL)


# ------------------------------------------------------------- engines
def trunk_cfg(trunk, selsa=False):
    """The tiny HVRNet (or SELSA) config with ``trunk``'s backbone and
    shared head."""
    model_cfg, test_cfg = tiny_selsa_cfg() if selsa else tiny_hnmb_cfg()
    return dict(model_cfg, **TRUNKS[trunk]), test_cfg


@pytest.fixture(scope="module")
def trunk_engines():
    """Per trunk: (JAX engine, JAX params, port engine) of the tiny HVRNet
    on one set of weights, the frozen BNs calibrated by the JAX package
    on the first frame of the test video."""
    out = {}
    for trunk in TRUNKS:
        model_cfg, test_cfg = trunk_cfg(trunk)
        jeng = JaxHNMBRCNN(model_cfg, None, test_cfg)
        tree = jax_param_tree(jeng, 2)
        port = HNMBRCNN(model_cfg, test_cfg, device="cpu")
        port.load_state_dict(state_dict_from_jax(tree))
        frame = next(_video(1, 9, False))
        img = normalized(port, frame["img"])
        params, _ = jax_calibrate_frozen_bn(jeng, tree, [img])
        port.load_state_dict(state_dict_from_jax(params))
        out[trunk] = (jeng, params, port)
    return out


@pytest.mark.parametrize("selsa", [False, True], ids=["hnmb", "selsa"])
@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_state_dict_from_jax_loads_strictly(trunk_engines, trunk, selsa):
    """The JAX HVRNet and SELSA engines' trees with either trunk load into
    the port's engines with ``strict=True``: every tensor named, every
    shape the port's."""
    model_cfg, test_cfg = trunk_cfg(trunk, selsa)
    if selsa:
        port_cls = SelsaRCNN
        tree = jax_param_tree(JaxSelsaRCNN(model_cfg, None, test_cfg), 1)
    else:                       # the engine fixture's calibrated tree
        port_cls, tree = HNMBRCNN, trunk_engines[trunk][1]
    port = port_cls(model_cfg, test_cfg, device="cpu")
    sd = state_dict_from_jax(tree)
    own = port.model.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in sd)
    port.model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_backbone_maps_match_jax(trunk_engines, trunk):
    """The frame program's C5 and RPN maps on the calibrated trunk,
    within 1e-4 of each map's max |·| (16 chained blocks' f32 rounding)."""
    jeng, params, port = trunk_engines[trunk]
    img = uint8_frame(np.random.default_rng(1))
    ish = np.array([86.0, 122.0], np.float32)
    want = jeng._backbone_dispatch(params, jnp.asarray(img), ish)
    got = port.backbone_maps(img, ish)
    for w, g in zip(want, got):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                   TRUNK_TOL)


@pytest.mark.parametrize("maps", ["port", "jax"])
@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_video_matches_jax_runner(trunk_engines, trunk, maps):
    """HVRNet with either trunk through the sliding-window runner over a
    6-frame video, against the JAX runner: per frame and class the same
    detections; with the JAX backbone maps injected boxes within 1e-3 px
    and scores within 1e-4, end to end boxes within 1e-4 of the canvas
    (the trunks' f32 rounding moves proposals, as ResNet's does in
    ``tests/test_torch_port_slice.py``) and scores within 1e-4."""
    jeng, params, port = trunk_engines[trunk]
    n = 6
    want = JaxRunner(jeng, params, branch=-1).run(_video(n, 9, True), n)
    eng = _JaxMaps(port, jeng, params) if maps == "jax" else port
    got = SlidingWindowRunner(eng, branch=-1).run(_video(n, 9, False), n)
    box_tol = 1e-3 if maps == "jax" else 1e-4 * CANVAS[1]
    total = 0
    for fw, fg in zip(want, got):
        assert len(fg) == len(fw) == 30
        for cw, cg in zip(fw, fg):
            assert cg.shape == cw.shape
            if len(cw):
                np.testing.assert_allclose(cg[:, :4], cw[:, :4], rtol=0,
                                           atol=box_tol)
                np.testing.assert_allclose(cg[:, 4], cw[:, 4], rtol=0,
                                           atol=1e-4)
            total += len(cw)
    assert total > 0
