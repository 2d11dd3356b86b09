"""The rest of the backbone zoo in the port against the JAX package: the
plugins ``ContextBlock`` (gcb), ``NonLocal2D`` and ``GeneralizedAttention``
(gen_attention) and their wiring into the ResNet bottleneck, ``HRNet`` and
``HRFPN``, ``roi_pool`` and the extractor's ``RoIPool`` branch, and one
tiny multi-stage engine each with the gcb plugin and with HRNet + HRFPN.

Module tests fill the JAX module's parameter tree from numpy (He-normal
kernels, random frozen-BN statistics and norms; the zero-initialised
parameters ``gamma``, the biases and the last convs drawn too, so each
term is live) and load it through ``utils/weights.py``.  The engines'
trunks have drawn frozen-BN statistics (``random_bn_stats``), their JAX
references computed once in a module fixture; ``simple_test`` is held on
the maps of a jitted JAX program, as in ``tests/test_torch_port_fpn.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine.multi_stage import CascadeRCNN as JaxCascadeRCNN
from hvrnet_tpu.engine.multi_stage import MaskRCNN as JaxMaskRCNN
from hvrnet_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from hvrnet_tpu.models.backbones.resnet import ResNet as JaxResNet
from hvrnet_tpu.models.necks.hrfpn import HRFPN as JaxHRFPN
from hvrnet_tpu.models.plugins import ContextBlock as JaxContextBlock
from hvrnet_tpu.models.plugins import \
    GeneralizedAttention as JaxGeneralizedAttention
from hvrnet_tpu.models.plugins import NonLocal2D as JaxNonLocal2D
from hvrnet_tpu.models.plugins import (_local_constraint_mask,
                                       _sine_position_embedding)
from hvrnet_tpu.models.roi_extractor import \
    SingleRoIExtractor as JaxSingleRoIExtractor
from hvrnet_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from hvrnet_tpu_torch.engine import CascadeRCNN, MaskRCNN
from hvrnet_tpu_torch.models.backbones.hrnet import HRNet
from hvrnet_tpu_torch.models.backbones.resnet import ResNet
from hvrnet_tpu_torch.models.builder import build_roi_extractor
from hvrnet_tpu_torch.models.necks.hrfpn import HRFPN
from hvrnet_tpu_torch.models.plugins import (ContextBlock,
                                             GeneralizedAttention, NonLocal2D,
                                             local_constraint_mask,
                                             sine_position_embedding)
from hvrnet_tpu_torch.ops.roi_pool import MAX_BIN, roi_pool
from hvrnet_tpu_torch.utils.weights import (backbone_state_dict,
                                            neck_state_dict,
                                            plugin_state_dict,
                                            state_dict_from_jax)
from tests.test_torch_port_backbone import jax_param_tree
from tests.test_torch_port_fpn import (TEST_CFG, _extractor, _filled,
                                       _inflate_heads, inject, jax_maps)
from tests.test_torch_port_image import _nchw, _rel_close
from tests.test_torch_port_zoo import _tensors

torch.set_num_threads(2)

TOL = 1e-5          # one module alone, of its output's max |·|
TRUNK_TOL = 1e-4    # a whole trunk (16 chained blocks of f32 rounding)
LIVE = ("gamma", "appr_bias", "geom_bias")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _live(params, seed, gain=0.5):
    """``params`` with every zero-initialised plugin parameter (``LIVE``,
    the context block's last convs, NonLocal's ``conv_out``) drawn at std
    ``gain`` so that the term it gates reaches the output, and the context
    block's first conv's bias too: on calibrated (zero-mean) maps the
    pooled context is a near-cancelling sum, and its LayerNorm would
    otherwise rescale that sum's rounding to O(1)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        keys = [getattr(p, "key", "") for p in path]
        if keys[-1] in LIVE or (keys[-1] == "kernel" and (
                keys[-2].endswith("_conv2") or keys[-2] == "conv_out")) or (
                keys[-1] == "bias" and keys[-2].endswith("_conv1")):
            return (rng.standard_normal(np.shape(a)) * gain).astype(
                np.float32)
        return a

    return jax.tree_util.tree_map_with_path(draw, params)


def _module_check(jmod, mod, x, seed, tol=TOL):
    params = _live(_filled(jmod, jnp.asarray(x), seed, bn_stats=True), seed)
    want = np.asarray(jmod.apply(params, jnp.asarray(x))).transpose(
        0, 3, 1, 2)
    sd = plugin_state_dict(params["params"])
    assert set(sd) == set(mod.state_dict())
    mod.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = mod(_nchw(x))
    assert tuple(got.shape) == want.shape
    _rel_close(got.numpy(), want, tol)
    return params


# ------------------------------------------------------------- plugins
GCB = {"att add": dict(pooling_type="att", fusion_types=("channel_add",)),
       "avg mul": dict(pooling_type="avg", fusion_types=("channel_mul",)),
       "att mul then add": dict(pooling_type="att",
                                fusion_types=("channel_mul", "channel_add"))}


@pytest.mark.parametrize("case", list(GCB))
def test_context_block_matches_jax(case):
    """``ContextBlock`` (32 channels, ratio 1/4): attention or average
    pooling, the ``channel_add`` and ``channel_mul`` fusions alone and in
    the JAX module's order, flax's LayerNorm (ε 1e-6) with random affines;
    within 1e-5 of the output's max |·|."""
    x = _x(1, (2, 6, 9, 32))
    _module_check(JaxContextBlock(32, 0.25, **GCB[case]),
                  ContextBlock(32, 0.25, **GCB[case]), x, 2)


@pytest.mark.parametrize("use_scale", [True, False])
def test_nonlocal_matches_jax(use_scale):
    """``NonLocal2D`` (16 channels, reduction 2), with and without the
    1/√inter scale: within 1e-5 of the output's max |·|."""
    x = _x(3, (2, 5, 7, 16))
    _module_check(JaxNonLocal2D(16, 2, use_scale),
                  NonLocal2D(16, 2, use_scale), x, 4)


def test_position_tables_are_bitwise_the_jax_ones():
    """The sinusoid tables and the spatial-range masks are built as the
    JAX module builds them: equal bit for bit, at strides 1 and 2."""
    for args in ((7, 4, 1, 2, 1, 24), (5, 5, 1, 1, 2, 48)):
        want = np.asarray(_sine_position_embedding(*args))
        got = sine_position_embedding(*args)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    for args in ((4, 5, 2, 3, 1, 2), (4, 5, 4, 5, 0, 1), (1, 1, 3, 3, 2, 2)):
        assert np.array_equal(local_constraint_mask(*args),
                              np.asarray(_local_constraint_mask(*args)))


GEN_ATTENTION = {
    # (attention_type, spatial_range, kv_stride)
    "1000": ("1000", -1, 2), "0100": ("0100", -1, 2),
    "0010 saliency": ("0010", -1, 2), "0001": ("0001", -1, 2),
    "1111": ("1111", -1, 1), "1111 kv 2": ("1111", -1, 2),
    "1111 range 1": ("1111", 1, 2), "1111 range 2 kv 1": ("1111", 2, 1),
    "0010 saliency range 1": ("0010", 1, 1), "1010 range 0": ("1010", 0, 2),
}


@pytest.mark.parametrize("case", list(GEN_ATTENTION))
def test_generalized_attention_matches_jax(case):
    """``GeneralizedAttention`` (24 channels, 3 heads) for each single
    energy term, '1111', '1010', with ``spatial_range`` −1, 0, 1 and 2 and
    ``kv_stride`` 1 and 2 (the saliency fast path with query (0, 0)'s
    window), every bias and ``gamma`` drawn: within 1e-5 of the output's
    max |·|."""
    at, sr, kv = GEN_ATTENTION[case]
    kw = dict(spatial_range=sr, num_heads=3, kv_stride=kv,
              attention_type=at)
    x = _x(5, (1, 5, 7, 24))
    _module_check(JaxGeneralizedAttention(24, **kw),
                  GeneralizedAttention(24, **kw), x, 6)


PLUGGED = dict(depth=50, num_stages=4, strides=(1, 2, 2, 2),
               dilations=(1, 1, 1, 1), out_indices=(0, 1, 2, 3),
               style="pytorch", gcb=dict(ratio=1. / 16.),
               stage_with_gcb=(False, True, True, True),
               gen_attention=dict(spatial_range=-1, num_heads=8,
                                  attention_type="1111", kv_stride=2),
               stage_with_gen_attention=((), (), (0, 2), (1,)))


def test_resnet_plugins_match_jax():
    """ResNet-50 (pytorch style, 4 stages) with ``gcb`` (ratio 1/16) on
    stages 2–4 and ``gen_attention`` ('1111', 8 heads, kv stride 2) in
    blocks 0 and 2 of stage 3 and block 1 of stage 4, as the JAX bottleneck
    runs them (the attention after conv2's ReLU, the context block after
    conv3's BN): the plugins sit where the config says, and the 4 maps
    are within 1e-4 of their max |·|."""
    x = _x(7, (1, 64, 64, 3))
    jnet = JaxResNet(**PLUGGED)
    params = _live(_filled(jnet, jnp.asarray(x), 8, bn_stats=True), 8)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x))
    net = ResNet(**PLUGGED)
    sd = backbone_state_dict(params["params"])
    assert set(sd) == set(net.state_dict())
    attn = {n.rsplit(".gen_attention_block", 1)[0] for n in sd
            if ".gen_attention_block." in n}
    assert attn == {"layer3.0", "layer3.2", "layer4.1"}
    gcb = {n.split(".")[0] for n in sd if ".context_block." in n}
    assert gcb == {"layer2", "layer3", "layer4"}
    net.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = net(_nchw(x))
    for g, w in zip(got, want):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                   TRUNK_TOL)


# ------------------------------------------------------------- HRNet
NARROW = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(1,), num_channels=(8,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(1, 1), num_channels=(4, 8)),
    stage3=dict(num_modules=2, num_branches=3, block="BASIC",
                num_blocks=(1, 1, 1), num_channels=(4, 8, 16)),
    stage4=dict(num_modules=1, num_branches=4, block="BASIC",
                num_blocks=(1, 2, 1, 1), num_channels=(4, 8, 16, 32)))


def test_hrnet_matches_jax(monkeypatch):
    """HRNet at narrow widths (4 to 32 channels, two stage-3 modules) on a
    76×100 image, whose branches (19×25, 10×13, 5×7, 3×4) upsample at
    non-integer ratios (half-pixel nearest, torch's ``nearest-exact``):
    the 4 branches within 1e-4 of their max |·|; ``nearest`` would give
    other maps."""
    x = _x(9, (1, 76, 100, 3))
    jnet = JaxHRNet(extra=NARROW)
    params = _filled(jnet, jnp.asarray(x), 10, bn_stats=True)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x))
    net = HRNet(extra=NARROW)
    sd = backbone_state_dict(params["params"])
    assert {"transition1.0.0.weight", "transition1.1.0.0.weight",
            "transition3.3.0.1.running_var",
            "stage3.1.fuse_layers.2.0.1.0.weight",
            "stage4.0.fuse_layers.0.3.1.bias",
            "stage4.0.branches.1.1.conv2.weight"} <= set(sd)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = net(_nchw(x))
    assert [tuple(g.shape[2:]) for g in got] == [(19, 25), (10, 13), (5, 7),
                                                 (3, 4)]
    for g, w in zip(got, want):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                   TRUNK_TOL)
    from hvrnet_tpu_torch.models.backbones import hrnet
    monkeypatch.setattr(hrnet, "resize_nearest", lambda t, size: (
        torch.nn.functional.interpolate(t, size=tuple(size),
                                        mode="nearest")))
    with torch.no_grad():
        off = net(_nchw(x))
    assert max((o - g).abs().max() for o, g in zip(off, got)) > 1e-3


@pytest.mark.parametrize("pooling", ["AVG", "MAX"])
def test_hrfpn_matches_jax(pooling):
    """``HRFPN`` (4, 8, 16, 32 → 16 channels, 5 outputs) on branches of
    19×25, 10×13, 5×7 and 3×4 (non-integer upsampling ratios against
    ``jax.image.resize(..., "bilinear")``), average and max pools: each
    output within 1e-5 of its max |·|."""
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((1, h, w, c)).astype(np.float32)
          for (h, w), c in zip(((19, 25), (10, 13), (5, 7), (3, 4)),
                               (4, 8, 16, 32))]
    kw = dict(in_channels=(4, 8, 16, 32), out_channels=16, num_outs=5,
              pooling_type=pooling)
    jneck = JaxHRFPN(**kw)
    jx = [jnp.asarray(x) for x in xs]
    params = jneck.init(jax.random.PRNGKey(0), jx)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.2,
        params)
    want = jneck.apply(params, jx)
    neck = HRFPN(**kw)
    sd = neck_state_dict(params["params"])
    assert set(sd) == set(neck.state_dict())
    neck.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = neck([_nchw(x) for x in xs])
    assert [tuple(g.shape[2:]) for g in got] == [(19, 25), (9, 12), (4, 6),
                                                 (2, 3), (1, 1)]
    for g, w in zip(got, want):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), TOL)


# ------------------------------------------------------------- RoIPool
def _rois(rng, n, batch, hw, scale):
    """n RoIs over ``batch`` images of an (h, w) map at ``scale``, in
    image coordinates, spread from sub-bin to whole-map sizes."""
    h, w = hw[0] / scale, hw[1] / scale
    xy = rng.uniform(-0.1, 0.9, (n, 2)) * [w, h]
    wh = rng.uniform(0.01, 0.9, (n, 2)) * [w, h]
    b = rng.integers(0, batch, (n, 1))
    return np.concatenate([b, xy, xy + wh], 1).astype(np.float32)


ROI_POOL = {
    "spread": dict(hw=(38, 63), batch=2, scale=1 / 16, n=60),
    # coordinates whose scaled value sits at k + 0.5 (half to even), RoIs
    # entirely off the map (every bin empty), and bins wider than MAX_BIN
    "edges": dict(hw=(40, 300), batch=1, scale=1.0, n=0),
}


@pytest.mark.parametrize("case", list(ROI_POOL))
def test_roi_pool_is_bitwise_the_jax_op(case):
    """``roi_pool`` against the JAX op bit for bit: random RoIs over two
    images of a 38×63 map at stride 16, and at scale 1 the half-way
    coordinates (2.5 → 2, 3.5 → 4), RoIs off the map (above-left: empty
    bins → 0; below-right: the clamped last row and column) and
    a 7-bin RoI 300 columns wide (43-column bins read their first 32)."""
    c = ROI_POOL[case]
    rng = np.random.default_rng(13)
    feats = rng.standard_normal((c["batch"],) + c["hw"] + (8,)).astype(
        np.float32)
    if case == "spread":
        rois = _rois(rng, c["n"], c["batch"], c["hw"], c["scale"])
    else:
        rois = np.float32([[0, 2.5, 3.5, 12.5, 9.5],
                           [0, 0.5, 1.5, 5.5, 6.5],
                           [0, -90, -60, -40, -20],
                           [0, 0, 0, 299, 39],
                           [0, 310, 45, 330, 60],
                           [0, 4, 2, 4, 2]])
    want = np.asarray(jax_roi_pool(jnp.asarray(feats), jnp.asarray(rois),
                                   7, c["scale"])).transpose(0, 3, 1, 2)
    got = roi_pool(_nchw(feats), torch.from_numpy(rois), 7, c["scale"])
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    if case == "edges":
        # off the map above-left every bin is empty; below-right the low
        # ends clamp to the last row and column, which every bin reads
        assert (want[2] == 0).all()
        assert (want[4] == feats[0, -1, -1][:, None, None]).all()
        # the 300-wide RoI's first bin: columns 0 … 31 of 0 … 42
        assert np.array_equal(want[3, :, 0, 0], feats[0, :6, :MAX_BIN].max(
            axis=(0, 1)))


def test_roi_extractor_pools_with_roi_pool():
    """The extractor's ``RoIPool`` branch over two levels (strides 4 and
    8, RoIs mapped by scale) against the JAX extractor: bit for bit."""
    rng = np.random.default_rng(17)
    maps = [rng.standard_normal((1, 32 >> i, 48 >> i, 8)).astype(np.float32)
            for i in range(2)]
    rois = _rois(rng, 20, 1, (32, 48), 1 / 4)
    rois[:, 0] = 0
    cfg = dict(roi_layer=dict(type="RoIPool", out_size=7), out_channels=8,
               featmap_strides=[4, 8], finest_scale=8)
    want = np.asarray(JaxSingleRoIExtractor(**cfg)(
        [jnp.asarray(m) for m in maps], jnp.asarray(rois)))
    got = build_roi_extractor(dict(cfg, type="SingleRoIExtractor"))(
        [_nchw(m) for m in maps], torch.from_numpy(rois))
    assert got.numpy().tobytes() == want.transpose(0, 3, 1, 2).tobytes()


# ------------------------------------------------------------- engines
CANVAS = (64, 96)


def zoo_cfg(kind):
    """``gcb``: Mask R-CNN on ResNet-50 (pytorch style) with the context
    block on stages 2–4 and a 32-channel FPN; ``hrnet``: 3-stage Cascade
    R-CNN on the narrow HRNet with a 32-channel HRFPN.  The RPN on the
    neck's first level (stride 4, 32-px anchors) and every RoI pooled
    from it, as the JAX engine runs a neck."""
    heads = [dict(type="SharedFCBBoxHead", num_fcs=2, in_channels=32,
                  fc_out_channels=32, roi_feat_size=7, num_classes=9,
                  target_means=[0.] * 4, target_stds=stds,
                  reg_class_agnostic=True)
             for stds in ([0.1, 0.1, 0.2, 0.2], [0.05, 0.05, 0.1, 0.1],
                          [0.033, 0.033, 0.067, 0.067])]
    cfg = dict(rpn_head=dict(type="RPNHead", in_channels=32,
                             feat_channels=32, anchor_scales=[8],
                             anchor_ratios=[0.5, 1.0, 2.0],
                             anchor_strides=[4, 8, 16, 32, 64]),
               bbox_roi_extractor=_extractor(7, [4, 8, 16, 32]))
    if kind == "gcb":
        cfg.update(
            type="MaskRCNN",
            backbone=dict(type="ResNet", depth=50, num_stages=4,
                          strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                          out_indices=(0, 1, 2, 3), frozen_stages=1,
                          style="pytorch", gcb=dict(ratio=1. / 16.),
                          stage_with_gcb=(False, True, True, True)),
            neck=dict(type="FPN", in_channels=(256, 512, 1024, 2048),
                      out_channels=32, num_outs=5),
            bbox_head=dict(heads[0], reg_class_agnostic=False),
            mask_roi_extractor=_extractor(14, [4, 8, 16, 32]),
            mask_head=dict(type="FCNMaskHead", num_convs=2, in_channels=32,
                           conv_out_channels=32, num_classes=9))
    else:
        cfg.update(type="CascadeRCNN", num_stages=3,
                   backbone=dict(type="HRNet", extra=NARROW),
                   neck=dict(type="HRFPN", in_channels=(4, 8, 16, 32),
                             out_channels=32, num_outs=5),
                   bbox_head=heads)
    return cfg


ENGINES = {"gcb": (JaxMaskRCNN, MaskRCNN),
           "hrnet": (JaxCascadeRCNN, CascadeRCNN)}


def random_bn_stats(tree, seed):
    """``tree`` with the backbone's frozen-BN statistics drawn (variances
    uniform in [0.5, 1.5], means normal at std 0.1) and its BN scales
    uniform in [0.3, 0.6], which keeps the maps O(10).  Not calibrated: a
    bottleneck trunk calibrated on these few-pixel maps is ill-conditioned
    (f32 runs of either package part from a float64 one by 1e-3 at P4),
    while on drawn statistics the two packages' maps agree within 2e-6."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        keys = [getattr(p, "key", "") for p in path]
        if keys[1] != "backbone" or keys[-1] not in ("mean", "var",
                                                     "scale"):
            return a
        if keys[-1] == "var":
            return rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32)
        if keys[-1] == "scale":
            return rng.uniform(0.3, 0.6, np.shape(a)).astype(np.float32)
        return (rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def zoo_runs():
    """Per engine: the JAX ``simple_test`` on a 64×96 noise image, the JAX
    maps, the port engine on the same weights and its inputs."""
    rng = np.random.default_rng(3)
    img = rng.normal(size=(1,) + CANVAS + (3,)).astype(np.float32)
    ish = np.array([CANVAS[0] - 4.0, CANVAS[1] - 2.0], np.float32)
    psh = np.array(CANVAS, np.float32)
    sf = np.array([0.8, 0.82, 0.8, 0.82], np.float32)
    out = {}
    for kind, (jax_cls, port_cls) in ENGINES.items():
        cfg = zoo_cfg(kind)
        jeng = jax_cls(cfg, None, TEST_CFG)
        params = random_bn_stats(_live(_inflate_heads(
            jax_param_tree(jeng, 11), 11), 11, gain=0.05), 12)
        port = port_cls(cfg, TEST_CFG, device="cpu")
        sd = state_dict_from_jax(params, cfg)
        assert set(sd) == set(port.model.state_dict())
        port.load_state_dict(sd)
        want = jax.device_get(jeng.simple_test(params, jnp.asarray(img), ish,
                                               psh, sf))
        out[kind] = dict(port=port, want=want, args=(img, ish, psh, sf),
                         maps=jax_maps(jeng, params, img))
    return out


@pytest.mark.parametrize("kind", list(ENGINES))
def test_zoo_neck_maps_match_jax(zoo_runs, kind):
    """The port's backbone and neck on the JAX engine's weights and image:
    each level within 1e-4 of the jitted JAX program's max |·|."""
    run = zoo_runs[kind]
    with torch.no_grad():
        got = run["port"].model.extract_feat(_nchw(run["args"][0]))
    assert len(got) == 5
    for g, w in zip(got, run["maps"][0]):
        _rel_close(g.numpy(), w, TRUNK_TOL)


@pytest.mark.parametrize("kind", list(ENGINES))
def test_zoo_simple_test_matches_jax(zoo_runs, kind, monkeypatch):
    """``simple_test`` on the JAX maps: the same NMS picks in the same rows
    with the same labels, boxes within 1e-3 px, scores within 2e-6, and
    Mask R-CNN's mask probabilities within 1e-5."""
    run = zoo_runs[kind]
    port = run["port"]
    inject(monkeypatch, port, run["maps"])
    got = port.simple_test(*run["args"])
    want = run["want"]
    dets, labels, mask = (t.numpy() for t in got[:3])
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_array_equal(labels[mask], want[1][mask])
    assert mask.sum() > 3
    np.testing.assert_allclose(dets[mask, :4], want[0][mask, :4], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets[mask, 4], want[0][mask, 4], rtol=0,
                               atol=2e-6)
    if kind == "gcb":
        np.testing.assert_allclose(got[3].numpy(),
                                   want[3].transpose(0, 3, 1, 2), rtol=0,
                                   atol=1e-5)
