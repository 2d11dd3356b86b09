"""The single-stage dense detectors in the port against the JAX package:
the focal, IoU, bounded-IoU, balanced-L1 and GHM losses, SSD's anchor
generators, ``SSDVGG``, the dense heads (``RetinaHead``,
``FreeAnchorRetinaHead``, ``SSDHead``, ``FCOSHead``, ``FoveaHead``) and
``SingleStageEngine.simple_test`` for RetinaNet, FreeAnchor, FCOS (caffe
ResNet-50 with the extra convs on the FPN's outputs through a ReLU, and
pytorch ResNet-18 with them on the inputs), FoveaBox and SSD300, and the
refusal of ``ResNeXt``.  Training is in
``tests/test_torch_port_dense_train.py``.

The engines are ResNet-18 (ResNet-50 for caffe FCOS) with a 16-channel
FPN and 11 classes on a 64×96 canvas, SSD the full SSDVGG at 300×300.
Weights: a JAX parameter tree filled from numpy crosses to the port
through ``state_dict_from_jax``; the port calibrates the frozen-BN
statistics on the image and the backbone's weights cross back
(``convert_torch_checkpoint``); the heads' output convs are drawn so that
scores spread below and above ``score_thr``.  Each JAX reference is
computed once, in a module fixture; ``simple_test`` is held on the neck's
maps of a jitted JAX program (XLA:CPU rounds jitted convolutions otherwise
than op-by-op ones).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine import single_stage as jax_single_stage
from hvrnet_tpu.models import losses as jax_losses
from hvrnet_tpu.models.anchor_heads import dense_heads as jax_heads
from hvrnet_tpu.models.backbones.resnext import SSDVGG as JaxSSDVGG
from hvrnet_tpu.ops import anchors as jax_anchors
from hvrnet_tpu.utils.checkpoint import (convert_torch_checkpoint,
                                         merge_params)
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine import single_stage
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.models import losses
from hvrnet_tpu_torch.models.backbones.resnext import SSDVGG
from hvrnet_tpu_torch.models.registry import BACKBONES, HEADS
from hvrnet_tpu_torch.models.two_stage import build_submodule
from hvrnet_tpu_torch.ops import anchors
from hvrnet_tpu_torch.utils.weights import (dense_head_state_dict,
                                            ssd_vgg_state_dict,
                                            state_dict_from_jax)
from tests.test_torch_port_backbone import jax_param_tree
from tests.test_torch_port_image import _nchw, _rel_close
from tests.test_torch_port_zoo import _tensors

torch.set_num_threads(2)

CANVAS = (64, 96)
SSD_CANVAS = (300, 300)
TEST_CFG = dict(nms_pre=60, score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                max_per_img=30)
SSD_TEST_CFG = dict(score_thr=0.02, nms=dict(type="nms", iou_thr=0.45),
                    max_per_img=40, nms_pre=300)
STRIDES = [8, 16, 32, 64, 128]


def _resnet(depth=18, style="pytorch"):
    return dict(type="ResNet", depth=depth, num_stages=4,
                strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                out_indices=(0, 1, 2, 3), frozen_stages=1, style=style,
                norm_eval=True)


def _fpn(depth=18, on_inputs=True):
    e = 1 if depth == 18 else 4
    neck = dict(type="FPN", in_channels=tuple(64 * e * 2 ** i
                                              for i in range(4)),
                out_channels=16, start_level=1, add_extra_convs=True,
                num_outs=5)
    if not on_inputs:
        neck.update(extra_convs_on_inputs=False, relu_before_extra_convs=True)
    return neck


def dense_cfg(kind):
    """A tiny config of each single-stage detector: ``retina``,
    ``free_anchor``, ``fcos_caffe`` (ResNet-50 caffe style, FPN extra convs
    on the outputs through a ReLU, 64-wide GroupNorm towers: 2 channels a
    group), ``fcos`` (ResNet-18, 32-wide towers: 1 channel a group),
    ``fovea`` or ``ssd`` (SSDVGG at 300, SSD300 COCO's anchors)."""
    if kind == "ssd":
        return dict(type="SingleStageDetector",
                    backbone=dict(type="SSDVGG", input_size=300, depth=16,
                                  with_last_pool=False, ceil_mode=True,
                                  out_indices=(3, 4),
                                  out_feature_indices=(22, 34),
                                  l2_norm_scale=20),
                    bbox_head=dict(type="SSDHead", input_size=300,
                                   in_channels=(512, 1024, 512, 256, 256,
                                                256),
                                   num_classes=11,
                                   anchor_strides=(8, 16, 32, 64, 100, 300),
                                   basesize_ratio_range=(0.15, 0.9),
                                   anchor_ratios=([2], [2, 3], [2, 3],
                                                  [2, 3], [2], [2]),
                                   target_means=(.0, .0, .0, .0),
                                   target_stds=(0.1, 0.1, 0.2, 0.2)))
    depth = 50 if kind == "fcos_caffe" else 18
    cfg = dict(backbone=_resnet(depth, "caffe" if depth == 50 else "pytorch"),
               neck=_fpn(depth, on_inputs=kind != "fcos_caffe"))
    if kind in ("retina", "free_anchor"):
        head = "RetinaHead" if kind == "retina" else "FreeAnchorRetinaHead"
        stds = [1.0] * 4 if kind == "retina" else [0.1, 0.1, 0.2, 0.2]
        cfg.update(type="RetinaNet", bbox_head=dict(
            type=head, num_classes=11, in_channels=16, stacked_convs=1,
            feat_channels=16, octave_base_scale=4, scales_per_octave=3,
            anchor_ratios=[0.5, 1.0, 2.0], anchor_strides=STRIDES,
            target_means=[.0, .0, .0, .0], target_stds=stds,
            loss_bbox=dict(type="SmoothL1Loss", beta=0.11,
                           loss_weight=0.75)))
    elif kind.startswith("fcos"):
        cfg.update(type="FCOS", bbox_head=dict(
            type="FCOSHead", num_classes=11, in_channels=16,
            stacked_convs=2, feat_channels=64 if depth == 50 else 32,
            strides=STRIDES))
    else:
        cfg.update(type="FOVEA", bbox_head=dict(
            type="FoveaHead", num_classes=11, in_channels=16,
            stacked_convs=1, feat_channels=16, strides=STRIDES,
            base_edge_list=[16, 32, 64, 128, 256],
            scale_ranges=((1, 64), (32, 128), (64, 256), (128, 512),
                          (256, 2048)), sigma=0.4,
            loss_bbox=dict(type="SmoothL1Loss", beta=0.11, loss_weight=1.0)))
    return cfg


KINDS = ("retina", "free_anchor", "fcos_caffe", "fcos", "fovea", "ssd")
ENGINES = {"RetinaNet": single_stage.RetinaNet, "FCOS": single_stage.FCOS,
           "FOVEA": single_stage.FOVEA,
           "SingleStageDetector": single_stage.SingleStageDetector}
# each head's output convs: (name, kernel std) so that on these maps the
# scores spread over (0, 1) and the boxes move; SSD's per-level classifiers
# and regressors scaled to its maps (conv4_1 L2-normalised to 20, the
# others' activations ~100)
OUTPUT_STDS = {"retina_cls": 0.3, "retina_reg": 0.05, "fcos_cls": 0.3,
               "fcos_reg": 0.05, "fcos_centerness": 0.3, "fovea_cls": 0.3,
               "fovea_reg": 0.05}
OUTPUT_STDS.update({f"cls_conv{i}": s for i, s in enumerate(
    (0.03, 2e-4, 3e-4, 4e-4, 4e-4, 4e-4))})
OUTPUT_STDS.update({f"reg_conv{i}": s for i, s in enumerate(
    (0.003, 2e-5, 3e-5, 4e-5, 4e-5, 4e-5))})


def _draw_outputs(tree, seed):
    """The head's output convs drawn at ``OUTPUT_STDS`` (SSD's, with an
    SSDVGG backbone, whose L2 norm scale is set to its init, 20), biases
    0."""
    p = dict(tree["params"])
    head = dict(p["bbox_head"])
    ssd = "l2_norm_scale" in p["backbone"]
    if ssd:
        p["backbone"] = dict(p["backbone"], l2_norm_scale=np.full(
            512, 20.0, np.float32))
    rng = np.random.default_rng(seed)
    for name in sorted(head):
        std = OUTPUT_STDS.get(name)
        if std is None or (name.startswith(("cls_conv", "reg_conv"))
                           and not ssd):
            continue
        shape = np.asarray(head[name]["kernel"]).shape
        head[name] = dict(kernel=rng.normal(0, std, shape).astype(np.float32),
                          bias=np.zeros(shape[-1:], np.float32))
    p["bbox_head"] = head
    return {"params": p}


def calibrated(kind, img, ish, seed, test_cfg=None, train_cfg=None,
               cfg=None):
    """(JAX engine, JAX params, port engine) of ``cfg`` (default
    ``dense_cfg(kind)``) on one set of weights, the frozen BNs calibrated
    on ``img`` by the port and carried back into the JAX tree."""
    cfg = cfg or dense_cfg(kind)
    jeng = getattr(jax_single_stage, cfg["type"])(cfg, train_cfg, test_cfg)
    tree = _draw_outputs(jax_param_tree(jeng, seed), seed)
    port = ENGINES[cfg["type"]](cfg, test_cfg, device="cpu",
                                train_cfg=train_cfg)
    sd = state_dict_from_jax(tree)
    assert set(sd) == set(port.model.state_dict())
    port.load_state_dict(sd)
    if calibrate_frozen_bn(port, [dict(img=img, img_shape=ish)]):
        backbone = {k: v.numpy() for k, v in port.model.state_dict().items()
                    if k.startswith("backbone.")}
        merged, _ = merge_params(
            tree["params"], convert_torch_checkpoint(backbone)["params"])
        tree = {"params": merged}
    return jeng, tree, port


def jax_feats(jeng, params, img):
    """The neck's (or the backbone's) maps of NHWC ``img`` from a jitted
    JAX program, NCHW."""
    mod = jeng.module
    feats = jax.jit(lambda p, x: mod.apply(p, x, method=mod.extract_feat))(
        params, jnp.asarray(img))
    return tuple(_nchw(f) for f in feats)


def image(kind, seed=3):
    """The kind's canvas of noise with its img_shape, pad_shape and a
    scale factor of 0.8 / 0.82 across the axes."""
    hw = SSD_CANVAS if kind == "ssd" else CANVAS
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(1,) + hw + (3,)).astype(np.float32) * 40
    ish = np.array([hw[0] - 4.0, hw[1] - 6.0], np.float32)
    return (img, ish, np.array(hw, np.float32),
            np.array([0.8, 0.82, 0.8, 0.82], np.float32))


@pytest.fixture(scope="module")
def dense_runs():
    """Per kind: the JAX ``simple_test`` on its image, the JAX maps, the
    port engine and its inputs."""
    out = {}
    for kind in KINDS:
        args = image(kind)
        test_cfg = SSD_TEST_CFG if kind == "ssd" else TEST_CFG
        jeng, params, port = calibrated(kind, args[0], args[1], seed=11,
                                        test_cfg=test_cfg)
        want = jax.device_get(jeng.simple_test(params, jnp.asarray(args[0]),
                                               args[1], args[3]))
        out[kind] = dict(port=port, want=want, args=args, tree=params,
                         feats=jax_feats(jeng, params, args[0]))
    return out


# --------------------------------------------------------------- losses
LOSS_CASES = {
    "focal": (dict(type="FocalLoss", gamma=2.0, alpha=0.25,
                   loss_weight=1.5), "labels"),
    "focal fovea": (dict(type="FocalLoss", gamma=1.5, alpha=0.4),
                    "labels"),
    "iou": (dict(type="IoULoss", loss_weight=2.0), "boxes"),
    "bounded iou": (dict(type="BoundedIoULoss", beta=0.2, eps=1e-3),
                    "boxes"),
    "balanced l1": (dict(type="BalancedL1Loss", alpha=0.5, gamma=1.5,
                         beta=1.0, loss_weight=1.0), "targets"),
}


def _boxes(rng, n):
    xy = rng.uniform(0, 60, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(2, 40, (n, 2))],
                          1).astype(np.float32)


@pytest.mark.parametrize("case", list(LOSS_CASES))
@pytest.mark.parametrize("reduce", ["mean", "avg_factor", "none"])
def test_losses_match_jax(case, reduce):
    """The focal, IoU, bounded-IoU and balanced-L1 losses built from their
    configs (``build_loss``) against the JAX classes on the same inputs and
    weights (per row, or per element): the mean, the sum over
    ``avg_factor`` and no reduction, within 1e-6 relative."""
    cfg, kind = LOSS_CASES[case]
    rng = np.random.default_rng(len(case))
    if kind == "labels":
        pred = rng.standard_normal((12, 5)).astype(np.float32) * 2
        target = rng.integers(0, 6, 12)
        weight = rng.uniform(0, 2, 12).astype(np.float32)
    elif kind == "boxes":
        target = _boxes(rng, 12)
        pred = target + rng.normal(0, 4, (12, 4)).astype(np.float32)
        weight = np.repeat(rng.uniform(0, 2, (12, 1)), 4, 1).astype(
            np.float32)
    else:
        pred = rng.standard_normal((12, 4)).astype(np.float32) * 2
        target = rng.standard_normal((12, 4)).astype(np.float32)
        weight = rng.uniform(0, 2, (12, 4)).astype(np.float32)
    kw = {"mean": {}, "avg_factor": dict(avg_factor=7.0),
          "none": dict(reduction_override="none")}[reduce]
    want = np.asarray(jax_losses.build_loss(dict(cfg))(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weight), **kw))
    got = losses.build_loss(dict(cfg))(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(weight), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("loss_type", ["GHMC", "GHMR"])
@pytest.mark.parametrize("bins", [10, 30])
def test_ghm_losses_match_jax(loss_type, bins):
    """``GHMC`` (1-based labels over 5 sigmoid channels) and ``GHMR`` with
    ignored rows (label weight 0), at 10 bins and at 30, where most bins
    are empty: within 1e-6 relative of the JAX losses, and the bin edges
    equal to ``jnp.linspace``'s."""
    rng = np.random.default_rng(bins)
    lw = (rng.uniform(size=16) > 0.25).astype(np.float32)
    if loss_type == "GHMC":
        pred = rng.standard_normal((16, 5)).astype(np.float32) * 3
        target = rng.integers(0, 6, 16)
        cfg = dict(type="GHMC", bins=bins, loss_weight=0.7)
    else:
        pred = rng.standard_normal((16, 4)).astype(np.float32) * 0.05
        target = np.zeros((16, 4), np.float32)
        lw = np.repeat(lw[:, None], 4, 1)
        cfg = dict(type="GHMR", mu=0.02, bins=bins, loss_weight=1.3)
    want = float(jax_losses.build_loss(dict(cfg))(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(lw)))
    got = float(losses.build_loss(dict(cfg))(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(lw)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert want > 0
    for top in (1e-6, 1e3):
        np.testing.assert_array_equal(
            np.array(losses._ghm_edges(bins, top), np.float32),
            np.asarray(jnp.linspace(0, 1, bins + 1).at[-1].add(top)))


def test_every_jax_loss_is_registered():
    """The port's ``build_loss`` builds every type the JAX one builds."""
    assert set(jax_losses.LOSSES.module_dict) <= set(
        losses.LOSSES.module_dict)


# -------------------------------------------------------------- anchors
@pytest.mark.parametrize("size,ratio", [(300, 0.15), (300, 0.2),
                                        (512, 0.1), (512, 0.15)])
def test_ssd_anchor_generators_match_jax(size, ratio):
    """``ssd_anchor_generators`` at SSD300 and SSD512 with each
    first-level special case (COCO, VOC): the per-level base anchors
    (the scale-2 square second) and the grid anchors of each level's map,
    bit for bit the JAX package's."""
    strides = ((8, 16, 32, 64, 100, 300) if size == 300
               else (8, 16, 32, 64, 128, 256, 512))
    ratios = ([2], [2, 3], [2, 3], [2, 3], [2], [2]) if size == 300 else (
        [2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2])
    cfg = dict(input_size=size, anchor_strides=strides,
               basesize_ratio_range=(ratio, 0.9), anchor_ratios=ratios)
    gens, got_strides = anchors.ssd_anchor_generators_from_cfg(cfg)
    jgens, _ = jax_anchors.ssd_anchor_generators_from_cfg(cfg)
    assert got_strides == strides and len(gens) == len(jgens)
    for s, g, j in zip(strides, gens, jgens):
        np.testing.assert_array_equal(g.base_anchors, j.base_anchors)
        fh = max(size // s, 1)
        np.testing.assert_array_equal(g.grid_anchors((fh, fh + 1), s),
                                      j.grid_anchors((fh, fh + 1), s))
    assert [g.num_base_anchors for g in gens] == [2 + 2 * len(r)
                                                  for r in ratios]


# ------------------------------------------------------------- backbone
def test_ssd_vgg_matches_jax():
    """``SSDVGG`` at 300×300 from the JAX module's parameters
    (``ssd_vgg_state_dict``: mmdet's ``features.{k}``, ``extra.{i}``,
    ``l2_norm.weight``): six maps of (512, 1024, 512, 256, 256, 256)
    channels at 37², 18², 9², 5², 3² and 1² (floor pooling), the first
    conv4_1's L2-normalised, each within 1e-5 of its max |·|."""
    x = np.random.default_rng(1).standard_normal(
        (1, 300, 300, 3)).astype(np.float32)
    jnet = JaxSSDVGG(input_size=300)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(2)

    def fill(path, s):
        z = rng.standard_normal(s.shape)
        if path[-1].key == "kernel":
            z = z * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif path[-1].key == "l2_norm_scale":
            z = 20.0 + z
        else:
            z = z * 0.1
        return z.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x))
    net = build_submodule(dict(type="SSDVGG", input_size=300,
                               with_last_pool=False, ceil_mode=True,
                               out_feature_indices=(22, 34)), BACKBONES)
    sd = ssd_vgg_state_dict(params["params"])
    assert set(sd) == set(net.state_dict())
    assert {"features.0.weight", "features.28.bias", "features.31.weight",
            "features.33.weight", "extra.7.weight",
            "l2_norm.weight"} <= set(sd)
    net.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = net(_nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [
        (512, 37, 37), (1024, 18, 18), (512, 9, 9), (256, 5, 5),
        (256, 3, 3), (256, 1, 1)]
    for g, w in zip(got, want):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), 1e-5)


def test_ssd_vgg_without_conv4_output():
    """Without 3 in ``out_indices`` (the JAX module's condition) there is no
    L2-normalised conv4_1 output and no ``l2_norm.weight``."""
    net = SSDVGG(out_indices=(4,))
    assert "l2_norm.weight" not in net.state_dict()
    with torch.no_grad():
        outs = net(torch.zeros(1, 3, 300, 300))
    assert [o.shape[1] for o in outs] == [1024, 512, 256, 256, 256]


# ---------------------------------------------------------------- heads
HEAD_CASES = {
    "RetinaHead": dict(num_classes=6, in_channels=8, feat_channels=8,
                       stacked_convs=2),
    "FreeAnchorRetinaHead": dict(num_classes=6, in_channels=8,
                                 feat_channels=8, stacked_convs=1),
    "SSDHead": dict(num_classes=6, in_channels=(8, 12, 8),
                    anchor_ratios=([2], [2, 3], [2])),
    "FCOSHead": dict(num_classes=6, in_channels=8, feat_channels=64,
                     stacked_convs=2, strides=(8, 16, 32)),
    "FoveaHead": dict(num_classes=6, in_channels=8, feat_channels=8,
                      stacked_convs=2),
}


@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_dense_heads_match_jax(name):
    """Each dense head from the JAX head's parameters
    (``dense_head_state_dict``; random non-separable weights, FCOS's
    GroupNorm affines and per-level scales among them) on three levels of
    a non-square map (8×12, 4×6, 1×1: a GroupNorm of one position): every
    per-level output within 1e-5 of its max |·|, in (h, w, anchor, class)
    order once flattened."""
    kw = HEAD_CASES[name]
    rng = np.random.default_rng(len(name))
    chans = kw["in_channels"] if name == "SSDHead" else (8, 8, 8)
    xs = [rng.standard_normal((1, h, w, c)).astype(np.float32)
          for (h, w), c in zip(((8, 12), (4, 6), (1, 1)), chans)]
    jhead = getattr(jax_heads, name)(**kw)
    jx = [jnp.asarray(x) for x in xs]
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jx)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.2,
        shapes)
    want = jax.jit(jhead.apply)(params, jx)
    head = build_submodule(dict(kw, type=name), HEADS)
    sd = dense_head_state_dict(params["params"])
    assert set(sd) == set(head.state_dict())
    head.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = head([_nchw(x) for x in xs])
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            w = np.asarray(w)
            _rel_close(g.numpy(), w.transpose(0, 3, 1, 2), 1e-5)
            _rel_close(single_stage.flat(g, 1).numpy(), w.reshape(-1, 1),
                       1e-5)


# -------------------------------------------------------------- engines
@pytest.mark.parametrize("kind", KINDS)
def test_simple_test_matches_jax(dense_runs, kind, monkeypatch):
    """``simple_test`` on the JAX maps: the same NMS picks in the same rows
    with the same labels and validity, boxes within 1e-3 px and scores
    within 2e-6 (the zoo's limits), for RetinaNet, FreeAnchor, FCOS
    (caffe, extra convs on the outputs; pytorch, on the inputs), FoveaBox
    and SSD300 (softmax, no ``nms_pre`` cut on the 1-px level)."""
    run = dense_runs[kind]
    port = run["port"]
    monkeypatch.setattr(port, "backbone_maps", lambda img, ish: run["feats"])
    got = [t.numpy() for t in port.simple_test(*run["args"])]
    want = run["want"]
    dets, labels, mask = got
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_array_equal(labels[mask], want[1][mask])
    assert 5 < mask.sum() and len(set(labels[mask])) > 2
    np.testing.assert_allclose(dets[mask, :4], want[0][mask, :4], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets[mask, 4], want[0][mask, 4], rtol=0,
                               atol=2e-6)
    assert not dets[~mask].any()


def test_ssd_maps_and_anchors_agree(dense_runs):
    """SSD300's six maps are 37², 18², 9², 5², 3², 1² (8096 anchors, not
    mmdet's 8732), and each level's anchor count is its map's positions
    times the head's anchors per position."""
    port = dense_runs["ssd"]["port"]
    feats = dense_runs["ssd"]["feats"]
    assert [f.shape[2] for f in feats] == [37, 18, 9, 5, 3, 1]
    n = [port.level_anchors(f.shape[2], f.shape[3], lvl).shape[0]
         for lvl, f in enumerate(feats)]
    assert n == [37 * 37 * 4, 18 * 18 * 6, 81 * 6, 25 * 6, 9 * 4, 4]
    assert sum(n) == 8096


def test_decode_order_is_the_jax_nhwc_order(dense_runs, monkeypatch):
    """A level's map flattened in (anchor, h, w) order, the NCHW memory
    order, gives other detections than the JAX engine's: the (h, w,
    anchor) order is what the parity above rests on."""
    run = dense_runs["retina"]
    port = run["port"]
    monkeypatch.setattr(port, "backbone_maps", lambda img, ish: run["feats"])
    monkeypatch.setattr(single_stage, "flat", lambda m, k: m[0].reshape(
        -1, k).float())
    got = port.simple_test(*run["args"])
    assert not np.allclose(got[0].numpy(), run["want"][0])


@pytest.mark.parametrize("kind", ["retina", "fcos_caffe"])
def test_bf16_simple_test_runs(dense_runs, kind, monkeypatch):
    """A bf16 engine on the same weights (the head's weights pre-cast) and
    the same maps in bf16: the output shapes, float32 boxes and scores in
    [score_thr, 1]; most of the float32 engine's detections kept."""
    run = dense_runs[kind]
    port = run["port"]
    cfg = dense_cfg(kind)
    eng = ENGINES[cfg["type"]](cfg, TEST_CFG, device="cpu",
                               dtype=torch.bfloat16)
    eng.load_state_dict(port.model.state_dict())
    eng.cast_head_params_bf16()
    monkeypatch.setattr(eng, "backbone_maps", lambda img, ish: tuple(
        f.bfloat16() for f in run["feats"]))
    got = eng.simple_test(*run["args"])
    dets, mask = got[0], got[2]
    assert dets.dtype == torch.float32 and dets.shape == (30, 5)
    assert ((dets[mask, 4] >= 0.05) & (dets[mask, 4] <= 1)).all()
    assert mask.sum() >= 0.5 * run["want"][2].sum()


# ------------------------------------------------------- build_detector
@pytest.mark.parametrize("kind", KINDS)
def test_build_detector_builds_dense_engines(kind):
    """``build_detector`` builds each engine from its config with mmdet's
    names (the heads' ``cls_convs.0.conv``, FCOS's ``cls_convs.0.gn`` and
    ``scales.4.scale``, SSD's ``cls_convs.5``, SSDVGG's ``features.33``);
    the seeded classifiers' bias is the prior −log(99); the single-image
    API refuses a single-stage engine."""
    cfg = dense_cfg(kind)
    eng = apis.build_detector(cfg, test_cfg=TEST_CFG, device="cpu")
    assert type(eng) is ENGINES[cfg["type"]]
    names = set(eng.model.state_dict())
    expect = {"ssd": {"bbox_head.cls_convs.5.weight",
                      "backbone.features.33.weight",
                      "backbone.l2_norm.weight"},
              "fcos": {"bbox_head.cls_convs.1.gn.weight",
                       "bbox_head.scales.4.scale",
                       "bbox_head.fcos_centerness.bias"},
              "fovea": {"bbox_head.fovea_reg.weight",
                        "bbox_head.reg_convs.0.conv.weight"},
              "retina": {"bbox_head.retina_cls.bias",
                         "neck.fpn_convs.4.conv.weight"}}
    assert expect[{"fcos_caffe": "fcos", "free_anchor": "retina"}.get(
        kind, kind)] <= names
    cls = {"retina": "retina_cls", "free_anchor": "retina_cls",
           "fovea": "fovea_cls"}.get(kind, "fcos_cls")
    if kind != "ssd":
        bias = getattr(eng.model.bbox_head, cls).bias
        np.testing.assert_allclose(bias.detach().numpy(), -np.log(99),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="simple_test"):
        apis.detect_image(eng, dict(img=None, img_shape=None,
                                    pad_shape=None, scale_factor=None))
