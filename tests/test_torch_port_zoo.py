"""The multi-stage R-CNN zoo in the port against the JAX package: the ConvFC
bbox heads, ``FCNMaskHead``, ``mask_target``, ``paste_masks``,
``mask_branch_loss``, the config-built losses, the multi-level RoI
extractor, ``CascadeRCNN`` (3 stages) and ``MaskRCNN`` ``simple_test``
(``tests/test_multi_stage.py:base_cfg``), and the refusals of what is
not ported yet; the training step and the ``build_detector`` /
``train_detector`` dispatch are in ``tests/test_torch_port_zoo_train.py``.

Weights: a JAX parameter tree filled from numpy crosses to the port
through ``state_dict_from_jax``; the port calibrates the frozen-BN
statistics on the image and the trunk's weights cross back
(``convert_torch_checkpoint``, which knows the trunk's names).  Every
stage's ``fc_reg`` is inflated to normal(0, 0.05) so that the arg-max
class's deltas move the boxes between stages.  Each JAX reference is
computed once, in a module fixture; ``simple_test`` is held on the maps
of a jitted JAX program (XLA:CPU rounds jitted convolutions otherwise than
op-by-op ones).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine.multi_stage import CascadeRCNN as JaxCascadeRCNN
from hvrnet_tpu.engine.multi_stage import MaskRCNN as JaxMaskRCNN
from hvrnet_tpu.engine.train_mask import \
    mask_branch_loss as jax_mask_branch_loss
from hvrnet_tpu.models import losses as jax_losses
from hvrnet_tpu.models.bbox_heads.convfc_bbox_head import (
    ConvFCBBoxHead as JaxConvFCBBoxHead)
from hvrnet_tpu.models.bbox_heads.convfc_bbox_head import (
    DoubleConvFCBBoxHead as JaxDoubleConvFCBBoxHead)
from hvrnet_tpu.models.bbox_heads.convfc_bbox_head import (
    SharedFCBBoxHead as JaxSharedFCBBoxHead)
from hvrnet_tpu.models.mask_heads import FCNMaskHead as JaxFCNMaskHead
from hvrnet_tpu.models.mask_heads import mask_target as jax_mask_target
from hvrnet_tpu.models.mask_heads import paste_masks_np
from hvrnet_tpu.models.roi_extractor import \
    SingleRoIExtractor as JaxSingleRoIExtractor
from hvrnet_tpu.utils.checkpoint import (convert_torch_checkpoint,
                                         merge_params)
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine import CascadeRCNN, MaskRCNN
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.engine.train_mask import mask_branch_loss
from hvrnet_tpu_torch.models import losses
from hvrnet_tpu_torch.models.bbox_heads.convfc_bbox_head import (
    DoubleConvFCBBoxHead, SharedFCBBoxHead)
from hvrnet_tpu_torch.models.builder import build_roi_extractor
from hvrnet_tpu_torch.models.mask_heads import (FCNMaskHead, mask_target,
                                                paste_masks)
from hvrnet_tpu_torch.models.registry import HEADS
from hvrnet_tpu_torch.models.two_stage import build_submodule
from hvrnet_tpu_torch.utils.weights import (bbox_head_state_dict,
                                            mask_head_state_dict,
                                            state_dict_from_jax)
from tests.test_multi_stage import TEST_CFG, base_cfg
from tests.test_torch_port_backbone import jax_param_tree
from tests.test_torch_port_image import _nchw, _rel_close

torch.set_num_threads(2)

CANVAS = (64, 96)
MODELS = {"cascade": (JaxCascadeRCNN, CascadeRCNN, 3, False),
          "mask": (JaxMaskRCNN, MaskRCNN, 1, True)}


def _tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _random_tree(module, x, seed, *args):
    """``module``'s parameters filled with standard normals (a
    non-separable weight, so a wrong flattening order shows)."""
    params = module.init(jax.random.PRNGKey(0), x, *args)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.2,
        params)


# ------------------------------------------------------------- ConvFC heads
CONVFC = {
    "shared_fc": (JaxSharedFCBBoxHead, SharedFCBBoxHead, dict(
        type="SharedFCBBoxHead", in_channels=16, fc_out_channels=24,
        num_classes=5)),
    "shared_fc_avg_pool": (JaxSharedFCBBoxHead, SharedFCBBoxHead, dict(
        type="SharedFCBBoxHead", in_channels=16, fc_out_channels=24,
        num_classes=5, with_avg_pool=True, reg_class_agnostic=True)),
    "branch_convs": (JaxConvFCBBoxHead, None, dict(
        type="ConvFCBBoxHead", num_shared_convs=1, num_cls_convs=1,
        num_cls_fcs=1, num_reg_convs=2, num_reg_fcs=1, in_channels=16,
        conv_out_channels=8, fc_out_channels=24, num_classes=5)),
    "branch_fcs_only": (JaxConvFCBBoxHead, None, dict(
        type="ConvFCBBoxHead", num_cls_convs=1, in_channels=16,
        conv_out_channels=8, fc_out_channels=24, num_classes=5)),
    "double": (JaxDoubleConvFCBBoxHead, DoubleConvFCBBoxHead, dict(
        type="DoubleConvFCBBoxHead", num_convs=2, num_fcs=2, in_channels=16,
        conv_out_channels=8, fc_out_channels=24, num_classes=5)),
}


@pytest.mark.parametrize("case", list(CONVFC))
def test_convfc_heads_match_jax(case):
    """``SharedFCBBoxHead``, ``ConvFCBBoxHead`` and ``DoubleConvFCBBoxHead``
    from the JAX heads' parameters on a 16-channel RoI map (784 inputs,
    below the JAX converter's 2048 rule): cls and reg within 1e-5 of their
    max |·|.  The dense layers ``state_dict_from_jax`` permutes from the HWC
    flattening are the first of each branch that holds the map
    (``shared_fcs.0``; ``cls_fcs.0`` / ``fc_reg`` after branch convs;
    ``fc0``), none after ``with_avg_pool``; the names are mmdet's
    (``shared_fcs.0``, ``cls_convs.0.conv``) and the double head's the JAX
    module's (``conv0``, ``fc0``)."""
    jax_cls, port_cls, cfg = CONVFC[case]
    kw = {k: v for k, v in cfg.items() if k != "type"}
    pooled = np.random.default_rng(1).standard_normal(
        (6, 7, 7, 16)).astype(np.float32)
    jhead = jax_cls(**kw)
    params = _random_tree(jhead, jnp.asarray(pooled), 2)
    want = jhead.apply(params, jnp.asarray(pooled))
    head = build_submodule(cfg, HEADS)
    assert port_cls is None or type(head) is port_cls
    sd = bbox_head_state_dict(params["params"], cfg)
    assert set(sd) == set(head.state_dict())
    head.load_state_dict(_tensors(sd))
    expect = {"shared_fc": {"shared_fcs.0"}, "shared_fc_avg_pool": set(),
              "branch_convs": {"cls_fcs.0", "reg_fcs.0"},
              "branch_fcs_only": {"fc_cls", "fc_reg"},
              "double": {"fc0"}}[case]
    assert head.flat_map_fcs == expect
    with torch.no_grad():
        got = head(_nchw(pooled))
    for g, w in zip(got, want):
        _rel_close(g.numpy(), w, 1e-5)


# -------------------------------------------------------------- mask head
@pytest.mark.parametrize("upsample", ["deconv", "nearest"])
@pytest.mark.parametrize("agnostic", [False, True])
def test_fcn_mask_head_matches_jax(upsample, agnostic):
    """``FCNMaskHead`` (2 convs, 8 channels) from the JAX head's parameters
    (``mask_head_state_dict``: ``conv{k}`` → ``convs.{k}.conv``, the
    transposed conv's kernel transposed and flipped): logits (R, K, 28, 28)
    within 1e-5 of their max |·|, with K = num_classes - 1 or 1."""
    kw = dict(num_convs=2, in_channels=6, conv_out_channels=8,
              num_classes=5, upsample_method=upsample,
              class_agnostic=agnostic)
    x = np.random.default_rng(3).standard_normal(
        (4, 14, 14, 6)).astype(np.float32)
    jhead = JaxFCNMaskHead(**kw)
    params = _random_tree(jhead, jnp.asarray(x), 4)
    want = np.asarray(jhead.apply(params, jnp.asarray(x)))
    head = FCNMaskHead(**kw)
    sd = mask_head_state_dict(params["params"])
    assert set(sd) == set(head.state_dict())
    head.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = head(_nchw(x)).numpy()
    assert got.shape == (4, 1 if agnostic else 4, 28, 28)
    _rel_close(got, want.transpose(0, 3, 1, 2), 1e-5)


def _gt_masks(rng, g, h, w):
    """``g`` binary masks of rectangles and ellipses."""
    masks = np.zeros((g, h, w), np.float32)
    yy, xx = np.mgrid[:h, :w]
    for i in range(g):
        y0, x0 = rng.uniform(0, h / 2), rng.uniform(0, w / 2)
        bh, bw = rng.uniform(4, h / 2), rng.uniform(4, w / 2)
        if i % 2:
            masks[i] = ((yy - y0 - bh / 2) ** 2 / (bh / 2) ** 2
                        + (xx - x0 - bw / 2) ** 2 / (bw / 2) ** 2) <= 1
        else:
            masks[i, int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = 1
    return masks


def _mask_case(seed, n_rois=24, g=3, hw=(40, 56)):
    rng = np.random.default_rng(seed)
    masks = _gt_masks(rng, g, *hw)
    xy = rng.uniform(-4, 30, (n_rois, 2))
    # integer and fractional corners, some past the raster's edge
    wh = rng.uniform(1, 40, (n_rois, 2))
    wh[::3] = np.round(wh[::3])
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    gt_inds = rng.integers(0, g, n_rois)
    return masks, boxes, gt_inds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_target_matches_jax(seed):
    """``mask_target`` bit for bit the JAX function's (which pools RoI r on
    its own gathered mask): on the (R, H, W) stack, and on the (G, H, W)
    masks with each RoI's ground-truth index in its first column."""
    masks, boxes, gi = _mask_case(seed)
    rois = np.concatenate([np.zeros((len(boxes), 1), np.float32), boxes], 1)
    want = np.asarray(jax_mask_target(jnp.asarray(masks[gi]),
                                      jnp.asarray(rois), 28))
    per_roi = np.concatenate([np.arange(len(boxes))[:, None], boxes], 1)
    got = mask_target(torch.from_numpy(masks[gi]),
                      torch.from_numpy(per_roi.astype(np.float32)), 28)
    by_index = mask_target(torch.from_numpy(masks), torch.from_numpy(
        np.concatenate([gi[:, None], boxes], 1).astype(np.float32)), 28)
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(by_index.numpy(), want)


@pytest.mark.parametrize("classes", [1, 4])
def test_paste_masks_matches_jax(classes):
    """``paste_masks`` bit for bit ``paste_masks_np`` (cv2's float resize):
    boxes of 1 to 120 px, fractional corners, boxes past the image's right
    and bottom edges; per class the same list of uint8 masks."""
    rng = np.random.default_rng(classes)
    n = 40
    probs = rng.uniform(0, 1, (n, 28, 28, classes)).astype(np.float32)
    xy = rng.uniform(0, 150, (n, 2))
    wh = rng.uniform(0, 120, (n, 2))
    dets = np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 1))],
                          1).astype(np.float32)
    labels = rng.integers(0, classes, n)
    want = paste_masks_np(probs, dets, labels, 160, 200)
    got = paste_masks(probs.transpose(0, 3, 1, 2), dets, labels, 160, 200)
    assert len(got) == len(want) == classes
    assert sum(len(c) for c in want) == n
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("agnostic", [False, True])
def test_mask_branch_loss_matches_jax(agnostic):
    """``mask_branch_loss`` on the (G, H, W) masks with each RoI's
    ground-truth index against the JAX loss on the gathered (R, H, W) stack:
    within 1e-6 relative; negatives weigh nothing."""
    masks, boxes, gi = _mask_case(5)
    rng = np.random.default_rng(6)
    n = len(boxes)
    k = 1 if agnostic else 4
    pred = rng.standard_normal((n, 28, 28, k)).astype(np.float32) * 3
    labels = rng.integers(1, 5, n)
    pos = rng.uniform(size=n) < 0.5
    rois = np.concatenate([np.zeros((n, 1)), boxes], 1).astype(np.float32)
    want = float(jax_mask_branch_loss(
        jnp.asarray(pred), jnp.asarray(masks[gi]), jnp.asarray(rois),
        jnp.asarray(labels), jnp.asarray(pos), 28, agnostic))
    got = mask_branch_loss(
        torch.from_numpy(pred.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(masks), torch.from_numpy(np.concatenate(
            [gi[:, None], boxes], 1).astype(np.float32)),
        torch.from_numpy(labels), torch.from_numpy(pos), 28, agnostic)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert want > 0


LOSS_CASES = {
    "ce softmax": (dict(type="CrossEntropyLoss"), "labels"),
    "ce sigmoid": (dict(type="CrossEntropyLoss", use_sigmoid=True,
                        loss_weight=2.0), "labels"),
    "ce sigmoid targets": (dict(type="CrossEntropyLoss", use_sigmoid=True),
                           "targets"),
    "smooth l1": (dict(type="SmoothL1Loss", beta=0.5, loss_weight=0.7),
                  "targets"),
    "mse": (dict(type="MSELoss", reduction="sum"), "targets"),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
@pytest.mark.parametrize("reduce", ["default", "avg_factor", "none"])
def test_losses_match_jax(case, reduce):
    """The config-built losses (``build_loss``) against the JAX classes on
    the same inputs and weights: each reduction (the config's, a mean over
    ``avg_factor``, none) within 1e-6 relative; ``weight_reduce_loss``'s
    refusal of ``avg_factor`` with a sum."""
    cfg, kind = LOSS_CASES[case]
    rng = np.random.default_rng(len(case))
    pred = rng.standard_normal((12, 5)).astype(np.float32) * 2
    # softmax labels 0..4; sigmoid labels 1-based over the 5 channels
    target = (rng.integers(0, 5 + bool(cfg.get("use_sigmoid")), 12)
              if kind == "labels" else
              rng.uniform(0, 1, (12, 5)).astype(np.float32))
    weight = rng.uniform(0, 2, 12 if kind == "labels" else (12, 5)).astype(
        np.float32)
    kw = {"default": {}, "avg_factor": dict(avg_factor=7.0,
                                            reduction_override="mean"),
          "none": dict(reduction_override="none")}[reduce]
    jcfg = dict(cfg)
    jloss = jax_losses.build_loss(jcfg)
    want = np.asarray(jloss(jnp.asarray(pred), jnp.asarray(target),
                            jnp.asarray(weight), **kw))
    loss = losses.build_loss(dict(cfg))
    got = loss(torch.from_numpy(pred), torch.from_numpy(target),
               torch.from_numpy(weight), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="avg_factor"):
        losses.weight_reduce_loss(torch.ones(3), reduction="sum",
                                  avg_factor=2.0)


def test_expand_binary_labels_matches_jax():
    """1-based labels → one-hot rows, label 0 all zero, weights broadcast:
    equal to the JAX function's."""
    labels = np.array([0, 1, 3, 2, 0])
    weights = np.arange(5, dtype=np.float32)
    want = jax_losses.expand_binary_labels(jnp.asarray(labels),
                                           jnp.asarray(weights), 3)
    got = losses.expand_binary_labels(torch.from_numpy(labels),
                                      torch.from_numpy(weights), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------ RoI extractor
def test_multilevel_roi_extractor_matches_jax():
    """Over three maps (strides 4, 8, 16): ``map_roi_levels`` equal to the
    JAX levels and the pooled RoIs (each from its level's map) within 1e-6
    of their max; one map pools as RoIAlign; ``RoIPool`` is refused."""
    cfg = dict(roi_layer=dict(type="RoIAlign", out_size=7, sample_num=2),
               out_channels=8, featmap_strides=[4, 8, 16])
    rng = np.random.default_rng(7)
    feats = [rng.standard_normal((1, 64 // s, 96 // s, 8)).astype(np.float32)
             for s in (4, 8, 16)]
    xy = rng.uniform(0, 40, (30, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(600), (30, 2)))
    rois = np.concatenate([np.zeros((30, 1)), xy, xy + wh],
                          1).astype(np.float32)
    jext = JaxSingleRoIExtractor(**cfg)
    ext = build_roi_extractor(dict(cfg, type="SingleRoIExtractor"))
    lv = ext.map_roi_levels(torch.from_numpy(rois), 3).numpy()
    np.testing.assert_array_equal(lv, np.asarray(jext.map_roi_levels(
        jnp.asarray(rois), 3)))
    assert set(lv) == {0, 1, 2}
    want = np.asarray(jext([jnp.asarray(f) for f in feats],
                           jnp.asarray(rois)))
    got = ext([_nchw(f) for f in feats], torch.from_numpy(rois)).numpy()
    _rel_close(got, want.transpose(0, 3, 1, 2), 1e-6)
    one = ext(_nchw(feats[2]), torch.from_numpy(rois)).numpy()
    want1 = np.asarray(jext([jnp.asarray(feats[2])], jnp.asarray(rois)))
    _rel_close(one, want1.transpose(0, 3, 1, 2), 1e-6)
    with pytest.raises(NotImplementedError, match="RoIPool"):
        build_roi_extractor(dict(cfg, roi_layer=dict(type="RoIPool",
                                                     out_size=7)))


# --------------------------------------------------------- engines
def _inflate_fc_reg(tree, seed):
    """Every stage's ``fc_reg`` kernel drawn at std 0.05."""
    p = dict(tree["params"])
    rng = np.random.default_rng(seed)
    for name in [k for k in p if k.startswith("bbox_head")]:
        shape = np.asarray(p[name]["fc_reg"]["kernel"]).shape
        p[name] = dict(p[name], fc_reg=dict(p[name]["fc_reg"], kernel=(
            rng.normal(0, 0.05, shape).astype(np.float32))))
    return {"params": p}


def _trunk_back(tree, port):
    """The JAX tree with the port's calibrated trunk (backbone, shared head
    and RPN; the JAX converter knows their names)."""
    trunk = {k: v.numpy() for k, v in port.model.state_dict().items()
             if k.startswith(("backbone.", "shared_head.", "rpn_head."))}
    merged, missing = merge_params(tree["params"],
                                   convert_torch_checkpoint(trunk)["params"])
    assert missing and all(m.startswith(("bbox_head", "mask_head"))
                           for m in missing)
    return {"params": merged}


def _calibrated(name, model_cfg, frames, seed, test_cfg=None,
                train_cfg=None):
    """(JAX engine, JAX params, port engine) on one set of weights, the
    frozen BNs calibrated on ``frames``."""
    jax_cls, port_cls, _, _ = MODELS[name]
    jeng = jax_cls(model_cfg, train_cfg, test_cfg)
    tree = _inflate_fc_reg(jax_param_tree(jeng, seed), seed)
    port = port_cls(model_cfg, test_cfg, device="cpu", train_cfg=train_cfg)
    sd = state_dict_from_jax(tree, model_cfg)
    assert set(sd) == set(port.model.state_dict())
    port.load_state_dict(sd)
    calibrate_frozen_bn(port, frames)
    return jeng, _trunk_back(tree, port), port


def _jax_maps(jeng, params, img):
    """(c5, rpn cls, rpn reg) of NHWC ``img`` from a jitted JAX program,
    NCHW."""
    mod = jeng.module

    def maps(p, x):
        f0 = mod.apply(p, x, method=mod.extract_feat)[0]
        cls, reg = mod.apply(p, f0, method=mod.rpn)
        return mod.apply(p, f0, method=mod.shared), cls, reg

    return tuple(_nchw(m) for m in jax.jit(maps)(params, jnp.asarray(img)))


@pytest.fixture(scope="module")
def zoo_test():
    """Per model: the JAX ``simple_test`` on a 64×96 noise image (scale
    factor 0.8 and 0.82 across the axes), the port engine and its inputs."""
    rng = np.random.default_rng(3)
    img = rng.normal(size=(1,) + CANVAS + (3,)).astype(np.float32) * 40
    ish = np.array([CANVAS[0] - 4.0, CANVAS[1] - 2.0], np.float32)
    psh = np.array(CANVAS, np.float32)
    sf = np.array([0.8, 0.82, 0.8, 0.82], np.float32)
    out = {}
    for name, (_, _, stages, with_mask) in MODELS.items():
        jeng, params, port = _calibrated(
            name, base_cfg(stages, with_mask), [dict(img=img, img_shape=ish)],
            seed=11, test_cfg=TEST_CFG)
        want = jax.device_get(jeng.simple_test(params, jnp.asarray(img), ish,
                                               psh, sf))
        out[name] = dict(port=port, want=want, args=(img, ish, psh, sf),
                         maps=_jax_maps(jeng, params, img))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_simple_test_matches_jax(zoo_test, name, monkeypatch):
    """``simple_test`` on the JAX maps: the same NMS picks in the same rows
    with the same labels, boxes within 1e-3 px and scores within 2e-6; the
    mask probabilities of every row within 1e-5.  The cascade refines
    between its 3 stages (boxes move) and averages their scores."""
    run = zoo_test[name]
    port = run["port"]
    monkeypatch.setattr(port, "backbone_maps", lambda img, ish: run["maps"])
    got = port.simple_test(*run["args"])
    want = run["want"]
    assert len(got) == len(want) == (4 if name == "mask" else 3)
    dets, labels, mask = (t.numpy() for t in got[:3])
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_array_equal(labels[mask], want[1][mask])
    assert mask.sum() > 3
    np.testing.assert_allclose(dets[mask, :4], want[0][mask, :4], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets[mask, 4], want[0][mask, 4], rtol=0,
                               atol=2e-6)
    if name == "mask":
        probs = got[3].numpy()
        assert probs.shape == (10, 10, 28, 28)
        np.testing.assert_allclose(probs, want[3].transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-5)


def test_cascade_stages_refine(zoo_test):
    """Each stage's boxes are the previous stage's moved by its arg-max
    class's deltas: the three stages pool three different box sets, and
    one stage alone detects otherwise."""
    port = zoo_test["cascade"]["port"]
    c5, cls_map, reg_map = zoo_test["cascade"]["maps"]
    img, ish, psh, sf = zoo_test["cascade"]["args"]
    with torch.no_grad():
        boxes = port._proposals_lanes(c5, cls_map, reg_map, [ish],
                                      [psh])[0][0]
        seen = [boxes]
        for st in range(2):
            cls, reg = port.stage_forward(c5, seen[-1], st)
            seen.append(port.refine(seen[-1], cls, reg, st, ish))
    for a, b in zip(seen, seen[1:]):
        assert (a - b).abs().max() > 0.05


# ------------------------------------------------------------ refusals
def _refused(what):
    cfg = base_cfg(1, True)
    if what in ("gcb", "gen_attention"):
        plugin = {"gcb": dict(gcb=dict(ratio=1. / 4.),
                              stage_with_gcb=(False, True, True, False)),
                  "gen_attention": dict(
                      gen_attention=dict(spatial_range=-1),
                      stage_with_gen_attention=((), (), (0,), ()))}[what]
        return dict(cfg, backbone=dict(cfg["backbone"], **plugin))
    if what == "HRFPN":
        return dict(cfg, neck=dict(type="HRFPN", in_channels=[18, 36],
                                   out_channels=256))
    return dict(cfg, bbox_roi_extractor=dict(
        cfg["bbox_roi_extractor"], roi_layer=dict(type="RoIPool",
                                                  out_size=7)))


@pytest.mark.parametrize("what", ["RoIPool", "gcb", "gen_attention",
                                  "HRFPN"])
def test_not_ported_yet_is_refused(what):
    """What waits for a later slice raises "not ported yet" when the
    engine is built: ``RoIPool``, the ResNet plugins (the global context
    block, generalized attention) and the HRNet neck ``HRFPN``.  (The
    ``dcn`` plugin is ported: ``tests/test_torch_port_deform.py``.)"""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        apis.build_detector(_refused(what), test_cfg=TEST_CFG, device="cpu")


def test_inference_detector_refuses_multi_stage(zoo_test):
    """The single-image API does not run a multi-stage engine (the JAX
    API fails in ``frame_features``): ``ValueError``, pointing at
    ``simple_test``."""
    with pytest.raises(ValueError, match="simple_test"):
        apis.detect_image(zoo_test["cascade"]["port"], dict(
            img=None, img_shape=None, pad_shape=None, scale_factor=None))


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_simple_test_runs(zoo_test, name, monkeypatch):
    """A bf16 engine on the same weights (the heads' weights pre-cast) and
    the same float32 maps: the same output shapes, float32 boxes, scores
    in [0, 1], mask probabilities in [0, 1]."""
    run = zoo_test[name]
    port = run["port"]
    _, port_cls, stages, with_mask = MODELS[name]
    eng = port_cls(base_cfg(stages, with_mask), TEST_CFG, device="cpu",
                   dtype=torch.bfloat16)
    eng.load_state_dict(port.model.state_dict())
    eng.cast_head_params_bf16()
    assert eng.model.bbox_head.state_dict()[
        "0.fc_cls.weight" if stages > 1 else "fc_cls.weight"].dtype == \
        torch.bfloat16
    c5, cls_map, reg_map = run["maps"]
    monkeypatch.setattr(eng, "backbone_maps", lambda img, ish: (
        c5.bfloat16(), cls_map.bfloat16(), reg_map.bfloat16()))
    got = eng.simple_test(*run["args"])
    want = port.simple_test(*run["args"])
    assert [t.shape for t in got] == [t.shape for t in want]
    dets, mask = got[0], got[2]
    assert dets.dtype == torch.float32 and mask.any()
    assert ((dets[mask, 4] >= 0) & (dets[mask, 4] <= 1)).all()
    if with_mask:
        assert got[3].dtype == torch.float32
        assert ((got[3] >= 0) & (got[3] <= 1)).all()
