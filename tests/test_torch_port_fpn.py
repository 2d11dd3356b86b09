"""The FPN half of the two-stage zoo in the port against the JAX package:
the pytorch-style 4-stage ResNet (depths 18 and 50, ``with_cp``), the
``FPN`` and ``BFP`` necks, ``HTCMaskHead``, ``FusedSemanticHead``,
``MaskIoUHead`` and ``GridHead``, Hybrid Task Cascade's ``simple_test``
with and without its semantic branch, the reused mask trunks against the
JAX replay, and the Mask Scoring and Grid R-CNN configs (whose extra heads
neither engine runs).  The training step is in
``tests/test_torch_port_fpn_train.py``.

The engines are ResNet-18 (pytorch style, 4 stages) with a 32-channel
FPN on a 64×96 canvas, the RPN on P2 at stride 4 with 32-px anchors and
every RoI pooled from P2, as the JAX engine runs an FPN config.
Weights: a JAX parameter tree filled from numpy crosses to the port
through ``state_dict_from_jax``; the port calibrates the frozen-BN
statistics on the image and the backbone's weights cross back
(``convert_torch_checkpoint``).  Each JAX reference is computed once, in a
module fixture; ``simple_test`` is held on the FPN maps, RPN maps and
semantic embedding of a jitted JAX program (XLA:CPU rounds jitted
convolutions otherwise than op-by-op ones).
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine.multi_stage import GridRCNN as JaxGridRCNN
from hvrnet_tpu.engine.multi_stage import \
    HybridTaskCascade as JaxHybridTaskCascade
from hvrnet_tpu.engine.multi_stage import \
    MaskScoringRCNN as JaxMaskScoringRCNN
from hvrnet_tpu.models.backbones.resnet import ResNet as JaxResNet
from hvrnet_tpu.models.mask_heads import FusedSemanticHead as JaxSemantic
from hvrnet_tpu.models.mask_heads import GridHead as JaxGridHead
from hvrnet_tpu.models.mask_heads import HTCMaskHead as JaxHTCMaskHead
from hvrnet_tpu.models.mask_heads import MaskIoUHead as JaxMaskIoUHead
from hvrnet_tpu.models.necks.fpn import BFP as JaxBFP
from hvrnet_tpu.models.necks.fpn import FPN as JaxFPN
from hvrnet_tpu.utils.checkpoint import (convert_torch_checkpoint,
                                         merge_params)
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine import (GridRCNN, HybridTaskCascade,
                                     MaskScoringRCNN)
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.engine.multi_stage import mean_scale
from hvrnet_tpu_torch.models.backbones.resnet import ResNet
from hvrnet_tpu_torch.models.mask_heads import (
    FusedSemanticHead, GridHead, HTCMaskHead, MaskIoUHead,
    resize_bilinear_antialiased)
from hvrnet_tpu_torch.models.registry import NECKS
from hvrnet_tpu_torch.models.two_stage import build_submodule
from hvrnet_tpu_torch.utils.weights import (backbone_state_dict,
                                            mask_head_state_dict,
                                            neck_state_dict,
                                            semantic_head_state_dict,
                                            state_dict_from_jax)
from tests.test_torch_port_backbone import jax_param_tree
from tests.test_torch_port_image import _nchw, _rel_close
from tests.test_torch_port_zoo import _random_tree, _tensors

torch.set_num_threads(2)

CANVAS = (64, 96)
STDS = ([0.1, 0.1, 0.2, 0.2], [0.05, 0.05, 0.1, 0.1],
        [0.033, 0.033, 0.067, 0.067])
TEST_CFG = dict(
    rpn=dict(nms_pre=200, nms_post=24, max_num=24, nms_thr=0.7,
             min_bbox_size=0),
    rcnn=dict(score_thr=0.01, nms=dict(type="nms", iou_thr=0.5),
              max_per_img=10, mask_thr_binary=0.5))


def _extractor(size, strides):
    return dict(type="SingleRoIExtractor",
                roi_layer=dict(type="RoIAlign", out_size=size, sample_num=2),
                out_channels=32, featmap_strides=strides)


def fpn_cfg(kind="htc"):
    """A tiny config of the FPN zoo on ResNet-18 (pytorch style, 4 stages)
    and a 32-channel FPN: ``htc`` (3 stages, per-stage ``HTCMaskHead``s,
    the semantic branch), ``htc_nosem`` (the same without the semantic
    branch), ``mask_scoring`` (Mask R-CNN with a ``mask_iou_head``) or
    ``grid`` (Faster R-CNN with a ``grid_head``)."""
    cfg = dict(
        type="HybridTaskCascade",
        backbone=dict(type="ResNet", depth=18, num_stages=4,
                      strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      style="pytorch", norm_eval=True),
        neck=dict(type="FPN", in_channels=(64, 128, 256, 512),
                  out_channels=32, num_outs=5),
        rpn_head=dict(type="RPNHead", in_channels=32, feat_channels=32,
                      anchor_scales=[8], anchor_ratios=[0.5, 1.0, 2.0],
                      anchor_strides=[4, 8, 16, 32, 64]),
        bbox_roi_extractor=_extractor(7, [4, 8, 16, 32]))

    def head(stds, agnostic=True):
        return dict(type="SharedFCBBoxHead", num_fcs=2, in_channels=32,
                    fc_out_channels=32, roi_feat_size=7, num_classes=9,
                    target_means=[0.] * 4, target_stds=stds,
                    reg_class_agnostic=agnostic)

    def mask_head(kind):
        return dict(type=kind, num_convs=2, in_channels=32,
                    conv_out_channels=32, num_classes=9)

    if kind.startswith("htc"):
        cfg.update(bbox_head=[head(s) for s in STDS],
                   mask_roi_extractor=_extractor(14, [4, 8, 16, 32]),
                   mask_head=[mask_head("HTCMaskHead") for _ in STDS])
        if kind == "htc":
            cfg.update(
                semantic_roi_extractor=_extractor(14, [8]),
                semantic_head=dict(
                    type="FusedSemanticHead", num_ins=5, fusion_level=1,
                    num_convs=2, in_channels=32, conv_out_channels=32,
                    num_classes=12, ignore_label=255, loss_weight=0.2),
                semantic_fusion=("bbox", "mask"))
    elif kind == "mask_scoring":
        cfg.update(type="MaskScoringRCNN", bbox_head=head(STDS[0], False),
                   mask_roi_extractor=_extractor(14, [4, 8, 16, 32]),
                   mask_head=mask_head("FCNMaskHead"),
                   mask_iou_head=dict(
                       type="MaskIoUHead", num_convs=4, num_fcs=2,
                       roi_feat_size=14, in_channels=32,
                       conv_out_channels=32, fc_out_channels=64,
                       num_classes=9))
    else:
        cfg.update(type="GridRCNN", bbox_head=head(STDS[0]),
                   grid_roi_extractor=_extractor(14, [4, 8, 16, 32]),
                   grid_head=dict(type="GridHead", grid_points=9,
                                  num_convs=2, in_channels=32,
                                  conv_out_channels=72))
    return cfg


ENGINES = {"htc": (JaxHybridTaskCascade, HybridTaskCascade),
           "htc_nosem": (JaxHybridTaskCascade, HybridTaskCascade),
           "mask_scoring": (JaxMaskScoringRCNN, MaskScoringRCNN),
           "grid": (JaxGridRCNN, GridRCNN)}


def _filled(module, x, seed, bn_stats=False):
    """``module``'s parameter tree (traced, not run) filled from numpy:
    He-normal conv kernels, zero biases; frozen BNs identity, or with
    ``bn_stats`` random positive scales and variances and random means
    and shifts."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if bn_stats and name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if bn_stats and name in ("mean", "bias"):
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ------------------------------------------------------------ backbone
RESNET_KW = dict(num_stages=4, strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                 out_indices=(0, 1, 2, 3), style="pytorch")


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_matches_jax(depth):
    """The pytorch-style ResNet over 4 stages (``BasicBlock`` at depth 18,
    ``Bottleneck`` with its stride on the 3×3 at 50), forward, from the JAX
    module's parameters (``backbone_state_dict``) with random frozen-BN
    statistics: the 4 maps at strides 4 to 32 with 64·e to 512·e channels,
    each within 1e-5 of its max |·|."""
    x = np.random.default_rng(depth).standard_normal(
        (1, 64, 96, 3)).astype(np.float32)
    jnet = JaxResNet(depth=depth, **RESNET_KW)
    params = _filled(jnet, jnp.asarray(x), depth, bn_stats=True)
    want = jnet.apply(params, jnp.asarray(x))
    net = ResNet(depth=depth, **RESNET_KW)
    sd = backbone_state_dict(params["params"])
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = net(_nchw(x))
    e = 1 if depth == 18 else 4
    assert [tuple(g.shape) for g in got] == [
        (1, 64 * e * 2 ** i, 16 >> i, 24 >> i) for i in range(4)]
    for g, w in zip(got, want):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), 1e-5)


def test_resnet_with_cp_equals_without():
    """``with_cp`` recomputes each block in the backward pass: the maps and
    the gradients of every parameter and of the input bit for bit those of
    the plain ResNet-18 (pytorch style, 4 stages)."""
    torch.manual_seed(0)
    x = torch.randn(1, 3, 64, 96)
    runs = []
    for with_cp in (False, True):
        net = ResNet(depth=18, with_cp=with_cp, **RESNET_KW)
        if runs:
            net.load_state_dict(runs[0][0].state_dict())
        xi = x.clone().requires_grad_(True)
        outs = net(xi)
        sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
        runs.append((net, outs, xi.grad))
    (net0, outs0, gx0), (net1, outs1, gx1) = runs
    assert net1.layer1.with_cp and not net0.layer1.with_cp
    for a, b in zip(outs0, outs1):
        assert torch.equal(a, b)
    assert torch.equal(gx0, gx1)
    for (n, p0), p1 in zip(net0.named_parameters(), net1.parameters()):
        assert torch.equal(p0.grad, p1.grad), n


# ---------------------------------------------------------------- necks
NECK_CASES = {
    "fpn max-pool extras": (JaxFPN, dict(
        type="FPN", in_channels=(8, 16, 32, 64), out_channels=16,
        num_outs=5)),
    "fpn conv extras on inputs": (JaxFPN, dict(
        type="FPN", in_channels=(8, 16, 32, 64), out_channels=16,
        num_outs=5, start_level=1, add_extra_convs=True,
        extra_convs_on_inputs=True)),
    "fpn conv extras on outputs": (JaxFPN, dict(
        type="FPN", in_channels=(8, 16, 32, 64), out_channels=16,
        num_outs=6, end_level=2, add_extra_convs=True,
        extra_convs_on_inputs=False, relu_before_extra_convs=True)),
    "bfp": (JaxBFP, dict(type="BFP", in_channels=16, num_levels=5,
                         refine_level=2)),
}


@pytest.mark.parametrize("case", list(NECK_CASES))
def test_necks_match_jax(case):
    """``FPN`` from the JAX neck's parameters (``neck_state_dict``: mmdet's
    ``lateral_convs.{i}.conv`` / ``fpn_convs.{i}.conv``, the extra convs
    appended) with stride-2 max-pool extras, stride-2 conv extras on the
    last used input (``start_level`` 1, RetinaNet's) and on the last
    output through a ReLU (``end_level`` 2), and ``BFP`` (its half-pixel
    nearest resizes, ``nearest-exact``): every output within 1e-5 of its
    max |·|."""
    jax_cls, cfg = NECK_CASES[case]
    rng = np.random.default_rng(len(case))
    if jax_cls is JaxBFP:
        shapes = [(16 >> i or 1, 24 >> i, 16) for i in range(5)]
    else:
        shapes = [(16 >> i, 24 >> i, c) for i, c in
                  enumerate(cfg["in_channels"])]
    xs = [rng.standard_normal((1,) + s).astype(np.float32) for s in shapes]
    jneck = jax_cls(**{k: v for k, v in cfg.items() if k != "type"})
    jx = [jnp.asarray(x) for x in xs]
    params = _random_tree(jneck, jx, 5)
    want = jneck.apply(params, jx)
    neck = build_submodule(cfg, NECKS)
    sd = neck_state_dict(params["params"]) if "params" in params else {}
    assert set(sd) == set(neck.state_dict())
    neck.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got = neck([_nchw(x) for x in xs])
    assert len(got) == len(want) == (5 if jax_cls is JaxBFP
                                     else cfg["num_outs"])
    for g, w in zip(got, want):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), 1e-5)


# ---------------------------------------------------------------- heads
@pytest.mark.parametrize("with_res", [False, True])
def test_htc_mask_head_matches_jax(with_res):
    """``HTCMaskHead`` (2 convs, 8 channels) from the JAX head's
    parameters, without and with the previous stage's features (its
    ``conv_res`` then exists): the logits (R, 4, 28, 28), the trunk
    features of ``return_feat`` and those of ``return_logits=False``
    within 1e-5 of their max |·|."""
    kw = dict(num_convs=2, in_channels=8, conv_out_channels=8, num_classes=5)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 14, 14, 8)).astype(np.float32)
    res = rng.standard_normal((4, 14, 14, 8)).astype(np.float32)
    jhead = JaxHTCMaskHead(**kw)
    args = (jnp.asarray(res),) if with_res else ()
    params = _random_tree(jhead, jnp.asarray(x), 8, *args)
    logits, feat = jhead.apply(params, jnp.asarray(x), *args,
                               return_feat=True)
    trunk = jhead.apply(params, jnp.asarray(x), *args, return_logits=False)
    head = HTCMaskHead(**kw, with_conv_res=with_res)
    sd = mask_head_state_dict(params["params"])
    assert set(sd) == set(head.state_dict())
    assert ("conv_res.conv.weight" in sd) == with_res
    head.load_state_dict(_tensors(sd))
    targs = (_nchw(res),) if with_res else ()
    with torch.no_grad():
        got, got_feat = head(_nchw(x), *targs, return_feat=True)
        got_trunk = head(_nchw(x), *targs, return_logits=False)
    assert got.shape == (4, 4, 28, 28)
    for g, w in ((got, logits), (got_feat, feat), (got_trunk, trunk)):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), 1e-5)


def test_antialiased_resize_matches_jax():
    """``resize_bilinear_antialiased`` against ``jax.image.resize(...,
    "bilinear")``, down (16×24 → 8×12, 4×6, 5×7) and up (→ 32×48, 13×21):
    within 1e-6 of the max |·|; torch's resize without ``antialias`` is off
    by more than 0.1 when downsampling."""
    x = np.random.default_rng(2).standard_normal(
        (1, 16, 24, 3)).astype(np.float32)
    for size in ((8, 12), (4, 6), (5, 7), (32, 48), (13, 21)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1,) + size + (3,),
                                           "bilinear")).transpose(0, 3, 1, 2)
        got = resize_bilinear_antialiased(_nchw(x), size).numpy()
        _rel_close(got, want, 1e-6, str(size))
        if size[0] < 16:
            plain = torch.nn.functional.interpolate(
                _nchw(x), size=size, mode="bilinear", align_corners=False)
            assert np.abs(plain.numpy() - want).max() > 0.1


def test_fused_semantic_head_matches_jax():
    """``FusedSemanticHead`` (5 levels at strides 4 to 64, fusion level 1,
    2 convs) from the JAX head's parameters (``semantic_head_state_dict``:
    ``lateral_fuse`` → ``lateral_convs.1.conv``, ``lateral{i}`` →
    ``lateral_convs.{i}.conv``, ``conv_seg`` → ``conv_logits``): the
    segmentation logits and the embedding at the fusion level's 8×12,
    within 1e-5 of their max |·|.  P2 is downsampled to P3, so a resize
    without antialiasing fails here."""
    kw = dict(num_ins=5, fusion_level=1, num_convs=2, in_channels=8,
              conv_out_channels=8, num_classes=6)
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal((1, 16 >> i or 1, 24 >> i, 8)).astype(
        np.float32) for i in range(5)]
    jhead = JaxSemantic(**kw)
    jx = [jnp.asarray(x) for x in xs]
    params = _random_tree(jhead, jx, 10)
    seg, emb = jhead.apply(params, jx)
    head = FusedSemanticHead(**kw)
    sd = semantic_head_state_dict(params["params"], 1)
    assert set(sd) == set(head.state_dict())
    head.load_state_dict(_tensors(sd))
    with torch.no_grad():
        got_seg, got_emb = head([_nchw(x) for x in xs])
        no_logits = head([_nchw(x) for x in xs], with_logits=False)
    assert got_seg.shape == (1, 6, 8, 12) and got_emb.shape == (1, 8, 8, 12)
    assert no_logits[0] is None and torch.equal(no_logits[1], got_emb)
    for g, w in ((got_seg, seg), (got_emb, emb)):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), 1e-5)


def _extra_heads(seed):
    """The JAX ``MaskIoUHead`` (8 mask-feature channels and the pooled
    mask, 3 classes) and
    ``GridHead`` (2 convs at 72 channels, random GroupNorm affines) with
    their parameters and outputs on random inputs."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((5, 14, 14, 8)).astype(np.float32)
    pred = rng.uniform(0, 1, (5, 28, 28, 1)).astype(np.float32)
    iou_kw = dict(num_convs=2, num_fcs=2, roi_feat_size=14, in_channels=8,
                  conv_out_channels=8, fc_out_channels=16, num_classes=4)
    jiou = JaxMaskIoUHead(**iou_kw)
    iou_params = _random_tree(jiou, jnp.asarray(feat), seed,
                              jnp.asarray(pred))
    grid_kw = dict(grid_points=9, num_convs=2, in_channels=8,
                   conv_out_channels=72)
    jgrid = JaxGridHead(**grid_kw)
    grid_params = _random_tree(jgrid, jnp.asarray(feat), seed + 1)
    return dict(
        feat=feat, pred=pred, iou_kw=iou_kw, grid_kw=grid_kw,
        iou=(iou_params, np.asarray(jiou.apply(
            iou_params, jnp.asarray(feat), jnp.asarray(pred)))),
        grid=(grid_params, np.asarray(jgrid.apply(grid_params,
                                                  jnp.asarray(feat)))))


def _with_heads(htc_tree, heads):
    """The HTC engine's JAX tree with the extra heads' subtrees beside it
    (the JAX engine builds neither)."""
    return {"params": dict(htc_tree["params"],
                           mask_iou_head=heads["iou"][0]["params"],
                           grid_head=heads["grid"][0]["params"])}


def test_mask_iou_head_matches_jax(fpn_runs):
    """``MaskIoUHead`` through ``state_dict_from_jax`` (a JAX tree with a
    ``mask_iou_head`` subtree): ``fcs.0`` reads the flattened (8, 7, 7)
    map, its input axis permuted from the JAX HWC flattening (the
    unpermuted weight gives another result); the (R, 3) IoUs within 1e-5
    of their max |·|."""
    heads = _extra_heads(3)
    cfg = dict(fpn_cfg(), mask_iou_head=dict(type="MaskIoUHead",
                                             **heads["iou_kw"]))
    sd = state_dict_from_jax(_with_heads(fpn_runs["htc"]["tree"], heads),
                             cfg)
    head = MaskIoUHead(**heads["iou_kw"])
    own = {k[len("mask_iou_head."):]: v for k, v in sd.items()
           if k.startswith("mask_iou_head.")}
    assert set(own) == set(head.state_dict())
    assert head.flat_map_fcs == {"fcs.0"} and head.flat_map_hw == 7
    head.load_state_dict(own)
    feat, pred = _nchw(heads["feat"]), _nchw(heads["pred"])
    with torch.no_grad():
        got = head(feat, pred).numpy()
    want = heads["iou"][1]
    assert got.shape == (5, 3)
    _rel_close(got, want, 1e-5)
    kernel = np.asarray(heads["iou"][0]["params"]["fc0"]["kernel"])
    with torch.no_grad():
        head.fcs[0].weight.copy_(torch.from_numpy(kernel.T.copy()))
        assert np.abs(head(feat, pred).numpy() - want).max() > \
            1e-2 * np.abs(want).max()


def test_grid_head_matches_jax(fpn_runs):
    """``GridHead`` through ``state_dict_from_jax`` (a JAX tree with a
    ``grid_head`` subtree): GroupNorm(36) at flax's epsilon 1e-6 and the
    two transposed convs ``deconv1`` / ``deconv2`` transposed and flipped;
    the (R, 9, 56, 56) heatmaps within 1e-5 of their max |·|, and an
    unflipped ``deconv2`` kernel gives another result."""
    heads = _extra_heads(5)
    sd = state_dict_from_jax(_with_heads(fpn_runs["htc"]["tree"], heads),
                             fpn_cfg())
    head = GridHead(**heads["grid_kw"])
    own = {k[len("grid_head."):]: v for k, v in sd.items()
           if k.startswith("grid_head.")}
    assert set(own) == set(head.state_dict())
    head.load_state_dict(own)
    assert head.convs[0].gn.eps == 1e-6
    with torch.no_grad():
        got = head(_nchw(heads["feat"])).numpy()
    want = heads["grid"][1].transpose(0, 3, 1, 2)
    assert got.shape == (5, 9, 56, 56)
    _rel_close(got, want, 1e-5)
    kernel = np.asarray(heads["grid"][0]["params"]["deconv2"]["kernel"])
    with torch.no_grad():
        head.deconv2.weight.copy_(torch.from_numpy(
            kernel.transpose(2, 3, 0, 1).copy()))
        assert np.abs(head(_nchw(heads["feat"])).numpy() - want).max() > \
            1e-2 * np.abs(want).max()


# --------------------------------------------------------------- engines
def _inflate_heads(tree, seed):
    """Every stage's ``fc_reg`` kernel drawn at std 0.05 and ``fc_cls`` at
    0.3, so that boxes move between stages and scores spread."""
    p = dict(tree["params"])
    rng = np.random.default_rng(seed)
    for name in sorted(k for k in p if k.startswith("bbox_head")):
        node = dict(p[name])
        for fc, std in (("fc_reg", 0.05), ("fc_cls", 0.3)):
            shape = np.asarray(node[fc]["kernel"]).shape
            node[fc] = dict(node[fc], kernel=rng.normal(0, std, shape).astype(
                np.float32))
        p[name] = node
    return {"params": p}


def calibrated(kind, frames, seed, test_cfg=None, train_cfg=None):
    """(JAX engine, JAX params, port engine) of ``fpn_cfg(kind)`` on one
    set of weights, the frozen BNs calibrated on ``frames`` by the port
    and carried back into the JAX tree."""
    jax_cls, port_cls = ENGINES[kind]
    cfg = fpn_cfg(kind)
    jeng = jax_cls(cfg, train_cfg, test_cfg)
    tree = _inflate_heads(jax_param_tree(jeng, seed), seed)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port = port_cls(cfg, test_cfg, device="cpu", train_cfg=train_cfg)
    assert any("run by neither" in str(w.message) for w in caught) == (
        kind in ("mask_scoring", "grid"))
    sd = state_dict_from_jax(tree, cfg)
    assert set(sd) == set(port.model.state_dict())
    port.load_state_dict(sd)
    calibrate_frozen_bn(port, frames)
    backbone = {k: v.numpy() for k, v in port.model.state_dict().items()
                if k.startswith("backbone.")}
    merged, missing = merge_params(
        tree["params"], convert_torch_checkpoint(backbone)["params"])
    assert missing and not any(m.startswith("backbone") for m in missing)
    return jeng, {"params": merged}, port


def jax_maps(jeng, params, img):
    """(FPN maps tuple, rpn cls, rpn reg, semantic embedding or None) of
    NHWC ``img`` from a jitted JAX program, NCHW."""
    mod = jeng.module

    def maps(p, x):
        feats = mod.apply(p, x, method=mod.extract_feat)
        cls, reg = mod.apply(p, feats[0], method=mod.rpn)
        emb = (mod.apply(p, feats, method=mod.semantic)[1]
               if jeng.with_semantic else None)
        return feats, cls, reg, emb

    feats, cls, reg, emb = jax.jit(maps)(params, jnp.asarray(img))
    return (tuple(_nchw(f) for f in feats), _nchw(cls), _nchw(reg),
            None if emb is None else _nchw(emb))


def inject(monkeypatch, port, maps):
    """The port engine fed ``jax_maps`` in place of its backbone, neck and
    semantic head."""
    feats, cls, reg, emb = maps
    monkeypatch.setattr(port, "backbone_maps",
                        lambda img, ish: (feats, cls, reg))
    monkeypatch.setattr(port, "semantic_embedding", lambda m: emb)


@pytest.fixture(scope="module")
def fpn_runs():
    """Per engine kind: the JAX ``simple_test`` on a 64×96 noise image
    (scale factor 0.8 and 0.82 across the axes), the JAX maps, the port
    engine and its inputs."""
    rng = np.random.default_rng(3)
    img = rng.normal(size=(1,) + CANVAS + (3,)).astype(np.float32) * 40
    ish = np.array([CANVAS[0] - 4.0, CANVAS[1] - 2.0], np.float32)
    psh = np.array(CANVAS, np.float32)
    sf = np.array([0.8, 0.82, 0.8, 0.82], np.float32)
    out = {}
    for kind in ENGINES:
        jeng, params, port = calibrated(
            kind, [dict(img=img, img_shape=ish)], seed=11,
            test_cfg=TEST_CFG)
        want = jax.device_get(jeng.simple_test(params, jnp.asarray(img), ish,
                                               psh, sf))
        out[kind] = dict(port=port, want=want, args=(img, ish, psh, sf),
                         maps=jax_maps(jeng, params, img), tree=params)
    return out


@pytest.mark.parametrize("kind", list(ENGINES))
def test_simple_test_matches_jax(fpn_runs, kind, monkeypatch):
    """``simple_test`` on the JAX maps (FPN, RPN on P2, the semantic
    embedding): HTC with and without its semantic branch, and the Mask
    Scoring and Grid R-CNN configs, which detect as Mask R-CNN and Faster
    R-CNN on the FPN (no MaskIoU or grid parameters on either side).  The
    same NMS picks in the same rows with the same labels, boxes within
    1e-3 px, scores within 2e-6, and every row's mask probabilities (HTC:
    the mean of its 3 stages' sigmoids) within 1e-5."""
    run = fpn_runs[kind]
    port = run["port"]
    inject(monkeypatch, port, run["maps"])
    got = port.simple_test(*run["args"])
    want = run["want"]
    with_mask = kind != "grid"
    assert len(got) == len(want) == (4 if with_mask else 3)
    assert not any(k.startswith(("mask_iou_head", "grid_head"))
                   for k in port.model.state_dict())
    dets, labels, mask = (t.numpy() for t in got[:3])
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_array_equal(labels[mask], want[1][mask])
    assert mask.sum() > 3
    np.testing.assert_allclose(dets[mask, :4], want[0][mask, :4], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets[mask, 4], want[0][mask, 4], rtol=0,
                               atol=2e-6)
    if with_mask:
        probs = got[3].numpy()
        assert probs.shape == (10, 8, 28, 28)
        np.testing.assert_allclose(probs, want[3].transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-5)


def test_semantic_branch_moves_the_detections(fpn_runs, monkeypatch):
    """The semantic embedding reaches the box stages and the masks: with it
    zeroed the same HTC engine gives other scores and masks."""
    run = fpn_runs["htc"]
    port = run["port"]
    feats, cls, reg, emb = run["maps"]
    inject(monkeypatch, port, (feats, cls, reg, torch.zeros_like(emb)))
    got = port.simple_test(*run["args"])
    want = run["want"]
    assert np.abs(got[0][:, 4].numpy() - want[0][:, 4]).max() > 1e-3
    assert np.abs(got[3].numpy()
                  - want[3].transpose(0, 3, 1, 2)).max() > 1e-3


def test_mask_trunks_reused_equal_the_replay(fpn_runs):
    """At test time every HTC stage pools the same mask RoIs: the mean
    mask probabilities of ``mask_probs``, each trunk run once and its
    features handed on, bit for bit those of the JAX form (``mask_stage``:
    heads 0..s-1 replayed trunk-only for stage s), on detections with the
    semantic features added; stage 0 has no ``conv_res``, stages 1 and 2
    do, and the stages' logits differ."""
    run = fpn_runs["htc"]
    port = run["port"]
    model = port.model
    assert model.mask_head[0].conv_res is None
    assert all(h.conv_res is not None for h in model.mask_head[1:])
    feats, _, _, emb = run["maps"]
    sf = run["args"][3]
    dets = torch.from_numpy(run["want"][0][:, :5].copy())
    with torch.no_grad():
        reused = port.mask_probs(feats[0], dets, sf, emb)
        rois = dets[:, :4] * mean_scale(sf)
        rois = torch.cat([torch.zeros_like(rois[:, :1]), rois], dim=1)
        pooled = port.fuse_semantic(port.mask_roi_extractor(feats[0], rois),
                                    emb, rois, "mask")
        replay = [model.mask_stage(pooled, s) for s in range(3)]
    assert torch.equal(reused, sum(torch.sigmoid(r) for r in replay) / 3)
    assert not torch.equal(replay[1], replay[2])


def test_single_level_pooling_is_the_jax_engines(fpn_runs):
    """With an FPN the JAX engine pools every RoI from P2 alone: the RoI
    extractor given one map pools at ``featmap_strides[0]`` (4), and the
    semantic extractor the stride-8 embedding, as the JAX extractors do."""
    from hvrnet_tpu.models.roi_extractor import \
        SingleRoIExtractor as JaxSingleRoIExtractor
    port = fpn_runs["htc"]["port"]
    feats = fpn_runs["htc"]["maps"][0]
    emb = fpn_runs["htc"]["maps"][3]
    rng = np.random.default_rng(6)
    xy = rng.uniform(0, 60, (9, 2))
    rois = np.concatenate([np.zeros((9, 1)), xy, xy + rng.uniform(
        4, 40, (9, 2))], 1).astype(np.float32)
    cfg = fpn_cfg()
    for ext, key, fmap in ((port.roi_extractor, "bbox_roi_extractor",
                            feats[0]),
                           (port.semantic_roi_extractor,
                            "semantic_roi_extractor", emb)):
        jcfg = {k: v for k, v in cfg[key].items() if k != "type"}
        want = np.asarray(JaxSingleRoIExtractor(**jcfg)(
            [jnp.asarray(fmap.numpy().transpose(0, 2, 3, 1))],
            jnp.asarray(rois)))
        got = ext([fmap], torch.from_numpy(rois)).numpy()
        _rel_close(got, want.transpose(0, 3, 1, 2), 1e-6, key)


def test_bf16_htc_simple_test_runs(fpn_runs, monkeypatch):
    """A bf16 HTC engine on the same weights (the heads' weights pre-cast)
    and the same float32 maps in bf16: the same output shapes, float32
    boxes, scores and mask probabilities in [0, 1]."""
    run = fpn_runs["htc"]
    port = run["port"]
    eng = HybridTaskCascade(fpn_cfg(), TEST_CFG, device="cpu",
                            dtype=torch.bfloat16)
    eng.load_state_dict(port.model.state_dict())
    eng.cast_head_params_bf16()
    assert eng.model.mask_head[2].conv_logits.weight.dtype == torch.bfloat16
    feats, cls, reg, emb = run["maps"]
    inject(monkeypatch, eng, (tuple(f.bfloat16() for f in feats),
                              cls.bfloat16(), reg.bfloat16(),
                              emb.bfloat16()))
    got = eng.simple_test(*run["args"])
    want = port.simple_test(*run["args"])
    assert [t.shape for t in got] == [t.shape for t in want]
    dets, mask = got[0], got[2]
    assert dets.dtype == torch.float32 and mask.any()
    assert ((dets[mask, 4] >= 0) & (dets[mask, 4] <= 1)).all()
    assert got[3].dtype == torch.float32
    assert ((got[3] >= 0) & (got[3] <= 1)).all()


@pytest.mark.parametrize("kind", list(ENGINES))
def test_build_detector_builds_fpn_engines(kind):
    """``build_detector`` builds each engine from its FPN config with
    mmdet's names (``neck.lateral_convs.0.conv``, ``neck.fpn_convs.3.conv``,
    ``mask_head.{i}.conv_res.conv``, ``semantic_head.lateral_convs.4.conv``)
    and the 4-stage backbone's ``layer4``; the Mask Scoring and Grid R-CNN
    configs warn that their extra head is not run; the single-image API
    refuses a multi-stage engine."""
    _, port_cls = ENGINES[kind]
    cfg = fpn_cfg(kind)
    if kind in ("mask_scoring", "grid"):
        with pytest.warns(UserWarning, match="run by neither"):
            eng = apis.build_detector(cfg, test_cfg=TEST_CFG, device="cpu")
    else:
        eng = apis.build_detector(cfg, test_cfg=TEST_CFG, device="cpu")
    assert type(eng) is port_cls
    names = set(eng.model.state_dict())
    assert {"backbone.layer4.1.conv2.weight", "backbone.layer4.1.bn2.bias",
            "neck.lateral_convs.0.conv.weight",
            "neck.fpn_convs.3.conv.bias"} <= names
    assert ("semantic_head.lateral_convs.4.conv.weight" in names) == (
        kind == "htc")
    assert ("mask_head.2.conv_res.conv.weight" in names) == \
        kind.startswith("htc")
    assert "mask_head.0.conv_res.conv.weight" not in names
    assert eng.with_mask == (kind != "grid")
    with pytest.raises(ValueError, match="simple_test"):
        apis.detect_image(eng, dict(img=None, img_shape=None,
                                    pad_shape=None, scale_factor=None))


def test_class_wise_nms_at_htc_scale_matches_jax():
    """HTC's decode shape in small: 80 foreground classes over 120 RoIs
    (9600 candidates) at score_thr 0.001 with class-specific boxes, scores
    rounded so that ties within and across classes decide the order, 100
    picks from more survivors: ``multiclass_nms_static`` (each class a lane
    of its own, the survivors merged by score) equal to the JAX package's
    one grouped problem over the union, bit for bit."""
    from hvrnet_tpu.ops.nms import multiclass_nms_static as j_multiclass
    from hvrnet_tpu_torch.ops.nms import multiclass_nms_static
    from tests.test_ops_nms import rand_dets
    rng = np.random.default_rng(13)
    n, ncls = 120, 81
    boxes = np.concatenate([rand_dets(rng, n)[0] for _ in range(ncls)], 1)
    scores = rng.dirichlet(np.full(ncls, 0.3), n).astype(np.float32)
    scores = np.round(scores, 2).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    want = j_multiclass(jnp.asarray(boxes), jnp.asarray(scores), 0.001, 0.5,
                        100, valid=jnp.asarray(valid))
    got = multiclass_nms_static(torch.from_numpy(boxes),
                                torch.from_numpy(scores), 0.001, 0.5, 100,
                                valid=torch.from_numpy(valid))
    assert int(got[2].sum()) == 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
