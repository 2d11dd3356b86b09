"""The deformable half of the dense family in the port against the JAX
package: ``ops/deform.py`` (``deform_conv2d`` v1 and v2, four deformable
groups, strides and dilations, samples in (−1, 0) and (H − 1, H) on both
axes; ``deform_roi_pooling``; ``masked_conv2d``), the ResNet ``dcn``
plugin (v1 and v2, ``fallback_on_stride``), the heads ``GARetinaHead``,
``GuidedAnchorHead``, ``GARPNHead`` and ``RepPointsHead``, and
``SingleStageEngine.simple_test`` on the guided-anchor branch of the anchor
route (GA-RetinaNet, GA-RPN) and on the RepPoints decode, then Cascade
R-CNN on an R50-FPN with dcn on c3-c5 through ``MultiStageEngine``.
Training is in ``tests/test_torch_port_deform_train.py``.

The dense engines are ResNet-18 with a 16-channel FPN (GA-RPN's from C2,
strides 4 to 64) and 11 classes (GA-RPN 2) on a 64×96 canvas, as in
``tests/test_torch_port_dense.py``; the heads' output convs, location and
shape branches and offset convs are drawn so that scores spread around
``score_thr`` and ``loc_filter_thr`` and the samples land off the grid.
Each JAX reference is computed once, in a module fixture; ``simple_test``
is held on the neck's maps of a jitted JAX program.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine import multi_stage as jax_multi_stage
from hvrnet_tpu.engine import single_stage as jax_single_stage
from hvrnet_tpu.models.anchor_heads import dense_heads as jax_heads
from hvrnet_tpu.models.backbones.resnet import ResNet as JaxResNet
from hvrnet_tpu.ops import deform as jax_deform
from hvrnet_tpu.utils.checkpoint import (convert_torch_checkpoint,
                                         merge_params)
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine import multi_stage, single_stage
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.models.backbones.resnet import ResNet
from hvrnet_tpu_torch.models.registry import HEADS
from hvrnet_tpu_torch.models.two_stage import build_submodule
from hvrnet_tpu_torch.ops import deform
from hvrnet_tpu_torch.utils.weights import (backbone_state_dict,
                                            dense_head_state_dict,
                                            state_dict_from_jax)
from tests.test_torch_port_dense import _fpn, _resnet, jax_feats
from tests.test_torch_port_image import _nchw, _rel_close
from tests.test_torch_port_zoo import _tensors

torch.set_num_threads(2)

CANVAS = (64, 96)
STRIDES = [8, 16, 32, 64, 128]
TEST_CFG = dict(nms_pre=60, score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                max_per_img=30)
RPN_TEST_CFG = dict(nms_pre=80, score_thr=0.0,
                    nms=dict(type="nms", iou_thr=0.7), max_per_img=40)


# ------------------------------------------------------------------ ops
OP_CASES = {
    "v1": dict(stride=1, pad=1, dil=1, groups=1, modulated=False),
    "v2 groups 4": dict(stride=1, pad=1, dil=1, groups=4, modulated=True),
    "v1 groups 4 stride 2": dict(stride=2, pad=1, dil=1, groups=4,
                                 modulated=False),
    "v2 dilation 2": dict(stride=1, pad=2, dil=2, groups=1, modulated=True),
}


def _op_inputs(case, seed):
    """x (2, 8, 6, 7), offsets of 1–2 px, a bias, the v2 mask; every
    sample at the map's border pushed into (−1, 0) or (H − 1, H)."""
    kw = OP_CASES[case]
    rng = np.random.default_rng(seed)
    B, C, H, W, O, k = 2, 8, 6, 7, 5, 3
    G = kw["groups"]
    s, p, d = kw["stride"], kw["pad"], kw["dil"]
    Ho = (H + 2 * p - d * (k - 1) - 1) // s + 1
    Wo = (W + 2 * p - d * (k - 1) - 1) // s + 1
    x = rng.standard_normal((B, C, H, W)).astype(np.float32)
    off = (rng.standard_normal((B, G, k * k, 2, Ho, Wo)) * 1.5)
    # the integer sample positions of each tap, then the border pushes
    base_y = (np.arange(Ho) * s - p)[None, :, None] \
        + (np.arange(k) * d).repeat(k)[:, None, None]
    base_x = (np.arange(Wo) * s - p)[None, None, :] \
        + np.tile(np.arange(k) * d, k)[:, None, None]
    for axis, base, n in ((0, base_y, H), (1, base_x, W)):
        pos = np.broadcast_to(base, (k * k, Ho, Wo))
        low = rng.uniform(-0.9, -0.1, (B, G, k * k, Ho, Wo))
        high = rng.uniform(n - 0.9, n - 0.1, (B, G, k * k, Ho, Wo))
        off[:, :, :, axis] = np.where(pos == 0, low - pos, off[:, :, :, axis])
        off[:, :, :, axis] = np.where(pos == n - 1, high - pos,
                                      off[:, :, :, axis])
    off = off.reshape(B, G * k * k * 2, Ho, Wo).astype(np.float32)
    w = rng.standard_normal((O, C, k, k)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    mask = (rng.uniform(0, 1, (B, G * k * k, Ho, Wo)).astype(np.float32)
            if kw["modulated"] else None)
    return x, off, w, b, mask, kw


@pytest.mark.parametrize("case", list(OP_CASES))
def test_deform_conv2d_matches_jax(case):
    """``deform_conv2d`` against the JAX function, forward and gradients
    (x, offsets, weight, bias and mask through ``jax.vjp`` of a random
    cotangent): each within 1e-5 of its max |·|.  The offsets put samples
    in (−1, 0) and (H − 1, H) on both axes (the JAX border rule), off the
    grid everywhere else."""
    x, off, w, b, mask, kw = _op_inputs(case, len(case))
    args = (kw["stride"], kw["pad"], kw["dil"])
    G = kw["groups"]
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (x, off, w, b) + ((mask,) if mask is not None else ())]
    got = deform.deform_conv2d(ts[0], ts[1], ts[2], ts[3], *args,
                               mask=ts[4] if mask is not None else None,
                               deformable_groups=G)
    cot = np.random.default_rng(1).standard_normal(
        tuple(got.shape)).astype(np.float32)
    got.backward(torch.from_numpy(cot))

    def f(xx, oo, ww, bb, *m):
        out = jax_deform.deform_conv2d(
            jnp.transpose(xx, (0, 2, 3, 1)), jnp.transpose(oo, (0, 2, 3, 1)),
            jnp.transpose(ww, (2, 3, 1, 0)), bb, kernel_size=3,
            stride=args[0], padding=args[1], dilation=args[2],
            mask=jnp.transpose(m[0], (0, 2, 3, 1)) if m else None,
            deformable_groups=G)
        return jnp.transpose(out, (0, 3, 1, 2))

    prim = [jnp.asarray(a) for a in (x, off, w, b) + (
        (mask,) if mask is not None else ())]
    want, vjp = jax.vjp(jax.jit(f), *prim)
    _rel_close(got.detach().numpy(), want, 1e-5)
    for t, g, name in zip(ts, vjp(jnp.asarray(cot)),
                          ("x", "offset", "weight", "bias", "mask")):
        assert np.abs(np.asarray(g)).max() > 0, name
        _rel_close(t.grad.numpy(), g, 1e-5, name)


@pytest.mark.parametrize("axis", ["y", "x"])
def test_border_rule_is_the_jax_one(axis):
    """Samples along one axis of a 4×4 map: at −0.25 the floor is −1 and
    ``ly`` 0.75, so the sample reads 0.25 of row (column) 0 and 0.75 of
    row 1 (mmdet's kernel: 0.75 of row 0, the outside corner 0); at
    H − 0.5 it reads row H − 1 at full weight (mmdet: half); at −1 and at
    H it reads 0; inside, the plain bilinear blend.  The JAX function
    agrees."""
    H = 4
    img = (np.arange(1, 17, dtype=np.float32).reshape(H, H) ** 2)
    line = img[:, 1] if axis == "y" else img[1, :]
    pos = np.array([-0.25, H - 0.5, -1.0, H, 1.5], np.float32)
    ys, xs = (pos, np.ones_like(pos)) if axis == "y" else \
        (np.ones_like(pos), pos)
    got = deform.bilinear_gather(torch.from_numpy(img)[None, None, None],
                                 torch.from_numpy(ys)[None, None],
                                 torch.from_numpy(xs)[None, None])[0, 0, 0]
    want = [0.25 * line[0] + 0.75 * line[1], line[H - 1], 0.0, 0.0,
            0.5 * (line[1] + line[2])]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    jgot = jax_deform._bilinear_gather(jnp.asarray(img[:, :, None]),
                                       jnp.asarray(ys), jnp.asarray(xs))
    np.testing.assert_allclose(np.asarray(jgot)[:, 0], want, rtol=1e-6)


def test_deform_roi_pooling_and_masked_conv_match_jax():
    """``deform_roi_pooling`` (two images, RoIs over the border, learned
    offsets) and ``masked_conv2d`` (a (B, H, W) mask) against the JAX
    functions, within 1e-5 of their max |·|."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 6, 9, 11)).astype(np.float32)
    rois = np.array([[0, 2, 3, 60, 40], [1, -8, -4, 30, 90],
                     [1, 100, 50, 170, 140]], np.float32)
    offs = rng.standard_normal((3, 49, 2)).astype(np.float32)
    for o in (None, offs):
        want = jax_deform.deform_roi_pooling(
            jnp.asarray(feats.transpose(0, 2, 3, 1)), jnp.asarray(rois),
            None if o is None else jnp.asarray(o))
        got = deform.deform_roi_pooling(torch.from_numpy(feats),
                                        torch.from_numpy(rois),
                                        None if o is None
                                        else torch.from_numpy(o))
        _rel_close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), 1e-5)
    w = rng.standard_normal((4, 6, 3, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    m = (rng.uniform(size=(2, 9, 11)) > 0.5).astype(np.float32)
    want = jax_deform.masked_conv2d(
        jnp.asarray(feats.transpose(0, 2, 3, 1)), jnp.asarray(m),
        jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b))
    got = deform.masked_conv2d(torch.from_numpy(feats), torch.from_numpy(m),
                               torch.from_numpy(w), torch.from_numpy(b))
    _rel_close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), 1e-5)
    assert not got.numpy().transpose(0, 2, 3, 1)[m == 0].any()


# ------------------------------------------------------------ backbone
def fill_tree(shapes, seed, offset_std=None):
    """A JAX parameter tree of ``shapes`` filled from numpy: He-normal
    conv kernels (the bare ``*_kernel`` ones of the deformable layers
    too), ``conv2_offset`` kernels at ``offset_std`` where given, zero
    biases, random frozen-BN statistics (positive scales and variances)
    and a random ``moment_transfer``."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        parent = path[-2].key if len(path) > 1 else ""
        if name == "kernel" or name.endswith("_kernel"):
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            if parent == "conv2_offset" and offset_std is not None:
                std = offset_std
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("mean", "moment_transfer") or (
                name == "bias" and parent.startswith(("bn", "conv2_bn"))):
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jump_margin(model, run):
    """The least distance of any sample of ``model``'s deformable convs,
    over the call ``run()``, to the JAX border rule's jumps: a sample
    moving across y = −1, y = 0 or y = H (x alike) changes its value by a
    whole row, so a rounding there parts two implementations by that
    much."""
    margins = []

    def hook(m, args, out):
        x, off = args[0], args[1]
        H, W = x.shape[-2:]
        k, st, pad, dil = (m.kernel_size[0], m.stride[0], m.padding[0],
                           m.dilation[0])
        ho, wo = off.shape[-2:]
        taps = torch.arange(k, dtype=torch.float64) * dil
        o = off.double().reshape(off.shape[0], -1, k, k, 2, ho, wo)
        ys = (torch.arange(ho, dtype=torch.float64) * st - pad)[:, None] \
            + taps[:, None, None, None] + o[..., 0, :, :]
        xs = (torch.arange(wo, dtype=torch.float64) * st - pad)[None, :] \
            + taps[None, :, None, None] + o[..., 1, :, :]
        for v, n in ((ys, H), (xs, W)):
            margins.append(min(float((v - j).abs().min())
                               for j in (-1.0, 0.0, float(n))))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, deform.DeformConv2d)]
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return out, min(margins)


RESNET_KW = dict(num_stages=4, strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                 out_indices=(0, 1, 2, 3), style="pytorch")
DCN = {"v1 fallback on stride": dict(modulated=False, deformable_groups=1,
                                     fallback_on_stride=True),
       "v2": dict(modulated=True, deformable_groups=1,
                  fallback_on_stride=False)}


def draw_dcn_offsets(params, net, x, seed, px=1.0):
    """The JAX ResNet tree ``params`` with each ``conv2_offset`` kernel
    drawn so that its offsets have a std of about ``px`` pixels on the
    inputs its block sees in ``net`` (the port, loaded with ``params``)
    on ``x``: random weights grow the maps by orders of magnitude from
    stage to stage, and one std for every block would move the deep
    blocks' samples by tens of pixels.  ``net`` is left loaded with the
    result."""
    rng = np.random.default_rng(seed)
    stds = {}

    def record(name):
        def hook(mod, args, out):
            stds[name] = float(args[0].std())
        return hook

    hooks = [m.conv2_offset.register_forward_hook(record(n))
             for n, m in net.named_modules() if getattr(m, "with_dcn", False)]
    with torch.no_grad():
        net(_nchw(x))
    for h in hooks:
        h.remove()
    tree = jax.tree_util.tree_map(np.asarray, params)
    bb = tree["params"] if "params" in tree else tree
    for name, std in stds.items():
        layer, block = name.split(".")
        node = bb[layer][f"block{block}"]["conv2_offset"]
        shape = node["kernel"].shape
        node["kernel"] = (rng.standard_normal(shape) * px
                          / (std * np.sqrt(np.prod(shape[:-1])))).astype(
                              np.float32)
    net.load_state_dict(_tensors(backbone_state_dict(bb)))
    return tree


@pytest.mark.parametrize("case", list(DCN))
def test_resnet_dcn_matches_jax(case):
    """ResNet-50 with the ``dcn`` plugin on c3-c5 from the JAX module's
    parameters (``backbone_state_dict``: ``conv2_offset``, ``conv2`` and
    ``bn2``), the offset convs drawn so that samples move about a pixel
    (``draw_dcn_offsets``), none within 1e-5 of a jump of the border rule
    (``jump_margin``): the 4 maps within 1e-5 of their max |·|; with
    ``fallback_on_stride`` each stage's strided first block keeps the
    plain 3×3 (no ``conv2_offset``), and v2 has 27 offset channels."""
    x = np.random.default_rng(5).standard_normal(
        (1, 64, 96, 3)).astype(np.float32)
    kw = dict(RESNET_KW, dcn=DCN[case],
              stage_with_dcn=(False, True, True, True))
    jnet = JaxResNet(depth=50, **kw)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = fill_tree(shapes, 50, offset_std=0.0)
    net = ResNet(depth=50, **kw)
    sd = backbone_state_dict(params["params"])
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(_tensors(sd))
    params = draw_dcn_offsets(params, net, x, seed=6)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x))
    fallback = DCN[case]["fallback_on_stride"]
    assert ("layer2.0.conv2_offset.weight" in sd) != fallback
    assert "layer1.0.conv2_offset.weight" not in sd
    assert sd["layer3.1.conv2_offset.weight"].shape[0] == (
        18 if fallback else 27)
    seen = []
    hooks = [m.conv2_offset.register_forward_hook(
        lambda m, i, o: seen.append(o[:, :18].abs().mean()))
        for m in net.modules() if getattr(m, "with_dcn", False)]
    with torch.no_grad():
        got, margin = jump_margin(net, lambda: net(_nchw(x)))
    for h in hooks:
        h.remove()
    assert all(0.3 < float(m) < 3 for m in seen), seen
    assert margin > 1e-5
    for g, w in zip(got, want):
        _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), 1e-5)


# ---------------------------------------------------------------- heads
HEAD_CASES = {
    "GARetinaHead": dict(num_classes=6, in_channels=8, feat_channels=8,
                         stacked_convs=2, deformable_groups=4),
    "GuidedAnchorHead": dict(num_classes=6, in_channels=8, feat_channels=12,
                             deformable_groups=4),
    "GARPNHead": dict(num_classes=2, in_channels=8, feat_channels=8,
                      deformable_groups=2),
    "RepPointsHead": dict(num_classes=6, in_channels=8, feat_channels=8,
                          point_feat_channels=12, stacked_convs=2,
                          num_points=9),
}


@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_deformable_heads_match_jax(name):
    """Each deformable head from the JAX head's parameters
    (``dense_head_state_dict``: mmdet's ``feature_adaption*.conv_offset`` /
    ``.conv_adaption``, ``reppoints_*``, ``moment_transfer``; random
    weights at std 0.2, so that the offsets move the samples by pixels) on
    three levels of a non-square map (8×12, 4×6, 1×1): every per-level
    output within 1e-5 of its max |·|."""
    kw = HEAD_CASES[name]
    rng = np.random.default_rng(len(name))
    xs = [rng.standard_normal((1, h, w, 8)).astype(np.float32)
          for h, w in ((8, 12), (4, 6), (1, 1))]
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
            _rel_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), 1e-5)


# -------------------------------------------------------------- engines
def deform_cfg(kind):
    """A tiny config of each deformable model: ``ga_retina``
    (``GARetinaHead``, 4 deformable groups over 16 channels), ``ga_rpn``
    (``GARPNHead`` on an FPN from C2, strides 4 to 64), ``reppoints``
    (``RepPointsHead``, 9 points, the moment transform), each on ResNet-18
    and a 16-channel FPN with 11 classes; ``cascade_dcn`` (Cascade R-CNN,
    3 stages, on ResNet-50 with dcn on c3-c5 and a 32-channel FPN, 9
    classes)."""
    if kind == "cascade_dcn":
        from tests.test_torch_port_fpn import fpn_cfg
        cfg = fpn_cfg("htc_nosem")
        for key in ("mask_roi_extractor", "mask_head"):
            cfg.pop(key)
        return dict(cfg, type="CascadeRCNN",
                    backbone=dict(_resnet(50, "pytorch"), dcn=dict(
                        modulated=False, deformable_groups=1,
                        fallback_on_stride=False),
                        stage_with_dcn=(False, True, True, True)),
                    neck=dict(cfg["neck"], in_channels=(256, 512, 1024,
                                                        2048)))
    cfg = dict(backbone=_resnet(), neck=_fpn())
    ga = dict(octave_base_scale=4, scales_per_octave=3,
              octave_ratios=[0.5, 1.0, 2.0], anchoring_means=[.0] * 4,
              anchoring_stds=[0.07, 0.07, 0.14, 0.14],
              target_means=[.0] * 4, target_stds=[0.07, 0.07, 0.11, 0.11],
              loc_filter_thr=0.01, deformable_groups=4,
              loss_loc=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                            alpha=0.25, loss_weight=1.0),
              loss_shape=dict(type="BoundedIoULoss", beta=0.2,
                              loss_weight=1.0),
              loss_bbox=dict(type="SmoothL1Loss", beta=0.04,
                             loss_weight=1.0))
    if kind == "ga_retina":
        return dict(cfg, type="RetinaNet", bbox_head=dict(
            type="GARetinaHead", num_classes=11, in_channels=16,
            stacked_convs=1, feat_channels=16, anchor_strides=STRIDES, **ga))
    if kind == "ga_rpn":
        return dict(cfg, type="RPN",
                    neck=dict(cfg["neck"], start_level=0,
                              add_extra_convs=False),
                    bbox_head=dict(type="GARPNHead", num_classes=2,
                                   in_channels=16, feat_channels=16,
                                   anchor_strides=[4, 8, 16, 32, 64],
                                   **dict(ga, octave_base_scale=8)))
    return dict(cfg, type="RepPointsDetector", bbox_head=dict(
        type="RepPointsHead", num_classes=11, in_channels=16,
        feat_channels=16, point_feat_channels=16, stacked_convs=1,
        num_points=9, point_strides=STRIDES, point_base_scale=4,
        transform_method="moment", moment_mul=0.01,
        loss_bbox_init=dict(type="SmoothL1Loss", beta=0.11, loss_weight=0.5),
        loss_bbox_refine=dict(type="SmoothL1Loss", beta=0.11,
                              loss_weight=1.0)))


# the dcn cascade's offsets in pixels: with the frozen BNs calibrated, a
# random trunk's maps are rough, and offsets read from them feed rounding
# back into the sampling; at 1 px its float32 and float64 forwards part by
# 0.3 of max at c4 (and XLA's jitted and eager ones alike), at 0.5 px by
# 1e-3
DCN_PX = 0.5
ENGINES = {"ga_retina": (jax_single_stage.RetinaNet, single_stage.RetinaNet),
           "ga_rpn": (jax_single_stage.RPN, single_stage.RPN),
           "reppoints": (jax_single_stage.RepPointsDetector,
                         single_stage.RepPointsDetector),
           "cascade_dcn": (jax_multi_stage.CascadeRCNN,
                           multi_stage.CascadeRCNN)}
# each head's drawn layers, in the order they feed each other: (port
# name, output std on the image's maps); the location branch, its bias at
# the prior −log(99), spreads across loc_filter_thr, the offset convs move
# the samples by about a pixel
DRAWN = {"ga_retina": (("conv_shape", 0.3), ("conv_loc", 2.0),
                       ("feature_adaption_cls.conv_offset", 1.0),
                       ("feature_adaption_reg.conv_offset", 1.0),
                       ("retina_cls", 1.0), ("retina_reg", 0.3)),
         "ga_rpn": (("conv_shape", 0.3), ("conv_loc", 2.0),
                    ("feature_adaption.conv_offset", 1.0),
                    ("conv_cls", 1.0), ("conv_reg", 0.3)),
         "reppoints": (("reppoints_pts_init_out", 1.0),
                       ("reppoints_cls_out", 1.0),
                       ("reppoints_pts_refine_out", 0.3))}
JAX_NAMES = {"feature_adaption_cls.conv_offset": "feature_adaption_cls_offset",
             "feature_adaption_reg.conv_offset": "feature_adaption_reg_offset",
             "feature_adaption.conv_offset": "feature_adaption_offset",
             "reppoints_cls_out": "cls_out",
             "reppoints_pts_init_out": "pts_init_out",
             "reppoints_pts_refine_out": "pts_refine_out"}
_BN_JAX = {"weight": "scale", "bias": "bias", "running_mean": "mean",
           "running_var": "var"}


def engine_tree(jeng, seed):
    """The JAX engine's parameter tree filled from numpy in its init
    scheme (He-normal conv kernels, the deformable layers' bare kernels
    too; normal(0, 0.01) dense kernels and RPN convs; zero biases;
    identity frozen BNs; zero ``conv2_offset`` kernels) and a random
    ``moment_transfer``."""
    shapes = jax.eval_shape(jeng.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        keys = [p.key for p in path]
        if name == "kernel" or name.endswith("_kernel"):
            std = (0.0 if "conv2_offset" in keys else
                   0.01 if len(s.shape) == 2 or keys[1] == "rpn_head"
                   else np.sqrt(2.0 / np.prod(s.shape[:-1])))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        if name == "moment_transfer":
            return (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.
                                  tree_map_with_path(fill, shapes))


def draw_head(tree, port, frames, kind, seed):
    """``DRAWN[kind]``'s layers drawn on the port's head, one after the
    other on the frames' maps (each to its output std), and written into
    the JAX tree."""
    head = port.model.bbox_head
    rng = np.random.default_rng(seed)
    jhead = tree["params"]["bbox_head"]
    for name, std in DRAWN[kind]:
        conv = head.get_submodule(name)
        if name == "conv_loc":         # the prior, as the head's init
            with torch.no_grad():
                conv.bias.fill_(-np.log(99.0))
        seen = []
        hook = conv.register_forward_hook(
            lambda m, i, o: seen.append(o.detach().flatten()))
        with torch.no_grad():
            for f in frames:
                head(port.backbone_maps(f["img"], f["img_shape"]))
        hook.remove()
        scale = std / float(torch.cat(seen).std())
        w = torch.from_numpy(rng.standard_normal(tuple(conv.weight.shape))
                             .astype(np.float32))
        with torch.no_grad():
            conv.weight.copy_(w * scale * conv.weight.std()
                              / max(float(conv.weight.std()), 1e-30))
            # the scale of a drawn conv's output is linear in its weight
            seen.clear()
            hook = conv.register_forward_hook(
                lambda m, i, o: seen.append(o.detach().flatten()))
            for f in frames:
                head(port.backbone_maps(f["img"], f["img_shape"]))
            hook.remove()
            bias = 0.0 if conv.bias is None else conv.bias.mean()
            conv.weight.mul_(std / float((torch.cat(seen) - bias).std()))
        node = dict(jhead[JAX_NAMES.get(name, name)])
        node["kernel"] = conv.weight.detach().numpy().transpose(2, 3, 1, 0)
        if conv.bias is not None:
            node["bias"] = conv.bias.detach().numpy().copy()
        jhead[JAX_NAMES.get(name, name)] = node


def cross_back(tree, port):
    """The port's frozen-BN statistics (and the dcn offset kernels) of the
    backbone into the JAX tree: ``convert_torch_checkpoint`` and, for the
    dcn blocks it does not know, ``conv2_bn`` from ``bn2`` and
    ``conv2_offset`` from ``conv2_offset``."""
    sd = {k: v.numpy() for k, v in port.model.state_dict().items()
          if k.startswith("backbone.")}
    merged, _ = merge_params(tree["params"], convert_torch_checkpoint(
        {k: v for k, v in sd.items() if "conv2_offset" not in k})["params"])
    for k, v in sd.items():
        parts = k.split(".")
        if len(parts) < 5 or not parts[1].startswith("layer"):
            continue
        block = merged["backbone"][parts[1]][f"block{parts[2]}"]
        if parts[3] == "bn2" and "conv2_bn" in block:
            block["conv2_bn"][_BN_JAX[parts[4]]] = v
        elif parts[3] == "conv2_offset":
            block["conv2_offset"]["kernel" if parts[4] == "weight"
                                  else "bias"] = (
                v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
    return {"params": merged}


def image(seed=3):
    """The 64×96 canvas of noise, its img_shape, pad_shape and a scale
    factor of 0.8 / 0.82 across the axes."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(1,) + CANVAS + (3,)).astype(np.float32) * 40
    return (img, np.array([CANVAS[0] - 4.0, CANVAS[1] - 6.0], np.float32),
            np.array(CANVAS, np.float32),
            np.array([0.8, 0.82, 0.8, 0.82], np.float32))


def calibrated(kind, frames, seed, test_cfg=None, train_cfg=None):
    """(JAX engine, JAX params, port engine) of ``deform_cfg(kind)`` on one
    set of weights: the port's frozen BNs calibrated on ``frames``, the
    dcn offsets (``draw_dcn_offsets``) and the head's drawn layers
    (``draw_head``) drawn on them, and everything carried back into the
    JAX tree."""
    jax_cls, port_cls = ENGINES[kind]
    cfg = deform_cfg(kind)
    jeng = jax_cls(cfg, train_cfg, test_cfg)
    tree = engine_tree(jeng, seed)
    port = port_cls(cfg, test_cfg, device="cpu", train_cfg=train_cfg)
    sd = state_dict_from_jax(tree, cfg)
    assert set(sd) == set(port.model.state_dict())
    port.load_state_dict(sd)
    calibrate_frozen_bn(port, frames)
    if kind == "cascade_dcn":
        tree["params"]["backbone"] = draw_dcn_offsets(
            tree["params"]["backbone"], port.model.backbone,
            frames[0]["img"], seed, px=DCN_PX)
        calibrate_frozen_bn(port, frames)
    else:
        draw_head(tree, port, frames, kind, seed)
    return jeng, cross_back(tree, port), port


@pytest.fixture(scope="module")
def deform_runs():
    """Per model: the JAX ``simple_test`` on the image, the JAX maps, the
    port engine and its inputs."""
    from tests.test_torch_port_fpn import jax_maps
    args = image()
    out = {}
    for kind in ENGINES:
        test_cfg = RPN_TEST_CFG if kind == "ga_rpn" else (
            None if kind == "cascade_dcn" else TEST_CFG)
        if kind == "cascade_dcn":
            from tests.test_torch_port_fpn import TEST_CFG as FPN_TEST_CFG
            test_cfg = FPN_TEST_CFG
        jeng, params, port = calibrated(
            kind, [dict(img=args[0], img_shape=args[1])], seed=11,
            test_cfg=test_cfg)
        if kind == "cascade_dcn":
            want = jeng.simple_test(params, jnp.asarray(args[0]), args[1],
                                    args[2], args[3])
            maps = jax_maps(jeng, params, args[0])
        else:
            want = jeng.simple_test(params, jnp.asarray(args[0]), args[1],
                                    args[3])
            maps = jax_feats(jeng, params, args[0])
        out[kind] = dict(port=port, want=jax.device_get(want), args=args,
                         maps=maps, tree=params)
    return out


@pytest.mark.parametrize("kind", ["ga_retina", "ga_rpn", "reppoints"])
def test_simple_test_matches_jax(deform_runs, kind, monkeypatch):
    """``simple_test`` on the JAX neck maps: the same NMS picks in the same
    rows with the same labels and validity, boxes within 1e-3 px and
    scores within 2e-6 (``tests/test_torch_port_dense.py``'s limits), for
    GA-RetinaNet and GA-RPN (the guided anchors, the location filter
    zeroing some scores before the ``nms_pre`` cut) and RepPoints (the
    moment transform with a nonzero ``moment_transfer``); no sample of
    the heads' deformable convs within 1e-6 px of a jump of the border
    rule (the two packages' offsets part by ~1e-7 px)."""
    run = deform_runs[kind]
    port = run["port"]
    monkeypatch.setattr(port, "backbone_maps", lambda img, ish: run["maps"])
    got, margin = jump_margin(port.model,
                              lambda: port.simple_test(*run["args"]))
    assert margin > 1e-6
    dets, labels, mask = (t.numpy() for t in got)
    want = run["want"]
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_array_equal(labels[mask], want[1][mask])
    assert 5 < mask.sum()
    if kind != "ga_rpn":
        assert len(set(labels[mask])) > 2
    np.testing.assert_allclose(dets[mask, :4], want[0][mask, :4], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets[mask, 4], want[0][mask, 4], rtol=0,
                               atol=2e-6)
    assert not dets[~mask].any()


@pytest.mark.parametrize("kind", ["ga_retina", "ga_rpn"])
def test_location_filter_zeroes_scores(deform_runs, kind):
    """The guided anchors' location filter acts on the image: between 5 %
    and 95 % of the positions pass ``loc_filter_thr``, and the zeroed rows
    of each level are the ones whose sigmoid(loc) is below it; the guided
    anchors are the squares reshaped by more than a pixel."""
    run = deform_runs[kind]
    port = run["port"]
    feats = run["maps"]
    with torch.no_grad():
        outs = port.model.bbox_head(feats)
    kept, moved = [], []
    for lvl in range(len(feats)):
        anchors, keep = port.guided_anchors(outs[2][lvl], outs[3][lvl], lvl)
        loc = torch.sigmoid(single_stage.flat(outs[3][lvl], 1)[:, 0])
        assert torch.equal(keep.bool(), loc >= 0.01)
        h, w = outs[2][lvl].shape[2:]
        sq = port._grids[("squares", h, w, port.head_cfg["anchor_strides"]
                          [lvl])]
        kept.append(keep)
        moved.append(float((anchors - sq).abs().max()))
    kept = torch.cat(kept)
    assert 0.05 < float(kept.mean()) < 0.95 and max(moved) > 1.0


def test_cascade_dcn_simple_test_matches_jax(deform_runs, monkeypatch):
    """Cascade R-CNN on ResNet-50 with dcn on c3-c5 and an FPN through
    ``MultiStageEngine`` as it stands (no engine change for the plugin):
    on the JAX maps (FPN, RPN) the same picks, labels and validity as the
    JAX engine, boxes within 1e-3 px and scores within 1e-5 (the zoo's
    limits).  The dcn trunk itself is held in
    ``test_resnet_dcn_matches_jax`` (``DCN_PX`` says why not here)."""
    from tests.test_torch_port_fpn import inject
    run = deform_runs["cascade_dcn"]
    port = run["port"]
    with torch.no_grad():
        _, margin = jump_margin(port.model, lambda: port.backbone_maps(
            run["args"][0], run["args"][1]))
    assert margin > 1e-6
    inject(monkeypatch, port, run["maps"])
    dets, labels, mask = (t.numpy() for t in port.simple_test(*run["args"]))
    want = run["want"]
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_array_equal(labels[mask], want[1][mask])
    assert mask.sum() > 3
    np.testing.assert_allclose(dets[mask, :4], want[0][mask, :4], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets[mask, 4], want[0][mask, 4], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", list(ENGINES))
def test_build_detector_builds_deformable_engines(kind):
    """``build_detector`` builds each deformable model from its config with
    mmdet's names (``feature_adaption_cls.conv_adaption.weight``,
    ``reppoints_pts_refine_conv.weight``, ``moment_transfer``, the dcn
    blocks' ``conv2_offset``); the seeded ``conv2_offset`` is zero (a
    deformable conv that starts as the plain 3×3) and the seeded
    deformable kernels are not."""
    from tests.test_torch_port_fpn import TEST_CFG as FPN_TEST_CFG
    cfg = deform_cfg(kind)
    eng = apis.build_detector(cfg, device="cpu", test_cfg=(
        FPN_TEST_CFG if kind == "cascade_dcn" else TEST_CFG))
    assert type(eng) is ENGINES[kind][1]
    sd = eng.model.state_dict()
    expect = {"ga_retina": ("bbox_head.feature_adaption_cls.conv_adaption."
                            "weight", "bbox_head.conv_loc.bias"),
              "ga_rpn": ("bbox_head.feature_adaption.conv_offset.weight",
                         "bbox_head.conv_cls.weight"),
              "reppoints": ("bbox_head.reppoints_pts_refine_conv.weight",
                            "bbox_head.moment_transfer"),
              "cascade_dcn": ("backbone.layer4.2.conv2_offset.bias",
                              "backbone.layer2.0.conv2.weight")}[kind]
    assert set(expect) <= set(sd)
    for name, t in sd.items():
        if "conv2_offset" in name:
            assert not t.any(), name
        elif name.endswith(("conv_adaption.weight", "refine_conv.weight",
                            "cls_conv.weight")) or (
                "layer3" in name and name.endswith("conv2.weight")):
            assert t.abs().max() > 0, name
