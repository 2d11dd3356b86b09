"""The deformable half's training in the port against the JAX package:
``ga_loc_targets`` / ``ga_shape_target_single``, ``reppoints_points``,
``point_assign`` and ``points2bbox`` on the same inputs (overlapping
regions of several ground truths, points at equal distance from two
ground truths, an unused slot), one step of ``GATrainer`` and of
``RepPointsTrainer`` on the JAX neck maps (losses against the jitted JAX
loss, gradients against the port's float64 recompute), and the
``train_detector`` dispatch: ``GARetinaHead`` → ``GATrainer``,
``RepPointsHead`` → ``RepPointsTrainer``, a ``GuidedAnchorHead`` under
``RetinaNet`` → ``RetinaTrainer``, ``RPN`` refused, and Cascade R-CNN with
dcn on c3-c5 through ``TwoStageTrainer``.

The models are those of ``tests/test_torch_port_deform.py`` (ResNet-18, a
16-channel FPN, 11 classes, 64×96).  The JAX losses and gradients come
from one jitted ``value_and_grad`` per trainer, computed once in a module
fixture.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu import apis as jax_apis
from hvrnet_tpu.models.builder import build_detector as jax_build_detector
from hvrnet_tpu.engine import train_guided_anchor as jax_ga
from hvrnet_tpu.engine import train_reppoints as jax_rp
from hvrnet_tpu.engine.train_single_stage import \
    RetinaTrainer as JaxRetinaTrainer
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.engine.train_guided_anchor import (
    GATrainer, ga_loc_targets, ga_shape_target_single)
from hvrnet_tpu_torch.engine.train_reppoints import (RepPointsTrainer,
                                                     point_assign,
                                                     points2bbox,
                                                     reppoints_points)
from hvrnet_tpu_torch.engine.train_single_stage import RetinaTrainer
from hvrnet_tpu_torch.engine.train_two_stage import TwoStageTrainer
from hvrnet_tpu_torch.ops.anchors import AnchorGenerator
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_dense import jax_feats
from tests.test_torch_port_dense_train import (jax_batch, jax_loss_fn,
                                               train_sample)
from tests.test_torch_port_deform import (CANVAS, ENGINES, calibrated,
                                          deform_cfg, jump_margin)
from tests.test_torch_port_image import _nchw
from tests.test_torch_port_train import (  # noqa: F401  (work_dir)
    ReluPattern, assert_grads_against_float64, default_dtype, relu_as,
    trainable_grads, work_dir)

torch.set_num_threads(2)

OPT = dict(optimizer=dict(lr=1e-3, momentum=0.9, weight_decay=1e-4))
TRAIN_CFG = dict(
    ga_assigner=dict(type="ApproxMaxIoUAssigner", pos_iou_thr=0.5,
                     neg_iou_thr=0.4, min_pos_iou=0.4, ignore_iof_thr=-1),
    ga_sampler=dict(type="RandomSampler", num=256, pos_fraction=0.5,
                    neg_pos_ub=-1, add_gt_as_proposals=False),
    assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.5,
                  min_pos_iou=0.0, ignore_iof_thr=-1),
    allowed_border=-1, center_ratio=0.2, ignore_ratio=0.5,
    init=dict(assigner=dict(type="PointAssigner", scale=4, pos_num=1)),
    refine=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                              neg_iou_thr=0.4, min_pos_iou=0.0)))
TRAINERS = {"ga_retina": (GATrainer, jax_ga.GATrainer),
            "reppoints": (RepPointsTrainer, jax_rp.RepPointsTrainer)}
GT = dict(gt_bboxes=np.array([[6, 8, 36, 38], [20, 18, 50, 48],
                              [40, 4, 88, 60], [2, 30, 14, 44],
                              [0, 0, 0, 0]], np.float32),
          gt_mask=np.array([True, True, True, True, False]),
          gt_labels=np.array([1, 4, 8, 2, 0]))


# -------------------------------------------------------------- targets
def test_ga_loc_targets_match_jax():
    """``ga_loc_targets`` on three levels (strides 8, 16, 32 of the 64×96
    canvas) for four ground truths, two of equal area whose centre and
    ignore regions overlap, one a level up whose ignore ring falls on the
    adjacent levels, and an unused slot: every target and weight equal to
    the JAX function's, with centre, ignore (0) and negative (0.1)
    positions on the first level and the average factor Σ(h·w) / 200."""
    sizes, strides = [(8, 12), (4, 6), (2, 3)], [8, 16, 32]
    want = ga_loc = jax.jit(jax_ga.ga_loc_targets, static_argnums=(2, 3, 4))(
        jnp.asarray(GT["gt_bboxes"]), jnp.asarray(GT["gt_mask"]),
        tuple(sizes), tuple(strides), 4)
    got = ga_loc_targets(torch.from_numpy(GT["gt_bboxes"]),
                         torch.from_numpy(GT["gt_mask"]), sizes, strides, 4)
    for g, w in zip(got[0] + got[1], list(want[0]) + list(want[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2] == ga_loc[2] == (96 + 24 + 6) / 200.0
    w0 = got[1][0].numpy()
    assert {0.0, np.float32(0.1), 1.0} <= set(np.unique(w0).tolist())


def test_ga_shape_target_matches_jax():
    """``ga_shape_target_single`` over the squares and approx anchors of
    the canvas (three levels, 9 approxs a square), an ``inside`` mask that
    drops a few squares: the assigned boxes, positive weights and count
    equal to the JAX function's, and more than one positive."""
    strides, sizes = (8, 16, 32), [(8, 12), (4, 6), (2, 3)]
    scales = tuple(4 * 2 ** (i / 3) for i in range(3))
    approxs = np.concatenate([AnchorGenerator(s, scales, (0.5, 1.0, 2.0))
                              .grid_anchors(hw, s)
                              for s, hw in zip(strides, sizes)])
    squares = np.concatenate([AnchorGenerator(s, (4,), (1.0,))
                              .grid_anchors(hw, s)
                              for s, hw in zip(strides, sizes)])
    inside = np.ones(len(squares), bool)
    inside[::7] = False
    args = (approxs, squares, inside, GT["gt_bboxes"], GT["gt_mask"])
    want = jax.jit(jax_ga.ga_shape_target_single,
                   static_argnums=(5, 6, 7, 8))(*map(jnp.asarray, args), 9,
                                                0.5, 0.4, 0.4)
    got = ga_shape_target_single(*map(torch.from_numpy, args), 9,
                                 0.5, 0.4, 0.4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(got[2]) > 1


def test_point_assign_and_points_match_jax():
    """``reppoints_points`` (strides 8 to 128 on the 64×96 canvas: points
    at i·stride) and ``point_assign`` at ``pos_num`` 1 and 3 against the
    JAX functions: equal points, strides and assignments, where two ground
    truths claim points at equal normalised distance (a stable double
    argsort, the first slot recorded keeps a tie), one is masked out."""
    strides = (8, 16, 32, 64, 128)
    pts, st = reppoints_points(CANVAS, strides)
    jpts, jst = jax_rp.reppoints_points(CANVAS, strides)
    np.testing.assert_array_equal(pts, np.asarray(jpts))
    np.testing.assert_array_equal(st, np.asarray(jst))
    # the second box is the first one's mirror about a column of points
    gt = np.array([[4, 4, 27, 27], [21, 4, 44, 27], [40, 4, 88, 60],
                   [10, 40, 30, 60], [0, 0, 0, 0]], np.float32)
    mask = np.array([True, True, True, False, False])
    for pos_num in (1, 3):
        want = jax.jit(jax_rp.point_assign, static_argnums=(4, 5))(
            jnp.asarray(pts), jnp.asarray(st), jnp.asarray(gt),
            jnp.asarray(mask), 4, pos_num)
        got = point_assign(torch.from_numpy(pts), torch.from_numpy(st),
                           torch.from_numpy(gt), torch.from_numpy(mask), 4,
                           pos_num)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert set(np.unique(got.numpy()).tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("method", ["moment", "minmax", "partial_minmax"])
def test_points2bbox_matches_jax(method):
    """``points2bbox`` of 40 random 9-point sets: the boxes and, for the
    moment transform, the gradients of the points and of
    ``moment_transfer`` (damped to ``moment_mul``) of a weighted sum, each
    within 1e-5 of its max |·| of the JAX function's (``ddof=1``)."""
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 5, (40, 18)).astype(np.float32)
    mt = np.array([0.3, -0.2], np.float32)
    w = rng.standard_normal((40, 4)).astype(np.float32)

    def jfn(p, m):
        return (jax_rp.points2bbox(p, method, m, 0.01) * w).sum()

    want, (gp, gm) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        jnp.asarray(pts), jnp.asarray(mt))
    p = torch.from_numpy(pts).requires_grad_(True)
    m = torch.from_numpy(mt).requires_grad_(True)
    boxes = points2bbox(p, method, m, 0.01)
    np.testing.assert_allclose(
        boxes.detach().numpy(),
        np.asarray(jax.jit(jax_rp.points2bbox, static_argnums=(1, 3))(
            jnp.asarray(pts), method, jnp.asarray(mt), 0.01)),
        rtol=0, atol=1e-5 * float(np.abs(pts).max()))
    (boxes * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gp)).max())
    if method == "moment":
        np.testing.assert_allclose(m.grad.numpy(), np.asarray(gm), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(gm)).max())
        assert np.abs(np.asarray(gm)).max() > 0


# ------------------------------------------------------------- the step
def _step(kind, sd, sample, feats, dtype=torch.float32):
    """The port's step from the image through the JAX neck maps (their
    values, the port backbone's and neck's gradient path) to the
    gradients: (trainer, logs)."""
    eng = ENGINES[kind][1](deform_cfg(kind), device="cpu",
                           train_cfg=TRAIN_CFG)
    eng.load_state_dict(sd)
    trainer = TRAINERS[kind][0](eng, OPT, steps_per_epoch=10)
    with default_dtype(dtype):
        eng.model.to(dtype)
        own = eng.model.extract_feat(_nchw(sample["img"][None]).to(dtype))
        fed = tuple(o + (_nchw(f).to(dtype) - o).detach()
                    for o, f in zip(own, feats))
        loss, logs = trainer.loss_from_c4(fed, sample)
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    logs["loss"] = loss
    return trainer, logs


@pytest.fixture(scope="module")
def deform_steps():
    """Per trainer: the JAX loss, logs and gradients (one jitted
    ``value_and_grad``) on one image with five ground-truth slots, the
    port's step on the JAX neck maps with its float64 recompute on the
    float32 step's ReLU pattern."""
    sample = dict(train_sample(), **GT)
    out = {}
    for kind in TRAINERS:
        jeng, params, port = calibrated(
            kind, [dict(img=sample["img"][None],
                        img_shape=sample["img_shape"])], seed=12,
            train_cfg=TRAIN_CFG)
        jtrainer = TRAINERS[kind][1](jeng, OPT, steps_per_epoch=10)
        (loss, logs), grads = jax.jit(jax.value_and_grad(
            jax_loss_fn(jtrainer, CANVAS), has_aux=True))(
                params, jax_batch(sample), jax.random.PRNGKey(0))
        feats = [f.numpy().transpose(0, 2, 3, 1)
                 for f in jax_feats(jeng, params, sample["img"][None])]
        case = (kind, port.model.state_dict(), sample, feats)
        with torch.no_grad():
            _, margin = jump_margin(port.model, lambda: port.model.bbox_head(
                tuple(_nchw(f) for f in feats)))
        pattern = ReluPattern()
        with relu_as(pattern):
            trainer, plogs = _step(*case)
            with pattern.replay():
                tr64, _ = _step(*case, dtype=torch.float64)
        out[kind] = dict(
            jlogs=dict(jax.device_get(logs), loss=float(loss)), logs=plogs,
            g32=trainable_grads(trainer), g64=trainable_grads(tr64),
            jgrads={k: v.numpy() for k, v in state_dict_from_jax(
                jax.device_get(grads)).items()}, margin=margin)
    return out


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_training_step_matches_jax(deform_steps, kind):
    """One step of ``GATrainer`` and ``RepPointsTrainer`` on the JAX neck
    maps: every log within 1e-5 relative of the JAX trainer's, each loss
    above 0; the trained set is the backbone from ``layer2``, the neck and
    the head (``moment_transfer``, the offset convs and the deformable
    kernels among them).  Gradients: the port's within 1e-5 of each
    tensor's max |grad| in its float64 recompute on the float32 step's
    ReLU pattern (the backbone's and the neck's 1e-4); the head's through
    ``assert_grads_against_float64``, where the JAX package's are held too
    (within 1e-3, and within 1e-4 of the float64 truth); no sample within
    1e-6 px of a jump of the border rule."""
    r = deform_steps[kind]
    assert r["margin"] > 1e-6
    jlogs, logs = r["jlogs"], r["logs"]
    assert set(jlogs) <= set(logs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        if k.startswith("loss"):
            assert float(jlogs[k]) > 0, k
    assert float(jlogs["num_pos"]) >= 1
    g32, g64 = r["g32"], r["g64"]
    assert {n.split(".")[0] for n in g64} == {"backbone", "neck",
                                              "bbox_head"}
    assert not any(n.startswith(("backbone.conv1.", "backbone.layer1."))
                   for n in g64)
    own = {"ga_retina": ("bbox_head.feature_adaption_cls.conv_offset.weight",
                         "bbox_head.feature_adaption_reg.conv_adaption."
                         "weight", "bbox_head.conv_loc.weight",
                         "bbox_head.conv_shape.bias"),
           "reppoints": ("bbox_head.moment_transfer",
                         "bbox_head.reppoints_cls_conv.weight",
                         "bbox_head.reppoints_pts_refine_conv.weight",
                         "bbox_head.reppoints_pts_init_out.bias")}[kind]
    for n in own:
        assert np.abs(g64[n]).max() > 0, n
    for n, t in g64.items():
        if not n.startswith("bbox_head."):
            assert np.abs(g32[n] - t).max() <= 1e-4 * np.abs(t).max(), n
    heads = [n for n in g64 if n.startswith("bbox_head.")]
    assert_grads_against_float64(
        {n: g32[n] for n in heads}, r["jgrads"], {n: g64[n] for n in heads},
        None, None, may_stray=())


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("kind", ["ga_retina", "reppoints", "cascade_dcn"])
def test_train_detector_dispatch(kind, work_dir):
    """``build_detector`` builds each deformable model for training and
    ``train_detector`` picks its trainer (``GARetinaHead`` →
    ``GATrainer``, ``RepPointsHead`` → ``RepPointsTrainer``, Cascade R-CNN
    with dcn → ``TwoStageTrainer``): one step moves the deformable layers
    (the offset convs, the deformable kernels, ``moment_transfer``, the
    dcn blocks' ``conv2_offset`` from their zero init) and keeps every
    tensor that does not train (the stem, ``layer1``, every frozen-BN
    statistic) bit for bit."""
    from tests.test_torch_port_fpn_train import train_cfg
    cfg = deform_cfg(kind)
    tcfg = train_cfg() if kind == "cascade_dcn" else TRAIN_CFG
    eng = apis.build_detector(cfg, train_cfg=tcfg, device="cpu", seed=2)
    sample = dict(train_sample(), **GT)
    calibrate_frozen_bn(eng, [dict(img=sample["img"][None],
                                   img_shape=sample["img_shape"])])
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    trainer = apis.train_detector(eng, [sample], dict(OPT, total_epochs=1),
                                  str(work_dir / kind), seed=1)
    assert type(trainer) is {"ga_retina": GATrainer,
                             "reppoints": RepPointsTrainer,
                             "cascade_dcn": TwoStageTrainer}[kind]
    assert trainer.step == 1
    after = eng.model.state_dict()
    moved = {"ga_retina": ("bbox_head.feature_adaption_cls.conv_offset."
                           "weight", "bbox_head.feature_adaption_reg."
                           "conv_adaption.weight", "bbox_head.conv_loc.bias",
                           "neck.fpn_convs.0.conv.weight"),
             "reppoints": ("bbox_head.moment_transfer",
                           "bbox_head.reppoints_cls_conv.weight",
                           "bbox_head.reppoints_pts_init_out.weight"),
             "cascade_dcn": ("backbone.layer3.1.conv2_offset.weight",
                             "backbone.layer4.0.conv2.weight",
                             "backbone.layer2.0.conv2_offset.bias")}[kind]
    for k in moved + ("backbone.layer2.0.conv1.weight",):
        assert not torch.equal(after[k], before[k]), k
    trains = {n for n, p in eng.model.named_parameters() if p.requires_grad}
    frozen = [k for k in before if k not in trains]
    assert {"backbone.conv1.weight", "backbone.layer1.0.conv1.weight"} <= \
        set(frozen)
    for k in frozen:
        assert torch.equal(after[k], before[k]), k


def test_train_detector_dispatch_follows_jax(work_dir, monkeypatch):
    """A ``GuidedAnchorHead`` under ``RetinaNet`` gets ``RetinaTrainer``
    (as the JAX ``build_trainer`` gives it), whose objective reads two
    outputs; an ``RPN`` with a ``GARPNHead`` has no training objective
    (``ValueError``, as in JAX)."""
    cfg = dict(deform_cfg("ga_rpn"), type="RetinaNet")
    jeng = jax_build_detector(cfg, train_cfg=TRAIN_CFG)
    assert type(jax_apis.build_trainer(jeng, OPT)) is JaxRetinaTrainer
    eng = apis.build_detector(cfg, train_cfg=TRAIN_CFG, device="cpu")
    picked = []

    def losses(self, outs, gt, s):
        picked.append(type(self))
        raise RuntimeError("picked")

    monkeypatch.setattr(RetinaTrainer, "losses", losses)
    with pytest.raises(RuntimeError, match="picked"):
        apis.train_detector(eng, [dict(train_sample(), **GT)], OPT,
                            str(work_dir / "ga_head"))
    assert picked == [RetinaTrainer]
    rpn = apis.build_detector(deform_cfg("ga_rpn"), train_cfg=TRAIN_CFG,
                              device="cpu")
    with pytest.raises(ValueError, match="no training objective"):
        apis.train_detector(rpn, [dict(train_sample(), **GT)], OPT,
                            str(work_dir / "rpn"))
    with pytest.raises(ValueError, match="no training objective"):
        jax_apis.build_trainer(jax_build_detector(
            deform_cfg("ga_rpn"), train_cfg=TRAIN_CFG), OPT)
