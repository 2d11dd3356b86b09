"""The FPN zoo's training in the port against the JAX package: one
``TwoStageTrainer`` step of Hybrid Task Cascade (ResNet-18 pytorch style,
32-channel FPN, 3 stages with per-stage ``HTCMaskHead``s and the
semantic branch; ``tests/test_torch_port_fpn.py:fpn_cfg``) on a 64×96
image with ground-truth masks and a stride-8 ``gt_semantic_seg`` holding
ignored pixels, on the JAX FPN maps and the JAX sampler draws, and the
``build_detector`` / ``train_detector`` dispatch of the HTC, Mask Scoring
and Grid R-CNN configs.  Weights as in ``tests/test_torch_port_fpn.py``;
the JAX loss and gradients come from one jitted ``value_and_grad``,
computed once in a module fixture."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine.train_two_stage import \
    TwoStageTrainer as JaxTwoStageTrainer
from hvrnet_tpu.models.losses import softmax_cross_entropy as jax_ce
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.engine.canvas import Canvas
from hvrnet_tpu_torch.engine.train_two_stage import (TwoStageTrainer,
                                                     semantic_loss)
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_fpn import ENGINES, calibrated, fpn_cfg
from tests.test_torch_port_image import _jax_c4, _nchw
from tests.test_torch_port_selsa import _jax_noise
from tests.test_torch_port_train import (  # noqa: F401  (work_dir)
    ReluPattern, assert_grads_against_float64, default_dtype, relu_as,
    trainable_grads, work_dir)

torch.set_num_threads(2)

CANVAS = (64, 96)
OPT = dict(optimizer=dict(lr=1e-3, momentum=0.9, weight_decay=1e-4))
STAGES = 3


def train_cfg():
    """HTC's training settings at test size: 3 stages at IoU 0.5 / 0.6 /
    0.7 sampling 32 RoIs each, weights 1 / 0.5 / 0.25."""
    def stage(iou):
        return dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=iou,
                                  neg_iou_thr=iou, min_pos_iou=iou),
                    sampler=dict(type="RandomSampler", num=32,
                                 pos_fraction=0.25,
                                 add_gt_as_proposals=True),
                    pos_weight=-1, mask_size=28)
    return dict(
        rpn=dict(assigner=dict(pos_iou_thr=0.7, neg_iou_thr=0.3,
                               min_pos_iou=0.3),
                 sampler=dict(num=64, pos_fraction=0.5), pos_weight=-1),
        rpn_proposal=dict(nms_pre=200, nms_post=64, max_num=64, nms_thr=0.7,
                          min_bbox_size=0),
        rcnn=[stage(t) for t in (0.5, 0.6, 0.7)],
        stage_loss_weights=[1, 0.5, 0.25])


def htc_sample(seed=5, semantic=True):
    """One 64×96 image with 3 ground-truth slots (2 used: a rectangle and
    an ellipse mask) and, with ``semantic``, an 8×12 label map at the
    fusion level's stride of 8, mostly the ignore label 255."""
    rng = np.random.default_rng(seed)
    h, w = CANVAS
    gt = np.array([[5, 5, 40, 40], [30, 20, 80, 60], [0, 0, 0, 0]],
                  np.float32)
    masks = np.zeros((3, h, w), np.float32)
    masks[0, 5:41, 5:41] = 1
    yy, xx = np.mgrid[:h, :w]
    masks[1] = ((yy - 40) / 20.5) ** 2 + ((xx - 55) / 25.5) ** 2 <= 1
    sample = dict(img=rng.normal(size=(h, w, 3)).astype(np.float32) * 40,
                  gt_bboxes=gt, gt_labels=np.array([1, 5, 0]),
                  gt_mask=np.array([True, True, False]), gt_masks=masks,
                  img_shape=np.array([h - 4.0, w - 6.0], np.float32),
                  pad_shape=np.array([float(h), float(w)], np.float32))
    if semantic:
        seg = np.full((h // 8, w // 8), 255, np.int64)
        seg[0:5, 0:5] = 1
        seg[2:8, 4:10] = 5
        seg[6:8, 10:12] = 11
        sample["gt_semantic_seg"] = seg
    return sample


def _step(model_cfg, sd, sample, feats, noise, dtype=torch.float32):
    """The port's step from the image through the JAX FPN maps (their
    values, the port backbone's and neck's gradient path) to the
    gradients: (trainer, logs)."""
    eng = ENGINES["htc"][1](model_cfg, device="cpu", train_cfg=train_cfg())
    eng.load_state_dict(sd)
    trainer = TwoStageTrainer(eng, OPT, steps_per_epoch=10)
    with default_dtype(dtype):
        eng.model.to(dtype)
        own = eng.model.extract_feat(_nchw(sample["img"][None]).to(dtype))
        fed = tuple(o + (_nchw(f).to(dtype) - o).detach()
                    for o, f in zip(own, feats))
        loss, logs = trainer.loss_from_c4(fed, sample, noise)
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    logs["loss"] = loss
    return trainer, logs


@pytest.fixture(scope="module")
def htc_step():
    """The JAX ``TwoStageTrainer``'s loss and gradients (jitted) of HTC on
    one image and the port's step on the JAX FPN maps and the JAX sampler
    draws (``split(key, 4)``: [0] the anchors, [1 + s] stage s's
    candidates: the ground truth and the 64 proposals, then the 32
    refined RoIs of the stage before), with its float64 recompute on the
    float32 step's ReLU pattern."""
    model_cfg = fpn_cfg()
    sample = htc_sample()
    jeng, params, port = calibrated(
        "htc", [dict(img=sample["img"][None],
                     img_shape=sample["img_shape"])],
        seed=12, train_cfg=train_cfg())
    key = jax.random.PRNGKey(21)
    jtrainer = JaxTwoStageTrainer(jeng, OPT, mesh=None, steps_per_epoch=10)
    loss_fn = jtrainer._build_loss_fn(*CANVAS)
    jsample = jax.tree_util.tree_map(jnp.asarray, sample)
    (loss, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jsample, key)
    feats = [np.asarray(f) for f in _jax_c4(jeng, params,
                                            jsample["img"][None])]
    keys = jax.random.split(key, STAGES + 1)
    n_gt = sample["gt_bboxes"].shape[0]
    n_props = [64] + [32] * (STAGES - 1)
    n_anchors = Canvas(*CANVAS, stride=4, scales=(8,)).anchors.shape[0]
    noise = (tuple(torch.from_numpy(x.copy())
                   for x in _jax_noise(keys[0], n_anchors)),
             [tuple(torch.from_numpy(x.copy()) for x in _jax_noise(
                 keys[1 + s], n_gt + n_props[s])) for s in range(STAGES)])
    case = (model_cfg, port.model.state_dict(), sample, feats, noise)
    pattern = ReluPattern()
    with relu_as(pattern):
        trainer, plogs = _step(*case)
        with pattern.replay():
            tr64, _ = _step(*case, dtype=torch.float64)
    jgrads = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.device_get(grads), model_cfg).items()}
    return dict(jlogs=dict(jax.device_get(logs), loss=float(loss)),
                logs=plogs, g32=trainable_grads(trainer),
                g64=trainable_grads(tr64), jgrads=jgrads, case=case,
                trained=[n for n, p in trainer.engine.model.named_parameters()
                         if p.requires_grad])


HEADS = ("bbox_head.", "mask_head.")


def test_htc_training_step_matches_jax(htc_step):
    """One HTC ``TwoStageTrainer`` step on the JAX FPN maps (through the
    port's backbone and neck) and the JAX sampler draws: every log within
    1e-5 relative of the JAX trainer's (``loss_semantic_seg``,
    ``loss_mask_s{0,1,2}``, ``loss_cls_s{s}``, ``loss_bbox_s{s}``,
    ``acc_s{s}``, the RPN's and the total), each loss above 0; the trained
    set is the backbone from ``layer2``, the neck, the RPN, every stage's
    bbox and mask head and the semantic head.  Gradients: the port's
    within 1e-5 of each tensor's max |grad| in its float64 recompute on
    the float32 step's ReLU pattern (the backbone's and the neck's
    1e-4); the heads' through ``assert_grads_against_float64``, where the
    JAX package's are held too (within 1e-3, and within 1e-4 of the
    float64 truth).  The conv trunks' JAX gradients (backbone, neck,
    semantic head) are not held: XLA:CPU's jitted float32 forward tips
    other ReLU inputs across 0."""
    r = htc_step
    jlogs, logs = r["jlogs"], r["logs"]
    keys = [k for k in jlogs if k.startswith(("loss", "acc"))]
    assert set(keys) <= set(logs)
    assert {"loss_semantic_seg", "loss_mask_s0", "loss_mask_s1",
            "loss_mask_s2", "loss_cls_s0", "loss_cls_s1"} <= set(keys)
    for k in keys:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        if k.startswith("loss"):
            assert float(jlogs[k]) > 0, k
    trained = ("backbone.layer2.", "backbone.layer3.", "backbone.layer4.",
               "neck.", "rpn_head.", "semantic_head.") + HEADS
    g32, g64 = r["g32"], r["g64"]
    assert set(g64) == set(r["trained"])
    assert all(n.startswith(trained) for n in g64)
    assert {n.split(".")[0] for n in g64} == {
        "backbone", "neck", "rpn_head", "semantic_head", "bbox_head",
        "mask_head"}
    for n, t in g64.items():
        if not n.startswith(HEADS):
            tol = 1e-4 if n.startswith(("backbone.", "neck.")) else 1e-5
            assert np.abs(g32[n] - t).max() <= tol * np.abs(t).max(), n
    heads = [n for n in g64 if n.startswith(HEADS)]
    assert any(n.startswith("mask_head.2.conv_res") for n in heads)
    assert_grads_against_float64(
        {n: g32[n] for n in heads}, r["jgrads"], {n: g64[n] for n in heads},
        None, None, may_stray=())


def test_mask_stages_train_through_the_replay(htc_step):
    """Stage s's mask loss reaches the mask heads before it through the
    replayed trunks: with only the last stage weighted, mask heads 0 and 1
    still get gradients (their trunks feed head 2's ``conv_res``), while
    their ``conv_logits`` and ``upsample`` get none."""
    model_cfg, sd, sample, feats, noise = htc_step["case"]
    eng = ENGINES["htc"][1](model_cfg, device="cpu", train_cfg=dict(
        train_cfg(), stage_loss_weights=[0.0, 0.0, 1.0]))
    eng.load_state_dict(sd)
    trainer = TwoStageTrainer(eng, OPT, steps_per_epoch=10)
    own = eng.model.extract_feat(_nchw(sample["img"][None]))
    loss, _ = trainer.loss_from_c4(
        tuple(o + (_nchw(f) - o).detach() for o, f in zip(own, feats)),
        sample, noise)
    loss.backward()
    grads = trainable_grads(trainer)
    for s in (0, 1):
        pre = f"mask_head.{s}."
        assert np.abs(grads[pre + "convs.0.conv.weight"]).max() > 0
        for n in ("conv_logits.weight", "upsample.weight"):
            assert not np.abs(grads[pre + n]).any(), pre + n
    assert np.abs(grads["mask_head.2.conv_logits.weight"]).max() > 0


def test_semantic_loss_matches_jax():
    """``semantic_loss`` against the JAX step's expression on logits and
    labels with ignored pixels (255) and every class present: within 1e-6
    relative; the ignored pixels' logits get no gradient."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((7, 6, 9)).astype(np.float32) * 3
    labels = rng.integers(0, 7, (6, 9))
    labels[rng.uniform(size=(6, 9)) < 0.4] = 255
    flat = jnp.asarray(logits.transpose(1, 2, 0).reshape(-1, 7))
    lab = jnp.asarray(labels.reshape(-1))
    valid = (lab != 255).astype(jnp.float32)
    # the JAX step's gather of label 255 is out of range: clip it, as
    # XLA's gather does inside the jitted step
    ce = jax_ce(flat, jnp.clip(lab, 0, 6))
    want = 0.2 * float((ce * valid).sum() / jnp.maximum(valid.sum(), 1.0))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = semantic_loss(x, torch.from_numpy(labels), 255, 0.2)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    got.backward()
    ignored = torch.from_numpy(labels == 255)
    assert not x.grad[:, ignored].any() and x.grad[:, ~ignored].any()


@pytest.mark.parametrize("kind", ["htc", "mask_scoring", "grid"])
def test_build_and_train_detector_dispatch(kind, work_dir):
    """``build_detector`` builds ``HybridTaskCascade``, ``MaskScoringRCNN``
    and ``GridRCNN`` from FPN configs (the last two warn that their extra
    head is not run); ``train_detector`` trains each with
    ``TwoStageTrainer`` on a still image: one step moves the neck, the RPN,
    every bbox head and the mask head (HTC: the semantic head and every
    stage's mask head, ``mask_head.2``'s ``conv_res`` among them), and
    keeps every tensor that does not train (the stem, ``layer1``, every
    frozen-BN statistic) bit for bit."""
    cfg = fpn_cfg(kind)
    tcfg = train_cfg()
    if kind != "htc":
        tcfg = dict(tcfg, rcnn=tcfg["rcnn"][0], stage_loss_weights=[1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = apis.build_detector(cfg, train_cfg=tcfg, device="cpu", seed=2)
    assert any("run by neither" in str(w.message) for w in caught) == (
        kind != "htc")
    assert type(eng) is ENGINES[kind][1]
    sample = htc_sample(semantic=kind == "htc")
    calibrate_frozen_bn(eng, [dict(img=sample["img"][None],
                                   img_shape=sample["img_shape"])])
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    trainer = apis.train_detector(eng, [sample], dict(OPT, total_epochs=1),
                                  str(work_dir / kind), seed=1)
    assert type(trainer) is TwoStageTrainer and trainer.step == 1
    after = eng.model.state_dict()
    moved = ["neck.fpn_convs.0.conv.weight", "rpn_head.rpn_conv.weight"]
    if kind == "htc":
        moved += [f"bbox_head.{i}.fc_cls.weight" for i in range(3)] + [
            "semantic_head.convs.0.conv.weight",
            "mask_head.2.conv_res.conv.weight"] + [
            f"mask_head.{i}.conv_logits.weight" for i in range(3)]
    else:
        moved.append("bbox_head.fc_cls.weight")
    if kind == "mask_scoring":
        moved.append("mask_head.conv_logits.weight")
    for k in moved:
        assert not torch.equal(after[k], before[k]), k
    trains = {n for n, p in eng.model.named_parameters() if p.requires_grad}
    frozen = [k for k in before if k not in trains]
    assert {"backbone.conv1.weight", "backbone.layer1.0.conv1.weight",
            "backbone.layer4.1.bn2.running_var"} <= set(frozen)
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
