"""The single-stage detectors' training in the port against the JAX
package: ``fcos_points`` / ``fcos_targets``, ``fovea_level_targets``,
``ssd_targets_and_loss`` and ``free_anchor_loss`` on the same inputs (ties
included: two ground truths of equal area over one point, equal cross
entropy among the negatives, equal IoU in a bag), one step of each of
``RetinaTrainer``, ``FreeAnchorTrainer``, ``SSDTrainer``, ``FCOSTrainer``
and ``FoveaTrainer`` on the JAX neck maps (losses against the jitted JAX
loss, gradients against the port's float64 recompute), one SGD step
against the JAX optax chain, and the ``train_detector`` dispatch.

The models are those of ``tests/test_torch_port_dense.py`` (ResNet-18, a
16-channel FPN, 11 classes, 64×96); SSD's trainer runs on a six-level FPN
(strides 4 to 128) under SSD300's anchor sizes, where the full SSDVGG
would cost minutes of CPU.  The JAX losses and gradients come from one
jitted ``value_and_grad`` per trainer, computed once in a module fixture.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hvrnet_tpu.engine import train_fcos as jax_train_fcos
from hvrnet_tpu.engine import train_single_stage as jax_train_ss
from hvrnet_tpu.engine.optim import make_optimizer as jax_make_optimizer
from hvrnet_tpu.engine.optim import step_lr_schedule as jax_schedule
from hvrnet_tpu.engine.train_mask import \
    ssd_targets_and_loss as jax_ssd_loss
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine import single_stage
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.engine.train_fcos import (FCOSTrainer, FoveaTrainer,
                                                fcos_points, fcos_targets,
                                                fovea_level_targets)
from hvrnet_tpu_torch.engine.train_mask import ssd_targets_and_loss
from hvrnet_tpu_torch.engine.train_single_stage import (FreeAnchorTrainer,
                                                        RetinaTrainer,
                                                        SSDTrainer,
                                                        free_anchor_loss)
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_dense import (CANVAS, ENGINES, calibrated,
                                         dense_cfg, jax_feats)
from tests.test_torch_port_image import _nchw
from tests.test_torch_port_precision import _merge
from tests.test_torch_port_train import (  # noqa: F401  (work_dir)
    ReluPattern, assert_grads_against_float64, default_dtype, relu_as,
    trainable_grads, work_dir)

torch.set_num_threads(2)

OPT = dict(optimizer=dict(lr=1e-3, momentum=0.9, weight_decay=1e-4))
TRAIN_CFG = dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                               neg_iou_thr=0.4, min_pos_iou=0.0),
                 allowed_border=-1, neg_pos_ratio=3, smoothl1_beta=1.0)
TRAINERS = {"retina": RetinaTrainer, "free_anchor": FreeAnchorTrainer,
            "ssd": SSDTrainer, "fcos": FCOSTrainer, "fovea": FoveaTrainer}


def train_cfg_of(kind):
    """``dense_cfg(kind)``, with SSD's head on a six-level FPN of
    ResNet-18 (strides 4 to 128, 16 channels) under SSD300's anchors, and
    FCOS on three levels (strides 8 to 32) with 64-wide towers: its
    GroupNorm groups then hold 2 channels of at least 6 positions (of 1
    channel, the conv biases before them get no gradient but rounding;
    over 1 or 2 positions the fast variance cancels, and the float64
    recompute parts from float32 by 1e-3)."""
    if kind == "fcos":
        cfg = dense_cfg(kind)
        return dict(cfg, neck=dict(cfg["neck"], num_outs=3,
                                   add_extra_convs=False),
                    bbox_head=dict(cfg["bbox_head"], feat_channels=64,
                                   strides=[8, 16, 32]))
    if kind != "ssd":
        return dense_cfg(kind)
    cfg = dense_cfg("retina")
    ssd = dense_cfg("ssd")["bbox_head"]
    return dict(cfg, type="SingleStageDetector",
                neck=dict(cfg["neck"], start_level=0, num_outs=6),
                bbox_head=dict(ssd, in_channels=(16,) * 6,
                               anchor_strides=(4, 8, 16, 32, 64, 128)))


def train_sample(seed=5):
    """One 64×96 image with 4 ground-truth slots: three boxes (two of equal
    area, 900 px², overlapping) and one unused slot."""
    rng = np.random.default_rng(seed)
    h, w = CANVAS
    gt = np.array([[6, 8, 36, 38], [20, 18, 50, 48], [40, 4, 88, 60],
                   [0, 0, 0, 0]], np.float32)
    return dict(img=rng.normal(size=(h, w, 3)).astype(np.float32) * 40,
                gt_bboxes=gt, gt_labels=np.array([1, 4, 9, 0]),
                gt_mask=np.array([True, True, True, False]),
                img_shape=np.array([h - 4.0, w - 6.0], np.float32),
                pad_shape=np.array([float(h), float(w)], np.float32))


def jax_batch(sample):
    """The JAX step's sample layout: one frame of each field."""
    return dict(imgs=jnp.asarray(sample["img"][None]),
                **{k: jnp.asarray(sample[k][None]) for k in (
                    "gt_bboxes", "gt_labels", "gt_mask", "img_shape")})


def jax_loss_fn(jtrainer, canvas):
    """The JAX trainer's ``loss_fn(params, sample, rng)``: built by
    ``_build_loss_fn`` (RetinaNet's family) or taken from the closure of
    ``make_train_step``'s step (FCOS and FoveaBox)."""
    if hasattr(jtrainer, "_build_loss_fn"):
        return jtrainer._build_loss_fn(*canvas)
    step = jtrainer.make_train_step(*canvas).__wrapped__
    return step.__closure__[step.__code__.co_freevars.index(
        "loss_fn")].cell_contents


JAX_TRAINERS = {"retina": jax_train_ss.RetinaTrainer,
                "free_anchor": jax_train_ss.FreeAnchorTrainer,
                "ssd": jax_train_ss.SSDTrainer,
                "fcos": jax_train_fcos.FCOSTrainer,
                "fovea": jax_train_fcos.FoveaTrainer}


def _step(kind, model_cfg, sd, sample, feats, dtype=torch.float32):
    """The port's step from the image through the JAX neck maps (their
    values, the port backbone's and neck's gradient path) to the
    gradients: (trainer, logs)."""
    eng = ENGINES[model_cfg["type"]](model_cfg, device="cpu",
                                     train_cfg=TRAIN_CFG)
    eng.load_state_dict(sd)
    trainer = TRAINERS[kind](eng, OPT, steps_per_epoch=10)
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
def dense_steps():
    """Per trainer: the JAX loss, logs and gradients (one jitted
    ``value_and_grad``) on one image, the port's step on the JAX neck maps
    with its float64 recompute on the float32 step's ReLU pattern."""
    sample = train_sample()
    out = {}
    for kind in TRAINERS:
        cfg = train_cfg_of(kind)
        jeng, params, port = calibrated_train(kind, cfg, sample)
        jtrainer = JAX_TRAINERS[kind](jeng, OPT, steps_per_epoch=10)
        loss_fn = jax_loss_fn(jtrainer, CANVAS)
        (loss, logs), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jax_batch(sample),
                                    jax.random.PRNGKey(0))
        feats = [f.numpy() for f in jax_feats(jeng, params,
                                              sample["img"][None])]
        feats = [f.transpose(0, 2, 3, 1) for f in feats]
        case = (kind, cfg, port.model.state_dict(), sample, feats)
        pattern = ReluPattern()
        with relu_as(pattern):
            trainer, plogs = _step(*case)
            with pattern.replay():
                tr64, _ = _step(*case, dtype=torch.float64)
        out[kind] = dict(
            jlogs=dict(jax.device_get(logs), loss=float(loss)), logs=plogs,
            g32=trainable_grads(trainer), g64=trainable_grads(tr64),
            jgrads={k: v.numpy() for k, v in state_dict_from_jax(
                jax.device_get(grads)).items()},
            jgrad_tree=jax.device_get(grads),
            tree=params, trainer=trainer, jtrainer=jtrainer)
    return out


# the classifiers' kernels scaled down from the serving tests' draw so
# that their logits have std ~2: a sigmoid saturated to 1.0 in float32
# (logits of 17 and more) is clamped by the losses' log(1 - p), where the
# float64 recompute is not, and its gradient then tells nothing
CLS_SCALE = {"retina_cls": 0.15, "fovea_cls": 0.2, "cls_conv": 0.3}


def calibrated_train(kind, cfg, sample):
    """``calibrated`` of the test module on ``cfg`` (SSD's FPN variant
    too) and the training config, the classifiers scaled by
    ``CLS_SCALE``."""
    jeng, tree, port = calibrated(kind, sample["img"][None],
                                  sample["img_shape"], seed=12,
                                  train_cfg=TRAIN_CFG, cfg=cfg)
    head = dict(tree["params"]["bbox_head"])
    for name, node in head.items():
        scale = CLS_SCALE.get(name.rstrip("0123456789"))
        if scale is not None:
            head[name] = dict(node, kernel=np.asarray(node["kernel"])
                              * np.float32(scale))
    tree = {"params": dict(tree["params"], bbox_head=head)}
    port.load_state_dict(state_dict_from_jax(tree))
    return jeng, tree, port


HEADS = ("bbox_head.",)


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_training_step_matches_jax(dense_steps, kind):
    """One step of each dense trainer on the JAX neck maps: every log
    within 1e-5 relative of the JAX trainer's (``num_pos`` exactly), each
    loss above 0; the trained set is the backbone from ``layer2``, the
    neck and the head.  Gradients: the port's within 1e-5 of each
    tensor's max |grad| in its float64 recompute on the float32 step's
    ReLU pattern (the backbone's and the neck's 1e-4); the head's through
    ``assert_grads_against_float64``, where the JAX package's are held too
    (within 1e-3, and within 1e-4 of the float64 truth); a head tensor
    without gradient in the float64 truth has none on either side."""
    r = dense_steps[kind]
    jlogs, logs = r["jlogs"], r["logs"]
    assert set(jlogs) <= set(logs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        if k.startswith(("loss", "positive", "negative")):
            assert float(jlogs[k]) > 0, k
    if "num_pos" in jlogs:
        assert float(jlogs["num_pos"]) >= 1
    g32, g64 = r["g32"], r["g64"]
    assert {n.split(".")[0] for n in g64} == {"backbone", "neck",
                                              "bbox_head"}
    assert not any(n.startswith(("backbone.conv1.", "backbone.layer1."))
                   for n in g64)
    for n, t in g64.items():
        if not n.startswith(HEADS):
            assert np.abs(g32[n] - t).max() <= 1e-4 * np.abs(t).max(), n
    heads = [n for n in g64 if n.startswith(HEADS)]
    # an SSD level whose anchors hold no positive and no mined negative
    # gets no gradient, in all three
    for n in [n for n in heads if not np.abs(g64[n]).any()]:
        assert not g32[n].any() and not r["jgrads"][n].any(), n
        heads.remove(n)
    assert_grads_against_float64(
        {n: g32[n] for n in heads}, r["jgrads"], {n: g64[n] for n in heads},
        None, None, may_stray=())


def _prune(t):
    """The trainable leaves of a JAX tree: without the frozen BNs, the stem
    and ``layer1``."""
    if not isinstance(t, dict):
        return t
    return {k: _prune(v) for k, v in t.items()
            if k not in ("bn", "stem", "layer1")}


@pytest.mark.parametrize("kind", ["retina", "fcos"])
def test_sgd_step_matches_the_jax_chain(dense_steps, kind):
    """The dense trainer's SGD step from the JAX gradients scaled to global
    norm 100 (so the clip at 35 acts), at the dense trainers' default
    schedule's first lr (warmup), with weight decay and momentum, against
    the JAX optax chain over the trainable subtree (the backbone from
    ``layer2``, the neck, the head; FCOS's GroupNorm affines and per-level
    scales among them): every tensor within 1e-6."""
    r = dense_steps[kind]
    trainer, tree = r["trainer"], r["tree"]
    eng = trainer.engine
    eng.load_state_dict(state_dict_from_jax(tree))
    gp = jax.tree_util.tree_map(jnp.asarray, {
        "params": _prune(r["jgrad_tree"]["params"])})
    scale = 100.0 / jax.jit(optax.global_norm)(gp)
    gp = jax.tree_util.tree_map(lambda g: g * scale, gp)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                {"params": _prune(tree["params"])})
    tx = jax_make_optimizer(jax_schedule(1e-3, 10, [8, 11], warmup_iters=500,
                                         warmup_ratio=1.0 / 3),
                            momentum=0.9, weight_decay=1e-4, clip_norm=35.0)
    upd, _ = jax.jit(tx.update)(gp, tx.init(jp), jp)
    want = state_dict_from_jax(_merge(tree, jax.jit(optax.apply_updates)(
        jp, upd)))
    g = state_dict_from_jax(_merge(jax.tree_util.tree_map(np.zeros_like,
                                                          tree),
                                   jax.device_get(gp)))
    for name, p in eng.model.named_parameters():
        p.grad = g[name].clone() if p.requires_grad else None
    before = state_dict_from_jax(tree)
    trainer.apply_update()
    for name, t in eng.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert sum(not torch.equal(want[n], before[n]) for n in want) > 10


# -------------------------------------------------------------- targets
def test_fcos_targets_match_jax():
    """``fcos_points`` (strides 8 to 128 on the 64×96 canvas) and
    ``fcos_targets`` against the JAX functions, the second gt of equal
    area (900 px²) to the first and over the same points, an unused slot:
    labels, positives and ltrb targets bit for bit, centerness within
    1e-6 relative (XLA's square root rounds a few values an ulp apart);
    the tied points go to the first gt (``argmin``)."""
    s = train_sample()
    strides = (8, 16, 32, 64, 128)
    pts, lv = fcos_points(CANVAS, strides)
    jpts, jlv = jax_train_fcos.fcos_points(CANVAS, strides)
    np.testing.assert_array_equal(pts, np.asarray(jpts))
    np.testing.assert_array_equal(lv, np.asarray(jlv))
    rr = np.asarray(jax_train_fcos.DEFAULT_REGRESS_RANGES, np.float32)
    gt = {k: s[k] for k in ("gt_bboxes", "gt_mask", "gt_labels")}
    want = jax.jit(jax_train_fcos.fcos_targets)(
        jnp.asarray(jpts), jnp.asarray(jlv), jnp.asarray(rr),
        *(jnp.asarray(gt[k]) for k in ("gt_bboxes", "gt_mask", "gt_labels")))
    got = fcos_targets(torch.from_numpy(pts), torch.from_numpy(lv),
                       torch.from_numpy(rr),
                       *(torch.from_numpy(gt[k]) for k in (
                           "gt_bboxes", "gt_mask", "gt_labels")))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-6 if i == 2 else 0, atol=0)
    b = s["gt_bboxes"]
    both = ((pts[:, 0] > b[1, 0]) & (pts[:, 0] < b[0, 2])
            & (pts[:, 1] > b[1, 1]) & (pts[:, 1] < b[0, 3]) & (lv == 0))
    assert both.any() and (got[0].numpy()[both] == 1).all()


@pytest.mark.parametrize("level", [0, 1, 2])
def test_fovea_targets_match_jax(level):
    """``fovea_level_targets`` at strides 8, 16 and 32 with the full
    config's scale ranges, two gts of equal area (900 px²) whose foveae
    overlap, a larger one and an unused slot: labels, log-space targets
    and positives equal to the JAX function's (the targets within 1e-6
    relative); at stride 8 the positions both foveae cover go to the
    first gt."""
    gt = dict(gt_bboxes=np.array([[10, 10, 40, 40], [12, 14, 42, 44],
                                  [40, 4, 88, 60], [0, 0, 0, 0]],
                                 np.float32),
              gt_mask=np.array([True, True, True, False]),
              gt_labels=np.array([1, 4, 9, 0]))
    strides, edges = (8, 16, 32), (16, 32, 64)
    ranges = ((1, 64), (32, 128), (64, 256))
    hw = (CANVAS[0] // strides[level], CANVAS[1] // strides[level])
    args = (hw, strides[level], edges[level], *ranges[level], 0.4)
    keys = ("gt_bboxes", "gt_mask", "gt_labels")
    want = jax.jit(jax_train_fcos.fovea_level_targets,
                   static_argnums=tuple(range(3, 9)))(
        *(jnp.asarray(gt[k]) for k in keys), *args)
    got = fovea_level_targets(*(torch.from_numpy(gt[k]) for k in keys),
                              *args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
    if level == 0:
        alone = [fovea_level_targets(
            torch.from_numpy(gt["gt_bboxes"]),
            torch.from_numpy(np.arange(4) == i),
            torch.from_numpy(gt["gt_labels"]), *args)[2] for i in (0, 1)]
        both = alone[0] & alone[1]
        assert both.any() and (got[0][both] == 1).all()


def test_ssd_targets_and_loss_matches_jax():
    """``ssd_targets_and_loss`` on 600 anchors whose negatives share a few
    logit rows (equal cross entropy across hundreds of anchors, the 3:1
    cut inside a tie): both losses within 1e-6 relative, and the logits'
    gradient (which negatives were mined) within 1e-6 of the JAX one."""
    rng = np.random.default_rng(4)
    anchors = np.concatenate([rng.uniform(0, 80, (600, 2)),
                              rng.uniform(0, 80, (600, 2))], 1)
    anchors = np.sort(anchors.reshape(600, 2, 2), axis=1).transpose(
        0, 2, 1).reshape(600, 4)
    anchors = anchors[:, [0, 2, 1, 3]].astype(np.float32)
    rows = rng.standard_normal((4, 10)).astype(np.float32)
    logits = rows[rng.integers(0, 4, 600)]
    deltas = rng.standard_normal((600, 4)).astype(np.float32) * 0.5
    s = train_sample()
    gt = [s[k] for k in ("gt_bboxes", "gt_mask", "gt_labels")]
    kw = dict(neg_pos_ratio=3, target_stds=(0.1, 0.1, 0.2, 0.2),
              smoothl1_beta=1.0)

    def jloss(lg, dl):
        c, b = jax_ssd_loss(lg, dl, jnp.asarray(anchors),
                            *(jnp.asarray(g) for g in gt), **kw)
        return c + b, (c, b)

    (_, (jc, jb)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(logits), jnp.asarray(deltas))
    lg = torch.from_numpy(logits).requires_grad_(True)
    dl = torch.from_numpy(deltas).requires_grad_(True)
    c, b = ssd_targets_and_loss(lg, dl, torch.from_numpy(anchors),
                                *(torch.from_numpy(g) for g in gt), **kw)
    (c + b).backward()
    np.testing.assert_allclose(float(c), float(jc), rtol=1e-6)
    np.testing.assert_allclose(float(b), float(jb), rtol=1e-6)
    assert float(b) > 0
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jg[0]), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jg[0])).max())
    np.testing.assert_allclose(dl.grad.numpy(), np.asarray(jg[1]), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jg[1])).max())
    mined = (np.abs(np.asarray(jg[0])).sum(1) > 0)
    assert 0 < mined.sum() < 600


def test_free_anchor_loss_matches_jax():
    """``free_anchor_loss`` over RetinaNet's anchors of the 64×96 canvas
    (bags of 50, whose anchor IoUs tie in symmetric pairs; an unused gt
    slot; a class without a gt): the three outputs and the gradients of
    the class probabilities and deltas within 1e-6 relative of the JAX
    function's (the predicted boxes and the image box probability
    detached on both sides)."""
    from hvrnet_tpu_torch.engine.single_stage import retina_scales
    from hvrnet_tpu_torch.ops.anchors import AnchorGenerator
    head = dense_cfg("free_anchor")["bbox_head"]
    anchors = np.concatenate([AnchorGenerator(
        st, retina_scales(head), (0.5, 1.0, 2.0)).grid_anchors(
            (-(-CANVAS[0] // st), -(-CANVAS[1] // st)), st)
        for st in (8, 16, 32, 64, 128)])
    rng = np.random.default_rng(6)
    prob = rng.uniform(0.01, 0.99, (len(anchors), 10)).astype(np.float32)
    deltas = (rng.standard_normal((len(anchors), 4)) * 0.3).astype(
        np.float32)
    s = train_sample()
    gt = [s[k] for k in ("gt_bboxes", "gt_mask", "gt_labels")]
    iou = jax_train_ss.bbox_overlaps(jnp.asarray(gt[0][:1]),
                                     jnp.asarray(anchors))
    assert len(np.unique(np.asarray(iou)[0, np.argsort(
        -np.asarray(iou)[0])[:50]])) < 50

    def jloss(p, d):
        pos, neg, n = jax_train_ss.free_anchor_loss(
            p, d, jnp.asarray(anchors), *(jnp.asarray(g) for g in gt),
            num_fg_classes=10)
        return pos + neg, (pos, neg, n)

    (_, (jpos, jneg, jn)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(prob),
                                              jnp.asarray(deltas))
    p = torch.from_numpy(prob).requires_grad_(True)
    d = torch.from_numpy(deltas).requires_grad_(True)
    pos, neg, n = free_anchor_loss(p, d, torch.from_numpy(anchors),
                                   *(torch.from_numpy(g) for g in gt),
                                   num_fg_classes=10)
    (pos + neg).backward()
    assert int(n) == int(jn) == 3
    np.testing.assert_allclose(float(pos), float(jpos), rtol=1e-6)
    np.testing.assert_allclose(float(neg), float(jneg), rtol=1e-6)
    for got, want in ((p.grad, jg[0]), (d.grad, jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        assert np.abs(want).max() > 0


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("kind", list(TRAINERS))
def test_train_detector_dispatch(kind, work_dir):
    """``build_detector`` builds each single-stage engine for training and
    ``train_detector`` picks its trainer by head type (``FCOSHead`` →
    ``FCOSTrainer``, ``FoveaHead`` → ``FoveaTrainer``,
    ``FreeAnchorRetinaHead`` → ``FreeAnchorTrainer``, ``SSDHead`` →
    ``SSDTrainer``, ``RetinaHead`` → ``RetinaTrainer``): one step moves the
    neck and the head's output convs and keeps every tensor that does not
    train (the stem, ``layer1``, every frozen-BN statistic) bit for
    bit."""
    cfg = train_cfg_of(kind)
    eng = apis.build_detector(cfg, train_cfg=TRAIN_CFG, device="cpu", seed=2)
    sample = train_sample()
    calibrate_frozen_bn(eng, [dict(img=sample["img"][None],
                                   img_shape=sample["img_shape"])])
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    trainer = apis.train_detector(eng, [sample], dict(OPT, total_epochs=1),
                                  str(work_dir / kind), seed=1)
    assert type(trainer) is TRAINERS[kind] and trainer.step == 1
    after = eng.model.state_dict()
    out = {"retina": "retina_cls", "free_anchor": "retina_cls",
           "ssd": "cls_convs.0", "fcos": "fcos_cls",
           "fovea": "fovea_cls"}[kind]
    for k in ("neck.fpn_convs.0.conv.weight", f"bbox_head.{out}.weight",
              "backbone.layer2.0.conv1.weight"):
        assert not torch.equal(after[k], before[k]), k
    trains = {n for n, p in eng.model.named_parameters() if p.requires_grad}
    frozen = [k for k in before if k not in trains]
    assert {"backbone.conv1.weight", "backbone.layer1.0.conv1.weight",
            "backbone.layer4.1.bn2.running_var"} <= set(frozen)
    for k in frozen:
        assert torch.equal(after[k], before[k]), k


def test_train_detector_refuses_the_rpn_engine(work_dir):
    """A single-stage engine without a training objective (``RPN``, as the
    JAX ``build_trainer``) raises ``ValueError``; a dense trainer refuses
    another engine's type."""
    cfg = dict(dense_cfg("retina"), type="RPN")
    eng = apis.build_detector(cfg, train_cfg=TRAIN_CFG, device="cpu")
    assert isinstance(eng, single_stage.SingleStageEngine)
    with pytest.raises(ValueError, match="no training objective"):
        apis.train_detector(eng, [train_sample()], OPT, str(work_dir))
    from tests.test_torch_port_fpn import fpn_cfg
    htc = apis.build_detector(fpn_cfg("grid"), train_cfg=TRAIN_CFG,
                              device="cpu")
    with pytest.raises(TypeError, match="SingleStageEngine"):
        RetinaTrainer(htc, OPT)
