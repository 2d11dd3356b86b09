"""The still-image Faster R-CNN (``FasterRCNN.simple_test`` / ``aug_test``,
``BBoxHead``), its trainer, ``SelsaTrainer`` with a single sampler and the
single-image API (``apis.init_detector`` / ``inference_detector``) in the
port against the JAX package, on the JAX tests' tiny configs
(``tests/test_train_faster_ssd.py:_faster_cfg`` / ``_faster_train_cfg``,
``tests/test_engine_hnmb.py:tiny_hnmb_cfg``,
``tests/test_engine_selsa.py:tiny_selsa_cfg``).

Weights: a JAX parameter tree filled from numpy crosses to the port
through ``state_dict_from_jax``, the port calibrates the frozen-BN
statistics on the test image and the weights cross back
(``convert_torch_checkpoint``).  ``fc_reg`` is inflated to normal(0, 0.05)
so that every class's deltas move its boxes: at the 0.001 init a decode of
the wrong class's deltas would pass.  Each JAX reference is computed once,
in a module fixture.  The sampler noise of a training step is the one
``jax.random`` draws from the JAX step's key; the step's gradients are
held to the port's float64 recompute on the float32 step's ReLU pattern.

The JAX ``inference_detector`` runs the video frame program
(``frame_features``) before it looks at the engine, and a ``BBoxHead`` has
no ``fc_new_1``: on ``FasterRCNN`` it raises ``AttributeError``.  The
port's calls the frame program on video engines only, and its
``FasterRCNN`` result is held to the JAX function's own preprocessing
followed by the JAX ``simple_test``.
"""
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu import apis as jax_apis
from hvrnet_tpu.data.pipelines import Normalize as JaxNormalize
from hvrnet_tpu.data.pipelines import Pad as JaxPad
from hvrnet_tpu.data.pipelines import Resize as JaxResize
from hvrnet_tpu.engine.canvas import pad_to_canvas as jax_pad_to_canvas
from hvrnet_tpu.engine.detector import FasterRCNN as JaxFasterRCNN
from hvrnet_tpu.engine.detector import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu.engine.detector import SelsaRCNN as JaxSelsaRCNN
from hvrnet_tpu.engine.train import SelsaTrainer as JaxSelsaTrainer
from hvrnet_tpu.engine.train_two_stage import \
    FasterRCNNTrainer as JaxFasterRCNNTrainer
from hvrnet_tpu.models.bbox_heads.bbox_head import BBoxHead as JaxBBoxHead
from hvrnet_tpu.ops.boxes import bbox2result_np as jax_bbox2result_np
from hvrnet_tpu.utils.config import Config as JaxConfig
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine import (FastRCNN, FasterRCNN, HNMBRCNN,
                                     SelsaRCNN)
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.engine.canvas import Canvas
from hvrnet_tpu_torch.engine.train import (FasterRCNNTrainer, SelsaTrainer,
                                           still_image)
from hvrnet_tpu_torch.models.bbox_heads.bbox_head import BBoxHead
from hvrnet_tpu_torch.models.bbox_heads.hrnmp_bbox_head import HRNMPBBoxHead
from hvrnet_tpu_torch.ops.boxes import bbox2result_np
from hvrnet_tpu_torch.utils.weights import (bbox_head_state_dict,
                                            state_dict_from_jax)
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_engine_selsa import tiny_selsa_cfg
from tests.test_torch_port_backbone import jax_param_tree
from tests.test_torch_port_cli import match_rows
from tests.test_torch_port_selsa import _cross_back, _jax_noise, _step_noise
from tests.test_torch_port_train import (  # noqa: F401  (work_dir)
    ReluPattern, _is_key_bias, default_dtype, relu_as, trainable_grads,
    work_dir)
from tests.test_train_faster_ssd import _faster_cfg, _faster_train_cfg
from tests.test_train_step import make_sample, tiny_model_cfg, tiny_train_cfg

torch.set_num_threads(2)

CANVAS = (64, 96)
TRAIN_CANVAS = (128, 192)
OPT = dict(optimizer=dict(lr=1e-3, momentum=0.9, weight_decay=1e-4))
FASTER_TEST_CFG = dict(
    rpn=dict(nms_pre=200, nms_post=8, max_num=8, nms_thr=0.7,
             min_bbox_size=0),
    rcnn=dict(score_thr=0.02, nms=dict(type='nms', iou_thr=0.5),
              max_per_img=20))
IMG_NORM = dict(mean=[103.06, 115.9, 123.15], std=[1.0, 1.0, 1.0],
                to_rgb=False)
# the single-image API's test image: 60×500 resizes to 120×1000, padded
# to 128×1008, the smallest canvas its (1000, 600) resize allows
API_IMAGE = (60, 500)
API_CANVAS = (128, 1008)
# the two backbones' float32 rounding through SELSA's head moves a score by
# more than 1e-4 end to end (tests/test_torch_port_cli_selsa.py)
END_TO_END_SCORE_TOL = {"hvrnet": 1e-4, "selsa": 2e-4, "faster": 1e-4}
# simple_test and aug_test through the two backbones on the 64×96 noise
# image: their C5 maps differ by 2.9e-4 of max|C5| (random weights amplify
# a rounding at each stage), which moved boxes by 0.031 px and scores by
# 1.43e-4 (measured); held at 1e-3 of the image width and 2e-4.  From the
# JAX maps: boxes 1e-3 px, scores 2e-6.
LIMITS = {"port": dict(score_tol=2e-4, box_tol=1e-3 * CANVAS[1]),
          "jax": dict(score_tol=2e-6, box_tol=1e-3)}


def _nchw(x):
    return torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy())


def _rel_close(got, want, tol, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _inflate_fc_reg(tree, seed):
    """The tree with ``bbox_head.fc_reg``'s kernel drawn at std 0.05."""
    head = dict(tree["params"]["bbox_head"])
    shape = np.asarray(head["fc_reg"]["kernel"]).shape
    head["fc_reg"] = dict(head["fc_reg"], kernel=np.random.default_rng(
        seed).normal(0, 0.05, shape).astype(np.float32))
    return {"params": dict(tree["params"], bbox_head=head)}


def _calibrated(jax_cls, port_cls, model_cfg, test_cfg, frames, seed,
                train_cfg=None):
    """(JAX engine, JAX params, port engine) on one set of calibrated
    weights (``fc_reg`` inflated on a plain head)."""
    jeng = jax_cls(model_cfg, train_cfg, test_cfg)
    tree = jax_param_tree(jeng, seed)
    if model_cfg["bbox_head"]["type"] == "BBoxHead":
        tree = _inflate_fc_reg(tree, seed)
    port = port_cls(model_cfg, test_cfg, device="cpu", train_cfg=train_cfg)
    port.load_state_dict(state_dict_from_jax(tree, model_cfg))
    calibrate_frozen_bn(port, frames)
    return jeng, _cross_back(tree, port), port


def _jax_maps(jeng, params, img):
    """The (c5, rpn cls, rpn reg) maps of NHWC ``img`` from the JAX
    engine's jitted backbone program, NCHW.  (XLA:CPU rounds the jitted
    convolutions otherwise than op-by-op ones: the maps of one program are
    the maps inside another.)"""
    fn = jeng._frame_backbone_fn(img.shape[1], img.shape[2])
    return tuple(_nchw(m) for m in fn(params, jnp.asarray(img)))


def assert_dets_match(got, want, num_classes, score_tol, box_tol=1e-3):
    """Two (dets, labels, mask) triples: per class the same number of kept
    detections, each within ``box_tol`` px and ``score_tol`` of one on the
    other side.  Returns the kept count."""
    g, w = ([np.asarray(t) for t in out] for out in (got, want))
    return assert_classes_match(
        bbox2result_np(g[0][g[2]], g[1][g[2]], num_classes),
        jax_bbox2result_np(w[0][w[2]], w[1][w[2]], num_classes),
        score_tol, box_tol)


def assert_classes_match(got, want, score_tol, box_tol=1e-3):
    assert len(got) == len(want)
    total = 0
    for cg, cw in zip(got, want):
        assert cg.shape == cw.shape
        if len(cw):
            match_rows(cg, cw, box_tol, score_tol)
        total += len(cw)
    assert total > 0
    return total


# --------------------------------------------------------------- BBoxHead
@pytest.mark.parametrize("channels", [16, 256])
@pytest.mark.parametrize("avg_pool", [False, True])
def test_bbox_head_matches_jax(channels, avg_pool):
    """``BBoxHead`` from the JAX head's parameters (``bbox_head_state_dict``:
    ``fc_cls`` / ``fc_reg`` permuted from the HWC to the CHW flattening
    when they read the flattened map, whatever its width, and not with
    ``with_avg_pool``): cls and reg within 1e-5 relative, on 16 channels
    (784 inputs, below the JAX converter's 2048 rule) and 256."""
    cfg = dict(type="BBoxHead", in_channels=channels, num_classes=5,
               with_avg_pool=avg_pool, reg_class_agnostic=False)
    rng = np.random.default_rng(channels)
    pooled = rng.standard_normal((6, 7, 7, channels)).astype(np.float32)
    jhead = JaxBBoxHead(in_channels=channels, num_classes=5,
                        with_avg_pool=avg_pool)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(pooled))
    # a non-separable weight, so a wrong flattening order shows
    params = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    want = jhead.apply(params, jnp.asarray(pooled))
    head = BBoxHead(**{k: v for k, v in cfg.items() if k != "type"})
    head.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in bbox_head_state_dict(
                              params["params"], cfg).items()})
    with torch.no_grad():
        got = head(_nchw(pooled), 0, 6, None)
    assert got[1].shape == (6, 20)
    for g, w in zip(got, want):
        _rel_close(g.numpy(), w, 1e-5)


def test_plain_head_needs_its_config():
    """Whether a plain head's fcs read the flattened map depends on its
    ``with_avg_pool``, which the parameter tree does not say."""
    params = {"fc_cls": {"kernel": np.zeros((784, 5)), "bias": np.zeros(5)}}
    with pytest.raises(ValueError, match="pass the model config"):
        bbox_head_state_dict(params)


def test_bbox_head_init_and_registry():
    """A config's ``BBoxHead`` builds with mmdet's names and the JAX init
    stds (0.01 for ``fc_cls``, 0.001 for ``fc_reg``), 4 deltas per class."""
    eng = FasterRCNN(_faster_cfg(), FASTER_TEST_CFG, device="cpu", seed=1)
    head = eng.model.bbox_head
    assert type(head) is BBoxHead
    assert sorted(n for n, _ in head.named_children()) == ["fc_cls",
                                                           "fc_reg"]
    assert head.fc_reg.out_features == 20
    assert head.fc_cls.weight.std().item() == pytest.approx(0.01, rel=0.05)
    assert head.fc_reg.weight.std().item() == pytest.approx(0.001, rel=0.05)
    assert not hasattr(eng, "window_detect") and eng.key_dim == 0


def test_bbox2result_np_matches_jax():
    """Per class the rows of that label, and 0 × 5 arrays when nothing is
    detected: equal to the JAX function's, exactly."""
    rng = np.random.default_rng(0)
    dets = rng.uniform(0, 50, (7, 5)).astype(np.float32)
    labels = np.array([0, 2, 2, 4, 0, 1, 2])
    for d, lab in ((dets, labels), (dets[:0], labels[:0])):
        got, want = bbox2result_np(d, lab, 6), jax_bbox2result_np(d, lab, 6)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("alias", ["HNLBBoxHead", "HNMBBBoxHead",
                                   "HMPBBoxHead"])
def test_head_aliases_build(alias):
    """A config naming one of the reference's head aliases builds the HRNMP
    head under that name."""
    model_cfg, test_cfg = tiny_hnmb_cfg()
    model_cfg = dict(model_cfg, bbox_head=dict(model_cfg["bbox_head"],
                                               type=alias))
    head = apis.build_detector(model_cfg, None, test_cfg,
                               device="cpu").model.bbox_head
    assert type(head).__name__ == alias and isinstance(head, HRNMPBBoxHead)


# ------------------------------------------------------ simple / aug test
@pytest.fixture(scope="module")
def faster():
    """The tiny Faster R-CNN on calibrated weights: (JAX engine, JAX
    params, port engine, the image and its meta)."""
    rng = np.random.default_rng(3)
    h, w = CANVAS
    img = rng.normal(size=(1, h, w, 3)).astype(np.float32) * 40
    meta = dict(ish=np.array([h - 4.0, w - 2.0], np.float32),
                psh=np.array(CANVAS, np.float32))
    jeng, params, port = _calibrated(
        JaxFasterRCNN, FasterRCNN, _faster_cfg(), FASTER_TEST_CFG,
        [dict(img=img, img_shape=meta["ish"])], seed=11)
    img_f = img.copy()
    iw = int(meta["ish"][1])
    img_f[0, :, :iw] = img_f[0, :, :iw][:, ::-1]
    return jeng, params, port, img, img_f, meta


@pytest.fixture(scope="module")
def faster_jax(faster):
    """The JAX engine's simple_test (scale factor 0.8) and aug_test (the
    image twice at scale factor 1; the image and its mirror)."""
    jeng, params, _, img, img_f, m = faster
    one = np.ones(4, np.float32)
    return dict(
        simple=jax.device_get(jeng.simple_test(
            params, jnp.asarray(img), m["ish"], m["psh"],
            np.full(4, 0.8, np.float32))),
        dup=jax.device_get(jeng.aug_test(
            params, [jnp.asarray(img)] * 2, [m["ish"]] * 2, [m["psh"]] * 2,
            [one] * 2, (False, False))),
        flip=jax.device_get(jeng.aug_test(
            params, [jnp.asarray(img), jnp.asarray(img_f)], [m["ish"]] * 2,
            [m["psh"]] * 2, [one] * 2, (False, True))))


def _port_maps(faster, backbone, monkeypatch):
    """With ``backbone`` "jax" the port engine takes its maps from the JAX
    module on the same images."""
    jeng, params, port = faster[:3]
    if backbone == "jax":
        monkeypatch.setattr(port, "backbone_maps", lambda img, ish: _jax_maps(
            jeng, params, np.asarray(img)))
    return port


@pytest.mark.parametrize("backbone", ["port", "jax"])
def test_simple_test_matches_jax(faster, faster_jax, backbone, monkeypatch):
    """``simple_test`` against the JAX engine's: per class the same kept
    detections, within ``LIMITS``: from the JAX backbone maps boxes within
    1e-3 px and scores within 2e-6."""
    _, _, _, img, _, m = faster
    port = _port_maps(faster, backbone, monkeypatch)
    got = port.simple_test(img, m["ish"], m["psh"],
                           np.full(4, 0.8, np.float32))
    assert got[0].shape == (20, 5)
    assert_dets_match(got, faster_jax["simple"], 5, **LIMITS[backbone])


@pytest.mark.parametrize("backbone", ["port", "jax"])
@pytest.mark.parametrize("case", ["dup", "flip"])
def test_aug_test_matches_jax(faster, faster_jax, case, backbone,
                              monkeypatch):
    """``aug_test`` on the image twice (unflipped, scale factor 1) and on
    the image and its mirror, against the JAX engine's, at
    ``simple_test``'s limits (``LIMITS``)."""
    _, _, _, img, img_f, m = faster
    port = _port_maps(faster, backbone, monkeypatch)
    one = np.ones(4, np.float32)
    imgs, flips = ([img, img], (False, False)) if case == "dup" else \
        ([img, img_f], (False, True))
    got = port.aug_test(imgs, [m["ish"]] * 2, [m["psh"]] * 2, [one] * 2,
                        flips)
    assert_dets_match(got, faster_jax[case], 5, **LIMITS[backbone])


def test_aug_test_duplicates_reproduce_simple_test(faster):
    """Two unflipped copies at scale factor 1 (where the merge's NMS in
    original coordinates sees the same IoUs) give ``simple_test``'s
    detections within 2e-3 (the JAX test's limit); the mirror's differ."""
    _, _, port, img, img_f, m = faster
    one = np.ones(4, np.float32)
    plain = port.simple_test(img, m["ish"], m["psh"], one)
    dup = port.aug_test([img, img], [m["ish"]] * 2, [m["psh"]] * 2,
                        [one] * 2, (False, False))
    a, b = (out[0][out[2]].numpy() for out in (plain, dup))
    assert a.shape == b.shape and len(a) > 0
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-3)
    flip = port.aug_test([img, img_f], [m["ish"]] * 2, [m["psh"]] * 2,
                         [one] * 2, (False, True))
    c = flip[0][flip[2]].numpy()
    assert np.isfinite(c).all()
    assert c.shape != a.shape or not np.allclose(c, a)


# ---------------------------------------------------------- training steps
def _still_sample(rng):
    """One 128×192 image in the still-image layout, two ground truths of
    classes 1 and 3 (64-px anchors and up fit inside it)."""
    h, w = TRAIN_CANVAS
    gt = np.zeros((4, 4), np.float32)
    gt[0], gt[1] = [8, 10, 90, 100], [70, 30, 180, 120]
    return dict(img=rng.normal(size=(h, w, 3)).astype(np.float32) * 40,
                gt_bboxes=gt, gt_labels=np.array([1, 3, 0, 0]),
                gt_mask=np.array([True, True, False, False]),
                img_shape=np.array([h - 4.0, w - 2.0], np.float32),
                pad_shape=np.array(TRAIN_CANVAS, np.float32))


def _step(port_cls, trainer_cls, model_cfg, train_cfg, sd, sample, c4,
          noise, dtype=torch.float32):
    """The port's step from the image through the JAX ``c4`` (its values,
    the port backbone's gradient path) to the gradients, in ``dtype``:
    (trainer, logs)."""
    eng = port_cls(model_cfg, device="cpu", train_cfg=train_cfg)
    eng.load_state_dict(sd)
    trainer = trainer_cls(eng, OPT, steps_per_epoch=10)
    with default_dtype(dtype):
        eng.model.to(dtype)
        if dtype == torch.float32:       # the trainer's own backbone call
            own = trainer.backbone(sample)
        else:
            imgs = sample["imgs"] if "imgs" in sample else sample["img"][None]
            own = eng.model.extract_feat(_nchw(imgs).to(dtype))
        loss, logs = trainer.loss_from_c4(own + (_nchw(c4).to(dtype)
                                                 - own).detach(),
                                          sample, noise)
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    logs["loss"] = loss
    return trainer, logs


def _jax_c4(jeng, params, imgs):
    """C4 of ``imgs`` from a jitted JAX program, as the jitted loss
    computes it."""
    mod = jeng.module
    return jax.jit(lambda p, x: mod.apply(p, x, method=mod.extract_feat))(
        params, imgs)


def _held_step(case):
    """The float32 step, and its float64 recompute on the float32 step's
    ReLU pattern: (float32 trainer, its logs, its gradients, float64
    gradients)."""
    pattern = ReluPattern()
    with relu_as(pattern):
        trainer, logs = _step(*case)
        with pattern.replay():
            tr64, _ = _step(*case, dtype=torch.float64)
    return trainer, logs, trainable_grads(trainer), trainable_grads(tr64)


@pytest.fixture(scope="module")
def faster_step():
    """The JAX ``FasterRCNNTrainer``'s loss on one still image (jitted,
    forward only) and the port's step on the JAX c4 and sampler draws."""
    model_cfg, train_cfg = _faster_cfg(), _faster_train_cfg()
    sample = _still_sample(np.random.default_rng(5))
    jeng, params, port = _calibrated(
        JaxFasterRCNN, FasterRCNN, model_cfg, None,
        [dict(img=sample["img"][None], img_shape=sample["img_shape"])],
        seed=12, train_cfg=train_cfg)
    key = jax.random.PRNGKey(21)
    trainer = JaxFasterRCNNTrainer(jeng, OPT, mesh=None, steps_per_epoch=10)
    loss_fn = trainer._build_loss_fn(*TRAIN_CANVAS)
    jsample = jax.tree_util.tree_map(jnp.asarray, sample)
    loss, logs = jax.jit(loss_fn)(params, jsample, key)
    c4 = _jax_c4(jeng, params, jsample["img"][None])
    keys = jax.random.split(key, 2)
    n_cand = 4 + train_cfg["rpn_proposal"]["nms_post"]
    noise = (tuple(torch.from_numpy(x.copy()) for x in _jax_noise(
        keys[0], Canvas(*TRAIN_CANVAS).anchors.shape[0])),
        tuple(torch.from_numpy(x.copy()) for x in _jax_noise(keys[1],
                                                             n_cand)))
    case = (FasterRCNN, FasterRCNNTrainer, model_cfg, train_cfg,
            port.model.state_dict(), sample, np.asarray(c4), noise)
    return dict(jax.device_get(logs), loss=float(loss)), case, \
        _held_step(case)


@pytest.fixture(scope="module")
def selsa_step():
    """The JAX ``SelsaTrainer``'s loss with one sampler (no OHEM) on 3
    frames (jitted, forward only) and the port's step on the JAX c4 and
    sampler draws."""
    model_cfg = tiny_model_cfg(sampler_num=8, t_dim=3)
    train_cfg = tiny_train_cfg(two_stage_sampler=False)
    batch = make_sample(np.random.default_rng(4), frames=3, h=TRAIN_CANVAS[0],
                        w=TRAIN_CANVAS[1])
    sample = jax.tree_util.tree_map(lambda x: x[0], batch)
    jeng, params, port = _calibrated(
        JaxSelsaRCNN, SelsaRCNN, model_cfg, None,
        [dict(img=sample["imgs"][f:f + 1], img_shape=sample["img_shape"][f])
         for f in range(3)], seed=7, train_cfg=train_cfg)
    key = jax.random.PRNGKey(31)
    trainer = JaxSelsaTrainer(jeng, OPT, mesh=None, steps_per_epoch=10)
    jsample = jax.tree_util.tree_map(jnp.asarray, sample)
    loss, logs = jax.jit(trainer._build_loss_fn(*TRAIN_CANVAS))(
        params, jsample, key)
    c4 = _jax_c4(jeng, params, jsample["imgs"])
    n_cand = sample["gt_bboxes"].shape[1] + \
        train_cfg["rpn_proposal"]["nms_post"]
    noise = _step_noise(key, 3, Canvas(*TRAIN_CANVAS).anchors.shape[0],
                        n_cand)
    case = (SelsaRCNN, SelsaTrainer, model_cfg, train_cfg,
            port.model.state_dict(), sample, np.asarray(c4), noise)
    return dict(jax.device_get(logs), loss=float(loss)), case, \
        _held_step(case)


LOG_KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc",
            "loss")
TRAINED = ("backbone.layer2.", "backbone.layer3.", "rpn_head.",
           "shared_head.", "bbox_head.")


@pytest.mark.parametrize("which", ["faster", "selsa"])
def test_training_step_matches_jax(which, request):
    """One step on the JAX c4 (through the port's backbone) and the JAX
    sampler draws (``FasterRCNNTrainer``, and ``SelsaTrainer`` with a
    single sampler): every log within 1e-5 relative of the JAX trainer's;
    the trained set is the backbone from ``layer2``, the RPN, the shared
    head and the head; each gradient within 1e-5 of its tensor's max
    |grad| in the float64 recompute (the backbone's 1e-4: a weight
    gradient inherits the float32 drift of its layer's input; the key
    projections' biases, whose gradient is 0 up to rounding, below 1e-6 of
    the largest gradient)."""
    jlogs, _, (trainer, logs, g32, g64) = request.getfixturevalue(
        f"{which}_step")
    for k in LOG_KEYS:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(jlogs["loss_bbox"]) > 0 and float(jlogs["loss_rpn_bbox"]) > 0
    params = dict(trainer.engine.model.named_parameters())
    assert set(g64) == {n for n in params if n.startswith(TRAINED)}
    peak = max(np.abs(t).max() for t in g64.values())
    for n, t in g64.items():
        if _is_key_bias(n):     # rounding noise on both sides
            assert np.abs(g32[n]).max() <= 1e-6 * peak, n
            continue
        tol = 1e-4 if n.startswith("backbone.") else 1e-5
        assert np.abs(g32[n] - t).max() <= tol * np.abs(t).max(), n


def test_faster_trainer_takes_the_video_layout(faster_step):
    """A video-layout sample (``imgs`` (F, H, W, 3), per-frame ground
    truth) trains on its frame 0: the same loss and logs as the still image,
    bit for bit."""
    _, case, (_, logs, _, _) = faster_step
    sample = case[5]
    video = dict(imgs=np.stack([sample["img"], sample["img"][::-1]]),
                 **{k: np.stack([sample[k], sample[k]]) for k in (
                     "gt_bboxes", "gt_labels", "gt_mask", "img_shape",
                     "pad_shape")})
    assert still_image(video)["imgs"].shape == (1,) + TRAIN_CANVAS + (3,)
    _, got = _step(*case[:5], video, *case[6:])
    for k in LOG_KEYS:
        assert torch.equal(got[k], logs[k]), k


def test_selsa_single_sampler_is_not_ohem(selsa_step):
    """With one sampler every sampled RoI of the key frame weighs in: the
    step's classification loss differs from the OHEM step's on the same
    draws."""
    _, case, (_, logs, _, _) = selsa_step
    train_cfg = dict(case[3], rcnn=dict(case[3]["rcnn"], sampler=[
        case[3]["rcnn"]["sampler"], dict(num=4, pos_fraction=0.25)]))
    _, ohem = _step(*case[:3], train_cfg, *case[4:])
    assert float(ohem["loss_cls"].detach()) != float(logs["loss_cls"].detach())
    bad = dict(case[3], rcnn=dict(case[3]["rcnn"], sampler=[
        case[3]["rcnn"]["sampler"]]))
    with pytest.raises(ValueError, match="one sampler"):
        _step(*case[:3], bad, *case[4:])


@pytest.mark.parametrize("kind", ["FasterRCNN", "FastRCNN"])
def test_build_and_train_detector_dispatch(kind, work_dir):
    """``build_detector`` builds ``FasterRCNN`` and ``FastRCNN`` from a
    config; ``train_detector`` trains either with ``FasterRCNNTrainer`` on
    still images: a step that moves the head and keeps the stem."""
    model_cfg = dict(_faster_cfg(), type=kind)
    eng = apis.build_detector(model_cfg, train_cfg=_faster_train_cfg(),
                              device="cpu", seed=2)
    assert type(eng) is {"FasterRCNN": FasterRCNN, "FastRCNN": FastRCNN}[kind]
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    trainer = apis.train_detector(
        eng, [_still_sample(np.random.default_rng(6))],
        dict(OPT, total_epochs=1), str(work_dir / kind), seed=1,
        calibrate_bn=True)
    assert type(trainer) is FasterRCNNTrainer and trainer.step == 1
    after = eng.model.state_dict()
    assert not torch.equal(after["bbox_head.fc_cls.weight"],
                           before["bbox_head.fc_cls.weight"])
    assert torch.equal(after["backbone.conv1.weight"],
                       before["backbone.conv1.weight"])


# ------------------------------------------------------- single-image API
API_ENGINES = {
    "hvrnet": (JaxHNMBRCNN, HNMBRCNN, tiny_hnmb_cfg),
    "selsa": (JaxSelsaRCNN, SelsaRCNN, tiny_selsa_cfg),
    "faster": (JaxFasterRCNN, FasterRCNN,
               lambda: (_faster_cfg(), FASTER_TEST_CFG)),
}


def _api_image():
    """A 60×500 BGR uint8 image: smooth random content."""
    rng = np.random.default_rng(8)
    small = rng.integers(0, 256, size=(6, 50, 3)).astype(np.uint8)
    return np.repeat(np.repeat(small, 10, axis=0), 10, axis=1)


def _jax_canvas(img):
    """The JAX ``inference_detector``'s preprocessing of ``img``."""
    r = dict(img=img.astype(np.float32), img_shape=img.shape,
             ori_shape=img.shape, bbox_fields=[])
    r = JaxPad(size_divisor=16)(JaxNormalize(**IMG_NORM)(
        JaxResize(img_scale=(1000, 600), keep_ratio=True)(r)))
    return r, jax_pad_to_canvas(r["img"], API_CANVAS)[None]


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    """Per engine: a config file, a checkpoint of calibrated weights, the
    port's ``init_detector`` engine on it and the JAX result on the API
    image."""
    work = tmp_path_factory.mktemp("api")
    img = _api_image()
    r, canvas = _jax_canvas(img)
    out = {}
    for name, (jax_cls, port_cls, cfgs) in API_ENGINES.items():
        model_cfg, test_cfg = cfgs()
        path = work / f"{name}.py"
        path.write_text(f"model = {model_cfg!r}\ntest_cfg = {test_cfg!r}\n"
                        f"img_norm_cfg = {IMG_NORM!r}\n")
        jeng, params, port = _calibrated(
            jax_cls, port_cls, model_cfg, test_cfg,
            [dict(img=canvas, img_shape=np.asarray(r["img_shape"][:2],
                                                   np.float32))], seed=13)
        ckpt = work / f"{name}.pth"
        torch.save({"state_dict": port.model.state_dict()}, ckpt)
        if name == "faster":    # see the module docstring
            want = jax.device_get(jeng.simple_test(
                params, jnp.asarray(canvas), r["img_shape"][:2],
                r["pad_shape"][:2], r["scale_factor"]))
            want = jax_bbox2result_np(want[0][want[2]], want[1][want[2]],
                                      jeng.num_classes)
        else:
            jeng.params = params
            jeng.cfg = JaxConfig(dict(img_norm_cfg=IMG_NORM))
            want = jax_apis.inference_detector(jeng, img,
                                               canvas_hw=API_CANVAS)
        out[name] = dict(cfg=str(path), ckpt=str(ckpt), want=want,
                         jeng=jeng, params=params,
                         engine=apis.init_detector(str(path), str(ckpt),
                                                   device="cpu"))
    yield out
    shutil.rmtree(work, ignore_errors=True)


@pytest.mark.parametrize("name", list(API_ENGINES))
def test_inference_detector_matches_jax(api, name, monkeypatch):
    """``inference_detector`` on one BGR image with the checkpoint's
    weights (``init_detector``): per class the same detections as the JAX
    API, boxes within 1e-3 px, scores within 1e-4 (SELSA 2e-4, as its
    end-to-end CLI runs); HVRNet and SELSA through their window of 3
    copies of the frame, the still-image engine through ``simple_test``.
    Its boxes end to end within the repository's end-to-end rule, 1e-4 of
    the image's size (0.05 px; 0.0085 px measured: its class-specific
    ``fc_reg``, inflated, turns the two backbones' 5.6e-5 relative C5
    drift into moves ~10× the relation heads'), and from the JAX backbone
    maps within 1e-3 px and scores within 2e-6."""
    run = api[name]
    eng = run["engine"]
    box_tol = 1e-4 * max(API_IMAGE) if name == "faster" else 1e-3
    got = apis.inference_detector(eng, _api_image(), canvas_hw=API_CANVAS)
    assert len(got) == eng.num_classes - 1
    assert_classes_match(got, run["want"], END_TO_END_SCORE_TOL[name],
                         box_tol)
    if name == "faster":
        monkeypatch.setattr(eng, "backbone_maps", lambda img, ish: _jax_maps(
            run["jeng"], run["params"], np.asarray(img)))
        got = apis.inference_detector(eng, _api_image(),
                                      canvas_hw=API_CANVAS)
        assert_classes_match(got, run["want"], 2e-6, 1e-3)


def test_inference_detector_is_the_window_of_copies(api):
    """The API's input is the JAX API's canvas, bit for bit
    (``image_input``), and its video detection is ``window_detect`` over T
    copies of that canvas's frame caches (``frame_features``), bit for
    bit; with no canvas given it takes ``pick_canvas_shape``'s and still
    detects."""
    eng = api["hvrnet"]["engine"]
    img = _api_image()
    r, canvas = _jax_canvas(img)
    x = apis.image_input(eng.cfg, img, API_CANVAS)
    np.testing.assert_array_equal(x["img"], canvas)
    np.testing.assert_array_equal(x["scale_factor"], r["scale_factor"])
    feats = eng.frame_features(x["img"], x["img_shape"], x["pad_shape"])
    T = eng.window
    dets, labels, mask = eng.window_detect(
        *(torch.stack([feats[k]] * T) for k in ("fc1", "boxes", "mask")),
        x["img_shape"], x["scale_factor"])[-1]
    want = bbox2result_np(dets[mask].numpy(), labels[mask].numpy(), 31)
    got = apis.inference_detector(eng, img, canvas_hw=API_CANVAS)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    wide = apis.inference_detector(api["faster"]["engine"], img)
    assert len(wide) == 4 and all(np.isfinite(c).all() for c in wide)


def test_init_detector_without_checkpoint(api, caplog):
    """Without a checkpoint the engine keeps its seeded weights and says
    so; the config rides along as ``engine.cfg``."""
    import logging
    with caplog.at_level(logging.INFO, logger="hvrnet_tpu_torch"):
        eng = apis.init_detector(api["selsa"]["cfg"], device="cpu", seed=4)
    assert "seeded random weights" in caplog.text
    twin = SelsaRCNN(*tiny_selsa_cfg(), device="cpu", seed=4)
    for k, v in twin.model.state_dict().items():
        assert torch.equal(eng.model.state_dict()[k], v), k
    assert eng.cfg.img_norm_cfg["mean"] == IMG_NORM["mean"]
