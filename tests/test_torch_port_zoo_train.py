"""The multi-stage zoo's training in the port against the JAX package: a
``TwoStageTrainer`` step of Cascade R-CNN (3 stages) and Mask R-CNN
(``tests/test_multi_stage.py:base_cfg``,
``tests/test_train_two_stage.py:_train_cfg`` / ``_batch`` on a 128×192
image, where 64-px anchors fit) on the JAX c4 and the JAX sampler draws,
and the ``build_detector`` / ``train_detector`` dispatch.  Weights as in
``tests/test_torch_port_zoo.py``; the JAX loss and gradients come from one
jitted ``value_and_grad``, computed once per model in a module fixture."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine.train_two_stage import \
    TwoStageTrainer as JaxTwoStageTrainer
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine.canvas import Canvas
from hvrnet_tpu_torch.engine.train_two_stage import TwoStageTrainer
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_multi_stage import base_cfg
from tests.test_torch_port_image import _jax_c4, _nchw
from tests.test_torch_port_selsa import _jax_noise
from tests.test_torch_port_train import (  # noqa: F401  (work_dir)
    ReluPattern, assert_grads_against_float64, default_dtype, relu_as,
    trainable_grads, work_dir)
from tests.test_torch_port_zoo import MODELS, _calibrated
from tests.test_train_two_stage import _batch, _train_cfg

torch.set_num_threads(2)

TRAIN_CANVAS = (128, 192)     # 64-px anchors fit: the RPN loss has samples
OPT = dict(optimizer=dict(lr=1e-3, momentum=0.9, weight_decay=1e-4))


# ---------------------------------------------------------- training steps
def _sample(with_mask):
    return {k: v[0] for k, v in _batch(with_mask, TRAIN_CANVAS).items()}


def _step(name, model_cfg, train_cfg, sd, sample, c4, noise,
          dtype=torch.float32):
    """The port's step from the image through the JAX ``c4`` (its values,
    the port backbone's gradient path) to the gradients: (trainer, logs)."""
    _, port_cls, _, _ = MODELS[name]
    eng = port_cls(model_cfg, device="cpu", train_cfg=train_cfg)
    eng.load_state_dict(sd)
    trainer = TwoStageTrainer(eng, OPT, steps_per_epoch=10)
    with default_dtype(dtype):
        eng.model.to(dtype)
        own = eng.model.extract_feat(_nchw(sample["img"][None]).to(dtype))
        loss, logs = trainer.loss_from_c4(
            own + (_nchw(c4).to(dtype) - own).detach(), sample, noise)
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    logs["loss"] = loss
    return trainer, logs


@pytest.fixture(scope="module", params=list(MODELS))
def zoo_step(request):
    """The JAX ``TwoStageTrainer``'s loss and gradients (jitted) on one
    128×192 image and the port's step on the JAX c4 and the JAX sampler
    draws (``split(key, n_stages + 1)``: [0] the anchors, [1 + s] stage
    s's candidates), with its float64 recompute on the float32 step's ReLU
    pattern."""
    name = request.param
    _, _, stages, with_mask = MODELS[name]
    model_cfg = base_cfg(stages, with_mask)
    train_cfg = _train_cfg(stages, with_mask)
    sample = _sample(with_mask)
    jeng, params, port = _calibrated(
        name, model_cfg, [dict(img=sample["img"][None],
                               img_shape=sample["img_shape"])],
        seed=12, train_cfg=train_cfg)
    key = jax.random.PRNGKey(21)
    jtrainer = JaxTwoStageTrainer(jeng, OPT, mesh=None, steps_per_epoch=10)
    loss_fn = jtrainer._build_loss_fn(*TRAIN_CANVAS)
    jsample = jax.tree_util.tree_map(jnp.asarray, sample)
    (loss, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jsample, key)
    c4 = np.asarray(_jax_c4(jeng, params, jsample["img"][None])[0])
    keys = jax.random.split(key, stages + 1)
    n_gt = sample["gt_bboxes"].shape[0]
    n_props = [train_cfg["rpn_proposal"]["nms_post"]] + [
        32] * (stages - 1)
    noise = (tuple(torch.from_numpy(x.copy()) for x in _jax_noise(
        keys[0], Canvas(*TRAIN_CANVAS).anchors.shape[0])),
        [tuple(torch.from_numpy(x.copy()) for x in _jax_noise(
            keys[1 + s], n_gt + n_props[s])) for s in range(stages)])
    case = (name, model_cfg, train_cfg, port.model.state_dict(), sample, c4,
            noise)
    pattern = ReluPattern()
    with relu_as(pattern):
        trainer, plogs = _step(*case)
        with pattern.replay():
            tr64, _ = _step(*case, dtype=torch.float64)
    jgrads = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.device_get(grads), model_cfg).items()}
    return dict(name=name, jlogs=dict(jax.device_get(logs), loss=float(loss)),
                logs=plogs, g32=trainable_grads(trainer),
                g64=trainable_grads(tr64), jgrads=jgrads, case=case,
                trained=[n for n, p in trainer.engine.model.named_parameters()
                         if p.requires_grad])


HEADS_TRAINED = ("bbox_head.", "mask_head.")


def test_training_step_matches_jax(zoo_step):
    """One ``TwoStageTrainer`` step on the JAX c4 (through the port's
    backbone) and the JAX sampler draws, Cascade (3 stages at IoU 0.5 /
    0.6 / 0.7, weights 1 / 0.5 / 0.25) and Mask R-CNN: every log within
    1e-5 relative of the JAX trainer's (per stage ``loss_cls_s{s}``,
    ``loss_bbox_s{s}``, ``acc_s{s}``; ``loss_mask``); the trained set is
    the backbone from ``layer2``, the RPN, the shared head, every stage's
    head and the mask head.  Gradients: the port's within 1e-5 of each
    tensor's max |grad| in its float64 recompute on the float32 step's ReLU
    pattern (the backbone's 1e-4); the heads' through
    ``assert_grads_against_float64``, where the JAX package's are held too
    (within 1e-3, and within 1e-4 of the float64 truth).  The conv trunks'
    JAX gradients are not held: XLA:CPU's jitted float32 forward tips
    other ReLU inputs across 0 (``tests/test_torch_port_train.py``)."""
    r = zoo_step
    jlogs, logs = r["jlogs"], r["logs"]
    keys = [k for k in jlogs if k.startswith(("loss", "acc"))]
    assert set(keys) <= set(logs)
    for k in keys:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(jlogs["loss_rpn_bbox"]) > 0
    bbox = "loss_bbox_s2" if r["name"] == "cascade" else "loss_bbox"
    assert float(jlogs[bbox]) > 0
    if r["name"] == "mask":
        assert float(jlogs["loss_mask"]) > 0
    trained = ("backbone.layer2.", "backbone.layer3.", "rpn_head.",
               "shared_head.") + HEADS_TRAINED
    g32, g64 = r["g32"], r["g64"]
    assert set(g64) == set(r["trained"])
    assert all(n.startswith(trained) for n in g64)
    assert {n.split(".")[0] for n in g64} >= {"backbone", "rpn_head",
                                              "shared_head", "bbox_head"}
    for n, t in g64.items():
        if not n.startswith(HEADS_TRAINED):
            tol = 1e-4 if n.startswith("backbone.") else 1e-5
            assert np.abs(g32[n] - t).max() <= tol * np.abs(t).max(), n
    heads = [n for n in g64 if n.startswith(HEADS_TRAINED)]
    assert_grads_against_float64(
        {n: g32[n] for n in heads}, r["jgrads"], {n: g64[n] for n in heads},
        None, None, may_stray=())


@pytest.mark.parametrize("zoo_step", ["cascade"], indirect=True)
def test_stage_heads_train_on_their_own_losses(zoo_step):
    """The boxes a stage refines for the next carry no gradient (detached,
    and RoIAlign gives RoIs none): with the first stage's loss weight 0 its
    head gets none, while the later stages' heads do."""
    name, model_cfg, train_cfg, sd, sample, c4, noise = zoo_step["case"]
    later = dict(train_cfg, stage_loss_weights=[0.0, 1.0, 0.5])
    trainer, _ = _step(name, model_cfg, later, sd, sample, c4, noise)
    grads = trainable_grads(trainer)
    first = [n for n in grads if n.startswith("bbox_head.0.")]
    assert first and not any(np.abs(grads[n]).any() for n in first)
    assert all(np.abs(grads[n]).any() for n in grads
               if n.startswith(("bbox_head.1.", "bbox_head.2.")))


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("name", list(MODELS))
def test_build_and_train_detector_dispatch(name, work_dir):
    """``build_detector`` builds ``CascadeRCNN`` and ``MaskRCNN`` from their
    configs, with mmdet's names (``bbox_head.{i}.shared_fcs.0`` for the
    cascade, ``bbox_head.fc_cls`` and ``mask_head.convs.0.conv`` /
    ``upsample`` / ``conv_logits`` for Mask R-CNN); ``train_detector``
    trains either with ``TwoStageTrainer`` on still images (frozen BNs
    calibrated): a step that moves every head and keeps the stem."""
    _, port_cls, stages, with_mask = MODELS[name]
    model_cfg = dict(base_cfg(stages, with_mask), type=port_cls.__name__)
    eng = apis.build_detector(model_cfg, train_cfg=_train_cfg(
        stages, with_mask), device="cpu", seed=2)
    assert type(eng) is port_cls and eng.num_stages == stages
    names = set(eng.model.state_dict())
    heads = ([f"bbox_head.{i}." for i in range(stages)] if stages > 1
             else ["bbox_head."])
    for h in heads:
        assert {h + n for n in ("shared_fcs.0.weight", "shared_fcs.1.weight",
                                "fc_cls.weight", "fc_reg.bias")} <= names
    if with_mask:
        assert {"mask_head.convs.0.conv.weight", "mask_head.upsample.weight",
                "mask_head.conv_logits.bias"} <= names
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    trainer = apis.train_detector(
        eng, [_sample(with_mask)], dict(OPT, total_epochs=1),
        str(work_dir / name), seed=1, calibrate_bn=True)
    assert type(trainer) is TwoStageTrainer and trainer.step == 1
    after = eng.model.state_dict()
    moved = [h + "fc_cls.weight" for h in heads] + (
        ["mask_head.conv_logits.weight"] if with_mask else [])
    for k in moved:
        assert not torch.equal(after[k], before[k]), k
    assert torch.equal(after["backbone.conv1.weight"],
                       before["backbone.conv1.weight"])


