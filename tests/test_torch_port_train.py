"""HVRNet training in the port against the JAX package's ``HNMBTrainer``.

Sizes are the tiny HNMB training configs of ``tests/test_train_step.py``
(R50 stages, ``sampler_num`` 8, ``t_dim`` 9, 5 videos × 3 frames, 64×96).
The JAX parameter tree is traced with ``jax.eval_shape`` and filled from
numpy; it crosses to the port through ``state_dict_from_jax``, the port
calibrates the frozen-BN statistics, and the weights cross back, so both
packages run the same weights.  JAX gradients cross by the same function.
The sampler's uniform noise is the one ``jax.random`` draws from the JAX
step's key, handed to the port (torch cannot reproduce those bits).
"""
import contextlib
import logging
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hvrnet_tpu.core import targets as jtargets
from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu.engine.optim import default_trainable_mask as jax_mask
from hvrnet_tpu.engine.optim import make_optimizer as jax_make_optimizer
from hvrnet_tpu.engine.optim import step_lr_schedule as jax_schedule
from hvrnet_tpu.engine.train import HNMBTrainer as JaxHNMBTrainer
from hvrnet_tpu.models.bbox_heads.hrnmp_bbox_head import (
    triplet_nonlocal_loss as jax_triplet)
from hvrnet_tpu.ops import attention as jattention
from hvrnet_tpu.ops import boxes as jboxes
from hvrnet_tpu.utils.checkpoint import convert_torch_checkpoint, merge_params
from hvrnet_tpu_torch.apis import train_detector
from hvrnet_tpu_torch.core import targets
from hvrnet_tpu_torch.engine import HNMBRCNN
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.engine.optim import (clip_grad_global_norm_,
                                           default_trainable_mask,
                                           make_optimizer, step_lr_schedule)
from hvrnet_tpu_torch.engine.train import HNMBTrainer
from hvrnet_tpu_torch.models.bbox_heads.hrnmp_bbox_head import (
    triplet_nonlocal_loss)
from hvrnet_tpu_torch.ops import boxes
from hvrnet_tpu_torch.ops.attention import (attention_backward_plain,
                                            attention_plain, masked_attention)
from hvrnet_tpu_torch.utils.checkpoint import load_checkpoint
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_backbone import jax_param_tree
from tests.test_train_step import make_sample, tiny_model_cfg, tiny_train_cfg

torch.set_num_threads(2)

CANVAS = (64, 96)
N_VIDEOS = 5
IPV = 3
OPT = dict(optimizer=dict(lr=1e-3, momentum=0.9, weight_decay=1e-4))


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _rand_boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(1, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# --------------------------------------------------------------- boxes
def test_bbox2delta_and_overlaps_match_jax():
    rng = np.random.default_rng(0)
    a, b = _rand_boxes(rng, 40), _rand_boxes(rng, 40)
    means, stds = (0.1, -0.1, 0.0, 0.2), (0.1, 0.1, 0.2, 0.2)
    np.testing.assert_allclose(
        boxes.bbox2delta(_t(a), _t(b), means, stds).numpy(),
        np.asarray(jboxes.bbox2delta(a, b, means, stds)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        boxes.bbox_overlaps(_t(a), _t(b[:25])).numpy(),
        np.asarray(jboxes.bbox_overlaps(a, b[:25])), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- targets
def _assign_case(seed):
    """Boxes and ground truths where ground truths 1 and 2 are the same box
    (both claim the same best box: the later must win), ground truth 4 is
    masked, and box 7 is masked."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (5, 2))
    gts = np.concatenate([xy, xy + rng.uniform(20, 40, (5, 2))], 1)
    gts[2] = gts[1]
    bxs = np.concatenate([_rand_boxes(rng, 30),
                          gts + rng.uniform(-2, 2, gts.shape)]).astype(
                              np.float32)
    gts = gts.astype(np.float32)
    gt_mask = np.array([True, True, True, True, False])
    box_mask = np.ones(len(bxs), bool)
    box_mask[7] = False
    labels = rng.integers(1, 31, 5)
    return bxs, gts, gt_mask, box_mask, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", [(0.5, 0.5, 0.5), (0.7, 0.3, 0.3)])
def test_max_iou_assign_matches_jax(seed, thr):
    bxs, gts, gm, bm, lab = _assign_case(seed)
    want = jtargets.max_iou_assign(*map(jnp.asarray, (bxs, gts, gm, lab)),
                                   *thr, box_mask=jnp.asarray(bm))
    got = targets.max_iou_assign(_t(bxs), _t(gts), _t(gm), _t(lab), *thr,
                                 box_mask=_t(bm))
    np.testing.assert_array_equal(got.gt_inds.numpy(),
                                  np.asarray(want.gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.max_overlaps.numpy(),
                                  np.asarray(want.max_overlaps))
    # ground truths 1 and 2 share their best box: the later one has it
    best = boxes.bbox_overlaps(_t(gts[1:2]), _t(bxs))[0].argmax()
    assert got.gt_inds[best] == 3


def _jax_noise(key, n):
    """The (pos, neg) U(0, 1) vectors ``random_sample_and_target`` draws
    from ``key``."""
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))),
            np.asarray(jax.random.uniform(kn, (n,))))


@pytest.mark.parametrize("add_gt,pos_weight", [(True, -1.0), (False, 2.0)])
@pytest.mark.parametrize("seed", [0, 3])
def test_random_sample_and_target_matches_jax(add_gt, pos_weight, seed):
    bxs, gts, gm, bm, lab = _assign_case(seed)
    kw = dict(num=16, pos_fraction=0.25, add_gt_as_proposals=add_gt,
              pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
              pos_weight=pos_weight)
    key = jax.random.PRNGKey(seed)
    want = jtargets.random_sample_and_target(
        key, *map(jnp.asarray, (bxs, bm, gts, gm, lab)), **kw)
    n = len(bxs) + (len(gts) if add_gt else 0)
    pos, neg = _jax_noise(key, n)
    got = targets.random_sample_and_target(
        _t(bxs), _t(bm), _t(gts), _t(gm), _t(lab), pos_noise=_t(pos),
        neg_noise=_t(neg), **kw)
    for name in ("rois", "labels", "valid", "pos_mask", "gt_inds",
                 "label_weights"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    # the JAX weights are (num, 1), broadcast where they are used
    np.testing.assert_array_equal(
        got.bbox_weights.numpy(),
        np.broadcast_to(np.asarray(want.bbox_weights), (16, 4)))
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=1e-5,
                               atol=1e-5)
    assert got.pos_mask.any() and (got.valid & ~got.pos_mask).any()


def test_sampler_draws_from_the_generator_when_no_noise():
    bxs, gts, gm, bm, lab = _assign_case(0)
    args = (_t(bxs), _t(bm), _t(gts), _t(gm), _t(lab), 16, 0.25)
    runs = [targets.random_sample_and_target(
        *args, generator=torch.Generator().manual_seed(s)).rois
        for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="torch.Generator"):
        targets.random_sample_and_target(*args)


# --------------------------------------------------------------- triplet
@pytest.mark.parametrize("inverted", [True, False])
def test_triplet_nonlocal_loss_matches_jax(inverted):
    rng = np.random.default_rng(4)
    q, k = 24, 20
    aff = (rng.standard_normal((q, k)) * 3).astype(np.float32)
    labels = rng.integers(0, 4, q)           # background anchors among them
    all_labels = labels[:k]
    key_mask = rng.uniform(size=k) > 0.2
    for km in (None, key_mask):
        want = jax_triplet(aff, labels, all_labels, 10.0, key_mask=km,
                           compat_inverted_mining=inverted)
        got = triplet_nonlocal_loss(
            _t(aff), _t(labels), _t(all_labels), 10.0,
            key_mask=None if km is None else _t(km),
            compat_inverted_mining=inverted)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------------------------------- attention
def _attn_inputs(rng, nq, nk, d, dtype=np.float32, masked=0.1):
    q, k, v = (rng.standard_normal((n, d)).astype(dtype)
               for n in (nq, nk, nk))
    bias = np.where(rng.uniform(size=nk) < masked, -1e30, 0.0).astype(
        np.float32)
    return q, k, v, bias


def test_attention_backward_plain_matches_jax_vjp():
    rng = np.random.default_rng(5)
    q, k, v, bias = _attn_inputs(rng, 24, 40, 128)
    g = rng.standard_normal((24, 128)).astype(np.float32)
    scale = 128 ** -0.5
    _, vjp = jax.vjp(lambda *a: jattention.masked_attention(*a, scale),
                     q, k, v, bias)
    want = vjp(g)
    got = attention_backward_plain(_t(q), _t(k), _t(v), _t(bias), scale,
                                   _t(g))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_masked_attention_function_gradcheck_float64():
    """The autograd Function against finite differences in float64 on the
    CPU (q, k, v; the mask bias is not a differentiated input)."""
    rng = np.random.default_rng(6)
    q, k, v, bias = _attn_inputs(rng, 5, 7, 8, np.float64, masked=0.3)
    ins = [_t(x).requires_grad_() for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: masked_attention(a, b, c, _t(bias), 0.3), ins)


def test_masked_attention_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(7)
    q, k, v, bias = (_t(x) for x in _attn_inputs(rng, 12, 16, 64))
    before = masked_attention.launches
    torch.testing.assert_close(masked_attention(q, k, v, bias, 0.125),
                               attention_plain(q, k, v, bias, 0.125),
                               rtol=0, atol=0)
    assert masked_attention.launches == before


# --------------------------------------------------------------- optimizer
def test_step_lr_schedule_matches_jax():
    kw = dict(warmup_iters=20, warmup_ratio=1.0 / 3)
    ours = step_lr_schedule(8e-4, 10, [3, 5], **kw)
    ref = jax_schedule(8e-4, 10, [3, 5], **kw)
    for step in (0, 1, 19, 20, 29, 30, 31, 50, 70):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)


def test_three_sgd_steps_match_the_optax_chain():
    """Clip (global norm over the trainable tensors) → weight decay →
    momentum → lr, masked to the trainable tensors; the second step's
    gradients are large enough to be clipped."""
    rng = np.random.default_rng(8)
    shapes = dict(a=(6, 5), b=(5,), frozen=(4, 4))
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    grads = [{n: (rng.standard_normal(s) * m).astype(np.float32)
              for n, s in shapes.items()} for m in (1.0, 40.0, 3.0)]
    mask = dict(a=True, b=True, frozen=False)
    sched = step_lr_schedule(0.05, 2, [1], warmup_iters=2)
    tx = jax_make_optimizer(jax_schedule(0.05, 2, [1], warmup_iters=2),
                            momentum=0.9, weight_decay=1e-2, clip_norm=35.0,
                            trainable_mask=mask)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    opt_state = tx.init(jp)
    params = {n: torch.nn.Parameter(_t(v)) for n, v in p0.items()}
    trainable = [params["a"], params["b"]]
    opt = make_optimizer(trainable, sched(0), momentum=0.9,
                         weight_decay=1e-2)
    norms = []
    for step, g in enumerate(grads):
        # the reference's frozen tensors get no gradient (stop_gradient)
        jg = dict(g, frozen=np.zeros_like(g["frozen"]))
        upd, opt_state = tx.update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for n in ("a", "b"):
            params[n].grad = _t(g[n])
        norms.append(float(clip_grad_global_norm_(trainable, 35.0)))
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        for n in shapes:
            np.testing.assert_allclose(params[n].detach().numpy(),
                                       np.asarray(jp[n]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{n} step {step}")
    assert norms[1] > 35.0 > max(norms[0], norms[2])
    np.testing.assert_array_equal(params["frozen"].detach().numpy(),
                                  p0["frozen"])


# --------------------------------------------------------------- the step
def triplet_sample(seed, n_videos=N_VIDEOS):
    """``make_sample``'s batch with the triplet loader's classes: videos
    0-2 share one class, the others take other classes."""
    batch = make_sample(np.random.default_rng(seed), frames=n_videos * IPV)
    classes = np.array([7, 7, 7] + [11 + v for v in range(n_videos - 3)])
    batch["gt_labels"][0] = np.repeat(classes, IPV)[:, None]
    return batch


def _tiny_cfgs():
    model_cfg = tiny_model_cfg(head_type="HRNMPBBoxHead", sampler_num=8,
                               t_dim=9, imgs_per_video=IPV)
    model_cfg["type"] = "HNMBRCNN"
    return model_cfg, tiny_train_cfg(two_stage_sampler=False, num=8)


@pytest.fixture(scope="module")
def setup():
    """(JAX engine, JAX params, port model config, port train config,
    calibrated port state_dict, batch)."""
    model_cfg, train_cfg = _tiny_cfgs()
    jeng = JaxHNMBRCNN(model_cfg, train_cfg, None)
    tree = jax_param_tree(jeng, seed=3)
    batch = triplet_sample(1)
    port = HNMBRCNN(model_cfg, device="cpu", train_cfg=train_cfg)
    port.load_state_dict(state_dict_from_jax(tree))
    calibrate_frozen_bn(port, [dict(img=batch["imgs"][0, f:f + 1],
                                    img_shape=batch["img_shape"][0, f])
                               for f in range(4)])
    sd = {k: v.clone() for k, v in port.model.state_dict().items()}
    back = convert_torch_checkpoint({k: v.numpy() for k, v in sd.items()})
    merged, missing = merge_params(tree["params"], back["params"])
    assert missing == []
    return jeng, {"params": merged}, model_cfg, train_cfg, sd, batch


def port_trainer(setup, seed=0):
    _, _, model_cfg, train_cfg, sd, _ = setup
    eng = HNMBRCNN(model_cfg, device="cpu", train_cfg=train_cfg)
    eng.load_state_dict(sd)
    return HNMBTrainer(eng, OPT, steps_per_epoch=10, seed=seed)


def test_training_engine_keeps_the_model_config_head():
    """Without a test_cfg the head keeps the config's sampler_num and
    t_dim, and the key frame comes from train_cfg.rcnn.key_dim."""
    model_cfg, train_cfg = _tiny_cfgs()
    eng = HNMBRCNN(model_cfg, device="cpu", train_cfg=train_cfg)
    head = eng.model.bbox_head
    assert (head.sampler_num, head.t_dim, head.imgs_per_video) == (8, 9, 3)
    assert eng.key_dim == 0 and eng.test_cfg is None


@pytest.mark.parametrize("frozen_stages,freeze", [(1, False), (2, False),
                                                   (1, True)])
def test_trainable_mask_matches_jax(setup, frozen_stages, freeze):
    """The JAX mask, spread over its tensors and carried by name: each of
    the port's parameters trains exactly when its JAX tensor does (the
    frozen BNs are buffers in the port, never parameters)."""
    jeng, params, _, _, _, _ = setup
    model = port_trainer(setup).engine.model
    mask = jax_mask(params, frozen_stages, freeze_backbone=freeze,
                    freeze_rpn=freeze)
    spread = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m, np.float32), mask, params)
    want = state_dict_from_jax(spread)
    got = default_trainable_mask(model, frozen_stages,
                                 freeze_backbone=freeze, freeze_rpn=freeze)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, trains in got.items():
        assert bool(want[name].all()) == trains == bool(want[name].any()), \
            name
    assert any(got.values()) and not all(got.values())


def test_train_step_computes_in_f32_whatever_the_tf32_flags(setup,
                                                            monkeypatch):
    """The forward, the backward (each module's and the attention's) and
    the optimizer update run with TF32 off; the caller's flags return."""
    import hvrnet_tpu_torch.ops.attention as attention
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    for f in flags:
        monkeypatch.setattr(f, "allow_tf32", True)
    seen = {}

    def note(where):
        seen.setdefault(where, set()).add(tuple(f.allow_tf32 for f in flags))

    trainer = port_trainer(setup)
    model = trainer.engine.model
    for m in model.modules():
        m.register_forward_pre_hook(lambda *_: note("forward"))
    for p in trainer.params:
        p.register_hook(lambda g: note("backward"))
    plain_bwd = attention.attention_backward_plain
    monkeypatch.setattr(attention, "attention_backward_plain",
                        lambda *a: (note("attention"), plain_bwd(*a))[1])
    step = trainer.optimizer.step
    monkeypatch.setattr(trainer.optimizer, "step",
                        lambda: (note("optimizer"), step())[1])
    trainer.train_step(jax.tree_util.tree_map(lambda x: x[0], setup[5]))
    assert seen == {k: {(False, False)} for k in
                    ("forward", "backward", "attention", "optimizer")}
    assert all(f.allow_tf32 for f in flags)


def _nchw(x):
    return torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy())


def test_multi_frame_roi_extractor_matches_jax(setup):
    """Three frames pooled in one call, by the frame index in each RoI, with
    the feature gradient of the JAX pooling."""
    jeng, _, _, _, _, _ = setup
    port = port_trainer(setup).engine
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((3, 4, 6, 16)).astype(np.float32)   # NHWC
    rois = np.concatenate([np.repeat(np.arange(3.0), 5)[:, None],
                           _rand_boxes(rng, 15, 60.0)], 1).astype(np.float32)
    g = rng.standard_normal((15, 7, 7, 16)).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda f: jeng.roi_extractor([f], rois)),
                        feats)
    x = _nchw(feats).requires_grad_()
    got = port.roi_extractor(x, _t(rois))
    got.backward(_t(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(vjp(g)[0]), rtol=1e-5, atol=1e-5)


def _head_inputs(rng, n_videos=3, S=8, C=256):
    feats = rng.standard_normal((n_videos, IPV * S, 7, 7, C)).astype(
        np.float32) * 0.1
    labels = np.concatenate([np.repeat([0, 7, 7, 3], 2)] * n_videos)
    labels[S + 1] = 12
    valid = np.ones((n_videos, IPV * S), bool)
    valid[0, 5] = valid[1, 20] = valid[2, 3] = False
    return feats, labels, valid


def _rel_close(got, want, tol, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _is_key_bias(name):
    """The key projections' biases add a constant to each softmax row, so
    their gradient is 0 in exact arithmetic."""
    return ".k_data_fc_" in name and name.endswith(".bias")


@contextlib.contextmanager
def default_dtype(dtype):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


_RELU = torch.nn.functional.relu


class ReluPattern:
    """Every ``F.relu`` call's positive inputs, recorded during one run and
    replayed as the gate ``where(mask, x, 0)`` inside ``replay()``, while
    installed with ``relu_as``.  A float64 recompute replaying the float32
    step's pattern differentiates the same piece of the piecewise-linear
    network as that step.  Without it the truth would depend on where each
    precision's rounding lands: on these tiny maps a weight gradient sums a
    few hundred positions, so one ReLU input that rounding tips across 0
    moves it by up to a few percent of its max (measured in the SELSA
    backbone; in the HNMB shared head the same flips in XLA:CPU's float32
    forward put the JAX gradients 1e-3 to 8e-3 off)."""

    def __init__(self):
        self.masks = []
        self.replaying = None

    def __call__(self, x, inplace=False):
        if self.replaying is None:
            self.masks.append(x.detach() > 0)
            return _RELU(x, inplace)
        mask = self.masks[self.replaying]
        self.replaying += 1
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype))

    @contextlib.contextmanager
    def replay(self):
        self.replaying = 0
        try:
            yield
            assert self.replaying == len(self.masks)
        finally:
            self.replaying = None


@contextlib.contextmanager
def relu_as(fn):
    torch.nn.functional.relu = fn
    try:
        yield
    finally:
        torch.nn.functional.relu = _RELU


def trainable_grads(trainer):
    return {n: p.grad.detach().numpy().copy()
            for n, p in trainer.engine.model.named_parameters()
            if p.requires_grad}


def assert_grads_against_float64(got, want, truth, loss64, params,
                                 may_stray, port_tol=None):
    """Hold float32 gradients ``got`` (the port's) to ``truth``, the port's
    float64 recompute of the same step on the same ReLU pattern
    (``ReluPattern``), within 1e-5 of each tensor's max |truth| (or
    ``port_tol(name)``), and to ``want`` (the JAX package's) within 1e-3 of
    max |want| wherever ``want`` is within 1e-4 of the truth.  Only the
    tensors named with a ``may_stray`` prefix may have ``want`` further
    off: XLA:CPU's float32 forward rounds other ReLU inputs of the conv
    trunks across 0 than the port's does, and which ones varies with the
    host and the thread count.  There central differences of the float64
    loss ``loss64()`` in the float64 ``params`` decide
    (``assert_differences_side_with_port``).  The key projections' biases
    (``_is_key_bias``) are rounding noise on both sides, below 1e-6 of the
    largest gradient."""
    peak = max(np.abs(t).max() for t in truth.values())
    for n, t in truth.items():
        g, w = got[n], want[n]
        if _is_key_bias(n):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * peak, n
            continue
        scale = np.abs(t).max()
        port_err = np.abs(g - t).max() / scale
        jax_err = np.abs(w - t).max() / scale
        assert port_err <= (port_tol(n) if port_tol else 1e-5), \
            (n, port_err)
        if jax_err <= 1e-4:
            _rel_close(g, w, 1e-3, n)
        else:
            assert n.startswith(may_stray), (n, jax_err)
            assert_differences_side_with_port(loss64, params[n], g, w, t)


def assert_differences_side_with_port(loss64, param, got, want, truth,
                                      worst=20, h=1e-6):
    """Central differences of the float64 loss ``loss64()`` in the float64
    tensor ``param`` along two directions: ``want - got`` over the whole
    tensor, and the ``worst`` elements where ``want`` is furthest from
    ``truth``, each signed as ``want - got``.  Each slope lies within 1e-6
    of ``truth``'s (relative to max |truth| times the direction's 1-norm)
    and nearer the port's ``got`` than the JAX package's ``want``.  The
    differences see every path from the tensor to the loss, so a port
    backward that drops one (a misplaced ``detach``) fails here."""
    t, g, w = (np.asarray(a, np.float64).reshape(-1)
               for a in (truth, got, want))
    flat = param.data.view(-1)
    orig = flat.clone()
    gap = w - g
    signed = np.zeros_like(t)
    idx = np.argsort(-np.abs(w - t), kind="stable")[:worst]
    signed[idx] = np.sign(gap[idx])
    for v in (gap / np.abs(gap).max(), signed):
        step = h * torch.from_numpy(v)
        flat.copy_(orig + step)
        up = loss64()
        flat.copy_(orig - step)
        down = loss64()
        flat.copy_(orig)
        slope = (up - down) / (2 * h)
        assert abs(slope - t @ v) <= \
            1e-6 * np.abs(t).max() * np.abs(v).sum(), (slope, t @ v)
        assert abs(slope - g @ v) < abs(slope - w @ v), \
            (slope, g @ v, w @ v)


def _grads_close(model, want, tol, prefixes):
    """Each trainable tensor's gradient within ``tol`` of its max |grad|;
    returns how many were held.  The key projections' biases add a constant
    to each softmax row, so their gradient is 0 in exact arithmetic: both
    sides must be rounding noise, below 1e-6 of the largest gradient."""
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()
             if p.requires_grad and n.startswith(prefixes)}
    peak = max(np.abs(want[n].numpy()).max() for n in grads)
    for n, g in grads.items():
        w = want[n].numpy()
        if _is_key_bias(n):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * peak, n
        else:
            _rel_close(g, w, tol, n)
    return len(grads)


def test_forward_train_matches_jax(setup):
    """The HRNMP training forward: both branches' cls/reg and loss_trip
    within 1e-5 relative, and the head's gradients within 1e-4 of each
    tensor's max |grad|."""
    jeng, params, _, _, _, _ = setup
    head = port_trainer(setup).engine.model.bbox_head
    mod = jeng.module
    rng = np.random.default_rng(10)
    feats, labels, valid = _head_inputs(rng)
    w_cls = rng.standard_normal((2, 24, 31)).astype(np.float32)
    w_reg = rng.standard_normal((2, 24, 4)).astype(np.float32)

    def objective(cls, reg, trip, to):
        return (sum((c * to(w)).sum() for c, w in zip(cls, w_cls))
                + sum((r * to(w)).sum() for r, w in zip(reg, w_reg)) + trip)

    def jax_fn(p):
        cls, reg, trip = mod.apply(p, feats, labels, valid,
                                   method=mod.bbox_forward_train_hrnmp)
        return objective(cls, reg, trip, jnp.asarray), (cls, reg, trip)

    (_, (jcls, jreg, jtrip)), jgrads = jax.jit(jax.value_and_grad(
        jax_fn, has_aux=True))(params)
    cls, reg, trip = head.forward_train(
        torch.from_numpy(feats.transpose(0, 1, 4, 2, 3).copy()), _t(labels),
        _t(valid))
    objective(cls, reg, trip, torch.from_numpy).backward()
    for a, b in zip(cls + reg, list(jcls) + list(jreg)):
        _rel_close(a.detach().numpy(), b, 1e-5)
    assert float(jtrip) > 0
    _rel_close(trip.item(), float(jtrip), 1e-5)
    want = state_dict_from_jax(jax.device_get(jgrads))
    model = port_trainer(setup).engine.model
    model.bbox_head = head
    assert _grads_close(model, want, 1e-4, ("bbox_head.",)) == 40


def _jax_step(setup, key, batch):
    """The JAX HNMB loss, gradients and the parameters after one update.

    The step runs eagerly: under ``jax.jit`` XLA:CPU's shared-head
    gradients of this step differ from a float64 recompute of the port's
    step by up to 0.12 of each tensor's max |grad| (layer4; measured).
    Eagerly they differ by 1e-6 on some hosts and up to 8e-3 (layer4.0,
    layer4.1.conv1) on others, or with another thread count in the
    process, while the port's float32 step stays within 1e-6; hence
    ``assert_grads_against_float64``.  The losses agree either way."""
    jeng, params, _, _, _, _ = setup
    trainer = JaxHNMBTrainer(jeng, OPT, mesh=None, steps_per_epoch=10)
    state = trainer.create_state(params)
    loss_fn = trainer._build_loss_fn(*CANVAS)
    sample = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), batch)
    (loss, logs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, sample, key)
    # the update is elementwise but for the global norm, so jitting it
    # changes nothing the test holds (eagerly it is seconds of dispatch)
    upd, _ = jax.jit(trainer.tx.update)(grads, state.opt_state, params)
    after = jax.jit(optax.apply_updates)(params, upd)
    c4 = jeng.module.apply(params, sample["imgs"],
                           method=jeng.module.extract_feat)
    return (dict(jax.device_get(logs), loss=float(loss)),
            jax.device_get(grads), jax.device_get(after), c4)


def _step_noise(key, n_frames, n_cand):
    """The JAX step's sampler noise for the chosen frames in order."""
    keys = jax.random.split(key, n_frames + 1)
    pairs = [_jax_noise(keys[j], n_cand) for j in range(3 * IPV)]
    return tuple(torch.from_numpy(np.stack(x)) for x in zip(*pairs))


LOG_KEYS = ("loss_trip", "loss_cls_1", "loss_cls_2", "loss_bbox_1",
            "loss_bbox_2", "acc_1", "acc_2", "loss")


@pytest.fixture(scope="module")
def whole_step(setup):
    """(key, (JAX logs, grads, params after, c4), the JAX sampler noise)."""
    key = jax.random.PRNGKey(21)
    batch = setup[5]
    want = _jax_step(setup, key, batch)
    n_cand = batch["gt_bboxes"].shape[2] + setup[3]["rpn_proposal"]["nms_post"]
    return key, want, _step_noise(key, N_VIDEOS * IPV, n_cand)


def _port_step(setup, c4, noise, dtype=torch.float32):
    """The port's step from ``c4`` to the gradients, in ``dtype``: in
    float64 the model and every tensor the step creates are float64."""
    trainer = port_trainer(setup)
    model = trainer.engine.model
    sample = jax.tree_util.tree_map(lambda x: x[0], setup[5])
    with default_dtype(dtype):
        model.to(dtype)
        loss, logs = trainer.loss_from_c4(_nchw(c4).to(dtype), sample, noise)
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    logs["loss"] = loss
    return trainer, logs


@pytest.fixture(scope="module")
def port_steps(setup, whole_step):
    """The port's step from the JAX c4 and noise in float32, and its
    recompute in float64 on the float32 step's ReLU pattern: (float32
    trainer, its logs, its gradients, the float64 loss, the float64
    gradients, the pattern)."""
    _, (_, _, _, c4), noise = whole_step
    pattern = ReluPattern()
    with relu_as(pattern):
        trainer, logs = _port_step(setup, c4, noise)
        with pattern.replay():
            tr64, logs64 = _port_step(setup, c4, noise, torch.float64)
    return (trainer, logs, trainable_grads(trainer), logs64["loss"].item(),
            trainable_grads(tr64), pattern)


def float64_loss(setup, whole_step, pattern):
    """The port's float64 loss from the JAX c4 on the float32 step's ReLU
    pattern, as a function of the float64 parameters it returns with it."""
    _, (_, _, _, c4), noise = whole_step
    trainer = port_trainer(setup)
    model = trainer.engine.model.double()
    sample = jax.tree_util.tree_map(lambda x: x[0], setup[5])
    c4 = _nchw(c4).double()

    def loss():
        with default_dtype(torch.float64), torch.no_grad(), \
                relu_as(pattern), pattern.replay():
            return trainer.loss_from_c4(c4, sample, noise)[0].item()

    return loss, dict(model.named_parameters())


def test_whole_step_gradients_match_float64(port_steps):
    """The port's float32 step from the JAX c4: the loss within 1e-6 and
    every trainable gradient within 1e-5 of each tensor's max |grad| of
    the float64 recompute (the key projections' biases, 0 in exact
    arithmetic, within 1e-6 of the largest gradient)."""
    _, logs, g32, loss64, g64, _ = port_steps
    np.testing.assert_allclose(logs["loss"].item(), loss64, rtol=1e-6)
    assert set(g32) == set(g64) and len(g64) == 52
    peak = max(np.abs(t).max() for t in g64.values())
    for n, t in g64.items():
        if _is_key_bias(n):
            assert np.abs(g32[n]).max() <= 1e-6 * peak, n
        else:
            _rel_close(g32[n], t, 1e-5, n)


def test_whole_step_from_jax_c4_matches_jax(setup, whole_step,
                                            port_steps):
    """``loss_from_c4`` fed the JAX c4 and the JAX sampler noise: every log
    key within 1e-4 relative; the shared-head and head gradients held to
    the float64 recompute at 1e-5 and to the eager JAX step at 1e-3 of each
    tensor's max |grad| wherever that step is within 1e-4 of float64
    (``assert_grads_against_float64``).  Only ``shared_head.layer4``'s
    tensors may have the JAX step further off, and there central
    differences of the float64 loss side with the port.  Then the
    parameters after one step within 1e-5, and every frozen tensor bitwise
    unchanged."""
    _, (jlogs, jgrads, jafter, _), _ = whole_step
    trainer, logs, g32, _, g64, pattern = port_steps
    before = setup[4]
    model = trainer.engine.model
    for k in LOG_KEYS:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(jlogs["loss_trip"]) > 0
    for name, p in model.named_parameters():
        assert p.requires_grad == name.startswith(("shared_head.",
                                                   "bbox_head.")), name
    want = state_dict_from_jax(jgrads)
    assert_grads_against_float64(
        g32, {n: want[n].numpy() for n in g64}, g64,
        *float64_loss(setup, whole_step, pattern),
        may_stray=("shared_head.layer4.",))
    trainer.apply_update()
    want_p = state_dict_from_jax(jafter)
    for name, t in model.state_dict().items():
        if name.startswith(("shared_head.", "bbox_head.")) and \
                name in dict(model.named_parameters()):
            np.testing.assert_allclose(t.numpy(), want_p[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
            assert not torch.equal(t, before[name]), name
        else:      # backbone, RPN and every frozen-BN tensor
            assert torch.equal(t, before[name]), name


def test_train_step_through_the_port_backbone(setup, whole_step):
    """The whole step from the images, a looser smoke check: the two
    backbones' f32 rounding differs by ~3e-5 of c4's scale, which moves
    the proposals a little; the losses stay within 1e-3 relative."""
    _, (jlogs, _, _, _), noise = whole_step
    trainer = port_trainer(setup)
    sample = jax.tree_util.tree_map(lambda x: x[0], setup[5])
    logs = trainer.train_step(sample, noise)
    assert trainer.step == 1 and logs["lr"] == trainer.schedule(0)
    for k in LOG_KEYS:
        assert np.isfinite(float(logs[k])), k
        if not k.startswith("acc"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       rtol=1e-3, err_msg=k)


def test_triplet_selection_needs_other_class_videos(setup):
    trainer = port_trainer(setup)
    c5 = torch.randn(3 * IPV, 8, 2, 2)
    with pytest.raises(ValueError, match="extra-class videos"):
        trainer.select_videos(c5)
    chosen = trainer.select_videos(torch.randn(N_VIDEOS * IPV, 8, 2, 2))
    assert chosen[0] == 0 and chosen[1] in (1, 2) and chosen[2] >= 3


@pytest.fixture
def work_dir(tmp_path):
    """``tmp_path``, emptied after the test: the training loop's
    checkpoints hold the whole tiny model and its momentum (~0.35 GB
    each)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_train_detector_checkpoints_and_resumes(setup, work_dir):
    """Three CPU steps (one per epoch, frozen BNs calibrated on the first
    batch) with a checkpoint each; resumed from the second epoch's
    checkpoint, the third step ends on the same parameters, bit for bit,
    and the log has one line per step."""
    _, _, model_cfg, train_cfg, sd, _ = setup
    batches = [jax.tree_util.tree_map(lambda x: x[0], triplet_sample(2))]
    cfg = dict(OPT, total_epochs=3)

    def run(work_dir, epochs, resume=None):
        eng = HNMBRCNN(model_cfg, device="cpu", train_cfg=train_cfg)
        eng.load_state_dict(sd)
        trainer = train_detector(eng, batches, cfg, str(work_dir),
                                 total_epochs=epochs, resume_from=resume,
                                 log_interval=1, seed=4, calibrate_bn=True)
        return trainer, eng.model.state_dict()

    full, sd_full = run(work_dir / "a", 3)
    assert full.step == 3
    lines = (work_dir / "a" / "train_log.jsonl").read_text().splitlines()
    assert len(lines) == 3
    ckpt = load_checkpoint(str(work_dir / "a" / "epoch_2.pth"))
    assert ckpt["step"] == 2 and ckpt["meta"]["epoch"] == 2
    resumed, sd_resumed = run(work_dir / "b", 3,
                              resume=str(work_dir / "a" / "epoch_2.pth"))
    assert resumed.step == 3
    assert len((work_dir / "b" / "train_log.jsonl").read_text()
               .splitlines()) == 1
    for k, v in sd_full.items():
        assert torch.equal(v, sd_resumed[k]), k
    for k in ("bbox_head.fc_cls_2.weight", "backbone.bn1.running_var"):
        assert not torch.equal(sd_full[k], sd[k]), k


def test_train_detector_load_from(setup, work_dir, caplog):
    """``load_from`` a reference-style bare state_dict that lacks some
    tensors: the first step starts from the loaded weights, the missing
    tensors keep their values, and a warning counts them."""
    _, _, model_cfg, train_cfg, sd, _ = setup
    path = work_dir / "reference.pth"
    torch.save({k: v for k, v in sd.items()
                if not k.startswith("bbox_head.fc_cls_2.")}, path)
    eng = HNMBRCNN(model_cfg, device="cpu", train_cfg=train_cfg, seed=7)
    own = {k: v.clone() for k, v in eng.model.state_dict().items()}
    first = {}

    class Snapshot:
        @staticmethod
        def phase(name):
            if not first:
                first.update({k: v.clone() for k, v in
                              eng.model.state_dict().items()})
            return contextlib.nullcontext()

    with caplog.at_level(logging.WARNING, logger="hvrnet_tpu_torch"):
        train_detector(eng, [jax.tree_util.tree_map(lambda x: x[0],
                                                    setup[5])],
                       OPT, str(work_dir / "w"), total_epochs=1,
                       load_from=str(path), timer=Snapshot())
    for k, v in first.items():
        want = own[k] if k.startswith("bbox_head.fc_cls_2.") else sd[k]
        assert torch.equal(v, want), k
    assert "missing 2 tensors" in caplog.text
