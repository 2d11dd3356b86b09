"""The port's precision policy against the JAX package's: the bf16
engines, the loss scale and the per-parameter optimizer options.

Sizes are the tiny configs of the other port tests: HVRNet and SELSA at
test time (``tiny_hnmb_cfg`` / ``tiny_selsa_cfg``, R50 stages, T = 3,
8 proposals) and in training (``tests/test_torch_port_train.py`` and
``tests/test_torch_port_selsa.py``).  Weights are JAX parameter trees
filled from numpy, crossed to the port by ``state_dict_from_jax``.

Every bf16 limit is set from bf16 rounding, u = 2⁻⁸ the relative rounding
step of bf16's 8-bit significand:

* RoIAlign: both packages round the same axis weights and the same
  first product (≤ 4 nonzero taps, f32 accumulation) to bf16, so they may
  differ by one rounding of a value ≤ max|feat|: 1 bf16 ulp of max|feat|.
* fc1 from the same maps: its own bf16 rounding and RoIAlign's one ulp
  carried through fc_new_1: 2 ulps, 2u·max|fc1|.
* Raw head outputs: the JAX package's budget for bf16 against f32
  (``tests/test_bf16_budget.py:test_hvrnet_bf16_budget_random``):
  |Δcls| ≤ 0.05·max(max|cls|, 1), |Δreg| ≤ 0.05.  The port's bf16 head
  against the JAX bf16 head differs by the two packages' roundings, each
  inside that budget of the f32 head.
* Streaming against exact ring: the streaming NL1 output keeps the softmax
  weights p in f32 where the exact ring's attention rounds them to bf16,
  so it is held to ``bf16_agreement``'s bound for that one rounding
  (``worst`` ≤ 1); the logits, where the two rings differ only in where p
  is rounded, to the bf16 budget above.
* Losses: the JAX package computes the heads' cross entropy in bf16
  (rounding each loss by ≤ u/2 ≈ 2e-3) where the port's is f32: 1e-2
  relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hvrnet_tpu.core.precision import DynamicLossScale as JaxLossScale
from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu.engine import SelsaRCNN as JaxSelsaRCNN
from hvrnet_tpu.engine.optim import default_trainable_mask as jax_mask
from hvrnet_tpu.engine.optim import make_optimizer as jax_make_optimizer
from hvrnet_tpu.engine.optim import step_lr_schedule as jax_schedule
from hvrnet_tpu.engine.train import HNMBTrainer as JaxHNMBTrainer
from hvrnet_tpu.engine.train import SelsaTrainer as JaxSelsaTrainer
from hvrnet_tpu.ops.roi_align import roi_align as jax_roi_align
from hvrnet_tpu_torch.apis import build_detector
from hvrnet_tpu_torch.core.precision import (DEFAULT_POLICY, FP32_POLICY,
                                             DynamicLossScale,
                                             LossScaleState, cast_floating,
                                             to_compute, widen)
from hvrnet_tpu_torch.engine import HNMBRCNN, SelsaRCNN
from hvrnet_tpu_torch.engine.canvas import Canvas
from hvrnet_tpu_torch.engine.detector import f32_precision
from hvrnet_tpu_torch.engine.train import HNMBTrainer, SelsaTrainer
from hvrnet_tpu_torch.ops.attention import NEG_INF, bf16_agreement
from hvrnet_tpu_torch.ops.roi_align import roi_align
from hvrnet_tpu_torch.ops.streaming_attention import finalize
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests import test_torch_port_selsa as selsa_tests
from tests import test_torch_port_train as hnmb_tests
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_engine_selsa import tiny_selsa_cfg
from tests.test_torch_port_backbone import (CANVAS, IMG_SHAPE, PAD_SHAPE,
                                            jax_param_tree, shared_engines,
                                            uint8_frame)

torch.set_num_threads(2)

BF16 = torch.bfloat16
U = 2.0 ** -8
OPT = dict(optimizer=dict(lr=1e-3, momentum=0.9, weight_decay=1e-4))


def _bf16_to_f32(tree):
    """A JAX tree with its bf16 leaves widened (exactly) to float32."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _nchw_bf16(x):
    """A JAX NHWC array (bf16 or f32) → NCHW torch bf16, exactly."""
    return torch.from_numpy(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2).copy()).to(BF16)


def _budget(got, want):
    """(max|Δcls| / max(max|cls|, 1), max|Δreg|) over the head's
    (cls, reg) lists."""
    def f32(x):
        return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)
    cls_d = max(np.abs(f32(a) - f32(b)).max() / max(np.abs(f32(b)).max(), 1.0)
                for a, b in zip(got[0], want[0]))
    reg_d = max(np.abs(f32(a) - f32(b)).max()
                for a, b in zip(got[1], want[1]))
    return float(cls_d), float(reg_d)


# ----------------------------------------------------------- loss scale
GRAD_SEQUENCE = "ggbgggbbgggggbg"      # g: finite gradients, b: one inf


@pytest.mark.parametrize("fp16", [dict(loss_scale="dynamic"),
                                  dict(loss_scale=512.0)])
def test_loss_scale_trajectory_matches_jax(fp16):
    """The scale and good-step count after each of a fixed sequence of
    finite and non-finite gradient sets, the finite flag and the unscaled
    gradients, against the JAX ``DynamicLossScale`` the JAX trainer builds
    from the same key (growth every 2 good steps for the dynamic one, so
    the sequence grows, backs off and resets the streak)."""
    if fp16["loss_scale"] == "dynamic":
        ours = DynamicLossScale(init_scale=64.0, growth_interval=2)
        ref = JaxLossScale(init_scale=64.0, growth_interval=2)
    else:
        ours = DynamicLossScale.from_config(fp16)
        ref = JaxLossScale(init_scale=512.0, growth_factor=1.0,
                           backoff_factor=1.0, growth_interval=1 << 30)
    rng = np.random.default_rng(0)
    st, jst = ours.init(), ref.init()
    scales = []
    for kind in GRAD_SEQUENCE:
        g = [rng.standard_normal(s).astype(np.float32) * 100
             for s in ((3, 4), (5,))]
        if kind == "b":
            g[1][2] = np.inf
        grads = [torch.from_numpy(x.copy()) for x in g]
        finite, st = ours.unscale_and_check(grads, st)
        jg, jfinite, jst = ref.unscale_and_check(g, jst)
        assert bool(finite) == bool(jfinite) == (kind == "g")
        assert float(st.scale) == float(jst.scale)
        assert int(st.good_steps) == int(jst.good_steps)
        for a, b in zip(grads, jg):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        scales.append(float(st.scale))
    if fp16["loss_scale"] == "dynamic":
        assert len(set(scales)) > 2         # it grew and backed off
    else:
        assert set(scales) == {512.0}


@pytest.fixture(scope="module")
def hnmb_setup():
    """``tests/test_torch_port_train.py``'s tiny HVRNet training setup:
    (JAX engine, JAX params, model config, train config, calibrated port
    state_dict, batch)."""
    return hnmb_tests.setup.__wrapped__()


def _hnmb_trainer(setup, cfg, dtype=torch.float32):
    _, _, model_cfg, train_cfg, sd, _ = setup
    eng = HNMBRCNN(model_cfg, device="cpu", train_cfg=train_cfg, dtype=dtype)
    eng.load_state_dict(sd)
    return HNMBTrainer(eng, cfg, steps_per_epoch=10, seed=0)


def _sample(setup):
    return jax.tree_util.tree_map(lambda x: x[0], setup[5])


def _momentum(trainer):
    return [trainer.optimizer.state[p]["momentum_buffer"].clone()
            for p in trainer.params]


def test_fp16_static_scale_step_equals_unscaled_step(hnmb_setup):
    """``fp16=dict(loss_scale=512.)``: the loss ×512 before the backward
    and the gradients ÷512 before the clip give the unscaled step's
    weights within 1e-6 relative; the fixed scale stays 512."""
    plain = _hnmb_trainer(hnmb_setup, OPT)
    scaled = _hnmb_trainer(hnmb_setup, dict(OPT, fp16=dict(loss_scale=512.)))
    logs0 = plain.train_step(_sample(hnmb_setup))
    logs1 = scaled.train_step(_sample(hnmb_setup))
    assert "overflow" not in logs0
    assert logs1["overflow"] == 0.0 and float(logs1["loss_scale"]) == 512.0
    np.testing.assert_allclose(float(logs1["loss"]), float(logs0["loss"]),
                               rtol=1e-6)
    for a, b in zip(scaled.params, plain.params):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-9)


def test_fp16_overflow_skips_weights_and_momentum(hnmb_setup):
    """An overflow (an inf scale makes every gradient non-finite) leaves
    the weights and the momentum bit for bit as they were, and still
    advances the step."""
    trainer = _hnmb_trainer(hnmb_setup, dict(OPT, fp16=dict(loss_scale=512.)))
    trainer.train_step(_sample(hnmb_setup))           # a momentum to keep
    weights = {k: v.clone()
               for k, v in trainer.engine.model.state_dict().items()}
    momentum = _momentum(trainer)
    trainer.scale_state = LossScaleState(
        torch.tensor(float("inf")), trainer.scale_state.good_steps)
    logs = trainer.train_step(_sample(hnmb_setup))
    assert logs["overflow"] == 1.0 and trainer.step == 2
    for k, v in trainer.engine.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    for a, b in zip(_momentum(trainer), momentum):
        assert torch.equal(a, b)


def _trainable_subtree(tree):
    """The HVRNet trainer's trainable leaves of a JAX tree: the shared head
    and the bbox head without their frozen BNs."""
    def prune(t):
        return {k: prune(v) for k, v in t.items() if k != "bn"} \
            if isinstance(t, dict) else t
    return {"params": {k: prune(tree["params"][k])
                       for k in ("shared_head", "bbox_head")}}


def _merge(tree, sub):
    """``tree`` with the leaves of ``sub`` in place of its own."""
    if not isinstance(tree, dict):
        return sub
    return {k: _merge(v, sub[k]) if k in sub else v for k, v in tree.items()}


def test_paramwise_options_match_the_jax_optimizer(hnmb_setup):
    """Three SGD steps with ``optimizer.paramwise_options`` on the tiny
    HVRNet tree (shared head and bbox head training, the second step's
    gradients clipped) against the JAX ``make_optimizer`` with the same
    options: every tensor within 1e-6.  (The JAX chain runs on the
    trainable subtree: its per-leaf multiplier trees do not pass through
    ``optax.masked``.)"""
    jeng, _, model_cfg, train_cfg, _, _ = hnmb_setup
    tree = jax_param_tree(jeng, seed=11)
    opts = dict(bias_lr_mult=2.0, bias_decay_mult=0.0, norm_decay_mult=0.0)
    cfg = dict(optimizer=dict(lr=0.05, momentum=0.9, weight_decay=1e-2,
                              paramwise_options=opts),
               optimizer_config=dict(grad_clip=dict(max_norm=35.0)),
               lr_config=dict(step=[1], warmup_iters=2, warmup_ratio=1 / 3))
    eng = HNMBRCNN(model_cfg, device="cpu", train_cfg=train_cfg)
    eng.load_state_dict(state_dict_from_jax(tree))
    trainer = HNMBTrainer(eng, cfg, steps_per_epoch=2)
    assert {g["lr_mult"] for g in trainer.optimizer.param_groups} == {1., 2.}

    jp = _trainable_subtree(tree)
    tx = jax_make_optimizer(jax_schedule(0.05, 2, [1], warmup_iters=2),
                            momentum=0.9, weight_decay=1e-2, clip_norm=35.0,
                            paramwise_options=opts, params=jp)
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(12)
    params = dict(eng.model.named_parameters())
    norms = []
    for step, mult in enumerate((1e-4, 0.05, 2e-4)):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * mult).astype(
                np.float32), tree)
        upd, opt_state = update(_trainable_subtree(grads), opt_state, jp)
        jp = jax.jit(optax.apply_updates)(jp, upd)
        g = state_dict_from_jax(grads)
        for name, p in params.items():
            p.grad = g[name].clone() if p.requires_grad else None
        norms.append(float(jax.jit(optax.global_norm)(
            _trainable_subtree(grads))))
        trainer.apply_update()
        want = state_dict_from_jax(_merge(tree, jp))
        for name, t in eng.model.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} step {step}")
    assert norms[1] > 35.0 > max(norms[0], norms[2])


def test_paramwise_names_follow_the_reference_rule():
    from hvrnet_tpu_torch.engine.optim import paramwise_mults
    opts = dict(bias_lr_mult=2.0, bias_decay_mult=0.5, norm_decay_mult=0.0)
    assert paramwise_mults("bbox_head.fc_cls.bias", opts) == (2.0, 0.5)
    assert paramwise_mults("bbox_head.fc_cls.weight", opts) == (1.0, 1.0)
    assert paramwise_mults("backbone.layer2.0.bn1.weight", opts) == (1.0, 0.0)
    assert paramwise_mults("neck.gn.bias", opts) == (1.0, 0.0)


# ----------------------------------------------------------- head casts
@pytest.mark.parametrize("kind", ["hnmb", "selsa"])
def test_cast_head_params_bf16_matches_jax(kind):
    """The bbox head's weights of rank ≥ 2 in bf16, bit for bit the JAX
    package's cast; biases, backbone, shared head and RPN float32; a
    float32 engine's cast changes nothing."""
    if kind == "hnmb":
        (model_cfg, test_cfg), jcls, cls = tiny_hnmb_cfg(), JaxHNMBRCNN, \
            HNMBRCNN
    else:
        (model_cfg, test_cfg), jcls, cls = tiny_selsa_cfg(), JaxSelsaRCNN, \
            SelsaRCNN
    jeng = jcls(model_cfg, None, test_cfg, dtype=jnp.bfloat16)
    tree = jax_param_tree(jeng, seed=2)
    jcast = jeng.cast_head_params_bf16(tree)
    is_bf16 = state_dict_from_jax(jax.tree_util.tree_map(
        lambda x: np.full(x.shape, x.dtype == jnp.bfloat16, np.float32),
        jcast))
    want = state_dict_from_jax(_bf16_to_f32(jcast))

    port = cls(model_cfg, test_cfg, device="cpu", dtype=BF16)
    port.load_state_dict(state_dict_from_jax(tree))
    port.cast_head_params_bf16()
    got = port.model.state_dict()
    assert set(got) == set(want)
    n_bf16 = 0
    for name, t in got.items():
        flag = is_bf16[name]
        assert bool(flag.min()) == bool(flag.max()), name
        assert (t.dtype == BF16) == bool(flag.max()), name
        assert (t.dtype == BF16) == (name.startswith("bbox_head.")
                                     and t.ndim >= 2), name
        n_bf16 += t.dtype == BF16
        assert torch.equal(t.float(), want[name]), name
    assert n_bf16 == (20 if kind == "hnmb" else 10)

    f32 = cls(model_cfg, test_cfg, device="cpu")
    before = {k: v.clone() for k, v in f32.model.state_dict().items()}
    f32.cast_head_params_bf16()
    for k, v in f32.model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k])


# -------------------------------------------------------------- RoIAlign
def _roi_case(seed, frames):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((frames, 6, 8, 32)).astype(np.float32)
    xy = rng.uniform(-8, 100, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (12, 2))], 1)
    idx = rng.integers(0, frames, (12, 1)).astype(np.float64)
    return (jnp.asarray(feats, jnp.bfloat16),
            np.concatenate([idx, boxes], 1).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_roi_align_bf16_matches_jax(seed):
    """One image's bf16 features: the JAX package's bf16 branch (sample
    mean folded into bf16 axis weights, the first product rounded to bf16,
    the second accumulated in f32), within 1 bf16 ulp of max|feat|, as
    float32."""
    feats, rois = _roi_case(seed, 1)
    want = np.asarray(jax_roi_align(feats, jnp.asarray(rois)))
    got = roi_align(_nchw_bf16(feats), torch.from_numpy(rois))
    assert got.dtype == torch.float32
    peak = float(np.abs(np.asarray(feats, np.float32)).max())
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=_ulp(peak))
    # the f32 arithmetic on the same values would differ: the branch ran
    f32 = roi_align(_nchw_bf16(feats).float(), torch.from_numpy(rois))
    assert not torch.equal(f32, got)


def test_roi_align_bf16_several_frames_matches_jax():
    """Several images' bf16 features (training): the JAX package's gather
    branch computes in f32 on the bf16 values, so the port's f32 form on
    the widened features, within the f32 limits of the f32 comparison
    (``test_torch_port_train.py``)."""
    feats, rois = _roi_case(3, 3)
    want = np.asarray(jax_roi_align(feats, jnp.asarray(rois)))
    got = roi_align(_nchw_bf16(feats), torch.from_numpy(rois))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ raw head outputs
def _head_engines(kind):
    """(JAX bf16 engine, JAX f32 params, JAX bf16-cast params, port f32
    engine, port bf16 engine with its head cast), one set of weights."""
    if kind == "hnmb":
        (model_cfg, test_cfg), jcls, cls = tiny_hnmb_cfg(), JaxHNMBRCNN, \
            HNMBRCNN
    else:
        (model_cfg, test_cfg), jcls, cls = tiny_selsa_cfg(), JaxSelsaRCNN, \
            SelsaRCNN
    j16 = jcls(model_cfg, None, test_cfg, dtype=jnp.bfloat16)
    tree = jax_param_tree(j16, seed=0)
    p32 = cls(model_cfg, test_cfg, device="cpu")
    p16 = cls(model_cfg, test_cfg, device="cpu", dtype=BF16)
    for eng in (p32, p16):
        eng.load_state_dict(state_dict_from_jax(tree))
    p16.cast_head_params_bf16()
    return j16, tree, j16.cast_head_params_bf16(tree), p32, p16


@pytest.mark.parametrize("kind", ["hnmb", "selsa"])
def test_bf16_head_within_the_jax_budget(kind):
    """The window head's raw cls/reg outputs in bf16, on the fixed inputs
    of ``test_hvrnet_bf16_budget_random`` (fc1 N(0, 1) from seed 7, ~90 %
    valid rows): against the JAX bf16 head and against the port's own f32
    head, |Δcls| ≤ 0.05·max(max|cls|, 1) and |Δreg| ≤ 0.05."""
    j16, _, jp16, p32, p16 = _head_engines(kind)
    T, P = p32.window, p32.proposal_num
    rng = np.random.default_rng(7)
    fc1 = rng.normal(size=(T * P, 1024)).astype(np.float32)
    masks = rng.random((T, P)) > 0.1
    mod = j16.module
    want16 = mod.apply(jp16, jnp.asarray(fc1, jnp.bfloat16), P, P,
                       jnp.asarray(masks.reshape(-1)),
                       method=mod.bbox_forward_fc1)
    x, m = torch.from_numpy(fc1), torch.from_numpy(masks.reshape(-1))
    with torch.no_grad():
        got16 = p16.model.bbox_head.forward_fc1(x.to(BF16), P, P, m)
        got32 = p32.model.bbox_head.forward_fc1(x, P, P, m)
    if kind == "selsa":                     # one branch
        want16, got16, got32 = (([a], [b]) for a, b in (want16, got16,
                                                         got32))
    assert all(t.dtype == BF16 for t in got16[0] + got16[1])
    for ref in (want16, got32):
        cls_d, reg_d = _budget(got16, ref)
        assert cls_d <= 0.05 and reg_d <= 0.05, (cls_d, reg_d)


# ------------------------------------------------------------- proposals
@pytest.fixture(scope="module")
def bf16_engines():
    """(JAX bf16 engine, its cast params, port bf16 engine with its head
    cast) on ``shared_engines``' calibrated weights."""
    jeng, params, port = shared_engines(seed=3)
    j16 = JaxHNMBRCNN(jeng.model_cfg, None, jeng.test_cfg,
                      dtype=jnp.bfloat16)
    p16 = HNMBRCNN(jeng.model_cfg, jeng.test_cfg, device="cpu", dtype=BF16)
    p16.load_state_dict(port.model.state_dict())
    p16.cast_head_params_bf16()
    return j16, j16.cast_head_params_bf16(params), p16


def test_frame_post_from_jax_bf16_maps_matches_jax(bf16_engines):
    """From the JAX bf16 backbone and RPN maps: the same proposal picks
    (slots and masks; both packages widen the bf16 logits before the
    sigmoid and break score ties toward the lower index), boxes within
    1e-3 px, and the bf16 fc1 rows within 2 bf16 ulps of max|fc1|."""
    j16, params, p16 = bf16_engines
    img = uint8_frame(np.random.default_rng(4))
    maps = j16._backbone_dispatch(params, jnp.asarray(img), IMG_SHAPE)
    assert all(m.dtype == jnp.bfloat16 for m in maps)
    want = jax.device_get(j16._frame_post_fn(*CANVAS)(
        j16._bb(params), *maps, IMG_SHAPE, PAD_SHAPE))
    got = p16.frame_post(*[_nchw_bf16(m) for m in maps], IMG_SHAPE,
                         PAD_SHAPE)
    assert got["fc1"].dtype == BF16 and got["boxes"].dtype == torch.float32
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert want["mask"].sum() > 0
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-6)
    fc1 = np.asarray(want["fc1"], np.float32)
    np.testing.assert_allclose(got["fc1"].float().numpy(), fc1, rtol=0,
                               atol=2 * U * np.abs(fc1).max())


# -------------------------------------------------------- streaming ring
def test_bf16_streaming_ring_against_the_exact_ring():
    """A bf16 streaming ring after 8 pushes of bf16 fc1 rows (T = 5, 8
    proposals; more than one ring turnover): bf16 row caches and f32
    accumulators; NL1's streaming output against the exact attention on
    the ring's own bf16 q/k/v within the bound of rounding p to bf16; the
    key frame's logits against the exact bf16 head on the same window
    within the bf16 budget."""
    model_cfg, test_cfg = tiny_hnmb_cfg(window_interval=2)
    eng = HNMBRCNN(model_cfg, test_cfg, device="cpu", dtype=BF16)
    eng.cast_head_params_bf16()
    eng.stream = True
    T, P, kd = eng.window, eng.proposal_num, eng.key_dim
    rng = np.random.default_rng(5)
    frames = [dict(fc1=torch.from_numpy(rng.normal(size=(P, 1024)).astype(
                       np.float32)).to(BF16),
                   boxes=torch.from_numpy(rng.uniform(5, 60, (P, 4)).astype(
                       np.float32)),
                   mask=torch.from_numpy(rng.random(P) > 0.2))
              for _ in range(8)]
    ring = eng.ring_reset(1024)
    for f in frames:
        eng.ring_push(ring, f)
    for k in ("fc1", "q1", "k1", "fc3s", "q3", "k3"):
        assert ring[k].dtype == BF16, k
    for k in ("m1", "l1", "a1", "m3", "l3", "a3", "M1", "M3"):
        assert ring[k].dtype == torch.float32, k

    head = eng.model.bbox_head
    bias = torch.where(ring["masks"].reshape(-1), 0.0, NEG_INF).float()
    nl1 = finalize(dict(m=ring["m1"], l=ring["l1"], a=ring["a1"]))
    agree = bf16_agreement(nl1, ring["q1"], ring["k1"], ring["fc1"], bias,
                           head.selsa_1.scale)
    assert agree["worst"] <= 1, agree

    centre = (ring["pos"] + 1 + kd) % T
    fc1 = torch.cat([f["fc1"] for f in frames[-T:]])
    valid = torch.cat([f["mask"] for f in frames[-T:]])
    with torch.no_grad(), f32_precision():
        got = head.stream_forward(eng.head_state(ring), centre)
        want = head.forward_fc1(fc1, kd * P, P, valid)
    cls_d, reg_d = _budget(got, want)
    assert cls_d <= 0.05 and reg_d <= 0.05, (cls_d, reg_d)


# -------------------------------------------------------------- training
def _jax_bf16_loss(jeng, params, cfg_cls, canvas, sample, key):
    """The JAX bf16 trainer's loss and logs (forward only, jitted) and its
    bf16 C4 of the sample's frames."""
    j16 = type(jeng)(jeng.model_cfg, jeng.train_cfg, None, dtype=jnp.bfloat16)
    trainer = cfg_cls(j16, OPT, mesh=None, steps_per_epoch=10)
    loss, logs = jax.jit(trainer._build_loss_fn(*canvas))(params, sample,
                                                          key)
    c4 = jax.jit(lambda p, x: j16.module.apply(
        p, x, method=j16.module.extract_feat))(params, sample["imgs"])
    return dict(jax.device_get(logs), loss=float(loss)), c4


def _assert_bf16_step(trainer, c4, sample, noise, want, trained):
    """One bf16 step from the JAX bf16 C4: the losses within 1e-2 relative
    of the JAX bf16 loss function's, float32 parameters and gradients,
    frozen tensors bitwise unchanged, trainable ones moved."""
    model = trainer.engine.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with f32_precision():
        loss, logs = trainer.loss_from_c4(c4, sample, noise)
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    logs["loss"] = loss
    for k, v in logs.items():
        assert v.dtype == torch.float32 and torch.isfinite(v), k
        if not k.startswith("acc"):
            np.testing.assert_allclose(v.item(), float(want[k]), rtol=1e-2,
                                       err_msg=k)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        if p.requires_grad:
            assert p.grad.dtype == torch.float32, name
    trainer.apply_update()
    params = dict(model.named_parameters())
    for name, t in model.state_dict().items():
        if name in params and params[name].requires_grad:
            assert name.startswith(trained), name
            if not (".k_data_fc_" in name and name.endswith(".bias")):
                assert not torch.equal(t, before[name]), name
        else:
            assert torch.equal(t, before[name]), name


def test_bf16_hnmb_training_step(hnmb_setup):
    """HVRNet: one bf16 step from the JAX bf16 C4 and sampler noise."""
    jeng, params, _, train_cfg, _, batch = hnmb_setup
    key = jax.random.PRNGKey(21)
    sample = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), batch)
    want, c4 = _jax_bf16_loss(jeng, params, JaxHNMBTrainer,
                              hnmb_tests.CANVAS, sample, key)
    n_cand = batch["gt_bboxes"].shape[2] + \
        train_cfg["rpn_proposal"]["nms_post"]
    noise = hnmb_tests._step_noise(key, hnmb_tests.N_VIDEOS * 3, n_cand)
    trainer = _hnmb_trainer(hnmb_setup, OPT, BF16)
    _assert_bf16_step(trainer, _nchw_bf16(c4), _sample(hnmb_setup), noise,
                      want, ("shared_head.", "bbox_head."))


def test_bf16_selsa_training_step():
    """SELSA: one bf16 step (RPN loss, OHEM) from the JAX bf16 C4 and
    noise; the trainable backbone stages, RPN and heads move."""
    setup = selsa_tests.setup.__wrapped__()
    jeng, params, model_cfg, train_cfg, sd, sample = setup
    key = jax.random.PRNGKey(31)
    want, c4 = _jax_bf16_loss(jeng, params, JaxSelsaTrainer,
                              selsa_tests.TRAIN_CANVAS,
                              jax.tree_util.tree_map(jnp.asarray, sample),
                              key)
    n_anchors = Canvas(*selsa_tests.TRAIN_CANVAS).anchors.shape[0]
    n_cand = sample["gt_bboxes"].shape[1] + \
        train_cfg["rpn_proposal"]["nms_post"]
    noise = selsa_tests._step_noise(key, 3, n_anchors, n_cand)
    eng = build_detector(model_cfg, train_cfg=train_cfg, dtype=BF16,
                         device="cpu")
    assert isinstance(eng, SelsaRCNN) and eng.dtype == BF16
    eng.load_state_dict(sd)
    trainer = SelsaTrainer(eng, OPT, steps_per_epoch=10)
    # the backbone's own C4 with the JAX values: the backbone keeps its
    # gradient, as in the f32 step test
    # (in f32, where the sum is exact: the C4 values are the JAX ones)
    x = eng._to_input(sample["imgs"], None)
    with f32_precision():
        own = eng.model.extract_feat(x).float()
    c4 = (own + (_nchw_bf16(c4).float() - own).detach()).to(BF16)
    _assert_bf16_step(trainer, c4, sample, noise, want,
                      ("backbone.layer2.", "backbone.layer3.", "rpn_head.",
                       "shared_head.", "bbox_head."))


def test_policy_casts():
    """The JAX policy's defaults; under float32 compute nothing is cast
    (a float64 recompute stays float64), and only floating tensors are."""
    assert DEFAULT_POLICY == (BF16, torch.float32, torch.float32)
    assert FP32_POLICY == (torch.float32,) * 3
    x64 = torch.zeros(2, dtype=torch.float64)
    x32 = torch.zeros(2)
    assert widen(x64) is x64 and widen(x32) is x32
    assert widen(x32.to(BF16)).dtype == torch.float32
    assert to_compute(x64, torch.float32) is x64
    assert to_compute(x64, BF16).dtype == BF16
    idx = torch.arange(3)
    assert cast_floating(idx, BF16) is idx
    assert cast_floating(x32, BF16).dtype == BF16
