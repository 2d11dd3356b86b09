"""SELSA in the port against the JAX package: the head, the engine and the
runner at test time, and one training step.

Sizes are the JAX tests' tiny SELSA configs: at test time
``tests/test_engine_selsa.py:tiny_selsa_cfg`` (R50 stages, T = 3, 8
proposals), in training ``tests/test_train_step.py``'s ``tiny_model_cfg`` /
``tiny_train_cfg`` (16 RoIs per frame, OHEM 8, head ``sampler_num`` 8 ×
``t_dim`` 3 = 24 keys of the 48 rows) on 3 frames of 128×192, the
smallest canvas whose anchors (64 px and up) fit inside the image, so the
RPN loss has samples.  Weights: a JAX
parameter tree filled from numpy crosses to the port through
``state_dict_from_jax``, the port calibrates the frozen-BN statistics and
the weights cross back.  The samplers' uniform noise is the one
``jax.random`` draws from the JAX step's key, handed to the port.

The training step's gradients are held to a float64 recompute of the
port's own step: the port's float32 gradients within 1e-5 of each tensor's
max |grad|, and within 1e-3 of the eager JAX step's wherever those are
within 1e-4 of float64.  XLA:CPU's float32 gradients in the conv trunks
(backbone and ``layer4``) depend on the host; where they stray further,
central differences of the float64 loss must side with the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hvrnet_tpu.core import targets as jtargets
from hvrnet_tpu.engine import SelsaRCNN as JaxSelsaRCNN
from hvrnet_tpu.engine import SlidingWindowRunner as JaxRunner
from hvrnet_tpu.engine.train import SelsaTrainer as JaxSelsaTrainer
from hvrnet_tpu.engine.train import _rpn_loss as jax_rpn_loss
from hvrnet_tpu.utils.checkpoint import convert_torch_checkpoint, merge_params
from hvrnet_tpu_torch.apis import train_detector
from hvrnet_tpu_torch.core import targets
from hvrnet_tpu_torch.engine import SelsaRCNN, SlidingWindowRunner
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.engine.canvas import Canvas
from hvrnet_tpu_torch.engine.train import SelsaTrainer, _rpn_loss
from hvrnet_tpu_torch.utils.checkpoint import load_checkpoint
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_engine_selsa import tiny_selsa_cfg
from tests.test_torch_port_backbone import jax_param_tree, uint8_frame
from tests.test_torch_port_train import (  # noqa: F401  (work_dir)
    ReluPattern, assert_grads_against_float64, default_dtype, relu_as,
    trainable_grads, work_dir)
from tests.test_train_step import make_sample, tiny_model_cfg, tiny_train_cfg

torch.set_num_threads(2)

CANVAS = (96, 128)          # inference
TRAIN_CANVAS = (128, 192)   # training
OPT = dict(optimizer=dict(lr=1e-3, momentum=0.9, weight_decay=1e-4))


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _nchw(x):
    return torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy())


def _rel_close(got, want, tol, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _cross_back(tree, port):
    """The port's (calibrated) weights as a JAX parameter tree."""
    back = convert_torch_checkpoint(
        {k: v.numpy() for k, v in port.model.state_dict().items()})
    merged, missing = merge_params(tree["params"], back["params"])
    assert missing == []
    return {"params": merged}


# --------------------------------------------------------------- inference
def _video(n, seed, as_jax):
    rng = np.random.default_rng(seed)
    for i in range(n):
        ish = np.array([86.0 - 2 * i, 122.0 - i], np.float32)
        img = uint8_frame(rng, ish)
        yield dict(img=jnp.asarray(img) if as_jax else img, img_shape=ish,
                   pad_shape=np.array(CANVAS, np.float32),
                   scale_factor=np.full(4, 0.8, np.float32),
                   key_frame_flag=0 if i == 0 else (1 if i == n - 1 else 2),
                   frame_offset=i, seg_len=n, frame_start_id=1)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, JAX params, port engine) on the same calibrated
    weights, T = 3, 8 proposals."""
    model_cfg, test_cfg = tiny_selsa_cfg(window_interval=1, proposals=8)
    jeng = JaxSelsaRCNN(model_cfg, None, test_cfg)
    tree = jax_param_tree(jeng, seed=5)
    port = SelsaRCNN(model_cfg, test_cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(tree))
    frame = next(_video(1, 100, False))
    calibrate_frozen_bn(port, [frame])
    return jeng, _cross_back(tree, port), port


def test_state_dict_from_jax_carries_the_selsa_tree(engines):
    """Every tensor of the port's SELSA model, and back through
    ``convert_torch_checkpoint`` to the same JAX tree bit for bit
    (``fc_new_1`` permuted between the HWC and CHW flattenings)."""
    _, params, port = engines
    sd = state_dict_from_jax(params)
    assert set(sd) == set(port.model.state_dict())
    for k, v in port.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = convert_torch_checkpoint({k: v.numpy() for k, v in sd.items()})
    leaves = jax.tree_util.tree_leaves_with_path(params["params"])
    flat = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(flat[path]),
                                      np.asarray(leaf), str(path))
    head = port.model.bbox_head
    assert sorted(n for n, _ in head.named_children()) == [
        "fc_cls", "fc_new_1", "fc_new_2", "fc_reg", "selsa_1", "selsa_2"]
    assert head.fc_reg.out_features == 4


def _head_rows(rng, n=24, masked=(3, 17)):
    fc1 = (rng.standard_normal((n, 1024)) * 0.5).astype(np.float32)
    valid = np.ones(n, bool)
    valid[list(masked)] = False
    return fc1, valid


@pytest.mark.parametrize("output_all", [False, True])
def test_head_forward_fc1_matches_jax(engines, output_all):
    """``forward_fc1`` over T·P = 24 rows with two masked rows, the key
    frame's 8 rows or every row: cls and reg within 1e-5 relative."""
    jeng, params, port = engines
    fc1, valid = _head_rows(np.random.default_rng(0))
    mod = jeng.module
    want = mod.apply(params, fc1, 8, 8, valid, output_all=output_all,
                     method=mod.bbox_forward_fc1)
    with torch.no_grad():
        got = port.model.bbox_head.forward_fc1(_t(fc1), 8, 8, _t(valid),
                                               output_all=output_all)
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((24 if output_all else 8), g.shape[1])
        _rel_close(g.numpy(), w, 1e-5)


def test_head_forward_from_pooled_rois_matches_jax(engines):
    """The full head from (N, C, 7, 7) pooled RoIs (fc_new_1 over the CHW
    flattening against the JAX package's HWC): within 1e-5 relative."""
    jeng, params, port = engines
    rng = np.random.default_rng(1)
    pooled = (rng.standard_normal((24, 7, 7, 256)) * 0.2).astype(np.float32)
    _, valid = _head_rows(rng)
    mod = jeng.module
    want = mod.apply(params, pooled, 16, 8, valid, method=mod.bbox_forward)
    with torch.no_grad():
        got = port.model.bbox_head(_nchw(pooled), 16, 8, _t(valid))
    for g, w in zip(got, want):
        _rel_close(g.numpy(), w, 1e-5)


class _JaxMaps:
    """The port's engine fed the JAX frame program's backbone maps, so the
    comparison starts after the backbone's f32 drift."""

    def __init__(self, port, jeng, params):
        self.port, self.jeng, self.params = port, jeng, params

    def __getattr__(self, name):
        return getattr(self.port, name)

    def frame_features(self, img, img_shape, pad_shape):
        maps = self.jeng._backbone_dispatch(self.params, jnp.asarray(img),
                                            img_shape)
        return self.port.frame_post(*[_nchw(m) for m in maps], img_shape,
                                    pad_shape)


def test_window_detect_matches_jax(engines):
    """``window_detect`` on the same window caches (the JAX frame program's
    per-frame outputs): boxes within 1e-3 px, scores within 1e-4, labels
    and the output mask equal."""
    jeng, params, port = engines
    frames = list(_video(3, 4, True))
    feats = [jax.device_get(jeng.frame_features(
        params, f["img"], f["img_shape"], f["pad_shape"])) for f in frames]
    stack = {k: np.stack([f[k] for f in feats])
             for k in ("fc1", "boxes", "mask")}
    m = frames[1]
    want = jax.device_get(jeng.window_detect(
        params, stack["fc1"], stack["boxes"], stack["mask"], m["img_shape"],
        m["scale_factor"]))
    got = port.window_detect(_t(stack["fc1"]), _t(stack["boxes"]),
                             _t(stack["mask"]), m["img_shape"],
                             m["scale_factor"])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    live = want[2]
    assert live.sum() > 0
    np.testing.assert_array_equal(got[1].numpy()[live], want[1][live])
    np.testing.assert_allclose(got[0].numpy()[live, :4], want[0][live, :4],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[0].numpy()[live, 4], want[0][live, 4],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("maps", ["jax", "port"])
def test_video_matches_jax_runner(engines, maps):
    """A 6-frame video through both ``SlidingWindowRunner``s (flags 0, 2,
    …, 1, front and tail padding): every frame a 30-class result, the same
    number of detections per class.  From the JAX backbone maps boxes
    within 1e-3 px and scores within 1e-4; from the images, a smoke check,
    boxes within 1e-4 of the canvas width (the backbone's f32 drift moves
    the proposals, ``test_torch_port_backbone.assert_close_to_scale``)."""
    jeng, params, port = engines
    n = 6
    want = JaxRunner(jeng, params).run(_video(n, 9, True), n)
    emitted = []
    eng = _JaxMaps(port, jeng, params) if maps == "jax" else port
    runner = SlidingWindowRunner(eng, flush_every=4,
                                 progress_hook=emitted.append)
    assert (runner.window, runner.key_dim, runner.speculative) == (3, 1,
                                                                   False)
    got = runner.run(_video(n, 9, False), n)
    assert sum(emitted) == n
    box_tol = 1e-3 if maps == "jax" else 1e-4 * CANVAS[1]
    total = 0
    for fw, fg in zip(want, got):
        assert len(fg) == len(fw) == 30
        for cw, cg in zip(fw, fg):
            assert cg.shape == cw.shape
            if len(cw):
                np.testing.assert_allclose(cg[:, :4], cw[:, :4], rtol=0,
                                           atol=box_tol)
                np.testing.assert_allclose(cg[:, 4], cw[:, 4], rtol=0,
                                           atol=1e-4)
            total += len(cw)
    assert total > 0


def test_selsa_engine_key_frame_and_window():
    """The key frame: ``train_cfg.rcnn.key_dim`` when training, the
    window centre ``frame_interval`` at test time; no streaming ring."""
    model_cfg, test_cfg = tiny_selsa_cfg(window_interval=2)
    eng = SelsaRCNN(model_cfg, test_cfg, device="cpu")
    assert (eng.key_dim, eng.window, eng.stream) == (2, 5, False)
    head = eng.model.bbox_head
    assert (head.sampler_num, head.t_dim) == (8, 5)
    tr = SelsaRCNN(tiny_model_cfg(), device="cpu",
                   train_cfg=tiny_train_cfg())
    assert (tr.key_dim, tr.window) == (0, None)
    assert (tr.model.bbox_head.sampler_num, tr.model.bbox_head.t_dim) == \
        (8, 3)


# --------------------------------------------------------------- targets
def _jax_noise(key, n):
    """The (pos, neg) U(0, 1) vectors the JAX samplers draw from ``key``."""
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))),
            np.asarray(jax.random.uniform(kn, (n,))))


def _anchor_case(seed):
    rng = np.random.default_rng(seed)
    canvas = Canvas(*TRAIN_CANVAS)
    gts = np.zeros((4, 4), np.float32)
    for g in range(3):
        xy = rng.uniform(0, 50, 2)
        gts[g] = np.concatenate([xy, xy + rng.uniform(30, 70, 2)])
    gts[2] = gts[1] + 1.0        # two ground truths on one object
    gt_mask = np.array([True, True, True, False])
    return canvas, gts, gt_mask


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pad,num,pos_weight", [((128, 192), 32, -1.0),
                                                ((128, 176), 256, 2.0)])
def test_anchor_target_single_matches_jax(seed, pad, num, pos_weight):
    """Anchor targets over the whole grid from the JAX noise: validity from
    the padded extent and ``allowed_border`` 0, the 0.7/0.3/0.3 assignment,
    the sample (``num`` 256 takes every eligible anchor), bit for bit; the
    deltas within 1e-5."""
    canvas, gts, gm = _anchor_case(seed)
    cfg = dict(tiny_train_cfg()["rpn"], pos_weight=pos_weight)
    cfg["sampler"] = dict(cfg["sampler"], num=num)
    ish = np.array([pad[0] - 6.0, pad[1] - 10.0], np.float32)
    key = jax.random.PRNGKey(seed)
    anchors = canvas.anchors.numpy()
    valid = canvas.anchor_valid(np.array(pad, np.float32))
    want = jtargets.anchor_target_single(
        key, jnp.asarray(anchors), jnp.asarray(valid.numpy()),
        jnp.asarray(gts), jnp.asarray(gm), jnp.asarray(ish), cfg)
    pos, neg = _jax_noise(key, len(anchors))
    got = targets.anchor_target_single(
        canvas.anchors, valid, _t(gts), _t(gm), ish, cfg,
        pos_noise=_t(pos), neg_noise=_t(neg))
    for name in ("labels", "label_weights", "num_total_samples"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_array_equal(
        got.bbox_weights.numpy(),
        np.broadcast_to(np.asarray(want.bbox_weights), got.bbox_weights.shape))
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=1e-5,
                               atol=1e-5)
    assert got.labels.sum() > 0 and (got.label_weights > 0).sum() > \
        got.labels.sum()


def test_anchor_target_draws_from_the_generator_when_no_noise():
    canvas, gts, gm = _anchor_case(0)
    args = (canvas.anchors, canvas.anchor_valid((128, 192)), _t(gts),
            _t(gm), (124.0, 190.0), tiny_train_cfg()["rpn"])
    runs = [targets.anchor_target_single(
        *args, generator=torch.Generator().manual_seed(s)).label_weights
        for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="torch.Generator"):
        targets.anchor_target_single(*args)


@pytest.mark.parametrize("losses", ["random", "tied"])
def test_ohem_weights_match_jax(losses):
    """The 8 hardest of 40 sampled RoIs at pos_fraction 0.25, 12 positives
    and 3 padded slots among them: the same selection as the JAX package,
    also when losses tie (the lower index wins, as in ``lax.top_k``)."""
    rng = np.random.default_rng(2)
    labels = np.zeros(40, np.int64)
    labels[rng.choice(40, 12, replace=False)] = rng.integers(1, 31, 12)
    valid = np.ones(40, bool)
    valid[[5, 21, 33]] = False
    loss = rng.uniform(0, 4, 40).astype(np.float32)
    if losses == "tied":
        loss = np.round(loss).astype(np.float32)
    lw = np.where(valid, 1.0, 0.0).astype(np.float32)
    bw = np.repeat((labels > 0)[:, None], 4, 1).astype(np.float32)
    want = jtargets.ohem_weights(*map(jnp.asarray, (labels, lw, bw, loss,
                                                    valid)), 8, 0.25)
    got = targets.ohem_weights(*map(_t, (labels, loss, valid)), 8, 0.25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) == 8 and int(got[3].sum()) == 2


def test_rpn_loss_matches_jax():
    """Sigmoid BCE and smooth-L1 (β = 1/9) over the sampled anchors of an
    (A, H, W) / (4A, H, W) map pair, normalised by the sample count."""
    rng = np.random.default_rng(3)
    canvas, gts, gm = _anchor_case(1)
    cfg = tiny_train_cfg()["rpn"]
    key = jax.random.PRNGKey(3)
    valid = canvas.anchor_valid((128, 192))
    ish = np.array([124.0, 190.0], np.float32)
    tgt_j = jtargets.anchor_target_single(
        key, jnp.asarray(canvas.anchors.numpy()), jnp.asarray(valid.numpy()),
        jnp.asarray(gts), jnp.asarray(gm), jnp.asarray(ish), cfg)
    pos, neg = _jax_noise(key, canvas.anchors.shape[0])
    tgt = targets.anchor_target_single(
        canvas.anchors, valid, _t(gts), _t(gm), ish, cfg,
        pos_noise=_t(pos), neg_noise=_t(neg))
    cls = (rng.standard_normal((8, 12, 12)) * 2).astype(np.float32)  # NHWC
    reg = (rng.standard_normal((8, 12, 48)) * 0.3).astype(np.float32)
    want = jax_rpn_loss(jnp.asarray(cls), jnp.asarray(reg), tgt_j)
    got = _rpn_loss(_nchw(cls[None])[0], _nchw(reg[None])[0], tgt)
    for g, w in zip(got, want):
        assert float(w) > 0
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


# --------------------------------------------------------------- the step
@pytest.fixture(scope="module")
def setup():
    """(JAX engine, JAX params, model config, train config, calibrated port
    state_dict, sample)."""
    model_cfg, train_cfg = tiny_model_cfg(sampler_num=8, t_dim=3), \
        tiny_train_cfg(two_stage_sampler=True)
    jeng = JaxSelsaRCNN(model_cfg, train_cfg, None)
    tree = jax_param_tree(jeng, seed=7)
    batch = make_sample(np.random.default_rng(4), frames=3,
                        h=TRAIN_CANVAS[0], w=TRAIN_CANVAS[1])
    port = SelsaRCNN(model_cfg, device="cpu", train_cfg=train_cfg)
    port.load_state_dict(state_dict_from_jax(tree))
    calibrate_frozen_bn(port, [dict(img=batch["imgs"][0, f:f + 1],
                                    img_shape=batch["img_shape"][0, f])
                               for f in range(3)])
    sd = {k: v.clone() for k, v in port.model.state_dict().items()}
    sample = jax.tree_util.tree_map(lambda x: x[0], batch)
    return jeng, _cross_back(tree, port), model_cfg, train_cfg, sd, sample


def port_trainer(setup, seed=0):
    _, _, model_cfg, train_cfg, sd, _ = setup
    eng = SelsaRCNN(model_cfg, device="cpu", train_cfg=train_cfg)
    eng.load_state_dict(sd)
    return SelsaTrainer(eng, OPT, steps_per_epoch=10, seed=seed)


def _step_noise(key, n_frames, n_anchors, n_cand):
    """The JAX step's noise: ``split(key, F + 2)``, [0] for the anchors,
    [1 + i] for frame i's RoI candidates."""
    keys = jax.random.split(key, n_frames + 2)
    frames = [_jax_noise(keys[1 + i], n_cand) for i in range(n_frames)]
    return (tuple(_t(x) for x in _jax_noise(keys[0], n_anchors)),
            tuple(torch.from_numpy(np.stack(x)) for x in zip(*frames)))


@pytest.fixture(scope="module")
def whole_step(setup):
    """The eager JAX step (value_and_grad of the loss, one optax update):
    (logs, grads, params after, c4, the noise it drew)."""
    jeng, params, _, train_cfg, _, sample = setup
    key = jax.random.PRNGKey(31)
    trainer = JaxSelsaTrainer(jeng, OPT, mesh=None, steps_per_epoch=10)
    state = trainer.create_state(params)
    loss_fn = trainer._build_loss_fn(*TRAIN_CANVAS)
    jsample = jax.tree_util.tree_map(jnp.asarray, sample)
    (loss, logs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, jsample, key)
    # the update is elementwise but for the global norm, so jitting it
    # changes nothing the test holds (eagerly it takes ~25 s of dispatch)
    upd, _ = jax.jit(trainer.tx.update)(grads, state.opt_state, params)
    after = jax.jit(optax.apply_updates)(params, upd)
    c4 = jeng.module.apply(params, jsample["imgs"],
                           method=jeng.module.extract_feat)
    n_anchors = Canvas(*TRAIN_CANVAS).anchors.shape[0]
    n_cand = sample["gt_bboxes"].shape[1] + \
        train_cfg["rpn_proposal"]["nms_post"]
    return (dict(jax.device_get(logs), loss=float(loss)),
            state_dict_from_jax(jax.device_get(grads)),
            state_dict_from_jax(jax.device_get(after)), np.asarray(c4),
            _step_noise(key, 3, n_anchors, n_cand))


def _with_c4(model, x, c4):
    """The port's C4 of ``x`` with its values replaced by ``c4``: the
    backbone stays in the graph and gets its gradient, and both packages'
    heads see the same maps."""
    own = model.extract_feat(x)
    return own + (c4 - own).detach()


def _port_step(setup, c4, noise, dtype=torch.float32):
    """The port's step from the images through ``_with_c4`` to the
    gradients, in ``dtype``: in float64 the model and every tensor the step
    creates are float64."""
    trainer = port_trainer(setup)
    model = trainer.engine.model
    sample = setup[5]
    with default_dtype(dtype):
        model.to(dtype)
        if dtype == torch.float32:       # the trainer's own backbone call
            own = trainer.backbone(sample)
            c4 = own + (_nchw(c4) - own).detach()
        else:
            c4 = _with_c4(model, _nchw(sample["imgs"]).to(dtype),
                          _nchw(c4).to(dtype))
        loss, logs = trainer.loss_from_c4(c4, sample, noise)
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    logs["loss"] = loss
    return trainer, logs


@pytest.fixture(scope="module")
def port_steps(setup, whole_step):
    """The port's step in float32 and its float64 recompute on the float32
    step's ReLU pattern: (float32 trainer, its logs, its gradients, the
    float64 gradients, the pattern)."""
    c4, noise = whole_step[3:]
    pattern = ReluPattern()
    with relu_as(pattern):
        trainer, logs = _port_step(setup, c4, noise)
        with pattern.replay():
            tr64, _ = _port_step(setup, c4, noise, torch.float64)
    return trainer, logs, trainable_grads(trainer), trainable_grads(tr64), \
        pattern


LOG_KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc",
            "loss")
TRAINED = ("backbone.layer2.", "backbone.layer3.", "rpn_head.",
           "shared_head.", "bbox_head.")


def test_whole_step_from_jax_c4_matches_jax(setup, whole_step, port_steps,
                                            monkeypatch):
    """``loss_from_c4`` on the JAX c4 (through the port's backbone) with
    the JAX noise: every log within 1e-4 relative; every trainable
    gradient (backbone ``layer2``/``layer3``, RPN, shared head, head)
    within 1e-5 of the float64 recompute's max |grad| and within 1e-3 of
    the JAX step's wherever that is within 1e-4 of float64
    (``assert_grads_against_float64``; where the backbone's or
    ``layer4``'s stray further, central differences of the float64 loss
    side with the port).  The backbone's tensors are held at
    1e-4: a weight gradient inherits the float32 drift of its layer's
    input, which grows through the bottlenecks to 3e-5 of c4's peak
    (measured up to 3.4e-5 at ``layer3.5``; the shared head starts from the
    same c4 in both precisions and holds 1e-6).  Then the parameters after
    one SGD step
    within 1e-5 of the JAX step's, every trainable one moved, and every
    frozen tensor bitwise unchanged."""
    jlogs, jgrads, jafter = whole_step[:3]
    trainer, logs, g32, g64, pattern = port_steps
    before = setup[4]
    model = trainer.engine.model
    for k in LOG_KEYS:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(jlogs["loss_rpn_bbox"]) > 0 and float(jlogs["loss_bbox"]) > 0
    params = dict(model.named_parameters())
    trained = {n for n, p in params.items() if p.requires_grad}
    assert trained == {n for n in params if n.startswith(TRAINED)}
    assert set(g64) == trained and len(trained) == 70
    assert_grads_against_float64(
        g32, {n: jgrads[n].numpy() for n in g64}, g64,
        *float64_loss(setup, whole_step, pattern, monkeypatch),
        may_stray=("backbone.", "shared_head.layer4."),
        port_tol=lambda n: 1e-4 if n.startswith("backbone.") else 1e-5)
    trainer.apply_update()
    for name, t in model.state_dict().items():
        if name in trained:
            np.testing.assert_allclose(t.numpy(), jafter[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
            if not (".k_data_fc_" in name and name.endswith(".bias")):
                assert not torch.equal(t, before[name]), name
        else:      # stem, layer1 and every frozen-BN tensor
            assert torch.equal(t, before[name]), name


def cached_trunk(backbone, pattern):
    """``backbone``'s C4 as a function of its input, which reruns only the
    stages from the first whose parameters changed since the last call
    (the stem, then each ``layer{i}``): a stage's output is a function of
    its input and its parameters, so a reused one is the one a rerun
    would give, bit for bit.  ``pattern`` (replaying) is moved to where
    the reused stages leave it.  Central differences perturb one tensor
    at a time, so most of the trunk before it is reused."""
    import hvrnet_tpu_torch.models.backbones.resnet as resnet
    stages = [(lambda h: resnet.max_pool_3x3_s2_p1(torch.nn.functional.relu(
        backbone.bn1(backbone.conv1(h)))), (backbone.conv1, backbone.bn1))]
    stages += [(layer, (layer,)) for layer in (
        getattr(backbone, f"layer{i + 1}")
        for i in range(backbone.num_stages))]
    cache = []

    def run(x):
        h, fresh = x, False
        for i, (fn, mods) in enumerate(stages):
            params = [p for m in mods for p in m.parameters()]
            if not fresh and i < len(cache) and all(
                    torch.equal(p, q) for p, q in zip(params, cache[i][0])):
                h, pattern.replaying = cache[i][1], cache[i][2]
                continue
            fresh = True
            h = fn(h)
            entry = ([p.detach().clone() for p in params], h,
                     pattern.replaying)
            cache[i:i + 1] = [entry]
        return h

    return run


def float64_loss(setup, whole_step, pattern, monkeypatch):
    """The port's float64 loss from the images on the float32 step's ReLU
    pattern, as a function of the float64 parameters it returns with it.
    The first call fixes the offset from C4 to the JAX c4, and the
    proposals, which the step takes from detached maps; the trunk reruns
    from the first stage a perturbation touched (``cached_trunk``)."""
    import hvrnet_tpu_torch.engine.train as train_module
    c4, noise = whole_step[3:]
    trainer = port_trainer(setup)
    model = trainer.engine.model.double()
    sample = setup[5]
    x = _nchw(sample["imgs"]).double()
    fixed, calls, offset = [], [0], []
    real = train_module._rpn_proposals

    def held_proposals(*args):
        i = calls[0] % len(sample["imgs"])
        calls[0] += 1
        if len(fixed) <= i:
            fixed.append(real(*args))
        return fixed[i]

    monkeypatch.setattr(train_module, "_rpn_proposals", held_proposals)
    trunk = cached_trunk(model.backbone, pattern)

    def loss():
        with default_dtype(torch.float64), torch.no_grad(), \
                relu_as(pattern), pattern.replay():
            own = trunk(x)
            if not offset:
                offset.append(_nchw(c4).double() - own)
            return trainer.loss_from_c4(own + offset[0], sample,
                                        noise)[0].item()

    loss()
    return loss, dict(model.named_parameters())


def test_float64_recompute_matches_finite_differences(setup, whole_step,
                                                       port_steps,
                                                       monkeypatch):
    """The float64 recompute is the derivative of the function the float32
    step computes: on the largest gradient entry of a backbone, an RPN, a
    shared-head and a head tensor, central differences of the port's
    float64 loss (``float64_loss``) agree with it to 1e-6 of the tensor's
    max |grad|."""
    g64, pattern = port_steps[3:]
    loss, params = float64_loss(setup, whole_step, pattern, monkeypatch)
    h = 1e-6
    for name in ("backbone.layer3.0.conv2.weight", "rpn_head.rpn_conv.weight",
                 "shared_head.layer4.0.conv2.weight",
                 "bbox_head.fc_new_1.weight"):
        flat = params[name].data.view(-1)
        i = int(np.abs(g64[name]).argmax())
        orig = flat[i].item()
        flat[i] = orig + h
        up = loss()
        flat[i] = orig - h
        down = loss()
        flat[i] = orig
        fd = (up - down) / (2 * h)
        peak = np.abs(g64[name]).max()
        assert abs(fd - g64[name].reshape(-1)[i]) <= 1e-6 * peak, \
            (name, fd, g64[name].reshape(-1)[i])


def test_selsa_trainer_needs_the_ohem_sampler(setup):
    """OHEM is the second sampler of ``train_cfg.rcnn``: a single sampler
    trains without it (as the JAX trainer does; held against JAX in
    ``tests/test_torch_port_image.py``), and a list of one sampler is
    refused before any work."""
    trainer = port_trainer(setup)
    tcfg = trainer.engine.train_cfg
    trainer.engine.train_cfg = dict(tcfg, rcnn=dict(
        tcfg["rcnn"], sampler=tcfg["rcnn"]["sampler"][:1]))
    with pytest.raises(ValueError, match="one sampler, or"):
        trainer.loss_from_c4(torch.zeros(3, 8, 8, 12), setup[5])
    trainer.engine.train_cfg = dict(tcfg, rcnn=dict(
        tcfg["rcnn"], sampler=tcfg["rcnn"]["sampler"][0]))
    sample = setup[5]
    loss, logs = trainer.loss_from_c4(trainer.backbone(sample), sample)
    assert torch.isfinite(loss) and set(logs) == {
        "loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc"}


def test_train_detector_trains_selsa_and_resumes(setup, work_dir):
    """``train_detector`` picks ``SelsaTrainer`` for a ``SelsaRCNN``: two
    CPU steps (one per epoch, frozen BNs calibrated on the first batch)
    with a checkpoint each; resumed from the first, the second step ends
    on the same parameters, bit for bit; the RPN and backbone ``layer2``
    moved, the stem did not."""
    _, _, model_cfg, train_cfg, sd, sample = setup
    cfg = dict(OPT, total_epochs=2)

    def run(work_dir, epochs, resume=None):
        eng = SelsaRCNN(model_cfg, device="cpu", train_cfg=train_cfg)
        eng.load_state_dict(sd)
        trainer = train_detector(eng, [sample], cfg, str(work_dir),
                                 total_epochs=epochs, resume_from=resume,
                                 log_interval=1, seed=4, calibrate_bn=True)
        return trainer, eng.model.state_dict()

    full, sd_full = run(work_dir / "a", 2)
    assert isinstance(full, SelsaTrainer) and full.step == 2
    lines = (work_dir / "a" / "train_log.jsonl").read_text().splitlines()
    assert len(lines) == 2 and "loss_rpn_cls" in lines[0]
    ckpt = load_checkpoint(str(work_dir / "a" / "epoch_1.pth"))
    assert ckpt["step"] == 1
    resumed, sd_resumed = run(work_dir / "b", 2,
                              resume=str(work_dir / "a" / "epoch_1.pth"))
    assert resumed.step == 2
    for k, v in sd_full.items():
        assert torch.equal(v, sd_resumed[k]), k
    for k in ("rpn_head.rpn_conv.weight", "backbone.layer2.0.conv1.weight"):
        assert not torch.equal(sd_full[k], sd[k]), k
    assert torch.equal(sd_full["backbone.conv1.weight"],
                       sd["backbone.conv1.weight"])
