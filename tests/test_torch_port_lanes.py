"""The port's lanes (B video streams in lockstep) against the JAX package's,
on the CPU at the tiny configs: the lanes NMS, the lane-axis attention,
the batched frame program, the batched ring, the sequential runner's pair
features (the batched frame program over consecutive frames) and the
window schedule.

Tolerances, each stated at its test:
- NMS: indices, masks, labels and dets equal (the picks are exact).
- attention: within 1e-5 of max|v| of ``jax.vmap(masked_attention)``;
  the 2-D call bit for bit its pre-lane expression.
- frame program, fed the JAX backbone maps: the proposal slots and masks
  equal, boxes within 1e-3 px, scores within 1e-6, fc1 within 1e-4 (the
  limits of ``tests/test_torch_port_backbone.py:test_frame_post_matches_
  jax``); in bf16 fc1 within 2 bf16 ulps of max|fc1| (those of
  ``tests/test_torch_port_precision.py``).
- ring: labels and masks equal, boxes within 1e-3 px and scores within
  1e-4 (those of ``tests/test_torch_port_selsa.py:test_window_detect_
  matches_jax``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu.engine import SelsaRCNN as JaxSelsaRCNN
from hvrnet_tpu.engine import SlidingWindowRunner as JaxRunner
from hvrnet_tpu.engine.batched_runner import \
    make_window_schedule as j_schedule
from hvrnet_tpu.ops.attention import masked_attention as j_attention
from hvrnet_tpu.ops.nms import \
    multiclass_nms_static_lanes as j_multiclass_lanes
from hvrnet_tpu.ops.nms import nms_static_lanes as j_nms_lanes
from hvrnet_tpu_torch.engine import HNMBRCNN, SelsaRCNN, SlidingWindowRunner
from hvrnet_tpu_torch.engine.batched_runner import make_window_schedule
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.ops.attention import NEG_INF, attention_plain
from hvrnet_tpu_torch.ops.nms import (multiclass_nms_static,
                                      multiclass_nms_static_lanes,
                                      nms_static, nms_static_lanes)
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_engine_selsa import tiny_selsa_cfg
from tests.test_ops_nms import rand_dets
from tests.test_torch_port_backbone import (CANVAS, PAD_SHAPE, _nchw,
                                            jax_param_tree, shared_engines,
                                            uint8_frame)
from tests.test_torch_port_selsa import _cross_back

torch.set_num_threads(2)

BF16 = torch.bfloat16
U = 2.0 ** -8


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------- NMS
def _lane_dets(seed, B, n, ties):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rand_dets(rng, n)[0] for _ in range(B)])
    scores = rng.uniform(0, 1, (B, n)).astype(np.float32)
    if ties:                     # the pick order then rests on the tie rule
        scores = np.round(scores, 1).astype(np.float32)
    valid = rng.uniform(size=(B, n)) > 0.2
    return boxes, scores, valid, rng


# (B, n, quota, ties, groups): one lane and three, tied scores, class
# groups, and a quota that truncates (lane 0's scores dominate lane 1's in
# the last case, as tests/test_ops_nms.py:test_nms_quota_truncation_per_lane)
NMS_CASES = [(1, 150, 40, False, False), (3, 150, 40, False, False),
             (3, 120, 25, True, False), (3, 120, 25, False, True),
             (2, 200, 10, False, False)]


@pytest.mark.parametrize("B,n,quota,ties,groups", NMS_CASES)
def test_nms_static_lanes_equals_jax(B, n, quota, ties, groups):
    """The same picks, order, per-lane quota and lane-local indices as the
    JAX ``nms_static_lanes`` (indices and masks equal, unused slots 0 and
    False), and each lane equal to the single-image ``nms_static``."""
    boxes, scores, valid, rng = _lane_dets(B * 100 + n, B, n, ties)
    if quota == 10:
        scores[0] = rng.uniform(0.5, 1.0, n)
        scores[1] = rng.uniform(0.0, 0.5, n)
    cls = rng.integers(0, 5, (B, n)) if groups else None
    ji, jm = j_nms_lanes(jnp.asarray(boxes), jnp.asarray(scores), 0.5, quota,
                         valid=jnp.asarray(valid),
                         sup_groups=None if cls is None
                         else jnp.asarray(cls, jnp.int32))
    ti, tm = nms_static_lanes(_t(boxes), _t(scores), 0.5, quota,
                              valid=_t(valid),
                              sup_groups=None if cls is None else _t(cls))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tm.sum() > 0 and (ti.numpy()[~tm.numpy()] == 0).all()
    for b in range(B):
        si, sm = nms_static(_t(boxes[b]), _t(scores[b]), 0.5, quota,
                            valid=_t(valid[b]),
                            groups=None if cls is None else _t(cls[b]))
        assert torch.equal(si, ti[b]) and torch.equal(sm, tm[b])


@pytest.mark.parametrize("B,specific", [(1, False), (3, False), (3, True)])
def test_multiclass_nms_lanes_equals_jax(B, specific):
    """Dets, labels and masks equal to the JAX
    ``multiclass_nms_static_lanes``, class-agnostic and class-specific
    (N, C·4) boxes, with padded rows; each lane equal to the single-image
    decode."""
    rng = np.random.default_rng(11 + B + specific)
    n, ncls, max_num = 80, 6, 30
    per = ncls if specific else 1
    boxes = np.stack([np.concatenate([rand_dets(rng, n)[0]
                                      for _ in range(per)], axis=1)
                      for _ in range(B)])
    scores = rng.dirichlet(np.ones(ncls), (B, n)).astype(np.float32)
    valid = rng.uniform(size=(B, n)) > 0.15
    jd, jl, jm = j_multiclass_lanes(jnp.asarray(boxes), jnp.asarray(scores),
                                    0.02, 0.5, max_num,
                                    valid=jnp.asarray(valid))
    td, tl, tm = multiclass_nms_static_lanes(_t(boxes), _t(scores), 0.02,
                                             0.5, max_num, valid=_t(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for b in range(B):
        sd, sl, sm = multiclass_nms_static(_t(boxes[b]), _t(scores[b]),
                                           0.02, 0.5, max_num,
                                           valid=_t(valid[b]))
        assert torch.equal(sd, td[b]) and torch.equal(sl, tl[b])


# ------------------------------------------------------------- attention
def _attn_lanes(seed, B, nq, nk, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, n, d)).astype(np.float32)
               for n in (nq, nk, nk))
    live = rng.random((B, nk)) > 0.3
    live[1 % B, :] = False                    # a lane with every key masked
    bias = np.where(live, 0.0, NEG_INF).astype(np.float32)
    return q, k, v, bias


def test_lane_attention_plain_matches_jax_vmap():
    """(3, 40, 64) queries over (3, 70, 64) keys, ~30 % of the keys masked
    and one lane wholly masked: within 1e-5 of max|v| of
    ``jax.vmap(masked_attention)`` on the CPU; each lane within 1e-6 of
    max|v| of its own 2-D call."""
    q, k, v, bias = _attn_lanes(0, 3, 40, 70)
    want = np.asarray(jax.vmap(lambda *a: j_attention(*a, 0.125))(
        *map(jnp.asarray, (q, k, v, bias))))
    got = attention_plain(*map(_t, (q, k, v, bias)), 0.125)
    assert got.shape == (3, 40, 64)
    tol = np.abs(v).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * tol)
    for b in range(3):
        one = attention_plain(*(_t(x[b]) for x in (q, k, v, bias)), 0.125)
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6 * tol)


def test_two_d_attention_is_its_pre_lane_expression():
    """The 2-D plain call, bit for bit the expression it had before the
    lane axis (``(q @ k.T) * scale + bias[None, :]``, softmax, ``@ v``), in
    float32 and for bf16 inputs."""
    q, k, v, bias = (_t(x[0]) for x in _attn_lanes(1, 1, 40, 70))
    for dt in (torch.float32, BF16):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        aff = (qd.float() @ kd.float().T) * 0.125 + bias[None, :]
        w = torch.softmax(aff, dim=-1)
        want = w.to(dt).float() @ vd.float()
        assert torch.equal(attention_plain(qd, kd, vd, bias, 0.125), want)


# ------------------------------------------------------- frame program
ISHS = np.array([[86.0, 122.0], [70.0, 96.0], [96.0, 64.0]], np.float32)


@pytest.fixture(scope="module")
def hnmb():
    return shared_engines(seed=7)


def _frames(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([uint8_frame(rng, ish) for ish in ISHS])


def _check_post(got, want, fc1_rtol, fc1_atol):
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert want["mask"].sum(axis=1).min() > 0
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-6)
    fc1 = np.asarray(want["fc1"], np.float32)
    np.testing.assert_allclose(got["fc1"].float().numpy(), fc1,
                               rtol=fc1_rtol, atol=fc1_atol(fc1))


def test_frame_post_batched_matches_jax(hnmb):
    """B = 3 frames of unequal ``img_shape`` through the JAX batched frame
    program's backbone; from those maps the port's ``frame_post_batched``
    against JAX's ``_frame_post_batched_fn``: slots and masks equal, boxes
    within 1e-3 px, scores within 1e-6, fc1 within 1e-4 (rtol 1e-4)."""
    jeng, params, port = hnmb
    imgs = _frames(3)
    pshs = np.tile(PAD_SHAPE, (3, 1))
    maps = jeng._backbone_dispatch(params, jnp.asarray(imgs), ISHS)
    want = jax.device_get(jeng._frame_post_batched_fn(*CANVAS)(
        jeng._bb(params), *maps, ISHS, pshs))
    got = port.frame_post_batched(*[_t(_nchw(m).copy()) for m in maps],
                                  ISHS, pshs)
    _check_post(got, want, 1e-4, lambda fc1: 1e-4)
    # the port's whole batched program against its own frame by frame:
    # the same slots, boxes within 1e-4 of the canvas width (the batched
    # convolution's rounding, tests/test_torch_port_backbone.py)
    whole = port.frame_features_batched(imgs, ISHS, pshs)
    for b in range(3):
        one = port.frame_features(imgs[b:b + 1], ISHS[b], PAD_SHAPE)
        np.testing.assert_array_equal(whole["mask"][b], one["mask"])
        np.testing.assert_allclose(whole["boxes"][b], one["boxes"], rtol=0,
                                   atol=1e-4 * CANVAS[1])


def test_frame_post_batched_bf16_matches_jax(hnmb):
    """The bf16 engines, from the JAX bf16 batched backbone maps: every
    lane pooled by RoIAlign's one-image bf16 branch as in JAX (slots and
    masks equal, boxes within 1e-3 px, scores within 1e-6, the bf16 fc1
    within 2 bf16 ulps of max|fc1|)."""
    jeng, params, port = hnmb
    j16 = JaxHNMBRCNN(jeng.model_cfg, None, jeng.test_cfg,
                      dtype=jnp.bfloat16)
    p16 = HNMBRCNN(jeng.model_cfg, jeng.test_cfg, device="cpu", dtype=BF16)
    p16.load_state_dict(port.model.state_dict())
    p16.cast_head_params_bf16()
    params16 = j16.cast_head_params_bf16(params)
    imgs = _frames(4)
    pshs = np.tile(PAD_SHAPE, (3, 1))
    maps = j16._backbone_dispatch(params16, jnp.asarray(imgs), ISHS)
    assert all(m.dtype == jnp.bfloat16 for m in maps)
    want = jax.device_get(j16._frame_post_batched_fn(*CANVAS)(
        j16._bb(params16), *maps, ISHS, pshs))
    nchw = [torch.from_numpy(np.asarray(m, np.float32).transpose(0, 3, 1, 2)
                             .copy()).to(BF16) for m in maps]
    got = p16.frame_post_batched(*nchw, ISHS, pshs)
    assert got["fc1"].dtype == BF16
    _check_post(got, want, 0, lambda fc1: 2 * U * np.abs(fc1).max())


# ------------------------------------------------------------ batched ring
def tiny_selsa_engines():
    """(JAX engine, JAX params, port engine) of the tiny SELSA config, T = 3,
    8 proposals, on one set of calibrated weights."""
    model_cfg, test_cfg = tiny_selsa_cfg(window_interval=1, proposals=8)
    jeng = JaxSelsaRCNN(model_cfg, None, test_cfg)
    tree = jax_param_tree(jeng, seed=5)
    port = SelsaRCNN(model_cfg, test_cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(tree))
    calibrate_frozen_bn(port, [dict(img=uint8_frame(np.random.default_rng(
        100)), img_shape=ISHS[0])])
    return jeng, _cross_back(tree, port), port


@pytest.fixture(scope="module")
def selsa():
    return tiny_selsa_engines()


B_RING, STEPS = 3, 6
RESETS = {0: (0, 1, 2), 3: (1,)}      # step → lanes that start a video


def _lane_caches(step, P, D, seed=21):
    rng = np.random.default_rng(seed + step)
    return dict(fc1=rng.normal(size=(B_RING, P, D)).astype(np.float32),
                boxes=np.sort(rng.uniform(2, 60, (B_RING, P, 4)),
                              axis=-1).astype(np.float32),
                mask=rng.random((B_RING, P)) > 0.2)


@pytest.mark.parametrize("kind,branch", [("selsa", None), ("hnmb", None),
                                         ("hnmb", 0)])
def test_batched_ring_matches_jax(kind, branch, selsa, hnmb, request):
    """Three lanes of crafted caches pushed for 6 steps, lane 1 starting a
    new video at step 3 (its whole ring refilled), a detection at every
    step from the second: labels and masks equal to the JAX batched ring,
    boxes within 1e-3 px and scores within 1e-4; every branch of HVRNet, or
    one (``branch=``)."""
    jeng, params, port = selsa if kind == "selsa" else hnmb
    P, D = port.proposal_num, 1024
    jstate = jeng.ring_reset_batched(B_RING, D)
    state = port.ring_reset_batched(B_RING, D)
    ishs = np.array([[86.0, 122.0], [70.0, 96.0], [60.0, 80.0]], np.float32)
    sfs = np.full((B_RING, 4), 0.8, np.float32)
    checked = 0
    for step in range(STEPS):
        c = _lane_caches(step, P, D)
        reset = np.isin(np.arange(B_RING), RESETS.get(step, ()))
        jstate = jeng.ring_push_batched(
            jstate, {k: jnp.asarray(v) for k, v in c.items()},
            jnp.asarray(reset))
        state = port.ring_push_batched(state, {k: _t(v) for k, v in
                                               c.items()}, reset)
        np.testing.assert_array_equal(state["pos"], np.asarray(jstate["pos"]))
        if step == 0:
            continue
        want = jax.device_get(jeng.ring_detect_batched(
            params, jstate, ishs, sfs, branch=branch))
        got = port.ring_detect_batched(state, ishs, sfs, branch=branch)
        if kind == "selsa" or branch is not None:
            want, got = [want], [got]
        assert len(got) == len(want)
        for (gd, gl, gm), (wd, wl, wm) in zip(got, want):
            np.testing.assert_array_equal(gm.numpy(), wm)
            np.testing.assert_array_equal(gl.numpy()[wm], wl[wm])
            np.testing.assert_allclose(gd.numpy()[wm][:, :4], wd[wm][:, :4],
                                       rtol=0, atol=1e-3)
            np.testing.assert_allclose(gd.numpy()[wm][:, 4], wd[wm][:, 4],
                                       rtol=0, atol=1e-4)
            checked += int(wm.sum())
    assert checked > 0
    for key in ("fc1", "boxes", "masks"):
        np.testing.assert_array_equal(state[key].numpy(),
                                      np.asarray(jstate[key]))


# ---------------------------------------------------------- pair features
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


def _maps_of(jeng, params):
    """A port engine's ``backbone_maps`` that returns the JAX frame
    program's maps of the same canvases (batched as given), NCHW."""
    def maps(img, img_shape):
        out = jeng._backbone_dispatch(params, jnp.asarray(np.asarray(img)),
                                      np.asarray(img_shape))
        return tuple(torch.from_numpy(np.asarray(m).transpose(0, 3, 1, 2)
                                      .copy()) for m in out)
    return maps


def _frame_by_frame(port):
    """The port engine's own ``backbone_maps``, one frame at a time."""
    own = port.backbone_maps

    def maps(img, img_shape):
        ish = np.asarray(img_shape, np.float32).reshape(-1, 2)
        per = [own(img[i:i + 1], ish[i]) for i in range(len(ish))]
        return tuple(torch.cat(m) for m in zip(*per))
    return maps


@pytest.mark.parametrize("kind,P,n", [("selsa", 2, 13), ("hnmb_stream", 3, 11)])
def test_pair_features_match_single_frames_and_jax(kind, P, n,
                                                   selsa, hnmb, monkeypatch):
    """P consecutive interior frames through one frame program: SELSA at
    P = 2 over 13 frames (an odd interior tail goes frame by frame) and
    HVRNet's streaming ring at P = 3 over 11 frames; every frame emitted
    once.  With the backbone run frame by frame, P equals P = 1 bit for bit
    (everything after the backbone is per frame).  With the backbone maps
    of the JAX frame program, against the JAX runner at the same P: the
    same detections per frame and class, boxes within 1e-3 px and scores
    within 1e-4 (the limits of tests/test_torch_port_slice.py fed the JAX
    maps)."""
    jeng, params, port = selsa if kind == "selsa" else hnmb
    if kind == "hnmb_stream":
        monkeypatch.setattr(port, "stream", True)
        monkeypatch.setattr(jeng, "stream", True, raising=False)
    want = JaxRunner(jeng, params, pair_features=P).run(_video(n, 9, True), n)

    def run(p, maps):
        emitted = []
        with monkeypatch.context() as mp:
            mp.setattr(port, "backbone_maps", maps)
            runner = SlidingWindowRunner(port, pair_features=p,
                                         progress_hook=emitted.append)
            out = runner.run(_video(n, 9, False), n)
        assert sum(emitted) == n and runner.pair_features == p
        return out

    own = _frame_by_frame(port)
    for a, b in zip(run(P, own), run(1, own)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    _assert_close(run(P, _maps_of(jeng, params)), want, n, box_tol=1e-3)


def _assert_close(got, want, n, box_tol):
    total = 0
    assert len(got) == len(want) == n
    for fg, fw in zip(got, want):
        assert len(fg) == len(fw) == 30
        for cg, cw in zip(fg, fw):
            assert cg.shape == cw.shape
            if len(cw):
                np.testing.assert_allclose(cg[:, :4], cw[:, :4], rtol=0,
                                           atol=box_tol)
                np.testing.assert_allclose(cg[:, 4], cw[:, 4], rtol=0,
                                           atol=1e-4)
            total += len(cw)
    assert total > 0


# --------------------------------------------------------- window schedule
@pytest.mark.parametrize("L", [1, 2, 3, 5, 10, 11, 21, 30, 50])
@pytest.mark.parametrize("T", [3, 21])
def test_window_schedule_equals_jax(L, T):
    """Action for action the JAX ``make_window_schedule``, on a shuffled
    visit order; every offset emitted exactly once, except in a one-frame
    video, whose only frame takes the reset branch and emits nothing (as in
    the JAX schedule)."""
    order = np.random.default_rng(L * T).permutation(L).tolist()
    got = make_window_schedule(order, T)
    assert got == j_schedule(order, T)
    emitted = sorted(e for _, _, e in got if e is not None)
    assert emitted == (list(range(L)) if L > 1 else [])
