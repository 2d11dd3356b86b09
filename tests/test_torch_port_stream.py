"""The port's streaming ring against the JAX package's and against the
port's own exact ring.

The same seeded numpy inputs go through ``hvrnet_tpu.ops.streaming_attention``
and ``hvrnet_tpu_torch.ops.streaming_attention``; the head's stream methods
run on weights from ``state_dict_from_jax``; the runners run the tiny HNMB
config (T = 5, 8 proposals).  Most engine tests feed crafted per-frame caches
(fc1, boxes, mask) through a stubbed frame program, as
``tests/test_streaming_engine.py`` does, so the window math is what they
compare.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine import SlidingWindowRunner as JaxRunner
from hvrnet_tpu.ops import streaming_attention as jsa
from hvrnet_tpu_torch.engine import HNMBRCNN, SlidingWindowRunner
from hvrnet_tpu_torch.ops import streaming_attention as tsa
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_torch_port_backbone import _nchw, shared_engines
from tests.test_torch_port_slice import _video

torch.set_num_threads(2)

T, P, D = 5, 8, 1024
ISH = np.array([64.0, 96.0], np.float32)
SF = np.ones((4,), np.float32)


def _close(got, want, rel, what=""):
    """|got − want| ≤ rel · max(|want|, 1) over the finite entries, and the
    same ±inf entries."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=rel * scale,
                               err_msg=what)


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [np.asarray(x)]


# ------------------------------------------------------------ the ops
def _op_inputs(seed):
    """R = 4 slots × 6 rows, d 16, one slot all masked.  Accumulators over
    the whole key set (``full``, which holds the departing keys), and the
    same with three rows empty (m = −inf, no live key)."""
    rng = np.random.default_rng(seed)
    slots, rows, d = 4, 6, 16
    R = slots * rows
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    x = dict(q=f32(R, d) * 1.5, k_all=f32(R, d) * 1.5, v_all=f32(R, d),
             k_new=f32(rows, d) * 1.5, v_new=f32(rows, d),
             mask_all=rng.random(R) > 0.3, mask_new=rng.random(rows) > 0.3)
    x["mask_all"][rows:2 * rows] = False
    x["mask_all"][0] = True
    x["k_dep"], x["v_dep"] = x["k_all"][:rows], x["v_all"][:rows]
    x["mask_dep"] = x["mask_all"][:rows]
    acc, M = tsa.init_rows(*(torch.from_numpy(x[k]) for k in
                             ("q", "k_all", "v_all", "mask_all")),
                           0.25, slots=slots)
    for k, v in acc.items():
        x[k] = v.numpy().copy()
        x[k + "_full"] = v.numpy().copy()
    x["M"] = M.numpy().copy()
    x["m"][:3], x["l"][:3], x["a"][:3] = -np.inf, 0.0, 0.0
    x["M"][:3] = -np.inf
    return x, slots


def _op(sa, to, name, x, slots):
    a = {k: to(v) for k, v in x.items()}
    acc = dict(m=a["m"], l=a["l"], a=a["a"])
    full = dict(m=a["m_full"], l=a["l_full"], a=a["a_full"])
    dep = (a["k_dep"], a["v_dep"], a["mask_dep"])
    new = (a["k_new"], a["v_new"], a["mask_new"])
    all_ = (a["k_all"], a["v_all"], a["mask_all"])
    if name == "acc_init":
        return sa.acc_init(7, 16)
    if name == "evict":
        return sa.evict(full, a["q"], *dep, 0.25)
    if name == "insert":
        return sa.insert(acc, a["q"], *new, 0.25)
    if name == "slide":
        return sa.slide(full, a["q"], *dep, *new, 0.25)
    if name == "slide_from_empty":
        return sa.slide(sa.acc_init(24, 16), a["q"], a["k_dep"], a["v_dep"],
                        to(np.zeros(6, bool)), *new, 0.25)
    if name == "init_rows":
        return sa.init_rows(a["q"], *all_, 0.25, slots=slots, slot_rows=24)
    if name == "finalize":
        return sa.finalize(acc)
    if name == "degenerate_rows":
        return sa.degenerate_rows(sa.evict(full, a["q"], *dep, 0.25),
                                  a["M"], theta=0.5)
    if name == "repair_keeps":
        return sa.repair(acc, a["M"], a["q"], *all_, 0.25, slots)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["acc_init", "evict", "insert", "slide",
                                  "slide_from_empty", "init_rows", "finalize",
                                  "degenerate_rows", "repair_keeps"])
@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_ops_match_jax(name, seed):
    """Each function, on masked slots, empty (−inf-anchored) rows and an
    all-masked slot: the port's outputs within 1e-5 of the JAX package's
    (relative to each output's scale), and no NaN."""
    x, slots = _op_inputs(seed)
    want = _leaves(jax.device_get(_op(jsa, jnp.asarray, name, x, slots)))
    got = _leaves(_op(tsa, torch.from_numpy, name, x, slots))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert not np.isnan(g).any(), (name, i)
        _close(g, w, 1e-5, f"{name} output {i}")


def test_repair_fires_on_dominant_eviction():
    """A key aligned with every query at 200× leaves: the other keys'
    contributions underflowed under its anchor, so both packages flag the
    rows, and ``repair`` rebuilds them to the direct softmax (1e-5), as
    ``tests/test_streaming_attention.py`` checks for the JAX package."""
    rng = np.random.default_rng(0)
    p, d = 4, 8
    q = rng.normal(size=(2 * p, d)).astype(np.float32)
    kA = np.concatenate([q[:1] * 200.0, rng.normal(size=(p - 1, d))]
                        ).astype(np.float32)
    vA, kB, vB, kC, vC = (rng.normal(size=(p, d)).astype(np.float32)
                          for _ in range(5))
    ones, ones2 = np.ones(p, bool), np.ones(2 * p, bool)

    def run(sa, to):
        acc, M = sa.init_rows(to(q), to(np.concatenate([kA, kB])),
                              to(np.concatenate([vA, vB])), to(ones2), 1.0,
                              slots=2)
        acc, col = sa.slide(acc, to(q), to(kA), to(vA), to(ones), to(kC),
                            to(vC), to(ones), 1.0)
        M = np.asarray(M).copy()
        M[:, 0] = np.asarray(col)
        bad = sa.degenerate_rows(acc, to(M))
        fixed, M2 = sa.repair(acc, to(M), to(q), to(np.concatenate([kC, kB])),
                              to(np.concatenate([vC, vB])), to(ones2), 1.0, 2)
        return (np.asarray(bad), np.asarray(sa.finalize(fixed)),
                np.asarray(sa.degenerate_rows(fixed, M2)))

    bad_t, out_t, after_t = run(tsa, torch.from_numpy)
    bad_j, out_j, _ = run(jsa, jnp.asarray)
    assert bad_t.any()
    np.testing.assert_array_equal(bad_t, bad_j)
    assert not after_t.any()
    _close(out_t, out_j, 1e-5)
    s = q @ np.concatenate([kC, kB]).T
    w = np.exp(s - s.max(axis=1, keepdims=True))
    direct = (w / w.sum(axis=1, keepdims=True)) @ np.concatenate([vC, vB])
    np.testing.assert_allclose(out_t, direct, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- the head
@pytest.fixture(scope="module")
def engines():
    """(JAX engine, JAX params, port engine) at T = 5 on one set of
    weights."""
    return shared_engines(seed=4, window_interval=2)


def _frame_caches(n, seed, dominant=None, factor=1.0):
    """n per-frame caches: fc1 N(0, 1) rows (frame ``dominant`` scaled by
    ``factor``), boxes, ~80 % valid masks."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fc1 = rng.normal(size=(P, D)).astype(np.float32)
        if i == dominant:
            fc1 *= factor
        out.append(dict(
            fc1=fc1, boxes=rng.uniform(5, 60, size=(P, 4)).astype(np.float32),
            scores=np.zeros(P, np.float32), mask=rng.random(P) > 0.2))
    return out


def _torch_caches(c):
    return {k: torch.from_numpy(np.array(v)) for k, v in c.items()}


def _empty_state(fc1_dim=D):
    R = T * P
    z = lambda *s: np.zeros(s, np.float32)
    ninf = lambda *s: np.full(s, -np.inf, np.float32)
    st = dict(mask=np.zeros((T, P), bool), m1=ninf(R), l1=z(R),
              a1=z(R, fc1_dim), m3=ninf(R), l3=z(R), a3=z(R, D),
              M1=ninf(R, T), M3=ninf(R, T))
    for k in ("fc1", "q1", "k1", "fc3s", "q3", "k3"):
        st[k] = z(R, D)
    return st


@pytest.mark.parametrize("rollback", [False, True])
def test_head_stream_methods_match_jax(engines, rollback):
    """``stream_update`` over 13 slides (more than two ring turnovers), then
    ``stream_forward`` at the window centre and ``stream_rebuild``: the
    port's state within 1e-5 and its logits within 1e-4 of the JAX head's
    (relative to each tensor's scale), with the same health verdicts."""
    jeng, params, port = engines
    mod, head = jeng.module, port.model.bbox_head
    bb = jeng._bb(params)
    st_j = {k: jnp.asarray(v) for k, v in _empty_state().items()}
    st_t = {k: torch.from_numpy(v.copy()) for k, v in _empty_state().items()}

    def compare(what):
        for k in st_j:
            _close(st_t[k].numpy(), jax.device_get(st_j[k]), 1e-5,
                   f"{what} {k}")

    with torch.no_grad():
        for i, c in enumerate(_frame_caches(13, seed=5)):
            slot = i % T
            upd_j = mod.apply(bb, st_j, jnp.asarray(c["fc1"]),
                              jnp.asarray(c["mask"]), slot, rollback,
                              method=mod.bbox_stream_update)
            upd_t = head.stream_update(st_t, torch.from_numpy(c["fc1"]),
                                       torch.from_numpy(c["mask"]), slot,
                                       rollback)
            if rollback:
                (st_j, bad_j), (st_t, bad_t) = upd_j, upd_t
                assert bool(bad_t) == bool(bad_j), i
            else:
                st_j, st_t = upd_j, upd_t
            compare(f"slide {i}")
            center = (slot + 1 + T // 2) % T
            fwd_j = mod.apply(bb, st_j, center, rollback,
                              method=mod.bbox_stream_forward)
            fwd_t = head.stream_forward(st_t, center, rollback)
            if rollback:
                assert bool(fwd_t[2]) == bool(fwd_j[2]), i
            for g, w in zip(fwd_t[0] + fwd_t[1],
                            list(fwd_j[0]) + list(fwd_j[1])):
                _close(g.numpy(), jax.device_get(w), 1e-4, f"logits {i}")
        st_j = mod.apply(bb, st_j, method=mod.bbox_stream_rebuild)
        head.stream_rebuild(st_t)
    compare("rebuild")


@pytest.mark.parametrize("rollback", [False, True])
def test_stream_forward_leaves_the_state_unchanged(engines, rollback):
    """The NL3 splice is temporary: after ``stream_forward`` every state
    tensor holds the same bits."""
    _, _, port = engines
    head = port.model.bbox_head
    st = {k: torch.from_numpy(v.copy()) for k, v in _empty_state().items()}
    with torch.no_grad():
        for i, c in enumerate(_frame_caches(7, seed=6)):
            head.stream_update(st, torch.from_numpy(c["fc1"]),
                               torch.from_numpy(c["mask"]), i % T)
        before = {k: v.clone() for k, v in st.items()}
        head.stream_forward(st, 3, rollback)
    for k, v in st.items():
        assert torch.equal(v, before[k]), k


# --------------------------------------------------------- the engine
def _port_engine(cfg_edit=None, window_interval=2):
    model_cfg, test_cfg = tiny_hnmb_cfg(window_interval=window_interval,
                                        proposals=P)
    if cfg_edit:
        cfg_edit(model_cfg, test_cfg)
    return HNMBRCNN(model_cfg, test_cfg, device="cpu")


def _cache_video(caches):
    """Frame dicts whose ``img`` is the frame's cache dict, for an engine
    whose ``frame_features`` returns ``img`` (``_stub_frames``)."""
    n = len(caches)
    for i, c in enumerate(caches):
        yield dict(img=_torch_caches(c), img_shape=ISH,
                   pad_shape=np.array([96.0, 128.0], np.float32),
                   scale_factor=SF,
                   key_frame_flag=0 if i == 0 else (1 if i == n - 1 else 2),
                   frame_offset=i, seg_len=n, frame_start_id=1)


def _stub_frames(monkeypatch, *engines):
    for eng in engines:
        monkeypatch.setattr(eng, "frame_features", lambda img, *_: img)


def _assert_results_close(got, want, tol):
    assert len(got) == len(want)
    total = 0
    for i, (fg, fw) in enumerate(zip(got, want)):
        assert fg is not None and len(fg) == len(fw) == 30, i
        for c, (cg, cw) in enumerate(zip(fg, fw)):
            assert cg.shape == cw.shape, (i, c, cg.shape, cw.shape)
            np.testing.assert_allclose(cg, cw, rtol=tol, atol=tol,
                                       err_msg=f"frame {i} class {c}")
            total += len(cw)
    assert total > 0


@pytest.fixture(scope="module")
def exact_and_stream():
    """Two port engines on the same seeded weights: exact and streaming."""
    exact = _port_engine()
    stream = _port_engine()
    stream.stream = True
    return exact, stream


@pytest.mark.parametrize("speculative", [True, False])
@pytest.mark.parametrize("branch", [-1, 0])
def test_stream_runner_matches_exact_runner(exact_and_stream, monkeypatch,
                                            branch, speculative):
    """13 frames (front padding, more than two ring turnovers, the tail
    drain): the streaming runner's detections within 1e-4 of the exact
    ring's, in both head branches, speculative or with the in-step
    repair."""
    exact, stream = exact_and_stream
    _stub_frames(monkeypatch, exact, stream)
    caches = _frame_caches(13, seed=7)
    want = SlidingWindowRunner(exact, branch=branch).run(
        _cache_video(caches), 13)
    runner = SlidingWindowRunner(stream, branch=branch, flush_every=4,
                                 speculative_stream=speculative)
    assert runner.speculative == speculative
    got = runner.run(_cache_video(caches), 13)
    assert runner.rebuilds == 0
    _assert_results_close(got, want, 1e-4)


def test_stream_runner_matches_jax_stream_runner(engines, monkeypatch):
    """A 12-frame uint8 video through the JAX streaming runner and the
    port's, the port fed the JAX backbone maps (as
    ``test_torch_port_slice.py`` does): the same detections per frame and
    class, boxes within 1e-3 px, scores within 1e-4."""
    jeng, params, port = engines
    n = 12
    monkeypatch.setattr(jeng, "stream", True, raising=False)
    want = JaxRunner(jeng, params, branch=-1).run(_video(n, 9, True), n)

    def from_jax_maps(img, img_shape, pad_shape):
        maps = jeng._backbone_dispatch(params, jnp.asarray(img), img_shape)
        return port.frame_post(
            *[torch.from_numpy(_nchw(m).copy()) for m in maps], img_shape,
            pad_shape)

    monkeypatch.setattr(port, "frame_features", from_jax_maps)
    monkeypatch.setattr(port, "stream", True, raising=False)
    runner = SlidingWindowRunner(port, branch=-1, flush_every=4)
    assert runner.speculative
    got = runner.run(_video(n, 9, False), n)
    total = 0
    for fw, fg in zip(want, got):
        assert len(fg) == len(fw) == 30
        for cw, cg in zip(fw, fg):
            assert cg.shape == cw.shape
            np.testing.assert_allclose(cg[:, :4], cw[:, :4], rtol=0,
                                       atol=1e-3)
            np.testing.assert_allclose(cg[:, 4], cw[:, 4], rtol=0, atol=1e-4)
            total += len(cw)
    assert total > 0


def _step_pairs(exact, stream, caches):
    """Drive the exact and the streaming ring push by push; yields
    (i, exact out, streaming state, streaming out) once the window is
    full."""
    st_e, st_s = exact.ring_reset(D), stream.ring_reset(D)
    for i, c in enumerate(caches):
        f = _torch_caches(c)
        if i < T:
            exact.ring_push(st_e, f)
            stream.ring_push(st_s, f)
            continue
        st_e, out_e = exact.ring_step(st_e, f, ISH, SF, branch=-1)
        st_s, out_s = stream.ring_step(st_s, f, ISH, SF, branch=-1)
        yield i, out_e, st_s, out_s


def _degenerate(st, theta=tsa.THETA):
    return any(bool(tsa.degenerate_rows(
        dict(m=st["m" + n], l=st["l" + n], a=st["a" + n]), st["M" + n],
        theta).any()) for n in ("1", "3"))


def _assert_dets_close(out_e, out_s, tol, what):
    (de, le, ve), (ds, ls, vs) = out_e, out_s
    np.testing.assert_allclose(ds.numpy(), de.numpy(), rtol=tol, atol=tol,
                               err_msg=what)
    np.testing.assert_array_equal(ls.numpy(), le.numpy(), err_msg=what)
    np.testing.assert_array_equal(vs.numpy(), ve.numpy(), err_msg=what)


def test_streaming_repair_fires_and_stays_exact(exact_and_stream):
    """One frame's fc1 rows ×40 dominate every attention row; when it leaves,
    the in-step repair must fire: after every slide the state is healthy,
    and the detections stay within 1e-3 of the exact ring's."""
    exact, stream = exact_and_stream
    caches = _frame_caches(12, seed=3, dominant=2, factor=40.0)
    must_fire = False
    prev = None
    for i, out_e, st_s, out_s in _step_pairs(exact, stream, caches):
        assert not _degenerate(st_s), i
        _assert_dets_close(out_e, out_s, 1e-3, str(i))
        if prev is not None:
            slot = i % T
            for n in ("1", "3"):
                others = np.delete(prev["M" + n], slot, axis=1).max(axis=1)
                must_fire |= bool(np.any(prev["m" + n] - others
                                         > tsa.THETA))
        prev = {k: st_s[k].numpy().copy() for k in ("m1", "m3", "M1", "M3")}
    assert must_fire, "the dominant frame never forced a repair"


def test_rollback_healthy_equals_in_step_repair(exact_and_stream):
    """On healthy inputs the speculative step (no repair) gives the repair
    path's detections, and its flag stays clear."""
    _, cond = exact_and_stream
    spec = _port_engine()
    spec.stream = spec.stream_rollback = True
    caches = _frame_caches(11, seed=8)
    st_c, st_s = cond.ring_reset(D), spec.ring_reset(D)
    assert "flag" in st_s and "flag" not in st_c
    for i, c in enumerate(caches):
        f = _torch_caches(c)
        if i < T:
            cond.ring_push(st_c, f)
            spec.ring_push(st_s, f)
            continue
        st_c, out_c = cond.ring_step(st_c, f, ISH, SF, branch=-1)
        st_s, out_s = spec.ring_step(st_s, f, ISH, SF, branch=-1)
        assert not bool(st_s["flag"]), i
        _assert_dets_close(out_c, out_s, 1e-4, str(i))


def test_rollback_flags_adversarial_and_rebuild_recovers(exact_and_stream):
    """A ×120 dominant frame's eviction degenerates the accumulators: under
    rollback the flag is set whenever the state is degenerate,
    ``stream_rebuild`` restores health and clears it, and afterwards the
    stream matches the exact ring again (1e-3)."""
    exact, _ = exact_and_stream
    spec = _port_engine()
    spec.stream = spec.stream_rollback = True
    caches = _frame_caches(12, seed=3, dominant=2, factor=120.0)
    flagged = degenerate_seen = compared_after = False
    for i, out_e, st_s, out_s in _step_pairs(exact, spec, caches):
        if _degenerate(st_s):
            degenerate_seen = True
            assert bool(st_s["flag"]), i
        if bool(st_s["flag"]):
            flagged = True
            spec.stream_rebuild(st_s)
            assert not bool(st_s["flag"]) and not _degenerate(st_s)
            continue
        if flagged:
            compared_after = True
            _assert_dets_close(out_e, out_s, 1e-3, str(i))
    assert flagged and degenerate_seen and compared_after


def test_ring_detect_refuses_rollback():
    """A detect alone has no state to carry the flag in."""
    eng = _port_engine()
    eng.stream = eng.stream_rollback = True
    st = eng.ring_reset(D)
    with pytest.raises(ValueError, match="ring_step"):
        eng.ring_detect(st, ISH, SF)


def _forced_rollback(model_cfg, test_cfg):
    model_cfg["bbox_head"] = dict(model_cfg["bbox_head"], stream_theta=-1.0)


def test_stream_theta_reaches_the_head():
    """The config's ``stream_theta`` is a head constructor argument, so it
    is not dropped with the keys the head does not take."""
    assert _port_engine().model.bbox_head.stream_theta == tsa.THETA
    assert _port_engine(_forced_rollback).model.bbox_head.stream_theta == -1.0


def test_runner_replay_protocol(exact_and_stream, monkeypatch):
    """With the head's threshold forced to −1 every step flags, so every
    flushed chunk is replayed exactly and followed by a rebuild: the
    results equal the exact ring's within 1e-5, and the engine's
    ``stream_rollback`` is set only while the runner runs."""
    exact, _ = exact_and_stream
    stream = _port_engine(_forced_rollback)
    stream.stream = True
    _stub_frames(monkeypatch, exact, stream)
    caches = _frame_caches(13, seed=9)
    want = SlidingWindowRunner(exact).run(_cache_video(caches), 13)
    runner = SlidingWindowRunner(stream, flush_every=4)
    assert runner.speculative
    assert "stream_rollback" not in vars(stream)
    got = runner.run(_cache_video(caches), 13)
    assert "stream_rollback" not in vars(stream)
    assert (runner.rebuilds, runner.replayed) == (4, 13)   # chunks 4+4+4+1
    _assert_results_close(got, want, 1e-5)
    stream.stream_rollback = False
    SlidingWindowRunner(stream).run(_cache_video(caches[:6]), 6)
    assert vars(stream)["stream_rollback"] is False


def test_streaming_reset_requires_full_key_coverage():
    """Keys covering 3 of the 5 cached frames: the streaming ring refuses
    (its accumulators assume every cached row is a key)."""
    def short_keys(model_cfg, test_cfg):
        test_cfg["bbox_head"]["t_dim"] = 3

    eng = _port_engine(short_keys)
    eng.stream = True
    with pytest.raises(ValueError, match="streaming ring"):
        eng.ring_reset(16)


def test_63_frame_cache_from_the_config(monkeypatch):
    """The 63-frame cache needs no engine API: frame_interval 31, t_dim 63
    and key_dim 31 in the config give a 63-frame window centred at 31 with
    all 504 rows keys, and the streaming runner matches the exact one over
    a 40-frame video (1e-4)."""
    def window_63(model_cfg, test_cfg):
        test_cfg["relation_setup"]["frame_interval"] = 31
        test_cfg["bbox_head"].update(t_dim=63, key_dim=31)

    exact, stream = _port_engine(window_63), _port_engine(window_63)
    assert (exact.window, exact.key_dim) == (63, 31)
    assert exact.model.bbox_head.t_dim == 63
    stream.stream = True
    assert stream.ring_reset(D)["fc1"].shape == (63 * P, D)
    _stub_frames(monkeypatch, exact, stream)
    caches = _frame_caches(40, seed=10)
    want = SlidingWindowRunner(exact).run(_cache_video(caches), 40)
    got = SlidingWindowRunner(stream).run(_cache_video(caches), 40)
    _assert_results_close(got, want, 1e-4)
