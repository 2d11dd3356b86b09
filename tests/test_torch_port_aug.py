"""The port's flip-augmented testing and HVRNet's multi-pass test graph
against the JAX package's, on the CPU at the tiny configs: the box
mappings, ``core/merge_augs.py``, ``MultiScaleFlipAug``, the aug frame
program and window detection, the runner with ``aug=True``, and
``forward_fc1_multi_passes`` with the engine's ``multi_pass``.

Tolerances, each stated at its test:
- box mappings, merged masks and box means: equal; ``merge_aug_proposals``
  the same picks (tied scores included) and the same zeroed rows.
- ``MultiScaleFlipAug``: equal images and metas.
- aug frame program fed the JAX backbone maps: merged boxes within 1e-3
  px, masks equal, fc1 within 1e-4 (``tests/test_torch_port_backbone.py:
  test_frame_post_matches_jax``'s limits).
- ``window_detect_aug`` on seeded fc1 stacks: labels and masks equal,
  scores within 1e-5, boxes within 1e-4 px.
- ``forward_fc1_multi_passes``: within 1e-5 of max|logit|.
- the multi-pass window, and the aug runner fed the JAX backbone maps:
  the limits of the ring (``tests/test_torch_port_lanes.py:
  test_batched_ring_matches_jax``: boxes 1e-3 px, scores 1e-4); HVRNet's
  aug runner end to end, through both backbones, the CLIs' (``tests/
  test_torch_port_cli.py``: scores 1e-4, boxes 1e-4 of the image scale).

JAX references are computed once per module in fixtures.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.core import merge_augs as j_merge
from hvrnet_tpu.data import pipelines as j_pipelines
from hvrnet_tpu.engine import SlidingWindowRunner as JaxRunner
from hvrnet_tpu.ops import boxes as j_boxes
from hvrnet_tpu_torch.core import merge_augs
from hvrnet_tpu_torch.data import pipelines
from hvrnet_tpu_torch.engine import SlidingWindowRunner, detector
from hvrnet_tpu_torch.engine.stream import mirrored
from hvrnet_tpu_torch.ops import boxes
from tests.test_ops_nms import rand_dets
from tests.test_torch_port_backbone import (CANVAS, PAD_SHAPE, _nchw,
                                            normalized, shared_engines,
                                            uint8_frame)
from tests.test_torch_port_cli import match_rows
from tests.test_torch_port_lanes import tiny_selsa_engines

torch.set_num_threads(2)

ISH = np.array([86.0, 122.0], np.float32)
SF = np.array([0.75, 0.8, 0.75, 0.8], np.float32)
FLIPS = (False, True)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, JAX params, port engine) per model on one set of
    calibrated weights: SELSA and HVRNet at T = 3, HVRNet at T = 9 for the
    multi-pass graph."""
    return {"selsa": tiny_selsa_engines(), "hnmb": shared_engines(seed=7),
            "hnmb9": shared_engines(seed=8, window_interval=4)}


# --------------------------------------------------------- box mappings
@pytest.mark.parametrize("flip", [False, True])
def test_box_mappings_equal_jax(flip):
    """``bbox_flip`` (the +1 convention, w = img_shape[1]), ``bbox_mapping``
    and ``bbox_mapping_back`` on (N, 4) and class-specific (N, 8) boxes:
    equal to JAX's."""
    rng = np.random.default_rng(int(flip))
    b4 = rand_dets(rng, 50)[0] * 1.3
    b8 = np.concatenate([b4, rand_dets(rng, 50)[0]], axis=1)
    for b in (b4, b8):
        np.testing.assert_array_equal(
            boxes.bbox_flip(_t(b), ISH).numpy(),
            np.asarray(j_boxes.bbox_flip(jnp.asarray(b), jnp.asarray(ISH))))
    for fn, jfn in ((boxes.bbox_mapping, j_boxes.bbox_mapping),
                    (boxes.bbox_mapping_back, j_boxes.bbox_mapping_back)):
        np.testing.assert_array_equal(
            fn(_t(b4), ISH, SF, flip).numpy(),
            np.asarray(jfn(jnp.asarray(b4), jnp.asarray(ISH),
                           jnp.asarray(SF), flip)))
    back = boxes.bbox_mapping_back(boxes.bbox_mapping(_t(b4), ISH, SF, flip),
                                   ISH, SF, flip)
    np.testing.assert_allclose(back.numpy(), b4, rtol=1e-6, atol=1e-4)


# ----------------------------------------------------------- merge_augs
def _aug_proposals(seed, ties):
    """Two augmentations' (40, 5) proposals with masks, the second in
    flipped coordinates; scores rounded to one decimal make ties."""
    rng = np.random.default_rng(seed)
    props, masks = [], []
    for _ in FLIPS:
        b = rand_dets(rng, 40)[0] * 1.5
        s = rng.uniform(0, 1, 40).astype(np.float32)
        if ties:
            s = np.round(s, 1).astype(np.float32)
        m = rng.uniform(size=40) > 0.2
        props.append(np.concatenate([b * m[:, None], (s * m)[:, None]], 1))
        masks.append(m)
    metas = [dict(img_shape=ISH, scale_factor=SF, flip=f) for f in FLIPS]
    return props, masks, metas


@pytest.mark.parametrize("ties", [False, True])
def test_merge_aug_proposals_equal_jax(ties):
    """80 rows of two augmentations to 24 at IoU 0.7: the same picks in
    the same order as JAX's (tied scores take the lower row, as
    ``lax.top_k``), dropped slots all zero, their score included."""
    props, masks, metas = _aug_proposals(3 + ties, ties)
    cfg = dict(nms_thr=0.7, max_num=24)
    jm = [dict(m, img_shape=jnp.asarray(ISH), scale_factor=jnp.asarray(SF))
          for m in metas]
    want, wkeep = j_merge.merge_aug_proposals(
        [jnp.asarray(p) for p in props], jm, cfg,
        [jnp.asarray(m) for m in masks])
    got, keep = merge_augs.merge_aug_proposals(
        [_t(p) for p in props], metas, cfg, [_t(m) for m in masks])
    np.testing.assert_array_equal(keep.numpy(), np.asarray(wkeep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(keep.sum()) < 24 or bool(keep.all())
    assert not got.numpy()[~keep.numpy()].any()


def test_merge_aug_bboxes_scores_masks_equal_jax():
    """``merge_aug_bboxes`` (boxes mapped back and averaged, scores
    averaged; without scores None), ``merge_aug_scores`` and the host
    ``merge_aug_masks`` (flipped masks unflipped, plain and weighted
    means): equal to JAX's."""
    rng = np.random.default_rng(9)
    bxs = [rand_dets(rng, 30)[0] for _ in FLIPS]
    scs = [rng.dirichlet(np.ones(5), 30).astype(np.float32) for _ in FLIPS]
    metas = [dict(img_shape=ISH, scale_factor=SF, flip=f) for f in FLIPS]
    jb, js = j_merge.merge_aug_bboxes([jnp.asarray(b) for b in bxs],
                                      [jnp.asarray(s) for s in scs], metas)
    gb, gs = merge_augs.merge_aug_bboxes([_t(b) for b in bxs],
                                         [_t(s) for s in scs], metas)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(js))
    assert merge_augs.merge_aug_bboxes([_t(b) for b in bxs], None,
                                       metas)[1] is None
    np.testing.assert_array_equal(
        merge_augs.merge_aug_scores([_t(s) for s in scs]).numpy(),
        np.asarray(j_merge.merge_aug_scores([jnp.asarray(s) for s in scs])))
    masks = [rng.uniform(size=(3, 7, 9)).astype(np.float32) for _ in FLIPS]
    for weights in (None, [0.25, 0.75]):
        np.testing.assert_array_equal(
            merge_augs.merge_aug_masks(masks, metas, weights=weights),
            j_merge.merge_aug_masks(masks, metas, weights=weights))


# ------------------------------------------------------ MultiScaleFlipAug
AUG_TRANSFORMS = [
    dict(type="Resize", keep_ratio=True),
    dict(type="RandomFlip"),
    dict(type="Normalize", mean=[103.06, 115.90, 123.15], std=[1.0, 1.0, 1.0],
         to_rgb=False),
    dict(type="Pad", size_divisor=16),
    dict(type="ImageToTensor", keys=["img"]),
    dict(type="Collect", keys=["img"]),
]


def test_multi_scale_flip_aug_equals_jax():
    """Two scales × flip on a 45×70 image: four augmentations, scales
    outer, unflipped first, each image and meta equal to JAX's (the
    port's resize is bit for bit cv2's); built from a config, not
    refused."""
    img = np.random.default_rng(2).integers(0, 256, (45, 70, 3), np.uint8)
    cfg = dict(type="MultiScaleFlipAug", img_scale=[(96, 64), (60, 40)],
               flip=True, transforms=AUG_TRANSFORMS)
    got = pipelines.build_transform(cfg)(dict(img=img, img_shape=img.shape,
                                              ori_shape=img.shape))
    want = j_pipelines.build_transform(cfg)(dict(img=img,
                                                 img_shape=img.shape,
                                                 ori_shape=img.shape))
    assert len(got) == len(want) == 4
    assert [g["img_meta"]["flip"] for g in got] == [False, True] * 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["img"], w["img"])
        for key in ("img_shape", "pad_shape", "flip"):
            assert tuple(np.atleast_1d(g["img_meta"][key])) == \
                tuple(np.atleast_1d(w["img_meta"][key]))
        np.testing.assert_array_equal(g["img_meta"]["scale_factor"],
                                      w["img_meta"]["scale_factor"])


# --------------------------------------------------- the aug frame program
def _aug_frame(engine, rng, ish=ISH):
    """One normalised frame on the canvas and its mirror within the valid
    width: the runner's ``img_augs``."""
    img = normalized(engine, uint8_frame(rng, ish), ish)
    return [img, mirrored(dict(img=img, img_shape=ish))]


def test_mirror_flips_only_the_valid_width():
    """``mirrored``: columns [0, round(img_shape[1])) reversed, the pad to
    the right of them untouched, the input unchanged."""
    img = np.random.default_rng(0).normal(size=(1, 4, 9, 3)).astype(
        np.float32)
    keep = img.copy()
    out = mirrored(dict(img=img, img_shape=np.float32([4.0, 6.4])))
    np.testing.assert_array_equal(out[:, :, :6], keep[:, :, 5::-1])
    np.testing.assert_array_equal(out[:, :, 6:], keep[:, :, 6:])
    np.testing.assert_array_equal(img, keep)


@pytest.mark.parametrize("kind", ["selsa", "hnmb"])
def test_frame_features_aug_matches_jax(engines, kind):
    """A frame and its mirror through the JAX aug frame program; from the
    JAX backbone maps of the pair the port's ``frame_post_aug``: the merged
    boxes within 1e-3 px in original coordinates, masks equal, each
    augmentation's fc1 within 1e-4.  The port's whole ``frame_features_aug``
    (its own backbone) gives the same mask and boxes within 1e-4 of the
    canvas width."""
    jeng, params, port = engines[kind]
    imgs = _aug_frame(port, np.random.default_rng(31))
    ishs, pshs, sfs = [ISH] * 2, [PAD_SHAPE] * 2, [SF] * 2
    want = jax.device_get(jeng.frame_features_aug(
        params, [jnp.asarray(i) for i in imgs], ishs, pshs, sfs, FLIPS))
    maps = jeng._frame_backbone_fn(*CANVAS)(params,
                                            jnp.asarray(np.concatenate(imgs)))
    got = port.frame_post_aug(*[_t(_nchw(m).copy()) for m in maps], ishs,
                              pshs, sfs, FLIPS)
    assert got["fc1"].shape == want["fc1"].shape
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert want["mask"].sum() > 0
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["fc1"].numpy(), want["fc1"], rtol=1e-4,
                               atol=1e-4)
    whole = port.frame_features_aug(imgs, ishs, pshs, sfs, FLIPS)
    np.testing.assert_array_equal(whole["mask"].numpy(), want["mask"])
    np.testing.assert_allclose(whole["boxes"].numpy(), want["boxes"],
                               rtol=0, atol=1e-4 * CANVAS[1])


# ---------------------------------------------------- window_detect_aug
def _aug_window(seed, T, P, D=1024):
    rng = np.random.default_rng(seed)
    fc1 = rng.normal(size=(2, T, P, D)).astype(np.float32)
    xy = rng.uniform(0, 70, (T, P, 2))
    wh = rng.uniform(5, 40, (T, P, 2))
    bxs = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    masks = rng.random((T, P)) > 0.2
    return fc1, bxs, masks


@pytest.mark.parametrize("kind,branch", [("selsa", None), ("hnmb", None),
                                         ("hnmb", 0)])
def test_window_detect_aug_matches_jax(engines, kind, branch):
    """Seeded (2, T, P, D) fc1 stacks of a frame and its mirror, merged
    boxes and masks: the port's ``window_detect_aug`` against JAX's —
    labels and masks equal, scores within 1e-5, boxes within 1e-4 px.  On
    HVRNet ``branch=None`` is the final branch alone, as in JAX."""
    jeng, params, port = engines[kind]
    fc1, bxs, masks = _aug_window(41, port.window, port.proposal_num)
    ishs, sfs = [ISH] * 2, [SF] * 2
    wd, wl, wm = jax.device_get(jeng.window_detect_aug(
        params, jnp.asarray(fc1), jnp.asarray(bxs), jnp.asarray(masks), ishs,
        sfs, FLIPS, branch=branch))
    gd, gl, gm = port.window_detect_aug(_t(fc1), _t(bxs), _t(masks), ishs,
                                        sfs, FLIPS, branch=branch)
    np.testing.assert_array_equal(gm.numpy(), wm)
    assert wm.sum() > 0
    np.testing.assert_array_equal(gl.numpy()[wm], wl[wm])
    np.testing.assert_allclose(gd.numpy()[wm][:, 4], wd[wm][:, 4], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gd.numpy()[wm][:, :4], wd[wm][:, :4], rtol=0,
                               atol=1e-4)


# ------------------------------------------------------------ multi-pass
@pytest.fixture(scope="module")
def multi_pass_window(engines):
    """A seeded T = 9 window of 8 proposals a frame and the JAX HVRNet
    engine's multi-pass head outputs and detections on it (3 passes of 3
    frames), per branch argument."""
    jeng, params, port = engines["hnmb9"]
    rng = np.random.default_rng(51)
    T, P = port.window, port.proposal_num
    fc1, bxs, masks = _aug_window(52, T, P)
    fc1 = fc1[0]
    mod = jeng.module
    head = {}
    for b in (1, 2):
        lanes = rng.normal(size=(b, T * P, 1024)).astype(np.float32)
        valid = rng.random((b, T * P)) > 0.2
        head[b] = (lanes, valid, [jax.device_get(mod.apply(
            jeng._bb(params), jnp.asarray(lanes[i]), T // 3 * P,
            jeng.key_dim * P, P, jnp.asarray(valid[i]),
            method=mod.bbox_forward_fc1_multi_pass)) for i in range(b)])
    jeng.multi_pass = 3
    try:
        dets = {branch: jax.device_get(jeng.window_detect(
            params, jnp.asarray(fc1), jnp.asarray(bxs), jnp.asarray(masks),
            ISH, SF, branch=branch)) for branch in (None, 0)}
    finally:
        jeng.multi_pass = None
    return dict(fc1=fc1, boxes=bxs, masks=masks, head=head, dets=dets)


@pytest.mark.parametrize("lanes", [1, 2])
def test_forward_fc1_multi_passes_matches_jax(engines, multi_pass_window,
                                              lanes):
    """The multi-pass graph over 72 rows in 3 passes of 24, the key frame's
    8 rows at 32: one (cls, reg) pair within 1e-5 of max|logit| of JAX's,
    as a 2-D call and over a lane axis (2 lanes, each its own mask)."""
    jeng, _, port = engines["hnmb9"]
    P = port.proposal_num
    fc1, valid, want = multi_pass_window["head"][lanes]
    head = port.model.bbox_head
    args = (3 * P, port.key_dim * P, P)
    with torch.no_grad():
        if lanes == 1:
            got = [head.forward_fc1_multi_passes(_t(fc1[0]), *args,
                                                 _t(valid[0]))]
        else:
            cls, reg = head.forward_fc1_multi_passes(_t(fc1), *args,
                                                     _t(valid))
            got = [([c[i] for c in cls], [r[i] for r in reg])
                   for i in range(lanes)]
    for (gc, gr), (wc, wr) in zip(got, want):
        assert len(gc) == len(wc) == 1
        for g, w in ((gc[0], wc[0]), (gr[0], wr[0])):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("branch", [None, 0])
def test_multi_pass_window_detect_matches_jax(engines, multi_pass_window,
                                              branch):
    """HVRNet's ``window_detect`` with ``multi_pass = 3`` at T = 9: one
    (dets, labels, mask) triple whatever ``branch`` is, labels and masks
    equal to JAX's, boxes within 1e-3 px, scores within 1e-4; a
    ``multi_pass`` that does not divide the window raises."""
    _, _, port = engines["hnmb9"]
    w = multi_pass_window
    port.multi_pass = 3
    try:
        got = port.window_detect(_t(w["fc1"]), _t(w["boxes"]),
                                 _t(w["masks"]), ISH, SF, branch=branch)
        port.multi_pass = 2
        with pytest.raises(ValueError, match="does not divide"):
            port.window_detect(_t(w["fc1"]), _t(w["boxes"]), _t(w["masks"]),
                               ISH, SF, branch=branch)
    finally:
        port.multi_pass = None
    assert isinstance(got, tuple)
    (gd, gl, gm), (wd, wl, wm) = got, w["dets"][branch]
    np.testing.assert_array_equal(gm.numpy(), wm)
    assert wm.sum() > 0
    np.testing.assert_array_equal(gl.numpy()[wm], wl[wm])
    np.testing.assert_allclose(gd.numpy()[wm][:, :4], wd[wm][:, :4], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(gd.numpy()[wm][:, 4], wd[wm][:, 4], rtol=0,
                               atol=1e-4)


def test_streaming_ring_refuses_multi_pass(engines):
    """A streaming engine with ``multi_pass`` set raises ``ValueError``
    (not an assert) at its ring reset and, on a ring made before, at its
    step: it would serve the single-pass graph."""
    _, _, port = engines["hnmb9"]
    P = port.proposal_num
    feats = dict(fc1=torch.zeros(P, 1024), boxes=torch.zeros(P, 4),
                 mask=torch.ones(P, dtype=torch.bool))
    port.stream = True
    try:
        ring = port.ring_reset(1024)
        port.multi_pass = 3
        with pytest.raises(ValueError, match="multi-pass"):
            port.ring_reset(1024)
        with pytest.raises(ValueError, match="multi-pass"):
            port.ring_step(ring, feats, ISH, SF)
    finally:
        port.stream = False
        port.multi_pass = None


# ----------------------------------------------------------- the runner
N_RUN = 6


def _aug_stream(engine, seed, aug=True, jax_arrays=False):
    """A 6-frame video of normalised frames (and with ``aug`` their
    mirrors) in the runner's format."""
    rng = np.random.default_rng(seed)
    wrap = jnp.asarray if jax_arrays else (lambda x: x)
    for i in range(N_RUN):
        img = normalized(engine, uint8_frame(rng), ISH)
        frame = dict(img=wrap(img), img_shape=ISH, pad_shape=PAD_SHAPE,
                     scale_factor=SF,
                     key_frame_flag=0 if i == 0 else (1 if i == N_RUN - 1
                                                      else 2),
                     frame_offset=i, seg_len=N_RUN, frame_start_id=1)
        if aug:
            frame["img_augs"] = [wrap(img), wrap(mirrored(
                dict(img=img, img_shape=ISH)))]
            frame["flips"] = FLIPS
        yield frame


def _assert_runs_close(got, want, score_tol, box_tol=1e-4 * CANVAS[1]):
    total = 0
    for fg, fw in zip(got, want):
        assert fg is not None and len(fg) == len(fw) == 30
        for cg, cw in zip(fg, fw):
            assert cg.shape == cw.shape
            if len(cw):
                match_rows(cg, cw, box_tol, score_tol)
            total += len(cw)
    assert total > 0


@contextlib.contextmanager
def jax_maps(jeng, params):
    """Port engines take their backbone maps from the JAX engine's frame
    program on the same canvases (as ``tests/test_torch_port_cli.py:
    jax_backbone`` does from a checkpoint)."""
    def maps(self, img, img_shape):
        out = jeng._backbone_dispatch(params, jnp.asarray(np.asarray(img)),
                                      img_shape)
        return tuple(_t(_nchw(m)) for m in out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(detector.BaseEngine, "backbone_maps", maps)
        yield


@pytest.fixture(scope="module")
def jax_aug_runs(engines):
    """The JAX runner with ``aug=True`` over the 6-frame video, per model."""
    runs = {}
    for kind in ("selsa", "hnmb"):
        jeng, params, port = engines[kind]
        runs[kind] = JaxRunner(jeng, params, aug=True).run(
            _aug_stream(port, 61, jax_arrays=True), N_RUN)
    return runs


@pytest.mark.parametrize("kind,backbone", [("selsa", "jax"), ("hnmb", "jax"),
                                           ("hnmb", "port")])
def test_aug_runner_matches_jax(engines, jax_aug_runs, kind, backbone):
    """The port's runner with ``aug=True`` against the JAX runner's on the
    same frames, per frame and class the same detections: fed the JAX
    backbone maps (``backbone`` "jax") within the ring's limits (boxes 1e-3
    px, scores 1e-4); HVRNet end to end, its own backbone, within the
    CLIs' end-to-end limits (scores 1e-4, boxes 1e-4 of the canvas width).
    SELSA end to end is held on the VID tree by
    ``tests/test_torch_port_cli_aug.py``: on these frames the two
    backbones' rounding flips a class-wise NMS decision between two boxes
    at IoU ≈ 0.3 whose scores differ by 2.4e-5 (frame 0), which the JAX
    maps remove."""
    jeng, params, port = engines[kind]
    runner = SlidingWindowRunner(port, aug=True)
    with (jax_maps(jeng, params) if backbone == "jax"
          else contextlib.nullcontext()):
        got = runner.run(_aug_stream(port, 61), N_RUN)
    assert not runner.speculative
    if backbone == "jax":
        _assert_runs_close(got, jax_aug_runs[kind], 1e-4, 1e-3)
    else:
        _assert_runs_close(got, jax_aug_runs[kind], 1e-4)


def test_duplicate_augs_equal_the_plain_runner(engines):
    """Two identical unflipped augmentations: the merge keeps the frame's
    own proposals and the means are the plain values, so the detections
    equal the plain runner's within the ring's limits (boxes 1e-3 px,
    scores 1e-4)."""
    _, _, port = engines["hnmb"]
    plain = SlidingWindowRunner(port).run(_aug_stream(port, 62, aug=False),
                                          N_RUN)

    def duplicated():
        for f in _aug_stream(port, 62, aug=False):
            yield dict(f, img_augs=[f["img"], f["img"]], flips=(False, False))

    dup = SlidingWindowRunner(port, aug=True).run(duplicated(), N_RUN)
    _assert_runs_close(dup, plain, 1e-4, 1e-3)


@pytest.mark.parametrize("option", ["prepad_provider", "pair_features"])
def test_aug_runner_refuses_what_it_cannot_combine(engines, option):
    """``aug`` with random pre-padding, or with pair features > 1, raises
    ``ValueError`` when the runner is made."""
    _, _, port = engines["hnmb"]
    kw = {"prepad_provider": lambda frame: [], "pair_features": 2}[option]
    with pytest.raises(ValueError, match="do not combine"):
        SlidingWindowRunner(port, aug=True, **{option: kw})
