"""The port's multi-device paths against the JAX package's, on the CPU at
the tiny configs: the K/V-sharded attention and the head's sharded route,
the lockstep lanes split over replicas (``enable_spmd_lanes``), the
data-parallel training step over gloo ranks, the training sample order by
rank, ``steps_per_epoch``, the dense trainers' refusal, the training CLI's
``--n-devices`` and the port's ``dryrun_multichip``.  The JAX package runs
on ``tests/conftest.py``'s 8 CPU devices; the port's ranks are spawned
processes (each test's within a timeout), its replicas CPU "devices".

Tolerances, each stated at its test:
- ``masked_attention_kv_sharded``: rtol and atol 2e-5 of the JAX function
  (``tests/test_attention.py:52``);
- the window head with the sharded route: 1e-4 (``tests/test_attention.py:
  73``), against JAX's sharded head and the port's unsharded one;
- the lanes: the frame program fed the JAX program's maps, the picks
  (slots, masks) equal, boxes within 1e-3 px, scores within 1e-6, fc1
  within 1e-4 (``tests/test_torch_port_lanes.py``); the ring's detections
  with masks and labels equal, boxes within 1e-3 px and scores within
  1e-4 of JAX's; and bit for bit the unsharded port engine run on each
  replica's lanes;
- the data-parallel step: the ranks' parameters equal bit for bit, and
  within ``dryrun.PARAM_TOL`` (1e-6 of max(1, |w|)) of one process that
  averages the ranks' gradients.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu.engine import SelsaRCNN as JaxSelsaRCNN
from hvrnet_tpu.engine.stream import train_batch_iterator as jax_iterator
from hvrnet_tpu.ops.attention import \
    masked_attention_kv_sharded as j_kv_sharded
from hvrnet_tpu.parallel.mesh import make_mesh as j_mesh
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine import single_stage
from hvrnet_tpu_torch.engine import train as port_train
from hvrnet_tpu_torch.engine.stream import train_batch_iterator
from hvrnet_tpu_torch.engine.train_fcos import FCOSTrainer, FoveaTrainer
from hvrnet_tpu_torch.engine.train_guided_anchor import GATrainer
from hvrnet_tpu_torch.engine.train_reppoints import RepPointsTrainer
from hvrnet_tpu_torch.engine.train_single_stage import (FreeAnchorTrainer,
                                                        RetinaTrainer,
                                                        SSDTrainer)
from hvrnet_tpu_torch.ops.attention import (NEG_INF, attention_plain,
                                            masked_attention_kv_sharded,
                                            pad_keys)
from hvrnet_tpu_torch.parallel import dryrun
from hvrnet_tpu_torch.parallel.mesh import rank_seed
from hvrnet_tpu_torch.tools import train as train_cli
from hvrnet_tpu_torch.data.vid_dataset import build_dataset
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.utils.checkpoint import load_checkpoint
from hvrnet_tpu_torch.utils.config import Config, unwrap
from tests.test_engine_selsa import tiny_selsa_cfg
from tests.test_torch_port_backbone import (CANVAS, PAD_SHAPE, normalized,
                                            shared_engines, uint8_frame)
from tests.test_torch_port_lanes import _check_post, tiny_selsa_engines
from tests.test_torch_port_train_cli import scaled, write_config
from tests.test_torch_port_train_data import (
    assert_generators_at_jax_globals, build_train_tree, first_skip_seed,
    paired, vid_cfg)
from tests.test_torch_port_data import build_tree
from tests.test_train_step import tiny_train_cfg

torch.set_num_threads(2)

TIMEOUT = 120.0          # each spawned run of ranks


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------ kv-sharded attention
def _attn_inputs(seed, nq, nk, d=128):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(n, d)).astype(np.float32)
               for n in (nq, nk, nk))
    bias = np.where(rng.random(nk) < 0.1, NEG_INF, 0.0).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("n,nk", [(2, 301), (4, 1894)])
def test_kv_sharded_attention_matches_jax(n, nk):
    """K/V over 2 and 4 shards with a key count neither divides, padded
    with −1e30-biased zero keys as the JAX head pads: within 2e-5 of the
    JAX function on a mesh of as many CPU devices; with a lane axis, each
    lane the 2-D call's."""
    q, k, v, bias = _attn_inputs(n, 77, nk)
    jk, jv, jb = (_t(x) for x in (k, v, bias))
    kp, vp, bp = pad_keys(jk, jv, jb, n)
    assert kp.shape[0] % n == 0 and kp.shape[0] - nk < n
    want = np.asarray(j_kv_sharded(*map(jnp.asarray, (q, kp.numpy(),
                                                      vp.numpy(),
                                                      bp.numpy())),
                                   0.088, j_mesh(n)))
    got = masked_attention_kv_sharded(_t(q), kp, vp, bp, 0.088, ["cpu"] * n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got.numpy(), attention_plain(_t(q), jk, jv, jb, 0.088).numpy(),
        rtol=2e-5, atol=2e-5)
    lanes = masked_attention_kv_sharded(
        *(torch.stack([x, x.flip(0)]) for x in (_t(q), kp, vp, bp)), 0.088,
        ["cpu"] * n)
    assert torch.equal(lanes[0], got)


@pytest.fixture(scope="module")
def hnmb():
    return shared_engines(seed=3)


@pytest.fixture(scope="module")
def selsa():
    return tiny_selsa_engines()


@pytest.mark.parametrize("kind", ["selsa", "hnmb"])
def test_engine_kv_sharded_attention_matches_jax(kind, selsa, hnmb):
    """``enable_kv_sharded_attention`` over 8 CPU devices (the T·P = 3·8 =
    24 keys of NL1 divide, NL2's 8 key rows of HVRNet's... every block
    padded where they do not) against the JAX engine's over its 8-device
    mesh, and against the port's unsharded head, on one window of crafted
    caches: within 1e-4 (``tests/test_attention.py:73``); the weights
    stay as they were."""
    jeng, params, port = selsa if kind == "selsa" else hnmb
    rng = np.random.default_rng(4)
    T, P = port.window, port.proposal_num
    fc1 = rng.normal(size=(T, P, 1024)).astype(np.float32)
    boxes = np.concatenate([rng.random((T, P, 2)) * 40,
                            40 + rng.random((T, P, 2)) * 40],
                           axis=-1).astype(np.float32)
    masks = rng.random((T, P)) < 0.9
    ish, sf = np.array([86.0, 118.0], np.float32), np.ones(4, np.float32)
    branch = -1 if kind == "hnmb" else None
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    base = port.window_detect(_t(fc1), _t(boxes), _t(masks), ish, sf,
                              branch)
    port.enable_kv_sharded_attention(["cpu"] * 8)
    try:
        got = port.window_detect(_t(fc1), _t(boxes), _t(masks), ish, sf,
                                 branch)
    finally:
        port.enable_kv_sharded_attention(None)
    sharded = JaxHNMBRCNN if kind == "hnmb" else JaxSelsaRCNN
    jsh = sharded(jeng.model_cfg, None, jeng.test_cfg)
    jsh.enable_kv_sharded_attention(j_mesh(8))
    want = jax.device_get(jsh.window_detect(
        params, jnp.asarray(fc1), jnp.asarray(boxes), jnp.asarray(masks),
        ish, sf, branch=branch))
    assert all(torch.equal(v, before[k])
               for k, v in port.model.state_dict().items())
    for g, b, w in zip(got, base, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.float().numpy(), b.float().numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert got[2].sum() > 0


# -------------------------------------------------------------- spmd lanes
SHAPES = np.array([[86.0, 122.0], [70.0, 96.0], [96.0, 64.0],
                   [80.0, 110.0]], np.float32)


def _ring_caches(step, B, P, D=1024, seed=21):
    rng = np.random.default_rng(seed + step)
    return dict(fc1=rng.normal(size=(B, P, D)).astype(np.float32),
                boxes=np.sort(rng.uniform(2, 60, (B, P, 4)),
                              axis=-1).astype(np.float32),
                mask=rng.random((B, P)) > 0.2)


@pytest.mark.parametrize("n,B", [(2, 2), (2, 4), (4, 4)])
def test_spmd_lanes_match_jax(n, B, selsa, monkeypatch):
    """B lockstep lanes over n replicas against the JAX engine with
    ``enable_spmd_lanes`` over an n-device mesh.  Frame program, fed the
    JAX sharded program's backbone maps: the picks (slots, masks) equal,
    boxes within 1e-3 px, scores within 1e-6, fc1 within 1e-4; and bit for
    bit the unsharded port engine on the same maps.  Ring, 4 pushes of
    crafted caches (every lane reset first, lane 1 again at step 2), a
    detection at steps 1-3: masks and labels equal to JAX's, boxes within
    1e-3 px and scores within 1e-4; bit for bit the unsharded port engine
    run on each replica's lanes alone."""
    jeng, params, port = selsa
    model_cfg, test_cfg = tiny_selsa_cfg(window_interval=1, proposals=8)
    jspmd = JaxSelsaRCNN(model_cfg, None, test_cfg)
    mesh = j_mesh(n)
    jspmd.enable_spmd_lanes(mesh)
    rng = np.random.default_rng(30 + 10 * n + B)
    ishs = SHAPES[:B]
    pshs = np.tile(PAD_SHAPE, (B, 1))
    imgs = np.concatenate([normalized(port, uint8_frame(rng, ish), ish)
                           for ish in ishs])
    want = jax.device_get(jspmd.frame_features_batched(
        params, jnp.asarray(imgs), ishs, pshs))
    maps = [torch.from_numpy(np.asarray(m).transpose(0, 3, 1, 2).copy())
            for m in jspmd._frame_backbone_spmd_fn(*CANVAS, mesh)(
                params, jnp.asarray(imgs))]
    lane_of = {imgs[b].tobytes(): b for b in range(B)}

    def injected(img, img_shape):
        lanes = [lane_of[np.asarray(f).tobytes()] for f in img]
        return tuple(m[lanes] for m in maps)

    monkeypatch.setattr(port, "backbone_maps", injected)
    port.enable_spmd_lanes(["cpu"] * n)
    try:
        got = port.frame_features_batched(imgs, ishs, pshs)
        assert len(got) == n
        _check_post(got, want, 1e-4, lambda fc1: 1e-4)
        P, D = port.proposal_num, 1024
        sfs = np.full((B, 4), 0.8, np.float32)
        jstate = jspmd.ring_reset_batched(B, D)
        state = port.ring_reset_batched(B, D)
        outs = []
        for step in range(4):
            c = _ring_caches(step, B, P)
            reset = np.full(B, step == 0)
            reset[1] |= step == 2
            jstate = jspmd.ring_push_batched(
                jstate, {k: jnp.asarray(v) for k, v in c.items()}, reset)
            state = port.ring_push_batched(state, {k: _t(v) for k, v in
                                                   c.items()}, reset)
            if step == 0:
                continue
            wd, wl, wm = jax.device_get(jspmd.ring_detect_batched(
                params, jstate, ishs, sfs))
            gd, gl, gm = port.ring_detect_batched(state, ishs, sfs)
            np.testing.assert_array_equal(gm.numpy(), wm)
            np.testing.assert_array_equal(gl.numpy()[wm], wl[wm])
            np.testing.assert_allclose(gd.numpy()[wm][:, :4],
                                       wd[wm][:, :4], rtol=0, atol=1e-3)
            np.testing.assert_allclose(gd.numpy()[wm][:, 4], wd[wm][:, 4],
                                       rtol=0, atol=1e-4)
            assert wm.sum() > 0
            outs.append((gd, gl, gm))
    finally:
        port.enable_spmd_lanes(None)
    plain = port.frame_features_batched(imgs, ishs, pshs)
    assert all(torch.equal(got[k], v) for k, v in plain.items())
    per = B // n
    states = [port.ring_reset_batched(per, D) for _ in range(n)]
    for step in range(4):
        c = _ring_caches(step, B, P)
        reset = np.full(B, step == 0)
        reset[1] |= step == 2
        for i in range(n):
            lanes = slice(i * per, (i + 1) * per)
            states[i] = port.ring_push_batched(
                states[i], {k: _t(v[lanes]) for k, v in c.items()},
                reset[lanes])
        if step:
            alone = [port.ring_detect_batched(
                states[i], ishs[i * per:(i + 1) * per],
                sfs[i * per:(i + 1) * per]) for i in range(n)]
            for j, got_t in enumerate(outs[step - 1]):
                assert torch.equal(got_t, torch.cat([a[j] for a in alone]))


def test_spmd_lanes_need_a_divisible_batch(selsa):
    """3 lanes over 2 replicas raise the JAX engine's ``ValueError``."""
    _, _, port = selsa
    port.enable_spmd_lanes(["cpu", "cpu"])
    try:
        imgs = np.zeros((3,) + CANVAS + (3,), np.float32)
        with pytest.raises(ValueError, match="mesh.size"):
            port.frame_features_batched(imgs, SHAPES[:3], SHAPES[:3])
        with pytest.raises(ValueError, match="mesh.size"):
            port.ring_reset_batched(3, 1024)
    finally:
        port.enable_spmd_lanes(None)


# ----------------------------------------------------------- data parallel
def selsa_spec(seed=0):
    """SELSA's tiny training spec: one sampler, 3 frames per rank."""
    return dict(model_cfg=dryrun.tiny_model_cfg("SelsaBBoxHead",
                                                sampler_num=8, t_dim=3),
                train_cfg=dryrun.tiny_train_cfg(),
                cfg=dict(optimizer=dict(lr=1e-3, momentum=0.9,
                                        weight_decay=1e-4)),
                seed=seed, make_sample=dryrun.tiny_sample,
                sample_args=[(r, 3) for r in range(8)])


@pytest.mark.parametrize("kind", ["selsa"])
def test_data_parallel_step_is_the_mean_gradient_step(kind, tmp_path):
    """One ``SelsaTrainer`` step over 2 gloo ranks (spawned, 2 threads
    each, as this process), each rank on its own sample with its own
    sampler seed: the ranks' parameters equal bit for bit, and equal bit
    for bit to this process's mean of the two samples' gradients (the
    rule of ``tests/test_train_step.py:_differential_mesh_check``; at two
    ranks both sides add the same two terms); the logs are the ranks'
    mean, the same on both; only trainable parameters move.
    ``HNMBTrainer``'s step is ``test_dryrun_multichip``'s."""
    spec = selsa_spec()
    out = dryrun.data_parallel_check(spec, 2, str(tmp_path),
                                     timeout=TIMEOUT, threads=2)
    assert out["max_rel_err"] == 0.0
    r0, r1 = out["ranks"]
    assert r0["backend"] == "gloo" and r0["logs"] == r1["logs"]
    start = dryrun._trainer(spec, "cpu")
    start_params = dryrun.trainable_state(start)
    assert any(not torch.equal(w, start_params[n])
               for n, w in r0["params"].items())
    assert not any(n.startswith(("backbone.conv1.", "backbone.layer1."))
                   for n in r0["params"])


# --------------------------------------------------- sample order by rank
@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    return build_train_tree(str(tmp_path_factory.mktemp("multi_train")))


def test_samples_by_rank_follow_the_jax_batches(train_tree):
    """Two ranks over the training tree (a portrait video among the
    first items of the shuffle, skipped): rank r's samples equal the JAX
    ``train_batch_iterator(batch_size=2)`` batches' ``[r]``, and each
    rank's generators stay at the JAX globals (every rank plans every
    draw, decoding only its own)."""
    vid, _ = train_tree
    cfg = vid_cfg(vid, selsa_with_aug=True)
    n = 3 * 30 + 1
    seed = first_skip_seed(n, n - 1)
    canvas = (64, 96)
    for rank in range(2):
        jax_ds, port = paired(cfg, seed=seed)
        want = jax_iterator(jax_ds, canvas, batch_size=2, seed=seed)
        got = train_batch_iterator(port, canvas, seed=seed, world=2,
                                   rank=rank)
        for _ in range(3):
            w, g = next(want), next(got)
            for key, value in w.items():
                np.testing.assert_array_equal(g[key], value[rank],
                                              err_msg=key)
            assert_generators_at_jax_globals(port.py_rng, port.rng)


class _Recorder:
    """A trainer class that records what ``train_detector`` gives it."""
    seen = {}

    def __init__(self, engine, cfg, steps_per_epoch, seed):
        self.seen.update(steps_per_epoch=steps_per_epoch, seed=seed)


@pytest.mark.parametrize("n_items,world,steps", [(5, 2, 2), (1, 2, 1),
                                                 (8, 4, 2), (3, 1, 3)])
def test_steps_per_epoch_follow_jax(n_items, world, steps, monkeypatch,
                                    tmp_path):
    """``train_detector``'s steps per epoch at ``world`` ranks:
    ``max(len(data) // world, 1)``, the JAX loop's
    (``hvrnet_tpu/apis.py:120-121``)."""
    monkeypatch.setattr(apis, "world_and_rank", lambda: (world, 0))
    monkeypatch.setattr(apis, "trainer_class", lambda engine: _Recorder)
    monkeypatch.setattr(apis, "broadcast_", lambda tensors: None)
    monkeypatch.setattr(apis, "load_params_for_engine", lambda e, p: None)

    class Engine:
        model = torch.nn.Linear(1, 1)

    apis.train_detector(Engine(), [{}] * n_items, dict(total_epochs=0),
                        work_dir=str(tmp_path))
    assert _Recorder.seen["steps_per_epoch"] == steps


DENSE = [RetinaTrainer, FreeAnchorTrainer, SSDTrainer, FCOSTrainer,
         FoveaTrainer, GATrainer, RepPointsTrainer]


@pytest.mark.parametrize("cls", DENSE, ids=[c.__name__ for c in DENSE])
def test_dense_trainers_refuse_data_parallel(cls, monkeypatch):
    """At world 2 a single-stage trainer raises ``ValueError`` naming what
    the JAX one does instead (trains on sample 0 of each n-device batch);
    the video and two-stage trainers take the data-parallel step."""
    monkeypatch.setattr(port_train, "world_and_rank", lambda: (2, 1))
    engine = object.__new__(single_stage.RetinaNet)
    with pytest.raises(ValueError, match="sample 0 of each n-device"):
        cls(engine, {})
    assert all(c.data_parallel for c in (port_train.HNMBTrainer,
                                         port_train.SelsaTrainer,
                                         port_train.FasterRCNNTrainer))


# ------------------------------------------------------------ the CLI
def test_train_cli_two_gloo_ranks(train_tree, tmp_path):
    """``tools/train.py --device cpu --n-devices 2`` on SELSA over the
    training tree: two gloo ranks take the first two samples of one
    shuffle; rank 0 alone writes the log (one line) and the checkpoints,
    which keep both ranks' sampler states; the weights equal one process
    that calibrates on rank 0's probe and averages the two samples'
    gradients, each with its rank's sampler seed, bit for bit (at the
    ranks' thread count: 1 each)."""
    vid, _ = train_tree
    val = build_tree(str(tmp_path / "val"))
    model, test_cfg = tiny_selsa_cfg()
    train_cfg = tiny_train_cfg(False, num=8)
    cfg = write_config(tmp_path / "selsa.py", model, train_cfg, test_cfg,
                       dict(vid_cfg(vid, selsa_with_aug=True),
                            pipeline=scaled(vid_cfg(vid)["pipeline"])),
                       val)
    work = tmp_path / "run"
    seed, canvas = 2, (96, 96)
    run = train_cli.main([cfg, "--device", "cpu", "--n-devices", "2",
                          "--canvas", *map(str, canvas), "--seed", str(seed),
                          "--work-dir", str(work), "--total-epochs", "1",
                          "--max-steps-per-epoch", "1", "--calibrate-bn"])
    assert run["world"] == 2
    assert sorted(os.listdir(work)) == ["epoch_1.pth", "latest.pth",
                                        "train_log.jsonl"]
    assert len((work / "train_log.jsonl").read_text().splitlines()) == 1
    ckpt = load_checkpoint(str(work / "latest.pth"))
    assert ckpt["step"] == 1 and len(ckpt["rng"]) == 2

    conf = Config.fromfile(cfg)
    torch.set_num_threads(1)            # the ranks' count
    try:
        want, moved = _one_process_mean(conf, canvas, seed)
    finally:
        torch.set_num_threads(2)
    err = max(((ckpt["state_dict"][k] - w).abs().max()
               / w.abs().max().clamp_min(1.0)).item()
              for k, w in want.items() if w.is_floating_point())
    assert err == 0.0 and moved


def _one_process_mean(conf, canvas, seed):
    """The two ranks' step in one process: rank 0's probe calibrates the
    frozen BNs, then each rank's sample through the loss and its backward
    with its sampler seed, the gradients' mean and one update.  Returns
    the weights and whether any moved."""
    samples = []
    for rank in range(2):
        ds = build_dataset(unwrap(conf.data.train), dict(seed=seed))
        probe = next(train_batch_iterator(ds, canvas, seed=seed))
        samples.append(next(train_batch_iterator(ds, canvas, seed=seed,
                                                 world=2, rank=rank)))
    engine = apis.build_detector(conf.model, train_cfg=conf.train_cfg,
                                 device="cpu", seed=seed)
    calibrate_frozen_bn(engine, [dict(img=probe["imgs"][f:f + 1],
                                      img_shape=probe["img_shape"][f])
                                 for f in range(3)])
    trainer = apis.trainer_class(engine)(engine, conf.as_dict(), 1, seed)
    total = {}
    for rank, sample in enumerate(samples):
        trainer.generator.manual_seed(rank_seed(seed, rank))
        trainer.forward_backward(sample)
        for p in trainer.params:
            if p.grad is not None:
                total[p] = total.get(p, 0) + p.grad
    for p in trainer.params:
        p.grad = total[p] / 2 if p in total else None
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    trainer.apply_update()
    after = engine.model.state_dict()
    return after, any(not torch.equal(after[k], before[k]) for k in after)


def test_dryrun_multichip():
    """The port's ``dryrun_multichip(2)``: its three checks pass; its
    HVRNet step over 2 gloo ranks (``HNMBTrainer``, the ranks at this
    process's thread count) is finite and bit for bit this process's mean
    of the two samples' gradients."""
    out = dryrun.dryrun_multichip(2, timeout=TIMEOUT)
    assert np.isfinite(out["loss"]) and out["dp_err"] == 0.0
    assert out["kv_err"] <= dryrun.KV_TOL
    assert out["lanes_pick_agreement"] >= 0.75
