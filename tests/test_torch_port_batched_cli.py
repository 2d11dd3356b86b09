"""The port's lockstep runner and threaded stream, and the CLI flags that
reach them or the pair features (``test --batched B``, ``--loader-workers
N``, ``--pair-features P`` on both CLIs), against the JAX package's on one
synthetic VID tree and one checkpoint file, in-process on the CPU at the
tiny HVRNet config (the runner's pair features, SELSA's among them, are
held in ``tests/test_torch_port_lanes.py``).

The tree holds only landscape videos (5, 3, 4 and 4 frames): lockstep
streams share one canvas per step, in the JAX runner as in the port's.
Frame order: ``np.random.seed(seed)`` before a JAX run, the same seed for
the port's dataset.  Tolerances: end to end, the limits of
``tests/test_torch_port_cli.py:assert_results_close`` (per frame and class
the same number of detections, scores within 1e-4, boxes within 1e-4 of
the image scale; measured on this tree below 1e-5 and 0.01 px); the
port's runs against each other bit for bit where only the threads, the
transfer dtype or the runner's batching of host work differ, and at the
same limits where the frame program's batch changes the convolutions'
rounding.
"""
import functools
import shutil

import numpy as np
import pytest
import torch

import hvrnet_tpu.engine.batched_runner as jax_lockstep
import hvrnet_tpu.engine.stream as jax_stream
from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu_torch.engine import (BatchedSlidingWindowRunner, HNMBRCNN,
                                     SlidingWindowRunner)
from hvrnet_tpu_torch.engine import stream as port_stream
from hvrnet_tpu_torch.engine.stream import parallel_test_frame_stream
from hvrnet_tpu_torch.tools import hnl_test
from hvrnet_tpu_torch.tools import test as test_cli
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_torch_port_cli import (CANVAS, assert_results_close,
                                       jax_backbone, jax_cli, load, port_args,
                                       shared_checkpoint, write_config)
from tests.test_torch_port_data import add_video, build_tree, datasets
from tests.test_vid_dataset import build_mini_vid

torch.set_num_threads(2)

SEED = 1
STREAM_CANVAS = dict(max_long=max(CANVAS), max_short=min(CANVAS))


def landscape_tree(root):
    """16 landscape frames: build_mini_vid's 5 + 3 at 48×72, then 4 at
    60×90 and 4 at 150×200."""
    build_mini_vid(root, [("val/ILSVRC2015_val_00000000", 5, "n02691156"),
                          ("val/ILSVRC2015_val_00000001", 3, "n02958343")])
    add_video(root, "val/ILSVRC2015_val_00000002", 4, (60, 90), "n02084071",
              seed=0)
    add_video(root, "val/ILSVRC2015_val_00000003", 4, (150, 200),
              "n02121808", seed=1)
    return root


def jax_test_cli(argv, seed):
    """The JAX ``tools/test.py`` at the test canvas: its lockstep runner
    and threaded stream take the canvas too (the JAX package unchanged;
    patched in this process only)."""
    run = jax_lockstep.BatchedSlidingWindowRunner.run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lockstep.BatchedSlidingWindowRunner, "run",
                   functools.partialmethod(run, **STREAM_CANVAS))
        mp.setattr(jax_stream, "parallel_test_frame_stream",
                   functools.partial(jax_stream.parallel_test_frame_stream,
                                     **STREAM_CANVAS))
        jax_cli("test", argv, seed=seed)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Work dir, tree, and HVRNet's (config, checkpoint)."""
    work = tmp_path_factory.mktemp("batched_cli")
    root = landscape_tree(str(work / "VID"))
    cfgs = tiny_hnmb_cfg()
    cfg = write_config(work / "hnmb.py", *cfgs, root)
    yield dict(work=work, root=root, hnmb=(cfg, shared_checkpoint(
        work / "hnmb.pth", *cfgs, JaxHNMBRCNN, HNMBRCNN, root, seed=4)))
    shutil.rmtree(work, ignore_errors=True)


def _port(setup, name, *flags, cli=test_cli):
    cfg, ckpt = setup["hnmb"]
    work = setup["work"]
    run = cli.main(port_args(cfg, ckpt, work / f"{name}.pkl", "--seed",
                             str(SEED), "--tmpdir", str(work / name),
                             *flags))
    return run


@pytest.fixture(scope="module")
def batched(setup):
    """The port's ``test --batched 2`` run and its options."""
    return {name: _port(setup, name, "--batched", "2", *flags)
            for name, flags in (
                ("plain", ()), ("workers", ("--loader-workers", "2")),
                ("u8", ("--u8-transfer",)),
                ("workers_u8", ("--loader-workers", "2", "--u8-transfer")))}


@pytest.fixture(scope="module")
def jax_batched(setup):
    """The JAX CLI's ``test --batched 2`` results, plain and with
    ``--loader-workers 2 --u8-transfer``."""
    cfg, ckpt = setup["hnmb"]
    work = setup["work"]
    runs = {}
    for tag, flags in (("plain", ()), ("workers_u8", ("--loader-workers", "2",
                                                      "--u8-transfer"))):
        want = work / f"jax_batched_{tag}.pkl"
        jax_test_cli([cfg, ckpt, "--batched", "2", *flags, "--out",
                      str(want), "--tmpdir", str(work / f"jax_{tag}")],
                     seed=SEED)
        runs[tag] = load(want)
    return runs


@pytest.mark.parametrize("tag", ["plain", "workers_u8"])
def test_batched_cli_matches_jax(batched, jax_batched, tag):
    """``test --batched 2`` (with and without ``--loader-workers 2
    --u8-transfer``) against the JAX CLI's lockstep runner under one seed,
    ``video_shuffle`` on: every frame emitted once, and each within the
    end-to-end limits."""
    run = batched[tag]
    assert run["runner"].batch == 2 and run["frames"] == 16
    assert all(r is not None for r in run["results"])
    assert_results_close(run["results"], jax_batched[tag])


def test_batched_cli_from_jax_maps_matches_jax(setup, jax_batched):
    """``test --batched 2`` with the port's backbone maps taken from the
    JAX frame program on the same (batched) canvases: everything after the
    backbone within the limits, against the JAX CLI's run."""
    with jax_backbone(*tiny_hnmb_cfg(), JaxHNMBRCNN, setup["hnmb"][1]):
        run = _port(setup, "jax_maps", "--batched", "2")
    assert_results_close(run["results"], jax_batched["plain"])


@pytest.mark.parametrize("other", ["workers", "u8", "workers_u8"])
def test_batched_options_are_bit_for_bit(batched, other):
    """Loader threads decode only (the draws stay serial in stream order)
    and the uint8 canvases normalise on the device to the same engine
    input: each option's results equal the plain lockstep run's, bit for
    bit."""
    for a, b in zip(batched[other]["results"], batched["plain"]["results"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_batched_matches_the_sequential_runner(setup, batched):
    """The sequential runner over the threaded stream (``--loader-workers
    2``: every video's shuffle drawn first, as the lockstep runner draws
    them) gives each video the same windows: the same detections within
    the limits (the batched frame program's convolutions round
    differently)."""
    seq = _port(setup, "sequential", "--loader-workers", "2")
    assert isinstance(seq["runner"], SlidingWindowRunner)
    assert_results_close(batched["plain"]["results"], seq["results"])


def test_batched_window_matches_jax(setup):
    """``test --batched 2 --window 5``, above the config's t_dim 3: both
    CLIs set the engine's window and key frame and keep the head's t_dim
    (the head keys 24 of the window's 40 rows); within the end-to-end
    limits of the JAX CLI's run."""
    cfg, ckpt = setup["hnmb"]
    work = setup["work"]
    want = work / "jax_batched_w5.pkl"
    jax_test_cli([cfg, ckpt, "--batched", "2", "--window", "5", "--out",
                  str(want), "--tmpdir", str(work / "jax_w5")], seed=SEED)
    run = _port(setup, "batched_w5", "--batched", "2", "--window", "5")
    eng = run["runner"].engine
    assert (eng.window, eng.key_dim, eng.model.bbox_head.t_dim) == (5, 2, 3)
    assert_results_close(run["results"], load(want))


def test_lockstep_streams_need_one_canvas(tmp_path):
    """A step that mixes a portrait and a landscape canvas stops with the
    cause named (the JAX runner fails there in ``np.stack``)."""
    root = build_tree(str(tmp_path / "VID"))
    _, ds = datasets(root, seed=SEED)
    eng = HNMBRCNN(*tiny_hnmb_cfg(), device="cpu")
    runner = BatchedSlidingWindowRunner(eng, batch=2)
    with pytest.raises(ValueError, match="portrait and landscape"):
        runner.run(ds, **STREAM_CANVAS)


# ----------------------------------------------------------- the stream
def _frames(stream):
    return [dict(f, img=np.asarray(f["img"])) for f in stream]


def _assert_frames_equal(got, want):
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert set(w) <= set(g)
        for key, value in w.items():
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(value), err_msg=key)


def test_parallel_stream_matches_the_sequential_stream_and_jax(setup):
    """Without ``video_shuffle`` the threaded stream's frames (images and
    meta) equal ``test_frame_stream``'s bit for bit; with it, the JAX
    ``parallel_test_frame_stream``'s under one seed, uint8 and float, and
    in transfer batches of 3 onto a device."""
    root = setup["root"]
    _, ds = datasets(root, seed=SEED, video_shuffle=False)
    want = _frames(port_stream.test_frame_stream(ds, **STREAM_CANVAS))
    _, ds = datasets(root, seed=SEED, video_shuffle=False)
    _assert_frames_equal(_frames(parallel_test_frame_stream(
        ds, workers=2, **STREAM_CANVAS)), want)
    for u8 in (False, True):
        jds, ds = datasets(root, seed=SEED)
        want = _frames(jax_stream.parallel_test_frame_stream(
            jds, workers=2, u8_transfer=u8, **STREAM_CANVAS))
        got = _frames(parallel_test_frame_stream(
            ds, workers=3, u8_transfer=u8, **STREAM_CANVAS))
        _assert_frames_equal(got, want)
    _, ds = datasets(root, seed=SEED)
    moved = list(parallel_test_frame_stream(
        ds, workers=2, transfer_batch=3, device="cpu", **STREAM_CANVAS))
    assert all(isinstance(f["img"], torch.Tensor) for f in moved)
    _, ds = datasets(root, seed=SEED)
    _assert_frames_equal(_frames(moved), _frames(parallel_test_frame_stream(
        ds, workers=1, **STREAM_CANVAS)))


# ------------------------------------------------------- pair features
@pytest.mark.parametrize("cli", ["test", "hnl_test"])
def test_pair_features_cli_matches_jax(setup, cli):
    """``--pair-features 2`` on both CLIs (HVRNet's config through ``test``
    and through ``hnl_test --window 3 --pre-padding repeat``) against the
    JAX CLIs with the same flag: within the end-to-end limits."""
    work = setup["work"]
    mod = test_cli if cli == "test" else hnl_test
    cfg, ckpt = setup["hnmb"]
    extra = [] if cli == "test" else ["--window", "3", "--pre-padding",
                                      "repeat"]
    want = work / f"jax_pairs_{cli}.pkl"
    jax_cli(cli, [cfg, ckpt, "--pair-features", "2", *extra, "--out",
                  str(want), "--tmpdir", str(work / f"jax_pairs_{cli}")],
            seed=SEED)
    run = _port(setup, f"pairs_{cli}", "--pair-features", "2", *extra,
                cli=mod)
    assert run["runner"].pair_features == 2
    assert_results_close(run["results"], load(want))


def test_spmd_lanes_match_the_unsharded_lanes(setup, batched, jax_batched):
    """``test --batched 2 --spmd-lanes 2``: the two lanes on two CPU
    replicas of the engine, one lane each, every frame within the limits
    of the port's ``--batched 2`` on one engine (a replica's one-frame
    backbone batch rounds otherwise) and of the JAX CLI's."""
    run = _port(setup, "spmd", "--batched", "2", "--spmd-lanes", "2")
    assert len(run["runner"].engine.lane_replicas) == 2
    assert_results_close(run["results"], batched["plain"]["results"])
    assert_results_close(run["results"], jax_batched["plain"])


# ----------------------------------------------------------- CLI rules
EXCLUSIVE = [(["--batched", "2", "--aug-test"], "are exclusive"),
             (["--batched", "2", "--timing"], "not supported with --batched"),
             (["--batched", "2", "--pair-features", "2"],
              "applies to the sequential runner"),
             (["--spmd-lanes"], "requires --batched B"),
             (["--batched", "2", "--spmd-lanes"],
              "on the CPU takes the replica count"),
             (["--batched", "3", "--spmd-lanes", "2"],
              "divisible by the device count \\(2\\)")]


@pytest.mark.parametrize("flags,message", EXCLUSIVE,
                         ids=[" ".join(f) for f, _ in EXCLUSIVE])
def test_cli_flag_rules_follow_jax(setup, flags, message):
    """The JAX CLI's rules for flags that do not combine, with its
    messages, before the refusals of what is not ported yet; on the CPU,
    ``--spmd-lanes`` names its replica count."""
    with pytest.raises(SystemExit, match=message):
        _port(setup, "never", *flags)
