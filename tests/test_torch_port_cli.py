"""The port's ``hnl_test`` and ``vid_eval`` CLIs against the JAX package's,
run in-process on one synthetic VID tree and one checkpoint file.

The checkpoint holds the tiny HNMB config's weights (``tiny_hnmb_cfg``,
T = 3), drawn from a seed in the JAX layout, crossed to the port, frozen
BNs calibrated on the tree's first frame, and saved as an mmdet
``state_dict`` ``.pth`` that both packages load.  The JAX CLI runs at the
test canvas (its stream's canvas arguments set by a patch of the JAX
stream function in this process; the JAX package itself is unchanged); the
port's CLI sizes its canvas from the config's pipeline (64 × 96 here).
Frame order: ``np.random.seed(seed)`` before the JAX CLI, ``--seed`` for
the port.

Each CLI comparison runs twice: with the port's backbone (end to end) and
with the port engine's backbone maps taken from the JAX frame program on
the same frame (``jax_backbone``).  The second holds everything after the
backbone (proposals, ring, runner, stream, data, CLI) at the limits of
``assert_results_close``.  The first also carries the two backbones' f32
rounding: on this tree it moves an HVRNet score by at most 8.0e-7 and a
box by 0.0096 px, so HVRNet is held at the same limits end to end; it
moves one SELSA score by 1.245e-4 (frame 9; the others by at most
2.1e-5), so SELSA's end-to-end scores are held at 2e-4
(``tests/test_torch_port_cli_selsa.py``).
"""
import contextlib
import functools
import importlib
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hvrnet_tpu.engine.stream as jax_stream
from hvrnet_tpu.apis import load_params_for_engine
from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine import HNLRCNN, HNMBRCNN, SlidingWindowRunner
from hvrnet_tpu_torch.engine import detector
from hvrnet_tpu_torch.engine.calibrate import calibrate_frozen_bn
from hvrnet_tpu_torch.tools import hnl_test, vid_eval
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_torch_port_backbone import jax_param_tree
from tests.test_torch_port_data import build_tree
from tests.test_vid_dataset import TEST_PIPELINE

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CANVAS = (64, 96)
IMAGE_SCALE = 200          # the tree's largest frame side, in pixels
N_FRAMES = 16


def write_config(path, model_cfg, test_cfg, root, video_shuffle=True):
    """A config file over the tree: the model, its test_cfg, and
    ``data.test`` with the tiny test pipeline."""
    test_cfg = dict(test_cfg, relation_setup=dict(
        test_cfg["relation_setup"], video_shuffle=video_shuffle))
    data = dict(test=dict(type="VIDSeqDataset",
                          ann_file=f"{root}/ImageSets/VID_val_videos.txt",
                          img_prefix=root, pipeline=TEST_PIPELINE))
    Path(path).write_text(f"model = {model_cfg!r}\ntest_cfg = {test_cfg!r}\n"
                          f"data = {data!r}\n")
    return str(path)


def first_frame(root):
    """The tree's first frame as the port's stream gives it."""
    from hvrnet_tpu_torch.data.vid_dataset import VIDSeqDataset
    from hvrnet_tpu_torch.engine.stream import test_frame_stream
    ds = VIDSeqDataset(ann_file=f"{root}/ImageSets/VID_val_videos.txt",
                       img_prefix=root, pipeline=TEST_PIPELINE,
                       test_mode=True, video_shuffle=False)
    return next(test_frame_stream(ds, max_long=max(CANVAS),
                                  max_short=min(CANVAS)))


def shared_checkpoint(path, model_cfg, test_cfg, jax_cls, port_cls, root,
                      seed):
    """Seeded weights in the JAX layout → the port, frozen BNs calibrated
    on the tree's first frame → an mmdet ``state_dict`` file."""
    tree = jax_param_tree(jax_cls(model_cfg, None, test_cfg), seed)
    port = port_cls(model_cfg, test_cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(tree))
    calibrate_frozen_bn(port, [first_frame(root)])
    torch.save({"state_dict": port.model.state_dict()}, path)
    return str(path)


def jax_cli(module, argv, seed=0):
    """Run the JAX package's ``tools/<module>.py`` main in this process at
    the test canvas, numpy's global state seeded first."""
    sys.path.insert(0, str(ROOT))
    main = importlib.import_module(f"tools.{module}").main
    stream = functools.partial(jax_stream.test_frame_stream,
                               max_long=max(CANVAS), max_short=min(CANVAS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_stream, "test_frame_stream", stream)
        mp.setattr(sys, "argv", [f"{module}.py"] + list(argv))
        np.random.seed(seed)
        main()


def port_args(cfg, ckpt, out, *extra):
    return [cfg, ckpt, "--device", "cpu", "--out", str(out), *extra]


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def match_rows(got, want, box_tol, score_tol=1e-4):
    """Pair each wanted detection with a distinct got one within the limits
    (boxes ``box_tol``, scores ``score_tol``), nearest first: rows of equal
    scores up to rounding may come in either order."""
    cost = np.maximum(
        np.abs(got[None, :, :4] - want[:, None, :4]).max(-1) / box_tol,
        np.abs(got[None, :, 4] - want[:, None, 4]) / score_tol)
    free_g, free_w = set(range(len(got))), set(range(len(want)))
    for flat in np.argsort(cost, axis=None, kind="stable"):
        w, g = divmod(int(flat), len(got))
        if w in free_w and g in free_g and cost[w, g] <= 1:
            free_w.discard(w)
            free_g.discard(g)
    assert not free_w, (f"{len(free_w)} detections without a counterpart "
                        f"within the limits", got, want)


def assert_results_close(got, want, box_tol=1e-4 * IMAGE_SCALE,
                         score_tol=1e-4):
    """Per frame and class the same number of detections, each within
    ``score_tol`` in score and ``box_tol`` in its box of one on the other
    side (by default the limits of ``tests/test_torch_port_slice.py:
    _compare_runners``).  Returns whether every array was also bitwise
    equal."""
    assert len(got) == len(want) == N_FRAMES
    total, bitwise = 0, True
    for fg, fw in zip(got, want):
        assert fg is not None and len(fg) == len(fw) == 30
        for cg, cw in zip(fg, fw):
            assert cg.shape == cw.shape
            if len(cw):
                match_rows(cg, cw, box_tol, score_tol)
            bitwise = bitwise and np.array_equal(cg, cw)
            total += len(cw)
    assert total > 0
    return bitwise


def assert_cli_matches(got, want, backbone, end_to_end_score_tol=1e-4):
    """``assert_results_close``; end to end (``backbone`` "port") scores
    are held at ``end_to_end_score_tol`` (see the module docstring)."""
    if backbone == "jax":
        return assert_results_close(got, want)
    return assert_results_close(got, want, score_tol=end_to_end_score_tol)


def fill_gaps(results):
    """(results with each undetected frame's ``None`` as 30 empty classes,
    the indices of those frames).  At an even window the reference's
    sliding-window loop never detects a video's last frame (its tail
    drain ends one frame short), in both packages."""
    empty = [np.zeros((0, 5), np.float32)] * 30
    gaps = [i for i, r in enumerate(results) if r is None]
    return [empty if r is None else r for r in results], gaps


@contextlib.contextmanager
def jax_backbone(model_cfg, test_cfg, jax_cls, ckpt):
    """Port engines take their (c5, rpn cls, rpn reg) maps from the JAX
    engine's frame program on the same canvas, as NCHW tensors."""
    jeng = jax_cls(model_cfg, None, test_cfg)
    params = load_params_for_engine(jeng, ckpt)

    def maps(self, img, img_shape):
        out = jeng._backbone_dispatch(params, jnp.asarray(img), img_shape)
        return tuple(torch.from_numpy(np.asarray(m).transpose(0, 3, 1, 2)
                                      .copy()) for m in out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(detector.BaseEngine, "backbone_maps", maps)
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(tree, config path, checkpoint path, work dir)."""
    work = tmp_path_factory.mktemp("hnl_cli")
    root = build_tree(str(work / "VID"))
    model_cfg, test_cfg = tiny_hnmb_cfg()
    cfg = write_config(work / "tiny_hnmb.py", model_cfg, test_cfg, root)
    ckpt = shared_checkpoint(work / "tiny_hnmb.pth", model_cfg, test_cfg,
                             JaxHNMBRCNN, HNMBRCNN, root, seed=4)
    yield root, cfg, ckpt, work
    shutil.rmtree(work, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX ``hnl_test`` CLI's results, exact and streaming ring."""
    _, cfg, ckpt, work = setup
    runs = {}
    for ring in ("exact", "stream"):
        out = work / f"jax_{ring}.pkl"
        jax_cli("hnl_test", [cfg, ckpt, "--window", "3", "--pre-padding",
                             "repeat", "--out", str(out), "--tmpdir",
                             str(work / f"jax_{ring}_parts")]
                + (["--stream"] if ring == "stream" else []), seed=2)
        runs[ring] = str(out)
    return runs


@pytest.mark.parametrize("backbone", ["port", "jax"])
@pytest.mark.parametrize("ring", ["exact", "stream"])
def test_hnl_test_cli_matches_jax(setup, jax_runs, ring, backbone):
    """The port's CLI on the same tree, weights file and seed: the same
    detections per frame and class as the JAX CLI's, and an mAP in [0, 1]
    equal to ``vid_eval`` of its own pickle; ``backbone`` "jax" takes the
    backbone maps from the JAX frame program."""
    _, cfg, ckpt, work = setup
    out = work / f"port_{ring}_{backbone}.pkl"
    argv = port_args(cfg, ckpt, out, "--window", "3", "--pre-padding",
                     "repeat", "--seed", "2", "--eval", "--tmpdir",
                     str(work / f"port_{ring}_{backbone}"))
    if ring == "stream":
        argv.append("--stream")
    with (jax_backbone(*tiny_hnmb_cfg(), JaxHNMBRCNN, ckpt)
          if backbone == "jax" else contextlib.nullcontext()):
        run = hnl_test.main(argv)
    got = load(out)
    assert_cli_matches(got, load(jax_runs[ring]), backbone)
    assert all(all(np.array_equal(a, b) for a, b in zip(x, y))
               for x, y in zip(run["results"], got))
    assert 0.0 <= run["map"] <= 1.0
    assert run["map"] == vid_eval.main([str(out), cfg])[0]
    if ring == "stream":
        assert run["runner"].speculative


def test_hnl_test_even_window_matches_jax(setup):
    """``hnl_test --window 4``, an even window, as the JAX CLI takes it:
    the head's t_dim 4 and key_dim 1, a ring of 4 frames detecting frame
    1; with the JAX backbone maps, the JAX CLI's detections within the
    limits, and the same undetected last frames (``fill_gaps``)."""
    _, cfg, ckpt, work = setup
    common = ["--window", "4", "--pre-padding", "repeat"]
    want = work / "jax_w4.pkl"
    jax_cli("hnl_test", [cfg, ckpt, *common, "--out", str(want), "--tmpdir",
                         str(work / "jax_w4")], seed=2)
    out = work / "port_w4.pkl"
    with jax_backbone(*tiny_hnmb_cfg(), JaxHNMBRCNN, ckpt):
        run = hnl_test.main(port_args(cfg, ckpt, out, *common, "--seed", "2",
                                      "--tmpdir", str(work / "port_w4")))
    eng = run["runner"].engine
    assert (eng.window, eng.key_dim, eng.model.bbox_head.t_dim) == (4, 1, 4)
    (got, gaps), (want, want_gaps) = fill_gaps(load(out)), fill_gaps(
        load(want))
    assert gaps == want_gaps and len(gaps) == 4       # one per video
    assert_cli_matches(got, want, "jax")


def test_vid_eval_matches_jax(setup, jax_runs, capsys):
    """Both packages' ``vid_eval`` on the JAX CLI's pickle: the same mAP
    and per-class curves, exactly, for both matching rules."""
    _, cfg, _, _ = setup
    sys.path.insert(0, str(ROOT))
    from tools.vid_eval import evaluate_results as jax_evaluate
    for imagenet in (False, True):
        want = jax_evaluate(jax_runs["exact"], cfg, imagenet_tpfp=imagenet,
                            quiet=True)
        argv = [jax_runs["exact"], cfg] + (["--imagenet-tpfp"] if imagenet
                                           else [])
        got = vid_eval.main(argv)
        assert got[0] == want[0]
        for g, w in zip(got[1], want[1]):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
    assert "mAP" in capsys.readouterr().out


def test_vid_eval_fills_missing_frames_and_reads_pairs(setup, jax_runs,
                                                       tmp_path):
    """A frame without results counts as empty, and [branch, final] pairs
    are scored on the final branch: the same mAP as JAX's."""
    _, cfg, _, _ = setup
    sys.path.insert(0, str(ROOT))
    from tools.vid_eval import evaluate_results as jax_evaluate
    results = load(jax_runs["exact"])
    empty = [np.zeros((0, 5), np.float32)] * 30
    pairs = [[empty, r] for r in results]
    pairs[3] = None
    path = tmp_path / "pairs.pkl"
    path.write_bytes(pickle.dumps(pairs))
    want = jax_evaluate(str(path), cfg, quiet=True)
    got = vid_eval.evaluate_results(str(path), cfg, quiet=True)
    assert got[0] == want[0]


def test_two_ranks_merge_to_the_single_rank_run(setup, tmp_path):
    """``--world-size 2``: rank 1 writes its part, rank 0 runs its videos,
    waits for the parts and merges them, in frame order, into the results
    of one rank over the whole tree (videos unshuffled, so each video's
    frames come in one order whatever the rank's draws)."""
    root, _, ckpt, _ = setup
    model_cfg, test_cfg = tiny_hnmb_cfg()
    cfg = write_config(tmp_path / "cfg.py", model_cfg, test_cfg, root,
                       video_shuffle=False)
    common = ("--window", "3", "--pre-padding", "repeat")
    single = hnl_test.main(port_args(cfg, ckpt, tmp_path / "one.pkl",
                                     *common, "--tmpdir",
                                     str(tmp_path / "one")))
    parts = str(tmp_path / "parts")
    out = tmp_path / "two.pkl"
    rank1 = hnl_test.main(port_args(cfg, ckpt, out, *common, "--world-size",
                                    "2", "--rank", "1", "--tmpdir", parts))
    assert not out.exists()
    rank0 = hnl_test.main(port_args(cfg, ckpt, out, *common, "--world-size",
                                    "2", "--rank", "0", "--tmpdir", parts))
    ds = rank0["dataset"]
    assert ds.local_frame_size_list == [8, 8]
    assert len(rank1["results"]) == 8
    merged = load(out)
    assert len(merged) == N_FRAMES
    for a, b in zip(merged, single["results"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_random_pre_padding(setup):
    """``--pre-padding random``: half − 1 frames of the first frame's own
    video at offsets inside it, through the pipeline, from a generator of
    their own: the same frames under one seed, others under another; the
    dataset's generator is untouched, and the CLI's results repeat."""
    root, cfg, ckpt, work = setup
    from hvrnet_tpu_torch.data.vid_dataset import VIDSeqDataset
    from hvrnet_tpu_torch.engine.stream import test_frame_stream

    def provider(seed, window=5):
        ds = VIDSeqDataset(ann_file=f"{root}/ImageSets/VID_val_videos.txt",
                           img_prefix=root, pipeline=TEST_PIPELINE,
                           test_mode=True, world_size=2, seed=0)
        return ds, hnl_test.random_prepad(ds, 1, window, seed, CANVAS,
                                          "cv2")

    ds, prepad = provider(7)
    state = ds.rng.get_state()[1].copy()
    frames = list(test_frame_stream(ds, rank=1, max_long=max(CANVAS),
                                    max_short=min(CANVAS)))
    firsts = [f for f in frames if f["key_frame_flag"] == 0]
    assert len(firsts) == 2
    ds2, again = provider(7)
    _, other = provider(8)
    offsets = []
    for first in firsts:
        pads = prepad(first)
        assert len(pads) == 2                       # (5 + 1) // 2 − 1
        for p in pads:
            assert p["frame_start_id"] == first["frame_start_id"]
            assert p["seg_len"] == first["seg_len"]
            assert 0 <= p["frame_offset"] < p["seg_len"]
            assert p["img"].shape[1:3] == first["img"].shape[1:3]
        twins = again(first)
        for p, q in zip(pads, twins):
            assert p["frame_offset"] == q["frame_offset"]
            np.testing.assert_array_equal(p["img"], q["img"])
        offsets += [p["frame_offset"] for p in pads]
        offsets += [p["frame_offset"] for p in other(first)]
    assert offsets[:2] != offsets[2:4] or offsets[4:6] != offsets[6:]
    np.testing.assert_array_equal(ds2.rng.get_state()[1], state)

    runs = [hnl_test.main(port_args(
        cfg, ckpt, work / f"random_{k}.pkl", "--window", "3",
        "--tmpdir", str(work / f"random_{k}"))) for k in range(2)]
    for a, b in zip(*(r["results"] for r in runs)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("flag", [["--show"]])
def test_hnl_test_refuses_unported_flags(setup, flag):
    _, cfg, ckpt, work = setup
    with pytest.raises(SystemExit, match="not ported yet \\(ROADMAP Queue "
                                         "1 item 7"):
        hnl_test.main(port_args(cfg, ckpt, work / "no.pkl", *flag))


def test_hnlrcnn_matches_hnmbrcnn(setup):
    """``HNLRCNN`` from a config (``apis.build_detector``) is HVRNet's
    engine under another name: on the same weights, the same detections
    bit for bit."""
    root, _, ckpt, _ = setup
    model_cfg, test_cfg = tiny_hnmb_cfg()
    state = torch.load(ckpt, weights_only=True)["state_dict"]
    out = []
    for kind in ("HNLRCNN", "HNMBRCNN"):
        eng = apis.build_detector(dict(model_cfg, type=kind), None, test_cfg,
                                  device="cpu")
        assert type(eng) is {"HNLRCNN": HNLRCNN, "HNMBRCNN": HNMBRCNN}[kind]
        eng.load_state_dict(state)
        frames = [first_frame(root)] * 3
        for i, f in enumerate(frames):
            frames[i] = dict(f, key_frame_flag=(0, 2, 1)[i], frame_offset=i,
                             seg_len=3, frame_start_id=1)
        out.append(SlidingWindowRunner(eng).run(frames, 3))
    for a, b in zip(*out):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))

