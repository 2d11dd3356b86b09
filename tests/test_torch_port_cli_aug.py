"""The port's ``test --aug-test`` (SELSA's and HVRNet's configs),
``hnl_test --multi-pass P`` and ``test --timing`` / ``--trace DIR``
against the JAX package's CLIs, in-process on the synthetic VID tree and
one checkpoint file per model, as ``tests/test_torch_port_cli.py`` runs
them; the JAX CLIs' rules for flags that do not combine.

Tolerances: the limits of ``tests/test_torch_port_cli.py:
assert_cli_matches`` (per frame and class the same detections, boxes
within 1e-4 of the image scale; scores within 1e-4, end to end for SELSA
2e-4 for the two backbones' rounding, as ``tests/test_torch_port_cli.py``
measured it on this tree).  With
the JAX backbone maps injected (``backbone`` "jax") every comparison is
held at 1e-4.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu.engine import SelsaRCNN as JaxSelsaRCNN
from hvrnet_tpu.engine.stream import test_frame_stream as jax_frame_stream
from hvrnet_tpu_torch.engine import HNMBRCNN, SelsaRCNN
from hvrnet_tpu_torch.engine import stream as port_stream
from hvrnet_tpu_torch.tools import hnl_test
from hvrnet_tpu_torch.tools import test as test_cli
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_engine_selsa import tiny_selsa_cfg
from tests.test_torch_port_cli import (assert_cli_matches, jax_backbone,
                                       jax_cli, load, port_args,
                                       shared_checkpoint, write_config)
from tests.test_torch_port_cli_selsa import END_TO_END_SCORE_TOL
from tests.test_torch_port_data import CANVAS, FRAME_KEYS, build_tree, \
    datasets

torch.set_num_threads(2)

SEED = 1
MODELS = {"selsa": (tiny_selsa_cfg, JaxSelsaRCNN, SelsaRCNN, 6,
                    END_TO_END_SCORE_TOL),
          "hnmb": (tiny_hnmb_cfg, JaxHNMBRCNN, HNMBRCNN, 4, 1e-4)}
HNL = ["--window", "9", "--pre-padding", "repeat"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tree, and per model its config file and checkpoint; HVRNet's
    config at a window of 9 frames (``hnmb9``) on HVRNet's checkpoint."""
    work = tmp_path_factory.mktemp("aug_cli")
    root = build_tree(str(work / "VID"))
    out = dict(work=work, root=root)
    for name, (cfg_fn, jax_cls, port_cls, seed, _) in MODELS.items():
        cfgs = cfg_fn()
        out[name] = (write_config(work / f"{name}.py", *cfgs, root),
                     shared_checkpoint(work / f"{name}.pth", *cfgs, jax_cls,
                                       port_cls, root, seed=seed))
    out["hnmb9"] = (write_config(work / "hnmb9.py",
                                 *tiny_hnmb_cfg(window_interval=4), root),
                    out["hnmb"][1])
    return out


def _argv(setup, model, name, *extra):
    cfg, ckpt = setup[model]
    work = setup["work"]
    return port_args(cfg, ckpt, work / f"{name}.pkl", "--tmpdir",
                     str(work / name), *extra)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX CLIs' results: ``test --aug-test`` per model and
    ``hnl_test --window 9 --multi-pass 3``."""
    work = setup["work"]
    runs = {}
    for name, module, model, extra, seed in (
            ("selsa", "test", "selsa", ["--aug-test"], SEED),
            ("hnmb", "test", "hnmb", ["--aug-test"], SEED),
            ("multi_pass", "hnl_test", "hnmb9", HNL + ["--multi-pass", "3"],
             SEED)):
        cfg, ckpt = setup[model]
        want = work / f"jax_{name}.pkl"
        jax_cli(module, [cfg, ckpt, *extra, "--out", str(want), "--tmpdir",
                         str(work / f"jax_{name}")], seed=seed)
        runs[name] = load(want)
    return runs


@pytest.mark.parametrize("backbone", ["port", "jax"])
@pytest.mark.parametrize("model", ["selsa", "hnmb"])
def test_aug_test_cli_matches_jax(setup, jax_runs, model, backbone):
    """``test --aug-test`` on each shipped model's tiny config: per frame
    and class the JAX CLI's detections within the limits above; the
    runner flip-augmented, off the streaming ring."""
    cfg_fn, jax_cls, _, _, tol = MODELS[model]
    ckpt = setup[model][1]
    with (jax_backbone(*cfg_fn(), jax_cls, ckpt) if backbone == "jax"
          else contextlib.nullcontext()):
        run = test_cli.main(_argv(setup, model, f"aug_{model}_{backbone}",
                                  "--aug-test", "--seed", str(SEED)))
    assert run["runner"].aug and not run["runner"].speculative
    assert_cli_matches(run["results"], jax_runs[model], backbone, tol)


@pytest.mark.parametrize("backbone", ["port", "jax"])
def test_multi_pass_cli_matches_jax(setup, jax_runs, backbone):
    """``hnl_test --window 9 --multi-pass 3`` against the JAX CLI: the
    engine runs the 3-pass graph on the exact ring, per frame and class
    the JAX CLI's detections within the limits above."""
    ckpt = setup["hnmb9"][1]
    with (jax_backbone(*tiny_hnmb_cfg(window_interval=4), JaxHNMBRCNN, ckpt)
          if backbone == "jax" else contextlib.nullcontext()):
        run = hnl_test.main(_argv(setup, "hnmb9", f"multi_pass_{backbone}",
                                  *HNL, "--multi-pass", "3", "--seed",
                                  str(SEED)))
    assert run["runner"].engine.multi_pass == 3
    assert run["runner"].engine.window == 9
    assert_cli_matches(run["results"], jax_runs["multi_pass"], backbone)


def test_aug_stream_matches_jax(setup):
    """``test_frame_stream(aug_flip=True)``: every frame's canvas and its
    mirror, bit for bit the JAX stream's, with the same metadata and flips
    (a portrait video included)."""
    jds, pds = datasets(setup["root"], seed=5)
    want = list(jax_frame_stream(jds, aug_flip=True, **CANVAS))
    got = list(port_stream.test_frame_stream(pds, aug_flip=True, **CANVAS))
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert g["flips"] == w["flips"] == (False, True)
        for a, b in zip(g["img_augs"], w["img_augs"]):
            np.testing.assert_array_equal(a, np.asarray(b))
        for key in FRAME_KEYS:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.fixture(scope="module")
def timed_traced(setup):
    """SELSA's ``test --aug-test --timing --trace DIR`` and its printed
    output."""
    work = setup["work"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = test_cli.main(_argv(setup, "selsa", "timed", "--aug-test",
                                  "--seed", str(SEED), "--timing", "--trace",
                                  str(work / "trace")))
    return run, out.getvalue(), work / "trace"


def test_timing_prints_the_phase_summary(timed_traced, jax_runs):
    """``--timing``: after the run the JAX CLI's summary table (header
    ``phase total_s calls avg_ms``), one line per phase, among them the
    runner's ``frame_features`` (16 frames) and ``window_detect`` (16
    detections) and the stream's ``pipeline``; the traced and timed run's
    detections still the JAX CLI's within the limits above."""
    run, printed, _ = timed_traced
    lines = printed.strip().splitlines()
    header = next(i for i, line in enumerate(lines)
                  if line.split() == ["phase", "total_s", "calls", "avg_ms"])
    rows = {line.split()[0]: line.split()[1:] for line in lines[header + 1:]}
    assert {"frame_features", "window_detect", "pipeline",
            "stream_wait"} <= set(rows)
    assert int(rows["frame_features"][1]) == 16
    assert int(rows["window_detect"][1]) == 16
    assert_cli_matches(run["results"], jax_runs["selsa"], "port",
                       END_TO_END_SCORE_TOL)


def test_trace_writes_a_trace_file(timed_traced):
    """``--trace DIR``: DIR holds one Chrome trace of the run whose events
    include the host's aten operators."""
    _, _, trace_dir = timed_traced
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(files) == 1
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_timing_summary_of_a_given_timer(setup, capsys):
    """``main(timer=...)`` wins over ``--timing``'s own timer, and
    ``--timing`` prints the given timer's summary."""
    from hvrnet_tpu_torch.utils.profiling import PhaseTimer
    timer = PhaseTimer()
    test_cli.main(_argv(setup, "hnmb", "given", "--timing"), timer=timer)
    assert timer.count["window_detect"] == 16
    assert timer.summary() in capsys.readouterr().out


# ----------------------------------------------------------- CLI rules
RULES = [
    ("hnl_test", "hnmb9", HNL[:2] + ["--multi-pass", "2"],
     SystemExit, "--multi-pass 2 must divide the window length 9"),
    ("hnl_test", "hnmb", ["--window", "3", "--stream", "--multi-pass", "3"],
     SystemExit, "--stream caches the single-pass spliced graph"),
    ("test", "selsa", ["--aug-test", "--u8-transfer"], SystemExit,
     "--u8-transfer is not supported with --aug-test"),
    ("test", "selsa", ["--aug-test", "--batched", "2"], SystemExit,
     "--batched and --aug-test are exclusive"),
    ("test", "selsa", ["--aug-test", "--pair-features", "2"], ValueError,
     "do not combine"),
]


@pytest.mark.parametrize("cli,model,flags,error,message", RULES,
                         ids=[" ".join(r[2]) for r in RULES])
def test_aug_and_multi_pass_flag_rules_follow_jax(setup, cli, model, flags,
                                                  error, message):
    """The JAX CLIs' rules for what does not combine with ``--aug-test`` or
    ``--multi-pass``, with their messages (``--aug-test --pair-features``
    stops in the runner, which the JAX runner ignores silently)."""
    main = {"test": test_cli, "hnl_test": hnl_test}[cli].main
    with pytest.raises(error, match=message):
        main(_argv(setup, model, "never", *flags))
