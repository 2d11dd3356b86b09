"""The port's SELSA ``test`` CLI against the JAX package's ``tools/test.py``
(what ``tools/selsa_test.py`` runs), in-process on the synthetic VID tree
and one checkpoint file, as ``tests/test_torch_port_cli.py`` runs
``hnl_test``; the port's ``--u8-transfer`` and ``--bf16`` runs; and
``HNLRCNN`` through the trainer.
"""
import numpy as np
import pytest
import torch

from hvrnet_tpu.engine import SelsaRCNN as JaxSelsaRCNN
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine import SelsaRCNN
from hvrnet_tpu_torch.engine.train import HNMBTrainer
from hvrnet_tpu_torch.tools import hnl_test
from hvrnet_tpu_torch.tools import test as test_cli
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_engine_selsa import tiny_selsa_cfg
from tests.test_torch_port_cli import (assert_cli_matches, fill_gaps,
                                       jax_backbone, jax_cli, load, port_args,
                                       shared_checkpoint, write_config)
from tests.test_torch_port_data import build_tree

torch.set_num_threads(2)

# the two backbones' f32 rounding moves one score of this tree's SELSA run
# by 1.245e-4 end to end (see tests/test_torch_port_cli.py's docstring)
END_TO_END_SCORE_TOL = 2e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(config path, checkpoint path, work dir, JAX CLI results path)."""
    work = tmp_path_factory.mktemp("selsa_cli")
    root = build_tree(str(work / "VID"))
    model_cfg, test_cfg = tiny_selsa_cfg()
    cfg = write_config(work / "tiny_selsa.py", model_cfg, test_cfg, root)
    ckpt = shared_checkpoint(work / "tiny_selsa.pth", model_cfg, test_cfg,
                             JaxSelsaRCNN, SelsaRCNN, root, seed=6)
    want = work / "jax.pkl"
    jax_cli("test", [cfg, ckpt, "--out", str(want), "--tmpdir",
                     str(work / "jax_parts")], seed=1)
    return cfg, ckpt, work, str(want)


@pytest.fixture(scope="module")
def port_run(setup):
    cfg, ckpt, work, _ = setup
    out = work / "port.pkl"
    run = test_cli.main(port_args(cfg, ckpt, out, "--seed", "1", "--eval",
                                  "--json_out", str(work / "port"),
                                  "--tmpdir", str(work / "port_parts")))
    return run, out


@pytest.mark.parametrize("backbone", ["port", "jax"])
def test_selsa_test_cli_matches_jax(setup, port_run, backbone):
    """Per frame and class the same detections as the JAX CLI (limits of
    ``tests/test_torch_port_cli.py:assert_cli_matches``), an mAP in
    [0, 1], and a COCO json with one entry per detection; ``backbone``
    "jax" takes the backbone maps from the JAX frame program."""
    import json
    cfg, ckpt, work, want = setup
    run, out = port_run
    if backbone == "jax":
        out = work / "port_jax_maps.pkl"
        with jax_backbone(*tiny_selsa_cfg(), JaxSelsaRCNN, ckpt):
            run = test_cli.main(port_args(
                cfg, ckpt, out, "--seed", "1", "--eval", "--tmpdir",
                str(work / "port_jax_maps")))
    assert_cli_matches(load(out), load(want), backbone,
                       END_TO_END_SCORE_TOL)
    assert 0.0 <= run["map"] <= 1.0
    if backbone == "port":
        dets = json.loads((work / "port.bbox.json").read_text())
        assert len(dets) == sum(len(c) for frame in load(out) for c in frame)


def test_u8_transfer_matches_the_float_run(setup, port_run):
    """``--u8-transfer``: the same frames (order and engine input, see
    ``tests/test_torch_port_data.py``), so the same detections, bit for
    bit."""
    cfg, ckpt, work, _ = setup
    run, _ = port_run
    u8 = test_cli.main(port_args(cfg, ckpt, work / "u8.pkl", "--seed", "1",
                                 "--u8-transfer", "--tmpdir",
                                 str(work / "u8_parts")))
    for a, b in zip(u8["results"], run["results"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_bf16_cli_runs(setup, tmp_path):
    """``--bf16`` on both CLIs: every frame a 30-class result with finite
    boxes (the bf16 policy itself is held to JAX in
    ``tests/test_torch_port_precision.py``)."""
    cfg, ckpt, _, _ = setup
    runs = [test_cli.main(port_args(cfg, ckpt, tmp_path / "s.pkl", "--bf16",
                                    "--tmpdir", str(tmp_path / "s")))]
    root = str(tmp_path / "VID")
    build_tree(root)
    model_cfg, test_cfg = tiny_hnmb_cfg()
    hcfg = write_config(tmp_path / "h.py", model_cfg, test_cfg, root)
    runs.append(hnl_test.main(port_args(
        hcfg, None, tmp_path / "h.pkl", "--bf16", "--window", "3",
        "--stream", "--tmpdir", str(tmp_path / "h"))))
    for run in runs:
        assert run["runner"].engine.dtype == torch.bfloat16
        assert len(run["results"]) == 16
        for frame in run["results"]:
            assert len(frame) == 30
            assert all(np.isfinite(c).all() and c.shape[1] == 5
                       for c in frame)


REFUSED = [["--spmd-lanes", "--batched", "2"], ["--show"]]


@pytest.mark.parametrize("flag", REFUSED, ids=[f[0] for f in REFUSED])
def test_test_cli_refuses_unported_flags(setup, flag):
    cfg, ckpt, work, _ = setup
    with pytest.raises(SystemExit, match="not ported yet \\(ROADMAP Queue "
                                         "1 item [67]"):
        test_cli.main(port_args(cfg, ckpt, work / "no.pkl", *flag))


@pytest.mark.parametrize("flag", [["--show-dir", "vis"],
                                  ["--show-thr", "0.5"]])
def test_test_cli_has_no_show_options(setup, flag, capsys):
    """``--show``'s options come back with ``--show``; until then argparse
    rejects them."""
    cfg, ckpt, work, _ = setup
    with pytest.raises(SystemExit) as stop:
        test_cli.main(port_args(cfg, ckpt, work / "no.pkl", *flag))
    assert stop.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_window_is_one_quantity(setup):
    """``test --window W`` sets what the JAX ``test`` sets: the engine's
    window and its key frame ``(W - 1) // 2``, for odd and even W; the
    head keeps the config's t_dim and the dataset its frame_interval.
    ``hnl_test``'s own setter also sets the head's t_dim and key_dim."""
    from hvrnet_tpu_torch.utils.config import Config
    cfg, _, _, _ = setup
    for window in (7, 6):
        c = Config.fromfile(cfg)
        eng = SelsaRCNN(c.model, c.test_cfg, device="cpu")
        test_cli.set_window(eng, window)
        assert (eng.window, eng.key_dim) == (window, (window - 1) // 2)
        assert eng.model.bbox_head.t_dim == 3
        assert c.test_cfg.relation_setup.frame_interval == 1
        hnl_test.set_head_window(c, window)
        assert (c.test_cfg.bbox_head.t_dim, c.test_cfg.bbox_head.key_dim) \
            == (window, (window - 1) // 2)
        assert c.test_cfg.relation_setup.frame_interval == 1
    with pytest.raises(SystemExit, match="at least 1"):
        test_cli.set_window(eng, 0)


@pytest.mark.parametrize("window", [5, 4])
def test_window_above_the_config_matches_jax(setup, window):
    """``test --window W`` above the tiny config's t_dim 3, odd and even:
    both CLIs keep the head's t_dim, so the head keys the first
    ``sampler_num·t_dim`` = 24 of the window's W·8 rows, and detect frame
    ``(W - 1) // 2``.  The port's run holds the JAX CLI's detections at
    the limits of ``assert_cli_matches`` with the JAX backbone maps, and
    at W = 4 the same undetected last frames (``fill_gaps``; the
    lockstep route is held in ``tests/test_torch_port_batched_cli.py``)."""
    cfg, ckpt, work, _ = setup
    want = work / f"jax_w{window}.pkl"
    jax_cli("test", [cfg, ckpt, "--window", str(window), "--out", str(want),
                     "--tmpdir", str(work / f"jax_w{window}")], seed=1)
    out = work / f"port_w{window}.pkl"
    with jax_backbone(*tiny_selsa_cfg(), JaxSelsaRCNN, ckpt):
        run = test_cli.main(port_args(
            cfg, ckpt, out, "--seed", "1", "--window", str(window),
            "--tmpdir", str(work / f"port_w{window}")))
    assert (run["runner"].window, run["runner"].key_dim) == \
        (window, (window - 1) // 2)
    assert run["runner"].engine.model.bbox_head.t_dim == 3
    (got, gaps), (want, want_gaps) = fill_gaps(load(out)), fill_gaps(
        load(want))
    assert gaps == want_gaps and len(gaps) == (4 if window == 4 else 0)
    assert_cli_matches(got, want, "jax")


@pytest.fixture
def work_dir(tmp_path):
    import shutil
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_hnlrcnn_trains_with_the_hnmb_trainer(work_dir):
    """``apis.train_detector`` trains an ``HNLRCNN`` with ``HNMBTrainer``:
    one step from the same weights and batch leaves the same parameters as
    an ``HNMBRCNN``'s, bit for bit."""
    import jax
    from tests.test_torch_port_train import OPT, _tiny_cfgs, triplet_sample
    model_cfg, train_cfg = _tiny_cfgs()
    batches = [jax.tree_util.tree_map(lambda x: x[0], triplet_sample(2))]
    states = []
    for kind in ("HNLRCNN", "HNMBRCNN"):
        eng = apis.build_detector(dict(model_cfg, type=kind),
                                  train_cfg=train_cfg, device="cpu", seed=3)
        trainer = apis.train_detector(eng, batches, dict(OPT, total_epochs=1),
                                      str(work_dir / kind), seed=4,
                                      calibrate_bn=True)
        assert type(trainer) is HNMBTrainer and trainer.step == 1
        states.append(eng.model.state_dict())
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


def test_load_params_for_engine(setup, tmp_path, caplog):
    """A checkpoint (the port's own, or a bare mmdet ``state_dict``) loads
    onto an engine; missing tensors keep the engine's values with a warning
    that counts them; an unknown name or another shape raises."""
    import logging
    _, ckpt, _, _ = setup
    model_cfg, test_cfg = tiny_selsa_cfg()
    state = torch.load(ckpt, weights_only=True)["state_dict"]
    eng = apis.build_detector(model_cfg, None, test_cfg, device="cpu",
                              seed=9)
    own = eng.model.state_dict()["bbox_head.fc_cls.weight"].clone()
    bare = tmp_path / "bare.pth"
    torch.save({k: v for k, v in state.items()
                if not k.startswith("bbox_head.fc_cls.")}, bare)
    with caplog.at_level(logging.WARNING, logger="hvrnet_tpu_torch"):
        apis.load_params_for_engine(eng, str(bare))
    assert "missing 2 tensors" in caplog.text
    got = eng.model.state_dict()
    assert torch.equal(got["bbox_head.fc_cls.weight"], own)
    assert torch.equal(got["backbone.conv1.weight"],
                       state["backbone.conv1.weight"])
    apis.load_params_for_engine(eng, ckpt)
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    # a reference BatchNorm2d state_dict also carries num_batches_tracked
    counted = tmp_path / "counted.pth"
    torch.save({"state_dict": dict(state, **{
        k[:-len("running_var")] + "num_batches_tracked": torch.tensor(0)
        for k in state if k.endswith(".running_var")})}, counted)
    seeded = apis.build_detector(model_cfg, None, test_cfg, device="cpu",
                                 seed=9)
    apis.load_params_for_engine(seeded, str(counted))
    for k, v in seeded.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    fresh = apis.build_detector(model_cfg, None, test_cfg, device="cpu",
                                seed=9)
    extra = tmp_path / "extra.pth"
    torch.save(dict(state, **{"neck.weight": torch.zeros(1)}), extra)
    with pytest.raises(KeyError, match="does not have"):
        apis.load_params_for_engine(fresh, str(extra))
    assert torch.equal(fresh.model.state_dict()["bbox_head.fc_cls.weight"],
                       own)                        # nothing was loaded
    wrong = tmp_path / "wrong.pth"
    torch.save(dict(state, **{"backbone.conv1.weight": torch.zeros(1)}),
               wrong)
    with pytest.raises(ValueError, match="shape mismatch"):
        apis.load_params_for_engine(eng, str(wrong))
