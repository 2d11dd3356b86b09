"""The port's ``tools/train.py`` on the CPU, on the tiny training tree of
``tests/test_torch_port_train_data.py`` and the val tree of
``tests/test_torch_port_data.py``, with the tiny HNMB and SELSA configs
(``tiny_hnmb_cfg``, ``tiny_selsa_cfg``; the train sections of
``tests/test_train_step.py:tiny_train_cfg``) written as config files, as
``tests/test_cli_e2e.py`` does.

Both pipelines resize to (96, 96) and train on a 96 × 96 canvas, which
holds frames of either orientation: the validation hook evaluates on the
training canvas, and ``hnl_test`` on its pipeline's, so the two agree.
The whole-step comparison with JAX is ``tests/test_torch_port_train.py``'s
and ``test_torch_port_selsa.py``'s; here the CLI, the loop, the hook and
the weights' hand-off.  Checkpoints go to the ``work_dir`` fixture, which
empties them.
"""
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import hvrnet_tpu.core.evaluation as jax_evaluation
from hvrnet_tpu.apis import load_params_for_engine as jax_load_params
from hvrnet_tpu.engine import HNMBRCNN as JaxHNMBRCNN
from hvrnet_tpu.engine.eval_hook import VidEvalHook as JaxVidEvalHook
from hvrnet_tpu_torch import apis
from hvrnet_tpu_torch.engine.train import BaseTrainer
from hvrnet_tpu_torch.tools import hnl_test, train
from hvrnet_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_engine_selsa import tiny_selsa_cfg
from tests.test_torch_port_cli import assert_cli_matches
from tests.test_torch_port_data import build_tree
from tests.test_torch_port_train import work_dir  # noqa: F401
from tests.test_torch_port_train_data import (TRAIN_PIPELINE,
                                              build_train_tree, det_cfg,
                                              vid_cfg)
from tests.test_train_step import tiny_train_cfg
from tests.test_vid_dataset import TEST_PIPELINE

torch.set_num_threads(2)

SCALE = (96, 96)
CANVAS = ["--canvas", "96", "96"]
SEED = 3


def scaled(pipeline):
    return [dict(t, img_scale=SCALE) if t["type"] == "Resize" else dict(t)
            for t in pipeline]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(VID train root, DET root, val root)."""
    root = tmp_path_factory.mktemp("trees")
    vid, det = build_train_tree(str(root / "train"))
    return vid, det, build_tree(str(root / "val"))


def write_config(path, model, train_cfg, test_cfg, train_data, val_root):
    val = dict(type="VIDSeqDataset",
               ann_file=f"{val_root}/ImageSets/VID_val_videos.txt",
               img_prefix=val_root, pipeline=scaled(TEST_PIPELINE))
    data = dict(train=train_data, val=val, test=val)
    Path(path).write_text(
        f"model = {model!r}\ntrain_cfg = {train_cfg!r}\n"
        f"test_cfg = {test_cfg!r}\ndata = {data!r}\n"
        "optimizer = dict(type='SGD', lr=1e-3, momentum=0.9, "
        "weight_decay=1e-4)\n"
        "optimizer_config = dict(grad_clip=dict(max_norm=35))\n"
        "lr_config = dict(step=[1], warmup_iters=2, warmup_ratio=1 / 3)\n"
        "checkpoint_config = dict(interval=1)\n"
        "evaluation = dict(interval=1)\ntotal_epochs = 1\n")
    return str(path)


def hnmb_config(path, trees):
    vid, _, val = trees
    model, test_cfg = tiny_hnmb_cfg()
    model["bbox_head"] = dict(model["bbox_head"], t_dim=9)
    train_data = [dict(vid_cfg(vid, hnl=True),
                       pipeline=scaled(TRAIN_PIPELINE))]
    return write_config(path, model, tiny_train_cfg(False, num=8), test_cfg,
                        train_data, val)


def cli(*argv):
    return train.main([*argv, "--device", "cpu", *CANVAS])


def test_train_cli_trains_validates_and_resumes(trees, work_dir):  # noqa: F811
    """HVRNet (27 frames a sample) for 2 epochs of 1 step with
    ``--calibrate-bn --validate``: checkpoints and a log with finite losses
    and each epoch's mAP; the hook's mAP on each epoch equals ``hnl_test
    --eval`` on that epoch's checkpoint at the same seed, exactly, and the
    JAX ``VidEvalHook`` on the same weights (loaded by the JAX package from
    the same file) within 1e-6; the last evaluation's detections equal
    ``hnl_test``'s; a resume from ``epoch_1.pth`` carries the step on."""
    cfg = hnmb_config(work_dir / "hnmb.py", trees)
    out = work_dir / "run"
    run = cli(cfg, "--work-dir", str(out), "--total-epochs", "2",
              "--max-steps-per-epoch", "1", "--seed", str(SEED),
              "--calibrate-bn", "--validate")
    assert run["trainer"].step == 2
    for name in ("epoch_1.pth", "epoch_2.pth", "latest.pth"):
        assert (out / name).is_file(), name
    assert load_checkpoint(str(out / "latest.pth"))["step"] == 2
    lines = [eval(line.replace("NaN", "float('nan')")) for line in
             (out / "train_log.jsonl").read_text().splitlines()]
    steps = [ln for ln in lines if "loss" in ln]
    maps = [ln for ln in lines if "mAP" in ln]
    assert len(steps) == 2 and [m["epoch"] for m in maps] == [0, 1]
    assert all(np.isfinite(v) for ln in steps for k, v in ln.items()
               if k.startswith(("loss", "acc")))

    for epoch, m in enumerate(maps):
        ckpt = str(out / f"epoch_{epoch + 1}.pth")
        tested = hnl_test.main([
            cfg, ckpt, "--device", "cpu", "--window", "3", "--pre-padding",
            "repeat", "--seed", str(SEED), "--eval", "--out",
            str(work_dir / f"hnl_{epoch}.pkl"), "--tmpdir",
            str(work_dir / f"hnl_{epoch}")])
        assert tested["map"] == m["mAP"]
    hook = run["eval_hook"]
    for a, b in zip(hook.results, tested["results"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))

    # the JAX hook on the last epoch's weights: its detections (taken on
    # their way to its eval_map) as the port hook's, within the CLI
    # comparisons' limits, and its mAP within 1e-6
    model, test_cfg = tiny_hnmb_cfg()
    jeng = JaxHNMBRCNN(model, None, test_cfg)
    params = jax_load_params(jeng, str(out / "epoch_2.pth"))
    jax_hook = JaxVidEvalHook(jeng, hook.dataset_cfg,
                              work_dir=str(work_dir / "jax"),
                              max_long=96, max_short=96)
    (work_dir / "jax").mkdir()
    seen, original = [], jax_evaluation.eval_map

    def eval_map(results, *args, **kw):
        seen.append(results)
        return original(results, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_evaluation, "eval_map", eval_map)
        np.random.seed(SEED)
        jax_map = jax_hook(params, 1)
    assert abs(jax_map - maps[1]["mAP"]) <= 1e-6
    assert_cli_matches(hook.results, seen[0], "port")

    resumed = cli(cfg, "--work-dir", str(work_dir / "resumed"),
                  "--total-epochs", "2", "--max-steps-per-epoch", "1",
                  "--seed", str(SEED), "--resume-from",
                  str(out / "epoch_1.pth"))
    assert resumed["trainer"].step == 2
    log = (work_dir / "resumed" / "train_log.jsonl").read_text()
    assert len(log.splitlines()) == 1 and '"epoch": 1' in log


def test_selsa_trains_on_the_vid_det_concat(trees, work_dir):  # noqa: F811
    """SELSA on VID + DET (``selsa_with_aug``, the shipped config's list),
    2 steps with finite losses from one pair of generators."""
    vid, det, val = trees
    model, test_cfg = tiny_selsa_cfg()
    train_data = [dict(vid_cfg(vid, selsa_with_aug=True),
                       pipeline=scaled(TRAIN_PIPELINE)),
                  dict(det_cfg(det, selsa_with_aug=True),
                       pipeline=scaled(TRAIN_PIPELINE))]
    cfg = write_config(work_dir / "selsa.py", model, tiny_train_cfg(True),
                       test_cfg, train_data, val)
    seen, step = [], BaseTrainer.train_step

    def recording(self, sample, noise=None):
        seen.append(sample["imgs"].shape)
        return step(self, sample, noise)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BaseTrainer, "train_step", recording)
        run = cli(cfg, "--work-dir", str(work_dir / "run"),
                  "--max-steps-per-epoch", "2", "--seed", "1",
                  "--calibrate-bn")
    ds = run["dataset"]
    assert [type(d).__name__ for d in ds.datasets] == ["VIDSeqDataset",
                                                       "DETSeqDataset"]
    assert ds.datasets[0].rng is ds.datasets[1].rng
    assert run["trainer"].step == 2 and seen == [(3, 96, 96, 3)] * 2
    lines = (work_dir / "run" / "train_log.jsonl").read_text().splitlines()
    assert len(lines) == 1          # the log interval is 50 steps
    assert "nan" not in lines[0].lower()


@pytest.mark.parametrize("flag", [["--n-devices", "4"],
                                  ["--coordinator", "localhost:1234"],
                                  ["--num-processes", "2"],
                                  ["--process-id", "1"]])
def test_multi_device_flags_are_refused(flag):
    config = str(Path(__file__).resolve().parents[1] / "configs"
                 / "faster_rcnn_r101_hrnmp_c5.py")
    with pytest.raises(SystemExit, match="Queue 1 item 6"):
        train.parse_args([config, *flag])
    train.parse_args([config, "--n-devices", "1"])


def test_autoscale_lr_quarters_the_rate(trees, tmp_path, monkeypatch):
    """One device: ``--autoscale-lr`` trains at lr / 4 (the JAX CLI's
    lr · devices / 4)."""
    cfg = hnmb_config(tmp_path / "hnmb.py", trees)
    seen = []
    monkeypatch.setattr(train, "train_detector",
                        lambda engine, data, cfg, **kw: seen.append(cfg))
    for extra in ([], ["--autoscale-lr"]):
        train.main([cfg, "--device", "cpu", "--work-dir", str(tmp_path),
                    *extra])
    assert [c["optimizer"]["lr"] for c in seen] == [1e-3, 1e-3 / 4]


def test_load_from_takes_a_reference_state_dict(tmp_path, caplog):
    """``train_detector(load_from=...)`` loads through
    ``load_params_for_engine``: a reference ``state_dict`` with BatchNorm
    counters loads (the counters dropped) and the missing tensors are
    counted; an unknown name raises."""
    from tests.test_torch_port_train import OPT, _tiny_cfgs, triplet_sample
    model_cfg, train_cfg = _tiny_cfgs()
    source = apis.build_detector(model_cfg, train_cfg=train_cfg,
                                 device="cpu", seed=5)
    state = source.model.state_dict()
    ref = {k: v for k, v in state.items() if not k.startswith("bbox_head.")}
    ref.update({k[:-len("running_var")] + "num_batches_tracked":
                torch.tensor(7) for k in state if k.endswith("running_var")})
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": ref}, path)
    batch = {k: v[0] for k, v in triplet_sample(0).items()}
    engine = apis.build_detector(model_cfg, train_cfg=train_cfg,
                                 device="cpu", seed=6)
    with caplog.at_level(logging.WARNING, logger="hvrnet_tpu_torch"):
        apis.train_detector(engine, [batch], OPT, str(tmp_path / "run"),
                            total_epochs=1, steps_per_epoch=1,
                            load_from=str(path))
    n_head = sum(k.startswith("bbox_head.") for k in state)
    assert f"missing {n_head} tensors" in caplog.text
    trained = engine.model.state_dict()
    assert torch.equal(trained["backbone.conv1.weight"],
                       state["backbone.conv1.weight"])
    torch.save({"state_dict": dict(ref, **{"neck.w": torch.zeros(1)})},
               path)
    with pytest.raises(KeyError, match="does not have"):
        apis.train_detector(engine, [batch], OPT, str(tmp_path / "bad"),
                            total_epochs=1, steps_per_epoch=1,
                            load_from=str(path))

