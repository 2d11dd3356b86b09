"""Slice 1 end to end, and the port's boundary.

One synthetic video (uint8 frames, flags 0, 2, …, 2, 1) runs through the
JAX ``SlidingWindowRunner`` and the port's on the same weights: every frame
gets the same detections per class.  The port imports nothing of JAX or the
JAX package, and its entry points run on the card unless told otherwise.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.engine import SlidingWindowRunner as JaxRunner
from hvrnet_tpu_torch.engine import HNMBRCNN, SlidingWindowRunner
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_torch_port_backbone import (CANVAS, _nchw, shared_engines,
                                            uint8_frame)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


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
    return shared_engines(seed=2)


class _JaxMaps:
    """The port's engine, fed the JAX frame program's backbone maps: the
    runner then compares everything after the backbone, without the f32
    drift the backbones' different reduction orders leave in the maps."""

    def __init__(self, port, jeng, params):
        self.port, self.jeng, self.params = port, jeng, params

    def __getattr__(self, name):
        return getattr(self.port, name)

    def frame_features(self, img, img_shape, pad_shape):
        maps = self.jeng._backbone_dispatch(self.params, jnp.asarray(img),
                                            img_shape)
        return self.port.frame_post(
            *[torch.from_numpy(_nchw(m).copy()) for m in maps], img_shape,
            pad_shape)


@pytest.mark.parametrize("prepad", [False, True])
def test_video_matches_jax_runner(engines, prepad):
    """End to end, a smoke check: per frame and class the same number of
    detections, scores within 1e-4, and boxes within 1e-4 of the image scale
    (the backbone's f32 rounding moves proposals by up to ~1e-2 px, see
    test_torch_port_backbone.assert_close_to_scale).  ``prepad`` front-pads
    the window with other frames (the reference's random pre-padding)
    instead of copies of the first."""
    _compare_runners(engines, prepad, "port")


@pytest.mark.parametrize("prepad", [False, True])
def test_video_from_jax_maps_matches_jax_runner(engines, prepad):
    """Everything after the backbone, fed the JAX backbone maps: the same
    detections per frame and class, boxes within 1e-3 px, scores within
    1e-4."""
    _compare_runners(engines, prepad, "jax")


def _compare_runners(engines, prepad, maps):
    jeng, params, port = engines
    n = 6

    def provider(as_jax):
        if not prepad:
            return None
        return lambda first: list(_video(3, 11, as_jax))

    want = JaxRunner(jeng, params, branch=-1,
                     prepad_provider=provider(True)).run(_video(n, 9, True), n)
    emitted = []
    eng = _JaxMaps(port, jeng, params) if maps == "jax" else port
    got = SlidingWindowRunner(
        eng, branch=-1, flush_every=4, progress_hook=emitted.append,
        prepad_provider=provider(False)).run(_video(n, 9, False), n)
    assert sum(emitted) == n             # one detection per frame
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


def test_engine_computes_in_f32_whatever_the_tf32_flags(engines,
                                                         monkeypatch):
    """The engine turns TF32 off around its convolutions and matmuls (the
    frame program and the window step) and restores the caller's flags."""
    _, _, port = engines
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    for f in flags:
        monkeypatch.setattr(f, "allow_tf32", True)
    seen = set()
    hooks = [m.register_forward_pre_hook(
        lambda *_: seen.add(tuple(f.allow_tf32 for f in flags)))
        for m in port.model.modules()]
    try:
        frame = next(_video(1, 5, False))
        feats = port.frame_features(frame["img"], frame["img_shape"],
                                    frame["pad_shape"])
        ring = port.ring_reset(int(feats["fc1"].shape[-1]))
        port.ring_step(ring, feats, frame["img_shape"],
                       frame["scale_factor"])
    finally:
        for h in hooks:
            h.remove()
    assert seen == {(False, False)}
    assert all(f.allow_tf32 for f in flags)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "hvrnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "hvrnet_tpu"), \
                f"{path.relative_to(ROOT)} imports {name}"


def test_port_imports_no_image_library_at_module_level():
    """cv2 and PIL are not on the card machine: the port imports them only
    inside a function that a caller chose (the default decoder)."""
    files = sorted((ROOT / "hvrnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in ("cv2", "PIL"), \
                    f"{path.relative_to(ROOT)} imports {name}"


def test_port_imports_with_jax_blocked(tmp_path):
    """With JAX, the JAX package, cv2 and PIL blocked (as on the card
    machine), every port module imports (the backbone zoo's and
    ``roi_pool`` among them, which pools once), one frame of a VID tree goes
    through the test pipeline and the stream with an injected numpy
    decoder, a float frame through the training transforms, and an image
    through the single-image API's pipeline (``apis.image_input``)."""
    from tests.test_vid_dataset import TEST_PIPELINE, write_xml
    root = tmp_path / "VID"
    write_xml(str(root / "Annotations" / "v" / "000000.xml"), 72, 48,
              [("n02691156", (10, 8, 40, 32))])
    (root / "ImageSets").mkdir()
    (root / "ImageSets" / "VID_val_videos.txt").write_text("v 1 0 1\n")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'hvrnet_tpu', 'cv2', 'PIL'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np\n"
            "import hvrnet_tpu_torch.engine, hvrnet_tpu_torch.utils.weights\n"
            "import hvrnet_tpu_torch.engine.calibrate, hvrnet_tpu_torch.apis\n"
            "import hvrnet_tpu_torch.core.precision\n"
            "import hvrnet_tpu_torch.data, hvrnet_tpu_torch.core.evaluation\n"
            "import hvrnet_tpu_torch.utils.dist_io\n"
            "import torch\n"
            "from hvrnet_tpu_torch.models.backbones import hrnet, res2net\n"
            "from hvrnet_tpu_torch.models import plugins\n"
            "from hvrnet_tpu_torch.models.necks import hrfpn\n"
            "from hvrnet_tpu_torch.ops.roi_pool import roi_pool\n"
            "assert roi_pool(torch.ones(1, 2, 4, 4), torch.tensor(\n"
            "    [[0., 0., 0., 3., 3.]]), 2, 1.0).shape == (1, 2, 2, 2)\n"
            "from hvrnet_tpu_torch.tools import hnl_test, test, train, "
            "vid_eval\n"
            "import hvrnet_tpu_torch.engine.eval_hook\n"
            "from hvrnet_tpu_torch.data import pipelines\n"
            "from hvrnet_tpu_torch.data import VIDSeqDataset\n"
            "from hvrnet_tpu_torch.engine.stream import test_frame_stream\n"
            "def imread(path):\n"
            "    return np.full((48, 72, 3), 7, np.uint8)\n"
            f"ds = VIDSeqDataset(ann_file={str(root / 'ImageSets' / 'VID_val_videos.txt')!r},\n"
            f"                   img_prefix={str(root)!r}, test_mode=True,\n"
            f"                   pipeline={TEST_PIPELINE!r}, imread=imread)\n"
            "frame, = test_frame_stream(ds, max_long=96, max_short=64)\n"
            "assert frame['img'].shape == (1, 64, 96, 3), frame['img'].shape\n"
            "assert frame['key_frame_flag'] == 1\n"
            "steps = [dict(type=t) for t in ('PhotoMetricDistortion', "
            "'Expand', 'MinIoURandomCrop')]\n"
            "steps.append(dict(type='Resize', img_scale=(96, 64)))\n"
            "r = pipelines.Compose(steps, np.random.RandomState(0))(dict(\n"
            "    img=np.full((48, 72, 3), 9, np.float32),\n"
            "    gt_bboxes=np.float32([[10, 8, 40, 32]]),\n"
            "    gt_labels=np.int64([1]), bbox_fields=['gt_bboxes']))\n"
            "assert r['img'].dtype == np.float32\n"
            "from hvrnet_tpu_torch.apis import image_input\n"
            "from hvrnet_tpu_torch.utils.config import Config\n"
            "x = image_input(Config(dict(img_norm_cfg=dict(\n"
            "    mean=[1., 2., 3.], std=[1., 1., 1.]))),\n"
            "    np.full((30, 50, 3), 9, np.uint8))\n"
            "assert x['img'].shape == (1, 608, 1008, 3), x['img'].shape\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         timeout=120, capture_output=True, text=True)
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("cli", ["hnl_test", "test", "train"])
def test_clis_need_a_card_unless_told_cpu(cli):
    """The CLIs run on the card by default and stop without one, before
    reading any data."""
    import importlib
    main = importlib.import_module(f"hvrnet_tpu_torch.tools.{cli}").main
    config = str(ROOT / "configs" / "faster_rcnn_r101_hrnmp_c5.py")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([config] + ([] if cli == "train" else ["--out", "unused.pkl"]))


def test_entry_points_default_to_the_card():
    model_cfg, test_cfg = tiny_hnmb_cfg()
    if torch.cuda.is_available():
        assert HNMBRCNN(model_cfg, test_cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HNMBRCNN(model_cfg, test_cfg)
