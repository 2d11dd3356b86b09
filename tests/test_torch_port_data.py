"""The port's data layer against the JAX package's, on synthetic VID trees.

XML parsing, the cv2-exact bilinear resize, the test iterator's frames as
``test_frame_stream`` yields them (under ``video_shuffle`` and one seed:
the port's dataset generator against numpy's global state), whole-video
sharding, the mAP evaluation and the COCO json of the results.  The trees
are ``tests/test_vid_dataset.py:build_mini_vid``'s two landscape videos
plus a portrait video and one that the pipeline scales down.
"""
import json
import os
import os.path as osp
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from hvrnet_tpu.core import evaluation as jax_eval
from hvrnet_tpu.data import VIDSeqDataset as JaxVIDSeqDataset
from hvrnet_tpu.data import vid_dataset as jax_vid
from hvrnet_tpu.engine.stream import test_frame_stream as jax_frame_stream
from hvrnet_tpu_torch.core import evaluation as port_eval
from hvrnet_tpu_torch.data import pipelines, vid_dataset
from hvrnet_tpu_torch.data.resize import resize_bilinear_u8
from hvrnet_tpu_torch.engine import HNMBRCNN
from hvrnet_tpu_torch.engine import stream as port_stream
from hvrnet_tpu_torch.engine.canvas import pad_to_canvas, pick_canvas_shape
from tests.test_engine_hnmb import tiny_hnmb_cfg
from tests.test_vid_dataset import TEST_PIPELINE, build_mini_vid, write_xml

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CANVAS = dict(max_long=96, max_short=64)
# (video path, frames, (height, width), wnid) added to build_mini_vid's two
EXTRA_VIDEOS = (("val/ILSVRC2015_val_00000002", 4, (72, 48), "n02084071"),
                ("val/ILSVRC2015_val_00000003", 4, (150, 200), "n02121808"))


def add_video(root, vpath, n, hw, wnid, seed):
    """Append a video of ``n`` random ``hw`` frames, each with a moving box
    and, from the second frame on, a box of a name outside the 30 classes,
    to the tree's val imageset."""
    rng = np.random.default_rng(seed)
    h, w = hw
    ann_file = osp.join(root, "ImageSets", "VID_val_videos.txt")
    lines = [ln for ln in open(ann_file).read().splitlines() if ln]
    last = lines[-1].split(" ")
    frame_id = int(last[1]) + int(last[3])
    for i in range(n):
        img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        box = (4 + i, 6, w // 2 + i, h // 2)
        img[box[1]:box[3], box[0]:box[2]] = (30, 200, 60)
        ipath = osp.join(root, "JPEGImages", vpath, f"{i:06d}.JPEG")
        os.makedirs(osp.dirname(ipath), exist_ok=True)
        cv2.imwrite(ipath, img)
        objs = [(wnid, box)] + ([("n00000000", (1, 1, 5, 5))] if i else [])
        write_xml(osp.join(root, "Annotations", vpath, f"{i:06d}.xml"),
                  w, h, objs)
    lines.append(f"{vpath} {frame_id} 0 {n}")
    with open(ann_file, "w") as f:
        f.write("\n".join(lines) + "\n")


def build_tree(root):
    build_mini_vid(root, [("val/ILSVRC2015_val_00000000", 5, "n02691156"),
                          ("val/ILSVRC2015_val_00000001", 3, "n02958343")])
    for k, video in enumerate(EXTRA_VIDEOS):
        add_video(root, *video, seed=k)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_tree(str(tmp_path_factory.mktemp("VID")))


def ann_file(root):
    return osp.join(root, "ImageSets", "VID_val_videos.txt")


def datasets(root, world_size=1, seed=0, video_shuffle=True):
    """(JAX dataset, port dataset) over the tree, test mode; numpy's global
    state seeded as the port's generator."""
    kw = dict(ann_file=ann_file(root), img_prefix=root,
              pipeline=TEST_PIPELINE, test_mode=True, world_size=world_size,
              video_shuffle=video_shuffle)
    port = vid_dataset.VIDSeqDataset(seed=seed, **kw)
    np.random.seed(seed)
    return JaxVIDSeqDataset(**kw), port


# ------------------------------------------------------------------ XML
@pytest.mark.parametrize("route", ["default", "elementtree"])
def test_parse_vid_xml_matches_jax(tree, route, monkeypatch):
    """Every annotation of the tree (unknown names skipped, boxes 0-based,
    labels 1-based) equal to JAX's, through its default route (the native
    scanner where it is built) and through ElementTree."""
    if route == "elementtree":
        from hvrnet_tpu.data import native
        monkeypatch.setattr(native, "parse_xml_fast", lambda *a: None)
    class_to_index = {c: i for i, c in enumerate(("__background__",)
                                                 + jax_vid.VID_WNIDS)}
    paths = sorted(Path(tree, "Annotations").rglob("*.xml"))
    assert len(paths) == 16
    for path in paths:
        want = jax_vid.parse_vid_xml(str(path), class_to_index)
        got = vid_dataset.parse_vid_xml(str(path), class_to_index)
        assert got[1:] == want[1:]
        for key in want[0]:
            assert got[0][key].dtype == want[0][key].dtype
            np.testing.assert_array_equal(got[0][key], want[0][key])
    assert vid_dataset.VID_WNIDS == jax_vid.VID_WNIDS
    assert vid_dataset.VID_CLASSES == jax_vid.VID_CLASSES


# --------------------------------------------------------------- resize
RESIZE_CASES = [
    ((720, 1280), (1000, 563)),     # VID's common frame at (1000, 600)
    ((1080, 1920), (1000, 563)),
    ((48, 72), (96, 64)),
    ((375, 500), (800, 600)),
    ((500, 333), (400, 600)),
    ((960, 540), (563, 1000)),      # portrait
    ((17, 13), (5, 7)),             # odd sizes, down
    ((13, 17), (41, 29)),           # odd sizes, up
    ((101, 99), (100, 100)),
    ((64, 96), (48, 32)),           # an exact halving: cv2's area path
    ((1, 1), (5, 3)),               # 1-pixel edges
    ((1, 7), (3, 1)),
    ((7, 1), (1, 9)),
    ((2, 2), (1, 1)),
]


@pytest.mark.parametrize("src,dsize", RESIZE_CASES,
                         ids=[f"{s[1]}x{s[0]}-{d[0]}x{d[1]}"
                              for s, d in RESIZE_CASES])
def test_resize_is_cv2_bit_for_bit(src, dsize):
    rng = np.random.default_rng(sum(src) + sum(dsize))
    for shape in (src + (3,), src):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)
        got = resize_bilinear_u8(img, dsize)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_resize_refuses_float_images():
    with pytest.raises(TypeError, match="uint8"):
        resize_bilinear_u8(np.zeros((4, 4, 3), np.float32), (2, 2))


# ------------------------------------------------------------- pipeline
def test_decoder_is_injected_and_cv2_only_on_demand(tree, monkeypatch):
    """A decoder callable replaces cv2; the default names cv2 and, when
    cv2 is missing, says to pass a decoder."""
    seen = []

    def imread(path):
        seen.append(path)
        return cv2.imread(path, cv2.IMREAD_COLOR)

    _, port = datasets(tree)
    own = vid_dataset.VIDSeqDataset(
        ann_file=ann_file(tree), img_prefix=tree, pipeline=TEST_PIPELINE,
        test_mode=True, imread=imread)
    a, b = port[0], own[0]
    np.testing.assert_array_equal(a["img"], b["img"])
    assert len(seen) == 1 and seen[0].endswith(".JPEG")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="pass a decoder"):
        port[1]


@pytest.mark.parametrize("name", sorted(pipelines.NOT_PORTED))
def test_training_transforms_are_not_ported_yet(name):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        pipelines.build_transform(dict(type=name))


# --------------------------------------------------------------- frames
FRAME_KEYS = ("img_shape", "pad_shape", "scale_factor", "key_frame_flag",
              "frame_offset", "seg_len", "frame_start_id")


@pytest.mark.parametrize("world_size", [1, 2])
def test_frame_stream_matches_jax(tree, world_size):
    """Every frame of every rank's stream equal to JAX's, bit for bit
    (image, shapes, scale, flags, offsets, ids), under ``video_shuffle``
    with one seed; each rank from a fresh dataset, as its own process
    would run it.  A portrait video switches the canvas mid-run."""
    shapes = set()
    n = 0
    for rank in range(world_size):
        jds, pds = datasets(tree, world_size, seed=5)
        want = list(jax_frame_stream(jds, rank=rank, **CANVAS))
        got = list(port_stream.test_frame_stream(pds, rank=rank, **CANVAS))
        assert len(got) == len(want) == pds.local_frame_size_list[rank]
        for w, g in zip(want, got):
            assert isinstance(g["img"], np.ndarray)
            assert g["img"].dtype == np.float32
            np.testing.assert_array_equal(g["img"], np.asarray(w["img"]))
            for key in FRAME_KEYS:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                assert type(g[key]) is type(w[key]), key
            shapes.add(g["img"].shape)
        n += len(got)
    assert n == 16
    assert shapes == {(1, 64, 96, 3), (1, 96, 64, 3)}


def test_shuffle_follows_the_seed_across_videos(tree):
    """The flip draw at ratio 0 is part of the sequence: skipping it moves
    the second video's order.  Two seeds give two orders; one seed one."""
    def offsets(seed):
        _, pds = datasets(tree, seed=seed)
        return [f["frame_offset"]
                for f in port_stream.test_frame_stream(pds, **CANVAS)]

    assert offsets(3) == offsets(3)
    assert offsets(3) != offsets(4)
    np.random.seed(3)
    order = []
    for n in (5, 3, 4, 4):                 # no draw per frame: wrong order
        idx = list(range(n))
        np.random.shuffle(idx)
        order += idx
    assert offsets(3)[:5] == order[:5] and offsets(3) != order


def test_u8_stream_gives_the_same_engine_input(tree):
    """``u8_transfer`` frames (no host Normalize, uint8 canvas normalised
    by the engine) give the float stream's engine input exactly, with the
    same frame order and metadata."""
    model_cfg, test_cfg = tiny_hnmb_cfg()
    engine = HNMBRCNN(model_cfg, test_cfg, device="cpu")
    _, a = datasets(tree, seed=1)
    _, b = datasets(tree, seed=1)
    pairs = zip(port_stream.test_frame_stream(a, **CANVAS),
                port_stream.test_frame_stream(b, u8_transfer=True,
                                              **CANVAS))
    for f, u in pairs:
        assert u["img"].dtype == np.uint8
        for key in FRAME_KEYS:
            np.testing.assert_array_equal(u[key], f[key])
        got = engine._to_input(u["img"], u["img_shape"])
        want = engine._to_input(f["img"], f["img_shape"])
        assert torch.equal(got, want)


@pytest.mark.parametrize("world_size", [1, 2, 3, 5])
def test_get_indices_matches_jax(tree, world_size):
    """Whole videos dealt to ranks and the per-rank frame_id rebasing."""
    jds, pds = datasets(tree, world_size)
    assert pds.indices_list == jds.indices_list
    assert pds.local_frame_size_list == jds.local_frame_size_list
    assert pds.global_video_list == jds.global_video_list
    assert [v["frame_id"] for v in pds.img_infos] == \
        [v["frame_id"] for v in jds.img_infos]
    assert len(pds) == len(jds) == 16


def test_stateful_gt_iterator_matches_jax(tree):
    """``get_ann_info`` walks the frames in dataset order whatever its
    index says within a video."""
    jds, pds = datasets(tree)
    for i in range(len(jds)):
        want, got = jds.get_ann_info(i), pds.get_ann_info(i)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_canvas_helpers_match_jax():
    from hvrnet_tpu.engine import canvas as jax_canvas
    for hw in ((563, 1000), (1000, 563), (600, 600), (64, 96)):
        assert pick_canvas_shape(*hw) == jax_canvas.pick_canvas_shape(*hw)
    img = np.arange(2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3)
    np.testing.assert_array_equal(pad_to_canvas(img, (4, 5)),
                                  jax_canvas.pad_to_canvas(img, (4, 5)))
    with pytest.raises(ValueError):
        pad_to_canvas(img, (1, 5))


# ------------------------------------------------------------------- mAP
def random_results(seed, n_frames=12, n_classes=30):
    """Detections near seeded ground truth, with empty frames, empty
    classes, score ties and ignored boxes."""
    rng = np.random.default_rng(seed)
    dets, gts, labels, ignore = [], [], [], []
    for f in range(n_frames):
        n_gt = int(rng.integers(0, 4))
        xy = rng.uniform(0, 80, (n_gt, 2))
        wh = rng.uniform(4, 40, (n_gt, 2))
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        lab = rng.integers(1, 4, n_gt).astype(np.int64)
        gts.append(gt)
        labels.append(lab)
        ignore.append(rng.random(n_gt) < 0.2)
        frame = []
        for c in range(n_classes):
            own = gt[lab == c + 1]
            k = int(rng.integers(0, 4)) if c < 4 else 0
            boxes = rng.uniform(0, 80, (k, 2))
            boxes = np.concatenate([boxes, boxes + rng.uniform(4, 40, (k, 2))],
                                   1)
            if len(own):
                jitter = own + rng.normal(0, 2, own.shape)
                boxes = np.concatenate([boxes, jitter])
            scores = np.round(rng.random((len(boxes), 1)), 1)   # ties
            frame.append(np.concatenate([boxes, scores], 1)
                         .astype(np.float32))
        dets.append(frame)
    return dets, gts, labels, ignore


def assert_eval_equal(got, want):
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("dataset", ["classes", "vid"])
@pytest.mark.parametrize("iou_thr", [0.5, 0.7])
def test_eval_map_matches_jax(dataset, iou_thr):
    """``eval_map`` with tpfp_default (a class-name tuple, as vid_eval
    passes) and tpfp_imagenet ('vid'), with and without ignored GT and
    scale ranges: the same mAP and per-class tp/fp curves, exactly."""
    ds = jax_vid.VID_CLASSES if dataset == "classes" else "vid"
    dets, gts, labels, ignore = random_results(int(iou_thr * 10))
    maps = []
    for kw in (dict(), dict(gt_ignore=ignore),
               dict(scale_ranges=[(0, 20), (20, 1e5)])):
        want = jax_eval.eval_map(dets, gts, labels, iou_thr=iou_thr,
                                 dataset=ds, print_summary=False, **kw)
        got = port_eval.eval_map(dets, gts, labels, iou_thr=iou_thr,
                                 dataset=ds, print_summary=False, **kw)
        assert_eval_equal(got, want)
        maps.append(np.mean(want[0]))
    assert min(maps) > 0


def test_analysis_map_matches_jax(tmp_path, capsys):
    dets, gts, labels, _ = random_results(3)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    want = jax_eval.analysis_map(dets, gts, labels, dataset=jax_vid.VID_CLASSES,
                                 file_dir=str(tmp_path / "jax"))
    got = port_eval.analysis_map(dets, gts, labels,
                                 dataset=vid_dataset.VID_CLASSES,
                                 file_dir=str(tmp_path / "port"))
    assert_eval_equal(got, want)
    assert (tmp_path / "port" / "analysis_map.txt").read_text() == \
        (tmp_path / "jax" / "analysis_map.txt").read_text()
    port_eval.print_map_summary(got[0], got[1], vid_dataset.VID_CLASSES)
    assert "mAP" in capsys.readouterr().out


def test_class_names_match_jax():
    for alias in ("vid", "voc", "det", "coco", "cityscapes", "wider_face"):
        assert port_eval.get_classes(alias) == jax_eval.get_classes(alias)


def test_vid_results2json_matches_jax(tree, tmp_path):
    sys.path.insert(0, str(ROOT))
    from tools.test import vid_results2json as jax_json
    from hvrnet_tpu_torch.tools.test import vid_results2json
    jds, pds = datasets(tree)
    dets, *_ = random_results(7, n_frames=len(pds))
    dets[2] = None
    dets[3] = [[np.zeros((0, 5), np.float32)] * 30, dets[3]]  # a pair
    want = jax_json(jds, dets, str(tmp_path / "jax.json"))
    got = vid_results2json(pds, dets, str(tmp_path / "port.json"))
    assert json.loads(Path(got).read_text()) == \
        json.loads(Path(want).read_text())
