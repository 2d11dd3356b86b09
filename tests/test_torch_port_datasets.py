"""The port's still-image data layer against the JAX package's, on tiny
COCO, VOC, WIDER Face, Cityscapes, VID and DET trees under ``tmp_path``
(deleted at teardown):

- each dataset's ``img_infos``, ``flag``, ``CLASSES``, label maps and
  ``get_ann_info`` (ignored, dropped and capped boxes among them);
- training and test items through one pipeline with ``Albu`` (mmdet's
  example block, ``filter_lost_elements``, ``skip_img_without_anno``),
  ``Resize``, ``RandomFlip``, ``Normalize`` and ``Pad``: every image, box,
  label and ``img_meta`` equal, and the port's generator left where numpy's
  global state is after every item (the retry draws included);
- the three samplers' orders over several seeds, replica counts and
  ranks; ``PrefetchLoader``'s order at 1–4 workers against the JAX
  loader's, its raised worker exception, its second pass and its bounded
  lookahead (the three departures); ``build_dataloader`` in both modes,
  and in training mode at two workers;
- ``eval_recalls``, ``results2json`` (the json equal), ``coco_style_eval``
  and ``voc_eval`` (equal APs), the CLIs' ``main`` and the VOC converter.
"""
import json
import pickle
import shutil
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from hvrnet_tpu.core.evaluation import eval_recalls as jax_eval_recalls
from hvrnet_tpu.data import build_dataset as jax_build_dataset
from hvrnet_tpu.data import loader as jax_loader
from hvrnet_tpu.data.vid_dataset import parse_vid_xml as jax_parse_vid_xml
from hvrnet_tpu_torch.core.evaluation import eval_recalls
from hvrnet_tpu_torch.data import build_dataset, loader
from hvrnet_tpu_torch.data.vid_dataset import MAX_OBJECTS, parse_vid_xml
from hvrnet_tpu_torch.tools import coco_eval, voc_eval
from hvrnet_tpu_torch.tools.convert_datasets import pascal_voc
from tests.test_vid_dataset import write_xml
from tools import coco_eval as jax_coco_eval
from tools import voc_eval as jax_voc_eval
from tools.convert_datasets import pascal_voc as jax_pascal_voc

torch.set_num_threads(2)

VOC_NAMES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
             "cat", "chair", "cow")
# COCO-style categories with gaps in their ids, listed out of id order
COCO_CATS = [(1, "person"), (3, "car"), (2, "bicycle"), (7, "train"),
             (13, "stop sign"), (90, "toothbrush")]
SIZES = [(64, 48), (48, 64), (80, 40), (56, 56), (40, 72), (72, 52)]


def np_states_equal(a, b):
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2:] == b[2:]


def write_image(path, w, h, seed):
    path.parent.mkdir(parents=True, exist_ok=True)
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    ok, buf = cv2.imencode(".png", img)      # lossless, under any name
    assert ok
    path.write_bytes(buf.tobytes())


def coco_json(root, cats, n_img=6):
    """Images of ``SIZES``; per image a few boxes, a crowd box on image 1,
    a sub-pixel box on image 2, and image 3 with only a crowd box."""
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(n_img):
        w, h = SIZES[i % len(SIZES)]
        name = f"img{i:03d}.png"
        write_image(root / "images" / name, w, h, i)
        images.append(dict(id=100 + i, file_name=name, width=w, height=h))
        n = 0 if i == 3 else int(rng.integers(1, 4))
        for _ in range(n):
            x, y = (float(v) for v in rng.uniform(0, 20, 2))
            bw, bh = (float(v) for v in rng.uniform(8, 25, 2))
            anns.append(dict(image_id=100 + i, bbox=[x, y, bw, bh],
                             category_id=cats[int(rng.integers(len(cats)))][0],
                             iscrowd=0))
        if i in (1, 3):
            anns.append(dict(image_id=100 + i, bbox=[2.0, 3.0, 30.0, 20.0],
                             category_id=cats[0][0], iscrowd=1))
        if i == 2:
            anns.append(dict(image_id=100 + i, bbox=[5.0, 5.0, 0.5, 12.0],
                             category_id=cats[1][0], iscrowd=0))
    for k, a in enumerate(anns):
        a.update(id=k + 1, area=a["bbox"][2] * a["bbox"][3])
    path = root / "annotations.json"
    path.write_text(json.dumps(dict(
        images=images, annotations=anns,
        categories=[dict(id=c, name=n) for c, n in cats])))
    return str(path)


def xml_tree(prefix, names, ext, ids, seed=0, extra_names=()):
    """``Annotations/{id}.xml`` and ``JPEGImages/{id}{ext}`` per id, objects
    of ``names`` (and unknown ``extra_names``); returns the path for the
    imageset, ``ImageSets/Main/test.txt``, whose directory it makes."""
    rng = np.random.default_rng(seed)
    for k, img_id in enumerate(ids):
        w, h = SIZES[k % len(SIZES)]
        objs = []
        for _ in range(int(rng.integers(0 if k == 2 else 1, 4))):
            x1, y1 = (int(v) for v in rng.integers(1, 20, 2))
            objs.append((str(rng.choice(names + extra_names)),
                         (x1, y1, x1 + int(rng.integers(6, 25)),
                          y1 + int(rng.integers(6, 25)))))
        write_xml(str(prefix / "Annotations" / f"{img_id}.xml"), w, h, objs)
        write_image(prefix / "JPEGImages" / f"{img_id}{ext}", w, h, 50 + k)
    listing = prefix / "ImageSets" / "Main" / "test.txt"
    listing.parent.mkdir(parents=True, exist_ok=True)
    return listing


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    t = {}
    t["coco"] = dict(ann_file=coco_json(root / "coco", COCO_CATS),
                     img_prefix=str(root / "coco" / "images") + "/")
    t["city"] = dict(ann_file=coco_json(
        root / "city", [(24, "person"), (25, "rider"), (26, "car")]),
        img_prefix=str(root / "city" / "images") + "/")
    voc = root / "VOCdevkit" / "VOC2007"
    ids = [f"{i:06d}" for i in range(6)]
    listing = xml_tree(voc, VOC_NAMES, ".jpg", ids, extra_names=("cyclops",))
    listing.write_text("\n".join(ids) + "\n")
    shutil.copy(listing, listing.parent / "trainval.txt")
    t["voc"] = dict(ann_file=str(listing), img_prefix=str(voc) + "/")
    wider = root / "WIDER"
    listing = xml_tree(wider, ("face",), ".jpg", ids[:4], seed=1)
    listing.write_text("\n".join(f"{i} extra" for i in ids[:4]) + "\n")
    t["wider"] = dict(ann_file=str(listing), img_prefix=str(wider) + "/")
    vid = root / "VID"
    wnids = ("n02691156", "n02958343", "n01503061")
    vids = [f"val/v{v}/{f:06d}" for v in range(2) for f in range(3)]
    xml_tree(vid, wnids, ".JPEG", vids, seed=2)
    (vid / "vid.txt").write_text("".join(
        f"val/v{v} {3 * v + f + 1} {f} 3\n" for v in range(2)
        for f in range(3)))
    t["vid"] = dict(ann_file=str(vid / "vid.txt"), img_prefix=str(vid) + "/")
    det = root / "DET"
    dets = [f"train/d{i}" for i in range(4)]
    xml_tree(det, wnids, ".JPEG", dets, seed=3)
    (det / "det.txt").write_text("".join(f"{d} {i}\n"
                                         for i, d in enumerate(dets)))
    t["det"] = dict(ann_file=str(det / "det.txt"), img_prefix=str(det) + "/")
    t["root"] = root
    yield t
    shutil.rmtree(root, ignore_errors=True)


DATASET_TYPES = {"CocoDataset": "coco", "CityscapesDataset": "city",
                 "XMLDataset": "voc", "VOCDataset": "voc",
                 "WIDERFaceDataset": "wider", "VIDDataset": "vid",
                 "DETIMGDataset": "det"}
TEST_PIPELINE = [dict(type="LoadImageFromFile")]


def pair(trees, ds_type, test_mode, pipeline=TEST_PIPELINE, seed=0,
         **extra):
    cfg = dict(type=ds_type, pipeline=pipeline, test_mode=test_mode,
               **trees[DATASET_TYPES.get(ds_type, ds_type)], **extra)
    return (build_dataset(dict(cfg), dict(seed=seed)),
            jax_build_dataset(dict(cfg)))


def assert_ann_equal(a, b):
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("ds_type", sorted(DATASET_TYPES))
def test_dataset_matches_jax(trees, ds_type, test_mode):
    port, ref = pair(trees, ds_type, test_mode)
    assert port.img_infos == ref.img_infos
    assert tuple(port.CLASSES) == tuple(ref.CLASSES)
    assert hasattr(port, "flag") == hasattr(ref, "flag") == (not test_mode)
    if not test_mode:
        assert port.flag.dtype == ref.flag.dtype
        np.testing.assert_array_equal(port.flag, ref.flag)
        assert 0 < port.flag.sum() < len(port)      # both groups
    for attr in ("cat_ids", "cat2label", "year"):
        assert getattr(port, attr, None) == getattr(ref, attr, None)
    for i in range(len(ref)):
        assert_ann_equal(port.get_ann_info(i), ref.get_ann_info(i))


def test_coco_annotations_follow_the_rules(trees):
    """Crowd boxes ignored with x + w − 1 corners, a sub-pixel box
    dropped, labels by the json's category order, an all-crowd image."""
    port, _ = pair(trees, "CocoDataset", True)
    assert port.cat_ids == [c for c, _ in COCO_CATS]
    assert port.CLASSES == tuple(n for _, n in COCO_CATS)
    ann = port.get_ann_info(1)
    np.testing.assert_array_equal(ann["bboxes_ignore"],
                                  np.float32([[2, 3, 31, 22]]))
    assert len(port.get_ann_info(3)["bboxes"]) == 0
    anns = json.load(open(trees["coco"]["ann_file"]))["annotations"]
    subpixel = [a for a in anns if a["image_id"] == 102 and a["bbox"][2] < 1]
    kept = [a for a in anns if a["image_id"] == 102 and a["bbox"][2] >= 1]
    assert subpixel and len(port.get_ann_info(2)["bboxes"]) == len(kept)


def test_voc_year_and_unknown_classes(trees):
    port, ref = pair(trees, "VOCDataset", True)
    assert port.year == ref.year == 2007
    assert port.cat2label == {c: i + 1 for i, c in enumerate(port.CLASSES)}


def test_parse_vid_xml_keeps_the_first_256_objects(tmp_path):
    """400 objects, every fourth of a class outside the map: the first 256
    of the 300 kept ones, as the JAX package's native scanner keeps them."""
    objs = [("n02691156" if k % 4 else "unknown", (k % 50 + 1, 2, k % 50 + 9,
                                                    12)) for k in range(400)]
    path = str(tmp_path / "many.xml")
    write_xml(path, 80, 60, objs)
    cmap = {"n02691156": 1}
    ann, wh, n = parse_vid_xml(path, cmap)
    assert n == len(ann["bboxes"]) == MAX_OBJECTS == 256
    want, wh_ref, n_ref = jax_parse_vid_xml(path, cmap)
    assert (wh, n) == (wh_ref, n_ref)
    assert_ann_equal(ann, want)


# ------------------------------------------------------------- pipelines
IMG_NORM = dict(mean=[103.53, 116.28, 123.675], std=[57.375, 57.12, 58.395],
                to_rgb=True)
ALBU = [
    dict(type="ShiftScaleRotate", shift_limit=0.0625, scale_limit=0.2,
         rotate_limit=30, interpolation=1, p=0.7),
    dict(type="RandomBrightnessContrast", brightness_limit=[0.1, 0.3],
         contrast_limit=[0.1, 0.3], p=0.5),
    dict(type="OneOf", transforms=[dict(type="Blur", blur_limit=3, p=1.0),
                                   dict(type="MedianBlur", blur_limit=3,
                                        p=1.0)], p=0.5),
    dict(type="HueSaturationValue", p=0.5),
    dict(type="ChannelShuffle", p=0.3),
]
ALBU_STEP = dict(type="Albu", transforms=ALBU, bbox_params=dict(
    type="BboxParams", format="pascal_voc", label_fields=["gt_labels"],
    min_visibility=0.3, filter_lost_elements=True),
    keymap={"img": "image", "gt_bboxes": "bboxes"},
    update_pad_shape=False, skip_img_without_anno=True)
TAIL = [dict(type="Resize", img_scale=(96, 64), keep_ratio=True),
        dict(type="RandomFlip", flip_ratio=0.5),
        dict(type="Normalize", **IMG_NORM),
        dict(type="Pad", size_divisor=16),
        dict(type="DefaultFormatBundle")]
TRAIN_PIPELINE = ([dict(type="LoadImageFromFile"),
                   dict(type="LoadAnnotations", with_bbox=True), ALBU_STEP]
                  + TAIL + [dict(type="Collect", keys=["img", "gt_bboxes",
                                                       "gt_labels"])])
TEST_ALBU_PIPELINE = ([dict(type="LoadImageFromFile"), ALBU_STEP] + TAIL
                      + [dict(type="ImageToTensor", keys=["img"]),
                         dict(type="Collect", keys=["img"])])


def assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in b:
        if k == "img_meta":
            assert set(a[k]) == set(b[k])
            for m in b[k]:
                if isinstance(b[k][m], dict):       # img_norm_cfg
                    for n in b[k][m]:
                        np.testing.assert_array_equal(a[k][m][n], b[k][m][n])
                else:
                    np.testing.assert_array_equal(a[k][m], b[k][m],
                                                  err_msg=m)
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("ds_type,test_mode", [
    ("CocoDataset", False), ("VOCDataset", False), ("DETIMGDataset", False),
    ("CocoDataset", True), ("VOCDataset", True)])
def test_items_match_jax(trees, ds_type, test_mode, seed):
    """Every item twice over (retries after empty samples included), the
    generator held to numpy's global state after each."""
    pipeline = TEST_ALBU_PIPELINE if test_mode else TRAIN_PIPELINE
    port, ref = pair(trees, ds_type, test_mode, pipeline, seed=seed)
    np.random.seed(seed)
    for idx in list(range(len(ref))) * 2:
        want = ref[idx]
        got = port[idx]
        assert_items_equal(got, want)
        assert np_states_equal(port.rng.get_state(), np.random.get_state())


def test_load_proposals_matches_jax():
    from hvrnet_tpu.data import pipelines as jax_pipes
    from hvrnet_tpu_torch.data import pipelines
    rng = np.random.default_rng(0)
    for cfg, props in ((dict(), rng.random((7, 5), np.float32)),
                       (dict(num_max_proposals=3), rng.random((7, 4),
                                                              np.float32)),
                       (dict(), np.zeros((0, 5), np.float32)),
                       (dict(), None)):
        make = lambda: dict(proposals=props, bbox_fields=["gt_bboxes"])
        got = pipelines.build_transform(dict(type="LoadProposals", **cfg))(
            make())
        want = jax_pipes.build_transform(dict(type="LoadProposals", **cfg))(
            make())
        assert got["bbox_fields"] == want["bbox_fields"]
        if props is not None:
            np.testing.assert_array_equal(got["proposals"],
                                          want["proposals"])
    with pytest.raises(AssertionError, match="proposals"):
        pipelines.build_transform(dict(type="LoadProposals"))(
            dict(proposals=np.zeros((2, 3), np.float32)))


# --------------------------------------------------------------- loaders
class Flags:
    def __init__(self, flag, slices=None):
        self.flag = np.asarray(flag, np.uint8)
        if slices is not None:
            self.slices_set = True
            self.indices_list = slices

    def __len__(self):
        return len(self.flag)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n,per_gpu", [(13, 1), (13, 2), (20, 4), (5, 3)])
def test_group_samplers_match_jax(seed, n, per_gpu):
    ds = Flags(np.random.default_rng(n + seed).integers(0, 2, n))
    port = loader.GroupSampler(ds, per_gpu, seed)
    ref = jax_loader.GroupSampler(ds, per_gpu, seed)
    for _ in range(2):                 # the generator moves on per pass
        assert list(port) == list(ref)
    assert len(port) == len(ref)
    for replicas in (2, 3):
        for rank in range(replicas):
            port = loader.DistributedGroupSampler(ds, per_gpu, replicas,
                                                  rank, seed)
            ref = jax_loader.DistributedGroupSampler(ds, per_gpu, replicas,
                                                     rank, seed)
            assert list(port) == list(ref) and len(port) == len(ref)


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_sampler_matches_jax(shuffle):
    for n, replicas in ((10, 1), (10, 3), (7, 4)):
        for rank in range(replicas):
            for ds in (Flags(np.zeros(n)), Flags(np.zeros(n), slices=[
                    list(range(r, n, replicas)) for r in range(replicas)])):
                rng = np.random.RandomState(rank)
                np.random.seed(rank)
                port = loader.DistributedSampler(
                    ds, replicas, rank, shuffle, rng if shuffle else None)
                ref = jax_loader.DistributedSampler(ds, replicas, rank,
                                                    shuffle)
                assert list(port) == list(ref) and len(port) == len(ref)
                assert np_states_equal(rng.get_state(),
                                       np.random.get_state())
    with pytest.raises(ValueError, match="RandomState"):
        loader.DistributedSampler(Flags(np.zeros(3)), shuffle=True)


def jittery(idx):
    """An item whose work takes a varying time, so workers finish out of
    order."""
    time.sleep(0.002 * ((idx * 7) % 5))
    return dict(idx=idx, thread=threading.get_ident())


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_prefetch_loader_order(workers):
    order = list(np.random.default_rng(workers).permutation(23))
    port = list(loader.PrefetchLoader(jittery, iter(order), workers))
    ref = list(jax_loader.PrefetchLoader(jittery, iter(order), workers))
    assert [d["idx"] for d in port] == [d["idx"] for d in ref] == order
    if workers > 1:
        assert len({d["thread"] for d in port}) > 1


def test_prefetch_loader_under_contention():
    """More workers than cores with a short switch interval: every item
    once, in order (a lost update of the shared results would drop or
    stall one), within a time bound."""
    import os
    import sys
    order = list(np.random.default_rng(9).permutation(600))
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        consumer = threading.Thread(target=lambda: got.extend(
            d["idx"] for d in loader.PrefetchLoader(
                lambda i: dict(idx=i), iter(order),
                2 * (os.cpu_count() or 4))))
        consumer.start()
        consumer.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not consumer.is_alive()
    assert got == order


def test_prefetch_loader_raises_a_worker_exception():
    """The departure from the JAX loader, whose consumer would wait for
    the failed item forever: the worker's exception is raised at that
    item's turn, after the items before it."""
    def sample(idx):
        if idx == 5:
            raise KeyError("bad sample 5")
        return jittery(idx)

    got = []
    with pytest.raises(KeyError, match="bad sample 5"):
        for item in loader.PrefetchLoader(sample, iter(range(9)), 3):
            got.append(item["idx"])
    assert got == [0, 1, 2, 3, 4]


def test_prefetch_loader_passes_twice():
    """Each pass runs its own workers (a second pass of the JAX loader
    finds its stop flag set and waits forever); a pass left early stops
    its workers."""
    pl = loader.PrefetchLoader(jittery, iter(range(6)), 2)
    assert [d["idx"] for d in pl] == [d["idx"] for d in pl] == list(range(6))
    it = iter(pl)
    next(it)
    it.close()
    assert [d["idx"] for d in pl] == list(range(6))


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_prefetch_loader_bounds_its_lookahead(workers):
    """A slow consumer: the workers start no item more than
    ``LOOKAHEAD_PER_WORKER * workers`` positions past the items taken,
    reach that bound, and keep the index order."""
    bound = loader.LOOKAHEAD_PER_WORKER * workers
    lock = threading.Lock()
    started = [0]
    taken, ahead = [], []

    def sample(idx):
        with lock:
            started[0] += 1
        return idx

    order = list(np.random.default_rng(workers).permutation(40))
    for idx in loader.PrefetchLoader(sample, iter(order), workers):
        taken.append(idx)
        full = min(len(order), len(taken) + bound)
        deadline = time.monotonic() + 5
        while started[0] < full and time.monotonic() < deadline:
            time.sleep(0.001)
        time.sleep(0.005)               # room to overshoot, were it allowed
        with lock:
            ahead.append(started[0] - len(taken))
    assert taken == order
    assert max(ahead) == bound


def test_build_dataloader_trains_in_sampler_order_at_two_workers(trees):
    """Training items on two workers: every sampler index once, in the
    sampler's order, each a whole item (the draws then depend on the
    threads' schedule, so only the order is held)."""
    port, _ = pair(trees, "CocoDataset", False, TRAIN_PIPELINE, seed=3)

    class Recording:
        flag = port.flag
        test_mode = False

        def __len__(self):
            return len(port)

        def __getitem__(self, idx):
            return idx, port[idx]

    got = list(loader.build_dataloader(Recording(), 1, 2, seed=2))
    order = list(loader.GroupSampler(port, 1, seed=2))
    assert [idx for idx, _ in got] == order
    assert sorted(order) == list(range(len(port)))
    for _, item in got:
        assert item["img"].dtype == np.float32
        assert np.isfinite(item["gt_bboxes"]).all()
        assert len(item["gt_bboxes"]) == len(item["gt_labels"]) > 0


@pytest.mark.parametrize("test_mode", [True, False])
def test_build_dataloader_matches_jax(trees, test_mode):
    pipeline = TEST_ALBU_PIPELINE if test_mode else TRAIN_PIPELINE
    port, ref = pair(trees, "CocoDataset", test_mode, pipeline, seed=3)
    np.random.seed(3)
    assert loader.dataset_is_test(port) == test_mode
    got = list(loader.build_dataloader(port, 1, 1, seed=2))
    want = list(jax_loader.build_dataloader(ref, 1, 1, seed=2))
    assert len(got) == len(want) == len(ref)
    for a, b in zip(got, want):
        assert_items_equal(a, b)
    assert np_states_equal(port.rng.get_state(), np.random.get_state())


# ------------------------------------------------------------ evaluation
def random_props(rng, gts, n, scored=True):
    """Proposals near the ground truth and elsewhere, scored at random."""
    out = []
    for g in gts:
        p = rng.uniform(0, 60, (n, 2))
        p = np.concatenate([p, p + rng.uniform(4, 30, (n, 2))], 1)
        if len(g):
            p[:len(g)] = g + rng.normal(0, 2, g.shape)
        if scored:
            p = np.concatenate([p, rng.random((n, 1))], 1)
        out.append(p.astype(np.float32))
    return out


@pytest.mark.parametrize("scored", [True, False])
def test_eval_recalls_matches_jax(scored):
    rng = np.random.default_rng(0)
    gts = []
    for m in (3, 0, 5, 2):
        g = rng.uniform(0, 50, (m, 2))
        gts.append(np.concatenate([g, g + rng.uniform(5, 20, (m, 2))],
                                  1).astype(np.float32))
    for nums, thrs in ((None, None), ([1, 3, 10], np.arange(0.5, 1.0, 0.05)),
                       (5, 0.7)):
        props = random_props(rng, gts, 12, scored)
        got = eval_recalls(gts, props, nums, thrs, print_summary=False)
        want = jax_eval_recalls(gts, props, nums, thrs, print_summary=False)
        np.testing.assert_array_equal(got, want)
    # as many boxes per image, proposal counts that differ: the JAX
    # function's object array fails there, the port's list does not
    gts = [gts[0], gts[0]]
    props = [random_props(rng, gts[:1], 12, scored)[0],
             random_props(rng, gts[:1], 9, scored)[0]]
    with pytest.raises(ValueError):
        jax_eval_recalls(gts, props, [20], print_summary=False)
    got = eval_recalls(gts, props, [20], print_summary=False)
    hits = sum(np.rint(3 * jax_eval_recalls([g], [p], [20],
                                            print_summary=False))
               for g, p in zip(gts, props))
    np.testing.assert_array_equal(got, hits / 6)


def detections(rng, dataset, noise=2.0, false=2):
    """Per image per class detections: the ground truth moved by
    ``noise`` px, scored at random, plus ``false`` false ones."""
    n_cls = len(dataset.CLASSES)
    results = []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        per = [np.zeros((0, 5), np.float32) for _ in range(n_cls)]
        for b, lab in zip(ann["bboxes"], ann["labels"]):
            box = b + rng.normal(0, noise, 4)
            per[lab - 1] = np.concatenate([per[lab - 1], np.concatenate(
                [box, rng.random(1)])[None].astype(np.float32)])
        for _ in range(false):
            c = int(rng.integers(n_cls))
            x, y = rng.uniform(0, 30, 2)
            per[c] = np.concatenate([per[c], np.float32(
                [[x, y, x + 10, y + 12, rng.random()]])])
        results.append(per)
    return results


def test_results2json_matches_jax(trees, tmp_path):
    port, ref = pair(trees, "CocoDataset", True)
    results = detections(np.random.default_rng(0), port)
    results[1] = None                   # an image without results
    a = coco_eval.results2json(port, results, str(tmp_path / "a.json"))
    b = jax_coco_eval.results2json(ref, results, str(tmp_path / "b.json"))
    got, want = json.load(open(a)), json.load(open(b))
    assert got == want and len(got) > 10
    assert {d["category_id"] for d in got} <= {c for c, _ in COCO_CATS}
    # back to the detections: category → label, [x, y, w, h] → corners
    back = [[[] for _ in port.CLASSES] for _ in results]
    for d in got:
        i = [info["id"] for info in port.img_infos].index(d["image_id"])
        x, y, w, h = d["bbox"]
        back[i][port.cat2label[d["category_id"]] - 1].append(
            [x, y, x + w - 1, y + h - 1, d["score"]])
    for res, b in zip(results, back):
        for cls, dets in enumerate(res or []):
            # float64 arithmetic on float32 values: ~1e-13 px
            np.testing.assert_allclose(np.asarray(b[cls]).reshape(-1, 5),
                                       dets, rtol=0, atol=1e-9)


@pytest.mark.parametrize("noise", [0.0, 3.0])
def test_coco_style_eval_matches_jax(trees, noise):
    port, ref = pair(trees, "CocoDataset", True)
    results = detections(np.random.default_rng(1), port, noise)
    results[1] = [np.zeros((0, 5), np.float32) for _ in port.CLASSES]
    anns = [port.get_ann_info(i) for i in range(len(port))]
    args = (results, [a["bboxes"] for a in anns],
            [a["labels"] for a in anns], port.CLASSES)
    got = coco_eval.coco_style_eval(*args)
    want = jax_coco_eval.coco_style_eval(*args)
    assert got == want and 0 < got <= 1


def write_config(path, data_test):
    path.write_text(f"data = dict(test={data_test!r})\n")
    return str(path)


def test_voc_eval_and_clis_match_jax(trees, tmp_path):
    """``voc_eval`` (VOC2007: 11 points) and the CLIs' ``main`` against the
    JAX functions on the same pickles; ground truth as detections scores
    1.0."""
    port, ref = pair(trees, "VOCDataset", True)
    for noise in (0.0, 2.5):
        results = detections(np.random.default_rng(2), port, noise,
                             false=2 * (noise > 0))
        if noise:
            results[1] = [np.zeros((0, 5), np.float32) for _ in port.CLASSES]
        pkl = tmp_path / f"voc{noise}.pkl"
        pkl.write_bytes(pickle.dumps(results))
        got = voc_eval.voc_eval(str(pkl), port)
        want = jax_voc_eval.voc_eval(str(pkl), ref)
        assert got[0] == want[0]
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g["ap"], w["ap"])
        if noise == 0.0:
            assert got[0] == 1.0
    cfg = write_config(tmp_path / "voc_cfg.py", dict(
        type="VOCDataset", pipeline=TEST_PIPELINE, **trees["voc"]))
    assert voc_eval.main([str(pkl), cfg])[0] == want[0]
    port, ref = pair(trees, "CocoDataset", True)
    results = detections(np.random.default_rng(3), port, 0.0, false=0)
    pkl.write_bytes(pickle.dumps(results))
    cfg = write_config(tmp_path / "coco_cfg.py", dict(
        type="CocoDataset", pipeline=TEST_PIPELINE, **trees["coco"]))
    out = tmp_path / "dets.json"
    assert coco_eval.main([str(pkl), cfg, "--json-out", str(out)]) == 1.0
    assert json.load(open(out)) == json.load(open(jax_coco_eval.results2json(
        ref, results, str(tmp_path / "ref.json"))))


def test_pascal_voc_converter_matches_jax(trees, tmp_path):
    devkit = str(trees["root"] / "VOCdevkit")
    pascal_voc.main([devkit, "--out-dir", str(tmp_path / "port")])
    (tmp_path / "ref").mkdir()
    for split in ("test", "trainval"):
        jax_pascal_voc.convert_split(devkit, "2007", split,
                                     str(tmp_path / "ref" / f"{split}.pkl"))
        got = pickle.loads((tmp_path / "port" /
                            f"voc2007_{split}.pkl").read_bytes())
        want = pickle.loads((tmp_path / "ref" / f"{split}.pkl").read_bytes())
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert {k: a[k] for k in ("filename", "width", "height")} == \
                {k: b[k] for k in ("filename", "width", "height")}
            assert_ann_equal(a["ann"], b["ann"])
