"""PASCAL VOC annotations to pickled middle format (counterpart of the
JAX package's ``tools/convert_datasets/pascal_voc.py``):

    python -m hvrnet_tpu_torch.tools.convert_datasets.pascal_voc \
        <devkit_path> [--out-dir DIR]

writes ``voc{year}_{split}.pkl`` for every ``VOC2007`` / ``VOC2012``
split list present (train, val, trainval, test): per image its
``filename`` (``JPEGImages/{id}.jpg``), ``width``, ``height`` and ``ann``,
the annotation ``parse_vid_xml`` gives over the 20 VOC classes.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

from ...data.datasets import VOCDataset
from ...data.vid_dataset import list_from_file, parse_vid_xml


def convert_split(devkit, year, split, out):
    prefix = osp.join(devkit, f"VOC{year}")
    ids = list_from_file(osp.join(prefix, "ImageSets/Main", split + ".txt"))
    cls2idx = {c: i + 1 for i, c in enumerate(VOCDataset.CLASSES)}
    infos = []
    for img_id in ids:
        ann, (w, h), _ = parse_vid_xml(
            osp.join(prefix, "Annotations", img_id + ".xml"), cls2idx)
        infos.append(dict(filename=f"JPEGImages/{img_id}.jpg", width=w,
                          height=h, ann=ann))
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"{out}: {len(infos)} images")


def main(argv=None):
    p = argparse.ArgumentParser(description="PASCAL VOC to middle format")
    p.add_argument("devkit_path")
    p.add_argument("--out-dir", default=".")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for year in ("2007", "2012"):
        for split in ("train", "val", "trainval", "test"):
            if osp.isfile(osp.join(args.devkit_path, f"VOC{year}",
                                   "ImageSets/Main", split + ".txt")):
                convert_split(args.devkit_path, year, split,
                              osp.join(args.out_dir,
                                       f"voc{year}_{split}.pkl"))


if __name__ == "__main__":
    main()
