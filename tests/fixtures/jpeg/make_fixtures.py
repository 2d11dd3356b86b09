"""Write the JPEG fixtures of the port's decoder tests and of
``chip_smoke.py``'s ``[jpeg]`` phase into this directory:

    python tests/fixtures/jpeg/make_fixtures.py [--seed 0]

Needs cv2 (it encodes the files and decodes them for ``expected.json``), so
it runs where cv2 is, not on a machine without it.  Writes:

- ``frame_000000.jpg`` … ``frame_000007.jpg``: eight 1280×720 frames of a
  smooth scene panning under two moving boxes of VID classes, quality 75
  (4:2:0), and ``frame_00000k.xml``, each frame's VID annotation;
- ``portrait.jpg`` / ``portrait.xml``: one 540×960 frame (width × height);
- odd sizes: ``odd_1x1.jpg``, ``odd_9x7_422_rst.jpg`` (4:2:2, a restart
  marker every 2 MCUs), ``odd_33x17_grey.jpg``, ``odd_17x33_440_q95.jpg``;
- ``progressive.jpg``: a progressive file, which the native decoder
  refuses;
- ``expected.json``: per file the shape and the SHA-256 of the C-ordered
  uint8 array that ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns, and
  ``"native": "refuses"`` for the file the native decoder refuses.
"""
import argparse
import hashlib
import json
import xml.etree.ElementTree as ET
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
FRAMES = 8
HW = (720, 1280)
PORTRAIT_HW = (960, 540)
# (wnid, box colour BGR) of the two moving boxes
OBJECTS = (("n02691156", (40, 40, 220)), ("n02958343", (220, 160, 40)))


def smooth_scene(rng, h, w):
    """A random field at 1/160 of the size in [96, 160), upsampled
    bicubically: broad gradients that code to ~27 KB per 1280×720 frame at
    quality 75."""
    small = rng.integers(96, 160, size=(h // 160 + 4, w // 160 + 4, 3),
                         dtype=np.uint8)
    return cv2.resize(small, (w + 160, h + 160),
                      interpolation=cv2.INTER_CUBIC)


def write_xml(path, w, h, objects):
    ann = ET.Element("annotation")
    ET.SubElement(ann, "folder").text = "ILSVRC2015_val_00000000"
    ET.SubElement(ann, "filename").text = path.stem
    size = ET.SubElement(ann, "size")
    ET.SubElement(size, "width").text = str(w)
    ET.SubElement(size, "height").text = str(h)
    for track, (wnid, box) in enumerate(objects):
        obj = ET.SubElement(ann, "object")
        ET.SubElement(obj, "trackid").text = str(track)
        ET.SubElement(obj, "name").text = wnid
        bnd = ET.SubElement(obj, "bndbox")
        for key, val in zip(("xmax", "xmin", "ymax", "ymin"),
                            (box[2], box[0], box[3], box[1])):
            ET.SubElement(bnd, key).text = str(val)
        ET.SubElement(obj, "occluded").text = "0"
        ET.SubElement(obj, "generated").text = "0"
    ET.ElementTree(ann).write(path)


def frame(scene, i, h, w):
    """Frame ``i``: the scene panned by (2i, 3i) px, the boxes moved by
    (24i, 12i) px; returns the image and its (wnid, box) pairs."""
    img = np.ascontiguousarray(scene[2 * i:2 * i + h, 3 * i:3 * i + w])
    objects = []
    for k, (wnid, colour) in enumerate(OBJECTS):
        x1 = w // 8 + 24 * i + k * w // 3
        y1 = h // 5 + 12 * i + k * h // 4
        box = (x1, y1, x1 + w // 4, y1 + h // 3)
        img[box[1]:box[3], box[0]:box[2]] = colour
        objects.append((wnid, box))
    return img, objects


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    q75 = [cv2.IMWRITE_JPEG_QUALITY, 75]
    written = {}
    h, w = HW
    scene = smooth_scene(rng, h, w)
    for i in range(FRAMES):
        img, objects = frame(scene, i, h, w)
        name = f"frame_{i:06d}"
        cv2.imwrite(str(HERE / f"{name}.jpg"), img, q75)
        write_xml(HERE / f"{name}.xml", w, h, objects)
        written[f"{name}.jpg"] = None
    ph, pw = PORTRAIT_HW
    img, objects = frame(smooth_scene(rng, ph, pw), 0, ph, pw)
    cv2.imwrite(str(HERE / "portrait.jpg"), img, q75)
    write_xml(HERE / "portrait.xml", pw, ph, objects)
    written["portrait.jpg"] = None

    def odd(hw, seed):
        g = np.random.default_rng(seed)
        return g.integers(0, 256, size=hw + (3,), dtype=np.uint8)

    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    cv2.imwrite(str(HERE / "odd_1x1.jpg"), odd((1, 1), 1), q75)
    cv2.imwrite(str(HERE / "odd_9x7_422_rst.jpg"), odd((7, 9), 2),
                q75 + [sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                       cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    cv2.imwrite(str(HERE / "odd_33x17_grey.jpg"),
                cv2.cvtColor(odd((17, 33), 3), cv2.COLOR_BGR2GRAY), q75)
    cv2.imwrite(str(HERE / "odd_17x33_440_q95.jpg"), odd((33, 17), 4),
                [cv2.IMWRITE_JPEG_QUALITY, 95, sf,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    for name in ("odd_1x1.jpg", "odd_9x7_422_rst.jpg", "odd_33x17_grey.jpg",
                 "odd_17x33_440_q95.jpg"):
        written[name] = None
    prog = cv2.resize(smooth_scene(rng, 64, 96)[:64, :96], (96, 64))
    cv2.imwrite(str(HERE / "progressive.jpg"), prog,
                q75 + [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    written["progressive.jpg"] = "refuses"

    expected = {}
    for name, native in written.items():
        img = cv2.imread(str(HERE / name), cv2.IMREAD_COLOR)
        entry = dict(shape=list(img.shape),
                     sha256=hashlib.sha256(
                         np.ascontiguousarray(img).tobytes()).hexdigest())
        if native:
            entry["native"] = native
        expected[name] = entry
    (HERE / "expected.json").write_text(json.dumps(
        dict(seed=args.seed, decoder=f"cv2 {cv2.__version__} imread "
             f"IMREAD_COLOR", files=expected), indent=1) + "\n")
    total = sum(f.stat().st_size for f in HERE.iterdir()
                if f.suffix in (".jpg", ".xml", ".json"))
    print(f"{len(expected)} images, {total} bytes with the XMLs and "
          f"expected.json")


if __name__ == "__main__":
    main()
