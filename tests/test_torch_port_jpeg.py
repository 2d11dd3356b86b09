"""The port's image decoder (``hvrnet_tpu_torch/data/jpeg.py`` over
``csrc/jpeg_decode.cpp``) against ``cv2.imread(path, IMREAD_COLOR)``, bit
for bit, on JPEGs that ``cv2.imwrite`` makes: qualities, the five sampling
factors, restart intervals, optimised tables, split luma / chroma quality,
grey, odd sizes, and the eight EXIF orientations spliced into a cv2-written
file; 16-bit and overflowing quantisation tables, files without DHT or
JFIF, an Adobe RGB file, and randomly mutated files (each decoded one
equal to cv2's).  Then its refusals (progressive, lossless, arithmetic, 12-bit,
four components, truncated and corrupt data, PNG, text), binary PPM / PGM
under JPEG names, the committed fixtures (``tests/fixtures/jpeg``, whose
``expected.json`` is held to cv2 here too), ``LoadImageFromFile`` with
``imread="native"`` on a VID tree, decoding from threads, and the port's
``hnl_test --decoder native`` against its ``--decoder cv2`` run.
"""
import hashlib
import json
import re
import struct
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from hvrnet_tpu_torch.data import jpeg, pipelines
from hvrnet_tpu_torch.tools import hnl_test
from tests.test_torch_port_cli import load, port_args, setup  # noqa: F401

torch.set_num_threads(2)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
SAMPLING = {k: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{k}")
            for k in ("444", "422", "420", "440", "411")}
SIZES = ((1, 1), (9, 7), (33, 17), (375, 500), (721, 1281))   # (h, w)


@pytest.fixture(scope="module", autouse=True)
def built():
    """One build of the decoder's library for the module."""
    return jpeg.library()


def scene(h, w, seed, noise=False):
    """A smooth random field with a flat box, or uniform noise."""
    rng = np.random.default_rng(seed)
    if noise:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    small = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3),
                         dtype=np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    img[h // 4:h // 2, w // 4:w // 2] = (40, 200, 90)
    return img


def assert_same_as_cv2(tmp_path, data, name="case.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got = jpeg.imread_native(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def encode(img, params=()):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("noise", [False, True], ids=["smooth", "noise"])
@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
def test_qualities(tmp_path, quality, noise):
    img = scene(375, 500, quality, noise)
    assert_same_as_cv2(tmp_path, encode(img, [cv2.IMWRITE_JPEG_QUALITY,
                                              quality]))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{w}x{h}" for h, w in SIZES])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_sampling_factors_and_sizes(tmp_path, sampling, hw):
    img = scene(*hw, seed=hw[0] * 7 + hw[1], noise=hw[0] < 40)
    assert_same_as_cv2(tmp_path, encode(img, [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_QUALITY, 90]))


CODING = {
    "rst1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
    "rst5_444": [cv2.IMWRITE_JPEG_RST_INTERVAL, 5,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"]],
    "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "optimize_rst3_411": [cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["411"]],
    "luma30_chroma90": [cv2.IMWRITE_JPEG_LUMA_QUALITY, 30,
                        cv2.IMWRITE_JPEG_CHROMA_QUALITY, 90],
    "luma95_chroma20": [cv2.IMWRITE_JPEG_LUMA_QUALITY, 95,
                        cv2.IMWRITE_JPEG_CHROMA_QUALITY, 20],
}


@pytest.mark.parametrize("hw", [(33, 17), (375, 500)],
                         ids=["17x33", "500x375"])
@pytest.mark.parametrize("coding", list(CODING))
def test_coding_options(tmp_path, coding, hw):
    assert_same_as_cv2(tmp_path, encode(scene(*hw, seed=5), CODING[coding]))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{w}x{h}" for h, w in SIZES])
@pytest.mark.parametrize("quality", [10, 75, 100])
def test_grey(tmp_path, quality, hw):
    grey = cv2.cvtColor(scene(*hw, seed=3), cv2.COLOR_BGR2GRAY)
    assert_same_as_cv2(tmp_path, encode(grey, [cv2.IMWRITE_JPEG_QUALITY,
                                               quality]))


def exif_app1(orientation, little):
    """An APP1 segment holding an EXIF IFD0 with one Orientation entry."""
    e = "<" if little else ">"
    tiff = (b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1)
    tiff += struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff += struct.pack(e + "I", 0)
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("little", [True, False], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation(tmp_path, orientation, little):
    """Orientations 1-8 applied as cv2 applies them (0 and 9 leave the
    image as it is); the segment spliced in after SOI."""
    data = encode(scene(45, 70, seed=9))
    data = data[:2] + exif_app1(orientation, little) + data[2:]
    assert_same_as_cv2(tmp_path, data)


def segments(data):
    """(marker, offset of its 0xFF, length with the marker) of each
    segment before the first SOS."""
    out, i = [], 2
    while data[i + 1] != 0xDA:
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        out.append((data[i + 1], i, n + 2))
        i += n + 2
    return out


def with_sof(data, edit):
    """``data`` with its SOF0 segment's payload replaced by ``edit(p)``."""
    for marker, at, n in segments(data):
        if marker == 0xC0:
            payload = edit(bytearray(data[at + 4:at + n]))
            return (data[:at + 2] + struct.pack(">H", len(payload) + 2)
                    + bytes(payload) + data[at + n:])
    raise AssertionError("no SOF0")


def sof_marker(data, marker):
    for m, at, _ in segments(data):
        if m == 0xC0:
            return data[:at + 1] + bytes([marker]) + data[at + 2:]
    raise AssertionError("no SOF0")


def four_components(p):
    p[5] = 4
    return p + p[-3:]


def twelve_bit(p):
    p[0] = 12
    return p


def corrupt_code(data):
    """The first entropy-coded bytes set to all ones: no Huffman code."""
    at = data.index(b"\xff\xda")
    start = at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]
    return data[:start] + b"\xff\x00" * 8 + data[start + 8:]


def dqt_rewritten(data, edit, sixteen=False):
    """``data`` with each DQT table replaced by ``edit(table id, values in
    zigzag order)``, written at 16 bits where asked or where a value needs
    it."""
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        seg = data[i + 4:i + 2 + n]
        if data[i + 1] != 0xDB:
            out += data[i:i + 2 + n]
        else:
            new, p = b"", 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                size = 128 if pq else 64
                body = seg[p + 1:p + 1 + size]
                vals = edit(tq, list(struct.unpack(">64H", body) if pq
                                     else body))
                if sixteen or max(vals) > 255:
                    new += bytes([0x10 | tq]) + struct.pack(">64H", *vals)
                else:
                    new += bytes([tq]) + bytes(vals)
                p += 1 + size
            out += b"\xff\xdb" + struct.pack(">H", len(new) + 2) + new
        i += 2 + n
    return bytes(out + data[i:])


QUANT_EDITS = {
    "16bit_same_values": (lambda t, v: v, True),
    "dc_9000": (lambda t, v: [9000] + v[1:], False),
    "dc_40000": (lambda t, v: [40000] + v[1:], False),
    "ac1_3000": (lambda t, v: v[:1] + [3000] + v[2:], False),
    "ac63_50000": (lambda t, v: v[:63] + [50000], False),
    "all_x300": (lambda t, v: [min(65535, x * 300) for x in v], False),
}


@pytest.mark.parametrize("image", ["smooth", "noise"])
@pytest.mark.parametrize("edit", list(QUANT_EDITS))
def test_quantisation_tables(tmp_path, edit, image):
    """16-bit DQT tables, and quantisers so large that the IDCT's 16-bit
    lanes overflow: cv2's libjpeg-turbo wraps and saturates them as its
    SIMD IDCT does (``csrc/jpeg_decode.cpp:idct_islow``)."""
    img = scene(48, 64, seed=21, noise=image == "noise")
    fn, sixteen = QUANT_EDITS[edit]
    data = dqt_rewritten(encode(img, [cv2.IMWRITE_JPEG_QUALITY, 90]), fn,
                         sixteen)
    assert_same_as_cv2(tmp_path, data)


def without_segments(data, markers):
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        if data[i + 1] not in markers:
            out += data[i:i + 2 + n]
        i += 2 + n
    return bytes(out + data[i:])


ADOBE_RGB = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"


@pytest.mark.parametrize("case", ["no_dht", "no_jfif", "adobe_rgb"])
def test_colour_space_and_table_defaults(tmp_path, case):
    """The standard Huffman tables where a file has no DHT (Motion-JPEG
    frames); YCbCr by the component ids without a JFIF marker; RGB under
    an Adobe marker with transform 0."""
    data = encode(scene(40, 56, seed=23))
    if case == "no_dht":
        data = without_segments(data, {0xC4})
    elif case == "no_jfif":
        data = without_segments(data, {0xE0})
    else:
        data = data[:2] + ADOBE_RGB + without_segments(data, {0xE0})[2:]
    assert_same_as_cv2(tmp_path, data)


@pytest.mark.parametrize("seed", range(4))
def test_mutated_files_decode_as_cv2_or_are_refused(seed):
    """Bytes of cv2-written files changed at random: every file the native
    decoder reads gives cv2's array, the others raise ``ValueError``, and
    none crashes the process."""
    rng = np.random.default_rng(seed)
    bases = [encode(rng.integers(0, 256, (37, 53, 3), dtype=np.uint8), p)
             for p in ([], [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
                       [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["411"]],
                       [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
                       [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["440"]])]
    decoded = 0
    for k in range(400):
        data = bytearray(bases[k % len(bases)])
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(len(data)))] = int(rng.integers(256))
        try:
            got = jpeg.decode(bytes(data))
        except ValueError:
            continue
        want = cv2.imdecode(np.frombuffer(bytes(data), np.uint8),
                            cv2.IMREAD_COLOR)
        assert want is not None and want.shape == got.shape
        np.testing.assert_array_equal(got, want)
        decoded += 1
    assert decoded > 20


BASE = encode(scene(64, 96, seed=11))
REFUSALS = {
    "progressive": (encode(scene(64, 96, seed=11),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
                    "progressive"),
    "lossless": (sof_marker(BASE, 0xC3), "lossless"),
    "arithmetic": (sof_marker(BASE, 0xC9), "arithmetic"),
    "12-bit": (with_sof(BASE, twelve_bit), "12-bit"),
    "cmyk": (with_sof(BASE, four_components), "CMYK or YCCK"),
    "truncated_half": (BASE[:len(BASE) // 2], "truncated"),
    "truncated_no_eoi": (BASE[:-2], "truncated"),
    "corrupt_code": (corrupt_code(BASE), "corrupt"),
    "png": (cv2.imencode(".png", scene(64, 96, seed=11))[1].tobytes(),
            "not a JPEG"),
    "text": (b"not an image\n", "not a JPEG"),
    "empty": (b"", "not a JPEG"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_name_the_file(tmp_path, case):
    data, reason = REFUSALS[case]
    path = tmp_path / f"{case}.JPEG"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=re.escape(str(path)) + ".*"
                       + re.escape(reason)):
        jpeg.imread_native(path)


@pytest.mark.parametrize("kind", ["P6", "P5"])
def test_binary_pnm_under_a_jpeg_name(tmp_path, kind):
    """Binary PPM / PGM read by their magic bytes, as cv2 reads them,
    whatever the file's name."""
    img = scene(13, 21, seed=2, noise=True)
    if kind == "P6":
        data = (b"P6\n# a comment\n21 13\n255\n"
                + img[..., ::-1].tobytes())
    else:
        data = b"P5\n21 13\n255\n" + img[..., 0].tobytes()
    assert_same_as_cv2(tmp_path, data, "frame.JPEG")


FIXTURE_FILES = json.loads((FIXTURES / "expected.json").read_text())["files"]


def sha256(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.mark.parametrize("name", list(FIXTURE_FILES))
def test_fixture_matches_expected(name):
    """The committed fixtures: ``expected.json`` still what cv2 gives here,
    and the native decoder's array hashes to it (the progressive file is
    refused)."""
    entry = FIXTURE_FILES[name]
    path = FIXTURES / name
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert [list(want.shape), sha256(want)] == [entry["shape"],
                                               entry["sha256"]]
    if entry.get("native") == "refuses":
        with pytest.raises(ValueError, match="progressive"):
            jpeg.imread_native(path)
        return
    got = jpeg.imread_native(path)
    assert [list(got.shape), sha256(got)] == [entry["shape"],
                                             entry["sha256"]]


def test_load_image_from_file_native_matches_cv2(setup):  # noqa: F811
    """``LoadImageFromFile(imread="native")`` against ``"cv2"`` on every
    frame of the CLI tests' VID tree, both as read and as float32."""
    root = Path(setup[0])
    frames = sorted((root / "JPEGImages").rglob("*.JPEG"))
    assert len(frames) >= 16
    for to_float32 in (False, True):
        native = pipelines.LoadImageFromFile(to_float32, imread="native")
        plain = pipelines.LoadImageFromFile(to_float32, imread="cv2")
        for path in frames:
            a, b = native.read(str(path)), plain.read(str(path))
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_threads_decode_alike():
    """Four threads decoding the fixtures at once give the serial arrays
    (the C calls release the GIL)."""
    names = [n for n, e in FIXTURE_FILES.items() if "native" not in e]
    want = {n: sha256(jpeg.imread_native(FIXTURES / n)) for n in names}
    got, errors = {}, []

    def work(k):
        try:
            for n in names[k::4] * 3:
                got.setdefault(n, set()).add(
                    sha256(jpeg.imread_native(FIXTURES / n)))
        except Exception as e:            # pragma: no cover - reported
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert got == {n: {h} for n, h in want.items()}


def test_resolve_decoder_native():
    """``imread="native"`` and ``--decoder native``, which ``hnl_test``,
    ``test`` and ``train`` all resolve through ``decoder_from_flag``."""
    from hvrnet_tpu_torch.tools import test as test_cli
    assert pipelines.resolve_decoder("native") is jpeg.imread_native
    assert test_cli.decoder_from_flag("native") is jpeg.imread_native
    with pytest.raises(TypeError, match="'native'"):
        pipelines.resolve_decoder("pil")
    with pytest.raises(SystemExit, match="cv2, native or module:function"):
        test_cli.decoder_from_flag("pil")


def test_hnl_test_native_decoder_matches_cv2(setup):  # noqa: F811
    """The port's ``hnl_test`` on the tiny config with ``--decoder native``:
    the same results, bit for bit, as its ``--decoder cv2`` run."""
    _, cfg, ckpt, work = setup
    runs = {}
    for decoder in ("cv2", "native"):
        out = work / f"decoder_{decoder}.pkl"
        hnl_test.main(port_args(cfg, ckpt, out, "--window", "3",
                                "--pre-padding", "repeat", "--seed", "2",
                                "--decoder", decoder, "--tmpdir",
                                str(work / f"decoder_{decoder}")))
        runs[decoder] = load(out)
    assert len(runs["native"]) == len(runs["cv2"]) > 0
    for fn, fc in zip(runs["native"], runs["cv2"]):
        assert len(fn) == len(fc) == 30
        for a, b in zip(fn, fc):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
