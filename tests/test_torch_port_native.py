"""The port's annotation scanner (``hvrnet_tpu_torch/data/native.py`` over
``csrc/vidmeta.cpp``) against the JAX package's ``parse_xml_fast`` and the
port's ElementTree parse (``parse_vid_xml_elementtree``): on the XMLs of
the data tests' VID tree and of the JPEG fixtures, past the 256-object cap,
with unknown names, with no objects and for a missing file; two class
tables scanned from two threads at once; the object count; and a library
that does not build raises instead of falling back.
"""
import threading
from pathlib import Path

import numpy as np
import pytest

from hvrnet_tpu.data import native as jax_native
from hvrnet_tpu.data import vid_dataset as jax_vid
from hvrnet_tpu_torch.data import native, vid_dataset
from hvrnet_tpu_torch.ops import kernel_build
from tests.test_torch_port_data import build_tree
from tests.test_vid_dataset import write_xml

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"
VID_TABLE = {c: i for i, c in enumerate(("__background__",)
                                        + vid_dataset.VID_WNIDS)}


@pytest.fixture(scope="module", autouse=True)
def built():
    """One build of the scanner's library for the module; the JAX scanner
    built as its own tests build it."""
    assert jax_native.load_library() is not None
    return native.library()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_tree(str(tmp_path_factory.mktemp("VID")))


def assert_same(got, want):
    assert got[1:] == want[1:]
    for key in want[0]:
        assert got[0][key].dtype == want[0][key].dtype
        np.testing.assert_array_equal(got[0][key], want[0][key])


def assert_three_agree(path, table=VID_TABLE):
    """The port's scanner, the JAX scanner and the port's ElementTree parse
    give the same result; returns it."""
    got = native.parse_xml_fast(str(path), table)
    assert_same(got, jax_native.parse_xml_fast(str(path), table))
    assert_same(got, vid_dataset.parse_vid_xml_elementtree(str(path), table))
    assert_same(vid_dataset.parse_vid_xml(str(path), table), got)
    return got


def test_tree_xmls(tree):
    paths = sorted(Path(tree, "Annotations").rglob("*.xml"))
    assert len(paths) == 16
    for path in paths:
        assert_three_agree(path)


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        FIXTURES.glob("*.xml")))
def test_fixture_xmls(name):
    ann, (w, h), n = assert_three_agree(FIXTURES / name)
    assert n == 2 and (w, h) in ((1280, 720), (540, 960))


def objects(n, seed, unknown_every=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        name = ("n00000000" if unknown_every and i % unknown_every == 0
                else vid_dataset.VID_WNIDS[int(rng.integers(30))])
        x, y = (int(v) for v in rng.integers(0, 500, 2))
        out.append((name, (x, y, x + int(rng.integers(1, 99)),
                           y + int(rng.integers(1, 99)))))
    return out


CASES = {
    "300_objects": objects(300, 0),
    "300_objects_unknown_every_7": objects(300, 1, unknown_every=7),
    "unknown_names": [("n00000000", (1, 2, 3, 4)),
                      ("n02691156", (5, 6, 70, 80)),
                      ("background", (1, 1, 9, 9)),
                      ("n02958343", (10, 20, 30, 40))],
    "no_objects": [],
}


@pytest.mark.parametrize("case", list(CASES))
def test_written_xmls(tmp_path, case):
    path = tmp_path / "f.xml"
    write_xml(str(path), 640, 360, CASES[case])
    ann, wh, n = assert_three_agree(path)
    known = sum(name in VID_TABLE for name, _ in CASES[case])
    assert wh == (640, 360) and n == min(known, native.MAX_OBJECTS)
    assert ann["bboxes"].shape == (n, 4)


def test_missing_file(tmp_path):
    path = str(tmp_path / "missing.xml")
    assert native.parse_xml_fast(path, VID_TABLE) is None
    assert jax_native.parse_xml_fast(path, VID_TABLE) is None
    for parse in (vid_dataset.parse_vid_xml, jax_vid.parse_vid_xml):
        with pytest.raises(FileNotFoundError):
            parse(path, VID_TABLE)
    assert native.count_objects(path) is None


def test_count_objects(tmp_path):
    path = tmp_path / "f.xml"
    write_xml(str(path), 320, 240, CASES["300_objects_unknown_every_7"])
    assert native.count_objects(str(path)) == (300, (320, 240))


def test_two_tables_from_two_threads(tmp_path):
    """A VID table and a second table of other names and order, each
    scanned from its own thread over the same files: every result that of
    ElementTree with that thread's table (one global table, as in the JAX
    library, would mislabel one thread's boxes)."""
    paths = []
    for k in range(6):
        path = tmp_path / f"f{k}.xml"
        write_xml(str(path), 100 + k, 80, objects(40, k))
        paths.append(str(path))
    wnids = vid_dataset.VID_WNIDS
    other = {c: i + 1 for i, c in enumerate(wnids[::-1][:20])}
    other["__background__"] = 0
    tables = (VID_TABLE, other)
    want = [[vid_dataset.parse_vid_xml_elementtree(p, t) for p in paths]
            for t in tables]
    assert not np.array_equal(want[0][0][0]["labels"],
                              want[1][0][0]["labels"])
    errors = []

    def work(k):
        try:
            for _ in range(30):
                for p, w in zip(paths, want[k]):
                    assert_same(native.parse_xml_fast(p, tables[k]), w)
        except Exception as e:            # pragma: no cover - reported
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_a_library_that_does_not_build_raises(tmp_path, monkeypatch):
    """A scanner source that does not compile: the build raises with the
    compiler's output, and so does ``parse_vid_xml`` (no ElementTree
    fallback)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "vidmeta.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(kernel_build, "CSRC", csrc)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TABLES", {})
    path = FIXTURES / "frame_000000.xml"
    with pytest.raises(RuntimeError, match="native build failed: "
                       "vidmeta.cpp(.|\n)*error"):
        vid_dataset.parse_vid_xml(str(path), VID_TABLE)
    assert not list((tmp_path / "build").glob("*.so"))


def test_port_module_imports_nothing_of_the_jax_scanner():
    import ast
    src = (ROOT / "hvrnet_tpu_torch" / "data" / "native.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert not any(n.split(".")[0] in ("hvrnet_tpu", "jax") for n in names)
    assert names == {"__future__", "ctypes", "threading", "typing", "numpy",
                     "..ops"}, names
