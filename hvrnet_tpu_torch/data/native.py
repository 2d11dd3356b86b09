"""The annotation scanner (``csrc/vidmeta.cpp``) through ``ctypes``: the
port's counterpart of the JAX package's ``data/native.py``.

``parse_xml_fast(path, class_to_index)`` returns what
``vid_dataset.parse_vid_xml`` returns (boxes −1 to 0-based float32, labels
1-based int64, names outside the table skipped, the first ``MAX_OBJECTS``
kept boxes), or None when the file cannot be read, where the caller falls
back to ElementTree as the JAX package does.

Unlike the JAX module, a library that cannot be built or loaded raises
(``ops/kernel_build.py`` builds it with the host compiler on first use),
and the class table is a handle per table, cached here and passed to every
call, instead of one table in the library that each call may replace: two
datasets with different tables can scan from two loader threads at once.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np

from ..ops import kernel_build

MAX_OBJECTS = 256          # kept boxes per XML, as the JAX scanner's _MAX_OBJ

_LIB = None
_TABLES: Dict[tuple, int] = {}
_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = kernel_build.load("vidmeta")
            lib.vidmeta_classes_new.argtypes = [ctypes.c_char_p]
            lib.vidmeta_classes_new.restype = ctypes.c_void_p
            lib.vidmeta_classes_free.argtypes = [ctypes.c_void_p]
            lib.vidmeta_parse_xml.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            lib.vidmeta_parse_xml.restype = ctypes.c_int
            lib.vidmeta_count_objects.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
            lib.vidmeta_count_objects.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def class_table(class_to_index: Dict[str, int]) -> int:
    """The library's handle of a class table: the names of index > 0 in
    index order, labelled 1, 2, ... (as the JAX scanner numbers them).
    One handle per distinct table, kept for the life of the process."""
    key = tuple(c for _, c in sorted((i, c) for c, i in
                                     class_to_index.items() if i > 0))
    handle = _TABLES.get(key)
    if handle is None:
        lib = library()
        with _LOCK:
            handle = _TABLES.get(key)
            if handle is None:
                handle = lib.vidmeta_classes_new("\n".join(key).encode())
                _TABLES[key] = handle
    return handle


def parse_xml_fast(xml_path: str, class_to_index: Dict[str, int]):
    """(ann, (width, height), kept boxes) of one XML, or None when the file
    cannot be read."""
    lib = library()
    table = class_table(class_to_index)
    out = (ctypes.c_int * (MAX_OBJECTS * 5))()
    wh = (ctypes.c_int * 2)()
    n = lib.vidmeta_parse_xml(table, str(xml_path).encode(), out,
                              MAX_OBJECTS, wh)
    if n < 0:
        return None
    arr = np.ctypeslib.as_array(out).reshape(MAX_OBJECTS, 5)[:n]
    if n:
        bboxes = arr[:, :4].astype(np.float32) - 1
        labels = arr[:, 4].astype(np.int64)
    else:
        bboxes = np.zeros((0, 4), np.float32)
        labels = np.zeros((0,), np.int64)
    ann = dict(bboxes=bboxes, labels=labels,
               bboxes_ignore=np.zeros((0, 4), np.float32),
               labels_ignore=np.zeros((0,), np.int64))
    return ann, (int(wh[0]), int(wh[1])), int(n)


def count_objects(xml_path: str):
    """(number of <object> entries, (width, height)), or None when the file
    cannot be read."""
    wh = (ctypes.c_int * 2)()
    n = library().vidmeta_count_objects(str(xml_path).encode(), wh)
    return None if n < 0 else (int(n), (int(wh[0]), int(wh[1])))
