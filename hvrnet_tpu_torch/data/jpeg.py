"""The port's image decoder: ``cv2.imread(path, IMREAD_COLOR)`` without cv2.

``imread_native(path)`` and ``decode(data)`` return an (H, W, 3) uint8 BGR
array, bit for bit what cv2 5.0 (libjpeg-turbo 3.1) gives for:

- baseline and extended-sequential 8-bit Huffman JPEG, one component (grey,
  replicated to three channels) or three (YCbCr, or RGB under an Adobe
  marker), any integral sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1),
  restart intervals, optimised tables, 8- and 16-bit quantisation tables:
  ``csrc/jpeg_decode.cpp``, built by ``ops/kernel_build.py`` with the host
  compiler on first use, reproduces libjpeg-turbo's islow IDCT, fancy
  upsampling and fixed-point colour conversion;
- the EXIF orientation, applied as cv2 applies it (flips and transposes);
- binary PPM (P6) and PGM (P5) at 8 bits, recognised by their magic bytes
  whatever the file's name.

Anything else raises ``ValueError`` naming the file and the reason:
progressive, lossless, arithmetic-coded and 12-bit JPEG, CMYK and YCCK,
truncated or corrupt entropy data (which libjpeg-turbo would fill with grey
behind a warning), PNG and every other format.  There is no fallback to
another decoder.

The decoder's C calls release the GIL, so loader threads decode in
parallel.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops import kernel_build

_LIB = None
_LOCK = threading.Lock()
_ERR = 512


def library() -> ctypes.CDLL:
    """The decoder's library, built on first use (raises if it cannot be
    built or loaded)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = kernel_build.load("jpeg_decode")
            lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_info.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_char_p,
                                        ctypes.c_int]
            lib.jpeg_decode.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's EXIF transform (``ExifTransform`` in its loadsave.cpp) for
    orientations 1-8; other values leave the image as it is."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 6):
        img = img[:, ::-1]
    elif orientation in (3, 7):
        img = img[::-1, ::-1]
    elif orientation in (4, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    lib = library()
    err = ctypes.create_string_buffer(_ERR)
    info = (ctypes.c_int * 3)()
    if lib.jpeg_info(data, len(data), info, err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    h, w, orientation = info
    out = np.empty((h, w, 3), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, h, w, err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return orient(out, orientation)


def decode_pnm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Binary PPM (P6, RGB) or PGM (P5, grey) with maxval 255; ``#``
    comments in the header."""
    fields, pos = [], 2
    while len(fields) < 3:            # width, height, maxval
        while pos < len(data) and (data[pos:pos + 1].isspace()
                                   or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
            else:
                pos += 1
        end = pos
        while end < len(data) and data[end:end + 1].isdigit():
            end += 1
        if end == pos:
            raise ValueError(f"{name}: bad PNM header")
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"{name}: PNM with maxval {maxval} is not "
                         f"supported (8-bit only)")
    channels = 3 if data[:2] == b"P6" else 1
    count = h * w * channels
    if w < 1 or h < 1 or len(data) < pos + 1 + count:
        raise ValueError(f"{name}: truncated PNM file")
    px = np.frombuffer(data, np.uint8, count=count, offset=pos + 1)
    if channels == 1:
        return np.repeat(px.reshape(h, w, 1), 3, axis=2)
    return np.ascontiguousarray(px.reshape(h, w, 3)[..., ::-1])


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An encoded image's bytes → (H, W, 3) uint8 BGR; ``name`` goes into
    the ``ValueError`` of a refused file."""
    head = bytes(data[:2])
    if head == b"\xff\xd8":
        return decode_jpeg(data, name)
    if head in (b"P5", b"P6"):
        return decode_pnm(data, name)
    raise ValueError(f"{name}: not a JPEG or binary PPM/PGM file (the "
                     f"native decoder reads no other format)")


def imread_native(path) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_COLOR)`` for the formats above."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, str(path))
