"""Build the port's native code and load it with ``ctypes``.

Two routes, one shared library each, both with a plain C interface:

- ``csrc/<name>.cu`` (``SOURCES``), the CUDA kernels, compiled by ``nvcc``
  for ``sm_90a`` (Hopper).  A source may include the headers beside it
  (``csrc/*.cuh``, inline PTX for TMA, mbarriers and wgmma); no CUTLASS or
  CuTe header is used, so the build needs only the CUDA toolkit.
- ``csrc/<name>.cpp`` (``HOST_SOURCES``), the data layer's host code (the
  JPEG decoder, the annotation scanner), compiled by the host's ``c++``
  with ``HOST_FLAGS`` (integer code: no ``-ffast-math``).  These build on
  any machine with a C++17 compiler, the CPU test machine too.

A library is named after a hash of its source (for ``.cu`` also every
header in ``csrc/``) and its flags, and lands in ``build/kernels/`` at the
root of the checkout, so a changed source is rebuilt and an unchanged one
is reused.  Nothing is built at import: the first call that needs a
library builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("masked_attention",)          # one library per csrc/<name>.cu
HOST_SOURCES = ("jpeg_decode", "vidmeta")  # one per csrc/<name>.cpp
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCKS = {name: threading.Lock() for name in SOURCES + HOST_SOURCES}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def cxx_path() -> str:
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no host C++ compiler (c++) on the PATH: the data "
                           "layer's native code cannot be built")
    return path


def source(name: str) -> Path:
    if name in SOURCES:
        return CSRC / f"{name}.cu"
    if name in HOST_SOURCES:
        return CSRC / f"{name}.cpp"
    raise KeyError(f"no native source named {name!r}")


def library_path(name: str) -> Path:
    src = source(name)
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        h.update(" ".join(HOST_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (c++)
    unless its current library exists.  Returns the compiler's output
    (nvcc's ptxas report; "" when the library was already built); raises
    with the compiler's output if the build fails.  Safe to call from
    several threads and processes at once."""
    out = library_path(name)
    with _LOCKS[name]:
        if out.exists():
            return ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = source(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if src.suffix == ".cu":
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        else:
            cmd = [cxx_path(), *HOST_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed: {src.name} ({cmd[0]} "
                               f"exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)
        return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` or ``.cpp`` if needed and load its
    library."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
