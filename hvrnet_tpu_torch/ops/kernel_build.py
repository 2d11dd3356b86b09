"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``hvrnet_tpu_torch/csrc/`` compiles on its own into a
shared library with a plain C interface, for ``sm_90a`` (Hopper).  A
source may include the headers beside it (``csrc/*.cuh``, inline PTX for
TMA, mbarriers and wgmma); no CUTLASS or CuTe header is used, so the build
needs only the CUDA toolkit.  The library is named after a hash of its
source, every header in ``csrc/`` and the flags, and lands in
``build/kernels/`` at the root of the checkout, so a changed source or
header is rebuilt and an unchanged one is reused.  Nothing is built at
import: the first call that needs a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("masked_attention",)          # one library per csrc/<name>.cu
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current library exists.  Returns
    nvcc's ptxas report ("" when the library was already built); raises with
    nvcc's output if the build fails."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}.cu (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load its library."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
