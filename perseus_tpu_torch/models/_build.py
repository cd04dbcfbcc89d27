"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` has a plain C interface; it is compiled with ``nvcc``
for Hopper (``sm_90a``) into ``perseus_tpu_torch/_build/`` at first use and
loaded with ``ctypes``. The library's file name carries a hash of the source
and the flags, so an edited source never loads a stale build; the build
writes to a temporary name and renames it, so concurrent builds do not see
a half-written file. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["NVCC_FLAGS", "EXTRA_FLAGS", "build", "library_path", "load_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# Per-source additions. augment.cu rounds every product and sum on its own,
# as its plain PyTorch version does (the index planes of its warp must not
# be contracted into FMAs differently per use).
EXTRA_FLAGS = {"augment": ("-fmad=false",)}


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); cannot build the CUDA kernels")


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lives (content-addressed)."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compiles ``csrc/<name>.cu`` unless its build exists; returns the path."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_flags(name), "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}.cu ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library(name: str) -> ctypes.CDLL:
    """Builds (if needed) and loads ``csrc/<name>.cu``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
