"""ctypes bindings for the native batch image decoder (``src/perseus_io.cpp``).

The port's copy of ``perseus_tpu/native/io.py``. The shared library is
compiled with ``g++ -O3`` (linked against libpng and zlib) at first use into
``perseus_tpu_torch/_build/``, its name keyed by a hash of the source. The
build writes to a temporary name and renames it into place, so processes
that build at once never load a half-written file. Where no toolchain or
libpng is present :func:`available` is False and callers keep the PIL path,
which gives bit-identical rows.

The decoder fills whole contiguous NHWC float batches with a C++ thread
pool in one call that releases the GIL. It is host code: it never touches
the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["available", "decode_batch", "decode_example", "library_path"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "perseus_io.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def library_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libperseus_io_{tag}.so")


def _compile() -> str:
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp, "-lpng", "-lz", "-lpthread"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(_compile())
        except Exception:  # no g++ or libpng: the caller keeps the PIL path
            return None
        c_charpp = ctypes.POINTER(ctypes.c_char_p)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.pio_decode_batch.argtypes = [
            c_charpp, c_charpp, c_charpp, ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p,
        ]
        lib.pio_decode_batch.restype = ctypes.c_int
        lib.pio_decode_example.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, f32p, f32p, f32p,
        ]
        lib.pio_decode_example.restype = ctypes.c_int
        lib.pio_last_error.restype = ctypes.c_char_p
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _paths_array(paths: list[str] | None):
    if paths is None:
        return None
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def decode_batch(
    rgb_paths: list[str],
    depth_paths: list[str] | None,
    seg_paths: list[str] | None,
    asset_ids: np.ndarray | None,
    h: int,
    w: int,
    threads: int = 0,
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None, int]:
    """Decodes a batch into (rgb (N, H, W, 3), depth (N, H, W) | None,
    seg (N, H, W) | None, n_failures); a failed item is zero-filled. The
    segmentation is binarized as ``seg == asset_id + 1``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(rgb_paths)
    if threads <= 0:
        threads = min(n, os.cpu_count() or 4)
    rgb = np.empty((n, h, w, 3), dtype=np.float32)
    depth = np.empty((n, h, w), dtype=np.float32) if depth_paths is not None else None
    seg = np.empty((n, h, w), dtype=np.float32) if seg_paths is not None else None
    ids = np.ascontiguousarray(np.asarray(asset_ids if asset_ids is not None else np.zeros(n), dtype=np.int64))
    f32p = ctypes.POINTER(ctypes.c_float)
    failures = lib.pio_decode_batch(
        _paths_array(rgb_paths),
        _paths_array(depth_paths),
        _paths_array(seg_paths),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n, h, w, threads,
        rgb.ctypes.data_as(f32p),
        depth.ctypes.data_as(f32p) if depth is not None else None,
        seg.ctypes.data_as(f32p) if seg is not None else None,
    )
    return rgb, depth, seg, int(failures)


def decode_example(
    rgb_path: str, depth_path: str | None, seg_path: str | None, asset_id: int, h: int, w: int
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
    """Decodes one example; raises with the decoder's message on failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    rgb = np.empty((h, w, 3), dtype=np.float32)
    depth = np.empty((h, w), dtype=np.float32) if depth_path else None
    seg = np.empty((h, w), dtype=np.float32) if seg_path else None
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.pio_decode_example(
        rgb_path.encode(),
        depth_path.encode() if depth_path else None,
        seg_path.encode() if seg_path else None,
        asset_id, h, w,
        rgb.ctypes.data_as(f32p),
        depth.ctypes.data_as(f32p) if depth is not None else None,
        seg.ctypes.data_as(f32p) if seg is not None else None,
    )
    if rc != 0:
        raise RuntimeError(f"decode failed: {lib.pio_last_error().decode()}")
    return rgb, depth, seg
