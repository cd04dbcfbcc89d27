"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into ``perseus_tpu_torch/_build/`` at first use, and bound either through a
plain C interface loaded with ``ctypes`` (:func:`load_library`) or, where a
wrapper's per-call host time matters, as a Python extension module
(:func:`load_module`: ``csrc/maxpool.cu``, built against Python's headers).
The library's file name carries a hash of the source
and the flags, so an edited source never loads a stale build; the build
writes to a temporary name and renames it, so concurrent builds do not see
a half-written file. A failed build raises: there is no fallback.

``ptxas -v`` reports each kernel's registers, stack frame, spills and
shared memory; the build keeps that output beside the library, and
:func:`build_report` condenses it (with the integer divisions in the
SASS, where ``cuobjdump`` is present).
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import re
import shutil
import subprocess
import sysconfig
import tempfile

__all__ = ["NVCC_FLAGS", "EXTRA_FLAGS", "build", "build_report", "library_path", "load_library", "load_module"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Per-source additions. augment.cu rounds every product and sum on its own,
# as its plain PyTorch version does (the index planes of its warp must not
# be contracted into FMAs differently per use). maxpool.cu is a Python
# extension module and includes Python.h.
EXTRA_FLAGS = {"augment": ("-fmad=false",), "maxpool": ("-I", sysconfig.get_paths()["include"])}


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

_loaded: dict[str, ctypes.CDLL] = {}
_modules: dict = {}


def _cuda_tool(tool: str) -> str | None:
    found = shutil.which(tool)
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", tool)
    return candidate if os.path.exists(candidate) else None


def _nvcc() -> str:
    found = _cuda_tool("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); cannot build the CUDA kernels")
    return found


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lives (content-addressed)."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compiles ``csrc/<name>.cu`` unless its build exists; returns the path.
    The compiler's output is kept beside the library (``.log``)."""
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
        with open(path[: -len(".so")] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _demangle(names: list[str]) -> list[str]:
    tool = _cuda_tool("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def build_report(name: str) -> list[str]:
    """One line per kernel of the build of ``csrc/<name>.cu``: registers,
    stack frame, spill stores and loads, static shared memory (from ``ptxas
    -v``), and from its SASS (``cuobjdump -sass``, where present) the
    subroutine calls and the 64-bit and 32-bit integer divisions."""
    path = build(name)
    with open(path[: -len(".so")] + ".log") as f:
        log = f.read()
    funcs: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            current = funcs.setdefault(m.group(1), {})
        elif m := re.search(r"Compiling entry function '(\S+)'", line):
            current = funcs.setdefault(m.group(1), {})
        elif current is not None and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            current.update(stack=int(m.group(1)), spill_st=int(m.group(2)), spill_ld=int(m.group(3)))
        elif current is not None and (m := re.search(r"Used (\d+) registers", line)):
            current["regs"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(smem.group(1)) if smem else 0
    sass: dict[str, list[int]] | None = None
    tool = _cuda_tool("cuobjdump")
    if tool is not None:
        # per kernel: subroutine calls (CALL.REL), and the reciprocal seeds
        # of 64-bit (I2F.U64.RP) and 32-bit (I2F.RP, I2F.U32.RP) integer
        # division sequences, one per division
        sass, fn = {}, None
        dump = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
        for line in dump.splitlines():
            if m := re.search(r"Function : (\S+)", line):
                fn = sass.setdefault(m.group(1), [0, 0, 0])
            elif fn is not None:
                fn[0] += "CALL.REL" in line
                fn[1] += "I2F.U64.RP" in line
                fn[2] += bool(re.search(r"I2F(\.U32)?\.RP ", line))
    names = list(funcs)
    lines = []
    for mangled, pretty in zip(names, _demangle(names)):
        f = funcs[mangled]
        if "regs" not in f:  # a subroutine, not a kernel: its frame is its caller's
            continue
        if sass is None:
            divs = "SASS not read (no cuobjdump)"
        else:
            calls, div64, div32 = sass.get(mangled, (0, 0, 0))
            divs = f"SASS: {calls} CALL.REL, {div64} 64-bit and {div32} 32-bit integer-division sequences"
        lines.append(
            f"{pretty[:90]}: {f['regs']} registers, {f.get('stack', 0)} B stack frame, "
            f"{f.get('spill_st', 0)} B spill stores, {f.get('spill_ld', 0)} B spill loads, "
            f"{f['smem']} B static smem; {divs}"
        )
    return lines


def load_library(name: str) -> ctypes.CDLL:
    """Builds (if needed) and loads ``csrc/<name>.cu``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib


def load_module(name: str):
    """Builds (if needed) and imports ``csrc/<name>.cu`` as the Python
    extension module ``perseus_<name>`` (its ``PyInit_perseus_<name>``);
    cached per process."""
    mod = _modules.get(name)
    if mod is None:
        loader = importlib.machinery.ExtensionFileLoader(f"perseus_{name}", build(name))
        mod = importlib.util.module_from_spec(importlib.util.spec_from_loader(loader.name, loader))
        loader.exec_module(mod)
        _modules[name] = mod
    return mod
