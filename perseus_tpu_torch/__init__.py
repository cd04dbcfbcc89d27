"""perseus_tpu_torch: the PyTorch/CUDA port of perseus_tpu.

The JAX package ``perseus_tpu`` beside this one is the reference; every module
here mirrors the module of the same name there and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports torch and numpy
only, never jax and nothing of ``perseus_tpu``: what it needs from there it
keeps as its own copy.

Its entry points run on the CUDA card unless the caller passes
``device="cpu"``; they raise when asked for CUDA on a host without it.
"""

from __future__ import annotations

import os

import torch

# Absolute path of the repository root (the parent of this package).
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

__version__ = "0.1.0"

__all__ = ["ROOT", "resolve_device", "__version__"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked for
    another. Raises instead of falling back when CUDA is asked for (or left
    as the default with ``None``) and the host has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run on the CPU"
        )
    return dev
