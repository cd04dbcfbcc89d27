"""Weights into the port's layout: from the JAX package's dicts, and from
reference-layout ``.pth`` checkpoints.

The JAX package keeps (params, batch_stats) as flat dicts under torchvision
names, conv kernels HWIO and ``fc.weight`` (in, out). The port keeps one flat
dict (a ``state_dict``) under the same names, conv weights OIHW and
``fc.weight`` (out, in). The reference's own checkpoints are ``state_dict``
files whose keys may carry ``module.`` (DDP) and ``resnet.`` (submodule)
prefixes; they are already in the port's layout.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["from_jax_params", "from_jax_folded", "load_reference_pth", "load_model"]


def _to_torch_layout(key: str, value) -> torch.Tensor:
    v = np.asarray(value, dtype=np.float32)
    if key == "fc.weight":
        v = v.T  # (in, out) -> (out, in)
    elif v.ndim == 4:
        v = v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return torch.from_numpy(np.array(v, order="C"))


def from_jax_params(
    params: Mapping[str, np.ndarray], stats: Mapping[str, np.ndarray]
) -> dict[str, torch.Tensor]:
    """JAX (params, batch_stats) dicts (numpy or array-likes) -> one f32
    CPU state dict in the port's layout."""
    out = {k: _to_torch_layout(k, v) for k, v in params.items()}
    out.update({k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in stats.items()})
    return out


def from_jax_folded(folded: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A JAX ``fold_batchnorm`` dict -> the port's folded dict (conv weights
    OIHW, biases and head as they are apart from fc.weight's transpose)."""
    return {k: _to_torch_layout(k, v) for k, v in folded.items()}


def load_reference_pth(path: str) -> dict[str, torch.Tensor]:
    """A reference-layout ``.pth`` state dict -> the port's f32 state dict:
    ``module.``/``resnet.`` prefixes stripped, ``num_batches_tracked`` dropped."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for key, value in raw.items():
        k = key.removeprefix("module.").removeprefix("resnet.")
        if not k.endswith("num_batches_tracked"):
            out[k] = value.to(torch.float32)
    return out


def load_model(path: str) -> dict[str, torch.Tensor]:
    """Loads a model state dict from a reference-layout ``.pth``.

    The JAX package's native checkpoints are orbax directories, which need
    JAX's orbax to read; export one to ``.pth`` with
    ``perseus_tpu.train.checkpoint.export_reference_pth`` first.
    """
    if path.endswith((".pth", ".pt")):
        return load_reference_pth(path)
    raise ValueError(
        f"{path!r} is not a .pth/.pt checkpoint; orbax checkpoint directories are not read by "
        "the port (export one with perseus_tpu.train.checkpoint.export_reference_pth)"
    )
