"""Weights into the port's layout: from the JAX package's dicts, and from
reference-layout ``.pth`` checkpoints.

The JAX package keeps (params, batch_stats) as flat dicts under torchvision
names, conv kernels HWIO and ``fc.weight`` (in, out). The port keeps one flat
dict (a ``state_dict``) under the same names, conv weights OIHW and
``fc.weight`` (out, in). The reference's own checkpoints are ``state_dict``
files whose keys may carry ``module.`` (DDP) and ``resnet.`` (submodule)
prefixes; they are already in the port's layout.

A JAX ``TrainState`` (params, batch_stats and the optax state of
``make_optimizer``, as numpy) becomes the port's ``TrainState`` with
:func:`from_jax_train_state`, so that both packages take the same next
step: :func:`convert_opt_state` maps optax's ``mu``, ``nu`` and ``count``
to ``exp_avg``, ``exp_avg_sq`` and ``step``, and its injected
``learning_rate`` and ``weight_decay`` along.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

__all__ = [
    "from_jax_params",
    "from_jax_folded",
    "normalize_reference_sd",
    "to_reference_sd",
    "load_reference_pth",
    "load_model",
    "convert_opt_state",
    "from_jax_train_state",
]


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


def normalize_reference_sd(raw: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A reference-layout state dict -> the port's f32 state dict:
    ``module.``/``resnet.`` prefixes stripped, ``num_batches_tracked`` dropped."""
    out = {}
    for key, value in raw.items():
        k = key.removeprefix("module.").removeprefix("resnet.")
        if not k.endswith("num_batches_tracked"):
            out[k] = value.to(torch.float32)
    return out


def to_reference_sd(sd: Mapping[str, torch.Tensor], prefix: str = "resnet.") -> dict[str, torch.Tensor]:
    """The inverse of :func:`normalize_reference_sd`: the port's state dict
    -> the reference layout, f32 CPU tensors, keys under ``prefix``, one
    ``num_batches_tracked`` (0) per BN layer, as the JAX package's
    ``convert.to_torch_state_dict`` writes them."""
    out = {}
    for key, value in sd.items():
        out[prefix + key] = value.detach().to("cpu", torch.float32).contiguous().clone()
        if key.endswith("running_var"):
            out[f"{prefix}{key.rsplit('.', 1)[0]}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def load_reference_pth(path: str) -> dict[str, torch.Tensor]:
    """A reference-layout ``.pth`` state dict -> the port's f32 state dict
    (:func:`normalize_reference_sd`)."""
    return normalize_reference_sd(torch.load(path, map_location="cpu", weights_only=True))


def load_model(path: str) -> dict[str, torch.Tensor]:
    """Loads a model state dict from a ``.pth``: a reference-layout
    checkpoint, or a bare torchvision resnet18 classifier, which
    ``models/pretrained.py`` adapts (backbone kept, conv1 and fc fresh).

    The JAX package's native checkpoints are orbax directories, which need
    JAX's orbax to read; export one to ``.pth`` with
    ``perseus_tpu.train.checkpoint.export_reference_pth`` first. The port's
    own checkpoint directories load through ``train/checkpoint.py::load_model``.
    """
    if path.endswith((".pth", ".pt")):
        from perseus_tpu_torch.models.pretrained import load_pretrained_checkpoint

        return load_pretrained_checkpoint(path)
    raise ValueError(
        f"{path!r} is not a .pth/.pt checkpoint; orbax checkpoint directories are not read by "
        "the port (export one with perseus_tpu.train.checkpoint.export_reference_pth)"
    )


def _find(tree, pred):
    """Depth-first search of an optax state (tuples, named tuples, dicts)
    for the first node satisfying ``pred``; the port imports no optax."""
    if pred(tree):
        return tree
    children = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (tuple, list)) else ()
    for child in children:
        hit = _find(child, pred)
        if hit is not None:
            return hit
    return None


def convert_opt_state(optax_state):
    """The optax state of ``perseus_tpu.train.train.make_optimizer``
    (clip_by_global_norm, then inject_hyperparams(adamw)), its leaves numpy
    or array-likes -> the port's ``AdamWState`` (f32 CPU tensors in the
    port's layouts, ``step`` a Python int)."""
    from perseus_tpu_torch.train.train import AdamWState

    adam = _find(optax_state, lambda n: all(hasattr(n, a) for a in ("mu", "nu", "count")))
    hyper = _find(optax_state, lambda n: isinstance(getattr(n, "hyperparams", None), dict))
    if adam is None or hyper is None:
        raise ValueError("not the optax state of clip_by_global_norm + inject_hyperparams(adamw)")
    return AdamWState(
        step=int(np.asarray(adam.count)),
        exp_avg={k: _to_torch_layout(k, v) for k, v in adam.mu.items()},
        exp_avg_sq={k: _to_torch_layout(k, v) for k, v in adam.nu.items()},
        learning_rate=float(np.asarray(hyper.hyperparams["learning_rate"])),
        weight_decay=float(np.asarray(hyper.hyperparams["weight_decay"])),
    )


def from_jax_train_state(params, batch_stats, opt_state, device: str | torch.device | None = "cuda"):
    """A JAX ``TrainState``'s three parts -> the port's ``TrainState`` on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    from perseus_tpu_torch import resolve_device
    from perseus_tpu_torch.train.train import TrainState

    device = resolve_device(device)
    sd = from_jax_params(params, batch_stats)
    opt = convert_opt_state(opt_state)
    move = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    return TrainState(
        params=move({k: sd[k] for k in params}),
        batch_stats=move({k: sd[k] for k in batch_stats}),
        opt_state=dataclasses.replace(opt, exp_avg=move(opt.exp_avg), exp_avg_sq=move(opt.exp_avg_sq)),
    )
