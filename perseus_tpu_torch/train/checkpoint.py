"""Checkpoints: the whole train state for exact resume, and ``.pth`` interop.

The port's counterpart of ``perseus_tpu/train/checkpoint.py``, with torch
files in place of orbax:

  * :func:`save_train_state` / :func:`restore_train_state`: a directory
    holding one ``torch.save`` file (:data:`STATE_FILE`) of the whole state
    dict (params, batch stats, the AdamW state, epoch, LR, the plateau
    scheduler's memory, the EMA: whatever the caller puts in it), written
    to a temporary name and then ``os.replace``d, so a reader never sees a
    half-written file;
  * :func:`load_model`: (params + batch stats) as one state dict from a
    port checkpoint directory or a ``.pth`` (reference layout, or a bare
    torchvision classifier, through ``models/convert.py::load_model``);
    orbax directories of the JAX package stay unread;
  * :func:`export_reference_pth`: a reference-layout ``.pth`` (keys under
    ``resnet.``, with ``num_batches_tracked``), which the JAX package's
    ``load_model`` reads too.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from perseus_tpu_torch.models import convert

__all__ = ["STATE_FILE", "save_train_state", "restore_train_state", "load_model", "export_reference_pth"]

STATE_FILE = "train_state.pt"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu")
    if dataclasses.is_dataclass(tree):  # the AdamW state, as a plain dict
        return {f.name: _to_cpu(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return tree


def save_train_state(directory: str, state: dict) -> None:
    """Saves ``state`` (tensors on any device, ``AdamWState``, numbers) to
    ``directory`` (made if missing; an earlier state there is replaced)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, STATE_FILE + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, os.path.join(directory, STATE_FILE))


def restore_train_state(directory: str, device: str | torch.device = "cpu") -> dict:
    """The state dict :func:`save_train_state` wrote, its tensors on
    ``device``; ``opt_state`` comes back as the port's ``AdamWState``."""
    from perseus_tpu_torch.train.train import AdamWState

    saved = torch.load(os.path.join(os.path.abspath(directory), STATE_FILE), map_location=device, weights_only=True)
    if "opt_state" in saved:
        saved["opt_state"] = AdamWState(**saved["opt_state"])
    return saved


def load_model(path: str) -> dict[str, torch.Tensor]:
    """(params and batch stats) as one f32 CPU state dict, from a port
    checkpoint directory or a ``.pth``."""
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        saved = restore_train_state(path)
        return {**saved["params"], **saved["batch_stats"]}
    return convert.load_model(path)


def export_reference_pth(path: str, params: dict, batch_stats: dict) -> None:
    """Writes a reference-format torch checkpoint: keys under ``resnet.``,
    one ``num_batches_tracked`` (0) per BN layer, f32 CPU tensors."""
    torch.save(convert.to_reference_sd({**params, **batch_stats}), path)
