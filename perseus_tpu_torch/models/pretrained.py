"""Pretrained-backbone initialization from a torchvision ResNet-18 checkpoint.

The port's copy of ``perseus_tpu/models/pretrained.py``, on state-dict keys
alone (torchvision is not needed): a bare torchvision ``resnet18``
classifier state dict (1000-way ``fc``, no ``resnet.`` nesting)
initializes the keypoint CNN the way the reference's constructor does:
backbone weights and BN running stats from the checkpoint, ``conv1`` (when
``num_channels != 3``) and ``fc`` fresh, from the port's own init
(``KeypointCNN``, seeded), because the reference's module replacement
discards their pretrained values too. torchvision's layout is the port's
(conv OIHW, ``fc.weight`` (out, in)), so nothing is transposed.
"""

from __future__ import annotations

import torch

from perseus_tpu_torch.models import convert

__all__ = ["adapt_torchvision_resnet18", "looks_like_torchvision_resnet18", "load_pretrained_checkpoint"]


def looks_like_torchvision_resnet18(state_dict: dict) -> bool:
    """A bare torchvision classifier checkpoint: 1000-way fc, no ``resnet.``
    nesting."""
    keys = set(state_dict.keys())
    return (
        "conv1.weight" in keys
        and "fc.weight" in keys
        and tuple(getattr(state_dict["fc.weight"], "shape", (0, 0)))[0] == 1000
    )


def adapt_torchvision_resnet18(
    state_dict: dict, n_keypoints: int = 8, num_channels: int = 4, seed: int = 0
) -> dict[str, torch.Tensor]:
    """torchvision resnet18 state dict -> the keypoint CNN's f32 CPU state
    dict: the backbone's convs, BNs and running stats from the checkpoint;
    ``conv1`` kept when ``num_channels == 3``, else fresh at the new width
    (kaiming fan-out normal); ``fc`` fresh at ``2*n_keypoints`` outputs
    (torch ``Linear``'s uniform). The fresh tensors come from
    ``KeypointCNN``'s init drawn from ``seed``."""
    from perseus_tpu_torch.models.resnet import KeypointCNN

    sd = convert.normalize_reference_sd({k: torch.as_tensor(v) for k, v in state_dict.items()})
    fresh = KeypointCNN(n_keypoints, num_channels, device="cpu", generator=torch.Generator().manual_seed(seed))
    fresh_sd = fresh.state_dict()
    replaced = ["fc.weight", "fc.bias"] + (["conv1.weight"] if num_channels != 3 else [])
    for k in replaced:
        sd[k] = fresh_sd[k].detach().clone()
    return sd


def load_pretrained_checkpoint(
    path: str, n_keypoints: int = 8, num_channels: int = 4, seed: int = 0
) -> dict[str, torch.Tensor]:
    """Loads a ``.pth`` that may be either a reference keypoint checkpoint
    or a bare torchvision resnet18 classifier; adapts the latter."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if looks_like_torchvision_resnet18(raw):
        return adapt_torchvision_resnet18(raw, n_keypoints, num_channels, seed)
    return convert.normalize_reference_sd(raw)
