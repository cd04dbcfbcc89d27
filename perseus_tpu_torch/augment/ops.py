"""Depth-image ops. Port of ``perseus_tpu/augment/ops.py::depth_plane_clamp``;
the train-time augmentation ops come with the training slice."""

from __future__ import annotations

import torch

__all__ = ["depth_plane_clamp"]


def depth_plane_clamp(
    depth: torch.Tensor,
    near_mean: float = 0.1,
    near_value: float = 0.0,
    far_mean: float = 0.5,
    far_value: float = 0.0,
    cube_scale: float = 0.035,
) -> torch.Tensor:
    """Deterministic near/far clamp for the val/streaming path."""
    scaled = cube_scale * depth
    scaled = torch.where(scaled < near_mean, near_value, scaled)
    scaled = torch.where(scaled > far_mean, far_value, scaled)
    return scaled / cube_scale
