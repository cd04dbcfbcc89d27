"""Cube geometry for labeling and pose: the scaled cube corners.

Port of ``perseus_tpu/datagen/labeling.py::cube_corners``; the rest of the
labeler comes with the datagen slice.
"""

from __future__ import annotations

import torch

__all__ = ["cube_corners"]

# itertools.product order over (x, y, z) in {-1, +1}: the reference's corner
# ordering, which the detector's keypoint order follows
_SIGNS = (
    (-1, -1, -1),
    (-1, -1, 1),
    (-1, 1, -1),
    (-1, 1, 1),
    (1, -1, -1),
    (1, -1, 1),
    (1, 1, -1),
    (1, 1, 1),
)


def cube_corners(
    scale: float, dtype: torch.dtype = torch.float32, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """The 8 cube corners (+/-1 per axis) scaled by `scale`, (8, 3)."""
    return torch.tensor(_SIGNS, dtype=torch.float32, device=device).mul(scale).to(dtype)
