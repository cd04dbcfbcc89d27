"""Pinhole camera model and pixel-coordinate conventions, in PyTorch.

Port of ``perseus_tpu/camera.py:37-134``: kornia-convention pixel
(de)normalization, intrinsics from a field of view and as a matrix, pinhole
projection with its Jacobian, the Blender -> OpenCV camera convention, and
the streaming path's center crop. Functions broadcast over leading
dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perseus_tpu_torch.lie import SE3, euler_xyz_to_rot, se3_compose, transform_to

__all__ = [
    "Intrinsics",
    "normalize_pixel_coordinates",
    "denormalize_pixel_coordinates",
    "intrinsics_from_fov",
    "intrinsics_matrix",
    "project",
    "project_jacobians",
    "project_world_point",
    "blender_to_opencv_pose",
    "center_crop_hw",
]


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (zero skew)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor


def normalize_pixel_coordinates(coords: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Pixel coords (..., 2) as (u, v) -> [-1, 1]: u_n = 2 u / (W - 1) - 1."""
    scale = torch.tensor(
        [2.0 / (width - 1.0), 2.0 / (height - 1.0)], dtype=coords.dtype, device=coords.device
    )
    return coords * scale - 1.0


def denormalize_pixel_coordinates(coords: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Inverse of :func:`normalize_pixel_coordinates`."""
    scale = torch.tensor(
        [(width - 1.0) / 2.0, (height - 1.0) / 2.0], dtype=coords.dtype, device=coords.device
    )
    return (coords + 1.0) * scale


def intrinsics_from_fov(fov: torch.Tensor, height: int, width: int) -> Intrinsics:
    """f = size / (2 tan(fov / 2)), principal point at the image center."""
    f_x = width / (2.0 * torch.tan(fov / 2.0))
    f_y = height / (2.0 * torch.tan(fov / 2.0))
    return Intrinsics(f_x, f_y, torch.full_like(f_x, width / 2.0), torch.full_like(f_y, height / 2.0))


def intrinsics_matrix(k: Intrinsics) -> torch.Tensor:
    """3x3 camera matrix (leading dims broadcast from the fields)."""
    zero = torch.zeros_like(k.fx)
    one = torch.ones_like(k.fx)
    return torch.stack(
        [
            torch.stack([k.fx, zero, k.cx], dim=-1),
            torch.stack([zero, k.fy, k.cy], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def project(k: Intrinsics, p_cam: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) to pixels (..., 2)."""
    z = p_cam[..., 2]
    u = k.fx * p_cam[..., 0] / z + k.cx
    v = k.fy * p_cam[..., 1] / z + k.cy
    return torch.stack([u, v], dim=-1)


def project_jacobians(k: Intrinsics, p_cam: torch.Tensor):
    """Returns (pixel (..., 2), d pixel / d p_cam (..., 2, 3))."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    inv_z = 1.0 / z
    u = k.fx * x * inv_z + k.cx
    v = k.fy * y * inv_z + k.cy
    zero = torch.zeros_like(z)
    row_u = torch.stack([k.fx * inv_z + zero, zero, -k.fx * x * inv_z * inv_z], dim=-1)
    row_v = torch.stack([zero, k.fy * inv_z + zero, -k.fy * y * inv_z * inv_z], dim=-1)
    return torch.stack([u, v], dim=-1), torch.stack([row_u, row_v], dim=-2)


def project_world_point(k: Intrinsics, camera_pose: SE3, p_world: torch.Tensor) -> torch.Tensor:
    """Project a world point through a camera at `camera_pose` (cam-to-world)."""
    return project(k, transform_to(camera_pose, p_world))


def blender_to_opencv_pose(camera_pose: SE3) -> SE3:
    """Convert a Blender camera pose (looks along -Z, +Y up) to the OpenCV
    convention (+Z forward, -Y up) by right-composing a pi rotation about x."""
    trans = camera_pose.trans
    rot = euler_xyz_to_rot(torch.tensor([torch.pi, 0.0, 0.0], dtype=trans.dtype, device=trans.device))
    return se3_compose(camera_pose, SE3(rot, torch.zeros(3, dtype=trans.dtype, device=trans.device)))


def center_crop_hw(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Center-crop (..., H, W, C) images to (..., out_h, out_w, C)."""
    h, w = image.shape[-3], image.shape[-2]
    top = h // 2 - out_h // 2
    left = w // 2 - out_w // 2
    return image[..., top : top + out_h, left : left + out_w, :]
