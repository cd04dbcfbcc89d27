"""Keypoint labeling math: project the cube's corners to pixels.

Port of ``perseus_tpu/datagen/labeling.py``: the Blender -> OpenCV camera
conversion, intrinsics from the field of view, and the projection of the 8
scaled cube corners through per-frame object / camera poses, vectorised
over frames.
"""

from __future__ import annotations

import torch

from perseus_tpu_torch import camera, lie, resolve_device

__all__ = ["cube_corners", "get_pixel_coordinates", "label_trajectory"]

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


def get_pixel_coordinates(
    keypoints: torch.Tensor,
    object_poses7_xyzw: torch.Tensor,
    camera_poses7_xyzw: torch.Tensor,
    fov: float,
    height: int,
    width: int,
) -> torch.Tensor:
    """Projects object-frame keypoints (K, 3) through (T, 7) object-to-world
    poses [xyz, quat xyzw] and (T, 7) Blender camera-to-world poses; returns
    (T, K, 2) pixel coordinates (u, v), on the keypoints' device and dtype."""
    obj = lie.pose7_xyzw_to_se3(object_poses7_xyzw)
    cam_cv = camera.blender_to_opencv_pose(lie.pose7_xyzw_to_se3(camera_poses7_xyzw))
    cam_from_obj = lie.se3_compose(lie.se3_inverse(cam_cv), obj)
    fov_t = torch.tensor(fov, dtype=keypoints.dtype, device=keypoints.device)
    k = camera.intrinsics_from_fov(fov_t, height, width)
    p_cam = lie.transform_from(
        lie.SE3(cam_from_obj.rot[:, None], cam_from_obj.trans[:, None]), keypoints[None, :, :]
    )  # (T, K, 3)
    return camera.project(k, p_cam)


def label_trajectory(
    object_poses7_wxyz,
    camera_poses7_wxyz,
    abs_scale: float,
    fov: float,
    height: int,
    width: int,
    device: str | torch.device | None = "cuda",
) -> torch.Tensor:
    """Labels one trajectory from kubric-style metadata (quaternions wxyz,
    as ``metadata.json`` writes them), on ``device`` in f32. Returns (T, 8,
    2) pixel coordinates."""
    dev = resolve_device(device)
    obj7 = torch.as_tensor(object_poses7_wxyz, dtype=torch.float32).to(dev)
    cam7 = torch.as_tensor(camera_poses7_wxyz, dtype=torch.float32).to(dev)

    def to_xyzw(p7):
        return torch.cat([p7[..., :3], p7[..., 4:7], p7[..., 3:4]], dim=-1)

    corners = cube_corners(abs_scale, device=dev)
    return get_pixel_coordinates(corners, to_xyzw(obj7), to_xyzw(cam7), fov, height, width)
