"""Smoother residuals with analytic Jacobians, in PyTorch.

Port of ``perseus_tpu/smoother/residuals.py``: rigid-body pose dynamics,
constant velocity and keypoint pinhole projection, the reference's three
GTSAM factors. GTSAM conventions: twists [omega; v], right-perturbation
Jacobians; the dynamics residual is Log((x1 . Exp(dt [w1; v1_body]))^-1 . x2)
and the projection residual project(K, camera_pose^-1 . (body_pose . p)) - z
with the body pose as the variable. Functions broadcast over leading
dimensions (the JAX package vmaps them), so one call covers a window.
"""

from __future__ import annotations

import torch

from perseus_tpu_torch.camera import Intrinsics, project_jacobians
from perseus_tpu_torch.lie import (
    SE3,
    matvec,
    se3_adjoint,
    se3_between,
    se3_compose,
    se3_exp,
    se3_inverse,
    se3_log,
    se3_logmap_derivative,
    se3_right_jacobian,
    skew,
    transform_from_jacobians,
    transform_to_jacobians,
)

__all__ = [
    "dynamics_residual",
    "dynamics_residual_and_jacobians",
    "constant_velocity_residual",
    "constant_velocity_jacobians",
    "keypoint_projection_residual",
    "keypoint_projection_residual_and_jacobian",
]


def _body_velocity(pose1: SE3, vel1: torch.Tensor, vel_frame: str) -> torch.Tensor:
    if vel_frame == "world":
        return matvec(pose1.rot.transpose(-1, -2), vel1)
    return vel1


def dynamics_residual(
    pose1: SE3, ang_vel1: torch.Tensor, vel1: torch.Tensor, pose2: SE3, dt: float,
    vel_frame: str = "world",
) -> torch.Tensor:
    """Log of the pose error between an exp-map Euler prediction and pose2."""
    v_body = _body_velocity(pose1, vel1, vel_frame)
    xi = dt * torch.cat([ang_vel1, v_body], dim=-1)
    pred = se3_compose(pose1, se3_exp(xi))
    return se3_log(se3_between(pred, pose2))


def dynamics_residual_and_jacobians(
    pose1: SE3, ang_vel1: torch.Tensor, vel1: torch.Tensor, pose2: SE3, dt: float,
    vel_frame: str = "world",
):
    """Returns (residual (..., 6), H_pose1 (..., 6, 6), H_ang_vel1 (..., 6, 3),
    H_vel1 (..., 6, 3), H_pose2 (..., 6, 6))."""
    v_body = _body_velocity(pose1, vel1, vel_frame)
    xi = dt * torch.cat([ang_vel1, v_body], dim=-1)
    increment = se3_exp(xi)
    pred = se3_compose(pose1, increment)
    rel = se3_between(pred, pose2)
    r = se3_log(rel)

    dlog = se3_logmap_derivative(rel)
    drel_dpred = -se3_adjoint(se3_inverse(rel))  # between H1
    dpred_dx1 = se3_adjoint(se3_inverse(increment))  # compose H1
    jr_xi = se3_right_jacobian(xi)

    derr_dtwist = dt * (dlog @ drel_dpred @ jr_xi)  # wrt [w; v_body]

    h_pose1 = dlog @ drel_dpred @ dpred_dx1
    h_ang = derr_dtwist[..., :, :3]
    if vel_frame == "world":
        # v_body = R1^T v_world: d v_body / d omega = skew(v_body),
        # d v_body / d v_world = R1^T
        h_pose1 = torch.cat(
            [h_pose1[..., :, :3] + derr_dtwist[..., :, 3:] @ skew(v_body), h_pose1[..., :, 3:]],
            dim=-1,
        )
        h_vel = derr_dtwist[..., :, 3:] @ pose1.rot.transpose(-1, -2)
    else:
        h_vel = derr_dtwist[..., :, 3:]
    return r, h_pose1, h_ang, h_vel, dlog


def constant_velocity_residual(vel1: torch.Tensor, vel2: torch.Tensor) -> torch.Tensor:
    """vel2 - vel1."""
    return vel2 - vel1


def constant_velocity_jacobians(dim: int = 3, dtype=torch.float32, device="cpu"):
    eye = torch.eye(dim, dtype=dtype, device=device)
    return -eye, eye


def keypoint_projection_residual(
    body_pose: SE3,
    intrinsics: Intrinsics,
    keypoint_measurement: torch.Tensor,
    point_body_frame: torch.Tensor,
    camera_pose: SE3 | None = None,
) -> torch.Tensor:
    """Projection of a body-frame point minus the measured pixel (..., 2)."""
    p_world = matvec(body_pose.rot, point_body_frame) + body_pose.trans
    if camera_pose is not None:
        p_cam = matvec(camera_pose.rot.transpose(-1, -2), p_world - camera_pose.trans)
    else:
        p_cam = p_world
    z = p_cam[..., 2]
    u = intrinsics.fx * p_cam[..., 0] / z + intrinsics.cx
    v = intrinsics.fy * p_cam[..., 1] / z + intrinsics.cy
    return torch.stack([u, v], dim=-1) - keypoint_measurement


def keypoint_projection_residual_and_jacobian(
    body_pose: SE3,
    intrinsics: Intrinsics,
    keypoint_measurement: torch.Tensor,
    point_body_frame: torch.Tensor,
    camera_pose: SE3 | None = None,
):
    """Returns (residual (..., 2), H_body_pose (..., 2, 6))."""
    p_world, dpw_dpose, _ = transform_from_jacobians(body_pose, point_body_frame)
    if camera_pose is not None:
        p_cam, _, dpc_dpw = transform_to_jacobians(camera_pose, p_world)
        pixel, dproj_dpc = project_jacobians(intrinsics, p_cam)
        h = dproj_dpc @ dpc_dpw @ dpw_dpose
    else:
        pixel, dproj_dpc = project_jacobians(intrinsics, p_world)
        h = dproj_dpc @ dpw_dpose
    return pixel - keypoint_measurement, h
