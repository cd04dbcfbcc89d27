"""Fixed-lag smoother runtime: a sliding window over streaming keypoints.

Port of ``perseus_tpu/smoother/fixed_lag.py``. Each ``update`` shifts the
window (the oldest frame becomes the prior: marginalization by rekeying),
appends the new measurement, initializes the new frame by dynamics
propagation, gates whole-frame detector failures, runs LM and emits the
newest pose. The window size is fixed; warm-up is a validity mask. All
decisions (gate, reset) are tensor ``where``s, so an update on the card never
reads back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perseus_tpu_torch.camera import Intrinsics
from perseus_tpu_torch.lie import SE3, se3_identity
from perseus_tpu_torch.smoother.lm import SmootherConfig, WindowState, lm_solve, predict_next
from perseus_tpu_torch.smoother.residuals import keypoint_projection_residual

__all__ = ["FixedLagSmoother", "SmootherCarry", "median"]


class SmootherCarry(NamedTuple):
    window: WindowState
    measurements: torch.Tensor  # (T, K, 2)
    valid: torch.Tensor  # (T,) float 0/1
    prior_rot: torch.Tensor  # (3, 3)
    prior_trans: torch.Tensor  # (3,)
    prior_ang_vel: torch.Tensor  # (3,)
    prior_vel: torch.Tensor  # (3,)
    frames_seen: torch.Tensor  # scalar int32
    consec_rejects: torch.Tensor  # scalar int32 — innovation-gate state


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor, the mean of the two middle values for an even
    count (``jnp.median``); ``torch.median`` would return the lower one."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


class FixedLagSmoother:
    """Functional fixed-lag smoother over a window on ``points_body``'s device."""

    def __init__(
        self,
        cfg: SmootherConfig,
        intrinsics: Intrinsics,
        points_body: torch.Tensor,
        camera_pose: SE3 | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        self.cfg = cfg
        self.intrinsics = intrinsics
        self.points_body = points_body
        self.camera_pose = camera_pose
        self.dtype = dtype
        self.device = points_body.device

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def init(self, initial_pose: SE3 | None = None) -> SmootherCarry:
        t = self.cfg.window
        k = self.cfg.n_keypoints
        pose0 = initial_pose if initial_pose is not None else se3_identity(self.dtype, self.device)
        rot0 = pose0.rot.to(self.dtype)
        trans0 = pose0.trans.to(self.dtype)
        window = WindowState(
            rot=rot0.expand(t, 3, 3).clone(),
            trans=trans0.expand(t, 3).clone(),
            ang_vel=self._zeros(t, 3),
            vel=self._zeros(t, 3),
        )
        return SmootherCarry(
            window=window,
            measurements=self._zeros(t, k, 2),
            valid=self._zeros(t),
            prior_rot=rot0,
            prior_trans=trans0,
            prior_ang_vel=self._zeros(3),
            prior_vel=self._zeros(3),
            frames_seen=torch.zeros((), dtype=torch.int32, device=self.device),
            consec_rejects=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def coarse_pose_from_keypoints(self, keypoints_px: torch.Tensor) -> SE3:
        """Closed-form cold-start pose from one frame of detections: the
        weak-perspective POS step (least-squares rotation rows scaled by
        1/z0, Gram-Schmidt, translation from the centroid at that depth)."""
        kp = keypoints_px.to(self.dtype)
        p = self.points_body.to(self.dtype)
        pc = p - torch.mean(p, dim=0)
        center = torch.mean(kp, dim=0)
        ux = (kp[:, 0] - center[0]) / self.intrinsics.fx
        uy = (kp[:, 1] - center[1]) / self.intrinsics.fy
        pinv = torch.linalg.pinv(pc)  # (3, K); corners span 3D, full rank
        r1 = pinv @ ux
        r2 = pinv @ uy
        n1 = torch.linalg.vector_norm(r1)
        n2 = torch.linalg.vector_norm(r2)
        s = torch.clamp_min(0.5 * (n1 + n2), 1e-8)  # = 1/z0
        z0 = torch.clamp(1.0 / s, 0.1, 1e4)
        a = r1 / torch.clamp_min(n1, 1e-8)
        b = r2 - torch.dot(a, r2) * a
        bn = torch.linalg.vector_norm(b)
        # degenerate (r1 ~ r2): any perpendicular direction
        ex = torch.tensor([1.0, 0.0, 0.0], dtype=self.dtype, device=self.device)
        ey = torch.tensor([0.0, 1.0, 0.0], dtype=self.dtype, device=self.device)
        alt = torch.linalg.cross(a, torch.where(torch.abs(a[0]) < 0.9, ex, ey))
        b = torch.where(
            bn > 1e-6, b / torch.clamp_min(bn, 1e-8), alt / torch.linalg.vector_norm(alt)
        )
        c = torch.linalg.cross(a, b)
        rot = torch.stack([a, b, c], dim=0)  # rows -> R maps body to camera
        t0 = torch.stack(
            [
                (center[0] - self.intrinsics.cx) / self.intrinsics.fx * z0,
                (center[1] - self.intrinsics.cy) / self.intrinsics.fy * z0,
                z0,
            ]
        )
        return SE3(rot.to(self.dtype), t0.to(self.dtype))

    def update(self, carry: SmootherCarry, keypoints_px: torch.Tensor) -> tuple[SmootherCarry, SE3]:
        """Consumes one frame of detected keypoints (K, 2) in pixels; returns
        the new carry and the smoothed newest pose."""
        cfg = self.cfg
        w = carry.window

        # after the shift the new oldest frame (old index 1) anchors the
        # prior at its estimate; until it has measurements keep the prior
        has_estimate = carry.valid[1] > 0.5
        prior_rot = torch.where(has_estimate, w.rot[1], carry.prior_rot)
        prior_trans = torch.where(has_estimate, w.trans[1], carry.prior_trans)
        prior_w = torch.where(has_estimate, w.ang_vel[1], carry.prior_ang_vel)
        prior_v = torch.where(has_estimate, w.vel[1], carry.prior_vel)

        pred_pose, pred_w, pred_v = predict_next(w, cfg.dt, cfg.vel_frame)
        window = WindowState(
            rot=torch.cat([w.rot[1:], pred_pose.rot[None]]),
            trans=torch.cat([w.trans[1:], pred_pose.trans[None]]),
            ang_vel=torch.cat([w.ang_vel[1:], pred_w[None]]),
            vel=torch.cat([w.vel[1:], pred_v[None]]),
        )
        measurements = torch.cat([carry.measurements[1:], keypoints_px[None].to(self.dtype)])

        # Innovation gate: the MEDIAN innovation against both the dynamics
        # prediction and the last smoothed pose; a frame that agrees with
        # either is accepted. A rejected frame keeps its slot with valid=0.
        # A still-disagreeing frame after gate_max_consec rejections resets
        # the window from its closed-form pose.
        accept = torch.ones((), dtype=self.dtype, device=self.device)
        consec = torch.zeros((), dtype=torch.int32, device=self.device)
        do_reset = torch.zeros((), dtype=torch.bool, device=self.device)
        if cfg.gate_px > 0.0:
            kp = keypoints_px.to(self.dtype)
            pts = self.points_body.to(self.dtype)

            def med_innov(pose: SE3) -> torch.Tensor:
                innov = keypoint_projection_residual(pose, self.intrinsics, kp, pts, self.camera_pose)
                return median(torch.linalg.vector_norm(innov, dim=-1))

            med = torch.minimum(med_innov(pred_pose), med_innov(SE3(w.rot[-1], w.trans[-1])))
            warm = carry.frames_seen >= cfg.gate_min_frames
            force = carry.consec_rejects >= cfg.gate_max_consec
            disagree = warm & (med > cfg.gate_px)
            reject = disagree & ~force
            do_reset = disagree & force
            accept = torch.where(reject, 0.0, 1.0).to(self.dtype)
            consec = torch.where(reject, carry.consec_rejects + 1, 0).to(torch.int32)
        valid = torch.cat([carry.valid[1:], accept[None]])

        if cfg.gate_px > 0.0:
            seed = self.coarse_pose_from_keypoints(keypoints_px)
            t = cfg.window
            r = do_reset
            window = WindowState(
                rot=torch.where(r, seed.rot.expand(t, 3, 3), window.rot),
                trans=torch.where(r, seed.trans.expand(t, 3), window.trans),
                ang_vel=torch.where(r, 0.0, window.ang_vel),
                vel=torch.where(r, 0.0, window.vel),
            )
            newest_only = self._zeros(t)
            newest_only[-1] = 1.0
            valid = torch.where(r, newest_only, valid)
            prior_rot = torch.where(r, seed.rot, prior_rot)
            prior_trans = torch.where(r, seed.trans, prior_trans)
            prior_w = torch.where(r, 0.0, prior_w)
            prior_v = torch.where(r, 0.0, prior_v)

        window, _ = lm_solve(
            cfg, window, measurements, valid, self.intrinsics, self.points_body,
            SE3(prior_rot, prior_trans), prior_w, prior_v, self.camera_pose,
        )
        new_carry = SmootherCarry(
            window=window,
            measurements=measurements,
            valid=valid,
            prior_rot=prior_rot,
            prior_trans=prior_trans,
            prior_ang_vel=prior_w,
            prior_vel=prior_v,
            # a reset re-warms the gate
            frames_seen=torch.where(do_reset, 1, carry.frames_seen + 1).to(torch.int32),
            consec_rejects=consec,
        )
        return new_carry, SE3(window.rot[-1], window.trans[-1])
