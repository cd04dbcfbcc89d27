"""Closed-loop pose-tracking accuracy: detector + smoother against the
simulation's ground truth.

Port of ``perseus_tpu/eval/pose_eval.py``. The serving path
(``runtime/streaming.py::StreamingPipeline``: preprocess -> detector ->
denormalize -> fixed-lag smoother) runs over a rendered trajectory and its
smoothed SE(3) poses are scored frame by frame against the trajectory's
``metadata.json``: translation RMSE in millimetres (1 scene unit = 0.035 m
/ abs_scale) and rotation RMSE in degrees. Depth is replayed in cube units
and the smoother's corners at the cube's simulated scale.

:func:`score_pose_tracking` scores frames already in memory (e.g.
``datagen/generate.py::render_video``'s); :func:`evaluate_pose_tracking`
loads a job directory (``PIL``) and scores it.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from perseus_tpu_torch import lie, resolve_device
from perseus_tpu_torch.camera import blender_to_opencv_pose, intrinsics_from_fov
from perseus_tpu_torch.data import schema
from perseus_tpu_torch.datagen.labeling import cube_corners
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline
from perseus_tpu_torch.smoother.fixed_lag import FixedLagSmoother
from perseus_tpu_torch.smoother.lm import SmootherConfig
from perseus_tpu_torch.train import checkpoint as ckpt

__all__ = ["evaluate_pose_tracking", "load_job_frames", "rotation_angle", "score_pose_tracking"]


def rotation_angle(rel: np.ndarray) -> np.ndarray:
    """Geodesic angle (radians) of rotation matrices ``rel`` (..., 3, 3), in
    float64: theta = 2 asin(||R - I||_F / (2 sqrt 2)) below 90 deg (stable
    for tiny angles, where arccos((trace - 1) / 2) floors to 0 in f32), the
    arccos form above, where the asin form saturates."""
    rel = np.asarray(rel, np.float64)
    eye = np.eye(3, dtype=np.float64)
    fro = np.linalg.norm(rel - eye, axis=(-2, -1))
    small = 2.0 * np.arcsin(np.clip(fro / (2.0 * np.sqrt(2.0)), 0.0, 1.0))
    cos = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    large = np.arccos(cos)
    return np.where(cos > 0.0, small, large)


def load_job_frames(job_dir: str) -> tuple[np.ndarray, dict]:
    """Loads a rendered job dir: ((T, H, W, 4) rgb+depth float32, metadata)."""
    with open(os.path.join(job_dir, "metadata.json")) as f:
        meta = json.load(f)
    t = int(meta["flags"]["frame_end"])
    frames = []
    for i in range(t):
        rgb = schema.load_rgb_png(os.path.join(job_dir, f"rgba_{i:05d}.png"))
        depth = schema.load_depth_tiff(os.path.join(job_dir, f"depth_{i:05d}.tiff"))
        frames.append(np.concatenate([rgb, depth[..., None]], axis=-1).astype(np.float32))
    return np.stack(frames), meta


def _gt_pose_in_camera(meta: dict) -> tuple[np.ndarray, np.ndarray, float]:
    """Per-frame GT cube pose in the OpenCV camera frame:
    T_co = (blender_to_opencv(T_wc))^-1 . T_wo, in f32. Returns (rot (T, 3,
    3), trans (T, 3), abs_scale)."""
    cube = meta["instances"][0]
    cam = meta["camera"]
    r_wo = lie.quat_wxyz_to_rot(torch.tensor(cube["quaternions"], dtype=torch.float32)).numpy()
    p_wo = np.asarray(cube["positions"], np.float32)
    r_wc_b = lie.quat_wxyz_to_rot(torch.tensor(cam["quaternions"], dtype=torch.float32))
    p_wc = np.asarray(cam["positions"], np.float32)
    r_wc = blender_to_opencv_pose(lie.SE3(r_wc_b, torch.from_numpy(p_wc))).rot.numpy()
    rot_co = np.einsum("tji,tjk->tik", r_wc, r_wo)  # R_wc^T R_wo
    trans_co = np.einsum("tji,tj->ti", r_wc, p_wo - p_wc)
    return rot_co, trans_co, float(cube["abs_scale"])


def score_pose_tracking(
    frames,
    meta: dict,
    state_dict: dict[str, torch.Tensor] | None = None,
    model_path: str = "",
    detector_fn=None,
    warmup: int | None = None,
    window: int = 12,
    in_channels: int = 4,
    amp: bool = True,
    device: str | torch.device | None = "cuda",
) -> dict:
    """Runs the streaming pipeline on ``device`` over a trajectory's frames
    ((T, H, W, 4) rgb + depth in cube units, numpy or a tensor) and scores
    the smoothed poses against ``meta``'s ground truth.

    ``detector_fn`` (optional: frames -> (T, K, 2) pixel keypoints) stands
    in for the detector, feeding its keypoints to the real smoother;
    otherwise the model of ``state_dict`` (or, without one, of
    ``model_path``: a port checkpoint directory or a ``.pth``) runs inside
    the pipeline. Returns {pose_rmse_mm, pose_rmse_deg, pose_median_mm,
    pose_median_deg, trans_rmse_units, n_scored, n_frames, abs_scale,
    window, per_frame_rot_deg, per_frame_trans_mm}."""
    dev = resolve_device(device)
    rot_gt, trans_gt, abs_scale = _gt_pose_in_camera(meta)
    t = len(frames)
    fov = float(meta["camera"]["field_of_view"])
    fps = float(meta["flags"]["frame_rate"])
    if warmup is None:
        warmup = window  # score after the window has filled with real frames

    res = int(meta["flags"]["resolution"])
    cfg = StreamingConfig(
        model_path=model_path,
        num_channels=in_channels,
        model_h=res,
        model_w=res,
        amp=amp,
        smooth=True,
        # cold start: the full accept/reject LM (the tracking-mode GN-4
        # config assumes a warm window)
        smoother=SmootherConfig(window=window, dt=1.0 / fps),
        camera_fov=fov,
        depth_in_cube_units=True,
        corner_scale=abs_scale,
    )
    if detector_fn is not None:
        kps_all = detector_fn(frames)  # (T, K, 2)
        if not isinstance(kps_all, torch.Tensor):
            kps_all = torch.from_numpy(np.array(kps_all, np.float32))
        kps_all = kps_all.to(dev, torch.float32)
        pipeline = _stub_detector(cfg, kps_all)
        kp0 = kps_all[0]
    else:
        if state_dict is None:
            state_dict = ckpt.load_model(model_path)
        pipeline = StreamingPipeline(cfg, state_dict, device=dev)
        kp0, *_ = pipeline(frames[0], pipeline.init_carry())

    # cold start near the truth: a closed-form pose from the first frame's
    # detections (the PnP-init role)
    carry = pipeline.init_carry(pipeline.smoother.coarse_pose_from_keypoints(kp0))
    rots, trans = [], []
    for i in range(t):
        kp, _, carry, pose = pipeline(frames[i] if detector_fn is None else i, carry)
        rots.append(pose.rot)
        trans.append(pose.trans)
    rots = torch.stack(rots).cpu().numpy()
    trans = torch.stack(trans).cpu().numpy()

    sl = slice(warmup, t)
    terr = np.linalg.norm(trans[sl] - trans_gt[sl], axis=-1)  # scene units
    rel = np.einsum("tji,tjk->tik", rots[sl], rot_gt[sl])  # R_est^T R_gt
    rerr_deg = np.degrees(rotation_angle(rel))

    unit_to_mm = 0.035 / abs_scale * 1000.0
    return {
        "pose_rmse_mm": float(np.sqrt(np.mean(terr**2)) * unit_to_mm),
        "pose_rmse_deg": float(np.sqrt(np.mean(rerr_deg**2))),
        "pose_median_mm": float(np.median(terr) * unit_to_mm),
        "pose_median_deg": float(np.median(rerr_deg)),
        "trans_rmse_units": float(np.sqrt(np.mean(terr**2))),
        "n_scored": int(t - warmup),
        "n_frames": int(t),
        "abs_scale": abs_scale,
        "window": window,
        # per-frame errors, so that multi-video callers can pool exact
        # medians / percentiles
        "per_frame_rot_deg": rerr_deg.tolist(),
        "per_frame_trans_mm": (terr * unit_to_mm).tolist(),
    }


def evaluate_pose_tracking(
    job_dir: str,
    state_dict: dict[str, torch.Tensor] | None = None,
    model_path: str = "",
    detector_fn=None,
    warmup: int | None = None,
    window: int = 12,
    in_channels: int = 4,
    amp: bool = True,
    device: str | torch.device | None = "cuda",
) -> dict:
    """:func:`score_pose_tracking` over a rendered job directory
    (:func:`load_job_frames`: PNG RGB, float TIFF depth)."""
    frames, meta = load_job_frames(job_dir)
    return score_pose_tracking(frames, meta, state_dict, model_path, detector_fn, warmup, window, in_channels, amp,
                               device)


class _StubPipeline:
    """Pipeline stand-in that feeds precomputed keypoints to the real
    fixed-lag smoother (for tests without a trained detector), through its
    graphed update (the JAX package's ``jax.jit(smoother.update)``)."""

    def __init__(self, smoother: FixedLagSmoother, kps_all: torch.Tensor):
        self.smoother = smoother
        self.kps = kps_all

    def init_carry(self, initial_pose=None):
        return self.smoother.init(initial_pose)

    def __call__(self, frame_index, carry):
        kp = self.kps[int(frame_index)]
        carry, pose = self.smoother.graphed_update(carry, kp)
        return kp, None, carry, pose


def _stub_detector(cfg: StreamingConfig, kps_all: torch.Tensor) -> _StubPipeline:
    dev = kps_all.device
    intr = intrinsics_from_fov(torch.tensor(cfg.camera_fov, device=dev), cfg.model_h, cfg.model_w)
    corners = cube_corners(cfg.corner_scale or cfg.cube_scale, device=dev)
    return _StubPipeline(FixedLagSmoother(cfg.smoother, intr, corners), kps_all)


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    @dataclasses.dataclass(frozen=True)
    class PoseEvalConfig:
        job_dir: str = "outputs/scale_run/pose_eval_job"
        model_path: str = "outputs/models/scale_run/final"
        window: int = 12
        metrics_out: str = ""  # merge results into this metrics.json

    cfg = cli(PoseEvalConfig)
    result = evaluate_pose_tracking(cfg.job_dir, model_path=cfg.model_path, window=cfg.window)
    print(json.dumps(result, indent=2))
    if cfg.metrics_out:
        merged = {}
        if os.path.exists(cfg.metrics_out):
            with open(cfg.metrics_out) as f:
                merged = json.load(f)
        merged.update({k: result[k] for k in ("pose_rmse_mm", "pose_rmse_deg")})
        with open(cfg.metrics_out, "w") as f:
            json.dump(merged, f, indent=2)


if __name__ == "__main__":
    main()
