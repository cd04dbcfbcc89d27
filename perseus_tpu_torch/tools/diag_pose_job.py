"""Per-frame diagnosis of a pose-eval trajectory, detector against smoother
blame: the port of ``scripts/diag_pose_job.py``.

For each frame of a rendered trajectory:

  * ``det_px``: the median detector corner error against the GT projection
    (the labeler's float64 projection);
  * ``innov_px``: the median innovation of the detections against the
    smoother's dynamics prediction at that frame (what the gate
    thresholds);
  * ``valid``: whether the smoother took the frame;
  * ``rot_deg`` / ``trans_mm``: the smoothed pose's error against the
    simulation's ground truth.

A high ``det_px`` blames the detector; a low one with a high ``rot_deg``
blames the smoother (gate, cold start, LM basin). :func:`diag_rows` is the
compute half (frames in memory, the rows as arrays); :func:`format_rows`
prints them as the JAX script does.

    python -m perseus_tpu_torch.tools.diag_pose_job --job-dir outputs/scale_run6/pose_multi_jobs/00000007 \\
        --model-path outputs/models/scale_run6/final
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.datagen.labeling import cube_corners, get_pixel_coordinates
from perseus_tpu_torch.eval import pose_eval
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline
from perseus_tpu_torch.smoother.lm import SmootherConfig, predict_next
from perseus_tpu_torch.smoother.residuals import keypoint_projection_residual

__all__ = ["DiagConfig", "COLUMNS", "gt_keypoints", "diag_rows", "format_rows", "main"]

COLUMNS = ("det_px", "innov_px", "valid", "rot_deg", "trans_mm")


@dataclasses.dataclass(frozen=True)
class DiagConfig:
    job_dir: str = "outputs/scale_run6/pose_multi_jobs/00000007"
    model_path: str = "outputs/models/scale_run6/final"
    window: int = 12
    amp: bool = True
    device: str = "cuda"  # cuda | cpu


def _xyzw(q) -> np.ndarray:
    q = np.asarray(q, np.float64)
    return np.concatenate([q[..., 1:], q[..., :1]], axis=-1)


def gt_keypoints(meta: dict) -> np.ndarray:
    """(T, 8, 2) float64 GT corner pixels of a trajectory's metadata."""
    cube, cam = meta["instances"][0], meta["camera"]
    res = int(meta["flags"]["resolution"])
    obj7 = np.concatenate([np.asarray(cube["positions"], np.float64), _xyzw(cube["quaternions"])], axis=-1)
    cam7 = np.concatenate([np.asarray(cam["positions"], np.float64), _xyzw(cam["quaternions"])], axis=-1)
    return get_pixel_coordinates(cube_corners(float(cube["abs_scale"]), dtype=torch.float64),
                                 torch.from_numpy(obj7), torch.from_numpy(cam7), float(cam["field_of_view"]),
                                 res, res).numpy()


@torch.no_grad()
def diag_rows(frames, meta: dict, state_dict: dict | None = None, model_path: str = "", detector_fn=None,
              window: int = 12, amp: bool = True, device: str | torch.device | None = "cuda") -> dict:
    """The per-frame rows of a trajectory ((T, H, W, 4) frames, rgb + depth
    in cube units, and its metadata) through the streaming pipeline on
    ``device``, the model of ``state_dict`` (else ``model_path``) or, with
    ``detector_fn`` (frames -> (T, K, 2) pixel keypoints), those keypoints
    fed to the real smoother. Returns {column: (T,) float64 array} over
    :data:`COLUMNS`, and "abs_scale"."""
    dev = resolve_device(device)
    rot_gt, trans_gt, abs_scale = pose_eval._gt_pose_in_camera(meta)
    kp_gt = gt_keypoints(meta)
    t = len(frames)
    res = int(meta["flags"]["resolution"])
    scfg = StreamingConfig(
        model_path=model_path, num_channels=4, model_h=res, model_w=res, amp=amp, smooth=True,
        smoother=SmootherConfig(window=window, dt=1.0 / float(meta["flags"]["frame_rate"])),
        camera_fov=float(meta["camera"]["field_of_view"]), depth_in_cube_units=True, corner_scale=abs_scale,
    )
    if detector_fn is not None:
        kps = torch.from_numpy(np.array(detector_fn(frames), np.float32)).to(dev)
        pipeline, inputs = pose_eval._stub_detector(scfg, kps), range(t)
    else:
        if state_dict is None:
            from perseus_tpu_torch.train import checkpoint as ckpt

            state_dict = ckpt.load_model(model_path)
        pipeline, inputs = StreamingPipeline(scfg, state_dict, device=dev), frames
    kp0, *_ = pipeline(inputs[0], pipeline.init_carry())
    carry = pipeline.init_carry(pipeline.smoother.coarse_pose_from_keypoints(kp0))
    sm = pipeline.smoother
    unit_to_mm = 0.035 / abs_scale * 1000.0
    rows = {k: np.zeros(t, np.float64) for k in COLUMNS}
    for i in range(t):
        pred_pose, _, _ = predict_next(carry.window, sm.cfg.dt, sm.cfg.vel_frame)
        kp, _, carry, pose = pipeline(inputs[i], carry)
        kp_h = kp.cpu().numpy()
        innov = keypoint_projection_residual(pred_pose, sm.intrinsics, kp, sm.points_body, sm.camera_pose)
        rel = pose.rot.cpu().numpy().T @ rot_gt[i]
        rows["det_px"][i] = np.median(np.linalg.norm(kp_h - kp_gt[i], axis=-1))
        rows["innov_px"][i] = np.median(np.linalg.norm(innov.cpu().numpy(), axis=-1))
        rows["valid"][i] = float(carry.valid[-1])
        rows["rot_deg"][i] = np.degrees(pose_eval.rotation_angle(rel[None]))[0]
        rows["trans_mm"][i] = np.linalg.norm(pose.trans.cpu().numpy() - trans_gt[i]) * unit_to_mm
    rows["abs_scale"] = abs_scale
    return rows


def format_rows(rows: dict) -> list[str]:
    """The JAX script's table: a header, then a line per frame."""
    lines = [f"{'t':>3} {'det_px':>8} {'innov_px':>9} {'valid':>5} {'rot_deg':>8} {'trans_mm':>9}"]
    for i in range(len(rows["det_px"])):
        lines.append(f"{i:>3} {rows['det_px'][i]:8.2f} {rows['innov_px'][i]:9.2f} {rows['valid'][i]:5.0f} "
                     f"{rows['rot_deg'][i]:8.2f} {rows['trans_mm'][i]:9.1f}")
    return lines


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    cfg = cli(DiagConfig)
    frames, meta = pose_eval.load_job_frames(cfg.job_dir)
    rows = diag_rows(frames, meta, model_path=cfg.model_path, window=cfg.window, amp=cfg.amp, device=cfg.device)
    print("\n".join(format_rows(rows)))
    print(json.dumps({"job": cfg.job_dir, "abs_scale": rows["abs_scale"]}))


if __name__ == "__main__":
    main()
