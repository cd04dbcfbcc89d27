"""The pose evaluation's device bisect, CPU against CUDA: the port of
``scripts/pose_backend_check.py``.

A dump on one device holds every intermediate of the pose evaluation: the
per-frame detector keypoints (the ResNet-18 forward), the per-frame
smoothed poses, the metrics, and a second smoother pass fed FIXED
keypoints (a reference dump's, else this run's own), which separates "the
forward differs between devices" from "the smoother's LM differs".
:func:`dump_arrays` is the compute half (frames in memory, the arrays
out); :func:`run_dump` writes them as ``.npz`` with the JAX script's keys
(``backend`` is the device); :func:`run_compare` prints the deltas of two
dumps.

    python -m perseus_tpu_torch.tools.pose_backend_check --device cpu  --out outputs/pose_cpu.npz
    python -m perseus_tpu_torch.tools.pose_backend_check --device cuda --out outputs/pose_cuda.npz \\
        --fixed-keypoints outputs/pose_cpu.npz
    python -m perseus_tpu_torch.tools.pose_backend_check --compare outputs/pose_cpu.npz,outputs/pose_cuda.npz
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from perseus_tpu_torch import ROOT, resolve_device
from perseus_tpu_torch.eval import pose_eval
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline
from perseus_tpu_torch.smoother.lm import SmootherConfig

__all__ = ["CheckConfig", "dump_arrays", "run_dump", "compare_lines", "run_compare", "main"]


@dataclasses.dataclass(frozen=True)
class CheckConfig:
    job_dir: str = "outputs/scale_run4/pose_jobs/00000000"
    model_path: str = "outputs/models/lu4qs7vx"
    window: int = 12
    device: str = "cuda"  # cuda | cpu
    amp: bool = True
    out: str = os.path.join(ROOT, "outputs", "pose_backend.npz")
    # a prior dump whose keypoints are replayed through THIS device's
    # smoother (bisect: detector forward vs smoother LM)
    fixed_keypoints: str = ""
    compare: tuple[str, ...] = ()


@torch.no_grad()
def dump_arrays(cfg: CheckConfig, frames, meta: dict, state_dict: dict | None = None,
                fixed_keypoints: np.ndarray | None = None, device: str | torch.device | None = "cuda") -> dict:
    """The dump of one trajectory ((T, H, W, 4) frames, metadata) on
    ``device``: keypoints (T, K, 2), rot (T, 3, 3), trans (T, 3) of the full
    path; rot_fixedkp, trans_fixedkp of the smoother alone on
    ``fixed_keypoints`` (else this run's keypoints); rot_gt, trans_gt;
    metrics {backend, pose_rmse_deg, pose_rmse_mm} over frames from
    ``cfg.window`` on. The model is ``state_dict`` (else ``cfg.model_path``)."""
    dev = resolve_device(device)
    rot_gt, trans_gt, abs_scale = pose_eval._gt_pose_in_camera(meta)
    t = len(frames)
    res = int(meta["flags"]["resolution"])
    scfg = StreamingConfig(
        model_path=cfg.model_path, num_channels=4, model_h=res, model_w=res, amp=cfg.amp, smooth=True,
        smoother=SmootherConfig(window=cfg.window, dt=1.0 / float(meta["flags"]["frame_rate"])),
        camera_fov=float(meta["camera"]["field_of_view"]), depth_in_cube_units=True, corner_scale=abs_scale,
    )
    pipeline = StreamingPipeline(scfg, state_dict, device=dev)
    kp0, *_ = pipeline(frames[0], pipeline.init_carry())
    carry = pipeline.init_carry(pipeline.smoother.coarse_pose_from_keypoints(kp0))
    kps, rots, trans = [], [], []
    for i in range(t):
        kp, _, carry, pose = pipeline(frames[i], carry)
        kps.append(kp)
        rots.append(pose.rot)
        trans.append(pose.trans)
    kps, rots, trans = (torch.stack(x).cpu().numpy() for x in (kps, rots, trans))

    # the smoother alone on fixed keypoints: the same smoother input on every device
    kps_fixed = kps if fixed_keypoints is None else np.asarray(fixed_keypoints, np.float32)
    stub = pose_eval._stub_detector(scfg, torch.from_numpy(kps_fixed).to(dev))
    carry2 = stub.init_carry(stub.smoother.coarse_pose_from_keypoints(stub.kps[0]))
    rots2, trans2 = [], []
    for i in range(t):
        _, _, carry2, pose2 = stub(i, carry2)
        rots2.append(pose2.rot)
        trans2.append(pose2.trans)

    sl = slice(cfg.window, t)
    rel = np.einsum("tji,tjk->tik", rots[sl], rot_gt[sl])
    rerr = np.degrees(pose_eval.rotation_angle(rel))
    terr = np.linalg.norm(trans[sl] - trans_gt[sl], axis=-1)
    unit_to_mm = 0.035 / abs_scale * 1000.0
    return {
        "keypoints": kps,
        "rot": rots,
        "trans": trans,
        "rot_fixedkp": torch.stack(rots2).cpu().numpy(),
        "trans_fixedkp": torch.stack(trans2).cpu().numpy(),
        "rot_gt": rot_gt,
        "trans_gt": trans_gt,
        "metrics": {
            "backend": dev.type,
            "pose_rmse_deg": float(np.sqrt(np.mean(rerr**2))),
            "pose_rmse_mm": float(np.sqrt(np.mean(terr**2)) * unit_to_mm),
        },
    }


def run_dump(cfg: CheckConfig, device: str | torch.device | None = "cuda") -> dict:
    """:func:`dump_arrays` of ``cfg.job_dir`` (``PIL``), the fixed keypoints
    from ``cfg.fixed_keypoints`` when given, saved to ``cfg.out``; prints
    and returns the metrics."""
    device = resolve_device(device)
    frames, meta = pose_eval.load_job_frames(cfg.job_dir)
    fixed_src = cfg.fixed_keypoints or None
    fixed = np.load(fixed_src)["keypoints"] if fixed_src else None
    d = dump_arrays(cfg, frames, meta, fixed_keypoints=fixed, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(cfg.out)), exist_ok=True)
    np.savez(cfg.out, **{k: v for k, v in d.items() if k != "metrics"}, metrics=json.dumps(d["metrics"]),
             fixed_src=str(fixed_src))
    print(json.dumps(d["metrics"]))
    return d["metrics"]


def compare_lines(a: dict, b: dict) -> list[str]:
    """The JAX script's comparison of two dumps (``.npz`` contents: metrics
    as a JSON string, fixed_src), as lines."""
    ma, mb = json.loads(str(a["metrics"])), json.loads(str(b["metrics"]))
    lines = [f"A ({ma['backend']}): {ma}", f"B ({mb['backend']}): {mb}"]
    kp_delta = np.abs(a["keypoints"] - b["keypoints"])
    lines.append(f"keypoint delta px: max {kp_delta.max():.4f} mean {kp_delta.mean():.5f}")
    rel = np.einsum("tji,tjk->tik", a["rot"], b["rot"])
    lines.append(f"pose rot delta deg (full path): max {np.degrees(pose_eval.rotation_angle(rel)).max():.4f}")
    lines.append(f"pose trans delta units (full path): max {np.abs(a['trans'] - b['trans']).max():.5f}")
    if str(b["fixed_src"]) != "None":
        rel2 = np.einsum("tji,tjk->tik", a["rot_fixedkp"], b["rot_fixedkp"])
        lines.append(f"pose rot delta deg (SAME keypoints): max {np.degrees(pose_eval.rotation_angle(rel2)).max():.4f}")
        lines.append(f"pose trans delta units (SAME keypoints): max "
                     f"{np.abs(a['trans_fixedkp'] - b['trans_fixedkp']).max():.5f}")
    return lines


def run_compare(a_path: str, b_path: str) -> None:
    print("\n".join(compare_lines(np.load(a_path), np.load(b_path))))


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    cfg = cli(CheckConfig)
    if cfg.compare:
        run_compare(*cfg.compare)
        return
    run_dump(cfg, cfg.device)


if __name__ == "__main__":
    main()
