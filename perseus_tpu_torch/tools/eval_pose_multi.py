"""The closed-loop pose evaluation pooled over many rendered trajectories:
the port of ``scripts/eval_pose_multi.py``.

One 24-frame video scores a dozen frames, where two bad frames make the
RMSE a coin flip; this runs the same evaluation
(``eval/pose_eval.py``: detector + fixed-lag smoother against the
simulation's ground truth) over every job and pools the per-frame errors:
RMSE, median and p90 of rotation (deg) and translation (mm), the frame and
video counts, and a ``per_job`` record each. :func:`pool_pose_results` is
the pooling, :func:`score_jobs` the compute half over trajectories in
memory (``score_pose_tracking``), :func:`eval_pose_multi` the script over
job directories (``PIL``). ``--update-metrics`` adds the ``pose_multi_*``
keys to an existing ``metrics.json`` and never overwrites the single-video
``pose_rmse_*`` keys.

    python -m perseus_tpu_torch.tools.eval_pose_multi --job-root outputs/scale_run5/pose_multi_jobs \\
        --model-path outputs/models/scale_run5/final --output outputs/models/scale_run5/pose_multi.json
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.eval import pose_eval

__all__ = ["MultiPoseConfig", "pool_pose_results", "score_jobs", "eval_pose_multi", "main"]


@dataclasses.dataclass(frozen=True)
class MultiPoseConfig:
    job_root: str = "outputs/scale_run5/pose_multi_jobs"
    model_path: str = "outputs/models/scale_run5/final"
    window: int = 12
    amp: bool = True
    output: str = ""
    update_metrics: str = ""
    device: str = "cuda"  # cuda | cpu


def pool_pose_results(results: list[tuple[str, dict]]) -> dict:
    """Pools (job name, ``score_pose_tracking`` result) pairs: the JAX
    script's record."""
    rot_all, trans_all, per_job = [], [], []
    for job, r in results:
        rot_all.extend(r["per_frame_rot_deg"])
        trans_all.extend(r["per_frame_trans_mm"])
        per_job.append({
            "job": job,
            "pose_rmse_deg": round(r["pose_rmse_deg"], 3),
            "pose_rmse_mm": round(r["pose_rmse_mm"], 3),
            "n_scored": r["n_scored"],
        })
        print(f"[pose-multi] {job}: {per_job[-1]}", file=sys.stderr, flush=True)
    rot = np.asarray(rot_all)
    trans = np.asarray(trans_all)
    return {
        "pose_multi_rmse_deg": float(np.sqrt(np.mean(rot**2))),
        "pose_multi_rmse_mm": float(np.sqrt(np.mean(trans**2))),
        "pose_multi_median_deg": float(np.median(rot)),
        "pose_multi_median_mm": float(np.median(trans)),
        "pose_multi_p90_deg": float(np.percentile(rot, 90)),
        "pose_multi_p90_mm": float(np.percentile(trans, 90)),
        "pose_multi_n_frames": int(rot.size),
        "pose_multi_n_videos": len(results),
        "per_job": per_job,
    }


def score_jobs(jobs, state_dict: dict, window: int = 12, amp: bool = True,
               device: str | torch.device | None = "cuda") -> dict:
    """The compute half: ``jobs`` yields (name, frames (T, H, W, 4),
    metadata) in memory, each scored by ``score_pose_tracking`` with the
    model of ``state_dict`` on ``device``; returns the pooled record."""
    dev = resolve_device(device)
    return pool_pose_results([
        (name, pose_eval.score_pose_tracking(frames, meta, state_dict=state_dict, window=window, amp=amp, device=dev))
        for name, frames, meta in jobs
    ])


def eval_pose_multi(cfg: MultiPoseConfig, device: str | torch.device | None = "cuda") -> dict:
    """Every job directory under ``cfg.job_root`` with a ``metadata.json``
    (sorted), scored with ``cfg.model_path``; writes ``cfg.output`` and
    updates ``cfg.update_metrics`` when given; returns the record."""
    dev = resolve_device(device)
    jobs = sorted(
        os.path.join(cfg.job_root, d)
        for d in os.listdir(cfg.job_root)
        if os.path.exists(os.path.join(cfg.job_root, d, "metadata.json"))
    )
    if not jobs:
        raise SystemExit(f"no jobs with metadata.json under {cfg.job_root}")
    out = pool_pose_results([
        (os.path.basename(job),
         pose_eval.evaluate_pose_tracking(job, model_path=cfg.model_path, window=cfg.window, amp=cfg.amp, device=dev))
        for job in jobs
    ])
    print(json.dumps(out), flush=True)
    if cfg.output:
        os.makedirs(os.path.dirname(cfg.output) or ".", exist_ok=True)
        with open(cfg.output, "w") as f:
            json.dump(out, f, indent=2)
    if cfg.update_metrics:
        with open(cfg.update_metrics) as f:
            metrics = json.load(f)
        metrics.update({k: v for k, v in out.items() if k != "per_job"})
        with open(cfg.update_metrics, "w") as f:
            json.dump(metrics, f, indent=2)
    return out


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    cfg = cli(MultiPoseConfig)
    eval_pose_multi(cfg, cfg.device)


if __name__ == "__main__":
    main()
