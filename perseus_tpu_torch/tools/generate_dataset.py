"""Dataset-scale video generation, resumable: the port of
``scripts/generate_dataset.py``.

Job ids are hex, from ``start_index``; a job whose ``metadata.json``
exists is skipped (the resume); a video that fails is printed and
skipped; progress is printed every 50 videos. :func:`render_videos` is the
compute half (each video simulated and rendered in memory, handed to a
callback; no file is written); :func:`generate_dataset` writes the job
directories (``PIL`` for the images).

    python -m perseus_tpu_torch.tools.generate_dataset --job-dir outputs/scale_run/jobs \\
        --n-videos 1600 --style train
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.datagen.generate import VideoConfig, render_video, write_video

__all__ = ["GenConfig", "job_ids", "video_config", "render_videos", "generate_dataset", "main"]


@dataclasses.dataclass(frozen=True)
class GenConfig:
    job_dir: str = "outputs/scale_run/jobs"
    n_videos: int = 1600
    start_index: int = 0  # first job id (hex), for resumable fan-out
    style: str = "train"
    seed: int = 0
    resolution: int = 256
    frames: int = 24
    device: str = "cuda"  # the renderer's device: "cuda" | "cpu"


def job_ids(cfg: GenConfig) -> list[str]:
    """The run's job ids: ``%08x`` of start_index .. start_index + n_videos - 1."""
    return [f"{i:08x}" for i in range(cfg.start_index, cfg.start_index + cfg.n_videos)]


def video_config(cfg: GenConfig) -> VideoConfig:
    return VideoConfig(job_dir=cfg.job_dir, resolution=cfg.resolution, frames=cfg.frames, style=cfg.style,
                       seed=cfg.seed)


def render_videos(
    cfg: GenConfig,
    on_video: Callable[[str, torch.Tensor, torch.Tensor, torch.Tensor, dict], None],
    device: str | torch.device | None = "cuda",
    skip: Callable[[str], bool] = lambda job_id: False,
) -> dict:
    """Renders every job id of ``cfg`` on ``device`` (``render_video``: the
    simulation on the host, textures and frames on the device) and calls
    ``on_video(job_id, rgb, depth, seg, metadata)``; a job for which
    ``skip(job_id)`` holds counts as done and is not rendered. A video that
    fails (in rendering or in ``on_video``) is printed and skipped, as in
    the JAX script. Returns {"done", "failed" (job ids), "wall_s"}."""
    dev = resolve_device(device)
    vcfg = video_config(cfg)
    t0 = time.time()
    done, failed = 0, []
    for job_id in job_ids(cfg):
        if skip(job_id):
            done += 1
            continue
        try:
            on_video(job_id, *render_video(vcfg, job_id, dev))
            done += 1
        except Exception as exc:  # per-video tolerance (the reference's generate_one_video)
            print(f"video {job_id} failed: {exc}", flush=True)
            failed.append(job_id)
        if done % 50 == 0:
            rate = done / max(time.time() - t0, 1e-9)
            print(
                f"[gen] {done}/{cfg.n_videos} ({rate:.2f} vids/s, "
                f"eta {(cfg.n_videos - done) / max(rate, 1e-9) / 60:.0f} min)",
                flush=True,
            )
    wall = time.time() - t0
    print(f"[gen] done: {done} videos in {wall / 60:.1f} min", flush=True)
    return {"done": done, "failed": failed, "wall_s": wall}


def generate_dataset(cfg: GenConfig, device: str | torch.device | None = "cuda") -> dict:
    """Writes the job directories under ``cfg.job_dir`` (``PIL``), skipping
    jobs whose ``metadata.json`` exists; a job directory left by a failed
    write is removed. Returns :func:`render_videos`' summary."""
    device = resolve_device(device)
    os.makedirs(cfg.job_dir, exist_ok=True)

    def write(job_id, rgb, depth, seg, metadata):
        job_path = os.path.join(cfg.job_dir, job_id)
        os.makedirs(job_path, exist_ok=True)
        try:
            write_video(job_path, rgb, depth, seg, metadata)
        except Exception:
            import shutil

            shutil.rmtree(job_path, ignore_errors=True)
            raise

    done = lambda job_id: os.path.exists(os.path.join(cfg.job_dir, job_id, "metadata.json"))  # noqa: E731
    return render_videos(cfg, write, device, skip=done)


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    cfg = cli(GenConfig)
    generate_dataset(cfg, cfg.device)


if __name__ == "__main__":
    main()
