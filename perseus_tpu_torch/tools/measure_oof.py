"""The out-of-frame GT-corner frame rate of a datagen distribution: the port
of ``scripts/measure_oof.py``.

The share of frames with a projected cube corner outside the image, over
``n_videos`` probe videos (job ids ``oof%05x``) at a low resolution (the
share does not depend on it), labelled by ``label_dataset``'s float64
projection; printed as one JSON line. It validates a change of the
collision or spawn model before a full-scale regeneration. The labels
depend on the simulation alone, so :func:`oof_counts`, the compute half,
simulates each video (``generate.simulate_video``) and labels its metadata
in memory, rendering nothing; with ``job_dir`` set, :func:`measure_oof`
also writes the job directories (rendered on the device, ``PIL``) and
labels them from their ``metadata.json``, as the JAX script does.

    python -m perseus_tpu_torch.tools.measure_oof --n-videos 40 --seed 11
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.datagen.generate import VideoConfig, generate_one_video, simulate_video
from perseus_tpu_torch.datagen.label_dataset import LabelConfig, label_job, label_metadata

__all__ = ["OofConfig", "video_config", "out_of_frame", "oof_counts", "measure_oof", "main"]


@dataclasses.dataclass(frozen=True)
class OofConfig:
    n_videos: int = 40
    seed: int = 11
    resolution: int = 64
    style: str = "train"
    object_collisions: bool = True
    job_dir: str = ""  # empty: labelled in memory, no job directory written


def video_config(cfg: OofConfig, job_dir: str = "") -> VideoConfig:
    return VideoConfig(job_dir=job_dir, resolution=cfg.resolution, style=cfg.style, seed=cfg.seed,
                       object_collisions=cfg.object_collisions)


def out_of_frame(px: np.ndarray, resolution: int) -> np.ndarray:
    """(T,) bool: a frame of (T, K, 2) pixel keypoints has a corner outside
    [0, resolution) in u or v."""
    out = (px[..., 0] < 0) | (px[..., 0] >= resolution) | (px[..., 1] < 0) | (px[..., 1] >= resolution)
    return out.any(axis=-1)


def oof_counts(cfg: OofConfig, device: str | torch.device | None = "cuda") -> tuple[int, int]:
    """(out-of-frame frames, frames) over the probe videos, from the
    simulation's metadata in memory (nothing rendered or written)."""
    resolve_device(device)
    vcfg = video_config(cfg)
    oof = total = 0
    for i in range(cfg.n_videos):
        job_id = f"oof{i:05x}"
        rec = label_metadata(LabelConfig(), simulate_video(vcfg, job_id)["metadata"], job_id)
        px = np.asarray(rec["pixel_coordinates"])  # (T, 8, 2)
        oof += int(out_of_frame(px, cfg.resolution).sum())
        total += px.shape[0]
    return oof, total


def measure_oof(cfg: OofConfig, device: str | torch.device | None = "cuda") -> dict:
    """The script's record {oof_frame_rate, frames, videos, collisions,
    style}; with ``cfg.job_dir`` the videos are also written there and
    labelled from their files."""
    dev = resolve_device(device)
    if cfg.job_dir:
        vcfg = video_config(cfg, cfg.job_dir)
        oof = total = 0
        for i in range(cfg.n_videos):
            job_id = f"oof{i:05x}"
            generate_one_video(vcfg, job_id, dev)
            px = np.asarray(label_job(LabelConfig(job_dir=cfg.job_dir, lazy_images=True), job_id)["pixel_coordinates"])
            oof += int(out_of_frame(px, cfg.resolution).sum())
            total += px.shape[0]
    else:
        oof, total = oof_counts(cfg, dev)
    return {
        "oof_frame_rate": oof / max(total, 1),
        "frames": total,
        "videos": cfg.n_videos,
        "collisions": cfg.object_collisions,
        "style": cfg.style,
    }


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    print(json.dumps(measure_oof(cli(OofConfig))))


if __name__ == "__main__":
    main()
