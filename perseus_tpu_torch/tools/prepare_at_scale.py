"""Dataset preparation for an at-scale run, apart from training: the port of
``scripts/prepare_at_scale.py``.

Prepares the main split and, with ``holdout_job_dir``, the holdout-style
split into ``<data_root>/holdout`` (train_frac 0.05: nearly every frame in
the test split), the layout ``train_at_scale``'s own preparation makes.
Train afterwards with ``train_at_scale --skip-prepare``. Two routes
(``tools/train_at_scale.py``):

  * the HDF5 route, the JAX script's: ``main`` over rendered job
    directories (``h5py``, ``PIL``)::

        python -m perseus_tpu_torch.tools.prepare_at_scale --job-dir outputs/scale_run6/jobs \\
            --data-root outputs/scale_run7/data --holdout-job-dir outputs/scale_run6/holdout_jobs

  * the decoded route, the card's: the videos rendered in memory on the
    card and written as decoded splits, no image file at all::

        python -m perseus_tpu_torch.tools.prepare_at_scale decoded --scale.data-root outputs/scale_run7/data \\
            --videos.n-videos 1600 --holdout-videos.n-videos 40
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from perseus_tpu_torch.data import schema
from perseus_tpu_torch.tools.generate_dataset import GenConfig, render_videos
from perseus_tpu_torch.tools.train_at_scale import (
    DecodedSplitWriter,
    ScaleRunConfig,
    decoded_path,
    holdout_config,
    prepare_dataset,
)

__all__ = ["HoldoutGenConfig", "DecodedPrepareConfig", "prepare", "prepare_rendered", "main"]


@dataclasses.dataclass(frozen=True)
class HoldoutGenConfig(GenConfig):
    """The holdout-style videos: none unless asked for, their own seed."""

    n_videos: int = 0
    style: str = "holdout"
    seed: int = 1


@dataclasses.dataclass(frozen=True)
class DecodedPrepareConfig:
    """The decoded route's command line: the run's config and the videos
    to render for each split (``holdout_videos.n_videos`` 0: no holdout)."""

    scale: ScaleRunConfig = dataclasses.field(default_factory=ScaleRunConfig)
    videos: GenConfig = dataclasses.field(default_factory=GenConfig)
    holdout_videos: HoldoutGenConfig = dataclasses.field(default_factory=HoldoutGenConfig)


def prepare(cfg: ScaleRunConfig) -> tuple[str, str | None]:
    """The HDF5 route: (main split, holdout split or None)."""
    main_split = prepare_dataset(cfg)
    print(f"[prep] main split -> {main_split}", flush=True)
    holdout = None
    if cfg.holdout_job_dir and os.path.isdir(cfg.holdout_job_dir):
        holdout = prepare_dataset(holdout_config(cfg))
        print(f"[prep] holdout split -> {holdout}", flush=True)
    return main_split, holdout


def _prepare_rendered_split(cfg: ScaleRunConfig, gen: GenConfig, device) -> str:
    """One decoded split from ``gen``'s videos, each handed to the writer as
    it is rendered; a failed video raises."""
    if cfg.skip_prepare and schema.is_decoded_split(decoded_path(cfg)):
        return decoded_path(cfg)
    writer = DecodedSplitWriter(cfg)
    summary = render_videos(gen, writer.add, device)
    if summary["failed"]:
        raise RuntimeError(f"videos failed: {summary['failed']}")
    return writer.write()


def prepare_rendered(cfg: DecodedPrepareConfig, device: str | torch.device | None = "cuda") -> tuple[str, str | None]:
    """The decoded route from scratch: ``cfg.videos`` (and
    ``cfg.holdout_videos``) rendered on ``device``, labelled, split,
    pruned and written as decoded splits: (main split, holdout split or
    None)."""
    main_split = _prepare_rendered_split(cfg.scale, cfg.videos, device)
    print(f"[prep] main split -> {main_split}", flush=True)
    holdout = None
    if cfg.holdout_videos.n_videos:
        holdout = _prepare_rendered_split(holdout_config(cfg.scale), cfg.holdout_videos, device)
        print(f"[prep] holdout split -> {holdout}", flush=True)
    return main_split, holdout


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    if sys.argv[1:2] == ["decoded"]:
        cfg = cli(DecodedPrepareConfig, sys.argv[2:])
        prepare_rendered(cfg, cfg.videos.device)
    else:
        prepare(cli(ScaleRunConfig))


if __name__ == "__main__":
    main()
