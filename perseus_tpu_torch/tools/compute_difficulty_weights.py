"""Per-row difficulty weights from a checkpoint, for hard-example sampling:
the port of ``scripts/compute_difficulty_weights.py``.

Every TRAIN row is scored with a keypoint checkpoint in val mode (the
depth near/far clamp that evaluation uses), in bf16 convs: its RMSE over
the corners in normalized units. The weights

    w_i = clip(1 + gain * err_i / mean(err), 1, w_max)

go to a ``.npy`` that ``TrainConfig.sample_weights_path`` reads
(``train.make_sample_weights``): each epoch then draws rows with
replacement in proportion to w. :func:`difficulty_errors` is the compute
half; :func:`compute_difficulty_weights` writes the file and returns the
script's JSON stats line.

    python -m perseus_tpu_torch.tools.compute_difficulty_weights \\
        --dataset-path outputs/scale_run3/data_full/decoded --checkpoint outputs/models/abl_tail/final
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.models import resnet
from perseus_tpu_torch.train import checkpoint as ckpt
from perseus_tpu_torch.train import train as tm
from perseus_tpu_torch.train.config import TrainConfig

__all__ = ["DifficultyConfig", "difficulty_errors", "difficulty_weights", "compute_difficulty_weights", "main"]


@dataclasses.dataclass(frozen=True)
class DifficultyConfig:
    dataset_path: str = "outputs/scale_run3/data_full/pruned/pruned.hdf5"
    checkpoint: str = "outputs/models/scale_run/final"
    output: str = ""  # default: <checkpoint dir>/../difficulty_weights.npy
    batch_size: int = 256
    in_channels: int = 4
    gain: float = 2.0  # weight slope per unit of mean-normalized error
    w_max: float = 8.0  # cap so a few catastrophic rows don't dominate epochs


@torch.no_grad()
def difficulty_errors(cfg: DifficultyConfig, device: str | torch.device | None = "cuda",
                      compute_dtype: torch.dtype = torch.bfloat16) -> np.ndarray:
    """Each train row's keypoint RMSE in normalized units, (N,) float64:
    the val-mode augmentation of the default ``TrainConfig``, the model of
    ``cfg.checkpoint`` in eval mode with convs in ``compute_dtype``; the
    last partial batch is padded with its last row (one batch shape)."""
    dev = resolve_device(device)
    sd = {k: v.to(dev) for k, v in ckpt.load_model(cfg.checkpoint).items()}
    ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=cfg.dataset_path), train=True, cache=False)
    tcfg = TrainConfig(batch_size=cfg.batch_size, in_channels=cfg.in_channels)
    val_aug = KeypointAugmentation(tcfg.augmentation_config, train=False)
    n, b = len(ds), cfg.batch_size
    errs = np.empty(n, np.float64)
    t0 = time.time()
    for s in range(0, n, b):
        rows = np.arange(s, min(s + b, n))
        rows_padded = np.concatenate([rows, np.full(b - len(rows), rows[-1])])
        batch = ds.batch(rows_padded)
        img = torch.from_numpy(tm._prepare_aug_batch(batch, cfg.in_channels, False)).to(dev)
        crd = torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32)).to(dev)
        x, c = val_aug(None, img, crd)
        pred, _ = resnet.keypoint_cnn_apply(sd, x[:, : cfg.in_channels], train=False, compute_dtype=compute_dtype)
        d = pred.reshape(pred.shape[0], -1, 2) - c.reshape(c.shape[0], -1, 2)
        e = torch.sqrt(torch.mean(torch.sum(d * d, dim=-1), dim=-1))
        errs[rows] = e.cpu().numpy()[: len(rows)]
        if s % (20 * b) == 0:
            print(f"[difficulty] {s}/{n} rows ({time.time() - t0:.0f}s)", flush=True)
    return errs


def difficulty_weights(errs: np.ndarray, gain: float, w_max: float) -> np.ndarray:
    """clip(1 + gain * err / mean(err), 1, w_max)."""
    w = 1.0 + gain * errs / max(errs.mean(), 1e-12)
    return np.clip(w, 1.0, w_max)


def compute_difficulty_weights(cfg: DifficultyConfig, device: str | torch.device | None = "cuda") -> dict:
    """Writes the weights (``cfg.output``, else ``difficulty_weights.npy``
    beside the checkpoint directory); returns the stats line (rows,
    err_mean, err_p95, w_mean, w_at_cap_pct, output), also printed."""
    errs = difficulty_errors(cfg, device)
    w = difficulty_weights(errs, cfg.gain, cfg.w_max)
    out = cfg.output or os.path.join(os.path.dirname(cfg.checkpoint.rstrip("/")), "difficulty_weights.npy")
    np.save(out, w)
    stats_line = {
        "rows": len(errs),
        "err_mean": float(errs.mean()),
        "err_p95": float(np.percentile(errs, 95)),
        "w_mean": float(w.mean()),
        "w_at_cap_pct": float(100.0 * np.mean(w >= cfg.w_max)),
        "output": out,
    }
    print(json.dumps(stats_line), flush=True)
    return stats_line


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    compute_difficulty_weights(cli(DifficultyConfig))


if __name__ == "__main__":
    main()
