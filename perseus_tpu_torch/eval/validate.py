"""Sim validation: loss statistics, keypoint pixel RMSE, loss histogram and
GT-vs-prediction overlay figures.

Port of ``perseus_tpu/eval/validate.py``. The val split goes through the
deterministic val-mode augmentation (the depth near/far clamp: no kernel of
``augment/``), the folded-BN ResNet-18 (``keypoint_cnn_apply_folded``, whose
stem maxpool is the CUDA kernel of ``models/pool.py``) in batches of
``batch_size``, then per-example SmoothL1 and the pixel RMSE.

:func:`validate_stats` is the computation (no file written; ``matplotlib``
not imported); :func:`validate` prints its statistics and draws the semilog
loss histogram and the overlays on the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perseus_tpu_torch import ROOT, resolve_device
from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
from perseus_tpu_torch.camera import denormalize_pixel_coordinates
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrefetchingLoader, PrunedKeypointDataset
from perseus_tpu_torch.models import resnet
from perseus_tpu_torch.train import checkpoint as ckpt

__all__ = ["ValConfig", "validate_stats", "validate", "main"]


@dataclass(frozen=True)
class ValConfig:
    """Validation configuration (the JAX package's fields and defaults).
    ``model_path``: a port checkpoint directory or a ``.pth``."""

    model_path: str = f"{ROOT}/outputs/models/latest"
    batch_size: int = 256 * 4
    dataset_config: KeypointDatasetConfig = field(default_factory=KeypointDatasetConfig)
    depth: bool = True
    augmentation_config: AugmentationConfig = field(default_factory=AugmentationConfig)
    use_train: bool = False
    # compute dtype for inference: bf16, or f32 for strict parity checks
    amp: bool = True
    # cap on overlay figures (0 = none, -1 = all)
    max_plots: int = 64


def _per_example_smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, 2K) -> (B,) mean SmoothL1 per example."""
    diff = torch.abs(pred - target)
    loss = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    return torch.mean(loss, dim=-1)


def validate_stats(
    cfg: ValConfig,
    device: str | torch.device | None = "cuda",
    state_dict: dict[str, torch.Tensor] | None = None,
) -> dict:
    """Runs the val split through the model on ``device``. ``state_dict``
    (the port's layout) defaults to the one at ``cfg.model_path``.

    Returns {losses (N,), rmse_px, stats {mean, std, min, max, median},
    plots: [(image (H, W, C), gt_px (K, 2), pred_px (K, 2))] for the first
    ``max_plots`` rows (all with -1), n_keypoints}, numpy on the host."""
    dev = resolve_device(device)
    if state_dict is None:
        state_dict = ckpt.load_model(cfg.model_path)
    folded = resnet.fold_batchnorm({k: v.to(dev, torch.float32) for k, v in state_dict.items()})
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32

    dataset = PrunedKeypointDataset(cfg.dataset_config, train=cfg.use_train)
    loader = PrefetchingLoader(dataset, cfg.batch_size, shuffle=False, drop_last=False)
    val_augment = KeypointAugmentation(cfg.augmentation_config, train=False)
    h, w = dataset.H, dataset.W
    n_channels = 4 if cfg.depth else 3

    all_losses, plots = [], []
    sq_px_err, n_px = 0.0, 0
    for batch in loader.epoch(0):
        images = batch["image"]
        if cfg.depth:
            images = np.concatenate([images, batch["depth_image"][..., None]], axis=-1)
        x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(images, -1, 1), np.float32)).to(dev)
        coords = torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32)).to(dev)
        with torch.no_grad():
            x, target = val_augment(None, x, coords)
            x = x[:, :n_channels]
            pred = resnet.keypoint_cnn_apply_folded(folded, x, compute_dtype=compute_dtype)
            target = target.reshape(target.shape[0], -1)
            losses = _per_example_smooth_l1(pred, target)
            pred_px = denormalize_pixel_coordinates(pred.reshape(pred.shape[0], -1, 2), h, w)
            gt_px = denormalize_pixel_coordinates(target.reshape(target.shape[0], -1, 2), h, w)
        losses, pred_px, gt_px = (t.cpu().numpy() for t in (losses, pred_px, gt_px))
        all_losses.append(losses)
        sq_px_err += float(np.sum((pred_px - gt_px) ** 2))
        n_px += pred_px.size
        n_plot = len(losses) if cfg.max_plots < 0 else min(len(losses), cfg.max_plots - len(plots))
        if n_plot > 0:
            shown = x[:n_plot].permute(0, 2, 3, 1).cpu().numpy()
            plots += [(shown[j], gt_px[j], pred_px[j]) for j in range(n_plot)]

    losses = np.concatenate(all_losses)
    stats = {
        "mean": float(losses.mean()),
        "std": float(losses.std()),
        "min": float(losses.min()),
        "max": float(losses.max()),
        "median": float(np.median(losses)),
    }
    return {
        "losses": losses,
        "rmse_px": float(np.sqrt(sq_px_err / n_px)),
        "stats": stats,
        "plots": plots,
        "n_keypoints": dataset.num_keypoints,
    }


def plot_and_save(args: tuple) -> None:
    """Renders one overlay figure: RGB (and depth) panes, GT stars and
    predicted dots joined by lines, a jet colour per keypoint."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    image, gt_px, pred_px, index, output_dir, depth, n_keypoints = args
    fig, axs = plt.subplots(1, 2 if depth else 1, figsize=(4, 8))
    axs = np.atleast_1d(axs)
    axs[0].imshow(np.clip(image[..., :3], 0, 1))
    if depth:
        axs[1].imshow(image[..., 3], cmap="gray")
    jet = plt.cm.jet(np.linspace(0, 1, n_keypoints))
    for ax in axs:
        for k in range(n_keypoints):
            ax.scatter(gt_px[k, 0], gt_px[k, 1], color=jet[k], alpha=0.8, marker="*")
            ax.scatter(pred_px[k, 0], pred_px[k, 1], color=jet[k], alpha=0.8)
            ax.plot([gt_px[k, 0], pred_px[k, 0]], [gt_px[k, 1], pred_px[k, 1]], c="k", alpha=0.9)
        ax.axis("off")
    plt.tight_layout()
    fig.savefig(Path(output_dir) / f"val_{index}.png", bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def plot_histogram(losses: np.ndarray, path: str) -> None:
    """The semilog histogram of the per-example losses."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.hist(losses, bins=100)
    plt.yscale("log")
    plt.savefig(path)
    plt.close()


def validate(cfg: ValConfig, device: str | torch.device | None = "cuda") -> dict:
    """:func:`validate_stats`, printed, with the histogram and overlays
    under ``outputs/figures/<checkpoint name>/sim``. Returns {losses,
    rmse_px, stats, output_dir}."""
    ckpt_name = os.path.basename(str(cfg.model_path)).split(".")[0]
    output_dir = Path(f"{ROOT}/outputs/figures/{ckpt_name}/sim")
    output_dir.mkdir(parents=True, exist_ok=True)
    result = validate_stats(cfg, device)
    stats, rmse_px = result["stats"], result["rmse_px"]

    print("=" * 80)
    print("Validation Loss")
    print(f"Mean +/- Stdev: {stats['mean']} +/- {stats['std']}")
    print(f"Min: {stats['min']}")
    print(f"Max: {stats['max']}")
    print(f"Median: {stats['median']}")
    print(f"Keypoint pixel RMSE: {rmse_px:.3f}")
    print("=" * 80)

    plot_histogram(result["losses"], str(output_dir / "loss_histogram.png"))
    for index, (image, gt_px, pred_px) in enumerate(result["plots"]):
        plot_and_save((image, gt_px, pred_px, index, output_dir, cfg.depth, result["n_keypoints"]))
    return {"losses": result["losses"], "rmse_px": rmse_px, "stats": stats, "output_dir": str(output_dir)}


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    validate(cli(ValConfig))


if __name__ == "__main__":
    main()
