"""Dataset, augmentation and segmentation-ratio visualisations.

Port of ``perseus_tpu/eval/visualize.py``: each tool renders one file with
headless matplotlib, imported inside the function (the card's machine has
none). The augmentation grid's computation is :func:`augment_batch`, which
writes nothing: the batch's 5 channels (RGB, depth, segmentation) through
the augmentation pipeline on the device (train mode with the default
config on the card: the fused "ultra" CUDA kernel, once), its keypoints
denormalized to pixels.
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
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset

__all__ = [
    "VisualizeConfig",
    "augment_batch",
    "visualize_data",
    "visualize_augmentations",
    "visualize_segmentation_ratios",
]


@dataclass(frozen=True)
class VisualizeConfig:
    """The JAX package's fields and defaults."""

    dataset_config: KeypointDatasetConfig = field(default_factory=KeypointDatasetConfig)
    augmentation_config: AugmentationConfig = field(default_factory=AugmentationConfig)
    train: bool = True
    num_images: int = 16
    seed: int = 0
    output_dir: str = f"{ROOT}/outputs/figures/visualize"


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def augment_batch(
    batch: dict,
    cfg: VisualizeConfig,
    device: str | torch.device | None = "cuda",
    draws: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The augmentation grid's computation. ``batch``: a dataset batch
    (``image`` (N, H, W, 3), ``depth_image``, ``segmentation_image``,
    ``pixel_coordinates`` (N, K, 2)). Runs ``KeypointAugmentation(
    cfg.augmentation_config, train=cfg.train)`` on ``device`` with the
    draws of a generator on ``device`` seeded with ``cfg.seed`` (or the
    given ``draws``, :meth:`KeypointAugmentation.sample`'s dict). Returns
    (images (N, H, W, 5) f32, keypoints (N, K, 2) in pixels), on ``device``."""
    dev = resolve_device(device)
    images = np.concatenate(
        [batch["image"], batch["depth_image"][..., None], batch["segmentation_image"][..., None]],
        axis=-1, dtype=np.float32,
    )
    n, h, w, c = images.shape
    x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2).contiguous()
    coords = torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32)).to(dev)
    aug = KeypointAugmentation(cfg.augmentation_config, train=cfg.train)
    if draws is None:
        draws = aug.sample(torch.Generator(device=dev).manual_seed(cfg.seed), n, h, w, c)
    with torch.no_grad():
        out, out_coords = aug.apply(x, coords, draws)
    return out.permute(0, 2, 3, 1), denormalize_pixel_coordinates(out_coords.reshape(n, -1, 2), h, w)


def visualize_data(cfg: VisualizeConfig) -> str:
    """Grid of dataset images with their ground-truth keypoints."""
    plt = _plt()
    ds = PrunedKeypointDataset(cfg.dataset_config, train=cfg.train)
    rng = np.random.default_rng(cfg.seed)
    n = min(cfg.num_images, len(ds))
    idx = rng.choice(len(ds), size=n, replace=False)
    side = int(np.ceil(np.sqrt(n)))
    fig, axs = plt.subplots(side, side, figsize=(3 * side, 3 * side))
    jet = plt.cm.jet(np.linspace(0, 1, ds.num_keypoints))
    for ax, i in zip(np.ravel(axs), idx):
        item = ds[int(i)]
        ax.imshow(item["image"])
        for k, kp in enumerate(item["pixel_coordinates"]):
            ax.scatter(kp[0], kp[1], color=jet[k], s=12)
        ax.axis("off")
    for ax in np.ravel(axs)[n:]:
        ax.axis("off")
    os.makedirs(cfg.output_dir, exist_ok=True)
    out = str(Path(cfg.output_dir) / "data_grid.png")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def visualize_augmentations(cfg: VisualizeConfig, device: str | torch.device | None = "cuda") -> str:
    """Grid of augmented RGB / depth / segmentation panels with the
    transformed keypoints (:func:`augment_batch` on ``device``)."""
    dev = resolve_device(device)
    plt = _plt()
    ds = PrunedKeypointDataset(cfg.dataset_config, train=cfg.train)
    n = min(cfg.num_images, len(ds))
    images, coords = augment_batch(ds.batch(np.arange(n)), cfg, dev)
    out_images, coords_px = images.cpu().numpy(), coords.cpu().numpy()

    side = int(np.ceil(np.sqrt(n)))
    fig, axs = plt.subplots(side, 3 * side, figsize=(9 * side, 3 * side))
    axs = np.asarray(axs).reshape(side, 3 * side)
    for i in range(n):
        r, c = divmod(i, side)
        ax_rgb, ax_d, ax_s = axs[r, 3 * c], axs[r, 3 * c + 1], axs[r, 3 * c + 2]
        ax_rgb.imshow(np.clip(out_images[i, ..., :3], 0, 1))
        ax_rgb.scatter(coords_px[i, :, 0], coords_px[i, :, 1], c="r", s=8)
        ax_d.imshow(out_images[i, ..., 3], cmap="gray")
        ax_s.imshow(out_images[i, ..., 4], cmap="gray")
        for ax in (ax_rgb, ax_d, ax_s):
            ax.axis("off")
    os.makedirs(cfg.output_dir, exist_ok=True)
    out = str(Path(cfg.output_dir) / "augmentations_grid.png")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def visualize_segmentation_ratios(cfg: VisualizeConfig) -> str:
    """Histogram and CDF of the split's segmentation ratios (the file
    returned), and one image per quartile bucket beside it, for tuning the
    prune bounds."""
    plt = _plt()
    ds = PrunedKeypointDataset(cfg.dataset_config, train=cfg.train)
    ratios = np.asarray(ds.split.segmentation_ratios)

    fig, axs = plt.subplots(1, 2, figsize=(10, 4))
    axs[0].hist(ratios, bins=50)
    axs[0].set_title("segmentation ratio histogram")
    sorted_r = np.sort(ratios)
    axs[1].plot(sorted_r, np.linspace(0, 1, len(sorted_r)))
    axs[1].set_title("CDF")
    os.makedirs(cfg.output_dir, exist_ok=True)
    out = str(Path(cfg.output_dir) / "segmentation_ratios.png")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)

    buckets = np.quantile(ratios, [0.0, 0.25, 0.5, 0.75, 1.0])
    fig, axs = plt.subplots(1, 4, figsize=(12, 3))
    for b in range(4):
        in_bucket = np.where((ratios >= buckets[b]) & (ratios <= buckets[b + 1]))[0]
        if len(in_bucket):
            item = ds[int(in_bucket[0])]
            axs[b].imshow(item["image"])
            axs[b].set_title(f"ratio~[{buckets[b]:.3f},{buckets[b+1]:.3f}]")
        axs[b].axis("off")
    fig.savefig(str(Path(cfg.output_dir) / "segmentation_ratio_buckets.png"), bbox_inches="tight")
    plt.close(fig)
    return out
