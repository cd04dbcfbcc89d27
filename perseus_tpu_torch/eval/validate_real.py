"""Real-image qualitative validation: RGB-only eval on a directory of PNGs.

Port of ``perseus_tpu/eval/validate_real.py``. Each image is resized to
``int(1.8 * model_h)`` rows (its width by the same scale, at least as wide
as tall) with an antialiased bilinear resize, which is what
``jax.image.resize(..., "bilinear")`` computes when it shrinks as when it
grows, center-cropped to (model_h, model_w), run through the folded
ResNet-18 (bf16 with ``amp``; its stem maxpool is the CUDA kernel of
``models/pool.py``) at batch 1, and its keypoints denormalized to pixels.

:func:`predict_real` is that computation (no file read or written; neither
``PIL`` nor ``matplotlib`` imported); :func:`validate` loads the PNGs
(skipping ``*segmentation*``), draws a scatter overlay per image and
assembles a GIF.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perseus_tpu_torch import ROOT, resolve_device
from perseus_tpu_torch.camera import center_crop_hw, denormalize_pixel_coordinates
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig
from perseus_tpu_torch.data.schema import load_rgb_png
from perseus_tpu_torch.models import resnet
from perseus_tpu_torch.train import checkpoint as ckpt

__all__ = ["ValConfig", "resize_and_crop", "predict_real", "validate", "main"]


@dataclass(frozen=True)
class ValConfig:
    """Validation configuration (the JAX package's fields and defaults).
    ``model_path``: a port checkpoint directory or a ``.pth``."""

    model_path: str = f"{ROOT}/outputs/models/latest"
    in_channels: int = 3
    dataset_cfg: KeypointDatasetConfig = field(
        default_factory=lambda: KeypointDatasetConfig(dataset_path=f"{ROOT}/data/real_imgs")
    )
    save_every: int = 1
    amp: bool = True
    model_h: int = 256
    model_w: int = 256


def resize_and_crop(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W, C) -> (h, w, C): an image of another size is resized to
    ``int(1.8 * h)`` rows and ``max(round(W * rows / H), rows)`` columns
    (bilinear, half-pixel centres, antialiased as ``jax.image.resize``),
    then center-cropped."""
    if tuple(image.shape[:2]) == (h, w):
        return image
    rows = int(1.8 * h)
    cols = max(int(round(image.shape[1] * rows / image.shape[0])), rows)
    x = F.interpolate(image.permute(2, 0, 1)[None], size=(rows, cols), mode="bilinear", align_corners=False,
                      antialias=True)
    return center_crop_hw(x[0].permute(1, 2, 0), h, w)


@torch.no_grad()
def predict_real(
    folded: dict[str, torch.Tensor],
    images: Sequence[np.ndarray | torch.Tensor],
    cfg: ValConfig,
    device: str | torch.device | None = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Runs each (H, W, 3) image in [0, 1] (any size) through
    :func:`resize_and_crop` and the folded forward (``resnet.fold_batchnorm``'s
    dict), one image per call. Returns (crops (N, model_h, model_w, 3) f32,
    keypoints (N, K, 2) in the crop's pixels), on ``device``."""
    dev = resolve_device(device)
    folded = {k: v.to(dev) for k, v in folded.items()}
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
    h, w = cfg.model_h, cfg.model_w
    crops, keypoints = [], []
    for image in images:
        crop = resize_and_crop(torch.as_tensor(image, dtype=torch.float32).to(dev), h, w)
        pred = resnet.keypoint_cnn_apply_folded(
            folded, crop.permute(2, 0, 1)[None].contiguous(), compute_dtype=compute_dtype
        )
        crops.append(crop)
        keypoints.append(denormalize_pixel_coordinates(pred.reshape(-1, 2), h, w))
    return torch.stack(crops), torch.stack(keypoints)


def validate(cfg: ValConfig, device: str | torch.device | None = "cuda") -> list[str]:
    """Writes ``outputs/figures/<checkpoint name>/val_<i>.png`` for every
    ``save_every``-th PNG of ``cfg.dataset_cfg.dataset_path`` and
    ``real/val.gif`` of them; returns the overlay paths."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    dev = resolve_device(device)
    ckpt_name = os.path.basename(str(cfg.model_path)).split(".")[0]
    out_dir = Path(f"{ROOT}/outputs/figures/{ckpt_name}")
    (out_dir / "real").mkdir(parents=True, exist_ok=True)

    sd = ckpt.load_model(cfg.model_path)
    folded = resnet.fold_batchnorm({k: v.to(dev, torch.float32) for k, v in sd.items()})
    n_keypoints = folded["fc.bias"].shape[0] // 2

    image_files = sorted(Path(cfg.dataset_cfg.dataset_path).glob("*.png"))
    image_files = [f for f in image_files if "segmentation" not in str(f)]

    written = []
    for ii, image_file in enumerate(image_files):
        if ii % cfg.save_every != 0:
            continue
        crops, keypoints = predict_real(folded, [load_rgb_png(str(image_file))], cfg, dev)
        image, pred_px = crops[0].cpu().numpy(), keypoints[0].cpu().numpy()

        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(np.clip(image, 0, 1))
        jet = plt.cm.jet(np.linspace(0, 1, n_keypoints))
        for jj in range(n_keypoints):
            ax.scatter(pred_px[jj, 0], pred_px[jj, 1], c=[jet[jj]], alpha=0.8)
        ax.set_title(f"Image {ii} / {len(image_files)}")
        path = str(out_dir / f"val_{ii}.png")
        fig.savefig(path)
        plt.close(fig)
        written.append(path)

    if written:
        import imageio.v3 as imageio

        frames = [imageio.imread(p) for p in written]
        min_h = min(f.shape[0] for f in frames)
        min_w = min(f.shape[1] for f in frames)
        stacked = np.stack([f[:min_h, :min_w] for f in frames])
        imageio.imwrite(str(out_dir / "real" / "val.gif"), stacked, loop=0, fps=5)
    return written


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    validate(cli(ValConfig))


if __name__ == "__main__":
    main()
