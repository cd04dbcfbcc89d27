"""Cross-domain transfer probe, clean renders against a sensor domain the
model never trained on: the port of ``scripts/eval_sensor_transfer.py``.

A checkpoint is scored twice on the same frames: as rendered, and through
the camera / sensor model of ``datagen/generate.py::_apply_camera_effects``
(white balance, film gamma, exposure, vignette, shot noise; off in the
training corpus), one draw per row from ``default_rng(seed)`` in the
loader's order. The model is the folded-BN ResNet-18 (bf16 with ``amp``),
whose stem maxpool is the CUDA kernel of ``models/pool.py``; both errors
are RMSEs over the pixel coordinates after the val-mode augmentation. The
labels are unchanged (the effects are photometric), so the delta is pure
domain shift. :func:`sensor_transfer` is the compute half (a dataset of
either layout in, the record out); :func:`main` prints the record as one
JSON line and writes it to ``output`` when given.

    python -m perseus_tpu_torch.tools.eval_sensor_transfer --checkpoint outputs/models/scale_run/final \\
        --dataset-path outputs/scale_run3/data_full/holdout/decoded
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
from perseus_tpu_torch.camera import denormalize_pixel_coordinates
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrefetchingLoader, PrunedKeypointDataset
from perseus_tpu_torch.datagen.generate import _apply_camera_effects
from perseus_tpu_torch.models import resnet
from perseus_tpu_torch.train import checkpoint as ckpt

__all__ = ["SensorTransferConfig", "sensor_images", "sensor_transfer", "main"]


@dataclasses.dataclass(frozen=True)
class SensorTransferConfig:
    checkpoint: str = "outputs/models/scale_run/final"
    dataset_path: str = "outputs/scale_run3/data_full/holdout/pruned/pruned.hdf5"
    batch_size: int = 256
    depth: bool = True
    amp: bool = True
    use_train: bool = False
    seed: int = 0
    output: str = ""  # optional path for the JSON record


def sensor_images(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(B, H, W, 3) renders in [0, 1] through the camera model, one draw per
    row from ``rng`` (datagen draws per video; per row is the same
    distribution, denser)."""
    return np.stack([_apply_camera_effects(im[None], rng)[0] for im in images.astype(np.float32)])


@torch.no_grad()
def sensor_transfer(cfg: SensorTransferConfig, device: str | torch.device | None = "cuda",
                    state_dict: dict | None = None) -> dict:
    """Scores the model of ``state_dict`` (else of ``cfg.checkpoint``) on
    ``cfg.dataset_path``'s split clean and through the sensor model:
    {clean_rmse_px, sensor_rmse_px, n_frames, dataset, checkpoint,
    delta_px}."""
    dev = resolve_device(device)
    sd = state_dict if state_dict is not None else ckpt.load_model(cfg.checkpoint)
    folded = resnet.fold_batchnorm({k: v.to(dev, torch.float32) for k, v in sd.items()})
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
    dataset = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=cfg.dataset_path), train=cfg.use_train)
    loader = PrefetchingLoader(dataset, cfg.batch_size, shuffle=False, drop_last=False)
    val_augment = KeypointAugmentation(AugmentationConfig(), train=False)
    h, w = dataset.H, dataset.W
    channels = 4 if cfg.depth else 3

    def sq_err(images_nhwc: np.ndarray, coords: torch.Tensor) -> torch.Tensor:
        images = torch.from_numpy(np.ascontiguousarray(np.moveaxis(images_nhwc, -1, 1))).to(dev)
        images, target = val_augment(None, images, coords)
        pred = resnet.keypoint_cnn_apply_folded(folded, images[:, :channels], compute_dtype=compute_dtype)
        pred_px = denormalize_pixel_coordinates(pred.reshape(pred.shape[0], -1, 2), h, w)
        gt_px = denormalize_pixel_coordinates(target.reshape(target.shape[0], -1, 2), h, w)
        return torch.sum((pred_px - gt_px) ** 2)

    sums = {"clean": [], "sensor": []}
    n_px = n_frames = 0
    rng = np.random.default_rng(cfg.seed)
    for batch in loader.epoch(0):
        images = batch["image"]
        coords = torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32)).to(dev)
        fx = sensor_images(images, rng)
        if cfg.depth:
            d = batch["depth_image"][..., None]
            images = np.concatenate([images, d], axis=-1)
            fx = np.concatenate([fx, d.astype(np.float32)], axis=-1)
        for name, imgs in (("clean", images), ("sensor", fx)):
            sums[name].append(sq_err(np.asarray(imgs, np.float32), coords))
        n_px += coords.numel()
        n_frames += len(images)
    sq = {k: float(np.sum(torch.stack(v).double().cpu().numpy())) for k, v in sums.items()}
    record = {
        "clean_rmse_px": float(np.sqrt(sq["clean"] / n_px)),
        "sensor_rmse_px": float(np.sqrt(sq["sensor"] / n_px)),
        "n_frames": n_frames,
        "dataset": cfg.dataset_path,
        "checkpoint": cfg.checkpoint,
    }
    record["delta_px"] = record["sensor_rmse_px"] - record["clean_rmse_px"]
    return record


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    cfg = cli(SensorTransferConfig)
    line = json.dumps(sensor_transfer(cfg))
    print(line, flush=True)
    if cfg.output:
        os.makedirs(os.path.dirname(cfg.output) or ".", exist_ok=True)
        with open(cfg.output, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
