"""The train-time augmentation pipeline: its configuration and the callable.

Port of ``perseus_tpu/augment/pipeline.py``: the same ``AugmentationConfig``
(fields and defaults) and the same ``KeypointAugmentation`` branch logic,
stage order and output contract. Train mode always takes the fused
branches (:mod:`perseus_tpu_torch.augment.fused`): the CUDA kernels on the
card, their plain versions on the CPU.

  * "ultra": transplant + affine + chain in one kernel, for 5-channel
    square images with transplantation and the affine on (the default);
  * "warp": affine + chain in one kernel, for other square images with the
    affine on (the transplant, if on, runs before it as plain tensor code);
  * "chain": the chain kernel alone, after the gather warp of non-square
    images when the affine is on.

Val mode applies only the deterministic near/far depth clamp. Both modes
normalize the keypoints to [-1, 1] and return them in the caller's leading
shape.

Sampling is split from applying: :meth:`KeypointAugmentation.sample` makes
every random draw from a ``torch.Generator`` (on the generator's device),
:meth:`KeypointAugmentation.apply` is a deterministic function of the draws,
so the tests can apply the draws the JAX pipeline made from its key.

Layout: (B, C, H, W) images; channels 0-2 RGB in [0, 1], 3 metric-scaled
depth, 4 binary cube segmentation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from perseus_tpu_torch.augment import fused, ops
from perseus_tpu_torch.camera import normalize_pixel_coordinates

__all__ = ["AugmentationConfig", "KeypointAugmentation"]

NUM_RGB_CHANNELS = 3
DEPTH_CHANNEL_INDEX = 3


@dataclass(frozen=True)
class AugmentationConfig:
    """Configuration for data augmentation (the JAX package's surface)."""

    cube_scale: float = 0.035

    # global augmentations
    random_transplantation_with_depth: bool = True

    random_affine: bool = True
    degrees: float = 90
    translate: Tuple[float, float] = (0.1, 0.1)
    scale: Tuple[float, float] = (0.9, 1.5)
    shear: float = 0.1

    random_erasing: bool = True

    # RGB only
    planckian_jitter: bool = True

    color_jiggle: bool = True
    brightness: float = 0.2
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.025

    blur: bool = True

    random_plasma_shadow: bool = True

    # depth only
    random_bias: bool = True
    dev_bias: float = 0.02
    p_bias: float = 0.5

    depth_gaussian_noise: bool = True
    std_gaussian_noise: float = 0.005

    random_near_plane: bool = True
    scaled_near_plane_mean: float = 0.1
    dev_near_plane: float = 0.05
    p_near_plane: float = 0.5
    near_value: float = 0.0

    random_far_plane: bool = True
    scaled_far_plane_mean: float = 0.5
    dev_far_plane: float = 0.05
    p_far_plane: float = 0.5
    far_value: float = 0.0


class KeypointAugmentation:
    """Augmentation callable::

        aug = KeypointAugmentation(cfg, train=True)
        images, coords = aug(gen, images_bchw, pixel_coordinates)

    ``images_bchw``: (B, C, H, W) with C in {3, 4, 5}, f32 or bf16;
    ``pixel_coordinates``: (B, K, 2) or (B, 2K). Returns the augmented
    images (train mode: in the input's storage dtype) and the coordinates
    normalized to [-1, 1] in the input's leading shape.
    """

    def __init__(self, cfg: AugmentationConfig, train: bool = True) -> None:
        self.cfg = cfg
        self.train = train

    def _use_ultra(self, c: int, h: int, w: int) -> bool:
        cfg = self.cfg
        return cfg.random_transplantation_with_depth and c == 5 and cfg.random_affine and h == w

    def sample(self, gen: torch.Generator, b: int, h: int, w: int, c: int) -> dict:
        """Every random draw of one call, on ``gen``'s device: ``donor_idx``
        (transplantation), ``affine`` (``ops.sample_affine_params``),
        ``fused`` (``fused.sample_fused_params``). Empty in val mode."""
        if not self.train:
            return {}
        cfg = self.cfg
        draws = {}
        if cfg.random_transplantation_with_depth and c == 5:
            draws["donor_idx"] = ops.sample_donor_indices(gen, b)
        if cfg.random_affine:
            draws["affine"] = ops.sample_affine_params(
                gen, b, h, w, degrees=cfg.degrees, translate=cfg.translate, scale=cfg.scale, shear=cfg.shear
            )
        draws["fused"] = fused.sample_fused_params(gen, cfg, b, h, w, c)
        return draws

    def apply(self, images: torch.Tensor, pixel_coordinates: torch.Tensor, draws: dict):
        """The augmentation as a deterministic function of ``draws``
        (:meth:`sample`'s dict, or the same draws from the JAX pipeline)."""
        cfg = self.cfg
        squeeze = images.dim() == 3
        if squeeze:
            images = images[None]
            pixel_coordinates = pixel_coordinates[None]
        b, c, h, w = images.shape
        leading = pixel_coordinates.shape[:-1]
        coords = pixel_coordinates.reshape(b, -1, 2)
        dev = images.device

        if self.train:
            use_ultra = self._use_ultra(c, h, w)
            donor_idx = draws["donor_idx"].to(dev) if "donor_idx" in draws else None
            if cfg.random_transplantation_with_depth and c == 5 and not use_ultra:
                images = ops.transplant_with_depth(images, donor_idx)
            mats = None
            if cfg.random_affine:
                affine = {k: v.to(dev) for k, v in draws["affine"].items()}
                mats = ops.affine_matrices(affine, h, w)
            params = draws["fused"]
            if use_ultra:
                swap, parts = ops._two_pass_params(ops._invert_affine(mats))
                images = fused.fused_ultra_apply(
                    images.contiguous(), donor_idx, swap, torch.stack(parts, dim=-1), params
                )
                coords = ops.transform_keypoints(coords, mats)
            elif mats is not None and h == w:
                images_sw, parts = ops._two_pass_setup(images, ops._invert_affine(mats))
                images = fused.fused_warp_apply(images_sw.contiguous(), torch.stack(parts, dim=-1), params)
                coords = ops.transform_keypoints(coords, mats)
            else:
                if mats is not None:
                    images = ops.warp_affine_bilinear(images, mats)
                    coords = ops.transform_keypoints(coords, mats)
                images = fused.fused_apply(images.contiguous(), params)
        elif (cfg.random_near_plane or cfg.random_far_plane) and c > NUM_RGB_CHANNELS:
            # val mode: the deterministic near/far clamp, in f32, one cast back
            depth = ops.depth_plane_clamp(
                images[:, DEPTH_CHANNEL_INDEX].float(),
                near_mean=cfg.scaled_near_plane_mean,
                near_value=cfg.near_value,
                far_mean=cfg.scaled_far_plane_mean,
                far_value=cfg.far_value,
                cube_scale=cfg.cube_scale,
            )
            images = images.clone()
            images[:, DEPTH_CHANNEL_INDEX] = depth.to(images.dtype)

        coords = normalize_pixel_coordinates(coords, h, w)
        return images, coords.reshape(*leading, -1)

    def __call__(self, gen: torch.Generator | None, images: torch.Tensor, pixel_coordinates: torch.Tensor):
        b, c, h, w = images.shape if images.dim() == 4 else (1, *images.shape)
        draws = self.sample(gen, b, h, w, c) if self.train else {}
        return self.apply(images, pixel_coordinates, draws)
