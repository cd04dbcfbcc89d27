"""The train-time augmentation pipeline: its configuration and the callable.

Port of ``perseus_tpu/augment/pipeline.py``: the same ``AugmentationConfig``
(fields and defaults) and the same ``KeypointAugmentation`` branch logic,
stage order and output contract. Train mode takes the fused branches
(:mod:`perseus_tpu_torch.augment.fused`: the CUDA kernels on the card,
their plain versions on the CPU) unless built with ``fused=False``:

  * "ultra": transplant + affine + chain in one kernel, for 5-channel
    square images with transplantation and the affine on (the default);
  * "warp": affine + chain in one kernel, for other square images with the
    affine on (the transplant, if on, runs before it as plain tensor code);
  * "chain": the chain kernel alone, after the gather warp of non-square
    images when the affine is on;
  * unfused (``fused=False``): the JAX pipeline's op chain, one
    ``augment/ops.py`` op per stage; its affine warp of square images is
    the two-pass CUDA kernel of ``augment/warp.py``.

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


def _to(draws, dev):
    """``draws`` (tensors in dicts and lists) on device ``dev``."""
    if isinstance(draws, dict):
        return {k: _to(v, dev) for k, v in draws.items()}
    if isinstance(draws, list):
        return [_to(v, dev) for v in draws]
    return draws.to(dev)


class KeypointAugmentation:
    """Augmentation callable::

        aug = KeypointAugmentation(cfg, train=True, fused=None)
        images, coords = aug(gen, images_bchw, pixel_coordinates)

    ``images_bchw``: (B, C, H, W) with C in {3, 4, 5}, f32 or bf16;
    ``pixel_coordinates``: (B, K, 2) or (B, 2K). Returns the augmented
    images (train mode: in the input's storage dtype) and the coordinates
    normalized to [-1, 1] in the input's leading shape.

    ``fused``: None or True takes the fused branches (one kernel for the
    chain); False the unfused op chain of the JAX pipeline, stage by stage
    in its order: transplant -> affine (the two-pass warp kernel for square
    images) -> 2x erasing -> Planckian -> colour jiggle -> blur -> plasma
    shadow -> depth bias -> depth noise -> depth planes, in f32 with one
    cast back to the storage dtype. The two chains draw differently and
    differ at hue ties (``ops._adjust_hue``).
    """

    def __init__(self, cfg: AugmentationConfig, train: bool = True, fused: bool | None = None) -> None:
        self.cfg = cfg
        self.train = train
        self.fused = fused is None or bool(fused)

    def _use_ultra(self, c: int, h: int, w: int) -> bool:
        cfg = self.cfg
        return cfg.random_transplantation_with_depth and c == 5 and cfg.random_affine and h == w

    def sample(self, gen: torch.Generator, b: int, h: int, w: int, c: int) -> dict:
        """Every random draw of one call, on ``gen``'s device: ``donor_idx``
        (transplantation), ``affine`` (``ops.sample_affine_params``); then
        for the fused chain ``fused`` (``fused.sample_fused_params``), for
        the unfused one a dict per stage that is on (``erase1``,
        ``erase2``, ``planckian``, ``jiggle``, ``blur``, ``plasma``,
        ``depth_bias``, ``depth_noise``, ``depth_plane``: each op's
        ``ops.sample_*``). Empty in val mode."""
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
        if self.fused:
            draws["fused"] = fused.sample_fused_params(gen, cfg, b, h, w, c)
            return draws
        if cfg.random_erasing:
            draws["erase1"] = ops.sample_random_erasing(gen, b, p=0.5, scale=(0.02, 0.1), ratio=(2.0, 3.0))
            draws["erase2"] = ops.sample_random_erasing(gen, b, p=0.5, scale=(0.02, 0.05), ratio=(0.8, 1.2))
        if cfg.planckian_jitter:
            draws["planckian"] = ops.sample_planckian_jitter(gen, b)
        if cfg.color_jiggle:
            draws["jiggle"] = ops.sample_color_jiggle(
                gen, b, brightness=cfg.brightness, contrast=cfg.contrast, saturation=cfg.saturation, hue=cfg.hue
            )
        if cfg.blur:
            draws["blur"] = ops.sample_gaussian_blur(gen, b, sigma_range=(3.0, 8.0), p=0.5)
        if cfg.random_plasma_shadow:
            draws["plasma"] = ops.sample_plasma_shadow(gen, b, h, w)
        if c > NUM_RGB_CHANNELS:
            if cfg.random_bias:
                draws["depth_bias"] = ops.sample_depth_bias(gen, (b, h, w), p=cfg.p_bias)
            if cfg.depth_gaussian_noise:
                draws["depth_noise"] = ops.sample_depth_gaussian_noise(gen, (b, h, w))
            if cfg.random_near_plane or cfg.random_far_plane:
                p_near, p_far = self._plane_probabilities()
                draws["depth_plane"] = ops.sample_depth_plane(gen, (b, h, w), p_near=p_near, p_far=p_far)
        return draws

    def _plane_probabilities(self) -> tuple[float, float]:
        cfg = self.cfg
        return (
            cfg.p_near_plane if cfg.random_near_plane else 1.0,
            cfg.p_far_plane if cfg.random_far_plane else 1.0,
        )

    def _apply_unfused(self, images: torch.Tensor, coords: torch.Tensor, draws: dict):
        """The unfused train chain (``pipeline.py``'s ``fused=False``
        branch) on f32 images; returns (images, pixel coords)."""
        cfg = self.cfg
        _, c, h, w = images.shape
        if cfg.random_transplantation_with_depth and c == 5:
            images = ops.transplant_with_depth(images, draws["donor_idx"])
        if cfg.random_affine:
            mats = ops.affine_matrices(draws["affine"], h, w)
            images = ops.warp_affine_bilinear(images, mats)
            coords = ops.transform_keypoints(coords, mats)
        if cfg.random_erasing:
            images = ops.random_erasing(images, draws["erase1"])
            images = ops.random_erasing(images, draws["erase2"])

        rgb = images[:, :NUM_RGB_CHANNELS]
        if cfg.planckian_jitter:
            rgb = ops.planckian_jitter(rgb, draws["planckian"])
        if cfg.color_jiggle:
            rgb = ops.color_jiggle(rgb, draws["jiggle"])
        if cfg.blur:
            rgb = ops.gaussian_blur_5x5(rgb, draws["blur"])
        if cfg.random_plasma_shadow:
            rgb = ops.plasma_shadow(rgb, draws["plasma"])
        images = torch.cat([rgb, images[:, NUM_RGB_CHANNELS:]], dim=1)

        if c > NUM_RGB_CHANNELS:
            depth = images[:, DEPTH_CHANNEL_INDEX]
            if cfg.random_bias:
                depth = ops.depth_bias(depth, draws["depth_bias"], dev=cfg.dev_bias, p=cfg.p_bias, cube_scale=cfg.cube_scale)
            if cfg.depth_gaussian_noise:
                depth = ops.depth_gaussian_noise(
                    depth, draws["depth_noise"], std=cfg.std_gaussian_noise, cube_scale=cfg.cube_scale
                )
            if cfg.random_near_plane or cfg.random_far_plane:
                p_near, p_far = self._plane_probabilities()
                depth = ops.depth_plane(
                    depth, draws["depth_plane"], near_mean=cfg.scaled_near_plane_mean, near_dev=cfg.dev_near_plane,
                    p_near=p_near, near_value=cfg.near_value, far_mean=cfg.scaled_far_plane_mean,
                    far_dev=cfg.dev_far_plane, p_far=p_far, far_value=cfg.far_value, cube_scale=cfg.cube_scale,
                )
            images = torch.cat([images[:, :DEPTH_CHANNEL_INDEX], depth[:, None], images[:, DEPTH_CHANNEL_INDEX + 1 :]], dim=1)
        return images, coords

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

        if self.train and not self.fused:
            in_dtype = images.dtype
            images, coords = self._apply_unfused(images.float(), coords, _to(draws, dev))
            images = images.to(in_dtype)
        elif self.train:
            use_ultra = self._use_ultra(c, h, w)
            donor_idx = draws["donor_idx"].to(dev) if "donor_idx" in draws else None
            if cfg.random_transplantation_with_depth and c == 5 and not use_ultra:
                images = ops.transplant_with_depth(images, donor_idx)
            mats = None
            if cfg.random_affine:
                mats = ops.affine_matrices(_to(draws["affine"], dev), h, w)
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
