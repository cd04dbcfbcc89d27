"""Augmentation primitives in PyTorch, on (B, C, H, W) planes.

Port of the subset of ``perseus_tpu/augment/ops.py`` that the train step's
fused augmentation needs: the donor transplant, the random affine and its
Catmull-Smith two-pass decomposition, the keypoint transform, the
blackbody gains and the plasma fractal; plus ``depth_plane_clamp`` (val
mode and the streaming path) and the gather warp of non-square images.

Random draws take an explicit ``torch.Generator`` and are made on its
device. torch cannot reproduce JAX's key streams, so every function that
turns draws into pixels also takes the draws themselves: the tests feed it
the draws JAX made and compare the results.

Layout: images are (B, C, H, W), the kernels' layout and the model's; JAX's
are (B, H, W, C). Channels as in the JAX package: 0-2 RGB in [0, 1], 3
metric-scaled depth, 4 binary cube segmentation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "depth_plane_clamp",
    "sample_donor_indices",
    "transplant_with_depth",
    "sample_affine_params",
    "affine_matrices",
    "warp_affine_bilinear",
    "transform_keypoints",
]


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def _bernoulli(gen: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < p


def depth_plane_clamp(
    depth: torch.Tensor,
    near_mean: float = 0.1,
    near_value: float = 0.0,
    far_mean: float = 0.5,
    far_value: float = 0.0,
    cube_scale: float = 0.035,
) -> torch.Tensor:
    """Deterministic near/far clamp for the val/streaming path."""
    scaled = cube_scale * depth
    scaled = torch.where(scaled < near_mean, near_value, scaled)
    scaled = torch.where(scaled > far_mean, far_value, scaled)
    return scaled / cube_scale


# --------------------------------------------------------------------------
# Transplantation
# --------------------------------------------------------------------------


def sample_donor_indices(gen: torch.Generator, b: int) -> torch.Tensor:
    """A random *different* donor element for each batch element."""
    if b == 1:
        return torch.zeros(1, dtype=torch.int64, device=gen.device)
    offsets = torch.randint(1, b, (b,), generator=gen, device=gen.device)
    return (torch.arange(b, device=gen.device) + offsets) % b


def transplant_with_depth(
    images: torch.Tensor,
    donor_idx: torch.Tensor,
    lb_seg_ratio: float = 0.02,
    ub_seg_ratio: float = 0.7,
) -> torch.Tensor:
    """Depth-layered donor transplantation on (B, 5, H, W) RGB+D+seg
    batches: donor pixels go wherever the acceptor has no cube or the donor
    is closer within the acceptor's cube, never the donor's own cube
    pixels; a result whose seg ratio leaves [lb, ub] keeps the original.
    The mask algebra of ``ops.transplant_with_depth`` and of the fused
    kernels' ``_transplant_planes``."""
    donor = images[donor_idx]
    depth, seg = images[:, 3], images[:, 4]
    d_depth, d_seg = donor[:, 3], donor[:, 4]
    acc_cube = seg == 1.0  # exact compare: seg is binary
    donor_cube = d_seg == 1.0
    accf = acc_cube.to(images.dtype)
    donor_mask = (~acc_cube) | ((d_depth * accf) < (depth * accf))
    donor_mask = donor_mask & ~donor_cube
    new_seg = 1.0 - donor_mask.to(images.dtype)
    new_seg = torch.where(donor_cube & ~acc_cube, 0.0, new_seg)
    candidate = torch.cat(
        [torch.where(donor_mask[:, None], donor[:, :4], images[:, :4]), new_seg[:, None]], dim=1
    )
    ratio = new_seg.sum(dim=(1, 2)) / (new_seg.shape[1] * new_seg.shape[2])
    ok = (ratio >= lb_seg_ratio) & (ratio <= ub_seg_ratio)
    return torch.where(ok[:, None, None, None], candidate, images)


# --------------------------------------------------------------------------
# Random affine + keypoints
# --------------------------------------------------------------------------


def sample_affine_params(
    gen: torch.Generator,
    batch: int,
    height: int,
    width: int,
    degrees: float = 90.0,
    translate: tuple[float, float] = (0.1, 0.1),
    scale: tuple[float, float] = (0.9, 1.5),
    shear: float = 0.1,
    p: float = 0.5,
) -> dict[str, torch.Tensor]:
    """Per-element kornia-style affine parameters, (B,) each: angle (deg),
    tx/ty (pixels), scale, shear_x/shear_y (deg), applied (bool)."""
    angle = _uniform(gen, (batch,), -degrees, degrees)
    tx = _uniform(gen, (batch,), -translate[0], translate[0]) * width
    ty = _uniform(gen, (batch,), -translate[1], translate[1]) * height
    sc = _uniform(gen, (batch,), scale[0], scale[1])
    sh = _uniform(gen, (batch, 2), -shear, shear)
    applied = _bernoulli(gen, p, (batch,))
    return {
        "angle": angle, "tx": tx, "ty": ty, "scale": sc,
        "shear_x": sh[:, 0], "shear_y": sh[:, 1], "applied": applied,
    }


def affine_matrices(params: dict, height: int, width: int) -> torch.Tensor:
    """(B, 3, 3) forward affines about the image center,
    A = T(t) T(c) R(angle) S(scale) Shear T(-c); identity where not applied."""
    angle = torch.deg2rad(params["angle"])
    sx = torch.deg2rad(params["shear_x"])
    sy = torch.deg2rad(params["shear_y"])
    s = params["scale"]
    cx = (width - 1) / 2.0
    cy = (height - 1) / 2.0
    cos_a, sin_a = torch.cos(angle) * s, torch.sin(angle) * s
    tan_sx, tan_sy = torch.tan(sx), torch.tan(sy)
    m00 = cos_a + (-sin_a) * tan_sy
    m01 = cos_a * tan_sx + (-sin_a)
    m10 = sin_a + cos_a * tan_sy
    m11 = sin_a * tan_sx + cos_a
    t0 = params["tx"] + cx - (m00 * cx + m01 * cy)
    t1 = params["ty"] + cy - (m10 * cx + m11 * cy)
    zeros, ones = torch.zeros_like(m00), torch.ones_like(m00)
    mats = torch.stack(
        [
            torch.stack([m00, m01, t0], dim=-1),
            torch.stack([m10, m11, t1], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=mats.dtype, device=mats.device).expand_as(mats)
    return torch.where(params["applied"][:, None, None], mats, eye)


def _invert_affine(mats: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) forward affines -> (B, 2, 3) inverse maps [dst -> src]."""
    a00, a01, t0 = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    a10, a11, t1 = mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2]
    det = a00 * a11 - a01 * a10
    i00, i01 = a11 / det, -a01 / det
    i10, i11 = -a10 / det, a00 / det
    return torch.stack(
        [
            torch.stack([i00, i01, -(i00 * t0 + i01 * t1)], dim=-1),
            torch.stack([i10, i11, -(i10 * t0 + i11 * t1)], dim=-1),
        ],
        dim=-2,
    )


def _two_pass_params(inv: torch.Tensor):
    """Catmull-Smith two-pass parameters per image: (swap (B,) bool,
    (i00, i01, t0, p, q, r)). Images with |i00| < |i10| are transposed
    (``swap``) and their inverse map's rows and columns swapped, so that the
    first pass never divides by a vanishing i00."""
    i00, i01, t0 = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    i10, i11, t1 = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    swap = torch.abs(i00) < torch.abs(i10)
    i00, i10 = torch.where(swap, i10, i00), torch.where(swap, i00, i10)
    i01, i11 = torch.where(swap, i11, i01), torch.where(swap, i01, i11)
    t0, t1 = torch.where(swap, t1, t0), torch.where(swap, t0, t1)
    p = i10 / i00
    q = i11 - p * i01
    r = t1 - p * t0
    return swap, (i00, i01, t0, p, q, r)


def _two_pass_setup(images: torch.Tensor, inv: torch.Tensor):
    """The swap prologue on (B, C, H, W) square images + the two-pass
    parameters (see :func:`_two_pass_params`)."""
    if images.shape[-2] != images.shape[-1]:
        raise ValueError("two-pass warp requires square images")
    swap, parts = _two_pass_params(inv)
    images = torch.where(swap[:, None, None, None], images.transpose(-2, -1), images)
    return images, parts


def warp_affine_bilinear(images: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Warps (B, C, H, W) images by forward affines (B, 3, 3), bilinear with
    zero padding, out(x) = in(A^-1 x): the per-pixel 4-tap gather form of
    ``ops.warp_affine_bilinear(method="gather")`` (the JAX package's warp of
    non-square images)."""
    b, c, h, w = images.shape
    inv = _invert_affine(mats)
    dev, f32 = images.device, torch.float32
    ys = torch.arange(h, dtype=f32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w)
    col = lambda k: inv[:, k[0], k[1], None, None]  # noqa: E731
    src_x = col((0, 0)) * xs + col((0, 1)) * ys + col((0, 2))
    src_y = col((1, 0)) * xs + col((1, 1)) * ys + col((1, 2))
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx, wy = (src_x - x0)[:, None], (src_y - y0)[:, None]
    flat = images.reshape(b, c, h * w)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = torch.gather(flat, 2, idx.reshape(b, 1, h * w).expand(b, c, h * w))
        return vals.reshape(b, c, h, w) * valid[:, None]

    return (
        gather(y0, x0) * (1 - wx) * (1 - wy)
        + gather(y0, x0 + 1) * wx * (1 - wy)
        + gather(y0 + 1, x0) * (1 - wx) * wy
        + gather(y0 + 1, x0 + 1) * wx * wy
    )


def transform_keypoints(coords: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Applies (B, 3, 3) affines to pixel keypoints (B, K, 2)."""
    return torch.einsum("bij,bkj->bki", mats[:, :2, :2], coords) + mats[:, None, :2, 2]


# --------------------------------------------------------------------------
# RGB-only helpers of the fused chain
# --------------------------------------------------------------------------


def _blackbody_gains(temp_k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(r_gain, b_gain), green-normalized, of a blackbody illuminant at
    ``temp_k`` Kelvin (Tanner Helland's curve fit, clamped finite)."""
    t = temp_k / 100.0
    r = torch.where(t <= 66.0, 255.0, 329.698727446 * torch.clamp_min(t - 60.0, 1e-3) ** -0.1332047592)
    g = torch.where(
        t <= 66.0,
        99.4708025861 * torch.log(torch.clamp_min(t, 1e-3)) - 161.1195681661,
        288.1221695283 * torch.clamp_min(t - 60.0, 1e-3) ** -0.0755148492,
    )
    b = torch.where(
        t >= 66.0,
        255.0,
        torch.where(
            t <= 19.0,
            0.0,
            138.5177312231 * torch.log(torch.clamp_min(t - 10.0, 1e-3)) - 305.0447927307,
        ),
    )
    r = torch.clamp(r, 0.0, 255.0)
    g = torch.clamp(g, 1e-3, 255.0)
    b = torch.clamp(b, 0.0, 255.0)
    return r / g, b / g


def _plasma_levels(size: int) -> list[int]:
    """Side of the field at each draw of :func:`_plasma_fractal`: 2, then
    doubling up to ``size``."""
    sides, cur = [2], 2
    for _ in range(int(math.log2(size))):
        cur = min(cur * 2, size)
        sides.append(cur)
        if cur == size:
            break
    return sides


def _plasma_draws(gen: torch.Generator, batch: int, size: int) -> list[torch.Tensor]:
    """The uniform draws of :func:`_plasma_fractal`: the (B, 2, 2) base in
    [0, 1), then one (B, n, n) detail level in [-0.5, 0.5) per octave."""
    sides = _plasma_levels(size)
    return [_uniform(gen, (batch, 2, 2))] + [
        _uniform(gen, (batch, n, n), -0.5, 0.5) for n in sides[1:]
    ]


def _plasma_fractal(roughness: torch.Tensor, draws: list[torch.Tensor]) -> torch.Tensor:
    """Fractal plasma noise in [0, 1], (B, size, size), from the draws of
    :func:`_plasma_draws`: each octave upsamples the field bilinearly
    (half-pixel centers, edge-clamped: ``jax.image.resize``'s bilinear for a
    2x upsample) and adds detail scaled by roughness**level."""
    field = draws[0]
    amp = torch.ones_like(roughness)
    for noise in draws[1:]:
        cur = noise.shape[-1]
        field = F.interpolate(field[:, None], size=(cur, cur), mode="bilinear", align_corners=False)[:, 0]
        amp = amp * roughness
        field = field + amp[:, None, None] * noise
    lo = torch.amin(field, dim=(1, 2), keepdim=True)
    hi = torch.amax(field, dim=(1, 2), keepdim=True)
    return (field - lo) / torch.clamp_min(hi - lo, 1e-6)
