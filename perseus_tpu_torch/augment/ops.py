"""Augmentation primitives in PyTorch, on (B, C, H, W) planes.

Port of ``perseus_tpu/augment/ops.py``: the donor transplant, the random
affine, its warp (:func:`warp_affine_bilinear`: the two-pass kernel of
``augment/warp.py`` for square images, the 4-tap gather otherwise) and the
keypoint transform; the ops of the unfused chain (random erasing, Planckian
jitter, colour jiggle, the 5x5 blur, the plasma shadow, depth bias / noise /
planes); the deterministic ``depth_plane_clamp`` of val mode and the
streaming path; and the helpers the fused chain shares.

Random draws take an explicit ``torch.Generator`` and are made on its
device. torch cannot reproduce JAX's key streams, so each random op is two
functions: ``sample_<op>`` makes the draws (a dict, the values each
``jax.random`` call of the JAX op returns, with its distributions), and
``<op>`` turns them into pixels. The tests feed the second the draws JAX
made and compare the results.

Layout: images are (B, C, H, W), the kernels' layout and the model's; JAX's
are (B, H, W, C). Channels as in the JAX package: 0-2 RGB in [0, 1], 3
metric-scaled depth, 4 binary cube segmentation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "sample_depth_bias",
    "depth_bias",
    "sample_depth_gaussian_noise",
    "depth_gaussian_noise",
    "sample_depth_plane",
    "depth_plane",
    "depth_plane_clamp",
    "sample_donor_indices",
    "transplant_with_depth",
    "sample_affine_params",
    "affine_matrices",
    "warp_affine_bilinear",
    "transform_keypoints",
    "sample_random_erasing",
    "random_erasing",
    "sample_planckian_jitter",
    "planckian_jitter",
    "sample_color_jiggle",
    "color_jiggle",
    "sample_gaussian_blur",
    "gaussian_blur_5x5",
    "sample_plasma_shadow",
    "plasma_shadow",
]


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def _bernoulli(gen: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < p


# --------------------------------------------------------------------------
# Depth augmentations, on metric-scaled depth planes (B, H, W)
# --------------------------------------------------------------------------


def _kept_scale(keep: torch.Tensor, p: float) -> torch.Tensor:
    """``keep / (1 - p)`` as the JAX package computes it: XLA folds the
    division of a converted bool into a select, kept -> 1 / (1 - p) in f32,
    dropped -> 0. At p = 1 a dropped pixel is therefore 0, not 0 / 0 = NaN
    (and a kept one would be inf)."""
    scale = 1.0 / torch.tensor(1.0 - p, dtype=torch.float32, device=keep.device)
    return torch.where(keep, scale, 0.0)


def sample_depth_bias(gen: torch.Generator, shape, p: float = 0.5) -> dict:
    """``keep`` (bool, probability 1 - p) and ``u`` (uniform in [-1, 1))."""
    return {"keep": _bernoulli(gen, 1.0 - p, shape), "u": _uniform(gen, shape, -1.0, 1.0)}


def depth_bias(depth: torch.Tensor, draws: dict, dev: float = 0.02, p: float = 0.5, cube_scale: float = 0.035) -> torch.Tensor:
    """Per-pixel uniform bias with dropout semantics: kept biases are scaled
    by 1 / (1 - p) (``ops.depth_bias``)."""
    bias = dev * _kept_scale(draws["keep"], p) * draws["u"]
    return (cube_scale * depth + bias) / cube_scale


def sample_depth_gaussian_noise(gen: torch.Generator, shape) -> dict:
    """``noise``: standard normal."""
    return {"noise": torch.randn(shape, generator=gen, device=gen.device)}


def depth_gaussian_noise(depth: torch.Tensor, draws: dict, std: float = 0.005, cube_scale: float = 0.035) -> torch.Tensor:
    """Gaussian noise on metric-scaled depth (``ops.depth_gaussian_noise``)."""
    return (cube_scale * depth + std * draws["noise"]) / cube_scale


def sample_depth_plane(gen: torch.Generator, shape, p_near: float = 0.5, p_far: float = 0.5) -> dict:
    """The near and far planes' ``keep`` masks (probability 1 - p) and
    uniform deviations in [-1, 1)."""
    return {
        "keep_near": _bernoulli(gen, 1.0 - p_near, shape),
        "u_near": _uniform(gen, shape, -1.0, 1.0),
        "keep_far": _bernoulli(gen, 1.0 - p_far, shape),
        "u_far": _uniform(gen, shape, -1.0, 1.0),
    }


def depth_plane(
    depth: torch.Tensor,
    draws: dict,
    near_mean: float = 0.1,
    near_dev: float = 0.05,
    p_near: float = 0.5,
    near_value: float = 0.0,
    far_mean: float = 0.5,
    far_dev: float = 0.05,
    p_far: float = 0.5,
    far_value: float = 0.0,
    cube_scale: float = 0.035,
) -> torch.Tensor:
    """Randomized near/far cutoff planes with per-pixel deviations
    (``ops.depth_plane``). The JAX pipeline turns a plane off with p = 1;
    then no pixel is kept, every deviation is 0 (:func:`_kept_scale`, not
    NaN), and the plane cuts at exactly its mean: the JAX result, kept as
    it is."""
    scaled = cube_scale * depth
    dev_n = near_dev * _kept_scale(draws["keep_near"], p_near) * draws["u_near"]
    scaled = torch.where(scaled < near_mean + dev_n, near_value, scaled)
    dev_f = far_dev * _kept_scale(draws["keep_far"], p_far) * draws["u_far"]
    scaled = torch.where(scaled > far_mean + dev_f, far_value, scaled)
    return scaled / cube_scale


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


def warp_affine_bilinear(images: torch.Tensor, mats: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """Warps (B, C, H, W) images by forward affines (B, 3, 3), bilinear with
    zero padding, out(x) = in(A^-1 x) (``ops.warp_affine_bilinear``).

    method:
      * "two_pass": the Catmull-Smith two-pass resampling of square images,
        f32 out (``augment/warp.py``: the CUDA kernel for CUDA tensors, its
        plain version on the CPU); the JAX package's ``method="pallas"``;
      * "gather": the per-pixel 4-tap gather, in the images' dtype;
      * "auto": "two_pass" for square images on every device (the route
        the JAX package takes on the TPU), else "gather".

    The JAX package's ``method="mxu"`` (one-hot matmuls with bf16 picks, a
    TPU lowering) is not ported.
    """
    b, c, h, w = images.shape
    if method == "auto":
        method = "two_pass" if h == w else "gather"
    inv = _invert_affine(mats)
    if method == "two_pass":
        from perseus_tpu_torch.augment.warp import warp_affine_two_pass  # warp imports this module

        if h != w:
            raise ValueError("two-pass warp requires square images")
        swap, parts = _two_pass_params(inv)
        return warp_affine_two_pass(images, swap, torch.stack(parts, dim=-1))
    if method != "gather":
        raise ValueError(f"warp_affine_bilinear: method {method!r} (ported: 'auto', 'two_pass', 'gather')")
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
# Random erasing
# --------------------------------------------------------------------------


def sample_random_erasing(
    gen: torch.Generator,
    b: int,
    p: float = 0.5,
    scale: tuple[float, float] = (0.02, 0.1),
    ratio: tuple[float, float] = (0.8, 1.2),
) -> dict:
    """Per image: ``applied`` (probability p), ``area`` (fraction of the
    image, uniform in ``scale``), ``aspect`` (w / h, uniform in ``ratio``),
    ``u_top`` and ``u_left`` (uniform in [0, 1))."""
    return {
        "applied": _bernoulli(gen, p, (b,)),
        "area": _uniform(gen, (b,), scale[0], scale[1]),
        "aspect": _uniform(gen, (b,), ratio[0], ratio[1]),
        "u_top": _uniform(gen, (b,)),
        "u_left": _uniform(gen, (b,)),
    }


def random_erasing(images: torch.Tensor, draws: dict, value: float = 0.0) -> torch.Tensor:
    """Sets one rectangle per applied image to ``value`` on every channel
    (``ops.random_erasing``). ``torch.round`` rounds half to even, as
    ``jnp.round``."""
    _, _, h, w = images.shape
    area = draws["area"] * (h * w)
    aspect = draws["aspect"]
    rect_h = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, h)
    rect_w = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, w)
    top = torch.floor(draws["u_top"] * (h - rect_h + 1))
    left = torch.floor(draws["u_left"] * (w - rect_w + 1))
    ys = torch.arange(h, dtype=torch.float32, device=images.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=images.device)[None, None, :]
    col = lambda v: v[:, None, None]  # noqa: E731
    in_rect = (ys >= col(top)) & (ys < col(top + rect_h)) & (xs >= col(left)) & (xs < col(left + rect_w))
    erase = in_rect & col(draws["applied"])
    return torch.where(erase[:, None], value, images)


# --------------------------------------------------------------------------
# RGB-only ops, on (B, 3, H, W)
# --------------------------------------------------------------------------


def sample_planckian_jitter(gen: torch.Generator, b: int, temp_range=(3000.0, 15000.0), p: float = 0.5) -> dict:
    """``temp`` (Kelvin, uniform in ``temp_range``) and ``applied``."""
    return {"temp": _uniform(gen, (b,), *temp_range), "applied": _bernoulli(gen, p, (b,))}


def planckian_jitter(rgb: torch.Tensor, draws: dict) -> torch.Tensor:
    """Scales red and blue by a blackbody illuminant's green-normalized
    gains where applied, then clips to [0, 1] (``ops.planckian_jitter``)."""
    r_gain, b_gain = _blackbody_gains(draws["temp"])
    r_gain = torch.where(draws["applied"], r_gain, 1.0)
    b_gain = torch.where(draws["applied"], b_gain, 1.0)
    gains = torch.stack([r_gain, torch.ones_like(r_gain), b_gain], dim=-1)
    return torch.clamp(rgb * gains[:, :, None, None], 0.0, 1.0)


def _rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, H, W) luma, 0.299 r + 0.587 g + 0.114 b."""
    return rgb[:, 0] * 0.299 + rgb[:, 1] * 0.587 + rgb[:, 2] * 0.114


def _hsv_to_rgb(hh: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    """HSV (hue in turns, [0, 1)) back to (r, g, b) planes, by the sector
    i = floor(6 h) mod 6 (``jnp.select`` over the six sectors)."""
    h6 = hh * 6.0
    i = torch.floor(h6)
    f = h6 - i
    pp = v * (1 - s)
    qq = v * (1 - s * f)
    tt = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def sel(vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return sel([v, qq, pp, pp, tt, v]), sel([tt, v, v, qq, pp, pp]), sel([pp, pp, tt, v, v, qq])


def _adjust_hue(rgb: torch.Tensor, shift_turns: torch.Tensor) -> torch.Tensor:
    """Hue rotation of (B, 3, H, W) by ``shift_turns`` (B,), as
    ``ops._adjust_hue`` writes it: the hue sums the branch of EVERY channel
    equal to the max, so at a tie (r == g > b, say) it is hr + hg, not one
    branch (the fused chain's ``fused._hue_planes`` picks one by ordering
    compares; the two differ there, and each port keeps its own).
    ``torch.remainder`` is the floor modulo of JAX's ``%``."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, 1.0, delta)
    s = torch.where(maxc == 0, 0.0, delta / torch.where(maxc == 0, 1.0, maxc))
    hr = torch.where(maxc == r, torch.remainder((g - b) / safe_delta, 6.0), 0.0)
    hg = torch.where(maxc == g, (b - r) / safe_delta + 2.0, 0.0)
    hb = torch.where(maxc == b, (r - g) / safe_delta + 4.0, 0.0)
    hh = torch.where(delta == 0, 0.0, (hr + hg + hb) / 6.0)
    hh = torch.remainder(hh + shift_turns[:, None, None], 1.0)
    return torch.stack(_hsv_to_rgb(hh, s, v), dim=1)


def sample_color_jiggle(
    gen: torch.Generator, b: int, brightness: float = 0.2, contrast: float = 0.4, saturation: float = 0.4, hue: float = 0.025
) -> dict:
    """Per-image factors: ``brightness``, ``contrast``, ``saturation``
    uniform in [1 - x, 1 + x), ``hue`` (turns) in [-hue, hue)."""
    return {
        "brightness": _uniform(gen, (b,), 1 - brightness, 1 + brightness),
        "contrast": _uniform(gen, (b,), 1 - contrast, 1 + contrast),
        "saturation": _uniform(gen, (b,), 1 - saturation, 1 + saturation),
        "hue": _uniform(gen, (b,), -hue, hue),
    }


def color_jiggle(rgb: torch.Tensor, draws: dict) -> torch.Tensor:
    """Brightness, contrast (about the image's mean gray), saturation and
    hue in that fixed order, each clipped to [0, 1] (``ops.color_jiggle``;
    the hue round trip runs even at a zero shift, as there)."""
    clip = lambda x: torch.clamp(x, 0.0, 1.0)  # noqa: E731
    col = lambda v: v[:, None, None, None]  # noqa: E731
    f_b, f_c, f_s = col(draws["brightness"]), col(draws["contrast"]), col(draws["saturation"])
    out = clip(rgb * f_b)
    mean_gray = torch.mean(_rgb_to_gray(out), dim=(1, 2))[:, None, None, None]
    out = clip(f_c * out + (1 - f_c) * mean_gray)
    gray = _rgb_to_gray(out)[:, None]
    out = clip(f_s * out + (1 - f_s) * gray)
    return clip(_adjust_hue(out, draws["hue"]))


def _reflect_index(n: int, device) -> torch.Tensor:
    """Source index of each of the n + 4 rows of a 2-reflect-padded axis:
    -2 -> 2, -1 -> 1, n -> n - 2, n + 1 -> n - 3 (``jnp.pad(mode="reflect")``)."""
    idx = torch.arange(-2, n + 2, device=device)
    idx = torch.where(idx < 0, -idx, idx)
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


def _blur_plane(x: torch.Tensor, taps: list[torch.Tensor]) -> torch.Tensor:
    """5-tap separable blur with reflect padding over the last two axes of
    ``x``, the vertical pass first, the taps (each broadcast against ``x``)
    summed in Python's left-to-right order, as ``ops.gaussian_blur_5x5``."""
    h, w = x.shape[-2:]
    p = x[..., _reflect_index(h, x.device), :]
    acc = 0
    for i in range(5):
        acc = acc + taps[i] * p[..., i : i + h, :]
    p = acc[..., _reflect_index(w, x.device)]
    out = 0
    for i in range(5):
        out = out + taps[i] * p[..., i : i + w]
    return out


def _blur_taps(sigma: torch.Tensor) -> torch.Tensor:
    """(B, 5) normalized Gaussian taps at offsets -2..2 for per-image sigma."""
    offsets = torch.arange(-2, 3, dtype=sigma.dtype, device=sigma.device)
    taps = torch.exp(-0.5 * (offsets[None, :] / sigma[:, None]) ** 2)
    return taps / torch.sum(taps, dim=-1, keepdim=True)


def sample_gaussian_blur(gen: torch.Generator, b: int, sigma_range=(3.0, 8.0), p: float = 0.5) -> dict:
    """``sigma`` uniform in ``sigma_range`` and ``applied``."""
    return {"sigma": _uniform(gen, (b,), *sigma_range), "applied": _bernoulli(gen, p, (b,))}


def gaussian_blur_5x5(rgb: torch.Tensor, draws: dict) -> torch.Tensor:
    """5x5 separable Gaussian blur with reflect padding where applied
    (``ops.gaussian_blur_5x5``)."""
    taps = _blur_taps(draws["sigma"])
    out = _blur_plane(rgb, [taps[:, i, None, None, None] for i in range(5)])
    return torch.where(draws["applied"][:, None, None, None], out, rgb)


def sample_plasma_shadow(
    gen: torch.Generator,
    b: int,
    h: int,
    w: int,
    roughness=(0.1, 0.7),
    shade_intensity=(-1.0, 0.0),
    shade_quantity=(0.0, 1.0),
    p: float = 0.5,
) -> dict:
    """``roughness``, ``intensity``, ``quantity`` (uniform in their
    ranges), ``applied``, and the plasma fractal's ``noise`` draws
    (:func:`_plasma_draws`) at the power of two covering max(h, w)."""
    size = 1 << int(math.ceil(math.log2(max(h, w))))
    return {
        "roughness": _uniform(gen, (b,), *roughness),
        "intensity": _uniform(gen, (b,), *shade_intensity),
        "quantity": _uniform(gen, (b,), *shade_quantity),
        "applied": _bernoulli(gen, p, (b,)),
        "noise": _plasma_draws(gen, b, size),
    }


def plasma_shadow(rgb: torch.Tensor, draws: dict) -> torch.Tensor:
    """Darkens by ``intensity`` (negative) where the plasma field lies below
    ``quantity``, where applied, then clips (``ops.plasma_shadow``)."""
    _, _, h, w = rgb.shape
    plasma = _plasma_fractal(draws["roughness"], draws["noise"])[:, :h, :w]
    shadow = (plasma < draws["quantity"][:, None, None]).to(rgb.dtype)
    delta = draws["intensity"][:, None, None] * shadow * draws["applied"][:, None, None]
    return torch.clamp(rgb + delta[:, None], 0.0, 1.0)


# --------------------------------------------------------------------------
# RGB-only helpers shared with the fused chain
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
