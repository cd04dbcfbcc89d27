"""The fused train-time augmentation: sampling, plain versions and the
CUDA kernels' wrappers.

Port of ``perseus_tpu/augment/fused.py``. Per image, the chain applies 2x
random erasing, Planckian channel gains, brightness / contrast / saturation
/ hue, a 5-tap separable blur, a plasma shadow and the depth bias / noise /
near-far-plane chain; the warp branch puts the two-pass affine warp in
front, and the "ultra" branch the donor transplant and the swap transpose
in front of that. Three Pallas kernels do this on the TPU; here each is a
hand-written CUDA kernel in ``csrc/augment.cu``:

  ==========================  ===================================  =====================
  entry                       TPU kernel it replaces               plain version
  ==========================  ===================================  =====================
  :func:`fused_apply`         ``fused.py::_kernel``                :func:`reference_apply`
  :func:`fused_warp_apply`    ``fused.py::_kernel_warp``           :func:`fused_warp_reference`
  :func:`fused_ultra_apply`   ``fused.py::_make_ultra_kernel``     :func:`fused_ultra_reference`
  ==========================  ===================================  =====================

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Each launch adds one to the
wrapper's ``launches``.

Random decisions stay outside the kernels: :func:`sample_fused_params`
draws every scalar and field with the JAX package's distributions and dict
layout, so the tests can hand both sides the same draws.

Scalar layout (per image, float32), as in the JAX module:
  0-4   erase rect 1: applied, top, left, height, width
  5-9   erase rect 2
  10,11 planckian gains: red, blue (green-normalized)
  12-15 color jiggle: brightness, contrast, saturation, hue shift (turns)
  16    blur applied
  17-21 blur taps (5)
  22    shadow intensity (pre-multiplied by applied)
  23    shadow quantity
  24-28 depth: cube_scale, near_mean, near_value, far_mean, far_value

Layout: images are (B, C, H, W) planes, the kernels' layout and the model's
(the JAX entry points take NHWC and transpose inside).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from perseus_tpu_torch.augment import ops
from perseus_tpu_torch.models import _build

__all__ = [
    "N_SCALARS",
    "sample_fused_params",
    "fused_apply",
    "fused_warp_apply",
    "fused_ultra_apply",
    "reference_apply",
    "fused_warp_reference",
    "fused_ultra_reference",
]

N_SCALARS = 29


def sample_fused_params(gen: torch.Generator, cfg, b: int, h: int, w: int, c: int) -> dict:
    """Samples every random input of the fused chain on ``gen``'s device:
    ``scalars`` (B, 29) f32 (layout in the module docstring), ``fields``
    (B, 3, H, W) bf16 (depth additive noise, near- and far-plane
    deviations) and ``plasma`` (B, H, W) bf16. The distributions of the JAX
    package's ``sample_fused_params``; the draws are torch's."""
    f32 = torch.float32
    dev = gen.device
    uni = functools.partial(ops._uniform, gen)

    def erase_rect(scale, ratio, p=0.5):
        applied = ops._bernoulli(gen, p, (b,))
        area = uni((b,), scale[0], scale[1]) * (h * w)
        aspect = uni((b,), ratio[0], ratio[1])
        rect_h = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, h)
        rect_w = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, w)
        top = torch.floor(uni((b,)) * (h - rect_h + 1))
        left = torch.floor(uni((b,)) * (w - rect_w + 1))
        return torch.stack([applied.to(f32), top, left, rect_h, rect_w], dim=-1)

    zeros = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)  # noqa: E731
    ones = lambda *shape: torch.ones(shape, dtype=f32, device=dev)  # noqa: E731
    if cfg.random_erasing:
        erase1 = erase_rect((0.02, 0.1), (2.0, 3.0))
        erase2 = erase_rect((0.02, 0.05), (0.8, 1.2))
    else:
        erase1, erase2 = zeros(b, 5), zeros(b, 5)

    if cfg.planckian_jitter:
        r_gain, b_gain = ops._blackbody_gains(uni((b,), 3000.0, 15000.0))
        applied = ops._bernoulli(gen, 0.5, (b,))
        r_gain = torch.where(applied, r_gain, 1.0)
        b_gain = torch.where(applied, b_gain, 1.0)
    else:
        r_gain, b_gain = ones(b), ones(b)

    if cfg.color_jiggle:
        f_b = uni((b,), 1 - cfg.brightness, 1 + cfg.brightness)
        f_c = uni((b,), 1 - cfg.contrast, 1 + cfg.contrast)
        f_s = uni((b,), 1 - cfg.saturation, 1 + cfg.saturation)
        f_h = uni((b,), -cfg.hue, cfg.hue)
    else:
        f_b, f_c, f_s, f_h = ones(b), ones(b), ones(b), zeros(b)

    if cfg.blur:
        sigma = uni((b,), 3.0, 8.0)
        blur_applied = ops._bernoulli(gen, 0.5, (b,)).to(f32)
        taps = ops._blur_taps(sigma)
    else:
        blur_applied, taps = zeros(b), zeros(b, 5)

    if cfg.random_plasma_shadow:
        size = 1 << int(math.ceil(math.log2(max(h, w))))
        rough = uni((b,), 0.1, 0.7)
        intensity = uni((b,), -1.0, 0.0)
        quantity = uni((b,), 0.0, 1.0)
        applied = ops._bernoulli(gen, 0.5, (b,))
        plasma = ops._plasma_fractal(rough, ops._plasma_draws(gen, b, size))[:, :h, :w]
        intensity = intensity * applied
    else:
        plasma, intensity, quantity = zeros(b, h, w), zeros(b), zeros(b)

    add_field, near_field, far_field = zeros(b, h, w), zeros(b, h, w), zeros(b, h, w)
    near_mean_v, far_mean_v = -math.inf, math.inf
    if c > 3:
        if cfg.random_bias:
            keep = ops._bernoulli(gen, 1.0 - cfg.p_bias, (b, h, w))
            u = uni((b, h, w), -1.0, 1.0)
            add_field = add_field + cfg.dev_bias * (keep / (1.0 - cfg.p_bias)) * u
        if cfg.depth_gaussian_noise:
            noise = torch.randn((b, h, w), generator=gen, device=dev)
            add_field = add_field + cfg.std_gaussian_noise * noise
        if cfg.random_near_plane or cfg.random_far_plane:
            p_near = cfg.p_near_plane if cfg.random_near_plane else 1.0
            p_far = cfg.p_far_plane if cfg.random_far_plane else 1.0
            keep_n = ops._bernoulli(gen, 1.0 - p_near, (b, h, w))
            near_field = cfg.dev_near_plane * (keep_n / max(1.0 - p_near, 1e-6)) * uni((b, h, w), -1.0, 1.0)
            keep_f = ops._bernoulli(gen, 1.0 - p_far, (b, h, w))
            far_field = cfg.dev_far_plane * (keep_f / max(1.0 - p_far, 1e-6)) * uni((b, h, w), -1.0, 1.0)
            near_mean_v, far_mean_v = cfg.scaled_near_plane_mean, cfg.scaled_far_plane_mean

    depth_scalars = torch.tensor(
        [cfg.cube_scale, near_mean_v, cfg.near_value, far_mean_v, cfg.far_value], dtype=f32, device=dev
    ).expand(b, 5)
    scalars = torch.cat(
        [
            erase1, erase2, r_gain[:, None], b_gain[:, None], f_b[:, None], f_c[:, None],
            f_s[:, None], f_h[:, None], blur_applied[:, None], taps, intensity[:, None],
            quantity[:, None], depth_scalars,
        ],
        dim=-1,
    )
    # fields and plasma travel as bf16, as in the JAX package (7/12 of the
    # kernels' input bytes); every consumer upcasts them to f32 at load
    return {
        "scalars": scalars.contiguous(),
        "fields": torch.stack([add_field, near_field, far_field], dim=1).to(torch.bfloat16),
        "plasma": plasma.to(torch.bfloat16).contiguous(),
    }


# --------------------------------------------------------------------------
# Plain versions (batched over B; each scalar k is sv[:, k] as (B, 1, 1))
# --------------------------------------------------------------------------


def _hue_planes(r, g, b, shift):
    """Hue rotation on channel planes. The max channel is picked by ordering
    comparisons (r >= g, ...), as in the JAX kernel, not by equality with
    the computed max (the unfused ``ops._adjust_hue`` differs at ties);
    ``%`` is torch.remainder, the floor modulo of JAX's ``%`` (a truncating
    fmod would be wrong for a negative shift)."""
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, 1.0, delta)
    s = torch.where(v > 0, delta / torch.where(v > 0, v, 1.0), 0.0)
    r_max = (r >= g) & (r >= b)
    g_max = (g > r) & (g >= b)
    hr = torch.remainder((g - b) / safe_delta, 6.0)
    hg = (b - r) / safe_delta + 2.0
    hb = (r - g) / safe_delta + 4.0
    hh = torch.where(r_max, hr, torch.where(g_max, hg, hb)) / 6.0
    hh = torch.where(delta == 0, 0.0, hh)
    hh = torch.remainder(hh + shift, 1.0)
    return ops._hsv_to_rgb(hh, s, v)


def _chain_planes(planes: list, plasma, fields: list, sv: torch.Tensor) -> list:
    """The fused chain on C channel planes (B, H, W) f32, plasma (B, H, W),
    the three fields, and the (B, 29) scalars: ``fused._chain_planes``."""
    h, w = planes[0].shape[-2:]
    dev = planes[0].device
    k = lambda i: sv[:, i, None, None]  # noqa: E731
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]

    def erase_mask(o):
        inside = (ys >= k(o + 1)) & (ys < k(o + 1) + k(o + 3)) & (xs >= k(o + 2)) & (xs < k(o + 2) + k(o + 4))
        return inside & (k(o) > 0.5)

    mask = erase_mask(0) | erase_mask(5)
    planes = [torch.where(mask, 0.0, p) for p in planes]

    clip = lambda x: torch.clamp(x, 0.0, 1.0)  # noqa: E731
    r, g, b = planes[0], planes[1], planes[2]
    f_b = k(12)
    r = clip(clip(r * k(10)) * f_b)
    g = clip(g * f_b)
    b = clip(clip(b * k(11)) * f_b)
    f_c = k(13)
    gray = r * 0.299 + g * 0.587 + b * 0.114
    mean_gray = torch.mean(gray, dim=(1, 2), keepdim=True)
    r = clip(f_c * r + (1 - f_c) * mean_gray)
    g = clip(f_c * g + (1 - f_c) * mean_gray)
    b = clip(f_c * b + (1 - f_c) * mean_gray)
    f_s = k(14)
    gray = r * 0.299 + g * 0.587 + b * 0.114
    r = clip(f_s * r + (1 - f_s) * gray)
    g = clip(f_s * g + (1 - f_s) * gray)
    b = clip(f_s * b + (1 - f_s) * gray)
    f_h = k(15)
    hr, hg, hb = _hue_planes(r, g, b, f_h)
    r = torch.where(f_h == 0.0, r, clip(hr))
    g = torch.where(f_h == 0.0, g, clip(hg))
    b = torch.where(f_h == 0.0, b, clip(hb))
    taps = [k(17 + i) for i in range(5)]
    blur_on = k(16) > 0.5
    r = torch.where(blur_on, ops._blur_plane(r, taps), r)
    g = torch.where(blur_on, ops._blur_plane(g, taps), g)
    b = torch.where(blur_on, ops._blur_plane(b, taps), b)
    delta_sh = k(22) * (plasma < k(23)).to(torch.float32)
    r = clip(r + delta_sh)
    g = clip(g + delta_sh)
    b = clip(b + delta_sh)

    out = [r, g, b]
    if len(planes) > 3:
        cs = k(24)
        scaled = cs * planes[3] + fields[0]
        scaled = torch.where(scaled < k(25) + fields[1], k(26), scaled)
        scaled = torch.where(scaled > k(27) + fields[2], k(28), scaled)
        out.append(scaled / cs)
    out.extend(planes[4:])
    return out


def _index_planes(warp_params: torch.Tensor, h: int, w: int):
    """The two-pass warp's fractional source-index planes, computed once
    (each consumer reads the same bits for a tap's index and its weight):
    rhoT (B, W, H) [j, y] = (q y + p j) + r and gam (B, H, W) [y, x] =
    (i01 y + i00 x) + t0, each product and sum rounded on its own."""
    i00, i01, t0, p, q, r = (warp_params[:, k].float()[:, None, None] for k in range(6))
    ys = torch.arange(h, dtype=torch.float32, device=warp_params.device)
    xs = torch.arange(w, dtype=torch.float32, device=warp_params.device)
    rho_t = q * ys[None, None, :] + p * xs[None, :, None] + r
    gam = i01 * ys[None, :, None] + i00 * xs[None, None, :] + t0
    return rho_t, gam


def _warp_planes(planes: list, rho_t: torch.Tensor, gam: torch.Tensor, s: int, w: int) -> list:
    """Two-pass affine warp of (B, S, W) planes, zero padding:
    inter[y, j] = p[i0, j] v_w0 + p[i0 + 1, j] v_w1 with i0 = floor(rhoT[j, y]),
    out[y, x] = inter[y, j0] h_w0 + inter[y, j0 + 1] h_w1 with j0 =
    floor(gam[y, x]) (``fused._warp_planes``)."""
    r0 = torch.floor(rho_t)
    fv = rho_t - r0
    i0 = r0.to(torch.int64)
    v_idx0, v_idx1 = i0.clamp(0, s - 1), (i0 + 1).clamp(0, s - 1)
    v_w0 = ((i0 >= 0) & (i0 < s)).float() * (1.0 - fv)
    v_w1 = ((i0 + 1 >= 0) & (i0 + 1 < s)).float() * fv
    g0 = torch.floor(gam)
    fh = gam - g0
    j0 = g0.to(torch.int64)
    h_idx0, h_idx1 = j0.clamp(0, w - 1), (j0 + 1).clamp(0, w - 1)
    h_w0 = ((j0 >= 0) & (j0 < w)).float() * (1.0 - fh)
    h_w1 = ((j0 + 1 >= 0) & (j0 + 1 < w)).float() * fh
    out = []
    for p in planes:
        pt = p.transpose(1, 2)  # (B, W_in, S)
        inter = (torch.gather(pt, 2, v_idx0) * v_w0 + torch.gather(pt, 2, v_idx1) * v_w1).transpose(1, 2)
        out.append(torch.gather(inter, 2, h_idx0) * h_w0 + torch.gather(inter, 2, h_idx1) * h_w1)
    return out


def _transplant_planes(planes: list, donor: list, lb: float, ub: float) -> list:
    """Depth-layered donor transplant on channel planes, kept only where the
    new seg ratio lies in [lb, ub] (``fused._transplant_planes``); the seg
    compares are exact (seg is binary)."""
    depth, seg = planes[3], planes[4]
    d_depth, d_seg = donor[3], donor[4]
    acc_cube = seg == 1.0
    donor_cube = d_seg == 1.0
    accf = acc_cube.float()
    donor_mask = (~acc_cube) | ((d_depth * accf) < (depth * accf))
    donor_mask = donor_mask & ~donor_cube
    new_planes = [torch.where(donor_mask, donor[k], planes[k]) for k in range(4)]
    new_seg = 1.0 - donor_mask.float()
    new_seg = torch.where(donor_cube & ~acc_cube, 0.0, new_seg)
    new_planes.append(new_seg)
    ratio = (new_seg.sum(dim=(1, 2)) / (new_seg.shape[1] * new_seg.shape[2]))[:, None, None]
    ok = (ratio >= lb) & (ratio <= ub)
    return [torch.where(ok, n, o) for n, o in zip(new_planes, planes)]


def _finish(planes: list, params: dict, dtype: torch.dtype) -> torch.Tensor:
    fields = params["fields"].float()
    out = _chain_planes(planes, params["plasma"].float(), [fields[:, k] for k in range(3)], params["scalars"].float())
    return torch.stack(out, dim=1).to(dtype)


def reference_apply(images: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain version of :func:`fused_apply` (``fused.reference_apply``):
    f32 math on the upcast planes, one cast to the storage dtype."""
    planes = [images[:, k].float() for k in range(images.shape[1])]
    return _finish(planes, params, images.dtype)


def fused_warp_reference(images_sw: torch.Tensor, warp_params: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain version of :func:`fused_warp_apply`."""
    _, c, h, w = images_sw.shape
    rho_t, gam = _index_planes(warp_params, h, w)
    planes = _warp_planes([images_sw[:, k].float() for k in range(c)], rho_t, gam, h, w)
    return _finish(planes, params, images_sw.dtype)


def fused_ultra_reference(
    images: torch.Tensor,
    donor_idx: torch.Tensor,
    swap: torch.Tensor,
    warp_params: torch.Tensor,
    params: dict,
    lb: float = 0.02,
    ub: float = 0.7,
) -> torch.Tensor:
    """Plain version of :func:`fused_ultra_apply`: transplant in the
    original orientation, then the per-image swap transpose, the warp and
    the chain."""
    _, c, h, w = images.shape
    planes = [images[:, k].float() for k in range(c)]
    donor = [p[donor_idx.long()] for p in planes]
    planes = _transplant_planes(planes, donor, lb, ub)
    sw = swap.bool()[:, None, None]
    planes = [torch.where(sw, p.transpose(1, 2), p) for p in planes]
    rho_t, gam = _index_planes(warp_params, h, w)
    planes = _warp_planes(planes, rho_t, gam, h, w)
    return _finish(planes, params, images.dtype)


# --------------------------------------------------------------------------
# The kernels (csrc/augment.cu)
# --------------------------------------------------------------------------

_MODE = {"chain": 0, "warp": 1, "ultra": 2}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load_library("augment"), f"perseus_fused_augment_{_SUFFIX[dtype]}")
    fn.argtypes = [
        ctypes.c_int,  # mode
        ctypes.c_void_p, ctypes.c_void_p,  # images, out
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # scalars, fields, plasma
        ctypes.c_void_p, ctypes.c_void_p,  # warp params (B, 6), donor idx (B,) int32
        ctypes.c_void_p,  # scratch of _scratch_bytes()(b, h, w) bytes
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, c, h, w
        ctypes.c_float, ctypes.c_float,  # lb, ub
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scratch_bytes():
    """(b, h, w) -> bytes of the kernels' scratch (RGB planes, per-tile gray
    partials, means, seg counts), as csrc/augment.cu lays it out."""
    fn = _build.load_library("augment").perseus_fused_augment_scratch_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int64
    return fn


def _launch(
    mode: str,
    images: torch.Tensor,
    params: dict,
    warp_params: torch.Tensor | None = None,
    donor_idx: torch.Tensor | None = None,
    swap: torch.Tensor | None = None,
    lb: float = 0.0,
    ub: float = 0.0,
) -> torch.Tensor:
    name = {"chain": "fused_apply", "warp": "fused_warp_apply", "ultra": "fused_ultra_apply"}[mode]
    if images.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {images.device}")
    if images.dtype not in _SUFFIX:
        raise TypeError(f"{name}: image dtype {images.dtype} (kernel takes float32, bfloat16)")
    if images.dim() != 4 or not images.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous (B, C, H, W) images, got {tuple(images.shape)}")
    b, c, h, w = images.shape
    if not 3 <= c <= 8 or h < 3 or w < 3:
        raise ValueError(f"{name}: the kernel takes 3-8 channels and H, W >= 3, got {tuple(images.shape)}")
    if b > 65535:
        raise ValueError(f"{name}: at most 65535 images per launch, got {b}")
    if mode != "chain" and h != w:
        raise ValueError(f"{name}: the two-pass warp requires square images")
    if mode == "ultra" and c != 5:
        raise ValueError(f"{name}: transplantation needs RGB + depth + seg (C = 5), got C = {c}")
    dev = images.device
    scalars = params["scalars"].to(dev, torch.float32).contiguous()
    fields, plasma = params["fields"], params["plasma"]
    if fields.dtype != torch.bfloat16 or plasma.dtype != torch.bfloat16:
        raise TypeError(f"{name}: fields and plasma must be bfloat16 (as sample_fused_params makes them)")
    if scalars.shape != (b, N_SCALARS) or fields.shape != (b, 3, h, w) or plasma.shape != (b, h, w):
        raise ValueError(f"{name}: params do not match images of shape {tuple(images.shape)}")
    fields, plasma = fields.to(dev).contiguous(), plasma.to(dev).contiguous()
    if warp_params is not None:
        warp_params = warp_params.to(dev, torch.float32).contiguous()
        if mode == "ultra":
            # the swap flag travels as a 7th warp parameter
            warp_params = torch.cat([warp_params, swap.to(dev, torch.float32)[:, None]], dim=1).contiguous()
    if donor_idx is not None:
        donor_idx = donor_idx.to(dev, torch.int32).contiguous()
        if donor_idx.shape != (b,):  # values are clamped into [0, B) in the kernel
            raise ValueError(f"{name}: donor_idx must be (B,) indices into the batch")
    out = torch.empty_like(images)
    if out.numel() == 0:
        return out
    scratch = torch.empty(_scratch_bytes()(b, h, w), dtype=torch.uint8, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(images.dtype)(
            _MODE[mode], images.data_ptr(), out.data_ptr(), scalars.data_ptr(), fields.data_ptr(),
            plasma.data_ptr(), ptr(warp_params), ptr(donor_idx), scratch.data_ptr(),
            b, c, h, w, lb, ub, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    _WRAPPER[mode].launches += 1
    return out


def fused_apply(images: torch.Tensor, params: dict) -> torch.Tensor:
    """The fused chain on (B, C, H, W) images, f32 or bf16 storage, f32
    math: the kernel for CUDA tensors, :func:`reference_apply` for CPU
    ones. ``params`` is :func:`sample_fused_params`'s dict."""
    if images.device.type == "cpu":
        return reference_apply(images, params)
    return _launch("chain", images, params)


def fused_warp_apply(images_sw: torch.Tensor, warp_params: torch.Tensor, params: dict) -> torch.Tensor:
    """Two-pass affine warp + the fused chain. ``images_sw`` (B, C, S, S)
    is swap-adjusted (``ops._two_pass_setup``); ``warp_params`` (B, 6) is
    (i00, i01, t0, p, q, r). The index planes are computed in the kernel
    with the plain version's rounding."""
    if images_sw.device.type == "cpu":
        return fused_warp_reference(images_sw, warp_params, params)
    return _launch("warp", images_sw, params, warp_params=warp_params)


def fused_ultra_apply(
    images: torch.Tensor,
    donor_idx: torch.Tensor,
    swap: torch.Tensor,
    warp_params: torch.Tensor,
    params: dict,
    lb: float = 0.02,
    ub: float = 0.7,
) -> torch.Tensor:
    """Donor transplant (seg-ratio gate [lb, ub]) + per-image swap transpose
    + two-pass warp + the fused chain on (B, 5, S, S) images in their
    ORIGINAL orientation; ``donor_idx`` (B,) indexes the same batch (no
    gathered copy), ``swap`` (B,) bool, ``warp_params`` (B, 6)
    swap-adjusted."""
    if images.device.type == "cpu":
        return fused_ultra_reference(images, donor_idx, swap, warp_params, params, lb, ub)
    return _launch("ultra", images, params, warp_params, donor_idx, swap, lb, ub)


# each wrapper's count of its kernel's launches, added to in _launch right
# after the launch (an empty batch launches nothing and counts nothing)
_WRAPPER = {"chain": fused_apply, "warp": fused_warp_apply, "ultra": fused_ultra_apply}
fused_apply.launches = 0
fused_warp_apply.launches = 0
fused_ultra_apply.launches = 0
