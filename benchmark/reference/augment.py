"""Plain train-time augmentation: the draws and the "ultra" apply, in f32.

The configuration's augmentation (``AugmentationConfig`` defaults, a
5-channel square batch: transplant, affine and chain in one pass) as plain
tensor code. ``sample`` makes the draws in the order and with the
distributions the configuration's pipeline makes them, from a
``torch.Generator`` seeded as the configuration seeds each step
(``step_seed``), so that the reference works out the timed path's draws
again; ``apply`` is a deterministic function of the draws. A frozen copy of
the plain arithmetic the configuration defines (donor transplant by depth,
the inverse affine as a two-pass warp, erasing, Planckian gains,
brightness / contrast / saturation / hue, a 5-tap blur, a plasma shadow,
depth bias, noise and near / far planes).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def step_seed(run_seed: int, step: int) -> int:
    """The seed of global step ``step``'s generator: SeedSequence((run seed,
    step)), 64 bits, shifted right by one."""
    return int(np.random.SeedSequence([run_seed, step]).generate_state(1, np.uint64)[0]) >> 1


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _bernoulli(gen, p, shape):
    return torch.rand(shape, generator=gen, device=gen.device) < p


def _blackbody_gains(temp_k):
    t = temp_k / 100.0
    r = torch.where(t <= 66.0, 255.0, 329.698727446 * torch.clamp_min(t - 60.0, 1e-3) ** -0.1332047592)
    g = torch.where(
        t <= 66.0,
        99.4708025861 * torch.log(torch.clamp_min(t, 1e-3)) - 161.1195681661,
        288.1221695283 * torch.clamp_min(t - 60.0, 1e-3) ** -0.0755148492,
    )
    b = torch.where(
        t >= 66.0, 255.0,
        torch.where(t <= 19.0, 0.0, 138.5177312231 * torch.log(torch.clamp_min(t - 10.0, 1e-3)) - 305.0447927307),
    )
    r, g, b = torch.clamp(r, 0.0, 255.0), torch.clamp(g, 1e-3, 255.0), torch.clamp(b, 0.0, 255.0)
    return r / g, b / g


def _blur_taps(sigma):
    offsets = torch.arange(-2, 3, dtype=sigma.dtype, device=sigma.device)
    taps = torch.exp(-0.5 * (offsets[None, :] / sigma[:, None]) ** 2)
    return taps / torch.sum(taps, dim=-1, keepdim=True)


def _plasma(gen, rough, b, size):
    """Fractal plasma in [0, 1], (B, size, size): a 2x2 base, then per
    octave a bilinear 2x upsample (half-pixel centres) plus uniform detail
    in +-0.5 scaled by roughness**level, min-max normalized."""
    sides, cur = [2], 2
    for _ in range(int(math.log2(size))):
        cur = min(cur * 2, size)
        sides.append(cur)
        if cur == size:
            break
    field = _uniform(gen, (b, 2, 2))
    details = [_uniform(gen, (b, n, n), -0.5, 0.5) for n in sides[1:]]
    amp = torch.ones_like(rough)
    for noise in details:
        n = noise.shape[-1]
        field = F.interpolate(field[:, None], size=(n, n), mode="bilinear", align_corners=False)[:, 0]
        amp = amp * rough
        field = field + amp[:, None, None] * noise
    lo, hi = torch.amin(field, dim=(1, 2), keepdim=True), torch.amax(field, dim=(1, 2), keepdim=True)
    return (field - lo) / torch.clamp_min(hi - lo, 1e-6)


def sample(gen: torch.Generator, cfg: dict, b: int, h: int, w: int) -> dict:
    """Every draw of one 5-channel square batch, in the pipeline's order:
    donor indices, affine parameters, then the chain's scalars and fields."""
    dev = gen.device
    offsets = torch.randint(1, b, (b,), generator=gen, device=dev)
    donor = (torch.arange(b, device=dev) + offsets) % b
    affine = {
        "angle": _uniform(gen, (b,), -cfg["degrees"], cfg["degrees"]),
        "tx": _uniform(gen, (b,), -cfg["translate"][0], cfg["translate"][0]) * w,
        "ty": _uniform(gen, (b,), -cfg["translate"][1], cfg["translate"][1]) * h,
        "scale": _uniform(gen, (b,), cfg["scale"][0], cfg["scale"][1]),
    }
    sh = _uniform(gen, (b, 2), -cfg["shear"], cfg["shear"])
    affine.update(shear_x=sh[:, 0], shear_y=sh[:, 1], applied=_bernoulli(gen, 0.5, (b,)))

    def erase_rect(scale, ratio):
        applied = _bernoulli(gen, 0.5, (b,))
        area = _uniform(gen, (b,), scale[0], scale[1]) * (h * w)
        aspect = _uniform(gen, (b,), ratio[0], ratio[1])
        rh = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, h)
        rw = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, w)
        top = torch.floor(_uniform(gen, (b,)) * (h - rh + 1))
        left = torch.floor(_uniform(gen, (b,)) * (w - rw + 1))
        return torch.stack([applied.float(), top, left, rh, rw], dim=-1)

    erase1 = erase_rect((0.02, 0.1), (2.0, 3.0))
    erase2 = erase_rect((0.02, 0.05), (0.8, 1.2))
    r_gain, b_gain = _blackbody_gains(_uniform(gen, (b,), 3000.0, 15000.0))
    on = _bernoulli(gen, 0.5, (b,))
    r_gain, b_gain = torch.where(on, r_gain, 1.0), torch.where(on, b_gain, 1.0)
    f_b = _uniform(gen, (b,), 1 - cfg["brightness"], 1 + cfg["brightness"])
    f_c = _uniform(gen, (b,), 1 - cfg["contrast"], 1 + cfg["contrast"])
    f_s = _uniform(gen, (b,), 1 - cfg["saturation"], 1 + cfg["saturation"])
    f_h = _uniform(gen, (b,), -cfg["hue"], cfg["hue"])
    sigma = _uniform(gen, (b,), 3.0, 8.0)
    blur_on = _bernoulli(gen, 0.5, (b,)).float()
    taps = _blur_taps(sigma)
    size = 1 << int(math.ceil(math.log2(max(h, w))))
    rough = _uniform(gen, (b,), 0.1, 0.7)
    intensity = _uniform(gen, (b,), -1.0, 0.0)
    quantity = _uniform(gen, (b,), 0.0, 1.0)
    shadow_on = _bernoulli(gen, 0.5, (b,))
    plasma = _plasma(gen, rough, b, size)[:, :h, :w]
    intensity = intensity * shadow_on
    p_bias = cfg["p_bias"]
    keep = _bernoulli(gen, 1.0 - p_bias, (b, h, w))
    u = _uniform(gen, (b, h, w), -1.0, 1.0)
    add = cfg["dev_bias"] * (keep / (1.0 - p_bias)) * u
    add = add + cfg["std_gaussian_noise"] * torch.randn((b, h, w), generator=gen, device=dev)
    keep_n = _bernoulli(gen, 1.0 - cfg["p_near_plane"], (b, h, w))
    near = cfg["dev_near_plane"] * (keep_n / max(1.0 - cfg["p_near_plane"], 1e-6)) * _uniform(gen, (b, h, w), -1.0, 1.0)
    keep_f = _bernoulli(gen, 1.0 - cfg["p_far_plane"], (b, h, w))
    far = cfg["dev_far_plane"] * (keep_f / max(1.0 - cfg["p_far_plane"], 1e-6)) * _uniform(gen, (b, h, w), -1.0, 1.0)
    depth = torch.tensor(
        [cfg["cube_scale"], cfg["scaled_near_plane_mean"], cfg["near_value"], cfg["scaled_far_plane_mean"], cfg["far_value"]],
        dtype=torch.float32, device=dev,
    ).expand(b, 5)
    cols = [f[:, None] for f in (r_gain, b_gain, f_b, f_c, f_s, f_h, blur_on)]
    scalars = torch.cat([erase1, erase2, *cols, taps, intensity[:, None], quantity[:, None], depth], dim=-1)
    # the fields travel as bf16 in the configuration
    fields = torch.stack([add, near, far], dim=1).to(torch.bfloat16).float()
    return {"donor": donor, "affine": affine, "scalars": scalars, "fields": fields, "plasma": plasma.to(torch.bfloat16).float()}


def affine_matrices(p: dict, h: int, w: int) -> torch.Tensor:
    """(B, 3, 3) forward maps about the image centre: translate, rotate and
    scale, shear; identity where not applied."""
    a, sx, sy, s = torch.deg2rad(p["angle"]), torch.deg2rad(p["shear_x"]), torch.deg2rad(p["shear_y"]), p["scale"]
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ca, sa = torch.cos(a) * s, torch.sin(a) * s
    tx, ty = torch.tan(sx), torch.tan(sy)
    m00, m01 = ca - sa * ty, ca * tx - sa
    m10, m11 = sa + ca * ty, sa * tx + ca
    t0 = p["tx"] + cx - (m00 * cx + m01 * cy)
    t1 = p["ty"] + cy - (m10 * cx + m11 * cy)
    z, o = torch.zeros_like(m00), torch.ones_like(m00)
    mats = torch.stack([torch.stack([m00, m01, t0], -1), torch.stack([m10, m11, t1], -1), torch.stack([z, z, o], -1)], -2)
    return torch.where(p["applied"][:, None, None], mats, torch.eye(3, device=mats.device).expand_as(mats))


def _warp_params(mats):
    """Inverse map split into two passes: (swap (B,), (i00, i01, t0, p, q, r))."""
    a00, a01, t0 = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    a10, a11, t1 = mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2]
    det = a00 * a11 - a01 * a10
    i00, i01, i10, i11 = a11 / det, -a01 / det, -a10 / det, a00 / det
    j0, j1 = -(i00 * t0 + i01 * t1), -(i10 * t0 + i11 * t1)
    swap = torch.abs(i00) < torch.abs(i10)
    i00, i10 = torch.where(swap, i10, i00), torch.where(swap, i00, i10)
    i01, i11 = torch.where(swap, i11, i01), torch.where(swap, i01, i11)
    j0, j1 = torch.where(swap, j1, j0), torch.where(swap, j0, j1)
    p = i10 / i00
    return swap, (i00, i01, j0, p, i11 - p * i01, j1 - p * j0)


def _warp(planes, params, h, w):
    i00, i01, t0, p, q, r = (x[:, None, None] for x in params)
    ys = torch.arange(h, dtype=torch.float32, device=i00.device)
    xs = torch.arange(w, dtype=torch.float32, device=i00.device)
    rho_t = q * ys[None, None, :] + p * xs[None, :, None] + r  # (B, W, H)
    gam = i01 * ys[None, :, None] + i00 * xs[None, None, :] + t0  # (B, H, W)

    def taps(idx, n):
        f0 = torch.floor(idx)
        fr = idx - f0
        i = f0.long()
        w0 = ((i >= 0) & (i < n)).float() * (1 - fr)
        w1 = ((i + 1 >= 0) & (i + 1 < n)).float() * fr
        return i.clamp(0, n - 1), (i + 1).clamp(0, n - 1), w0, w1

    v0, v1, vw0, vw1 = taps(rho_t, h)
    h0, h1, hw0, hw1 = taps(gam, w)
    out = []
    for pl in planes:
        pt = pl.transpose(1, 2)
        inter = (torch.gather(pt, 2, v0) * vw0 + torch.gather(pt, 2, v1) * vw1).transpose(1, 2)
        out.append(torch.gather(inter, 2, h0) * hw0 + torch.gather(inter, 2, h1) * hw1)
    return out


def _hsv_to_rgb(hh, s, v):
    h6 = hh * 6.0
    i = torch.floor(h6)
    f = h6 - i
    pp, qq, tt = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def sel(vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return sel([v, qq, pp, pp, tt, v]), sel([tt, v, v, qq, pp, pp]), sel([pp, pp, tt, v, v, qq])


def _hue(r, g, b, shift):
    maxc = torch.maximum(torch.maximum(r, g), b)
    delta = maxc - torch.minimum(torch.minimum(r, g), b)
    sd = torch.where(delta == 0, 1.0, delta)
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, 1.0), 0.0)
    hh = torch.where(
        (r >= g) & (r >= b), torch.remainder((g - b) / sd, 6.0),
        torch.where((g > r) & (g >= b), (b - r) / sd + 2.0, (r - g) / sd + 4.0),
    ) / 6.0
    hh = torch.remainder(torch.where(delta == 0, 0.0, hh) + shift, 1.0)
    return _hsv_to_rgb(hh, s, maxc)


def _blur(x, taps):
    h, w = x.shape[-2:]

    def reflect(n):
        i = torch.arange(-2, n + 2, device=x.device)
        i = torch.where(i < 0, -i, i)
        return torch.where(i >= n, 2 * (n - 1) - i, i)

    p = x[..., reflect(h), :]
    acc = 0
    for i in range(5):
        acc = acc + taps[i] * p[..., i : i + h, :]
    p = acc[..., reflect(w)]
    out = 0
    for i in range(5):
        out = out + taps[i] * p[..., i : i + w]
    return out


def _chain(planes, d):
    sv, fields, plasma = d["scalars"], d["fields"], d["plasma"]
    h, w = planes[0].shape[-2:]
    k = lambda i: sv[:, i, None, None]  # noqa: E731
    ys = torch.arange(h, dtype=torch.float32, device=sv.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=sv.device)[None, :]

    def erased(o):
        inside = (ys >= k(o + 1)) & (ys < k(o + 1) + k(o + 3)) & (xs >= k(o + 2)) & (xs < k(o + 2) + k(o + 4))
        return inside & (k(o) > 0.5)

    mask = erased(0) | erased(5)
    planes = [torch.where(mask, 0.0, p) for p in planes]
    clip = lambda x: torch.clamp(x, 0.0, 1.0)  # noqa: E731
    r, g, b = planes[:3]
    r, g, b = clip(clip(r * k(10)) * k(12)), clip(g * k(12)), clip(clip(b * k(11)) * k(12))
    mean = torch.mean(r * 0.299 + g * 0.587 + b * 0.114, dim=(1, 2), keepdim=True)
    r, g, b = (clip(k(13) * x + (1 - k(13)) * mean) for x in (r, g, b))
    gray = r * 0.299 + g * 0.587 + b * 0.114
    r, g, b = (clip(k(14) * x + (1 - k(14)) * gray) for x in (r, g, b))
    hr, hg, hb = _hue(r, g, b, k(15))
    r, g, b = (torch.where(k(15) == 0.0, x, clip(y)) for x, y in ((r, hr), (g, hg), (b, hb)))
    taps = [k(17 + i) for i in range(5)]
    r, g, b = (torch.where(k(16) > 0.5, _blur(x, taps), x) for x in (r, g, b))
    shade = k(22) * (plasma < k(23)).float()
    out = [clip(r + shade), clip(g + shade), clip(b + shade)]
    cs = k(24)
    scaled = cs * planes[3] + fields[:, 0]
    scaled = torch.where(scaled < k(25) + fields[:, 1], k(26), scaled)
    scaled = torch.where(scaled > k(27) + fields[:, 2], k(28), scaled)
    return out + [scaled / cs] + planes[4:]


def apply(images: torch.Tensor, coords: torch.Tensor, d: dict, lb: float = 0.02, ub: float = 0.7):
    """(augmented f32 images (B, 5, H, W), keypoints normalized to [-1, 1]
    (B, K, 2)) of f32 ``images`` and pixel ``coords`` under draws ``d``."""
    _, c, h, w = images.shape
    planes = [images[:, i] for i in range(c)]
    donor = [p[d["donor"]] for p in planes]
    acc_cube, donor_cube = planes[4] == 1.0, donor[4] == 1.0
    accf = acc_cube.float()
    mask = ((~acc_cube) | ((donor[3] * accf) < (planes[3] * accf))) & ~donor_cube
    new = [torch.where(mask, donor[i], planes[i]) for i in range(4)]
    new_seg = torch.where(donor_cube & ~acc_cube, 0.0, 1.0 - mask.float())
    ratio = (new_seg.sum(dim=(1, 2)) / (h * w))[:, None, None]
    ok = (ratio >= lb) & (ratio <= ub)
    planes = [torch.where(ok, n, o) for n, o in zip(new + [new_seg], planes)]
    mats = affine_matrices(d["affine"], h, w)
    swap, params = _warp_params(mats)
    planes = [torch.where(swap[:, None, None], p.transpose(1, 2), p) for p in planes]
    out = torch.stack(_chain(_warp(planes, params, h, w), d), dim=1)
    kp = torch.einsum("bij,bkj->bki", mats[:, :2, :2], coords) + mats[:, None, :2, 2]
    kp = torch.stack([kp[..., 0] * (2.0 / (w - 1.0)), kp[..., 1] * (2.0 / (h - 1.0))], -1) - 1.0
    return out, kp
