"""Port parity: the unfused train-time augmentation (perseus_tpu_torch/augment/
ops.py, warp.py and KeypointAugmentation(fused=False)) against the JAX
package's, on JAX's draws.

JAX runs with x64 off here (``jax.enable_x64(False)``), so that its ops
compute in f32 as they do in training (with x64 on, ``keep / (1 - p)`` and
the default-dtype draws would be f64). The port's deterministic functions
get the values each ``jax.random`` call of the JAX op returned. JAX's
two-pass warp is its Pallas kernel in interpret mode (``method="pallas"``);
the port's is the plain version its wrapper takes on the CPU (the CUDA
kernel is held against it on the card: tests/test_torch_augment_cuda.py
and chip_smoke.py). Tolerances: atol 1e-6 per op (f32, the same
arithmetic; sums such as the mean gray in another order); 1e-5 for the
warp and the pipeline, as tests/test_torch_augment.py (f32 sums in another
order move a warp tap's blend by a few ulp); one bf16 ulp (rtol 2^-7, atol
2^-9) for bf16 storage; exact at the identity affine.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu.augment import fused as jfused
from perseus_tpu.augment import ops as jops
from perseus_tpu.augment.pipeline import AugmentationConfig as JAugConfig
from perseus_tpu.augment.pipeline import KeypointAugmentation as JAug
from perseus_tpu_torch.augment import fused, ops, warp
from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation

B, S = 4, 32
BF16_TOL = dict(rtol=2**-7, atol=2**-9)


def _t(x):
    """A JAX array as a torch tensor: floats f32, bools and ints as they are."""
    x = np.asarray(x)
    return torch.from_numpy(np.array(x, np.float32) if x.dtype.kind == "f" else np.array(x))


def _nchw(x_nhwc, dtype=torch.float32):
    return torch.from_numpy(np.array(x_nhwc, np.float32)).permute(0, 3, 1, 2).contiguous().to(dtype)


def _nhwc(x):
    return x.float().permute(0, 2, 3, 1).numpy()


def _images(c, seed, h=S, w=S):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, h, w, c)).astype(np.float32)
    if c > 3:
        x[..., 3] = rng.uniform(3.0, 14.0, (B, h, w))
    if c > 4:
        x[..., 4] = rng.uniform(0, 1, (B, h, w)) < 0.4
    x[:, :4, :4, :3] = 1.0  # bright corner: clipped channels, hue ties
    return x


def _uni(key, shape, lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


# The draws of each JAX op, from the key it is given, in the port's dict
# layout (ops.sample_*). ``shape`` is the depth plane's (B, H, W).
def _erase_draws(key, b, scale, ratio, p=0.5):
    ks = jax.random.split(key, 5)
    return {
        "applied": _t(jax.random.bernoulli(ks[0], p, (b,))),
        "area": _t(_uni(ks[1], (b,), *scale)),
        "aspect": _t(_uni(ks[2], (b,), *ratio)),
        "u_top": _t(_uni(ks[3], (b,))),
        "u_left": _t(_uni(ks[4], (b,))),
    }


def _planckian_draws(key, b):
    k1, k2 = jax.random.split(key)
    return {"temp": _t(_uni(k1, (b,), 3000.0, 15000.0)), "applied": _t(jax.random.bernoulli(k2, 0.5, (b,)))}


def _jiggle_draws(key, b, cfg):
    ks = jax.random.split(key, 4)
    four = (b, 1, 1, 1)  # the JAX op's draw shapes; the same values as (b,)
    return {
        "brightness": _t(_uni(ks[0], four, 1 - cfg.brightness, 1 + cfg.brightness)).reshape(b),
        "contrast": _t(_uni(ks[1], four, 1 - cfg.contrast, 1 + cfg.contrast)).reshape(b),
        "saturation": _t(_uni(ks[2], four, 1 - cfg.saturation, 1 + cfg.saturation)).reshape(b),
        "hue": _t(_uni(ks[3], (b,), -cfg.hue, cfg.hue)),
    }


def _blur_draws(key, b):
    k1, k2 = jax.random.split(key)
    return {"sigma": _t(_uni(k1, (b,), 3.0, 8.0)), "applied": _t(jax.random.bernoulli(k2, 0.5, (b,)))}


def _plasma_draws(key, b, h, w):
    ks = jax.random.split(key, 5)
    size = 1 << int(np.ceil(np.log2(max(h, w))))
    keys = jax.random.split(ks[4], int(np.log2(size)) + 1)
    sides = ops._plasma_levels(size)
    return {
        "roughness": _t(_uni(ks[0], (b,), 0.1, 0.7)),
        "intensity": _t(_uni(ks[1], (b,), -1.0, 0.0)),
        "quantity": _t(_uni(ks[2], (b,), 0.0, 1.0)),
        "applied": _t(jax.random.bernoulli(ks[3], 0.5, (b,))),
        "noise": [_t(_uni(keys[0], (b, 2, 2)))]
        + [_t(_uni(keys[i], (b, n, n), -0.5, 0.5)) for i, n in enumerate(sides[1:], 1)],
    }


def _bias_draws(key, shape, p):
    k_keep, k_u = jax.random.split(key)
    return {
        "keep": _t(jax.random.bernoulli(k_keep, 1.0 - p, shape)),
        "u": _t(jax.random.uniform(k_u, shape, dtype=jnp.float32, minval=-1.0, maxval=1.0)),
    }


def _plane_draws(key, shape, p_near, p_far):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = lambda k: _t(jax.random.uniform(k, shape, dtype=jnp.float32, minval=-1.0, maxval=1.0))  # noqa: E731
    return {
        "keep_near": _t(jax.random.bernoulli(k1, 1.0 - p_near, shape)),
        "u_near": u(k2),
        "keep_far": _t(jax.random.bernoulli(k3, 1.0 - p_far, shape)),
        "u_far": u(k4),
    }


def _op_case(name, key, x):
    """(JAX's output as NHWC / (B, H, W) numpy, the port's output) of one op."""
    cfg = JAugConfig()
    b, h, w, _ = x.shape
    rgb, depth = jnp.asarray(x[..., :3]), jnp.asarray(x[..., 3])
    t_rgb, t_depth = _nchw(x[..., :3]), torch.from_numpy(x[..., 3].copy())
    if name == "erasing":
        ref = jops.random_erasing(key, jnp.asarray(x), p=0.5, scale=(0.02, 0.1), ratio=(2.0, 3.0))
        return ref, _nhwc(ops.random_erasing(_nchw(x), _erase_draws(key, b, (0.02, 0.1), (2.0, 3.0))))
    if name == "planckian":
        return jops.planckian_jitter(key, rgb), _nhwc(ops.planckian_jitter(t_rgb, _planckian_draws(key, b)))
    if name == "jiggle":
        ref = jops.color_jiggle(key, rgb, cfg.brightness, cfg.contrast, cfg.saturation, cfg.hue)
        return ref, _nhwc(ops.color_jiggle(t_rgb, _jiggle_draws(key, b, cfg)))
    if name == "blur":
        return jops.gaussian_blur_5x5(key, rgb), _nhwc(ops.gaussian_blur_5x5(t_rgb, _blur_draws(key, b)))
    if name == "plasma":
        return jops.plasma_shadow(key, rgb), _nhwc(ops.plasma_shadow(t_rgb, _plasma_draws(key, b, h, w)))
    if name == "depth_bias":
        ref = jops.depth_bias(key, depth, dev=cfg.dev_bias, p=cfg.p_bias, cube_scale=cfg.cube_scale)
        return ref, ops.depth_bias(t_depth, _bias_draws(key, (b, h, w), cfg.p_bias), cfg.dev_bias, cfg.p_bias).numpy()
    if name == "depth_noise":
        ref = jops.depth_gaussian_noise(key, depth, std=cfg.std_gaussian_noise)
        draws = {"noise": _t(jax.random.normal(key, (b, h, w), dtype=jnp.float32))}
        return ref, ops.depth_gaussian_noise(t_depth, draws, std=cfg.std_gaussian_noise).numpy()
    raise ValueError(name)


@pytest.mark.parametrize(
    "name", ["erasing", "planckian", "jiggle", "blur", "plasma", "depth_bias", "depth_noise"]
)
def test_unfused_op_matches_jax_on_its_draws(name):
    # the non-square pipeline case's shape: JAX compiles each op's
    # primitives once for both (eager JAX compiles per shape)
    x = _images(5, seed=1, h=40, w=56)
    with jax.enable_x64(False):
        ref, out = _op_case(name, jax.random.key(7), x)
        ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    if name in ("erasing", "blur", "plasma", "planckian"):
        assert not np.allclose(ref, x[..., : ref.shape[-1]]), f"{name}: the op changed nothing"


@pytest.mark.parametrize("p_near, p_far", [(0.5, 0.5), (1.0, 0.5), (0.5, 1.0)], ids=["both", "near_off", "far_off"])
def test_depth_plane_matches_jax_with_a_plane_off(p_near, p_far):
    """The JAX pipeline turns a plane off with p = 1 (pipeline.py:255,259).
    keep / (1 - p) is then not 0 / 0 = NaN: XLA folds the division of a
    converted bool into a select, so every deviation is 0 and the plane
    cuts at exactly its mean. The port gives the same."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 18.0, (B, S, S)).astype(np.float32)  # scaled 0.0175-0.63: both planes bite
    key = jax.random.key(9)
    kw = dict(near_mean=0.1, near_dev=0.05, p_near=p_near, near_value=0.0, far_mean=0.5, far_dev=0.05,
              p_far=p_far, far_value=0.0, cube_scale=0.035)
    with jax.enable_x64(False):
        ref = np.asarray(jops.depth_plane(key, jnp.asarray(depth), **kw))
        draws = _plane_draws(key, (B, S, S), p_near, p_far)
    out = ops.depth_plane(torch.from_numpy(depth), draws, **kw).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    scaled = np.float32(0.035) * depth
    if p_near == 1.0:
        assert (out[scaled < np.float32(0.1)] == 0).all()
    if p_far == 1.0:
        assert (out[scaled > np.float32(0.5)] == 0).all()
    assert ((scaled > 0.15) & (scaled < 0.45) & (out != 0)).any()


@pytest.mark.parametrize(
    "pixel",
    [(1.0, 1.0, 0.2), (0.7, 0.3, 0.7), (0.4, 0.4, 0.4), (1.0, 0.2, 1.0), (0.3, 0.9, 0.9), (0.0, 0.0, 0.0)],
    ids=["r=g>b", "r=b>g", "equal", "r=b>g clipped", "g=b>r", "black"],
)
def test_hue_at_channel_ties_matches_jax(pixel):
    """ops._adjust_hue sums the branch of every channel equal to the max; a
    tie gives hr + hg (say), not one branch. The port reproduces that
    exactly, and it is not what the fused chain's _hue_planes gives."""
    shifts = np.asarray([0.01, -0.02, 0.025, -0.001], np.float32)
    rgb = np.broadcast_to(np.asarray(pixel, np.float32), (B, 2, 3, 3)).copy()
    with jax.enable_x64(False):
        ref = np.asarray(jops._adjust_hue(jnp.asarray(rgb), jnp.asarray(shifts)))
    out = _nhwc(ops._adjust_hue(_nchw(rgb), torch.from_numpy(shifts)))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    if pixel == (1.0, 1.0, 0.2):  # the tie that brightness clipping makes common
        np.testing.assert_allclose(out[0, 0, 0], [0.2, 1.0, 0.248], atol=1e-6)
        t = torch.from_numpy(rgb[:1, 0, 0])
        fused_rgb = fused._hue_planes(t[:, 0], t[:, 1], t[:, 2], torch.tensor(0.01))
        np.testing.assert_allclose([v.item() for v in fused_rgb], [0.952, 1.0, 0.2], atol=1e-6)


def _affines(angles, h=S, w=S):
    aff = jops.sample_affine_params(jax.random.key(3), len(angles), h, w, degrees=90.0, shear=10.0)
    aff = {k: jnp.asarray(v, jnp.float32) for k, v in aff.items() if k != "applied"}
    aff = dict(aff, angle=jnp.asarray(angles, jnp.float32), applied=jnp.ones(len(angles), bool))
    return jops.affine_matrices(aff, h, w)


def test_two_pass_warp_matches_jax_pallas_kernel():
    """method="two_pass" on the CPU (the kernel's plain version) against the
    JAX package's Pallas kernel (interpret mode) at rotations to +-90 deg,
    shear 10 deg; a share of the images take the swap transpose."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (B, S, S, 5)).astype(np.float32)
    mats = _affines([15.0, -60.0, 89.0, -90.0])
    swap, _ = jops._two_pass_params(jops._invert_affine(mats))
    assert np.asarray(swap).any() and not np.asarray(swap).all()
    ref = np.asarray(jops.warp_affine_bilinear(jnp.asarray(x), mats, method="pallas"))
    out = ops.warp_affine_bilinear(_nchw(x), _t(mats), method="two_pass")
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-5, rtol=0)
    # "auto" is the two-pass route for square images, the gather otherwise
    assert torch.equal(ops.warp_affine_bilinear(_nchw(x), _t(mats)), out)
    with pytest.raises(ValueError, match="method"):
        ops.warp_affine_bilinear(_nchw(x), _t(mats), method="mxu")


def test_two_pass_warp_is_exact_at_the_identity():
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (B, S, S, 5)).astype(np.float32)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (B, 3, 3))
    ref = np.asarray(jops.warp_affine_bilinear(jnp.asarray(x), eye, method="pallas"))
    out = _nhwc(ops.warp_affine_bilinear(_nchw(x), _t(eye), method="two_pass"))
    np.testing.assert_array_equal(ref, x)
    np.testing.assert_array_equal(out, x)


def _jax_unfused_draws(key, cfg, b, h, w, c):
    """The draws JAX's KeypointAugmentation(fused=False) makes from ``key``:
    keys = split(key, 10): 0 donor, 1 affine, 2-3 erasing, 4 Planckian, 5
    jiggle, 6 blur, 7 plasma, 8 depth bias, 9 depth noise; the planes from
    fold_in(key, 1000)."""
    keys = jax.random.split(key, 10)
    aff = jops.sample_affine_params(
        keys[1], b, h, w, degrees=cfg.degrees, translate=cfg.translate, scale=cfg.scale, shear=cfg.shear
    )
    draws = {
        "affine": {k: _t(v) for k, v in aff.items()},
        "erase1": _erase_draws(keys[2], b, (0.02, 0.1), (2.0, 3.0)),
        "erase2": _erase_draws(keys[3], b, (0.02, 0.05), (0.8, 1.2)),
        "planckian": _planckian_draws(keys[4], b),
        "jiggle": _jiggle_draws(keys[5], b, cfg),
        "blur": _blur_draws(keys[6], b),
        "plasma": _plasma_draws(keys[7], b, h, w),
        "depth_bias": _bias_draws(keys[8], (b, h, w), cfg.p_bias),
        "depth_noise": {"noise": _t(jax.random.normal(keys[9], (b, h, w), dtype=jnp.float32))},
        "depth_plane": _plane_draws(jax.random.fold_in(key, 1000), (b, h, w), cfg.p_near_plane, cfg.p_far_plane),
    }
    if c == 5:
        draws["donor_idx"] = _t(jops.sample_donor_indices(keys[0], b))
    if c == 3:
        draws = {k: v for k, v in draws.items() if not k.startswith("depth")}
    return draws


@pytest.mark.parametrize(
    "c, h, w, storage",
    [(5, S, S, "f32"), (4, S, S, "f32"), (5, 40, 56, "f32"), (5, S, S, "bf16")],
    ids=["c5-two_pass", "c4-two_pass", "c5-gather-40x56", "c5-two_pass-bf16"],
)
def test_unfused_pipeline_matches_jax_call(c, h, w, storage, monkeypatch):
    """KeypointAugmentation(fused=False) against the JAX pipeline's unfused
    chain on its draws. JAX's CPU "auto" warp is the gather; square images
    go through its Pallas two-pass kernel here, the route it takes on the
    TPU and the port's "auto" takes on every device."""
    if h == w:
        monkeypatch.setattr(jops, "warp_affine_bilinear", functools.partial(jops.warp_affine_bilinear, method="pallas"))
    jdt, tdt = (jnp.float32, torch.float32) if storage == "f32" else (jnp.bfloat16, torch.bfloat16)
    cfg = JAugConfig()
    x = _images(c, seed=20 + c, h=h, w=w)
    xj = jnp.asarray(x).astype(jdt)
    coords = np.random.default_rng(c).uniform(2, min(h, w) - 3, (B, 8, 2)).astype(np.float32)
    key = jax.random.key(21)
    with jax.enable_x64(False):
        ref_img, ref_crd = JAug(cfg, train=True, fused=False)(key, xj, jnp.asarray(coords))
        draws = _jax_unfused_draws(key, cfg, B, h, w, c)
    aug = KeypointAugmentation(AugmentationConfig(), fused=False)
    assert set(draws) == set(aug.sample(torch.Generator(), B, h, w, c))
    out_img, out_crd = aug.apply(_nchw(np.asarray(xj.astype(jnp.float32)), tdt), torch.from_numpy(coords), draws)
    assert out_img.dtype == tdt and out_img.shape == (B, c, h, w)
    tol = dict(atol=1e-5, rtol=0) if storage == "f32" else BF16_TOL
    np.testing.assert_allclose(_nhwc(out_img), np.asarray(ref_img.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(out_crd.numpy(), np.asarray(ref_crd, np.float32), atol=1e-5)


def test_unfused_pipeline_is_seeded_finite_and_not_the_fused_one():
    x = _nchw(_images(5, seed=40))
    coords = torch.from_numpy(np.random.default_rng(40).uniform(2, 29, (B, 16)).astype(np.float32))
    aug = KeypointAugmentation(AugmentationConfig(), fused=False)
    a_img, a_crd = aug(torch.Generator().manual_seed(3), x, coords)
    b_img, b_crd = aug(torch.Generator().manual_seed(3), x, coords)
    assert a_img.shape == x.shape and a_crd.shape == (B, 16)
    assert torch.isfinite(a_img).all() and torch.equal(a_img, b_img) and torch.equal(a_crd, b_crd)
    assert not aug.sample(torch.Generator(), B, S, S, 5).keys() & {"fused"}
    assert KeypointAugmentation(AugmentationConfig()).fused and not aug.fused
    # every random stage off: the chain is the identity on the images
    off = AugmentationConfig(**{f: False for f in (
        "random_transplantation_with_depth", "random_affine", "random_erasing", "planckian_jitter",
        "color_jiggle", "blur", "random_plasma_shadow", "random_bias", "depth_gaussian_noise",
        "random_near_plane", "random_far_plane")})
    ident = KeypointAugmentation(off, fused=False)
    assert ident.sample(torch.Generator(), B, S, S, 5) == {}
    assert torch.equal(ident(torch.Generator(), x, coords)[0], x)


def test_two_pass_wrapper_refuses_other_devices():
    wp = torch.zeros((1, 6))
    with pytest.raises(ValueError, match="unsupported device"):
        warp.warp_affine_two_pass(torch.empty((1, 4, 8, 8), device="meta"), torch.zeros(1, dtype=torch.bool), wp)
    before = warp.warp_affine_two_pass.launches
    out = warp.warp_affine_two_pass(torch.rand(1, 4, 8, 8), torch.ones(1, dtype=torch.bool), wp)  # CPU: plain
    assert out.shape == (1, 4, 8, 8) and warp.warp_affine_two_pass.launches == before
