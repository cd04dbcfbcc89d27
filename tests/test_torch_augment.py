"""Port parity: the fused train-time augmentation (perseus_tpu_torch/augment/)
against the JAX package's, on shared draws.

JAX makes the draws (the tests run it with x64 on: every draw is cast to f32
before the port sees it) and runs its Pallas kernels in interpret mode, as
tests/test_fused_augment.py does; the port runs the plain versions (what its
wrappers take on the CPU). Tolerances, as the JAX package's own tests use
them: atol 2e-6 for fused_apply, 1e-5 for the warped kernels (f32 sums in
another order move a warp tap's blend by a few ulp), and one bf16 ulp
(rtol 2^-7, atol 2^-9) for bf16 storage. The CUDA kernels are held against
the plain versions on the card: tests/test_torch_augment_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu.augment import fused as jfused
from perseus_tpu.augment import ops as jops
from perseus_tpu.augment.pipeline import AugmentationConfig as JAugConfig
from perseus_tpu.augment.pipeline import KeypointAugmentation as JAug
from perseus_tpu_torch.augment import fused, ops
from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
from tests.test_torch_augment_cuda import AFFINE_SWEEP

B, S = 4, 48
BF16_TOL = dict(rtol=2**-7, atol=2**-9)


def _t(x):
    """A JAX array as a torch tensor: floats f32, bools and ints as they are."""
    x = np.asarray(x)
    return torch.from_numpy(np.array(x, np.float32) if x.dtype.kind == "f" else np.array(x))


def _nchw(x_nhwc, dtype=torch.float32):
    return torch.from_numpy(np.array(x_nhwc, np.float32)).permute(0, 3, 1, 2).contiguous().to(dtype)


def _nhwc(x):
    return x.float().permute(0, 2, 3, 1).numpy()


def _port_params(p):
    return {
        "scalars": _t(p["scalars"]),
        "fields": _t(p["fields"].astype(jnp.float32)).to(torch.bfloat16),
        "plasma": _t(p["plasma"].astype(jnp.float32)).to(torch.bfloat16),
    }


def _images(c, seed, h=S, w=S):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, h, w, c)).astype(np.float32)
    if c > 3:
        x[..., 3] = rng.uniform(3.0, 14.0, (B, h, w))
    if c > 4:
        x[..., 4] = rng.uniform(0, 1, (B, h, w)) < 0.4
        x[0, ..., 4] = x[1, ..., 4] = 0.0  # image 0 with donor 1: no cube anywhere -> rejected
    return x


def _warp_setup(h=S, w=S):
    """Affine draws with one image at 90 degrees (the swap branch) and the
    rest small rotations."""
    aff = jops.sample_affine_params(jax.random.key(3), B, h, w, degrees=90.0, translate=(0.1, 0.1), scale=(0.9, 1.5), shear=0.1)
    aff = dict(aff, angle=jnp.asarray([10.0, 90.0, -30.0, 84.0], jnp.float32), applied=jnp.ones(B, bool))
    aff = {k: jnp.asarray(v, jnp.float32) if k != "applied" else v for k, v in aff.items()}
    mats = jops.affine_matrices(aff, h, w)
    return jops._invert_affine(mats)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 4, 5, 6])
def test_fused_apply_plain_matches_jax(c, storage):
    jdt, tdt = (jnp.float32, torch.float32) if storage == "f32" else (jnp.bfloat16, torch.bfloat16)
    x = _images(c, seed=c)
    p = jfused.sample_fused_params(jax.random.key(c), JAugConfig(), B, S, S, c)
    ref = np.asarray(jfused.fused_apply(jnp.asarray(x).astype(jdt), p, interpret=True).astype(jnp.float32))
    out = fused.fused_apply(_nchw(x, tdt), _port_params(p))
    assert out.dtype == tdt and out.shape == (B, c, S, S)
    np.testing.assert_allclose(_nhwc(out), ref, **(dict(atol=2e-6) if storage == "f32" else BF16_TOL))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 4, 5, 6])
def test_fused_warp_apply_plain_matches_jax(c, storage):
    jdt, tdt = (jnp.float32, torch.float32) if storage == "f32" else (jnp.bfloat16, torch.bfloat16)
    x = _images(c, seed=10 + c)
    p = jfused.sample_fused_params(jax.random.key(10 + c), JAugConfig(), B, S, S, c)
    images_sw, parts = jops._two_pass_setup(jnp.asarray(x).astype(jdt), _warp_setup())
    wp = jnp.stack(parts, axis=-1).astype(jnp.float32)
    ref = np.asarray(jfused.fused_warp_apply(images_sw, wp, p, interpret=True).astype(jnp.float32))
    out = fused.fused_warp_apply(_nchw(np.asarray(images_sw.astype(jnp.float32)), tdt), _t(wp), _port_params(p))
    np.testing.assert_allclose(_nhwc(out), ref, **(dict(atol=1e-5) if storage == "f32" else BF16_TOL))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_fused_ultra_apply_plain_matches_jax(storage):
    """Transplant + swap + warp + chain, with a swapped image and a rejected
    transplant in the batch."""
    jdt, tdt = (jnp.float32, torch.float32) if storage == "f32" else (jnp.bfloat16, torch.bfloat16)
    x = _images(5, seed=20)
    p = jfused.sample_fused_params(jax.random.key(20), JAugConfig(), B, S, S, 5)
    swap, parts = jops._two_pass_params(_warp_setup())
    assert np.asarray(swap).any() and not np.asarray(swap).all()
    donor = jnp.asarray([1, 2, 3, 0], jnp.int32)
    wp = jnp.stack(parts, axis=-1).astype(jnp.float32)
    xj = jnp.asarray(x).astype(jdt)
    ref = np.asarray(jfused.fused_ultra_apply(xj, donor, swap, wp, p, interpret=True).astype(jnp.float32))
    out = fused.fused_ultra_apply(_nchw(x, tdt), _t(donor), _t(swap), _t(wp), _port_params(p))
    np.testing.assert_allclose(_nhwc(out), ref, **(dict(atol=1e-5) if storage == "f32" else BF16_TOL))
    # image 0's transplant is rejected (its candidate seg is empty): its seg
    # channel is its own, warped, not the candidate's zeros
    cand = jops.transplant_with_depth(None, jnp.asarray(x), donor_idx=donor)
    assert np.array_equal(np.asarray(cand[0]), x[0]) and not np.array_equal(np.asarray(cand[2]), x[2])
    port_cand = ops.transplant_with_depth(_nchw(x), _t(donor))
    np.testing.assert_array_equal(_nhwc(port_cand), np.asarray(cand))


@pytest.mark.parametrize("part", [0, 1])
def test_fused_ultra_apply_plain_matches_jax_over_affine_extremes(part):
    """The plain ultra version against JAX's kernel over the affine sweep
    the CUDA kernel is checked at on the card, in two batches of B, each
    with image 0's transplant rejected (the batch shape of
    test_fused_ultra_apply_plain_matches_jax, so JAX compiles nothing new)."""
    rows = np.asarray(AFFINE_SWEEP[B * part : B * part + B], np.float32).T
    aff = dict(angle=rows[0], scale=rows[1], shear_x=rows[2], shear_y=rows[3], tx=rows[4] * S, ty=rows[5] * S)
    aff = {k: jnp.asarray(v, jnp.float32) for k, v in aff.items()} | {"applied": jnp.ones(B, bool)}
    swap, parts = jops._two_pass_params(jops._invert_affine(jops.affine_matrices(aff, S, S)))
    x = _images(5, seed=30 + part)
    p = jfused.sample_fused_params(jax.random.key(30 + part), JAugConfig(), B, S, S, 5)
    donor = jnp.asarray([1, 2, 3, 0], jnp.int32)
    wp = jnp.stack(parts, axis=-1).astype(jnp.float32)
    ref = np.asarray(jfused.fused_ultra_apply(jnp.asarray(x), donor, swap, wp, p, interpret=True))
    out = fused.fused_ultra_apply(_nchw(x), _t(donor), _t(swap), _t(wp), _port_params(p))
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-5)


def test_augment_helpers_match_jax():
    rng = np.random.default_rng(4)
    temps = rng.uniform(3000, 15000, 64).astype(np.float32)
    for a, b in zip(ops._blackbody_gains(torch.from_numpy(temps)), jops._blackbody_gains(jnp.asarray(temps))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6)
    aff = jops.sample_affine_params(jax.random.key(8), 6, 40, 56)
    aff = {k: jnp.asarray(v, jnp.float32) if k != "applied" else v for k, v in aff.items()}
    mats = jops.affine_matrices(aff, 40, 56)
    tm = ops.affine_matrices({k: _t(v) for k, v in aff.items()}, 40, 56)
    np.testing.assert_allclose(tm.numpy(), np.asarray(mats), rtol=1e-6, atol=1e-5)
    inv = jops._invert_affine(mats)
    tinv = ops._invert_affine(_t(mats))
    np.testing.assert_allclose(tinv.numpy(), np.asarray(inv), rtol=1e-6, atol=1e-5)
    swap, parts = jops._two_pass_params(inv)
    tswap, tparts = ops._two_pass_params(_t(inv))
    np.testing.assert_array_equal(tswap.numpy(), np.asarray(swap))
    for a, b in zip(tparts, parts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)
    coords = rng.uniform(0, 40, (6, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(
        ops.transform_keypoints(torch.from_numpy(coords), _t(mats)).numpy(),
        np.asarray(jops.transform_keypoints(jnp.asarray(coords), mats)), rtol=1e-6, atol=1e-4,
    )


def test_plasma_fractal_matches_jax_on_its_draws():
    b, size = 3, 64
    key = jax.random.key(6)
    rough = jnp.asarray([0.1, 0.4, 0.7], jnp.float32)
    ref = np.asarray(jops._plasma_fractal(key, b, size, rough))
    keys = jax.random.split(key, int(np.log2(size)) + 1)
    sides = ops._plasma_levels(size)
    draws = [_t(jax.random.uniform(keys[0], (b, 2, 2)))] + [
        _t(jax.random.uniform(keys[i], (b, n, n), minval=-0.5, maxval=0.5)) for i, n in enumerate(sides[1:], 1)
    ]
    out = ops._plasma_fractal(_t(rough), draws)
    assert out.shape == (b, size, size)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def _jax_draws(key, cfg, b, h, w, c):
    """The draws JAX's KeypointAugmentation.__call__ makes from ``key``:
    keys[0] donor, keys[1] affine, keys[2] fused params."""
    keys = jax.random.split(key, 10)
    aff = jops.sample_affine_params(
        keys[1], b, h, w, degrees=cfg.degrees, translate=cfg.translate, scale=cfg.scale, shear=cfg.shear
    )
    return {
        "donor_idx": _t(jops.sample_donor_indices(keys[0], b)),
        "affine": {k: _t(v) for k, v in aff.items()},
        "fused": _port_params(jfused.sample_fused_params(keys[2], cfg, b, h, w, c)),
    }


@pytest.mark.parametrize(
    "branch, c, h, w, train",
    [
        ("ultra", 5, S, S, True),
        ("warp", 4, S, S, True),
        ("chain", 5, 40, 56, True),  # transplant + gather warp + chain kernel
        ("val", 5, S, S, False),
    ],
)
def test_pipeline_apply_matches_jax_call(branch, c, h, w, train):
    cfg = JAugConfig()
    x = _images(c, seed=30 + c, h=h, w=w)
    coords = np.random.default_rng(c).uniform(2, min(h, w) - 3, (B, 8, 2)).astype(np.float32)
    key = jax.random.key(31)
    # JAX without x64 here: its pipeline draws in the default float dtype,
    # and the affine's f64 draws would move warp taps by ~1e-5 px, which on
    # depth (values 3-14) is above the tolerance
    with jax.enable_x64(False):
        ref_img, ref_crd = JAug(cfg, train=train, fused=True)(key, jnp.asarray(x), jnp.asarray(coords))
        draws = _jax_draws(key, cfg, B, h, w, c) if train else {}
    aug = KeypointAugmentation(AugmentationConfig(), train=train)
    out_img, out_crd = aug.apply(_nchw(x), torch.from_numpy(coords), draws)
    assert out_crd.shape == (B, 8, 2)
    np.testing.assert_allclose(_nhwc(out_img), np.asarray(ref_img, np.float32), atol=1e-5)
    np.testing.assert_allclose(out_crd.numpy(), np.asarray(ref_crd, np.float32), atol=1e-5)


def test_sample_fused_params_layout_ranges_and_seed():
    cfg = AugmentationConfig()
    b, h, w = 64, 32, 40
    p = fused.sample_fused_params(torch.Generator().manual_seed(0), cfg, b, h, w, 5)
    sv, fields, plasma = p["scalars"], p["fields"], p["plasma"]
    assert sv.shape == (b, fused.N_SCALARS) and sv.dtype == torch.float32
    assert fields.shape == (b, 3, h, w) and fields.dtype == torch.bfloat16
    assert plasma.shape == (b, h, w) and plasma.dtype == torch.bfloat16
    for o in (0, 5):  # erase rects: applied flag, inside the image
        assert set(sv[:, o].tolist()) <= {0.0, 1.0}
        assert (sv[:, o + 3] >= 1).all() and (sv[:, o + 1] + sv[:, o + 3] <= h).all()
        assert (sv[:, o + 4] >= 1).all() and (sv[:, o + 2] + sv[:, o + 4] <= w).all()
    assert (sv[:, 10] > 0).all() and (sv[:, 11] >= 0).all()
    assert ((sv[:, 12] >= 0.8) & (sv[:, 12] <= 1.2)).all() and ((sv[:, 13] >= 0.6) & (sv[:, 13] <= 1.4)).all()
    assert ((sv[:, 14] >= 0.6) & (sv[:, 14] <= 1.4)).all() and (sv[:, 15].abs() <= 0.025).all()
    assert set(sv[:, 16].tolist()) == {0.0, 1.0}
    torch.testing.assert_close(sv[:, 17:22].sum(-1), torch.ones(b))
    assert ((sv[:, 22] >= -1) & (sv[:, 22] <= 0)).all() and ((sv[:, 23] >= 0) & (sv[:, 23] <= 1)).all()
    torch.testing.assert_close(sv[:, 24:], torch.tensor([[0.035, 0.1, 0.0, 0.5, 0.0]]).expand(b, 5))
    assert plasma.min() >= 0 and plasma.max() <= 1
    assert fields[:, 1:].abs().max() <= 0.1 + 1e-3 and (fields[:, 1:] == 0).any()
    # reproducible from the seed, and different for another seed
    again = fused.sample_fused_params(torch.Generator().manual_seed(0), cfg, b, h, w, 5)
    other = fused.sample_fused_params(torch.Generator().manual_seed(1), cfg, b, h, w, 5)
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert not torch.equal(p["scalars"], other["scalars"])
    # RGB only: no depth fields, the depth planes disabled
    rgb = fused.sample_fused_params(torch.Generator().manual_seed(0), cfg, b, h, w, 3)
    assert (rgb["fields"] == 0).all() and rgb["scalars"][0, 25] == -np.inf and rgb["scalars"][0, 27] == np.inf


def test_pipeline_call_on_cpu_is_seeded_and_finite():
    aug = KeypointAugmentation(AugmentationConfig())
    x = _nchw(_images(5, seed=40))
    coords = torch.from_numpy(np.random.default_rng(40).uniform(2, 45, (B, 16)).astype(np.float32))
    a_img, a_crd = aug(torch.Generator().manual_seed(3), x, coords)
    b_img, b_crd = aug(torch.Generator().manual_seed(3), x, coords)
    assert a_img.shape == x.shape and a_crd.shape == (B, 16)
    assert torch.isfinite(a_img).all() and torch.equal(a_img, b_img) and torch.equal(a_crd, b_crd)
    assert set(aug.sample(torch.Generator(), B, S, S, 5)) == {"donor_idx", "affine", "fused"}
    assert KeypointAugmentation(AugmentationConfig(), train=False).sample(torch.Generator(), B, S, S, 5) == {}


def test_kernel_wrappers_refuse_other_devices():
    p = fused.sample_fused_params(torch.Generator().manual_seed(0), AugmentationConfig(), 1, 8, 8, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_apply(torch.empty((1, 4, 8, 8), device="meta"), p)
    before = fused.fused_apply.launches
    fused.fused_apply(torch.rand(1, 4, 8, 8), p)  # the CPU takes the plain version, uncounted
    assert fused.fused_apply.launches == before
