"""The augmentation's CUDA kernels (perseus_tpu_torch/csrc/augment.cu: the
fused chain's three and the two-pass warp) against their plain PyTorch
versions, on the card. The tests marked cuda need a CUDA card and skip
without one; the file imports no JAX, so that the card's machine (which
has none) runs it:

    python -m pytest tests/test_torch_augment_cuda.py -m cuda --noconftest -q

Tolerances: atol 1e-5 in f32 (the kernel's mean-gray sum runs in another
order; the warp's blend as the plain version's, fused multiply-adds off);
one bf16 ulp (rtol 2^-7, atol 2^-9) for bf16 storage; the warp exact at the
identity. The CPU tests here check what the kernels' design rests on: the
source boxes fit the shared-memory budget, the edge columns bound a tile's
taps, and the hue's floor modulos written without fmodf give the same bits
(numpy float32, which rounds every operation once, as the kernels do with
fused multiply-adds off).
"""

import os
import re

import numpy as np
import pytest
import torch

from perseus_tpu_torch.augment import fused, ops, warp
from perseus_tpu_torch.augment.pipeline import AugmentationConfig

BF16_TOL = dict(rtol=2**-7, atol=2**-9)

# (angle deg, forward scale, shear_x deg, shear_y deg, tx, ty as fractions of
# the size): the augmentation config's extremes (degrees 90, scale 0.9-1.5,
# shear 0.1, translate 0.1), images swapped (|angle| > 45) and not, the
# identity, and a zoom-out past the config (scale 0.3) whose tiles' source
# boxes exceed the ultra kernel's shared-memory budget
AFFINE_SWEEP = (
    (90.0, 0.9, 0.1, -0.1, 0.1, -0.1),
    (-90.0, 1.5, -0.1, 0.1, -0.1, 0.1),
    (45.0, 0.9, 0.1, 0.1, 0.1, 0.1),
    (-45.0, 1.5, -0.1, -0.1, -0.1, -0.1),
    (60.0, 1.2, 0.1, -0.1, -0.1, 0.1),
    (-30.0, 0.9, -0.1, 0.1, 0.1, 0.0),
    (0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
    (30.0, 0.3, 0.0, 0.0, 0.0, 0.0),
)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernels_match_plain_versions(storage):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode (run chip_smoke.py on the card)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = AugmentationConfig()
    for c, s in [(5, 64), (4, 37)]:
        x = torch.rand((3, c, s, s), device="cuda", generator=gen)
        if c == 5:
            x[:, 4] = (x[:, 4] > 0.6).float()
        x = x.to(storage)
        p = fused.sample_fused_params(gen, cfg, 3, s, s, c)
        wp = torch.tensor([[0.9, 0.1, 2.0, 0.05, 1.1, -3.0]] * 3, device="cuda")
        calls = [(fused.fused_apply, fused.reference_apply, (x, p)),
                 (fused.fused_warp_apply, fused.fused_warp_reference, (x, wp, p))]
        if c == 5:
            donor = torch.tensor([1, 2, 0], device="cuda")
            swap = torch.tensor([True, False, True], device="cuda")
            calls.append((fused.fused_ultra_apply, fused.fused_ultra_reference, (x, donor, swap, wp, p)))
        for kernel, plain, args in calls:
            before = kernel.launches
            out = kernel(*args)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            tol = dict(atol=1e-5, rtol=0) if storage == torch.float32 else BF16_TOL
            torch.testing.assert_close(out.float(), plain(*args).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_ultra_kernel_over_affine_sweep(storage):
    """The ultra kernel (#6) over AFFINE_SWEEP, one image per affine, with
    swapped and unswapped images, accepted and rejected transplants (image 0
    and its donor carry no cube), at sizes that are not multiples of its
    32-pixel tile; the zoom-out's taps leave the staged box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode (run chip_smoke.py on the card)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    b = len(AFFINE_SWEEP)
    for s in (37, 129):
        x = torch.rand((b, 5, s, s), device="cuda", generator=gen)
        x[:, 3] = 3.0 + 11.0 * x[:, 3]
        x[:, 4] = (x[:, 4] < 0.4).float()
        x[:2, 4] = 0.0
        col = torch.tensor(AFFINE_SWEEP, device="cuda").T
        aff = {"angle": col[0], "scale": col[1], "shear_x": col[2], "shear_y": col[3], "tx": col[4] * s,
               "ty": col[5] * s, "applied": torch.ones(b, dtype=torch.bool, device="cuda")}
        swap, parts = ops._two_pass_params(ops._invert_affine(ops.affine_matrices(aff, s, s)))
        donor = (torch.arange(b, device="cuda") + 1) % b
        accepted = (ops.transplant_with_depth(x, donor) != x).flatten(1).any(1)
        assert swap.any() and not swap.all() and accepted.any() and not accepted.all()
        args = (x.to(storage), donor, swap, torch.stack(parts, dim=-1),
                fused.sample_fused_params(gen, AugmentationConfig(), b, s, s, 5))
        out = fused.fused_ultra_apply(*args)
        torch.cuda.synchronize()
        tol = dict(atol=1e-5, rtol=0) if storage == torch.float32 else BF16_TOL
        torch.testing.assert_close(out.float(), fused.fused_ultra_reference(*args).float(), **tol)


@pytest.mark.parametrize("budget_name", ["kBoxPix", "kWarpBoxPix"])
def test_ultra_source_boxes_fit_the_kernel_budget(budget_name):
    """The ultra kernel (#6) and the warp + chain (#5), budget kBoxPix per
    channel in either storage type, and the standalone two-pass warp (#3,
    kWarpBoxPix) stage each output tile's source box (the rows and
    columns its taps reach, clamped as warp_taps clamps them) in shared
    memory, that many pixels per channel with an odd row pitch; a tap
    outside it reads global memory (right, but slower). Every tile of the
    default config's affines at 256x256 must fit each budget."""
    with open(os.path.join(os.path.dirname(fused.__file__), "..", "csrc", "augment.cu")) as f:
        src = f.read()
    budget = int(re.search(rf"constexpr int {budget_name} = (\d+);", src).group(1))
    tile = int(re.search(r"constexpr int kTile = (\d+);", src).group(1))
    cfg, b, s = AugmentationConfig(), 64, 256
    aff = ops.sample_affine_params(torch.Generator().manual_seed(0), b, s, s, degrees=cfg.degrees,
                                   translate=cfg.translate, scale=cfg.scale, shear=cfg.shear)
    aff["applied"][:] = True
    swap, parts = ops._two_pass_params(ops._invert_affine(ops.affine_matrices(aff, s, s)))
    assert swap.any() and not swap.all()
    i00, i01, t0, p, q, r = (t[:, None, None] for t in parts)
    ys = torch.arange(s, dtype=torch.float32)[None, :, None]
    xs = torch.arange(s, dtype=torch.float32)[None, None, :]
    j0 = torch.floor(i01 * ys + i00 * xs + t0).long()
    rows, cols = [], []
    for t in (0, 1):
        j = (j0 + t).clamp(0, s - 1)
        i0 = torch.floor(q * ys + p * j.float() + r).long()
        rows += [(i0 + u).clamp(0, s - 1) for u in (0, 1)]
        cols.append(j)
    n = s // tile
    per_tile = lambda v, red: red(torch.stack(v).reshape(len(v), b, n, tile, n, tile), (0, 3, 5))  # noqa: E731
    nrows = per_tile(rows, torch.amax) - per_tile(rows, torch.amin) + 1
    pitch = (per_tile(cols, torch.amax) - per_tile(cols, torch.amin) + 1) | 1
    assert (nrows * pitch).max().item() <= budget


def _tap_bounds(parts, s):
    """Each output pixel's tap rows and columns, clamped as warp_taps clamps
    them, with warp_taps' f32 arithmetic (no fused multiply-adds on the
    CPU): (i min, i max, j min, j max), each (B, S, S)."""
    i00, i01, t0, p, q, r = (t[:, None, None] for t in parts)
    ys = torch.arange(s, dtype=torch.float32)[None, :, None]
    xs = torch.arange(s, dtype=torch.float32)[None, None, :]
    j0 = torch.floor(i01 * ys + i00 * xs + t0).long()
    rows, cols = [], []
    for t in (0, 1):
        j = (j0 + t).clamp(0, s - 1)
        i0 = torch.floor(q * ys + p * j.float() + r).long()
        rows += [(i0 + u).clamp(0, s - 1) for u in (0, 1)]
        cols.append(j)
    rows, cols = torch.stack(rows), torch.stack(cols)
    return rows.amin(0), rows.amax(0), cols.amin(0), cols.amax(0)


def test_tile_box_from_edge_columns_is_the_box_of_every_tap():
    """The two-pass warp (#3) and the warp + chain (#5) bound a 32x32
    output tile's taps by those of its first and last column in the image
    (#6 bounds every pixel's): along a row the column
    map is monotone in x, and the row map monotone in the column, rounding
    included. The box must be the one every pixel's taps give: on the
    default config's affines at 256 and on AFFINE_SWEEP at sizes whose edge
    tiles are ragged."""
    with open(os.path.join(os.path.dirname(fused.__file__), "..", "csrc", "augment.cu")) as f:
        tile = int(re.search(r"constexpr int kTile = (\d+);", f.read()).group(1))
    cfg = AugmentationConfig()
    aff = ops.sample_affine_params(torch.Generator().manual_seed(1), 32, 256, 256, degrees=cfg.degrees,
                                   translate=cfg.translate, scale=cfg.scale, shear=cfg.shear)
    aff["applied"][:] = True
    cases = [(aff, 256)]
    for s in (37, 129):
        col = torch.tensor(AFFINE_SWEEP).T
        cases.append(({"angle": col[0], "scale": col[1], "shear_x": col[2], "shear_y": col[3], "tx": col[4] * s,
                       "ty": col[5] * s, "applied": torch.ones(len(AFFINE_SWEEP), dtype=torch.bool)}, s))
    for aff, s in cases:
        _, parts = ops._two_pass_params(ops._invert_affine(ops.affine_matrices(aff, s, s)))
        bounds = _tap_bounds(parts, s)
        for y0 in range(0, s, tile):
            for x0 in range(0, s, tile):
                rows = slice(y0, y0 + tile)
                edges = [x0, min(x0 + tile, s) - 1]
                for t, reduce in zip(bounds, (torch.amin, torch.amax, torch.amin, torch.amax)):
                    every = reduce(t[:, rows, x0 : x0 + tile], (1, 2))
                    assert torch.equal(every, reduce(t[:, rows, edges], (1, 2))), (s, y0, x0)


@pytest.mark.cuda
def test_cuda_warp_kernel_matches_plain_version():
    """The two-pass warp (#3) at rotations to +-90 deg with both swap
    orientations, square sizes that are not multiples of a block, and the
    identity (exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode (run chip_smoke.py on the card)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, c, s in [(4, 5, 64), (3, 4, 37), (2, 3, 129)]:
        x = torch.rand((b, c, s, s), device="cuda", generator=gen)
        aff = ops.sample_affine_params(gen, b, s, s, degrees=90.0, shear=10.0)
        aff["applied"][:] = True
        swap, parts = ops._two_pass_params(ops._invert_affine(ops.affine_matrices(aff, s, s)))
        swap[0], swap[1] = True, False
        wp = torch.stack(parts, dim=-1)
        before = warp.warp_affine_two_pass.launches
        out = warp.warp_affine_two_pass(x, swap, wp)
        torch.cuda.synchronize()
        assert warp.warp_affine_two_pass.launches == before + 1 and out.dtype == torch.float32
        torch.testing.assert_close(out, warp.warp_affine_two_pass_reference(x, swap, wp), atol=1e-5, rtol=0)
        eye = torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], device="cuda").expand(b, 6)
        assert torch.equal(warp.warp_affine_two_pass(x, torch.zeros_like(swap), eye), x)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 5])
def test_cuda_warp_kernel_over_affine_sweep(c):
    """The two-pass warp (#3) over AFFINE_SWEEP, one image per affine, at
    sizes that are not multiples of its 32-pixel tile, with every image in
    both orientations (the swap flags as drawn, then flipped); the
    zoom-out's taps leave the staged box at 129. Exact at the identity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode (run chip_smoke.py on the card)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    b = len(AFFINE_SWEEP)
    for s in (37, 129):
        x = torch.rand((b, c, s, s), device="cuda", generator=gen)
        col = torch.tensor(AFFINE_SWEEP, device="cuda").T
        aff = {"angle": col[0], "scale": col[1], "shear_x": col[2], "shear_y": col[3], "tx": col[4] * s,
               "ty": col[5] * s, "applied": torch.ones(b, dtype=torch.bool, device="cuda")}
        swap, parts = ops._two_pass_params(ops._invert_affine(ops.affine_matrices(aff, s, s)))
        assert swap.any() and not swap.all()
        wp = torch.stack(parts, dim=-1)
        for flags in (swap, ~swap):
            out = warp.warp_affine_two_pass(x, flags, wp)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, warp.warp_affine_two_pass_reference(x, flags, wp), atol=1e-5, rtol=0)
        eye = torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], device="cuda").expand(b, 6)
        assert torch.equal(warp.warp_affine_two_pass(x, torch.zeros_like(swap), eye), x)


@pytest.mark.cuda
def test_cuda_wrappers_count_only_launches():
    """An empty batch launches no kernel, so it adds nothing to a count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode (run chip_smoke.py on the card)")
    s = 16
    x = torch.empty((0, 5, s, s), device="cuda")
    p = {
        "scalars": torch.zeros((0, fused.N_SCALARS), device="cuda"),
        "fields": torch.zeros((0, 3, s, s), dtype=torch.bfloat16, device="cuda"),
        "plasma": torch.zeros((0, s, s), dtype=torch.bfloat16, device="cuda"),
    }
    wp = torch.zeros((0, 6), device="cuda")
    idx = torch.zeros((0,), dtype=torch.int32, device="cuda")
    for kernel, args in [(fused.fused_apply, (x, p)), (fused.fused_warp_apply, (x, wp, p)),
                         (fused.fused_ultra_apply, (x, idx, idx.bool(), wp, p)),
                         (warp.warp_affine_two_pass, (x, idx.bool(), wp))]:
        before = kernel.launches
        assert kernel(*args).shape == x.shape
        assert kernel.launches == before


# --------------------------------------------------------------------------
# The hue's floor modulos (csrc/augment.cu::hue_rotate), in numpy float32
# --------------------------------------------------------------------------

F32 = np.float32


def _floor_mod_fmod(x, m):
    """The floor modulo as the kernels wrote it before: C's fmodf (exact),
    moved into [0, m) when its sign differs from m's."""
    t = np.fmod(x, F32(m))
    return np.where((t != 0) & ((t < 0) != (m < 0)), t + F32(m), t).astype(F32)


def _f32_between(lo, hi, stride):
    """Every `stride`-th float32 in [lo, hi] by bit pattern (lo <= 0 <= hi),
    with both zeros, the ends and the values next to each integer inside."""
    pos = np.arange(0, np.float32(hi).view(np.uint32) + 1, stride, dtype=np.uint32).view(F32)
    neg = -np.arange(0, np.float32(-lo).view(np.uint32) + 1, stride, dtype=np.uint32).view(F32)
    ints = np.arange(np.ceil(lo), np.floor(hi) + 1, dtype=F32)
    near = np.concatenate([ints, np.nextafter(ints, F32(-np.inf)), np.nextafter(ints, F32(np.inf))])
    edge = np.array([0.0, -0.0, lo, hi, 1e-45, -1e-45, 2**-24, -(2**-24), 2**-25, -(2**-25)], F32)
    x = np.concatenate([pos, neg, near, edge]).astype(F32)
    return x[(x >= lo) & (x <= hi)]


def _rgb_grid(seed):
    """(r, g, b) float32 in [0, 1]: a 41^3 grid (every order and tie of the
    channels), random triples, and triples one ulp apart."""
    g = np.linspace(0.0, 1.0, 41, dtype=F32)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    rand = rng.uniform(0.0, 1.0, (200_000, 3)).astype(F32)
    base = rng.uniform(0.0, 1.0, (20_000, 1)).astype(F32)
    ulp = np.concatenate([base, np.nextafter(base, F32(2)), np.nextafter(base, F32(-1))], 1)
    rgb = np.concatenate([grid, rand, ulp]).astype(F32)
    return rgb[:, 0], rgb[:, 1], rgb[:, 2]


def _red_sector_hue(r, g, b):
    """(g - b) / delta of the pixels whose max channel is red, as the kernel
    computes it (delta == 0 excluded: it is replaced by 1 there)."""
    maxc, minc = np.maximum(np.maximum(r, g), b), np.minimum(np.minimum(r, g), b)
    delta = (maxc - minc).astype(F32)
    keep = (r >= g) & (r >= b) & (delta != 0)
    return ((g - b)[keep] / delta[keep]).astype(F32)


def test_red_sector_floor_mod_6_is_a_select():
    """hue_rotate's x % 6 of the red sector's hue x = (g - b) / delta: x lies
    in [-1, 1] (|g - b| <= max - min, each side rounded), where fmodf(x, 6)
    is x, so the floor modulo is x < 0 ? x + 6 : x, bit for bit, -0 and -1
    included. Checked over a dense sweep of [-1, 1] and over the hues that
    the pixels of an RGB grid give."""
    x = _f32_between(-1.0, 1.0, 1021)
    hue = _red_sector_hue(*_rgb_grid(0))
    assert np.abs(hue).max() <= 1.0
    for v in (x, hue):
        select = np.where(v < 0, v + F32(6), v).astype(F32)
        assert np.array_equal(select.view(np.uint32), _floor_mod_fmod(v, 6.0).view(np.uint32))


def test_turn_floor_mod_1_is_y_minus_floor():
    """hue_rotate's y % 1 of y = hue + shift (hue in [0, 1], shift of either
    sign): y - floor(y), rounded once, is the real number that fmodf(y, 1) +
    1 rounds to for y < 0 and fmodf(y, 1) itself for y >= 0, so the bits are
    the same. The one exception is the sign of a zero (a negative integer
    y: fmodf gives -0, the rewrite +0), which gives the same sector and
    fraction downstream."""
    y = np.concatenate([_f32_between(-1.5, 2.0, 509), np.array([-1.0, -0.0, 0.0, 1.0, 2.0, -1.5], F32)])
    new = (y - np.floor(y)).astype(F32)
    old = _floor_mod_fmod(y, 1.0)
    same_bits = new.view(np.uint32) == old.view(np.uint32)
    assert np.all(same_bits | ((new == 0) & (old == 0)))
    assert np.all(same_bits[y != np.floor(y)])  # off the integers, every bit
    for hh in (new, old):
        assert np.all((hh >= 0) & (hh <= 1))
    h6_new, h6_old = (new * F32(6)).astype(F32), (old * F32(6)).astype(F32)
    fi_new, fi_old = np.floor(h6_new), np.floor(h6_old)
    assert np.array_equal((h6_new - fi_new).view(np.uint32), (h6_old - fi_old).view(np.uint32))
    assert np.array_equal(fi_new.astype(np.int32) % 6, fi_old.astype(np.int32) % 6)


def _hue_rotate(r, g, b, shift, rewritten):
    """csrc/augment.cu::hue_rotate in numpy float32: `rewritten` selects
    this design (one division, x < 0 ? x + 6 : x, y - floor(y), the sector
    6 -> 0) or the fmodf one it replaced."""
    maxc, minc = np.maximum(np.maximum(r, g), b), np.minimum(np.minimum(r, g), b)
    v, delta = maxc, (maxc - minc).astype(F32)
    safe = np.where(delta == 0, F32(1), delta).astype(F32)
    s = np.where(v > 0, delta / np.where(v > 0, v, F32(1)), F32(0)).astype(F32)
    r_max, g_max = (r >= g) & (r >= b), (g > r) & (g >= b)
    if rewritten:
        x = (np.where(r_max, g - b, np.where(g_max, b - r, r - g)) / safe).astype(F32)
        hh = np.where(r_max, np.where(x < 0, x + F32(6), x), x + np.where(g_max, F32(2), F32(4))).astype(F32)
    else:
        hr = _floor_mod_fmod(((g - b) / safe).astype(F32), 6.0)
        hg, hb = ((b - r) / safe + F32(2)).astype(F32), ((r - g) / safe + F32(4)).astype(F32)
        hh = np.where(r_max, hr, np.where(g_max, hg, hb)).astype(F32)
    hh = np.where(delta == 0, F32(0), (hh / F32(6)).astype(F32))
    y = (hh + F32(shift)).astype(F32)
    hh = (y - np.floor(y)).astype(F32) if rewritten else _floor_mod_fmod(y, 1.0)
    h6 = (hh * F32(6)).astype(F32)
    fi = np.floor(h6)
    f = (h6 - fi).astype(F32)
    pp = (v * (F32(1) - s)).astype(F32)
    qq = (v * (F32(1) - s * f)).astype(F32)
    tt = (v * (F32(1) - s * (F32(1) - f))).astype(F32)
    i = fi.astype(np.int32)
    i = np.where(i == 6, 0, i) if rewritten else i % 6
    pick = lambda vals: np.select([i == k for k in range(6)], vals)  # noqa: E731
    return pick([v, qq, pp, pp, tt, v]), pick([tt, v, v, qq, pp, pp]), pick([pp, pp, tt, v, v, qq])


@pytest.mark.parametrize("shift", [-0.5, -0.025, -(2.0**-24), -(2.0**-26), 2.0**-24, 0.025, 0.5])
def test_hue_rotate_rewrite_is_bit_identical(shift):
    """The whole hue rotation with the rewritten floor modulos, one division
    and the sector by selects gives the same bits as the fmodf version it
    replaced, on an RGB grid with ties and one-ulp neighbours, at shifts of
    either sign (the config draws them in [-0.025, 0.025]; at -2^-26 a gray
    pixel's hue rounds up to a whole turn, sector 6, which is sector 0)."""
    r, g, b = _rgb_grid(1)
    for old, new in zip(_hue_rotate(r, g, b, shift, False), _hue_rotate(r, g, b, shift, True)):
        assert np.array_equal(old.astype(F32).view(np.uint32), new.astype(F32).view(np.uint32))


# --------------------------------------------------------------------------
# The chain (#4) and the warp + chain (#5) on the card
# --------------------------------------------------------------------------


def _chain_inputs(gen, b, c, s, storage, w=None):
    """(B, C, S, W) images on the card (RGB in [0, 1], metric depth, binary
    seg) and their fused params."""
    w = s if w is None else w
    x = torch.rand((b, c, s, w), device="cuda", generator=gen)
    if c > 3:
        x[:, 3] = 3.0 + 11.0 * x[:, 3]
    if c > 4:
        x[:, 4] = (x[:, 4] < 0.4).float()
    return x.to(storage), fused.sample_fused_params(gen, AugmentationConfig(), b, s, w, c)


def _sweep_params(s, device="cuda"):
    """AFFINE_SWEEP at size S: (inverse maps (8, 2, 3), swap (8,), two-pass
    params (8, 6))."""
    col = torch.tensor(AFFINE_SWEEP, device=device).T
    aff = {"angle": col[0], "scale": col[1], "shear_x": col[2], "shear_y": col[3], "tx": col[4] * s,
           "ty": col[5] * s, "applied": torch.ones(len(AFFINE_SWEEP), dtype=torch.bool, device=device)}
    inv = ops._invert_affine(ops.affine_matrices(aff, s, s))
    swap, parts = ops._two_pass_params(inv)
    return inv, swap, torch.stack(parts, dim=-1)


def _check_once(kernel, plain, args, storage):
    """One launch of `kernel` (its count goes up by one) against `plain`."""
    before = kernel.launches
    out = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and out.dtype == storage
    tol = dict(atol=1e-5, rtol=0) if storage == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), plain(*args).float(), **tol)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode (run chip_smoke.py on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [4, 5])
def test_cuda_chain_and_warp_kernels_over_affine_sweep(c, storage):
    """#4 on AFFINE_SWEEP-sized batches (no affine) and #5 with the sweep's
    parameters on the swap-adjusted batch (ops._two_pass_setup), at sizes
    that are not multiples of the tiles; the zoom-out's taps leave #5's
    staged box at 129."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for s in (37, 129):
        x, p = _chain_inputs(gen, len(AFFINE_SWEEP), c, s, storage)
        inv, swap, wp = _sweep_params(s)
        assert swap.any() and not swap.all()
        x_sw, _ = ops._two_pass_setup(x, inv)
        _check_once(fused.fused_apply, fused.reference_apply, (x, p), storage)
        _check_once(fused.fused_warp_apply, fused.fused_warp_reference, (x_sw.contiguous(), wp, p), storage)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 6, 7, 8])
def test_cuda_chain_and_warp_kernels_at_other_channel_counts(c):
    """#4 and #5 at C = 3 (their own instantiation) and at 6-8 (the generic
    one), at a small odd shape, in f32 and bf16."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    for storage in (torch.float32, torch.bfloat16):
        x, p = _chain_inputs(gen, len(AFFINE_SWEEP), c, 37, storage)
        _, _, wp = _sweep_params(37)
        _check_once(fused.fused_apply, fused.reference_apply, (x, p), storage)
        _check_once(fused.fused_warp_apply, fused.fused_warp_reference, (x, wp, p), storage)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_chain_and_warp_kernels_scalar_paths(storage):
    """The scalar path of #4's stage 1 and of stage 2 (shared by #4-#6):
    widths that are not a multiple of 4 (a non-square chain, an odd square
    warp), a batch slice whose base is not 16-byte aligned, and an unaligned
    view at a width that is a multiple of 4; the aligned case beside it."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, p = _chain_inputs(gen, 3, 5, 40, storage, w=30)
    _check_once(fused.fused_apply, fused.reference_apply, (x, p), storage)
    x, p = _chain_inputs(gen, 4, 5, 37, storage)
    xs, ps = x[1:], {k: v[1:] for k, v in p.items()}
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    _, _, wp = _sweep_params(37)
    for args in ((xs, ps), (xs, wp[:3], ps)):
        plain = fused.reference_apply if len(args) == 2 else fused.fused_warp_reference
        kernel = fused.fused_apply if len(args) == 2 else fused.fused_warp_apply
        _check_once(kernel, plain, args, storage)
    x, p = _chain_inputs(gen, 3, 4, 64, storage)
    buf = torch.empty(x.numel() + 1, dtype=storage, device="cuda")
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    _, _, wp = _sweep_params(64)
    for images in (x, xu):
        _check_once(fused.fused_apply, fused.reference_apply, (images, p), storage)
        _check_once(fused.fused_warp_apply, fused.fused_warp_reference, (images, wp[:3], p), storage)
