"""The augmentation's CUDA kernels (perseus_tpu_torch/csrc/augment.cu: the
fused chain's three and the two-pass warp) against their plain PyTorch
versions, on the card. These tests need a CUDA card and skip without one
(all but the check of the ultra kernel's shared-memory budget, which runs
on the CPU); the file imports no JAX, so that the card's machine (which
has none) runs it:

    python -m pytest tests/test_torch_augment_cuda.py -m cuda --noconftest -q

Tolerances: atol 1e-5 in f32 (the kernel's mean-gray sum runs in another
order; the warp's blend as the plain version's, fused multiply-adds off);
one bf16 ulp (rtol 2^-7, atol 2^-9) for bf16 storage; the warp exact at the
identity.
"""

import os
import re

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
    """The ultra kernel (#6, budget kBoxPix) and the standalone two-pass
    warp (#3, kWarpBoxPix) stage each output tile's source box (the rows and
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
    """Both staging kernels (#3, #6) bound a 32x32 output tile's taps by
    those of its first and last column in the image: along a row the column
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
