"""The augmentation's CUDA kernels (perseus_tpu_torch/csrc/augment.cu: the
fused chain's three and the two-pass warp) against their plain PyTorch
versions, on the card. These tests need a CUDA
card and skip without one; the file imports no JAX, so that the card's
machine (which has none) runs it:

    python -m pytest tests/test_torch_augment_cuda.py -m cuda --noconftest -q

Tolerances: atol 1e-5 in f32 (the kernel's mean-gray sum runs in another
order; the warp's blend as the plain version's, fused multiply-adds off);
one bf16 ulp (rtol 2^-7, atol 2^-9) for bf16 storage; the warp exact at the
identity.
"""

import pytest
import torch

from perseus_tpu_torch.augment import fused, ops, warp
from perseus_tpu_torch.augment.pipeline import AugmentationConfig

BF16_TOL = dict(rtol=2**-7, atol=2**-9)


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
