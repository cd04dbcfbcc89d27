"""The fused augmentation's CUDA kernels (perseus_tpu_torch/csrc/augment.cu)
against their plain PyTorch versions, on the card. These tests need a CUDA
card and skip without one; the file imports no JAX, so that the card's
machine (which has none) runs it:

    python -m pytest tests/test_torch_augment_cuda.py -m cuda --noconftest -q

Tolerances: atol 1e-5 in f32 (the kernel's mean-gray sum runs in another
order); one bf16 ulp (rtol 2^-7, atol 2^-9) for bf16 storage.
"""

import pytest
import torch

from perseus_tpu_torch.augment import fused
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
                         (fused.fused_ultra_apply, (x, idx, idx.bool(), wp, p))]:
        before = kernel.launches
        assert kernel(*args).shape == x.shape
        assert kernel.launches == before
