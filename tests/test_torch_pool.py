"""Port parity: the stem maxpool (perseus_tpu_torch/models/pool.py).

The plain PyTorch version is held exactly (equal values, equal NaN
positions) against the JAX package's Pallas kernel in interpret mode and
against XLA's reduce_window, on the same numpy inputs. The CUDA kernel itself
is checked on the card: the ``cuda``-marked test here, and chip_smoke.py. The
card's machine has no JAX, so this file imports it inside the tests that use
it; there run ``python -m pytest tests/test_torch_pool.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from perseus_tpu_torch.models import pool


def _jax():
    import jax.numpy as jnp

    from perseus_tpu.models import resnet as jax_resnet
    from perseus_tpu.models.pool_pallas import max_pool_3x3_s2_pallas

    return jnp, jax_resnet, max_pool_3x3_s2_pallas


def _nchw(x_nhwc: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous().to(dtype)


def _assert_same(port: torch.Tensor, ref_nhwc) -> None:
    """Equal values and equal NaN positions, compared in f32."""
    a = port.to(torch.float32).permute(0, 2, 3, 1).numpy()
    b = np.asarray(ref_nhwc.astype("float32"))
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_reference_matches_pallas_kernel_exactly(dtype):
    jnp, jax_resnet, max_pool_3x3_s2_pallas = _jax()
    tdt, jdt = dtype, jnp.dtype(str(dtype).removeprefix("torch."))
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 8)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    out = pool.max_pool_3x3_s2_reference(_nchw(x, tdt))
    assert out.dtype == tdt
    _assert_same(out, max_pool_3x3_s2_pallas(xj, True))
    _assert_same(out, jax_resnet._reduce_window_max_3x3_s2(xj))


@pytest.mark.parametrize("shape", [(2, 31, 17, 8), (1, 1, 1, 3), (1, 2, 5, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_reference_odd_shapes_nan_and_inf_match_reduce_window(shape, dtype):
    jnp, jax_resnet, _ = _jax()
    tdt, jdt = dtype, jnp.dtype(str(dtype).removeprefix("torch."))
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, size=max(1, flat.size // 20), replace=False)] = -np.inf
    flat[rng.choice(flat.size, size=max(1, flat.size // 40), replace=False)] = np.nan
    out = pool.max_pool_3x3_s2_reference(_nchw(x, tdt))
    _assert_same(out, jax_resnet._reduce_window_max_3x3_s2(jnp.asarray(x).astype(jdt)))
    assert out.shape[-2:] == pool.pool_output_hw(shape[1], shape[2])


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 4, 10, 12)).astype(np.float32))
    before = pool.max_pool_3x3_s2.launches
    assert torch.equal(pool.max_pool_3x3_s2(x), pool.max_pool_3x3_s2_reference(x))
    assert pool.max_pool_3x3_s2.launches == before


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        pool.max_pool_3x3_s2(torch.empty((1, 1, 4, 4), device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernel_matches_reference(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode (run chip_smoke.py on the card)")
    gen = torch.Generator().manual_seed(3)
    for shape in [(2, 64, 128, 128), (2, 8, 31, 17), (1, 3, 1, 1)]:
        x = torch.randn(shape, generator=gen).to("cuda", dtype)
        x.view(-1)[::97] = float("nan")
        x.view(-1)[5::31] = float("-inf")
        before = pool.max_pool_3x3_s2.launches
        out = pool.max_pool_3x3_s2(x)
        torch.cuda.synchronize()
        ref = pool.max_pool_3x3_s2_reference(x)
        assert pool.max_pool_3x3_s2.launches == before + 1
        assert torch.equal(out.isnan(), ref.isnan())
        assert torch.equal(out.nan_to_num(0.0), ref.nan_to_num(0.0))
