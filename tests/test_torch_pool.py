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


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past a 16-byte boundary (what
    a view into a larger buffer, such as a batch slice, can be)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def test_wrapper_takes_autograd_only_for_a_gradient():
    """An input that needs a gradient goes through the autograd.Function;
    under no_grad (serving) or without requires_grad the forward is called
    directly, with the same values and no graph."""
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 3, 9, 8)).astype(np.float32))
    xg = x.clone().requires_grad_()
    y = pool.max_pool_3x3_s2(xg)
    assert type(y.grad_fn).__name__ == "_MaxPool3x3S2Backward"
    with torch.no_grad():
        y_ng = pool.max_pool_3x3_s2(xg)
    y_plain = pool.max_pool_3x3_s2(x)
    assert y_ng.grad_fn is None and y_plain.grad_fn is None
    assert torch.equal(y_ng, y.detach()) and torch.equal(y_plain, y.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernel_matches_reference(dtype):
    """Exact (values and NaN positions) on the stem's shape, odd sizes, a
    1x1 plane, widths that are not a multiple of 16 or of 8 (the kernel's
    cells span 16 input columns) and unaligned views, with NaN and -inf
    placed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode (run chip_smoke.py on the card)")
    gen = torch.Generator().manual_seed(3)
    shapes = [(2, 64, 128, 128), (2, 8, 31, 17), (1, 3, 1, 1), (2, 4, 30, 40), (2, 4, 29, 36), (1, 2, 33, 130)]
    for shape in shapes:
        for view in (False, True):
            x = torch.randn(shape, generator=gen).to("cuda", dtype)
            x.view(-1)[::97] = float("nan")
            x.view(-1)[5::31] = float("-inf")
            if view:
                x = _unaligned(x)
                assert x.data_ptr() % 16 != 0
            before = pool.max_pool_3x3_s2.launches
            out = pool.max_pool_3x3_s2(x)
            torch.cuda.synchronize()
            ref = pool.max_pool_3x3_s2_reference(x)
            assert pool.max_pool_3x3_s2.launches == before + 1
            assert torch.equal(out.isnan(), ref.isnan())
            assert torch.equal(out.nan_to_num(0.0), ref.nan_to_num(0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_no_grad_path_counts_one_launch_and_matches_autograd(dtype):
    """The forward without autograd (no_grad, the serving path) launches the
    kernel once and gives the tensor the autograd path gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode (run chip_smoke.py on the card)")
    x = torch.relu(torch.randn((1, 64, 128, 128), generator=torch.Generator().manual_seed(9))).to("cuda", dtype)
    xg = x.clone().requires_grad_()
    before = pool.max_pool_3x3_s2.launches
    with torch.no_grad():
        fast = pool.max_pool_3x3_s2(xg)
    assert pool.max_pool_3x3_s2.launches == before + 1 and fast.grad_fn is None
    slow = pool.max_pool_3x3_s2(xg)
    assert pool.max_pool_3x3_s2.launches == before + 2 and slow.grad_fn is not None
    assert torch.equal(fast, slow.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernels_launch_on_the_tensors_device(dtype):
    """A batch on another card than the current one: the forward and the
    gradient run there, on that card's current stream, exactly, and the
    current card stays the current one."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    gen = torch.Generator().manual_seed(10)
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    current = torch.cuda.current_device()
    assert dev.index != current
    x = torch.round(torch.randn((2, 8, 31, 17), generator=gen) * 1.5).to(dev, dtype)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # dev's current stream is `side` in this block
        torch.cuda.set_device(current)  # ... and another card the current one
        y = pool.max_pool_3x3_s2(x)
        assert torch.cuda.current_device() == current
    torch.cuda.synchronize(dev)
    assert torch.equal(y, pool.max_pool_3x3_s2_reference(x))
    xg = x.clone().requires_grad_()
    out = pool.max_pool_3x3_s2(xg)
    g = torch.randn(out.shape, generator=gen).to(dev, dtype)
    out.backward(g)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == current
    assert torch.equal(xg.grad, pool.max_pool_3x3_s2_backward_reference(x, out.detach(), g))


def _jax_bwd():
    import jax
    import jax.numpy as jnp

    from perseus_tpu.models import resnet as jax_resnet
    from perseus_tpu.models.pool_pallas import _pool_bwd_call, _pool_fwd_call

    return jax, jnp, jax_resnet, _pool_fwd_call, _pool_bwd_call


def _tied_input(shape, seed):
    """Integer-valued inputs: many exact ties inside each 3x3 window."""
    rng = np.random.default_rng(seed)
    return np.round(rng.normal(size=shape) * 1.5).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 16, 24, 8), (1, 8, 8, 64), (2, 18, 22, 4), (1, 6, 10, 8)])
def test_backward_reference_matches_pallas_kernel_exactly_with_ties(shape):
    jax, jnp, _, fwd, bwd = _jax_bwd()
    x = _tied_input(shape, seed=shape[-1])
    y = fwd(jnp.asarray(x), True)
    g = jnp.asarray(np.random.default_rng(1).normal(size=y.shape).astype(np.float32))
    ref = bwd(jnp.asarray(x), y, g, True)
    out = pool.max_pool_3x3_s2_backward_reference(_nchw(x, torch.float32), _nchw(np.asarray(y), torch.float32), _nchw(np.asarray(g), torch.float32))
    _assert_same(out, ref)


def test_backward_reference_bf16_matches_pallas_kernel():
    """bf16 operands: both upcast, compare and sum in f32 and cast once, so
    the results agree to the bf16 rounding of the same f32 sums (exactly,
    here; the bound checked is one bf16 ulp)."""
    jax, jnp, _, fwd, bwd = _jax_bwd()
    x = jnp.asarray(_tied_input((2, 16, 24, 8), seed=3)).astype(jnp.bfloat16)
    y = fwd(x, True)
    g = jnp.asarray(np.random.default_rng(2).normal(size=y.shape).astype(np.float32)).astype(jnp.bfloat16)
    ref = np.asarray(bwd(x, y, g, True).astype(jnp.float32))
    t = lambda a: _nchw(np.asarray(a.astype(jnp.float32)), torch.bfloat16)  # noqa: E731
    out = pool.max_pool_3x3_s2_backward_reference(t(x), t(y), t(g))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().permute(0, 2, 3, 1).numpy(), ref, rtol=2**-7, atol=2**-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autograd_gradient_matches_jax_comparison_vjp(dtype):
    """The differentiable op's gradient (the autograd.Function, on the CPU)
    against the VJP of the JAX package's comparison maxpool, whose tie
    semantics the Pallas kernel shares."""
    jax, jnp, jax_resnet, _, _ = _jax_bwd()
    jdt = jnp.dtype(str(dtype).removeprefix("torch."))
    x = _tied_input((2, 12, 10, 6), seed=4)
    gy = np.random.default_rng(5).normal(size=(2, 6, 5, 6)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    _, vjp = jax.vjp(jax_resnet._max_pool_3x3_s2_cmp, xj)
    (ref,) = vjp(jnp.asarray(gy).astype(jdt))
    xt = _nchw(x, dtype).requires_grad_()
    pool.max_pool_3x3_s2(xt).backward(_nchw(gy, dtype))
    assert xt.grad.dtype == dtype
    if dtype == torch.float32:
        _assert_same(xt.grad, ref)
    else:  # the XLA-level VJP sums ties in bf16, the kernels in f32: one ulp
        np.testing.assert_allclose(
            xt.grad.float().permute(0, 2, 3, 1).numpy(), np.asarray(ref.astype(jnp.float32)), rtol=2**-7, atol=2**-9
        )


def test_cpu_gradient_routes_the_whole_g_to_every_tie():
    """All-zero input: every input ties with its windows' max, so its
    gradient is the sum of g over the windows that cover it (1, 2 or 4 for
    g = 1), not a half per tie (autograd through torch.maximum) and not a
    single argmax (F.max_pool2d)."""
    x = torch.zeros((1, 1, 6, 7), requires_grad=True)
    y = pool.max_pool_3x3_s2(x)
    y.backward(torch.ones_like(y))
    # row 2p+1 lies in windows p and p+1, but the last odd row (5) only in
    # window 2; the last column (6) is even
    rows = torch.tensor([1, 2, 1, 2, 1, 1], dtype=torch.float32)
    cols = torch.tensor([1, 2, 1, 2, 1, 2, 1], dtype=torch.float32)
    assert torch.equal(x.grad[0, 0], rows[:, None] * cols[None, :])


def test_backward_wrapper_on_cpu_takes_plain_version_without_counting():
    x = torch.from_numpy(_tied_input((2, 3, 9, 8), seed=6))
    y = pool.max_pool_3x3_s2(x)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    before = pool.max_pool_3x3_s2_backward.launches
    assert torch.equal(pool.max_pool_3x3_s2_backward(x, y, g), pool.max_pool_3x3_s2_backward_reference(x, y, g))
    assert pool.max_pool_3x3_s2_backward.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_backward_kernel_matches_reference_exactly(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode (run chip_smoke.py on the card)")
    gen = torch.Generator().manual_seed(7)
    # the stem's shape, odd H and W, a 1x1 plane, a width that is not a
    # multiple of the kernel's 8-column groups
    for shape in [(256, 64, 128, 128), (2, 8, 31, 17), (1, 3, 1, 1), (2, 4, 18, 22)]:
        x = torch.round(torch.randn(shape, generator=gen) * 1.5).to("cuda", dtype).requires_grad_()
        y = pool.max_pool_3x3_s2(x)
        g = torch.randn(y.shape, generator=gen).to("cuda", dtype)
        before = pool.max_pool_3x3_s2_backward.launches
        y.backward(g)
        torch.cuda.synchronize()
        assert pool.max_pool_3x3_s2_backward.launches == before + 1
        assert torch.equal(x.grad, pool.max_pool_3x3_s2_backward_reference(x.detach(), y.detach(), g))
    # contiguous views one element past a 16-byte boundary: the scalar path
    x = torch.round(torch.randn((2, 8, 32, 64), generator=gen) * 1.5).to("cuda", dtype)
    y = pool.max_pool_3x3_s2(x)
    g = torch.randn(y.shape, generator=gen).to("cuda", dtype)
    views = [_unaligned(t) for t in (x, y, g)]
    out = pool.max_pool_3x3_s2_backward(*views)
    assert views[0].data_ptr() % 16 != 0
    assert torch.equal(out, pool.max_pool_3x3_s2_backward_reference(x, y, g))
