"""The ResNet stem maxpool: ``MaxPool2d(3, stride=2, padding=1)``, forward
and gradient.

Port of ``perseus_tpu/models/pool_pallas.py::max_pool_3x3_s2_pallas``: the
forward kernel ``_fwd_kernel`` and the gradient kernel ``_bwd_kernel``, as
the hand-written CUDA kernels in ``csrc/maxpool.cu``.

  * :func:`max_pool_3x3_s2` (forward) and :func:`max_pool_3x3_s2_backward`
    launch those kernels for CUDA tensors and take their plain versions,
    :func:`max_pool_3x3_s2_reference` and
    :func:`max_pool_3x3_s2_backward_reference`, only for tensors on the CPU.
  * :func:`max_pool_3x3_s2` is also the differentiable op the model calls:
    for an input that needs a gradient, a ``torch.autograd.Function`` over
    the two, on both devices, so the gradient has the JAX kernel's tie
    semantics everywhere: ``g[p, q]`` goes
    whole to EVERY input equal to its window max (autograd through
    ``torch.maximum`` would split it in halves at a tie, and
    ``F.max_pool2d``'s backward gives it to one argmax).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perseus_tpu_torch.models import _build

__all__ = [
    "max_pool_3x3_s2",
    "max_pool_3x3_s2_backward",
    "max_pool_3x3_s2_reference",
    "max_pool_3x3_s2_backward_reference",
    "pool_output_hw",
]

_DTYPES = (torch.float32, torch.bfloat16)


def pool_output_hw(h: int, w: int) -> tuple[int, int]:
    """Output size of the 3x3/s2/p1 window: floor((n + 2 - 3) / 2) + 1."""
    return (h - 1) // 2 + 1, (w - 1) // 2 + 1


def max_pool_3x3_s2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: pad with -inf, then the max over the nine
    stride-2 shifted views, in window order. (B, C, H, W) -> (B, C, Ho, Wo)."""
    ho, wo = pool_output_hw(x.shape[-2], x.shape[-1])
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    out = None
    for ky in range(3):
        for kx in range(3):
            tap = xp[..., ky : ky + 2 * ho - 1 : 2, kx : kx + 2 * wo - 1 : 2]
            out = tap if out is None else torch.maximum(out, tap)
    return out


def max_pool_3x3_s2_backward_reference(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the gradient: the compare-and-route form of
    ``pool_pallas.py::_bwd_kernel``, not autograd of the forward.

    Input row 2p is covered by window row p only, row 2p+1 by window rows p
    and p+1 (the same for columns), so each of the four parity sub-grids of
    x sums 1, 2, 2 or 4 terms ``where(x == y[p', q'], g[p', q'], 0)``, in the
    JAX order (p, q), (p+1, q), (p, q+1), (p+1, q+1). A window past the last
    one is a -inf / 0 pad, as in the JAX kernel. Compares and sums run in
    f32, with one cast to x's dtype; any H and W.
    """
    xf, yf, gf = x.float(), y.float(), g.float()
    # one window past the end: y -inf (never equal to a finite x), g 0
    yp = F.pad(yf, (0, 1, 0, 1), value=float("-inf"))
    gp = F.pad(gf, (0, 1, 0, 1), value=0.0)
    dx = torch.empty_like(xf)
    for dr in (0, 1):
        for dc in (0, 1):
            xs = xf[..., dr::2, dc::2]
            nr, nc = xs.shape[-2:]
            acc = None
            for a, b in ((0, 0), (1, 0), (0, 1), (1, 1)):
                if a > dr or b > dc:
                    continue
                term = torch.where(
                    xs == yp[..., a : a + nr, b : b + nc], gp[..., a : a + nr, b : b + nc], 0.0
                )
                acc = term if acc is None else acc + term
            dx[..., dr::2, dc::2] = acc
    return dx.to(x.dtype)


def _check(name: str, *tensors: torch.Tensor) -> None:
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name}: every tensor must share x's device and dtype")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} (kernel takes float32, bfloat16)")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected (B, C, H, W), got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes NCHW-contiguous tensors")


# the handle of a device's current stream, without building a
# torch.cuda.Stream (what Triton's launcher reads); absent from CPU builds
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _kernels():
    """The library of csrc/maxpool.cu as an extension module: ``fwd(bf16,
    x, y, B C, H, W, device, stream)`` and ``bwd(bf16, x, y, g, dx, B C, H,
    W, device, stream)`` launch on the device given (made current for the
    launch when it is not) and return the launch's cudaError. Built and
    imported at the first call."""
    return _build.load_module("maxpool")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")


def _forward(x: torch.Tensor) -> torch.Tensor:
    """The forward of :func:`max_pool_3x3_s2`, without autograd. The path
    of a CUDA tensor is the serving frame's host time at batch 1, so it
    makes no call it can do without."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return max_pool_3x3_s2_reference(x)
        raise ValueError(f"max_pool_3x3_s2: unsupported device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4 or not x.is_contiguous():
        _check("max_pool_3x3_s2", x)  # raises, naming what the kernel does not take
    b, c, h, w = x.shape
    # pool_output_hw; the sizes as separate arguments parse faster than a tuple
    y = x.new_empty(b, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1)
    if y.numel() == 0:
        return y
    dev = x.get_device()
    err = _kernels().fwd(x.dtype is torch.bfloat16, x.data_ptr(), y.data_ptr(), b * c, h, w, dev, _raw_stream(dev))
    _raise_on(err, "max_pool_3x3_s2")
    max_pool_3x3_s2.launches += 1
    return y


def max_pool_3x3_s2_backward(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient of the pool: dx from the input x, the output y and the
    output's gradient g (all NCHW, one dtype, f32 or bf16, any H, W).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    gradient kernel on the current stream, or raises as the forward does.
    Each launch adds one to ``max_pool_3x3_s2_backward.launches``.
    """
    if x.device.type == "cpu":
        return max_pool_3x3_s2_backward_reference(x, y, g)
    _check("max_pool_3x3_s2_backward", x, y, g)
    ho, wo = pool_output_hw(*x.shape[-2:])
    if y.shape != (*x.shape[:2], ho, wo) or g.shape != y.shape:
        raise ValueError(f"max_pool_3x3_s2_backward: shapes x {tuple(x.shape)} y {tuple(y.shape)} g {tuple(g.shape)}")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    b, c, h, w = x.shape
    dev = x.get_device()
    err = _kernels().bwd(x.dtype is torch.bfloat16, x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(),
                         b * c, h, w, dev, _raw_stream(dev))
    _raise_on(err, "max_pool_3x3_s2_backward")
    max_pool_3x3_s2_backward.launches += 1
    return dx


max_pool_3x3_s2_backward.launches = 0


class _MaxPool3x3S2(torch.autograd.Function):
    """Forward kernel, and the gradient kernel as its backward."""

    @staticmethod
    def forward(ctx, x):
        y = _forward(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return max_pool_3x3_s2_backward(x, y, g.contiguous())


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2/pad-1 max pool of an NCHW batch, f32 or bf16, any H, W,
    differentiable: its gradient is :func:`max_pool_3x3_s2_backward`.

    A CPU tensor takes the plain version. A CUDA tensor launches the CUDA
    kernel on the current stream, or raises: for a dtype, rank or layout the
    kernel does not take, and for a failed build or launch. Each launch adds
    one to ``max_pool_3x3_s2.launches``. Only an input that needs a gradient
    goes through the ``autograd.Function``; inference (serving) calls the
    forward directly, which gives the same tensor with less host work.
    """
    if x.requires_grad and torch.is_grad_enabled():
        return _MaxPool3x3S2.apply(x)
    return _forward(x)


max_pool_3x3_s2.launches = 0
