"""The ResNet stem maxpool: ``MaxPool2d(3, stride=2, padding=1)``, forward.

Port of ``perseus_tpu/models/pool_pallas.py::max_pool_3x3_s2_pallas``
(forward kernel ``_fwd_kernel``) as the hand-written CUDA kernel in
``csrc/maxpool.cu``. :func:`max_pool_3x3_s2` launches that kernel for a CUDA
tensor and takes the plain version, :func:`max_pool_3x3_s2_reference`, only
for a tensor on the CPU. The gradient kernel comes with the training path;
until then the wrapper refuses a CUDA input that needs a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from perseus_tpu_torch.models import _build

__all__ = ["max_pool_3x3_s2", "max_pool_3x3_s2_reference", "pool_output_hw"]

_ENTRY = {torch.float32: "perseus_maxpool3x3s2_f32", torch.bfloat16: "perseus_maxpool3x3s2_bf16"}


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


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load_library("maxpool"), _ENTRY[dtype])
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2/pad-1 max pool of an NCHW batch, f32 or bf16, any H, W.

    A CPU tensor takes the plain version. A CUDA tensor launches the CUDA
    kernel on the current stream, or raises: for a dtype, rank or layout the
    kernel does not take, for an input that needs a gradient, and for a
    failed build or launch. Each launch adds one to ``max_pool_3x3_s2.launches``.
    """
    if x.device.type == "cpu":
        return max_pool_3x3_s2_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool_3x3_s2: unsupported device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"max_pool_3x3_s2: dtype {x.dtype} (kernel takes float32, bfloat16)")
    if x.dim() != 4:
        raise ValueError(f"max_pool_3x3_s2: expected (B, C, H, W), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("max_pool_3x3_s2: the kernel takes an NCHW-contiguous tensor")
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("max_pool_3x3_s2: the gradient kernel is not ported yet")
    b, c, h, w = x.shape
    ho, wo = pool_output_hw(h, w)
    y = torch.empty((b, c, ho, wo), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry(x.dtype)(x.data_ptr(), y.data_ptr(), b * c, h, w, ho, wo, stream)
    if err != 0:
        raise RuntimeError(f"max_pool_3x3_s2: kernel launch failed, cudaError {err}")
    max_pool_3x3_s2.launches += 1
    return y


max_pool_3x3_s2.launches = 0
