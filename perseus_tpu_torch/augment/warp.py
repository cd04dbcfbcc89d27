"""The two-pass affine warp of the unfused augmentation: its CUDA kernel's
wrapper and its plain version.

Port of ``perseus_tpu/augment/warp_pallas.py``. The Catmull-Smith
decomposition of a per-image affine: a vertical resample by the fractional
row map rhoT, then a horizontal one by the column map gam, bilinear with
zero padding (``ops._two_pass_params`` makes the parameters). On the TPU the
Pallas kernel ``_warp_kernel`` does it with lane gathers on images that
``ops._two_pass_setup`` swap-transposed beforehand; here one hand-written
CUDA kernel (``csrc/augment.cu``, ``perseus_warp_affine_f32``) reads each
image in its stored orientation and takes the transpose from the per-image
swap flag, so no transposed copy of the batch is written.

  ============================  ================================  =====================================
  entry                         TPU kernel it replaces            plain version
  ============================  ================================  =====================================
  :func:`warp_affine_two_pass`  ``warp_pallas.py::_warp_kernel``  :func:`warp_affine_two_pass_reference`
  ============================  ================================  =====================================

f32 in the math and the output, as the JAX kernel (other float inputs are
cast first); any square size. The wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises. Each
launch adds one to ``warp_affine_two_pass.launches``.

Layout: (B, C, S, S) images.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from perseus_tpu_torch.augment import fused
from perseus_tpu_torch.models import _build

__all__ = ["warp_affine_two_pass", "warp_affine_two_pass_reference"]


def warp_affine_two_pass_reference(images: torch.Tensor, swap: torch.Tensor, warp_params: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`warp_affine_two_pass`: the swap prologue of
    ``ops._two_pass_setup``, then the fused chain's index planes and
    two-pass resample (``fused._index_planes``, ``fused._warp_planes``)."""
    _, c, h, w = images.shape
    x = images.float()
    x = torch.where(swap.bool()[:, None, None, None], x.transpose(-2, -1), x)
    rho_t, gam = fused._index_planes(warp_params, h, w)
    return torch.stack(fused._warp_planes([x[:, k] for k in range(c)], rho_t, gam, h, w), dim=1)


@functools.cache
def _entry():
    fn = _build.load_library("augment").perseus_warp_affine_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # images, out, params (B, 7)
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, c, h, w
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def warp_affine_two_pass(images: torch.Tensor, swap: torch.Tensor, warp_params: torch.Tensor) -> torch.Tensor:
    """Two-pass affine warp of (B, C, S, S) images in their stored
    orientation: ``swap`` (B,) bool transposes an image before the warp,
    ``warp_params`` (B, 6) is (i00, i01, t0, p, q, r) for the swapped image
    (``ops._two_pass_params``). Returns f32: the kernel for CUDA tensors,
    :func:`warp_affine_two_pass_reference` for CPU ones."""
    name = "warp_affine_two_pass"
    if images.device.type == "cpu":
        return warp_affine_two_pass_reference(images, swap, warp_params)
    if images.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {images.device}")
    if images.dim() != 4 or images.shape[-2] != images.shape[-1]:
        raise ValueError(f"{name}: the two-pass warp takes square (B, C, S, S) images, got {tuple(images.shape)}")
    if not images.is_floating_point():
        raise TypeError(f"{name}: image dtype {images.dtype} (the kernel takes floating point, computes in f32)")
    b, c, h, w = images.shape
    if b > 65535:
        raise ValueError(f"{name}: at most 65535 images per launch, got {b}")
    if swap.shape != (b,) or warp_params.shape != (b, 6):
        raise ValueError(f"{name}: swap must be (B,) and warp_params (B, 6) for B = {b}")
    dev = images.device
    x = images.to(torch.float32).contiguous()
    wp = torch.cat([warp_params.to(dev, torch.float32), swap.to(dev, torch.float32)[:, None]], dim=1).contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(x.data_ptr(), out.data_ptr(), wp.data_ptr(), b, c, h, w, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    warp_affine_two_pass.launches += 1
    return out


# the count of the kernel's launches, added to right after a launch (an
# empty batch launches nothing and counts nothing)
warp_affine_two_pass.launches = 0
