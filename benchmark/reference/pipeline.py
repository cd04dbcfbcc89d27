"""What the served frame does around any detector, in plain PyTorch: the
frame's preprocess, the keypoints' denormalize, and the matmul precision
every reference computes under."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool = False):
    """f32 convolutions and matrix products in full f32 (``tf32=False``) or
    in TF32; the caller's settings are restored after."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def preprocess(frame: torch.Tensor, cube_scale: float, near: float, far: float, h: int, w: int) -> torch.Tensor:
    """(H, W, 4) metric RGBD frame -> (1, 4, h, w) model input: non-finite
    depth to 0, depth in cube units, depth nearer than ``near`` or farther
    than ``far`` metres to 0, the centre h x w crop."""
    depth = torch.where(torch.isfinite(frame[..., 3]), frame[..., 3], torch.zeros_like(frame[..., 3]))
    scaled = depth  # metres: cube_scale * (depth / cube_scale)
    depth = torch.where((scaled < near) | (scaled > far), torch.zeros_like(depth), depth / cube_scale)
    image = torch.cat([frame[..., :3], depth[..., None]], dim=-1)
    top, left = image.shape[0] // 2 - h // 2, image.shape[1] // 2 - w // 2
    return image[top : top + h, left : left + w].permute(2, 0, 1)[None]


def denormalize(kp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., 2K) in [-1, 1] -> (..., K, 2) pixels: u = (x + 1) (W - 1) / 2."""
    kp = kp.reshape(*kp.shape[:-1], -1, 2)
    return torch.stack([(kp[..., 0] + 1) * (w - 1) / 2, (kp[..., 1] + 1) * (h - 1) / 2], dim=-1)
