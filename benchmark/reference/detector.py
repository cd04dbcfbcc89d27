"""Plain f32 ResNet-18 keypoint regressor: the yardstick of the detector.

torchvision's ResNet-18 (7x7 stride-2 stem, 3x3 stride-2 max pool with
padding 1, four stages of two basic blocks, global average pool) with a
``num_channels``-wide stem and a fully connected head of 2K outputs, on
weights in torchvision's names. Plain ``torch.nn.functional`` operations in
float32 with TF32 off: no kernel, cache or batching of the program.

``quantize=True`` computes every convolution as float8 training does: its
inputs and weights rounded to e4m3 and, in the backward, the gradient of its
output to e5m2, one scale per tensor. That is the precision below the bf16
that the configurations state, the benchmark's control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.pipeline import matmul_precision

STAGES = ((2, 64), (2, 128), (2, 256), (2, 512))
BN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8 e4m3
FP8_GRAD_MAX = 57344.0  # largest finite float8 e5m2


def blocks():
    """(prefix, stride, has_downsample) of every basic block, in order."""
    for stage, (n, _) in enumerate(STAGES):
        for block in range(n):
            first = stage > 0 and block == 0
            yield f"layer{stage + 1}.{block}", (2 if first else 1), first


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to the format's largest value; straight through for autograd."""
    scale = FP8_MAX / torch.clamp_min(x.detach().abs().amax(), 1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


class _E5M2Gradient(torch.autograd.Function):
    """Identity whose gradient is rounded to float8 e5m2 under one scale."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        scale = FP8_GRAD_MAX / torch.clamp_min(g.abs().amax(), 1e-30)
        return (g * scale).to(torch.float8_e5m2).to(g.dtype) / scale


def conv(x, w, stride, padding, quantize=False):
    if not quantize:
        return F.conv2d(x, w, stride=stride, padding=padding)
    return _E5M2Gradient.apply(F.conv2d(fp8_round(x), fp8_round(w), stride=stride, padding=padding))


def fold(sd: dict) -> dict:
    """BN folded into the preceding conv: weight * gamma / sqrt(var + eps),
    bias beta - mean * gamma / sqrt(var + eps); the head as it is."""
    pairs = [("conv1", "bn1")]
    for p, _, down in blocks():
        pairs += [(f"{p}.conv1", f"{p}.bn1"), (f"{p}.conv2", f"{p}.bn2")]
        if down:
            pairs.append((f"{p}.downsample.0", f"{p}.downsample.1"))
    out = {}
    for c, b in pairs:
        scale = sd[f"{b}.weight"].float() / torch.sqrt(sd[f"{b}.running_var"].float() + BN_EPS)
        out[f"{c}.weight"] = sd[f"{c}.weight"].float() * scale[:, None, None, None]
        out[f"{c}.bias"] = sd[f"{b}.bias"].float() - sd[f"{b}.running_mean"].float() * scale
    out["fc.weight"], out["fc.bias"] = sd["fc.weight"].float(), sd["fc.bias"].float()
    return out


def features(folded: dict, x: torch.Tensor, quantize: bool = False) -> torch.Tensor:
    """(B, 512) pooled features of NCHW images, BN folded."""

    def cb(h, name, stride, padding):
        return conv(h, folded[f"{name}.weight"], stride, padding, quantize) + folded[f"{name}.bias"][:, None, None]

    with matmul_precision(False):
        out = F.max_pool2d(torch.relu(cb(x.float(), "conv1", 2, 3)), 3, 2, 1)
        for p, stride, down in blocks():
            h = torch.relu(cb(out, f"{p}.conv1", stride, 1))
            h = cb(h, f"{p}.conv2", 1, 1)
            identity = cb(out, f"{p}.downsample.0", stride, 0) if down else out
            out = torch.relu(h + identity)
        return out.mean(dim=(2, 3))


def detect(folded: dict, x: torch.Tensor, quantize: bool = False) -> torch.Tensor:
    """(B, 2K) normalized keypoints of NCHW images, BN folded, head in f32."""
    with matmul_precision(False):
        return features(folded, x, quantize) @ folded["fc.weight"].T + folded["fc.bias"]


class _MaxPoolAllTies(torch.autograd.Function):
    """3x3 stride-2 max pool, padding 1, whose gradient goes to every input
    equal to its window's maximum (the configurations' pool)."""

    @staticmethod
    def forward(ctx, x):
        out = F.max_pool2d(x, 3, 2, 1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        hi, wi = x.shape[-2:]
        ho, wo = out.shape[-2:]
        xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
        gp = torch.zeros_like(xp)
        for dy in range(3):
            for dx in range(3):
                win = xp[..., dy : dy + 2 * ho - 1 : 2, dx : dx + 2 * wo - 1 : 2]
                gp[..., dy : dy + 2 * ho - 1 : 2, dx : dx + 2 * wo - 1 : 2] += torch.where(win == out, g, 0.0)
        return gp[..., 1 : 1 + hi, 1 : 1 + wi]


def forward_train(params: dict, x: torch.Tensor, quantize: bool = False, stats: dict | None = None) -> torch.Tensor:
    """(B, 2K) logits with BN in train mode (batch mean, biased batch
    variance); ``stats``, when given, receives each BN layer's unbiased
    batch variance (what the running variance is updated with)."""

    def bn(h, name):
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = ((h - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        if stats is not None:
            n = h.numel() // h.shape[1]
            stats[name] = (var.flatten() * (n / (n - 1))).detach()
        return (h - mean) * torch.rsqrt(var + BN_EPS) * params[f"{name}.weight"][:, None, None] + params[f"{name}.bias"][:, None, None]

    with matmul_precision(False):
        out = torch.relu(bn(conv(x, params["conv1.weight"], 2, 3, quantize), "bn1"))
        out = _MaxPoolAllTies.apply(out)
        for p, stride, down in blocks():
            h = torch.relu(bn(conv(out, params[f"{p}.conv1.weight"], stride, 1, quantize), f"{p}.bn1"))
            h = bn(conv(h, params[f"{p}.conv2.weight"], 1, 1, quantize), f"{p}.bn2")
            identity = bn(conv(out, params[f"{p}.downsample.0.weight"], stride, 0, quantize), f"{p}.downsample.1") if down else out
            out = torch.relu(h + identity)
        return out.mean(dim=(2, 3)) @ params["fc.weight"].T + params["fc.bias"]
