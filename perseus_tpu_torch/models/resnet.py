"""ResNet-18 keypoint regressor in PyTorch.

Port of ``perseus_tpu/models/resnet.py``: the torchvision-semantics
ResNet-18 with a ``num_channels``-wide stem and a ``2 * n_keypoints``
regression head, on either the global-average-pool head or the flattened
"spatial" head. Parameters live in flat dicts keyed by torchvision names
(``conv1.weight``, ``layer1.0.bn1.running_mean`` ...), the keys of the JAX
package's dicts, in PyTorch layouts: activations NCHW, conv weights OIHW,
``fc.weight`` (out, in).

  * :func:`keypoint_cnn_apply`: the forward with batch norm in train mode
    (batch statistics, running-stat update) or eval mode; in a process
    group of more than one rank (data-parallel training), train mode's
    statistics are those of the global batch, as the JAX package's mesh
    gives them;
  * :func:`fold_batchnorm` + :func:`keypoint_cnn_apply_folded`: inference
    with BN folded into conv weight and bias, the serving path;
  * :class:`KeypointCNN`: an ``nn.Module`` holding the parameters, whose
    ``state_dict`` keys are exactly those dict keys.

The stem maxpool goes through :mod:`perseus_tpu_torch.models.pool`, the CUDA
kernel on the card. Convs and their bias add run in ``compute_dtype``; the
head runs in f32. An f32 compute dtype means true f32, as the JAX package's
``Precision.HIGHEST``: TF32 is switched off for the call and the caller's
settings are restored after it.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.models import pool

__all__ = [
    "RESNET18_STAGES",
    "KeypointCNN",
    "keypoint_cnn_apply",
    "fold_batchnorm",
    "keypoint_cnn_apply_folded",
    "space_to_depth",
    "space_to_depth_stem_kernel",
]

# (num_blocks, channels) per stage; first block of stages 2-4 has stride 2.
RESNET18_STAGES = ((2, 64), (2, 128), (2, 256), (2, 512))

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


@contextlib.contextmanager
def _full_f32():
    """f32 convs and matmuls in full f32 (cuDNN defaults f32 convs to TF32)."""
    cudnn_old = torch.backends.cudnn.allow_tf32
    matmul_old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_old
        torch.backends.cuda.matmul.allow_tf32 = matmul_old


def _block_prefixes():
    """(prefix, stride) of every basic block, in order."""
    for stage_idx, (num_blocks, _) in enumerate(RESNET18_STAGES):
        for block_idx in range(num_blocks):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            yield f"layer{stage_idx + 1}.{block_idx}", stride


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int, compute_dtype) -> torch.Tensor:
    return F.conv2d(x.to(compute_dtype), w.to(compute_dtype), stride=stride, padding=padding)


def _world_size() -> int:
    """The data-parallel world: the active process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _batchnorm(x: torch.Tensor, sd: dict, prefix: str, train: bool, new_stats: dict | None):
    """torch BN semantics (eps 1e-5, momentum 0.1; biased batch variance to
    normalize, unbiased for the running-stat update), computed as the JAX
    package does: the batch variance as E[y^2] - E[y]^2 of y = x - running
    mean, accumulated in at least f32.

    In a process group of more than one rank, the batch is the global one:
    the per-channel sums of y and y^2 and the element count are all-reduced
    (SyncBatchNorm's arithmetic; the autograd all-reduce carries the
    cross-rank terms into the backward), so every rank normalizes with, and
    updates the running stats to, the same global statistics."""
    gamma = sd[f"{prefix}.weight"]
    beta = sd[f"{prefix}.bias"]
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    if train:
        rm = sd[f"{prefix}.running_mean"].to(acc_dtype)
        yf = x.to(acc_dtype) - rm[:, None, None]
        if _world_size() > 1:
            from torch.distributed.nn.functional import all_reduce

            c = yf.shape[1]
            n = x.shape[0] * x.shape[2] * x.shape[3]
            count = torch.full((1,), float(n), dtype=acc_dtype, device=yf.device)
            sums = all_reduce(torch.cat([torch.sum(yf, dim=(0, 2, 3)), torch.sum(yf * yf, dim=(0, 2, 3)), count]))
            n_all = sums[2 * c]
            mean_y = sums[:c] / n_all
            var = torch.clamp_min(sums[c : 2 * c] / n_all - mean_y * mean_y, 0.0)
            # the global count stays on the device: no read-back per layer
            bessel = n_all / torch.clamp_min(n_all - 1, 1)
        else:
            mean_y = torch.mean(yf, dim=(0, 2, 3))
            var = torch.clamp_min(torch.mean(yf * yf, dim=(0, 2, 3)) - mean_y * mean_y, 0.0)
            n = x.shape[0] * x.shape[2] * x.shape[3]
            bessel = n / max(n - 1, 1)
        mean = mean_y + rm
        if new_stats is not None:
            unbiased = var * bessel
            m = BN_MOMENTUM
            new_stats[f"{prefix}.running_mean"] = (
                (1 - m) * sd[f"{prefix}.running_mean"] + m * mean
            ).detach()
            new_stats[f"{prefix}.running_var"] = (
                (1 - m) * sd[f"{prefix}.running_var"] + m * unbiased
            ).detach()
    else:
        mean = sd[f"{prefix}.running_mean"]
        var = sd[f"{prefix}.running_var"]
    scale = gamma.to(acc_dtype) * torch.rsqrt(var.to(acc_dtype) + BN_EPS)
    shift = beta.to(acc_dtype) - mean.to(acc_dtype) * scale
    return (x.to(acc_dtype) * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return pool.max_pool_3x3_s2(x.contiguous())


def _head_features(out: torch.Tensor, fc_w: torch.Tensor, acc_dtype) -> torch.Tensor:
    """Head input by fc.weight's fan-in: C -> global average pool; H*W*C ->
    the feature map flattened in NHWC order (the JAX layout the spatial
    head's weight rows follow)."""
    b, c, h, w = out.shape
    if fc_w.shape[1] == c:
        return torch.mean(out.to(acc_dtype), dim=(2, 3))
    expect = h * w * c
    if fc_w.shape[1] != expect:
        raise ValueError(
            f"fc.weight fan-in {fc_w.shape[1]} matches neither pooled ({c}) "
            f"nor flattened ({expect}) features — wrong input resolution for this head?"
        )
    return out.to(acc_dtype).permute(0, 2, 3, 1).reshape(b, expect)


def _head(out: torch.Tensor, sd: dict, acc_dtype) -> torch.Tensor:
    feat = _head_features(out, sd["fc.weight"], acc_dtype)
    return feat @ sd["fc.weight"].to(acc_dtype).T + sd["fc.bias"].to(acc_dtype)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel order (dy, dx, c)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def space_to_depth_stem_kernel(w: torch.Tensor) -> torch.Tensor:
    """The 7x7 stride-2 stem kernel (O, C, 7, 7) as the equivalent 4x4
    stride-1 kernel (O, 4C, 4, 4) over :func:`space_to_depth` input, which
    the conv pads by (2, 1) per spatial dim. Tap ky maps to (t, d) with
    2y + ky - 3 = 2(y + t) + d, d in {0, 1}; packed channel (2 d_y + d_x) C + c.
    """
    c_in = w.shape[1]
    w2 = torch.zeros((w.shape[0], 4 * c_in, 4, 4), dtype=w.dtype, device=w.device)
    for ky in range(7):
        t_y, d_y = (ky - 3 - ((ky - 3) % 2)) // 2, (ky - 3) % 2
        for kx in range(7):
            t_x, d_x = (kx - 3 - ((kx - 3) % 2)) // 2, (kx - 3) % 2
            ch = (d_y * 2 + d_x) * c_in
            w2[:, ch : ch + c_in, t_y + 2, t_x + 2] = w[:, :, ky, kx]
    return w2


def _s2d_stem(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    xs = F.pad(space_to_depth(x), (2, 1, 2, 1))
    return _conv(xs, space_to_depth_stem_kernel(w), 1, 0, compute_dtype)


def keypoint_cnn_apply(
    sd: dict[str, torch.Tensor],
    x: torch.Tensor,
    train: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    s2d_stem: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Forward pass of NCHW images (B, C, H, W).

    ``sd`` holds parameters and BN running stats. Returns (logits (B, 2K) in
    at least f32, stats): with ``train`` the BN layers normalize with batch
    statistics and ``stats`` holds the updated running statistics; without,
    ``stats`` is the running statistics of ``sd`` unchanged. ``s2d_stem``
    runs the stem as a 4x4 stride-1 conv over space-to-depth input (even
    H, W), numerically the same conv.
    """
    stats = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    new_stats = dict(stats) if train else None
    with _full_f32():
        if s2d_stem and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            out = _s2d_stem(x, sd["conv1.weight"], compute_dtype)
        else:
            out = _conv(x, sd["conv1.weight"], 2, 3, compute_dtype)
        out = torch.relu(_batchnorm(out, sd, "bn1", train, new_stats))
        out = _max_pool(out)
        for prefix, stride in _block_prefixes():
            identity = out
            h = _conv(out, sd[f"{prefix}.conv1.weight"], stride, 1, compute_dtype)
            h = torch.relu(_batchnorm(h, sd, f"{prefix}.bn1", train, new_stats))
            h = _conv(h, sd[f"{prefix}.conv2.weight"], 1, 1, compute_dtype)
            h = _batchnorm(h, sd, f"{prefix}.bn2", train, new_stats)
            if f"{prefix}.downsample.0.weight" in sd:
                identity = _conv(out, sd[f"{prefix}.downsample.0.weight"], stride, 0, compute_dtype)
                identity = _batchnorm(identity, sd, f"{prefix}.downsample.1", train, new_stats)
            out = torch.relu(h + identity)
        logits = _head(out, sd, torch.promote_types(x.dtype, torch.float32))
    return logits, (new_stats if train else stats)


def _conv_bn_pairs(sd: dict):
    """(conv, bn) name pairs of the network, in order."""
    yield "conv1", "bn1"
    for prefix, _ in _block_prefixes():
        yield f"{prefix}.conv1", f"{prefix}.bn1"
        yield f"{prefix}.conv2", f"{prefix}.bn2"
        if f"{prefix}.downsample.0.weight" in sd:
            yield f"{prefix}.downsample.0", f"{prefix}.downsample.1"


def fold_batchnorm(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Folds every (conv, bn) pair into (scaled conv weight, bias), in the
    parameters' own dtype (f32), before any cast to the compute dtype.

    Maps ``<conv>.weight`` -> folded OIHW weight and ``<conv>.bias`` ->
    folded bias, plus the fc head unchanged.
    """
    folded: dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for conv, bn in _conv_bn_pairs(sd):
            scale = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + BN_EPS)
            folded[f"{conv}.weight"] = sd[f"{conv}.weight"] * scale[:, None, None, None]
            folded[f"{conv}.bias"] = sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * scale
        folded["fc.weight"] = sd["fc.weight"].detach()
        folded["fc.bias"] = sd["fc.bias"].detach()
    return folded


def keypoint_cnn_apply_folded(
    folded: dict[str, torch.Tensor],
    x: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    s2d_stem: bool = False,
) -> torch.Tensor:
    """Inference with BN pre-folded: conv + bias + relu chains, the bias add
    and relu in ``compute_dtype`` as in the JAX package. NCHW in, (B, 2K)
    f32 out."""

    def conv_bias(h, name, stride, padding):
        out = _conv(h, folded[f"{name}.weight"], stride, padding, compute_dtype)
        return out + folded[f"{name}.bias"].to(out.dtype)[:, None, None]

    with _full_f32():
        if s2d_stem:
            out = _s2d_stem(x, folded["conv1.weight"], compute_dtype)
            out = torch.relu(out + folded["conv1.bias"].to(out.dtype)[:, None, None])
        else:
            out = torch.relu(conv_bias(x, "conv1", 2, 3))
        out = _max_pool(out)
        for prefix, stride in _block_prefixes():
            identity = out
            h = torch.relu(conv_bias(out, f"{prefix}.conv1", stride, 1))
            h = conv_bias(h, f"{prefix}.conv2", 1, 1)
            if f"{prefix}.downsample.0.weight" in folded:
                identity = conv_bias(out, f"{prefix}.downsample.0", stride, 0)
            out = torch.relu(h + identity)
        return _head(out, folded, torch.promote_types(x.dtype, torch.float32))


class _Weights(nn.Module):
    """Parameter holder for one conv or linear layer; the arithmetic is in
    the functions above. Left uninitialized: :class:`KeypointCNN` draws it."""

    def __init__(self, shape: tuple, bias: bool, device: torch.device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        if bias:
            self.bias = nn.Parameter(torch.empty(shape[0], device=device))


class _BatchNorm(nn.Module):
    """Parameter/buffer holder for one BN layer (weight, bias, running stats);
    the arithmetic is :func:`_batchnorm`."""

    def __init__(self, c: int, device: torch.device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))


class _BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, downsample: bool, device: torch.device):
        super().__init__()
        self.conv1 = _Weights((c_out, c_in, 3, 3), False, device)
        self.bn1 = _BatchNorm(c_out, device)
        self.conv2 = _Weights((c_out, c_out, 3, 3), False, device)
        self.bn2 = _BatchNorm(c_out, device)
        if downsample:
            self.downsample = nn.Sequential(
                _Weights((c_out, c_in, 1, 1), False, device), _BatchNorm(c_out, device)
            )


class KeypointCNN(nn.Module):
    """The keypoint ResNet-18 as a module; ``forward`` is
    :func:`keypoint_cnn_apply` on the module's own parameters, updating the
    running statistics in place in train mode.

    Initialization matches the JAX package's (torchvision's kaiming fan-out
    normal for convs, torch ``Linear``'s uniform for the head), drawn on the
    CPU from ``generator`` (seed 0 when None) so one seed gives the same
    weights on every device.
    """

    def __init__(
        self,
        n_keypoints: int = 8,
        num_channels: int = 3,
        head: str = "avgpool",
        feat_hw: int = 8,
        device: str | torch.device | None = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if head == "avgpool":
            fc_in = 512
        elif head == "spatial":
            fc_in = feat_hw * feat_hw * 512
        else:
            raise ValueError(f"unknown head {head!r}")
        self.conv1 = _Weights((64, num_channels, 7, 7), False, dev)
        self.bn1 = _BatchNorm(64, dev)
        c_in = 64
        for stage_idx, (num_blocks, c_out) in enumerate(RESNET18_STAGES):
            blocks = [
                _BasicBlock(c_in if i == 0 else c_out, c_out, i == 0 and stage_idx > 0, dev)
                for i in range(num_blocks)
            ]
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*blocks))
            c_in = c_out
        self.fc = _Weights((2 * n_keypoints, fc_in), True, dev)
        self._init(generator if generator is not None else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if p.dim() == 4:
                fan_out = p.shape[0] * p.shape[2] * p.shape[3]
                std = math.sqrt(2.0 / fan_out)
                p.copy_(std * torch.randn(p.shape, generator=gen))
            elif name.startswith("fc."):
                bound = 1.0 / math.sqrt(self.fc.weight.shape[1])
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sd = dict(self.named_parameters())
        sd.update(self.named_buffers())
        logits, stats = keypoint_cnn_apply(sd, x, train=self.training)
        if self.training:
            with torch.no_grad():
                for name, buf in self.named_buffers():
                    buf.copy_(stats[name])
        return logits
