"""Plain f32 SwinV2 keypoint regressor: the yardstick of the SwinV2 detector.

Swin Transformer V2 as Liu et al. describe it ("Swin Transformer V2:
Scaling Up Capacity and Resolution", arXiv:2111.09883) and as the official
``swin_transformer_v2.py`` of github.com/microsoft/Swin-Transformer computes
it, on weights in that file's names: a patch-embedding convolution and LN;
stages of blocks ``x + LN(attn(x))``, ``x + LN(mlp(x))``, whose attention is
scaled cosine attention over windows (``exp(min(logit_scale, ln 100))``
per head) with a continuous position bias (``16 sigmoid`` of a two-layer
MLP over log-spaced relative coordinates), every other block's windows
rolled by half a window with a -100 mask between regions (neither where the
map is no larger than a window); patch merging between stages; the final
LN, the mean over tokens and the head. Plain ``torch`` operations in
float32 with TF32 off: the MLP, the clamp, the coordinate tables and the
masks are worked out again on every call, from the raw weights.

Departures from the published model: the input's channel count and the
head's width are the weights' (4 channels and 16 keypoint coordinates in
the benchmark's configuration, for 3 and 1000 classes), no drop-path
(inference), and the window is an argument (8, the published, by default).
Everything else is read from the weights' shapes.

``quantize=True`` computes every linear layer (the patch embedding, qkv,
the attention's projection, the MLP's two layers and patch merging's
reduction; the head stays in f32, as ``reference/detector.py`` leaves its
head) on its input and weight rounded to float8 e4m3, one scale per tensor:
the precision below the bf16 that the configuration states, the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.detector import fp8_round
from benchmark.reference.pipeline import matmul_precision

WINDOW = 8
LN_EPS = 1e-5


def _linear(x, w, b=None, quantize=False):
    if quantize:
        x, w = fp8_round(x), fp8_round(w)
    return F.linear(x, w, b)


def _ln(x, sd, name):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], LN_EPS)


def relative_coords_table(window: int) -> torch.Tensor:
    """(2w-1, 2w-1, 2): relative offsets over (w - 1), times 8, then
    sign(x) log2(|x| + 1) / log2(8) (pretrained window 0)."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    table = torch.stack(torch.meshgrid([r, r], indexing="ij")).permute(1, 2, 0).contiguous()
    table = table / (window - 1) * 8
    return torch.sign(table) * torch.log2(torch.abs(table) + 1.0) / math.log2(8)


def relative_position_index(window: int) -> torch.Tensor:
    """(w^2, w^2): the table row of each pair of tokens in a window."""
    coords = torch.stack(torch.meshgrid([torch.arange(window), torch.arange(window)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, w, w, C)."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """(B * windows, w, w, C) -> (B, H, W, C)."""
    b = int(windows.shape[0] / (h * w / window / window))
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def shift_mask(h: int, w: int, window: int, shift: int, device) -> torch.Tensor:
    """(windows, w^2, w^2): -100 between tokens whose regions of the rolled
    frame differ, 0 within one region (the official image-mask construction)."""
    img = torch.zeros((1, h, w, 1), device=device)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = window_partition(img, window).view(-1, window * window)
    mask = mw.unsqueeze(1) - mw.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def position_bias(sd: dict, prefix: str, window: int) -> torch.Tensor:
    """(heads, w^2, w^2): 16 sigmoid(cpb_mlp(table))[index]."""
    table = relative_coords_table(window).to(sd[f"{prefix}.cpb_mlp.0.weight"].device)
    hidden = torch.relu(F.linear(table, sd[f"{prefix}.cpb_mlp.0.weight"], sd[f"{prefix}.cpb_mlp.0.bias"]))
    heads = sd[f"{prefix}.cpb_mlp.2.weight"].shape[0]
    bias_table = F.linear(hidden, sd[f"{prefix}.cpb_mlp.2.weight"]).view(-1, heads)
    index = relative_position_index(window).to(table.device)
    bias = bias_table[index.view(-1)].view(window * window, window * window, -1).permute(2, 0, 1).contiguous()
    return 16 * torch.sigmoid(bias)


def attention(sd: dict, prefix: str, x: torch.Tensor, window: int, mask, quantize: bool = False) -> torch.Tensor:
    """Window attention of (B * windows, w^2, C) tokens, from the raw weights
    under ``prefix`` (``...attn``)."""
    b_, n, c = x.shape
    heads = sd[f"{prefix}.logit_scale"].shape[0]
    qkv_bias = torch.cat((sd[f"{prefix}.q_bias"], torch.zeros_like(sd[f"{prefix}.v_bias"]), sd[f"{prefix}.v_bias"]))
    qkv = _linear(x, sd[f"{prefix}.qkv.weight"], qkv_bias, quantize)
    q, k, v = qkv.reshape(b_, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)
    logit_scale = torch.clamp(sd[f"{prefix}.logit_scale"], max=math.log(1.0 / 0.01)).exp()
    attn = attn * logit_scale + position_bias(sd, prefix, window).unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(b_, n, c)
    return _linear(out, sd[f"{prefix}.proj.weight"], sd[f"{prefix}.proj.bias"], quantize)


def block(sd: dict, prefix: str, x: torch.Tensor, h: int, w: int, window: int, shift: int,
          quantize: bool = False) -> torch.Tensor:
    """One block on (B, H*W, C): the window the map where the map is no
    larger than ``window``, and then no shift."""
    if min(h, w) <= window:
        window, shift = min(h, w), 0
    b, _, c = x.shape
    shortcut = x
    x = x.view(b, h, w, c)
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = window_partition(x, window).view(-1, window * window, c)
    mask = shift_mask(h, w, window, shift, x.device) if shift > 0 else None
    out = attention(sd, f"{prefix}.attn", windows, window, mask, quantize).view(-1, window, window, c)
    x = window_reverse(out, window, h, w)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + _ln(x.reshape(b, h * w, c), sd, f"{prefix}.norm1")
    hidden = F.gelu(_linear(x, sd[f"{prefix}.mlp.fc1.weight"], sd[f"{prefix}.mlp.fc1.bias"], quantize))
    mlp = _linear(hidden, sd[f"{prefix}.mlp.fc2.weight"], sd[f"{prefix}.mlp.fc2.bias"], quantize)
    return x + _ln(mlp, sd, f"{prefix}.norm2")


def merge(sd: dict, prefix: str, x: torch.Tensor, h: int, w: int, quantize: bool = False) -> torch.Tensor:
    """Patch merging: (B, H*W, C) -> (B, H*W/4, 2C)."""
    b, _, c = x.shape
    x = x.view(b, h, w, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1).view(b, -1, 4 * c)
    return _ln(_linear(x, sd[f"{prefix}.reduction.weight"], None, quantize), sd, f"{prefix}.norm")


def _stages(sd: dict) -> list[int]:
    """Blocks in each stage, from the weights' names."""
    depths = []
    while f"layers.{len(depths)}.blocks.0.norm1.weight" in sd:
        i = len(depths)
        depths.append(sum(1 for k in sd if k.startswith(f"layers.{i}.blocks.") and k.endswith(".norm1.weight")))
    return depths


def prepare(sd: dict) -> dict:
    """The raw weights in f32: the reference works everything else out
    again on every call."""
    return {k: v.float() for k, v in sd.items()}


def features(sd: dict, x: torch.Tensor, quantize: bool = False, window: int = WINDOW) -> torch.Tensor:
    """(B, C) pooled features of NCHW images."""
    with matmul_precision(False):
        w_proj = sd["patch_embed.proj.weight"]
        ps = w_proj.shape[-1]
        if quantize:
            h = F.conv2d(fp8_round(x.float()), fp8_round(w_proj), sd["patch_embed.proj.bias"], stride=ps)
        else:
            h = F.conv2d(x.float(), w_proj, sd["patch_embed.proj.bias"], stride=ps)
        hh, ww = h.shape[-2:]
        h = _ln(h.flatten(2).transpose(1, 2), sd, "patch_embed.norm")
        depths = _stages(sd)
        for i, depth in enumerate(depths):
            for j in range(depth):
                h = block(sd, f"layers.{i}.blocks.{j}", h, hh, ww, window, 0 if j % 2 == 0 else window // 2, quantize)
            if i < len(depths) - 1:
                h = merge(sd, f"layers.{i}.downsample", h, hh, ww, quantize)
                hh, ww = hh // 2, ww // 2
        return _ln(h, sd, "norm").mean(dim=1)


def detect(sd: dict, x: torch.Tensor, quantize: bool = False, window: int = WINDOW) -> torch.Tensor:
    """(B, 2K) normalized keypoints of NCHW images, the head in f32."""
    with matmul_precision(False):
        return features(sd, x, quantize, window) @ sd["head.weight"].T + sd["head.bias"]
