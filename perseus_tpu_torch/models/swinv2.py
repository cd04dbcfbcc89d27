"""SwinV2 keypoint regressor: the tracker's second detector, for serving.

Swin Transformer V2 (Liu et al., arXiv:2111.09883; the official
``swin_transformer_v2.py`` of github.com/microsoft/Swin-Transformer, whose
parameter names the weights keep) as a keypoint regressor. The JAX package
has no counterpart. An NCHW model input goes through

  patch embedding (a 4x4 stride-4 convolution, written as a linear layer
  over the patches) and LN
  -> four stages of blocks, each ``x + LN(attn(x))`` then
     ``x + LN(mlp(x))`` (residual post-norm), the attention scaled cosine
     attention over 8x8 windows with a continuous position bias, every
     other block's windows shifted cyclically by 4 (no shift, one window,
     where the map is no larger than a window: all of stage 4)
  -> patch merging after stages 1-3 (the 2x2 neighbours concatenated, a
     bias-free ``Linear(4C, 2C)``, LN)
  -> the final LN, the mean over tokens and the head: (B, 2K) normalized
     keypoints.

Departures from the published model: ``in_chans`` input channels (4, RGBD)
and a ``num_outputs``-wide regression head (16: 8 corners x 2) in place of
3 channels and 1000 classes, and no drop-path (inference).

:func:`prepare` works out once, from the weights, what depends on nothing
else at inference: each block's position-bias table (heads, 64, 64) in f32,
``16 sigmoid(cpb_mlp(coords))[index]``; each head's ``exp(min(logit_scale,
ln 100))``; the qkv bias ``(q_bias, 0, v_bias)``; the linear weights in the
compute dtype. :func:`swinv2_apply` is the serving forward: linear layers in
the compute dtype (bf16 when serving), LN, softmax and the residual stream
in f32. Each block's window attention is one call of
:func:`window_attention`: on a CUDA tensor one launch of ``csrc/window_attn.cu``
(kernel #8) inside the span ``swinv2.window_attn``, on a CPU tensor its
plain version :func:`window_attention_reference`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from perseus_tpu_torch.models import _build
from perseus_tpu_torch.models.resnet import _full_f32
from perseus_tpu_torch.utils.spans import span

__all__ = [
    "SwinV2Config",
    "swinv2_tiny_patch4_window8_256",
    "prepare",
    "swinv2_apply",
    "window_attention",
    "window_attention_reference",
]

LN_EPS = 1e-5  # nn.LayerNorm's
LOGIT_SCALE_MAX = math.log(100.0)  # the clamp: a temperature of at least 0.01
MASK = -100.0  # between tokens of different regions of a shifted window
BIAS_SCALE = 16.0  # 16 sigmoid(cpb): the bias lies in (0, 16)


@dataclass(frozen=True)
class SwinV2Config:
    img_size: int = 256
    patch_size: int = 4
    in_chans: int = 4
    num_outputs: int = 16
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 8
    mlp_ratio: int = 4

    def stages(self):
        """(stage, depth, heads, channels, map side, window, shift of the
        odd blocks) of each stage: the window is the map where the map is no
        larger than a window, and then nothing is shifted."""
        side = self.img_size // self.patch_size
        for i, (depth, heads) in enumerate(zip(self.depths, self.num_heads)):
            window = min(self.window_size, side)
            shift = 0 if side <= self.window_size else self.window_size // 2
            yield i, depth, heads, self.embed_dim * 2**i, side, window, shift
            side //= 2


def swinv2_tiny_patch4_window8_256(in_chans: int = 4, num_outputs: int = 16) -> SwinV2Config:
    """The published SwinV2-T (``configs/swinv2/swinv2_tiny_patch4_window8_256.yaml``):
    256x256 input, patch 4, embed 96, depths 2/2/6/2, heads 3/6/12/24,
    window 8, MLP ratio 4, q and v biases, pretrained window 0."""
    return SwinV2Config(in_chans=in_chans, num_outputs=num_outputs)


def _coords_table(window: int) -> torch.Tensor:
    """((2w-1)^2, 2) log-spaced relative coordinates, the cpb MLP's input:
    sign(x) log2(1 + |8 x / (w - 1)|) / log2(8)."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    table = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1) / max(window - 1, 1) * 8.0
    return (torch.sign(table) * torch.log2(table.abs() + 1.0) / math.log2(8.0)).reshape(-1, 2)


def _relative_index(window: int) -> torch.Tensor:
    """(w^2, w^2) index of each token pair's relative offset in the table."""
    r = torch.arange(window)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def prepare(sd: dict, cfg: SwinV2Config, compute_dtype: torch.dtype = torch.float32) -> dict:
    """The serving form of ``sd`` (the official names): per block its
    position-bias table ``bias`` (heads, w^2, w^2) f32, head scales
    ``scale`` (heads,) f32 and qkv bias ``qkv.bias`` (3C,); linear weights
    in ``compute_dtype``, LN parameters and the head in f32."""
    dev = sd["patch_embed.proj.weight"].device
    f32 = {k: v.detach().to(dev, torch.float32) for k, v in sd.items()}
    w = lambda name: f32[name].to(compute_dtype)  # noqa: E731
    proj = f32["patch_embed.proj.weight"]
    if proj.shape != (cfg.embed_dim, cfg.in_chans, cfg.patch_size, cfg.patch_size):
        raise ValueError(f"patch_embed.proj.weight {tuple(proj.shape)} does not fit {cfg}")
    if f32["head.weight"].shape != (cfg.num_outputs, cfg.embed_dim * 2 ** (len(cfg.depths) - 1)):
        raise ValueError(f"head.weight {tuple(f32['head.weight'].shape)} does not fit {cfg}")
    out = {
        "patch_embed.proj.weight": proj.reshape(cfg.embed_dim, -1).to(compute_dtype),
        "patch_embed.proj.bias": w("patch_embed.proj.bias"),
        "head.weight": f32["head.weight"], "head.bias": f32["head.bias"],
    }
    for name in ("patch_embed.norm", "norm"):
        out[f"{name}.weight"], out[f"{name}.bias"] = f32[f"{name}.weight"], f32[f"{name}.bias"]
    tables = {}
    for i, depth, heads, _, _, window, _ in cfg.stages():
        if window not in tables:
            tables[window] = (_coords_table(window).to(dev), _relative_index(window).to(dev))
        coords, index = tables[window]
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            cpb = F.linear(torch.relu(F.linear(coords, f32[f"{p}.attn.cpb_mlp.0.weight"], f32[f"{p}.attn.cpb_mlp.0.bias"])),
                           f32[f"{p}.attn.cpb_mlp.2.weight"])  # ((2w-1)^2, heads)
            out[f"{p}.bias"] = (BIAS_SCALE * torch.sigmoid(cpb[index].permute(2, 0, 1))).contiguous()
            out[f"{p}.scale"] = torch.clamp(f32[f"{p}.attn.logit_scale"].reshape(heads), max=LOGIT_SCALE_MAX).exp()
            q_bias, v_bias = f32[f"{p}.attn.q_bias"], f32[f"{p}.attn.v_bias"]
            out[f"{p}.qkv.bias"] = torch.cat([q_bias, torch.zeros_like(q_bias), v_bias]).to(compute_dtype)
            out[f"{p}.qkv.weight"] = w(f"{p}.attn.qkv.weight")
            for lin in ("attn.proj", "mlp.fc1", "mlp.fc2"):
                out[f"{p}.{lin}.weight"], out[f"{p}.{lin}.bias"] = w(f"{p}.{lin}.weight"), w(f"{p}.{lin}.bias")
            for norm in ("norm1", "norm2"):
                out[f"{p}.{norm}.weight"], out[f"{p}.{norm}.bias"] = f32[f"{p}.{norm}.weight"], f32[f"{p}.{norm}.bias"]
        if i < len(cfg.depths) - 1:
            p = f"layers.{i}.downsample"
            out[f"{p}.reduction.weight"] = w(f"{p}.reduction.weight")
            out[f"{p}.norm.weight"], out[f"{p}.norm.bias"] = f32[f"{p}.norm.weight"], f32[f"{p}.norm.bias"]
    out["config"] = cfg
    return out


def _shift_mask(h: int, w: int, window: int, shift: int, device) -> torch.Tensor:
    """(windows, w^2, w^2): ``MASK`` between tokens of different regions of
    the rolled frame (per axis: before the last window, the last window
    before the wrapped strip, the strip), 0 within one."""
    def regions(n):
        i = torch.arange(n, device=device)
        return (i >= n - window).long() + (i >= n - shift).long()

    label = (regions(h)[:, None] * 3 + regions(w)[None, :]).float()
    label = label.reshape(h // window, window, w // window, window).transpose(1, 2).reshape(-1, window * window)
    return torch.where(label[:, :, None] != label[:, None, :], MASK, 0.0)


def window_attention_reference(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, heads: int, h: int,
                               w: int, window: int, shift: int) -> torch.Tensor:
    """Plain version of :func:`window_attention`, step by step: the (B, H*W,
    3C) qkv product rolled by -``shift``, cut into windows, q and k rows
    normalized, ``(q . k) scale + bias + mask``, softmax, P V, the windows
    put back and rolled by ``shift``; all in f32, returned in qkv's dtype as
    (B, H*W, C)."""
    b, _, c3 = qkv.shape
    c = c3 // 3
    x = qkv.float().reshape(b, h, w, c3)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    n = window * window
    x = x.reshape(b, h // window, window, w // window, window, c3).transpose(2, 3).reshape(-1, n, 3, heads, c // heads)
    q, k, v = x.permute(2, 0, 3, 1, 4)  # (B nW, heads, n, d) each
    attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)
    attn = attn * scale[:, None, None] + bias
    if shift:
        nw = (h // window) * (w // window)
        attn = (attn.reshape(b, nw, heads, n, n) + _shift_mask(h, w, window, shift, qkv.device)[None, :, None]).reshape(-1, heads, n, n)
    out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(b, h // window, w // window, window, window, c)
    out = out.transpose(2, 3).reshape(b, h, w, c)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
    return out.reshape(b, h * w, c).to(qkv.dtype)


class _Args(ctypes.Structure):
    """``csrc/window_attn.cu``'s ``WindowAttnArgs``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("qkv", "out", "bias", "scale")] + [
        (name, ctypes.c_int) for name in ("batch", "height", "width", "heads", "shift")
    ]


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_WINDOW, KERNEL_HEAD_DIM = 8, 32  # the kernel's window side and channels a head


@functools.cache
def _kernel():
    """The launch of ``csrc/window_attn.cu``, built and loaded at first use."""
    launch = _build.load_library("window_attn").perseus_window_attn
    launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return launch


def window_attention(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, heads: int, h: int, w: int,
                     window: int, shift: int) -> torch.Tensor:
    """One block's shifted-window cosine attention: (B, H*W, 3C) qkv in token
    order -> (B, H*W, C) in its dtype; ``scale`` (heads,) and ``bias``
    (heads, w^2, w^2) f32 from :func:`prepare`.

    A CPU tensor takes the plain version. A CUDA tensor launches kernel #8
    on the current stream, or raises: for a window other than 8, heads
    other than 32 channels wide, a dtype other than f32 or bf16, and a
    failed build or launch. Each launch adds one to
    ``window_attention.launches``."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, scale, bias, heads, h, w, window, shift)
    name = "window_attention"
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    b, tokens, c3 = qkv.shape
    if window != KERNEL_WINDOW or c3 != 3 * heads * KERNEL_HEAD_DIM or tokens != h * w:
        raise ValueError(f"{name}: the kernel takes windows of {KERNEL_WINDOW} and heads of {KERNEL_HEAD_DIM} "
                         f"channels (qkv {tuple(qkv.shape)}, {heads} heads, {h}x{w}, window {window})")
    if qkv.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {qkv.dtype} (the kernel takes float32 and bfloat16)")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32 or scale.shape != (heads,) or bias.shape != (
            heads, window * window, window * window):
        raise ValueError(f"{name}: scale (heads,) and bias (heads, 64, 64) are float32")
    qkv, scale, bias = qkv.contiguous(), scale.contiguous(), bias.contiguous()
    out = torch.empty((b, tokens, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    args = _Args(qkv=qkv.data_ptr(), out=out.data_ptr(), bias=bias.data_ptr(), scale=scale.data_ptr(), batch=b,
                 height=h, width=w, heads=heads, shift=shift)
    with torch.cuda.device(qkv.device):
        err = _kernel()(ctypes.byref(args), _KERNEL_DTYPES[qkv.dtype], torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    window_attention.launches += 1
    return out


# the count of the kernel's launches, added to right after a launch
window_attention.launches = 0


def _layer_norm(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def _linear(x: torch.Tensor, p: dict, name: str, dtype: torch.dtype, bias: bool = True) -> torch.Tensor:
    return F.linear(x.to(dtype), p[f"{name}.weight"].to(dtype), p[f"{name}.bias"].to(dtype) if bias else None)


def _block(p: dict, prefix: str, x: torch.Tensor, heads: int, side: int, window: int, shift: int,
           dtype: torch.dtype) -> torch.Tensor:
    """One block on the f32 residual stream x (B, side^2, C)."""
    qkv = _linear(x, p, f"{prefix}.qkv", dtype)
    with span("swinv2.window_attn", qkv.device):
        attn = window_attention(qkv, p[f"{prefix}.scale"], p[f"{prefix}.bias"], heads, side, side, window, shift)
    x = x + _layer_norm(_linear(attn, p, f"{prefix}.attn.proj", dtype), p, f"{prefix}.norm1")
    hidden = F.gelu(_linear(x, p, f"{prefix}.mlp.fc1", dtype))
    return x + _layer_norm(_linear(hidden, p, f"{prefix}.mlp.fc2", dtype), p, f"{prefix}.norm2")


def _merge(p: dict, prefix: str, x: torch.Tensor, side: int, dtype: torch.dtype) -> torch.Tensor:
    """Patch merging: (B, side^2, C) -> (B, (side/2)^2, 2C), the 2x2
    neighbours x0 [0::2, 0::2], x1 [1::2, 0::2], x2 [0::2, 1::2], x3
    [1::2, 1::2] concatenated, reduced and normalized."""
    b, _, c = x.shape
    x = x.to(dtype).reshape(b, side // 2, 2, side // 2, 2, c)
    x = x.permute(0, 1, 3, 4, 2, 5).reshape(b, (side // 2) ** 2, 4 * c)  # (dx, dy) order: x0, x1, x2, x3
    return _layer_norm(_linear(x, p, f"{prefix}.reduction", dtype, bias=False), p, f"{prefix}.norm")


def swinv2_apply(prepared: dict, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """NCHW model input -> (B, 2K) f32 normalized keypoints, linear layers in
    ``compute_dtype`` (f32: in full f32, TF32 off)."""
    cfg: SwinV2Config = prepared["config"]
    b, ch, hh, ww = x.shape
    ps = cfg.patch_size
    if (ch, hh, ww) != (cfg.in_chans, cfg.img_size, cfg.img_size):
        raise ValueError(f"swinv2_apply: input {tuple(x.shape)}, the model takes (B, {cfg.in_chans}, "
                         f"{cfg.img_size}, {cfg.img_size})")
    with _full_f32():
        side = hh // ps
        patches = x.to(compute_dtype).reshape(b, ch, side, ps, side, ps).permute(0, 2, 4, 1, 3, 5)
        h = _linear(patches.reshape(b, side * side, ch * ps * ps), prepared, "patch_embed.proj", compute_dtype)
        h = _layer_norm(h, prepared, "patch_embed.norm")
        for i, depth, heads, _, side, window, shift in cfg.stages():
            for j in range(depth):
                h = _block(prepared, f"layers.{i}.blocks.{j}", h, heads, side, window, shift if j % 2 else 0,
                           compute_dtype)
            if i < len(cfg.depths) - 1:
                h = _merge(prepared, f"layers.{i}.downsample", h, side, compute_dtype)
        feats = _layer_norm(h, prepared, "norm").mean(dim=1)
        return feats @ prepared["head.weight"].T + prepared["head.bias"]
