"""SwinV2-T as a camera cell's detector (``"detector": "swinv2_t"``).

The plug-in gives every function ``detectors/resnet18.py`` lists except
``program_b1``: only ``detector.b1_ms`` reads that, and its layer is
ResNet-18's folded forward, which does not list this cell. The
architecture is the configuration's (``embed_dim``, ``depths``,
``num_heads``, ``window_size``, ``patch_size``, ``mlp_ratio``), the weights
in the official repository's names, the reference ``reference/swinv2.py``.
Besides: ``window_attn_work(config)``, the operations and bytes of a
frame's window-attention calls, for ``swinv2.window_attn_roofline``.
"""

from __future__ import annotations

import math

import torch

from benchmark import inputs
from benchmark.reference import swinv2 as ref

HEAD = ("head.weight", "head.bias")
CPB_HIDDEN = 512  # the position-bias MLP's hidden width

prepare = ref.prepare
features = ref.features
detect = ref.detect


def _stages(config: dict):
    """(stage, depth, heads, channels, map side) of each stage."""
    side = config["model_h"] // config["patch_size"]
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        yield i, depth, heads, config["embed_dim"] * 2**i, side
        side //= 2


def shapes(config: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, draw) of every tensor, in the official names; the draws
    are :func:`weights`'."""
    c0, ps = config["embed_dim"], config["patch_size"]
    out = [("patch_embed.proj.weight", (c0, config["num_channels"], ps, ps), "conv"),
           ("patch_embed.proj.bias", (c0,), "conv"),
           ("patch_embed.norm.weight", (c0,), "ln_w"), ("patch_embed.norm.bias", (c0,), "small")]
    hidden = config["mlp_ratio"]
    last = len(config["depths"]) - 1
    for i, depth, heads, c, _ in _stages(config):
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            out += [
                (f"{p}.norm1.weight", (c,), "ln_w"), (f"{p}.norm1.bias", (c,), "small"),
                (f"{p}.attn.logit_scale", (heads, 1, 1), "scale"),
                (f"{p}.attn.cpb_mlp.0.weight", (CPB_HIDDEN, 2), "cpb0_w"),
                (f"{p}.attn.cpb_mlp.0.bias", (CPB_HIDDEN,), "cpb0_b"),
                (f"{p}.attn.cpb_mlp.2.weight", (heads, CPB_HIDDEN), "cpb2"),
                (f"{p}.attn.qkv.weight", (3 * c, c), "normal"),
                (f"{p}.attn.q_bias", (c,), "small"), (f"{p}.attn.v_bias", (c,), "small"),
                (f"{p}.attn.proj.weight", (c, c), "normal"), (f"{p}.attn.proj.bias", (c,), "small"),
                (f"{p}.norm2.weight", (c,), "ln_w"), (f"{p}.norm2.bias", (c,), "small"),
                (f"{p}.mlp.fc1.weight", (hidden * c, c), "normal"), (f"{p}.mlp.fc1.bias", (hidden * c,), "small"),
                (f"{p}.mlp.fc2.weight", (c, hidden * c), "normal"), (f"{p}.mlp.fc2.bias", (c,), "small"),
            ]
        if i < last:
            p = f"layers.{i}.downsample"
            out += [(f"{p}.reduction.weight", (2 * c, 4 * c), "normal"),
                    (f"{p}.norm.weight", (2 * c,), "ln_w"), (f"{p}.norm.bias", (2 * c,), "small")]
    c_last = c0 * 2**last
    return out + [("norm.weight", (c_last,), "ln_w"), ("norm.bias", (c_last,), "small"),
                  ("head.weight", (2 * config["n_keypoints"], c_last), "normal"),
                  ("head.bias", (2 * config["n_keypoints"],), "small")]


def weights(seed: int, config: dict, device) -> dict:
    """Seeded f32 weights on ``device``, one ``randn`` and one ``rand`` for
    all of them: linear weights N(0, 0.02) as the official init; every
    parameter the official init leaves at a constant drawn away from it (LN
    weights in [0.8, 1.2), LN, linear, q and v biases in +-0.05), so that
    each enters the result; the patch convolution U(+-1/sqrt(fan_in)), as
    PyTorch's default; the position-bias MLP with first layer N(0, 1) and
    bias U(+-0.5), second layer N(0, 4/512), so that the bias varies over
    the window by several logits; logit scales U(ln 5, ln 200), so that
    about a fifth of the heads lie above ln 100, where the clamp acts."""
    fan_in = config["num_channels"] * config["patch_size"] ** 2
    normal = {"normal": 0.02, "cpb0_w": 1.0, "cpb2": 2.0 / math.sqrt(CPB_HIDDEN)}
    uniform = {  # (low, high)
        "ln_w": (0.8, 1.2), "small": (-0.05, 0.05), "cpb0_b": (-0.5, 0.5),
        "conv": (-1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in)), "scale": (math.log(5.0), math.log(200.0)),
    }
    gen = inputs.device_generator(seed, inputs.TAG_WEIGHTS, device)
    table = shapes(config)
    parts = {}
    for kinds, draw in ((normal, torch.randn), (uniform, torch.rand)):
        mine = [(name, shape, kind) for name, shape, kind in table if kind in kinds]
        sizes = [math.prod(shape) for _, shape, _ in mine]
        for (name, shape, kind), x in zip(mine, torch.split(draw(sum(sizes), generator=gen, device=device), sizes)):
            if kinds is normal:
                parts[name] = (x * normal[kind]).reshape(shape)
            else:
                lo, hi = uniform[kind]
                parts[name] = (lo + (hi - lo) * x).reshape(shape)
    return {name: parts[name] for name, _, _ in table}


def _attn_macs(config: dict) -> int:
    """q.k and P.V of every block: 2 x 64 x tokens x channels each."""
    n = config["window_size"] ** 2
    return sum(depth * 2 * n * side * side * c for _, depth, _, c, side in _stages(config))


def forward_flops(config: dict) -> int:
    """Multiply-adds x 2 of one frame's linear layers (patch embedding, qkv,
    projection, MLP, merging, head) and attention products (q.k, P.V); LN,
    softmax, GELU, the bias adds and the position-bias MLP (worked out at
    load) are not counted. 11,853,127,680 at 4 channels, 16 outputs and the
    published widths."""
    ps, c0 = config["patch_size"], config["embed_dim"]
    side0 = config["model_h"] // ps
    macs = side0 * side0 * c0 * config["num_channels"] * ps * ps
    last = len(config["depths"]) - 1
    for i, depth, _, c, side in _stages(config):
        macs += depth * side * side * c * c * (3 + 1 + 2 * config["mlp_ratio"])
        if i < last:
            macs += (side // 2) ** 2 * 4 * c * 2 * c
    macs += c0 * 2**last * 2 * config["n_keypoints"]
    return 2 * (macs + _attn_macs(config))


def window_attn_work(config: dict) -> tuple[int, int]:
    """(operations, bytes) of one frame's window-attention calls: q.k and
    P.V (2 x the multiply-adds); q, k and v read once and the output
    written once in the compute dtype, each block's bias table (heads, 64,
    64) and head scales read once in f32. 478,150,656 operations and
    17,203,752 bytes at the published widths in bf16."""
    size = torch.finfo(getattr(torch, config["compute_dtype"])).bits // 8
    n = config["window_size"] ** 2
    bytes_moved = sum(depth * (side * side * 4 * c * size + heads * (n * n + 1) * 4)
                      for _, depth, heads, c, side in _stages(config))
    return 2 * _attn_macs(config), bytes_moved


def streaming_fields(config: dict) -> dict:
    return {"detector": "swinv2_t"}

