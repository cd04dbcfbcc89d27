"""SwinV2's window attention (csrc/window_attn.cu, kernel #8) and the SwinV2-T
serving frame on the card, at the published widths.

``cuda``-marked: they skip without a card. On the card (no JAX there):
``python -m pytest tests/test_torch_swinv2_cuda.py -m cuda --noconftest -q``.

The weights are the benchmark plug-in's seeded draws (benchmark/detectors/
swinv2_t.py), so each block's bias table and head scales are those the
served frame uses.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.detectors import swinv2_t as plugin
from perseus_tpu_torch.models import swinv2
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline
from perseus_tpu_torch.utils.graphed import WARMUP_CALLS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = swinv2.swinv2_tiny_patch4_window8_256(4, 16)
# (stage, block) at each stage's shape: its first block unshifted, its
# second shifted by 4 (stage 4, an 8x8 map in one window, shifts nothing)
CASES = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)]
# The kernel and the plain version compute in f32 from the same inputs, the
# sums in another order and exp, sqrt and division as the card's and
# PyTorch's f32 routines: logits of up to ~116 (a scale of 100 and a bias
# of up to 16) carry f32 rounding of ~1e-5 through exp, so f32 outputs
# agree within 1e-5 of the output's largest magnitude. A bf16 output is
# that result rounded to 8 significant bits, at most 2^-8 of its value off:
# bf16 outputs lie within 2^-8 of the plain f32 value plus the f32 margin.
BF16_REL = 2.0**-8
F32_REL = 1e-5


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs", "rgbd-stream-swinv2t.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def weights():
    _need_cuda()
    return plugin.weights(20, _config(), "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stage,block", CASES)
def test_kernel_matches_the_plain_version_at_each_stage(weights, stage, block):
    _, _, heads, c, side, window, shift = list(ARCH.stages())[stage]
    shift = shift if block % 2 else 0
    prepared = swinv2.prepare(weights, ARCH, torch.bfloat16)
    p = f"layers.{stage}.blocks.{block}"
    scale, bias = prepared[f"{p}.scale"], prepared[f"{p}.bias"]
    gen = torch.Generator(device="cuda").manual_seed(stage * 2 + block)
    qkv = torch.randn(2, side * side, 3 * c, generator=gen, device="cuda")  # batch 2: the image index
    for dtype in (torch.bfloat16, torch.float32):
        x = qkv.to(dtype)
        before = swinv2.window_attention.launches
        got = swinv2.window_attention(x, scale, bias, heads, side, side, window, shift)
        torch.cuda.synchronize()
        assert swinv2.window_attention.launches == before + 1 and got.dtype == dtype
        want = swinv2.window_attention_reference(x.float(), scale, bias, heads, side, side, window, shift)
        err = (got.float() - want).abs()
        margin = F32_REL * float(want.abs().max())
        if dtype == torch.bfloat16:
            assert bool((err <= BF16_REL * want.abs() + margin).all()), f"{dtype}: worst {float(err.max())}"
        else:
            assert float(err.max()) <= margin


@pytest.mark.cuda
def test_the_kernel_refuses_what_it_does_not_take(weights):
    prepared = swinv2.prepare(weights, ARCH, torch.bfloat16)
    scale, bias = prepared["layers.0.blocks.0.scale"], prepared["layers.0.blocks.0.bias"]
    qkv = torch.zeros(1, 64 * 64, 288, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        swinv2.window_attention(qkv, scale, bias, 3, 64, 64, 4, 0)  # windows of 4
    with pytest.raises(TypeError):
        swinv2.window_attention(qkv.half(), scale, bias, 3, 64, 64, 8, 0)


def _frame(seed=6):
    cfg = _config()
    rng = np.random.default_rng(seed)
    frame = rng.random((cfg["frame_h"], cfg["frame_w"], 4), dtype=np.float32)
    frame[..., 3] = 0.15 + 0.3 * frame[..., 3]
    frame[rng.random(frame.shape[:2]) < 0.01, 3] = np.nan
    return frame


@pytest.mark.cuda
def test_a_replayed_frame_equals_the_eager_frame_bit_for_bit_12_launches_a_frame(weights):
    """``StreamingPipeline.__call__`` at the published widths in bf16:
    captured once, replayed a frame; each replay launches kernel #8 once a
    block, 12 times, and gives the eager step's keypoints bit for bit."""
    cfg = StreamingConfig(num_channels=4, amp=True, smooth=False, detector="swinv2_t")
    pipeline = StreamingPipeline(cfg, weights, device="cuda")
    frames = [_frame(s) for s in range(3)]
    before = swinv2.window_attention.launches
    outs = [pipeline(f, None)[0] for f in frames]  # the first captures
    torch.cuda.synchronize()
    assert pipeline._step.graphs == 1
    assert swinv2.window_attention.launches - before == 12 * (len(frames) + WARMUP_CALLS)
    before = swinv2.window_attention.launches
    pipeline(frames[0], None)
    assert swinv2.window_attention.launches - before == 12
    for f, got in zip(frames, outs):
        want = pipeline.step_eager(f, None)[0]
        assert torch.isfinite(got).all() and torch.equal(got, want)
