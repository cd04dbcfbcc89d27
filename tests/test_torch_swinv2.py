"""SwinV2-T as the tracker's detector (perseus_tpu_torch/models/swinv2.py)
against the benchmark's plain reference (benchmark/reference/swinv2.py), on
the CPU in f32, where the window attention is its plain version.

The tiny model: embed 16, depths 2/2, heads 1/2, window 4, at 32x32, so
that stage 1 (8x8 tokens) alternates plain and shifted windows and stage 2
(4x4, no larger than a window) runs full attention, unshifted. The weights
are the benchmark plug-in's draws (every LN, bias and the position-bias MLP
away from its initial value). Port and reference compute the same f32
arithmetic with sums in other orders: 1e-5 of the largest output.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark.detectors import swinv2_t as plugin
from benchmark.reference import pipeline as ref_pipe
from benchmark.reference import swinv2 as ref
from perseus_tpu_torch.models import resnet, swinv2
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline
from perseus_tpu_torch.utils.graphed import kernel_wrappers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "configs", "rgbd-stream-swinv2t.json")) as _f:
    CONFIG = json.load(_f)
TINY = dict(CONFIG, model_h=32, model_w=32, embed_dim=16, depths=[2, 2], num_heads=[1, 2], window_size=4)
TINY_ARCH = swinv2.SwinV2Config(img_size=32, embed_dim=16, depths=(2, 2), num_heads=(1, 2), window_size=4)
REL = 1e-5
# logit scales all under the clamp (ln 10, the paper's initial value) or
# all over it (ln 150: the clamp to ln 100 decides every head's temperature)
SCALES = {"below_clamp": math.log(10.0), "above_clamp": math.log(150.0)}


def _weights(logit_scale=None, seed=3, config=TINY):
    sd = plugin.weights(seed, config, "cpu")
    if logit_scale is not None:
        for k in sd:
            if k.endswith("logit_scale"):
                sd[k] = torch.full_like(sd[k], logit_scale)
    return sd


def _close(got, want):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= REL * float(want.abs().max())


@pytest.mark.parametrize("scale", SCALES)
def test_swinv2_apply_matches_the_reference(scale):
    sd = _weights(SCALES[scale])
    x = torch.rand(2, 4, 32, 32, generator=torch.Generator().manual_seed(1))
    x[:, 3] *= 10.0  # depth in cube units
    got = swinv2.swinv2_apply(swinv2.prepare(sd, TINY_ARCH), x, torch.float32)
    _close(got, ref.detect(ref.prepare(sd), x, window=4))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shift", [0, 2])
def test_a_block_matches_the_reference_block(shift, scale):
    """Stage 1's second block (8x8 tokens, windows of 4) with and without
    its shift, on the same residual stream."""
    sd = _weights(SCALES[scale])
    x = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(2))
    prepared = swinv2.prepare(sd, TINY_ARCH)
    got = swinv2._block(prepared, "layers.0.blocks.1", x, 1, 8, 4, shift, torch.float32)
    _close(got, ref.block(ref.prepare(sd), "layers.0.blocks.1", x, 8, 8, 4, shift))


@pytest.mark.parametrize("shift", [0, 2])
def test_the_plain_window_attention_is_the_reference_attention(shift):
    """``window_attention`` on a CPU tensor (its plain version, no launch)
    against the reference's roll, partition, attention (its projection the
    identity), reverse and roll back, from the raw weights."""
    raw = _weights()
    prepared = swinv2.prepare(raw, TINY_ARCH)
    sd = ref.prepare(raw)
    p = "layers.1.blocks.0"  # 2 heads
    c = 32
    sd[f"{p}.attn.proj.weight"], sd[f"{p}.attn.proj.bias"] = torch.eye(c), torch.zeros(c)
    side = 8
    x = torch.randn(1, side * side, c, generator=torch.Generator().manual_seed(4))
    qkv = torch.nn.functional.linear(x, prepared[f"{p}.qkv.weight"], prepared[f"{p}.qkv.bias"])
    before = swinv2.window_attention.launches
    got = swinv2.window_attention(qkv, prepared[f"{p}.scale"], prepared[f"{p}.bias"], 2, side, side, 4, shift)
    assert swinv2.window_attention.launches == before and swinv2.window_attention in kernel_wrappers()
    rolled = torch.roll(x.view(1, side, side, c), (-shift, -shift), (1, 2)) if shift else x.view(1, side, side, c)
    windows = ref.window_partition(rolled, 4).view(-1, 16, c)
    mask = ref.shift_mask(side, side, 4, shift, "cpu") if shift else None
    out = ref.window_reverse(ref.attention(sd, f"{p}.attn", windows, 4, mask).view(-1, 4, 4, c), 4, side, side)
    if shift:
        out = torch.roll(out, (shift, shift), (1, 2))
    _close(got, out.reshape(1, side * side, c))


def test_the_swinv2_pipeline_matches_the_reference_eagerly_on_the_cpu():
    """``StreamingPipeline`` with ``detector="swinv2_t"`` at the published
    widths, f32 on the CPU (the call is the eager step there), against the
    reference's preprocess, forward and denormalize on the same frame."""
    sd = _weights(config=CONFIG)
    cfg = StreamingConfig(num_channels=4, amp=False, smooth=False, detector="swinv2_t")
    pipeline = StreamingPipeline(cfg, sd, device="cpu")
    assert pipeline.folded["config"] == swinv2.swinv2_tiny_patch4_window8_256(4, 16)
    rng = np.random.default_rng(5)
    frame = rng.random((280, 300, 4), dtype=np.float32)
    frame[..., 3] = 0.15 + 0.3 * frame[..., 3]
    frame[rng.random((280, 300)) < 0.02, 3] = np.nan
    kp, image, carry, _ = pipeline(frame, None)
    assert carry is None and kp.shape == (8, 2) and image.shape == (256, 256, 4)
    x = ref_pipe.preprocess(torch.from_numpy(frame), CONFIG["cube_scale"], CONFIG["depth_near_m"], CONFIG["depth_far_m"], 256, 256)
    want = ref_pipe.denormalize(ref.detect(ref.prepare(sd), x), 256, 256)[0]
    torch.testing.assert_close(image, x[0].permute(1, 2, 0), rtol=0, atol=0)
    # pixels: the normalized outputs' 1e-5 of their largest, times (256 - 1) / 2
    _close(kp, want)


def test_a_default_streaming_config_still_builds_the_resnet_path():
    assert StreamingConfig().detector == "resnet18"
    sd = resnet.KeypointCNN(num_channels=4, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    pipeline = StreamingPipeline(StreamingConfig(num_channels=4, model_h=32, model_w=32, amp=False, smooth=False),
                                 sd, device="cpu")
    assert "conv1.bias" in pipeline.folded and "config" not in pipeline.folded
    with pytest.raises(ValueError, match="detector"):
        StreamingPipeline(StreamingConfig(detector="vit_b16"), sd, device="cpu")


def test_the_configuration_is_the_published_preset_and_its_counts():
    """The benchmark configuration's architecture is the port's preset; the
    plug-in's counts are the figures PERF.md and the issue quote: 27,591,994
    parameters (28.35 M with the published 3 channels and 1000 classes),
    11,853,127,680 operations a frame, the window attention's 478,150,656
    operations and 17,203,752 bytes."""
    preset = swinv2.swinv2_tiny_patch4_window8_256(CONFIG["num_channels"], 2 * CONFIG["n_keypoints"])
    assert (CONFIG["model_h"], CONFIG["patch_size"], CONFIG["embed_dim"], tuple(CONFIG["depths"]),
            tuple(CONFIG["num_heads"]), CONFIG["window_size"], CONFIG["mlp_ratio"]) == (
        preset.img_size, preset.patch_size, preset.embed_dim, preset.depths, preset.num_heads,
        preset.window_size, preset.mlp_ratio)
    assert CONFIG["reduced"] == [] and CONFIG["detector"] == "swinv2_t"
    assert sum(math.prod(s) for _, s, _ in plugin.shapes(CONFIG)) == CONFIG["parameters"] == 27_591_994
    assert plugin.forward_flops(CONFIG) == 11_853_127_680
    assert plugin.window_attn_work(CONFIG) == (478_150_656, 17_203_752)
    assert [s[4:] for s in preset.stages()] == [(64, 8, 4), (32, 8, 4), (16, 8, 4), (8, 8, 0)]
    assert [s[4:] for s in TINY_ARCH.stages()] == [(8, 4, 2), (4, 4, 0)]
