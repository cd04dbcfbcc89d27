#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (perseus_tpu_torch) on one card.

    python3 chip_smoke.py

from the root of a checkout, on a host with one CUDA card (Hopper: the
kernels are built for sm_90a). Phases, each of which fails the run with a
non-zero exit:

  1. device: require CUDA; print the card's name and power limit;
  2. build every CUDA kernel of the serving path from csrc/ with nvcc;
  3. each kernel against its plain PyTorch version, on the card, at the
     serving path's shapes and at the batch-256 detector shape, plus odd
     shapes and NaN/-inf inputs: exact agreement required; CUDA-event times of
     the kernel, the plain version and the nearest PyTorch library call;
  4. the serving path at full width: StreamingPipeline, RGBD 376x672 frames
     cropped to 256x256, ResNet-18 folded bf16, fixed-lag smoother window 24
     (GN-4), random weights from a seed, 64 frames. Every output finite; the
     kernel's launches counted over exactly this run; the same frames again
     with the plain maxpool must give identical keypoints and poses; where a
     frame's time goes (detector alone, smoother alone, device busy share by
     torch.profiler); the default LM-8 smoother on a few frames; the detector
     alone at batch 256; and the CUDA pipeline against the CPU pipeline
     (which the tier-1 tests hold against the JAX package) on a small f32
     configuration.

Prints the card line, then one JSON line describing each kernel, then, as the
last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

# published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s and
# non-tensor-core f32 operations/s, for the bound of a memory-bound kernel
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_FRAMES = 64


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, by CUDA events over `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def same(a, b) -> bool:
    """Equal values and equal NaN positions."""
    import torch

    return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")


def phase_build():
    from perseus_tpu_torch.models import _build

    t0 = time.perf_counter()
    path = _build.build("maxpool")
    _build.load_library("maxpool")
    log(f"built {path} in {time.perf_counter() - t0:.3f} s")


def pool_bound_ms(shape, dtype) -> tuple[float, str]:
    """Least time of the pool on this card: each input read once and each
    output written once at the HBM rate, or 8 f32 compares per output."""
    import torch

    from perseus_tpu_torch.models.pool import pool_output_hw

    b, c, h, w = shape
    ho, wo = pool_output_hw(h, w)
    size = torch.finfo(dtype).bits // 8
    bytes_ms = (b * c * (h * w + ho * wo) * size) / HBM_BYTES_PER_S * 1e3
    ops_ms = 8 * b * c * ho * wo / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_pool_kernel(main_shape, main_dtype):
    import torch
    import torch.nn.functional as F

    from perseus_tpu_torch.models import pool

    gen = torch.Generator().manual_seed(0)
    cases = [
        ("stem B=256 bf16", (256, 64, 128, 128), torch.bfloat16, False),
        ("stem B=256 f32", (256, 64, 128, 128), torch.float32, False),
        ("stem B=1 bf16 (serving)", (1, 64, 128, 128), torch.bfloat16, False),
        ("stem B=1 f32", (1, 64, 128, 128), torch.float32, False),
        ("odd 2x8x31x17 f32", (2, 8, 31, 17), torch.float32, True),
        ("odd 2x8x31x17 bf16", (2, 8, 31, 17), torch.bfloat16, True),
        ("tiny 1x3x1x1 f32", (1, 3, 1, 1), torch.float32, True),
    ]
    timings = {}
    max_err = 0.0
    for name, shape, dtype, special in cases:
        # ReLU'd normal input, like the stem's: many exact-zero ties
        x = torch.relu(torch.randn(shape, generator=gen)).to("cuda", dtype)
        if special:
            x.view(-1)[::7] = float("nan")
            x.view(-1)[3::5] = float("-inf")
        out = pool.max_pool_3x3_s2(x)
        torch.cuda.synchronize()
        ref = pool.max_pool_3x3_s2_reference(x)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype or not same(out, ref):
            raise AssertionError(f"maxpool kernel disagrees with its plain version on {name}")
        finite = ~ref.isnan()
        err = (out[finite].float() - ref[finite].float()).abs().max().item() if finite.any() else 0.0
        max_err = max(max_err, err)
        if not special:
            t_kernel = time_ms(lambda: pool.max_pool_3x3_s2(x))
            t_plain = time_ms(lambda: pool.max_pool_3x3_s2_reference(x))
            t_lib = time_ms(lambda: F.max_pool2d(x, 3, 2, 1))
            bound, by = pool_bound_ms(shape, dtype)
            timings[(shape, dtype)] = (t_kernel, t_plain, t_lib, bound, by)
            log(
                f"maxpool {name}: exact; kernel {t_kernel:.6f} ms, plain {t_plain:.6f} ms, "
                f"F.max_pool2d {t_lib:.6f} ms, bound {bound:.6f} ms ({by})"
            )
        else:
            log(f"maxpool {name} (NaN/-inf): exact")
    return timings[(main_shape, main_dtype)], max_err


def _serving_config(smoother=None):
    from perseus_tpu_torch.runtime.streaming import StreamingConfig
    from perseus_tpu_torch.smoother.lm import SmootherConfig

    return StreamingConfig(
        num_channels=4, model_h=256, model_w=256, amp=True, smooth=True,
        smoother=smoother or SmootherConfig(window=24, max_iterations=4, accept_reject=False),
    )


def _run(pipeline, frames):
    """All frames through a fresh carry; returns stacked outputs and whether
    every output was finite (checked once, at the end)."""
    import torch

    carry = pipeline.init_carry()
    kps, rots, transs, finite = [], [], [], []
    for f in frames:
        k, image, carry, pose = pipeline(f, carry)
        kps.append(k)
        rots.append(pose.rot)
        transs.append(pose.trans)
        finite.append(
            torch.isfinite(k).all() & torch.isfinite(image).all()
            & torch.isfinite(pose.rot).all() & torch.isfinite(pose.trans).all()
        )
    return torch.stack(kps), torch.stack(rots), torch.stack(transs), bool(torch.stack(finite).all())


def breakdown(pipeline, frames, sd) -> None:
    """Where a serving frame's time goes: the detector alone at batch 1, the
    smoother update alone (the same GN-4 config, and the block solver for
    comparison), and the device's busy share over a few traced frames."""
    import torch

    from perseus_tpu_torch.models import resnet
    from perseus_tpu_torch.runtime.streaming import StreamingPipeline
    from perseus_tpu_torch.smoother.lm import SmootherConfig

    image = pipeline.preprocess(frames[0]).permute(2, 0, 1)[None].contiguous()
    det_ms = time_ms(
        lambda: resnet.keypoint_cnn_apply_folded(pipeline.folded, image), iters=20, warmup=3
    )
    log(f"breakdown: detector alone at batch 1 bf16 {det_ms:.4f} ms (CUDA events)")
    with torch.no_grad():
        meas = [
            resnet.keypoint_cnn_apply_folded(
                pipeline.folded, pipeline.preprocess(f).permute(2, 0, 1)[None].contiguous()
            ).reshape(-1, 2)
            for f in frames[:20]
        ]
    for solver in ("jacfwd", "block"):
        cfg = SmootherConfig(window=24, max_iterations=4, accept_reject=False, solver=solver)
        p = StreamingPipeline(_serving_config(smoother=cfg), sd, device="cuda")
        carry = p.init_carry()
        with torch.no_grad():
            for m in meas[:4]:
                carry, _ = p.smoother.update(carry, m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for m in meas[4:]:
                carry, _ = p.smoother.update(carry, m)
            torch.cuda.synchronize()
        log(
            f"breakdown: smoother update alone (GN-4, solver={solver}) "
            f"{(time.perf_counter() - t0) * 1e3 / 16:.4f} ms (host clock)"
        )
    try:
        from torch.profiler import ProfilerActivity, profile

        carry = pipeline.init_carry()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for f in frames[:4]:
                _, _, carry, _ = pipeline(f, carry)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
        launches = sum(e.count for e in events if getattr(e, "self_device_time_total", 0.0) > 0)
        top = sorted(events, key=lambda e: getattr(e, "self_device_time_total", 0.0), reverse=True)[:5]
        log(
            f"breakdown: traced 4 frames, device busy {busy_us / wall_us:.6f} of wall "
            f"({busy_us:.1f} of {wall_us:.1f} us, profiler on), {launches / 4:.1f} kernels/frame"
        )
        for e in top:
            log(f"breakdown:   {e.key[:70]}: {getattr(e, 'self_device_time_total', 0.0) / 4:.1f} us/frame")
    except Exception as exc:  # the profiler is untried on this machine: report, do not fail
        log(f"breakdown: device busy share not measured (profiler: {exc!r})")


def phase_serving():
    import numpy as np
    import torch

    from perseus_tpu_torch.models import pool, resnet
    from perseus_tpu_torch.runtime.sources import SyntheticSource
    from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline
    from perseus_tpu_torch.smoother.lm import SmootherConfig

    model = resnet.KeypointCNN(
        n_keypoints=8, num_channels=4, device="cuda", generator=torch.Generator().manual_seed(0)
    )
    sd = model.state_dict()
    source = SyntheticSource(height=376, width=672, depth=True, seed=2)
    frames_np = [source.get_frame() for _ in range(N_FRAMES)]
    frames = torch.as_tensor(np.stack(frames_np)).to("cuda")
    pipeline = StreamingPipeline(_serving_config(), sd, device="cuda")

    # warm-up (cuDNN plans, allocator), then the counted, timed main path
    _run(pipeline, frames[:4])
    torch.cuda.synchronize()
    pool.max_pool_3x3_s2.launches = 0
    t0 = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    kps, rots, transs, finite = _run(pipeline, frames)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / N_FRAMES
    event_ms = start.elapsed_time(end) / N_FRAMES
    launches = pool.max_pool_3x3_s2.launches
    if not finite:
        raise AssertionError("serving path produced non-finite keypoints, image or pose")
    if kps.shape != (N_FRAMES, 8, 2) or rots.shape != (N_FRAMES, 3, 3):
        raise AssertionError(f"unexpected output shapes {tuple(kps.shape)} {tuple(rots.shape)}")
    if launches < N_FRAMES:
        raise AssertionError(f"maxpool kernel launched {launches} times on {N_FRAMES} frames")
    log(
        f"serving GN-4 window 24: {N_FRAMES} frames, {event_ms:.4f} ms/frame (CUDA events), "
        f"{wall_ms:.4f} ms/frame (host clock); maxpool launches {launches}"
    )

    # kernel vs plain maxpool inside the same pipeline: identical results
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = _run(pipeline, frames)
        with mock.patch.object(pool, "max_pool_3x3_s2", pool.max_pool_3x3_s2_reference):
            b = _run(pipeline, frames)
    finally:
        torch.backends.cudnn.deterministic = old_det
    for name, x, y in zip(("keypoints", "rotations", "translations"), a[:3], b[:3]):
        if not torch.equal(x, y):
            diff = (x - y).abs().max().item()
            raise AssertionError(f"kernel and plain maxpool pipelines differ in {name} by {diff}")
    log(f"serving path with the plain maxpool: identical keypoints and poses on {N_FRAMES} frames")

    breakdown(pipeline, frames, sd)

    # the default smoother (LM-8 with accept/reject) on a few frames
    lm8 = StreamingPipeline(_serving_config(smoother=SmootherConfig()), sd, device="cuda")
    _run(lm8, frames[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, finite = _run(lm8, frames[:8])
    torch.cuda.synchronize()
    if not finite:
        raise AssertionError("LM-8 serving path produced non-finite outputs")
    log(f"serving LM-8 window 24: {(time.perf_counter() - t0) * 1e3 / 8:.4f} ms/frame (host clock)")

    # the detector alone at batch 256 in bf16
    folded = resnet.fold_batchnorm(sd)
    x = torch.rand((256, 4, 256, 256), generator=torch.Generator().manual_seed(1)).to("cuda")
    det_ms = time_ms(lambda: resnet.keypoint_cnn_apply_folded(folded, x), iters=10, warmup=3)
    log(f"detector batch 256 bf16: {det_ms:.4f} ms/batch, {256 / det_ms * 1e3:.1f} frames/s")

    # CUDA against the CPU path on a small f32 configuration
    small = StreamingConfig(
        num_channels=4, model_h=64, model_w=64, amp=False,
        smoother=SmootherConfig(window=4, max_iterations=2),
    )
    sd_cpu = {k: v.cpu() for k, v in sd.items()}
    small_frames = [f[:96, :128] for f in frames_np[:3]]
    on_card = _run(StreamingPipeline(small, sd, device="cuda"), small_frames)
    on_cpu = _run(StreamingPipeline(small, sd_cpu, device="cpu"), small_frames)
    errs = [(x.cpu() - y).abs().max().item() for x, y in zip(on_card[:3], on_cpu[:3])]
    if not (on_card[3] and errs[0] < 1e-3 and max(errs[1:]) < 1e-4):
        raise AssertionError(f"CUDA and CPU pipelines disagree: keypoints/rot/trans {errs}")
    log(f"small f32 pipeline, CUDA vs CPU: max abs diff keypoints/rot/trans {errs}")
    return launches


def main() -> int:
    try:
        import torch

        import perseus_tpu_torch  # noqa: F401  (the port, from this checkout)
    except ImportError as exc:
        print(f"[smoke] FAIL: cannot import the port ({exc}); run from the repo root", file=sys.stderr)
        return 1
    phase = "device"
    try:
        phase_device()
        phase = "build"
        phase_build()
        phase = "kernel"
        main_shape, main_dtype = (1, 64, 128, 128), torch.bfloat16
        (t_kernel, t_plain, t_lib, bound, by), max_err = phase_pool_kernel(main_shape, main_dtype)
        phase = "serving"
        launches = phase_serving()
    except Exception as exc:  # report which phase failed, with its traceback
        import traceback

        traceback.print_exc()
        print(f"[smoke] FAIL in phase {phase}: {exc}", file=sys.stderr)
        return 1
    kernels = [
        {
            "name": "max_pool_3x3_s2",
            "route": "cuda",
            "source": "perseus_tpu_torch/csrc/maxpool.cu",
            "replaces": "perseus_tpu/models/pool_pallas.py:55",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": t_kernel,
            "plain_ms": t_plain,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": t_lib,
        }
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
