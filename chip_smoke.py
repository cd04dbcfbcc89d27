#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (perseus_tpu_torch) on one card.

    python3 chip_smoke.py

from the root of a checkout, on a host with one CUDA card (Hopper: the
kernels are built for sm_90a). Phases, each of which fails the run with a
non-zero exit:

  1. device: require CUDA; print the card's name and power limit;
  2. build every CUDA source in csrc/ with nvcc, one process per source, all
     started together; log each kernel's registers, stack frame, spills and
     shared memory (ptxas -v) and the integer divisions in its SASS;
  3. each kernel against its plain PyTorch version, on the card, at the main
     paths' shapes plus odd shapes: the stem maxpool forward (exact, with
     NaN/-inf inputs, odd sizes, widths that are not a multiple of 16 or 8,
     unaligned views and a batch slice) and gradient (exact, with forced
     ties, odd sizes, a width that is not a multiple of 8, unaligned views),
     the three fused augmentation kernels at (256, 5, 256, 256) in f32 (atol
     1e-5) and bf16 (one ulp: rtol 2^-7, atol 2^-9) and at (256, 4, 256,
     256) f32 (the 4-channel warp branch's input), with a swapped image and
     a rejected transplant for the ultra kernel, at odd sizes with C = 3-6
     and 8 (the chain and warp kernels' instantiations), a batch slice whose
     base is not 16-byte aligned and an unaligned view at a width that is a
     multiple of 4 (their scalar paths), and over a sweep of affines (the
     config's extremes and a zoom-out past it) at sizes 37, 129 and 256;
     CUDA-event times of the kernel, the plain version and, where one
     exists, the PyTorch library call that computes the same function, and
     each timed kernel's device time split over its launches (torch.profiler,
     kernels only), for the maxpool forward also beside F.max_pool2d's and
     with the host time of a call; the two-pass affine warp (#3) with every
     image in both orientations, within 1e-5 and exact at the identity: at
     (256, 5, 256, 256) f32 with affines to +-90 deg and shear 10 deg (its
     swapped and unswapped images also timed as batches of their own), at
     (3, 5, 37, 37) and (2, 4, 129, 129), and over the sweep of affines at
     sizes 37, 129 and 256 with 5 and 4 channels; timed beside F.grid_sample
     (a direct 2-D bilinear warp, another function: a yardstick only);
  4. the detector train step at the default TrainConfig: batch 256 of
     5-channel 256x256 synthetic frames, fused ultra augmentation, ResNet-18
     in bf16 with f32 params, SmoothL1, clip + AdamW; 3 warm-up steps, then
     20 timed steps with every kernel's launches counted over exactly those
     steps; finite losses and params; where a step's time goes (augmentation,
     forward + backward, optimizer; device busy share by torch.profiler); the
     two other augmentation branches (warp + chain for 4-channel input, the
     chain alone without the affine) for a few steps each; and the CUDA step
     against the CPU step (which the tier-1 tests hold against the JAX
     package) on a small f32 configuration, same state, same draws: loss,
     batch stats, each gradient leaf before the optimizer, and clip + AdamW
     on the same gradients;
  4b. the trainer's device-resident-data configuration with the unfused
     augmentation: default TrainConfig, KeypointAugmentation(fused=False), a
     split of 1,024 synthetic 5-channel 256x256 rows on the card, 3 warm-up
     steps, then 20 timed steps in one make_device_data_epoch_fn call with
     every kernel's launches counted over exactly those steps (#3, #1, #2
     one each per step; #4-#6 none); finite losses and params; where a step's
     time goes; the eval step over a 300-row val split (not a multiple of
     256: every row counted once); and the unfused pipeline on the card
     against the CPU on a small f32 configuration with the same draws;
  5. the serving path at full width: StreamingPipeline, RGBD 376x672 frames
     cropped to 256x256, ResNet-18 folded bf16, fixed-lag smoother window 24
     (GN-4), random weights from a seed, 32 frames. Every output finite; the
     maxpool's launches counted over exactly this run; the same frames again
     with the plain maxpool must give identical keypoints and poses; where a
     frame's time goes (detector alone, smoother alone, device busy share by
     torch.profiler); the default LM-8 smoother on a few frames; the detector
     alone at batch 256; and the CUDA pipeline against the CPU pipeline on a
     small f32 configuration.

Prints each phase's wall time, the card line, then one JSON line describing
each kernel, then, as the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

# published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s and
# non-tensor-core f32 operations/s, for the bound of a memory-bound kernel
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_FRAMES = 32
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
BF16_TOL = dict(rtol=2**-7, atol=2**-9)
SOURCES = ("maxpool", "augment")


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


def time_turns(fns: dict, rounds: int = 7, iters: int = 50) -> dict:
    """Median over ``rounds`` of each function's mean time per call (CUDA
    events over ``iters`` back-to-back calls), the functions taking turns
    in every round, so that a drift of the shared host's speed falls on all
    of them alike."""
    import statistics

    runs = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            runs[name].append(time_ms(fn, iters=iters, warmup=3))
    return {name: statistics.median(v) for name, v in runs.items()}


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call, on the host clock over ``calls`` back-to-back
    calls (the enqueue: a kernel shorter than its launch path never holds
    the host back)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


def same(a, b) -> bool:
    """Equal values and equal NaN positions."""
    import torch

    return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def log_split(label: str, fn, calls: int = 5, host: bool = False) -> None:
    """Logs the device time of each kernel that ``calls`` calls of ``fn``
    launch, from torch.profiler (kernels only), longest first. With
    ``host``, also where a call's host time goes: its wall on the host clock
    over 200 back-to-back calls (the enqueue: the device's work hides
    behind it unless the device is slower) and the profiler's CPU-side
    events per call (ATen ops, CUDA runtime calls; the profiler inflates
    them), longest first; what they leave of the wall is Python. The
    profiler is a diagnostic here, so its failure is reported, not fatal."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        fn()
        torch.cuda.synchronize()
        host_time = host_us(fn) if host else None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:  # noqa: BLE001
        log(f"{label} split: not measured (profiler: {exc!r})")
        return
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in kernels) / calls
    log(f"{label} split (torch.profiler, kernels only, per call): {total:.3f} us in "
        f"{sum(e.count for e in kernels) / calls:g} launches")
    for e in kernels:
        log(f"{label} split:   {e.key[:100]}: {e.self_device_time_total / calls:.3f} us ({e.count / calls:g} launches)")
    if host:
        cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0]
        cpu.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
        log(f"{label} host: {host_time:.3f} us per call (host clock, 200 back-to-back calls); CPU events per call "
            f"(torch.profiler, self time): {sum(e.self_cpu_time_total for e in cpu) / calls:.3f} us: "
            + ", ".join(f"{e.key} {e.self_cpu_time_total / calls:.3f}" for e in cpu[:6]))


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
    with ThreadPoolExecutor(len(SOURCES)) as pool_:  # one nvcc process per source
        paths = list(pool_.map(_build.build, SOURCES))
    _build.load_module("maxpool")  # as each wrapper binds its library
    _build.load_library("augment")
    log(f"built {paths} in {time.perf_counter() - t0:.3f} s")
    for name in SOURCES:  # ptxas -v and the SASS's integer divisions, per kernel
        for line in _build.build_report(name):
            log(f"build {name}.cu: {line}")


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
    """The maxpool forward kernel against its plain version, exactly (equal
    values and NaN positions), at the stem's shapes (train batch 256 and the
    serving frame's batch 1, both dtypes: timed, with the device time split
    over launches and the host time of a call, beside F.max_pool2d's) and,
    with NaN and -inf placed, at odd sizes, widths that are not a multiple
    of 16 or of 8 (the kernel's cells span 16 input columns), unaligned
    views and a batch slice of an odd-sized plane."""
    import torch
    import torch.nn.functional as F

    from perseus_tpu_torch.models import pool

    gen = torch.Generator().manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("stem B=256 bf16", (256, 64, 128, 128), bf16, "timed"),
        ("stem B=256 f32", (256, 64, 128, 128), f32, "timed"),
        ("stem B=1 bf16 (serving)", (1, 64, 128, 128), bf16, "timed"),
        ("stem B=1 f32", (1, 64, 128, 128), f32, "timed"),
        ("tiny 1x3x1x1 f32", (1, 3, 1, 1), f32, "special"),
    ]
    for dtype in (f32, bf16):
        dt = str(dtype).removeprefix("torch.")
        cases += [
            (f"odd 2x8x31x17 {dt}", (2, 8, 31, 17), dtype, "special"),
            (f"W % 16 != 0 2x4x30x40 {dt}", (2, 4, 30, 40), dtype, "special"),
            (f"W % 8 != 0 2x4x29x36 {dt}", (2, 4, 29, 36), dtype, "special"),
            (f"W % 16 != 0 1x2x33x130 {dt}", (1, 2, 33, 130), dtype, "special"),
            (f"unaligned view 2x8x32x64 {dt}", (2, 8, 32, 64), dtype, "unaligned"),
            (f"unaligned view 2x8x31x17 {dt}", (2, 8, 31, 17), dtype, "unaligned"),
            (f"batch slice [1:] of 3x3x31x17 {dt}", (3, 3, 31, 17), dtype, "slice"),
        ]
    timings = {}
    max_err = 0.0
    for name, shape, dtype, kind in cases:
        # ReLU'd normal input, like the stem's: many exact-zero ties
        x = torch.relu(torch.randn(shape, generator=gen)).to("cuda", dtype)
        if kind != "timed":
            x.view(-1)[::7] = float("nan")
            x.view(-1)[3::5] = float("-inf")
        if kind == "unaligned":
            x = unaligned(x)
        elif kind == "slice":
            x = x[1:]
        if kind in ("unaligned", "slice") and x.data_ptr() % 16 == 0:
            raise AssertionError(f"maxpool case {name}: the view is 16-byte aligned")
        out = pool.max_pool_3x3_s2(x)
        torch.cuda.synchronize()
        ref = pool.max_pool_3x3_s2_reference(x)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype or not same(out, ref):
            raise AssertionError(f"maxpool kernel disagrees with its plain version on {name}")
        finite = ~ref.isnan()
        err = (out[finite].float() - ref[finite].float()).abs().max().item() if finite.any() else 0.0
        max_err = max(max_err, err)
        if kind != "timed":
            log(f"maxpool {name} (NaN/-inf): exact")
            continue
        # the kernel and the library call in turns: at batch 1 both are
        # bound by the host, whose speed drifts
        turns = time_turns({"kernel": lambda: pool.max_pool_3x3_s2(x), "lib": lambda: F.max_pool2d(x, 3, 2, 1)})
        t_kernel, t_lib = turns["kernel"], turns["lib"]
        t_plain = time_ms(lambda: pool.max_pool_3x3_s2_reference(x))
        log_split(f"maxpool {name} kernel", lambda: pool.max_pool_3x3_s2(x), calls=50, host=True)
        log_split(f"maxpool {name} F.max_pool2d", lambda: F.max_pool2d(x, 3, 2, 1), calls=50, host=True)
        if shape[0] == 1:
            log_pool_host_path(f"maxpool {name}", x)
        bound, by = pool_bound_ms(shape, dtype)
        timings[(shape, dtype)] = (t_kernel, t_plain, t_lib, bound, by)
        log(
            f"maxpool {name}: exact; kernel {t_kernel:.6f} ms, plain {t_plain:.6f} ms, "
            f"F.max_pool2d {t_lib:.6f} ms, bound {bound:.6f} ms ({by}) (CUDA events per call of 50 back to "
            f"back; kernel and F.max_pool2d: the median of 7 such runs in turns)"
        )
    return timings[(main_shape, main_dtype)], max_err


def log_pool_host_path(label: str, x) -> None:
    """Where the host time of one forward call goes: the wrapper whole, and
    each step of its path alone (the checks, the output's allocation, the
    device and stream lookup, the binding's call with nothing to launch,
    the call and the launch), beside F.max_pool2d; host clock, the median of
    5 rounds of 200 calls taken in turns. A diagnostic: a tree whose
    wrapper has other steps is reported, not failed."""
    import statistics

    import torch
    import torch.nn.functional as F

    from perseus_tpu_torch.models import _build, pool

    b, c, h, w = x.shape
    ho, wo = pool.pool_output_hw(h, w)
    y = pool.max_pool_3x3_s2(x)
    try:
        fwd = _build.load_module("maxpool").fwd
    except (AttributeError, ImportError) as exc:
        log(f"{label} host path: not measured ({exc!r})")
        return
    bf16, dev = x.dtype is torch.bfloat16, x.get_device()
    stream = pool._raw_stream(dev)
    xp, yp = x.data_ptr(), y.data_ptr()
    steps = {
        "whole wrapper": lambda: pool.max_pool_3x3_s2(x),
        "F.max_pool2d": lambda: F.max_pool2d(x, 3, 2, 1),
        "checks": lambda: (x.requires_grad and torch.is_grad_enabled(), x.is_cuda, x.dtype in pool._DTYPES,
                           x.dim(), x.is_contiguous()),
        "allocation (new_empty)": lambda: x.new_empty(b, c, ho, wo),
        "device and stream": lambda: pool._raw_stream(x.get_device()),
        "binding call, no launch": lambda: fwd(bf16, xp, yp, 0, h, w, dev, stream),
        "binding call + launch": lambda: fwd(bf16, xp, yp, b * c, h, w, dev, stream),
    }
    runs = {k: [] for k in steps}
    for _ in range(5):
        for k, step in steps.items():
            runs[k].append(host_us(step))
    log(f"{label} host path (us per call, host clock, median of 5 x 200 calls in turns): "
        + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in runs.items()))


def bytes_bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time of a function on this card: its bytes (each input read
    once, each output written once) at the HBM rate, or its f32 operations
    at the non-tensor-core rate, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def unaligned(t):
    """A contiguous copy of ``t`` whose data pointer is one element past a
    16-byte boundary (what a view into a larger buffer can be)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_pool_backward_kernel():
    """The maxpool gradient kernel against its plain version, exactly, on
    ReLU'd inputs (exact-zero ties) and integer inputs (positive ties), at
    the stem's shape, odd sizes, a width that is not a multiple of 8 and
    unaligned views."""
    import torch
    import torch.nn.functional as F

    from perseus_tpu_torch.models import pool

    gen = torch.Generator().manual_seed(1)
    cases = [
        ("stem B=256 bf16", (256, 64, 128, 128), torch.bfloat16, "relu"),
        ("stem B=256 f32", (256, 64, 128, 128), torch.float32, "relu"),
        ("stem B=2 bf16 integer ties", (2, 64, 128, 128), torch.bfloat16, "ties"),
        ("odd 2x8x31x17 f32 integer ties", (2, 8, 31, 17), torch.float32, "ties"),
        ("odd 2x8x31x17 bf16 integer ties", (2, 8, 31, 17), torch.bfloat16, "ties"),
        ("W % 8 != 0 2x4x18x22 f32 integer ties", (2, 4, 18, 22), torch.float32, "ties"),
        ("W % 8 != 0 2x4x18x22 bf16 integer ties", (2, 4, 18, 22), torch.bfloat16, "ties"),
        ("unaligned views 2x8x32x64 f32 integer ties", (2, 8, 32, 64), torch.float32, "unaligned"),
        ("unaligned views 2x8x32x64 bf16 integer ties", (2, 8, 32, 64), torch.bfloat16, "unaligned"),
        ("tiny 1x3x1x1 f32", (1, 3, 1, 1), torch.float32, "ties"),
    ]
    timings = {}
    for name, shape, dtype, kind in cases:
        x = torch.randn(shape, generator=gen)
        x = torch.relu(x) if kind == "relu" else torch.round(x * 1.5)
        x = x.to("cuda", dtype)
        y = pool.max_pool_3x3_s2(x)
        g = torch.randn(y.shape, generator=gen).to("cuda", dtype)
        if kind == "unaligned":
            x, y, g = unaligned(x), unaligned(y), unaligned(g)
        out = pool.max_pool_3x3_s2_backward(x, y, g)
        torch.cuda.synchronize()
        ref = pool.max_pool_3x3_s2_backward_reference(x, y, g)
        if out.dtype != ref.dtype or not torch.equal(out, ref):
            raise AssertionError(f"maxpool gradient kernel disagrees with its plain version on {name}")
        if shape[0] != 256:
            log(f"maxpool backward {name}: exact")
            continue
        # the library yardstick: PyTorch's own maxpool gradient from saved
        # indices (it routes g to ONE argmax, so it is timed, never compared)
        _, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
        lib = lambda: torch.ops.aten.max_pool2d_with_indices_backward(g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)  # noqa: E731
        t_kernel = time_ms(lambda: pool.max_pool_3x3_s2_backward(x, y, g), iters=20, warmup=3)
        t_plain = time_ms(lambda: pool.max_pool_3x3_s2_backward_reference(x, y, g), iters=5, warmup=1)
        t_lib = time_ms(lib, iters=20, warmup=3)
        log_split(f"maxpool backward {name}", lambda: pool.max_pool_3x3_s2_backward(x, y, g))
        size = torch.finfo(dtype).bits // 8
        nbytes = (2 * x.numel() + 2 * y.numel()) * size  # x, y, g read; dx written
        bound, by = bytes_bound_ms(nbytes, 7 * x.numel())  # <= 4 compares + 3 adds per input
        timings[(shape, dtype)] = (t_kernel, t_plain, t_lib, bound, by)
        log(
            f"maxpool backward {name}: exact; kernel {t_kernel:.6f} ms, plain {t_plain:.6f} ms, "
            f"max_pool2d_with_indices_backward {t_lib:.6f} ms, bound {bound:.6f} ms ({by})"
        )
    return timings[((256, 64, 128, 128), torch.bfloat16)], 0.0


def _aug_inputs(gen, b, c, s, dtype):
    """Random (B, C, S, S) augmentation input on the card: RGB in [0, 1],
    metric depth, binary seg; image 0 and its donor (image 1) have no cube,
    so image 0's transplant is rejected. Warp params with image 1 swapped."""
    import torch

    from perseus_tpu_torch.augment import fused, ops
    from perseus_tpu_torch.augment.pipeline import AugmentationConfig

    x = torch.rand((b, c, s, s), device="cuda", generator=gen)
    if c > 3:
        x[:, 3] = 3.0 + 11.0 * x[:, 3]
    if c > 4:
        x[:, 4] = (x[:, 4] < 0.4).float()
        x[:2, 4] = 0.0
    cfg = AugmentationConfig()
    params = fused.sample_fused_params(gen, cfg, b, s, s, c)
    aff = ops.sample_affine_params(gen, b, s, s)
    aff["applied"][:] = True
    aff["angle"][1] = 90.0  # |i00| < |i10|: the swap branch
    swap, parts = ops._two_pass_params(ops._invert_affine(ops.affine_matrices(aff, s, s)))
    donor = (torch.arange(b, device="cuda") + 1) % b
    return x.to(dtype), params, donor, swap, torch.stack(parts, dim=-1)


def aug_bytes(b: int, c: int, s: int, dtype) -> float:
    """Bytes each augmentation kernel must move: the image tensor, fields (3
    bf16 planes) and plasma (1 bf16 plane) read once, the output written
    once. The ultra kernel's donors are images of the same tensor, so they
    add no bytes to the least the function must move."""
    import torch

    size = torch.finfo(dtype).bits // 8
    return b * s * s * (2 * c * size + 4 * 2)


# f32 operations per output pixel, counted from the plain versions: the chain
# (erase, gains, colour, hue, 5+5-tap blur, shadow, depth) ~150; the warp
# 2 index planes and 4 taps per channel ~20 + 12 C; the transplant ~10 C
AUG_OPS_PER_PX = {"chain": lambda c: 150, "warp": lambda c: 170 + 12 * c, "ultra": lambda c: 170 + 22 * c}


# (angle deg, forward scale, shear_x deg, shear_y deg, tx, ty as fractions of
# the size): the augmentation config's extremes (degrees 90, scale 0.9-1.5,
# shear 0.1, translate 0.1), images swapped (|angle| > 45) and not, the
# identity, and a zoom-out past the config (scale 0.3) whose tiles' source
# boxes exceed the ultra kernel's shared-memory budget
AFFINE_SWEEP = (
    (90.0, 0.9, 0.1, -0.1, 0.1, -0.1),
    (-90.0, 1.5, -0.1, 0.1, -0.1, 0.1),
    (45.0, 0.9, 0.1, 0.1, 0.1, 0.1),
    (-45.0, 1.5, -0.1, -0.1, -0.1, -0.1),
    (60.0, 1.2, 0.1, -0.1, -0.1, 0.1),
    (-30.0, 0.9, -0.1, 0.1, 0.1, 0.0),
    (0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
    (30.0, 0.3, 0.0, 0.0, 0.0, 0.0),
)


def _sweep_affines(s):
    """Two-pass parameters of AFFINE_SWEEP at size S on the card: (swap
    (8,), params (8, 6)); some images are swapped and some are not."""
    import torch

    from perseus_tpu_torch.augment import ops

    b = len(AFFINE_SWEEP)
    col = torch.tensor(AFFINE_SWEEP, device="cuda").T
    aff = {"angle": col[0], "scale": col[1], "shear_x": col[2], "shear_y": col[3], "tx": col[4] * s,
           "ty": col[5] * s, "applied": torch.ones(b, dtype=torch.bool, device="cuda")}
    swap, parts = ops._two_pass_params(ops._invert_affine(ops.affine_matrices(aff, s, s)))
    if not (swap.any() and not swap.all()):
        raise AssertionError(f"affine sweep at {s}: swap {swap.tolist()}")
    return swap, torch.stack(parts, dim=-1)


def _sweep_inputs(gen, s, dtype):
    """(8, 5, S, S) inputs on the card, image k warped by AFFINE_SWEEP[k];
    image 0 and its donor (image 1) carry no cube, so image 0's transplant
    is rejected and the others' are accepted."""
    import torch

    from perseus_tpu_torch.augment import fused, ops
    from perseus_tpu_torch.augment.pipeline import AugmentationConfig

    b = len(AFFINE_SWEEP)
    x = torch.rand((b, 5, s, s), device="cuda", generator=gen)
    x[:, 3] = 3.0 + 11.0 * x[:, 3]
    x[:, 4] = (x[:, 4] < 0.4).float()
    x[:2, 4] = 0.0
    swap, wp = _sweep_affines(s)
    donor = (torch.arange(b, device="cuda") + 1) % b
    accepted = (ops.transplant_with_depth(x, donor) != x).flatten(1).any(1)
    if not (swap.any() and not swap.all() and accepted.any() and not accepted.all()):
        raise AssertionError(f"affine sweep at {s}: swap {swap.tolist()}, transplant accepted {accepted.tolist()}")
    params = fused.sample_fused_params(gen, AugmentationConfig(), b, s, s, 5)
    return x.to(dtype), params, donor, swap, wp


def phase_augment_kernels():
    """Each fused augmentation kernel against its plain version, at the
    train shapes (256, 5, 256, 256) in f32 and bf16 and (256, 4, 256, 256)
    in f32 (the warp + chain branch's 4-channel input), at odd shapes with
    C = 3-6 and 8, on a batch slice off a 16-byte boundary and an unaligned
    view, and over AFFINE_SWEEP at sizes 37, 129 and 256; each kernel's
    device time split over its launches at the train shapes."""
    import torch

    from perseus_tpu_torch.augment import fused

    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(256, 5, 256, f32, "timed"), (256, 5, 256, bf16, "timed"), (256, 4, 256, f32, "timed"),
             (3, 4, 37, f32, "odd"), (3, 5, 37, bf16, "odd"), (3, 3, 37, f32, "odd"), (3, 3, 37, bf16, "odd"),
             (3, 6, 37, f32, "odd"), (3, 8, 37, bf16, "odd"), (4, 5, 37, f32, "batch slice"),
             (4, 5, 37, bf16, "batch slice"), (3, 4, 64, f32, "unaligned view"), (3, 4, 64, bf16, "unaligned view")]
    cases += [(len(AFFINE_SWEEP), 5, s, dtype, "affine sweep") for s in (37, 129, 256) for dtype in (f32, bf16)]
    for b, c, s, dtype, case in cases:
        if case == "affine sweep":
            x, params, donor, swap, wp = _sweep_inputs(gen, s, dtype)
        else:
            x, params, donor, swap, wp = _aug_inputs(gen, b, c, s, dtype)
        if case == "batch slice":  # at an odd size, images 1.. start off a 16-byte boundary
            x, params, donor, swap, wp = x[1:], {k: v[1:] for k, v in params.items()}, None, None, wp[1:]
            b -= 1
            if x.data_ptr() % 16 == 0:
                raise AssertionError("the batch slice is aligned: it would not reach the scalar path")
        elif case == "unaligned view":  # a width that is a multiple of 4, the base one element off
            x = unaligned(x)
        calls = {
            "chain": (fused.fused_apply, fused.reference_apply, (x, params)),
            "warp": (fused.fused_warp_apply, fused.fused_warp_reference, (x, wp, params)),
        }
        if c == 5 and donor is not None:
            calls["ultra"] = (fused.fused_ultra_apply, fused.fused_ultra_reference, (x, donor, swap, wp, params))
        for kind, (kernel, plain, args) in calls.items():
            out = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            err = (out.float() - ref.float()).abs().max().item()
            tol = dict(atol=1e-5, rtol=0.0) if dtype == torch.float32 else BF16_TOL
            if out.dtype != dtype or not torch.allclose(out.float(), ref.float(), **tol):
                raise AssertionError(f"{kind} kernel disagrees with its plain version at {(b, c, s, s)} {dtype} ({case}): {err}")
            label = f"{kind} {(b, c, s, s)} {str(dtype).removeprefix('torch.')}"
            if case != "timed":
                label += f" ({case})"
                log(f"augment {label}: max abs err {err:.3e} (within {tol})")
                continue
            t_kernel = time_ms(lambda: kernel(*args), iters=20, warmup=3)
            t_plain = time_ms(lambda: plain(*args), iters=3, warmup=1)
            log_split(f"augment {label}", lambda: kernel(*args))
            bound, by = bytes_bound_ms(aug_bytes(b, c, s, dtype), b * s * s * AUG_OPS_PER_PX[kind](c))
            results[(kind, c, dtype)] = (t_kernel, t_plain, bound, by, err)
            log(
                f"augment {label}: max abs err {err:.3e}; kernel {t_kernel:.6f} ms, plain {t_plain:.6f} ms, "
                f"no single PyTorch call computes it; bound {bound:.6f} ms ({by})"
            )
        del x, params, calls
        torch.cuda.empty_cache()
    return results


def augment_kernel_times(label: str = "") -> dict:
    """CUDA-event times (mean over 20 launches) of the augmentation kernels
    at their train shapes, each with its device split over its launches:
    #4 and #5 at (256, 5, 256, 256) and (256, 4, 256, 256), #6 at (256, 5,
    256, 256), in f32 and bf16, and #3 at (256, 5, 256, 256) f32. The
    inputs come from a fixed
    seed, so two trees' times taken in turns on one card compare: run this
    function from inside each tree (a parent unpacked with git archive
    imports its own package), one process per turn."""
    import torch

    from perseus_tpu_torch.augment import fused, warp

    gen = torch.Generator(device="cuda").manual_seed(11)
    times = {}
    for c, dtype in ((5, torch.float32), (5, torch.bfloat16), (4, torch.float32), (4, torch.bfloat16)):
        x, params, donor, swap, wp = _aug_inputs(gen, 256, c, 256, dtype)
        calls = {"chain": lambda: fused.fused_apply(x, params), "warp": lambda: fused.fused_warp_apply(x, wp, params)}
        if c == 5:
            calls["ultra"] = lambda: fused.fused_ultra_apply(x, donor, swap, wp, params)
        for kind, fn in calls.items():
            name = f"{kind} {(256, c, 256, 256)} {str(dtype).removeprefix('torch.')}"
            times[name] = time_ms(fn, iters=20, warmup=3)
            log(f"{label}augment times {name}: kernel {times[name]:.6f} ms")
            log_split(f"{label}augment times {name}", fn)
        if c == 5 and dtype == torch.float32:
            fn = lambda: warp.warp_affine_two_pass(x, swap, wp)  # noqa: E731
            times["two-pass warp (256, 5, 256, 256) float32"] = time_ms(fn, iters=20, warmup=3)
            log(f"{label}augment times two-pass warp (256, 5, 256, 256) float32: kernel "
                f"{times['two-pass warp (256, 5, 256, 256) float32']:.6f} ms")
        del x, params, calls
        torch.cuda.empty_cache()
    return times


def _warp_params(gen, b, s, identity=False):
    """Two-pass parameters of random affines drawn at degrees 90, shear 10
    deg (every one applied), or of the identity: (swap (B,), params (B, 6),
    forward affines (B, 3, 3))."""
    import torch

    from perseus_tpu_torch.augment import ops

    aff = ops.sample_affine_params(gen, b, s, s, degrees=90.0, shear=10.0)
    aff["applied"][:] = not identity
    mats = ops.affine_matrices(aff, s, s)
    swap, parts = ops._two_pass_params(ops._invert_affine(mats))
    return swap, torch.stack(parts, dim=-1), mats


def _grid_sample_warp(x, mats):
    """The same affines as one F.grid_sample call (a direct 2-D bilinear
    warp, zero padding, align_corners): the grid maps each normalized output
    pixel through A^-1. Not the two-pass function: a yardstick only."""
    import torch
    import torch.nn.functional as F

    from perseus_tpu_torch.augment import ops

    b, _, h, w = x.shape
    inv = torch.cat([ops._invert_affine(mats), mats[:, 2:]], dim=1)
    to_px = torch.tensor([[(w - 1) / 2, 0, (w - 1) / 2], [0, (h - 1) / 2, (h - 1) / 2], [0, 0, 1]], device=x.device)
    theta = (torch.linalg.inv(to_px) @ inv @ to_px)[:, :2]
    grid = F.affine_grid(theta, list(x.shape), align_corners=True)
    return lambda: F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def warp_bound_ms(x) -> tuple[float, str]:
    """Least time of the two-pass warp of ``x`` (B, C, S, S) f32: the image
    read once, the output written once (the (B, 7) params are noise); per
    output pixel ~22 f32 operations for the taps and 7 per channel for the
    blend."""
    b, c, s, _ = x.shape
    return bytes_bound_ms(2 * x.numel() * 4 + b * 7 * 4, b * s * s * (22 + 7 * c))


def phase_warp_kernel():
    """The two-pass warp kernel (#3) against its plain version on the card,
    within 1e-5 and exact at the identity, every image in both orientations
    (the drawn swap flags, then the flipped ones: the flag is an input of
    the function both sides compute): the unfused train path's shape
    (256, 5, 256, 256) f32 with affines to +-90 deg (timed, also its
    swapped and unswapped images as batches of their own), odd sizes, and
    AFFINE_SWEEP (the config's extremes, the identity, a zoom-out past the
    kernel's shared-memory box) at sizes 37, 129 and 256 with 5 and 4
    channels."""
    import torch

    from perseus_tpu_torch.augment import warp

    gen = torch.Generator(device="cuda").manual_seed(3)
    result = None
    cases = [(256, 5, 256, "timed"), (3, 5, 37, "random"), (2, 4, 129, "random")]
    cases += [(len(AFFINE_SWEEP), c, s, "affine sweep") for s in (37, 129, 256) for c in (5, 4)]
    for b, c, s, case in cases:
        x = torch.rand((b, c, s, s), device="cuda", generator=gen)
        x[:, 3:4] = 3.0 + 11.0 * x[:, 3:4]
        if case == "affine sweep":
            swap, wp = _sweep_affines(s)
        else:
            swap, wp, mats = _warp_params(gen, b, s)
            swap[0], swap[-1] = False, True
        err = 0.0
        for flags in (swap, ~swap):
            out = warp.warp_affine_two_pass(x, flags, wp)
            torch.cuda.synchronize()
            ref = warp.warp_affine_two_pass_reference(x, flags, wp)
            err = max(err, (out - ref).abs().max().item())
            if out.dtype != torch.float32 or out.shape != x.shape or not err <= 1e-5:
                raise AssertionError(f"warp kernel disagrees with its plain version at {(b, c, s, s)} ({case}): {err}")
        # the identity: no swap, exact on both
        eye_swap, eye_wp, _ = _warp_params(gen, b, s, identity=True)
        eye = warp.warp_affine_two_pass(x, eye_swap, eye_wp)
        if eye_swap.any() or not (torch.equal(eye, x) and torch.equal(warp.warp_affine_two_pass_reference(x, eye_swap, eye_wp), x)):
            raise AssertionError(f"warp kernel or its plain version is not exact at the identity at {(b, c, s, s)}")
        label = f"warp {(b, c, s, s)} f32 ({case}, {int(swap.sum())} of {b} swapped, then flipped)"
        if case != "timed":
            log(f"{label}: max abs err {err:.3e} (within 1e-5); exact at the identity")
            continue
        t_kernel = time_ms(lambda: warp.warp_affine_two_pass(x, swap, wp), iters=20, warmup=3)
        t_plain = time_ms(lambda: warp.warp_affine_two_pass_reference(x, swap, wp), iters=3, warmup=1)
        t_grid = time_ms(_grid_sample_warp(x, mats), iters=20, warmup=3)
        log_split(f"warp {(b, c, s, s)}", lambda: warp.warp_affine_two_pass(x, swap, wp))
        bound, by = warp_bound_ms(x)
        result = (t_kernel, t_plain, bound, by, err)
        log(
            f"{label}: max abs err {err:.3e}; exact at the identity; kernel {t_kernel:.6f} ms, plain "
            f"{t_plain:.6f} ms, bound {bound:.6f} ms ({by}); F.grid_sample on the same affines (a direct "
            f"2-D bilinear warp, not this function: a yardstick) {t_grid:.6f} ms"
        )
        # the batch's swapped and unswapped images, each as a batch of its own
        for flag, orient in ((True, "swapped"), (False, "unswapped")):
            sel = swap == flag
            xs, ss, ws = x[sel].contiguous(), swap[sel], wp[sel]
            t_part = time_ms(lambda: warp.warp_affine_two_pass(xs, ss, ws), iters=20, warmup=3)
            part_bound, _ = warp_bound_ms(xs)
            log(f"warp {orient} images alone {tuple(xs.shape)}: kernel {t_part:.6f} ms, bound {part_bound:.6f} ms "
                f"({part_bound / t_part:.3f} of it)")
        del x, out, ref, eye
        torch.cuda.empty_cache()
    return result


def _counted():
    from perseus_tpu_torch.augment import fused, warp
    from perseus_tpu_torch.models import pool

    return (pool.max_pool_3x3_s2, pool.max_pool_3x3_s2_backward, fused.fused_apply,
            fused.fused_warp_apply, fused.fused_ultra_apply, warp.warp_affine_two_pass)


def _reset_counts():
    for fn in _counted():
        fn.launches = 0


def _counts() -> dict:
    return {fn.__name__: fn.launches for fn in _counted()}


def _train_setup(cfg, batch, device, seed=0):
    import numpy as np
    import torch

    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.train import train

    opt = train.make_optimizer(cfg)
    state = train.init_state(cfg, opt, device=device)
    aug = KeypointAugmentation(cfg.augmentation_config)
    step = train.make_train_step(cfg, opt, aug)
    use_transplant = cfg.augmentation_config.random_transplantation_with_depth
    images = torch.from_numpy(train._prepare_aug_batch(batch, cfg.in_channels, use_transplant)).to(device)
    coords = torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32)).to(device)
    return opt, state, aug, step, images, coords


def step_breakdown(label, aug_kind, cfg, state, aug, opt, images, coords, gen, step_ms, traced_steps):
    """Where a train step's time goes: the augmentation (sampling + apply),
    forward + backward and clip + AdamW, each alone (CUDA events), and the
    device busy share of 3 steps run by ``traced_steps`` under
    torch.profiler (kernels only) against the untraced ``step_ms``."""
    import torch

    from perseus_tpu_torch.models import resnet
    from perseus_tpu_torch.train import train

    b, c, h, w = images.shape
    aug_ms = time_ms(lambda: aug.apply(images, coords, aug.sample(gen, b, h, w, c)), iters=10, warmup=2)
    aug_images, target = aug.apply(images, coords, aug.sample(gen, b, h, w, c))
    aug_images, target = aug_images[:, : cfg.in_channels], target.reshape(b, -1)
    keys = list(state.params)
    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}

    def fwd_bwd():
        pred, _ = resnet.keypoint_cnn_apply(
            {**params, **state.batch_stats}, aug_images, train=True, compute_dtype=torch.bfloat16
        )
        return torch.autograd.grad(train.smooth_l1_loss(pred, target), [params[k] for k in keys])

    fb_ms = time_ms(fwd_bwd, iters=10, warmup=2)
    grads = dict(zip(keys, fwd_bwd()))
    opt_ms = time_ms(lambda: opt.update(grads, state.opt_state, state.params), iters=10, warmup=2)
    log(
        f"{label} breakdown: augmentation ({aug_kind}) {aug_ms:.4f} ms, forward + backward "
        f"{fb_ms:.4f} ms, clip + AdamW {opt_ms:.4f} ms (each alone, CUDA events)"
    )
    del params, grads, aug_images
    try:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_steps()
            torch.cuda.synchronize()
        # the kernels alone: key_averages() also credits each aten op with
        # the device time of the kernels it launched (counted twice if summed)
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 3 / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        log(
            f"{label} breakdown: traced 3 steps, kernels {busy_ms:.4f} ms/step, {len(kernels)} distinct kernels, "
            f"{sum(e.count for e in kernels) / 3:.0f} launches/step; device busy share "
            f"{busy_ms / step_ms:.6f} of the untraced {step_ms:.4f} ms/step"
        )
        for e in top:
            log(f"{label} breakdown:   {e.key[:70]}: {e.self_device_time_total / 3:.1f} us/step ({e.count / 3:.0f} launches)")
    except Exception as exc:  # the profiler is untried on this machine: report, do not fail
        log(f"{label} breakdown: device busy share not measured (profiler: {exc!r})")


def phase_train():
    """The default TrainConfig's step at full width, counted and timed."""
    import dataclasses

    import torch

    from perseus_tpu_torch.augment.pipeline import AugmentationConfig
    from perseus_tpu_torch.data.synthetic import make_batch
    from perseus_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig()
    t0 = time.perf_counter()
    batch = make_batch(cfg.batch_size, cfg.input_resolution, cfg.input_resolution, cfg.n_keypoints, seed=cfg.random_seed)
    opt, state, aug, step, images, coords = _train_setup(cfg, batch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(cfg.random_seed)
    log(f"train: batch {tuple(images.shape)} {images.dtype} made and uploaded in {time.perf_counter() - t0:.3f} s")
    for _ in range(TRAIN_WARMUP):
        state, loss = step(state, images, coords, gen)
    torch.cuda.synchronize()

    _reset_counts()
    losses = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, images, coords, gen)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    counts = _counts()
    losses = torch.stack(losses)
    expect = {"max_pool_3x3_s2": TRAIN_STEPS, "max_pool_3x3_s2_backward": TRAIN_STEPS, "fused_ultra_apply": TRAIN_STEPS,
              "fused_apply": 0, "fused_warp_apply": 0, "warp_affine_two_pass": 0}
    if counts != expect:
        raise AssertionError(f"train step launches {counts}, expected {expect} over {TRAIN_STEPS} steps")
    finite = bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(v).all()) for v in state.params.values())
    if not finite:
        raise AssertionError("train step produced non-finite losses or params")
    log(
        f"train TrainConfig() batch {cfg.batch_size}: {step_ms:.4f} ms/step, "
        f"{cfg.batch_size / step_ms * 1e3:.1f} img/s (CUDA events over {TRAIN_STEPS} steps); "
        f"{wall_ms:.4f} ms/step host clock; losses {losses[0].item():.6f} -> {losses[-1].item():.6f}; "
        f"launches per step {{{', '.join(f'{k}: {v / TRAIN_STEPS:g}' for k, v in counts.items())}}}"
    )

    def traced_steps():
        st = state
        for _ in range(3):
            st, _ = step(st, images, coords, gen)

    step_breakdown("train", "sample + ultra kernel", cfg, state, aug, opt, images, coords, gen, step_ms, traced_steps)

    # the other two augmentation branches through the same entry points
    branch_counts = {}
    # (aug_c: the channels of the augmentation input, the shape at which the
    # kernel phase times the branch's kernel)
    for name, kernel, aug_kw, aug_c in [
        ("warp + chain (4-channel input, no transplant)", "fused_warp_apply",
         dict(random_transplantation_with_depth=False), 4),
        ("chain alone (no affine)", "fused_apply", dict(random_affine=False), 5),
    ]:
        bcfg = dataclasses.replace(cfg, augmentation_config=AugmentationConfig(**aug_kw), in_channels=4)
        _, bstate, _, bstep, bimages, _ = _train_setup(bcfg, batch, "cuda")
        if bimages.shape[1] != aug_c:
            raise AssertionError(f"train branch {name}: input {tuple(bimages.shape)}, expected {aug_c} channels")
        bstate, _ = bstep(bstate, bimages, coords, gen)
        _reset_counts()
        for _ in range(3):
            bstate, bloss = bstep(bstate, bimages, coords, gen)
        torch.cuda.synchronize()
        n = _counts()[kernel]
        if n != 3 or not torch.isfinite(bloss):
            raise AssertionError(f"train branch {name}: {kernel} launched {n} times in 3 steps, loss {bloss.item()}")
        branch_counts[kernel] = n
        log(f"train branch {name}: {kernel} launched {n} times in 3 steps, input {tuple(bimages.shape)}, loss {bloss.item():.6f}")
        del bstate, bimages
    del state, images
    torch.cuda.empty_cache()

    train_cuda_vs_cpu(cfg)
    return counts, branch_counts, step_ms


# every random augmentation stage off: the deterministic pipeline
AUG_OFF = dict(
    random_transplantation_with_depth=False, random_affine=False, random_erasing=False,
    planckian_jitter=False, color_jiggle=False, blur=False, random_plasma_shadow=False,
    random_bias=False, depth_gaussian_noise=False, random_near_plane=False, random_far_plane=False,
)


def train_cuda_vs_cpu(cfg, dev="cuda"):
    """The train step on the card against the CPU step (which the tier-1
    tests hold against the JAX package), on a small f32 configuration:

      * the full augmentation on synthetic frames, the same draws, from the
        state after one step: the loss and the new batch stats (the
        augmentation kernel and the forward);
      * random-pixel frames with every random augmentation stage off, from
        the seeded initial state: the loss and each gradient leaf before
        the optimizer, by its norm (a wrong pool gradient reaches only
        conv1 and bn1, so it shows there); then clip + AdamW alone on the
        card's gradients, on both devices, with the moments of the state
        after one step.

    Where the gradients are compared matters, because a gradient is not a
    continuous function of its input's rounding. The pool routes g whole
    to EVERY input equal to its window max, so on flat regions (a synthetic
    cube face, an erased rectangle) a one-ulp difference between the
    devices' conv sums makes or breaks a tie; and a ReLU input within
    rounding of 0 takes its gradient or drops it. Either moves conv1's and
    bn1's gradients by percents. Random pixels have no flat regions, and
    from the seeded initial state no ReLU input of this batch lies within
    rounding of 0 (after one step one does, at layer2.0's output, and the
    CPU's f32 gradients part from its f64 ones there by 8.5e-3)."""
    import dataclasses

    import numpy as np
    import torch

    from perseus_tpu_torch.augment.pipeline import AugmentationConfig
    from perseus_tpu_torch.data.synthetic import make_batch
    from perseus_tpu_torch.train import train

    to = lambda t, d: {k: to(v, d) for k, v in t.items()} if isinstance(t, dict) else t.to(d)  # noqa: E731

    def on_both(small, sbatch, state):
        """(loss, grads, new batch stats) of one draw, on the card and on the CPU."""
        _, _, aug, _, images, coords = _train_setup(small, sbatch, "cpu")
        draws = aug.sample(torch.Generator().manual_seed(2), 4, 64, 64, images.shape[1])
        dev_state = train.TrainState(to(state.params, dev), to(state.batch_stats, dev), state.opt_state)
        loss_and_grads = train.make_loss_and_grads(small, aug)
        old_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            on_dev = loss_and_grads(dev_state, images.to(dev), coords.to(dev), draws=to(draws, dev))
        finally:
            torch.backends.cudnn.deterministic = old_det
        return on_dev, loss_and_grads(state, images, coords, draws=draws)

    small = dataclasses.replace(cfg, batch_size=4, amp=False, learning_rate=2e-4)
    sbatch = make_batch(4, 64, 64, small.n_keypoints, seed=5)
    opt, init, aug, step, images, coords = _train_setup(small, sbatch, "cpu")
    stepped, _ = step(init, images, coords, draws=aug.sample(torch.Generator().manual_seed(1), 4, 64, 64, images.shape[1]))

    (dev_loss, _, dev_stats), (cpu_loss, _, cpu_stats) = on_both(small, sbatch, stepped)
    loss_rel = abs(dev_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    stat_err = max((dev_stats[k].cpu() - v).abs().max().item() for k, v in cpu_stats.items())
    if not (loss_rel < 1e-5 and stat_err < 1e-4):
        raise AssertionError(f"CUDA and CPU train steps disagree: loss rel {loss_rel}, batch stats {stat_err}")
    log(f"small f32 train step, full augmentation, CUDA vs CPU: loss rel diff {loss_rel:.3e}, batch stats max abs {stat_err:.3e}")

    rng = np.random.default_rng(0)
    rbatch = dict(sbatch, image=rng.uniform(0, 1, np.shape(sbatch["image"])).astype(np.float32),
                  depth_image=rng.uniform(3, 14, np.shape(sbatch["depth_image"])).astype(np.float32))
    off = dataclasses.replace(small, augmentation_config=AugmentationConfig(**AUG_OFF))
    (dev_loss, dev_grads, _), (cpu_loss, cpu_grads, _) = on_both(off, rbatch, init)
    loss_rel = abs(dev_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    rel = {k: ((dev_grads[k].cpu() - g).norm() / g.norm().clamp_min(1e-30)).item() for k, g in cpu_grads.items()}
    worst = max(rel, key=rel.get)
    moments = dataclasses.replace(stepped.opt_state, exp_avg=to(stepped.opt_state.exp_avg, dev),
                                  exp_avg_sq=to(stepped.opt_state.exp_avg_sq, dev))
    dev_params, _ = opt.update(dev_grads, moments, to(stepped.params, dev))
    cpu_params, _ = opt.update(to(dev_grads, "cpu"), stepped.opt_state, stepped.params)
    opt_err = max((dev_params[k].cpu() - v).abs().max().item() for k, v in cpu_params.items())
    if not (loss_rel < 1e-5 and rel[worst] < 1e-4 and opt_err < 1e-6):
        raise AssertionError(
            f"CUDA and CPU train steps disagree on random pixels: loss rel {loss_rel}, gradient of {worst} "
            f"rel {rel[worst]}, clip + AdamW on the same gradients {opt_err}"
        )
    log(
        f"small f32 train step, random pixels, CUDA vs CPU: loss rel diff {loss_rel:.3e}, gradients per leaf "
        f"||diff|| / ||grad|| max {rel[worst]:.3e} ({worst}; conv1.weight {rel['conv1.weight']:.3e}, bn1.bias "
        f"{rel['bn1.bias']:.3e}), clip + AdamW on the same gradients max abs {opt_err:.3e}"
    )


VAL_ROWS = 300  # not a multiple of the batch: the eval mask's filler rows


def _device_split(cfg, n, seed):
    """A device-resident split of ``n`` synthetic rows: the (N, 5, H, W) f32
    augmentation input (RGB, depth, seg) and (N, K, 2) keypoints, on the card."""
    import numpy as np
    import torch

    from perseus_tpu_torch.data.synthetic import make_batch
    from perseus_tpu_torch.train import train

    batch = make_batch(n, cfg.input_resolution, cfg.input_resolution, cfg.n_keypoints, seed=seed)
    images = torch.from_numpy(train._prepare_aug_batch(batch, cfg.in_channels, True)).to("cuda")
    coords = torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32)).to("cuda")
    return images, coords


def phase_train_unfused():
    """The trainer's device-resident-data configuration with the unfused
    augmentation, at the default TrainConfig, counted and timed."""
    import numpy as np
    import torch

    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.train import train
    from perseus_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig()
    b = cfg.batch_size
    t0 = time.perf_counter()
    ds_images, ds_coords = _device_split(cfg, 4 * b, seed=cfg.random_seed)
    log(f"train unfused: split {tuple(ds_images.shape)} {ds_images.dtype} "
        f"({ds_images.numel() * 4 / 1e9:.3f} GB) made and uploaded in {time.perf_counter() - t0:.3f} s")
    opt = train.make_optimizer(cfg)
    state = train.init_state(cfg, opt, device="cuda")
    aug = KeypointAugmentation(cfg.augmentation_config, fused=False)
    epoch_fn = train.make_device_data_epoch_fn(cfg, opt, aug)
    # epoch order: a permutation of the split per epoch, as the JAX trainer draws it
    rng = np.random.default_rng(cfg.random_seed)
    order = np.concatenate([rng.permutation(len(ds_images)) for _ in range(7)])
    idx = torch.from_numpy(order[: (TRAIN_WARMUP + TRAIN_STEPS) * b].reshape(-1, b)).to("cuda")
    state, _ = epoch_fn(state, ds_images, ds_coords, idx[:TRAIN_WARMUP], cfg.random_seed, 0)
    torch.cuda.synchronize()

    _reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    state, losses = epoch_fn(state, ds_images, ds_coords, idx[TRAIN_WARMUP:], cfg.random_seed, TRAIN_WARMUP)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    counts = _counts()
    expect = {"max_pool_3x3_s2": TRAIN_STEPS, "max_pool_3x3_s2_backward": TRAIN_STEPS, "fused_ultra_apply": 0,
              "fused_apply": 0, "fused_warp_apply": 0, "warp_affine_two_pass": TRAIN_STEPS}
    if counts != expect:
        raise AssertionError(f"unfused train launches {counts}, expected {expect} over {TRAIN_STEPS} steps")
    finite = bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(v).all()) for v in state.params.values())
    if losses.shape != (TRAIN_STEPS,) or not finite:
        raise AssertionError(f"unfused train epoch: losses {tuple(losses.shape)}, finite {finite}")
    log(
        f"train unfused, device-resident split, TrainConfig() batch {b}: {step_ms:.4f} ms/step, "
        f"{b / step_ms * 1e3:.1f} img/s (CUDA events over {TRAIN_STEPS} steps in one epoch call); "
        f"{wall_ms:.4f} ms/step host clock; losses {losses[0].item():.6f} -> {losses[-1].item():.6f}; "
        f"launches per step {{{', '.join(f'{k}: {v / TRAIN_STEPS:g}' for k, v in counts.items())}}}"
    )

    images, coords = ds_images[:b], ds_coords[:b]
    gen = torch.Generator(device="cuda").manual_seed(cfg.random_seed)
    step_breakdown(
        "train unfused", "sample + unfused op chain, warp kernel #3", cfg, state, aug, opt, images, coords, gen,
        step_ms, lambda: epoch_fn(state, ds_images, ds_coords, idx[:3], cfg.random_seed, 0),
    )
    del ds_images, ds_coords

    # the eval step over a val split whose row count is not a multiple of the batch
    val_images, val_coords = _device_split(cfg, VAL_ROWS, seed=cfg.random_seed + 1)
    val_aug = KeypointAugmentation(cfg.augmentation_config, train=False)
    dd_eval = train.make_device_data_eval_step(cfg, val_aug)
    total, count, n_batches = 0.0, 0.0, 0
    for idx_v, mask in train.eval_index_batches(VAL_ROWS, b):
        s_, n_ = dd_eval(state, val_images, val_coords, idx_v, mask)
        total, count, n_batches = total + s_.item(), count + n_.item(), n_batches + 1
    eval_step = train.make_eval_step(cfg, val_aug)
    parts = [eval_step(state, val_images[a:z], val_coords[a:z], torch.ones(z - a, device="cuda"))
             for a, z in ((0, b), (b, VAL_ROWS))]
    whole = sum(p[0].item() for p in parts)
    rel = abs(total - whole) / abs(whole)
    # rel 1e-3: bf16 convolutions, and cuDNN may take another algorithm for a batch of 44
    if count != VAL_ROWS or not np.isfinite(total) or not rel < 1e-3:
        raise AssertionError(f"device-data eval: count {count} of {VAL_ROWS} rows, loss sum {total} vs {whole}")
    log(f"eval over a {VAL_ROWS}-row val split in {n_batches} batches of {b}: count {count:g}, mean loss "
        f"{total / count:.6f}; the unpadded batches' sum differs by rel {rel:.3e}")
    del val_images, val_coords, state
    torch.cuda.empty_cache()
    unfused_cuda_vs_cpu(cfg)
    return counts, step_ms


def unfused_cuda_vs_cpu(cfg):
    """The unfused augmentation on the card against the CPU (which the
    tier-1 tests hold against the JAX package) on a small f32 batch, the
    same draws: transplant, the two-pass warp kernel, every op. A value
    that sits on a discontinuity (an erase edge, a tap floor, a hue tie, a
    depth plane) would differ by a jump: the worst elements are printed."""
    import numpy as np
    import torch

    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.data.synthetic import make_batch
    from perseus_tpu_torch.train import train

    batch = make_batch(4, 64, 64, cfg.n_keypoints, seed=7)
    images = torch.from_numpy(train._prepare_aug_batch(batch, cfg.in_channels, True))
    coords = torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32))
    aug = KeypointAugmentation(cfg.augmentation_config, fused=False)
    draws = aug.sample(torch.Generator().manual_seed(3), 4, 64, 64, 5)
    on_cpu, crd_cpu = aug.apply(images, coords, draws)
    on_dev, crd_dev = aug.apply(images.cuda(), coords.cuda(), draws)
    diff = (on_dev.cpu() - on_cpu).abs()
    crd_err = (crd_dev.cpu() - crd_cpu).abs().max().item()
    if not (diff.max().item() <= 1e-5 and crd_err <= 1e-5):
        worst = torch.topk(diff.flatten(), 5)
        where = [tuple(int(i) for i in torch.unravel_index(k, diff.shape)) for k in worst.indices]
        log(f"unfused CUDA vs CPU: worst elements (b, c, y, x) {where}: card "
            f"{[on_dev.cpu()[w].item() for w in where]}, CPU {[on_cpu[w].item() for w in where]}")
        raise AssertionError(f"unfused augmentation, CUDA vs CPU: max abs {diff.max().item()}, coords {crd_err}")
    log(f"small f32 unfused augmentation (4, 5, 64, 64), CUDA vs CPU, same draws: max abs diff "
        f"{diff.max().item():.3e}, coords {crd_err:.3e}")


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
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:5]
        log(
            f"breakdown: traced 4 frames, kernels {busy_us / 4:.1f} us/frame, device busy {busy_us / wall_us:.6f} "
            f"of wall ({busy_us:.1f} of {wall_us:.1f} us, profiler on), {launches / 4:.1f} kernels/frame"
        )
        for e in top:
            log(f"breakdown:   {e.key[:70]}: {e.self_device_time_total / 4:.1f} us/frame")
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


def _entry(name, source, replaces, launches, err, timing, library_ms):
    t_kernel, t_plain, bound, by = timing
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
        "library_ms": library_ms,
    }


def main() -> int:
    try:
        import torch

        import perseus_tpu_torch  # noqa: F401  (the port, from this checkout)
    except ImportError as exc:
        print(f"[smoke] FAIL: cannot import the port ({exc}); run from the repo root", file=sys.stderr)
        return 1
    phase = "device"
    t_start = time.perf_counter()

    def run(name, fn, *args):
        nonlocal phase
        phase = name
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s (run so far {time.perf_counter() - t_start:.1f} s)")
        return out

    try:
        run("device", phase_device)
        run("build", phase_build)
        fwd, fwd_err = run("kernel: maxpool forward", phase_pool_kernel, (256, 64, 128, 128), torch.bfloat16)
        bwd, bwd_err = run("kernel: maxpool backward", phase_pool_backward_kernel)
        augk = run("kernel: augmentation", phase_augment_kernels)
        warpk = run("kernel: two-pass warp", phase_warp_kernel)
        train_counts, branch_counts, _ = run("train", phase_train)
        unfused_counts, _ = run("train unfused (device-resident split)", phase_train_unfused)
        serving_launches = run("serving", phase_serving)
    except Exception as exc:  # report which phase failed, with its traceback
        import traceback

        traceback.print_exc()
        print(f"[smoke] FAIL in phase {phase}: {exc}", file=sys.stderr)
        return 1
    log(f"maxpool forward launches: {train_counts['max_pool_3x3_s2']} in {TRAIN_STEPS} train steps, "
        f"{serving_launches} in {N_FRAMES} serving frames")
    pool_src, aug_src = "perseus_tpu_torch/csrc/maxpool.cu", "perseus_tpu_torch/csrc/augment.cu"
    # each kernel timed at the shape of the path that counts it: the ultra
    # kernel and the chain branch take 5 channels, the warp branch 4
    aug = lambda kind, c: augk[(kind, c, torch.float32)]  # noqa: E731
    kernels = [
        _entry("max_pool_3x3_s2", pool_src, "perseus_tpu/models/pool_pallas.py:55",
               train_counts["max_pool_3x3_s2"], fwd_err, (fwd[0], fwd[1], fwd[3], fwd[4]), fwd[2]),
        _entry("max_pool_3x3_s2_backward", pool_src, "perseus_tpu/models/pool_pallas.py:79",
               train_counts["max_pool_3x3_s2_backward"], bwd_err, (bwd[0], bwd[1], bwd[3], bwd[4]), bwd[2]),
        _entry("fused_apply", aug_src, "perseus_tpu/augment/fused.py:333",
               branch_counts["fused_apply"], aug("chain", 5)[4], aug("chain", 5)[:4], None),
        _entry("fused_warp_apply", aug_src, "perseus_tpu/augment/fused.py:395",
               branch_counts["fused_warp_apply"], aug("warp", 4)[4], aug("warp", 4)[:4], None),
        _entry("fused_ultra_apply", aug_src, "perseus_tpu/augment/fused.py:413",
               train_counts["fused_ultra_apply"], aug("ultra", 5)[4], aug("ultra", 5)[:4], None),
        # no single PyTorch call computes the two-pass warp (F.grid_sample,
        # logged beside it, is a direct 2-D bilinear warp)
        _entry("warp_affine_two_pass", aug_src, "perseus_tpu/augment/warp_pallas.py:70",
               unfused_counts["warp_affine_two_pass"], warpk[4], warpk[:4], None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
