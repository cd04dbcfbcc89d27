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
     forward + backward, optimizer; the kernels by torch.profiler); the
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
     (GN-4), random weights from a seed, 32 frames, the step captured into a
     CUDA graph on the first call and replayed after. Every output finite;
     the maxpool's launches counted over exactly this run (one a replayed
     frame); under cuDNN's deterministic algorithms, graph replay against
     the eager step bit for bit on the 32 frames (keypoints, rotations,
     translations, the last carry) for GN-4 "jacfwd", GN-4 "block" and LM-8,
     and the smoother's graphed update against its eager update on a
     sequence whose jumps drive the innovation gate through rejections and
     two resets; the plain maxpool captured in a graph of its own must give
     identical keypoints and poses; serving ms/frame of the graph and the
     eager step in turns (CUDA events, host clock); where a frame's time
     goes (detector alone, the smoother alone as a graph and eagerly in
     turns, and for replayed and eager frames the kernels a frame runs, its
     graph launches by torch.profiler); LM-8,
     graph and eager in turns; the detector alone at batch 256; and the
     CUDA pipeline against the CPU pipeline on a small f32 configuration;
  6. the train loop at the default TrainConfig: a decoded synthetic split of
     1,024 train and 256 val rows at 256x256 (numpy alone, in a temporary
     directory under outputs/); train() on the host loader, 2 epochs with a
     save each and the EMA, #6, #1 and #2 counted inside the call (#6 and
     #2 once per step, #1 also once per val batch); the host loader's
     batch alone (materialise, prepare, copy); one epoch with a save and a
     traced window (train()'s profile_dir: the kernels a step), then the
     second resumed, against a straight run, under cuDNN's deterministic
     algorithms: run id, epoch, LR, scheduler memory and AdamW step equal,
     losses, params and EMA bit for bit; the device-resident split, the
     epoch in one call and step by step; a half-size subset redrawn every
     epoch. Each path's img/s per epoch. The split and the runs'
     directories are deleted;
  7. the synthetic-data path and its evaluation at full width: (7a)
     render_video's simulation (host clock) and textures + render (CUDA
     events, peak memory) at the default VideoConfig (256x256, 24 frames,
     up to 24 objects, ground, shadows, textures) for two job ids, the
     first job's first frames rendered again on the CPU (seg equal on
     99.5% of each frame's pixels; where it agrees, rgb within 1e-4 and
     depth within rel 1e-5 on 99.5% of them) and its metadata equal; (7b)
     label_trajectory on the card against the CPU (1e-3 px), the corners'
     box against the cube's silhouette (the cube rendered alone); (7c)
     the pose scorer over the rendered frames with the perfect detector
     (pose RMSE under 5 mm and 6 deg) and with the ResNet-18 from random
     weights in bf16 (finite; #1 once per frame and once for the cold
     start); (7d) validate_stats at the default ValConfig (batch 1,024,
     bf16, depth) over a decoded split of 1,024 rows from a checkpoint
     the phase writes (#1 once per val batch, img/s), and the card against
     the CPU in f32 on 16 rows (losses and RMSE within rel 1e-3). The split
     and the checkpoint are deleted;
  8. the eval and runtime tools at full width: (8a) run_parity at the
     default ParityConfig (4 channels, batch 32, lr 1e-3, wd 1e-2, clip
     1.0; epochs cut from 15 to 2) over a decoded split of 512 + 128 rows
     at 256x256, unaugmented and augmented (unfused, #3 once per step), the
     port's ResNet-18 (#1, #2 once per step) against a stock PyTorch one in
     f32 with TF32 off: final losses within 20%, round-trip logits within
     1e-5, and unaugmented the val RMSE ratio within 0.8-1.25 (the JAX
     test's bounds; the augmented ratio is logged: see phase_eval_tools);
     the two train steps timed alone; (8b) predict_real at the default
     ValConfig (bf16) over 48 frames at 376x672 and 8 at 1080x1920, #1 once
     per image, img/s, identical keypoints with the plain maxpool, card vs
     CPU in f32 (crops 1e-4, keypoints 1e-3 px); (8c) the augmentation
     grid's computation on 16 5-channel rows, #6 once, card vs CPU on the
     same draws (keypoints 1e-4 px; images 1e-5 with the affine off, since
     each device builds the affine matrices ulps apart); (8d) stream_frames over 8 frames in phase 5's serving
     config, #1 once per frame, equal to frame-by-frame calls;
  9. data parallel, every rank a process of its own (this script with
     --dp-rank) on cuda:0, a failed rank failing the phase: (9a) two gloo
     ranks against one rank, 3 f32 steps on one batch (TF32 off, the
     augmentation in eval mode) from one state: losses rel 1e-5, params and
     batch stats 1e-5, the replicas bit for bit, #1 and #2 once a step on
     every rank; (9b) train() at the default TrainConfig, two gloo ranks
     (128 rows each) over a decoded split of phase 6's size and seed (1,024 + 256 rows), one
     epoch on the host loader and one on the device-resident split, each
     against one rank stepping through the same global batches and draws:
     the first global batch bit for bit, the epoch's loss rel 2e-2 and the
     params atol 5e-2 (tests/test_distributed.py's tolerances), the val
     loss against one rank's eval of the same state rel 1e-3, the replicas
     bit for bit, #6 and #2 once per step and #1 once per step and val
     batch on every rank; img/s global and per rank, each rank's host share
     of a step, the all-reduces per step and the gloo all-reduce alone;
     (9c) NCCL at world size 1 through maybe_initialize_distributed: an
     all-reduce and a broadcast on the card, then train() on the
     device-resident split, its img/s;
 10. the scripts/ ports (perseus_tpu_torch/tools/) at full width, in a
     directory under outputs/ deleted after: render_videos at the default
     VideoConfig until the pruned train split holds 256 rows (one batch),
     2 holdout-style videos and 2 pose jobs (16 frames), no failed video;
     prepare_decoded into the main and holdout decoded splits;
     pretrain_backbone at the default PretrainConfig, 2 epochs (#1 and #2
     once a step), its step alone on CUDA events; train_at_scale from the
     pretrained backbone, 2 epochs, the EMA, holdout and pose evaluation
     (#6 and #2 once a step, #1 once a step and a val batch, a holdout
     batch and a pose frame): metrics.json with the JAX script's keys and
     no error key; compute_difficulty_weights on that checkpoint (#1 a
     batch) and one train() epoch sampling by its weights; eval_pose_multi
     over the pose jobs, eval_sensor_transfer on the holdout split,
     measure_oof on 2 videos, diag_pose_job, and pose_backend_check: the
     card's dump and the CPU's in f32, the keypoints within 1e-2 px, the
     smoothers on the SAME keypoints (the GT projection) within 0.05 deg
     and 2e-3 scene units, and each on its own detections within 1 deg and
     2e-2 units. Each tool's wall time;
 11. the bench and the entry points: (11a) ``python -m
     perseus_tpu_torch.bench`` at its defaults (the JAX bench's line:
     detector f/s at batch 256 bf16, the smoother alone as GN-4 and LM-8,
     streaming ms/frame, train img/s on a bf16-stored batch), every
     measured field finite and non-null, vs_baseline null, the JAX line's
     keys, the launches of #1, #2 and #6 in each of its phase processes
     equal to what its chain lengths give; (11b) #6 against its plain
     version on the bench's own bf16 (256, 5, 256, 256) train batch and
     draws (one bf16 ulp); (11c) graft_entry.entry() on the card, a finite
     (8, 16) with one launch of #1, and its bf16 difference from the CPU's
     forward of the same weights (logged); (11d)
     graft_entry.dryrun_multichip(2), two gloo ranks on cuda:0, #1, #2 and
     #6 once a step on each rank.

Prints each phase's wall time, the card line, then one JSON line describing
each kernel, then, as the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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


def time_ms_host(fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """Mean time of one call over ``iters`` back-to-back calls after
    ``warmup``: by CUDA events, and by the host clock from the first call
    to the end of the last call's work on the device."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, (time.perf_counter() - t0) * 1e3 / iters


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, by CUDA events over `iters` calls."""
    return time_ms_host(fn, iters, warmup)[0]


def time_turns(fns: dict, rounds: int = 7, iters: int = 50, warmup: int = 3) -> dict:
    """Median over ``rounds`` of each function's mean time per call over
    ``iters`` back-to-back calls, (CUDA events, host clock), the functions
    taking turns in every round, so that a drift of the shared host's speed
    falls on all of them alike."""
    import statistics

    runs = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            runs[name].append(time_ms_host(fn, iters=iters, warmup=warmup))
    return {name: tuple(statistics.median(t[i] for t in v) for i in (0, 1)) for name, v in runs.items()}


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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    print(card_line(), flush=True)
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
        t_kernel, t_lib = turns["kernel"][0], turns["lib"][0]
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
    from perseus_tpu_torch.utils.graphed import kernel_wrappers

    return kernel_wrappers()


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


def step_breakdown(label, aug_kind, cfg, state, aug, opt, images, coords, gen, traced_steps):
    """Where a train step's time goes: the augmentation (sampling + apply),
    forward + backward and clip + AdamW, each alone (CUDA events), and the
    kernels of 3 steps run by ``traced_steps`` under torch.profiler."""
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
        kernels_ms = sum(e.self_device_time_total for e in kernels) / 3 / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        log(
            f"{label} breakdown: traced 3 steps, kernels {kernels_ms:.4f} ms/step, {len(kernels)} distinct kernels, "
            f"{sum(e.count for e in kernels) / 3:.0f} launches/step"
        )
        for e in top:
            log(f"{label} breakdown:   {e.key[:70]}: {e.self_device_time_total / 3:.1f} us/step ({e.count / 3:.0f} launches)")
    except Exception as exc:  # the profiler is untried on this machine: report, do not fail
        log(f"{label} breakdown: kernels not traced (profiler: {exc!r})")


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

    step_breakdown("train", "sample + ultra kernel", cfg, state, aug, opt, images, coords, gen, traced_steps)

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
        lambda: epoch_fn(state, ds_images, ds_coords, idx[:3], cfg.random_seed, 0),
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


def _frames_out(step, carry, frames):
    """``step(frame, carry)`` over ``frames`` from ``carry``: the stacked
    keypoints, rotations and translations, one device flag for whether
    every output was finite, and the last carry."""
    import torch

    kps, rots, transs, finite = [], [], [], []
    for f in frames:
        k, image, carry, pose = step(f, carry)
        kps.append(k)
        rots.append(pose.rot)
        transs.append(pose.trans)
        finite.append(
            torch.isfinite(k).all() & torch.isfinite(image).all()
            & torch.isfinite(pose.rot).all() & torch.isfinite(pose.trans).all()
        )
    return torch.stack(kps), torch.stack(rots), torch.stack(transs), torch.stack(finite).all(), carry


def _run(pipeline, frames, eager=False):
    """All frames through a fresh carry, by the pipeline's call (on the card
    its captured step) or, with ``eager``, its eager step; returns stacked
    outputs and whether every output was finite (checked once, at the end)."""
    kps, rots, transs, finite, _ = _frames_out(pipeline.step_eager if eager else pipeline, pipeline.init_carry(),
                                               frames)
    return kps, rots, transs, bool(finite)


def _same_tree(a, b) -> bool:
    """Two pytrees of tensors with one structure and equal tensors, bit for bit."""
    import torch
    from torch.utils import _pytree as pytree

    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


GATE_JUMPS = (10, 22)  # frames at which the gate-reset sequence's corners jump away and back
GATE_JUMP_PX = 90.0


def _gate_sequence(smoother, n: int):
    """``n`` frames of the smoother's corners projected at a cube pose that
    turns and drifts (0.3 scene units in front of the camera), in pixels,
    every corner moved by GATE_JUMP_PX from frame GATE_JUMPS[0] until frame
    GATE_JUMPS[1] (the cube seen to jump away and back): after warm-up the
    innovation gate rejects ``gate_max_consec`` frames at each jump and
    resets the window on the next one."""
    import torch

    from perseus_tpu_torch.camera import project
    from perseus_tpu_torch.lie import so3_exp

    t = torch.arange(n, dtype=torch.float32, device=smoother.device)[:, None]
    rot = so3_exp(torch.cat([0.3 + 0.02 * t, -0.2 + 0.01 * t, 0.015 * t], dim=-1))
    trans = torch.cat([0.02 * torch.sin(0.2 * t), 0.01 * torch.cos(0.3 * t), 0.3 + 0.001 * t], dim=-1)
    p_cam = torch.einsum("tij,kj->tki", rot, smoother.points_body) + trans[:, None]
    away = ((t >= GATE_JUMPS[0]) & (t < GATE_JUMPS[1])).to(torch.float32)[:, :, None]
    return project(smoother.intrinsics, p_cam) + GATE_JUMP_PX * away


def _smoother_seq(update, carry, meas):
    """``update`` over the measurements from ``carry``: stacked rotations and
    translations, the last carry, and each frame's (consecutive rejections,
    frames seen) of the gate, on the device."""
    import torch

    rots, transs, gate = [], [], []
    for m in meas:
        carry, pose = update(carry, m)
        rots.append(pose.rot)
        transs.append(pose.trans)
        gate.append(torch.stack([carry.consec_rejects, carry.frames_seen]))
    return torch.stack(rots), torch.stack(transs), carry, torch.stack(gate)


def graph_vs_eager(sd, frames) -> None:
    """Graph replay against the eager step on the same card, bit for bit,
    under cuDNN's deterministic algorithms: the serving frames through a
    fresh pipeline (one capture, then replays) and through its eager step,
    for GN-4 "jacfwd", GN-4 "block" and LM-8 (keypoints, rotations,
    translations, the last carry); and the smoother's graphed update against
    its eager update on a sequence whose outliers drive the innovation gate
    through rejections and resets."""
    import torch

    from perseus_tpu_torch.runtime.streaming import StreamingPipeline
    from perseus_tpu_torch.smoother.lm import SmootherConfig

    cases = (
        ("GN-4 jacfwd", None),
        ("GN-4 block", SmootherConfig(window=24, max_iterations=4, accept_reject=False, solver="block")),
        ("LM-8", SmootherConfig(window=24)),
    )
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, smoother in cases:
            p = StreamingPipeline(_serving_config(smoother=smoother), sd, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph = _frames_out(p, p.init_carry(), frames)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eager = _frames_out(p.step_eager, p.init_carry(), frames)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            equal = [_same_tree(a, b) for a, b in zip(graph, eager)]
            log(f"graph vs eager, {label}, {len(frames)} frames: keypoints/rotations/translations/finite/carry equal "
                f"{equal}; graphs captured {p._step.graphs}; {(t1 - t0) * 1e3 / len(frames):.4f} ms/frame with the "
                f"capture, eager {(t2 - t1) * 1e3 / len(frames):.4f} (host clock)")
            if not all(equal) or not bool(graph[3]) or p._step.graphs != 1:
                raise AssertionError(f"graph replay differs from the eager step ({label}): equal {equal}, "
                                     f"finite {bool(graph[3])}, graphs {p._step.graphs}")
        sm = StreamingPipeline(_serving_config(), sd, device="cuda").smoother
        meas = _gate_sequence(sm, len(frames))
        start = sm.coarse_pose_from_keypoints(meas[0])  # the cold start, as the pose scorer's
        graph = _smoother_seq(sm.graphed_update, sm.init(start), meas)
        eager = _smoother_seq(sm.update, sm.init(start), meas)
    finally:
        torch.backends.cudnn.deterministic = old_det
    gate = eager[3].cpu().tolist()
    rejects = sum(1 for c, _ in gate if c > 0)
    resets = [i for i, (_, seen) in enumerate(gate) if i > 0 and seen == 1]
    equal = [_same_tree(a, b) for a, b in zip(graph, eager)]
    log(f"graph vs eager, smoother GN-4 jacfwd on the gate sequence ({len(frames)} frames, jumps at frames "
        f"{GATE_JUMPS}): rotations/translations/carry/gate equal {equal}; {rejects} frames rejected, resets at "
        f"frames {resets}")
    want = [first + sm.cfg.gate_max_consec for first in GATE_JUMPS]
    if not all(equal) or resets != want or rejects != len(GATE_JUMPS) * sm.cfg.gate_max_consec:
        raise AssertionError(f"gate sequence: equal {equal}, {rejects} rejections, resets {resets} (want {want})")


def chain_turns(steps: dict, init, inputs, iters: int = 8) -> dict:
    """ms per call of each ``step(input, carry) -> carry``, a chain of its
    own from ``init()`` over ``inputs`` (cycled), in turns (``time_turns``,
    3 rounds): (CUDA events, host clock) medians."""
    fns = {}
    for name, step in steps.items():
        state = [init(), 0]

        def one(step=step, state=state):
            state[0] = step(inputs[state[1] % len(inputs)], state[0])
            state[1] += 1

        fns[name] = one
    return time_turns(fns, rounds=3, iters=iters, warmup=1)


def serving_turns(pipeline, frames, iters: int = 8) -> dict:
    """Serving ms/frame of the captured step and of the eager step, in turns."""
    return chain_turns({"graph": lambda f, c: pipeline(f, c)[2], "eager": lambda f, c: pipeline.step_eager(f, c)[2]},
                       pipeline.init_carry, frames, iters)


def trace_frames(label: str, step, carry, frames) -> None:
    """The kernels a frame runs, their device time a frame and the graph
    launches it makes (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for f in frames:
                _, _, carry, _ = step(f, carry)
            torch.cuda.synchronize()
        events = prof.key_averages()
    except Exception as exc:  # the profiler is a diagnostic here: report, do not fail
        log(f"{label}: kernels not measured (profiler: {exc!r})")
        return
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"{label}: kernels not measured (the profiler saw no kernel)")
        return
    kernels_us = sum(e.self_device_time_total for e in kernels) / n
    graph_launches = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    log(f"{label}: traced {n} frames, {sum(e.count for e in kernels) / n:.1f} kernels/frame, "
        f"{graph_launches / n:g} graph launches/frame, kernels {kernels_us:.1f} us/frame")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:5]:
        log(f"{label}:   {e.key[:70]}: {e.self_device_time_total / n:.1f} us/frame ({e.count / n:g} launches)")


def breakdown(pipeline, frames, sd) -> None:
    """Where a serving frame's time goes: the detector alone at batch 1, the
    smoother update alone (the same GN-4 config, and the block solver for
    comparison) as a graph and eagerly in turns, and the kernels of
    replayed and of eager frames."""
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
        sm = StreamingPipeline(_serving_config(smoother=cfg), sd, device="cuda").smoother
        t = chain_turns({"graph": lambda m, c: sm.graphed_update(c, m)[0], "eager": lambda m, c: sm.update(c, m)[0]},
                        sm.init, meas)
        log(f"breakdown: smoother update alone (GN-4, solver={solver}), in turns, CUDA events / host clock: graph "
            f"{t['graph'][0]:.4f} / {t['graph'][1]:.4f} ms, eager {t['eager'][0]:.4f} / {t['eager'][1]:.4f} ms")
    carry = pipeline.init_carry()
    for f in frames[:4]:
        _, _, carry, _ = pipeline(f, carry)
    trace_frames("breakdown, replayed frames", pipeline, carry, frames[4:12])
    trace_frames("breakdown, eager frames", pipeline.step_eager, carry, frames[4:6])


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

    # the first call captures the step (an eager warm-up, the capture, a
    # replay); then the counted, timed main path, replays only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _run(pipeline, frames[:4])
    torch.cuda.synchronize()
    log(f"serving: capture and 4 frames {time.perf_counter() - t0:.3f} s (host clock)")
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
    if launches != N_FRAMES or pipeline._step.graphs != 1:
        raise AssertionError(f"maxpool kernel launched {launches} times on {N_FRAMES} replayed frames, "
                             f"{pipeline._step.graphs} graphs captured")
    log(
        f"serving GN-4 window 24 (graph replay): {N_FRAMES} frames, {event_ms:.4f} ms/frame (CUDA events), "
        f"{wall_ms:.4f} ms/frame (host clock); maxpool launches {launches}"
    )

    graph_vs_eager(sd, frames)

    # kernel vs plain maxpool, each captured in a pipeline of its own (the
    # patch before the capture): identical results
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = _run(StreamingPipeline(_serving_config(), sd, device="cuda"), frames)
        with mock.patch.object(pool, "max_pool_3x3_s2", pool.max_pool_3x3_s2_reference):
            b = _run(StreamingPipeline(_serving_config(), sd, device="cuda"), frames)
    finally:
        torch.backends.cudnn.deterministic = old_det
    for name, x, y in zip(("keypoints", "rotations", "translations"), a[:3], b[:3]):
        if not torch.equal(x, y):
            diff = (x - y).abs().max().item()
            raise AssertionError(f"kernel and plain maxpool graphs differ in {name} by {diff}")
    log(f"serving graph with the plain maxpool captured: identical keypoints and poses on {N_FRAMES} frames")

    turns = serving_turns(pipeline, frames)
    log(f"serving GN-4 ms/frame in turns (median of 3 rounds of 8 frames), CUDA events / host clock: graph "
        f"{turns['graph'][0]:.4f} / {turns['graph'][1]:.4f}, eager {turns['eager'][0]:.4f} / "
        f"{turns['eager'][1]:.4f} ({card_line()})")

    breakdown(pipeline, frames, sd)

    # the default smoother (LM-8 with accept/reject), graph and eager in turns
    lm8 = StreamingPipeline(_serving_config(smoother=SmootherConfig()), sd, device="cuda")
    _, _, _, finite = _run(lm8, frames[:8])
    if not finite:
        raise AssertionError("LM-8 serving path produced non-finite outputs")
    t = serving_turns(lm8, frames, iters=4)
    log(f"serving LM-8 window 24 ms/frame in turns (median of 3 rounds of 4 frames), CUDA events / host clock: "
        f"graph {t['graph'][0]:.4f} / {t['graph'][1]:.4f}, eager {t['eager'][0]:.4f} / {t['eager'][1]:.4f}")

    # the detector alone at batch 256 in bf16
    folded = resnet.fold_batchnorm(sd)
    x = torch.rand((256, 4, 256, 256), generator=torch.Generator().manual_seed(1)).to("cuda")
    det_ms = time_ms(lambda: resnet.keypoint_cnn_apply_folded(folded, x), iters=10, warmup=3)
    log(f"detector batch 256 bf16: {det_ms:.4f} ms/batch, {256 / det_ms * 1e3:.1f} frames/s")

    # CUDA (graph) against the CPU path on a small f32 configuration
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


LOOP_ROWS, LOOP_VAL_ROWS = 1024, 256  # the train loop's decoded split: 4 steps an epoch at batch 256


def _logged(run_id: str, key: str) -> list:
    """One metric of a run's metrics.jsonl, in order."""
    import os

    from perseus_tpu_torch import ROOT

    with open(os.path.join(ROOT, "outputs", "runs", run_id, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def _counted_train(label, cfg, run_ids, expect_steps, val_batches):
    """train(cfg) on the card with every kernel's launches counted over
    exactly that call: #6, #2 one per train step, #1 one per train step and
    one per val batch, the others none; finite losses, params and EMA; its
    img/s per epoch (the run's own log)."""
    import torch

    from perseus_tpu_torch.train import train

    _reset_counts()
    t0 = time.perf_counter()
    result = train.train(cfg)
    wall = time.perf_counter() - t0
    counts = _counts()
    run_ids.append(result["run_id"])
    expect = {"max_pool_3x3_s2": expect_steps + val_batches, "max_pool_3x3_s2_backward": expect_steps,
              "fused_ultra_apply": expect_steps, "fused_apply": 0, "fused_warp_apply": 0, "warp_affine_two_pass": 0}
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} inside train(), expected {expect}")
    state = result["state"]
    tensors = list(state.params.values()) + list(state.batch_stats.values())
    if result["ema"] is not None:
        tensors += list(result["ema"]["params"].values())
    if not (all(t.is_cuda and bool(torch.isfinite(t).all()) for t in tensors)
            and all(map(math.isfinite, result["train_loss_history"] + [result["final_val_loss"]]))):
        raise AssertionError(f"{label}: non-finite or off-card results {result['train_loss_history']}")
    rates, times = _logged(result["run_id"], "train_images_per_sec"), _logged(result["run_id"], "epoch_time_s")
    n_epochs = len(result["train_loss_history"])
    overall = expect_steps * cfg.batch_size / sum(times)
    log(f"{label}: {n_epochs} epochs, {expect_steps} steps in {wall:.3f} s of train(); img/s per epoch "
        f"{[round(r, 1) for r in rates]} (epoch times {[round(t, 4) for t in times]} s), over its epochs "
        f"{overall:.1f} img/s; train losses {result['train_loss_history']}, "
        f"val {result['final_val_loss']:.6f}; launches {counts}")
    return result, times, overall


def _trace_kernels(trace_dir: str) -> tuple[float, float, int]:
    """(kernel ms, memcpy ms, kernel launches) in the chrome trace train()
    wrote under ``trace_dir``."""
    import os

    (name,) = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    memcpy = [e for e in events if e.get("cat") == "gpu_memcpy"]
    return sum(e["dur"] for e in kernels) / 1e3, sum(e["dur"] for e in memcpy) / 1e3, len(kernels)


def host_batch_times(cfg, batches: int = 5) -> dict:
    """The host loader's work for one batch alone, on the host clock, median
    over ``batches`` batches after one warm-up: materialise (the
    dataset's rows from the memory-mapped decoded split), prepare
    (``_prepare_aug_batch`` into a pinned buffer) and copy (pinned -> card,
    synchronised)."""
    import statistics

    import numpy as np
    import torch

    from perseus_tpu_torch.data.dataset import PrunedKeypointDataset
    from perseus_tpu_torch.train import train

    ds = PrunedKeypointDataset(cfg.dataset_config, train=True)
    order = np.random.default_rng(1).permutation(len(ds))
    c = train._aug_channels(cfg.in_channels, cfg.augmentation_config.random_transplantation_with_depth)
    buf = torch.empty((cfg.batch_size, c, ds.H, ds.W), pin_memory=True)
    parts = {"materialise": [], "prepare": [], "copy": []}
    for i in range(batches + 1):
        idx = order[(i * cfg.batch_size) % len(ds):][: cfg.batch_size]
        t0 = time.perf_counter()
        batch = ds.batch(idx)
        t1 = time.perf_counter()
        train._prepare_aug_batch(batch, cfg.in_channels, True, out=buf.numpy())
        t2 = time.perf_counter()
        buf.to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i:
            for k, t in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k].append(t * 1e3)
    out = {k: statistics.median(v) for k, v in parts.items()}
    gb = buf.numel() * 4 / 1e9
    log(f"host loader, one batch alone ({cfg.batch_size} rows, {gb:.3f} GB f32), median of {batches} (host clock): "
        f"materialise {out['materialise']:.3f} ms, prepare {out['prepare']:.3f} ms, copy to the card "
        f"{out['copy']:.3f} ms ({gb / out['copy'] * 1e3:.2f} GB/s); total {sum(out.values()):.3f} ms")
    return out


def phase_train_loop():
    """The trainer's main path at the default TrainConfig over a decoded
    synthetic split (LOOP_ROWS train, LOOP_VAL_ROWS val rows at 256x256):
    train() on the host loader (2 epochs, a save every epoch, the EMA), its
    launches of #6, #1 and #2 counted inside the call; resume (one epoch and
    a save, then the second epoch resumed) against the straight run, both
    under cuDNN's deterministic algorithms, bit for bit; the
    device-resident split with the epoch in one call and step by step; the
    row subset redrawn every epoch. The split and the runs' directories are
    deleted at the end."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import torch

    from perseus_tpu_torch import ROOT
    from perseus_tpu_torch.data.dataset import KeypointDatasetConfig
    from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split
    from perseus_tpu_torch.train import checkpoint as ckpt
    from perseus_tpu_torch.train import train
    from perseus_tpu_torch.train.config import TrainConfig

    base = TrainConfig()
    os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_train_loop_", dir=os.path.join(ROOT, "outputs"))
    run_ids = []
    try:
        t0 = time.perf_counter()
        split = generate_synthetic_decoded_split(
            os.path.join(tmp, "split"), LOOP_ROWS, LOOP_VAL_ROWS, base.input_resolution, base.input_resolution,
            base.n_keypoints, seed=base.random_seed,
        )
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(split) for f in fs)
        log(f"train loop: decoded split of {LOOP_ROWS} + {LOOP_VAL_ROWS} rows at {base.input_resolution}^2 "
            f"({size / 1e9:.3f} GB on disk) written in {time.perf_counter() - t0:.3f} s; h5py and PIL imported: "
            f"{'h5py' in sys.modules}, {'PIL' in sys.modules}")
        cfg = dataclasses.replace(base, dataset_config=KeypointDatasetConfig(dataset_path=split), n_epochs=2,
                                  save_epochs=1, ema_decay=0.9)
        steps = LOOP_ROWS // cfg.batch_size
        val_batches = -(-LOOP_VAL_ROWS // cfg.batch_size)

        host_times = host_batch_times(cfg)
        _, _, host_rate = _counted_train("train loop, host loader", cfg, run_ids, 2 * steps, 2 * val_batches)

        # resume against the straight run, cuDNN deterministic; the first
        # run also traces steps 1-2 (train()'s profile_dir)
        prof_dir = os.path.join(tmp, "trace")
        old_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            straight = train.train(cfg)
            run_ids.append(straight["run_id"])
            first = train.train(dataclasses.replace(cfg, n_epochs=1, profile_dir=prof_dir, profile_steps=2))
            run_ids.append(first["run_id"])
            run_dir = os.path.join(ROOT, "outputs", "models", first["run_id"])
            saved = ckpt.restore_train_state(run_dir)
            resumed = train.train(dataclasses.replace(cfg, resume=run_dir))
        finally:
            torch.backends.cudnn.deterministic = old_det
        final = ckpt.restore_train_state(os.path.join(ROOT, "outputs", "models", straight["run_id"]))
        resumed_saved = ckpt.restore_train_state(run_dir)
        exact = {
            "run id": (resumed["run_id"], first["run_id"]),
            "epoch saved": (saved["epoch"], 0),
            "epoch after resume": (resumed_saved["epoch"], final["epoch"]),
            "lr": (resumed_saved["lr"], final["lr"]),
            "sched_best": (resumed_saved["sched_best"], final["sched_best"]),
            "sched_num_bad": (resumed_saved["sched_num_bad"], final["sched_num_bad"]),
            "AdamW step": (resumed["state"].opt_state.step, straight["state"].opt_state.step),
        }
        bad = {k: v for k, v in exact.items() if v[0] != v[1]}
        loss_diff = [abs(a - b) for a, b in zip(resumed["train_loss_history"], straight["train_loss_history"][1:])]
        param_diff = max((v - straight["state"].params[k]).abs().max().item() for k, v in resumed["state"].params.items())
        ema_diff = max((v - straight["ema"]["params"][k]).abs().max().item() for k, v in resumed["ema"]["params"].items())
        log(f"train loop resume (cuDNN deterministic): {exact}; resumed epoch's loss - straight's {loss_diff}, val "
            f"{resumed['final_val_loss'] - straight['final_val_loss']}; params max abs diff {param_diff}, EMA {ema_diff}")
        # tolerance 0: with cuDNN's deterministic algorithms every kernel of
        # the step is deterministic, and the loop's draws and order depend on
        # (seed, step) and (seed, epoch) alone
        if bad or any(loss_diff) or resumed["final_val_loss"] != straight["final_val_loss"] or param_diff or ema_diff:
            raise AssertionError(f"train loop: the resumed run parts from the straight one: {bad}")
        kernel_ms, memcpy_ms, launches = _trace_kernels(prof_dir)
        per_step = kernel_ms / 2
        log(f"train loop host loader, traced steps 1-2 (torch.profiler, train()'s profile_dir): kernels "
            f"{per_step:.4f} ms/step in {launches / 2:g} launches, host->card copies {memcpy_ms / 2:.4f} ms/step; "
            f"host batch alone {sum(host_times.values()):.3f} ms against kernels {per_step:.4f} ms a step")

        # the device-resident split: the epoch in one call, step by step
        dd = dataclasses.replace(cfg, data_on_device=True, n_epochs=1, ema_decay=0.0)
        scan, _, scan_rate = _counted_train("train loop, device-resident split, epoch in one call", dd, run_ids,
                                            steps, val_batches)
        per, _, per_rate = _counted_train("train loop, device-resident split, step by step",
                                          dataclasses.replace(dd, device_data_epoch_scan=False), run_ids, steps,
                                          val_batches)
        log(f"train loop device-resident: epoch call's losses - step by step's "
            f"{[a - b for a, b in zip(scan['train_loss_history'], per['train_loss_history'])]}")

        # a subset of half the rows, redrawn every epoch: freed, then uploaded anew
        uploads = []
        real = train._device_dataset

        def upload(*args, **kw):
            t = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            uploads.append((kw.get("subset"), time.perf_counter() - t))
            return out

        sub = dataclasses.replace(dd, n_epochs=2, device_data_rows=LOOP_ROWS // 2, device_data_refresh_epochs=1)
        with mock.patch.object(train, "_device_dataset", upload):
            _counted_train("train loop, device-resident subset refreshed each epoch", sub, run_ids,
                           2 * (LOOP_ROWS // 2 // cfg.batch_size), 2 * val_batches)
        drawn = [s for s, _ in uploads if s is not None]
        if len(drawn) != 2 or len(drawn[0]) != LOOP_ROWS // 2 or (drawn[0] == drawn[1]).all():
            raise AssertionError(f"train loop: subset uploads {[None if s is None else len(s) for s in drawn]}")
        log(f"train loop subset refresh: {len(uploads)} uploads (train, val, train), decode + upload "
            f"{[round(t, 3) for _, t in uploads]} s; the two subsets share {len(set(drawn[0]) & set(drawn[1]))} rows")
        log(f"train loop on {card_line()}: train() img/s over its epochs: host loader {host_rate:.1f}, "
            f"device-resident epoch call {scan_rate:.1f}, step by step {per_rate:.1f}; host loader batch alone "
            f"{sum(host_times.values()):.3f} ms ({', '.join(f'{k} {v:.3f}' for k, v in host_times.items())}) "
            f"against kernels {per_step:.4f} ms a step")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for run_id in run_ids:
            for kind in ("models", "runs"):
                shutil.rmtree(os.path.join(ROOT, "outputs", kind, run_id), ignore_errors=True)


VIDEO_JOBS = ("00000000", "00000001")  # job ids rendered at the default VideoConfig
CPU_RENDER_FRAMES = 4  # frames of the first job rendered again on the CPU
POSE_WINDOW = 8  # the pose scorer's smoother window (24 frames: 16 scored)
POSE_BOUND_MM, POSE_BOUND_DEG = 5.0, 6.0  # tests/test_pose_eval.py's perfect-detector bounds
VAL_ROWS = 1024  # one val batch at the default ValConfig
SHARE = 0.995  # card vs CPU render: equal seg pixels, and rgb / depth within tolerance where seg agrees
RGB_ATOL, DEPTH_RTOL = 1e-4, 1e-5


def _first_frames(sim: dict, n: int) -> dict:
    """A simulate_video result cut to its first n frames."""
    per_frame = ("obj_rot", "obj_trans", "cam_pose7_wxyz")
    return {**sim, "inputs": {k: v[:n] if k in per_frame else v for k, v in sim["inputs"].items()}}


def _render_timed(cfg, sim):
    """render_simulated on the card: (rgb, depth, seg, CUDA-event ms, peak
    bytes allocated during the call)."""
    import torch

    from perseus_tpu_torch.datagen import generate

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rgb, depth, seg = generate.render_simulated(cfg, sim, "cuda")
    end.record()
    end.synchronize()
    return rgb, depth, seg, start.elapsed_time(end), torch.cuda.max_memory_allocated() - base


def _check_render(rgb, depth, seg, n_obj, label):
    import torch

    t, h, w = seg.shape
    if rgb.shape != (t, h, w, 3) or depth.shape != (t, h, w):
        raise AssertionError(f"{label}: shapes rgb {tuple(rgb.shape)} depth {tuple(depth.shape)} seg {tuple(seg.shape)}")
    if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all() and (depth > 0).all()):
        raise AssertionError(f"{label}: non-finite rgb or depth, or depth <= 0")
    if rgb.min() < 0 or rgb.max() > 1 or seg.min() < 0 or seg.max() > n_obj:
        raise AssertionError(f"{label}: rgb in [{rgb.min()}, {rgb.max()}], seg in [{seg.min()}, {seg.max()}]")
    if not (seg == 1).any():
        raise AssertionError(f"{label}: the cube is in no frame")


def _render_agreement(card, cpu) -> dict:
    """Card vs CPU render of the same frames: the share of equal seg pixels
    (worst frame), and where seg agrees the share of pixels with rgb within
    RGB_ATOL and depth within DEPTH_RTOL (worst frame), with the largest
    errors there."""
    import torch

    (rgb_a, depth_a, seg_a), (rgb_b, depth_b, seg_b) = [[x.cpu() for x in r] for r in (card, cpu)]
    same = seg_a == seg_b
    rgb_err = (rgb_a - rgb_b).abs().amax(dim=-1)
    depth_err = (depth_a - depth_b).abs() / depth_b.abs()
    ok = same & (rgb_err <= RGB_ATOL) & (depth_err <= DEPTH_RTOL)
    return {
        "seg_equal": same.float().mean(dim=(1, 2)).min().item(),
        "pixels_within": (ok.sum(dim=(1, 2)) / same.sum(dim=(1, 2))).min().item(),
        "rgb_max_err": rgb_err[same].max().item(),
        "depth_max_rel_err": depth_err[same].max().item(),
        "rgb_median_err": torch.median(rgb_err[same]).item(),
    }


def _check_labels_on_mask(cfg, sim, kp, seg):
    """The cube's projected corners against its silhouette: the cube
    rendered alone on the card (no occluder) has the bounding box of its 8
    projected corners (a convex solid's silhouette is their hull) within
    1.5 px on every side where the corners lie inside the image, its mask
    holds the scene's cube mask (occlusion only removes pixels), and the
    scene's mask lies inside the corners' box. Returns the frames checked."""
    import numpy as np
    import torch

    from perseus_tpu_torch.datagen import generate

    alone = dict(sim["inputs"])
    alone["active"] = np.zeros_like(alone["active"])
    alone["active"][0] = 1.0
    _, _, seg_alone = generate.render_simulated(cfg, {**sim, "inputs": alone}, "cuda")
    res = cfg.resolution
    full_frames = 0
    for i in range(seg.shape[0]):
        lo, hi = kp[i].min(dim=0).values.tolist(), kp[i].max(dim=0).values.tolist()
        for mask, label in ((seg_alone[i] == 1, "alone"), (seg[i] == 1, "scene")):
            if not mask.any():
                continue
            ys, xs = torch.nonzero(mask, as_tuple=True)
            box = (xs.min().item(), ys.min().item(), xs.max().item(), ys.max().item())
            if box[0] < lo[0] - 1.5 or box[1] < lo[1] - 1.5 or box[2] > hi[0] + 1.5 or box[3] > hi[1] + 1.5:
                raise AssertionError(f"frame {i}: the cube's {label} mask {box} leaves its corners' box {lo + hi}")
        if ((seg[i] == 1) & (seg_alone[i] != 1)).any():
            raise AssertionError(f"frame {i}: scene cube pixels outside the cube rendered alone")
        if min(lo) >= 0 and max(hi) <= res - 1 and (seg_alone[i] == 1).any():
            ys, xs = torch.nonzero(seg_alone[i] == 1, as_tuple=True)
            box = (xs.min().item(), ys.min().item(), xs.max().item(), ys.max().item())
            if max(abs(box[0] - lo[0]), abs(box[1] - lo[1]), abs(box[2] - hi[0]), abs(box[3] - hi[1])) > 1.5:
                raise AssertionError(f"frame {i}: corners' box {lo + hi} and the cube's silhouette {box} differ")
            full_frames += 1
    return full_frames


def phase_datagen_eval():
    """Phase 7: the synthetic-data path and its evaluation at full width.
    7a render_video's two halves at the default VideoConfig for two job ids
    (simulation on the host clock, textures + render on CUDA events, peak
    memory), against the CPU render of the first job's first frames and
    its metadata; 7b label_trajectory on the card against the CPU, the
    corners against the cube's mask; 7c the pose scorer over the rendered
    frames with the perfect detector (the labels) and with the ResNet-18
    from random weights in bf16 (#1 counted); 7d validate_stats at the
    default ValConfig over a decoded split of VAL_ROWS rows from a
    checkpoint written by the port (#1 counted), and the card against the
    CPU in f32 on a small split. Returns #1's launches in 7c and 7d."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from perseus_tpu_torch import ROOT
    from perseus_tpu_torch.data.dataset import KeypointDatasetConfig
    from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split
    from perseus_tpu_torch.datagen import generate
    from perseus_tpu_torch.datagen.labeling import label_trajectory
    from perseus_tpu_torch.eval import pose_eval, validate
    from perseus_tpu_torch.models import resnet
    from perseus_tpu_torch.train import checkpoint as ckpt
    from perseus_tpu_torch.train import train
    from perseus_tpu_torch.train.config import TrainConfig
    from perseus_tpu_torch.utils.graphed import WARMUP_CALLS

    # 7a: render
    cfg = generate.VideoConfig()
    generate.render_simulated(cfg, generate.simulate_video(cfg, "warmup"), "cuda")  # allocator, first launches
    videos = []
    for job in VIDEO_JOBS:
        t0 = time.perf_counter()
        sim = generate.simulate_video(cfg, job)
        sim_s = time.perf_counter() - t0
        rgb, depth, seg, ms, peak = _render_timed(cfg, sim)
        n_obj = int(sim["inputs"]["active"].sum())
        _check_render(rgb, depth, seg, n_obj, f"render {job}")
        videos.append((job, sim, rgb, depth, seg))
        log(f"7a render {job} at {cfg.resolution}^2, {cfg.frames} frames, {n_obj} objects of {cfg.max_objects} "
            f"({sim['scene']['style']['sky_family']} sky, {sim['scene']['style']['ground_family']} ground): "
            f"simulation {sim_s * 1e3:.3f} ms (host clock), textures + render {ms:.3f} ms (CUDA events), "
            f"{cfg.frames / ms * 1e3:.1f} frames/s, peak memory {peak / 2**30:.3f} GiB above the "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB held")
    job, sim, rgb, depth, seg = videos[0]
    sim_cpu = generate.simulate_video(cfg, job)
    if json.dumps(sim_cpu["metadata"]) != json.dumps(sim["metadata"]):
        raise AssertionError("7a: the metadata of a second simulation differs")
    t0 = time.perf_counter()
    cpu = generate.render_simulated(cfg, _first_frames(sim_cpu, CPU_RENDER_FRAMES), "cpu")
    cpu_s = time.perf_counter() - t0
    n = CPU_RENDER_FRAMES
    agree = _render_agreement((rgb[:n], depth[:n], seg[:n]), cpu)
    log(f"7a card vs CPU render of {job}'s first {n} frames (CPU {cpu_s:.3f} s): {agree}; metadata identical")
    if agree["seg_equal"] < SHARE or agree["pixels_within"] < SHARE:
        raise AssertionError(f"7a: card and CPU renders disagree: {agree}")

    # 7b: label
    labels = []
    for job, sim, rgb, depth, seg in videos:
        meta = sim["metadata"]
        cube = meta["instances"][0]
        obj7 = np.concatenate([np.asarray(cube["positions"]), np.asarray(cube["quaternions"])], axis=-1)
        cam7 = np.concatenate([np.asarray(meta["camera"]["positions"]), np.asarray(meta["camera"]["quaternions"])], axis=-1)
        args = (obj7, cam7, cube["abs_scale"], meta["camera"]["field_of_view"], cfg.resolution, cfg.resolution)
        kp = label_trajectory(*args, device="cuda")
        err = (kp.cpu() - label_trajectory(*args, device="cpu")).abs().max().item()
        if kp.shape != (cfg.frames, 8, 2) or not torch.isfinite(kp).all() or err > 1e-3:
            raise AssertionError(f"7b {job}: labels {tuple(kp.shape)}, card vs CPU max abs {err} px")
        full = _check_labels_on_mask(cfg, sim, kp, seg)
        log(f"7b labels {job}: card vs CPU max abs {err:.3e} px; corners on the cube's silhouette, "
            f"{full} of {cfg.frames} frames with all 8 corners in the image")
        labels.append(kp)

    # 7c: pose eval, perfect detector on both videos, then the ResNet-18
    for (job, sim, rgb, depth, seg), kp in zip(videos, labels):
        t0 = time.perf_counter()
        res = pose_eval.score_pose_tracking(torch.cat([rgb, depth[..., None]], dim=-1), sim["metadata"],
                                            detector_fn=lambda f, kp=kp: kp, window=POSE_WINDOW, device="cuda")
        wall = time.perf_counter() - t0
        log(f"7c pose, perfect detector, {job}: RMSE {res['pose_rmse_mm']:.4f} mm / {res['pose_rmse_deg']:.4f} deg, "
            f"median {res['pose_median_mm']:.4f} mm / {res['pose_median_deg']:.4f} deg over {res['n_scored']} "
            f"scored frames (window {POSE_WINDOW}); {wall / cfg.frames * 1e3:.1f} ms/frame (host clock)")
        if not (res["pose_rmse_mm"] < POSE_BOUND_MM and res["pose_rmse_deg"] < POSE_BOUND_DEG):
            raise AssertionError(f"7c {job}: perfect-detector pose RMSE over {POSE_BOUND_MM} mm / {POSE_BOUND_DEG} deg")
    job, sim, rgb, depth, seg = videos[0]
    frames = torch.cat([rgb, depth[..., None]], dim=-1)
    sd = resnet.KeypointCNN(n_keypoints=8, num_channels=4, device="cuda",
                            generator=torch.Generator().manual_seed(0)).state_dict()
    _reset_counts()
    t0 = time.perf_counter()
    res = pose_eval.score_pose_tracking(frames, sim["metadata"], state_dict=sd, window=POSE_WINDOW, amp=True,
                                        device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts()
    pose_launches = counts["max_pool_3x3_s2"]
    # one detection per frame, the cold start's detection of frame 0, and
    # the eager warm-up before the step's capture
    expect = {k: (cfg.frames + 1 + WARMUP_CALLS if k == "max_pool_3x3_s2" else 0) for k in counts}
    finite = all(np.isfinite(res[k]).all() for k in ("pose_rmse_mm", "pose_rmse_deg", "per_frame_rot_deg",
                                                      "per_frame_trans_mm"))
    log(f"7c pose, ResNet-18 random weights bf16, {job}: RMSE {res['pose_rmse_mm']:.4f} mm / "
        f"{res['pose_rmse_deg']:.4f} deg (random weights: finite is the check); {wall / cfg.frames * 1e3:.1f} "
        f"ms/frame (host clock); launches {counts}")
    if not finite or counts != expect:
        raise AssertionError(f"7c: finite {finite}, launches {counts}, expected {expect}")

    # 7d: validate
    os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_validate_", dir=os.path.join(ROOT, "outputs"))
    try:
        tcfg = TrainConfig()
        state = train.init_state(tcfg, train.make_optimizer(tcfg), device="cuda")
        ckpt_dir = os.path.join(tmp, "model")
        ckpt.save_train_state(ckpt_dir, {"params": state.params, "batch_stats": state.batch_stats})
        t0 = time.perf_counter()
        split = generate_synthetic_decoded_split(os.path.join(tmp, "split"), 8, VAL_ROWS, 256, 256, 8, seed=3)
        split_s = time.perf_counter() - t0
        vcfg = validate.ValConfig(model_path=ckpt_dir, dataset_config=KeypointDatasetConfig(dataset_path=split),
                                  max_plots=0)
        batches = -(-VAL_ROWS // vcfg.batch_size)
        validate.validate_stats(vcfg, "cuda")  # warm-up: cuDNN plans at batch 1,024
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = validate.validate_stats(vcfg, "cuda")
        wall = time.perf_counter() - t0
        counts = _counts()
        val_launches = counts["max_pool_3x3_s2"]
        expect = {k: (batches if k == "max_pool_3x3_s2" else 0) for k in counts}
        log(f"7d validate at the default ValConfig (batch {vcfg.batch_size}, bf16, depth) over {VAL_ROWS} rows "
            f"(decoded split written in {split_s:.3f} s): {wall:.3f} s, {VAL_ROWS / wall:.1f} img/s (host clock); "
            f"loss mean {out['stats']['mean']:.6f}, RMSE {out['rmse_px']:.4f} px; launches {counts}")
        if counts != expect or out["losses"].shape != (VAL_ROWS,) or not np.isfinite(out["losses"]).all():
            raise AssertionError(f"7d: launches {counts}, expected {expect}; losses {out['losses'].shape}")
        small = generate_synthetic_decoded_split(os.path.join(tmp, "small"), 4, 16, 256, 256, 8, seed=4)
        scfg = dataclasses.replace(vcfg, amp=False, batch_size=8,
                                   dataset_config=KeypointDatasetConfig(dataset_path=small))
        on_card, on_cpu = validate.validate_stats(scfg, "cuda"), validate.validate_stats(scfg, "cpu")
        loss_err = float(np.max(np.abs(on_card["losses"] - on_cpu["losses"]) / np.abs(on_cpu["losses"])))
        rmse_err = abs(on_card["rmse_px"] - on_cpu["rmse_px"]) / on_cpu["rmse_px"]
        log(f"7d small f32 validate (16 rows, batch 8), card vs CPU: losses max rel {loss_err:.3e}, "
            f"RMSE rel {rmse_err:.3e}")
        if loss_err > 1e-3 or rmse_err > 1e-3:
            raise AssertionError(f"7d: card and CPU validate disagree: losses {loss_err}, RMSE {rmse_err}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return pose_launches, val_launches


PARITY_ROWS, PARITY_VAL_ROWS, PARITY_EPOCHS = 512, 128, 2  # the parity split; epochs cut from 15
REAL_FRAMES = ((48, 376, 672), (8, 1080, 1920))  # (count, H, W): ZED VGA (grows), 1080p (shrinks)
CPU_REAL_FRAMES = 2  # frames of each size run again on the CPU in f32
GRID_ROWS = 16  # the augmentation grid's batch (VisualizeConfig.num_images)
STREAM_FRAMES = 8
GRID_ATOL = 1e-5  # the augmentation tests' tolerance
GRID_COORD_ATOL = 1e-4  # px: a few f32 ulps of coordinates up to 256


def _parity_step_times(cfg):
    """The port's train step and the oracle's alone at the parity config
    (batch of 4-channel 256x256 frames, f32, TF32 off), CUDA events over 10
    steps after 3 warm-up steps each, from the oracle's seeded init."""
    import torch

    from perseus_tpu_torch.eval import parity
    from perseus_tpu_torch.models import convert, resnet
    from perseus_tpu_torch.train.train import ClipAdamW

    gen = torch.Generator().manual_seed(5)
    x = torch.rand((cfg.batch_size, cfg.in_channels, 256, 256), generator=gen).to("cuda")
    y = (torch.rand((cfg.batch_size, 2 * cfg.n_keypoints), generator=gen) * 2 - 1).to("cuda")
    oracle = parity._oracle(cfg).to("cuda")
    sd = {k: v.to("cuda") for k, v in convert.normalize_reference_sd(oracle.state_dict()).items()}
    is_stat = lambda k: k.endswith(("running_mean", "running_var"))  # noqa: E731
    params = {k: v for k, v in sd.items() if not is_stat(k)}
    stats = {k: v for k, v in sd.items() if is_stat(k)}
    opt = ClipAdamW(cfg.grad_clip_norm, cfg.learning_rate, cfg.weight_decay)
    opt_state = opt.init(params)
    oracle_opt = torch.optim.AdamW(oracle.parameters(), lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
    port = lambda: parity.port_train_step(opt, params, stats, opt_state, x, y)  # noqa: E731
    ref = lambda: parity.oracle_train_step(oracle, oracle_opt, x, y, cfg.grad_clip_norm)  # noqa: E731
    with resnet._full_f32():
        port_ms, oracle_ms = time_ms(port, iters=10, warmup=3), time_ms(ref, iters=10, warmup=3)
        kernels = {name: _kernel_ms(fn) for name, fn in (("port", port), ("oracle", ref))}
    return port_ms, oracle_ms, kernels


def _kernel_ms(fn, calls: int = 3) -> tuple[float, float] | None:
    """(device kernel ms, kernel launches) per call of ``fn``, from
    torch.profiler (kernels only); None where the profiler fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:  # noqa: BLE001  (a diagnostic: reported, not fatal)
        log(f"kernel time: not measured (profiler: {exc!r})")
        return None
    return (sum(e.self_device_time_total for e in kernels) / calls / 1e3, sum(e.count for e in kernels) / calls)


def parity_sensitivity(seeds=(0, 1, 2, 3), epochs=(2,), augmented=True) -> list:
    """How far two runs of run_parity that differ only in cuDNN's choice of
    convolution algorithms (the default heuristics, then
    ``cudnn.benchmark``) part: each model's val RMSE in both, per seed and
    epoch count, on phase 8's split. Not part of main(): a diagnostic of
    how well the parity bounds are conditioned at this size."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import torch

    from perseus_tpu_torch import ROOT
    from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split
    from perseus_tpu_torch.eval import parity

    os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_parity_", dir=os.path.join(ROOT, "outputs"))
    rows = []
    try:
        split = generate_synthetic_decoded_split(os.path.join(tmp, "split"), PARITY_ROWS, PARITY_VAL_ROWS, 256, 256, 8,
                                                 seed=6)
        for n_epochs in epochs:
            for seed in seeds:
                cfg = parity.ParityConfig(dataset_path=split, epochs=n_epochs, augmented=augmented, seed=seed)
                runs = []
                for bench in (False, True):
                    old = torch.backends.cudnn.benchmark
                    torch.backends.cudnn.benchmark = bench
                    try:
                        runs.append(parity.run_parity(dataclasses.replace(cfg), "cuda"))
                    finally:
                        torch.backends.cudnn.benchmark = old
                a, b = runs
                row = {"epochs": n_epochs, "seed": seed, "augmented": augmented,
                       "oracle_rmse": (a["torch_val_rmse_px"], b["torch_val_rmse_px"]),
                       "port_rmse": (a["port_val_rmse_px"], b["port_val_rmse_px"]),
                       "ratio": (a["rmse_ratio"], b["rmse_ratio"]),
                       "oracle_self_ratio": a["torch_val_rmse_px"] / b["torch_val_rmse_px"],
                       "port_self_ratio": a["port_val_rmse_px"] / b["port_val_rmse_px"]}
                rows.append(row)
                log(f"parity sensitivity: {row}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def phase_eval_tools():
    """Phase 8: the eval and runtime tools at full width. 8a run_parity at
    the default ParityConfig (4 channels, batch 32, lr 1e-3, wd 1e-2, clip
    1.0) over a decoded split of PARITY_ROWS + PARITY_VAL_ROWS rows at
    256x256, PARITY_EPOCHS epochs, unaugmented and augmented, #1, #2 and #3
    counted over each call, the JAX test's bounds; the port's train step
    and the oracle's, each timed alone. 8b predict_real at the default
    ValConfig (bf16) over REAL_FRAMES frames, #1 once per image, img/s;
    the same frames with the plain maxpool, and on the CPU in f32. 8c the
    augmentation grid's computation (augment_batch) on GRID_ROWS 5-channel
    rows, #6 once; the CPU on the same draws. 8d stream_frames over
    STREAM_FRAMES SyntheticSource frames in phase 5's serving config, #1
    once per frame, against frame-by-frame calls. Returns the launches of
    every counted run, summed."""
    import collections
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from perseus_tpu_torch import ROOT
    from perseus_tpu_torch.augment import pipeline as aug_pipeline
    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split, make_batch
    from perseus_tpu_torch.eval import parity, validate_real, visualize
    from perseus_tpu_torch.models import pool, resnet
    from perseus_tpu_torch.runtime.sources import SyntheticSource
    from perseus_tpu_torch.runtime.streaming import StreamingPipeline, stream_frames

    total = collections.Counter()
    zero = {fn.__name__: 0 for fn in _counted()}

    # 8a: parity
    os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_parity_", dir=os.path.join(ROOT, "outputs"))
    try:
        t0 = time.perf_counter()
        split = generate_synthetic_decoded_split(os.path.join(tmp, "split"), PARITY_ROWS, PARITY_VAL_ROWS, 256, 256, 8,
                                                 seed=6)
        log(f"8a parity: decoded split of {PARITY_ROWS} + {PARITY_VAL_ROWS} rows at 256^2 written in "
            f"{time.perf_counter() - t0:.3f} s")
        cfg = parity.ParityConfig(dataset_path=split, epochs=PARITY_EPOCHS)
        steps = PARITY_EPOCHS * (PARITY_ROWS // cfg.batch_size)
        for augmented in (False, True):
            run_cfg = dataclasses.replace(cfg, augmented=augmented)
            # cuDNN's deterministic algorithms: the two free-running
            # trajectories part at the first AdamW step, and with the
            # default algorithms a rerun parts too (on an H100 80GB HBM3 at
            # 700 W the unaugmented val RMSE ratio spread 0.876-1.095 over
            # four runs), so a run is reproducible only with them
            old_det = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                _reset_counts()
                t0 = time.perf_counter()
                result = parity.run_parity(run_cfg, "cuda")
                wall = time.perf_counter() - t0
                counts = _counts()
            finally:
                torch.backends.cudnn.deterministic = old_det
            total.update(counts)
            # #1: each port step, the val forward, the round trip's forward
            expect = dict(zero, max_pool_3x3_s2=steps + 2, max_pool_3x3_s2_backward=steps,
                          warp_affine_two_pass=steps if augmented else 0)
            t_loss, p_loss = result["final_losses"]
            log(f"8a parity augmented={augmented}: {steps} steps of both models in {wall:.3f} s; val RMSE port "
                f"{result['port_val_rmse_px']:.4f} px, oracle {result['torch_val_rmse_px']:.4f} px, ratio "
                f"{result['rmse_ratio']:.6f}; final losses oracle {t_loss:.6f}, port {p_loss:.6f} "
                f"(gap {abs(t_loss - p_loss) / t_loss:.4f}); round-trip logits max abs "
                f"{result['roundtrip_logits_max_abs_diff']:.3e}; launches {counts}")
            # the JAX test's bounds (tests/test_parity_training.py); the val
            # RMSE ratio of the augmented run is logged, not held: at this
            # size the oracle against itself, with only cuDNN's choice of
            # algorithms changed, parts by 0.26-1.68x in val RMSE after 2 or
            # 15 augmented epochs (parity_sensitivity on an H100 80GB HBM3
            # at 700 W), while the unaugmented runs agree within 0.95-1.07
            ratio_ok = augmented or 0.8 < result["rmse_ratio"] < 1.25
            if not (ratio_ok and abs(t_loss - p_loss) < 0.2 * max(t_loss, 1e-6)
                    and result["roundtrip_logits_max_abs_diff"] < 1e-5 and counts == expect):
                raise AssertionError(f"8a parity augmented={augmented}: {result}; launches {counts}, expected {expect}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    port_ms, oracle_ms, kernels = _parity_step_times(cfg)
    log(f"8a parity train step at batch {cfg.batch_size}, f32, TF32 off (CUDA events, 10 steps): port "
        f"{port_ms:.4f} ms, oracle (stock PyTorch ResNet-18, AdamW) {oracle_ms:.4f} ms, port / oracle "
        f"{port_ms / oracle_ms:.4f}; kernels per step (torch.profiler, ms, launches): {kernels}")

    # 8b: predict_real
    vcfg = validate_real.ValConfig()
    folded = resnet.fold_batchnorm(resnet.KeypointCNN(n_keypoints=8, num_channels=3, device="cuda",
                                                      generator=torch.Generator().manual_seed(0)).state_dict())
    rng = np.random.default_rng(7)
    frames = [rng.random((h, w, 3), dtype=np.float32) for n, h, w in REAL_FRAMES for _ in range(n)]
    n_real = len(frames)
    warm = [frames[0], frames[-1]]
    validate_real.predict_real(folded, warm, vcfg, "cuda")  # cuDNN plans, the resize kernels
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    crops, kps = validate_real.predict_real(folded, frames, vcfg, "cuda")
    kps_host = kps.cpu()
    wall = time.perf_counter() - t0
    counts = _counts()
    total.update(counts)
    if counts != dict(zero, max_pool_3x3_s2=n_real) or kps.shape != (n_real, 8, 2) or \
            crops.shape != (n_real, 256, 256, 3) or not (torch.isfinite(kps).all() and torch.isfinite(crops).all()):
        raise AssertionError(f"8b predict_real: launches {counts}, keypoints {tuple(kps.shape)}, crops "
                             f"{tuple(crops.shape)}")
    log(f"8b predict_real at the default ValConfig (bf16): {n_real} frames ({', '.join(f'{n} at {h}x{w}' for n, h, w in REAL_FRAMES)}) "
        f"in {wall:.3f} s, {n_real / wall:.1f} img/s (host clock, keypoints read back); launches {counts}")
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, a = validate_real.predict_real(folded, frames, vcfg, "cuda")
        with mock.patch.object(pool, "max_pool_3x3_s2", pool.max_pool_3x3_s2_reference):
            _, b = validate_real.predict_real(folded, frames, vcfg, "cuda")
    finally:
        torch.backends.cudnn.deterministic = old_det
    if not torch.equal(a, b):
        raise AssertionError(f"8b: kernel and plain maxpool keypoints differ by {(a - b).abs().max().item()}")
    f32 = dataclasses.replace(vcfg, amp=False)
    some = frames[:CPU_REAL_FRAMES] + frames[-CPU_REAL_FRAMES:]
    card_crops, card_kps = validate_real.predict_real(folded, some, f32, "cuda")
    cpu_crops, cpu_kps = validate_real.predict_real({k: v.cpu() for k, v in folded.items()}, some, f32, "cpu")
    crop_err = (card_crops.cpu() - cpu_crops).abs().max().item()
    kp_err = (card_kps.cpu() - cpu_kps).abs().max().item()
    log(f"8b predict_real with the plain maxpool: identical keypoints on {n_real} frames; f32 card vs CPU on "
        f"{len(some)} frames (growing and shrinking): crops max abs {crop_err:.3e}, keypoints {kp_err:.3e} px")
    # crops within 1e-4: the card's antialiased bilinear kernel sums its taps
    # in another order than the CPU's (1.9e-5 apart on an H100)
    if kp_err > 1e-3 or crop_err > 1e-4:
        raise AssertionError(f"8b: card and CPU disagree: crops {crop_err}, keypoints {kp_err} px")
    del crops, frames

    # 8c: the augmentation grid's computation
    vis = visualize.VisualizeConfig()
    batch = make_batch(GRID_ROWS, 256, 256, 8, seed=8)
    aug = KeypointAugmentation(vis.augmentation_config, train=vis.train)
    draws = aug.sample(torch.Generator(device="cuda").manual_seed(vis.seed), GRID_ROWS, 256, 256, 5)
    _reset_counts()
    images, coords = visualize.augment_batch(batch, vis, "cuda", draws=draws)
    torch.cuda.synchronize()
    counts = _counts()
    total.update(counts)
    cpu_images, cpu_coords = visualize.augment_batch(batch, vis, "cpu", draws=aug_pipeline._to(draws, "cpu"))
    img_err = (images.cpu() - cpu_images).abs().amax(dim=(0, 1, 2)).tolist()
    crd_err = (coords.cpu() - cpu_coords).abs().max().item()
    # the same draws with the affine off: the chain and the transplant alone
    # (each device builds the affine matrices from the draws, ulps apart,
    # which moves every sample of a warped image by ~1e-5-1e-4 px at this
    # size: on noise images that is up to ~1e-4 in RGB and ~1e-3 in depth;
    # the kernel against its plain version on the same matrices is phase 3's)
    flat = {**draws, "affine": {**draws["affine"], "applied": torch.zeros_like(draws["affine"]["applied"])}}
    card_flat, _ = visualize.augment_batch(batch, vis, "cuda", draws=flat)
    cpu_flat, _ = visualize.augment_batch(batch, vis, "cpu", draws=aug_pipeline._to(flat, "cpu"))
    flat_err = (card_flat.cpu() - cpu_flat).abs().max().item()
    log(f"8c augmentation grid ({GRID_ROWS}, 5, 256, 256) train mode: launches {counts}; card vs CPU on the same "
        f"draws: keypoints max abs {crd_err:.3e} px, images per channel {[f'{e:.3e}' for e in img_err]}; with the "
        f"affine off: images {flat_err:.3e}")
    if counts != dict(zero, fused_ultra_apply=1) or not torch.isfinite(images).all() or \
            crd_err > GRID_COORD_ATOL or flat_err > GRID_ATOL:
        raise AssertionError(f"8c: launches {counts}, keypoints {crd_err} px, images with the affine off {flat_err}")

    # 8d: the live loop without a display
    sd = resnet.KeypointCNN(n_keypoints=8, num_channels=4, device="cuda",
                            generator=torch.Generator().manual_seed(0)).state_dict()
    pipeline = StreamingPipeline(_serving_config(), sd, device="cuda")
    source = SyntheticSource(height=376, width=672, depth=True, seed=9)
    live = [source.get_frame() for _ in range(STREAM_FRAMES)]

    class Replay:
        def __init__(self):
            self.left = list(live)

        def get_frame(self):
            return self.left.pop(0)

        def close(self):
            pass

    _run(pipeline, live[:2])  # warm-up
    got = []
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        n = stream_frames(pipeline, Replay(), STREAM_FRAMES, lambda kp, image, pose: got.append((kp, pose)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        total.update(counts)
        kps, rots, transs, finite = _run(pipeline, live)
    finally:
        torch.backends.cudnn.deterministic = old_det
    same_kp = all(np.array_equal(k, w) for (k, _), w in zip(got, kps.cpu().numpy()))
    same_pose = all(torch.equal(p.rot, r) and torch.equal(p.trans, t) for (_, p), r, t in zip(got, rots, transs))
    log(f"8d stream_frames, serving config (GN-4 window 24), {n} frames: {wall / n * 1e3:.3f} ms/frame (host "
        f"clock, keypoints and image read back each frame); launches {counts}; equal to frame-by-frame calls: "
        f"keypoints {same_kp}, poses {same_pose}")
    if n != STREAM_FRAMES or counts != dict(zero, max_pool_3x3_s2=STREAM_FRAMES) or not (finite and same_kp and same_pose):
        raise AssertionError(f"8d: {n} frames, launches {counts}, finite {finite}, equal {same_kp} {same_pose}")
    log(f"phase 8 launches, summed over its counted runs: {dict(total)}")
    return total


DP_WORLD = 2  # phase 9's ranks, sharing cuda:0 through gloo
DP_STEPS = 3  # 9a's steps
DP_TIMEOUT = 480  # s: a rank group still running then fails the phase
DP_TRAIN_EXPECT = {"max_pool_3x3_s2": 5, "max_pool_3x3_s2_backward": 4, "fused_apply": 0, "fused_warp_apply": 0,
                   "fused_ultra_apply": 4, "warp_affine_two_pass": 0}  # per rank and epoch: 4 steps, 1 val batch


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(task: str, world: int, work: str) -> list:
    """Runs ``world`` processes of this script as ranks of ``task``
    (``--dp-rank``), all on cuda:0, and returns their results (``work``/
    ``<task><r>.json``). A rank that exits non-zero, or a group still
    running after DP_TIMEOUT s, has every rank killed and fails the phase
    with the tails of their logs."""
    port, procs, logs = _free_port(), [], []
    try:
        for r in range(world):
            logs.append(open(os.path.join(work, f"{task}{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank", task, str(r), str(world), str(port), work],
                stdout=logs[-1], stderr=subprocess.STDOUT,
            ))
        deadline = time.monotonic() + DP_TIMEOUT
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        tails = []
        for r in range(world):
            with open(os.path.join(work, f"{task}{r}.log")) as f:
                tails.append(f"--- rank {r} (exit {procs[r].returncode}):\n" + "".join(f.readlines()[-25:]))
        raise RuntimeError(f"phase 9 {task}: a rank failed or timed out\n" + "\n".join(tails))
    out = []
    for r in range(world):
        with open(os.path.join(work, f"{task}{r}.json")) as f:
            out.append(json.load(f))
    return out


def _digest(tensors: dict) -> str:
    """sha256 over the tensors' bytes in key order: equal digests, equal bits."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().view(-1).numpy().tobytes())
    return h.hexdigest()


def _row_hashes(x) -> list:
    """A short sha256 of each row (first axis) of a tensor's bytes."""
    import hashlib

    host = x.detach().cpu().contiguous().numpy()
    return [hashlib.sha256(row.tobytes()).hexdigest()[:16] for row in host]


def _dp_step_setup(work: str):
    """9a's config, batch and state: TrainConfig at batch 8, 4-channel 32x32
    random pixels (no pool ties) in f32; the seeded initial params with
    AdamW moments drawn from a numpy seed (count 10), so that no
    rounding-level gradient flips an update's sign as AdamW's first step
    from zero moments would."""

    import numpy as np
    import torch

    from perseus_tpu_torch.train import train
    from perseus_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig(batch_size=8, in_channels=4, amp=False)
    path = os.path.join(work, "step.pt")
    if not os.path.exists(path):
        rng = np.random.default_rng(9)
        images = rng.uniform(0, 1, (8, 4, 32, 32)).astype(np.float32)
        images[:, 3] = rng.uniform(3.0, 14.0, (8, 32, 32))
        coords = rng.uniform(2, 29, (8, 8, 2)).astype(np.float32)
        state = train.init_state(cfg, train.make_optimizer(cfg), "cpu")
        mom = lambda f: {k: torch.from_numpy(f(v.shape).astype(np.float32)) for k, v in state.params.items()}  # noqa: E731
        opt = dataclasses.replace(state.opt_state, step=10, exp_avg=mom(lambda sh: rng.normal(0, 1e-3, sh)),
                                  exp_avg_sq=mom(lambda sh: rng.uniform(1e-6, 1e-4, sh)))
        torch.save({"state": state._replace(opt_state=opt), "images": torch.from_numpy(images),
                    "coords": torch.from_numpy(coords)}, path)
    return cfg, torch.load(path, weights_only=False)


def _to_cuda(state):
    from perseus_tpu_torch.train import train

    move = lambda d: {k: v.to("cuda:0") for k, v in d.items()}  # noqa: E731
    o = state.opt_state
    return train.TrainState(move(state.params), move(state.batch_stats),
                            dataclasses.replace(o, exp_avg=move(o.exp_avg), exp_avg_sq=move(o.exp_avg_sq)))


def _dp_steps(cfg, blob, rows):
    """DP_STEPS train steps of 9a on ``rows`` of its batch, the augmentation
    in eval mode (f32: the step's convs run with TF32 off): (losses, final
    state, launches)."""
    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.train import train

    step = train.make_train_step(cfg, train.make_optimizer(cfg), KeypointAugmentation(cfg.augmentation_config, train=False))
    state = _to_cuda(blob["state"])
    images, coords = blob["images"][rows].to("cuda:0"), blob["coords"][rows].to("cuda:0")
    _reset_counts()
    losses = []
    for _ in range(DP_STEPS):
        state, loss = step(state, images, coords)
        losses.append(loss.item())
    return losses, state, _counts()


def _dp_rank_step(rank, world, port, work):
    """9a on one rank: this rank's half of the batch."""

    import torch

    from perseus_tpu_torch.train import train

    cfg, blob = _dp_step_setup(work)
    train.maybe_initialize_distributed(
        dataclasses.replace(cfg, coordinator_address=f"localhost:{port}", num_processes=world, process_id=rank),
        "cuda:0", backend="gloo",
    )
    b = cfg.batch_size // world
    losses, state, counts = _dp_steps(cfg, blob, slice(rank * b, (rank + 1) * b))
    tensors = {**state.params, **state.batch_stats}
    if rank == 0:
        torch.save({k: v.cpu() for k, v in tensors.items()}, os.path.join(work, "step_state.pt"))
    return {"losses": losses, "digest": _digest(tensors), "counts": counts}


def dp_step_check(work: str) -> dict:
    """9a: DP_STEPS steps at a small f32 config with TF32 off, two gloo ranks
    on cuda:0 against one rank (this process, no process group) on the same
    global batch from the same state, the augmentation in eval mode (the
    JAX package's test_sharded_matches_single_device). Losses to rel 1e-5,
    params and batch stats to atol 1e-5, the replicas bit for bit; #1 and
    #2 once per step on every rank. Returns the ranks' launches, summed."""

    import torch

    cfg, blob = _dp_step_setup(work)
    ranks = _run_ranks("step", DP_WORLD, work)
    losses, state, counts = _dp_steps(cfg, blob, slice(None))
    got = torch.load(os.path.join(work, "step_state.pt"))
    want = {**state.params, **state.batch_stats}
    err = max((got[k] - v.cpu()).abs().max().item() for k, v in want.items())
    rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], losses))
    replicas = len({r["digest"] for r in ranks}) == 1
    expect = dict({k: 0 for k in counts}, max_pool_3x3_s2=DP_STEPS, max_pool_3x3_s2_backward=DP_STEPS)
    log(f"9a data-parallel step, {DP_WORLD} gloo ranks on cuda:0 vs one rank, batch {cfg.batch_size} of 4x32x32 f32, "
        f"TF32 off, {DP_STEPS} steps: losses {ranks[0]['losses']} vs {losses} (max rel {rel:.3e}); params and batch "
        f"stats max abs {err:.3e}; replicas bit for bit {replicas}; launches per rank {[r['counts'] for r in ranks]}")
    if rel > 1e-5 or err > 1e-5 or not replicas or any(r["counts"] != expect for r in ranks) or counts != expect:
        raise AssertionError(f"9a: loss rel {rel}, state {err}, replicas {replicas}, launches "
                             f"{[r['counts'] for r in ranks]} and {counts}, expected {expect}")
    return {k: sum(r["counts"][k] for r in ranks) for k in counts}


def _dp_train_cfg(split: str):
    """9b and 9c: the default TrainConfig over the decoded split, one epoch."""
    from perseus_tpu_torch.data.dataset import KeypointDatasetConfig
    from perseus_tpu_torch.train.config import TrainConfig

    return TrainConfig(dataset_config=KeypointDatasetConfig(dataset_path=split), n_epochs=1)


def _record_train(train):
    """Wraps ``train.make_train_step`` and ``torch.distributed.all_reduce`` for
    one train() call: the first step's batch (a copy on the card), the host
    clock inside the step calls and between them, and the all-reduces'
    count and bytes. Returns (record, undo)."""
    import torch.distributed as dist

    rec = {"in": 0.0, "out": 0.0, "steps": 0, "reduces": 0, "bytes": 0}
    real_make, real_reduce = train.make_train_step, dist.all_reduce
    last = [None]

    def make(*a, **kw):
        step = real_make(*a, **kw)

        def timed(state, images_aug, coords, *rest, **kw2):
            t0 = time.perf_counter()
            if last[0] is not None:
                rec["out"] += t0 - last[0]
            if "images" not in rec:
                rec["images"], rec["coords"] = images_aug.clone(), coords.clone()
            out = step(state, images_aug, coords, *rest, **kw2)
            last[0] = time.perf_counter()
            rec["in"] += last[0] - t0
            rec["steps"] += 1
            return out
        return timed

    def reduce(tensor, *a, **kw):
        rec["reduces"] += 1
        rec["bytes"] += tensor.numel() * tensor.element_size()
        return real_reduce(tensor, *a, **kw)

    train.make_train_step, dist.all_reduce = make, reduce

    def undo():
        train.make_train_step, dist.all_reduce = real_make, real_reduce

    return rec, undo


def _dp_warmup(cfg, dev):
    """One train step at the full width on random rows (cuDNN's algorithm
    choice, the first launches, the collectives), outside every count."""
    import torch

    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.train import train

    opt = train.make_optimizer(cfg)
    b, world = cfg.batch_size, train._rank_world()[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand((b // world, 5, cfg.input_resolution, cfg.input_resolution), generator=gen, device=dev)
    coords = torch.rand((b // world, cfg.n_keypoints, 2), generator=gen, device=dev) * cfg.input_resolution
    step = train.make_train_step(cfg, opt, KeypointAugmentation(cfg.augmentation_config))
    _, loss = step(train.init_state(cfg, opt, dev), images, coords, gen)
    loss.item()


def _dp_rank_train(rank, world, port, work):
    """9b on one rank: train() on the host loader, then on the
    device-resident split, one epoch each, launches counted inside each
    call; then the gloo all-reduce alone, at the gradient bucket's size and
    at a batch norm layer's."""

    import torch
    import torch.distributed as dist

    from perseus_tpu_torch.train import train

    with open(os.path.join(work, "spec.json")) as f:
        split = json.load(f)["split"]
    cfg = dataclasses.replace(_dp_train_cfg(split), coordinator_address=f"localhost:{port}", num_processes=world,
                              process_id=rank)
    dev = train.maybe_initialize_distributed(cfg, "cuda:0", backend="gloo")
    _dp_warmup(cfg, dev)
    out = {}
    for mode in ("loader", "dd"):
        rec, undo = _record_train(train)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        try:
            res = train.train(dataclasses.replace(cfg, data_on_device=mode == "dd"), "cuda:0")
        finally:
            undo()
        wall = time.perf_counter() - t0
        st = res["state"]
        out[mode] = {
            "run_id": res["run_id"], "counts": _counts(), "wall_s": wall, "history": res["train_loss_history"],
            "val": res["final_val_loss"], "digest": _digest({**st.params, **st.batch_stats}),
            "first_rows": _row_hashes(rec["images"]), "first_coords": _row_hashes(rec["coords"]),
            "step_in_s": rec["in"], "step_out_s": rec["out"], "steps": rec["steps"],
            "reduces": rec["reduces"], "reduce_bytes": rec["bytes"],
        }
        if rank == 0:
            out[mode]["losses"] = _logged(res["run_id"], "loss")
            out[mode]["img_s"] = _logged(res["run_id"], "train_images_per_sec")
            torch.save({k: v.cpu() for k, v in {**st.params, **st.batch_stats}.items()},
                       os.path.join(work, f"train_{mode}.pt"))
    # the collective alone: the gradient bucket (loss + every parameter) and a BN layer's sums
    n = 1 + sum(v.numel() for v in st.params.values())
    for name, size, reps in (("bucket", n, 5), ("bn", 2 * 512 + 1, 20)):
        x = torch.ones(size, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) / reps * 1e3
    out["bucket_floats"] = n
    return out


def _sharded_draws(aug, seed, step, world, b, h, w, c):
    """The draws ``world`` ranks make at ``step`` (rank r from
    step_generator(seed, step, r), on its ``b`` rows), as one global
    batch's: each rank's block in turn, its donors moved to its rows."""
    import torch

    from perseus_tpu_torch.train import train

    parts = [aug.sample(train.step_generator(seed, step, "cuda", r), b, h, w, c) for r in range(world)]
    for r, d in enumerate(parts):
        d["donor_idx"] = d["donor_idx"] + r * b

    def cat(xs):
        return {k: cat([x[k] for x in xs]) for k in xs[0]} if isinstance(xs[0], dict) else torch.cat(xs)

    return cat(parts)


def _dp_reference(cfg, mode: str, world: int):
    """The ``world``-rank epoch of 9b in this process, one rank: the same
    global batches (host loader: its global batches, W-independent;
    device-resident: the split whole, each step on the rows the ranks'
    shards give it, in their orders from (seed, epoch, rank)) and the same
    draws (each block from its rank's generator, donors within the block),
    one forward and backward over the global batch. Returns (per-step
    losses, val loss, state, (first batch's row hashes, its keypoints'))."""
    import numpy as np
    import torch

    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.data.dataset import PrefetchingLoader, PrunedKeypointDataset
    from perseus_tpu_torch.train import train

    ds = PrunedKeypointDataset(cfg.dataset_config, train=True)
    val = PrunedKeypointDataset(cfg.dataset_config, train=False)
    opt = train.make_optimizer(cfg)
    state = train.init_state(cfg, opt, "cuda")
    aug = KeypointAugmentation(cfg.augmentation_config)
    step = train.make_train_step(cfg, opt, aug)
    lbs, h, w, c = cfg.batch_size // world, ds.H, ds.W, 5
    if mode == "loader":
        def batches():
            for batch in PrefetchingLoader(ds, cfg.batch_size, shuffle=True, seed=cfg.random_seed).epoch(0):
                yield (torch.from_numpy(train._prepare_aug_batch(batch, cfg.in_channels, True)).cuda(),
                       torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32)).cuda())
    else:
        imgs, crds, _, _, n = train._device_dataset(ds, cfg, "cuda", True)
        n_local = -(-n // world)
        perms = [d * n_local + np.random.default_rng((cfg.random_seed, 0, d)).permutation(n_local)
                 for d in range(world)]

        def batches():
            for s in range(n_local // lbs):
                idx = torch.from_numpy(np.concatenate([p[s * lbs : (s + 1) * lbs] for p in perms])).cuda()
                yield imgs.index_select(0, idx), crds.index_select(0, idx)
    losses, first = [], None
    for s, (images, coords) in enumerate(batches()):
        if first is None:
            first = (_row_hashes(images), _row_hashes(coords))
        state, loss = step(state, images, coords, draws=_sharded_draws(aug, cfg.random_seed, s, world, lbs, h, w, c))
        losses.append(loss.item())
    return losses, _one_rank_val(cfg, state), state, first


def _one_rank_val(cfg, state) -> float:
    """The val loss of ``state`` on one rank: the val split in global
    batches through make_eval_step."""
    import numpy as np
    import torch

    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.data.dataset import PrefetchingLoader, PrunedKeypointDataset
    from perseus_tpu_torch.train import train

    val = PrunedKeypointDataset(cfg.dataset_config, train=False)
    eval_step = train.make_eval_step(cfg, KeypointAugmentation(cfg.augmentation_config, train=False))
    sums = []
    for batch in PrefetchingLoader(val, cfg.batch_size, shuffle=False, drop_last=False).epoch(0):
        images = torch.from_numpy(train._prepare_aug_batch(batch, cfg.in_channels, False)).cuda()
        coords = torch.from_numpy(np.asarray(batch["pixel_coordinates"], np.float32)).cuda()
        sums.append(eval_step(state, images, coords, torch.ones(len(images), device="cuda")))
    return sum(p[0].item() for p in sums) / sum(p[1].item() for p in sums)


def dp_train_check(work: str, split: str) -> dict:
    """9b: train() at the default TrainConfig (global batch 256, 128 a rank,
    5-channel 256x256, bf16 convs, the fused ultra augmentation) over the
    decoded split, two gloo ranks on cuda:0, one epoch on the host loader
    and one on the device-resident split. Each against the same epoch on
    one rank (_dp_reference): the first global batch bit for bit, the
    epoch's train loss and the params at tests/test_distributed.py's
    tolerances (rel 2e-2, atol 5e-2); the ranks' val loss against one rank's
    eval of the same final state, rel 1e-3 (bf16 convs at batch 128 and
    256); params and batch stats equal on the ranks bit for bit; #6, #2
    once per step and #1 once per step and val batch on every rank. The
    val loss of the one-rank run's own final state is logged, not held:
    after 4 updates from their init the eval-mode BN running stats carry
    the trajectories' rounding-level parting (bf16 convs at batch 128 and
    256, then AdamW's sign flips; ROADMAP.md Queue C). Logs img/s (global
    and per rank), each rank's host share of a step, and the all-reduces
    per step with the gloo all-reduce's time alone. Returns the ranks'
    launches, summed, and the runs' ids."""
    import numpy as np
    import torch

    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"split": split}, f)
    ranks = _run_ranks("train", DP_WORLD, work)
    cfg = _dp_train_cfg(split)
    total = {k: 0 for k in DP_TRAIN_EXPECT}
    bucket_ms, bn_ms = ranks[0]["bucket_ms"], ranks[0]["bn_ms"]
    for mode in ("loader", "dd"):
        a = [r[mode] for r in ranks]
        losses, val, state, first = _dp_reference(cfg, mode, DP_WORLD)
        got = torch.load(os.path.join(work, f"train_{mode}.pt"))
        same_state = state._replace(params={k: got[k].cuda() for k in state.params},
                                    batch_stats={k: got[k].cuda() for k in state.batch_stats})
        val_same = _one_rank_val(cfg, same_state)
        val_same_rel = abs(a[0]["val"] - val_same) / abs(val_same)
        param_err = max((got[k] - v.cpu()).abs().max().item() for k, v in state.params.items())
        stats_err = max((got[k] - v.cpu()).abs().max().item() for k, v in state.batch_stats.items())
        rows_equal = sum((r["first_rows"] for r in a), []) == first[0]
        coords_equal = sum((r["first_coords"] for r in a), []) == first[1]
        replicas = len({r["digest"] for r in a}) == 1 and len({tuple(r["history"]) for r in a}) == 1
        epoch_rel = abs(a[0]["history"][0] - np.mean(losses)) / abs(np.mean(losses))
        val_rel = abs(a[0]["val"] - val) / abs(val)
        steps = a[0]["steps"]
        host_share = [r["step_out_s"] / (r["step_in_s"] + r["step_out_s"]) for r in a]
        per_step = [r["reduces"] / steps for r in a]
        mb = a[0]["reduce_bytes"] / steps / 1e6
        img_s = a[0]["img_s"][0]
        log(f"9b train() {mode}, {DP_WORLD} gloo ranks on cuda:0, default TrainConfig (global batch {cfg.batch_size}, "
            f"{cfg.batch_size // DP_WORLD} a rank), 1 epoch of {steps} steps: first global batch equal to one rank's, "
            f"rows {rows_equal}, keypoints {coords_equal}; replicas bit for bit {replicas}; per-step losses "
            f"{a[0]['losses']} vs one rank's {losses} (first step rel {abs(a[0]['losses'][0] - losses[0]) / losses[0]:.3e}, "
            f"epoch rel {epoch_rel:.3e}); params max abs {param_err:.3e}, batch stats {stats_err:.3e}; val "
            f"{a[0]['val']:.6f}, one rank's eval of the same state {val_same:.6f} (rel {val_same_rel:.3e}), the one-rank "
            f"run's own {val:.6f} (rel {val_rel:.3e}); launches per rank {[r['counts'] for r in a]}")
        log(f"9b {mode} on {card_line()}: {img_s:.1f} img/s global, {img_s / DP_WORLD:.1f} per rank (rank 0's "
            f"metrics.jsonl; train() wall {[round(r['wall_s'], 3) for r in a]} s); host share of a step (host clock "
            f"between step calls / inside and between) {[round(x, 4) for x in host_share]}; all-reduces per step "
            f"{per_step} ({mb:.3f} MB a rank), gloo all-reduce alone {bucket_ms:.3f} ms for the {ranks[0]['bucket_floats']}"
            f"-float gradient bucket, {bn_ms:.3f} ms for a BN layer's 1,025 floats")
        ok = (rows_equal and coords_equal and replicas and epoch_rel <= 2e-2 and val_same_rel <= 1e-3
              and param_err <= 5e-2 and all(r["counts"] == DP_TRAIN_EXPECT for r in a))
        if not ok:
            raise AssertionError(f"9b {mode}: rows {rows_equal} {coords_equal}, replicas {replicas}, epoch rel "
                                 f"{epoch_rel}, val rel {val_same_rel} (same state), params {param_err}, launches "
                                 f"{[r['counts'] for r in a]}, expected {DP_TRAIN_EXPECT}")
        for r in a:
            for k in total:
                total[k] += r["counts"][k]
    return total, [ranks[0][m]["run_id"] for m in ("loader", "dd")]


def _dp_rank_nccl(rank, world, port, work):
    """9c: one rank through maybe_initialize_distributed on bare "cuda"
    (NCCL); an all-reduce and a broadcast on the card; train() on the
    device-resident split, 2 epochs (the first warms up)."""

    import torch
    import torch.distributed as dist

    from perseus_tpu_torch.train import train

    with open(os.path.join(work, "spec.json")) as f:
        split = json.load(f)["split"]
    cfg = dataclasses.replace(_dp_train_cfg(split), coordinator_address=f"localhost:{port}", num_processes=world,
                              process_id=rank, data_on_device=True, n_epochs=2)
    dev = train.maybe_initialize_distributed(cfg, "cuda")
    x = torch.arange(4.0, device=dev)
    dist.all_reduce(x)
    dist.broadcast(x, src=0)
    _reset_counts()
    res = train.train(cfg, "cuda")
    counts = _counts()
    backend = dist.get_backend()
    dist.destroy_process_group()
    return {"backend": backend, "device": str(dev), "reduced": x.tolist(), "counts": counts, "run_id": res["run_id"],
            "img_s": _logged(res["run_id"], "train_images_per_sec"), "history": res["train_loss_history"]}


def phase_data_parallel():
    """Phase 9: data parallel. 9a the step (dp_step_check), 9b train()
    (dp_train_check) over a decoded split of LOOP_ROWS + LOOP_VAL_ROWS rows,
    9c NCCL at world size 1. Every rank a process of its own on cuda:0;
    the split, the runs' directories and the ranks' files are deleted at
    the end. Returns the launches of #1, #2 and #6 summed over the ranks."""
    import shutil
    import tempfile

    from perseus_tpu_torch import ROOT
    from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split
    from perseus_tpu_torch.train.config import TrainConfig

    base = TrainConfig()
    os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_dp_", dir=os.path.join(ROOT, "outputs"))
    run_ids = []
    try:
        total = dp_step_check(tmp)
        split = generate_synthetic_decoded_split(
            os.path.join(tmp, "split"), LOOP_ROWS, LOOP_VAL_ROWS, base.input_resolution, base.input_resolution,
            base.n_keypoints, seed=base.random_seed,
        )
        counts, ids = dp_train_check(tmp, split)
        run_ids += ids
        for k, v in counts.items():
            total[k] += v
        (nccl,) = _run_ranks("nccl", 1, tmp)
        run_ids.append(nccl["run_id"])
        expect = {k: 2 * v for k, v in DP_TRAIN_EXPECT.items()}
        log(f"9c NCCL at world size 1 through maybe_initialize_distributed(cfg, 'cuda'): backend {nccl['backend']} on "
            f"{nccl['device']}, all-reduce + broadcast of [0, 1, 2, 3] -> {nccl['reduced']}; train() on the "
            f"device-resident split, 2 epochs: img/s {[round(x, 1) for x in nccl['img_s']]} on {card_line()} (phase 6's "
            f"one-card figure beside it: its device-resident epoch call); losses {nccl['history']}; launches "
            f"{nccl['counts']}")
        if nccl["backend"] != "nccl" or nccl["reduced"] != [0.0, 1.0, 2.0, 3.0] or nccl["counts"] != expect:
            raise AssertionError(f"9c: {nccl}, launches expected {expect}")
        for k in total:
            total[k] += nccl["counts"][k]
        log(f"phase 9 launches, summed over the ranks of its counted runs: {total}")
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for run_id in run_ids:
            for kind in ("models", "runs"):
                shutil.rmtree(os.path.join(ROOT, "outputs", kind, run_id), ignore_errors=True)


DP_TASKS = {"step": _dp_rank_step, "train": _dp_rank_train, "nccl": _dp_rank_nccl}


def dp_rank_main(argv) -> int:
    """``chip_smoke.py --dp-rank <task> <rank> <world> <port> <work dir>``:
    one rank of a phase-9 task; writes its results to
    ``<work dir>/<task><rank>.json``."""
    task, rank, world, port, work = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    out = DP_TASKS[task](rank, world, port, work)
    with open(os.path.join(work, f"{task}{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


SCALE_TRAIN_ROWS = 256  # one batch of the default TrainConfig / PretrainConfig: the least train split
SCALE_FIRST_VIDEOS = 12  # rendered before the first count of the pruned train rows; then 2 more at a time
SCALE_HOLDOUT_VIDEOS, SCALE_POSE_JOBS = 2, 2
SCALE_POSE_FRAMES = 16  # pose jobs cut from 24 frames: the at-scale script's window 12 scores 4 of them
SCALE_EPOCHS, PRETRAIN_EPOCHS, PRETRAIN_TIMED = 2, 2, 5
SCALE_POSE_WINDOW = 8  # eval_pose_multi and diag_pose_job, cut from 12
BACKEND_WINDOW = 4  # pose_backend_check's window, cut from 12
# card vs CPU bounds of the f32 bisect: the detector's keypoints; the smoother on the SAME (GT) keypoints
BACKEND_KP_PX, BACKEND_DEG, BACKEND_UNITS = 1e-2, 0.05, 2e-3
# the full path, each device's smoother on its own detections: a model trained 2 epochs misses the corners
# by 500-1,100 px, an ill-conditioned LM (0.0226 deg / 9.5e-4 units apart in this PR's first card run)
BACKEND_FULL_DEG, BACKEND_FULL_UNITS = 1.0, 2e-2
# the JAX script's metrics.json keys (scripts/train_at_scale.py:284-388), with the EMA, holdout and pose parts
SCALE_KEYS = {
    "val_rmse_px", "val_median_corner_err_px", "val_p90_corner_err_px", "other_variant_rmse_px",
    "val_rmse_in_frame_px", "val_oof_frame_rate", "val_loss", "train_loss", "epochs", "n_train", "n_val",
    "train_wall_s", "image_hw", "failure_breakdown", "holdout_style_rmse_px", "holdout_style_median_corner_err_px",
    "holdout_style_n_frames", "pose_rmse_mm", "pose_rmse_deg", "pose_median_mm", "pose_median_deg",
}


def _train_split_rows(writer) -> int:
    """The rows a DecodedSplitWriter's train split would hold now."""
    trajs = sorted(writer.trajs, key=lambda tr: tr["job_id"])
    return sum(len(tr["keep"]) for tr in trajs[: int(writer.cfg.train_frac * len(trajs))])


def _timed(label: str, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    wall = time.perf_counter() - t0
    log(f"10 {label}: {wall:.3f} s (host clock)")
    return out, wall


def _expect_launches(label: str, counts: dict, expect: dict) -> None:
    full = {k: expect.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError(f"10 {label}: launches {counts}, expected {full}")


def phase_scripts_tools():
    """Phase 10: the scripts/ ports (perseus_tpu_torch/tools/) at full
    width, in a directory under outputs/ deleted after: render_videos (the
    default VideoConfig) until the pruned train split holds SCALE_TRAIN_ROWS
    rows, holdout-style videos and pose jobs; prepare_decoded into decoded
    splits; pretrain_backbone at the default PretrainConfig (#1, #2 per
    step) and its step timed on CUDA events; train_at_scale from the
    pretrained backbone with the EMA, holdout and pose evaluation (#6, #2,
    #1 counted; JAX's metrics keys, no error key); compute_difficulty_weights
    (#1) and one train() epoch sampling by them; eval_pose_multi over the
    pose jobs, eval_sensor_transfer on the holdout split, measure_oof,
    diag_pose_job and the pose_backend_check bisect, CPU against the card.
    Returns the launches of #1, #2 and #6 over the phase's counted calls."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from perseus_tpu_torch import ROOT
    from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
    from perseus_tpu_torch.datagen.generate import VideoConfig, render_video
    from perseus_tpu_torch.tools import compute_difficulty_weights as cdw
    from perseus_tpu_torch.tools import diag_pose_job, eval_pose_multi, eval_sensor_transfer, measure_oof
    from perseus_tpu_torch.tools import generate_dataset as gd
    from perseus_tpu_torch.tools import pose_backend_check as pbc
    from perseus_tpu_torch.tools import pretrain_backbone as pb
    from perseus_tpu_torch.tools import train_at_scale as tas
    from perseus_tpu_torch.train import checkpoint as ckpt
    from perseus_tpu_torch.train import train
    from perseus_tpu_torch.train.config import TrainConfig
    from perseus_tpu_torch.utils.graphed import WARMUP_CALLS

    total = {"max_pool_3x3_s2": 0, "max_pool_3x3_s2_backward": 0, "fused_ultra_apply": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_tools_", dir=os.path.join(ROOT, "outputs"))
    run_ids = []
    try:
        # 10.1 generate_dataset's compute half: the main videos until the split is big enough
        scfg = tas.ScaleRunConfig(
            job_dir=os.path.join(work, "jobs"), data_root=os.path.join(work, "data"),
            output_dir=os.path.join(work, "model"), epochs=SCALE_EPOCHS, ema_decay=0.5, skip_prepare=True,
            holdout_job_dir=os.path.join(work, "holdout_jobs"),
        )
        writer = tas.DecodedSplitWriter(scfg)
        t0 = time.perf_counter()
        gen = gd.GenConfig(job_dir=scfg.job_dir, n_videos=SCALE_FIRST_VIDEOS)
        failed = []
        while True:
            failed += gd.render_videos(gen, writer.add, "cuda")["failed"]
            if failed or _train_split_rows(writer) >= SCALE_TRAIN_ROWS:
                break
            gen = dataclasses.replace(gen, start_index=gen.start_index + gen.n_videos, n_videos=2)
        n_main = len(writer.trajs)
        ho_writer = tas.DecodedSplitWriter(tas.holdout_config(scfg))
        failed += gd.render_videos(gd.GenConfig(job_dir=scfg.holdout_job_dir, n_videos=SCALE_HOLDOUT_VIDEOS,
                                                style="holdout", seed=1), ho_writer.add, "cuda")["failed"]
        render_s = time.perf_counter() - t0
        pose_cfg = VideoConfig(frames=SCALE_POSE_FRAMES, seed=2)
        pose_jobs = []
        for i in range(SCALE_POSE_JOBS):
            rgb, depth, _, meta = render_video(pose_cfg, f"{i:08x}", "cuda")
            pose_jobs.append((f"{i:08x}", torch.cat([rgb, depth[..., None]], dim=-1), meta))
        if failed:
            raise AssertionError(f"10.1 videos failed: {failed}")
        log(f"10.1 render_videos at the default VideoConfig: {n_main} main + {SCALE_HOLDOUT_VIDEOS} holdout videos "
            f"in {render_s:.3f} s ({(n_main + SCALE_HOLDOUT_VIDEOS) / render_s:.2f} videos/s, simulation and "
            f"render, host clock); {SCALE_POSE_JOBS} pose jobs of {SCALE_POSE_FRAMES} frames")

        # 10.2 prepare_decoded: the main split and the holdout split
        (main_split, ho_split), prep_s = _timed("prepare_decoded, both splits",
                                                lambda: (writer.write(), ho_writer.write()))
        train_ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=main_split), train=True)
        val_ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=main_split), train=False)
        ho_ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=ho_split), train=False)
        log(f"10.2 decoded splits: train {len(train_ds)}, val {len(val_ds)}, holdout {len(ho_ds)} rows at "
            f"{train_ds.H}x{train_ds.W} in {prep_s:.3f} s")
        if len(train_ds) < SCALE_TRAIN_ROWS or not len(val_ds) or not len(ho_ds):
            raise AssertionError("10.2: a split is too small")

        # 10.3 pretrain_backbone at the default PretrainConfig
        pcfg = pb.PretrainConfig(dataset_path=main_split, output_dir=os.path.join(work, "pretrain"),
                                 epochs=PRETRAIN_EPOCHS)
        _reset_counts()
        pre, pre_s = _timed("pretrain_backbone", pb.pretrain, pcfg, "cuda")
        counts = _counts()
        steps = pre["steps_per_epoch"] * PRETRAIN_EPOCHS
        _expect_launches("pretrain", counts, {"max_pool_3x3_s2": steps, "max_pool_3x3_s2_backward": steps})
        add(counts)
        if not (math.isfinite(pre["loss"]) and math.isfinite(pre["rot_acc"])):
            raise AssertionError(f"10.3 pretrain loss {pre['loss']}, rot-acc {pre['rot_acc']}")
        pool = pb.load_rows(train_ds, pb.draw_rows(len(train_ds), pcfg.max_rows, pcfg.seed), pcfg.in_channels,
                            torch.bfloat16, torch.device("cuda"))
        opt = train.ClipAdamW(1.0, pcfg.learning_rate, pcfg.weight_decay)
        state = pb.init_pretrain_state(pcfg, opt, "cuda")
        step = pb.make_pretrain_step(opt)
        idx = torch.arange(pcfg.batch_size, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, _, _ = step(state, pool, idx, gen)  # warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(PRETRAIN_TIMED):
            state, loss, acc = step(state, pool, idx, gen)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms = ev[0].elapsed_time(ev[1]) / PRETRAIN_TIMED
        log(f"10.3 pretrain: {pre['n_rows']} rows, {steps} steps at batch {pcfg.batch_size}, loss {pre['loss']:.6f} "
            f"rot-acc {pre['rot_acc']:.4f}, epochs {[round(t, 3) for t in pre['epoch_s']]} s; the step alone "
            f"{step_ms:.4f} ms ({pcfg.batch_size / step_ms * 1e3:.1f} img/s, CUDA events over {PRETRAIN_TIMED} "
            f"steps); launches {counts}")
        del pool, state

        # 10.4 train_at_scale from the pretrained backbone, with the EMA, holdout and pose evaluation
        acfg = dataclasses.replace(scfg, init_backbone=os.path.join(pcfg.output_dir, "final"))
        _reset_counts()
        out, scale_s = _timed("train_at_scale", tas.train_at_scale, acfg, "cuda", pose_job=pose_jobs[0][1:])
        counts = _counts()
        run_ids.append(out["run_id"])
        m = out["metrics"]
        steps = len(train_ds) // acfg.batch_size * acfg.epochs
        val_batches = -(-len(val_ds) // acfg.batch_size)
        ho_batches = -(-len(ho_ds) // acfg.batch_size)
        # train(): a step each and its val batches each epoch; the final state's and the EMA's val
        # RMSE; the holdout's; the pose scorer's frames, cold start and capture warm-up
        _expect_launches("train_at_scale", counts, {
            "max_pool_3x3_s2": steps + acfg.epochs * val_batches + 2 * val_batches + ho_batches
            + SCALE_POSE_FRAMES + 1 + WARMUP_CALLS,
            "max_pool_3x3_s2_backward": steps, "fused_ultra_apply": steps})
        add(counts)
        errors = [k for k in m if k.endswith("_error")]
        with open(os.path.join(acfg.output_dir, "metrics.json")) as f:
            on_disk = json.load(f)
        if errors or set(m) != SCALE_KEYS or json.dumps(on_disk, sort_keys=True) != json.dumps(m, sort_keys=True):
            raise AssertionError(f"10.4 metrics: errors {[(k, m[k]) for k in errors]}, keys {sorted(m)}")
        if not all(math.isfinite(m[k]) for k in ("val_rmse_px", "val_loss", "train_loss", "holdout_style_rmse_px",
                                                 "pose_rmse_mm", "pose_rmse_deg")):
            raise AssertionError(f"10.4 metrics not finite: {m}")
        rates = _logged(out["run_id"], "train_images_per_sec")
        tcfg = tas.train_config(acfg, main_split, train_ds.H)
        dd_val = train._device_dataset(val_ds, tcfg, "cuda", use_transplant=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tas.val_rmse_px(out["state"], tcfg, dd_val)
        val_s = time.perf_counter() - t0
        del dd_val
        log(f"10.4 train_at_scale: {json.dumps(m)}")
        log(f"10.4 train_at_scale: {scale_s:.3f} s in all, train() {m['train_wall_s']} s, img/s per epoch "
            f"{[round(r, 1) for r in rates]}; val_rmse_px alone over {len(val_ds)} rows {val_s:.4f} s (host clock); "
            f"launches {counts}")

        # 10.5 compute_difficulty_weights on that checkpoint, then an epoch of train() sampling by them
        dcfg = cdw.DifficultyConfig(dataset_path=main_split, checkpoint=os.path.join(acfg.output_dir, "final"))
        _reset_counts()
        stats, diff_s = _timed("compute_difficulty_weights", cdw.compute_difficulty_weights, dcfg, "cuda")
        counts = _counts()
        _expect_launches("difficulty", counts, {"max_pool_3x3_s2": -(-len(train_ds) // dcfg.batch_size)})
        add(counts)
        weights = np.load(stats["output"])
        if weights.shape != (len(train_ds),) or not (weights >= 1).all() or not (weights <= dcfg.w_max).all():
            raise AssertionError(f"10.5 weights {weights.shape}, range {weights.min()}-{weights.max()}")
        wcfg = TrainConfig(n_epochs=1, dataset_config=KeypointDatasetConfig(dataset_path=main_split),
                           sample_weights_path=stats["output"], data_on_device=True, device_data_dtype="bfloat16",
                           wandb_project="")
        _reset_counts()
        res, w_s = _timed("train() sampling by the difficulty weights", train.train, wcfg, "cuda")
        counts = _counts()
        run_ids.append(res["run_id"])
        steps = len(train_ds) // wcfg.batch_size
        _expect_launches("weighted train", counts, {"max_pool_3x3_s2": steps + val_batches,
                                                     "max_pool_3x3_s2_backward": steps, "fused_ultra_apply": steps})
        add(counts)
        if not all(map(math.isfinite, res["train_loss_history"] + [res["final_val_loss"]])):
            raise AssertionError(f"10.5 weighted train: {res['train_loss_history']}")
        log(f"10.5 difficulty weights {stats}; weighted train() epoch loss {res['train_loss_history']}, "
            f"val {res['final_val_loss']:.6f}; launches {counts}")

        # 10.6 eval_pose_multi over the pose jobs, the trained model
        sd = ckpt.load_model(os.path.join(acfg.output_dir, "final"))
        _reset_counts()
        multi, multi_s = _timed("eval_pose_multi", eval_pose_multi.score_jobs, pose_jobs, sd,
                                window=SCALE_POSE_WINDOW, device="cuda")
        counts = _counts()
        _expect_launches("pose multi", counts,
                         {"max_pool_3x3_s2": SCALE_POSE_JOBS * (SCALE_POSE_FRAMES + 1 + WARMUP_CALLS)})
        add(counts)
        if multi["pose_multi_n_videos"] != SCALE_POSE_JOBS or not all(
                math.isfinite(v) for k, v in multi.items() if k.startswith("pose_multi_")):
            raise AssertionError(f"10.6 pose multi {multi}")
        log(f"10.6 eval_pose_multi (window {SCALE_POSE_WINDOW}): {json.dumps(multi)}; "
            f"{multi_s / (SCALE_POSE_JOBS * SCALE_POSE_FRAMES) * 1e3:.1f} ms/frame; launches {counts}")

        # 10.7 eval_sensor_transfer on the holdout split
        tcfg_s = eval_sensor_transfer.SensorTransferConfig(checkpoint=os.path.join(acfg.output_dir, "final"),
                                                           dataset_path=ho_split)
        _reset_counts()
        rec, sens_s = _timed("eval_sensor_transfer", eval_sensor_transfer.sensor_transfer, tcfg_s, "cuda")
        counts = _counts()
        _expect_launches("sensor transfer", counts, {"max_pool_3x3_s2": 2 * ho_batches})
        add(counts)
        if rec["n_frames"] != len(ho_ds) or not (math.isfinite(rec["clean_rmse_px"])
                                                 and math.isfinite(rec["sensor_rmse_px"])):
            raise AssertionError(f"10.7 sensor transfer {rec}")
        log(f"10.7 eval_sensor_transfer: {json.dumps(rec)}; launches {counts}")

        # 10.8 measure_oof on 2 videos (the simulation's labels, nothing rendered)
        oof, _ = _timed("measure_oof", measure_oof.measure_oof, measure_oof.OofConfig(n_videos=2), "cuda")
        if oof["frames"] != 2 * VideoConfig().frames or not 0 <= oof["oof_frame_rate"] <= 1:
            raise AssertionError(f"10.8 measure_oof {oof}")
        log(f"10.8 measure_oof: {json.dumps(oof)}")

        # 10.9 diag_pose_job on the first pose job
        _reset_counts()
        rows, _ = _timed("diag_pose_job", diag_pose_job.diag_rows, pose_jobs[0][1], pose_jobs[0][2], state_dict=sd,
                         window=SCALE_POSE_WINDOW, device="cuda")
        counts = _counts()
        _expect_launches("diag", counts, {"max_pool_3x3_s2": SCALE_POSE_FRAMES + 1 + WARMUP_CALLS})
        add(counts)
        if not all(np.isfinite(rows[k]).all() for k in diag_pose_job.COLUMNS):
            raise AssertionError("10.9 diag rows not finite")
        log("10.9 diag_pose_job:\n" + "\n".join(diag_pose_job.format_rows(rows)))

        # 10.10 pose_backend_check: the card and the CPU in f32, each smoother also fed the SAME fixed
        # keypoints (the GT projection)
        bcfg = pbc.CheckConfig(window=BACKEND_WINDOW, amp=False)
        frames, meta = pose_jobs[0][1], pose_jobs[0][2]
        gt_kp = diag_pose_job.gt_keypoints(meta).astype(np.float32)
        _reset_counts()
        on_card, card_s = _timed("pose_backend_check on the card", pbc.dump_arrays, bcfg, frames, meta, sd,
                                 fixed_keypoints=gt_kp, device="cuda")
        counts = _counts()
        _expect_launches("backend check", counts, {"max_pool_3x3_s2": SCALE_POSE_FRAMES + 1 + WARMUP_CALLS})
        add(counts)
        on_cpu, cpu_s = _timed("pose_backend_check on the CPU", pbc.dump_arrays, bcfg, frames.cpu(), meta,
                               {k: v.cpu() for k, v in sd.items()}, fixed_keypoints=gt_kp, device="cpu")
        a, b = ({**d, "metrics": json.dumps(d["metrics"]), "fixed_src": "the GT keypoints"} for d in (on_card, on_cpu))
        log("10.10 pose_backend_check, card (A) vs CPU (B), f32, window "
            f"{BACKEND_WINDOW}:\n" + "\n".join(pbc.compare_lines(a, b)))
        from perseus_tpu_torch.eval.pose_eval import rotation_angle

        def deltas(rot, trans):
            rel = np.einsum("tji,tjk->tik", a[rot], b[rot])
            return float(np.degrees(rotation_angle(rel)).max()), float(np.abs(a[trans] - b[trans]).max())

        kp_delta = float(np.abs(a["keypoints"] - b["keypoints"]).max())
        full_deg, full_units = deltas("rot", "trans")
        same_deg, same_units = deltas("rot_fixedkp", "trans_fixedkp")
        if (kp_delta > BACKEND_KP_PX or same_deg > BACKEND_DEG or same_units > BACKEND_UNITS
                or full_deg > BACKEND_FULL_DEG or full_units > BACKEND_FULL_UNITS):
            raise AssertionError(f"10.10 card vs CPU: keypoints {kp_delta} px (bound {BACKEND_KP_PX}), SAME "
                                 f"keypoints {same_deg} deg / {same_units} units (bounds {BACKEND_DEG} / "
                                 f"{BACKEND_UNITS}), full path {full_deg} deg / {full_units} units (bounds "
                                 f"{BACKEND_FULL_DEG} / {BACKEND_FULL_UNITS})")
        log(f"10.10 bisect held: keypoints {kp_delta:.3e} px <= {BACKEND_KP_PX}, SAME keypoints {same_deg:.3e} deg "
            f"<= {BACKEND_DEG}, {same_units:.3e} units <= {BACKEND_UNITS}, full path {full_deg:.3e} deg <= "
            f"{BACKEND_FULL_DEG}, {full_units:.3e} units <= {BACKEND_FULL_UNITS}; the card {card_s:.3f} s, the CPU "
            f"{cpu_s:.3f} s")
        log(f"10 launches over the phase's counted calls: {total}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        for run_id in run_ids:
            for kind in ("models", "runs"):
                shutil.rmtree(os.path.join(ROOT, "outputs", kind, run_id), ignore_errors=True)
    return total


# the JAX line's keys (bench.py:492-512), which the port's line must carry, in this order, and its measured fields
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "smoother_p50_ms", "smoother_default_p50_ms",
              "streaming_ms_per_frame", "train_images_per_sec")
BENCH_FIELDS = tuple(k for k in BENCH_KEYS if k not in ("metric", "unit", "vs_baseline"))
BENCH_GLOBAL_BUDGET_S = 600  # the bench's own bound: it kills its phases and prints its line by then
ENTRY_SHAPE = (8, 16)  # the flagship forward's output on entry()'s example


def _bench_phase_results(stderr: str) -> dict:
    """Each phase's result fields from the bench's stderr, where its harness
    logs them as ``[bench] phase NAME: ok in Xs -> {json}``."""
    out = {}
    for line in stderr.splitlines():
        head, sep, fields = line.partition(" -> ")
        if sep and head.startswith("[bench] phase ") and ": ok in " in head:
            name = head.removeprefix("[bench] phase ").split(":")[0]
            out[name] = {"wall_s": float(head.split(": ok in ")[1].rstrip("s")), **json.loads(fields)}
    return out


def phase_bench_entry():
    """Phase 11: the bench and the entry points. (11a) ``python -m
    perseus_tpu_torch.bench`` at its defaults: every measured field finite,
    ``vs_baseline`` null, the JAX line's keys, each phase's launches of #1,
    #2 and #6 as its chain lengths give them; (11b) #6 against its plain
    version on the bench's own bf16 train batch and draws; (11c)
    ``graft_entry.entry()`` on the card, a finite (8, 16), beside the CPU's
    output on the same weights (logged); (11d)
    ``graft_entry.dryrun_multichip(2)`` on the card. Returns the launches of
    each kernel over the bench's phases, the entry and the dry run."""
    import numpy as np
    import torch

    from perseus_tpu_torch import ROOT, bench, graft_entry
    from perseus_tpu_torch.augment import fused, ops
    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.train.config import TrainConfig
    from perseus_tpu_torch.utils.graphed import WARMUP_CALLS

    # 11a the bench, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "perseus_tpu_torch.bench"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PERSEUS_BENCH_GLOBAL_BUDGET_S=str(BENCH_GLOBAL_BUDGET_S)),
        timeout=BENCH_GLOBAL_BUDGET_S + 60,
    )
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"11a {line}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip().startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"11a the bench exited {proc.returncode} with no line")
    line = json.loads(lines[-1])
    log(f"11a bench line ({wall:.1f} s of command, {card_line()}): {json.dumps(line)}")
    bad = [k for k in BENCH_FIELDS if not isinstance(line.get(k), (int, float)) or not math.isfinite(line[k])]
    if bad or list(line)[: len(BENCH_KEYS)] != list(BENCH_KEYS) or line["vs_baseline"] is not None:
        raise AssertionError(f"11a bench line: null or non-finite {bad}, keys {list(line)[:len(BENCH_KEYS)]}, "
                             f"vs_baseline {line.get('vs_baseline')}")
    phases = _bench_phase_results(proc.stderr)
    log("11a phase walls: " + ", ".join(f"{k} {v['wall_s']:.1f} s" for k, v in phases.items()))
    det_n = (bench.DETECTOR_WARMUPS + bench.DETECTOR_REPS) * bench.DETECTOR_K
    # the streaming chains' frames, and the eager warm-up before the step's capture
    stm_n = bench.STREAMING_WARMUP_K + bench.STREAMING_REPS * bench.STREAMING_K + WARMUP_CALLS
    trn_n = (bench.TRAIN_WARMUPS + bench.TRAIN_REPS) * bench.TRAIN_K
    expect = {"detector": {"max_pool_3x3_s2": det_n}, "streaming": {"max_pool_3x3_s2": stm_n},
              "train": {"max_pool_3x3_s2": trn_n, "max_pool_3x3_s2_backward": trn_n, "fused_ultra_apply": trn_n}}
    total = dict.fromkeys(_counts(), 0)
    for name, want in expect.items():
        got = phases[name]["launches"]
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"11a bench phase {name}: launches {got}, expected {want}")
        for k, v in got.items():
            total[k] += v
    log(f"11a bench launches: {total}")

    # 11b #6 on the bench's bf16 train batch, with the draws of its first timed chain
    b, s = TrainConfig().batch_size, 256
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 1, (b, s, s, 5)).astype(np.float32)).to("cuda")
    images = images.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
    draws = KeypointAugmentation(TrainConfig().augmentation_config).sample(
        torch.Generator(device="cuda").manual_seed(0), b, s, s, 5)
    swap, parts = ops._two_pass_params(ops._invert_affine(ops.affine_matrices(draws["affine"], s, s)))
    args = (images, draws["donor_idx"], swap, torch.stack(parts, dim=-1), draws["fused"])
    out = fused.fused_ultra_apply(*args)
    torch.cuda.synchronize()
    ref = fused.fused_ultra_reference(*args)
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype != torch.bfloat16 or not torch.allclose(out.float(), ref.float(), **BF16_TOL):
        raise AssertionError(f"11b #6 on the bench's bf16 batch disagrees with its plain version: {err}")
    log(f"11b #6 on the bench's bf16 {tuple(images.shape)} batch: max abs err {err:.3e} (within {BF16_TOL})")
    del images, draws, args, out, ref
    torch.cuda.empty_cache()

    # 11c the flagship forward on the card, and on the CPU with the same weights
    forward, (example,) = graft_entry.entry()
    before = _counts()
    logits = forward(example)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _counts().items()}
    if tuple(logits.shape) != ENTRY_SHAPE or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"11c entry(): shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    if launched != {k: int(k == "max_pool_3x3_s2") for k in launched}:
        raise AssertionError(f"11c entry(): launches {launched}")
    forward_c, (example_c,) = graft_entry.entry(device="cpu")
    diff = (logits.cpu() - forward_c(example_c)).abs().max().item()
    log(f"11c entry(): {tuple(logits.shape)} finite on the card; bf16 card vs CPU max abs diff {diff:.3e} (logged)")
    total["max_pool_3x3_s2"] += 1

    # 11d the data-parallel dry run, two gloo ranks on the card
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(2)
    steps = 3  # the step, then 2 of the epoch
    want = {"max_pool_3x3_s2": 2 * steps, "max_pool_3x3_s2_backward": 2 * steps, "fused_ultra_apply": 2 * steps}
    if dry["launches"] != {k: want.get(k, 0) for k in dry["launches"]}:
        raise AssertionError(f"11d dryrun_multichip(2): launches {dry['launches']}, expected {want}")
    log(f"11d dryrun_multichip(2) on the card: loss {dry['loss']}, epoch losses {dry['losses']}, launches "
        f"{dry['launches']}, {time.perf_counter() - t0:.1f} s")
    for k, v in dry["launches"].items():
        total[k] += v
    log(f"11 launches over the phase's counted runs: {total}")
    return total


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
        run("train loop", phase_train_loop)
        pose_launches, val_launches = run("datagen and eval", phase_datagen_eval)
        tools = run("eval and runtime tools", phase_eval_tools)
        dp = run("data parallel", phase_data_parallel)
        scripts = run("scripts tools", phase_scripts_tools)
        benched = run("bench and entry points", phase_bench_entry)
    except Exception as exc:  # report which phase failed, with its traceback
        import traceback

        traceback.print_exc()
        print(f"[smoke] FAIL in phase {phase}: {exc}", file=sys.stderr)
        return 1
    log(f"maxpool forward launches: {train_counts['max_pool_3x3_s2']} in {TRAIN_STEPS} train steps, "
        f"{serving_launches} in {N_FRAMES} serving frames, {pose_launches} in the pose scorer "
        f"(a frame each and the cold start's), {val_launches} in validate's val batches, "
        f"{tools['max_pool_3x3_s2']} in phase 8, {dp['max_pool_3x3_s2']} on phase 9's ranks, "
        f"{scripts['max_pool_3x3_s2']} in phase 10, {benched['max_pool_3x3_s2']} in phase 11")
    pool_src, aug_src = "perseus_tpu_torch/csrc/maxpool.cu", "perseus_tpu_torch/csrc/augment.cu"
    # each kernel timed at the shape of the path that counts it: the ultra
    # kernel and the chain branch take 5 channels, the warp branch 4
    aug = lambda kind, c: augk[(kind, c, torch.float32)]  # noqa: E731
    kernels = [
        _entry("max_pool_3x3_s2", pool_src, "perseus_tpu/models/pool_pallas.py:55",
               train_counts["max_pool_3x3_s2"] + serving_launches + pose_launches + val_launches
               + tools["max_pool_3x3_s2"]
               + dp["max_pool_3x3_s2"] + scripts["max_pool_3x3_s2"] + benched["max_pool_3x3_s2"], fwd_err,
               (fwd[0], fwd[1], fwd[3], fwd[4]), fwd[2]),
        _entry("max_pool_3x3_s2_backward", pool_src, "perseus_tpu/models/pool_pallas.py:79",
               train_counts["max_pool_3x3_s2_backward"] + tools["max_pool_3x3_s2_backward"]
               + dp["max_pool_3x3_s2_backward"] + scripts["max_pool_3x3_s2_backward"]
               + benched["max_pool_3x3_s2_backward"], bwd_err,
               (bwd[0], bwd[1], bwd[3], bwd[4]), bwd[2]),
        _entry("fused_apply", aug_src, "perseus_tpu/augment/fused.py:333",
               branch_counts["fused_apply"], aug("chain", 5)[4], aug("chain", 5)[:4], None),
        _entry("fused_warp_apply", aug_src, "perseus_tpu/augment/fused.py:395",
               branch_counts["fused_warp_apply"], aug("warp", 4)[4], aug("warp", 4)[:4], None),
        _entry("fused_ultra_apply", aug_src, "perseus_tpu/augment/fused.py:413",
               train_counts["fused_ultra_apply"] + tools["fused_ultra_apply"] + dp["fused_ultra_apply"]
               + scripts["fused_ultra_apply"] + benched["fused_ultra_apply"],
               aug("ultra", 5)[4], aug("ultra", 5)[:4], None),
        # no single PyTorch call computes the two-pass warp (F.grid_sample,
        # logged beside it, is a direct 2-D bilinear warp)
        _entry("warp_affine_two_pass", aug_src, "perseus_tpu/augment/warp_pallas.py:70",
               unfused_counts["warp_affine_two_pass"] + tools["warp_affine_two_pass"], warpk[4], warpk[:4], None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(dp_rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--dp-rank"] else main())
