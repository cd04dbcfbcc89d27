"""The parts of a run that do not depend on the cell: timing, the trace
window and its reduction, the device record, the import check and the
result line."""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

# top-level module names a run must not have loaded (the JAX package and
# JAX itself); compared as whole words, as ``perseus_tpu_torch`` begins with
# one of them
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "perseus_tpu")


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """The forbidden top-level modules this process has loaded."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device: torch.device, calls: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()`` over ``calls`` calls after
    ``warmup``: CUDA events on the card, the host clock elsewhere (only the
    CPU tests run there)."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3 / calls


@dataclass
class TraceSummary:
    """The reduction of one traced window: its length, the union of device
    operation intervals inside it, the kernels launched, the device
    operations that took most time and the longest idle gaps, each named
    by the innermost host operation running at its middle."""

    window_s: float
    busy_s: float
    kernels: int
    units: int  # frames or steps run inside the window
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


WINDOW_LABEL = "benchmark_window"
NAME_CHARS = 160  # of an operation's name in the breakdown (kernel names run to thousands)


class TracedWindow:
    """``with TracedWindow(device) as tw: ...`` profiles the block (host
    operations and, on the card, CUDA activity), then ``tw.summary(units)``
    reduces it. Device operations are clipped to the window's own range,
    so the busy share cannot pass 1."""

    def __init__(self, device: torch.device):
        self.device = device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._range = None

    def __enter__(self):
        synchronize(self.device)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW_LABEL)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        synchronize(self.device)
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def events(self):
        return self._prof.profiler.kineto_results.events()

    def summary(self, units: int, device_type=None) -> TraceSummary:
        """``device_type`` is the profiler's device type of the operations
        counted as device work (CUDA; the tests pass the CPU's)."""
        device_type = torch.autograd.DeviceType.CUDA if device_type is None else device_type
        events = self.events()
        win = next(e for e in events if e.name() == WINDOW_LABEL)
        w0, w1 = win.start_ns(), win.end_ns()
        dev, host = [], []
        for e in events:
            if e.name() == WINDOW_LABEL:
                continue
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if e.device_type() == device_type:
                if b > a:
                    dev.append((a, b, e.name()))
            elif e.device_type() == torch.autograd.DeviceType.CPU and b > a:
                host.append((a, b, e.name()))
        dev.sort()
        busy, gaps, cur0, cur1 = 0, [], None, None
        prev_end = w0
        for a, b, _ in dev:
            if cur1 is None or a > cur1:
                if cur1 is not None:
                    busy += cur1 - cur0
                if a > prev_end:
                    gaps.append((a - prev_end, prev_end, a))
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
            prev_end = max(prev_end, b)
        if cur1 is not None:
            busy += cur1 - cur0
        if w1 > prev_end:
            gaps.append((w1 - prev_end, prev_end, w1))
        kernels = sum(1 for _, _, n in dev if not n.startswith(("Memcpy", "Memset")))
        by_name: dict = {}
        for a, b, n in dev:
            by_name[n] = by_name.get(n, 0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = []
        for length, a, b in sorted(gaps, reverse=True)[:10]:
            mid = (a + b) // 2
            inner = [h for h in host if h[0] <= mid < h[1]]
            name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "no host operation"
            idle.append([name, length / 1e9])
        return TraceSummary(
            window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, kernels=kernels, units=units,
            device_ops=[[n[:NAME_CHARS], t / 1e9] for n, t in top], idle_gaps=[[n[:NAME_CHARS], t] for n, t in idle],
        )


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def device_record(device: torch.device, chips: int, memory_peak: int, trace: TraceSummary | None) -> dict:
    rec = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": chips,
        "memory_peak_bytes": int(memory_peak),
    }
    if trace is not None:
        rec["busy_s"], rec["window_s"] = trace.busy_s, trace.window_s
    return rec


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                trace: TraceSummary | None, checks: dict) -> str:
    """The run's last stdout line; ``checks`` (each compared number beside
    its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics, "device": device}
    if trace is not None:
        out["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    out["checks"] = checks
    return json.dumps(out)


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` (every reading finite and at most its limit) and the
    checks record. A number without a limit fails: a cell states each."""
    checks, ok = {}, True
    for name, value in readings.items():
        limit = limits.get(name)
        value = float(value)
        good = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if math.isfinite(value) else repr(value), "limit": limit}
    return ok and bool(readings), checks
