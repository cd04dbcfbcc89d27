"""The span window: the cell's traced units run again with the port's
spans on (``perseus_tpu_torch/utils/spans.py``) and no profiler, for the
metrics read from the program's own spans.

The first reader of a ``--trace 1`` run that needs it calls :func:`read`,
which stores its result in the run's shared ``ctx`` for the others: spans
on; the traffic's ``traced()`` run once and its records dropped (with
spans on, a graphed step captures a graph of its own there); where the
traffic settles its graph in set-up (``camera.py``'s ``_settle``: a new GN-4 graph
replays about a sixth slower at first on the H100, ``PERF.md``), the
spans-on graph settled the same way; ``traced()`` again, as many times as
start within ``SECONDS`` (a burst of a few train steps after a synchronize
has not reached the steady state in which the host runs ahead of the
device), bracketed by synchronizes, its wall on the host clock; the
records drained and spans off. A program without spans gives None, and its
readers report nothing.
"""

from __future__ import annotations

import statistics
import time

from benchmark import harness

KEY = "span_window"
SECONDS = 2.0


class SpanWindow:
    """The span window's records, its units (frames or steps) and wall."""

    def __init__(self, records: list, units: int, wall_s: float):
        self.records, self.units, self.wall_s = records, units, wall_s

    def named(self, name: str, parent: str | None = None) -> list:
        return [r for r in self.records if r.name == name and (parent is None or r.parent == parent)]

    def median_ms(self, name: str, parent: str | None = None) -> float | None:
        """The median device time of the spans ``name`` (under ``parent``)."""
        ms = [r.device_ms for r in self.named(name, parent)]
        return statistics.median(ms) if ms else None

    def self_ms(self, name: str, child: str) -> float | None:
        """The median over units of a span's device time less its
        ``child`` spans' (one ``name`` span a unit)."""
        own = {r.id: r.device_ms for r in self.named(name)}
        for r in self.named(child, name):
            own[r.id] -= r.device_ms
        return statistics.median(own.values()) if own else None


def read(ctx) -> SpanWindow | None:
    if KEY in ctx:
        return ctx[KEY]
    try:
        from perseus_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        ctx[KEY] = None
        return None
    d, device = ctx["driver"], ctx["device"]
    spans.enable()
    try:
        d.traced()
        settle = getattr(d, "_settle", None)
        if settle is not None:
            harness.log(f"span window: settling the spans-on graph: {settle(d.carries[-1])}")
        harness.synchronize(device)
        spans.drain()
        t0 = time.perf_counter()
        units = 0
        while units == 0 or time.perf_counter() - t0 < SECONDS:
            units += d.traced()
        harness.synchronize(device)
        wall = time.perf_counter() - t0
        records = spans.drain()
    finally:
        spans.disable()
    ctx[KEY] = SpanWindow(records, units, wall)
    return ctx[KEY]
