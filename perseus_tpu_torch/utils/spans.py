"""Spans: named ranges of the port's own layers, with their device time.

``with span("smoother.update", device): ...`` marks one layer's work. With
spans on (:func:`enable`), each span leaves a :class:`SpanRecord`: its
name, the id of its frame or step (a span opened with no span open starts a
new id; the spans opened inside it take its id), its parent's name, its
host start and end on ``time.time_ns()`` (the clock of ``torch.profiler``'s
events) and, on a CUDA device, its device time from two timing events
recorded on the current stream. No span waits for its events: the device
times are read when the records are drained (:func:`drain`), or in batches
once their events have completed, which returns the events to a pool for
later spans. On the CPU the device time is the host duration; a span given
no device is a host range alone.

Spans are off by default. Then :func:`span` returns one shared no-op object
after one flag check, and makes no event, record or allocation. Whenever a
``torch.profiler`` is recording, each span also enters a profiler range of
its name, on or off, so a profiler trace (``train()``'s ``profile_dir``,
the benchmark's traced window) names host time by the program's layers.
The range is a host operation of the trace (``_RecordFunctionFast``), not
``record_function``'s user annotation, which the profiler also draws on the
device's timeline over the kernels launched inside it, where it would count
as device work.

Inside a CUDA graph capture (``utils/graphed.py``), the spans become event
record nodes of the graph (:func:`graph_capture`): each replay, opened as
``span(root, device, graph=...)``, yields the captured spans as children of
the replay's record, with that replay's device times (the replay's own from
nodes at the graph's start and end), and no host times. A replay's events
are recorded over by the next replay of the same graph, so their times are
read before it (:func:`span` does that).

Records stay in memory until :func:`drain` returns them. Spans are kept by
one thread: the one that runs the served frame or the train step.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _profiler

__all__ = ["SpanRecord", "GraphSpans", "span", "enable", "disable", "enabled", "drain", "paused", "graph_capture"]

READ_BATCH = 64  # stream spans left pending before a new root span reads the completed ones

_on = False
_records: list = []  # finished spans, until drain()
_pending: list = []  # records of stream spans whose device time is still on their events
_replayed: dict = {}  # the GraphSpans whose last replay's records are unread, by id
_pool: dict = {}  # free timing events, by device index
_streams: dict = {}  # the current streams met, by (device index, raw stream)
_open: list = []  # the open spans, innermost last
_last_id = 0
_capture = None  # the GraphSpans of the graph being captured


@dataclass(slots=True)
class SpanRecord:
    """One finished span. ``host_start_ns`` and ``host_end_ns`` are None for
    a span inside a CUDA graph (it ran on the device alone); ``device_ms``
    is None for a host range."""

    name: str
    id: int
    parent: str | None
    host_start_ns: int | None = None
    host_end_ns: int | None = None
    device_ms: float | None = None
    events: tuple | None = field(default=None, repr=False)  # (start, end[, device index]) until read


class GraphSpans:
    """The spans of one captured graph: its start and end event nodes, and
    (name, parent, start, end) for each span inside it."""

    def __init__(self, root: str):
        self.root = root
        self.start = self.end = None
        self.inner: list = []
        self.last: list = []  # the records of the graph's last replay, until read


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, device=None, graph: GraphSpans | None = None):
    """A context manager for the span ``name`` of work on ``device`` (None:
    a host range alone). ``graph`` is the replayed graph's
    :class:`GraphSpans`, for the span around a replay."""
    if not _on:
        return _range(name) if _profiler._is_profiler_enabled else _NO_SPAN
    return _Span(name, device, graph)


def drain() -> list:
    """The finished records, oldest first, with their device times read
    (waiting for an event only where it has not completed); forgets them."""
    global _records
    for g in _replayed.values():
        _read_graph(g)
    _replayed.clear()
    _read_pending(wait=True)
    out, _records = _records, []
    return out


@contextmanager
def paused():
    """Spans off inside the block (a graph's eager warm-up)."""
    global _on
    was, _on = _on, False
    try:
        yield
    finally:
        _on = was


@contextmanager
def graph_capture(root: str):
    """Inside a CUDA graph capture: yields the graph's :class:`GraphSpans`
    (None with spans off), whose spans record as event nodes of the graph,
    and whose start and end nodes bracket the block."""
    global _capture, _open
    if not _on:
        yield None
        return
    gs = GraphSpans(root)
    gs.start = _node_event()
    outer, _capture, _open = (_capture, _open), gs, []
    try:
        yield gs
        gs.end = _node_event()
    finally:
        _capture, _open = outer


def _range(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


def _node_event():
    """A timing event recorded as a node of the graph being captured."""
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


def _current_stream(dev: int):
    """Device ``dev``'s current stream, looked up by its raw handle (building
    the stream object, as ``torch.cuda.current_stream`` does each call,
    costs several microseconds on the H100's host)."""
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(dev)
    return stream


def _stream_event(dev: int, stream):
    """A timing event from device ``dev``'s pool, recorded on ``stream``."""
    free = _pool.get(dev)
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _read_pending(wait: bool) -> None:
    """Reads the pending stream spans in order, up to the first whose events
    have not completed (``wait``: waits for those), and returns their
    events to the pool."""
    done = 0
    for rec in _pending:
        start, end, dev = rec.events
        if not end.query():
            if not wait:
                break
            end.synchronize()
        rec.device_ms = start.elapsed_time(end)
        rec.events = None
        _pool.setdefault(dev, []).extend((start, end))
        done += 1
    del _pending[:done]


def _read_graph(g: GraphSpans) -> None:
    """Reads the records of the graph's last replay: its end node completes
    after every node inside it."""
    if g.last:
        if not g.end.query():
            g.end.synchronize()
        for rec in g.last:
            rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
            rec.events = None
        g.last = []


class _Span:
    __slots__ = ("name", "device", "cuda", "graph", "rec", "range", "start", "dev", "stream", "parent", "in_graph")

    def __init__(self, name: str, device, graph: GraphSpans | None):
        self.name, self.graph, self.range = name, graph, None
        self.device = None if device is None else torch.device(device)
        self.cuda = self.device is not None and self.device.type == "cuda"

    def __enter__(self):
        # the host clock is read outside the profiler's range, which then
        # lies inside the span
        t0 = time.time_ns()
        if _profiler._is_profiler_enabled:
            self.range = _range(self.name)
            self.range.__enter__()
        self.in_graph = _capture is not None
        if self.in_graph:  # a pair of event nodes of the graph being captured
            self.parent = _open[-1].name if _open else _capture.root
            self.start = _node_event()
        else:
            global _last_id
            outer = _open[-1] if _open else None
            if outer is None:
                _last_id += 1
                if len(_pending) >= READ_BATCH:
                    _read_pending(wait=False)
            if self.graph is not None and self.graph.last:  # this replay records over the last one's events
                _read_graph(self.graph)
            self.rec = SpanRecord(self.name, outer.rec.id if outer else _last_id, outer.name if outer else None, t0)
            if self.cuda and self.graph is None:
                index = self.device.index
                self.dev = torch.cuda.current_device() if index is None else index
                self.stream = _current_stream(self.dev)
                self.start = _stream_event(self.dev, self.stream)
        _open.append(self)
        return self

    def __exit__(self, *exc):
        _open.pop()
        if self.in_graph:
            _capture.inner.append((self.name, self.parent, self.start, _node_event()))
        rec, g = (None, None) if self.in_graph else (self.rec, self.graph)
        if g is not None:
            rec.events = (g.start, g.end)
            g.last = [SpanRecord(n, rec.id, p, events=(s, e)) for n, p, s, e in g.inner] + [rec]
            _replayed[id(g)] = g
            _records.extend(g.last)
        elif rec is not None:
            if self.cuda:
                rec.events = (self.start, _stream_event(self.dev, self.stream), self.dev)
                _pending.append(rec)
            _records.append(rec)
        if self.range is not None:
            self.range.__exit__(*exc)
        if rec is not None:
            rec.host_end_ns = time.time_ns()
            if self.device is not None and not self.cuda:
                rec.device_ms = (rec.host_end_ns - rec.host_start_ns) / 1e6
        return False
