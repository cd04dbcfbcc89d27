"""The share of the serving loop in which the device held none of the
program's frame work, %: 100 x (1 - the summed device times of the spans
``graphed.copy_in``, ``graphed.replay`` and ``graphed.clone_out`` of the
span window's frames over the window's wall; ``benchmark/span_window.py``).
It holds the host's Python, the pageable staging, the caller's read-back
and the next grab. No profiler runs in the span window."""

from benchmark import span_window

PARTS = ("graphed.copy_in", "graphed.replay", "graphed.clone_out")


def read(ctx):
    w = span_window.read(ctx)
    if w is None or w.wall_s <= 0:
        return None
    records = [r for name in PARTS for r in w.named(name, "serve.frame")]
    if not records:
        return None
    return 100.0 * (1.0 - sum(r.device_ms for r in records) / (w.wall_s * 1e3))
