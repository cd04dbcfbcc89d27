"""Clip and AdamW inside a train step, ms: the median over the span
window's steps (``benchmark/span_window.py``) of the device time of the
program's span ``optimizer.update`` (``ClipAdamW.update`` on the step's own
gradients)."""

from benchmark import span_window


def read(ctx):
    w = span_window.read(ctx)
    return None if w is None else w.median_ms("optimizer.update")
