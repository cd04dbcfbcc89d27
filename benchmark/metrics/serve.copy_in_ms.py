"""A served frame's copy in, ms: the median over the span window's frames
(``benchmark/span_window.py``) of the device time of the program's span
``graphed.copy_in`` (the host frame and the carry copied into the graph's
input buffers, CUDA events on the stream)."""

from benchmark import span_window


def read(ctx):
    w = span_window.read(ctx)
    return None if w is None else w.median_ms("graphed.copy_in", "serve.frame")
