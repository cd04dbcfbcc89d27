"""The detector inside a served frame, ms: the median over the span
window's frames (``benchmark/span_window.py``) of the device time of the
program's span ``serve.detector`` (``keypoint_cnn_apply_folded`` inside the
replayed graph, between two of its event nodes)."""

from benchmark import span_window


def read(ctx):
    w = span_window.read(ctx)
    return None if w is None else w.median_ms("serve.detector")
