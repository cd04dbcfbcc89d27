"""The smoother's solve inside a served frame, ms: the median over the span
window's frames (``benchmark/span_window.py``) of the device time of the
program's span ``smoother.solve`` (the ``lm_solve`` call inside
``FixedLagSmoother.update``, inside the replayed graph, between two of its
event nodes). A program without that span gives None."""

from benchmark import span_window


def read(ctx):
    w = span_window.read(ctx)
    return None if w is None else w.median_ms("smoother.solve")
