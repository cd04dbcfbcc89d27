"""The augmentation's sampling inside a train step, ms: the median over the
span window's steps (``benchmark/span_window.py``) of the device time of
the program's span ``augment.sample``."""

from benchmark import span_window


def read(ctx):
    w = span_window.read(ctx)
    return None if w is None else w.median_ms("augment.sample")
