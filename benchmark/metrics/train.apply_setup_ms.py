"""The augmentation apply's set-up inside a train step, ms: the median over
the span window's steps (``benchmark/span_window.py``) of the device time
of the program's span ``augment.apply`` less that of its child
``augment.apply.kernel`` (the hand kernel's call): the affine matrices, the
two-pass parameters and the keypoints around the kernel."""

from benchmark import span_window


def read(ctx):
    w = span_window.read(ctx)
    return None if w is None else w.self_ms("augment.apply", "augment.apply.kernel")
