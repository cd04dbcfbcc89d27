"""The detector's forward and backward inside a train step, ms: the median
over the span window's steps (``benchmark/span_window.py``) of the device
time of the program's span ``model.forward_backward``
(``keypoint_cnn_apply`` in train mode through ``torch.autograd.grad``)."""

from benchmark import span_window


def read(ctx):
    w = span_window.read(ctx)
    return None if w is None else w.median_ms("model.forward_backward")
