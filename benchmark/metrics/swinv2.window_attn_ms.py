"""SwinV2's window attention inside a served frame, ms: the median over the
span window's frames (``benchmark/span_window.py``) of the summed device
time of that frame's spans ``swinv2.window_attn`` (the 12 calls of kernel
#8, one a block, each between two event nodes of the replayed graph),
grouped by the frame's id, which a frame's spans share. A program without
that span gives None."""

import statistics

from benchmark import span_window


def read(ctx):
    w = span_window.read(ctx)
    if w is None:
        return None
    frames: dict = {}
    for r in w.named("swinv2.window_attn"):
        frames[r.id] = frames.get(r.id, 0.0) + r.device_ms
    return statistics.median(frames.values()) if frames else None
