"""The 95th percentile of the measured window's frame latencies, ms: the
end-to-end ``frame_ms_p95`` of the cells whose runs it spreads too widely
in to hold to that metric's bound (``PERF.md``), kept here, unbounded, so
that their tail stays on record."""


def read(ctx):
    w = ctx["window"]
    if w["units"] == 0:
        return None
    return w["frame_ms_p95"]
