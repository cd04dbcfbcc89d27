"""Share of the traced serving window in which no device operation ran, %:
1 - (union of device operation intervals) / (the traced window's length),
both from the profiler's trace of ``traced_frames`` closed-loop frames run
after the measured window. It is the traced window's share: the profiler
adds its own host time to each graph launch, which shows here as idle
time (``PERF.md``), so it reads above the untraced frames' idle share."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
