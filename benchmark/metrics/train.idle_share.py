"""Share of the traced training window in which no device operation ran,
%: 1 - (union of device operation intervals) / (the traced window's
length), both from the profiler's trace of ``traced_steps`` consecutive
train steps run after the measured window: the traced window's share,
with the profiler's own host time in it."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
