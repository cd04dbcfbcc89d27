"""Device kernels a served frame launches: the kernels in the profiler's
trace of the traced window (copies and fills not counted) over its frames."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.kernels == 0 or t.units == 0:
        return None
    return t.kernels / t.units
