"""The whole served frame's share of the card's bf16 peak, %: the
detector's forward operations on one frame (the configuration's detector
plug-in's ``forward_flops``) times the frames of the run's measured window,
over that window's wall time and ``counts.PEAK_BF16_FLOPS``."""

from benchmark import counts, run


def read(ctx):
    w = ctx["window"]
    if w["units"] == 0:
        return None
    flops = run.detector(ctx["config"]).forward_flops(ctx["config"])
    return 100.0 * flops * w["units"] / w["window_s"] / counts.PEAK_BF16_FLOPS
