"""The whole served frame's share of the card's bf16 peak, %: the
detector's forward operations per frame (``counts.resnet18_forward_flops``
at batch 1 and the model input's shape) times the frames of the run's
measured window, over that window's wall time and ``counts.PEAK_BF16_FLOPS``."""

from benchmark import counts


def read(ctx):
    w, c = ctx["window"], ctx["config"]
    if w["units"] == 0:
        return None
    flops = counts.resnet18_forward_flops(1, c["num_channels"], c["model_h"], c["model_w"], 2 * c["n_keypoints"])
    return 100.0 * flops * w["units"] / w["window_s"] / counts.PEAK_BF16_FLOPS
