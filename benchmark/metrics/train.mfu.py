"""The whole train step's share of the card's bf16 peak, %: 3 x the
forward's operations at the cell's batch and model input
(``counts.resnet18_train_flops``) times the steps of the run's measured
window, over that window's wall time (it ends in a synchronize) and
``counts.PEAK_BF16_FLOPS``."""

from benchmark import counts


def read(ctx):
    w, c = ctx["window"], ctx["config"]
    if w["units"] == 0:
        return None
    r = c["input_resolution"]
    flops = counts.resnet18_train_flops(c["batch_size"], c["in_channels"], r, r, 2 * c["n_keypoints"])
    return 100.0 * flops * w["units"] / w["window_s"] / counts.PEAK_BF16_FLOPS
