"""The augmentation apply's share of its roofline, %: the least time its
bytes take at the card's memory peak (``counts.augment_apply_bytes``: the
stored batch and the draws read once, the model input written once), over
the time ``KeypointAugmentation.apply`` takes alone on the cell's first
batch (CUDA events over 10 calls)."""

import torch

from benchmark import counts, harness


def read(ctx):
    d, c = ctx["driver"], ctx["config"]
    rows = d.order_rows(0)
    images, coords = d.images.index_select(0, rows), d.coords.index_select(0, rows)
    b, ch, h, w = images.shape
    draws = d.aug.sample(d.step_generator(d.seed, 0, d.device), b, h, w, ch)
    with torch.no_grad():
        ms = harness.time_ms(lambda: d.aug.apply(images, coords, draws), d.device, 10)
    bound_s = counts.augment_apply_bytes(b, ch, c["in_channels"], h, w, images.element_size()) / counts.PEAK_HBM_BYTES_S
    return 100.0 * bound_s / (ms / 1e3)
