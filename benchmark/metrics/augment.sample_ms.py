"""The augmentation's sampling alone at the cell's batch, ms a call:
``KeypointAugmentation.sample`` from a step's generator (CUDA events over
10 calls)."""

from benchmark import harness


def read(ctx):
    d = ctx["driver"]
    c = d.images.shape[1]
    return harness.time_ms(
        lambda: d.aug.sample(d.step_generator(d.seed, 0, d.device), d.batch, d.res, d.res, c), d.device, 10
    )
