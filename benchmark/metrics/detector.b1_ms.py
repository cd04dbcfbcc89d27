"""The detector alone at batch 1, replayed as the served frame runs it, ms
a call: the configuration's detector plug-in's ``program_b1`` (for
ResNet-18 ``keypoint_cnn_apply_folded`` on the served pipeline's folded
weights, in the configuration's compute dtype) on one preprocessed frame,
captured by the program's ``Graphed`` (on its first call, outside the
timing) and replayed, CUDA events over 200 calls."""

import torch

from benchmark import harness, run


def read(ctx):
    from perseus_tpu_torch.utils.graphed import Graphed

    d = ctx["driver"]
    x = d.preprocess(torch.as_tensor(d.frames[0], device=d.device))
    # held by the graph, as the served step holds its weights
    detector = Graphed(run.detector(ctx["config"]).program_b1(d.pipeline, ctx["config"]), d.device)
    return harness.time_ms(lambda: detector(x), d.device, 200)
