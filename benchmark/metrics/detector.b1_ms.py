"""The folded detector alone at batch 1 in the configuration's compute
dtype, replayed as the served frame runs it, ms a call:
``keypoint_cnn_apply_folded`` on the served pipeline's folded weights and
one preprocessed frame, captured by the program's ``Graphed`` (on its
first call, outside the timing) and replayed, CUDA events over 200 calls."""

import torch

from benchmark import harness


def read(ctx):
    from perseus_tpu_torch.models import resnet
    from perseus_tpu_torch.utils.graphed import Graphed

    d = ctx["driver"]
    x = d.preprocess(torch.as_tensor(d.frames[0], device=d.device))
    dtype = getattr(torch, ctx["config"]["compute_dtype"])
    folded = d.pipeline.folded  # held by the graph, as the served step holds it
    detector = Graphed(lambda image: resnet.keypoint_cnn_apply_folded(folded, image, compute_dtype=dtype), d.device)
    return harness.time_ms(lambda: detector(x), d.device, 200)
