"""The smoother's update alone, ms a call: ``FixedLagSmoother.graphed_update``
(a CUDA graph of the update; it captures on its first call, inside the
warm-up) from the window's last carry on its last keypoints, CUDA events
over 50 calls."""

import torch

from benchmark import harness


def read(ctx):
    d = ctx["driver"]
    smoother = d.pipeline.smoother
    if smoother is None:
        return None
    carry = d.carries[-1]
    kp = torch.as_tensor(d.outputs[-1][0], device=d.device)
    return harness.time_ms(lambda: smoother.graphed_update(carry, kp), d.device, 50)
