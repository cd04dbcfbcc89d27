"""The detector's train forward and backward alone at the cell's batch,
ms a call: ``keypoint_cnn_apply`` in train mode in the configuration's
compute dtype on the current state, SmoothL1 against the batch's
normalized keypoints, ``torch.autograd.grad`` of every parameter (CUDA
events over 5 calls), on the cell's first batch augmented once."""

import torch

from benchmark import harness


def read(ctx):
    from perseus_tpu_torch.models import resnet
    from perseus_tpu_torch.train import train as tm

    d, c = ctx["driver"], ctx["config"]
    rows = d.order_rows(0)
    draws = d.aug.sample(d.step_generator(d.seed, 0, d.device), d.batch, d.res, d.res, d.images.shape[1])
    with torch.no_grad():
        images, target = d.aug.apply(d.images.index_select(0, rows), d.coords.index_select(0, rows), draws)
    images, target = images[:, : c["in_channels"]], target.reshape(target.shape[0], -1)
    dtype = getattr(torch, c["compute_dtype"])
    state = d.state
    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}

    def fwd_bwd():
        with torch.enable_grad(), resnet._full_f32():
            pred, _ = resnet.keypoint_cnn_apply({**params, **state.batch_stats}, images, train=True, compute_dtype=dtype)
            return torch.autograd.grad(tm.smooth_l1_loss(pred, target), list(params.values()))

    return harness.time_ms(fwd_bwd, d.device, 5, warmup=2)
