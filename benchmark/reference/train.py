"""Plain train step: the yardstick of the training cells.

augmentation (``reference/augment.py``, the draws worked out again from the
step's seed) -> the ResNet-18 in train mode in f32 (``detector.forward_train``)
-> SmoothL1 (beta 1) over the normalized keypoints -> clip by global norm
-> AdamW (moments, bias corrections, decoupled decay on every parameter,
optax's order: the update u = m_hat / (sqrt(v_hat) + eps) + decay * p,
then p - lr * u). The state is a dict of parameters and the two moment
dicts, all f32.

Faults and the control, for the benchmark's checks: ``quantize`` runs the
convolutions on float8-rounded inputs and weights; ``half_batch`` takes the
loss over the first half of the batch only.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import augment, detector


def huber(pred, target, delta=1.0):
    err = torch.abs(pred - target)
    quad = torch.clamp_max(err, delta)
    return 0.5 * quad * quad + delta * (err - quad)


def init(params: dict) -> dict:
    return {
        "params": {k: v.float().clone() for k, v in params.items()},
        "m": {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()},
        "v": {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()},
        "step": 0,
    }


def loss_and_grads(params: dict, images: torch.Tensor, coords: torch.Tensor, draws: dict, in_channels: int,
                   quantize: bool = False, half_batch: bool = False, stats: dict | None = None):
    """(loss, gradients by name) of the f32 ``images`` (B, 5, H, W) and
    pixel ``coords`` (B, K, 2) under ``draws``; ``stats`` receives each BN
    layer's unbiased batch variance."""
    with torch.no_grad():
        x, target = augment.apply(images.float(), coords, draws)
    x, target = x[:, :in_channels], target.reshape(target.shape[0], -1)
    if half_batch:
        x, target = x[: x.shape[0] // 2], target[: target.shape[0] // 2]
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = huber(detector.forward_train(leaves, x, quantize, stats), target).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def clip_adamw(state: dict, grads: dict, cfg: dict) -> tuple[dict, dict]:
    """(new state, the clipped gradients the moments took)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.where(norm < cfg["grad_clip_norm"], torch.ones_like(norm), cfg["grad_clip_norm"] / norm)
    clipped = {k: g * scale for k, g in grads.items()}
    b1, b2, eps = np.float32(0.9), np.float32(0.999), 1e-8
    t = state["step"] + 1
    new = {"params": {}, "m": {}, "v": {}, "step": t}
    for k, p in state["params"].items():
        g = clipped[k]
        m = float(1 - b1) * g + float(b1) * state["m"][k]
        v = float(1 - b2) * g * g + float(b2) * state["v"][k]
        u = (m / float(1 - b1**t)) / (torch.sqrt(v / float(1 - b2**t)) + eps) + cfg["weight_decay"] * p
        new["params"][k], new["m"][k], new["v"][k] = p - cfg["learning_rate"] * u, m, v
    return new, clipped


def step(state: dict, images, coords, run_seed: int, global_step: int, cfg: dict, aug_cfg: dict,
         quantize: bool = False, half_batch: bool = False):
    """One step at global step ``global_step``: (new state, loss, clipped
    gradients, each BN layer's unbiased batch variance)."""
    gen = torch.Generator(device=images.device).manual_seed(augment.step_seed(run_seed, global_step))
    b, _, h, w = images.shape
    draws = augment.sample(gen, aug_cfg, b, h, w)
    stats = {}
    loss, grads = loss_and_grads(state["params"], images, coords, draws, cfg["in_channels"], quantize, half_batch, stats)
    new, clipped = clip_adamw(state, grads, cfg)
    return new, loss, clipped, stats
