"""Global-norm clip and AdamW alone, ms a call: ``ClipAdamW.update`` on the
current state with gradients of the parameters' shape (CUDA events over 10
calls)."""

import torch

from benchmark import harness


def read(ctx):
    d = ctx["driver"]
    state = d.state
    grads = {k: torch.full_like(v, 1e-3) for k, v in state.params.items()}
    return harness.time_ms(lambda: d.optimizer.update(grads, state.opt_state, state.params), d.device, 10)
