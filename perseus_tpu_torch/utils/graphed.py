"""CUDA graphs for fixed-shape functions of tensors: the port's ``jax.jit``.

The JAX package compiles its serving step and the smoother update into one
program each (``jax.jit``), so a frame is one device dispatch. The port's
counterpart is :class:`Graphed`: on a CUDA device it captures the function
into a ``torch.cuda.CUDAGraph`` on the first call for an input signature
and replays it after, so a call is one graph launch plus the copies of its
inputs into the graph's static buffers and of its outputs out of them. The
kernels in the graph are the eager ones, so a replay gives the eager
function's results bit for bit on the same card.

The function takes and returns pytrees of tensors (tuples, ``NamedTuple``s
such as ``SmootherCarry``, ``WindowState``, ``SE3``; ``None`` and Python
scalars as constants). It must run on the device alone, with no host read
and no host wait, and must not change its inputs; a capture that meets a
host read raises (there is no eager fallback on CUDA). On a CPU device the
wrapper is the eager call.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from perseus_tpu_torch.utils import spans

__all__ = ["Graphed", "WARMUP_CALLS", "kernel_wrappers"]

WARMUP_CALLS = 1  # eager calls before a capture: each launches its hand kernels once


def kernel_wrappers() -> tuple:
    """The hand kernels' Python wrappers, each with its ``launches`` count
    (one added where the wrapper launches its kernel)."""
    from perseus_tpu_torch.augment import fused, warp
    from perseus_tpu_torch.models import pool

    return (pool.max_pool_3x3_s2, pool.max_pool_3x3_s2_backward, fused.fused_apply,
            fused.fused_warp_apply, fused.fused_ultra_apply, warp.warp_affine_two_pass)


def _launch_counts() -> dict:
    # a wrapper patched out (a test swapping in a plain version) has no count
    return {fn: fn.launches for fn in kernel_wrappers() if hasattr(fn, "launches")}


class _Capture(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static input buffers (None for a constant leaf)
    outputs: list  # the graph's output leaves
    out_spec: pytree.TreeSpec
    launches: dict  # the hand-kernel launches the graph holds, by wrapper
    spans: spans.GraphSpans | None  # the spans inside the graph (captured with spans on)


class Graphed:
    """``fn`` on ``device``, captured into a CUDA graph per input signature.

    The first call for a signature (the pytree's structure, each tensor's
    shape and dtype, each constant's value) runs ``fn`` ``WARMUP_CALLS``
    times eagerly on a side stream, which creates the cuDNN plans and the
    cuBLAS and cuSOLVER handles and workspaces, then captures it with
    static input buffers and the garbage collector off. Every call copies its tensors into those buffers (a host tensor
    is copied to the device there), replays the graph and returns clones of
    its outputs, so that no later replay overwrites them. A new signature
    captures a new graph. Whether spans are on (``utils/spans.py``) is part
    of the signature: with spans off the graph is the function's work alone;
    with spans on a graph of its own holds event nodes at its start and end
    and around each span inside the function, so that each replay yields
    them. A call opens the spans ``graphed.copy_in``, ``graphed.replay``
    and ``graphed.clone_out`` (on the CPU around the eager call, the first
    and last around nothing). The hand kernels' wrappers count their launches
    in Python; the launches a graph holds are added to their counts at each
    replay (and not at the capture, which launches nothing). Outputs carry
    no autograd history.
    """

    def __init__(self, fn: Callable, device: str | torch.device):
        self.fn = fn
        self.device = torch.device(device)
        self._captures: dict = {}

    @property
    def graphs(self) -> int:
        """The graphs captured so far, one per input signature."""
        return len(self._captures)

    def __call__(self, *args: Any) -> Any:
        if self.device.type != "cuda":
            with torch.no_grad():
                with spans.span("graphed.copy_in", self.device):
                    pass
                with spans.span("graphed.replay", self.device):
                    out = self.fn(*args)
                with spans.span("graphed.clone_out", self.device):
                    pass
                return out
        leaves, spec = pytree.tree_flatten(args)
        key = (spec, tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else x for x in leaves),
               spans.enabled())
        cap = self._captures.get(key)
        if cap is None:
            cap = self._captures[key] = self._capture(leaves, spec)
        with spans.span("graphed.copy_in", self.device):
            for buf, x in zip(cap.inputs, leaves):
                if buf is not None:
                    buf.copy_(x)
        with spans.span("graphed.replay", self.device, graph=cap.spans):
            cap.graph.replay()
        for fn, n in cap.launches.items():
            fn.launches += n
        with spans.span("graphed.clone_out", self.device):
            return pytree.tree_unflatten(
                [x.clone() if isinstance(x, torch.Tensor) else x for x in cap.outputs], cap.out_spec
            )

    def _capture(self, leaves: list, spec: pytree.TreeSpec) -> _Capture:
        inputs = [
            torch.empty_like(x, device=self.device).copy_(x) if isinstance(x, torch.Tensor) else None
            for x in leaves
        ]
        static = pytree.tree_unflatten([b if b is not None else x for b, x in zip(inputs, leaves)], spec)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad():
            with torch.cuda.stream(stream), spans.paused():
                for _ in range(WARMUP_CALLS):
                    self.fn(*static)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            before = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: one would destroy any
            # graph left in a reference cycle, which CUDA refuses during a
            # capture (the capture fails). torch.cuda.graph collects first.
            collecting = gc.isenabled()
            gc.disable()
            try:  # a capture that fails raises: there is no eager fallback
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                    with spans.graph_capture("graphed.replay") as graph_spans:
                        out = self.fn(*static)
            finally:  # the capture recorded launches and ran none
                if collecting:
                    gc.enable()
                launches = {fn: n - before[fn] for fn, n in _launch_counts().items() if n != before.get(fn, n)}
                for fn in launches:
                    fn.launches = before[fn]
        outputs, out_spec = pytree.tree_flatten(out)
        return _Capture(graph, inputs, outputs, out_spec, launches, graph_spans)
