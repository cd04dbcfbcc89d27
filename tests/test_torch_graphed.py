"""The serving step as one CUDA graph a frame (perseus_tpu_torch/utils/graphed.py).

On the CPU:

* a guard against the known capture hazards: every aten op that
  ``FixedLagSmoother.update`` (both solvers, GN and LM, through a sequence
  whose jump drives the innovation gate through rejections and a reset)
  and ``StreamingPipeline``'s eager step dispatch is recorded under a
  ``TorchDispatchMode``, and none may be one that copies a host literal to
  the device (``lift_fresh``), reads a device value on the host
  (``_local_scalar_dense``, ``item``, ``equal``), sizes its output by the
  data (``nonzero``) or factors on the host's terms (``linalg_pinv``'s
  SVD, ``_linalg_check_errors``). It guards against those known hazards; it
  does not prove that the step captures, which only a capture on the card
  shows;
* the constants hoisted out of the step are the values the step computed;
* the wrapper on the CPU is the eager call.

On the card (``cuda``-marked, skipped here; there run
``python -m pytest tests/test_torch_graphed.py -m cuda --noconftest``):
replay against the eager step bit for bit, earlier outputs surviving later
replays, a second graph for a new shape, no garbage collection inside a
capture, a capture that meets a host read raising, and the maxpool
kernel's counter counting replays.
"""

import gc

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perseus_tpu_torch.camera import denormalize_pixel_coordinates, intrinsics_from_fov, normalize_pixel_coordinates
from perseus_tpu_torch.camera import project
from perseus_tpu_torch.datagen.labeling import cube_corners
from perseus_tpu_torch.lie import so3_exp
from perseus_tpu_torch.models import pool, resnet
from perseus_tpu_torch.runtime.sources import SyntheticSource
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline
from perseus_tpu_torch.smoother import lm
from perseus_tpu_torch.smoother.fixed_lag import FixedLagSmoother
from perseus_tpu_torch.smoother.lm import SmootherConfig
from perseus_tpu_torch.utils.graphed import WARMUP_CALLS, Graphed

HAZARDS = {"aten.lift_fresh", "aten._local_scalar_dense", "aten.item", "aten.equal", "aten.nonzero",
           "aten.linalg_pinv", "aten._linalg_svd", "aten._linalg_check_errors"}
JUMP, N_FRAMES = 5, 9  # the gate sequence: corners jump at frame 5; rejections 5-7, the reset at 8


class _Ops(TorchDispatchMode):
    """Records the overload packet of every aten op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _smoother(device="cpu", **kw) -> FixedLagSmoother:
    cfg = SmootherConfig(window=4, max_iterations=2, **kw)
    intr = intrinsics_from_fov(torch.tensor(1.0, device=device), 64, 64)
    return FixedLagSmoother(cfg, intr, cube_corners(0.035, device=device))


def _gate_sequence(sm: FixedLagSmoother) -> torch.Tensor:
    """The corners at a turning, drifting pose 0.3 units away, in pixels,
    all moved by 40 px from frame JUMP on (the cube seen to jump)."""
    t = torch.arange(N_FRAMES, dtype=torch.float32, device=sm.device)[:, None]
    rot = so3_exp(torch.cat([0.3 + 0.02 * t, -0.2 + 0.01 * t, 0.015 * t], dim=-1))
    trans = torch.cat([0.02 * torch.sin(0.2 * t), 0.01 * torch.cos(0.3 * t), 0.3 + 0.001 * t], dim=-1)
    p_cam = torch.einsum("tij,kj->tki", rot, sm.points_body) + trans[:, None]
    return project(sm.intrinsics, p_cam) + 40.0 * (t >= JUMP).to(torch.float32)[:, :, None]


def _pipeline(device="cpu", solver="jacfwd", **kw) -> StreamingPipeline:
    cfg = StreamingConfig(num_channels=4, model_h=64, model_w=64, amp=False,
                          smoother=SmootherConfig(window=4, max_iterations=2, solver=solver, **kw))
    model = resnet.KeypointCNN(n_keypoints=8, num_channels=4, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    return StreamingPipeline(cfg, model.state_dict(), device=device)


def _frames(n, h=96, w=128):
    source = SyntheticSource(height=h, width=w, depth=True, seed=3)
    return [source.get_frame() for _ in range(n)]


@pytest.mark.parametrize("accept_reject", [False, True], ids=["gn", "lm"])
@pytest.mark.parametrize("solver", ["jacfwd", "block"])
def test_smoother_update_dispatches_no_capture_hazard(solver, accept_reject):
    sm = _smoother(solver=solver, accept_reject=accept_reject)
    meas = _gate_sequence(sm)
    carry = sm.init(sm.coarse_pose_from_keypoints(meas[0]))
    gate = []
    with _Ops() as ops, torch.no_grad():
        for m in meas:
            carry, _ = sm.update(carry, m)
            gate.append((carry.consec_rejects, carry.frames_seen))
    assert not ops.seen & HAZARDS, sorted(ops.seen & HAZARDS)
    assert not {op for op in ops.seen if op.startswith("aten.linalg_pinv")}
    gate = [(int(c), int(s)) for c, s in gate]
    # the gate's reject and reset paths both ran
    assert [c for c, _ in gate[JUMP:]] == [1, 2, 3, 0] and gate[-1][1] == 1, gate


@pytest.mark.parametrize("solver", ["jacfwd", "block"])
def test_streaming_eager_step_dispatches_no_capture_hazard(solver):
    pipe = _pipeline(solver=solver)
    frames = [torch.from_numpy(f) for f in _frames(2)]
    carry = pipe.init_carry()
    with _Ops() as ops:
        for f in frames:
            _, _, carry, _ = pipe.step_eager(f, carry)
    assert not ops.seen & HAZARDS, sorted(ops.seen & HAZARDS)
    assert "aten.conv2d" in ops.seen or "aten.convolution" in ops.seen  # the detector ran under the recorder


def test_hoisted_constants_are_the_values_the_step_computed():
    """The corners' pseudo-inverse, the cold start's axes, the reset mask,
    the dynamics sigmas and the damping are the literals they replace."""
    sm = _smoother()
    p = sm.points_body.to(sm.dtype)
    assert torch.equal(sm._corners_pinv, torch.linalg.pinv(p - torch.mean(p, dim=0)))
    assert torch.equal(sm._ex, torch.tensor([1.0, 0.0, 0.0])) and torch.equal(sm._ey, torch.tensor([0.0, 1.0, 0.0]))
    assert torch.equal(sm._newest_only, torch.tensor([0.0, 0.0, 0.0, 1.0]))
    cfg, cpu = sm.cfg, torch.device("cpu")
    want = torch.tensor([cfg.sigma_dynamics_rot] * 3 + [cfg.sigma_dynamics_trans] * 3)
    assert torch.equal(lm._sigma_dyn(cfg, torch.float32, cpu), want)
    assert lm._sigma_dyn(cfg, torch.float32, cpu) is lm._sigma_dyn(cfg, torch.float32, cpu)  # built once


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pixel_scaling_without_a_literal_is_bit_for_bit(dtype):
    coords = torch.from_numpy(np.random.default_rng(0).uniform(-300, 300, (512, 8, 2))).to(dtype)
    for h, w in ((256, 256), (376, 672), (64, 48)):
        norm = coords * torch.tensor([2.0 / (w - 1.0), 2.0 / (h - 1.0)], dtype=dtype) - 1.0
        denorm = (coords + 1.0) * torch.tensor([(w - 1.0) / 2.0, (h - 1.0) / 2.0], dtype=dtype)
        assert torch.equal(normalize_pixel_coordinates(coords, h, w), norm)
        assert torch.equal(denormalize_pixel_coordinates(coords, h, w), denorm)


def test_wrapper_on_the_cpu_is_the_eager_call():
    sm = _smoother()
    meas = _gate_sequence(sm)[:3]
    graphed, eager = sm.init(), sm.init()
    outs = []
    for m in meas:
        graphed, pose = sm.graphed_update(graphed, m)
        eager, want = sm.update(eager, m)
        outs.append((pose, pose.trans.clone()))
        assert all(torch.equal(a, b) for a, b in zip(_leaves((graphed, pose)), _leaves((eager, want))))
    # a later call leaves an earlier call's outputs as they were
    assert all(torch.equal(pose.trans, kept) for pose, kept in outs)
    assert sm.graphed_update.graphs == 0  # no capture on the CPU


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _deterministic(fn):
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = old


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["jacfwd", "block"])
def test_replay_equals_the_eager_step_bit_for_bit(solver):
    _need_cuda()
    pipe = _pipeline("cuda", solver=solver, accept_reject=False)
    frames = _frames(8)

    def run(step):
        carry, out = pipe.init_carry(), []
        for f in frames:
            k, image, carry, pose = step(f, carry)
            out.append((k, image, pose))
        return out, carry

    graph, eager = _deterministic(lambda: (run(pipe), run(pipe.step_eager)))
    assert pipe._step.graphs == 1
    for a, b in zip(_leaves(graph), _leaves(eager)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_earlier_outputs_survive_later_replays():
    _need_cuda()
    pipe = _pipeline("cuda")
    f0, f1 = _frames(2)
    first = pipe(f0, pipe.init_carry())
    kept = [x.clone() for x in _leaves(first)]
    second = pipe(f1, first[2])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(first), kept))
    assert not torch.equal(first[0], second[0])


@pytest.mark.cuda
def test_a_new_shape_captures_a_second_graph():
    _need_cuda()
    pipe = _pipeline("cuda")
    small, large = _frames(1, 80, 100)[0], _frames(1)[0]
    outs = _deterministic(lambda: [pipe(f, pipe.init_carry()) for f in (large, small, large)])
    assert pipe._step.graphs == 2
    assert all(torch.equal(a, b) for a, b in zip(_leaves(outs[0]), _leaves(outs[2])))
    for f, out in zip((large, small), outs):
        want = _deterministic(lambda: pipe.step_eager(f, pipe.init_carry()))
        assert all(torch.equal(a, b) for a, b in zip(_leaves(out), _leaves(want)))


@pytest.mark.cuda
def test_the_maxpool_counter_counts_replays():
    _need_cuda()
    pipe = _pipeline("cuda")
    frames = _frames(5)
    before = pool.max_pool_3x3_s2.launches
    carry = pipe.init_carry()
    for f in frames:
        _, _, carry, _ = pipe(f, carry)
    torch.cuda.synchronize()
    assert pool.max_pool_3x3_s2.launches - before == WARMUP_CALLS + len(frames)


@pytest.mark.cuda
def test_no_garbage_collection_inside_a_capture():
    """A collection inside a capture would destroy any graph left in a
    reference cycle (a pipeline and its graphed step hold each other),
    which CUDA refuses while a stream captures: the capture runs with the
    collector off, and turns it back on."""
    _need_cuda()
    seen = []

    def step(x):
        seen.append(gc.isenabled())
        return x * 2

    assert gc.isenabled()
    Graphed(step, "cuda")(torch.ones(3, device="cuda"))
    assert seen == [True] * WARMUP_CALLS + [False] and gc.isenabled()


@pytest.mark.cuda
def test_a_host_read_inside_the_step_raises_on_cuda():
    """Last in the file: a failed capture is the end of a step."""
    _need_cuda()
    step = Graphed(lambda x: x * x.sum().item(), "cuda")
    with pytest.raises(RuntimeError):
        step(torch.ones(3, device="cuda"))
