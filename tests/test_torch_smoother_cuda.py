"""The smoother's hand-written solve (csrc/smoother.cu, lm.lm_solve_cuda) on
the card against its plain version (lm.lm_solve_reference).

``cuda``-marked: they skip without a card. On the card (no JAX there):
``python -m pytest tests/test_torch_smoother_cuda.py -m cuda --noconftest -q``.

The keypoints are the camera traffic's (benchmark/inputs.py): the corners of
a cube at a seeded pose with a few pixels of per-frame jitter, moved 90 px
away for 8 frames and back, so that the innovation gate rejects frames and
resets the window twice.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import inputs
from perseus_tpu_torch.camera import intrinsics_from_fov
from perseus_tpu_torch.datagen.labeling import cube_corners
from perseus_tpu_torch.lie import SE3, se3_exp
from perseus_tpu_torch.smoother import fixed_lag, lm
from perseus_tpu_torch.smoother.fixed_lag import FixedLagSmoother
from perseus_tpu_torch.smoother.residuals import keypoint_projection_residual
from perseus_tpu_torch.utils.graphed import WARMUP_CALLS

FRAMES = 208
JUMP = (100, 108)  # frames moved away by JUMP_PX
JUMP_PX = 90.0
GN4 = dict(window=24, dt=0.01, max_iterations=4, accept_reject=False)
CASES = {
    "gn4": (GN4, False),
    "lm8": (dict(window=24, dt=0.01), False),
    "gn4-body": (dict(GN4, vel_frame="body"), False),
    "gn4-gm": (dict(GN4, robust_kernel="gm"), False),
    "gn4-camera": (GN4, True),
}
# Corners projected under the newest pose agree within this: the kernel and
# the plain version compute the same f32 arithmetic with sums in another
# order (the normal equations, the Cholesky, the costs). The benchmark's
# limit against the f64 reference is 0.7 px, where sound runs read 0.07-0.19.
CORNER_PX = 0.1


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _keypoints(n: int, seed: int = 5):
    """(n, 8, 2) keypoints on the card and the cube's pose (rot, trans)."""
    rot, trans = inputs.cube_pose(seed)
    base = inputs.project_corners(rot, trans, 0.035, 1.0, 256, 256)
    rng = np.random.default_rng(seed)
    kp = base[None] + rng.normal(scale=3.0, size=(n, 8, 2))
    kp[JUMP[0]:JUMP[1]] += JUMP_PX
    as_cuda = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    return as_cuda(kp), SE3(as_cuda(rot), as_cuda(trans))


def _smoother(cfg: dict, camera: bool) -> FixedLagSmoother:
    intr = intrinsics_from_fov(torch.tensor(1.0, device="cuda"), 256, 256)
    cam = se3_exp(torch.tensor([0.02, -0.01, 0.03, 0.01, 0.0, -0.02], device="cuda")) if camera else None
    return FixedLagSmoother(lm.SmootherConfig(**cfg), intr, cube_corners(0.035, device="cuda"), camera_pose=cam)


def _plain(sm: FixedLagSmoother):
    """``sm``'s graphed update with the plain solve captured in its graph."""
    with mock.patch.object(fixed_lag, "lm_solve", lm.lm_solve_reference):
        sm.graphed_update(sm.init(), torch.zeros(8, 2, device="cuda"))
    return sm.graphed_update


def _corners(sm: FixedLagSmoother, pose: SE3) -> torch.Tensor:
    zero = torch.zeros(8, 2, device="cuda")
    return keypoint_projection_residual(pose, sm.intrinsics, zero, sm.points_body, sm.camera_pose)


def _flags(carry) -> torch.Tensor:
    return torch.cat([carry.valid, torch.stack([carry.consec_rejects, carry.frames_seen]).float()])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_the_plain_solve_over_the_camera_keypoints(case):
    """Kernel and plain version each run their own carry over the frames:
    the same gate decisions on every frame, the newest pose's corners within
    CORNER_PX."""
    _need_cuda()
    cfg, camera = CASES[case]
    kp, pose0 = _keypoints(FRAMES)
    sm, ref = _smoother(cfg, camera), _smoother(cfg, camera)
    plain = _plain(ref)
    ck, cr = sm.init(pose0), ref.init(pose0)
    gaps, flags_k, flags_r = [], [], []
    for m in kp:
        ck, pk = sm.graphed_update(ck, m)
        cr, pr = plain(cr, m)
        gaps.append((_corners(sm, pk) - _corners(ref, pr)).abs().max())
        flags_k.append(_flags(ck))
        flags_r.append(_flags(cr))
    gap = torch.stack(gaps).max().item()
    fk, fr = torch.stack(flags_k).cpu(), torch.stack(flags_r).cpu()
    assert torch.equal(fk, fr)
    rejects, seen = fk[:, -2].tolist(), fk[:, -1].tolist()
    resets = [i for i in range(1, FRAMES) if seen[i] == 1]
    assert sum(r > 0 for r in rejects) == 6 and resets == [JUMP[0] + 3, JUMP[1] + 3], (rejects, resets)
    assert gap < CORNER_PX, gap


@pytest.mark.cuda
def test_graph_replay_matches_the_eager_update_bit_for_bit_one_launch_an_update():
    _need_cuda()
    kp, pose0 = _keypoints(FRAMES)
    sm = _smoother(GN4, False)
    kp = kp[JUMP[0] - 24:JUMP[1] + 16]  # warm window, the rejections and the reset
    c_graph = c_eager = sm.init(pose0)
    before = lm.lm_solve_cuda.launches
    for i, m in enumerate(kp):
        c_graph, p_graph = sm.graphed_update(c_graph, m)
        if i == 0:  # the warm-up's launch, the capture's none, the replay's one
            assert lm.lm_solve_cuda.launches - before == WARMUP_CALLS + 1
            before = lm.lm_solve_cuda.launches
        n = lm.lm_solve_cuda.launches
        c_eager, p_eager = sm.update(c_eager, m)
        assert lm.lm_solve_cuda.launches == n + 1
        leaves_g = torch.utils._pytree.tree_leaves((c_graph, p_graph))
        leaves_e = torch.utils._pytree.tree_leaves((c_eager, p_eager))
        assert all(torch.equal(a, b) for a, b in zip(leaves_g, leaves_e)), i
    # one launch a replay (the frames after the first) and one an eager update
    assert lm.lm_solve_cuda.launches - before == 2 * (len(kp) - 1) + 1
    assert sm.graphed_update.graphs == 1


def _window_args(sm: FixedLagSmoother, kp: torch.Tensor, pose0: SE3, frames: int = 30):
    """The arguments of the solve of the update after ``frames`` frames."""
    carry = sm.init(pose0)
    for m in kp[:frames]:
        carry, _ = sm.graphed_update(carry, m)
    seen = []
    with mock.patch.object(fixed_lag, "lm_solve", lambda *a: seen.append(a) or lm.lm_solve(*a)):
        sm.update(carry, kp[frames])
    return seen[0]


@pytest.mark.cuda
def test_lm_solve_on_a_cuda_f32_window_never_reaches_jacfwd():
    _need_cuda()
    kp, pose0 = _keypoints(40)
    for cfg in (GN4, dict(window=24, dt=0.01)):
        sm = _smoother(cfg, False)
        args = _window_args(sm, kp, pose0)
        before = lm.lm_solve_cuda.launches
        with mock.patch.object(torch.func, "jacfwd", side_effect=AssertionError("jacfwd reached")):
            out, cost = lm.lm_solve(*args)
        assert lm.lm_solve_cuda.launches == before + 1
        ref, ref_cost = lm.lm_solve_reference(*args)
        assert bool(torch.isfinite(cost)) and abs(cost.item() - ref_cost.item()) <= 1e-3 * ref_cost.item()
        assert max((a - b).abs().max().item() for a, b in zip(out, ref)) < 1e-3


@pytest.mark.cuda
def test_the_block_solver_keeps_its_torch_path_and_other_windows_raise():
    _need_cuda()
    kp, pose0 = _keypoints(40)
    sm = _smoother(GN4, False)
    args = list(_window_args(sm, kp, pose0))
    before = lm.lm_solve_cuda.launches
    lm.lm_solve(lm.SmootherConfig(**GN4, solver="block"), *args[1:])
    assert lm.lm_solve_cuda.launches == before
    f64 = [lm.WindowState(*(x.double() for x in args[1]))] + args[2:]
    with pytest.raises(TypeError, match="float32"):
        lm.lm_solve(args[0], *f64)
    # a window whose arrays exceed a block's shared memory
    t = 64
    big = lm.WindowState(*(x[:1].expand(t, *x.shape[1:]).contiguous() for x in args[1]))
    meas = args[2][:1].expand(t, 8, 2).contiguous()
    valid = torch.ones(t, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        lm.lm_solve(lm.SmootherConfig(**dict(GN4, window=t)), big, meas, valid, *args[4:])
    assert lm.lm_solve_cuda.launches == before
