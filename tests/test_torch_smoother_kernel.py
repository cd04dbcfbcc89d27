"""The premise of the smoother's hand-written solve (csrc/smoother.cu), and
its wrapper's CPU-side behaviour (perseus_tpu_torch/smoother/lm.py).

The kernel forms only the nonzero blocks of the "jacfwd" solver's Jacobian
and normal equations and solves them by block-Thomas Cholesky. That is the
dense path's arithmetic only if every entry it leaves out is an exact zero:
each factor's rows of the dense ``torch.func.jacfwd`` Jacobian vanish
outside its frames' columns (a frame's keypoints outside its 6 pose
columns), ``jac.T @ jac`` vanishes outside the block tridiagonal, and
``solve_block_tridiag`` on the damped blocks gives the dense
``cholesky_solve`` step. Checked here in float64 on GN-4 windows of 24
frames (the serving config's smoother) with warm-up frames, a rejected
frame, and right after a reset. The kernel itself runs on the card only
(tests/test_torch_smoother_cuda.py).
"""

import functools

import numpy as np
import pytest
import torch

from perseus_tpu_torch.camera import intrinsics_from_fov, project
from perseus_tpu_torch.datagen.labeling import cube_corners
from perseus_tpu_torch.lie import SE3, se3_exp, so3_exp
from perseus_tpu_torch.smoother import lm
from perseus_tpu_torch.utils.graphed import kernel_wrappers

F64 = torch.float64
T, K = 24, 8
# the serving config's GN-4 smoother (benchmark/configs/rgbd-stream-gn4.json)
GN4 = dict(window=T, dt=0.01, max_iterations=4, accept_reject=False)
MASKS = {
    "warm-up": [0.0] * 20 + [1.0] * 4,  # four frames seen so far
    "rejected": [1.0] * 17 + [0.0] + [1.0] * 6,  # the gate rejected frame 17
    "reset": [0.0] * 23 + [1.0],  # a reset keeps the newest frame alone
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _window(mask: str, seed: int = 7):
    """A window of a cube turning and drifting 0.3 m in front of the camera,
    perturbed, with a perturbed anchor (a later iteration's linearization
    point), the corners' pixels with noise, and a camera pose."""
    g = torch.Generator().manual_seed(seed)
    s = torch.arange(T, dtype=F64)[:, None] * 0.01
    rot = so3_exp(torch.cat([0.3 + 2.0 * s, -0.2 + s, 1.5 * s], dim=-1))
    trans = torch.cat([0.02 * torch.sin(20 * s), 0.01 * torch.cos(30 * s), 0.3 + 0.1 * s], dim=-1)
    pts = cube_corners(0.035, dtype=F64)
    intr = intrinsics_from_fov(torch.tensor(1.0, dtype=F64), 256, 256)
    meas = project(intr, torch.einsum("tij,kj->tki", rot, pts) + trans[:, None]) + torch.randn(T, K, 2, generator=g,
                                                                                             dtype=F64)

    def perturbed(scale):
        d = torch.randn(T, 12, generator=g, dtype=F64) * scale
        w = torch.tensor([2.0, 1.0, 1.5], dtype=F64) + d[:, 6:9]
        return lm.retract_window(lm.WindowState(rot, trans, w, 0.1 * d[:, 9:12]), d * torch.tensor(
            [1.0] * 6 + [0.0] * 6, dtype=F64))

    state, anchor = perturbed(0.02), perturbed(0.02)
    prior = SE3(state.rot[0], state.trans[0] + 0.005)
    camera = se3_exp(torch.tensor([0.02, -0.01, 0.03, 0.01, 0.0, -0.02], dtype=F64))
    valid = torch.tensor(MASKS[mask], dtype=F64)
    return state, anchor, meas, valid, intr, pts, prior, state.ang_vel[0] + 0.1, state.vel[0] - 0.01, camera


@functools.lru_cache(maxsize=None)
def _linearized(mask: str, vel_frame: str, kernel: str):
    """(cfg, jac, r) of the dense "jacfwd" path, as lm_solve_reference takes
    them, at the window (with its camera pose and anchor)."""
    cfg = lm.SmootherConfig(**GN4, vel_frame=vel_frame, robust_kernel=kernel)
    state, anchor, meas, valid, intr, pts, prior, pw, pv, camera = _window(mask)

    def residual_of(d):
        return lm.window_residuals(cfg, lm.retract_window(state, d.reshape(T, 12)), meas, valid, intr, pts,
                                   prior, pw, pv, camera, anchor)

    jac, r = torch.func.jacfwd(lambda d: (residual_of(d),) * 2, has_aux=True)(torch.zeros(12 * T, dtype=F64))
    return cfg, jac, r


def _factor_columns() -> torch.Tensor:
    """(R, 12T) bool: the columns each residual row may depend on, in
    window_residuals' row order: prior (frame 0), dynamics, constant angular
    and linear velocity (frames i and i+1 of pair i), keypoints (frame i's
    6 pose columns), pins (frame i)."""
    rows = []

    def frames(*idx, pose_only=False):
        m = torch.zeros(T, 12, dtype=torch.bool)
        for i in idx:
            m[i, : 6 if pose_only else 12] = True
        return m.reshape(-1)

    rows += [frames(0)] * 12
    for width in (6, 3, 3):
        for i in range(T - 1):
            rows += [frames(i, i + 1)] * width
    for i in range(T):
        rows += [frames(i, pose_only=True)] * (2 * K)
    for i in range(T):
        rows += [frames(i)] * 12
    return torch.stack(rows)


def _band() -> torch.Tensor:
    """(12T, 12T) bool: the block tridiagonal."""
    blk = torch.arange(12 * T) // 12
    return (blk[:, None] - blk[None, :]).abs() <= 1


CASES = [(m, vf, kern) for m in MASKS for vf in ("world", "body") for kern in ("huber", "gm")]


@pytest.mark.parametrize("mask,vel_frame,kernel", CASES)
def test_jacobian_is_exactly_zero_outside_each_factors_frames(mask, vel_frame, kernel):
    _, jac, _ = _linearized(mask, vel_frame, kernel)
    allowed = _factor_columns()
    assert jac.shape == allowed.shape
    assert torch.count_nonzero(jac[~allowed]) == 0
    # the pattern is not empty: every frame's pose columns are reached by some row
    assert bool((jac != 0).reshape(-1, T, 12)[..., :6].any(dim=0).all())


@pytest.mark.parametrize("mask,vel_frame,kernel", CASES)
def test_normal_equations_are_block_tridiagonal(mask, vel_frame, kernel):
    _, jac, _ = _linearized(mask, vel_frame, kernel)
    jtj = jac.T @ jac
    assert torch.count_nonzero(jtj[~_band()]) == 0
    assert torch.count_nonzero(jtj[_band()]) > 0


@pytest.mark.parametrize("mask,vel_frame,kernel", CASES)
def test_block_thomas_solve_gives_the_dense_step(mask, vel_frame, kernel):
    """The kernel's solve (solve_block_tridiag's recursion) on the damped
    band against lm_solve_reference's dense cholesky_solve step."""
    cfg, jac, r = _linearized(mask, vel_frame, kernel)
    jtj, jtr = jac.T @ jac, jac.T @ r
    lam = torch.tensor(cfg.lambda_init, dtype=F64)
    a = jtj + lam * torch.diag(torch.clamp_min(torch.diagonal(jtj), 1e-6))
    dense = torch.cholesky_solve((-jtr)[:, None], lm._cholesky(a))[:, 0].reshape(T, 12)
    blocks = a.reshape(T, 12, T, 12).permute(0, 2, 1, 3)
    idx = torch.arange(T - 1)
    band = lm.solve_block_tridiag(blocks[torch.arange(T), torch.arange(T)], blocks[idx, idx + 1],
                                  (-jtr).reshape(T, 12))
    assert bool(torch.isfinite(dense).all())
    np.testing.assert_allclose(band.numpy(), dense.numpy(), rtol=0, atol=1e-10)


def test_wrapper_raises_on_a_device_that_is_not_cuda():
    cfg = lm.SmootherConfig(**GN4)
    state, _, meas, valid, intr, pts, prior, pw, pv, _ = _window("warm-up")
    meta = lambda x: x.to("meta", torch.float32)  # noqa: E731
    window = lm.WindowState(*(meta(x) for x in state))
    with pytest.raises(ValueError, match="unsupported device"):
        lm.lm_solve_cuda(cfg, window, meta(meas), meta(valid), intr, meta(pts), prior, pw, pv)


@pytest.mark.parametrize("solver", ["jacfwd", "block"])
def test_a_cpu_solve_takes_the_plain_version_and_launches_nothing(solver):
    cfg = lm.SmootherConfig(window=4, max_iterations=2, solver=solver)
    state, _, meas, valid, intr, pts, prior, pw, pv, camera = _window("rejected")
    args = (cfg, lm.WindowState(*(x[-4:] for x in state)), meas[-4:], valid[-4:], intr, pts, prior, pw, pv, camera)
    before = lm.lm_solve_cuda.launches
    out, cost = lm.lm_solve(*args)
    ref_out, ref_cost = lm.lm_solve_reference(*args)
    assert lm.lm_solve_cuda.launches == before
    assert all(torch.equal(a, b) for a, b in zip(out, ref_out)) and torch.equal(cost, ref_cost)


def test_the_kernel_wrapper_is_counted_with_the_hand_kernels():
    assert lm.lm_solve_cuda in kernel_wrappers()
    assert isinstance(lm.lm_solve_cuda.launches, int)


@pytest.mark.parametrize("vel_frame,kernel,delta", [("world", "huber", 3.0), ("body", "gm", 2.0),
                                                    ("world", "huber", 0.0)])
def test_launch_arguments_follow_the_config(vel_frame, kernel, delta):
    """The config's scalars as the kernel takes them: flags for the velocity
    frame and the robust kernel, and each sigma the plain version divides
    by as a Python float as its f32 reciprocal (what the card multiplies by)."""
    cfg = lm.SmootherConfig(vel_frame=vel_frame, robust_kernel=kernel, robust_keypoint_delta=delta,
                            sigma_const_vel=0.3, sigma_keypoint_px=3.0)
    s = lm._scalars(cfg)
    assert s["vel_body"] == (vel_frame == "body")
    assert s["robust"] == (0 if delta <= 0 else {"huber": 1, "gm": 2}[kernel])
    one = torch.tensor(1.0)
    for key, sigma in (("inv_sigma_cv", 0.3), ("inv_sigma_kp", 3.0), ("inv_pin", 1e-3)):
        assert np.float32(s[key]) == (one / torch.tensor(sigma, dtype=torch.float32)).item()
    assert (s["iterations"], s["accept_reject"]) == (cfg.max_iterations, int(cfg.accept_reject))


def test_launch_arguments_refuse_an_unknown_robust_kernel():
    with pytest.raises(ValueError, match="robust_kernel"):
        lm._scalars(lm.SmootherConfig(robust_kernel="cauchy"))
