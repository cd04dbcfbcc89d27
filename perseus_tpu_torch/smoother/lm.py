"""Fixed-lag Levenberg-Marquardt smoother on SE(3), in PyTorch.

Port of ``perseus_tpu/smoother/lm.py``. State per frame: pose (SE3),
body-frame angular velocity (3,), linear velocity (3,, world or body frame);
tangent ordering per frame [pose (6) | ang vel (3) | lin vel (3)]. Factors
over a window of T frames: a prior on frame 0, dynamics and constant-velocity
residuals between neighbours, keypoint projections masked by per-frame
validity, and pins that hold unobserved (warm-up) frames at their
initialization.

Two solvers, as in the JAX package: "jacfwd" takes the Jacobian of the whole
residual stack by forward-mode AD (``torch.func.jacfwd``: vmapped JVPs over
the 12T tangent columns) and solves the dense damped normal equations by
Cholesky; "block" assembles the block-tridiagonal normal equations from the
analytic per-factor Jacobians and solves them by block-Thomas Cholesky.
Everything runs with no host reads and no host literals, so a window on the
card stays on the card and an update captures into a CUDA graph
(``FixedLagSmoother.graphed_update``); the iteration count is fixed (no
early exit), with accept/reject by ``torch.where``.

On the card the "jacfwd" solve is one launch of a hand-written kernel
(``csrc/smoother.cu``; it replaces no Pallas kernel: the JAX package jits
the smoother):

  =====================  ================================  ==========================
  entry                  kernel                            plain version
  =====================  ================================  ==========================
  :func:`lm_solve_cuda`  ``perseus_smoother_lm_f32``       :func:`lm_solve_reference`
  =====================  ================================  ==========================

:func:`lm_solve` takes the kernel for a CUDA window with the "jacfwd" solver
and the plain version otherwise (a CPU window, the "block" solver). Each
launch adds one to ``lm_solve_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from perseus_tpu_torch.camera import Intrinsics
from perseus_tpu_torch.lie import (
    SE3,
    matvec,
    se3_between,
    se3_compose,
    se3_exp,
    se3_log,
    se3_logmap_derivative,
)
from perseus_tpu_torch.models import _build
from perseus_tpu_torch.smoother import residuals as res

__all__ = [
    "SmootherConfig",
    "WindowState",
    "retract_window",
    "window_residuals",
    "assemble_normal_blocks",
    "assemble_normal_equations",
    "solve_block_tridiag",
    "lm_solve",
    "lm_solve_cuda",
    "lm_solve_reference",
    "predict_next",
]


@dataclass(frozen=True)
class SmootherConfig:
    """Noise model + solver settings; the JAX package's ``SmootherConfig``
    field for field (see there for what each one is for). Residuals are
    whitened by 1/sigma."""

    window: int = 24
    dt: float = 1.0 / 100.0
    vel_frame: str = "world"
    n_keypoints: int = 8

    sigma_dynamics_rot: float = 0.01
    sigma_dynamics_trans: float = 0.005
    sigma_const_ang_vel: float = 0.1
    sigma_const_vel: float = 0.1
    sigma_keypoint_px: float = 2.0
    sigma_prior_pose: float = 0.1
    sigma_prior_vel: float = 1.0

    # robust kernel on the keypoint residuals, threshold in whitened units;
    # 0 disables. "huber" or "gm" (Geman-McClure).
    robust_keypoint_delta: float = 3.0
    robust_kernel: str = "huber"

    # innovation gate on whole-frame detector failures (0 disables), with a
    # tracker reset after gate_max_consec consecutive rejections
    gate_px: float = 30.0
    gate_max_consec: int = 3
    gate_min_frames: int = 4

    max_iterations: int = 8
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    lambda_min: float = 1e-9
    lambda_max: float = 1e6
    solver: str = "jacfwd"  # "jacfwd" | "block"
    # False = incremental Gauss-Newton (constant damping, every step taken)
    accept_reject: bool = True


def _robust_keypoint_weights(cfg: SmootherConfig, r_kp_whitened: torch.Tensor) -> torch.Tensor:
    """IRLS sqrt-weights (..., K, 1) for whitened keypoint residual 2-vectors,
    held constant through differentiation (detached), so the two solvers
    agree exactly."""
    if cfg.robust_keypoint_delta <= 0.0:
        return torch.ones(
            r_kp_whitened.shape[:-1] + (1,), dtype=r_kp_whitened.dtype, device=r_kp_whitened.device
        )
    norm = torch.sqrt(torch.sum(r_kp_whitened**2, dim=-1, keepdim=True) + 1e-12)
    if cfg.robust_kernel == "gm":
        w = 1.0 / (1.0 + (norm / cfg.robust_keypoint_delta) ** 2) ** 2
    elif cfg.robust_kernel == "huber":
        w = torch.clamp_max(cfg.robust_keypoint_delta / norm, 1.0)
    else:
        raise ValueError(f"unknown robust_kernel {cfg.robust_kernel!r}")
    return torch.sqrt(w).detach()


class WindowState(NamedTuple):
    """Estimation window: leading axis is time (T frames)."""

    rot: torch.Tensor  # (T, 3, 3)
    trans: torch.Tensor  # (T, 3)
    ang_vel: torch.Tensor  # (T, 3)
    vel: torch.Tensor  # (T, 3)

    @property
    def poses(self) -> SE3:
        return SE3(self.rot, self.trans)


def retract_window(state: WindowState, delta: torch.Tensor) -> WindowState:
    """Applies a (T, 12) tangent update: pose . Exp(d_pose), vel + d_vel."""
    new_pose = se3_compose(SE3(state.rot, state.trans), se3_exp(delta[..., :6]))
    return WindowState(
        new_pose.rot, new_pose.trans, state.ang_vel + delta[..., 6:9], state.vel + delta[..., 9:12]
    )


@functools.lru_cache(maxsize=64)
def _sigma_dyn(cfg: SmootherConfig, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The dynamics residual's 6 sigmas [rot x3 | trans x3], built once per
    (config, dtype, device) and filled on the device: no host literal, even
    where the first use is inside a CUDA graph's capture."""
    sigma = torch.full((6,), cfg.sigma_dynamics_trans, dtype=dtype, device=device)
    sigma[:3].fill_(cfg.sigma_dynamics_rot)
    return sigma


def _frame_poses(state: WindowState) -> SE3:
    """Frame poses shaped to broadcast against the K corners: (T, 1, ...)."""
    return SE3(state.rot[:, None], state.trans[:, None])


def window_residuals(
    cfg: SmootherConfig,
    state: WindowState,
    measurements: torch.Tensor,  # (T, K, 2) pixel measurements
    valid: torch.Tensor,  # (T,) 0/1 frame validity
    intrinsics: Intrinsics,
    points_body: torch.Tensor,  # (K, 3) cube corners in the body frame
    prior_pose: SE3,
    prior_ang_vel: torch.Tensor,
    prior_vel: torch.Tensor,
    camera_pose: SE3 | None = None,
    anchor: WindowState | None = None,
) -> torch.Tensor:
    """Whitened residual stack (flat vector), static shape. `anchor` (the
    pre-solve window) pins frames without measurements to their
    initialization so the normal equations stay full rank."""
    # frame 0 as a batch of one: under forward-mode AD a Python scalar times
    # a 0-dim tensor gives a float64 tangent, which breaks f32 windows
    r_prior_pose = se3_log(se3_between(prior_pose, SE3(state.rot[:1], state.trans[:1])))[0]
    r_prior = torch.cat(
        [
            r_prior_pose / cfg.sigma_prior_pose,
            (state.ang_vel[0] - prior_ang_vel) / cfg.sigma_prior_vel,
            (state.vel[0] - prior_vel) / cfg.sigma_prior_vel,
        ]
    )

    r_dyn = res.dynamics_residual(
        SE3(state.rot[:-1], state.trans[:-1]), state.ang_vel[:-1], state.vel[:-1],
        SE3(state.rot[1:], state.trans[1:]), cfg.dt, cfg.vel_frame,
    )
    pair_valid = (valid[:-1] * valid[1:])[:, None]
    r_dyn = (r_dyn / _sigma_dyn(cfg, r_dyn.dtype, r_dyn.device)) * pair_valid
    r_cw = (state.ang_vel[1:] - state.ang_vel[:-1]) / cfg.sigma_const_ang_vel * pair_valid
    r_cv = (state.vel[1:] - state.vel[:-1]) / cfg.sigma_const_vel * pair_valid

    r_kp = res.keypoint_projection_residual(
        _frame_poses(state), intrinsics, measurements, points_body, camera_pose
    )  # (T, K, 2)
    r_kp = (r_kp / cfg.sigma_keypoint_px) * valid[:, None, None]
    r_kp = r_kp * _robust_keypoint_weights(cfg, r_kp)

    parts = [r_prior, r_dyn.reshape(-1), r_cw.reshape(-1), r_cv.reshape(-1), r_kp.reshape(-1)]
    if anchor is not None:
        invalid = (1.0 - valid)[:, None]
        r_pin_pose = se3_log(
            se3_between(SE3(anchor.rot, anchor.trans), SE3(state.rot, state.trans))
        )
        r_pin = torch.cat(
            [r_pin_pose, state.ang_vel - anchor.ang_vel, state.vel - anchor.vel], dim=-1
        ) * invalid / 1e-3
        parts.append(r_pin.reshape(-1))
    return torch.cat(parts)


def assemble_normal_blocks(
    cfg: SmootherConfig,
    state: WindowState,
    measurements: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    points_body: torch.Tensor,
    prior_pose: SE3,
    prior_ang_vel: torch.Tensor,
    prior_vel: torch.Tensor,
    camera_pose: SE3 | None,
    anchor: WindowState,
):
    """The block-tridiagonal normal equations (d_blocks (T,12,12), u_blocks
    (T-1,12,12), b_blocks (T,12), cost) from the analytic per-factor
    Jacobians; the residual stack is :func:`window_residuals`'s."""
    t = state.rot.shape[0]
    dtype, device = state.trans.dtype, state.trans.device
    eye3 = torch.eye(3, dtype=dtype, device=device)

    d_blocks = torch.zeros((t, 12, 12), dtype=dtype, device=device)
    b_blocks = torch.zeros((t, 12), dtype=dtype, device=device)

    # ---- prior on frame 0 ----------------------------------------------
    rel0 = se3_between(prior_pose, SE3(state.rot[0], state.trans[0]))
    r0p = se3_log(rel0) / cfg.sigma_prior_pose
    j0p = se3_logmap_derivative(rel0) / cfg.sigma_prior_pose
    r0w = (state.ang_vel[0] - prior_ang_vel) / cfg.sigma_prior_vel
    r0v = (state.vel[0] - prior_vel) / cfg.sigma_prior_vel
    d_blocks[0, :6, :6] += j0p.T @ j0p
    d_blocks[0, 6:9, 6:9] += eye3 / cfg.sigma_prior_vel**2
    d_blocks[0, 9:12, 9:12] += eye3 / cfg.sigma_prior_vel**2
    b_blocks[0] += torch.cat([j0p.T @ r0p, r0w / cfg.sigma_prior_vel, r0v / cfg.sigma_prior_vel])
    cost = torch.dot(r0p, r0p) + torch.dot(r0w, r0w) + torch.dot(r0v, r0v)

    # ---- dynamics + constant-velocity pairs (i, i+1) -------------------
    sigma_dyn = _sigma_dyn(cfg, dtype, device)
    pair_valid = valid[:-1] * valid[1:]
    r_dyn, h_p1, h_w, h_v, h_p2 = res.dynamics_residual_and_jacobians(
        SE3(state.rot[:-1], state.trans[:-1]), state.ang_vel[:-1], state.vel[:-1],
        SE3(state.rot[1:], state.trans[1:]), cfg.dt, cfg.vel_frame,
    )
    pv = pair_valid[:, None]
    pv2 = pair_valid[:, None, None]
    # whitened pair residual: [dynamics (6) | const-w (3) | const-v (3)]
    r_pair = torch.cat(
        [
            r_dyn / sigma_dyn,
            (state.ang_vel[1:] - state.ang_vel[:-1]) / cfg.sigma_const_ang_vel,
            (state.vel[1:] - state.vel[:-1]) / cfg.sigma_const_vel,
        ],
        dim=-1,
    ) * pv
    # A: d r_pair / d frame_i ; B: d r_pair / d frame_{i+1}
    a = torch.zeros((t - 1, 12, 12), dtype=dtype, device=device)
    a[:, :6, :6] = h_p1 / sigma_dyn[:, None]
    a[:, :6, 6:9] = h_w / sigma_dyn[:, None]
    a[:, :6, 9:12] = h_v / sigma_dyn[:, None]
    a[:, 6:9, 6:9] = -eye3 / cfg.sigma_const_ang_vel
    a[:, 9:12, 9:12] = -eye3 / cfg.sigma_const_vel
    a = a * pv2
    b = torch.zeros((t - 1, 12, 12), dtype=dtype, device=device)
    b[:, :6, :6] = h_p2 / sigma_dyn[:, None]
    b[:, 6:9, 6:9] = eye3 / cfg.sigma_const_ang_vel
    b[:, 9:12, 9:12] = eye3 / cfg.sigma_const_vel
    b = b * pv2

    d_blocks[:-1] += a.transpose(-1, -2) @ a
    d_blocks[1:] += b.transpose(-1, -2) @ b
    u_blocks = a.transpose(-1, -2) @ b  # coupling i, i+1
    b_blocks[:-1] += matvec(a.transpose(-1, -2), r_pair)
    b_blocks[1:] += matvec(b.transpose(-1, -2), r_pair)
    cost = cost + torch.sum(r_pair * r_pair)

    # ---- keypoint projections (per frame, pose block only) -------------
    r_kp, h_kp = res.keypoint_projection_residual_and_jacobian(
        _frame_poses(state), intrinsics, measurements, points_body, camera_pose
    )
    r_kp = (r_kp / cfg.sigma_keypoint_px) * valid[:, None, None]  # (T, K, 2)
    h_kp = (h_kp / cfg.sigma_keypoint_px) * valid[:, None, None, None]  # (T, K, 2, 6)
    rw = _robust_keypoint_weights(cfg, r_kp)
    r_kp = r_kp * rw
    h_kp = h_kp * rw[..., None]
    jk = h_kp.reshape(t, -1, 6)
    rk = r_kp.reshape(t, -1)
    d_blocks[:, :6, :6] += jk.transpose(-1, -2) @ jk
    b_blocks[:, :6] += matvec(jk.transpose(-1, -2), rk)
    cost = cost + torch.sum(rk * rk)

    # ---- pin unobserved (warmup) frames to the anchor ------------------
    w_pin = (1.0 - valid) / 1e-3
    rel_pin = se3_between(SE3(anchor.rot, anchor.trans), SE3(state.rot, state.trans))
    r_pin_pose = se3_log(rel_pin) * w_pin[:, None]
    j_pin = se3_logmap_derivative(rel_pin) * w_pin[:, None, None]
    r_pin_w = (state.ang_vel - anchor.ang_vel) * w_pin[:, None]
    r_pin_v = (state.vel - anchor.vel) * w_pin[:, None]
    d_blocks[:, :6, :6] += j_pin.transpose(-1, -2) @ j_pin
    pin_eye = w_pin[:, None, None] ** 2 * eye3
    d_blocks[:, 6:9, 6:9] += pin_eye
    d_blocks[:, 9:12, 9:12] += pin_eye
    b_blocks[:, :6] += matvec(j_pin.transpose(-1, -2), r_pin_pose)
    b_blocks[:, 6:9] += w_pin[:, None] * r_pin_w
    b_blocks[:, 9:12] += w_pin[:, None] * r_pin_v
    cost = cost + torch.sum(r_pin_pose**2) + torch.sum(r_pin_w**2) + torch.sum(r_pin_v**2)

    return d_blocks, u_blocks, b_blocks, 0.5 * cost


def assemble_normal_equations(
    cfg: SmootherConfig,
    state: WindowState,
    measurements: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    points_body: torch.Tensor,
    prior_pose: SE3,
    prior_ang_vel: torch.Tensor,
    prior_vel: torch.Tensor,
    camera_pose: SE3 | None,
    anchor: WindowState,
):
    """Dense (J^T J, J^T r, cost) from :func:`assemble_normal_blocks`."""
    t = state.rot.shape[0]
    d_blocks, u_blocks, b_blocks, half_cost = assemble_normal_blocks(
        cfg, state, measurements, valid, intrinsics, points_body,
        prior_pose, prior_ang_vel, prior_vel, camera_pose, anchor,
    )
    h = torch.zeros((t * 12, t * 12), dtype=d_blocks.dtype, device=d_blocks.device)
    for i in range(t):
        h[i * 12 : (i + 1) * 12, i * 12 : (i + 1) * 12] = d_blocks[i]
    for i in range(t - 1):
        h[i * 12 : (i + 1) * 12, (i + 1) * 12 : (i + 2) * 12] = u_blocks[i]
        h[(i + 1) * 12 : (i + 2) * 12, i * 12 : (i + 1) * 12] = u_blocks[i].T
    return h, b_blocks.reshape(t * 12), half_cost


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN (not an exception, not a host sync) where
    the matrix is not positive definite, as the JAX package's factor."""
    low, info = torch.linalg.cholesky_ex(a)
    return torch.where(info[..., None, None] == 0, low, torch.full_like(low, float("nan")))


def solve_block_tridiag(
    d_blocks: torch.Tensor,  # (T, B, B) diagonal blocks (SPD system)
    u_blocks: torch.Tensor,  # (T-1, B, B) super-diagonal blocks (i, i+1)
    rhs: torch.Tensor,  # (T, B)
) -> torch.Tensor:
    """Solves the SPD block-tridiagonal system H x = rhs by block-Thomas
    Cholesky, sequential in T:

      S_0 = D_0,  S_i = D_i - W_{i-1}^T W_{i-1},  W_i = L_i^{-1} U_i,
      L_i = chol(S_i);  forward: y_i = L_i^{-1}(b_i - W_{i-1}^T y_{i-1});
      backward: x_i = L_i^{-T}(y_i - W_i x_{i+1}).
    """
    t, bdim, _ = d_blocks.shape
    w_prev = torch.zeros((bdim, bdim), dtype=d_blocks.dtype, device=d_blocks.device)
    y_prev = torch.zeros((bdim,), dtype=d_blocks.dtype, device=d_blocks.device)
    factors = []
    for i in range(t):
        s_i = d_blocks[i] - w_prev.T @ w_prev
        l_i = _cholesky(s_i)
        y_i = torch.linalg.solve_triangular(
            l_i, (rhs[i] - w_prev.T @ y_prev)[:, None], upper=False
        )[:, 0]
        u_i = u_blocks[i] if i < t - 1 else torch.zeros_like(w_prev)
        w_i = torch.linalg.solve_triangular(l_i, u_i, upper=False)
        factors.append((l_i, w_i, y_i))
        w_prev, y_prev = w_i, y_i

    x_next = torch.zeros_like(y_prev)
    xs = []
    for l_i, w_i, y_i in reversed(factors):
        x_next = torch.linalg.solve_triangular(
            l_i.T, (y_i - w_i @ x_next)[:, None], upper=True
        )[:, 0]
        xs.append(x_next)
    return torch.stack(xs[::-1])


def lm_solve(
    cfg: SmootherConfig,
    state: WindowState,
    measurements: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    points_body: torch.Tensor,
    prior_pose: SE3,
    prior_ang_vel: torch.Tensor,
    prior_vel: torch.Tensor,
    camera_pose: SE3 | None = None,
) -> tuple[WindowState, torch.Tensor]:
    """Damped Gauss-Newton (LM) for ``cfg.max_iterations`` steps.

    Returns (optimized window, final cost). With ``accept_reject`` a step
    that does not lower the cost is rejected and the damping raised;
    without, every step is taken at constant damping. A CUDA window with
    the "jacfwd" solver goes to the kernel (:func:`lm_solve_cuda`), any
    other to :func:`lm_solve_reference`.
    """
    solve = lm_solve_cuda if cfg.solver == "jacfwd" and state.trans.device.type == "cuda" else lm_solve_reference
    return solve(cfg, state, measurements, valid, intrinsics, points_body, prior_pose, prior_ang_vel, prior_vel,
                 camera_pose)


def lm_solve_reference(
    cfg: SmootherConfig,
    state: WindowState,
    measurements: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    points_body: torch.Tensor,
    prior_pose: SE3,
    prior_ang_vel: torch.Tensor,
    prior_vel: torch.Tensor,
    camera_pose: SE3 | None = None,
) -> tuple[WindowState, torch.Tensor]:
    """:func:`lm_solve` in PyTorch ops, for both solvers on any device; with
    accept/reject by ``torch.where``."""
    t = state.rot.shape[0]
    tangent_dim = 12 * t
    dtype, device = state.trans.dtype, state.trans.device
    anchor = state  # pre-solve estimate pins unobserved frames

    def residual_of(delta_flat: torch.Tensor, st: WindowState) -> torch.Tensor:
        perturbed = retract_window(st, delta_flat.reshape(t, 12))
        return window_residuals(
            cfg, perturbed, measurements, valid, intrinsics, points_body,
            prior_pose, prior_ang_vel, prior_vel, camera_pose, anchor,
        )

    zero = torch.zeros(tangent_dim, dtype=dtype, device=device)

    def cost(st: WindowState) -> torch.Tensor:
        r = residual_of(zero, st)
        return 0.5 * torch.dot(r, r)

    def step(st: WindowState, lam: torch.Tensor):
        if cfg.solver == "block":
            d_b, u_b, b_b, old_cost = assemble_normal_blocks(
                cfg, st, measurements, valid, intrinsics, points_body,
                prior_pose, prior_ang_vel, prior_vel, camera_pose, anchor,
            )
            bdiag = torch.diagonal(d_b, dim1=-2, dim2=-1)
            damp = torch.diag_embed(lam * torch.clamp_min(bdiag, 1e-6))
            delta = solve_block_tridiag(d_b + damp, u_b, -b_b)
        else:
            jac, r = torch.func.jacfwd(
                lambda d: (residual_of(d, st),) * 2, has_aux=True
            )(zero)  # (R, 12T), (R,)
            jtj, jtr, old_cost = jac.T @ jac, jac.T @ r, 0.5 * torch.dot(r, r)
            a = jtj + lam * torch.diag(torch.clamp_min(torch.diagonal(jtj), 1e-6))
            delta = torch.cholesky_solve((-jtr)[:, None], _cholesky(a))[:, 0]
        return retract_window(st, delta.reshape(t, 12)), old_cost

    lam = torch.full((), cfg.lambda_init, dtype=dtype, device=device)
    if not cfg.accept_reject:
        # incremental GN: constant damping, always step; the cost is the
        # one at the last linearization point
        final_cost = torch.zeros((), dtype=dtype, device=device)
        for _ in range(cfg.max_iterations):
            state, final_cost = step(state, lam)
        return state, final_cost

    final_cost = cost(state)
    for _ in range(cfg.max_iterations):
        new_state, old_cost = step(state, lam)
        new_cost = cost(new_state)
        accept = new_cost < old_cost
        state = WindowState(*(torch.where(accept, n, o) for n, o in zip(new_state, state)))
        lam = torch.clamp(
            torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up),
            cfg.lambda_min,
            cfg.lambda_max,
        )
        final_cost = torch.where(accept, new_cost, old_cost)
    return state, final_cost


class _Params(ctypes.Structure):
    """``csrc/smoother.cu``'s ``Params``, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "rot", "trans", "ang_vel", "vel", "meas", "valid", "fx", "fy", "cx", "cy", "points",
            "prior_rot", "prior_trans", "prior_w", "prior_v", "cam_rot", "cam_trans",
            "out_rot", "out_trans", "out_ang_vel", "out_vel", "out_cost")]
        + [(name, ctypes.c_int) for name in ("t", "k", "vel_body", "robust", "iterations", "accept_reject")]
        + [(name, ctypes.c_float) for name in (
            "dt", "sigma_dyn_rot", "sigma_dyn_trans", "inv_sigma_cw", "inv_sigma_cv", "inv_sigma_kp",
            "inv_sigma_prior_pose", "inv_sigma_prior_vel", "inv_pin", "robust_delta", "inv_robust_delta",
            "lambda_init", "lambda_up", "lambda_down", "lambda_min", "lambda_max")]
    )


def _inv_f32(x: float) -> float:
    """1 / x in f32, as the card computes ``tensor / x`` for a Python float x
    (the f32 reciprocal of x rounded to f32; the double quotient of two f32
    values rounds to the f32 quotient)."""
    return 1.0 / ctypes.c_float(x).value


@functools.lru_cache(maxsize=64)
def _scalars(cfg: SmootherConfig) -> dict:
    """The kernel's launch arguments from the config."""
    if cfg.vel_frame not in ("world", "body"):
        raise ValueError(f"unknown vel_frame {cfg.vel_frame!r}")
    robust = 0
    if cfg.robust_keypoint_delta > 0.0:
        if cfg.robust_kernel not in ("huber", "gm"):
            raise ValueError(f"unknown robust_kernel {cfg.robust_kernel!r}")
        robust = 1 if cfg.robust_kernel == "huber" else 2
    delta = cfg.robust_keypoint_delta
    return dict(
        vel_body=int(cfg.vel_frame == "body"), robust=robust, iterations=cfg.max_iterations,
        accept_reject=int(cfg.accept_reject), dt=cfg.dt, sigma_dyn_rot=cfg.sigma_dynamics_rot,
        sigma_dyn_trans=cfg.sigma_dynamics_trans, inv_sigma_cw=_inv_f32(cfg.sigma_const_ang_vel),
        inv_sigma_cv=_inv_f32(cfg.sigma_const_vel), inv_sigma_kp=_inv_f32(cfg.sigma_keypoint_px),
        inv_sigma_prior_pose=_inv_f32(cfg.sigma_prior_pose), inv_sigma_prior_vel=_inv_f32(cfg.sigma_prior_vel),
        inv_pin=_inv_f32(1e-3), robust_delta=delta, inv_robust_delta=_inv_f32(delta) if delta > 0.0 else 0.0,
        lambda_init=cfg.lambda_init, lambda_up=cfg.lambda_up, lambda_down=cfg.lambda_down,
        lambda_min=cfg.lambda_min, lambda_max=cfg.lambda_max,
    )


@functools.cache
def _kernel():
    """The launch of ``csrc/smoother.cu``, built and loaded at first use, its
    shared-memory attribute set once."""
    lib = _build.load_library("smoother")
    err = lib.perseus_smoother_init()
    if err != 0:
        raise RuntimeError(f"lm_solve_cuda: setting the kernel's shared memory failed, cudaError {err}")
    launch = lib.perseus_smoother_lm_f32
    launch.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return launch


def lm_solve_cuda(
    cfg: SmootherConfig,
    state: WindowState,
    measurements: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: Intrinsics,
    points_body: torch.Tensor,
    prior_pose: SE3,
    prior_ang_vel: torch.Tensor,
    prior_vel: torch.Tensor,
    camera_pose: SE3 | None = None,
) -> tuple[WindowState, torch.Tensor]:
    """:func:`lm_solve_reference` with the "jacfwd" solver as one launch of
    ``csrc/smoother.cu`` on a float32 CUDA window: every iteration in one
    thread block, with the config's settings as launch arguments (any
    window size whose arrays fit a block's shared memory, any number of
    corners and iterations, accept/reject or not). Raises for any other
    device or dtype, or a window too large."""
    name = "lm_solve_cuda"
    dev = state.trans.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if state.trans.dtype != torch.float32:
        raise TypeError(f"{name}: window dtype {state.trans.dtype} (the kernel takes float32)")
    t, k = state.rot.shape[0], points_body.shape[0]
    if (state.rot.shape != (t, 3, 3) or any(x.shape != (t, 3) for x in state[1:]) or points_body.shape != (k, 3)
            or measurements.shape != (t, k, 2) or valid.shape != (t,)):
        raise ValueError(f"{name}: a window of {t} frames and {k} corners takes rot (T, 3, 3), trans, ang_vel, "
                         f"vel (T, 3), measurements (T, K, 2), valid (T,), points_body (K, 3)")
    scalars = _scalars(cfg)
    launch = _kernel()

    def f32(x: torch.Tensor) -> torch.Tensor:
        return x.to(dev, torch.float32).contiguous()

    ins = dict(
        rot=f32(state.rot), trans=f32(state.trans), ang_vel=f32(state.ang_vel), vel=f32(state.vel),
        meas=f32(measurements), valid=f32(valid), fx=f32(intrinsics.fx), fy=f32(intrinsics.fy),
        cx=f32(intrinsics.cx), cy=f32(intrinsics.cy), points=f32(points_body), prior_rot=f32(prior_pose.rot),
        prior_trans=f32(prior_pose.trans), prior_w=f32(prior_ang_vel), prior_v=f32(prior_vel),
    )
    if camera_pose is not None:
        ins.update(cam_rot=f32(camera_pose.rot), cam_trans=f32(camera_pose.trans))
    out = WindowState(*(torch.empty_like(ins[key]) for key in ("rot", "trans", "ang_vel", "vel")))
    cost = torch.empty((), dtype=torch.float32, device=dev)
    params = _Params(
        **{key: x.data_ptr() for key, x in ins.items()},
        out_rot=out.rot.data_ptr(), out_trans=out.trans.data_ptr(), out_ang_vel=out.ang_vel.data_ptr(),
        out_vel=out.vel.data_ptr(), out_cost=cost.data_ptr(), t=t, k=k, **scalars,
    )
    with torch.cuda.device(dev):
        err = launch(ctypes.byref(params), torch.cuda.current_stream(dev).cuda_stream)
    if err == 1:  # cudaErrorInvalidValue: the entry launched nothing
        raise ValueError(f"{name}: a window of {t} frames and {k} corners needs more shared memory than a block "
                         f"has (227 KB)")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    lm_solve_cuda.launches += 1
    return out, cost


# the count of the kernel's launches, added to right after a launch
lm_solve_cuda.launches = 0


def predict_next(state: WindowState, dt: float, vel_frame: str = "world") -> tuple[SE3, torch.Tensor, torch.Tensor]:
    """Euler exp-map propagation of the newest frame (for window extension)."""
    last = SE3(state.rot[-1], state.trans[-1])
    w = state.ang_vel[-1]
    v = state.vel[-1]
    v_body = matvec(last.rot.T, v) if vel_frame == "world" else v
    xi = dt * torch.cat([w, v_body])
    return se3_compose(last, se3_exp(xi)), w, v
