"""Port parity: Lie group, camera and smoother residual math
(perseus_tpu_torch/{lie,camera}.py, smoother/residuals.py).

The same numpy inputs, in float64, go through each JAX function and its
port; closed-form math agrees to 1e-10 (1e-12 for the camera, exactly for
the constant-velocity factor). The window solves are in test_torch_smoother.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu import camera as jcam
from perseus_tpu import lie as jlie
from perseus_tpu.smoother import residuals as jres
from perseus_tpu_torch import camera as tcam
from perseus_tpu_torch import lie as tlie
from perseus_tpu_torch.smoother import residuals as tres

F64 = np.float64
DT = 0.1


def _j(x):
    return jnp.asarray(np.asarray(x, F64))


def _t(x):
    return torch.tensor(np.asarray(x, F64))


def _close(port, ref, atol, msg=""):
    if isinstance(port, tuple):
        for p, r in zip(port, ref):
            _close(p, r, atol, msg)
        return
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0, err_msg=msg)


def _twists():
    """Random twists plus the small-angle and near-pi branches."""
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(6, 6))
    xi[1, :3] = 1e-6 * rng.normal(size=3)  # Taylor branch
    xi[2, :3] = 0.0
    axis = rng.normal(size=3)
    xi[3, :3] = (np.pi - 1e-4) * axis / np.linalg.norm(axis)  # near pi
    return xi


@pytest.mark.parametrize(
    "name",
    [
        "se3_exp", "se3_log", "se3_compose", "se3_between", "se3_adjoint",
        "se3_right_jacobian", "se3_right_jacobian_inverse", "se3_logmap_derivative",
        "so3_right_jacobian_inverse", "transform_from_jacobians", "transform_to_jacobians",
    ],
)
def test_lie_matches_jax(name):
    xi = _twists()
    rng = np.random.default_rng(1)
    pj, pt = jlie.se3_exp(_j(xi)), tlie.se3_exp(_t(xi))
    qj, qt = jlie.se3_exp(_j(xi[::-1].copy())), tlie.se3_exp(_t(xi[::-1].copy()))
    pts = rng.normal(size=(6, 3))
    cases = {
        "se3_exp": lambda m: m.se3_exp(_j(xi) if m is jlie else _t(xi)),
        "se3_log": lambda m: m.se3_log(pj if m is jlie else pt),
        "se3_compose": lambda m: m.se3_compose(*((pj, qj) if m is jlie else (pt, qt))),
        "se3_between": lambda m: m.se3_between(*((pj, qj) if m is jlie else (pt, qt))),
        "se3_adjoint": lambda m: m.se3_adjoint(pj if m is jlie else pt),
        "se3_right_jacobian": lambda m: m.se3_right_jacobian(_j(xi) if m is jlie else _t(xi)),
        "se3_right_jacobian_inverse": lambda m: m.se3_right_jacobian_inverse(_j(xi) if m is jlie else _t(xi)),
        "se3_logmap_derivative": lambda m: m.se3_logmap_derivative(pj if m is jlie else pt),
        "so3_right_jacobian_inverse": lambda m: m.so3_right_jacobian_inverse(
            _j(xi[:, :3]) if m is jlie else _t(xi[:, :3])
        ),
        "transform_from_jacobians": lambda m: m.transform_from_jacobians(
            *((pj, _j(pts)) if m is jlie else (pt, _t(pts)))
        ),
        "transform_to_jacobians": lambda m: m.transform_to_jacobians(
            *((pj, _j(pts)) if m is jlie else (pt, _t(pts)))
        ),
    }
    _close(cases[name](tlie), cases[name](jlie), 1e-10, name)


@pytest.mark.parametrize("vel_frame", ["world", "body"])
def test_dynamics_residual_and_jacobians_match_jax(vel_frame):
    rng = np.random.default_rng(2)
    x1, x2 = rng.normal(size=6), rng.normal(size=6)
    w1, v1 = rng.normal(size=3), rng.normal(size=3)
    out_j = jres.dynamics_residual_and_jacobians(
        jlie.se3_exp(_j(x1)), _j(w1), _j(v1), jlie.se3_exp(_j(x2)), DT, vel_frame
    )
    out_t = tres.dynamics_residual_and_jacobians(
        tlie.se3_exp(_t(x1)), _t(w1), _t(v1), tlie.se3_exp(_t(x2)), DT, vel_frame
    )
    _close(out_t, out_j, 1e-10)
    r_t = tres.dynamics_residual(tlie.se3_exp(_t(x1)), _t(w1), _t(v1), tlie.se3_exp(_t(x2)), DT, vel_frame)
    _close(r_t, out_j[0], 1e-10)


@pytest.mark.parametrize("with_camera", [False, True], ids=["no_cam", "cam"])
def test_keypoint_projection_and_jacobian_match_jax(with_camera):
    rng = np.random.default_rng(3)
    rot_vec, trans = np.array([0.2, -0.1, 0.3]), np.array([0.05, -0.02, 0.3])
    point, meas = np.array([0.02, -0.02, 0.02]), np.array([120.0, 130.0])
    cam = rng.normal(size=6) * 0.1 if with_camera else None
    kj = jcam.Intrinsics(*(_j(128.0) for _ in range(4)))
    kt = tcam.Intrinsics(*(_t(128.0) for _ in range(4)))
    bj = jlie.SE3(jlie.so3_exp(_j(rot_vec)), _j(trans))
    bt = tlie.SE3(tlie.so3_exp(_t(rot_vec)), _t(trans))
    cj = None if cam is None else jlie.se3_exp(_j(cam))
    ct = None if cam is None else tlie.se3_exp(_t(cam))
    out_j = jres.keypoint_projection_residual_and_jacobian(bj, kj, _j(meas), _j(point), cj)
    out_t = tres.keypoint_projection_residual_and_jacobian(bt, kt, _t(meas), _t(point), ct)
    _close(out_t, out_j, 1e-10)
    _close(tres.keypoint_projection_residual(bt, kt, _t(meas), _t(point), ct), out_j[0], 1e-10)


def test_constant_velocity_matches_jax():
    rng = np.random.default_rng(6)
    v1, v2 = rng.normal(size=3), rng.normal(size=3)
    _close(tres.constant_velocity_residual(_t(v1), _t(v2)), jres.constant_velocity_residual(_j(v1), _j(v2)), 0)
    _close(
        tres.constant_velocity_jacobians(dtype=torch.float64),
        jres.constant_velocity_jacobians(dtype=jnp.float64),
        0,
    )


@pytest.mark.parametrize(
    "name", ["normalize", "denormalize", "intrinsics_from_fov", "project", "project_jacobians", "center_crop_hw"]
)
def test_camera_matches_jax(name):
    rng = np.random.default_rng(7)
    coords = rng.uniform(0, 63, (5, 8, 2))
    p_cam = rng.normal(size=(5, 3)) * 0.05 + [0.0, 0.0, 0.4]
    image = rng.normal(size=(2, 11, 14, 4))
    cases = {
        "normalize": lambda m, c: m.normalize_pixel_coordinates(c(coords), 48, 64),
        "denormalize": lambda m, c: m.denormalize_pixel_coordinates(c(coords), 48, 64),
        "intrinsics_from_fov": lambda m, c: tuple(m.intrinsics_from_fov(c(1.1), 48, 64)),
        "project": lambda m, c: m.project(m.intrinsics_from_fov(c(1.1), 48, 64), c(p_cam)),
        "project_jacobians": lambda m, c: m.project_jacobians(m.intrinsics_from_fov(c(1.1), 48, 64), c(p_cam)),
        "center_crop_hw": lambda m, c: m.center_crop_hw(c(image), 6, 9),
    }
    _close(cases[name](tcam, _t), cases[name](jcam, _j), 1e-12, name)


def test_unskew_matches_jax():
    """The vee operator on random skew matrices (and a batch of them):
    exact, and the inverse of ``skew``."""
    w = np.random.default_rng(8).normal(size=(2, 5, 3))
    m = np.asarray(jlie.skew(_j(w)))
    _close(tlie.unskew(_t(m)), jlie.unskew(_j(m)), 0)
    _close(tlie.unskew(tlie.skew(_t(w))), w, 0)
