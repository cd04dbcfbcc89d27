"""Port parity: the fixed-lag LM smoother (perseus_tpu_torch/smoother/).

The same numpy inputs, in float64, go through each JAX function and its
port. Tolerances: 1e-9/1e-7 for the residual stack and normal equations,
1e-10 for the block-tridiagonal solve, 1e-7 for one LM solve (iterative;
both sides factor the same matrices in another summation order), 1e-6 over
a gated multi-frame sequence, where those differences compound through the
window. The Lie/camera/residual math is in test_torch_lie.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu import camera as jcam
from perseus_tpu import lie as jlie
from perseus_tpu.datagen.labeling import cube_corners as j_cube_corners
from perseus_tpu.smoother import lm as jlm
from perseus_tpu.smoother.fixed_lag import FixedLagSmoother as JSmoother
from perseus_tpu_torch import camera as tcam
from perseus_tpu_torch import lie as tlie
from perseus_tpu_torch.datagen.labeling import cube_corners as t_cube_corners
from perseus_tpu_torch.smoother import lm as tlm
from perseus_tpu_torch.smoother.fixed_lag import FixedLagSmoother as TSmoother
from perseus_tpu_torch.smoother.fixed_lag import median


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    the suite runs several test processes side by side on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

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


# ---------------------------------------------------------------- windows


def _simulate(t_frames, noise_px, seed=11):
    """A cube translating + rotating in front of an identity camera (as in
    tests/test_smoother.py), as numpy arrays."""
    rng = np.random.default_rng(seed)
    k = jcam.intrinsics_from_fov(_j(np.pi / 3), 256, 256)
    corners = np.asarray(j_cube_corners(0.035).astype(jnp.float64))
    twist = np.array([0.3, -0.2, 0.4, 0.02, 0.03, -0.01])
    pose = jlie.SE3(jlie.so3_exp(_j([0.1, 0.2, -0.1])), _j([0.02, -0.03, 0.35]))
    rots, transs, meas = [], [], []
    for _ in range(t_frames):
        rots.append(np.asarray(pose.rot))
        transs.append(np.asarray(pose.trans))
        p_world = jlie.transform_from(jlie.SE3(pose.rot[None], pose.trans[None]), _j(corners))
        meas.append(np.asarray(jcam.project(k, p_world)))
        pose = jlie.se3_compose(pose, jlie.se3_exp(DT * _j(twist)))
    meas = np.stack(meas) + noise_px * rng.normal(size=(t_frames, 8, 2))
    return corners, np.stack(rots), np.stack(transs), meas, twist


def _intrinsics():
    fov = np.pi / 3
    return (
        jcam.intrinsics_from_fov(_j(fov), 256, 256),
        tcam.intrinsics_from_fov(_t(fov), 256, 256),
    )


def _window_problem(t=5, seed=4):
    """A perturbed, partly valid window and its factors, numpy."""
    rng = np.random.default_rng(seed)
    corners, rots, transs, meas, twist = _simulate(t, noise_px=1.0)
    pert = rng.normal(size=(t, 6)) * 0.05
    rot0 = np.stack([np.asarray(jlie.se3_retract(jlie.SE3(_j(r), _j(tr)), _j(d)).rot) for r, tr, d in zip(rots, transs, pert)])
    tr0 = np.stack([np.asarray(jlie.se3_retract(jlie.SE3(_j(r), _j(tr)), _j(d)).trans) for r, tr, d in zip(rots, transs, pert)])
    state = (rot0, tr0, rng.normal(size=(t, 3)) * 0.2 + twist[:3], rng.normal(size=(t, 3)) * 0.02 + twist[3:])
    anchor = (rots, transs, np.tile(twist[:3], (t, 1)), np.tile(twist[3:], (t, 1)))
    valid = np.array([0.0, 0.0] + [1.0] * (t - 2))
    cam = rng.normal(size=6) * 0.1
    return dict(
        corners=corners, meas=meas, twist=twist, state=state, anchor=anchor,
        valid=valid, prior=(rots[0], transs[0]), cam=cam,
    )


def _args(side, pb, cfg_kwargs):
    """lm-function argument tuple for one side (jax or torch)."""
    lie, lm, conv = (jlie, jlm, _j) if side == "jax" else (tlie, tlm, _t)
    kj, kt = _intrinsics()
    cfg = lm.SmootherConfig(window=len(pb["valid"]), dt=DT, **cfg_kwargs)
    state = lm.WindowState(*(conv(a) for a in pb["state"]))
    cam = lie.se3_exp(conv(pb["cam"]))
    return cfg, state, conv(pb["meas"]), conv(pb["valid"]), kj if side == "jax" else kt, conv(
        pb["corners"]
    ), lie.SE3(*(conv(a) for a in pb["prior"])), conv(pb["twist"][:3]), conv(pb["twist"][3:]), cam


@pytest.mark.parametrize("vel_frame", ["world", "body"])
def test_window_residuals_and_normal_equations_match_jax(vel_frame):
    pb = _window_problem()
    aj = _args("jax", pb, dict(vel_frame=vel_frame))
    at = _args("torch", pb, dict(vel_frame=vel_frame))
    anc_j = jlm.WindowState(*(_j(a) for a in pb["anchor"]))
    anc_t = tlm.WindowState(*(_t(a) for a in pb["anchor"]))
    _close(
        tlm.window_residuals(*at, anc_t),
        jax.jit(jlm.window_residuals, static_argnums=0)(*aj, anc_j),
        1e-9,
    )
    _close(
        tlm.assemble_normal_equations(*at, anc_t),
        jax.jit(jlm.assemble_normal_equations, static_argnums=0)(*aj, anc_j),
        1e-7,
    )


def test_solve_block_tridiag_matches_jax():
    t, bdim = 7, 12
    rng = np.random.default_rng(3)
    u = rng.normal(size=(t - 1, bdim, bdim)) * 0.3
    d = np.stack([np.eye(bdim) * 10 + rng.normal(size=(bdim, bdim)) for _ in range(t)])
    d = 0.5 * (d + np.swapaxes(d, -1, -2))
    rhs = rng.normal(size=(t, bdim))
    _close(
        tlm.solve_block_tridiag(_t(d), _t(u), _t(rhs)),
        jlm.solve_block_tridiag(_j(d), _j(u), _j(rhs)),
        1e-10,
    )


@pytest.mark.parametrize("solver", ["jacfwd", "block"])
@pytest.mark.parametrize("accept_reject", [True, False], ids=["lm", "gn"])
def test_lm_solve_matches_jax(solver, accept_reject):
    pb = _window_problem(t=4, seed=5)
    kw = dict(vel_frame="body", max_iterations=3 if accept_reject else 2, solver=solver,
              accept_reject=accept_reject)
    sj, cj = jax.jit(jlm.lm_solve, static_argnums=0)(*_args("jax", pb, kw))
    st, ct = tlm.lm_solve(*_args("torch", pb, kw))
    _close(tuple(st), tuple(sj), 1e-7)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-7)


def test_predict_next_matches_jax():
    pb = _window_problem()
    for vf in ("world", "body"):
        out_j = jlm.predict_next(jlm.WindowState(*(_j(a) for a in pb["state"])), DT, vf)
        out_t = tlm.predict_next(tlm.WindowState(*(_t(a) for a in pb["state"])), DT, vf)
        _close((*out_t[0], out_t[1], out_t[2]), (*out_j[0], out_j[1], out_j[2]), 1e-12)


def test_median_averages_the_two_middle_values():
    x = np.array([5.0, 1.0, 4.0, 2.0, 9.0, 3.0, 7.0, 8.0])  # middle pair 4, 5
    assert float(median(_t(x))) == float(jnp.median(_j(x))) == 4.5
    assert float(torch.median(_t(x))) == 4.0  # why the port does not use it
    assert float(median(_t(x[:7]))) == float(jnp.median(_j(x[:7])))


def _smoothers(cfg_kwargs):
    kj, kt = _intrinsics()
    cj = j_cube_corners(0.035).astype(jnp.float64)
    ct = t_cube_corners(0.035, dtype=torch.float64)
    assert torch.equal(ct, _t(np.asarray(cj)))  # same corners, same order
    return (
        JSmoother(jlm.SmootherConfig(**cfg_kwargs), kj, cj, dtype=jnp.float64),
        TSmoother(tlm.SmootherConfig(**cfg_kwargs), kt, ct, dtype=torch.float64),
    )


def test_coarse_pose_matches_jax():
    _, _, _, meas, _ = _simulate(1, noise_px=0.5)
    js, ts = _smoothers(dict(window=6))
    _close(tuple(ts.coarse_pose_from_keypoints(_t(meas[0]))), tuple(js.coarse_pose_from_keypoints(_j(meas[0]))), 1e-10)


def test_fixed_lag_gated_sequence_matches_jax():
    """A stream whose detections re-lock onto a shifted track at frame 7:
    the gate rejects three frames, then resets the window onto the new
    track; both sides take the same gate decisions and agree on every pose."""
    t_frames, window = 13, 6
    _, _, _, meas, _ = _simulate(t_frames, noise_px=0.2)
    meas[7:] += [80.0, -60.0]
    js, ts = _smoothers(
        dict(window=window, dt=DT, vel_frame="body", max_iterations=4, sigma_prior_pose=1.0,
             sigma_prior_vel=10.0, gate_px=30.0, gate_max_consec=3)
    )
    cj = js.init(js.coarse_pose_from_keypoints(_j(meas[0])))
    ct = ts.init(ts.coarse_pose_from_keypoints(_t(meas[0])))
    update = jax.jit(js.update)
    rejects, resets = [], 0
    for i in range(t_frames):
        seen_before = int(cj.frames_seen)
        cj, pj = update(cj, _j(meas[i]))
        ct, pt = ts.update(ct, _t(meas[i]))
        assert int(ct.consec_rejects) == int(cj.consec_rejects), i
        assert int(ct.frames_seen) == int(cj.frames_seen), i
        _close(tuple(pt), tuple(pj), 1e-6, f"frame {i}")
        _close(tuple(ct.window), tuple(cj.window), 1e-6, f"frame {i}")
        rejects.append(int(cj.consec_rejects))
        resets += int(cj.frames_seen) == 1 and seen_before > 0
    assert rejects[7:11] == [1, 2, 3, 0] and resets == 1, (rejects, resets)  # both gate paths ran
