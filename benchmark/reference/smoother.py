"""Plain fixed-lag smoother update: the yardstick of the serving smoother.

One update of a sliding window of T poses (rotation, translation) with
body angular and world linear velocities, as the configuration states it:
shift the window (the oldest frame becomes the prior's anchor once it has
an estimate), predict the new frame by an Euler exp-map step, gate the new
detection by its median reprojection innovation (reject, or after
``gate_max_consec`` rejections reset the window from the closed-form
weak-perspective pose), then ``max_iterations`` damped Gauss-Newton steps on
the whitened residual stack:

  prior on frame 0   Log(prior^-1 x_0) / s_prior_pose, (w_0 - w_p) / s_prior_vel, (v_0 - v_p) / s_prior_vel
  dynamics (i, i+1)  Log((x_i Exp(dt [w_i; R_i^T v_i]))^-1 x_{i+1}) / s_dyn
  constant velocity  (w_{i+1} - w_i) / s_const_ang_vel, (v_{i+1} - v_i) / s_const_vel
  keypoints          (project(R_i p_k + t_i) - z_ik) / s_px, Huber-weighted (weights fixed per step)
  pins               frames without a detection held at the pre-solve window, / 1e-3

with each pair term masked by both frames' validity and each keypoint term
by its frame's. The tangent of a frame is [pose (6, right-perturbed: x
Exp(d)) | w (3) | v (3)]; SE(3) twists are [omega; v] with the left
Jacobian on v (GTSAM's Pose3). The Jacobian is taken by forward-mode
differentiation of that stack; each step solves (J^T J + lambda diag(J^T
J)) d = -J^T r. Written from these equations in plain torch, for any dtype
and device (float64 is the yardstick; float32 under TF32 the control).

A carry is a dict of tensors: ``rot`` (T, 3, 3), ``trans``, ``ang_vel``,
``vel`` (T, 3), ``measurements`` (T, K, 2), ``valid`` (T,), ``prior_rot``,
``prior_trans``, ``prior_ang_vel``, ``prior_vel``, ``frames_seen``,
``consec_rejects``.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.pipeline import matmul_precision

_SMALL = 1e-12


def skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], z, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], z], -1),
        ],
        -2,
    )


def _eye(x, shape):
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(*shape, 3, 3)


def _abc(th2):
    """sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3, series near 0."""
    small = th2 < _SMALL
    s2 = torch.where(small, torch.ones_like(th2), th2)
    t = torch.sqrt(s2)
    a = torch.where(small, 1 - th2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(t)) / s2)
    c = torch.where(small, 1 / 6 - th2 / 120, (t - torch.sin(t)) / (s2 * t))
    return a, b, c


def so3_exp(w):
    th2 = (w * w).sum(-1)
    a, b, _ = _abc(th2)
    k = skew(w)
    return _eye(w, w.shape[:-1]) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def left_jacobian(w):
    th2 = (w * w).sum(-1)
    _, b, c = _abc(th2)
    k = skew(w)
    return _eye(w, w.shape[:-1]) + b[..., None, None] * k + c[..., None, None] * (k @ k)


def left_jacobian_inverse(w):
    th2 = (w * w).sum(-1)
    small = th2 < _SMALL
    s2 = torch.where(small, torch.ones_like(th2), th2)
    t = torch.sqrt(s2)
    d = torch.where(small, 1 / 12 + th2 / 720, 1 / s2 - (1 + torch.cos(t)) / (2 * t * torch.sin(t)))
    k = skew(w)
    return _eye(w, w.shape[:-1]) - 0.5 * k + d[..., None, None] * (k @ k)


def so3_log(r):
    """Rotation angle below pi/2 assumed where the series is taken."""
    s = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]], -1)
    c = 0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1)
    n2 = (s * s).sum(-1)
    small = n2 < _SMALL
    sn = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    scale = torch.where(small, 1 + n2 / 6, torch.atan2(sn, c) / sn)
    return scale[..., None] * s


def mv(m, v):
    return (m @ v[..., None])[..., 0]


def se3_exp(xi):
    return so3_exp(xi[..., :3]), mv(left_jacobian(xi[..., :3]), xi[..., 3:])


def se3_log(rot, trans):
    w = so3_log(rot)
    return torch.cat([w, mv(left_jacobian_inverse(w), trans)], -1)


def compose(ra, ta, rb, tb):
    return ra @ rb, mv(ra, tb) + ta


def between(ra, ta, rb, tb):
    """a^-1 b."""
    rat = ra.transpose(-1, -2)
    return rat @ rb, mv(rat, tb - ta)


def project(rot, trans, corners, k):
    """(..., K, 2) pixels of the corners under the poses (..., 3, 3), (..., 3)."""
    p = (rot[..., None, :, :] @ corners[..., None])[..., 0] + trans[..., None, :]
    fx, fy, cx, cy = k
    return torch.stack([fx * p[..., 0] / p[..., 2] + cx, fy * p[..., 1] / p[..., 2] + cy], -1)


def median(x):
    s = torch.sort(x).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def coarse_pose(kp, corners, k):
    """Weak-perspective closed-form pose of one frame of detections (the
    reset's seed): rotation rows from the least-squares fit to the centred
    corners scaled by 1/z0, Gram-Schmidt, translation at that depth."""
    fx, fy, cx, cy = k
    centre = kp.mean(0)
    pinv = torch.linalg.pinv(corners - corners.mean(0))
    r1, r2 = pinv @ ((kp[:, 0] - centre[0]) / fx), pinv @ ((kp[:, 1] - centre[1]) / fy)
    n1, n2 = torch.linalg.vector_norm(r1), torch.linalg.vector_norm(r2)
    z0 = torch.clamp(1 / torch.clamp_min(0.5 * (n1 + n2), 1e-8), 0.1, 1e4)
    a = r1 / torch.clamp_min(n1, 1e-8)
    b = r2 - torch.dot(a, r2) * a
    bn = torch.linalg.vector_norm(b)
    e = torch.eye(3, dtype=kp.dtype, device=kp.device)
    alt = torch.linalg.cross(a, e[0] if abs(float(a[0])) < 0.9 else e[1])
    b = b / torch.clamp_min(bn, 1e-8) if float(bn) > 1e-6 else alt / torch.linalg.vector_norm(alt)
    rot = torch.stack([a, b, torch.linalg.cross(a, b)])
    trans = torch.stack([(centre[0] - cx) / fx * z0, (centre[1] - cy) / fy * z0, z0])
    return rot, trans


def _residuals(cfg, st, meas, valid, corners, k, prior, anchor):
    rot, trans, w, v = st
    p_rot, p_trans, p_w, p_v = prior
    r_prior = torch.cat(
        [
            # frame 0 as a batch of one: under forward-mode differentiation a
            # Python number times a 0-dim tensor gives a float64 tangent
            se3_log(*between(p_rot, p_trans, rot[:1], trans[:1]))[0] / cfg["sigma_prior_pose"],
            (w[0] - p_w) / cfg["sigma_prior_vel"],
            (v[0] - p_v) / cfg["sigma_prior_vel"],
        ]
    )
    pv = (valid[:-1] * valid[1:])[:, None]
    v_body = mv(rot[:-1].transpose(-1, -2), v[:-1])
    e_rot, e_trans = se3_exp(cfg["dt"] * torch.cat([w[:-1], v_body], -1))
    pr, pt = compose(rot[:-1], trans[:-1], e_rot, e_trans)
    sig = torch.tensor([cfg["sigma_dynamics_rot"]] * 3 + [cfg["sigma_dynamics_trans"]] * 3, dtype=rot.dtype, device=rot.device)
    r_dyn = se3_log(*between(pr, pt, rot[1:], trans[1:])) / sig * pv
    r_cw = (w[1:] - w[:-1]) / cfg["sigma_const_ang_vel"] * pv
    r_cv = (v[1:] - v[:-1]) / cfg["sigma_const_vel"] * pv
    r_kp = (project(rot, trans, corners, k) - meas) / cfg["sigma_keypoint_px"] * valid[:, None, None]
    delta = cfg["robust_keypoint_delta"]
    if delta > 0:
        norm = torch.sqrt((r_kp * r_kp).sum(-1, keepdim=True) + 1e-12)
        if cfg["robust_kernel"] == "huber":
            wt = torch.clamp_max(delta / norm, 1.0)
        else:  # Geman-McClure
            wt = 1 / (1 + (norm / delta) ** 2) ** 2
        r_kp = r_kp * torch.sqrt(wt).detach()
    a_rot, a_trans, a_w, a_v = anchor
    r_pin = torch.cat([se3_log(*between(a_rot, a_trans, rot, trans)), w - a_w, v - a_v], -1) * (1 - valid)[:, None] / 1e-3
    return torch.cat([r_prior, r_dyn.reshape(-1), r_cw.reshape(-1), r_cv.reshape(-1), r_kp.reshape(-1), r_pin.reshape(-1)])


def _retract(st, d):
    rot, trans, w, v = st
    e_rot, e_trans = se3_exp(d[:, :6])
    r, t = compose(rot, trans, e_rot, e_trans)
    return r, t, w + d[:, 6:9], v + d[:, 9:12]


def _solve(cfg, st, meas, valid, corners, k, prior):
    """``max_iterations`` damped Gauss-Newton steps; with ``accept_reject``
    a step that does not lower the cost is undone and the damping raised."""
    t = st[0].shape[0]
    anchor = st
    zero = torch.zeros(12 * t, dtype=st[1].dtype, device=st[1].device)

    def res(d, s):
        return _residuals(cfg, _retract(s, d.reshape(t, 12)), meas, valid, corners, k, prior, anchor)

    def step(s, lam):
        jac = torch.func.jacfwd(res)(zero, s)
        r = res(zero, s)
        jtj = jac.T @ jac
        a = jtj + lam * torch.diag(torch.clamp_min(torch.diagonal(jtj), 1e-6))
        d = torch.linalg.solve(a, -(jac.T @ r))
        return _retract(s, d.reshape(t, 12)), 0.5 * torch.dot(r, r)

    lam = cfg["lambda_init"]
    for _ in range(cfg["max_iterations"]):
        new, old_cost = step(st, lam)
        if not cfg["accept_reject"]:
            st = new
            continue
        r = res(zero, new)
        if 0.5 * float(torch.dot(r, r)) < float(old_cost):
            st, lam = new, max(lam * cfg["lambda_down"], cfg["lambda_min"])
        else:
            lam = min(lam * cfg["lambda_up"], cfg["lambda_max"])
    return st


def update(cfg: dict, carry: dict, kp: torch.Tensor, corners: torch.Tensor, k: tuple, tf32: bool = False):
    """One frame's update: (new carry, (rotation, translation) of the newest
    frame). ``cfg`` holds the smoother's settings by the configuration's
    names; ``kp`` (K, 2) pixels; ``corners`` (K, 3) metres; ``k`` (fx, fy,
    cx, cy); all tensors in the dtype to compute in."""
    if cfg["vel_frame"] != "world":
        raise ValueError("the reference implements world-frame velocities")
    c = carry
    has_est = bool(c["valid"][1] > 0.5)
    prior = tuple(c[f][1] if has_est else c[f"prior_{f}"] for f in ("rot", "trans", "ang_vel", "vel"))
    rot, trans, w, v = c["rot"], c["trans"], c["ang_vel"], c["vel"]
    e_rot, e_trans = se3_exp(cfg["dt"] * torch.cat([w[-1], mv(rot[-1].T, v[-1])]))
    pred_rot, pred_trans = compose(rot[-1], trans[-1], e_rot, e_trans)
    st = (
        torch.cat([rot[1:], pred_rot[None]]),
        torch.cat([trans[1:], pred_trans[None]]),
        torch.cat([w[1:], w[-1:]]),
        torch.cat([v[1:], v[-1:]]),
    )
    meas = torch.cat([c["measurements"][1:], kp[None]])
    accept, consec, reset = 1.0, 0, False
    frames_seen, rejects = int(c["frames_seen"]), int(c["consec_rejects"])
    if cfg["gate_px"] > 0:
        def innovation(r_, t_):
            return median(torch.linalg.vector_norm(project(r_, t_, corners, k) - kp, dim=-1))

        med = min(float(innovation(pred_rot, pred_trans)), float(innovation(rot[-1], trans[-1])))
        disagree = frames_seen >= cfg["gate_min_frames"] and med > cfg["gate_px"]
        force = rejects >= cfg["gate_max_consec"]
        reset = disagree and force
        if disagree and not force:
            accept, consec = 0.0, rejects + 1
    valid = torch.cat([c["valid"][1:], torch.full((1,), accept, dtype=kp.dtype, device=kp.device)])
    if reset:
        s_rot, s_trans = coarse_pose(kp, corners, k)
        n = st[0].shape[0]
        st = (s_rot.expand(n, 3, 3).clone(), s_trans.expand(n, 3).clone(), torch.zeros_like(st[2]), torch.zeros_like(st[3]))
        valid = torch.zeros_like(valid)
        valid[-1] = 1.0
        prior = (s_rot, s_trans, torch.zeros_like(prior[2]), torch.zeros_like(prior[3]))
    with matmul_precision(tf32):
        st = _solve(cfg, st, meas, valid, corners, k, prior)
    new = {
        "rot": st[0], "trans": st[1], "ang_vel": st[2], "vel": st[3], "measurements": meas, "valid": valid,
        "prior_rot": prior[0], "prior_trans": prior[1], "prior_ang_vel": prior[2], "prior_vel": prior[3],
        "frames_seen": 1 if reset else frames_seen + 1, "consec_rejects": consec,
    }
    return new, (st[0][-1], st[1][-1])


def intrinsics(fov: float, h: int, w: int) -> tuple:
    """(fx, fy, cx, cy) of a pinhole camera of field of view ``fov``."""
    return w / (2 * math.tan(fov / 2)), h / (2 * math.tan(fov / 2)), w / 2, h / 2
