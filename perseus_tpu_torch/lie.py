"""SO(3)/SE(3) Lie group operations with analytic Jacobians, in PyTorch.

Port of ``perseus_tpu/lie.py``, every public name of it. Same
conventions: twists ``xi = [omega; v]``, Jacobians with respect to right
perturbations, ``se3_exp`` the true SE(3) exponential. Every function
broadcasts over leading batch dimensions and is safe under ``torch.func``
transforms (no in-place writes, no host reads). Small-angle cases keep the
JAX package's double-``where`` form: both branches are evaluated, the exact
one at a "safe" angle, so derivatives stay finite where it is not selected.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "SE3",
    "matvec",
    "skew",
    "unskew",
    "so3_exp",
    "so3_log",
    "so3_left_jacobian",
    "so3_right_jacobian",
    "so3_left_jacobian_inverse",
    "so3_right_jacobian_inverse",
    "rot_to_quat_wxyz",
    "quat_wxyz_to_rot",
    "quat_xyzw_to_rot",
    "rot_to_quat_xyzw",
    "euler_xyz_to_rot",
    "se3_identity",
    "se3_exp",
    "se3_log",
    "se3_compose",
    "se3_inverse",
    "se3_between",
    "se3_adjoint",
    "se3_left_jacobian",
    "se3_right_jacobian",
    "se3_right_jacobian_inverse",
    "se3_logmap_derivative",
    "se3_retract",
    "transform_from",
    "transform_from_jacobians",
    "transform_to",
    "transform_to_jacobians",
    "pose7_wxyz_to_se3",
    "se3_to_pose7_wxyz",
    "pose7_xyzw_to_se3",
]

_EPS2 = 1e-8  # threshold on theta^2 below which Taylor branches are used


class SE3(NamedTuple):
    """A rigid transform: ``x_world = rot @ x_body + trans``."""

    rot: torch.Tensor  # (..., 3, 3)
    trans: torch.Tensor  # (..., 3)


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _eye3_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def skew(w: torch.Tensor) -> torch.Tensor:
    """Hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def unskew(m: torch.Tensor) -> torch.Tensor:
    """Vee operator: extracts (..., 3) from a skew-symmetric (..., 3, 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _coeffs(theta2: torch.Tensor):
    """Returns (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    small = theta2 < _EPS2
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0, torch.sin(t) / t)
    b = torch.where(
        small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0, (1.0 - torch.cos(t)) / safe_t2
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
        (t - torch.sin(t)) / (safe_t2 * t),
    )
    return a, b, c


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) via Rodrigues' formula."""
    theta2 = torch.sum(omega * omega, dim=-1)
    a, b, _ = _coeffs(theta2)
    w = skew(omega)
    w2 = w @ w
    return _eye3_like(omega, w.shape) + a[..., None, None] * w + b[..., None, None] * w2


def rot_to_quat_wxyz(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z], branchless (Shepperd),
    canonical sign w >= 0."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    t0 = 1.0 + m00 + m11 + m22
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22

    q0 = torch.stack([t0, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, t1, m10 + m01, m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m10 + m01, t2, m21 + m12], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m21 + m12, t3], dim=-1)

    ts = torch.stack([t0, t1, t2, t3], dim=-1)  # (..., 4)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    idx = torch.argmax(ts, dim=-1)
    onehot = (torch.arange(4, device=r.device) == idx[..., None]).to(r.dtype)
    q = torch.sum(qs * onehot[..., None], dim=-2)
    t_sel = torch.sum(ts * onehot, dim=-1)
    q = q / (2.0 * torch.sqrt(torch.clamp_min(t_sel, 1e-12)))[..., None]
    q = torch.where(q[..., 0:1] < 0.0, -q, q)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_wxyz_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w, x, y, z] -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def quat_xyzw_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [x, y, z, w] (pypose/scipy order) -> rotation matrix."""
    return quat_wxyz_to_rot(torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1))


def rot_to_quat_xyzw(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [x, y, z, w]."""
    q = rot_to_quat_wxyz(r)
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def euler_xyz_to_rot(euler: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ Euler angles -> rotation matrix: R = Rx @ Ry @ Rz
    (pypose.euler2SO3's convention, which the Blender -> OpenCV camera
    conversion uses)."""
    cx, sx = torch.cos(euler[..., 0]), torch.sin(euler[..., 0])
    cy, sy = torch.cos(euler[..., 1]), torch.sin(euler[..., 1])
    cz, sz = torch.cos(euler[..., 2]), torch.sin(euler[..., 2])
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    mx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    my = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    mz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return mx @ my @ mz


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3) via the quaternion route (robust near pi)."""
    q = rot_to_quat_wxyz(r)
    w = q[..., 0]
    v = q[..., 1:4]
    nv2 = torch.sum(v * v, dim=-1)
    small = nv2 < _EPS2
    safe_nv = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    theta = 2.0 * torch.atan2(safe_nv, w)
    scale_exact = theta / safe_nv
    safe_w = torch.where(torch.abs(w) < 1e-6, torch.ones_like(w), w)
    scale_taylor = (2.0 / safe_w) * (1.0 - nv2 / (3.0 * safe_w * safe_w))
    scale = torch.where(small, scale_taylor, scale_exact)
    return scale[..., None] * v


def so3_left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): Jl = I + B*w^ + C*w^2."""
    theta2 = torch.sum(omega * omega, dim=-1)
    _, b, c = _coeffs(theta2)
    w = skew(omega)
    w2 = w @ w
    return _eye3_like(omega, w.shape) + b[..., None, None] * w + c[..., None, None] * w2


def so3_right_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3): Jr(w) = Jl(-w)."""
    return so3_left_jacobian(-omega)


def so3_left_jacobian_inverse(omega: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian: Jl^-1 = I - w^/2 + D*w^2."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < _EPS2
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(safe_t2)
    half_t = 0.5 * t
    d_exact = 1.0 / safe_t2 - 0.5 * torch.cos(half_t) / (t * torch.sin(half_t))
    d_taylor = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    d = torch.where(small, d_taylor, d_exact)
    w = skew(omega)
    w2 = w @ w
    return _eye3_like(omega, w.shape) - 0.5 * w + d[..., None, None] * w2


def so3_right_jacobian_inverse(omega: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian: Jr^-1(w) = Jl^-1(-w)."""
    return so3_left_jacobian_inverse(-omega)


def se3_identity(
    dtype: torch.dtype = torch.float32, device: torch.device | str = "cpu", batch_shape: tuple = ()
) -> SE3:
    """Identity transform, optionally batched."""
    rot = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    trans = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return SE3(rot, trans)


def se3_exp(xi: torch.Tensor) -> SE3:
    """SE(3) exponential of a twist [omega; v]: R = exp(w^), t = Jl(w) v."""
    omega = xi[..., :3]
    v = xi[..., 3:]
    return SE3(so3_exp(omega), matvec(so3_left_jacobian(omega), v))


def se3_log(t: SE3) -> torch.Tensor:
    """SE(3) logarithm -> twist [omega; v]."""
    omega = so3_log(t.rot)
    v = matvec(so3_left_jacobian_inverse(omega), t.trans)
    return torch.cat([omega, v], dim=-1)


def se3_compose(a: SE3, b: SE3) -> SE3:
    """a . b (apply b first in the body frame of a)."""
    return SE3(a.rot @ b.rot, matvec(a.rot, b.trans) + a.trans)


def se3_inverse(t: SE3) -> SE3:
    rot_t = t.rot.transpose(-1, -2)
    return SE3(rot_t, -matvec(rot_t, t.trans))


def se3_between(a: SE3, b: SE3) -> SE3:
    """a^-1 . b."""
    return se3_compose(se3_inverse(a), b)


def se3_adjoint(t: SE3) -> torch.Tensor:
    """Adjoint (..., 6, 6) in [omega; v] ordering: [[R, 0], [t^ R, R]]."""
    r = t.rot
    tr = skew(t.trans) @ r
    r = r.expand(tr.shape)
    zero = torch.zeros_like(r)
    top = torch.cat([r, zero], dim=-1)
    bot = torch.cat([tr, r], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _se3_q_matrix(xi: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q matrix (translation-block coupling of the SE(3) left
    Jacobian) in the [omega; v] ordering."""
    omega = xi[..., :3]
    v = xi[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < _EPS2
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(safe_t2)
    sin_t, cos_t = torch.sin(t), torch.cos(t)

    c1 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - sin_t) / (safe_t2 * t))
    c2 = torch.where(
        small,
        -1.0 / 24.0 + theta2 / 720.0,
        (1.0 - 0.5 * safe_t2 - cos_t) / (safe_t2 * safe_t2),
    )
    c3 = torch.where(
        small,
        -1.0 / 120.0 + theta2 / 5040.0,
        (t - sin_t - t * safe_t2 / 6.0) / (safe_t2 * safe_t2 * t),
    )

    w = skew(omega)
    vv = skew(v)
    wv = w @ vv
    vw = vv @ w
    wvw = wv @ w
    w2 = w @ w
    return (
        0.5 * vv
        + c1[..., None, None] * (wv + vw + w @ vw)
        - c2[..., None, None] * (w2 @ vv + vv @ w2 - 3.0 * w @ vw)
        - 0.5 * (c2 - 3.0 * c3)[..., None, None] * (wvw @ w + w @ wvw)
    )


def se3_left_jacobian(xi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SE(3) (..., 6, 6) in [omega; v] ordering."""
    jl = so3_left_jacobian(xi[..., :3])
    q = _se3_q_matrix(xi)
    zero = torch.zeros_like(jl)
    top = torch.cat([jl, zero], dim=-1)
    bot = torch.cat([q, jl], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_right_jacobian(xi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SE(3): Jr(xi) = Jl(-xi) (GTSAM's ExpmapDerivative)."""
    return se3_left_jacobian(-xi)


def se3_right_jacobian_inverse(xi: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of the SE(3) right Jacobian by block inversion."""
    jr_inv = so3_right_jacobian_inverse(xi[..., :3])
    q_r = _se3_q_matrix(-xi)
    bl = -jr_inv @ q_r @ jr_inv
    zero = torch.zeros_like(jr_inv)
    top = torch.cat([jr_inv, zero], dim=-1)
    bot = torch.cat([bl, jr_inv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_logmap_derivative(t: SE3) -> torch.Tensor:
    """d Log(T . Exp(delta)) / d delta at delta=0, i.e. Jr^-1(Log(T))."""
    return se3_right_jacobian_inverse(se3_log(t))


def se3_retract(t: SE3, delta: torch.Tensor) -> SE3:
    """Right-retract a tangent perturbation: T . Exp(delta)."""
    return se3_compose(t, se3_exp(delta))


def transform_from(t: SE3, p: torch.Tensor) -> torch.Tensor:
    """Body -> world: R p + t."""
    return matvec(t.rot, p) + t.trans


def transform_from_jacobians(t: SE3, p: torch.Tensor):
    """Returns (p_world, d/dpose (..., 3, 6), d/dpoint (..., 3, 3)); the
    pose Jacobian is d/domega = -R [p]^, d/dv = R."""
    pw = transform_from(t, p)
    d_omega = -t.rot @ skew(p)
    rot = t.rot.expand(d_omega.shape)
    return pw, torch.cat([d_omega, rot], dim=-1), rot


def transform_to(t: SE3, p: torch.Tensor) -> torch.Tensor:
    """World -> body: R^T (p - t)."""
    return matvec(t.rot.transpose(-1, -2), p - t.trans)


def transform_to_jacobians(t: SE3, p: torch.Tensor):
    """Returns (p_body, d/dpose (..., 3, 6), d/dpoint (..., 3, 3)):
    d/domega = [p_body]^, d/dv = -I, d/dpoint = R^T."""
    pb = transform_to(t, p)
    s = skew(pb)
    d_pose = torch.cat([s, -_eye3_like(pb, s.shape)], dim=-1)
    return pb, d_pose, t.rot.transpose(-1, -2).expand(s.shape)


# 7-vector pose layouts (dataset / kubric metadata)


def pose7_wxyz_to_se3(pose7: torch.Tensor) -> SE3:
    """[x y z qw qx qy qz] (kubric metadata order) -> SE3."""
    return SE3(quat_wxyz_to_rot(pose7[..., 3:7]), pose7[..., :3])


def se3_to_pose7_wxyz(t: SE3) -> torch.Tensor:
    return torch.cat([t.trans, rot_to_quat_wxyz(t.rot)], dim=-1)


def pose7_xyzw_to_se3(pose7: torch.Tensor) -> SE3:
    """[x y z qx qy qz qw] (pypose order) -> SE3."""
    return SE3(quat_xyzw_to_rot(pose7[..., 3:7]), pose7[..., :3])
