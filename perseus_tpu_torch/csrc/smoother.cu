// The fixed-lag smoother's damped Gauss-Newton / Levenberg-Marquardt solve
// (perseus_tpu_torch/smoother/lm.py::lm_solve, solver "jacfwd") as one
// launch of one thread block: every iteration of one window.
//
//   perseus_smoother_lm_f32  replaces no Pallas kernel: the JAX package jits
//                  the whole smoother update (jax.jit over lm_solve), which
//                  XLA fuses into a few programs. The port's plain version,
//                  lm.py::lm_solve_reference, runs ~7,250 small PyTorch ops
//                  a GN-4 update (vmapped JVPs, a 288x288 GEMM, a dense
//                  Cholesky), each a kernel of its own in the served CUDA
//                  graph; this kernel is one node instead.
//
// Bound. At window T = 24, K = 8 corners, 4 iterations the solve reads and
// writes ~3 KB and needs ~1-2 MFLOP (the Jacobian's 996 forward-mode
// columns, J^T J's band, the block Cholesky): under 0.1 us at the card's
// f32 rate or its memory bandwidth. What bounds it is the dependent chain:
// per iteration T block steps of a 12x12 Cholesky (12 pivots, each a
// square root, a division and an update), two 12-step triangular solves
// and a 12-step back substitution, one after another.
//
// Design. One block of 512 threads; the window, the anchor (the pre-solve
// window that pins unobserved frames), the measurements, the Jacobian's
// nonzero blocks, the residuals and the normal equations' band all stay in
// shared memory (~91 KB at T 24, K 8). Per iteration:
//   1. Residuals and their Jacobian by forward mode, as torch.func.jacfwd
//      computes it, without the columns that it fills with exact zeros: a
//      thread takes one (factor, tangent column) pair (12 columns for the
//      prior, 24 for a dynamics / constant-velocity pair, 6 for a frame's
//      keypoints, 12 for a pin) and evaluates the factor in a dual-number
//      scalar seeded on the retraction x . Exp(d), v + d at d = 0. The Lie
//      and residual code is templated on the scalar, so the plain residual
//      (the cost of accept/reject) and its derivative come from one source;
//      it keeps lie.py's small-angle branches. The keypoints' robust
//      (Huber / Geman-McClure) IRLS weights come from the residual's values
//      and are held constant, as lm.py's _robust_keypoint_weights does.
//   2. J^T J as its T diagonal and T - 1 off-diagonal 12x12 blocks and
//      J^T r (every other entry of jac.T @ jac is an exact zero), the
//      diagonal damped by lambda max(diag, 1e-6).
//   3. Block-Thomas Cholesky and the forward and back substitutions
//      (lm.py::solve_block_tridiag's recursion), in warp 0: lane a holds row
//      a of a block (the factor by shuffles), lanes 0-12 take the 12
//      columns of the coupling block and the right-hand side. This is the
//      dense Cholesky's arithmetic on the band (outside it every entry of
//      the factor is an exact zero). A pivot that is not positive makes the
//      whole step NaN, as lm.py's _cholesky makes the whole factor NaN.
//   4. The retraction, one thread a frame; with accept/reject the cost at
//      the new point, the step taken or not, lambda raised or lowered.
// Everything is f32 (no TF32, no lower precision); sums run in another
// order than the plain version's (cuBLAS, cuSOLVER), so the two agree to
// f32 rounding, not bit for bit. The config's scalars are launch arguments
// and every tensor a device pointer: no host read, so a launch captures
// into a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

// The launch's arguments (lm.py's _Params, field for field); outside the
// unnamed namespace, so that the exported entry keeps external linkage.
struct Params {
  const float *rot, *trans, *ang_vel, *vel;  // (T, 3, 3), (T, 3) x 3
  const float *meas, *valid;                 // (T, K, 2), (T,)
  const float *fx, *fy, *cx, *cy;            // one each
  const float* points;                       // (K, 3)
  const float *prior_rot, *prior_trans, *prior_w, *prior_v;
  const float *cam_rot, *cam_trans;  // null: the camera at the world origin
  float *out_rot, *out_trans, *out_ang_vel, *out_vel, *out_cost;
  int t, k, vel_body, robust, iterations, accept_reject;  // robust: 0 off, 1 huber, 2 gm
  float dt, sigma_dyn_rot, sigma_dyn_trans;
  // reciprocals of the sigmas that lm.py divides by as Python floats
  // (x / s on the card is x * (1 / s) in f32, which PyTorch computes so)
  float inv_sigma_cw, inv_sigma_cv, inv_sigma_kp, inv_sigma_prior_pose, inv_sigma_prior_vel, inv_pin,
      robust_delta, inv_robust_delta;
  float lambda_init, lambda_up, lambda_down, lambda_min, lambda_max;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on Hopper
constexpr int kFrame = 18;        // a frame's state: R (9), t (3), w (3), v (3)

// Offsets (in floats) of every array in shared memory.
struct Layout {
  int x, anchor, xn, meas, valid, pts, misc, jp, jd, jk, jn, rp, rd, rk, rn, d, u, rhs, inv, delta, red, total;
};

__host__ __device__ inline Layout layout(int t, int k) {
  Layout l;
  int o = 0;
  l.x = o, o += t * kFrame;
  l.anchor = o, o += t * kFrame;
  l.xn = o, o += t * kFrame;
  l.meas = o, o += t * k * 2;
  l.valid = o, o += t;
  l.pts = o, o += k * 3;
  l.misc = o, o += 36;  // intrinsics 4, prior 18, camera 12
  l.jp = o, o += 144;
  l.jd = o, o += (t - 1) * 288;
  l.jk = o, o += t * 2 * k * 6;
  l.jn = o, o += t * 144;
  l.rp = o, o += 12;
  l.rd = o, o += (t - 1) * 12;
  l.rk = o, o += t * 2 * k;
  l.rn = o, o += t * 12;
  l.d = o, o += t * 144;
  l.u = o, o += (t - 1) * 144;
  l.rhs = o, o += t * 12;
  l.inv = o, o += t * 12;
  l.delta = o, o += t * 12;
  l.red = o, o += kWarps + 1;
  l.total = o;
  return l;
}

// ---------------------------------------------------------------- scalars

struct Dual {
  float v, d;
  __device__ Dual() {}
  __device__ Dual(float x) : v(x), d(0.f) {}
  __device__ Dual(float x, float dx) : v(x), d(dx) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return Dual(a.v * b.v, a.d * b.v + a.v * b.d); }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
__device__ __forceinline__ Dual operator+(Dual a, float b) { return Dual(a.v + b, a.d); }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return Dual(a + b.v, b.d); }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return Dual(a.v - b, a.d); }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return Dual(a - b.v, -b.d); }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return Dual(a.v * b, a.d * b); }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return Dual(a * b.v, a * b.d); }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return Dual(q, -q * b.d / b.v);
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual sqrt_(Dual x) {
  const float s = sqrtf(x.v);
  return Dual(s, x.d / (2.f * s));
}
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ Dual sin_(Dual x) { return Dual(sinf(x.v), x.d * cosf(x.v)); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ Dual cos_(Dual x) { return Dual(cosf(x.v), -(x.d * sinf(x.v))); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ Dual atan2_(Dual y, Dual x) {
  return Dual(atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v));
}

// ---------------------------------------------------------------- SO(3) / SE(3)
// lie.py's functions on one element, with its branches and its order of
// operations; matrices are row-major 3x3.

constexpr float kEps2 = 1e-8f;  // lie.py's _EPS2

template <class S>
__device__ __forceinline__ void matvec(const S* m, const S* v, S* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = m[3 * i] * v[0] + m[3 * i + 1] * v[1] + m[3 * i + 2] * v[2];
}

template <class S>
__device__ __forceinline__ void matvec_t(const S* m, const S* v, S* out) {  // m^T v
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = m[i] * v[0] + m[3 + i] * v[1] + m[6 + i] * v[2];
}

template <class S>
__device__ __forceinline__ void matmul(const S* a, const S* b, S* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

template <class S>
__device__ __forceinline__ void matmul_tn(const S* a, const S* b, S* out) {  // a^T b
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * i + j] = a[i] * b[j] + a[3 + i] * b[3 + j] + a[6 + i] * b[6 + j];
}

template <class S>
__device__ __forceinline__ void skew(const S* w, S* m) {
  const S zero(0.f);
  m[0] = zero, m[1] = -w[2], m[2] = w[1];
  m[3] = w[2], m[4] = zero, m[5] = -w[0];
  m[6] = -w[1], m[7] = w[0], m[8] = zero;
}

template <class S>
__device__ __forceinline__ S norm2(const S* w) {
  return w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
}

// I + p W + q W^2 with W = skew(w): so3_exp, the left Jacobian, its inverse
template <class S>
__device__ __forceinline__ void rodrigues(const S* w, S p, S q, S* out) {
  S m[9], m2[9];
  skew(w, m);
  matmul(m, m, m2);
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = ((i % 4 == 0 ? 1.f : 0.f) + p * m[i]) + q * m2[i];
}

template <class S>
__device__ __forceinline__ void so3_exp(const S* w, S* r) {
  const S th2 = norm2(w);
  S a, b;
  if (val(th2) < kEps2) {
    a = (1.f - th2 * (1.f / 6.f)) + th2 * th2 * (1.f / 120.f);
    b = (0.5f - th2 * (1.f / 24.f)) + th2 * th2 * (1.f / 720.f);
  } else {
    const S t = sqrt_(th2);
    a = sin_(t) / t;
    b = (1.f - cos_(t)) / th2;
  }
  rodrigues(w, a, b, r);
}

template <class S>
__device__ __forceinline__ void so3_left_jacobian(const S* w, S* j) {
  const S th2 = norm2(w);
  S b, c;
  if (val(th2) < kEps2) {
    b = (0.5f - th2 * (1.f / 24.f)) + th2 * th2 * (1.f / 720.f);
    c = ((1.f / 6.f) - th2 * (1.f / 120.f)) + th2 * th2 * (1.f / 5040.f);
  } else {
    const S t = sqrt_(th2);
    b = (1.f - cos_(t)) / th2;
    c = (t - sin_(t)) / (th2 * t);
  }
  rodrigues(w, b, c, j);
}

template <class S>
__device__ __forceinline__ void so3_left_jacobian_inverse(const S* w, S* j) {
  const S th2 = norm2(w);
  S d;
  if (val(th2) < kEps2) {
    d = ((1.f / 12.f) + th2 * (1.f / 720.f)) + th2 * th2 * (1.f / 30240.f);
  } else {
    const S t = sqrt_(th2);
    const S half = 0.5f * t;
    d = 1.f / th2 - 0.5f * cos_(half) / (t * sin_(half));
  }
  rodrigues(w, S(-0.5f), d, j);
}

// rotation -> unit quaternion [w, x, y, z] (Shepperd, the first largest
// trace term, canonical sign w >= 0)
template <class S>
__device__ __forceinline__ void rot_to_quat(const S* r, S* q) {
  const S &m00 = r[0], &m01 = r[1], &m02 = r[2], &m10 = r[3], &m11 = r[4], &m12 = r[5], &m20 = r[6],
          &m21 = r[7], &m22 = r[8];
  const S t0 = ((1.f + m00) + m11) + m22;
  const S t1 = ((1.f + m00) - m11) - m22;
  const S t2 = ((1.f - m00) + m11) - m22;
  const S t3 = ((1.f - m00) - m11) + m22;
  int idx = 0;
  float best = val(t0);
  if (val(t1) > best) idx = 1, best = val(t1);
  if (val(t2) > best) idx = 2, best = val(t2);
  if (val(t3) > best) idx = 3;
  S ts;
  if (idx == 0) {
    ts = t0, q[0] = t0, q[1] = m21 - m12, q[2] = m02 - m20, q[3] = m10 - m01;
  } else if (idx == 1) {
    ts = t1, q[0] = m21 - m12, q[1] = t1, q[2] = m10 + m01, q[3] = m02 + m20;
  } else if (idx == 2) {
    ts = t2, q[0] = m02 - m20, q[1] = m10 + m01, q[2] = t2, q[3] = m21 + m12;
  } else {
    ts = t3, q[0] = m10 - m01, q[1] = m02 + m20, q[2] = m21 + m12, q[3] = t3;
  }
  const S den = 2.f * sqrt_(val(ts) > 1e-12f ? ts : S(1e-12f));
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / den;
  if (val(q[0]) < 0.f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
  const S n = sqrt_(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

template <class S>
__device__ __forceinline__ void so3_log(const S* r, S* w) {
  S q[4];
  rot_to_quat(r, q);
  const S nv2 = norm2(q + 1);
  S scale;
  if (val(nv2) < kEps2) {
    const S safe_w = fabsf(val(q[0])) < 1e-6f ? S(1.f) : q[0];
    scale = ((1.f / safe_w) * 2.f) * (1.f - nv2 / (3.f * safe_w * safe_w));
  } else {
    const S nv = sqrt_(nv2);
    scale = (2.f * atan2_(nv, q[0])) / nv;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = scale * q[1 + i];
}

template <class S>
__device__ __forceinline__ void se3_exp(const S* xi, S* r, S* t) {
  S j[9];
  so3_exp(xi, r);
  so3_left_jacobian(xi, j);
  matvec(j, xi + 3, t);
}

template <class S>
__device__ __forceinline__ void se3_log(const S* r, const S* t, S* xi) {
  S j[9];
  so3_log(r, xi);
  so3_left_jacobian_inverse(xi, j);
  matvec(j, t, xi + 3);
}

// a^-1 . b: (Ra^T Rb, Ra^T tb + (-(Ra^T ta)))
template <class S>
__device__ __forceinline__ void se3_between(const S* ra, const S* ta, const S* rb, const S* tb, S* r, S* t) {
  S inv_t[3], bt[3];
  matmul_tn(ra, rb, r);
  matvec_t(ra, ta, inv_t);
  matvec_t(ra, tb, bt);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = bt[i] + (-inv_t[i]);
}

// ---------------------------------------------------------------- a frame

template <class S>
struct Frame {
  S r[9], t[3], w[3], v[3];
};

// a frame's state at the tangent d = 0, seeded on tangent column `col`
// (-1: none) of the retraction R Exp(d_pose), t + R d_trans, w + d_w, v + d_v:
// d R = R skew(e_col), d t = R e_(col-3), d w = e_(col-6), d v = e_(col-9)
__device__ __forceinline__ void load_frame(const float* x, int col, Frame<float>& f) {
#pragma unroll
  for (int i = 0; i < 9; ++i) f.r[i] = x[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) f.t[i] = x[9 + i], f.w[i] = x[12 + i], f.v[i] = x[15 + i];
}

__device__ __forceinline__ void load_frame(const float* x, int col, Frame<Dual>& f) {
  float e[3] = {0.f, 0.f, 0.f}, sk[9], dr[9];
  if (col >= 0 && col < 3) e[col] = 1.f;
  skew(e, sk);
  matmul(x, sk, dr);
#pragma unroll
  for (int i = 0; i < 9; ++i) f.r[i] = Dual(x[i], dr[i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f.t[i] = Dual(x[9 + i], (col >= 3 && col < 6) ? x[3 * i + col - 3] : 0.f);
    f.w[i] = Dual(x[12 + i], col == 6 + i ? 1.f : 0.f);
    f.v[i] = Dual(x[15 + i], col == 9 + i ? 1.f : 0.f);
  }
}

template <class S>
__device__ __forceinline__ void to_s(const float* a, S* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = S(a[i]);
}

// ---------------------------------------------------------------- factors
// Each writes its whitened residual rows (window_residuals' values).

struct Ctx {
  const Params* p;
  float* sm;
  Layout l;
};

// prior on frame 0: [Log(prior^-1 x0) / s_pose, (w0 - w_p) / s_vel, (v0 - v_p) / s_vel]
template <class S>
__device__ void prior_residual(const Ctx& c, const Frame<S>& f, S* res) {
  const float* misc = c.sm + c.l.misc;
  S pr[9], pt[3], r[9], t[3], xi[6];
  to_s(misc + 4, pr, 9);
  to_s(misc + 13, pt, 3);
  se3_between(pr, pt, f.r, f.t, r, t);
  se3_log(r, t, xi);
  const float sp = c.p->inv_sigma_prior_pose, sv = c.p->inv_sigma_prior_vel;
#pragma unroll
  for (int i = 0; i < 6; ++i) res[i] = xi[i] * sp;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    res[6 + i] = (f.w[i] - misc[16 + i]) * sv;
    res[9 + i] = (f.v[i] - misc[19 + i]) * sv;
  }
}

// pair (i, i+1): [dynamics (6) / sigma_dyn, const-w (3), const-v (3)] x pair_valid
template <class S>
__device__ void pair_residual(const Ctx& c, const Frame<S>& a, const Frame<S>& b, float pv, S* res) {
  const Params& p = *c.p;
  S vb[3], xi[6], re[9], te[9], rp[9], tp[3], rr[9], tr[3], e[6];
  if (p.vel_body) {
#pragma unroll
    for (int i = 0; i < 3; ++i) vb[i] = a.v[i];
  } else {
    matvec_t(a.r, a.v, vb);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) xi[i] = p.dt * a.w[i], xi[3 + i] = p.dt * vb[i];
  se3_exp(xi, re, te);
  matmul(a.r, re, rp);
  matvec(a.r, te, tp);
#pragma unroll
  for (int i = 0; i < 3; ++i) tp[i] = tp[i] + a.t[i];
  se3_between(rp, tp, b.r, b.t, rr, tr);
  se3_log(rr, tr, e);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    res[i] = (e[i] / S(p.sigma_dyn_rot)) * pv;
    res[3 + i] = (e[3 + i] / S(p.sigma_dyn_trans)) * pv;
    res[6 + i] = ((b.w[i] - a.w[i]) * p.inv_sigma_cw) * pv;
    res[9 + i] = ((b.v[i] - a.v[i]) * p.inv_sigma_cv) * pv;
  }
}

// corner k of frame i: ((project(K, cam^-1 (x p_k)) - z_k) / s_kp) x valid,
// times the IRLS sqrt-weight of the residual's value (held constant)
template <class S>
__device__ void keypoint_residual(const Ctx& c, int i, int k, const Frame<S>& f, S& ru, S& rv) {
  const Params& p = *c.p;
  const float* misc = c.sm + c.l.misc;
  const float* z_k = c.sm + c.l.meas + (i * p.k + k) * 2;
  const float vi = c.sm[c.l.valid + i];
  S pb[3], pw[3], pc[3];
  to_s(c.sm + c.l.pts + 3 * k, pb, 3);
  matvec(f.r, pb, pw);
#pragma unroll
  for (int j = 0; j < 3; ++j) pw[j] = pw[j] + f.t[j];
  if (p.cam_rot != nullptr) {
    S cr[9], d[3];
    to_s(misc + 22, cr, 9);
#pragma unroll
    for (int j = 0; j < 3; ++j) d[j] = pw[j] - misc[31 + j];
    matvec_t(cr, d, pc);
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) pc[j] = pw[j];
  }
  const S u = (misc[0] * pc[0]) / pc[2] + misc[2];
  const S v = (misc[1] * pc[1]) / pc[2] + misc[3];
  ru = ((u - z_k[0]) * p.inv_sigma_kp) * vi;
  rv = ((v - z_k[1]) * p.inv_sigma_kp) * vi;
  float w = 1.f;
  if (p.robust) {
    const float n = sqrtf((val(ru) * val(ru) + val(rv) * val(rv)) + 1e-12f);
    if (p.robust == 2) {
      const float q = 1.f + (n * p.inv_robust_delta) * (n * p.inv_robust_delta);
      w = 1.f / (q * q);
    } else {
      w = fminf((1.f / n) * p.robust_delta, 1.f);
    }
  }
  const float sw = sqrtf(w);
  ru = ru * sw;
  rv = rv * sw;
}

// frame i pinned to its pre-solve value where it has no measurement:
// [Log(anchor^-1 x), w - w_a, v - v_a] x (1 - valid) / 1e-3
template <class S>
__device__ void pin_residual(const Ctx& c, int i, const Frame<S>& f, S* res) {
  const float* a = c.sm + c.l.anchor + i * kFrame;
  const float inv = 1.f - c.sm[c.l.valid + i];
  S ar[9], at[3], r[9], t[3], xi[6];
  to_s(a, ar, 9);
  to_s(a + 9, at, 3);
  se3_between(ar, at, f.r, f.t, r, t);
  se3_log(r, t, xi);
  const float w = c.p->inv_pin;
#pragma unroll
  for (int j = 0; j < 6; ++j) res[j] = (xi[j] * inv) * w;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    res[6 + j] = ((f.w[j] - a[12 + j]) * inv) * w;
    res[9 + j] = ((f.v[j] - a[15 + j]) * inv) * w;
  }
}

// ---------------------------------------------------------------- block-wide steps
// Each is called by every thread of the block.

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += red[i];
    red[kWarps] = s;
  }
  __syncthreads();
  const float s = red[kWarps];
  __syncthreads();
  return s;
}

// 0.5 r.r at the window x (shared memory): a thread a factor, by value
__device__ float window_cost(const Ctx& c, const float* x) {
  const int t = c.p->t;
  const float* vd = c.sm + c.l.valid;
  float s = 0.f;
  for (int f = threadIdx.x; f < 3 * t; f += kThreads) {
    float res[12];
    int rows = 12;
    Frame<float> a, b;
    if (f == 0) {
      load_frame(x, -1, a);
      prior_residual(c, a, res);
    } else if (f < t) {
      load_frame(x + (f - 1) * kFrame, -1, a);
      load_frame(x + f * kFrame, -1, b);
      pair_residual(c, a, b, vd[f - 1] * vd[f], res);
    } else if (f < 2 * t) {
      load_frame(x + (f - t) * kFrame, -1, a);
      for (int k = 0; k < c.p->k; ++k) {
        float ru, rv;
        keypoint_residual(c, f - t, k, a, ru, rv);
        s += ru * ru;
        s += rv * rv;
      }
      rows = 0;
    } else {
      load_frame(x + (f - 2 * t) * kFrame, -1, a);
      pin_residual(c, f - 2 * t, a, res);
    }
    for (int r = 0; r < rows; ++r) s += res[r] * res[r];
  }
  return 0.5f * block_sum(s, c.sm + c.l.red);
}

// One tangent column of a factor's 12 rows (row stride `stride` in the
// Jacobian block at `jac`), and with `values` the rows' values (at `res`).
__device__ __forceinline__ void store12(float* jac, int stride, float* res, const Dual* r, bool values) {
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    jac[i * stride] = r[i].d;
    if (values) res[i] = r[i].v;
  }
}

// A column whose only nonzero row is `row`, of derivative `d` (12 rows).
__device__ __forceinline__ void linear12(float* jac, int stride, int row, float d) {
#pragma unroll
  for (int i = 0; i < 12; ++i) jac[i * stride] = i == row ? d : 0.f;
}

// The residuals at the window and the Jacobian's nonzero columns, a thread
// per (factor, tangent column), the residual's values from its column 0.
// The columns run heaviest first, so that in most windows a thread takes at
// most one that goes through the Lie group: the prior's pose, a pair's
// frame i and frame i+1's pose, a pin's pose; then the corners' (a frame's
// pose); then the velocity columns of rows that are linear in them (the
// prior's, a pair's frame i+1, a pin's), written from their constant
// derivative as forward mode computes it. A factor of zero weight (a pair
// with an invalid frame, an invalid frame's corners, a valid frame's pin)
// has rows of exact zeros: written as such.
__device__ void linearize(const Ctx& c) {
  const Params& p = *c.p;
  float* sm = c.sm;
  const int t = p.t, k2 = 2 * p.k;
  const Layout& l = c.l;
  const float* x = sm + l.x;
  const float* vd = sm + l.valid;
  const int n_heavy = 6 + 18 * (t - 1) + 6 * t, n_kp = 6 * t, n_linear = 6 + 6 * (t - 1) + 6 * t;
  for (int col = threadIdx.x; col < n_heavy + n_kp + n_linear; col += kThreads) {
    Dual res[12];
    Frame<Dual> a, b;
    int q = col;
    if (q < n_heavy) {
      if (q < 6) {  // the prior's pose
        load_frame(x, q, a);
        prior_residual(c, a, res);
        store12(sm + l.jp + q, 12, sm + l.rp, res, q == 0);
        continue;
      }
      q -= 6;
      if (q < 18 * (t - 1)) {  // pair i: frame i, frame i+1's pose
        const int i = q / 18, j = q % 18;
        const float pv = vd[i] * vd[i + 1];
        float* jac = sm + l.jd + i * 288 + j;
        if (pv == 0.f) {
          linear12(jac, 24, -1, 0.f);
          if (j == 0) linear12(sm + l.rd + i * 12, 1, -1, 0.f);
          continue;
        }
        load_frame(x + i * kFrame, j < 12 ? j : -1, a);
        load_frame(x + (i + 1) * kFrame, j < 12 ? -1 : j - 12, b);
        pair_residual(c, a, b, pv, res);
        store12(jac, 24, sm + l.rd + i * 12, res, j == 0);
        continue;
      }
      q -= 18 * (t - 1);
      const int i = q / 6, j = q % 6;  // pin i's pose
      float* jac = sm + l.jn + i * 144 + j;
      if (vd[i] == 1.f) {
        linear12(jac, 12, -1, 0.f);
        if (j == 0) linear12(sm + l.rn + i * 12, 1, -1, 0.f);
        continue;
      }
      load_frame(x + i * kFrame, j, a);
      pin_residual(c, i, a, res);
      store12(jac, 12, sm + l.rn + i * 12, res, j == 0);
      continue;
    }
    q -= n_heavy;
    if (q < n_kp) {  // frame i's corners
      const int i = q / 6, j = q % 6;
      float* jac = sm + l.jk + i * k2 * 6 + j;
      float* val = sm + l.rk + i * k2;
      if (vd[i] == 0.f) {
        for (int r = 0; r < k2; ++r) {
          jac[r * 6] = 0.f;
          if (j == 0) val[r] = 0.f;
        }
        continue;
      }
      load_frame(x + i * kFrame, j, a);
      for (int k = 0; k < p.k; ++k) {
        Dual ru, rv;
        keypoint_residual(c, i, k, a, ru, rv);
        jac[2 * k * 6] = ru.d;
        jac[(2 * k + 1) * 6] = rv.d;
        if (j == 0) val[2 * k] = ru.v, val[2 * k + 1] = rv.v;
      }
      continue;
    }
    q -= n_kp;
    // velocity columns with linear rows: ((1 - 0) s) w on their own row
    if (q < 6) {
      linear12(sm + l.jp + 6 + q, 12, 6 + q, p.inv_sigma_prior_vel);
      continue;
    }
    q -= 6;
    if (q < 6 * (t - 1)) {
      const int i = q / 6, j = q % 6;
      linear12(sm + l.jd + i * 288 + 18 + j, 24, 6 + j, (j < 3 ? p.inv_sigma_cw : p.inv_sigma_cv) * (vd[i] * vd[i + 1]));
      continue;
    }
    q -= 6 * (t - 1);
    const int i = q / 6, j = q % 6;
    linear12(sm + l.jn + i * 144 + 6 + j, 12, 6 + j, (1.f - vd[i]) * p.inv_pin);
  }
}

// sum_r A[r][a] B[r][b] over `rows` rows of two column blocks
__device__ __forceinline__ float col_dot(const float* a, const float* b, int rows, int stride) {
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s = fmaf(a[r * stride], b[r * stride], s);
  return s;
}

// J^T J's band, damped, and -J^T r: D_i (T, 12, 12), U_i (T - 1, 12, 12), rhs (T, 12)
__device__ void normal_equations(const Ctx& c, float lam) {
  float* sm = c.sm;
  const int t = c.p->t, k2 = 2 * c.p->k;
  const Layout& l = c.l;
  const int nd = t * 144, nu = (t - 1) * 144, ng = t * 12;
  for (int task = threadIdx.x; task < nd + nu + ng; task += kThreads) {
    if (task < nd + nu) {
      const bool diag = task < nd;
      const int e = diag ? task : task - nd, i = e / 144, a = (e % 144) / 12, b = e % 12;
      float s = 0.f;
      if (diag) {
        if (i == 0) s += col_dot(sm + l.jp + a, sm + l.jp + b, 12, 12);
        if (i > 0) s += col_dot(sm + l.jd + (i - 1) * 288 + 12 + a, sm + l.jd + (i - 1) * 288 + 12 + b, 12, 24);
        if (i < t - 1) s += col_dot(sm + l.jd + i * 288 + a, sm + l.jd + i * 288 + b, 12, 24);
        if (a < 6 && b < 6) s += col_dot(sm + l.jk + i * k2 * 6 + a, sm + l.jk + i * k2 * 6 + b, k2, 6);
        s += col_dot(sm + l.jn + i * 144 + a, sm + l.jn + i * 144 + b, 12, 12);
        if (a == b) s = s + lam * fmaxf(s, 1e-6f);
        sm[l.d + e] = s;
      } else {
        sm[l.u + e] = col_dot(sm + l.jd + i * 288 + a, sm + l.jd + i * 288 + 12 + b, 12, 24);
      }
    } else {
      const int e = task - nd - nu, i = e / 12, a = e % 12;
      float s = 0.f;
      if (i == 0) {
        const float* j = sm + l.jp + a;
        for (int q = 0; q < 12; ++q) s = fmaf(j[q * 12], sm[l.rp + q], s);
      }
      if (i > 0) {
        const float* j = sm + l.jd + (i - 1) * 288 + 12 + a;
        const float* r = sm + l.rd + (i - 1) * 12;
        for (int q = 0; q < 12; ++q) s = fmaf(j[q * 24], r[q], s);
      }
      if (i < t - 1) {
        const float* j = sm + l.jd + i * 288 + a;
        const float* r = sm + l.rd + i * 12;
        for (int q = 0; q < 12; ++q) s = fmaf(j[q * 24], r[q], s);
      }
      if (a < 6) {
        const float* j = sm + l.jk + i * k2 * 6 + a;
        const float* r = sm + l.rk + i * k2;
        for (int q = 0; q < k2; ++q) s = fmaf(j[q * 6], r[q], s);
      }
      {
        const float* j = sm + l.jn + i * 144 + a;
        const float* r = sm + l.rn + i * 12;
        for (int q = 0; q < 12; ++q) s = fmaf(j[q * 12], r[q], s);
      }
      sm[l.rhs + e] = -s;
    }
  }
}

// Block-Thomas Cholesky of the band and the step, in one warp:
//   S_i = D_i - W_{i-1}^T W_{i-1},  L_i = chol(S_i),  W_i = L_i^-1 U_i,
//   y_i = L_i^-1 (b_i - W_{i-1}^T y_{i-1}),  x_i = L_i^-T (y_i - W_i x_{i+1}).
// L_i overwrites D_i, W_i U_i, y_i b_i, 1 / diag(L_i) goes to inv; the step
// goes to delta (all NaN where a pivot is not positive). The recursion is
// the kernel's dependent chain: each pivot's reciprocal square root is one
// MUFU op, and the substitutions multiply by the stored reciprocals.
__device__ void solve_band(const Layout& l, float* sm, int t) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  bool ok = true;
  for (int i = 0; i < t; ++i) {
    float* li = sm + l.d + i * 144;
    float* inv = sm + l.inv + i * 12;
    float s[12], rb = 0.f;
#pragma unroll
    for (int b = 0; b < 12; ++b) s[b] = lane < 12 ? li[lane * 12 + b] : 0.f;
    if (lane < 12) {
      rb = sm[l.rhs + i * 12 + lane];
      if (i > 0) {
        const float* w = sm + l.u + (i - 1) * 144;
        const float* y = sm + l.rhs + (i - 1) * 12;
        float wa[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) wa[k] = w[k * 12 + lane];
#pragma unroll
        for (int b = 0; b < 12; ++b) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < 12; ++k) acc = fmaf(wa[k], w[k * 12 + b], acc);
          s[b] = s[b] - acc;
        }
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < 12; ++k) acc = fmaf(wa[k], y[k], acc);
        rb = rb - acc;
      }
    }
    // lane a holds row a: right-looking, column k's entries by shuffles
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const float piv = __shfl_sync(full, s[k], k);
      ok = ok && piv > 0.f;
      const float r = rsqrtf(piv);
      const float lak = lane == k ? piv * r : s[k] * r;
      if (lane == k) inv[k] = r;
      s[k] = lak;
#pragma unroll
      for (int m = k + 1; m < 12; ++m) s[m] = fmaf(-lak, __shfl_sync(full, lak, m), s[m]);
    }
    if (lane < 12) {
#pragma unroll
      for (int b = 0; b < 12; ++b) li[lane * 12 + b] = b <= lane ? s[b] : 0.f;
      sm[l.rhs + i * 12 + lane] = rb;
    }
    __syncwarp();
    // forward substitutions: lanes 0-11 the columns of U_i, lane 12 the rhs
    if (lane < 12 ? i < t - 1 : lane == 12) {
      float* col = lane < 12 ? sm + l.u + i * 144 + lane : sm + l.rhs + i * 12;
      const int stride = lane < 12 ? 12 : 1;
      float x[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) x[j] = col[j * stride];
      // column-oriented: each x_j, once final, updates the rows below it
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        x[j] = x[j] * inv[j];
#pragma unroll
        for (int m = j + 1; m < 12; ++m) x[m] = fmaf(-li[m * 12 + j], x[j], x[m]);
      }
#pragma unroll
      for (int j = 0; j < 12; ++j) col[j * stride] = x[j];
    }
    __syncwarp();
  }
  for (int i = t - 1; i >= 0; --i) {
    const float* li = sm + l.d + i * 144;
    const float* inv = sm + l.inv + i * 12;
    float* xi = sm + l.delta + i * 12;
    if (lane < 12) {  // z = y_i - W_i x_{i+1}, a row a lane
      float z = sm[l.rhs + i * 12 + lane];
      if (i < t - 1) {
        const float* w = sm + l.u + i * 144 + lane * 12;
        const float* xn = sm + l.delta + (i + 1) * 12;
#pragma unroll
        for (int c = 0; c < 12; ++c) z = fmaf(-w[c], xn[c], z);
      }
      xi[lane] = z;
    }
    __syncwarp();
    if (lane == 0) {  // L_i^T x = z, column-oriented in one lane's registers
      float v[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) v[j] = xi[j];
#pragma unroll
      for (int j = 11; j >= 0; --j) {
        v[j] = v[j] * inv[j];
#pragma unroll
        for (int m = 0; m < j; ++m) v[m] = fmaf(-li[j * 12 + m], v[j], v[m]);
      }
#pragma unroll
      for (int j = 0; j < 12; ++j) xi[j] = v[j];
    }
    __syncwarp();
  }
  if (!ok) {
    for (int e = lane; e < t * 12; e += 32) sm[l.delta + e] = __int_as_float(0x7fc00000);  // NaN
  }
}

// x . Exp(d_pose), w + d_w, v + d_v (retract_window) for frame i
__device__ void retract(const float* x, const float* d, float* out) {
  Frame<float> f;
  load_frame(x, -1, f);
  float re[9], te[3], r[9], t[3];
  se3_exp(d, re, te);
  matmul(f.r, re, r);
  matvec(f.r, te, t);
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = r[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[9 + i] = t[i] + f.t[i];
    out[12 + i] = f.w[i] + d[6 + i];
    out[15 + i] = f.v[i] + d[9 + i];
  }
}

__global__ void __launch_bounds__(kThreads, 1) lm_kernel(const Params p) {
  extern __shared__ float sm[];
  const Layout l = layout(p.t, p.k);
  const int t = p.t, tid = threadIdx.x;
  for (int i = tid; i < t; i += kThreads) {
    float* x = sm + l.x + i * kFrame;
    for (int j = 0; j < 9; ++j) x[j] = p.rot[i * 9 + j];
    for (int j = 0; j < 3; ++j) {
      x[9 + j] = p.trans[i * 3 + j];
      x[12 + j] = p.ang_vel[i * 3 + j];
      x[15 + j] = p.vel[i * 3 + j];
    }
    for (int j = 0; j < kFrame; ++j) sm[l.anchor + i * kFrame + j] = x[j];
    sm[l.valid + i] = p.valid[i];
  }
  for (int i = tid; i < t * p.k * 2; i += kThreads) sm[l.meas + i] = p.meas[i];
  for (int i = tid; i < p.k * 3; i += kThreads) sm[l.pts + i] = p.points[i];
  if (tid == 0) {
    float* m = sm + l.misc;
    m[0] = *p.fx, m[1] = *p.fy, m[2] = *p.cx, m[3] = *p.cy;
    for (int j = 0; j < 9; ++j) m[4 + j] = p.prior_rot[j];
    for (int j = 0; j < 3; ++j) m[13 + j] = p.prior_trans[j], m[16 + j] = p.prior_w[j], m[19 + j] = p.prior_v[j];
    if (p.cam_rot != nullptr) {
      for (int j = 0; j < 9; ++j) m[22 + j] = p.cam_rot[j];
      for (int j = 0; j < 3; ++j) m[31 + j] = p.cam_trans[j];
    }
  }
  __syncthreads();
  const Ctx c{&p, sm, l};
  float lam = p.lambda_init;
  // with accept/reject, the cost at the current point; without, the cost
  // at the last linearization point
  float cost = p.accept_reject ? window_cost(c, sm + l.x) : 0.f;
  const int n_res = l.d - l.rp;  // rp, rd, rk, rn lie side by side
  for (int it = 0; it < p.iterations; ++it) {
    linearize(c);
    __syncthreads();
    if (!p.accept_reject && it == p.iterations - 1) {
      float s = 0.f;
      for (int e = tid; e < n_res; e += kThreads) s += sm[l.rp + e] * sm[l.rp + e];
      cost = 0.5f * block_sum(s, sm + l.red);
    }
    normal_equations(c, lam);
    __syncthreads();
    if (tid < 32) solve_band(l, sm, t);
    __syncthreads();
    float* dst = sm + (p.accept_reject ? l.xn : l.x);
    for (int i = tid; i < t; i += kThreads) retract(sm + l.x + i * kFrame, sm + l.delta + i * 12, dst + i * kFrame);
    __syncthreads();
    if (p.accept_reject) {
      const float new_cost = window_cost(c, sm + l.xn);
      const bool accept = new_cost < cost;
      if (accept) {
        for (int e = tid; e < t * kFrame; e += kThreads) sm[l.x + e] = sm[l.xn + e];
        cost = new_cost;
      }
      lam = fminf(fmaxf(accept ? lam * p.lambda_down : lam * p.lambda_up, p.lambda_min), p.lambda_max);
      __syncthreads();
    }
  }
  for (int i = tid; i < t; i += kThreads) {
    const float* x = sm + l.x + i * kFrame;
    for (int j = 0; j < 9; ++j) p.out_rot[i * 9 + j] = x[j];
    for (int j = 0; j < 3; ++j) {
      p.out_trans[i * 3 + j] = x[9 + j];
      p.out_ang_vel[i * 3 + j] = x[12 + j];
      p.out_vel[i * 3 + j] = x[15 + j];
    }
  }
  if (tid == 0) *p.out_cost = cost;
}

}  // namespace

// Sets the kernel's largest dynamic shared memory; once, at load.
extern "C" int perseus_smoother_init() {
  return (int)cudaFuncSetAttribute(lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

// cudaErrorInvalidValue, launching nothing, for an empty window or one whose
// arrays take more than a block's shared memory (227 KB).
extern "C" int perseus_smoother_lm_f32(const Params* p, void* stream) {
  if (p->t < 1 || p->k < 1 || p->iterations < 0) return (int)cudaErrorInvalidValue;
  const int64_t bytes = (int64_t)layout(p->t, p->k).total * (int64_t)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  lm_kernel<<<1, kThreads, bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}
