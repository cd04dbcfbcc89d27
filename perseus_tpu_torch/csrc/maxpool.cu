// Stem maxpool of the ResNet-18 detector: MaxPool2d(kernel 3, stride 2,
// padding 1) with -inf padding, forward and gradient, over NCHW-contiguous
// batches.
//
// FORWARD. Replaces perseus_tpu/models/pool_pallas.py::_fwd_kernel (through
// max_pool_3x3_s2_pallas). The TPU kernel packs the W parity split into
// lanes, (B, H, W/2, 2C), and so needs even H and W; both exist only because
// Mosaic cannot slice vectors with a stride. Here the kernel is a direct
// windowed max: one thread per output element, any H and W.
//
// Bound on this card: bytes. Each output reads nine inputs and does eight
// compares, far below the compute rate, so the least time is one read of x
// and one write of y at the memory rate. Neighbouring threads take
// neighbouring outputs of one row, so a warp's loads of a window row cover
// a contiguous span of about 64 inputs and its store is contiguous; the
// overlap between windows (each input lies in up to four) is served by L1.
//
// Compares run in f32 for both dtypes, as the TPU kernel does; the selected
// input is stored as it was, so the output holds input values bit for bit.
// NaN propagates like torch.maximum: the first NaN met in window order wins
// (fmaxf would drop it).
//
// GRADIENT. Replaces perseus_tpu/models/pool_pallas.py::_bwd_kernel (through
// _pool_bwd_call, the VJP of max_pool_3x3_s2_pallas): g[p, q] goes whole to
// EVERY input equal to its window max y[p, q] (not to one argmax, as
// F.max_pool2d's backward does). Gather form: one thread per INPUT element,
// no atomics. Input row 2p is covered by window row p only and row 2p+1 by
// window rows p and p+1 (the same for columns), from the geometry, so any H
// and W work (the TPU kernel needs even sizes). The thread adds the terms of
// the windows that cover it in the JAX order (p,q), (p+1,q), (p,q+1),
// (p+1,q+1); a window past the last row or column adds an exact 0, as the
// TPU kernel's -inf / 0 padding does. Compares and sums run in f32 and the
// sum is cast once, so the plain version (models/pool.py) agrees bit for bit.
// Bound on this card: bytes (x read once, y and g about once through L1/L2,
// dx written once; at most 4 compares and 3 adds per input).
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// the launch and 0 when there is nothing to do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return -INFINITY; }
template <> __device__ __forceinline__ __nv_bfloat16 neg_inf<__nv_bfloat16>() {
  return __float2bfloat16(-INFINITY);
}

template <typename T>
__global__ void maxpool3x3s2_fwd(const T* __restrict__ x, T* __restrict__ y, int64_t planes,
                                 int h, int w, int ho, int wo) {
  const int64_t n = planes * ho * wo;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int q = (int)(i % wo);
    const int64_t r = i / wo;
    const int p = (int)(r % ho);
    const int64_t plane = r / ho;
    const T* xp = x + plane * h * w;
    // starts at the -inf padding; every window has at least one in-range tap
    T best = neg_inf<T>();
    float best_f = -INFINITY;
    bool is_nan = false;
    const int r0 = 2 * p - 1;
    const int c0 = 2 * q - 1;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int row = r0 + ky;
      if (row < 0 || row >= h) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int col = c0 + kx;
        if (col < 0 || col >= w) continue;
        const T v = xp[(int64_t)row * w + col];
        const float vf = to_f32(v);
        if (!is_nan && (vf != vf || vf > best_f)) {
          best = v;
          best_f = vf;
          is_nan = vf != vf;
        }
      }
    }
    y[i] = best;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void maxpool3x3s2_bwd(const T* __restrict__ x, const T* __restrict__ y,
                                 const T* __restrict__ g, T* __restrict__ dx, int64_t planes,
                                 int h, int w, int ho, int wo) {
  const int64_t n = planes * h * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int col = (int)(i % w);
    const int64_t r = i / w;
    const int row = (int)(r % h);
    const int64_t plane = r / h;
    const T* yp = y + plane * ho * wo;
    const T* gp = g + plane * ho * wo;
    const float xv = to_f32(x[i]);
    const int p = row >> 1, q = col >> 1;
    const bool odd_r = row & 1, odd_c = col & 1;
    // term of window (pp, qq); 0 for the window past the last one
    auto term = [&](int pp, int qq) -> float {
      if (pp >= ho || qq >= wo) return 0.0f;
      const int64_t k = (int64_t)pp * wo + qq;
      return xv == to_f32(yp[k]) ? to_f32(gp[k]) : 0.0f;
    };
    float acc = term(p, q);
    if (odd_r) acc = acc + term(p + 1, q);
    if (odd_c) acc = acc + term(p, q + 1);
    if (odd_r && odd_c) acc = acc + term(p + 1, q + 1);
    dx[i] = from_f32<T>(acc);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* g, void* dx, int64_t planes, int h, int w,
               int ho, int wo, void* stream) {
  const int64_t n = planes * h * w;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  maxpool3x3s2_bwd<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)y, (const T*)g, (T*)dx, planes, h, w, ho, wo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, int64_t planes, int h, int w, int ho, int wo, void* stream) {
  const int64_t n = planes * ho * wo;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride loop covers the rest
  maxpool3x3s2_fwd<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, planes, h, w, ho, wo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int perseus_maxpool3x3s2_f32(const void* x, void* y, int64_t planes, int h, int w,
                                        int ho, int wo, void* stream) {
  return launch<float>(x, y, planes, h, w, ho, wo, stream);
}

extern "C" int perseus_maxpool3x3s2_bf16(const void* x, void* y, int64_t planes, int h, int w,
                                         int ho, int wo, void* stream) {
  return launch<__nv_bfloat16>(x, y, planes, h, w, ho, wo, stream);
}

extern "C" int perseus_maxpool3x3s2_bwd_f32(const void* x, const void* y, const void* g, void* dx,
                                            int64_t planes, int h, int w, int ho, int wo,
                                            void* stream) {
  return launch_bwd<float>(x, y, g, dx, planes, h, w, ho, wo, stream);
}

extern "C" int perseus_maxpool3x3s2_bwd_bf16(const void* x, const void* y, const void* g,
                                             void* dx, int64_t planes, int h, int w, int ho,
                                             int wo, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, y, g, dx, planes, h, w, ho, wo, stream);
}
