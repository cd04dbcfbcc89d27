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
// F.max_pool2d's backward does). Gather form, no atomics. Input row 2p is
// covered by window row p only and row 2p+1 by window rows p and p+1 (the
// same for columns), from the geometry, so any H and W work (the TPU kernel
// needs even sizes). Each input adds the terms of the windows that cover it
// in the JAX order (p,q), (p+1,q), (p,q+1), (p+1,q+1); a window past the
// last row or column adds an exact 0, as the TPU kernel's -inf / 0 padding
// does. Compares and sums run in f32 and the sum is cast once, so the plain
// version (models/pool.py) agrees bit for bit.
//
// Tiling (Hopper redesign): a thread owns input rows 2p and 2p+1 across 8
// consecutive columns, 16 inputs, and loads the 2 x 5 windows that cover
// them once, into registers. x and dx move as 16-byte words where the
// tensors allow it (aligned, rows a multiple of 16 bytes); the ragged edge,
// odd sizes and unaligned views take scalar accesses with the same
// arithmetic. Block x covers 256 such cells of one plane, block y walks the
// planes; offsets are 32-bit inside a plane and the cell is found with one
// division per thread. (The first version ran one thread per input and
// found its plane, row and column with four 64-bit divisions per element:
// 2.41 ms at the stem's bf16 shape, integer-bound.)
//
// Bound on this card: bytes. x read once, y and g once (their reuse between
// neighbouring threads is served by L1), dx written once; at most 4
// compares and 3 adds per input. At (256, 64, 128, 128) bf16 the bound is
// 0.4006 ms at 3.35 TB/s; measured (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W): 0.51 ms, and 0.89 ms in f32 against its 0.80 ms bound.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// the launch and 0 when there is nothing to do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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

// 8 consecutive values as float, moved as 16-byte words (one for bf16, two
// for f32); the pointer is 16-byte aligned (the launch checks).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 pair;
    memcpy(&pair, &words[k], 4);
    v[2 * k] = __low2float(pair);
    v[2 * k + 1] = __high2float(pair);
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint32_t words[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 pair = __halves2bfloat162(__float2bfloat16_rn(v[2 * k]), __float2bfloat16_rn(v[2 * k + 1]));
    memcpy(&words[k], &pair, 4);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
}

constexpr int kBwdThreads = 256;

// One thread owns input rows 2p and 2p + 1 across the 8 columns c0 .. c0 + 7
// (window columns q0 .. q0 + 3, q0 = c0 / 2) of one plane: the windows that
// cover them are rows p, p + 1 and columns q0 .. q0 + 4, loaded once into
// registers for all 16 inputs. Block x covers 256 (row pair, column group)
// cells of a plane; block y walks the planes. Offsets inside a plane are
// 32-bit (the launch checks H W < 2^31); the thread's cell is found by one
// division when it starts. `vec`: x and dx are 16-byte aligned with rows of
// a multiple of 16 bytes, so a full 8-column group moves as 16-byte words;
// the ragged last group, odd H or W and unaligned tensors take the scalar
// loads and stores of the same arithmetic.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
maxpool3x3s2_bwd(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
                 T* __restrict__ dx, int64_t planes, int h, int w, int ho, int wo, bool vec) {
  const int ncg = (w + 7) >> 3;
  const int cell = blockIdx.x * kBwdThreads + threadIdx.x;
  if (cell >= ((h + 1) >> 1) * ncg) return;
  const int p = cell / ncg;
  const int c0 = (cell - p * ncg) * 8, q0 = c0 >> 1;
  const int rows = 2 * p + 1 < h ? 2 : 1;
  const bool full = vec && c0 + 8 <= w;
  for (int64_t plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const T* xp = x + plane * h * w;
    const T* yp = y + plane * ho * wo;
    const T* gp = g + plane * ho * wo;
    T* dxp = dx + plane * h * w;
    // windows (p + r, q0 + k); one past the last row or column is y = g = 0,
    // whose term is an exact 0 whatever x is
    float yv[2][5], gv[2][5];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const bool in = p + r < ho && q0 + k < wo;
        const int o = (p + r) * wo + q0 + k;
        yv[r][k] = in ? to_f32(yp[o]) : 0.0f;
        gv[r][k] = in ? to_f32(gp[o]) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r >= rows) break;
      const int off = (2 * p + r) * w + c0;
      float xv[8], out[8];
      if (full) {
        load8(xp + off, xv);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) xv[k] = c0 + k < w ? to_f32(xp[off + k]) : 0.0f;
      }
      // g whole to every input equal to its window max; the terms of the
      // windows that cover the input in the JAX order (p,q), (p+1,q),
      // (p,q+1), (p+1,q+1), summed in f32
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int kk = k >> 1;
        float acc = xv[k] == yv[0][kk] ? gv[0][kk] : 0.0f;
        if (r == 1) acc = acc + (xv[k] == yv[1][kk] ? gv[1][kk] : 0.0f);
        if (k & 1) acc = acc + (xv[k] == yv[0][kk + 1] ? gv[0][kk + 1] : 0.0f);
        if (r == 1 && (k & 1)) acc = acc + (xv[k] == yv[1][kk + 1] ? gv[1][kk + 1] : 0.0f);
        out[k] = acc;
      }
      if (full) {
        store8(dxp + off, out);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (c0 + k < w) dxp[off + k] = from_f32<T>(out[k]);
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* g, void* dx, int64_t planes, int h, int w,
               int ho, int wo, void* stream) {
  if (planes == 0 || h == 0 || w == 0) return 0;
  if ((int64_t)h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int cells = ((h + 1) >> 1) * ((w + 7) >> 3);
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  const bool vec = aligned(x) && aligned(dx) && ((int64_t)w * sizeof(T)) % 16 == 0;
  const dim3 grid((unsigned)((cells + kBwdThreads - 1) / kBwdThreads),
                  (unsigned)(planes < 65535 ? planes : 65535));
  maxpool3x3s2_bwd<T><<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)y, (const T*)g, (T*)dx, planes, h, w, ho, wo, vec);
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
