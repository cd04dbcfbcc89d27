// Stem maxpool of the ResNet-18 detector: MaxPool2d(kernel 3, stride 2,
// padding 1) with -inf padding, forward, over an NCHW-contiguous batch.
//
// Replaces perseus_tpu/models/pool_pallas.py::_fwd_kernel (through
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
