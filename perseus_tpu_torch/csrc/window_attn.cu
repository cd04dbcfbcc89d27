// Kernel #8: SwinV2's shifted-window scaled cosine attention, one launch a
// transformer block (perseus_tpu_torch/models/swinv2.py::window_attention;
// its plain version is window_attention_reference in the same module).
//
//   perseus_window_attn  replaces no Pallas kernel: the JAX package has no
//                        transformer detector. It was added with SwinV2-T as
//                        the tracker's second detector.
//
// Input: the block's qkv product (B, H*W, 3C) in unshifted token order, q, k
// and v each C = heads * 32 wide, in bf16 or f32. One block of 256 threads
// per (window, head, image) computes, for the window's 64 tokens:
//   gather    the tokens of window (wy, wx) of the frame rolled by -shift:
//             the roll is folded into the index, token (sy, sx) of the
//             rolled frame is token ((sy + shift) % H, (sx + shift) % W);
//   cosine    q and k rows divided by max(|row|, 1e-12), in f32;
//   logits    (q . k) * scale[head] + bias[head] + mask, the mask -100 where
//             two tokens lie in different regions of the rolled frame (the
//             regions worked out from the coordinates, as the reference's
//             image mask labels them), 0 elsewhere and without a shift;
//   softmax   in f32 over each row, then P . V;
//   store     to the token's unshifted place (the window reverse and the
//             reverse roll folded into the store index), head h's 32
//             channels at [32 h, 32 h + 32) of a C-wide row.
//
// Bound: bytes (q, k, v read once, the output written once, the bias table
// read once; 1.3 operations a byte at stage 1, far under the card's ~295).
// Its launches are small (24-192 blocks), so at batch 1 a launch's latency
// is most of its time: one launch covers every window and head of a block,
// everything between the gather and the store stays in shared memory and
// registers, and the f32 products run on the CUDA cores (0.48 GFLOP a frame
// over all 12 launches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The launch's arguments, field for field models/swinv2.py's _Args (outside
// the unnamed namespace, so that the entry stays exported).
struct WindowAttnArgs {
  const void* qkv;     // (B, H*W, 3C)
  void* out;           // (B, H*W, C), the input's type
  const float* bias;   // (heads, 64, 64): 16 sigmoid(cpb_mlp(table))[index]
  const float* scale;  // (heads,): exp(min(logit_scale, ln 100))
  int batch, height, width, heads, shift;
};

namespace {

constexpr int kWin = 8;           // window side
constexpr int kN = kWin * kWin;   // tokens a window
constexpr int kD = 32;            // channels a head
constexpr int kThreads = 256;     // 4 threads a query row
constexpr float kMask = -100.0f;  // the reference's mask value
constexpr float kEps = 1e-12f;    // F.normalize's

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The region (0..8) of rolled-frame coordinates (sy, sx): per axis 0 before
// the last window, 1 in the last window before the wrapped strip, 2 in the
// strip the roll brought from the start of the frame.
__device__ __forceinline__ int region(int sy, int sx, int h, int w, int shift) {
  if (shift == 0) return 0;
  const int ry = sy < h - kWin ? 0 : (sy < h - shift ? 1 : 2);
  const int rx = sx < w - kWin ? 0 : (sx < w - shift ? 1 : 2);
  return ry * 3 + rx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) window_attn_kernel(WindowAttnArgs a) {
  __shared__ float q[kN][kD + 1];  // +1: rows on distinct banks
  __shared__ float k[kN][kD + 1];
  __shared__ float v[kN][kD + 1];
  __shared__ float p[kN][kN + 1];
  __shared__ int tok[kN];
  __shared__ int reg[kN];

  const int tid = threadIdx.x;
  const int head = blockIdx.y, image = blockIdx.z;
  const int wins_x = a.width / kWin;
  const int wy = blockIdx.x / wins_x, wx = blockIdx.x % wins_x;
  const int c = a.heads * kD;

  if (tid < kN) {
    const int sy = wy * kWin + tid / kWin, sx = wx * kWin + tid % kWin;
    int y = sy + a.shift, x = sx + a.shift;
    if (y >= a.height) y -= a.height;
    if (x >= a.width) x -= a.width;
    tok[tid] = y * a.width + x;
    reg[tid] = region(sy, sx, a.height, a.width, a.shift);
  }
  __syncthreads();

  const int64_t tokens = (int64_t)a.height * a.width;
  const T* src = static_cast<const T*>(a.qkv) + (int64_t)image * tokens * 3 * c + head * kD;
  for (int e = tid; e < kN * kD; e += kThreads) {
    const int t = e / kD, d = e % kD;
    const T* row = src + (int64_t)tok[t] * 3 * c + d;
    q[t][d] = to_f32(row[0]);
    k[t][d] = to_f32(row[c]);
    v[t][d] = to_f32(row[2 * c]);
  }
  __syncthreads();

  // cosine: threads 0-63 normalise q's rows, 64-127 k's
  if (tid < 2 * kN) {
    float* row = tid < kN ? q[tid] : k[tid - kN];
    float ss = 0.0f;
    for (int d = 0; d < kD; ++d) ss = fmaf(row[d], row[d], ss);
    const float norm = fmaxf(sqrtf(ss), kEps);
    for (int d = 0; d < kD; ++d) row[d] = row[d] / norm;
  }
  __syncthreads();

  // logits and softmax: row i by the 4 neighbouring lanes i*4 .. i*4+3, lane
  // part l taking the columns l, l+4, ..., l+60
  const int i = tid >> 2, l = tid & 3;
  const float scale = a.scale[head];
  const float* bias = a.bias + ((int64_t)head * kN + i) * kN;
  float s[kN / 4];
  float mx = -INFINITY;
#pragma unroll
  for (int m = 0; m < kN / 4; ++m) {
    const int j = l + 4 * m;
    float dot = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; ++d) dot = fmaf(q[i][d], k[j][d], dot);
    float logit = dot * scale + bias[j];
    if (reg[i] != reg[j]) logit += kMask;
    s[m] = logit;
    mx = fmaxf(mx, logit);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float sum = 0.0f;
#pragma unroll
  for (int m = 0; m < kN / 4; ++m) {
    s[m] = expf(s[m] - mx);
    sum += s[m];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
  for (int m = 0; m < kN / 4; ++m) p[i][l + 4 * m] = s[m] / sum;
  __syncthreads();

  // P . V: lane part l takes the channels 8 l .. 8 l + 7 of row i
  float o[kD / 4];
#pragma unroll
  for (int d = 0; d < kD / 4; ++d) o[d] = 0.0f;
  for (int j = 0; j < kN; ++j) {
    const float pij = p[i][j];
#pragma unroll
    for (int d = 0; d < kD / 4; ++d) o[d] = fmaf(pij, v[j][l * (kD / 4) + d], o[d]);
  }
  T* dst = static_cast<T*>(a.out) + ((int64_t)image * tokens + tok[i]) * c + head * kD + l * (kD / 4);
#pragma unroll
  for (int d = 0; d < kD / 4; ++d) store(dst + d, o[d]);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. cudaErrorInvalidValue, launching nothing,
// for a frame that windows of 8 do not tile, no head or a shift outside
// [0, 8).
extern "C" int perseus_window_attn(const WindowAttnArgs* a, int dtype, void* stream) {
  if (a->batch < 1 || a->heads < 1 || a->height < kWin || a->width < kWin || a->height % kWin != 0 ||
      a->width % kWin != 0 || a->shift < 0 || a->shift >= kWin || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a->height / kWin) * (a->width / kWin), a->heads, a->batch);
  if (dtype == 0)
    window_attn_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(*a);
  else
    window_attn_kernel<__nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
