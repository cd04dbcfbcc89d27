// The train-time augmentation kernels of the keypoint detector, over
// NCHW-contiguous batches in f32 or bf16 storage with f32 math. One source,
// three entry modes of the fused chain:
//
//   mode 0  chain  replaces perseus_tpu/augment/fused.py::_kernel
//                  (fused_apply: the elementwise chain of _chain_planes)
//   mode 1  warp   replaces fused.py::_kernel_warp (fused_warp_apply: the
//                  two-pass affine warp of _warp_planes, then the chain)
//   mode 2  ultra  replaces fused.py::_make_ultra_kernel (fused_ultra_apply:
//                  the donor transplant of _transplant_planes with its
//                  seg-ratio gate, the per-image swap transpose, the warp,
//                  the chain)
//
// and the standalone warp of the unfused chain:
//
//   perseus_warp_affine_f32  replaces perseus_tpu/augment/warp_pallas.py::
//                  _warp_kernel (augment/warp.py::warp_affine_two_pass): the
//                  two-pass warp alone, f32 in and out, any square size, the
//                  swap transpose read in place. One thread per output pixel
//                  computes its taps once (warp_taps, shared with stage1) and
//                  walks the channels. Bound: bytes (the image read once, the
//                  output written once, 40 B/px at C = 5); the 4 taps per
//                  channel re-read neighbouring source pixels through L1/L2,
//                  and a swapped image is read down its columns.
//
// Design. The TPU kernel holds a whole image in VMEM. A 256x256x5 f32 image
// is 1.25 MiB, far above one SM's 227 KB of shared memory, and the chain
// has two per-image reductions (the transplant's seg ratio, the contrast's
// mean gray) and a 5x5 neighbourhood (the blur) in it, so it runs as up to
// three launches on the same stream:
//
//   (a) seg_count (ultra only): per image, the exact integer count of
//       pixels whose new seg is 1 after the candidate transplant; the
//       ratio gate ratio in [lb, ub] follows from it.
//   (b) stage1: one thread per output pixel. It computes the source on the
//       fly: the (transplanted if accepted, swapped) source pixel is read
//       at (c, r) when swap is set, the donor by donor_idx in the same
//       tensor (no gathered copy). The two-pass warp is 4 reads: for
//       j in {j0, j0 + 1}, j0 = floor(gam[y, x]), the column tap is
//       inter(y, j) = src(i0, j) v_w0 + src(i0 + 1, j) v_w1 with
//       i0 = floor(rhoT[j, y]) (the row taps differ per column: this is
//       not 2-D bilinear), blended with h_w0, h_w1 in _warp_planes' order.
//       Then the two erase rects, the Planckian gains and brightness; RGB
//       goes to an f32 scratch and its gray to a per-block partial sum
//       (summed in a fixed order, so runs are deterministic). The depth
//       chain is pointwise and seg passes through: both are stored here.
//   (c) stage2: a 32x32 output tile per block with a 2-pixel halo in
//       shared memory: contrast about the mean gray, saturation, hue, the
//       5-tap separable reflect-padded blur (-1 -> 1, -2 -> 2; taps summed
//       in _blur_plane's order), the plasma shadow, one cast at the store.
//
// Bound on this card: bytes. Per pixel the chain does some 100 f32
// operations, far below the compute rate; the least traffic is one read of
// the image (and the donor), fields and plasma and one write of the output.
// The RGB scratch (24 B/px) and the warp's repeated taps (served by L1/L2)
// are what this simple design pays above that.
//
// Traps, each handled where it bites below:
//   * FMA contraction: the file is built with -fmad=false (models/_build.py)
//     so every product and sum rounds on its own, as the plain version's
//     torch ops do. It matters most for the index planes rhoT and gam: one
//     value per use gives a tap's index and its weight.
//   * Float modulo: JAX's % and torch.remainder are floor modulo; fmodf
//     truncates, which is wrong for a negative hue shift.
//   * Hue branch: the max channel is chosen by ordering compares, as in
//     fused.py::_hue_planes, not by equality with the computed max.
//   * bf16 storage: load, upcast, compute in f32, round once at the store
//     (__float2bfloat16_rn). Fields and plasma always arrive as bf16.
//   * Exact masks: the transplant tests seg == 1.0 exactly.
//
// Plain C interface for ctypes; the entry returns the first non-zero
// cudaGetLastError() of its launches, 0 when all were accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kScalars = 29;
constexpr int kThreads = 256;
constexpr int kPixPerBlock = 1024;  // stage (a)/(b) pixels per block; the wrapper sizes partials by it
constexpr int kMaxC = 8;
constexpr int kTile = 32;
constexpr int kHalo = kTile + 4;

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T st(float v);
template <> __device__ __forceinline__ float st<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch.clamp(x, 0, 1): NaN stays NaN (fminf/fmaxf would drop it)
__device__ __forceinline__ float clip01(float x) { return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x); }

// Floor modulo, JAX's % on floats: truncating fmodf, moved into [0, m)
// when its sign differs from m's.
__device__ __forceinline__ float floor_mod(float x, float m) {
  float t = fmodf(x, m);
  if (t != 0.0f && ((t < 0.0f) != (m < 0.0f))) t += m;
  return t;
}

template <typename T>
struct Args {
  const T* img;
  T* out;
  const float* sv;              // (B, 29)
  const __nv_bfloat16* fields;  // (B, 3, H, W)
  const __nv_bfloat16* plasma;  // (B, H, W)
  const float* wp;              // (B, 6) or, for ultra, (B, 7) with the swap flag last
  const int* donor;             // (B,)
  int* counts;                  // (B,) new-seg pixel counts, zeroed by the caller
  float* partial;               // (B, nblk) gray partial sums
  float* rgb;                   // (B, 3, H, W) f32 scratch
  int b, c, h, w, nblk;
  float lb, ub;
};

// The transplant's mask algebra at one pixel (fused.py::_transplant_planes).
struct Transplant {
  bool take_donor;
  float seg;
};
__device__ __forceinline__ Transplant transplant(float depth, float seg, float d_depth,
                                                 float d_seg) {
  const bool acc_cube = seg == 1.0f;  // exact compares: seg is binary
  const bool donor_cube = d_seg == 1.0f;
  const float a = acc_cube ? 1.0f : 0.0f;
  bool m = (!acc_cube) || (d_depth * a < depth * a);
  m = m && !donor_cube;
  float new_seg = 1.0f - (m ? 1.0f : 0.0f);
  if (donor_cube && !acc_cube) new_seg = 0.0f;
  return {m, new_seg};
}

__device__ __forceinline__ bool accepted(const int* counts, int bi, int hw, float lb, float ub) {
  // jnp.mean of the 0/1 seg: an exact integer sum, divided once
  const float ratio = (float)counts[bi] / (float)hw;
  return ratio >= lb && ratio <= ub;
}

// (a) per image, the count of pixels whose candidate new seg is 1
template <typename T>
__global__ void seg_count(Args<T> a) {
  const int bi = blockIdx.y;
  const int64_t hw = (int64_t)a.h * a.w;
  int d = a.donor[bi];
  d = d < 0 ? 0 : (d >= a.b ? a.b - 1 : d);
  const T* img = a.img + (int64_t)bi * a.c * hw;
  const T* don = a.img + (int64_t)d * a.c * hw;
  const int64_t end = min((int64_t)(blockIdx.x + 1) * kPixPerBlock, hw);
  int cnt = 0;
  for (int64_t px = (int64_t)blockIdx.x * kPixPerBlock + threadIdx.x; px < end; px += kThreads) {
    const Transplant t =
        transplant(ld(img[3 * hw + px]), ld(img[4 * hw + px]), ld(don[3 * hw + px]), ld(don[4 * hw + px]));
    cnt += t.seg == 1.0f;
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&a.counts[bi], cnt);  // integer: exact, any order
}

// Offset of row i, column j of the warp's input in the stored (square)
// image: the stored image is read transposed, at (j, i), when swap is set.
__device__ __forceinline__ int64_t src_offset(int i, int j, bool swap, int w) {
  return swap ? (int64_t)j * w + i : (int64_t)i * w + j;
}

// The two-pass warp's taps of output pixel (y, x) of an h x w image:
// columns j[t] = clamp(j0 + t), j0 = floor(gam[y, x]), with weights hwt[t];
// for each, rows i[t][u] = clamp(i0 + u), i0 = floor(rhoT[j[t], y]), with
// weights vwt[t][u]. Out-of-range taps get weight 0 (zero padding). Every
// product and sum rounds on its own (-fmad=false), as in the plain version,
// so a tap's index and its weight come from the same bits.
struct Taps {
  int j[2];
  float hwt[2];
  int i[2][2];
  float vwt[2][2];
};
__device__ __forceinline__ Taps warp_taps(float i00, float i01, float t0, float p, float q, float r,
                                          float yf, float xf, int h, int w) {
  Taps tp;
  const float gam = i01 * yf + i00 * xf + t0;  // gam[y, x] = (i01 y + i00 x) + t0
  const float g0 = floorf(gam);
  const float fh = gam - g0;
  const int j0 = (int)g0;
  tp.j[0] = min(max(j0, 0), w - 1);
  tp.j[1] = min(max(j0 + 1, 0), w - 1);
  tp.hwt[0] = (j0 >= 0 && j0 < w) ? 1.0f - fh : 0.0f;
  tp.hwt[1] = (j0 + 1 >= 0 && j0 + 1 < w) ? fh : 0.0f;
  for (int t = 0; t < 2; ++t) {
    const float rho = q * yf + p * (float)tp.j[t] + r;  // rhoT[j, y]
    const float r0 = floorf(rho);
    const float fv = rho - r0;
    const int i0 = (int)r0;
    tp.i[t][0] = min(max(i0, 0), h - 1);
    tp.i[t][1] = min(max(i0 + 1, 0), h - 1);
    tp.vwt[t][0] = (i0 >= 0 && i0 < h) ? 1.0f - fv : 0.0f;
    tp.vwt[t][1] = (i0 + 1 >= 0 && i0 + 1 < h) ? fv : 0.0f;
  }
  return tp;
}

// All channels of the source pixel at row i, column j of the warp's input:
// the (transplanted if accepted) image, transposed when swap is set.
template <typename T, int MODE>
__device__ __forceinline__ void fetch(const Args<T>& a, const T* img, const T* don, int i, int j,
                                      bool swap, bool accept, float* v) {
  const int64_t hw = (int64_t)a.h * a.w;
  const int64_t px = src_offset(i, j, swap, a.w);
  for (int k = 0; k < a.c; ++k) v[k] = ld(img[k * hw + px]);
  if (MODE == 2 && accept) {
    float dv[5];
    for (int k = 0; k < 5; ++k) dv[k] = ld(don[k * hw + px]);
    const Transplant t = transplant(v[3], v[4], dv[3], dv[4]);
    if (t.take_donor)
      for (int k = 0; k < 4; ++k) v[k] = dv[k];
    v[4] = t.seg;
  }
}

// (b) source / warp, erase, gains, brightness; depth chain; gray partials
template <typename T, int MODE>
__global__ void stage1(Args<T> a) {
  const int bi = blockIdx.y;
  const int h = a.h, w = a.w, c = a.c;
  const int64_t hw = (int64_t)h * w;
  const float* sv = a.sv + (int64_t)bi * kScalars;
  const T* img = a.img + (int64_t)bi * c * hw;
  T* out = a.out + (int64_t)bi * c * hw;
  float* rgb = a.rgb + (int64_t)bi * 3 * hw;
  const __nv_bfloat16* fields = a.fields + (int64_t)bi * 3 * hw;

  float i00 = 0.f, i01 = 0.f, t0 = 0.f, p = 0.f, q = 0.f, r = 0.f;
  bool swap = false, accept = false;
  const T* don = img;
  if (MODE >= 1) {
    const float* wp = a.wp + (int64_t)bi * (MODE == 2 ? 7 : 6);
    i00 = wp[0]; i01 = wp[1]; t0 = wp[2]; p = wp[3]; q = wp[4]; r = wp[5];
    if (MODE == 2) {
      swap = wp[6] > 0.5f;
      accept = accepted(a.counts, bi, (int)hw, a.lb, a.ub);
      int d = a.donor[bi];
      d = d < 0 ? 0 : (d >= a.b ? a.b - 1 : d);
      don = a.img + (int64_t)d * c * hw;
    }
  }

  float gray_sum = 0.0f;
  const int64_t end = min((int64_t)(blockIdx.x + 1) * kPixPerBlock, hw);
  for (int64_t px = (int64_t)blockIdx.x * kPixPerBlock + threadIdx.x; px < end; px += kThreads) {
    const int y = (int)(px / w), x = (int)(px % w);
    const float yf = (float)y, xf = (float)x;
    float v[kMaxC];
    if (MODE == 0) {
      for (int k = 0; k < c; ++k) v[k] = ld(img[k * hw + px]);
    } else {
      const Taps tp = warp_taps(i00, i01, t0, p, q, r, yf, xf, h, w);
      float inter[2][kMaxC];
      for (int t = 0; t < 2; ++t) {
        float v0[kMaxC], v1[kMaxC];
        fetch<T, MODE>(a, img, don, tp.i[t][0], tp.j[t], swap, accept, v0);
        fetch<T, MODE>(a, img, don, tp.i[t][1], tp.j[t], swap, accept, v1);
        for (int k = 0; k < c; ++k) inter[t][k] = v0[k] * tp.vwt[t][0] + v1[k] * tp.vwt[t][1];
      }
      for (int k = 0; k < c; ++k) v[k] = inter[0][k] * tp.hwt[0] + inter[1][k] * tp.hwt[1];
    }
    // two erase rects, on every channel
    bool erase = false;
    for (int o = 0; o <= 5; o += 5) {
      const float top = sv[o + 1], left = sv[o + 2];
      erase |= (yf >= top) && (yf < top + sv[o + 3]) && (xf >= left) && (xf < left + sv[o + 4]) &&
               (sv[o] > 0.5f);
    }
    if (erase)
      for (int k = 0; k < c; ++k) v[k] = 0.0f;
    // Planckian gains + brightness
    const float f_b = sv[12];
    const float rr = clip01(clip01(v[0] * sv[10]) * f_b);
    const float gg = clip01(v[1] * f_b);
    const float bb = clip01(clip01(v[2] * sv[11]) * f_b);
    rgb[px] = rr;
    rgb[hw + px] = gg;
    rgb[2 * hw + px] = bb;
    gray_sum += rr * 0.299f + gg * 0.587f + bb * 0.114f;
    if (c > 3) {
      const float cs = sv[24];
      float scaled = cs * v[3] + ld(fields[px]);
      if (scaled < sv[25] + ld(fields[hw + px])) scaled = sv[26];
      if (scaled > sv[27] + ld(fields[2 * hw + px])) scaled = sv[28];
      out[3 * hw + px] = st<T>(scaled / cs);
    }
    for (int k = 4; k < c; ++k) out[k * hw + px] = st<T>(v[k]);
  }
  // deterministic block sum: shuffle tree per warp, then warps in order
  for (int off = 16; off > 0; off >>= 1) gray_sum += __shfl_down_sync(0xffffffffu, gray_sum, off);
  __shared__ float warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = gray_sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int k = 0; k < kThreads / 32; ++k) s += warp_sums[k];
    a.partial[(int64_t)bi * a.nblk + blockIdx.x] = s;
  }
}

__device__ void hue_rotate(float r, float g, float b, float shift, float* o) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float v = maxc;
  const float delta = maxc - minc;
  const float safe_delta = delta == 0.0f ? 1.0f : delta;
  const float s = v > 0.0f ? delta / v : 0.0f;
  // ordering compares pick the max channel (not equality with maxc)
  const bool r_max = (r >= g) && (r >= b);
  const bool g_max = (g > r) && (g >= b);
  float hh;
  if (r_max) hh = floor_mod((g - b) / safe_delta, 6.0f);
  else if (g_max) hh = (b - r) / safe_delta + 2.0f;
  else hh = (r - g) / safe_delta + 4.0f;
  hh = hh / 6.0f;
  if (delta == 0.0f) hh = 0.0f;
  hh = floor_mod(hh + shift, 1.0f);  // floor modulo: shift may be negative
  const float h6 = hh * 6.0f;
  const float fi = floorf(h6);
  const float f = h6 - fi;
  const float pp = v * (1.0f - s);
  const float qq = v * (1.0f - s * f);
  const float tt = v * (1.0f - s * (1.0f - f));
  switch ((int)fi % 6) {
    case 0: o[0] = v; o[1] = tt; o[2] = pp; break;
    case 1: o[0] = qq; o[1] = v; o[2] = pp; break;
    case 2: o[0] = pp; o[1] = v; o[2] = tt; break;
    case 3: o[0] = pp; o[1] = qq; o[2] = v; break;
    case 4: o[0] = tt; o[1] = pp; o[2] = v; break;
    default: o[0] = v; o[1] = pp; o[2] = qq; break;
  }
}

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);  // rows of a ragged tile past the image: unused
}

// (c) contrast, saturation, hue, blur, shadow on a 32x32 tile + halo
template <typename T>
__global__ void stage2(Args<T> a) {
  __shared__ float s_in[3][kHalo][kHalo + 1];
  __shared__ float s_v[3][kTile][kHalo + 1];
  __shared__ float s_mean;
  const int bi = blockIdx.z;
  const int h = a.h, w = a.w;
  const int64_t hw = (int64_t)h * w;
  const float* sv = a.sv + (int64_t)bi * kScalars;
  const float* rgb = a.rgb + (int64_t)bi * 3 * hw;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  if (tid == 0) {
    float s = 0.0f;
    for (int k = 0; k < a.nblk; ++k) s += a.partial[(int64_t)bi * a.nblk + k];
    s_mean = s / (float)hw;
  }
  __syncthreads();
  const float mean_gray = s_mean;
  const float f_c = sv[13], f_s = sv[14], f_h = sv[15];
  for (int idx = tid; idx < kHalo * kHalo; idx += kThreads) {
    const int ty = idx / kHalo, tx = idx % kHalo;
    const int64_t px = (int64_t)reflect(y0 + ty - 2, h) * w + reflect(x0 + tx - 2, w);
    float r = rgb[px], g = rgb[hw + px], b = rgb[2 * hw + px];
    r = clip01(f_c * r + (1.0f - f_c) * mean_gray);
    g = clip01(f_c * g + (1.0f - f_c) * mean_gray);
    b = clip01(f_c * b + (1.0f - f_c) * mean_gray);
    const float gray = r * 0.299f + g * 0.587f + b * 0.114f;
    r = clip01(f_s * r + (1.0f - f_s) * gray);
    g = clip01(f_s * g + (1.0f - f_s) * gray);
    b = clip01(f_s * b + (1.0f - f_s) * gray);
    if (f_h != 0.0f) {  // the HSV round trip is not exact at shift 0: keep the input then
      float o[3];
      hue_rotate(r, g, b, f_h, o);
      r = clip01(o[0]);
      g = clip01(o[1]);
      b = clip01(o[2]);
    }
    s_in[0][ty][tx] = r;
    s_in[1][ty][tx] = g;
    s_in[2][ty][tx] = b;
  }
  __syncthreads();
  const bool blur_on = sv[16] > 0.5f;
  const float taps[5] = {sv[17], sv[18], sv[19], sv[20], sv[21]};
  if (blur_on) {  // vertical pass over the tile's rows and the halo's columns
    for (int idx = tid; idx < kTile * kHalo; idx += kThreads) {
      const int ty = idx / kHalo, tx = idx % kHalo;
      for (int ch = 0; ch < 3; ++ch) {
        float acc = taps[0] * s_in[ch][ty][tx];
        for (int k = 1; k < 5; ++k) acc = acc + taps[k] * s_in[ch][ty + k][tx];
        s_v[ch][ty][tx] = acc;
      }
    }
  }
  __syncthreads();
  const float intensity = sv[22], quantity = sv[23];
  const __nv_bfloat16* plasma = a.plasma + (int64_t)bi * hw;
  T* out = a.out + (int64_t)bi * a.c * hw;
  for (int ty = threadIdx.y; ty < kTile; ty += kThreads / kTile) {
    const int y = y0 + ty, x = x0 + threadIdx.x;
    if (y >= h || x >= w) continue;
    const int64_t px = (int64_t)y * w + x;
    const float delta_sh = intensity * (ld(plasma[px]) < quantity ? 1.0f : 0.0f);
    for (int ch = 0; ch < 3; ++ch) {
      float val;
      if (blur_on) {
        val = taps[0] * s_v[ch][ty][threadIdx.x];
        for (int k = 1; k < 5; ++k) val = val + taps[k] * s_v[ch][ty][threadIdx.x + k];
      } else {
        val = s_in[ch][ty + 2][threadIdx.x + 2];
      }
      out[ch * hw + px] = st<T>(clip01(val + delta_sh));
    }
  }
}

template <typename T>
int run(int mode, const void* img, void* out, const void* sv, const void* fields,
        const void* plasma, const void* wp, const void* donor, void* counts, void* partial,
        void* rgb, int b, int c, int h, int w, float lb, float ub, void* stream) {
  if (b == 0 || h == 0 || w == 0) return 0;
  if (c < 3 || c > kMaxC || (mode == 2 && c != 5) || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const int64_t hw = (int64_t)h * w;
  Args<T> a{(const T*)img, (T*)out, (const float*)sv, (const __nv_bfloat16*)fields,
            (const __nv_bfloat16*)plasma, (const float*)wp, (const int*)donor, (int*)counts,
            (float*)partial, (float*)rgb, b, c, h, w, (int)((hw + kPixPerBlock - 1) / kPixPerBlock),
            lb, ub};
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid1(a.nblk, b);
  int err;
  if (mode == 2) {
    seg_count<T><<<grid1, kThreads, 0, s>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (mode == 0) stage1<T, 0><<<grid1, kThreads, 0, s>>>(a);
  else if (mode == 1) stage1<T, 1><<<grid1, kThreads, 0, s>>>(a);
  else stage1<T, 2><<<grid1, kThreads, 0, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 grid2((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  stage2<T><<<grid2, dim3(kTile, kThreads / kTile), 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The standalone two-pass warp: one thread per output pixel of image
// blockIdx.y; wp is (B, 7), (i00, i01, t0, p, q, r, swap).
__global__ void warp_two_pass(const float* __restrict__ img, float* __restrict__ out,
                              const float* __restrict__ wp, int c, int h, int w) {
  const int bi = blockIdx.y;
  const int64_t hw = (int64_t)h * w;
  const int64_t px = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (px >= hw) return;
  const float* prm = wp + (int64_t)bi * 7;
  const bool swap = prm[6] > 0.5f;
  const int y = (int)(px / w), x = (int)(px % w);
  const Taps tp = warp_taps(prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], (float)y, (float)x, h, w);
  int64_t off[2][2];
  for (int t = 0; t < 2; ++t)
    for (int u = 0; u < 2; ++u) off[t][u] = src_offset(tp.i[t][u], tp.j[t], swap, w);
  const float* src = img + (int64_t)bi * c * hw;
  float* dst = out + (int64_t)bi * c * hw;
  for (int k = 0; k < c; ++k) {
    const float* plane = src + k * hw;
    const float in0 = plane[off[0][0]] * tp.vwt[0][0] + plane[off[0][1]] * tp.vwt[0][1];
    const float in1 = plane[off[1][0]] * tp.vwt[1][0] + plane[off[1][1]] * tp.vwt[1][1];
    dst[k * hw + px] = in0 * tp.hwt[0] + in1 * tp.hwt[1];
  }
}

}  // namespace

extern "C" int perseus_warp_affine_f32(const void* img, void* out, const void* wp, int b, int c,
                                       int h, int w, void* stream) {
  if (b == 0 || c == 0 || h == 0 || w == 0) return 0;
  if (h != w || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((int64_t)h * w + kThreads - 1) / kThreads), b);
  warp_two_pass<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const float*)img, (float*)out,
                                                             (const float*)wp, c, h, w);
  return (int)cudaGetLastError();
}

extern "C" int perseus_fused_augment_f32(int mode, const void* img, void* out, const void* sv,
                                         const void* fields, const void* plasma, const void* wp,
                                         const void* donor, void* counts, void* partial, void* rgb,
                                         int b, int c, int h, int w, float lb, float ub,
                                         void* stream) {
  return run<float>(mode, img, out, sv, fields, plasma, wp, donor, counts, partial, rgb, b, c, h,
                    w, lb, ub, stream);
}

extern "C" int perseus_fused_augment_bf16(int mode, const void* img, void* out, const void* sv,
                                          const void* fields, const void* plasma, const void* wp,
                                          const void* donor, void* counts, void* partial,
                                          void* rgb, int b, int c, int h, int w, float lb,
                                          float ub, void* stream) {
  return run<__nv_bfloat16>(mode, img, out, sv, fields, plasma, wp, donor, counts, partial, rgb,
                            b, c, h, w, lb, ub, stream);
}
