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
//                  swap transpose read in place. Hopper redesign, the design
//                  of the ultra stage 1 below (and its box code): a block
//                  bounds its 32x32 output tile's taps, stages that source
//                  box once in shared memory (a swapped image read along its
//                  stored rows and written transposed), and reads its taps
//                  there; a tap outside the box reads global memory the same
//                  way; the box is bounded from the taps of the tile's two
//                  edge columns, which give the same box as every pixel's.
//                  C = 5 at compile time, any other C in passes of up to 5
//                  channels; 32-bit offsets. Bound: bytes (the image read
//                  once, the output written once, 40 B/px at C = 5: 0.2003
//                  ms at (256, 5, 256, 256)). Measured (chip_smoke.py,
//                  NVIDIA H100 80GB HBM3, 700.00 W): 0.33 ms there, swapped
//                  and unswapped images alike.
//                  (The first version ran one thread per output pixel with
//                  64-bit pixel indexing and read its 4 taps per channel from
//                  global memory, a swapped image down its columns, one
//                  32-byte sector per 4-byte load: 0.51 ms at (256, 5, 256,
//                  256), NVIDIA H100 80GB HBM3, 700.00 W.)
//
// Design. The TPU kernel holds a whole image in VMEM. A 256x256x5 f32 image
// is 1.25 MiB, far above one SM's 227 KB of shared memory, and the chain
// has two per-image reductions (the transplant's seg ratio, the contrast's
// mean gray) and a 5x5 neighbourhood (the blur) in it, so it runs as up to
// three launches on the same stream:
//
//   (a) seg_count (ultra only): per image, the exact integer count of
//       pixels whose new seg is 1 after the candidate transplant, from
//       4-pixel vector loads of the image's and the donor's depth and seg
//       planes; the gate ratio in [lb, ub] follows from it.
//   (b) stage 1, a block per 32x32 output tile: the source, the warp, the
//       two erase rects, the Planckian gains and brightness; RGB goes to an
//       f32 scratch and the tile's gray to a partial sum. The depth chain is
//       pointwise and seg passes through: both are stored here. The
//       two-pass warp of output (y, x) is 4 reads: for j in {j0, j0 + 1},
//       j0 = floor(gam[y, x]), the column tap inter(y, j) = src(i0, j) v_w0
//       + src(i0 + 1, j) v_w1 with i0 = floor(rhoT[j, y]) (the row taps
//       differ per column: this is not 2-D bilinear), blended with h_w0,
//       h_w1 in _warp_planes' order. The last tile of an image to finish
//       sums the image's tile partials in a fixed order into its mean gray
//       (deterministic). C is a compile-time constant (3, 4 and 5; one
//       generic instantiation for 6-8, the same arithmetic over up to 8
//       channels), so the per-pixel values live in registers; offsets
//       inside an image are 32-bit (the launch checks c h w < 2^31).
//         chain (Hopper redesign): no taps, so a thread takes 4 consecutive
//       pixels of a row and moves the image planes, the RGB scratch and
//       depth / seg as 16-byte words in f32 (8 in bf16) and the fields as
//       8-byte words. Widths that are not a multiple of 4 and bases that
//       are not aligned (a batch slice can make one) take a scalar path
//       with the same arithmetic.
//         warp and ultra (Hopper redesign): the block first bounds every
//       tap of its tile (their row and column ranges, reduced over the
//       block), then stages that source box once in shared memory, in the
//       storage type, read row by row, coalesced, two stored columns per
//       pass (two loads in flight). Taps read the box. A tap outside the
//       staged box (only when the box exceeds the kBoxPix budget, e.g. a
//       zoom-out beyond the config's scale range) reads global memory
//       through the same source function, so the values stay
//       bit-identical. Every box of the default config's affines fits the
//       budget (tests/test_torch_augment_cuda.py). The warp's input is
//       already swap-adjusted (ops._two_pass_setup): its box comes from the
//       taps of the tile's two edge columns, and in f32 it is a plain copy,
//       staged by asynchronous copies (cp.async) that all go out before the
//       block waits. Ultra's source is the stored image and its donor, the
//       transplant applied once per source pixel, written transposed when
//       the image is swapped (odd row pitch: no bank conflicts either way);
//       its box comes from every pixel's taps (the edge-column bound made
//       it spill).
//   (c) stage 2, a block per 64x32 output tile (1.20x its pixels with the
//       halo, against 1.27x for 32x32): the tile with a 2-pixel halo in
//       shared memory: contrast about the image's mean gray (one value,
//       read by every block), saturation, hue, the 5-tap separable
//       reflect-padded blur (-1 -> 1, -2 -> 2; the vertical pass first, taps
//       summed in _blur_plane's order), the plasma shadow, one cast at the
//       store. 4 x 68 threads: a thread owns a halo column (its source
//       column reflected once) and computes the colour of every 4th row of
//       it, two rows at a time; the vertical pass takes a column segment of
//       4 outputs per thread (8 loads), the horizontal pass a row segment of
//       4 (two 16-byte loads), which also stores 4 outputs as one word; each
//       phase divides evenly among the threads. The hue needs no fmodf and
//       no divergent branch (see hue_rotate); the clamps are NaN-propagating
//       min / max.
//
// Bound on this card: bytes. Per pixel the chain does some 150 f32
// operations, far below the compute rate; the least traffic is one read of
// the image (its images are also the donors), fields and plasma and one
// write of the output: 48 B/px at C = 5 in f32. The two-launch design adds
// the RGB scratch round trip (24 B/px in f32): contrast needs the image's
// mean gray, which only a finished stage 1 knows. Measured (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700.00 W) at (256, 5, 256, 256) f32 before this
// design of stages 1 (chain, warp) and 2: chain 0.69 ms, warp (C = 4) 0.77,
// ultra 1.01 (seg count 0.07, stage 1 0.63, stage 2 0.30); PERF.md has the
// times of this one. (The first ultra ran one thread per output pixel,
// loading each of the 4 taps' 5 channels and its donor's from global
// memory and evaluating the transplant per tap, with 64-bit pixel indexing
// and runtime-indexed per-pixel arrays in local memory: 3.0 ms there.)
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
//     (__float2bfloat16_rn). Fields and plasma always arrive as bf16. The
//     staged box holds the storage type: a transplanted value is a stored
//     value or a seg of 0 / 1, exact in bf16.
//   * Exact masks: the transplant tests seg == 1.0 exactly.
//
// Plain C interface for ctypes; the entry returns the first non-zero
// CUDA error of its launches, 0 when all were accepted. The caller passes
// one scratch buffer of perseus_fused_augment_scratch_bytes(b, h, w) bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kScalars = 29;
constexpr int kThreads = 256;
constexpr int kMaxC = 8;
constexpr int kAnyC = kMaxC;                         // the generic instantiation: c in 6-8 at run time
constexpr int kTile = 32;                            // output tile of stage 1
constexpr int kTileRows = kThreads / kTile;          // a stage-1 block is kTile x kTileRows threads
constexpr int kCountPix = 4096;                      // seg_count pixels per block
constexpr int kUltraC = 5;
// stage 2: a 64x32 output tile, its halo 68 x 36, rows of 68 floats (16-byte
// aligned); s_in (the halo's colour) and s_v (the vertical pass) together
// 3 x (36 + 32) x 68 x 4 B = 55,488 B, four blocks per SM
constexpr int kS2W = 64, kS2H = 32;
constexpr int kS2HaloW = kS2W + 4, kS2HaloH = kS2H + 4;
constexpr int kS2Pitch = kS2HaloW;
constexpr int kS2Threads = 4 * kS2HaloW;            // 272: a thread per halo column, 4 rows a pass
constexpr int kS2Smem = 3 * (kS2HaloH + kS2H) * kS2Pitch * (int)sizeof(float);
// the staged source box's budget of the warp and ultra stage 1, pixels per
// channel: 5 x 2800 f32 is 56,000 B, so four blocks fit an SM's 228 KB
constexpr int kBoxPix = 2800;
constexpr int kBoxMaxCols = 127;
// the standalone warp's: channels staged per pass (the unfused chain's C),
// and its f32 box budget, pixels per channel: 5 x 2800 x 4 B is 56,000 B,
// four blocks per SM
constexpr int kWarpC = 5;
constexpr int kWarpBoxPix = 2800;

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T st(float v);
template <> __device__ __forceinline__ float st<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 4 consecutive values, 16-byte (f32) or 8-byte (bf16) aligned
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, 4);
  memcpy(&hi, &u.y, 4);
  v[0] = __low2float(lo); v[1] = __high2float(lo); v[2] = __low2float(hi); v[3] = __high2float(hi);
}
// read-only global memory through the non-coherent path (ld.global.nc),
// which the compiler may move across the kernel's stores
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void ldg4(const float* p, float* v) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void ldg4(const __nv_bfloat16* p, float* v) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, 4);
  memcpy(&hi, &u.y, 4);
  v[0] = __low2float(lo); v[1] = __high2float(lo); v[2] = __low2float(hi); v[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  memcpy(&u.x, &lo, 4);
  memcpy(&u.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = u;
}
template <typename T>
inline bool aligned4(const void* p) {  // 4 values of T as one word
  return ((uintptr_t)p % (4 * sizeof(T))) == 0;
}

// torch.clamp(x, 0, 1): NaN stays NaN (fminf/fmaxf would drop it). On the
// card, two NaN-propagating min/max (sm_80+) in place of compares and
// selects: the same values (a -0 input gives +0).
__device__ __forceinline__ float clip01(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("max.NaN.f32 %0, %1, 0f00000000;\n\tmin.NaN.f32 %0, %0, 0f3F800000;" : "=f"(y) : "f"(x));
  return y;
#else
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
#endif
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
  // the scratch buffer, carved by run()
  int* counts;                  // (B,) new-seg pixel counts
  int* tickets;                 // (B,) stage-1 tiles finished
  float* partial;               // (B, ntiles) gray partial sums, one per stage-1 tile
  float* mean;                  // (B,) mean gray
  float* rgb;                   // (B, 3, H, W) f32
  int b, c, h, w, ntiles;
  float lb, ub;
};

// The scratch layout (the one place that sizes it): the RGB planes, the
// partials, the means, then the two integer arrays that run() zeroes.
struct Scratch {
  int64_t rgb, partial, mean, counts, tickets, bytes;
};
inline int tiles_of(int h, int w) {
  return ((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
}
inline Scratch scratch_layout(int b, int h, int w) {
  Scratch s;
  s.rgb = 0;
  s.partial = s.rgb + (int64_t)b * 3 * h * w * 4;
  s.mean = s.partial + (int64_t)b * tiles_of(h, w) * 4;
  s.counts = s.mean + (int64_t)b * 4;
  s.tickets = s.counts + (int64_t)b * 4;
  s.bytes = s.tickets + (int64_t)b * 4;
  return s;
}

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

template <typename T>
__device__ __forceinline__ int donor_of(const Args<T>& a, int bi) {
  const int d = a.donor[bi];
  return d < 0 ? 0 : (d >= a.b ? a.b - 1 : d);
}

// (a) per image, the count of pixels whose candidate new seg is 1
template <typename T>
__global__ void __launch_bounds__(kThreads) seg_count(Args<T> a, bool vec) {
  const int bi = blockIdx.y;
  const int hw = a.h * a.w;
  const int64_t plane = hw;
  const T* img = a.img + (int64_t)bi * a.c * plane;
  const T* don = a.img + (int64_t)donor_of(a, bi) * a.c * plane;
  const T *dep = img + 3 * plane, *seg = img + 4 * plane;
  const T *d_dep = don + 3 * plane, *d_seg = don + 4 * plane;
  const int start = blockIdx.x * kCountPix, end = min(start + kCountPix, hw);
  int cnt = 0;
  if (vec) {  // hw % 4 == 0 and aligned planes: 4 pixels per load
    for (int px = start + 4 * (int)threadIdx.x; px < end; px += 4 * kThreads) {
      float v0[4], v1[4], v2[4], v3[4];
      load4(dep + px, v0);
      load4(seg + px, v1);
      load4(d_dep + px, v2);
      load4(d_seg + px, v3);
#pragma unroll
      for (int k = 0; k < 4; ++k) cnt += transplant(v0[k], v1[k], v2[k], v3[k]).seg == 1.0f;
    }
  } else {
    for (int px = start + (int)threadIdx.x; px < end; px += kThreads)
      cnt += transplant(ld(dep[px]), ld(seg[px]), ld(d_dep[px]), ld(d_seg[px])).seg == 1.0f;
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

// Per-image pointers of stage 1; offsets inside an image are 32-bit.
template <typename T>
struct Image {
  const float* sv;
  const __nv_bfloat16* fields;
  T* out;
  float* rgb;
  int hw;
};
template <typename T>
__device__ __forceinline__ Image<T> image_of(const Args<T>& a, int bi) {
  const int hw = a.h * a.w;
  return {a.sv + (int64_t)bi * kScalars, a.fields + (int64_t)bi * 3 * hw, a.out + (int64_t)bi * a.c * hw,
          a.rgb + (int64_t)bi * 3 * hw, hw};
}

// The image's scalars of stage 1, in registers: the erase rects (their
// bottom and right edges summed as the plain version sums them), the gains,
// brightness and the depth chain's.
struct Chain {
  bool e_on[2];
  float e_top[2], e_bot[2], e_left[2], e_right[2];
  float gain_r, gain_b, f_b, cs, near_mean, near_value, far_mean, far_value;
};
__device__ __forceinline__ Chain chain_of(const float* sv) {
  Chain k;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float* s = sv + 5 * e;
    k.e_on[e] = s[0] > 0.5f;
    k.e_top[e] = s[1];
    k.e_bot[e] = s[1] + s[3];
    k.e_left[e] = s[2];
    k.e_right[e] = s[2] + s[4];
  }
  k.gain_r = sv[10]; k.gain_b = sv[11]; k.f_b = sv[12];
  k.cs = sv[24]; k.near_mean = sv[25]; k.near_value = sv[26]; k.far_mean = sv[27]; k.far_value = sv[28];
  return k;
}

// Stage 1 after the source, at output pixel (y, x) with source values v of
// the NC (or, for kAnyC, up to 8) channels: the erase rects (on every
// channel, in v), the Planckian gains and brightness into rgb, the depth
// chain from v[3] and the three fields into depth; returns the pixel's gray.
template <int NC>
__device__ __forceinline__ float chain_pixel(const Chain& k, float yf, float xf, float* v, float f_add,
                                             float f_near, float f_far, float* rgb, float& depth) {
  bool erase = false;
#pragma unroll
  for (int e = 0; e < 2; ++e)
    erase |= k.e_on[e] && (yf >= k.e_top[e]) && (yf < k.e_bot[e]) && (xf >= k.e_left[e]) && (xf < k.e_right[e]);
  if (erase) {
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = 0.0f;
  }
  rgb[0] = clip01(clip01(v[0] * k.gain_r) * k.f_b);
  rgb[1] = clip01(v[1] * k.f_b);
  rgb[2] = clip01(clip01(v[2] * k.gain_b) * k.f_b);
  if (NC > 3) {
    float scaled = k.cs * v[3] + f_add;
    if (scaled < k.near_mean + f_near) scaled = k.near_value;
    if (scaled > k.far_mean + f_far) scaled = k.far_value;
    depth = scaled / k.cs;
  }
  return rgb[0] * 0.299f + rgb[1] * 0.587f + rgb[2] * 0.114f;
}

// chain_pixel at one pixel (offset px in its plane) with scalar loads and
// stores: RGB to the scratch, depth and the channels past it to the output.
template <int NC, typename T>
__device__ __forceinline__ float tail_pixel(const Chain& k, const Image<T>& im, int c, int y, int x, int px,
                                            float* v) {
  const int hw = im.hw;
  float f[3] = {0.0f, 0.0f, 0.0f}, rgb[3], depth;
  if (NC > 3) {
#pragma unroll
    for (int i = 0; i < 3; ++i) f[i] = ldg(im.fields + i * hw + px);
  }
  const float gray = chain_pixel<NC>(k, (float)y, (float)x, v, f[0], f[1], f[2], rgb, depth);
#pragma unroll
  for (int i = 0; i < 3; ++i) im.rgb[i * hw + px] = rgb[i];
  if (NC > 3) im.out[3 * hw + px] = st<T>(depth);
#pragma unroll
  for (int ch = 4; ch < NC; ++ch)
    if (ch < c) im.out[ch * hw + px] = st<T>(v[ch]);
  return gray;
}

// The end of stage 1: the block's gray (its threads' sums in a fixed order)
// becomes the tile's partial; the last tile of the image to finish sums the
// image's partials in a fixed order into its mean gray.
template <typename T>
__device__ __forceinline__ void finish_gray(const Args<T>& a, int bi, float gray_sum) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ bool last;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int off = 16; off > 0; off >>= 1) gray_sum += __shfl_down_sync(0xffffffffu, gray_sum, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = gray_sum;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int k = 0; k < kThreads / 32; ++k) s += warp_sums[k];
    a.partial[(int64_t)bi * a.ntiles + blockIdx.y * gridDim.x + blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is
    last = atomicAdd(&a.tickets[bi], 1) == a.ntiles - 1;
  }
  __syncthreads();
  if (last && tid < 32) {
    __threadfence();
    const float* part = a.partial + (int64_t)bi * a.ntiles;
    float s = 0.0f;
    for (int k = tid; k < a.ntiles; k += 32) s += __ldcg(part + k);  // L2: written by other SMs
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (tid == 0) a.mean[bi] = s / (float)((int64_t)a.h * a.w);
  }
}

// (b) chain: a thread takes 4 consecutive pixels of one row of the 32x32
// tile (8 threads a row), as 16-byte (f32) or 8-byte (bf16) words when vec
// (w % 4 == 0 and every base aligned: the 4 pixels then lie in the row),
// else one pixel at a time with the same arithmetic.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) stage1_chain(Args<T> a, bool vec) {
  const int bi = blockIdx.z;
  const int h = a.h, w = a.w, c = NC == kAnyC ? a.c : NC;
  const Image<T> im = image_of(a, bi);
  const int hw = im.hw;
  const T* img = a.img + (int64_t)bi * c * hw;
  const Chain k = chain_of(im.sv);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + (tid >> 3), x = blockIdx.x * kTile + 4 * (tid & 7);
  float gray_sum = 0.0f;
  if (y < h && x < w) {
    const int px = y * w + x;
    if (vec) {
      float v[4][NC] = {}, u[4];
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) {
        if (ch < c) {
          ldg4(img + ch * hw + px, u);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i][ch] = u[i];
        }
      }
      float f[3][4] = {};
      if (NC > 3) {
#pragma unroll
        for (int i = 0; i < 3; ++i) ldg4(im.fields + i * hw + px, f[i]);
      }
      float rgb[3][4], depth[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float o[3];
        gray_sum += chain_pixel<NC>(k, (float)y, (float)(x + i), v[i], f[0][i], f[1][i], f[2][i], o, depth[i]);
#pragma unroll
        for (int j = 0; j < 3; ++j) rgb[j][i] = o[j];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) store4(im.rgb + j * hw + px, rgb[j]);
      if (NC > 3) store4(im.out + 3 * hw + px, depth);
#pragma unroll
      for (int ch = 4; ch < NC; ++ch) {
        if (ch < c) {
#pragma unroll
          for (int i = 0; i < 4; ++i) u[i] = v[i][ch];
          store4(im.out + ch * hw + px, u);
        }
      }
    } else {
      for (int i = 0; i < 4 && x + i < w; ++i) {
        float v[NC] = {};
#pragma unroll
        for (int ch = 0; ch < NC; ++ch)
          if (ch < c) v[ch] = ldg(img + ch * hw + px + i);
        gray_sum += tail_pixel<NC>(k, im, c, y, x + i, px + i, v);
      }
    }
  }
  finish_gray(a, bi, gray_sum);
}

// A tile's source box (the warp and ultra stage 1, the standalone warp):
// the rows i0 .. i0 + nrows - 1 and columns j0 .. j0 + ncols - 1 of the
// warp's input, channel k's value (li, lj) at [(k nrows + li) pitch + lj];
// an odd row pitch, so a swapped image's transposed writes do not conflict.
struct Box {
  int i0, j0, nrows, ncols, pitch;
};

// The rows and columns the taps of the block's output tile reach (clamped,
// as read), reduced over the block through s_lim (i min, i max, j min, j
// max), and from them the box, cut to `budget` pixels per channel when it
// exceeds it (the taps outside it read global memory). A box from the
// tile's corners would miss border tiles: the row map is evaluated at the
// clamped column. kEdgeColumns = false bounds every pixel's taps (each
// thread its column's pixels). kEdgeColumns = true bounds only the taps of
// the tile's first and last column in the image (lanes of warps 0 and 1,
// one row each), which gives the same box: along a row the column map gam
// is monotone in x, and for a fixed row the row map rhoT is monotone in the
// column j, each rounding step included (a rounded product or sum is
// monotone in its operands), as are floor and the clamps
// (tests/test_torch_augment_cuda.py holds the two boxes equal).
template <bool kEdgeColumns>
__device__ __forceinline__ Box tile_box(float i00, float i01, float t0, float p, float q, float r, int h, int w,
                                        int tid, int budget, int* s_lim) {
  if (tid == 0) {
    s_lim[0] = s_lim[2] = INT_MAX;
    s_lim[1] = s_lim[3] = INT_MIN;
  }
  __syncthreads();
  int lim[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
  const auto bound = [&](int y, int x) {
    const Taps tp = warp_taps(i00, i01, t0, p, q, r, (float)y, (float)x, h, w);
    lim[0] = min(lim[0], min(min(tp.i[0][0], tp.i[0][1]), min(tp.i[1][0], tp.i[1][1])));
    lim[1] = max(lim[1], max(max(tp.i[0][0], tp.i[0][1]), max(tp.i[1][0], tp.i[1][1])));
    lim[2] = min(lim[2], min(tp.j[0], tp.j[1]));
    lim[3] = max(lim[3], max(tp.j[0], tp.j[1]));
  };
  if (kEdgeColumns) {
    const int y = blockIdx.y * kTile + (tid & 31);
    if (tid < 64 && y < h) bound(y, tid < 32 ? blockIdx.x * kTile : min((int)(blockIdx.x + 1) * kTile, w) - 1);
  } else {
    const int x = blockIdx.x * kTile + threadIdx.x, y_end = min(h, (int)(blockIdx.y + 1) * kTile);
    for (int y = blockIdx.y * kTile + threadIdx.y; y < y_end && x < w; y += kTileRows) bound(y, x);
  }
  lim[0] = __reduce_min_sync(0xffffffffu, lim[0]);
  lim[1] = __reduce_max_sync(0xffffffffu, lim[1]);
  lim[2] = __reduce_min_sync(0xffffffffu, lim[2]);
  lim[3] = __reduce_max_sync(0xffffffffu, lim[3]);
  if ((tid & 31) == 0 && lim[0] <= lim[1]) {
    atomicMin(&s_lim[0], lim[0]);
    atomicMax(&s_lim[1], lim[1]);
    atomicMin(&s_lim[2], lim[2]);
    atomicMax(&s_lim[3], lim[3]);
  }
  __syncthreads();
  Box bx;
  bx.i0 = s_lim[0];
  bx.j0 = s_lim[2];
  bx.ncols = min(s_lim[3] - bx.j0 + 1, kBoxMaxCols);
  bx.pitch = bx.ncols | 1;
  bx.nrows = min(s_lim[1] - bx.i0 + 1, budget / bx.pitch);
  return bx;
}

// Stages the box: `src(i, j, v)` gives the first nc (<= NC) channels of the
// warp's input at row i, column j. Stored rows go by warp and stored columns
// by lane, so the reads are coalesced in either orientation: a swapped
// image's stored row is a column of the warp's input. kPairs: a lane takes
// two stored columns (32 apart) per pass, both read before either is
// written, so two loads are in flight.
template <int NC, bool kPairs, typename T, typename Src>
__device__ __forceinline__ void stage_box(T* box, const Box& bx, bool swap, int tid, int nc, Src src) {
  if (bx.nrows <= 0) return;
  const int n_sr = swap ? bx.ncols : bx.nrows, n_sc = swap ? bx.nrows : bx.ncols;
  const auto put = [&](int sr, int sc, const float* v) {
    // stored (sr, sc) of the box is the warp input's (li, lj), or (lj, li) when swapped
    const int li = swap ? sc : sr, lj = swap ? sr : sc;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < nc) box[(k * bx.nrows + li) * bx.pitch + lj] = st<T>(v[k]);
  };
  for (int sr = tid >> 5; sr < n_sr; sr += kThreads / 32) {
    for (int sc = tid & 31; sc < n_sc; sc += kPairs ? 64 : 32) {
      float v[NC];
      src(bx.i0 + (swap ? sc : sr), bx.j0 + (swap ? sr : sc), v);
      if (kPairs && sc + 32 < n_sc) {
        const int sc1 = sc + 32;
        float v1[NC];
        src(bx.i0 + (swap ? sc1 : sr), bx.j0 + (swap ? sr : sc1), v1);
        put(sr, sc, v);
        put(sr, sc1, v1);
      } else {
        put(sr, sc, v);
      }
    }
  }
}

// Asynchronous 4-byte copies global -> shared (cp.async, sm_80+) and the
// wait for all of a thread's.
__device__ __forceinline__ void copy_async4(float* smem, const float* gmem) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem));
#else
  *smem = *gmem;
#endif
}
__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Stages the box of an f32 warp input that needs no transform (no swap, no
// transplant) by asynchronous copies, laid out as stage_box lays it: every
// copy goes out before the thread waits, and none passes through registers.
template <int NC>
__device__ __forceinline__ void stage_box_copy(float* box, const Box& bx, int tid, int nc, const float* img, int hw,
                                               int w) {
  for (int sr = tid >> 5; sr < bx.nrows; sr += kThreads / 32)
    for (int sc = tid & 31; sc < bx.ncols; sc += 32) {
      const float* src = img + (bx.i0 + sr) * w + bx.j0 + sc;
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (k < nc) copy_async4(box + (k * bx.nrows + sr) * bx.pitch + sc, src + k * hw);
    }
  copy_async_wait();
}

// The two-pass blend of output pixel taps tp over nc (<= NC) channels, in
// _warp_planes' order: for each tap column t, inter = s(i[t][0]) vwt[t][0] +
// s(i[t][1]) vwt[t][1], then v = inter[0] hwt[0] + inter[1] hwt[1]. A tap
// reads the staged box where it falls in it, else global memory through
// `src`, the function that staged the box: the values are the same bits
// whatever the box's size.
template <int NC, typename T, typename Src>
__device__ __forceinline__ void blend_taps(const Taps& tp, const T* box, const Box& bx, int nc, Src src, float* v) {
  float inter[2][NC];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float s[2][NC] = {};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int li = tp.i[t][u] - bx.i0, lj = tp.j[t] - bx.j0;
      if ((unsigned)li < (unsigned)bx.nrows && (unsigned)lj < (unsigned)bx.ncols) {
#pragma unroll
        for (int k = 0; k < NC; ++k)
          if (k < nc) s[u][k] = ld(box[(k * bx.nrows + li) * bx.pitch + lj]);
      } else {
        src(tp.i[t][u], tp.j[t], s[u]);
      }
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) inter[t][k] = s[0][k] * tp.vwt[t][0] + s[1][k] * tp.vwt[t][1];
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) v[k] = inter[0][k] * tp.hwt[0] + inter[1][k] * tp.hwt[1];
}

// (b) warp: the tile's source box of the swap-adjusted input staged in
// shared memory (storage type, c x kBoxPix values), bounded from the
// tile's edge columns, then the taps (at most 64 registers for the four
// blocks per SM that a 5-channel f32 box allows; 128 for the 6-8 channels
// of kAnyC, whose box allows two).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC == kAnyC ? 2 : 4) stage1_warp(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* box = reinterpret_cast<T*>(smem_raw);  // [c][rows][pitch]
  __shared__ int s_lim[4];
  const int bi = blockIdx.z;
  const int h = a.h, w = a.w, c = NC == kAnyC ? a.c : NC;
  const Image<T> im = image_of(a, bi);
  const int hw = im.hw;
  const T* img = a.img + (int64_t)bi * c * hw;
  const float* wp = a.wp + (int64_t)bi * 6;
  const float i00 = wp[0], i01 = wp[1], t0 = wp[2], p = wp[3], q = wp[4], r = wp[5];
  const Chain k = chain_of(im.sv);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y_begin = blockIdx.y * kTile + threadIdx.y, y_end = min(h, (int)(blockIdx.y + 1) * kTile);
  const auto source = [&](int i, int j, float* v) {
    const int o = i * w + j;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch)
      if (ch < c) v[ch] = ldg(img + ch * hw + o);
  };

  // 1. the box of the tile's taps; 2. staged once: f32 by asynchronous
  // copies, bf16 through registers, two stored columns a pass
  const Box bx = tile_box<true>(i00, i01, t0, p, q, r, h, w, tid, kBoxPix, s_lim);
  if constexpr (sizeof(T) == sizeof(float))
    stage_box_copy<NC>(box, bx, tid, c, img, hw, w);
  else
    stage_box<NC, true>(box, bx, false, tid, c, source);
  __syncthreads();

  // 3. the taps, from the box where they fall in it
  float gray_sum = 0.0f;
  for (int y = y_begin; y < y_end && x < w; y += kTileRows) {
    const Taps tp = warp_taps(i00, i01, t0, p, q, r, (float)y, (float)x, h, w);
    float v[NC];
    blend_taps<NC>(tp, box, bx, c, source, v);
    gray_sum += tail_pixel<NC>(k, im, c, y, x, y * w + x, v);
  }
  finish_gray(a, bi, gray_sum);
}

// All 5 channels of the ultra source at row i, column j of the warp's
// input: the (transplanted if accepted) image, transposed when swap is set.
// The staged box and the taps outside it both come from here.
template <typename T>
__device__ __forceinline__ void ultra_source(const T* img, const T* don, int64_t hw, int w, int i, int j,
                                             bool swap, bool accept, float* v) {
  const int64_t px = src_offset(i, j, swap, w);
#pragma unroll
  for (int k = 0; k < kUltraC; ++k) v[k] = ld(img[k * hw + px]);
  if (accept) {
    const float d_depth = ld(don[3 * hw + px]);
    const Transplant t = transplant(v[3], v[4], d_depth, ld(don[4 * hw + px]));
    if (t.take_donor) {
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = ld(don[k * hw + px]);
      v[3] = d_depth;
    }
    v[4] = t.seg;
  }
}

// (b) ultra: the tile's source box staged in shared memory, then the taps
// (at most 64 registers: the four blocks per SM that the f32 box allows)
template <typename T>
__global__ void __launch_bounds__(kThreads, 4) stage1_ultra(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* box = reinterpret_cast<T*>(smem_raw);  // [kUltraC][rows][pitch]
  __shared__ int s_lim[4];
  const int bi = blockIdx.z;
  const int h = a.h, w = a.w;
  const Image<T> im = image_of(a, bi);
  const int64_t hw = im.hw;
  const T* img = a.img + (int64_t)bi * kUltraC * hw;
  const T* don = a.img + (int64_t)donor_of(a, bi) * kUltraC * hw;
  const float* wp = a.wp + (int64_t)bi * 7;
  const float i00 = wp[0], i01 = wp[1], t0 = wp[2], p = wp[3], q = wp[4], r = wp[5];
  const bool swap = wp[6] > 0.5f;
  const bool accept = accepted(a.counts, bi, h * w, a.lb, a.ub);
  const Chain k = chain_of(im.sv);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y_begin = blockIdx.y * kTile + threadIdx.y, y_end = min(h, (int)(blockIdx.y + 1) * kTile);
  const auto source = [&](int i, int j, float* v) { ultra_source(img, don, hw, w, i, j, swap, accept, v); };

  // 1. the box of the tile's taps; 2. staged once, two stored columns a pass
  const Box bx = tile_box<false>(i00, i01, t0, p, q, r, h, w, tid, kBoxPix, s_lim);
  stage_box<kUltraC, true>(box, bx, swap, tid, kUltraC, source);
  __syncthreads();

  // 3. the taps, from the box where they fall in it
  float gray_sum = 0.0f;
  for (int y = y_begin; y < y_end && x < w; y += kTileRows) {
    const Taps tp = warp_taps(i00, i01, t0, p, q, r, (float)y, (float)x, h, w);
    float v[kUltraC];
    blend_taps<kUltraC>(tp, box, bx, kUltraC, source, v);
    gray_sum += tail_pixel<kUltraC>(k, im, kUltraC, y, x, y * w + x, v);
  }
  finish_gray(a, bi, gray_sum);
}

// _hue_planes at one pixel, with its two floor modulos (JAX's %) written
// without fmodf, each the same bits (tests/test_torch_augment_cuda.py):
//   * the red sector's hue x = (g - b) / delta lies in [-1, 1] (|g - b| <=
//     max - min, each side rounded), where fmodf(x, 6) is x itself, so x % 6
//     is x < 0 ? x + 6 : x;
//   * y % 1 is y - floor(y), rounded once: for y < 0 that is the real
//     number fmodf(y, 1) + 1 is, rounded once there too (fmodf is exact).
//     At a negative integer y it gives +0 where fmodf's gives -0; the
//     sector and f are the same for both.
// One division for the three sectors' hue, and the sector's values picked
// by selects: no divergent branch.
__device__ __forceinline__ void hue_rotate(float r, float g, float b, float shift, float* o) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float v = maxc;
  const float delta = maxc - minc;
  const float safe_delta = delta == 0.0f ? 1.0f : delta;
  const float s = v > 0.0f ? delta / v : 0.0f;
  // ordering compares pick the max channel (not equality with maxc)
  const bool r_max = (r >= g) && (r >= b);
  const bool g_max = (g > r) && (g >= b);
  const float x = (r_max ? g - b : (g_max ? b - r : r - g)) / safe_delta;
  float hh = r_max ? (x < 0.0f ? x + 6.0f : x) : x + (g_max ? 2.0f : 4.0f);
  hh = hh / 6.0f;
  if (delta == 0.0f) hh = 0.0f;
  const float y = hh + shift;  // floor modulo: shift may be negative
  hh = y - floorf(y);
  const float h6 = hh * 6.0f;
  const float fi = floorf(h6);
  const float f = h6 - fi;
  const float pp = v * (1.0f - s);
  const float qq = v * (1.0f - s * f);
  const float tt = v * (1.0f - s * (1.0f - f));
  int i = (int)fi;  // 0 .. 6: 6 when hh rounds up to 1, which is sector 0
  if (i == 6) i = 0;
  o[0] = (i == 0 || i == 5) ? v : (i == 1 ? qq : (i == 4 ? tt : pp));
  o[1] = (i == 1 || i == 2) ? v : (i == 0 ? tt : (i == 3 ? qq : pp));
  o[2] = (i == 3 || i == 4) ? v : (i == 2 ? tt : (i == 5 ? qq : pp));
}

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);  // rows of a ragged tile past the image: unused
}

// (c) contrast, saturation, hue, blur, shadow on a 64x32 tile + halo.
// kS2Threads = 4 x 68: a thread owns one halo column (its reflect-padded
// source column fixed) and every 4th row of it, and one column segment of
// the vertical pass per pass, so each phase divides evenly. vec: w % 4 == 0
// and the output and plasma bases aligned, so a 4-pixel segment of a row
// moves as one word.
template <typename T>
__global__ void __launch_bounds__(kS2Threads, 4) stage2(Args<T> a, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_in = reinterpret_cast<float*>(smem_raw);  // [3][kS2HaloH][kS2Pitch]: the halo's colour
  float* s_v = s_in + 3 * kS2HaloH * kS2Pitch;       // [3][kS2H][kS2Pitch]: the vertical pass
  const int bi = blockIdx.z;
  const int h = a.h, w = a.w, hw = h * w;
  const float* sv = a.sv + (int64_t)bi * kScalars;
  const float* rgb = a.rgb + (int64_t)bi * 3 * hw;
  const int y0 = blockIdx.y * kS2H, x0 = blockIdx.x * kS2W;
  const int tid = threadIdx.x, col = tid % kS2HaloW, row0 = tid / kS2HaloW;
  const float f_c = sv[13], f_s = sv[14], f_h = sv[15];
  const float c_mean = (1.0f - f_c) * __ldg(a.mean + bi), s_keep = 1.0f - f_s;
  // the halo inside the image (most tiles): no reflection
  const bool inside = x0 >= 2 && y0 >= 2 && x0 + kS2W + 2 <= w && y0 + kS2H + 2 <= h;
  const float* src_col = rgb + (inside ? x0 + col - 2 : reflect(x0 + col - 2, w));
  const auto src_row = [&](int row) { return (inside ? y0 + row - 2 : reflect(y0 + row - 2, h)) * w; };

  // 1. the colour of every halo pixel, once, two rows (4 apart) at a time:
  // both rows' reads go out first, and the two colour chains interleave
  const auto colour = [&](float* v) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) v[ch] = clip01(f_c * v[ch] + c_mean);
    const float gray = v[0] * 0.299f + v[1] * 0.587f + v[2] * 0.114f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) v[ch] = clip01(f_s * v[ch] + s_keep * gray);
    if (f_h != 0.0f) {  // the HSV round trip is not exact at shift 0: keep the input then
      float hue[3];
      hue_rotate(v[0], v[1], v[2], f_h, hue);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) v[ch] = clip01(hue[ch]);
    }
  };
  const auto load_row = [&](int row, float* v) {
    const int o = src_row(row);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) v[ch] = ldg(src_col + ch * hw + o);
  };
  for (int row = row0; row < kS2HaloH; row += 8) {
    const bool two = row + 4 < kS2HaloH;
    float v[3], u[3];
    load_row(row, v);
    load_row(two ? row + 4 : row, u);
    colour(v);
    colour(u);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      s_in[(ch * kS2HaloH + row) * kS2Pitch + col] = v[ch];
      if (two) s_in[(ch * kS2HaloH + row + 4) * kS2Pitch + col] = u[ch];
    }
  }
  __syncthreads();
  const bool blur_on = sv[16] > 0.5f;
  float taps[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) taps[k] = sv[17 + k];
  if (blur_on) {  // 2. vertical pass: column segments of 4 output rows
    for (int seg = row0; seg < kS2H / 4; seg += 4) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float* src = s_in + (ch * kS2HaloH + 4 * seg) * kS2Pitch + col;
        float in[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) in[k] = src[k * kS2Pitch];
        float* dst = s_v + (ch * kS2H + 4 * seg) * kS2Pitch + col;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float acc = taps[0] * in[k];
#pragma unroll
          for (int t = 1; t < 5; ++t) acc = acc + taps[t] * in[k + t];
          dst[k * kS2Pitch] = acc;
        }
      }
    }
    __syncthreads();
  }
  // 3. horizontal pass, shadow, store: row segments of 4 outputs (two
  // 16-byte reads of s_v cover their 8 taps)
  const float intensity = sv[22], quantity = sv[23];
  const __nv_bfloat16* plasma = a.plasma + (int64_t)bi * hw;
  T* out = a.out + (int64_t)bi * a.c * hw;
  for (int idx = tid; idx < kS2H * (kS2W / 4); idx += kS2Threads) {
    const int ty = idx / (kS2W / 4), tx = 4 * (idx % (kS2W / 4));  // powers of two: shifts
    const int y = y0 + ty, x = x0 + tx;
    if (y >= h || x >= w) continue;
    const int px = y * w + x;
    float sh[4];
    if (vec) {
      ldg4(plasma + px, sh);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) sh[i] = x + i < w ? ldg(plasma + px + i) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sh[i] = intensity * (sh[i] < quantity ? 1.0f : 0.0f);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v[4];
      if (blur_on) {
        const float* src = s_v + (ch * kS2H + ty) * kS2Pitch + tx;
        float in[8];
        load4(src, in);
        load4(src + 4, in + 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float val = taps[0] * in[i];
#pragma unroll
          for (int t = 1; t < 5; ++t) val = val + taps[t] * in[i + t];
          v[i] = val;
        }
      } else {
        const float* src = s_in + (ch * kS2HaloH + ty + 2) * kS2Pitch + tx + 2;
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = src[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = clip01(v[i] + sh[i]);
      if (vec) {
        store4(out + ch * hw + px, v);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (x + i < w) out[ch * hw + px + i] = st<T>(v[i]);
      }
    }
  }
}

// Stage 1 of the chain and the warp at C = NC (kAnyC: 6-8 at run time).
template <typename T, int NC>
int launch_stage1(int mode, const Args<T>& a, dim3 grid, dim3 block, cudaStream_t s) {
  if (mode == 0) {
    const bool vec = a.w % 4 == 0 && aligned4<T>(a.img) && aligned4<T>(a.out) && aligned4<__nv_bfloat16>(a.fields);
    stage1_chain<T, NC><<<grid, block, 0, s>>>(a, vec);
  } else {
    const int box_bytes = a.c * kBoxPix * (int)sizeof(T);
    const int err = (int)cudaFuncSetAttribute(stage1_warp<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, box_bytes);
    if (err) return err;
    stage1_warp<T, NC><<<grid, block, box_bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run(int mode, const void* img, void* out, const void* sv, const void* fields,
        const void* plasma, const void* wp, const void* donor, void* scratch, int b, int c, int h,
        int w, float lb, float ub, void* stream) {
  if (b == 0 || h == 0 || w == 0) return 0;
  if (c < 3 || c > kMaxC || (mode == 2 && c != kUltraC) || mode < 0 || mode > 2 || b > 65535 ||
      (int64_t)c * h * w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Scratch lay = scratch_layout(b, h, w);
  char* base = (char*)scratch;
  Args<T> a{(const T*)img, (T*)out, (const float*)sv, (const __nv_bfloat16*)fields,
            (const __nv_bfloat16*)plasma, (const float*)wp, (const int*)donor,
            (int*)(base + lay.counts), (int*)(base + lay.tickets), (float*)(base + lay.partial),
            (float*)(base + lay.mean), (float*)(base + lay.rgb), b, c, h, w, tiles_of(h, w), lb, ub};
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  // the seg counts and the tile tickets start at 0
  if ((err = (int)cudaMemsetAsync(base + lay.counts, 0, lay.bytes - lay.counts, s))) return err;
  if (mode == 2) {
    const int hw = h * w;
    const bool vec = hw % 4 == 0 && ((uintptr_t)img % 16) == 0;
    seg_count<T><<<dim3((hw + kCountPix - 1) / kCountPix, b), kThreads, 0, s>>>(a, vec);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b), block(kTile, kTileRows);
  if (mode == 2) {
    const int box_bytes = kUltraC * kBoxPix * (int)sizeof(T);
    err = (int)cudaFuncSetAttribute(stage1_ultra<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, box_bytes);
    if (err) return err;
    stage1_ultra<T><<<grid, block, box_bytes, s>>>(a);
    err = (int)cudaGetLastError();
  } else if (c == 3) {
    err = launch_stage1<T, 3>(mode, a, grid, block, s);
  } else if (c == 4) {
    err = launch_stage1<T, 4>(mode, a, grid, block, s);
  } else if (c == 5) {
    err = launch_stage1<T, 5>(mode, a, grid, block, s);
  } else {
    err = launch_stage1<T, kAnyC>(mode, a, grid, block, s);
  }
  if (err) return err;
  if ((err = (int)cudaFuncSetAttribute(stage2<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kS2Smem))) return err;
  const bool vec2 = w % 4 == 0 && aligned4<T>(out) && aligned4<__nv_bfloat16>(plasma);
  stage2<T><<<dim3((w + kS2W - 1) / kS2W, (h + kS2H - 1) / kS2H, b), kS2Threads, kS2Smem, s>>>(a, vec2);
  return (int)cudaGetLastError();
}

// The standalone two-pass warp on a 32x32 output tile of image blockIdx.z,
// the design of stage1_ultra: the tile's source box staged once in shared
// memory (f32), the taps read from it. wp is (B, 7), (i00, i01, t0, p, q,
// r, swap). C = kWarpC channels at compile time, in one pass with the
// per-pixel values in registers; C = 0: any c, in passes of up to kWarpC
// channels. Offsets inside an image are 32-bit (the launch checks c h w <
// 2^31).
template <int C>
__global__ void __launch_bounds__(kThreads, 4)
warp_two_pass(const float* __restrict__ img, float* __restrict__ out, const float* __restrict__ wp, int c,
              int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* box = reinterpret_cast<float*>(smem_raw);  // [kWarpC][rows][pitch]
  __shared__ int s_lim[4];
  const int cc = C > 0 ? C : c;
  const int bi = blockIdx.z, hw = h * w;
  const float* prm = wp + (int64_t)bi * 7;
  const float i00 = prm[0], i01 = prm[1], t0 = prm[2], p = prm[3], q = prm[4], r = prm[5];
  const bool swap = prm[6] > 0.5f;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y_begin = blockIdx.y * kTile + threadIdx.y, y_end = min(h, (int)(blockIdx.y + 1) * kTile);
  const Box bx = tile_box<true>(i00, i01, t0, p, q, r, h, w, tid, kWarpBoxPix, s_lim);
  for (int k0 = 0; k0 < cc; k0 += kWarpC) {
    const int nc = C > 0 ? C : min(kWarpC, cc - k0);
    const float* src = img + ((int64_t)bi * cc + k0) * hw;
    float* dst = out + ((int64_t)bi * cc + k0) * hw;
    // the warp input's (i, j): the stored image's, or its (j, i) when swapped
    const auto source = [&](int i, int j, float* v) {
      const int o = swap ? j * w + i : i * w + j;
#pragma unroll
      for (int k = 0; k < kWarpC; ++k)
        if (k < nc) v[k] = src[k * hw + o];
    };
    if (k0 > 0) __syncthreads();  // every tap of the last pass has been read
    stage_box<kWarpC, false>(box, bx, swap, tid, nc, source);
    __syncthreads();
    for (int y = y_begin; y < y_end && x < w; y += kTileRows) {
      const Taps tp = warp_taps(i00, i01, t0, p, q, r, (float)y, (float)x, h, w);
      float v[kWarpC];
      blend_taps<kWarpC>(tp, box, bx, nc, source, v);
#pragma unroll
      for (int k = 0; k < kWarpC; ++k)
        if (k < nc) dst[k * hw + y * w + x] = v[k];
    }
  }
}

}  // namespace

extern "C" int perseus_warp_affine_f32(const void* img, void* out, const void* wp, int b, int c,
                                       int h, int w, void* stream) {
  if (b == 0 || c == 0 || h == 0 || w == 0) return 0;
  if (h != w || b > 65535 || (int64_t)c * h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b), block(kTile, kTileRows);
  const int box_bytes = kWarpC * kWarpBoxPix * (int)sizeof(float);
  const auto kernel = c == kWarpC ? warp_two_pass<kWarpC> : warp_two_pass<0>;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, box_bytes);
  if (err) return err;
  kernel<<<grid, block, box_bytes, (cudaStream_t)stream>>>((const float*)img, (float*)out, (const float*)wp,
                                                             c, h, w);
  return (int)cudaGetLastError();
}

extern "C" int64_t perseus_fused_augment_scratch_bytes(int b, int h, int w) {
  return scratch_layout(b, h, w).bytes;
}

extern "C" int perseus_fused_augment_f32(int mode, const void* img, void* out, const void* sv,
                                         const void* fields, const void* plasma, const void* wp,
                                         const void* donor, void* scratch, int b, int c, int h,
                                         int w, float lb, float ub, void* stream) {
  return run<float>(mode, img, out, sv, fields, plasma, wp, donor, scratch, b, c, h, w, lb, ub,
                    stream);
}

extern "C" int perseus_fused_augment_bf16(int mode, const void* img, void* out, const void* sv,
                                          const void* fields, const void* plasma, const void* wp,
                                          const void* donor, void* scratch, int b, int c, int h,
                                          int w, float lb, float ub, void* stream) {
  return run<__nv_bfloat16>(mode, img, out, sv, fields, plasma, wp, donor, scratch, b, c, h, w,
                            lb, ub, stream);
}
