// Stem maxpool of the ResNet-18 detector: MaxPool2d(kernel 3, stride 2,
// padding 1) with -inf padding, forward and gradient, over NCHW-contiguous
// batches.
//
// FORWARD. Replaces perseus_tpu/models/pool_pallas.py::_fwd_kernel (through
// max_pool_3x3_s2_pallas). The TPU kernel packs the W parity split into
// lanes, (B, H, W/2, 2C), and so needs even H and W; both exist only because
// Mosaic cannot slice vectors with a stride. Here the kernel is a direct
// windowed max over any H and W.
//
// Compares run in f32 for both dtypes, as the TPU kernel does; the selected
// input is stored as it was (bf16 moves by its bits), so the output holds
// input values bit for bit. NaN propagates like torch.maximum: the first NaN
// met in window order wins (fmaxf would drop it).
//
// Tiling (Hopper redesign): a thread owns 8 consecutive outputs of one
// output row, and loads the 3 x 17 inputs their windows cover once into
// registers, row by row: 16 columns as 16-byte words where the tensor
// allows it (aligned, rows a multiple of 16 bytes), the left halo column by
// a scalar load. It writes its 8 outputs as one (bf16) or two (f32) 16-byte
// stores. The ragged right edge, odd sizes and unaligned views take scalar
// accesses with the same arithmetic. Block x covers 256 such cells of one
// plane, block y walks the planes; offsets are 32-bit inside a plane and the
// cell is found with one division per thread. (The first version ran one
// thread per output and found its plane, row and column with 64-bit
// divisions per element, two subroutine calls in its SASS, and made nine
// 2-byte loads per output: 0.72 ms at the stem's bf16 shape.)
//
// Bound on this card: bytes. Each output reads nine inputs and does at most
// nine compares, far below the compute rate, so the least time is one read
// of x and one write of y at the memory rate: 0.2003 ms at (256, 64, 128,
// 128) bf16, 0.4006 in f32. Measured (chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700.00 W): 0.26 ms in bf16, 0.43-0.45 in f32; at the serving
// frame's (1, 64, 128, 128) 3 us of device time, under the ~10 us of host
// time a call takes (see the Python binding below).
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
// Python binding: the library is also the extension module perseus_maxpool
// (CPython's C API, METH_FASTCALL), whose fwd and bwd launch on the
// tensors' device (made current for the launch only when it is not) and
// return cudaGetLastError() after the launch, 0 when there is nothing to do.
// At batch 1 the serving frame pays the wrapper's host time, not the
// kernel's: a call converts its arguments in ~0.1 us here, where ctypes
// took ~1.6 us (chip_smoke.py's host path split, on the H100's host).

#define PY_SSIZE_T_CLEAN
#include <Python.h>  // first, as Python's headers ask

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// bf16 <-> f32 by their bits: a bf16 is the top half of the f32 of the same
// value, so these are exact for every value, NaN payloads included, and the
// forward stores the selected input as it was.
__device__ __forceinline__ float lo_bits(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bits(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float load_bits(const float* p) { return *p; }
__device__ __forceinline__ float load_bits(const __nv_bfloat16* p) {
  return lo_bits(*reinterpret_cast<const uint16_t*>(p));
}
__device__ __forceinline__ void store_bits(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_bits(__nv_bfloat16* p, float v) {
  *reinterpret_cast<uint16_t*>(p) = (uint16_t)(__float_as_uint(v) >> 16);
}

// 16 consecutive values from 16-byte words (the pointer is 16-byte aligned)
__device__ __forceinline__ void load16_bits(const float* p, float* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = reinterpret_cast<const float4*>(p)[k];
    v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = a.z; v[4 * k + 3] = a.w;
  }
}
__device__ __forceinline__ void load16_bits(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[k];
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {  // little endian: the lower address is the low half
      v[8 * k + 2 * m] = lo_bits(words[m]);
      v[8 * k + 2 * m + 1] = hi_bits(words[m]);
    }
  }
}
// 8 consecutive values as 16-byte words (two for f32, one for bf16)
__device__ __forceinline__ void store8_bits(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8_bits(__nv_bfloat16* p, const float* v) {
  uint32_t words[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    words[m] = (__float_as_uint(v[2 * m]) >> 16) | (__float_as_uint(v[2 * m + 1]) & 0xffff0000u);
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
}

constexpr int kFwdThreads = 256;

// One thread owns the 8 outputs (p, q0 .. q0 + 7) of one plane, a cell: its
// windows cover input rows 2p - 1 .. 2p + 1 and columns c0 - 1 .. c0 + 15,
// c0 = 2 q0. Row by row it loads the 17 columns once into registers (the 16
// from c0 as 16-byte words where `vec_in`, the halo column c0 - 1 by a
// scalar load) and updates the 8 running maxima, so each output still meets
// its nine taps in window order. A tap past the edge is -inf, which changes
// no maximum: the same as the padding. The 8 outputs go out as 16-byte words
// where `vec_out`. `vec_in` / `vec_out`: x / y is 16-byte aligned and its
// rows are a multiple of 16 bytes; the ragged last cell of a row, odd sizes
// and unaligned views take scalar loads and stores of the same arithmetic.
// Block x covers 256 cells of a plane, block y walks the planes; offsets
// inside a plane are 32-bit (the launch checks H W < 2^31) and the cell is
// found with one division.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
maxpool3x3s2_fwd(const T* __restrict__ x, T* __restrict__ y, int64_t planes, int h, int w, int ho, int wo,
                 bool vec_in, bool vec_out) {
  const int ncg = (wo + 7) >> 3;
  const int cell = blockIdx.x * kFwdThreads + threadIdx.x;
  if (cell >= ho * ncg) return;
  const int p = cell / ncg;
  const int q0 = (cell - p * ncg) * 8, c0 = 2 * q0;
  const bool full_in = vec_in && c0 + 16 <= w;
  const bool full_out = vec_out && q0 + 8 <= wo;
  for (int64_t plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const T* xp = x + plane * h * w;
    // every window has an in-range tap (row 2p, column 2q), so the -inf
    // start is always replaced or equal to what is selected
    float best[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) best[k] = -INFINITY;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int row = 2 * p - 1 + r;
      if (row < 0 || row >= h) continue;
      const T* xr = xp + row * w;
      float v[17];  // columns c0 - 1 .. c0 + 15
      v[0] = c0 > 0 ? load_bits(xr + c0 - 1) : -INFINITY;
      if (full_in) {
        load16_bits(xr + c0, v + 1);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k + 1] = c0 + k < w ? load_bits(xr + c0 + k) : -INFINITY;
      }
      // compares in f32; the first NaN met in window order wins (a NaN
      // best takes nothing more), else the first of equal maxima
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float t = v[2 * k + kx];
          if (best[k] == best[k] && (t != t || t > best[k])) best[k] = t;
        }
      }
    }
    T* yr = y + plane * ho * wo + p * wo + q0;
    if (full_out) {
      store8_bits(yr, best);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (q0 + k < wo) store_bits(yr + k, best[k]);
    }
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
               void* stream) {
  if (planes == 0 || h == 0 || w == 0) return 0;
  if ((int64_t)h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int cells = ((h + 1) >> 1) * ((w + 7) >> 3);
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  const bool vec = aligned(x) && aligned(dx) && ((int64_t)w * sizeof(T)) % 16 == 0;
  const dim3 grid((unsigned)((cells + kBwdThreads - 1) / kBwdThreads),
                  (unsigned)(planes < 65535 ? planes : 65535));
  maxpool3x3s2_bwd<T><<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)y, (const T*)g, (T*)dx, planes, h, w, (h + 1) / 2, (w + 1) / 2, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, int64_t planes, int h, int w, void* stream) {
  if (planes == 0 || h == 0 || w == 0) return 0;
  if ((int64_t)h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;  // floor((n + 2 - 3) / 2) + 1
  const int cells = ho * ((wo + 7) >> 3);
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  const bool vec_in = aligned(x) && ((int64_t)w * sizeof(T)) % 16 == 0;
  const bool vec_out = aligned(y) && ((int64_t)wo * sizeof(T)) % 16 == 0;
  const dim3 grid((unsigned)((cells + kFwdThreads - 1) / kFwdThreads),
                  (unsigned)(planes < 65535 ? planes : 65535));
  maxpool3x3s2_fwd<T><<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, planes, h, w, ho, wo, vec_in, vec_out);
  return (int)cudaGetLastError();
}

// Runs `launch` with `device` current: as it is, or made current for the
// launch alone (the tensors' device, whose current stream the caller
// passes). Returns the first CUDA error.
template <typename Launch>
int on_device(int device, Launch launch) {
  int current;
  int err = (int)cudaGetDevice(&current);
  if (err || current == device) return err ? err : launch();
  if ((err = (int)cudaSetDevice(device))) return err;
  err = launch();
  const int restored = (int)cudaSetDevice(current);
  return err ? err : restored;
}

// (bf16, the NPTR tensors' pointers, planes, H, W, device, stream) of a call
template <int NPTR>
bool parse_args(PyObject* const* a, Py_ssize_t n, const char* name, bool* bf16, void** ptr, int64_t* planes,
                int* h, int* w, int* device, void** stream) {
  if (n != NPTR + 6) {
    PyErr_Format(PyExc_TypeError, "%s takes %d arguments, got %zd", name, NPTR + 6, n);
    return false;
  }
  *bf16 = PyObject_IsTrue(a[0]) == 1;
  for (int k = 0; k < NPTR; ++k) ptr[k] = PyLong_AsVoidPtr(a[1 + k]);
  *planes = PyLong_AsLongLong(a[NPTR + 1]);
  *h = (int)PyLong_AsLong(a[NPTR + 2]);
  *w = (int)PyLong_AsLong(a[NPTR + 3]);
  *device = (int)PyLong_AsLong(a[NPTR + 4]);
  *stream = PyLong_AsVoidPtr(a[NPTR + 5]);
  return !PyErr_Occurred();
}

// fwd(bf16, x, y, planes, h, w, device, stream): y is (planes, (H + 1) / 2,
// (W + 1) / 2)
PyObject* py_fwd(PyObject*, PyObject* const* a, Py_ssize_t n) {
  bool bf16;
  void *p[2], *stream;
  int64_t planes;
  int h, w, device;
  if (!parse_args<2>(a, n, "fwd", &bf16, p, &planes, &h, &w, &device, &stream)) return nullptr;
  return PyLong_FromLong(on_device(device, [&] {
    return bf16 ? launch<__nv_bfloat16>(p[0], p[1], planes, h, w, stream) : launch<float>(p[0], p[1], planes, h, w, stream);
  }));
}

// bwd(bf16, x, y, g, dx, planes, h, w, device, stream)
PyObject* py_bwd(PyObject*, PyObject* const* a, Py_ssize_t n) {
  bool bf16;
  void *p[4], *stream;
  int64_t planes;
  int h, w, device;
  if (!parse_args<4>(a, n, "bwd", &bf16, p, &planes, &h, &w, &device, &stream)) return nullptr;
  return PyLong_FromLong(on_device(device, [&] {
    return bf16 ? launch_bwd<__nv_bfloat16>(p[0], p[1], p[2], p[3], planes, h, w, stream)
                : launch_bwd<float>(p[0], p[1], p[2], p[3], planes, h, w, stream);
  }));
}

PyMethodDef kMethods[] = {
    {"fwd", (PyCFunction)(void (*)(void))py_fwd, METH_FASTCALL,
     "fwd(bf16, x, y, planes, h, w, device, stream) -> cudaError"},
    {"bwd", (PyCFunction)(void (*)(void))py_bwd, METH_FASTCALL,
     "bwd(bf16, x, y, g, dx, planes, h, w, device, stream) -> cudaError"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "perseus_maxpool", "The stem maxpool's CUDA kernels.", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_perseus_maxpool(void) { return PyModule_Create(&kModule); }
