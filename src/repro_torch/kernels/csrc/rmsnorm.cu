// RMSNorm for Hopper (sm_90a), one row per block:
//   out[r, :] = x[r, :] * (1 / sqrt(mean(x[r, :]^2) + eps)) * w
// with fp32 statistics, w read as fp32, and the output in x's dtype
// (fp32 or bf16), multiplied in that order: (x * r) * w.  w is stored as
// fp32 or bf16; with plus_one the kernel takes w = 1 + (float)w, the
// model's (1 + scale) form, so the caller makes no fp32 copy of it.
//
// Replaces the Pallas TPU kernel rmsnorm_pallas of
// src/repro/kernels/rmsnorm.py (pallas_call at :43, _rmsnorm_kernel at :23).
//
// What bounds it on this card (H100 SXM: 3.35 TB/s): one multiply-add per
// element read, far below the card's operations-per-byte line, so the bytes
// are the whole cost: x read once and the output written once.  At the
// served shapes that is 2 x 1024 x 2560 x 2 bytes = 10.5 MB for a Mamba2
// prefill row block (3.1 us) and a few tens of KB for a decode step, where
// the launch itself dominates.
//
// How the design meets it:
//   * one block of 256 threads per row; a row is cut into 16-byte chunks
//     (8 bf16 or 4 fp32 elements), chunk c belongs to thread c % 256, and
//     each thread sums the squares of its chunks in order.  The chunk is
//     loaded as one 16-byte vector when the row allows it (width a multiple
//     of the chunk, both bases 16-byte aligned) and element by element
//     otherwise, in the same order, so the result never depends on the path;
//   * the 256 partial sums meet in a fixed tree: a butterfly of shuffles in
//     each warp, then the 8 warp sums added in warp order by one thread.
//     The order depends on the row width alone, never on the number of rows
//     or on which block runs first, so a row's result is the same in a
//     batch of 8 and of 1 (the serving engine's continuous batching relies
//     on that; it is why the port's norms no longer sum in fp64);
//   * the second pass re-reads the row (from L1/L2: a 2560-wide bf16 row is
//     5 KB) and writes it scaled, so device memory sees x once.
//
// The statistics and the scaling are common.cuh's (port::sq_add,
// port::warp_sum, port::rms_inv, port::rms_scale), which the norm prologues
// of fixed_linear.cu and quant_matmul.cu's qmm_group share: a row they
// normalise is bitwise the row this kernel writes.
//
// X and out are (rows, d) contiguous, w (d,) fp32 or bf16.  The C launcher takes
// PyTorch's current stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = port::kRmsThreads;
constexpr int kWarps = port::kRmsWarps;

// elements in a 16-byte chunk
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int n = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
};

using port::to_f32;
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

// The chunk of a row starting at element e0, as floats; elements past d are 0.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, long long e0, int d,
                                           bool vec, float (&v)[Chunk<T>::n]) {
  constexpr int V = Chunk<T>::n;
  if (vec && e0 + V <= d) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + e0);
    const T* p = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = e0 + i < d ? to_f32(row[e0 + i]) : 0.f;
  }
}

// grid (rows); block kThreads
template <typename T, typename W, bool kPlusOne>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ X, const W* __restrict__ w, T* __restrict__ out,
               int d, float eps, bool vec) {
  constexpr int V = Chunk<T>::n;
  const long long row = blockIdx.x;
  const T* x = X + row * d;
  T* o = out + row * d;

  float s = 0.f;
  for (long long e0 = (long long)threadIdx.x * V; e0 < d; e0 += (long long)kThreads * V) {
    float v[V];
    load_chunk(x, e0, d, vec, v);
#pragma unroll
    for (int i = 0; i < V; ++i) s = port::sq_add(s, v[i]);
  }
  s = port::warp_sum(s);
  __shared__ float part[kWarps];
  __shared__ float inv;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) inv = port::rms_inv(part, d, eps);
  __syncthreads();
  const float r = inv;

  for (long long e0 = (long long)threadIdx.x * V; e0 < d; e0 += (long long)kThreads * V) {
    float v[V];
    load_chunk(x, e0, d, vec, v);
    if (vec && e0 + V <= d) {
      uint4 raw;
      T* p = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        store(port::rms_scale(v[i], r, port::norm_weight(w, e0 + i, kPlusOne)), p + i);
      }
      *reinterpret_cast<uint4*>(o + e0) = raw;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (e0 + i < d) {
          store(port::rms_scale(v[i], r, port::norm_weight(w, e0 + i, kPlusOne)), o + e0 + i);
        }
      }
    }
  }
}

template <typename T, typename W, bool kPlusOne>
int launch(const void* X, const void* w, void* out, int rows, int d, float eps,
           cudaStream_t s) {
  constexpr int V = Chunk<T>::n;
  const bool vec = d % V == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  rmsnorm_kernel<T, W, kPlusOne><<<rows, kThreads, 0, s>>>(
      static_cast<const T*>(X), static_cast<const W*>(w), static_cast<T*>(out), d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_w(int wdtype, bool plus_one, const void* X, const void* w, void* out, int rows,
             int d, float eps, cudaStream_t s) {
  if (wdtype == 0) {
    return plus_one ? launch<T, float, true>(X, w, out, rows, d, eps, s)
                    : launch<T, float, false>(X, w, out, rows, d, eps, s);
  }
  if (wdtype == 1) {
    return plus_one ? launch<T, __nv_bfloat16, true>(X, w, out, rows, d, eps, s)
                    : launch<T, __nv_bfloat16, false>(X, w, out, rows, d, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = fp32 x and out, 1 = bf16; wdtype: the same codes for w; plus_one:
// w is taken as 1 + w.  Returns a cudaError_t as int (0 = launched).
extern "C" int rmsnorm_launch(int dtype, int wdtype, int plus_one, const void* X,
                              const void* w, void* out, int rows, int d, float eps,
                              void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_w<float>(wdtype, plus_one != 0, X, w, out, rows, d, eps, s);
  if (dtype == 1) {
    return launch_w<__nv_bfloat16>(wdtype, plus_one != 0, X, w, out, rows, d, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
