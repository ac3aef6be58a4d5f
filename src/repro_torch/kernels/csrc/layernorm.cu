// LayerNorm for Hopper (sm_90a), one row per block:
//   mu = sum(x[r, :]) / d
//   var = sum((x[r, :] - mu)^2) / d
//   out[r, :] = ((x[r, :] - mu) * (1 / sqrt(var + eps))) * scale + bias
// with fp32 statistics, scale and bias read as fp32, and the output in x's
// dtype (fp32 or bf16), each step one IEEE rounding in that order (never
// contracted into an FMA).  scale and bias are stored as fp32 or bf16 (one
// dtype for both), so a model's norm costs one launch and no fp32 copy.
//
// Replaces no TPU kernel: the reference's layernorm
// (src/repro/models/layers/norms.py:32-39) is jnp left to XLA.  The port
// needs it as a kernel because Whisper's encoder-decoder runs 62 LayerNorms
// a forward (25 in the encoder, 37 in the decoder), and each row's
// statistics must not depend on how many rows share the launch: a decode
// batch of 8 has to give each row the bits it has alone (before this kernel
// the port summed them in fp64 for that reason).
//
// What bounds it on this card (H100 SXM: 3.35 TB/s): a handful of
// operations an element read, far below the card's operations-per-byte
// line, so the bytes: x read once and the output written once.  At
// Whisper's encoder rows (8 x 1,500, 768) bf16 that is 36.9 MB, 11 us;
// a decode step's (8, 768) is a few KB, where the launch dominates.
//
// How the design meets it (rmsnorm.cu's layout and order):
//   * one block of 256 threads per row; a row is cut into 16-byte chunks
//     (8 bf16 or 4 fp32 elements), chunk c belongs to thread c % 256, and
//     each thread sums its chunks' elements in order.  A chunk is loaded as
//     one 16-byte vector when the row allows it and element by element
//     otherwise, in the same order, so the result never depends on the path;
//   * the 256 partial sums meet in a fixed tree: common.cuh's xor butterfly
//     in each warp, then the 8 warp sums added in warp order by one thread.
//     The mean and the centred variance each take that order, which depends
//     on the row width (and x's dtype, the chunk) alone, never on the number
//     of rows, so a row's result is the same in a batch of 8 and of 1;
//   * the variance sums (x - mu)^2 over the row's d elements only, a
//     multiply then an add;
//   * the row is read three times (the two statistics and the output), the
//     second and third from L1/L2 (a 768-wide bf16 row is 1.5 KB), so
//     device memory sees x once.
// The plain version in layernorm.py takes the same order in PyTorch, step
// for step.
//
// X and out are (rows, d) contiguous, scale and bias (d,).  The C launcher
// takes PyTorch's current stream, allocates nothing and returns
// cudaGetLastError().

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

// The block's 256 per-thread sums in the fixed tree; every thread gets the
// row's total divided by d.  part and total are the block's shared slots;
// the barrier on entry keeps a previous call's readers ahead of the writes.
__device__ __forceinline__ float row_mean(float s, int d, float (&part)[kWarps],
                                          float& total) {
  s = port::warp_sum(s);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = part[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) t = __fadd_rn(t, part[i]);
    total = __fdiv_rn(t, static_cast<float>(d));
  }
  __syncthreads();
  return total;
}

// grid (rows); block kThreads
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ X, const W* __restrict__ scale,
                 const W* __restrict__ bias, T* __restrict__ out, int d, float eps, bool vec) {
  constexpr int V = Chunk<T>::n;
  const long long row = blockIdx.x;
  const T* x = X + row * d;
  T* o = out + row * d;
  __shared__ float part[kWarps];
  __shared__ float total;

  float s = 0.f;
  for (long long e0 = (long long)threadIdx.x * V; e0 < d; e0 += (long long)kThreads * V) {
    float v[V];
    load_chunk(x, e0, d, vec, v);
#pragma unroll
    for (int i = 0; i < V; ++i) s = __fadd_rn(s, v[i]);
  }
  const float mu = row_mean(s, d, part, total);

  s = 0.f;
  for (long long e0 = (long long)threadIdx.x * V; e0 < d; e0 += (long long)kThreads * V) {
    float v[V];
    load_chunk(x, e0, d, vec, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (e0 + i < d) {
        const float c = __fsub_rn(v[i], mu);
        s = __fadd_rn(s, __fmul_rn(c, c));
      }
    }
  }
  const float var = row_mean(s, d, part, total);
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));

  for (long long e0 = (long long)threadIdx.x * V; e0 < d; e0 += (long long)kThreads * V) {
    float v[V];
    load_chunk(x, e0, d, vec, v);
    float y[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const long long e = e0 + i < d ? e0 + i : 0;
      y[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mu), r), to_f32(scale[e])),
                       to_f32(bias[e]));
    }
    if (vec && e0 + V <= d) {
      uint4 raw;
      T* p = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) store(y[i], p + i);
      *reinterpret_cast<uint4*>(o + e0) = raw;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (e0 + i < d) store(y[i], o + e0 + i);
      }
    }
  }
}

template <typename T, typename W>
int launch(const void* X, const void* scale, const void* bias, void* out, int rows, int d,
           float eps, cudaStream_t s) {
  constexpr int V = Chunk<T>::n;
  const bool vec = d % V == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  layernorm_kernel<T, W><<<rows, kThreads, 0, s>>>(
      static_cast<const T*>(X), static_cast<const W*>(scale), static_cast<const W*>(bias),
      static_cast<T*>(out), d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_w(int wdtype, const void* X, const void* scale, const void* bias, void* out,
             int rows, int d, float eps, cudaStream_t s) {
  if (wdtype == 0) return launch<T, float>(X, scale, bias, out, rows, d, eps, s);
  if (wdtype == 1) return launch<T, __nv_bfloat16>(X, scale, bias, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = fp32 x and out, 1 = bf16; wdtype: the same codes for scale and
// bias.  Returns a cudaError_t as int (0 = launched).
extern "C" int layernorm_launch(int dtype, int wdtype, const void* X, const void* scale,
                                const void* bias, void* out, int rows, int d, float eps,
                                void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_w<float>(wdtype, X, scale, bias, out, rows, d, eps, s);
  if (dtype == 1) return launch_w<__nv_bfloat16>(wdtype, X, scale, bias, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
