// LM head for Hopper (sm_90a): fp32 logits from bf16 or fp32 operands,
//   tied     logits[m, v] = sum_d x[m, d] * W[v, d]     W (V, D), the token table
//   untied   logits[m, v] = sum_d x[m, d] * H[d, v]     H (D, V), the head table
// each product exact in fp32 (bf16 x bf16 fits its 24-bit significand),
// summed in fp32 in one order fixed by D alone.
//
// Replaces no TPU kernel: the reference's logits_from
// (src/repro/models/layers/embedding.py:34-40) is an einsum with
// preferred_element_type=float32 that it leaves to XLA.  The kernel exists
// for the port's batch invariance.  The serving engine's continuous batching
// must give the slot-at-a-time oracle's greedy streams, so a row's logits
// may not depend on how many rows share the call; a cuBLAS product picks its
// summation order by shape, which is why the head summed in fp64 (and kept
// an fp64 copy of the table) before this kernel.  So:
//   * tied: the D axis is cut into chunks of 8 elements (16 bytes of bf16);
//     chunk c belongs to lane c % 32 of a warp, which runs one fma chain over
//     its chunks in index order, each chunk's elements in order; the 32 lane
//     sums meet in a fixed xor butterfly (every lane ends with the same
//     value, since fp32 addition is commutative);
//   * untied: one thread runs one fma chain over d in index order for each
//     of its 8 columns;
//   * either way the chain of (m, v) depends on D alone, never on M, on the
//     M-tile the row falls in, or on which vocab rows share a warp, so row m
//     is bitwise the same at M = 1 and M = 8.
// Arithmetic is IEEE fp32 fma, no --use_fast_math.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 outside
// the tensor cores): at a decode step (M <= 8) the table is read once for
// 2 * M operations an element, far below the card's operations-per-byte
// line, so the bytes bound it: V * D * 2 bytes, 0.18 ms for Gemma3-1B's
// 262,144 x 1,152 bf16 table, 0.14 ms for Qwen2-1.5B's, 0.077 ms for
// Mamba2-2.7B's.
//
// How the design meets it:
//   * an M-tile of up to 8 rows of x sits in shared memory as fp32; a block
//     walks the vocabulary (grid-stride), so each block fills it once, and
//     the table is read once per M-tile, in 16-byte loads;
//   * tied: a warp takes 4 vocab rows at once, so each x value read from
//     shared memory serves 4 table chunks; the 4 rows' next chunks are
//     loaded while the current ones are multiplied;
//   * untied: the threads of a warp read 32 neighbouring 16-byte column
//     chunks of one table row, coalesced.
//
// x (M, D) and the table are contiguous with 16-byte aligned bases; D (tied)
// or V (untied) is a multiple of 8 (the wrapper checks).  out is (M, V)
// fp32.  The C launcher takes PyTorch's current stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;          // elements a lane takes per load step
constexpr int kR = 4;          // vocab rows a warp takes at once (tied)
constexpr int kMaxMT = 8;      // rows of x an M-tile holds

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 elements at p (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&f)[kE]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[kE]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The block's M-tile of x as fp32, rows past M as zeros.  With split, a
// row keeps the first 4 elements of every 8-element chunk in its first
// half and the last 4 in its second, so that lanes reading neighbouring
// chunks read neighbouring 16 bytes (no bank conflicts).
template <typename T, int kMT, bool kSplit>
__device__ __forceinline__ void fill_x(const T* __restrict__ x, float* xs, int M, int D) {
  const long long m0 = (long long)blockIdx.y * kMT;
  for (int e = threadIdx.x; e < kMT * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int at = kSplit ? (d % kE >= 4) * (D / 2) + (d / kE) * 4 + d % 4 : d;
    xs[r * D + at] = m0 + r < M ? to_float(x[(m0 + r) * D + d]) : 0.f;
  }
  __syncthreads();
}

template <typename T, int kMT>
__global__ void __launch_bounds__(kThreads)
tied_kernel(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ out,
            int M, int V, int D) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [kMT][D]
  fill_x<T, kMT, true>(x, xs, M, D);
  const long long m0 = (long long)blockIdx.y * kMT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = D / kE;
  const long long stride = (long long)gridDim.x * kWarps * kR;
  for (long long v0 = ((long long)blockIdx.x * kWarps + warp) * kR; v0 < V; v0 += stride) {
    float acc[kR][kMT];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int m = 0; m < kMT; ++m) acc[r][m] = 0.f;
    }
    // the 4 rows' chunk c, loaded one step ahead of its products
    float wf[kR][kE], wn[kR][kE];
    auto load_rows = [&](int c, float (&dst)[kR][kE]) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (c < chunks && v0 + r < V) {
          load8(w + (v0 + r) * D + (long long)c * kE, dst[r]);
        } else {
#pragma unroll
          for (int e = 0; e < kE; ++e) dst[r][e] = 0.f;
        }
      }
    };
    load_rows(lane, wn);
    for (int c = lane; c < chunks; c += 32) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int e = 0; e < kE; ++e) wf[r][e] = wn[r][e];
      }
      load_rows(c + 32, wn);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        float xf[kE];
        const float4 a = *reinterpret_cast<const float4*>(xs + m * D + c * 4);
        const float4 b = *reinterpret_cast<const float4*>(xs + m * D + D / 2 + c * 4);
        xf[0] = a.x; xf[1] = a.y; xf[2] = a.z; xf[3] = a.w;
        xf[4] = b.x; xf[5] = b.y; xf[6] = b.z; xf[7] = b.w;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[r][m] = fmaf(xf[e], wf[r][e], acc[r][m]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) {
          acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], off);
        }
      }
    }
    // every lane holds every sum; lane (r * kMT + m) % 32 writes (m, v0 + r)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (lane == (r * kMT + m) % 32 && m0 + m < M && v0 + r < V) {
          out[(m0 + m) * V + v0 + r] = acc[r][m];
        }
      }
    }
  }
}

template <typename T, int kMT>
__global__ void __launch_bounds__(kThreads)
untied_kernel(const T* __restrict__ x, const T* __restrict__ h, float* __restrict__ out,
              int M, int V, int D) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [kMT][D]
  fill_x<T, kMT, false>(x, xs, M, D);
  const long long m0 = (long long)blockIdx.y * kMT;
  const long long v0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kE;
  if (v0 >= V) return;
  float acc[kMT][kE];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[m][e] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float hf[kE];
    load8(h + (long long)d * V + v0, hf);
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const float xm = xs[m * D + d];
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[m][e] = fmaf(xm, hf[e], acc[m][e]);
    }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    if (m0 + m < M) {
      float* o = out + (m0 + m) * V + v0;
      *reinterpret_cast<float4*>(o) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n = 132;
    }
  }
  return n;
}

template <typename T, int kMT>
int launch(int tied, const void* x, const void* w, void* out, int M, int V, int D,
           cudaStream_t stream) {
  const int smem = kMT * D * static_cast<int>(sizeof(float));
  auto kernel = tied ? tied_kernel<T, kMT> : untied_kernel<T, kMT>;
  static int configured[2] = {0, 0};   // dynamic shared memory allowed, by form
  if (smem > 48 * 1024 && smem > configured[tied]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[tied] = smem;
  }
  const long long mtiles = (M + kMT - 1) / kMT;
  if (mtiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks;
  if (tied) {
    blocks = (V + kWarps * kR - 1) / (kWarps * kR);
    const long long cap = 2LL * num_sms();
    if (blocks > cap) blocks = cap;
  } else {
    blocks = (V / kE + kThreads - 1) / kThreads;
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(mtiles));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                           static_cast<float*>(out), M, V, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mt(int tied, const void* x, const void* w, void* out, int M, int V, int D,
              cudaStream_t s) {
  // a decode step's M is 1 (the slot-at-a-time path) or the slot count
  return M == 1 ? launch<T, 1>(tied, x, w, out, M, V, D, s)
                : launch<T, kMaxMT>(tied, x, w, out, M, V, D, s);
}

}  // namespace

// dtype: 0 = fp32 x and table, 1 = bf16.  tied: 1 = table (V, D), 0 =
// table (D, V).  out (M, V) fp32.  D % 8 == 0 when tied, V % 8 == 0 when
// not; D * 32 bytes of x fit in shared memory.  Returns a cudaError_t as int.
extern "C" int lm_head_launch(int dtype, int tied, const void* x, const void* w, void* out,
                              int M, int V, int D, void* stream) {
  if (M <= 0 || V <= 0 || D <= 0 || (tied ? D % kE : V % kE) ||
      D > 227 * 1024 / (kMaxMT * static_cast<int>(sizeof(float)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_mt<float>(tied, x, w, out, M, V, D, s);
  if (dtype == 1) return launch_mt<__nv_bfloat16>(tied, x, w, out, M, V, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
