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
// an fp64 copy of the table) before this kernel.
//
// Routes, by operand dtype and form:
//   * bf16, tied (the served head of every model): tied_mma_kernel, on the
//     tensor cores.  mma.sync.m16n8k16 bf16 x bf16 with fp32 accumulation:
//     16 vocab rows are the m16 side (A, loaded in 16-byte pieces straight
//     from HBM into registers), the <= 8 rows of x of an M-tile the n8 side
//     (B, bf16 in shared memory; rows past M are zeros).  D is cut into
//     groups of 32 elements; lane (g, t) loads the 8 elements 32q + 8t ..
//     32q + 8t + 7 of its rows g and g + 8 and of x's row g, and group q is
//     two mma's, the first over the first 4 of each lane's 8 elements, the
//     second over the last 4 (the same permutation of k for A and B).  Each
//     mma starts from zero, so the tensor core sums 16 exact products, and
//     its result is added to the logit's fp32 sum with an IEEE add: one
//     chain of D / 16 steps in index order, fixed by D.  An output element of
//     mma is its own dot product, so logit (m, v) does not depend on M, on
//     the column x's row lands in, or on the other rows of the tile: row m
//     is bitwise the same at M = 1 and M = 8.  The mma step and the streaming
//     load are common.cuh's (port::mma_bf16_add, port::ld_stream), which
//     fixed_linear.cu's decode products share.
//   * fp32, tied: tied_kernel on the SIMT pipe (IEEE fp32 FMA; the port's
//     rule keeps fp32 operands off the tensor cores and TF32 off).  D is cut
//     into chunks of 8 elements; chunk c belongs to lane c % 32 of a warp,
//     which runs one fma chain over its chunks in index order; the 32 lane
//     sums meet in a fixed xor butterfly.
//   * untied, either dtype: untied_kernel on the SIMT pipe, one fma chain
//     over d in index order for each of a thread's 8 columns.  No served
//     model is untied.
// Arithmetic is IEEE fp32 outside the tensor cores, no --use_fast_math.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 outside
// the tensor cores, 989 TFLOP/s bf16 in them): at a decode step (M <= 8) the
// table is read once for 2 * M operations an element, far below the card's
// operations-per-byte line, so the bytes bound it: V * D * 2 bytes, 0.18 ms
// for Gemma3-1B's 262,144 x 1,152 bf16 table, 0.14 ms for Qwen2-1.5B's,
// 0.077 ms for Mamba2-2.7B's.  On the SIMT pipe, 8 fp32 FMAs an element at
// M = 8 held the FMA kernel to about twice that; on the tensor cores the
// kernel is a byte stream.
//
// How the mma route meets it:
//   * a block stages its M-tile of x once (shared memory rows padded so that
//     the 8 rows a quarter-warp reads fall in distinct banks), then its
//     warps walk 16-row vocab tiles (grid-stride over a grid sized by the
//     occupancy calculator to fill every SM), each warp one tile at a time;
//   * a lane keeps kGroups groups (2 x 16 bytes each) of the table in flight
//     while it multiplies the kGroups before them, across tile boundaries,
//     with loads that do not allocate in L1; the first are issued before x is
//     staged.  The ragged last tile (V % 16) loads zeros for rows past V and
//     stores nothing for them.
//
// x (M, D) and the table are contiguous with 16-byte aligned bases; D (tied)
// or V (untied) is a multiple of 8 (the wrapper checks).  out is (M, V)
// fp32.  The C launcher takes PyTorch's current stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

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

// ------------------------------------------------------------------------- //
// bf16, tied: the tensor-core route
// ------------------------------------------------------------------------- //
constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kGroups = 8;     // 32-element groups of D a lane keeps in flight

// Bytes of one row of x in shared memory: D rounded up to a whole group of
// 32 (zeros past D), plus 64 bytes where that is a multiple of 128, so that
// the two rows a quarter-warp reads start 64 bytes apart in the banks.
int mma_pitch(int D) {
  const int bytes = (D + 31) / 32 * 64;
  return bytes % 128 ? bytes : bytes + 64;
}

using port::ld_stream;
using port::mma_bf16_add;

// grid (blocks, M-tiles of 8), kMmaThreads threads, 8 * pitch bytes of
// dynamic shared memory.  A warp walks its 16-row vocab tiles (grid-stride)
// and each tile's groups of D in order, kGroups at a time: while it
// multiplies one batch of groups, the next batch is in flight (the next
// tile's first batch during a tile's last), so its loads never wait for a
// tile boundary; the first batch is issued before x is staged.  Lane (g, t)
// holds, for the tile at v0, logits (m0 + 2t, v0 + g), (m0 + 2t + 1, v0 + g),
// (m0 + 2t, v0 + g + 8) and (m0 + 2t + 1, v0 + g + 8): the m16n8
// accumulator with vocab rows as rows and x's rows as columns.
__global__ void __launch_bounds__(kMmaThreads)
tied_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                float* __restrict__ out, int M, int V, int D, int pitch) {
  extern __shared__ float4 smem4[];
  char* xs = reinterpret_cast<char*>(smem4);   // [8][pitch] bytes
  const long long m0 = (long long)blockIdx.y * kMaxMT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (D + 31) / 32;
  const long long tiles = (V + 15) / 16;
  const long long stride = (long long)gridDim.x * kMmaWarps;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // a tile's rows g and g + 8: where this lane's 16 bytes of group 0 start
  // (group q at + q * 32), and whether the rows exist
  auto rows = [&](long long tile, const __nv_bfloat16*& lo, const __nv_bfloat16*& hi,
                  bool& ok_lo, bool& ok_hi) {
    const long long v_lo = tile * 16 + g, v_hi = v_lo + 8;
    ok_lo = tile < tiles && v_lo < V;
    ok_hi = tile < tiles && v_hi < V;
    lo = w + (ok_lo ? v_lo : 0) * D + t * 8;
    hi = w + (ok_hi ? v_hi : 0) * D + t * 8;
  };
  // groups q0 .. q0 + kGroups - 1 of the rows, zeros past D or V
  auto load = [&](const __nv_bfloat16* lo, const __nv_bfloat16* hi, bool ok_lo, bool ok_hi,
                  int q0, uint4 (&dst)[kGroups][2]) {
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int q = q0 + u;
      const bool in = q < groups && q * 32 + t * 8 < D;
      dst[u][0] = in && ok_lo ? ld_stream(lo + q * 32) : zero;
      dst[u][1] = in && ok_hi ? ld_stream(hi + q * 32) : zero;
    }
  };

  long long tile = (long long)blockIdx.x * kMmaWarps + warp;
  const __nv_bfloat16 *lo, *hi, *next_lo, *next_hi;
  bool ok_lo, ok_hi, next_ok_lo, next_ok_hi;
  rows(tile, lo, hi, ok_lo, ok_hi);
  uint4 cur[kGroups][2], nxt[kGroups][2];
  load(lo, hi, ok_lo, ok_hi, 0, cur);

  // the block's M-tile of x, staged while the first loads are in flight
  const int pieces = pitch / 16;
  for (int e = threadIdx.x; e < kMaxMT * pieces; e += kMmaThreads) {
    const int r = e / pieces, c = e % pieces;
    uint4 v = zero;
    if (m0 + r < M && c * 8 < D) {
      v = *reinterpret_cast<const uint4*>(x + (m0 + r) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(xs + r * pitch + c * 16) = v;
  }
  __syncthreads();

  const char* xrow = xs + g * pitch + t * 16;    // group q at + q * 64
  for (; tile < tiles; tile += stride) {
    rows(tile + stride, next_lo, next_hi, next_ok_lo, next_ok_hi);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = 0; q0 < groups; q0 += kGroups) {
      const bool more = q0 + kGroups < groups;
      load(more ? lo : next_lo, more ? hi : next_hi, more ? ok_lo : next_ok_lo,
           more ? ok_hi : next_ok_hi, more ? q0 + kGroups : 0, nxt);
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        if (q0 + u < groups) {
          const uint4 b = *reinterpret_cast<const uint4*>(xrow + (q0 + u) * 64);
          mma_bf16_add(acc, cur[u][0].x, cur[u][1].x, cur[u][0].y, cur[u][1].y, b.x, b.y);
          mma_bf16_add(acc, cur[u][0].z, cur[u][1].z, cur[u][0].w, cur[u][1].w, b.z, b.w);
        }
      }
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        cur[u][0] = nxt[u][0];
        cur[u][1] = nxt[u][1];
      }
    }
    const long long v_lo = tile * 16 + g, v_hi = v_lo + 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long m = m0 + 2 * t + j;
      if (m < M) {
        if (v_lo < V) out[m * V + v_lo] = acc[j];
        if (v_hi < V) out[m * V + v_hi] = acc[2 + j];
      }
    }
    lo = next_lo;
    hi = next_hi;
    ok_lo = next_ok_lo;
    ok_hi = next_ok_hi;
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

// Allow `smem` bytes of dynamic shared memory for `kernel` (once per size).
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int& configured) {
  if (smem <= 48 * 1024 || smem <= configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) configured = smem;
  return err;
}

template <typename T, int kMT, bool kTied>
int launch_fma(const void* x, const void* w, void* out, int M, int V, int D,
               cudaStream_t stream) {
  const int smem = kMT * D * static_cast<int>(sizeof(float));
  const auto kernel = [] {
    if constexpr (kTied) {
      return tied_kernel<T, kMT>;
    } else {
      return untied_kernel<T, kMT>;
    }
  }();
  static int configured = 0;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mtiles = (M + kMT - 1) / kMT;
  if (mtiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks;
  if (kTied) {
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

template <typename T, bool kTied>
int launch_mt(const void* x, const void* w, void* out, int M, int V, int D, cudaStream_t s) {
  // a decode step's M is 1 (the slot-at-a-time path) or the slot count
  return M == 1 ? launch_fma<T, 1, kTied>(x, w, out, M, V, D, s)
                : launch_fma<T, kMaxMT, kTied>(x, w, out, M, V, D, s);
}

int launch_mma(const void* x, const void* w, void* out, int M, int V, int D,
               cudaStream_t stream) {
  const int pitch = mma_pitch(D);
  const int smem = kMaxMT * pitch;
  static int configured = 0;
  cudaError_t err = allow_smem(tied_mma_kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mtiles = (M + kMaxMT - 1) / kMaxMT;
  if (mtiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  static int per_sm = 0, per_sm_smem = -1;   // resident blocks per SM, by smem
  if (per_sm_smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tied_mma_kernel,
                                                        kMmaThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    per_sm_smem = smem;
  }
  const long long tiles = (V + 15) / 16;
  long long blocks = (tiles + kMmaWarps - 1) / kMmaWarps;
  const long long cap = static_cast<long long>(per_sm) * num_sms();
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(mtiles));
  tied_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), M, V, D, pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32 x and table, 1 = bf16.  tied: 1 = table (V, D), 0 =
// table (D, V).  out (M, V) fp32.  D % 8 == 0 when tied, V % 8 == 0 when
// not; D * 32 bytes of x fit in shared memory.  bf16 tied takes the tensor
// cores, everything else the SIMT pipe.  Returns a cudaError_t as int.
extern "C" int lm_head_launch(int dtype, int tied, const void* x, const void* w, void* out,
                              int M, int V, int D, void* stream) {
  if (M <= 0 || V <= 0 || D <= 0 || (tied ? D % kE : V % kE) ||
      D > 227 * 1024 / (kMaxMT * static_cast<int>(sizeof(float)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && tied) return launch_mma(x, w, out, M, V, D, s);
  if (dtype == 1) return launch_mt<__nv_bfloat16, false>(x, w, out, M, V, D, s);
  if (dtype == 0 && tied) return launch_mt<float, true>(x, w, out, M, V, D, s);
  if (dtype == 0) return launch_mt<float, false>(x, w, out, M, V, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
