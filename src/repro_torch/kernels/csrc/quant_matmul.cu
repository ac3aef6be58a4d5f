// Quantized int8 x int8 matrix product for Hopper (sm_90a):
//   out[m, n] = (float)(sum_k xq[m, k] * wq[k, n]) * xs[m] * ws[n]
// with the sum taken exactly in int32 and the two products in fp32, in that
// order, so the result is bitwise equal to the plain version (and to the
// reference's oracle quant_matmul_ref) at any K: integer addition does not
// depend on its order, so the blocks may split and permute K freely.
//
// Replaces the Pallas TPU kernel quant_matmul_pallas of
// src/repro/kernels/quant_matmul.py (pallas_call at :77, _qmm_kernel at :40).
//
// Operands: xq (M, K) int8 row-major; the weight as wt = wq^T, (N, K) int8
// row-major (the port keeps static weights in this layout, so both operands
// are K-contiguous, which is what mma.sync's row.col form reads); xs (M,)
// and ws (N,) fp32; out (M, N) fp32.  Ragged M, N and K are masked in the
// kernel: rows and columns past the edge load zeros and store nothing, and
// K past its end loads zeros.  Rows are read with 16-byte loads when K is a
// multiple of 16 and both bases are 16-byte aligned, byte by byte otherwise.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1,979 dense int8 TOP/s):
//   * decode, M = the slot count (8): 2 operations per weight byte, far below
//     the card's ~590 int8 operations per byte, so reading wq is the whole
//     cost: w_up (1536 x 8960) is 13.76 MB, a bound of 4.1 us; one decode
//     step of Qwen2-1.5B streams 1.31 GB of int8 weights, 0.39 ms.
//   * prefill, M = wave x padded length (~4096 and up): 2·M operations per
//     weight byte, above that line, so the tensor cores bound it:
//     2·M·K·N / 1,979 TOP/s.
//
// How the design meets them (simple first; wgmma with TMA is later work):
//   * Both paths use mma.sync.m16n8k32 (s8 x s8 -> s32).  Each lane loads 16
//     consecutive bytes of a row for a 64-byte step of K and feeds them to
//     two mma's; the order in which K reaches the tensor core is permuted the
//     same way for both operands, which an integer sum does not notice.
//   * M <= 16 (decode): qmm_skinny.  One block owns 8·NT output columns and
//     every row; its 4 warps take interleaved 64-byte steps of K and load the
//     weight straight into registers (U steps in flight per warp), so each
//     weight byte is read once per launch and never staged.  The warps' int32
//     partial tiles meet in shared memory, and warp 0 applies the epilogue.
//     NT (columns per block) shrinks for narrow N so the grid still fills the
//     132 SMs.
//   * M > 16 (prefill): qmm_tiled.  128 x 128 output tiles, 8 warps of 64 x 32,
//     64-byte K steps staged in two shared-memory buffers: the next step is
//     loaded into registers while the current one is multiplied, one barrier
//     a step.
//
// The C launcher takes PyTorch's current stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStep = 64;   // bytes of K per step: two m16n8k32 mma's

// 16 bytes of a row from byte k, zero past K.
template <bool kVec>
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ row, int k, int K) {
  if (kVec && k + 16 <= K) {
    return __ldg(reinterpret_cast<const uint4*>(row + k));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (k + j < K) {
      w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[k + j])) << ((j & 3) * 8);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 64-byte step of K for an m16 x n8 tile.  lo / hi are the 16 bytes lane
// (g, t) holds of A's rows g and g + 8, b those of the weight's row g (output
// column g), all at byte t·16 of the step.  The first mma takes bytes 0..7 of
// each, the second bytes 8..15: logical k index t·4 + j of an m16n8k32 lands
// on byte t·16 + j, and 16 + t·4 + j on t·16 + 4 + j, in A and B alike.
__device__ __forceinline__ void mma_step(int (&c)[4], const uint4& lo, const uint4& hi,
                                         const uint4& b) {
  mma_s8(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_s8(c, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

// Accumulator element i of lane (g, t): row g (+8 for i >= 2), column
// t·2 + (i & 1).  The epilogue multiplies in the reference's order.
__device__ __forceinline__ void store_tile(const int (&c)[4], int r0, int c0, int g, int t,
                                           const float* __restrict__ xs,
                                           const float* __restrict__ ws,
                                           float* __restrict__ out, int M, int N) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + (i >= 2 ? 8 : 0);
    const int col = c0 + t * 2 + (i & 1);
    if (r < M && col < N) {
      out[static_cast<long long>(r) * N + col] = __int2float_rn(c[i]) * xs[r] * ws[col];
    }
  }
}

// ------------------------------------------------------------------------- //
// M <= 16: grid (ceil(N / (8·NT))), 4 warps splitting K.
// ------------------------------------------------------------------------- //
constexpr int kSkinnyWarps = 4;
constexpr int kUnroll = 4;   // 64-byte steps of K in flight per warp

template <int NT, bool kVec>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
qmm_skinny(const int8_t* __restrict__ X, const int8_t* __restrict__ Wt,
           const float* __restrict__ xs, const float* __restrict__ ws,
           float* __restrict__ out, int M, int N, int K) {
  __shared__ int red[kSkinnyWarps][NT][4][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * (8 * NT);
  const int8_t* xlo = X + static_cast<long long>(g) * K;
  const int8_t* xhi = X + static_cast<long long>(g + 8) * K;
  const bool lo_ok = g < M, hi_ok = g + 8 < M;
  const int8_t* wrow[NT];
  bool w_ok[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + j * 8 + g;
    w_ok[j] = n < N;
    wrow[j] = Wt + static_cast<long long>(w_ok[j] ? n : 0) * K;
  }

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  const int steps = (K + kStep - 1) / kStep;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int s0 = warp; s0 < steps; s0 += kSkinnyWarps * kUnroll) {
    uint4 lo[kUnroll], hi[kUnroll], b[kUnroll][NT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kSkinnyWarps;
      const int k = s * kStep + t * 16;
      const bool in = s < steps;
      lo[u] = (in && lo_ok) ? load16<kVec>(xlo, k, K) : zero;
      hi[u] = (in && hi_ok) ? load16<kVec>(xhi, k, K) : zero;
#pragma unroll
      for (int j = 0; j < NT; ++j) b[u][j] = (in && w_ok[j]) ? load16<kVec>(wrow[j], k, K) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_step(acc[j], lo[u], hi[u], b[u][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[warp][j][i][lane] = acc[j][i];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kSkinnyWarps; ++w) sum += red[w][j][i][lane];
      acc[j][i] = sum;
    }
    store_tile(acc[j], 0, n0 + j * 8, g, t, xs, ws, out, M, N);
  }
}

// ------------------------------------------------------------------------- //
// M > 16: grid (ceil(N / 128), ceil(M / 128)), 8 warps of 64 x 32.
// ------------------------------------------------------------------------- //
constexpr int kTile = 128;                       // rows and columns per block
constexpr int kTiledThreads = 256;
constexpr int kChunks = kStep / 16;              // 16-byte chunks per row and step
constexpr int kLoads = kTile * kChunks / kTiledThreads;   // 2 per operand

template <bool kVec>
__device__ __forceinline__ void load_step(const int8_t* __restrict__ X,
                                          const int8_t* __restrict__ Wt, int m0, int n0,
                                          int k0, int M, int N, int K, uint4 (&ra)[kLoads],
                                          uint4 (&rb)[kLoads]) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int e = threadIdx.x + j * kTiledThreads;
    const int r = e / kChunks, k = k0 + (e % kChunks) * 16;
    ra[j] = (m0 + r < M) ? load16<kVec>(X + static_cast<long long>(m0 + r) * K, k, K) : zero;
    rb[j] = (n0 + r < N) ? load16<kVec>(Wt + static_cast<long long>(n0 + r) * K, k, K) : zero;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kTiledThreads, 1)
qmm_tiled(const int8_t* __restrict__ X, const int8_t* __restrict__ Wt,
          const float* __restrict__ xs, const float* __restrict__ ws,
          float* __restrict__ out, int M, int N, int K) {
  __shared__ uint4 sA[2][kTile][kChunks];
  __shared__ uint4 sB[2][kTile][kChunks];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;       // 2 x 4 warps
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  uint4 ra[kLoads], rb[kLoads];
  const int steps = (K + kStep - 1) / kStep;
  load_step<kVec>(X, Wt, m0, n0, 0, M, N, K, ra, rb);
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int e = threadIdx.x + j * kTiledThreads;
    sA[0][e / kChunks][e % kChunks] = ra[j];
    sB[0][e / kChunks][e % kChunks] = rb[j];
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load_step<kVec>(X, Wt, m0, n0, (s + 1) * kStep, M, N, K, ra, rb);
    uint4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = sB[buf][wn * 32 + j * 8 + g][t];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 lo = sA[buf][wm * 64 + i * 16 + g][t];
      const uint4 hi = sA[buf][wm * 64 + i * 16 + 8 + g][t];
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_step(acc[i][j], lo, hi, b[j]);
    }
    if (s + 1 < steps) {
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int e = threadIdx.x + j * kTiledThreads;
        sA[buf ^ 1][e / kChunks][e % kChunks] = ra[j];
        sB[buf ^ 1][e / kChunks][e % kChunks] = rb[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_tile(acc[i][j], m0 + wm * 64 + i * 16, n0 + wn * 32 + j * 8, g, t, xs, ws, out, M,
                 N);
}

template <int NT, bool kVec>
void launch_skinny(const int8_t* X, const int8_t* Wt, const float* xs, const float* ws,
                   float* out, int M, int N, int K, cudaStream_t s) {
  const int cols = 8 * NT;
  qmm_skinny<NT, kVec><<<(N + cols - 1) / cols, kSkinnyWarps * 32, 0, s>>>(X, Wt, xs, ws, out,
                                                                          M, N, K);
}

template <bool kVec>
void launch(const int8_t* X, const int8_t* Wt, const float* xs, const float* ws, float* out,
            int M, int N, int K, cudaStream_t s) {
  if (M <= 16) {
    // the most columns per block that still gives two blocks per SM (132)
    if (N >= 32 * 264) {
      launch_skinny<4, kVec>(X, Wt, xs, ws, out, M, N, K, s);
    } else if (N >= 16 * 264) {
      launch_skinny<2, kVec>(X, Wt, xs, ws, out, M, N, K, s);
    } else {
      launch_skinny<1, kVec>(X, Wt, xs, ws, out, M, N, K, s);
    }
  } else {
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    qmm_tiled<kVec><<<grid, kTiledThreads, 0, s>>>(X, Wt, xs, ws, out, M, N, K);
  }
}

}  // namespace

// xq (M, K) int8, wt (N, K) int8, both row-major with row stride K; xs (M,),
// ws (N,) fp32; out (M, N) fp32.  Returns a cudaError_t as int (0 = launched).
extern "C" int quant_matmul_launch(const void* xq, const void* wt, const void* xs,
                                   const void* ws, void* out, int M, int N, int K,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto X = static_cast<const int8_t*>(xq);
  const auto Wt = static_cast<const int8_t*>(wt);
  const auto xsf = static_cast<const float*>(xs);
  const auto wsf = static_cast<const float*>(ws);
  const auto o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  if (vec) {
    launch<true>(X, Wt, xsf, wsf, o, M, N, K, s);
  } else {
    launch<false>(X, Wt, xsf, wsf, o, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
