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
// are K-contiguous, which is what mma.sync's row.col form and wgmma's
// K-major operands read); xs (M,) and ws (N,) fp32; out (M, N) fp32.
// Ragged M, N and K are handled in the kernels: rows and columns past the
// edge load zeros and store nothing, and K past its end loads zeros.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1,979 dense int8 TOP/s):
//   * decode, M = the slot count (8): 2 operations per weight byte, far below
//     the card's ~590 int8 operations per byte, so reading wq is the whole
//     cost: w_up (1536 x 8960) is 13.76 MB, a bound of 4.1 us; one decode
//     step of Qwen2-1.5B streams 1.31 GB of int8 weights, 0.39 ms.
//   * prefill, M = wave x padded length (7,168 to 15,680 rows served): 2·M
//     operations per weight byte, above that line, so the tensor cores bound
//     it, 2·M·K·N / 1,979 TOP/s, with the fp32 output (4·M·N bytes) a close
//     second at the narrow widths.
//
// How the design meets them:
//   * M <= 16 (decode): qmm_skinny, on mma.sync.m16n8k32 (s8 x s8 -> s32).
//     One block owns 8·NT output columns and every row; its 4 warps take
//     interleaved 64-byte steps of K and load the weight straight into
//     registers (U steps in flight per warp), so each weight byte is read
//     once per launch and never staged.  Each lane loads 16 consecutive
//     bytes of a row and feeds them to two mma's; the order in which K
//     reaches the tensor core is permuted the same way for both operands,
//     which an integer sum does not notice.  The warps' int32 partial tiles
//     meet in shared memory, and warp 0 applies the epilogue.  NT (columns
//     per block) shrinks for narrow N so the grid still fills the 132 SMs.
//     Rows are read with 16-byte loads when K is a multiple of 16 and both
//     bases are 16-byte aligned, byte by byte otherwise.
//   * M > 16 (prefill): qmm_wgmma, on wgmma.m64nNk32 (s8 x s8 -> s32), the
//     only route to the card's full tensor-core rate: a persistent grid of
//     one block per SM over 128 x BN output tiles (BN 256, or 128 where that
//     fills the SMs better: the wrapper chooses by shape), a producer warp
//     that keeps a 4-stage ring of 128-byte K steps full with TMA, and two
//     consumer warpgroups of 64 x BN that read both operands from shared
//     memory through wgmma descriptors (the 128-byte swizzle TMA writes, so
//     no bank conflicts and no ldmatrix).  Each loaded byte feeds 256 (BN
//     256) or 128 output columns, against 32 in the mma.sync tile this form
//     replaced; the ring hides the loads and, across tiles, the epilogue's
//     stores.
// The C launcher takes PyTorch's current stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

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
// M > 16: qmm_wgmma.  A persistent grid (at most one block per SM) walks the
// (ceil(M / 128) x ceil(N / BN)) output tiles, m fastest.  Per block:
//   * one producer warp: lane 0 keeps a ring of kStages shared-memory stages
//     full with TMA (cp.async.bulk.tensor), each stage 128 rows of xq and BN
//     rows of wt, 128 bytes of K, written in the 128-byte swizzle that wgmma
//     reads; a full/empty mbarrier pair per stage;
//   * two consumer warpgroups, rows 0-63 and 64-127 of the tile: for each
//     128-byte step, 4 wgmma.m64nBNk32 (s8 x s8 -> s32) read both operands
//     straight from the stage, with one step's group in flight while the
//     next is issued; a stage is handed back once its wgmma's are done;
//   * the epilogue: each consumer warpgroup writes its fp32 outputs, 64 rows
//     x 32 columns at a time, into one of two shared-memory boxes that TMA
//     stores (when N % 4 == 0, TMA's row-stride rule; lanes store their own
//     pairs otherwise), so the next tile's wgmma's start while the stores
//     drain.
//   * TMA fills rows past M or N and bytes past K with zeros and drops its
//     stores past M or N; the lanes' own stores are masked.
// ------------------------------------------------------------------------- //
constexpr int kBM = 128;                 // rows of a tile: two warpgroups of 64
constexpr int kBK = 128;                 // bytes of K a stage holds
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kWgmmaThreads = kConsumers * 128 + 32;   // + the producer warp

constexpr int kOutCols = 32;             // fp32 columns a staged output box holds
constexpr int kOutBox = 64 * kOutCols * 4;   // bytes of a box: a warpgroup's 64 rows

template <int BN>
constexpr int wgmma_smem() {             // + 1 KB to align the ring to 1024 bytes
  return kStages * (kBM + BN) * kBK + kConsumers * 2 * kOutBox + 2 * kStages * 8 + 1024;
}

template <int BN>
struct Wgmma;

template <>
struct Wgmma<256> {
  // d (m64 x n256, s32) += A (64 x 32 bytes) . B (n256 x 32 bytes)^T, both from
  // shared memory; scale_d = 0 starts the sum from zero
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d (m64 x n128, s32) += A (64 x 32 bytes) . B (n128 x 32 bytes)^T, both from
  // shared memory; scale_d = 0 starts the sum from zero
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};


__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma operand in shared memory: rows of 128 bytes (K-major), 8-row
// groups 1024 bytes apart, in the 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)   // start address
         | static_cast<uint64_t>(1) << 16                // leading offset (unused)
         | static_cast<uint64_t>(1024 >> 4) << 32        // stride between 8-row groups
         | static_cast<uint64_t>(1) << 62;               // 128-byte swizzle
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Wait for the phase of parity `parity` of the barrier to complete.  A
// phase that never completes (a ring out of step) traps after ~2 s of the
// SM's clock instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 4000000000LL) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// rows [row, row + box) x bytes [k, k + 128) of the map's tensor into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// the staged box at src (64 rows x 32 fp32 columns, 128-byte swizzle) into
// the map's tensor at (row, col); rows and columns past the tensor are not
// written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator register
// across a wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// kStore: the epilogue stages fp32 boxes of 64 x 32 in shared memory and
// TMA writes them out (whole 128-byte rows, asynchronously, so the next
// tile's products start at once; needs N % 4 == 0); otherwise each lane
// stores its own pairs of columns.
template <int BN, bool kStore>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
          const __grid_constant__ CUtensorMap map_out, const float* __restrict__ xs,
          const float* __restrict__ ws, float* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t a_base = base;                                  // [kStages][kBM][kBK]
  const uint32_t b_base = base + kStages * kBM * kBK;            // [kStages][BN][kBK]
  const uint32_t o_base = b_base + kStages * BN * kBK;           // [kConsumers][2][kOutBox]
  const uint32_t bars = o_base + kConsumers * 2 * kOutBox;       // full[kStages], empty[kStages]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (M + kBM - 1) / kBM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int steps = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // the producer warp
    if (threadIdx.x % 32 != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * kBM, n0 = (tile / m_tiles) * BN;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect(full(stage), (kBM + BN) * kBK);
        tma_load(a_base + stage * kBM * kBK, &map_x, s * kBK, m0, full(stage));
        tma_load(b_base + stage * BN * kBK, &map_w, s * kBK, n0, full(stage));
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg * 64 .. wg * 64 + 63 of each tile
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  int stage = 0;
  uint32_t phase = 0;
  int acc[BN / 2];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * kBM, n0 = (tile / m_tiles) * BN;
    int held = -1;                       // the stage whose wgmma's are in flight
    for (int s = 0; s < steps; ++s) {
      mbar_wait(full(stage), phase);
      const uint32_t a = a_base + stage * kBM * kBK + wg * 64 * kBK;
      const uint32_t b = b_base + stage * BN * kBK;
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        Wgmma<BN>::mma(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32),
                       s > 0 || kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_regs(acc);
      if (held >= 0 && tid == 0) mbar_arrive(empty(held));
      held = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(acc);
    if (tid == 0) mbar_arrive(empty(held));

    // accumulator element 4j + i of lane (g, t): row g (+8 for i >= 2) of
    // the warp's 16, column 8j + 2t + (i & 1); the epilogue multiplies in
    // the reference's order
    const int r0 = m0 + wg * 64 + warp * 16 + g;
    float x_scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) x_scale[h] = r0 + 8 * h < M ? xs[r0 + 8 * h] : 0.f;
    if constexpr (kStore) {
      // box c holds columns 32c .. 32c + 31; boxes alternate between two
      // buffers, and a buffer is written once the store that last read it
      // has read it
#pragma unroll
      for (int c = 0; c < BN / kOutCols; ++c) {
        const uint32_t box = o_base + (wg * 2 + (c & 1)) * kOutBox;
        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        wg_sync(wg);
#pragma unroll
        for (int jj = 0; jj < kOutCols / 8; ++jj) {
          const int j = c * (kOutCols / 8) + jj;
          const int col = n0 + 8 * j + 2 * t;
          const float w0 = col < N ? ws[col] : 0.f;
          const float w1 = col + 1 < N ? ws[col + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = warp * 16 + g + 8 * h;     // within the box
            const float v0 = __int2float_rn(acc[4 * j + 2 * h]) * x_scale[h] * w0;
            const float v1 = __int2float_rn(acc[4 * j + 2 * h + 1]) * x_scale[h] * w1;
            // 16-byte piece 2jj + t/2 of the row's 128, in the 128-byte swizzle
            const uint32_t at =
                box + row * 128 + (((2 * jj + (t >> 1)) ^ (row & 7)) << 4) + (t & 1) * 8;
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(at), "f"(v0), "f"(v1)
                         : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        wg_sync(wg);
        if (tid == 0) tma_store(&map_out, box, n0 + c * kOutCols, m0 + wg * 64);
      }
    } else {
      const bool pairs = N % 2 == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
        float* orow = out + static_cast<long long>(r) * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float v0 = __int2float_rn(acc[4 * j + 2 * h]) * x_scale[h];
          const float v1 = __int2float_rn(acc[4 * j + 2 * h + 1]) * x_scale[h];
          if (pairs && col + 1 < N) {
            const float2 wsc = *reinterpret_cast<const float2*>(ws + col);
            *reinterpret_cast<float2*>(orow + col) = make_float2(v0 * wsc.x, v1 * wsc.y);
          } else {
            if (col < N) orow[col] = v0 * ws[col];
            if (col + 1 < N) orow[col + 1] = v1 * ws[col + 1];
          }
        }
      }
    }
  }
  // the last boxes' reads of shared memory, and their writes, done
  if (kStore && tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int NT, bool kVec>
void launch_skinny(const int8_t* X, const int8_t* Wt, const float* xs, const float* ws,
                   float* out, int M, int N, int K, cudaStream_t s) {
  const int cols = 8 * NT;
  qmm_skinny<NT, kVec><<<(N + cols - 1) / cols, kSkinnyWarps * 32, 0, s>>>(X, Wt, xs, ws, out,
                                                                          M, N, K);
}

template <bool kVec>
void launch_skinny_by_width(const int8_t* X, const int8_t* Wt, const float* xs,
                            const float* ws, float* out, int M, int N, int K, cudaStream_t s) {
  // the most columns per block that still gives two blocks per SM (132)
  if (N >= 32 * 264) {
    launch_skinny<4, kVec>(X, Wt, xs, ws, out, M, N, K, s);
  } else if (N >= 16 * 264) {
    launch_skinny<2, kVec>(X, Wt, xs, ws, out, M, N, K, s);
  } else {
    launch_skinny<1, kVec>(X, Wt, xs, ws, out, M, N, K, s);
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

// cuTensorMapEncodeTiled, looked up by name in libcuda (which PyTorch has
// already loaded), so that the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr) {
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

// A TMA map of a row-major (rows, cols) tensor of `elem`-byte elements, read
// or written in boxes of box_rows x box_cols elements (128 bytes a row) in
// the 128-byte swizzle; reads past the tensor fill zeros, writes past it
// are dropped.
bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
              int rows, int cols, int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box_cols),
                               static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, boxes, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool kStore>
int launch_wgmma(const CUtensorMap& map_x, const CUtensorMap& map_w, const CUtensorMap& map_out,
                 const float* xs, const float* ws, float* out, int M, int N, int K,
                 cudaStream_t s) {
  constexpr int smem = wgmma_smem<BN>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_wgmma<BN, kStore>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(tiles < num_sms() ? tiles : num_sms());
  qmm_wgmma<BN, kStore><<<blocks, kWgmmaThreads, smem, s>>>(map_x, map_w, map_out, xs, ws, out,
                                                            M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_wgmma(const void* X, const void* Wt, const float* xs, const float* ws, float* out,
                 int M, int N, int K, cudaStream_t s) {
  CUtensorMap map_x, map_w, map_out;
  if (!make_map(&map_x, X, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, kBM, kBK) ||
      !make_map(&map_w, Wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, BN, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool store = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (store) {
    if (!make_map(&map_out, out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, N, 64, kOutCols)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_wgmma<BN, true>(map_x, map_w, map_out, xs, ws, out, M, N, K, s);
  }
  map_out = map_w;                       // not read
  return launch_wgmma<BN, false>(map_x, map_w, map_out, xs, ws, out, M, N, K, s);
}

}  // namespace

// xq (M, K) int8, wt (N, K) int8, both row-major with row stride K; xs (M,),
// ws (N,) fp32; out (M, N) fp32.  M <= 16 takes qmm_skinny (bn is not
// read); M > 16 takes qmm_wgmma with tiles of 128 x bn columns, bn 128 or
// 256, and needs K % 16 == 0 and 16-byte aligned xq and wt (TMA's rule; the
// wrapper pads K and copies a misaligned operand).  Returns a cudaError_t as
// int (0 = launched).
extern "C" int quant_matmul_launch(const void* xq, const void* wt, const void* xs,
                                   const void* ws, void* out, int M, int N, int K, int bn,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto X = static_cast<const int8_t*>(xq);
  const auto Wt = static_cast<const int8_t*>(wt);
  const auto xsf = static_cast<const float*>(xs);
  const auto wsf = static_cast<const float*>(ws);
  const auto o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = K % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  if (M <= 16) {
    if (aligned) {
      launch_skinny_by_width<true>(X, Wt, xsf, wsf, o, M, N, K, s);
    } else {
      launch_skinny_by_width<false>(X, Wt, xsf, wsf, o, M, N, K, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 256) return launch_wgmma<256>(xq, wt, xsf, wsf, o, M, N, K, s);
  if (bn == 128) return launch_wgmma<128>(xq, wt, xsf, wsf, o, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
