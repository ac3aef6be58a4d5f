// Quantized int8 x int8 matrix products for Hopper (sm_90a):
//   out[m, n] = (float)(sum_k xq[m, k] * wq[k, n]) * xs[m] * ws[n]
// with the sum taken exactly in int32 and the two products in fp32, in that
// order, so the result is bitwise equal to the plain version (and to the
// reference's oracle quant_matmul_ref) at any K: integer addition does not
// depend on its order, so the blocks may split and permute K freely.  And
// the row quantization in front of it,
//   xs[m] = max_k |x[m, k]| / 127 + 1e-8,   xq[m, k] = clamp(rint(x[m, k] / xs[m]), ±127)
// in fp32 with IEEE division and rounding half to even, bitwise what the
// plain quantize_rows computes.
//
// Replaces the Pallas TPU kernel quant_matmul_pallas of
// src/repro/kernels/quant_matmul.py (pallas_call at :77, _qmm_kernel at :40);
// quantize_rows_kernel replaces no TPU kernel (the reference's quantize_rows,
// src/repro/kernels/ops.py:64, is jnp left to XLA).
//
// Operands: the weight as wt = wq^T, (N, K) int8 row-major (the port keeps
// static weights in this layout, so both operands are K-contiguous, which is
// what mma.sync's row.col form and wgmma's K-major operands read), with K a
// multiple of 16 and 16-byte aligned (the wrapper pads and copies where not);
// xs (M,) and ws (N,) fp32; out (M, N) row-major, fp32 or x's dtype.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1,979 dense int8 TOP/s):
//   * decode, M = the slot count (8): 2 operations per weight byte, far below
//     the card's ~590 int8 operations per byte, so reading the weights is the
//     whole cost: Qwen2-1.5B's gate/up group (2 x 1536 x 8960) is 27.5 MB, a
//     bound of 8.2 us; one decode step streams 1.31 GB of int8 weights, 0.39 ms.
//   * prefill, M = wave x padded length (7,168 to 15,680 rows served): 2·M
//     operations per weight byte, above that line, so the tensor cores bound
//     the product, 2·M·K·N / 1,979 TOP/s, with the output (2 or 4 bytes an
//     element) a close second at the narrow widths; the quantization is one
//     read of x and one write of xq: 3·M·K bytes from bf16.
//
// How the designs meet them:
//   * M <= 16 (decode): qmm_group, one launch for the 1-3 projections that
//     read the same x (q/k/v, gate/up), on mma.sync.m16n8k32 (s8 x s8 -> s32).
//     The grid spans the group's column tiles of 128 columns; a tile's K is
//     split over a cluster of up to 8 blocks, so that the narrow groups fill
//     the 132 SMs (about one block an SM), and the grid stays one wave.
//     In each block
//       - a producer warp streams the block's weight tile with TMA through a
//         64 KB ring of 128-byte columns of K, the first ones issued at once,
//         so the weights are in flight while x is quantized;
//       - 8 consumer warps read x (bf16 or fp32, any row stride): where a
//         warp holds a whole row in registers (M <= 8, K <= 1,536 in bf16)
//         each block takes the rows' max |x| itself; otherwise each block
//         reads its K-slice and pushes the partial maxima to every block of
//         the cluster through distributed shared memory (max is exact in
//         any order).  The slice is quantized into shared memory as int8
//         (rows padded so the fragment loads hit 32 banks), at a multiply a
//         value and an IEEE division only where the product is within 1e-4
//         of a rounding boundary (the bound is derived at quantize());
//       - each consumer warp multiplies its 16 columns, x's fragments
//         and the weight's both from shared memory, the K order permuted
//         alike for both operands (an integer sum does not notice), and
//         frees a stage after a proxy fence (its reads before the refill);
//       - the int32 partial tile is pushed, column by column, to the block
//         of the cluster that owns the column; after one cluster barrier each
//         block sums its columns and applies the epilogue with all its
//         threads, rounding once to the output type.  No workspace, no
//         memset, nothing allocated: a CUDA graph captures the launch as it is.
//     The same kernel takes a quantized int8 x with given scales (quant_matmul
//     at M <= 16).
//   * M > 16 (prefill): quantize_rows_kernel, one launch per group: a row per
//     group of 32-256 threads (by K), each thread holding its 16-byte chunks
//     in registers (up to 5), so x is read once and xq written once.  Then
//     qmm_wgmma once per weight, on wgmma.m64nNk32 (s8 x s8 -> s32), the only
//     route to the card's full tensor-core rate: a persistent grid of one
//     block per SM over 128 x BN output tiles (BN 256, or 128 where that
//     fills the SMs better: the wrapper chooses by shape), a producer warp
//     that keeps a 4-stage ring of 128-byte K steps full with TMA, and two
//     consumer warpgroups of 64 x BN that read both operands from shared
//     memory through wgmma descriptors (the 128-byte swizzle TMA writes, so
//     no bank conflicts and no ldmatrix).  The epilogue writes fp32 or bf16
//     through 8 KB shared-memory boxes that TMA stores, so the next tile's
//     wgmma's start while the stores drain.
// The C launchers take PyTorch's current stream, allocate nothing and
// return a cudaError_t as int.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

// the TMA ring's and the clusters' pieces, shared with fixed_linear.cu
// (common.cuh)
using port::cluster_arrive_relaxed;
using port::cluster_blocks;
using port::cluster_map;
using port::cluster_rank;
using port::cluster_sync;
using port::cluster_wait;
using port::fence_regs;
using port::make_map;
using port::mbar_arrive;
using port::mbar_expect;
using port::mbar_init;
using port::mbar_wait;
using port::num_sms;
using port::smem_addr;
using port::st_cluster;
using port::sw128_desc;
using port::tma_load;
using port::tma_store;

constexpr int kStep = 64;   // bytes of K per step: two m16n8k32 mma's

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The reference's row scale, and the int8 value of v under it: the IEEE
// quotient v / scale rounded half to even, clamped to ±127.  The quotient is
// taken as v · inv (inv = 1 / scale, rounded once), which an IEEE division
// (about 40 instructions) would cost several times over: |v / scale| <=
// 127.00001, and inv and v · inv are one rounding each (2^-24 relative), so
// v · inv lies within 2.3e-5 of the IEEE quotient.  Where it lies more than
// 1e-4 from a half-integer, both round to the same integer; nearer (a tie,
// or close to one) the quotient is taken with __fdiv_rn.  Bitwise the
// plain version either way.
__device__ __forceinline__ float row_scale(float amax) {
  return __fadd_rn(__fdiv_rn(amax, 127.f), 1e-8f);
}
__device__ __forceinline__ uint32_t quantize(float v, float scale, float inv) {
  const float y = __fmul_rn(v, inv);
  float n = rintf(y);
  if (0.5f - fabsf(y - n) < 1e-4f) n = rintf(__fdiv_rn(v, scale));
  const int q = static_cast<int>(n);
  return static_cast<uint8_t>(static_cast<int8_t>(q < -127 ? -127 : (q > 127 ? 127 : q)));
}

// Element e of a 16-byte chunk of T's, as float.
template <typename T>
__device__ __forceinline__ float chunk_elem(const uint4& c, int e) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(w[e]);
  } else {
    const uint32_t h = (w[e >> 1] >> ((e & 1) * 16)) & 0xFFFFu;
    return __uint_as_float(h << 16);      // bf16 -> fp32 is exact
  }
}

// The 8 (bf16) or 4 (fp32) elements of a 16-byte chunk quantized into as
// many bytes, little-endian in packed.
template <typename T>
__device__ __forceinline__ void quantize_chunk(const uint4& v, float scale, float inv,
                                               uint32_t (&packed)[16 / sizeof(T) / 4]) {
#pragma unroll
  for (int p = 0; p < 16 / static_cast<int>(sizeof(T)) / 4; ++p) {
    packed[p] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) packed[p] |= quantize(chunk_elem<T>(v, 4 * p + e), scale, inv) << (8 * e);
  }
}

// The chunk of row xr that starts at element k (16 bytes of T), zeros past
// K: one vector load when vec (16-byte aligned rows, K a multiple of the
// chunk), element by element otherwise.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ xr, int k, int K, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) return k < K ? __ldg(reinterpret_cast<const uint4*>(xr + k)) : make_uint4(0, 0, 0, 0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (k + e < K) {
      uint32_t bits;
      if constexpr (std::is_same<T, float>::value) {
        bits = __float_as_uint(xr[k + e]);
        w[e] = bits;
      } else {
        bits = static_cast<uint32_t>(__bfloat16_as_ushort(xr[k + e]));
        w[e >> 1] |= bits << ((e & 1) * 16);
      }
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

// ------------------------------------------------------------------------- //
// M <= 16: qmm_group.  Grid: (column tiles of every member) x C blocks, in
// clusters of C along x; block rank r of a cluster takes bytes [r·kc,
// (r + 1)·kc) of K, kc a multiple of the 128-byte stage.  9 warps: warp 8
// streams the block's weight tile (kGroupBN rows x kc bytes) through a
// 64 KB ring of stages with TMA (128 bytes of K a stage, in the 128-byte
// swizzle); warps 0-7 quantize x meanwhile, then each multiplies its 16
// columns from the ring.  Shared memory (from a
// 1024-byte boundary): the ring; x's slice quantized, [16][ldk] int8 (ldk =
// 64 mod 128); the partial tiles the cluster's blocks push to this block,
// [C][16][per]; the partial row maxima pushed here, [8][16]; the scales;
// the ring's full and empty barriers.
// ------------------------------------------------------------------------- //
constexpr int kGroupWarps = 8;               // consumer warps
constexpr int kGroupThreads = kGroupWarps * 32 + 32;   // + the producer warp
constexpr int kNT = 2;                       // column groups of 8 a consumer warp owns
constexpr int kGroupBN = kGroupWarps * 8 * kNT;        // columns of a tile
constexpr int kMaxMembers = 3;
constexpr int kMaxRows = 16;
constexpr int kMaxCluster = 8;
constexpr int kRingBytes = 64 * 1024;        // the weight ring
constexpr int kStageK = 128;                 // bytes of K a ring stage holds (one swizzled row)
constexpr int kXChunks = 6;                  // x's 16-byte chunks a lane loads at once

struct Group {
  CUtensorMap map[kMaxMembers];              // each weight, (n, Kp) int8, boxes BN x 128
  const float* ws[kMaxMembers];              // (n,)
  void* out[kMaxMembers];                    // (M, n)
  int n[kMaxMembers];
  int tile0[kMaxMembers];                    // each one's first column tile in the grid
  int members;
};

// bytes of shared memory besides x's slice
constexpr int group_smem_fixed() {
  return 1024 + kRingBytes                          // alignment, the ring
         + kMaxRows * (kGroupBN + kMaxCluster) * 4  // the partial tiles pushed here
         + kMaxCluster * kMaxRows * 4               // the partial maxima pushed here
         + kMaxRows * 4 + kGroupBN * 4              // x's and the weights' scales
         + 2 * (kRingBytes / (kGroupBN * kStageK)) * 8;   // the barriers
}

// the 256 consumer threads
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// TIn: int8_t (x already quantized, scales given), float or __nv_bfloat16
// (the block quantizes its slice); TOut: the output's type.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kGroupThreads, 2)
qmm_group(const __grid_constant__ Group grp, const TIn* __restrict__ x, long long ldx,
          const float* __restrict__ xs_in, int M, int K, int kc, int ldk, int vec_x) {
  constexpr int BN = kGroupBN, NT = kNT;
  constexpr int S = kRingBytes / (BN * kStageK);   // stages in the ring
  constexpr int E = 16 / sizeof(TIn);        // elements of x in 16 bytes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((smem_addr(smem_raw) + 1023) & ~1023u) - smem_addr(smem_raw);
  int8_t* xq = reinterpret_cast<int8_t*>(ring + kRingBytes);             // [16][ldk]
  int* red = reinterpret_cast<int*>(xq + kMaxRows * ldk);               // [C][16][per]
  float* amax = reinterpret_cast<float*>(red + kMaxRows * (BN + kMaxCluster));  // [8][16]
  float* scale = amax + kMaxCluster * kMaxRows;                         // [16]
  float* wscale = scale + kMaxRows;                                     // [BN]
  const uint32_t bars = smem_addr(wscale + BN);                         // full[S], empty[S]
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (S + st); };

  cluster_arrive_relaxed();                  // started (waited for before a push)
  const int C = static_cast<int>(cluster_blocks());
  const int rank = static_cast<int>(cluster_rank());
  const int tile = blockIdx.x / C;
  int mi = 0;
#pragma unroll
  for (int i = 1; i < kMaxMembers; ++i) {
    if (i < grp.members && tile >= grp.tile0[i]) mi = i;
  }
  const int N = grp.n[mi];
  const int n0 = (tile - grp.tile0[mi]) * BN;
  const int k0 = rank * kc;
  const int stages = kc / kStageK;           // of this block's slice (zeros past K)
  const int per = (BN + C - 1) / C;          // columns whose sums a block owns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int rows = M > 8 ? kMaxRows : 8;     // rows the mma's read
  const int chunks = kc / E;                 // x's chunks in a row of the slice
  const float w_scale = threadIdx.x < BN && n0 + threadIdx.x < N ? grp.ws[mi][n0 + threadIdx.x]
                                                                 : 0.f;
  const float x_scale = std::is_same<TIn, int8_t>::value && threadIdx.x < M
                            ? xs_in[threadIdx.x] : 0.f;

  // x's slice [k0, k0 + kc) as int8 in shared memory, zeros past K and M:
  // a warp's rows w and w + 8, kXChunks chunks a lane at a time (a row of
  // one such group, at M <= 8, stays in registers from the first pass to
  // the second)
  uint4 xv[kXChunks];
  auto load_x = [&](int r, int c0) {
    const TIn* xr = x + (r < M ? r : 0) * ldx;
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int c = c0 + lane + 32 * i;
      if constexpr (std::is_same<TIn, int8_t>::value) {
        xv[i] = r < M && c < chunks && k0 + c * 16 < K
                    ? __ldg(reinterpret_cast<const uint4*>(xr + k0 + c * 16)) : zero;
      } else {
        xv[i] = r < M && c < chunks ? load_chunk<TIn>(xr, k0 + c * E, K, vec_x) : zero;
      }
    }
  };
  // Where a warp holds a whole row of x in registers (M <= 8, K short), each
  // block takes the rows' maxima over all of K itself, and no maxima cross
  // the cluster; otherwise over its slice, exchanged.  A consumer's first
  // chunks of x (of its row, or of its row's slice) are asked for before
  // anything waits.
  const bool whole = !std::is_same<TIn, int8_t>::value && M <= 8 &&
                     (K + E - 1) / E <= 32 * kXChunks;
  auto load_row = [&](int r) {
    const TIn* xr = x + (r < M ? r : 0) * ldx;
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int c = lane + 32 * i;
      xv[i] = r < M && c * E < K ? load_chunk<TIn>(xr, c * E, K, vec_x) : zero;
    }
  };
  if (warp < kGroupWarps) {
    if (whole) {
      load_row(warp);
    } else {
      load_x(warp, 0);
    }
  }
  if (threadIdx.x == kGroupWarps * 32) {     // the producer's lane 0: no loads pending
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kGroupWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kGroupWarps) {
    // the producer: the first S stages at once; the rest as the consumers
    // free them (after the prologue's cluster barriers, which every thread
    // of the cluster takes)
    const CUtensorMap* map = &grp.map[mi];
    int st = 0;
    auto issue = [&]() {
      const int slot = st % S;
      if (st >= S) mbar_wait(empty(slot), ((st / S) - 1) & 1);
      mbar_expect(full(slot), BN * kStageK);
      tma_load(smem_addr(ring) + slot * BN * kStageK, map, k0 + st * kStageK, n0, full(slot));
      ++st;
    };
    if (lane == 0) {
      while (st < stages && st < S) issue();
    }
    __syncwarp();
    cluster_wait();
    if (!std::is_same<TIn, int8_t>::value && !whole) cluster_sync();
    if (lane == 0) {
      while (st < stages) issue();
    }
    __syncwarp();
    cluster_sync();
    return;
  }

  const bool kept = M <= 8 && chunks <= 32 * kXChunks;
  if constexpr (std::is_same<TIn, int8_t>::value) {
    for (int r = warp; r < rows; r += kGroupWarps) {
      for (int c0 = 0; c0 < chunks; c0 += 32 * kXChunks) {
        if (r != warp || c0 != 0) load_x(r, c0);
#pragma unroll
        for (int i = 0; i < kXChunks; ++i) {
          const int c = c0 + lane + 32 * i;
          if (c < chunks) *reinterpret_cast<uint4*>(xq + r * ldk + c * 16) = xv[i];
        }
      }
    }
    cluster_wait();
  } else if (whole) {
    // the row's max |x| and scale, this warp's alone; then the slice of
    // the row quantized from registers (chunk c is lane c % 32's, its
    // (c / 32)-th), and zeros where the slice runs past the row
    const int r = warp;
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) mx = fmaxf(mx, fabsf(chunk_elem<TIn>(xv[i], e)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
    const float sc = r < M ? row_scale(mx) : 1.f;
    const float inv = __frcp_rn(sc);
    if (lane == 0 && r < M) scale[r] = sc;
#pragma unroll 1
    for (int i = 0; i < kXChunks; ++i) {
      const int c = lane + 32 * i;
      if (c * E < k0 || c * E >= k0 + kc) continue;
      uint4 v = xv[0];
#pragma unroll
      for (int k = 1; k < kXChunks; ++k) v = k == i ? xv[k] : v;
      uint32_t packed[E / 4];
      quantize_chunk<TIn>(v, sc, inv, packed);
      int8_t* dst = xq + r * ldk + c * E - k0;
      if constexpr (E == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = packed[0];
      }
    }
    for (int c = lane; c < chunks; c += 32) {
      if (k0 + c * E >= 32 * kXChunks * E) {
        int8_t* dst = xq + r * ldk + c * E;
        if constexpr (E == 8) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = 0u;
        }
      }
    }
  } else {
    // each row's max |x| over the slice, pushed to every block of the
    // cluster (all of which have started by now) ...
    cluster_wait();
    for (int r = warp; r < M; r += kGroupWarps) {
      float mx = 0.f;
      for (int c0 = 0; c0 < chunks; c0 += 32 * kXChunks) {
        if (r != warp || c0 != 0) load_x(r, c0);
#pragma unroll
        for (int i = 0; i < kXChunks; ++i) {
#pragma unroll
          for (int e = 0; e < E; ++e) mx = fmaxf(mx, fabsf(chunk_elem<TIn>(xv[i], e)));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
      if (lane < C) {
        st_cluster(cluster_map(smem_addr(amax + rank * kMaxRows + r), lane), __float_as_uint(mx));
      }
    }
    // ... and over the cluster's slices: the row's scale, the same in
    // every block
    cluster_sync();
    if (threadIdx.x < M) {
      float m = 0.f;
      for (int q = 0; q < C; ++q) m = fmaxf(m, amax[q * kMaxRows + threadIdx.x]);
      scale[threadIdx.x] = row_scale(m);
    }
    consumers_sync();
    // the slice quantized (read again where it was not kept), a chunk at a
    // time
    for (int r = warp; r < rows; r += kGroupWarps) {
      const float sc = r < M ? scale[r] : 1.f;
      const float inv = __frcp_rn(sc);
      for (int c0 = 0; c0 < chunks; c0 += 32 * kXChunks) {
        if (!kept || r != warp || c0 != 0) load_x(r, c0);
#pragma unroll 1
        for (int i = 0; i < kXChunks; ++i) {
          const int c = c0 + lane + 32 * i;
          if (c >= chunks) break;
          uint4 v = xv[0];
#pragma unroll
          for (int k = 1; k < kXChunks; ++k) v = k == i ? xv[k] : v;
          uint32_t packed[E / 4];
          quantize_chunk<TIn>(v, sc, inv, packed);
          int8_t* dst = xq + r * ldk + c * E;
          if constexpr (E == 8) {
            *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
          } else {
            *reinterpret_cast<uint32_t*>(dst) = packed[0];
          }
        }
      }
    }
  }
  consumers_sync();

  // the product: stage st holds steps 2st and 2st + 1 (64 bytes each) of
  // every column of the tile; lane (g, t) reads 16 bytes of its columns'
  // row g at byte 16·(4h + t), where the 128-byte swizzle put them.  A
  // warp frees a stage once all its lanes have read it.
  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  const int8_t* xlo = xq + g * ldk + t * 16;
  const int8_t* xhi = xq + (g + 8) * ldk + t * 16;
  const bool two = M > 8;
  for (int st = 0; st < stages; ++st) {
    const int slot = st % S;
    mbar_wait(full(slot), (st / S) & 1);
    const uint8_t* stage = ring + slot * BN * kStageK;
#pragma unroll
    for (int h = 0; h < kStageK / kStep; ++h) {
      const int s = kStageK / kStep * st + h;
      const uint4 lo = *reinterpret_cast<const uint4*>(xlo + s * kStep);
      const uint4 hi = two ? *reinterpret_cast<const uint4*>(xhi + s * kStep) : zero;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int row = (warp * NT + j) * 8 + g;
        const uint4 b = *reinterpret_cast<const uint4*>(
            stage + row * kStageK + (((4 * h + t) ^ (row & 7)) << 4));
        mma_step(acc[j], lo, hi, b);
      }
    }
    // the stage's reads (the generic proxy) ordered before TMA (the async
    // proxy) fills it again: without the fence a refill overwrote weight
    // rows still to be read in about 2 % of the launches of Qwen2's gate/up
    // group, whose grid puts two blocks on some SMs
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(slot));
  }

  if (whole) cluster_wait();
  // the partial tile, pushed to the blocks that own its columns: column c
  // to block c / per, as [rank][row][c % per].  Accumulator element i of
  // lane (g, t) for columns j is row g (+8 for i >= 2), column (w·NT + j)·8
  // + 2t + (i & 1).
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = (warp * NT + j) * 8 + 2 * t + (i & 1);
      const int row = g + (i >= 2 ? 8 : 0);
      const int owner = col / per;
      const uint32_t at = smem_addr(red + (rank * kMaxRows + row) * per + col - owner * per);
      st_cluster(cluster_map(at, owner), static_cast<uint32_t>(acc[j][i]));
    }
  }
  if (threadIdx.x < BN) wscale[threadIdx.x] = w_scale;
  if constexpr (std::is_same<TIn, int8_t>::value) {
    if (threadIdx.x < M) scale[threadIdx.x] = x_scale;
  }
  cluster_sync();
  // this block's columns, summed over the cluster's partials in rank order
  // (an integer sum: any order gives the same bits); the epilogue
  // multiplies in the reference's order and rounds once.  No block reads
  // another's shared memory after the barrier, so none waits to leave.
  TOut* out = static_cast<TOut*>(grp.out[mi]);
  const int c0 = rank * per;
  const int ncols = min(BN, c0 + per) - c0;
  for (int o = threadIdx.x; o < M * ncols; o += kGroupWarps * 32) {
    const int r = o / ncols, cl = o % ncols;
    const int n = n0 + c0 + cl;
    int sum = 0;
    for (int q = 0; q < C; ++q) sum += red[(q * kMaxRows + r) * per + cl];
    if (n < N) {
      out[static_cast<long long>(r) * N + n] =
          from_float<TOut>(__int2float_rn(sum) * scale[r] * wscale[c0 + cl]);
    }
  }
}

// ------------------------------------------------------------------------- //
// quantize_rows_kernel: grid ceil(M / (256 / G)), 256 threads; a group of G
// threads (a power of two, 32..256) per row.  Thread l of a group loads
// chunks l, l + G, ... (16 bytes each) of the row, kQChunks at a time, all in
// flight together.  The group's max meets through shuffles (and shared
// memory when it spans warps); then each thread quantizes its chunks from
// registers (a row longer than G·kQChunks chunks is read again) and writes
// them.  xq has row stride ldq and Kq >= K columns, those past K zero.
// Five chunks a thread (not eight) keep it at 48 registers, 5 blocks an SM:
// a row's loads, maxima and stores form one chain, so the kernel is held by
// how many rows an SM has in flight (PERF.md has the times; a persistent
// grid that staged each warp's next row through shared memory read slower).
// ------------------------------------------------------------------------- //
constexpr int kQThreads = 256;
constexpr int kQChunks = 5;                  // chunks a thread holds at once

template <typename T>
__global__ void __launch_bounds__(kQThreads, 5)
quantize_rows_kernel(const T* __restrict__ x, long long ldx, int8_t* __restrict__ xq,
                     long long ldq, float* __restrict__ xs, int M, int K, int Kq, int G,
                     int vec) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float part[kQThreads / 32];
  const int gi = threadIdx.x / G, gl = threadIdx.x % G;
  const long long row = static_cast<long long>(blockIdx.x) * (kQThreads / G) + gi;
  const bool live = row < M;
  const T* xr = x + (live ? row : 0) * ldx;
  const int nc = (K + E - 1) / E;
  const int span = G * kQChunks;             // chunks a group holds at once
  uint4 v[kQChunks];
  auto load = [&](int c0) {
#pragma unroll
    for (int i = 0; i < kQChunks; ++i) {
      const int c = c0 + gl + i * G;
      v[i] = live && c < nc ? load_chunk<T>(xr, c * E, K, vec) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  float mx = 0.f;
  for (int c0 = 0; c0 < nc; c0 += span) {
    load(c0);
#pragma unroll
    for (int i = 0; i < kQChunks; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) mx = fmaxf(mx, fabsf(chunk_elem<T>(v[i], e)));
    }
  }
  for (int o = (G < 32 ? G : 32) / 2; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  }
  if (G > 32) {
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = mx;
    __syncthreads();
    for (int w = gi * (G / 32); w < (gi + 1) * (G / 32); ++w) mx = fmaxf(mx, part[w]);
  }
  if (!live) return;
  const float s = row_scale(mx);
  const float inv = __frcp_rn(s);
  if (gl == 0) xs[row] = s;
  int8_t* qr = xq + row * ldq;
  for (int c0 = 0; c0 < nc; c0 += span) {
    if (nc > span) load(c0);                 // one span: still in registers
#pragma unroll
    for (int i = 0; i < kQChunks; ++i) {     // a chunk at a time
      const int c = c0 + gl + i * G;
      if (c >= nc) break;
      const uint4 vi = v[i];
      uint32_t packed[E / 4];
      quantize_chunk<T>(vi, s, inv, packed);
      int8_t* dst = qr + c * E;
      if (vec) {
        if constexpr (E == 8) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = packed[0];
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (c * E + e < K) dst[e] = static_cast<int8_t>((packed[e / 4] >> (8 * (e % 4))) & 0xFFu);
        }
      }
    }
  }
  if (gl < Kq - K) qr[K + gl] = 0;
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
//   * the epilogue: each consumer warpgroup writes its outputs (fp32 or
//     bf16), 64 rows x 32 columns at a time, into one of two shared-memory
//     boxes that TMA stores (when a row of out is a multiple of 16 bytes,
//     TMA's row-stride rule; lanes store their own pairs otherwise), so the
//     next tile's wgmma's start while the stores drain.
//   * TMA fills rows past M or N and bytes past K with zeros and drops its
//     stores past M or N; the lanes' own stores are masked.
// ------------------------------------------------------------------------- //
constexpr int kBM = 128;                 // rows of a tile: two warpgroups of 64
constexpr int kBK = 128;                 // bytes of K a stage holds
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kWgmmaThreads = kConsumers * 128 + 32;   // + the producer warp

constexpr int kOutBox = 64 * 128;        // bytes of a staged output box: 64 rows of <= 128

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

// the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// two neighbouring outputs into shared memory at `at`, as TOut (bf16: each
// rounded to nearest even, v0 in the low half)
template <typename TOut>
__device__ __forceinline__ void st_pair(uint32_t at, float v0, float v1) {
  if constexpr (std::is_same<TOut, float>::value) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(at), "f"(v0), "f"(v1) : "memory");
  } else {
    uint32_t pair;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(pair) : "f"(v1), "f"(v0));
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(at), "r"(pair) : "memory");
  }
}

// kStore: the epilogue stages boxes of 64 rows x 32 columns in shared memory
// and TMA writes them out (whole 128-byte rows, asynchronously, so the next
// tile's products start at once; needs rows of out a multiple of 16 bytes);
// otherwise each lane stores its own pairs of columns.  TOut: float or
// __nv_bfloat16, rounded once from the fp32 epilogue.
template <int BN, bool kStore, typename TOut>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
          const __grid_constant__ CUtensorMap map_out, const float* __restrict__ xs,
          const float* __restrict__ ws, TOut* __restrict__ out, int M, int N, int K) {
  constexpr int kOutCols = 32;                      // columns a staged box holds
  constexpr int kRowBytes = kOutCols * sizeof(TOut);  // 128 (fp32, swizzled) or 64
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
      // box c holds columns kOutCols·c .. kOutCols·(c + 1) - 1; boxes
      // alternate between two buffers, and a buffer is written once the
      // store that last read it has read it
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
          // byte of the pair in the box's row; a 128-byte row places its
          // 16-byte pieces by the 128-byte swizzle
          const int byte = (8 * jj + 2 * t) * static_cast<int>(sizeof(TOut));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = warp * 16 + g + 8 * h;     // within the box
            const float v0 = __int2float_rn(acc[4 * j + 2 * h]) * x_scale[h] * w0;
            const float v1 = __int2float_rn(acc[4 * j + 2 * h + 1]) * x_scale[h] * w1;
            const int piece = kRowBytes == 128 ? (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15)
                                               : byte;
            st_pair<TOut>(box + row * kRowBytes + piece, v0, v1);
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
        TOut* orow = out + static_cast<long long>(r) * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float v0 = __int2float_rn(acc[4 * j + 2 * h]) * x_scale[h];
          const float v1 = __int2float_rn(acc[4 * j + 2 * h + 1]) * x_scale[h];
          if (pairs && col + 1 < N) {
            const float2 wsc = *reinterpret_cast<const float2*>(ws + col);
            if constexpr (std::is_same<TOut, float>::value) {
              *reinterpret_cast<float2*>(orow + col) = make_float2(v0 * wsc.x, v1 * wsc.y);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(v0 * wsc.x, v1 * wsc.y);
            }
          } else {
            if (col < N) orow[col] = from_float<TOut>(v0 * ws[col]);
            if (col + 1 < N) orow[col + 1] = from_float<TOut>(v1 * ws[col + 1]);
          }
        }
      }
    }
  }
  // the last boxes' reads of shared memory, and their writes, done
  if (kStore && tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int BN, bool kStore, typename TOut>
int launch_wgmma(const CUtensorMap& map_x, const CUtensorMap& map_w, const CUtensorMap& map_out,
                 const float* xs, const float* ws, TOut* out, int M, int N, int K,
                 cudaStream_t s) {
  constexpr int smem = wgmma_smem<BN>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_wgmma<BN, kStore, TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(tiles < num_sms() ? tiles : num_sms());
  qmm_wgmma<BN, kStore, TOut><<<blocks, kWgmmaThreads, smem, s>>>(map_x, map_w, map_out, xs, ws,
                                                                  out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, typename TOut>
int launch_wgmma(const void* X, const void* Wt, const float* xs, const float* ws, TOut* out,
                 int M, int N, int K, cudaStream_t s) {
  CUtensorMap map_x, map_w, map_out;
  if (!make_map(&map_x, X, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, kBM, kBK) ||
      !make_map(&map_w, Wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, BN, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int elem = sizeof(TOut);
  const bool store = (N * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (store) {
    const CUtensorMapDataType type = elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!make_map(&map_out, out, type, elem, M, N, 64, 32,
                  elem == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_wgmma<BN, true, TOut>(map_x, map_w, map_out, xs, ws, out, M, N, K, s);
  }
  map_out = map_w;                       // not read
  return launch_wgmma<BN, false, TOut>(map_x, map_w, map_out, xs, ws, out, M, N, K, s);
}

// ------------------------------------------------------------------------- //
// qmm_group's launch: tiles of 128 columns; K split over a cluster of about
// as many blocks as leaves the grid at one block an SM (at most 8), each
// block a whole number of 128-byte stages.
// ------------------------------------------------------------------------- //
constexpr int kMaxGroupSmem = 227 * 1024;

template <typename TIn, typename TOut>
int launch_group(const void* const* wts, const float* const* wss, void* const* outs,
                 const int* ns, int count, const void* x, long long ldx, const float* xs, int M,
                 int K, int Kp, bool vec_x, cudaStream_t s) {
  constexpr int BN = kGroupBN;
  Group g = {};
  g.members = count;
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    if (!make_map(&g.map[i], wts[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ns[i], Kp, BN, kStageK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    g.ws[i] = wss[i];
    g.out[i] = outs[i];
    g.n[i] = ns[i];
    g.tile0[i] = tiles;
    tiles += (ns[i] + BN - 1) / BN;
  }
  const int stages = (Kp + kStageK - 1) / kStageK;
  int C = num_sms() / tiles;
  C = C < 1 ? 1 : (C > kMaxCluster ? kMaxCluster : C);
  C = C > stages ? stages : C;
  const int per = (stages + C - 1) / C;
  C = (stages + per - 1) / per;
  const int kc = per * kStageK;
  const int ldk = kc + 64;                   // 64 mod 128: no bank conflicts
  const int smem = kMaxRows * ldk + group_smem_fixed();
  if (smem > kMaxGroupSmem || static_cast<long long>(tiles) * C > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = qmm_group<TIn, TOut>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxGroupSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C);
  cfg.blockDim = dim3(kGroupThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, g, static_cast<const TIn*>(x), ldx,
                                             xs, M, K, kc, ldk, vec_x ? 1 : 0));
}

int choose_g(int nc) {
  // the fewest threads a row (32..256) that hold its chunks at once: a row
  // in one warp needs no shared memory to meet, and each thread keeps more
  // loads in flight
  int G = 32;
  while (G < kQThreads && (nc + G - 1) / G > kQChunks) G *= 2;
  return G;
}

}  // namespace

// xq (M, K) int8, wt (N, K) int8, both row-major with row stride K, K % 16 ==
// 0, both 16-byte aligned (the wrapper pads K and copies a misaligned
// operand); xs (M,), ws (N,) fp32; out (M, N) of out_dtype (0 = fp32, 1 =
// bf16).  M <= 16 takes qmm_group on the quantized x (fp32 out only; bn is
// not read); M > 16 takes qmm_wgmma with tiles of 128 x bn columns, bn 128 or
// 256.  Returns a cudaError_t as int (0 = launched).
extern "C" int quant_matmul_launch(const void* xq, const void* wt, const void* xs,
                                   const void* ws, void* out, int M, int N, int K, int bn,
                                   int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (K % 16 != 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto xsf = static_cast<const float*>(xs);
  const auto wsf = static_cast<const float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    if (out_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_group<int8_t, float>(&wt, &wsf, &out, &N, 1, xq, K, xsf, M, K, K, true, s);
  }
  if (out_dtype == 0) {
    float* o = static_cast<float*>(out);
    if (bn == 256) return launch_wgmma<256, float>(xq, wt, xsf, wsf, o, M, N, K, s);
    if (bn == 128) return launch_wgmma<128, float>(xq, wt, xsf, wsf, o, M, N, K, s);
  } else if (out_dtype == 1) {
    auto o = static_cast<__nv_bfloat16*>(out);
    if (bn == 256) return launch_wgmma<256, __nv_bfloat16>(xq, wt, xsf, wsf, o, M, N, K, s);
    if (bn == 128) return launch_wgmma<128, __nv_bfloat16>(xq, wt, xsf, wsf, o, M, N, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch of qmm_group for `count` (1-3) weights that read the same x:
// x (M, K), M <= 16, of dtype (0 = fp32, 1 = bf16) with row stride ldx
// elements and unit column stride; wts[i] (ns[i], Kp) int8 row-major, Kp =
// K rounded up to 16, 16-byte aligned; wss[i] (ns[i],) fp32; outs[i] (M,
// ns[i]) of x's dtype.  Returns a cudaError_t as int (0 = launched).
extern "C" int quant_group_launch(const void* x, long long ldx, int dtype, int M, int K, int Kp,
                                  const void* const* wts, const void* const* wss,
                                  void* const* outs, const int* ns, int count, void* stream) {
  if (M <= 0 || M > 16 || K <= 0 || Kp < K || Kp % 16 != 0 || count < 1 ||
      count > kMaxMembers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < count; ++i) {
    if (ns[i] <= 0 || reinterpret_cast<uintptr_t>(wts[i]) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto wss_f = reinterpret_cast<const float* const*>(wss);
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (ldx * elem) % 16 == 0 &&
                   (K * elem) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_group<float, float>(wts, wss_f, outs, ns, count, x, ldx, nullptr, M, K, Kp,
                                      vec, s);
  }
  if (dtype == 1) {
    return launch_group<__nv_bfloat16, __nv_bfloat16>(wts, wss_f, outs, ns, count, x, ldx,
                                                      nullptr, M, K, Kp, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (M, K) of dtype (0 = fp32, 1 = bf16), row stride ldx elements, unit
// column stride; xq (M, Kq) int8 with row stride ldq, Kq >= K (columns past
// K are written 0); xs (M,) fp32.  Returns a cudaError_t as int (0 =
// launched).
extern "C" int quantize_rows_launch(const void* x, long long ldx, int dtype, void* xq,
                                    long long ldq, void* xs, int M, int K, int Kq,
                                    void* stream) {
  if (M <= 0 || K <= 0 || Kq < K || Kq - K >= 32 || ldq < Kq) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = dtype == 0 ? 4 : 2;
  const int E = 16 / elem;
  const int G = choose_g((K + E - 1) / E);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (ldx * elem) % 16 == 0 &&
                   K % E == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 && ldq % 16 == 0;
  const int rows = kQThreads / G;
  const long long blocks = (static_cast<long long>(M) + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<int8_t*>(xq);
  auto f = static_cast<float*>(xs);
  if (dtype == 0) {
    quantize_rows_kernel<float><<<blocks, kQThreads, 0, s>>>(
        static_cast<const float*>(x), ldx, q, ldq, f, M, K, Kq, G, vec ? 1 : 0);
  } else if (dtype == 1) {
    quantize_rows_kernel<__nv_bfloat16><<<blocks, kQThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, q, ldq, f, M, K, Kq, G, vec ? 1 : 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
