// Fixed-order products for Hopper (sm_90a): for up to 5 weights that read
// the same rows,
//   out_i[m, n] = sum_k xin[m, k] * W_i[n, k]        W_i (N_i, K), out_i (M, N_i)
// each product exact in fp32 (bf16 x bf16, or fp32 x fp32 by FMA), summed in
// fp32 in one order fixed by K alone, and rounded once to out_i's dtype (fp32
// or bf16, per weight).  xin is x itself, or, with the norm prologue, what
// the layer's RMSNorm would have handed the product, computed in the block
// and never written out: rmsnorm(x) (scale, eps, optionally 1 + scale),
// rounded to the weights' dtype.  x is then in the weights' dtype (a
// model's pre-norm) or fp32 (Mamba-2's gated norm, whose gate x = y * silu(z)
// ssd_decode_kernel writes in fp32).  The statistics are summed in
// rmsnorm.cu's order (common.cuh: chunk c of a row to thread c % 256, fma in
// chunk order, an xor butterfly in each warp of 32 such threads, the 8 warp
// sums in warp order), and a normalised element is (x * r) * w, so the row
// the product reads is bitwise what the rmsnorm kernel (and the cast after
// it) would hand it.
//
// Replaces no TPU kernel: the reference's projections are einsums that it
// leaves to XLA (src/repro/models/layers/ssd.py, attention.py, mlp.py).  The
// kernel exists for the port's batch invariance.  The serving engine's
// continuous batching must give the slot-at-a-time oracle's greedy streams,
// so a row's products may not depend on how many rows share the call; a
// cuBLAS product picks its summation order by shape (an fp32 product of 8
// rows differs from the same rows one at a time in most elements).  Folding
// the norm in also takes the norm's own launch and its round trip off every
// decode step.
//
// The bf16 order, the same bits on both bf16 forms (below):
//   * K is cut into k16 steps of 16 contiguous elements at their natural
//     positions (an m16n8k16 mma's k = 0..15, a wgmma's K-major row), and
//     the steps into slices of 16 (256 elements); the last slice runs to a
//     multiple of 4 steps (64 elements), zeros past K;
//   * within a slice the tensor core chains the steps in its own fp32
//     accumulator, the first from zero: P_s = mma(.., mma(.., mma(.., 0)));
//   * the slices are added in order with IEEE adds and the sum is rounded
//     once: out = ((P_0 + P_1) + P_2) + ...
// An output element of an mma or a wgmma is its own dot product, so row m is
// bitwise the same at any M and beside any other rows.  A probe on the
// H100 (tests/csrc/mma_chain_probe.cu, run by tests/test_torch_cuda.py)
// found a chain of 16 bf16 k16 steps the same fp32 bits through
// mma.sync.m16n8k16 and wgmma.m64nNk16 at N = 64, 128 and 256, with either
// operand on the A side, on normal, cancelling, wide-exponent and
// half-cancelling data, and k16 steps of zeros past the data leave a chain
// as it is; so the chain (and not each step from zero plus an IEEE add,
// which gives other bits in 10-99 % of the outputs there) is the order.
//
// Routes, by the weights' dtype and the rows:
//   * bf16 weights, M <= 16 or a norm in front (a decode step):
//     fixed_mma_kernel, on mma.sync.m16n8k16 with 16 weight rows on the m16
//     side and the <= 8 rows of an M-tile of x on the n8 side.
//   * bf16 weights and x, more than 16 rows, no norm (a prefill wave):
//     fixed_wgmma_kernel, on wgmma.m64n128k16, x on the m64 side.
//   * fp32 weights: fixed_fma_kernel on the SIMT pipe (IEEE fp32 FMA; the port
//     keeps fp32 operands off the tensor cores and TF32 off): a warp per output
//     column, K cut into chunks of 4, chunk c to lane c % 32, one fma chain
//     over a lane's chunks in order, the 32 lane sums in a fixed xor
//     butterfly.  Only the reduced-width (fp32) configurations take it.
//
// What bounds them on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 on the
// tensor cores):
//   * a decode step (M <= 16) reads each weight element once for 2·M
//     operations, far below the card's ~295 operations a byte, so the bytes
//     bound it: Mamba2-2.7B's in-projections (2560 x 10576 bf16, 54 MB)
//     16.2 us, its out-projection (5120 x 2560, 26 MB) 7.8 us;
//   * a prefill wave (M = 8,000 rows at Qwen2-1.5B's gate/up, 1536 x 17920)
//     does 2·M operations a weight element, so the tensor cores bound it:
//     440 GFLOP, 0.445 ms at their peak.
//
// How fixed_mma_kernel meets its bound:
//   * every SM streams the same share of the weights: a persistent grid of
//     clusters of C blocks (one block an SM, C chosen on the host so that
//     the most (16-row tile, slice) items a block takes is least), cluster c
//     takes a contiguous run of the tiles and its C x 8 warps split the
//     run's items evenly, so a tile's slices may be multiplied in several
//     blocks;
//   * each warp streams its items through a ring of 1-4 pieces of 4 KB in
//     shared memory (16 weight rows x 128 elements, half a slice) by
//     cp.async, a 256-byte row piece a half-warp an instruction, so the
//     loads are long runs of each row; ldmatrix hands the mma the weights'
//     fragments at their natural positions (the ring's 16-byte chunks are
//     XOR-swizzled by row, so it reads without bank conflicts);
//   * x's rows (and the norm's scale) arrive by cp.async, all in flight at
//     once and behind the first pieces, into rows 16 bytes past a multiple
//     of 128 bytes apart (no bank conflicts in the fragments' 4-byte reads);
//     where the rows do not fit whole beside two pieces a warp (K above
//     9,152; no served width), they are staged 4,096 elements at a time,
//     the warps taking that phase's slices before the next is loaded, or,
//     behind a norm (whose statistics need the whole row), whole beside
//     one piece a warp;
//     behind a norm, bf16 rows are normalised in place by the whole block in
//     rmsnorm.cu's order, and fp32 rows (Mamba-2's gate) by the cluster: a
//     block reads each of its rows from global memory into registers, and
//     writes the bf16 row into the tile of every block of the cluster;
//   * an item's 16 x 8 partial goes to shared memory of the block of the
//     cluster that owns its tile (a store into a neighbour's shared memory);
//     one cluster barrier at the end of a wave of tiles (all of the served
//     shapes are one wave), and each block adds its tiles' slices in order
//     and rounds once.  Where more waves are needed, a second barrier ends
//     each wave (the partials' buffer is read before the next wave's
//     pushes), and the rings run on across the barriers.  No workspace,
//     nothing allocated: a CUDA graph captures the launch as it is.
//
// How fixed_wgmma_kernel meets its bound: qmm_wgmma's shape (quant_matmul.cu)
// in bf16.  A persistent grid (at most one block an SM) walks 128 x 128
// output tiles (x rows fastest, so the blocks in flight share a weight tile
// in L2, or weight tiles fastest where x is the larger operand); a producer
// warpgroup keeps a ring of 6 stages full with TMA, each 128 rows of x and
// 128 weight rows by 64 elements of K in the 128-byte swizzle (TMA fills
// zeros past M, N and K and takes x's row stride); two consumer warpgroups
// of 64 x 128 issue wgmma.m64n128k16 from shared memory, chain a slice's 16
// steps in one accumulator set and add it to a second with IEEE adds (64 a
// thread a slice, beside 16 wgmma's; setmaxnreg gives them the producer's
// registers), and round once into bf16 or fp32 per weight.  The second
// accumulator set is the order's price: it holds a warpgroup's tile to
// 64 x 128 (160 or 192 weight rows spill even at 232 registers), which reads
// shared memory a fifth more for each product than 64 x 256 would.  The TMA maps are built
// on the host at each call (an eager prefill; no CUDA graph captures this
// form).
//
// x (M, K) has a 16-byte aligned row stride (ldx elements), K % 8 == 0; each
// weight (N_i, K) is contiguous and 16-byte aligned; outputs are contiguous.
// The C launcher takes PyTorch's current stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using port::num_sms;
using port::smem_addr;

constexpr int kThreads = port::kRmsThreads;   // 256, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 5;                      // weights one launch takes
constexpr int kMmaRows = 8;                   // rows of x an mma M-tile holds (n8)
constexpr int kGroups = 8;                    // 32-element groups of K in a slice
constexpr int kSliceK = kGroups * 32;         // 256 elements: a slice of the order
constexpr int kItemFloats = 128;              // a (tile, slice) partial: 16 x 8 sums
constexpr int kNormPer = 32;                  // fp32 route: a row's elements a thread normalises
constexpr int kSmemMax = 226 * 1024;          // dynamic, beside the static bytes
constexpr int kDecodeRows = 16;               // more rows (bf16, no norm) take the tiled form
constexpr int kMaxCluster = 8;

using bf16 = __nv_bfloat16;

struct Group {
  const void* w[kMaxW];       // weight i, (N_i, K) row-major
  void* out[kMaxW];           // (M, N_i)
  int n[kMaxW];
  int out_bf16[kMaxW];
  int tile0[kMaxW + 1];       // each weight's first tile of 16 rows; tile0[count]: all
  int count;
};

// The norm in front of the product (norm == 0: none).
struct Prologue {
  int norm;
  const void* scale;          // (K,), fp32 or bf16
  int scale_bf16;
  int plus_one;               // the scale is taken as 1 + scale
  float eps;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void put(float v, float* p) { *p = v; }
__device__ __forceinline__ void put(float v, bf16* p) { *p = __float2bfloat16_rn(v); }

// 16 bytes of T at p (aligned) as floats
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ float scale_at(const Prologue& pro, long long e) {
  return pro.scale_bf16 ? port::norm_weight(static_cast<const bf16*>(pro.scale), e, pro.plus_one)
                        : port::norm_weight(static_cast<const float*>(pro.scale), e,
                                            pro.plus_one);
}

// r = 1 / sqrt(mean(x^2) + eps) of one row held in shared memory, by one
// warp, in rmsnorm.cu's order: chunk c (16 bytes of TX) is thread c % 256's,
// whose squares run in chunk order; lane l keeps the sums of threads
// l + 32w (w = 0..7), the 8 warps' butterflies are added in warp order.
template <typename TX>
__device__ __forceinline__ float row_rinv(const TX* row, int K, float eps) {
  constexpr int E = 16 / sizeof(TX);
  const int lane = threadIdx.x & 31;
  const int chunks = K / E;
  float s[port::kRmsWarps];
#pragma unroll
  for (int w = 0; w < port::kRmsWarps; ++w) s[w] = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += port::kRmsThreads) {
#pragma unroll
    for (int w = 0; w < port::kRmsWarps; ++w) {
      const int c = c0 + 32 * w + lane;
      if (c < chunks) {
        float v[E];
        load16(row + c * E, v);
#pragma unroll
        for (int i = 0; i < E; ++i) s[w] = port::sq_add(s[w], v[i]);
      }
    }
  }
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < port::kRmsWarps; ++w) {
    const float sw = port::warp_sum(s[w]);
    t = w == 0 ? sw : __fadd_rn(t, sw);
  }
  return port::rms_inv_of(t, K, eps);
}

// The weight of tile `tile` (G: Group or TiledGroup).
template <typename G>
__device__ __forceinline__ int weight_of(const G& grp, int tile) {
  int i = 0;
#pragma unroll
  for (int j = 1; j < kMaxW; ++j) {
    if (j < grp.count && tile >= grp.tile0[j]) i = j;
  }
  return i;
}

// Round a sum once to weight i's output type and store it.
template <typename G>
__device__ __forceinline__ void store_out(const G& grp, int i, long long at, float v) {
  if (grp.out_bf16[i]) {
    static_cast<bf16*>(grp.out[i])[at] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(grp.out[i])[at] = v;
  }
}

// ------------------------------------------------------------------------- //
// bf16 weights, a decode step: fixed_mma_kernel.
// ------------------------------------------------------------------------- //
constexpr int kTileRows = 16;                  // weight rows a tile (the m16 side)
constexpr int kPieceK = 128;                   // elements of K a ring piece holds
constexpr int kPieceBytes = kTileRows * kPieceK * 2;   // 4 KB: half a tile's slice
constexpr int kMaxPieces = 4;                  // pieces a warp's ring holds at most
constexpr int kNormChunks = 8;                 // fp32 x: a row's 16-byte chunks a thread holds

// The decode form's layout and split of the work, fixed on the host by K,
// the widths and the card (never by M).
struct Plan {
  int pitch;        // bytes of a bf16 row of x in shared memory (16 mod 128)
  int scale_off;    // the norm's scale, K elements as given (bf16 x)
  int part_off;     // the partials: [wave / C][S][128] fp32
  int ring_off;     // the warps' rings: [8][pieces][16 rows][256 bytes]
  int pieces;       // pieces a warp keeps in flight (1 .. kMaxPieces)
  int S;            // slices of K
  int SQ;           // slices of x's rows staged at once: S, or kPhaseSlices
  int Q;            // phases of x's rows: ceil(S / SQ)
  int C;            // blocks a cluster
  int G;            // clusters
  int wave;         // tiles a cluster takes at once (a multiple of C)
  int smem;         // dynamic shared memory bytes
};

__device__ __forceinline__ uint32_t lds32(const char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes from global memory into shared memory, or zeros (nothing read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of this thread's groups are in flight (n <= 4)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// kx elements of the 8 rows of an M-tile of x, bf16 (a phase of x's rows,
// or the whole rows): issue their cp.async (and the norm's scale's, K
// elements) as one group.
__device__ void issue_x(const bf16* __restrict__ x, long long ldx, int rows, int kx, int K,
                        const Prologue& pro, char* smem, const Plan& pl) {
  const int chunks = kx / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks, c = e % chunks;
    cp_async16(smem + r * pl.pitch + c * 16, x + r * ldx + c * 8);
  }
  if (pro.norm) {
    const int n16 = K * (pro.scale_bf16 ? 2 : 4) / 16;
    const char* src = static_cast<const char*>(pro.scale);
    for (int c = threadIdx.x; c < n16; c += kThreads) {
      cp_async16(smem + pl.scale_off + c * 16, src + c * 16);
    }
  }
  cp_async_commit();
}

// r = 1 / sqrt(mean + eps) of each row from each thread's sums of squares,
// in rmsnorm.cu's order: each warp's sums in a butterfly, the 8 warp sums in
// warp order, by thread r for row r (sums: [8 warps + 1][rows] in shared
// memory, the last row for the results)
template <int R>
__device__ __forceinline__ void row_inv(float (&sq)[R], float (*sums)[kMmaRows], int K,
                                        float eps, float (&rinv)[R]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float w = port::warp_sum(sq[r]);
    if (lane == 0) sums[warp][r] = w;
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float part[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) part[w] = sums[w][threadIdx.x];
    sums[kWarps][threadIdx.x] = port::rms_inv(part, K, eps);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) rinv[r] = sums[kWarps][r];
}

// bf16 x behind the norm: the whole block on the tile's rows at once, in
// place (element e of a row is read and written by the same thread): chunk c
// of every row to thread c % 256, which sums its chunks' squares in chunk
// order (rmsnorm.cu's order), then writes (x * r) * w rounded to bf16.
__device__ void normalize_bf16(int rows, int K, const Prologue& pro, char* smem, const Plan& pl,
                               float (*sums)[kMmaRows]) {
  const int chunks = K / 8;
  auto row = [&](int r) { return reinterpret_cast<bf16*>(smem + r * pl.pitch); };
  float sq[kMmaRows];
#pragma unroll
  for (int r = 0; r < kMmaRows; ++r) sq[r] = 0.f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
#pragma unroll
    for (int r = 0; r < kMmaRows; ++r) {
      if (r < rows) {
        float v[8];
        load16(row(r) + c * 8, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) sq[r] = port::sq_add(sq[r], v[i]);
      }
    }
  }
  float rinv[kMmaRows];
  row_inv(sq, sums, K, pro.eps, rinv);
  const char* sc = smem + pl.scale_off;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    // the chunk's 8 scales (port::norm_weight's value), read 16 bytes at a
    // time, and each row's 8 elements written back as one 16-byte store
    float w[8];
    if (pro.scale_bf16) {
      load16(reinterpret_cast<const bf16*>(sc) + c * 8, w);
    } else {
      float lo[4], hi[4];
      load16(reinterpret_cast<const float*>(sc) + c * 8, lo);
      load16(reinterpret_cast<const float*>(sc) + c * 8 + 4, hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = lo[j];
        w[j + 4] = hi[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = pro.plus_one ? __fadd_rn(1.0f, w[j]) : w[j];
#pragma unroll
    for (int r = 0; r < kMmaRows; ++r) {
      if (r < rows) {
        float v[8];
        load16(row(r) + c * 8, v);
        uint4 packed;
        bf16* h = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) put(port::rms_scale(v[j], rinv[r], w[j]), h + j);
        *reinterpret_cast<uint4*>(row(r) + c * 8) = packed;
      }
    }
  }
}

// fp32 x behind the norm (Mamba-2's gate): block `rank` of the cluster
// normalises rows rank, rank + C, ... of the tile, one at a time, from
// global memory into registers (chunk c of the row to thread c % 256, in
// rmsnorm.cu's order), into its own tile; then, once every block of the
// cluster has started (the wait of the cluster barrier whose arrival the
// kernel made first), it copies those bf16 rows, 16 bytes a store, into the
// tile of every other block of the cluster.
__device__ void normalize_fp32(const float* __restrict__ x, long long ldx, int rows, int K,
                               const Prologue& pro, char* smem, const Plan& pl, int rank,
                               float (*sums)[kMmaRows]) {
  const int chunks = K / 4;
  const int tid = threadIdx.x;
  float w[kNormChunks][4];
#pragma unroll
  for (int j = 0; j < kNormChunks; ++j) {
    const int c = tid + j * kThreads;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[j][i] = c < chunks ? scale_at(pro, c * 4 + i) : 0.f;
  }
  for (int r = rank; r < rows; r += pl.C) {
    float v[kNormChunks][4];
    float sq[1] = {0.f};
#pragma unroll
    for (int j = 0; j < kNormChunks; ++j) {
      const int c = tid + j * kThreads;
      if (c < chunks) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(x + r * ldx) + c);
        v[j][0] = a.x; v[j][1] = a.y; v[j][2] = a.z; v[j][3] = a.w;
#pragma unroll
        for (int i = 0; i < 4; ++i) sq[0] = port::sq_add(sq[0], v[j][i]);
      }
    }
    float rinv[1];
    row_inv(sq, sums, K, pro.eps, rinv);
    char* row = smem + r * pl.pitch;
#pragma unroll
    for (int j = 0; j < kNormChunks; ++j) {
      const int c = tid + j * kThreads;
      if (c < chunks) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            port::rms_scale(v[j][0], rinv[0], w[j][0]), port::rms_scale(v[j][1], rinv[0], w[j][1]));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(
            port::rms_scale(v[j][2], rinv[0], w[j][2]), port::rms_scale(v[j][3], rinv[0], w[j][3]));
        *reinterpret_cast<uint2*>(row + c * 8) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
    __syncthreads();                     // sums is read again for the next row
  }
  const int n16 = K / 8;                 // 16-byte pieces of a bf16 row
  port::cluster_wait();                  // every block of the cluster has started
  for (int r = rank; r < rows; r += pl.C) {
    const char* row = smem + r * pl.pitch;
    const uint32_t at = smem_addr(row);
    for (int e = tid; e < (pl.C - 1) * n16; e += kThreads) {
      const int peer = (rank + 1 + e / n16) % pl.C, q = e % n16;
      port::st_cluster(port::cluster_map(at + q * 16, peer),
                       *reinterpret_cast<const uint4*>(row + q * 16));
    }
  }
}

// grid (C x G, M-tiles of 8) in clusters of C along x, kThreads threads;
// dynamic shared memory as the Plan lays it out.
template <typename TX>
__global__ void __launch_bounds__(kThreads, 1)
fixed_mma_kernel(const __grid_constant__ Group grp, const __grid_constant__ Prologue pro,
                 const TX* __restrict__ x, long long ldx, int M, int K,
                 const __grid_constant__ Plan pl) {
  extern __shared__ float4 smem4[];
  __shared__ float sums[kWarps + 1][kMmaRows];
  char* smem = reinterpret_cast<char*>(smem4);
  // no block stores into another before every block of the cluster started
  port::cluster_arrive_relaxed();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int C = pl.C, S = pl.S, P = pl.pieces;
  const int rank = static_cast<int>(port::cluster_rank());
  const int cluster = blockIdx.x / C;
  const int tiles = grp.tile0[grp.count];
  const int T0 = static_cast<int>(static_cast<long long>(cluster) * tiles / pl.G);
  const int nt = static_cast<int>(static_cast<long long>(cluster + 1) * tiles / pl.G) - T0;
  const int waves = (nt + pl.wave - 1) / pl.wave;
  const int SQ = pl.SQ, Q = pl.Q;
  const int gw = rank * kWarps + warp, nw = C * kWarps;
  const long long m0 = static_cast<long long>(blockIdx.y) * kMmaRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kMmaRows), M - m0));
  const uint32_t part = smem_addr(smem + pl.part_off);
  const uint32_t ring = smem_addr(smem + pl.ring_off) + warp * P * kPieceBytes;

  // a piece of this warp's items: wave w, phase q of x's rows, item u of
  // the (wave, phase) (up to e), half h; item u is slice q * SQ + u % sq of
  // tile u / sq of the wave (sq: the phase's slices)
  struct Cur {
    int w, q, u, e, h;
  };
  auto sq_of = [&](int q) { return min(SQ, S - q * SQ); };
  auto settle = [&](Cur c) {
    while (c.w < waves && c.u >= c.e) {
      if (++c.q == Q) {
        c.q = 0;
        ++c.w;
      }
      if (c.w < waves) {
        const int U = min(pl.wave, nt - c.w * pl.wave) * sq_of(c.q);
        c.u = static_cast<int>(static_cast<long long>(U) * gw / nw);
        c.e = static_cast<int>(static_cast<long long>(U) * (gw + 1) / nw);
      }
    }
    return c;
  };
  auto slice_of = [&](const Cur& c) { return c.q * SQ + c.u % sq_of(c.q); };
  auto tile_of = [&](const Cur& c) { return c.u / sq_of(c.q); };   // of the wave
  // slice s's k16 steps: to a multiple of 4 past K; its pieces: 1 or 2
  auto steps_of = [&](int s) { return min(16, 4 * ((K - s * kSliceK + 63) / 64)); };
  auto next = [&](Cur c) {
    if (c.h == 0 && steps_of(slice_of(c)) > 8) {
      c.h = 1;
      return c;
    }
    c.h = 0;
    ++c.u;
    return settle(c);
  };
  // piece c's 16 weight rows x 128 elements into ring slot `slot`, a row
  // per half-warp an instruction, 16-byte chunk q of row r at chunk q ^ (r % 8)
  // (ldmatrix then reads without bank conflicts); zeros past K and the rows
  auto issue = [&](Cur c, int slot) {
    if (c.w < waves) {
      const int tile = T0 + c.w * pl.wave + tile_of(c);
      const int i = weight_of(grp, tile);
      const long long v0 = static_cast<long long>(tile - grp.tile0[i]) * kTileRows;
      const bf16* w = static_cast<const bf16*>(grp.w[i]);
      const int q = lane & 15;
      const int k = slice_of(c) * kSliceK + c.h * kPieceK + q * 8;
      const uint32_t dst = ring + slot * kPieceBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 2 * j + (lane >> 4);
        const bool ok = v0 + r < grp.n[i] && k < K;
        cp_async16_zfill(dst + r * 256 + ((q ^ (r & 7)) << 4),
                         w + (ok ? (v0 + r) * K + k : 0), ok);
      }
    }
    cp_async_commit();
  };
  // phase q's elements of x's rows, and zeros from there to a multiple of 64
  // (and in the tile's rows past M)
  auto kx_of = [&](int q) { return min(K - q * SQ * kSliceK, SQ * kSliceK); };
  auto pad_x = [&](int q) {
    const int kx = kx_of(q), kpad = (kx + 63) / 64 * 64;
    for (int r = 0; r < kMmaRows; ++r) {
      bf16* row = reinterpret_cast<bf16*>(smem + r * pl.pitch);
      for (int e = (r < rows ? kx : 0) + threadIdx.x; e < kpad; e += kThreads) {
        row[e] = __float2bfloat16_rn(0.f);
      }
    }
  };

  Cur ic = settle(Cur{-1, Q - 1, 0, 0, 0});
  Cur cc = ic;
  if constexpr (sizeof(TX) == 2) {
    issue_x(reinterpret_cast<const bf16*>(x) + m0 * ldx, ldx, rows, kx_of(0), K, pro, smem, pl);
  } else {
    cp_async_commit();
  }
  for (int p = 0; p < P; ++p) {
    issue(ic, p);
    ic = next(ic);
  }
  cp_async_wait(P);                                 // x's rows (and the scale) are in
  __syncthreads();
  if constexpr (sizeof(TX) == 2) {
    if (pro.norm) normalize_bf16(rows, K, pro, smem, pl, sums);
  } else {
    normalize_fp32(reinterpret_cast<const float*>(x) + m0 * ldx, ldx, rows, K, pro, smem, pl,
                   rank, sums);
    port::cluster_arrive();                         // every block's rows are written ...
  }
  pad_x(0);
  __syncthreads();
  port::cluster_wait();                             // ... and seen here

  // the tile's 16 weight rows on the m16 side, x's rows on the n8 side
  int slot = 0;
  float acc[4];
  for (int w = 0; w < waves; ++w) {
    for (int q = 0; q < Q; ++q) {
      if constexpr (sizeof(TX) == 2) {
        if (Q > 1 && w + q > 0) {
          // x's rows of phase q (no norm: the rows were not whole), once
          // every warp is done with the last phase's; the ring's pieces in
          // flight land too
          __syncthreads();
          issue_x(reinterpret_cast<const bf16*>(x) + m0 * ldx + q * SQ * kSliceK, ldx, rows,
                  kx_of(q), K, pro, smem, pl);
          pad_x(q);
          cp_async_wait(0);
          __syncthreads();
        }
      }
      while (cc.w == w && cc.q == q) {
        cp_async_wait(P - 1);                       // piece cc is in
        __syncwarp();
        const int s = slice_of(cc), j = tile_of(cc);
        const int steps = min(8, steps_of(s) - 8 * cc.h);
        if (cc.h == 0) acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
        const char* xr =
            smem + g * pl.pitch + ((s - q * SQ) * kSliceK + cc.h * kPieceK) * 2 + 4 * t;
        // ldmatrix: lane l gives row (l / 8 % 2) * 8 + l % 8 of the piece,
        // chunk 2 * step + l / 16
        const int mi = lane >> 3, r = (mi & 1) * 8 + (lane & 7);
        const uint32_t arow = ring + slot * kPieceBytes + r * 256;
#pragma unroll
        for (int kk = 0; kk < kPieceK / 16; ++kk) {
          if (kk < steps) {
            uint32_t a[4];
            ldmatrix_x4(arow + (((2 * kk + (mi >> 1)) ^ (r & 7)) << 4), a);
            port::mma_bf16_chain(acc, a[0], a[1], a[2], a[3], lds32(xr + 32 * kk),
                                 lds32(xr + 32 * kk + 16));
          }
        }
        __syncwarp();                               // every lane has read the slot
        issue(ic, slot);
        ic = next(ic);
        if (cc.h == 1 || steps_of(s) <= 8) {
          // the slice's chain, pushed to the block that owns its tile
          const uint32_t at = part + (((j / C) * S + s) * kItemFloats + lane * 4) * 4;
          port::st_cluster(port::cluster_map(at, j % C), acc);
        }
        cc = next(cc);
        slot = slot + 1 == P ? 0 : slot + 1;
      }
    }
    port::cluster_arrive();          // this block's pushes of wave w ...
    port::cluster_wait();            // ... and every block's, to this one
    // the wave's tiles this block owns, j = rank, rank + C, ...: output
    // (weight row nl, x row mr) is element (nl >= 8) * 2 + (mr & 1) of lane
    // (nl & 7) * 4 + mr / 2's partials, summed over the slices in order
    const int tw = min(pl.wave, nt - w * pl.wave);
    const int mine = rank < tw ? (tw - rank + C - 1) / C : 0;
    const float* pb = reinterpret_cast<const float*>(smem + pl.part_off);
    for (int o = threadIdx.x; o < mine * kItemFloats; o += kThreads) {
      const int jj = o / kItemFloats, e = o % kItemFloats;
      const int nl = e >> 3, mr = e & 7;
      const int src = ((nl & 7) * 4 + (mr >> 1)) * 4 + (nl >= 8 ? 2 : 0) + (mr & 1);
      const float* p = pb + jj * S * kItemFloats + src;
      float sum = p[0];
      for (int s = 1; s < S; ++s) sum = __fadd_rn(sum, p[s * kItemFloats]);
      const int tile = T0 + w * pl.wave + rank + jj * C;
      const int i = weight_of(grp, tile);
      const long long n = static_cast<long long>(tile - grp.tile0[i]) * kTileRows + nl;
      const long long m = m0 + mr;
      if (m < M && n < grp.n[i]) store_out(grp, i, m * grp.n[i] + n, sum);
    }
    if (w + 1 < waves) {
      port::cluster_arrive();        // every block has read its partials
      port::cluster_wait();          // before the next wave's pushes
    }
  }
  cp_async_wait(0);
}

// ------------------------------------------------------------------------- //
// bf16 weights and x, many rows: fixed_wgmma_kernel.  A persistent grid walks
// (ceil(M / 128) x the group's tiles of 128 weight rows) output tiles.
// Shared memory (from a 1024-byte boundary): the ring, kStages x ([128 x
// rows][128 bytes] then [128 weight rows][128 bytes]); the full and empty
// barriers.
// ------------------------------------------------------------------------- //
constexpr int kBM = 128;                 // rows of x a tile: two warpgroups of 64
constexpr int kBN = 128;                 // weight rows a tile
constexpr int kBK = 64;                  // elements of K a stage holds (128 bytes)
constexpr int kStages = 6;
constexpr int kConsumers = 2;
constexpr int kWgThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kStageBytes = (kBM + kBN) * kBK * 2;
constexpr int kWgmmaSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;

struct TiledGroup {
  CUtensorMap map[kMaxW];     // weight i, (N_i, K) bf16, boxes of 128 rows x 64
  void* out[kMaxW];
  int n[kMaxW];
  int out_bf16[kMaxW];
  int tile0[kMaxW + 1];       // each weight's first tile of 128 rows; tile0[count]: all
  int count;
};

// map_x: boxes of 128 rows x 64.  n_fastest: consecutive tiles share x's rows
// (where x is larger than the weights), else the weights' rows.
__global__ void __launch_bounds__(kWgThreads, 1)
fixed_wgmma_kernel(const __grid_constant__ TiledGroup tg, const __grid_constant__ CUtensorMap map_x,
                   int M, int K, int n_fastest) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t a_base = base;                                  // [kStages][kBM][128 B]
  const uint32_t b_base = base + kStages * kBM * kBK * 2;        // [kStages][kBN][128 B]
  const uint32_t bars = base + kStages * kStageBytes;            // full[kStages], empty[kStages]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      port::mbar_init(full(s), 1);
      port::mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = tg.tile0[tg.count];
  const int tiles = m_tiles * n_tiles;
  const int steps = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  auto place = [&](int tile, int& nt, int& m0) {
    nt = n_fastest ? tile % n_tiles : tile / m_tiles;
    m0 = (n_fastest ? tile / n_tiles : tile % m_tiles) * kBM;
  };

  if (wg == kConsumers) {
    // the producer warpgroup: one thread issues the loads; the warpgroup
    // hands registers to the consumers (setmaxnreg: at 384 threads ptxas
    // gives a thread 168, and the consumers' two accumulator sets spill
    // there)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int nt, m0;
        place(tile, nt, m0);
        const int i = weight_of(tg, nt);
        const int n0 = (nt - tg.tile0[i]) * kBN;
        for (int s = 0; s < steps; ++s) {
          port::mbar_wait(empty(stage), phase ^ 1);
          port::mbar_expect(full(stage), kStageBytes);
          port::tma_load(a_base + stage * kBM * kBK * 2, &map_x, s * kBK, m0, full(stage));
          port::tma_load(b_base + stage * kBN * kBK * 2, &tg.map[i], s * kBK, n0, full(stage));
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  } else {
    // a consumer warpgroup: rows wg * 64 .. wg * 64 + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    auto release = [&](int st) {
      if (tid == 0) port::mbar_arrive(empty(st));
    };
    int stage = 0;
    uint32_t phase = 0;
    float acc[kBN / 2], total[kBN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int nt, m0;
      place(tile, nt, m0);
      const int i = weight_of(tg, nt);
      const int n0 = (nt - tg.tile0[i]) * kBN;
      int held = -1;                     // a stage whose wgmma's may be in flight
      for (int s = 0; s < steps; ++s) {
        port::mbar_wait(full(stage), phase);
        const uint32_t a = a_base + stage * kBM * kBK * 2 + wg * 64 * kBK * 2;
        const uint32_t b = b_base + stage * kBN * kBK * 2;
        port::fence_regs(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // a slice (4 stages) starts its chain from zero
          port::WgmmaBf16<kBN>::mma(acc, port::sw128_desc(a + kk * 32),
                                    port::sw128_desc(b + kk * 32), (s & 3) != 0 || kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if ((s & 3) == 3 || s == steps - 1) {
          // the slice's chain is done: add it to the slices before it
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          port::fence_regs(acc);
          if (held >= 0) release(held);
          release(stage);
          held = -1;
#pragma unroll
          for (int e = 0; e < kBN / 2; ++e) {
            total[e] = s < 4 ? acc[e] : __fadd_rn(total[e], acc[e]);
          }
        } else {
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          port::fence_regs(acc);
          if (held >= 0) release(held);
          held = stage;
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // element 4j + e of lane (g, t): x row g (+8 for e >= 2) of the warp's
      // 16, weight row 8j + 2t + (e & 1); each rounded once to its output type
      const int n = tg.n[i];
      const bool pairs = n % 2 == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wg * 64 + warp * 16 + g + 8 * h;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float v0 = total[4 * j + 2 * h], v1 = total[4 * j + 2 * h + 1];
          const long long at = static_cast<long long>(r) * n + col;
          if (pairs && col + 1 < n) {
            if (tg.out_bf16[i]) {
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(tg.out[i]) + at) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              *reinterpret_cast<float2*>(static_cast<float*>(tg.out[i]) + at) =
                  make_float2(v0, v1);
            }
          } else {
            if (col < n) store_out(tg, i, at, v0);
            if (col + 1 < n) store_out(tg, i, at + 1, v1);
          }
        }
      }
    }
  }
}

// The SIMT route's staging, as the first design had it (kept as it was, so
// that the fp32 route compiles to the same kernel).
// Rows m0 .. m0 + R - 1 (R <= 8) of what the product reads, staged in shared
// memory as TS, row r at xs + r * ld elements, zeros past K (up to ld) and
// for rows past M.  x's rows (TX) arrive by cp.async into `raw` ([R][K]);
// with the norm, warp r computes row r's r.  Where the raw rows lie apart
// from the tile, warp r then normalises its own row into the tile; where
// they overlap (fp32 rows too wide for both), the rows are normalised one
// at a time by the whole block, each read into registers before any of it
// is written, in an order that never overwrites a raw row still to be read:
// the tile's rows are narrower than the raw rows when TX is fp32
// (forward), and at most 64 bytes wider when TX is TS (backward).
template <typename TX, typename TS>
__device__ void stage_rows(const TX* __restrict__ x, long long ldx, int M, int K,
                           long long m0, int R, const Prologue& pro, TS* xs, int ld,
                           TX* raw, bool apart) {
  constexpr int E = 16 / sizeof(TX);
  constexpr int kPer = kNormPer / E;           // chunks of a row a thread holds
  __shared__ float rinv[kMmaRows];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rows = static_cast<int>(min(static_cast<long long>(R), M - m0));
  const int chunks = K / E;
  TX* dst0 = pro.norm ? raw : reinterpret_cast<TX*>(xs);
  const int ldd = pro.norm ? K : ld;
  for (int e = tid; e < rows * chunks; e += kThreads) {
    const int r = e / chunks, c = e % chunks;
    cp_async16(dst0 + static_cast<long long>(r) * ldd + c * E, x + (m0 + r) * ldx + c * E);
  }
  // the norm's weights of this thread's elements (the same in every row),
  // read while the rows are in flight, for the one-row-at-a-time path
  float wv[kPer][E];
  if (pro.norm && !apart) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = tid + k * kThreads;
#pragma unroll
      for (int j = 0; j < E; ++j) wv[k][j] = c < chunks ? scale_at(pro, c * E + j) : 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (pro.norm && apart) {
    if (warp < rows) {
      const TX* src = raw + static_cast<long long>(warp) * K;
      const float rv = row_rinv(src, K, pro.eps);
      TS* row = xs + static_cast<long long>(warp) * ld;
      for (int c = tid & 31; c < chunks; c += 32) {
        float v[E];
        load16(src + c * E, v);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          put(port::rms_scale(v[j], rv, scale_at(pro, c * E + j)), row + c * E + j);
        }
      }
    }
  } else if (pro.norm) {
    if (warp < rows) {
      const float rv = row_rinv(raw + static_cast<long long>(warp) * K, K, pro.eps);
      if ((tid & 31) == 0) rinv[warp] = rv;
    }
    __syncthreads();
    const bool forward = sizeof(TX) > sizeof(TS);
    for (int i = 0; i < rows; ++i) {
      const int r = forward ? i : rows - 1 - i;
      float v[kPer][E];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = tid + k * kThreads;
        if (c < chunks) load16(raw + static_cast<long long>(r) * K + c * E, v[k]);
      }
      __syncthreads();
      const float rr = rinv[r];
      TS* row = xs + static_cast<long long>(r) * ld;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = tid + k * kThreads;
        if (c < chunks) {
#pragma unroll
          for (int j = 0; j < E; ++j) {
            put(port::rms_scale(v[k][j], rr, wv[k][j]), row + c * E + j);
          }
        }
      }
      __syncthreads();
    }
  }
  for (int r = 0; r < R; ++r) {
    TS* row = xs + static_cast<long long>(r) * ld;
    for (int e = (r < rows ? K : 0) + tid; e < ld; e += kThreads) row[e] = TS(0.f);
  }
}

// ------------------------------------------------------------------------- //
// fp32: the SIMT route.  grid (blocks, M-tiles of R), kThreads threads;
// dynamic shared memory: the raw rows [R][K] (with the norm) and x's M-tile
// [R][K] fp32.  A warp per output column (grid-stride over every column of
// the group).
// ------------------------------------------------------------------------- //
__global__ void __launch_bounds__(kThreads)
fixed_fma_kernel(const __grid_constant__ Group grp, const __grid_constant__ Prologue pro,
                 const float* __restrict__ x, long long ldx, int M, int K, int R) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const long long m0 = static_cast<long long>(blockIdx.y) * R;
  stage_rows<float, float>(x, ldx, M, K, m0, R, pro, xs, K, xs + (pro.norm ? R * K : 0), true);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long cols = static_cast<long long>(grp.tile0[grp.count]) * 16;
  for (long long c = static_cast<long long>(blockIdx.x) * kWarps + warp; c < cols;
       c += static_cast<long long>(gridDim.x) * kWarps) {
    const int tile = static_cast<int>(c / 16);
    const int i = weight_of(grp, tile);
    const long long n = static_cast<long long>(tile - grp.tile0[i]) * 16 + c % 16;
    if (n >= grp.n[i]) continue;
    const float* wr = static_cast<const float*>(grp.w[i]) + n * K;
    float acc[kMmaRows];
#pragma unroll
    for (int r = 0; r < kMmaRows; ++r) acc[r] = 0.f;
    for (int ch = lane; ch < K / 4; ch += 32) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + ch * 4));
#pragma unroll
      for (int r = 0; r < kMmaRows; ++r) {
        if (r < R) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * K + ch * 4);
          acc[r] = fmaf(xv.x, wv.x, acc[r]);
          acc[r] = fmaf(xv.y, wv.y, acc[r]);
          acc[r] = fmaf(xv.z, wv.z, acc[r]);
          acc[r] = fmaf(xv.w, wv.w, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMmaRows; ++r) {
      const float sum = port::warp_sum(acc[r]);
      if (lane == r && r < R && m0 + r < M) store_out(grp, i, (m0 + r) * grp.n[i] + n, sum);
    }
  }
}

// Allow `smem` bytes of dynamic shared memory for `kernel` (once per size).
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int smem, int& configured) {
  if (smem <= 48 * 1024 || smem <= configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) configured = smem;
  return err;
}

int mma_slices(int K) { return (K + kSliceK - 1) / kSliceK; }

// The decode form's shared memory before the partials, for x of x_bytes,
// a scale of s_bytes (0: no norm) and x's rows staged SQ slices at a time:
// 8 bf16 rows 16 bytes past a multiple of 128 bytes apart, then the scale
// where x is bf16 (fp32 x is normalised from global memory).
Plan mma_layout(int K, int x_bytes, int s_bytes, int SQ) {
  Plan pl{};
  pl.S = mma_slices(K);
  pl.SQ = SQ;
  pl.Q = (pl.S + SQ - 1) / SQ;
  const int kx = K < SQ * kSliceK ? K : SQ * kSliceK;
  pl.pitch = (2 * kx + 127) / 128 * 128 + 16;
  pl.scale_off = kMmaRows * pl.pitch;
  pl.part_off = pl.scale_off + (x_bytes == 2 ? (K * s_bytes + 15) / 16 * 16 : 0);
  return pl;
}

constexpr int kPieceRing = kWarps * kPieceBytes;   // one piece a warp
constexpr int kPhaseSlices = 16;                   // x's rows in phases: 4,096 elements

// The decode form's layout for K: x's rows whole where they fit beside the
// scale, one tile's partials and two pieces a warp; else, without a norm,
// x's rows in phases of kPhaseSlices slices, and behind a norm (whose
// statistics need the whole row) with one piece a warp.  Returns the
// pieces a warp has at least, 0 where nothing fits.
int fit_layout(int K, int x_bytes, int s_bytes, Plan& pl) {
  const long long item = 4LL * mma_slices(K) * kItemFloats;
  auto fits = [&](int pieces) {
    return pl.part_off + item + static_cast<long long>(pieces) * kPieceRing <= kSmemMax;
  };
  pl = mma_layout(K, x_bytes, s_bytes, mma_slices(K));
  if (fits(2)) return 2;
  if (s_bytes > 0) return fits(1) ? 1 : 0;
  pl = mma_layout(K, x_bytes, 0, kPhaseSlices);
  return fits(2) ? 2 : 0;
}

// clusters of C blocks of fixed_mma_kernel<TX> the card holds at once
template <typename TX>
int clusters_of(int C) {
  static int cached[kMaxCluster + 1] = {};
  if (cached[C] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C * (num_sms() / C));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemMax;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, fixed_mma_kernel<TX>, &cfg) != cudaSuccess || n < 1) {
      cudaGetLastError();
      n = num_sms() / C;
    }
    cached[C] = n;
  }
  return cached[C];
}

// The decode form's plan for K, `tiles` tiles of 16 weight rows and the
// norm's scale of s_bytes (0: no norm); 0, or a cudaError_t where no layout
// fits.  Behind a norm, fp32 x takes clusters of 4 or 8 blocks, which share
// its rows' work.  Where a cluster's tiles' partials do not fit at once, it
// takes them in waves, and a second cluster barrier ends each wave.
template <typename TX>
int make_plan(int K, int tiles, int s_bytes, Plan& pl) {
  const int least = fit_layout(K, sizeof(TX), s_bytes, pl);
  const bool shared_norm = sizeof(TX) == 4 && s_bytes > 0;
  if (least == 0 || (shared_norm && K > kNormChunks * 4 * kThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int configured = 0;
  const cudaError_t err = allow_smem(fixed_mma_kernel<TX>, kSmemMax, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the cluster size whose busiest block takes the fewest items
  long long best = -1;
  for (int C = shared_norm ? 4 : 1; C <= kMaxCluster; C *= 2) {
    const int G = clusters_of<TX>(C) < tiles ? clusters_of<TX>(C) : tiles;
    const long long per = (static_cast<long long>((tiles + G - 1) / G) * pl.S + C - 1) / C;
    if (best < 0 || per < best) {
      best = per;
      pl.C = C;
      pl.G = G;
    }
  }
  const int item = pl.S * kItemFloats * 4;
  const int room = kSmemMax - pl.part_off - least * kPieceRing;
  const int nt = (tiles + pl.G - 1) / pl.G;
  const int own = (nt + pl.C - 1) / pl.C;
  pl.wave = (own < room / item ? own : room / item) * pl.C;
  pl.ring_off = pl.part_off + pl.wave / pl.C * item;
  pl.pieces = (kSmemMax - pl.ring_off) / kPieceRing;
  if (pl.pieces > kMaxPieces) pl.pieces = kMaxPieces;
  pl.smem = pl.ring_off + pl.pieces * kPieceRing;
  return 0;
}

template <typename TX>
int launch_mma(const Group& grp, const Prologue& pro, const void* x, long long ldx, int M,
               int K, cudaStream_t stream) {
  Plan pl;
  const int err = make_plan<TX>(K, grp.tile0[grp.count],
                                pro.norm ? (pro.scale_bf16 ? 2 : 4) : 0, pl);
  if (err) return err;
  const long long mtiles = (M + kMmaRows - 1) / kMmaRows;
  if (mtiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pl.C * pl.G), static_cast<unsigned>(mtiles));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, fixed_mma_kernel<TX>, grp, pro,
                                             static_cast<const TX*>(x), ldx, M, K, pl));
}

// The tiled form: the group's tiles of kBN rows, a TMA map each and x's.
int launch_tiled(const void* const* ws, void* const* outs, const int* ns, const int* out_bf16,
                 int count, const void* x, long long ldx, int M, int K, cudaStream_t stream) {
  TiledGroup tg{};
  tg.count = count;
  long long ntiles = 0;
  for (int i = 0; i < count; ++i) {
    if (!port::make_map(&tg.map[i], ws[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ns[i], K, kBN,
                        kBK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tg.out[i] = outs[i];
    tg.n[i] = ns[i];
    tg.out_bf16[i] = out_bf16[i];
    tg.tile0[i] = static_cast<int>(ntiles);
    ntiles += (ns[i] + kBN - 1) / kBN;
  }
  for (int i = count; i <= kMaxW; ++i) tg.tile0[i] = static_cast<int>(ntiles);
  CUtensorMap map_x;
  if (!port::make_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kBM, kBK,
                      CU_TENSOR_MAP_SWIZZLE_128B, ldx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (M + kBM - 1) / kBM * ntiles;
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  static int configured = 0;
  const cudaError_t err = allow_smem(fixed_wgmma_kernel, kWgmmaSmem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  // stream the larger operand once: the blocks in flight share its tile
  long long w_elems = 0;
  for (int i = 0; i < count; ++i) w_elems += static_cast<long long>(ns[i]) * K;
  const int n_fastest = static_cast<long long>(M) * K > w_elems ? 1 : 0;
  const int blocks = static_cast<int>(tiles < num_sms() ? tiles : num_sms());
  fixed_wgmma_kernel<<<blocks, kWgThreads, kWgmmaSmem, stream>>>(tg, map_x, M, K, n_fastest);
  return static_cast<int>(cudaGetLastError());
}

// rows an fp32 M-tile holds: the most of 8, 4, 2, 1 whose rows (and raw
// rows, with the norm) fit, fixed by K (never by M, so a row's work does not
// depend on the batch)
int fma_rows(int K, int norm) {
  const long long row = static_cast<long long>(K) * 4 * (norm ? 2 : 1);
  for (int R = 8; R >= 1; R /= 2) {
    if (R * row <= kSmemMax) return R;
  }
  return 0;
}

int launch_fma(const Group& grp, const Prologue& pro, const void* x, long long ldx, int M,
               int K, cudaStream_t stream) {
  const int R = fma_rows(K, pro.norm);
  if (R == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = R * K * 4 * (pro.norm ? 2 : 1);
  static int configured = 0;
  const cudaError_t err = allow_smem(fixed_fma_kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mtiles = (M + R - 1) / R;
  if (mtiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long cols = static_cast<long long>(grp.tile0[grp.count]) * 16;
  long long blocks = (cols + kWarps - 1) / kWarps;
  if (blocks > 4LL * num_sms()) blocks = 4LL * num_sms();
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(mtiles));
  fixed_fma_kernel<<<grid, kThreads, smem, stream>>>(grp, pro, static_cast<const float*>(x),
                                                      ldx, M, K, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest K a launch of the decode form (or the SIMT route) takes, for
// the weights' dtype (0 fp32, 1 bf16), x's dtype (the same codes) and the
// norm (its scale taken as fp32): fit_layout's, and with the norm a thread
// holds at most kNormChunks chunks (the decode form's fp32 x) or kNormPer
// elements (the SIMT route) of a row.
extern "C" int fixed_linear_max_k(int dtype, int x_dtype, int norm) {
  int lo = 8, hi = 1 << 20;
  const int x_bytes = x_dtype == 0 ? 4 : 2;
  while (lo < hi) {
    const int K = (lo + hi + 8) / 16 * 8;
    bool fits;
    if (dtype == 1) {
      Plan pl;
      fits = fit_layout(K, x_bytes, norm ? 4 : 0, pl) > 0 &&
             !(norm && x_bytes == 4 && K > kNormChunks * 4 * kThreads);
    } else {
      fits = fma_rows(K, norm) > 0 && !(norm && K > kThreads * kNormPer);
    }
    if (fits) {
      lo = K;
    } else {
      hi = K - 8;
    }
  }
  return lo;
}

// The decode form's plan for bf16 weights with `tiles` tiles of 16 rows, x
// of x_dtype (0 fp32, 1 bf16), and a norm whose scale is bf16 (scale = 1),
// fp32 (2) or absent (0): out = {blocks a cluster, clusters, tiles a
// cluster takes a wave, phases of x's rows, pieces a warp keeps in flight}.
// Returns 0 or a cudaError_t.
extern "C" int fixed_linear_plan(int x_dtype, int scale, int K, int tiles, int* out) {
  Plan pl;
  const int s_bytes = scale == 1 ? 2 : (scale == 2 ? 4 : 0);
  const int err = x_dtype == 0 ? make_plan<float>(K, tiles, s_bytes, pl)
                               : make_plan<bf16>(K, tiles, s_bytes, pl);
  if (err) return err;
  out[0] = pl.C;
  out[1] = pl.G;
  out[2] = pl.wave;
  out[3] = pl.Q;
  out[4] = pl.pieces;
  return 0;
}

// The route a launch takes: 0 the SIMT route (fp32 weights), 1 the decode
// form on the tensor cores, 2 the tiled form (bf16 x and weights, no norm,
// more than kDecodeRows rows).
extern "C" int fixed_linear_route(int dtype, int x_dtype, int norm, int M) {
  if (dtype == 0) return 0;
  return x_dtype == 1 && !norm && M > kDecodeRows ? 2 : 1;
}

// dtype: the weights', 0 = fp32 (the SIMT route), 1 = bf16 (the tensor
// cores); x_dtype: x's, the weights' or (with the norm, on the tensor cores)
// fp32.  x (M, K) with row stride ldx (elements, 16-byte aligned rows);
// ws[i] (ns[i], K) contiguous; outs[i] (M, ns[i]) contiguous, bf16 where
// out_bf16[i], else fp32; count 1..5.  norm: the product reads rmsnorm(x)
// rounded to the weights' dtype, with scale (K,) (fp32 or bf16 by
// scale_bf16, 16-byte aligned), eps, plus_one.  Returns a cudaError_t as int
// (0 = launched).
extern "C" int fixed_linear_launch(int dtype, int x_dtype, const void* x, long long ldx, int M,
                                   int K, const void* const* ws, void* const* outs,
                                   const int* ns, const int* out_bf16, int count, int norm,
                                   const void* scale, int scale_bf16, int plus_one, float eps,
                                   void* stream) {
  if (M <= 0 || K <= 0 || K % 8 || count < 1 || count > kMaxW || (dtype != 0 && dtype != 1) ||
      (x_dtype != 0 && x_dtype != 1) || (x_dtype != dtype && !(norm && dtype == 1)) ||
      (norm && scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < count; ++i) {
    if (ns[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed_linear_route(dtype, x_dtype, norm, M) == 2) {
    return launch_tiled(ws, outs, ns, out_bf16, count, x, ldx, M, K, s);
  }
  if (K > fixed_linear_max_k(dtype, x_dtype, norm)) return static_cast<int>(cudaErrorInvalidValue);
  Group grp{};
  grp.count = count;
  long long tiles = 0;
  for (int i = 0; i < count; ++i) {
    grp.w[i] = ws[i];
    grp.out[i] = outs[i];
    grp.n[i] = ns[i];
    grp.out_bf16[i] = out_bf16[i];
    grp.tile0[i] = static_cast<int>(tiles);
    tiles += (ns[i] + 15) / 16;
  }
  if (tiles > (1LL << 26)) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = count; i <= kMaxW; ++i) grp.tile0[i] = static_cast<int>(tiles);
  const Prologue pro{norm ? 1 : 0, scale, scale_bf16, plus_one, eps};
  if (dtype == 0) return launch_fma(grp, pro, x, ldx, M, K, s);
  return x_dtype == 0 ? launch_mma<float>(grp, pro, x, ldx, M, K, s)
                      : launch_mma<bf16>(grp, pro, x, ldx, M, K, s);
}
