// Nearest-centroid assignment for Hopper (sm_90a):
//   out[p, i] = argmin_c ( ||c||^2 - 2 * x_i . c ),  ties to the lowest index.
//
// Replaces the Pallas TPU kernel kmeans_assign_pallas of
// src/repro/kernels/kmeans_assign.py (pallas_call at :75, _assign_kernel at :37).
//
// The order, which every form and route below computes bit for bit, so that
// a row's pick is the same at any n and P, at any place in the batch, in
// either form, on either route and at any row stride:
//   * d is cut into slices of kSlice = 512 elements (a constant of this
//     source: never chosen from n, P or the card);
//   * x . c over a slice is one fmaf chain from zero in natural depth order
//     (bf16 x enters as its exact fp32 value; depths past d add 0 * 0, which
//     leaves a chain as it is);
//   * the slices' chains are added in slice order by IEEE adds onto a sum
//     that starts at 0;
//   * the score is cn[c] - 2 * sum (cn = ||c||^2, computed by the wrapper),
//     and the pick is the first lowest score (strict <, ties to the lowest
//     index).
// At d <= 512 this is one chain, the order of the kernel this one replaced.
//
// What bounds it on this card.  At the fit's shape X (8, 131072, 4096) fp32,
// k = 50, the kernel does 2k = 100 fp32 operations for every 4-byte element
// of X: 4.3e11 operations, 6.41 ms at the 67 TFLOP/s of the fp32 FMA pipe,
// against 5.13 ms to read X's 17.2 GB once at 3.35 TB/s.  The two are close,
// so HBM has to stream and the FMA pipe has to stay busy at the same time.
// At a serving microbatch (1, 2048, 4096) the bound is 0.0125 ms of
// operations; what holds a kernel there is occupancy (2,048 rows are 16
// tiles of 128 rows: 16 of the 132 SMs).
//
// What the design does about it:
//   * the stream form (rows enough for a tile on every SM): a persistent
//     grid of two blocks an SM, each of 4 consumer warps and 1 producer warp.
//     The producer streams X through a ring of 3-4 shared-memory stages of
//     128 rows x 128 bytes (TMA, 128-byte swizzle, a full and an empty
//     mbarrier a stage), and C's matching 128 bytes of the column tile from
//     L2 the same way: no block barrier, no staging through registers.
//     Lane l of every warp holds rows l + 32 i (i < 4); warp w holds columns
//     [w TN, (w + 1) TN).  A step of 4 depths reads 4 words of X (32 rows, 4
//     conflict-free wavefronts each) and TN words of C that all 32 lanes share
//     (one wavefront each), for 16 TN FMAs: shared-memory wavefronts, which
//     a layout of 4 x 8 lanes (each of them reading its own words) made the
//     limit, stay below the FMA issue slots.  The running slice's chains stay
//     in registers, the slices' sum in shared memory (no spill);
//   * the column tile is fitted to k: 4 warps of TN = 4, 8, 13 or 16 columns,
//     so k = 50 runs 52 columns (2 padding) and X is read once at k <= 64; a
//     wider k runs its tiles in turn over X again;
//   * the split form (too few rows to fill the card, as a serving
//     microbatch): d's slices are split over the blocks of a thread-block
//     cluster (up to 8), block r taking slices r, r + G, ...; each block
//     pushes its slice's chains, a row to the block that owns it (row % G),
//     through distributed shared memory; each owner adds the cluster's
//     slices in slice order onto its rows' sums, then takes their argmin.
//     Its blocks hold 64 rows (2 a lane) and three fit an SM, so (1, 2048,
//     4096) is 32 clusters of 8 blocks, all resident at once;
//   * a general route for rows TMA cannot take (a row stride that is not a
//     multiple of 16 bytes, an unaligned base): the producer warp fills the
//     same swizzled stages with 4-byte cp.async copies (fp32; zeros past the
//     edges by a source size of 0, completion counted on the stage's
//     mbarrier), or with 2-byte loads and stores (bf16 rows at odd element
//     offsets, which no cp.async takes); the consumers are the same code;
//   * no tensor cores: the port's rule keeps fp32 operands on IEEE fp32 FMA
//     (no TF32), and splitting both operands into three bf16 terms costs 9
//     products for each one: ~3.9 ms at the dense bf16 peak, ~6 ms at a
//     realistic 65 % of it, no better than the FMA bound, and the 5.13 ms of
//     bytes bound either design; a tensor-core sum is also not one fmaf chain.
//
// X is (P, n, d) with element strides (sxp, sxn, 1), fp32 or bf16; C is
// (k, ldc) fp32, 16-byte aligned, ldc a multiple of 4, zeros in [d, ldc);
// cn (k,) fp32; out (P, n) int32.  The C launcher picks the form and the
// route, takes PyTorch's current stream, allocates nothing and returns a
// cudaError_t as int; info[0..2] get the form (0 stream, 1 split), the route
// (1 TMA, 0 general) and the cluster's blocks.

#include "common.cuh"

#include <climits>
#include <cmath>

namespace {

using port::cluster_blocks;
using port::cluster_map;
using port::cluster_rank;
using port::cluster_sync;
using port::encode_tiled;
using port::mbar_arrive;
using port::mbar_expect;
using port::mbar_init;
using port::mbar_wait;
using port::num_sms;
using port::smem_addr;
using port::st_cluster;
using port::tma_load;

constexpr int kSlice = 512;                  // elements of d a chain runs over
constexpr int kWarps = 4;                    // consumer warps a block
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kMaxBK = 64;                   // the widest column tile
constexpr int kStageBytes = 128;             // bytes of a row a ring stage holds
constexpr int kMaxCluster = 8;
constexpr int kMaxRing = 4, kMinRing = 3;
constexpr int kStreamSmem = 113 * 1024;      // two stream blocks an SM
constexpr int kSplitSmem = 75 * 1024;        // three split blocks an SM
constexpr int kMaxSmem = 227 * 1024;
constexpr int kStreamTM = 4, kSplitTM = 2;   // rows a consumer thread holds, 32 apart

struct Args {
  CUtensorMap xmap;      // X as (d, n, P), boxes of one stage (the TMA route)
  CUtensorMap cmap;      // C as (ldc, k), boxes of 32 x TN (a warp's columns)
  const void* x;         // X (the general route)
  long long sxp, sxn;
  const float* cn;
  int* out;
  long long items;       // (partition, row tile) pairs
  int rtiles;            // row tiles a partition
  int n, d, k;
  int ctiles;            // column tiles
  int dstages;           // stages along d
  int ring;              // stages in the ring
  int tma;               // X by TMA (1) or by the general route (0)
};

template <typename T>
__host__ __device__ constexpr int stage_depth() { return kStageBytes / static_cast<int>(sizeof(T)); }

// C's boxes of 32 fp32 a stage holds
template <typename T>
__host__ __device__ constexpr int c_boxes() { return stage_depth<T>() / 32; }

// A warp's TN columns sit at rows [w R, w R + TN) of a C box, R a multiple
// of 8, so that column j's swizzle is j % 8 whatever the warp.
__host__ __device__ constexpr int c_rows(int tn) { return (tn + 7) / 8 * 8; }

// bytes of one C box, and of a ring stage (BR rows of X, the C boxes)
template <int TN>
__host__ __device__ constexpr int c_box_bytes() { return kWarps * c_rows(TN) * kStageBytes; }

template <typename T, int BR, int TN>
__host__ __device__ constexpr int stage_bytes() {
  return BR * kStageBytes + c_boxes<T>() * c_box_bytes<TN>();
}

// byte b of row r of a stage of 128-byte rows in the 128-byte swizzle (the
// stage 1024-byte aligned): 16-byte chunk b / 16 lands on chunk (b / 16) ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int b) {
  return static_cast<uint32_t>(r * kStageBytes + ((((b >> 4) ^ r) & 7) << 4) + (b & 15));
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// 4 bytes from src to dst, or 4 zero bytes where !valid (nothing is read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// arrive on bar once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"(v) : "memory");
}

// the 128 consumer threads' barrier (the producer warp does not take it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// The shared memory a block uses: the ring's X stages, its C stages, the
// full and empty barriers; then the form's own (from `tail`).
template <typename T, int BR, int TN>
struct Ring {
  static constexpr int kCStage = c_boxes<T>() * c_box_bytes<TN>();   // bytes of a C stage
  uint8_t* xs;
  uint8_t* cs;
  uint32_t bars;
  uint8_t* tail;

  __device__ __forceinline__ Ring(uint8_t* raw, int ring) {
    xs = raw + ((smem_addr(raw) + 1023) & ~1023u) - smem_addr(raw);
    cs = xs + ring * BR * kStageBytes;
    bars = smem_addr(cs + ring * kCStage);
    tail = cs + ring * kCStage + 16 * ring;
  }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s, int ring) const { return bars + 8 * (ring + s); }
};

// A stage's position in the ring, the same sequence for the producer and the
// consumers.
struct Cursor {
  int slot = 0;
  uint32_t phase = 0;
  int filled = 0;   // stages issued so far, capped at the ring's size
  __device__ __forceinline__ void next(int ring) {
    if (++slot == ring) {
      slot = 0;
      phase ^= 1u;
    }
    if (filled < ring) ++filled;
  }
};

// The producer's stage: X's rows [r0, r0 + BR) x depths [s DS, (s + 1) DS) of
// partition p, and C's tile of columns [c0, c0 + 4 TN) at the same depths,
// warp w's TN columns at rows w R of each C box.
template <typename T, int BR, int TN>
__device__ __forceinline__ void produce(const Args& a, const Ring<T, BR, TN>& rg, Cursor& cur,
                                        int lane, int p, int r0, int c0, int s) {
  constexpr int DS = stage_depth<T>();
  const int slot = cur.slot;
  // a stage is free once the consumers of its last round have arrived
  if (cur.filled == a.ring) mbar_wait(rg.empty(slot, a.ring), cur.phase ^ 1u);
  const uint32_t full = rg.full(slot);
  const uint32_t xdst = smem_addr(rg.xs) + slot * BR * kStageBytes;
  if (lane == 0) {
    const uint32_t cdst = smem_addr(rg.cs) + slot * rg.kCStage;
    mbar_expect(full, (a.tma ? BR * kStageBytes : 0) + c_boxes<T>() * kWarps * TN * kStageBytes);
    if (a.tma) tma_load_3d(xdst, &a.xmap, s * DS, r0, p, full);
#pragma unroll
    for (int b = 0; b < c_boxes<T>(); ++b) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        tma_load(cdst + b * c_box_bytes<TN>() + w * c_rows(TN) * kStageBytes, &a.cmap,
                 s * DS + 32 * b, c0 + w * TN, full);
      }
    }
  }
  if (!a.tma) {
    const T* xp = static_cast<const T*>(a.x) + p * a.sxp;
    if constexpr (sizeof(T) == 4) {
#pragma unroll 8
      for (int e = lane; e < BR * DS; e += 32) {
        const int r = e / DS, c = e % DS;
        const int gr = r0 + r, gc = s * DS + c;
        const bool ok = gr < a.n && gc < a.d;
        cp_async4(xdst + swz(r, c * 4), ok ? xp + gr * a.sxn + gc : xp, ok);
      }
      cp_async_arrive(full);
    } else {
      const unsigned short* xh = reinterpret_cast<const unsigned short*>(xp);
#pragma unroll 8
      for (int e = lane; e < BR * DS; e += 32) {
        const int r = e / DS, c = e % DS;
        const int gr = r0 + r, gc = s * DS + c;
        const unsigned short v = gr < a.n && gc < a.d ? __ldg(xh + gr * a.sxn + gc) : 0;
        st_shared_u16(xdst + swz(r, c * 2), v);
      }
      mbar_arrive(full);
    }
  }
  cur.next(a.ring);
}

// The consumers' stage: acc[i][j] += x[row lane + 32 i] . c[column j of the
// warp] over the stage's depths, in depth order.  xrow is the stage's row
// `lane` (whose swizzle, sw = (lane % 8) << 4, is that of every row the
// thread reads), ccol the warp's first row of the first C box.  A warp's 32
// lanes read 32 rows of X (four conflict-free 128-byte wavefronts) and one
// word of C that every lane shares.
template <typename T, int TM, int TN>
__device__ __forceinline__ void multiply(const uint8_t* xrow, const uint8_t* ccol, int sw,
                                         float (&acc)[TM][TN]) {
  constexpr int SZ = sizeof(T);
  constexpr int kQuads = kStageBytes / (4 * SZ);   // steps of 4 depths
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int b = u * 4 * SZ;
    const uint8_t* px = xrow + (((b & 0x70) ^ sw) | (b & 15));
    float xv[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if constexpr (SZ == 4) {
        const float4 v = *reinterpret_cast<const float4*>(px + 32 * i * kStageBytes);
        xv[i][0] = v.x;
        xv[i][1] = v.y;
        xv[i][2] = v.z;
        xv[i][3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(px + 32 * i * kStageBytes);
        xv[i][0] = __uint_as_float(v.x << 16);
        xv[i][1] = __uint_as_float(v.x & 0xFFFF0000u);
        xv[i][2] = __uint_as_float(v.y << 16);
        xv[i][3] = __uint_as_float(v.y & 0xFFFF0000u);
      }
    }
    const uint8_t* pc = ccol + (u >> 3) * c_box_bytes<TN>();
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 c = *reinterpret_cast<const float4*>(
          pc + j * kStageBytes + (((u & 7) ^ (j & 7)) << 4));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][j] = fmaf(xv[i][0], c.x, acc[i][j]);
        acc[i][j] = fmaf(xv[i][1], c.y, acc[i][j]);
        acc[i][j] = fmaf(xv[i][2], c.z, acc[i][j]);
        acc[i][j] = fmaf(xv[i][3], c.w, acc[i][j]);
      }
    }
  }
}

// The consumers' side of a stage: wait for it, multiply, free it.
template <typename T, int TM, int TN, int BR>
__device__ __forceinline__ void consume(const Args& a, const Ring<T, BR, TN>& rg, Cursor& cur,
                                        int warp, int lane, float (&acc)[TM][TN]) {
  const int slot = cur.slot;
  mbar_wait(rg.full(slot), cur.phase);
  multiply<T, TM, TN>(rg.xs + slot * BR * kStageBytes + lane * kStageBytes,
                      rg.cs + slot * rg.kCStage + warp * c_rows(TN) * kStageBytes,
                      (lane & 7) << 4, acc);
  // every lane's reads of the stage are done before its refill (an async
  // proxy write) is asked for
  __syncwarp();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (lane == 0) mbar_arrive(rg.empty(slot, a.ring));
  cur.next(a.ring);
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&v)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = 0.f;
}

// the cluster barrier, its .aligned form taken by a converged warp
__device__ __forceinline__ void cluster_sync_warp() {
  __syncwarp();
  cluster_sync();
}

__device__ __forceinline__ void init_barriers(uint32_t bars, const Args& a) {
  for (int s = 0; s < a.ring; ++s) {
    // the TMA route: the producer's expect_tx arrive; the general route adds
    // the producer's 32 lanes' arrivals
    mbar_init(bars + 8 * s, a.tma ? 1 : 33);
    mbar_init(bars + 8 * (a.ring + s), kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ------------------------------------------------------------------------- //
// The stream form.  Grid: persistent, blocks walking the (partition, row
// tile) items in turn; rows of a tile BR = 128, thread `lane` of each warp
// holding rows lane + 32 i (i < 4); columns of a tile BK = 4 TN, warp w
// holding [w TN, (w + 1) TN).  The running slice's chains stay in
// registers, the sum of the slices before it in shared memory.  Shared
// memory (from a 1024-byte boundary): the ring, its barriers, the sums
// ([TM TN / 4][128] float4, a thread's at its own index, so that no two
// lanes meet in a bank), each warp's (min, index) of every row, [4][BR] x 2.
// ------------------------------------------------------------------------- //
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 2) assign_stream(const __grid_constant__ Args a) {
  constexpr int TM = kStreamTM, BR = 32 * TM, BK = kWarps * TN;
  constexpr int kSliceStages = kSlice / stage_depth<T>();
  constexpr int kVecs = TM * TN / 4;
  extern __shared__ uint8_t smem_raw[];
  const Ring<T, BR, TN> rg(smem_raw, a.ring);
  float4* sums = reinterpret_cast<float4*>(rg.tail);                  // [kVecs][128]
  float* red = reinterpret_cast<float*>(sums + kVecs * kConsumers);   // [4][BR]
  int* red_idx = reinterpret_cast<int*>(red + kWarps * BR);           // [4][BR]
  if (threadIdx.x == 0) init_barriers(rg.bars, a);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Cursor cur;

  if (warp == kWarps) {
    if (a.tma && lane != 0) return;
    for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
      const int p = static_cast<int>(item / a.rtiles);
      const int r0 = static_cast<int>(item % a.rtiles) * BR;
      for (int ct = 0; ct < a.ctiles; ++ct) {
        for (int s = 0; s < a.dstages; ++s) {
          produce<T, BR, TN>(a, rg, cur, lane, p, r0, ct * BK, s);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;   // the row this thread picks for
  float4* mine = sums + tid;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int p = static_cast<int>(item / a.rtiles);
    const int r0 = static_cast<int>(item % a.rtiles) * BR;
    float best = INFINITY;
    int best_idx = 0;
    for (int ct = 0; ct < a.ctiles; ++ct) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) mine[v * kConsumers] = make_float4(0.f, 0.f, 0.f, 0.f);
      float acc[TM][TN];
      zero(acc);
      for (int s = 0; s < a.dstages; ++s) {
        consume<T, TM, TN, BR>(a, rg, cur, warp, lane, acc);
        if ((s + 1) % kSliceStages == 0 || s + 1 == a.dstages) {   // a slice ends
#pragma unroll
          for (int v = 0; v < kVecs; ++v) {
            float4 t = mine[v * kConsumers];
            t.x = __fadd_rn(t.x, acc[(4 * v) / TN][(4 * v) % TN]);
            t.y = __fadd_rn(t.y, acc[(4 * v + 1) / TN][(4 * v + 1) % TN]);
            t.z = __fadd_rn(t.z, acc[(4 * v + 2) / TN][(4 * v + 2) % TN]);
            t.w = __fadd_rn(t.w, acc[(4 * v + 3) / TN][(4 * v + 3) % TN]);
            mine[v * kConsumers] = t;
          }
          zero(acc);
        }
      }
      // the sums back in registers (acc)
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const float4 t = mine[v * kConsumers];
        acc[(4 * v) / TN][(4 * v) % TN] = t.x;
        acc[(4 * v + 1) / TN][(4 * v + 1) % TN] = t.y;
        acc[(4 * v + 2) / TN][(4 * v + 2) % TN] = t.z;
        acc[(4 * v + 3) / TN][(4 * v + 3) % TN] = t.w;
      }
      // scores; (min, first index) over the warp's columns; then over the
      // four warps in order, and against the tile before (strictly lower:
      // their columns come later)
      const long long cw = static_cast<long long>(ct) * BK + warp * TN;
      float cnv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) cnv[j] = cw + j < a.k ? a.cn[cw + j] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float v = INFINITY;
        int vi = INT_MAX;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (cw + j < a.k) {
            const float sc = cnv[j] - 2.f * acc[i][j];
            if (sc < v) {
              v = sc;
              vi = static_cast<int>(cw + j);
            }
          }
        }
        red[warp * BR + lane + 32 * i] = v;
        red_idx[warp * BR + lane + 32 * i] = vi;
      }
      consumers_sync();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (red[w * BR + tid] < best) {
          best = red[w * BR + tid];
          best_idx = red_idx[w * BR + tid];
        }
      }
      consumers_sync();
    }
    if (r0 + tid < a.n) a.out[static_cast<long long>(p) * a.n + r0 + tid] = best_idx;
  }
}

// ------------------------------------------------------------------------- //
// The split form.  Grid: (partition, row tile) items x G blocks, in clusters
// of G along x; rows of a tile BR = 64 (lane + 32 i, i < 2), columns as in
// the stream form.  In round q, block r takes slice q G + r (if there is
// one) and pushes its chains, row by row, to the row's owner (block row %
// G) at slots[r][row / G]; after a cluster barrier each owner adds the slots
// in slice order onto its rows' sums, and after a second the slots are free.
// Shared memory (from a 1024-byte boundary): the ring, its barriers, the
// slots [G][rpo][BK], the owned rows' sums [rpo][BK] and (min, index) [rpo].
// ------------------------------------------------------------------------- //
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 2) assign_split(const __grid_constant__ Args a) {
  constexpr int TM = kSplitTM, BR = 32 * TM, BK = kWarps * TN;
  constexpr int kSliceStages = kSlice / stage_depth<T>();
  extern __shared__ uint8_t smem_raw[];
  const Ring<T, BR, TN> rg(smem_raw, a.ring);
  const int G = static_cast<int>(cluster_blocks());
  const int rank = static_cast<int>(cluster_rank());
  const int rpo = (BR + G - 1) / G;                       // rows a block owns
  float* slots = reinterpret_cast<float*>(rg.tail);       // [G][rpo][BK]
  float* sums = slots + G * rpo * BK;                     // [rpo][BK]
  float* best = sums + rpo * BK;                          // [rpo]
  int* best_idx = reinterpret_cast<int*>(best + rpo);     // [rpo]
  if (threadIdx.x == 0) init_barriers(rg.bars, a);
  __syncthreads();
  cluster_sync();   // every block has started before any pushes to it

  const long long item = blockIdx.x / G;
  const int p = static_cast<int>(item / a.rtiles);
  const int r0 = static_cast<int>(item % a.rtiles) * BR;
  const int slices = (a.dstages + kSliceStages - 1) / kSliceStages;
  const int rounds = (slices + G - 1) / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Cursor cur;

  if (warp == kWarps) {
    for (int ct = 0; ct < a.ctiles; ++ct) {
      for (int q = 0; q < rounds; ++q) {
        const int sl = q * G + rank;
        if (sl < slices && (!a.tma || lane == 0)) {
          const int end = min((sl + 1) * kSliceStages, a.dstages);
          for (int s = sl * kSliceStages; s < end; ++s) {
            produce<T, BR, TN>(a, rg, cur, lane, p, r0, ct * BK, s);
          }
        }
        cluster_sync_warp();
        cluster_sync_warp();
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const uint32_t slots_at = smem_addr(slots);
  if (tid < rpo) {
    best[tid] = INFINITY;
    best_idx[tid] = 0;
  }
  for (int ct = 0; ct < a.ctiles; ++ct) {
    for (int q = 0; q < rounds; ++q) {
      const int sl = q * G + rank;
      if (sl < slices) {
        float acc[TM][TN];
        zero(acc);
        const int end = min((sl + 1) * kSliceStages, a.dstages);
        for (int s = sl * kSliceStages; s < end; ++s) {
          consume<T, TM, TN, BR>(a, rg, cur, warp, lane, acc);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = lane + 32 * i;
          const uint32_t to = cluster_map(
              slots_at + 4 * ((rank * rpo + row / G) * BK + warp * TN), row % G);
#pragma unroll
          for (int j = 0; j < TN; ++j) st_cluster(to + 4 * j, __float_as_uint(acc[i][j]));
        }
      }
      cluster_sync_warp();   // the round's chains are in their owners' slots
      for (int e = tid; e < rpo * BK; e += kConsumers) {
        float t = q == 0 ? 0.f : sums[e];
        for (int r = 0; r < G && q * G + r < slices; ++r) {
          t = __fadd_rn(t, slots[r * rpo * BK + e]);
        }
        sums[e] = t;
      }
      cluster_sync_warp();   // the slots are free; the sums are whole
    }
    // the owned rows' scores and (min, first index), a warp a row, its lanes
    // over the columns; then against the tile before
    for (int lrow = warp; lrow < rpo && lrow * G + rank < BR; lrow += kWarps) {
      float v = INFINITY;
      int vi = INT_MAX;
      for (int col = lane; col < BK; col += 32) {
        const long long c = static_cast<long long>(ct) * BK + col;
        if (c < a.k) {
          const float sc = a.cn[c] - 2.f * sums[lrow * BK + col];
          if (sc < v) {
            v = sc;
            vi = static_cast<int>(c);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xFFFFFFFFu, v, o);
        const int oi = __shfl_xor_sync(0xFFFFFFFFu, vi, o);
        if (ov < v || (ov == v && oi < vi)) {
          v = ov;
          vi = oi;
        }
      }
      if (lane == 0 && v < best[lrow]) {
        best[lrow] = v;
        best_idx[lrow] = vi;
      }
    }
    consumers_sync();   // the owned rows' picks are in before they are read
  }
  if (tid < rpo) {
    const int gr = r0 + tid * G + rank;
    if (tid * G + rank < BR && gr < a.n) {
      a.out[static_cast<long long>(p) * a.n + gr] = best_idx[tid];
    }
  }
}

// ------------------------------------------------------------------------- //
// The launcher.
// ------------------------------------------------------------------------- //

// X as (d, n, P) of `elem`-byte elements with row and partition strides in
// bytes, boxes of one stage (box_d x box_rows x 1) in the 128-byte swizzle
bool make_x_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int d, int n,
                int P, long long row_bytes, long long part_bytes, int box_d, int box_rows) {
  const port::EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(P)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(part_bytes)};
  const cuuint32_t boxes[3] = {static_cast<cuuint32_t>(box_d), static_cast<cuuint32_t>(box_rows),
                               1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, boxes, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The form's launch at a column tile of 4 TN columns (TN a warp).
template <typename T, int TN>
int launch_tile(Args& a, int P, const float* C, long long ldc, int G, int* info,
                cudaStream_t s) {
  constexpr int SZ = sizeof(T);
  constexpr int DS = stage_depth<T>();
  constexpr int BK = kWarps * TN;
  constexpr int kStreamBR = 32 * kStreamTM, kSplitBR = 32 * kSplitTM;
  const bool split = G > 1;
  const int BR = split ? kSplitBR : kStreamBR;
  a.rtiles = static_cast<int>((static_cast<long long>(a.n) + BR - 1) / BR);
  a.items = static_cast<long long>(P) * a.rtiles;
  a.ctiles = static_cast<int>((static_cast<long long>(a.k) + BK - 1) / BK);

  // the route: TMA where X's rows and partitions start on 16-byte
  // boundaries and do not overlap
  const long long part = P == 1 ? a.n * a.sxn : a.sxp;
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 && (a.sxn * SZ) % 16 == 0 &&
                       a.sxn >= a.d && (part * SZ) % 16 == 0 && part >= a.n * a.sxn &&
                       part * SZ < (1LL << 40);
  const CUtensorMapDataType xtype =
      SZ == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  a.tma = aligned &&
          make_x_map(&a.xmap, a.x, xtype, a.d, a.n, P, a.sxn * SZ, part * SZ, DS, BR) ? 1 : 0;
  if (!port::make_map(&a.cmap, C, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.k,
                      static_cast<int>(ldc), TN, 32, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  // shared memory: the ring (3-4 stages; two stream blocks or three split
  // blocks an SM where they fit, else fewer) and the form's own
  const int rpo = (kSplitBR + G - 1) / G;
  const int fixed = split ? 1024 + 4 * (G * rpo * BK + rpo * BK + 2 * rpo)
                          : 1024 + 4 * kStreamTM * TN * kConsumers + 8 * kWarps * kStreamBR;
  const int per_stage =
      (split ? stage_bytes<T, kSplitBR, TN>() : stage_bytes<T, kStreamBR, TN>()) + 16;
  a.ring = ((split ? kSplitSmem : kStreamSmem) - fixed) / per_stage;
  a.ring = a.ring > kMaxRing ? kMaxRing : (a.ring < kMinRing ? kMinRing : a.ring);
  const int smem = fixed + a.ring * per_stage;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);

  info[0] = split ? 1 : 0;
  info[1] = a.tma;
  info[2] = G;
  auto kernel = split ? assign_split<T, TN> : assign_stream<T, TN>;
  static bool configured[2] = {false, false};
  if (!configured[split]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[split] = true;
  }
  if (!split) {
    // persistent: as many blocks as are resident at once
    int resident = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = static_cast<long long>(resident < 1 ? 1 : resident) * num_sms();
    const int grid = static_cast<int>(a.items < cap ? a.items : cap);
    kernel<<<grid, kThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.items * G));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

template <typename T>
int launch(const void* X, long long sxp, long long sxn, const float* C, long long ldc,
           const float* cn, int* out, int P, int n, int d, int k, int* info, cudaStream_t s) {
  constexpr int kStreamBR = 32 * kStreamTM, kSplitBR = 32 * kSplitTM;
  Args a = {};
  a.x = X;
  a.sxp = sxp;
  a.sxn = sxn;
  a.cn = cn;
  a.out = out;
  a.n = n;
  a.d = d;
  a.k = k;
  a.dstages = (d + stage_depth<T>() - 1) / stage_depth<T>();
  const int slices = (d + kSlice - 1) / kSlice;

  // the form: the stream form where its tiles reach every SM, else d's
  // slices split over a cluster of blocks (as many as bring the grid to two
  // blocks an SM, at most 8 and at most the slices)
  const long long sms = num_sms();
  const long long stream_items = P * ((static_cast<long long>(n) + kStreamBR - 1) / kStreamBR);
  const long long split_items = P * ((static_cast<long long>(n) + kSplitBR - 1) / kSplitBR);
  int G = 1;
  if (stream_items < sms && slices >= 2) {
    const long long want = (2 * sms + split_items - 1) / split_items;
    G = static_cast<int>(want < kMaxCluster ? want : kMaxCluster);
    G = G < slices ? G : slices;
    G = G < 2 ? 2 : G;
  }

  // the column tile fitted to k: tiles of at most 64 columns, as even as
  // they come, 4 warps' columns each, rounded up to 16, 32, 52 or 64
  const long long tiles = (static_cast<long long>(k) + kMaxBK - 1) / kMaxBK;
  const long long per_warp = ((k + tiles - 1) / tiles + kWarps - 1) / kWarps;
  if (per_warp <= 4) return launch_tile<T, 4>(a, P, C, ldc, G, info, s);
  if (per_warp <= 8) return launch_tile<T, 8>(a, P, C, ldc, G, info, s);
  if (per_warp <= 13) return launch_tile<T, 13>(a, P, C, ldc, G, info, s);
  return launch_tile<T, 16>(a, P, C, ldc, G, info, s);
}

}  // namespace

// dtype: 0 = fp32 X, 1 = bf16 X.  Returns a cudaError_t as int (0 = launched).
extern "C" int kmeans_assign_launch(int dtype, const void* X, long long sxp, long long sxn,
                                    const void* C, long long ldc, const void* cn, void* out,
                                    int P, int n, int d, int k, int* info, void* stream) {
  if (P <= 0 || n <= 0 || d <= 0 || k <= 0 || ldc < d || ldc % 4 != 0 ||
      reinterpret_cast<uintptr_t>(C) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Cf = static_cast<const float*>(C);
  const float* cnf = static_cast<const float*>(cn);
  int* o = static_cast<int*>(out);
  if (dtype == 0) return launch<float>(X, sxp, sxn, Cf, ldc, cnf, o, P, n, d, k, info, s);
  if (dtype == 1) return launch<__nv_bfloat16>(X, sxp, sxn, Cf, ldc, cnf, o, P, n, d, k, info, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
