// Logistic-regression gradient, g = X^T (sigmoid(X w) - y), for Hopper (sm_90a):
// one kernel that reads X once (grad_kernel), and the two kernels of the
// first design, which the served path and the checks keep.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/logreg_grad.py:
//   logreg_margin  (pallas_call at :85, _margin_kernel at :40)  z = sigmoid(Xw) - y
//   logreg_xt_z    (pallas_call at :111, _xtz_kernel at :59)    g = X^T z
// and their chain logreg_grad_pallas (:128), which grad_kernel computes in
// one pass.
//
// What bounds them on this card: each reads X and does two floating-point
// operations per element it reads (four for grad_kernel), far below the
// card's operations-per-byte line, so all three are bound by the bytes of X
// read from device memory.  The reference reads X twice because a TPU core
// cannot hold a 640 KB row of the paper's 160,000 features; the two-kernel
// chain inherited that, and so read X twice as well.
//
// grad_kernel (one launch a step; its plan comes from the wrapper,
// kernels/logreg_grad.py's grad_plan, a function of (n, d) alone):
//   * A cluster of C blocks owns a chunk of Rc rows of one partition; block
//     `rank` owns columns [rank W, rank W + W) (the last slice may be
//     narrower).  Two forms: slices up to 4,096 wide (8 columns a thread,
//     stages of 4 rows, clusters of up to 8), else up to 10,240 (20 columns
//     a thread, stages of 1 row, clusters of up to 16, non-portable above
//     8), so that a block's slices of g and of w stay in registers at 512
//     threads.  d = 4,096 takes C = 1, d = 30,000 C = 8 (W = 3,750),
//     d = 160,000 C = 16 (W = 10,000).  cudaOccupancyMaxActiveClusters
//     (logreg_grad_clusters; the smoke prints it) puts 7 clusters of 16 on
//     an H100 at once (112 SMs) and 15 of 8; clusters of 8 at d = 160,000
//     would need 40 columns a thread in registers, or rows of 80 KB of
//     which the ring holds two, and read slower on the card (PERF.md).  A
//     partition is cut into 7 chunks in clusters of 16 (so every wave of 7
//     is full whatever P), 16 otherwise.  Wider than 163,840 columns the
//     wrapper takes the chain of the two other kernels.
//   * Rows stream through a ring of S stages of R rows in shared memory,
//     filled by one-dimensional bulk copies (the copy engine: one
//     instruction of one thread a row, where 16-byte cp.async copies took
//     five of every thread) completing on an mbarrier a stage.  A tensor
//     map cannot take the table's view (its row stride, (d + 1) * 4 bytes,
//     is no multiple of 16), so each row slice is copied from the 16-byte
//     granule that holds its first byte to the one that holds its last: the
//     copy reads up to 15 bytes on either side of the slice, in the granules
//     of the same allocation, and the slice lands `shift` elements into its
//     stage, so element c is read at [shift + c] whatever the alignment
//     (bf16 at odd offsets too).  A row's label comes the same way, its
//     granule beside the row.
//   * For each group every block forms its rows' partial margins over its
//     slice and stores them into every block of the cluster with st.async,
//     each store counted on the receiver's mbarrier (a cluster barrier,
//     whose release waits for the remote stores, stalled every group); warp
//     0 waits on its own mbarrier and adds the C partials, so every block
//     holds the same margin bits, forms z = sigmoid(m) - y and adds x * z
//     into its slice of g from the copy still on chip.  X is not read again.
//   * A chunk's g slice goes to scratch (partial, P * Q * d floats for Q
//     chunks a partition); the last block of a (partition, rank) to finish
//     (a ticket) adds the Q chunks in chunk order and writes g, and resets
//     its ticket, so a step is one launch with no fill beside it and may be
//     captured in a CUDA graph.  With Q = 1 the block writes g directly.
//   * Sum order, fixed by (n, d) alone: a thread owns columns t + 512 k of
//     its slice and chains x * w over k by fmaf from zero; a warp adds its
//     lanes by an xor butterfly, the block its 16 warps in warp order, the
//     margin its C slices by an xor butterfly over 32 / R lanes (zeros past
//     C); g chains x * z over the chunk's rows in row order by fmaf from
//     zero, and the chunks add in chunk order from zero.  No floating-point
//     atomics; nothing depends on P, the SM count, the strides, the
//     alignment or which block ends last, so a partition's g is bitwise the
//     same in a launch of 8 partitions and of 4, and for a strided view and
//     its contiguous copy.
//
// margin_kernel: the feature axis is cut into segments of kMarginSeg columns
// and one block owns kMarginRows rows x one segment of one partition,
// accumulating in fp32 registers; blocks are numbered segment-fastest, so
// the blocks resident at one time read neighbouring columns of the same few
// rows.  Each block writes its partial sums to scratch, and the last block of
// a row tile to finish (a ticket per tile, which it resets) adds the
// partials in segment order and writes sigmoid(m) - y (sigmoid(m) where y is
// null: the served path's predict_proba).
//
// xtz_kernel: one block owns kThreads columns of one partition and walks all
// the rows of that partition, so each output has one owner and no atomics are
// needed; neighbouring threads read neighbouring columns, z is staged through
// shared memory, and kXtzUnroll independent accumulators per thread keep that
// many loads in flight.
//
// All take a leading partition dimension, X (P, n, d) with element strides
// (sxp, sxn, 1), so a column slice of a row-major table (the features after
// the label column) is read in place.  X is fp32 or bf16; accumulation is
// fp32 either way.  Ragged n and d are masked: any shape goes.  The C
// launchers take PyTorch's current stream, allocate nothing (scratch and
// tickets come from the wrapper; tickets start at zero and are left at zero)
// and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using port::cluster_blocks;
using port::cluster_map;
using port::cluster_rank;
using port::cluster_sync;
using port::mbar_init;
using port::mbar_wait;
using port::smem_addr;

constexpr int kThreads = 256;
constexpr int kMarginRows = 4;
constexpr int kMarginSeg = 4096;
constexpr int kXtzUnroll = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (S * RT, P) for S = ceil(d / kMarginSeg) segments and RT =
// ceil(n / kMarginRows) row tiles, segment fastest; block kThreads.
// w is (P, d) with row stride swp, or (d,) shared by all partitions (swp = 0);
// y is (P, n), or null for sigmoid(Xw) alone.
// partial holds P * RT * S * kMarginRows floats; tickets P * RT zeros, which
// the kernel leaves at zero.
template <typename T>
__global__ void __launch_bounds__(kThreads)
margin_kernel(const T* __restrict__ X, long long sxp, long long sxn,
              const float* __restrict__ w, long long swp,
              const float* __restrict__ y, float* __restrict__ z,
              float* __restrict__ partial, unsigned int* __restrict__ tickets,
              int n, int d, int S) {
  const int p = blockIdx.y;
  const int seg = blockIdx.x % S;
  const long long tile = (long long)p * ((n + kMarginRows - 1) / kMarginRows) + blockIdx.x / S;
  const int r0 = (blockIdx.x / S) * kMarginRows;
  const int nr = min(kMarginRows, n - r0);
  const int c1 = min(d, (seg + 1) * kMarginSeg);
  const T* xb = X + (long long)p * sxp + (long long)r0 * sxn;
  const float* wp = w + (long long)p * swp;

  float acc[kMarginRows];
#pragma unroll
  for (int r = 0; r < kMarginRows; ++r) acc[r] = 0.f;

  if (nr == kMarginRows) {
    for (int c = seg * kMarginSeg + threadIdx.x; c < c1; c += kThreads) {
      const float wc = wp[c];
#pragma unroll
      for (int r = 0; r < kMarginRows; ++r) acc[r] += to_float(xb[r * sxn + c]) * wc;
    }
  } else {  // the ragged last tile of rows
    for (int c = seg * kMarginSeg + threadIdx.x; c < c1; c += kThreads) {
      const float wc = wp[c];
#pragma unroll
      for (int r = 0; r < kMarginRows; ++r)
        if (r < nr) acc[r] += to_float(xb[r * sxn + c]) * wc;
    }
  }

  __shared__ float red[kMarginRows][kThreads / 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kMarginRows; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == 0) red[r][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < kMarginRows) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) m += red[threadIdx.x][i];
    partial[(tile * S + seg) * kMarginRows + threadIdx.x] = m;
  }
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[tile], 1u) == (unsigned)(S - 1);
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) tickets[tile] = 0u;  // every block of the tile has taken its ticket
  if (threadIdx.x < nr) {
    __threadfence();
    float m = 0.f;
    for (int t = 0; t < S; ++t) m += __ldcg(&partial[(tile * S + t) * kMarginRows + threadIdx.x]);
    const long long row = (long long)p * n + r0 + threadIdx.x;
    const float s = 1.f / (1.f + expf(-m));
    z[row] = y != nullptr ? s - y[row] : s;
  }
}

// grid (ceil(d / kThreads), P); block kThreads.  z is (P, n), g is (P, d).
template <typename T>
__global__ void __launch_bounds__(kThreads)
xtz_kernel(const T* __restrict__ X, long long sxp, long long sxn,
           const float* __restrict__ z, float* __restrict__ g, int n, int d) {
  __shared__ float zs[kThreads];
  const int p = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < d;
  const T* xc = X + (long long)p * sxp + (live ? c : 0);
  const float* zp = z + (long long)p * n;

  float acc[kXtzUnroll];
#pragma unroll
  for (int u = 0; u < kXtzUnroll; ++u) acc[u] = 0.f;

  for (int r0 = 0; r0 < n; r0 += kThreads) {
    const int nr = min(kThreads, n - r0);
    __syncthreads();  // the previous tile's z is no longer read
    if (threadIdx.x < nr) zs[threadIdx.x] = zp[r0 + threadIdx.x];
    __syncthreads();
    if (live) {
      const T* x = xc + (long long)r0 * sxn;
      int r = 0;
      for (; r + kXtzUnroll <= nr; r += kXtzUnroll) {
#pragma unroll
        for (int u = 0; u < kXtzUnroll; ++u)
          acc[u] += to_float(x[(long long)(r + u) * sxn]) * zs[r + u];
      }
      for (; r < nr; ++r) acc[0] += to_float(x[(long long)r * sxn]) * zs[r];
    }
  }
  if (live) {
    const float s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                    ((acc[4] + acc[5]) + (acc[6] + acc[7]));
    g[(long long)p * d + c] = s;
  }
}

// ------------------------------------------------------------------------- //
// grad_kernel
// ------------------------------------------------------------------------- //
constexpr int kGradThreads = 512;
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kGradMaxStages = 8;    // S
constexpr int kGradMaxCluster = 16;  // C (non-portable above 8)
constexpr int kGradMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kGradRingSmem = kGradMaxSmem - 2048;  // the ring's part of it

struct GradArgs {
  const void* x;
  long long sxp, sxn;
  const float* w;
  long long swp;
  const float* y;
  long long syp, syn;
  float* g;
  float* partial;      // P * Q * d floats where Q > 1
  unsigned* tickets;   // P * C zeros, left at zero
  int P, n, d;
  int W;               // columns of a slice
  int Rc, Q;           // rows of a chunk, chunks of a partition
  int S;               // stages
  int slot;            // bytes of one row's stage slot
};

// bytes of one row's slot: the slice and up to 15 bytes on either side
__host__ __device__ constexpr int grad_slot_bytes(int W) { return (W * 4 + 32 + 15) / 16 * 16; }

// rows a stage holds for K columns a thread: 4 of slices up to 4,096 wide,
// else 1 (five rows of a 10,000-wide slice fill the ring)
__host__ __device__ constexpr int grad_rows(int K) { return K <= 8 ? 4 : 1; }

// v into another block's shared memory at addr, counted on its mbarrier bar
// (both addresses mapped into that block); the store completes on its own
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// `bytes` (a multiple of 16) from 16-byte-aligned src to dst by the copy
// engine (a one-dimensional bulk copy), completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// where a row slice starting at src lies in its slot: first granule, granules, shift
template <typename T>
__device__ __forceinline__ void granules(const T* src, int width, uintptr_t& lo, int& count,
                                         int& shift) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  lo = a & ~static_cast<uintptr_t>(15);
  const uintptr_t hi =
      (a + static_cast<uintptr_t>(width) * sizeof(T) + 15) & ~static_cast<uintptr_t>(15);
  count = static_cast<int>((hi - lo) / 16);
  shift = static_cast<int>((a - lo) / sizeof(T));
}

// Grid: P * Q clusters of C blocks, (partition, chunk) = (cluster % P,
// cluster / P): a partition's last chunk comes in the last wave, so the sums
// of its chunks hold up no other cluster; block kGradThreads; dynamic shared
// memory S * R slots.
// K: the slice's columns a thread owns, at most (W <= K * kGradThreads);
// R = grad_rows(K) rows a stage.
//
// The loop is lagged by one group so that the exchange's latency hides
// behind work: iteration j starts with group j's partial margins pushed; it
// forms group j + 1's partial margins from its stage, waits (warp 0) until
// every block's partials of group j have arrived and forms z_j, pushes group
// j + 1's partials, and only then adds group j's x * z into g from group j's
// stage, which is refilled in the next iteration.  Two stages are in use and
// S - 2 in flight.  red, part, pbar and zs are double-buffered by the
// group's parity.  One __syncthreads a group; no cluster barrier after the
// first.
// A row slice's dot with w (a chain over the thread's columns by fmaf from
// zero) and its x * z added into g.  With FULL every column of the first
// K - 1 is in the slice for every thread (width >= (K - 1) * kGradThreads),
// so only the last needs a test: 20 live tests would not fit the predicate
// registers, and their spills serialized the shared-memory loads.
template <typename T, int K, bool FULL>
__device__ __forceinline__ float slice_dot(const T* xs, const float (&wr)[K], int t, int width) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * kGradThreads;
    if ((FULL && k < K - 1) || c < width) acc = fmaf(to_float(xs[c]), wr[k], acc);
  }
  return acc;
}

template <typename T, int K, bool FULL>
__device__ __forceinline__ void slice_axpy(const T* xs, float z, float (&gr)[K], int t,
                                           int width) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * kGradThreads;
    if ((FULL && k < K - 1) || c < width) gr[k] = fmaf(to_float(xs[c]), z, gr[k]);
  }
}


template <typename T, int K>
__global__ void __launch_bounds__(kGradThreads, 1)
grad_kernel(const GradArgs a) {
  constexpr int R = grad_rows(K);
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kGradMaxStages];
  __shared__ __align__(8) uint64_t pbar[2];  // a group's partials have all arrived
  __shared__ __align__(16) float ys[kGradMaxStages][R][4];  // each label's granule
  __shared__ float red[2][R][kGradWarps];
  __shared__ float part[2][kGradMaxCluster][R];
  __shared__ float zs[2][R];
  __shared__ bool last;

  const int C = static_cast<int>(cluster_blocks());
  const int rank = static_cast<int>(cluster_rank());
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const long long cid = blockIdx.x / C;
  const int p = static_cast<int>(cid % a.P);
  const int q = static_cast<int>(cid / a.P);
  const int r0 = q * a.Rc;
  const int rows = min(a.Rc, a.n - r0);
  const int c0 = rank * a.W;
  const int width = min(a.W, a.d - c0);
  const T* xb = static_cast<const T*>(a.x) + p * a.sxp + static_cast<long long>(r0) * a.sxn + c0;
  const float* yb = a.y + p * a.syp + static_cast<long long>(r0) * a.syn;
  const int groups = (rows + R - 1) / R;
  const bool whole = (K - 1) * kGradThreads <= width;  // see slice_dot
  float wr[K], gr[K];  // the slice's w and g: column t + k * kGradThreads

  // the three serial jobs of a group on three warps: warp 0 forms z, warp 1
  // pushes the partials, warp 2 refills the ring
  constexpr int kPusher = 32, kIssuer = 64;
  // warp 0's lanes a row's z takes: one a cluster rank
  constexpr int kZLanes = 32 / R;
  const uint32_t ring_base = smem_addr(ring);
  // stage grp % S <- the rows of group grp and the granules of their labels,
  // one bulk copy each, issued by thread `who` after the block's last reads
  // of the stage (the proxy fence orders those reads before the copy
  // engine's writes)
  auto issue = [&](int grp, int who) {
    if (t != who || grp >= groups) return;
    const int s = grp % a.S;
    const int nr = min(R, rows - grp * R);
    uintptr_t lo[R];
    int count[R];
    uint32_t bytes = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int shift;
      granules(xb + (grp * R + i) * a.sxn, width, lo[i], count[i], shift);
      if (i < nr) bytes += 16 * count[i] + 16;
    }
    const uint32_t bar = smem_addr(&full[s]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    port::mbar_expect(bar, bytes);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < nr) {
        bulk_load(ring_base + (s * R + i) * a.slot, reinterpret_cast<const void*>(lo[i]),
                  16 * count[i], bar);
        const uintptr_t ya = reinterpret_cast<uintptr_t>(yb + (grp * R + i) * a.syn);
        bulk_load(smem_addr(&ys[s][i][0]),
                  reinterpret_cast<const void*>(ya & ~static_cast<uintptr_t>(15)), 16, bar);
      }
    }
  };
  // the stage row of group grp's row i, at the column offset shift
  auto stage_row = [&](int grp, int i) {
    uintptr_t lo;
    int count, shift;
    granules(xb + (grp * R + i) * a.sxn, width, lo, count, shift);
    return reinterpret_cast<const T*>(ring + ((grp % a.S) * R + i) * a.slot) + shift;
  };
  // group grp's partial margins into red[grp & 1], and each row's label into
  // y of the lane of warp 0 that forms the row's z
  auto margins = [&](int grp, float& y) {
    const int s = grp % a.S;
    const int nr = min(R, rows - grp * R);
    mbar_wait(smem_addr(&full[s]), (grp / a.S) & 1);
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i] = 0.f;
      if (i < nr) {
        const T* xs = stage_row(grp, i);
        acc[i] = whole ? slice_dot<T, K, true>(xs, wr, t, width)
                      : slice_dot<T, K, false>(xs, wr, t, width);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) red[grp & 1][i][warp] = acc[i];
    }
    if (t < 32 && t % kZLanes == 0 && t / kZLanes < nr) {
      const int i = t / kZLanes;
      const uintptr_t ya = reinterpret_cast<uintptr_t>(yb + (grp * R + i) * a.syn);
      y = ys[s][i][(ya & 15) / 4];
    }
  };
  // each row's block partial (its warps in warp order) into every block's
  // part[grp & 1], counted on its pbar[grp & 1]; kPusher first tells its own
  // pbar how many bytes the group brings (pbar[b]'s phase of group grp - 2
  // has completed by then, so the count lands in the group's own phase).
  // That phase in turn completes only after every block has formed z of
  // group grp - 1 and read part[b] for the last time.
  auto push = [&](int grp) {
    const int nr = min(R, rows - grp * R);
    const int b = grp & 1;
    if (t == kPusher) port::mbar_expect(smem_addr(&pbar[b]), nr * C * 4);
    if (t >= kPusher && t < kPusher + nr * C) {
      const int i = (t - kPusher) / C, to = (t - kPusher) % C;
      float m = 0.f;
#pragma unroll
      for (int v = 0; v < kGradWarps; ++v) m += red[b][i][v];
      st_async(cluster_map(smem_addr(&part[b][rank][i]), to), m,
               cluster_map(smem_addr(&pbar[b]), to));
    }
  };

  // thread 0 sets up the barriers and starts the ring at once; the block
  // loads its slice of w meanwhile
  if (t == 0) {
    for (int s = 0; s < a.S; ++s) mbar_init(smem_addr(&full[s]), 1);
    mbar_init(smem_addr(&pbar[0]), 1);
    mbar_init(smem_addr(&pbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < a.S; ++s) issue(s, 0);
  }
  const float* wp = a.w + p * a.swp + c0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * kGradThreads;
    wr[k] = c < width ? wp[c] : 0.f;
    gr[k] = 0.f;
  }
  // every block of the cluster has started (and its barriers are set up)
  // before any block pushes into its shared memory
  cluster_sync();

  float yr = 0.f, yn = 0.f;
  margins(0, yr);
  __syncthreads();  // red[0] is whole
  push(0);
  for (int grp = 0; grp < groups; ++grp) {
    const bool next = grp + 1 < groups;
    if (next) margins(grp + 1, yn);
    const int nr = min(R, rows - grp * R);
    if (warp == 0) {
      // once every block's partials of the group have arrived, lane
      // i * kZLanes + j holds row i's partial of rank j (0 for j >= C) and
      // the lanes of a row add them by an xor butterfly
      mbar_wait(smem_addr(&pbar[grp & 1]), (grp >> 1) & 1);
      const int i = lane / kZLanes, j = lane % kZLanes;
      float m = i < nr && j < C ? part[grp & 1][j][i] : 0.f;
#pragma unroll
      for (int o = kZLanes / 2; o > 0; o >>= 1) m += __shfl_xor_sync(0xffffffffu, m, o);
      if (j == 0 && i < nr) zs[grp & 1][i] = 1.f / (1.f + expf(-m)) - yr;
    }
    // zs and red[(grp + 1) & 1] are whole; group grp - 1's stage is free
    __syncthreads();
    if (grp > 0) issue(grp - 1 + a.S, kIssuer);
    if (next) push(grp + 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < nr) {
        const T* xs = stage_row(grp, i);
        const float z = zs[grp & 1][i];
        if (whole) {
          slice_axpy<T, K, true>(xs, z, gr, t, width);
        } else {
          slice_axpy<T, K, false>(xs, z, gr, t, width);
        }
      }
    }
    yr = yn;
  }

  float* gp = a.g + static_cast<long long>(p) * a.d + c0;
  if (a.Q == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = t + k * kGradThreads;
      if (c < width) gp[c] = gr[k];
    }
    return;
  }
  const long long pq = static_cast<long long>(p) * a.Q;
  float* mine = a.partial + (pq + q) * a.d + c0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * kGradThreads;
    if (c < width) mine[c] = gr[k];
  }
  // the block's chunk is visible before its ticket: the barrier orders every
  // thread's stores before thread 0's fence (as a grid barrier does)
  __syncthreads();
  unsigned* ticket = a.tickets + static_cast<long long>(p) * C + rank;
  if (t == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(a.Q - 1);
    if (last) {
      *ticket = 0u;  // every chunk of this slice has taken its ticket
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  // the Q chunks in chunk order, U of them loaded at a time (g and w are
  // dead here, so their registers hold the loads)
  constexpr int U = K <= 8 ? 8 : 4;
  const float* col = a.partial + pq * a.d + c0;
  float sum[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sum[k] = 0.f;
  int qq = 0;
  for (; qq + U <= a.Q; qq += U) {
    float v[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = t + k * kGradThreads;
        v[u][k] = c < width ? __ldcg(col + (qq + u) * static_cast<long long>(a.d) + c) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) sum[k] += v[u][k];
    }
  }
  for (; qq < a.Q; ++qq) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = t + k * kGradThreads;
      if (c < width) sum[k] += __ldcg(col + qq * static_cast<long long>(a.d) + c);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * kGradThreads;
    if (c < width) gp[c] = sum[k];
  }
}

template <typename T, int K>
cudaError_t grad_configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(grad_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kGradRingSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(grad_kernel<T, K>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  done = err == cudaSuccess;
  return err;
}

// launch, or with `clusters` non-null, report how many clusters of C blocks
// the card holds at once (cudaOccupancyMaxActiveClusters)
template <typename T, int K>
int grad_run(const GradArgs& a, int P, int C, cudaStream_t s, int* clusters) {
  const cudaError_t err = grad_configure<T, K>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(P) * a.Q * C));
  cfg.blockDim = dim3(kGradThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(grad_rows(K)) * a.S * a.slot;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, grad_kernel<T, K>, &cfg));
  }
  return static_cast<int>(cudaLaunchKernelEx(&cfg, grad_kernel<T, K>, a));
}

template <typename T>
int grad_dispatch(const GradArgs& a, int P, int C, int K, cudaStream_t s, int* clusters) {
  if (K == 8) return grad_run<T, 8>(a, P, C, s, clusters);
  if (K == 20) return grad_run<T, 20>(a, P, C, s, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

int grad_entry(int dtype, const void* X, long long sxp, long long sxn, const void* w,
               long long swp, const void* y, long long syp, long long syn, void* g,
               void* partial, void* tickets, int P, int n, int d, int C, int W, int K, int Rc,
               int R, int S, void* stream, int* clusters) {
  const int slot = grad_slot_bytes(W);
  const long long Q = (static_cast<long long>(n) + Rc - 1) / Rc;
  // the plan must cover d with C slices, none empty, each within K columns a
  // thread, with C ranks to a row's lanes of warp 0 (32 / R, kZLanes), and its
  // ring must fit a block's shared memory with at least 3 stages (a group's
  // rows are issued two iterations before they are read)
  if (P <= 0 || n <= 0 || d <= 0 || C < 1 || C > kGradMaxCluster || W < 1 ||
      static_cast<long long>(C) * W < d || static_cast<long long>(C - 1) * W >= d ||
      (K != 8 && K != 20) || W > K * kGradThreads || Rc < 1 || R != grad_rows(K) ||
      C * R > 32 || S < 3 ||
      S > kGradMaxStages || static_cast<long long>(R) * S * slot > kGradRingSmem ||
      P * Q > 2147483647LL / C || (Q > 1 && (partial == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GradArgs a = {};
  a.x = X;
  a.sxp = sxp;
  a.sxn = sxn;
  a.w = static_cast<const float*>(w);
  a.swp = swp;
  a.y = static_cast<const float*>(y);
  a.syp = syp;
  a.syn = syn;
  a.g = static_cast<float*>(g);
  a.partial = static_cast<float*>(partial);
  a.tickets = static_cast<unsigned*>(tickets);
  a.P = P;
  a.n = n;
  a.d = d;
  a.W = W;
  a.Rc = Rc;
  a.Q = static_cast<int>(Q);
  a.S = S;
  a.slot = slot;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return grad_dispatch<float>(a, P, C, K, s, clusters);
  if (dtype == 1) return grad_dispatch<__nv_bfloat16>(a, P, C, K, s, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Scratch the margin kernel needs for P partitions of n rows and d columns.
extern "C" void logreg_margin_scratch(int P, int n, int d, long long* partial_floats,
                                      long long* tickets) {
  const long long tiles = (long long)P * ((n + kMarginRows - 1) / kMarginRows);
  *partial_floats = tiles * ((d + kMarginSeg - 1) / kMarginSeg) * kMarginRows;
  *tickets = tiles;
}

// dtype: 0 = fp32 X, 1 = bf16 X.  y may be null (sigmoid(Xw) alone).
// Returns a cudaError_t as int (0 = launched).
extern "C" int logreg_margin_launch(int dtype, const void* X, long long sxp, long long sxn,
                                    const void* w, long long swp, const void* y, void* z,
                                    void* partial, void* tickets, int P, int n, int d,
                                    void* stream) {
  const int S = (d + kMarginSeg - 1) / kMarginSeg;
  const long long blocks = (long long)S * ((n + kMarginRows - 1) / kMarginRows);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    margin_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(X), sxp, sxn, static_cast<const float*>(w), swp,
        static_cast<const float*>(y), static_cast<float*>(z), static_cast<float*>(partial),
        static_cast<unsigned int*>(tickets), n, d, S);
  } else if (dtype == 1) {
    margin_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(X), sxp, sxn, static_cast<const float*>(w), swp,
        static_cast<const float*>(y), static_cast<float*>(z), static_cast<float*>(partial),
        static_cast<unsigned int*>(tickets), n, d, S);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int logreg_xt_z_launch(int dtype, const void* X, long long sxp, long long sxn,
                                  const void* z, void* g, int P, int n, int d, void* stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    xtz_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(X), sxp, sxn, static_cast<const float*>(z),
        static_cast<float*>(g), n, d);
  } else if (dtype == 1) {
    xtz_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(X), sxp, sxn, static_cast<const float*>(z),
        static_cast<float*>(g), n, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The one-pass gradient g (P, d) fp32 under the wrapper's plan: C blocks a
// cluster, slices of W columns, K columns a thread, chunks of Rc rows, a ring
// of S stages of R rows.  y (P, n) at element strides (syp, syn); w (P, d) at
// row stride swp, or (d,) with swp = 0.  partial: P * ceil(n / Rc) * d floats
// and tickets: P * C zeros where n > Rc (else unused).  Returns a cudaError_t
// as int (0 = launched; cudaErrorInvalidValue for a plan the kernel cannot run).
extern "C" int logreg_grad_launch(int dtype, const void* X, long long sxp, long long sxn,
                                  const void* w, long long swp, const void* y, long long syp,
                                  long long syn, void* g, void* partial, void* tickets, int P,
                                  int n, int d, int C, int W, int K, int Rc, int R, int S,
                                  void* stream) {
  return grad_entry(dtype, X, sxp, sxn, w, swp, y, syp, syn, g, partial, tickets, P, n, d, C, W,
                    K, Rc, R, S, stream, nullptr);
}

// How many clusters of the plan's C blocks the card holds at once, into *out.
extern "C" int logreg_grad_clusters(int dtype, int n, int d, int C, int W, int K, int Rc, int R,
                                    int S, int* out) {
  static float dummy[1];
  return grad_entry(dtype, dummy, 0, 0, dummy, 0, dummy, 0, 0, dummy, dummy, dummy, 1, n, d, C,
                    W, K, Rc, R, S, nullptr, out);
}
