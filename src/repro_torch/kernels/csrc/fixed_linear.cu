// Fixed-order decode products for Hopper (sm_90a): for up to 5 weights that
// read the same rows,
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
// Routes, by the weights' dtype:
//   * bf16: fixed_mma_kernel, on the tensor cores, tied_mma_kernel's rule
//     (lm_head.cu): mma.sync.m16n8k16 bf16 x bf16 with fp32 accumulation,
//     16 weight rows on the m16 side (loaded in 16-byte pieces from HBM into
//     registers, not kept in L1) and the <= 8 rows of x of an M-tile on the
//     n8 side (bf16 in shared memory; rows past M are zeros).  K is cut into
//     groups of 32 (two mma's each, lane (g, t) taking elements 8t..8t+7 of
//     the group for rows g and g + 8 and for x's row g) and the groups into
//     slices of kGroups (256 elements).  Each mma starts from zero and is
//     added to its slice's fp32 sum with an IEEE add, in group order; the
//     slices' sums are then added in slice order by one thread:
//       out = ((P_0 + P_1) + P_2) + ...,   P_s = ((0 + d_0) + d_1) + ...
//     an order fixed by K alone.  An output element of mma is its own dot
//     product, so row m is bitwise the same at M = 1 and M = 8.
//   * bf16, more than kDecodeRows rows without a norm (a prefill):
//     fixed_tiled_kernel, the same sum element for element on larger tiles.
//     A block takes 128 weight rows (16 a warp) and 64 rows of x (8 n8
//     tiles), both staged a slice of 256 elements of K at a time by cp.async
//     into two shared-memory stages (the next slice in flight while the warps
//     multiply this one); each warp's weight fragment serves 8 mma's where
//     the decode form's serves one, so a wave of prompts reads each weight
//     once per 64 rows instead of once per 8.  Each mma starts from zero and
//     is added to its slice's sum in group order, the slices in order, the
//     lanes' K elements as in fixed_mma_kernel: a row of a prefill is
//     bitwise the same row at M = 1.
//   * fp32: fixed_fma_kernel on the SIMT pipe (IEEE fp32 FMA; the port keeps
//     fp32 operands off the tensor cores and TF32 off): a warp per output
//     column, K cut into chunks of 4, chunk c to lane c % 32, one fma chain
//     over a lane's chunks in order, the 32 lane sums in a fixed xor
//     butterfly.  Only the reduced-width (fp32) configurations take it.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 on the
// tensor cores): at a decode step (M <= 16) each weight element is read once
// for 2·M operations, far below the card's operations-per-byte line, so the
// bytes bound it: Mamba2-2.7B's in-projections (2560 x 10576 bf16, 54 MB)
// 16.2 us, its out-projection (5120 x 2560, 26 MB) 7.8 us; a Mamba2 decode
// step streams 5.4 GB of weights, 1.6 ms.
//
// How the bf16 route meets it:
//   * a persistent grid of one block an SM (8 warps) walks the group's tiles
//     of 16 weight rows (tile i of the grid's x, then i + gridDim.x, ...); a
//     block's (tile, slice) items go to its warps in contiguous runs, so a
//     warp streams along its rows (the narrow shapes, N = 1536 and K = 8960:
//     96 tiles, still keep every warp busy);
//   * a warp holds two items in registers and loads them in turns, so that
//     while it waits for one item's 8 KB the next one's are in flight too
//     (a load-then-copy pipeline waited for each item alone); the first two
//     are issued before the block stages x;
//   * x's rows arrive by cp.async, all in flight at once (a load-and-store
//     loop waited an L2 round trip a step); with the norm, warp r sums row
//     r's squares from shared memory in rmsnorm.cu's order (lane l keeps the
//     sums of threads l + 32w, w = 0..7) and normalises row r into the tile
//     (where the raw rows and the tile do not both fit, fp32 rows of 5,120,
//     the block normalises the rows one at a time over the raw rows' bytes);
//   * the items' partial sums go to shared memory; after each wave of tiles
//     a barrier, then every output of the wave summed over its slices in
//     order and rounded once.  No workspace, nothing allocated: a CUDA graph
//     captures the launch as it is.
//
// The tiled form is bounded by operations: a wave of 8,000 rows against
// Qwen2-1.5B's gate/up (1536 x 17920) is 440 GFLOP, 0.44 ms at the tensor
// cores' peak.  It holds 64 x 128 outputs a block in registers (32 sums and
// 32 slice sums a thread) and reads 96 KB of shared memory a slice for 4.2
// MFLOP; no wgmma (whose order inside an instruction of K = 16 is the same
// hardware's, but whose operands would need a layout of their own).
//
// x (M, K) has a 16-byte aligned row stride (ldx elements), K % 8 == 0; each
// weight (N_i, K) is contiguous and 16-byte aligned; outputs are contiguous.
// The C launcher takes PyTorch's current stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = port::kRmsThreads;   // 256, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 5;                      // weights one launch takes
constexpr int kMmaRows = 8;                   // rows of x an mma M-tile holds (n8)
constexpr int kGroups = 8;                    // 32-element groups of K in a slice
constexpr int kItemFloats = 128;              // a (tile, slice) partial: 16 x 8 sums
constexpr int kNormPer = 32;                  // a row's elements a thread normalises at most
constexpr int kSmemMax = 226 * 1024;          // dynamic, beside the static bytes
constexpr int kDecodeRows = 16;               // more rows (bf16, no norm) take the tiled form
constexpr int kTileN = 128;                   // tiled form: weight rows a block takes
constexpr int kTileM = 64;                    // ... rows of x a block takes (8 n8 tiles)
constexpr int kTilePitch = kGroups * 64 + 64; // ... bytes a staged row of a slice takes
constexpr int kStageBytes = (kTileN + kTileM) * kTilePitch;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 16 bytes, or zeros (nothing read) where !valid
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
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

// The weight of tile `tile`.
__device__ __forceinline__ int weight_of(const Group& grp, int tile) {
  int i = 0;
#pragma unroll
  for (int j = 1; j < kMaxW; ++j) {
    if (j < grp.count && tile >= grp.tile0[j]) i = j;
  }
  return i;
}

// Round a sum once to weight i's output type and store it.
__device__ __forceinline__ void store_out(const Group& grp, int i, long long at, float v) {
  if (grp.out_bf16[i]) {
    static_cast<bf16*>(grp.out[i])[at] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(grp.out[i])[at] = v;
  }
}

// ------------------------------------------------------------------------- //
// bf16 weights: the tensor-core route.  grid (blocks, M-tiles of 8), kThreads
// threads; dynamic shared memory: x's M-tile [8][pitch bytes] (with the norm,
// the raw rows [8][K] of TX first, in the same bytes or beyond them), then
// the partials of a wave of tiles [wave * S][128] fp32.
// ------------------------------------------------------------------------- //
template <typename TX>
__global__ void __launch_bounds__(kThreads, 1)
fixed_mma_kernel(const __grid_constant__ Group grp, const __grid_constant__ Prologue pro,
                 const TX* __restrict__ x, long long ldx, int M, int K, int pitch, int S,
                 int wave, int raw_off, int part_off) {
  extern __shared__ float4 smem4[];
  char* xs = reinterpret_cast<char*>(smem4);
  float* part = reinterpret_cast<float*>(xs + part_off);
  const long long m0 = static_cast<long long>(blockIdx.y) * kMmaRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (K + 31) / 32;
  const int tiles = grp.tile0[grp.count];
  const int nt = tiles > static_cast<int>(blockIdx.x)
                     ? (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int items = nt * S;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // this warp's run of the items of the wave from local tile w0: [begin, end)
  auto run = [&](int w0, int& begin, int& end) {
    const int lo = w0 * S, hi = min(nt, w0 + wave) * S;
    const int per = (hi - lo + kWarps - 1) / kWarps;
    begin = min(hi, lo + warp * per);
    end = min(hi, begin + per);
  };
  // the 8 groups of item u (tile u / S of this block, slice u % S) that lane
  // (g, t) multiplies: 16 bytes of rows g and g + 8 each; zeros (and no
  // load) past the items, K or the weight's rows
  auto load = [&](int u, uint4 (&dst)[kGroups][2]) {
    const bool live = u < items;
    const int tile = blockIdx.x + (live ? u / S : 0) * gridDim.x;
    const int i = weight_of(grp, tile);
    const int n = grp.n[i];
    const long long v_lo = static_cast<long long>(tile - grp.tile0[i]) * 16 + g;
    const long long v_hi = v_lo + 8;
    const bf16* w = static_cast<const bf16*>(grp.w[i]);
    const bool ok_lo = live && v_lo < n, ok_hi = live && v_hi < n;
    const bf16* lo = w + (ok_lo ? v_lo : 0) * K + t * 8;
    const bf16* hi = w + (ok_hi ? v_hi : 0) * K + t * 8;
    const int q0 = (live ? u % S : 0) * kGroups;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int q = q0 + k;
      const bool in = q < groups && q * 32 + t * 8 < K;
      dst[k][0] = in && ok_lo ? port::ld_stream(lo + q * 32) : zero;
      dst[k][1] = in && ok_hi ? port::ld_stream(hi + q * 32) : zero;
    }
  };
  const char* xrow = xs + g * pitch + t * 16;     // group q at + q * 64
  // item u's partial sums, from its groups in registers, into the wave's
  // slot j of the partials
  auto multiply = [&](const uint4 (&src)[kGroups][2], int u, int j) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int q0 = (u % S) * kGroups;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      if (q0 + k < groups) {
        const uint4 b = *reinterpret_cast<const uint4*>(xrow + (q0 + k) * 64);
        port::mma_bf16_add(acc, src[k][0].x, src[k][1].x, src[k][0].y, src[k][1].y, b.x, b.y);
        port::mma_bf16_add(acc, src[k][0].z, src[k][1].z, src[k][0].w, src[k][1].w, b.z, b.w);
      }
    }
    *reinterpret_cast<float4*>(part + j * kItemFloats + lane * 4) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  };

  // two items in flight a warp, in turns: while the warp waits for one
  // buffer, the other's loads are on their way too
  uint4 bufA[kGroups][2], bufB[kGroups][2];
  {
    int begin, end;
    run(0, begin, end);
    load(begin < end ? begin : items, bufA);
    load(begin + 1 < end ? begin + 1 : items, bufB);
  }
  stage_rows<TX, bf16>(x, ldx, M, K, m0, kMmaRows, pro, reinterpret_cast<bf16*>(xs), pitch / 2,
                       reinterpret_cast<TX*>(xs + raw_off), raw_off > 0);
  __syncthreads();

  for (int w0 = 0; w0 < nt; w0 += wave) {
    int begin, end;
    run(w0, begin, end);
    if (w0 > 0) {
      load(begin < end ? begin : items, bufA);
      load(begin + 1 < end ? begin + 1 : items, bufB);
    }
    for (int u = begin; u < end; u += 2) {
      multiply(bufA, u, u - w0 * S);
      load(u + 2 < end ? u + 2 : items, bufA);
      if (u + 1 < end) {
        multiply(bufB, u + 1, u + 1 - w0 * S);
        load(u + 3 < end ? u + 3 : items, bufB);
      }
    }
    __syncthreads();
    // the wave's outputs: (weight row nl of the tile, x row mr) is element
    // (nl >= 8) * 2 + (mr & 1) of lane (nl & 7) * 4 + mr / 2's sums
    const int wt = min(nt - w0, wave);
    for (int o = threadIdx.x; o < wt * kItemFloats; o += kThreads) {
      const int jj = o / kItemFloats, e = o % kItemFloats;
      const int nl = e >> 3, mr = e & 7;
      const int src = ((nl & 7) * 4 + (mr >> 1)) * 4 + (nl >= 8 ? 2 : 0) + (mr & 1);
      const float* p = part + jj * S * kItemFloats + src;
      float sum = p[0];
      for (int s = 1; s < S; ++s) sum = __fadd_rn(sum, p[s * kItemFloats]);
      const int tile = blockIdx.x + (w0 + jj) * gridDim.x;
      const int i = weight_of(grp, tile);
      const long long n = static_cast<long long>(tile - grp.tile0[i]) * 16 + nl;
      const long long m = m0 + mr;
      if (m < M && n < grp.n[i]) store_out(grp, i, m * grp.n[i] + n, sum);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------------- //
// bf16 weights and x, many rows: the tiled form.  grid (M-tiles of 64, the
// group's tiles of 128 weight rows), kThreads threads; dynamic shared memory:
// two stages, each [128 weight rows][kTilePitch] then [64 x rows][kTilePitch]
// bytes, a row holding one slice (256 elements) of K.  Warp w multiplies
// weight rows 16w .. 16w + 15 of the tile against all 64 rows of x.
// ------------------------------------------------------------------------- //
__global__ void __launch_bounds__(kThreads, 1)
fixed_tiled_kernel(const __grid_constant__ Group grp, const bf16* __restrict__ x,
                   long long ldx, int M, int K) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.y;
  const int i = weight_of(grp, tile);
  const int n = grp.n[i];
  const long long n0 = static_cast<long long>(tile - grp.tile0[i]) * kTileN;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const bf16* w = static_cast<const bf16*>(grp.w[i]);
  const int groups = (K + 31) / 32;
  const int slices = (groups + kGroups - 1) / kGroups;
  const int chunks = K / 8;                        // 16-byte chunks of a row
  constexpr int kRowChunks = kGroups * 4;          // ... of a slice of a row

  // stage st <- slice s: zeros past K, past the weight's rows and past M
  auto load = [&](int st, int s) {
    char* dst = smem + st * kStageBytes;
    for (int e = threadIdx.x; e < (kTileN + kTileM) * kRowChunks; e += kThreads) {
      const int r = e / kRowChunks, c = e % kRowChunks;
      const int ck = s * kRowChunks + c;
      const bf16* src;
      bool ok;
      if (r < kTileN) {
        const long long v = n0 + r;
        ok = v < n && ck < chunks;
        src = w + (ok ? v * K + ck * 8 : 0);
      } else {
        const long long m = m0 + (r - kTileN);
        ok = m < M && ck < chunks;
        src = x + (ok ? m * ldx + ck * 8 : 0);
      }
      cp_async16_zfill(dst + r * kTilePitch + c * 16, src, ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float total[kTileM / 8][4];
  load(0, 0);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      load((s + 1) & 1, s + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const char* wst = smem + (s & 1) * kStageBytes + (warp * 16 + g) * kTilePitch + t * 16;
    const char* xst = smem + (s & 1) * kStageBytes + (kTileN + g) * kTilePitch + t * 16;
    float acc[kTileM / 8][4];
#pragma unroll
    for (int j = 0; j < kTileM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      if (s * kGroups + k < groups) {
        const uint4 lo = *reinterpret_cast<const uint4*>(wst + k * 64);
        const uint4 hi = *reinterpret_cast<const uint4*>(wst + 8 * kTilePitch + k * 64);
#pragma unroll
        for (int j = 0; j < kTileM / 8; ++j) {
          const uint4 b = *reinterpret_cast<const uint4*>(xst + j * 8 * kTilePitch + k * 64);
          port::mma_bf16_add(acc[j], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
          port::mma_bf16_add(acc[j], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kTileM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) total[j][e] = s == 0 ? acc[j][e] : __fadd_rn(total[j][e], acc[j][e]);
    }
    __syncthreads();   // the stage is reloaded two slices on
  }
  // sum e of n8 tile j: weight row g (+ 8 for e >= 2), x row j * 8 + 2t (+ 1 for odd e)
#pragma unroll
  for (int j = 0; j < kTileM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long v = n0 + warp * 16 + g + (e >= 2 ? 8 : 0);
      const long long m = m0 + j * 8 + 2 * t + (e & 1);
      if (m < M && v < n) store_out(grp, i, m * n + v, total[j][e]);
    }
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
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int smem, int& configured) {
  if (smem <= 48 * 1024 || smem <= configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) configured = smem;
  return err;
}

// Bytes of one row of x in shared memory on the mma route: K rounded up to a
// whole group of 32 (zeros past K), plus 64 bytes where that is a multiple of
// 128, so that the rows a quarter-warp reads start 64 bytes apart in the banks
// (lm_head.cu's mma_pitch).
int mma_pitch(int K) {
  const int bytes = (K + 31) / 32 * 64;
  return bytes % 128 ? bytes : bytes + 64;
}

// The mma route's shared memory before the partials: the tile, and with the
// norm the raw rows, after the tile where both fit beside the partials of
// one tile (raw_off > 0), else sharing its bytes (raw_off = 0).
struct MmaLayout {
  int raw_off, part_off;
};
MmaLayout mma_layout(int K, int x_bytes, int norm) {
  const int tile = (kMmaRows * mma_pitch(K) + 15) / 16 * 16;
  const int raw = norm ? (kMmaRows * K * x_bytes + 15) / 16 * 16 : 0;
  const int slices = ((K + 31) / 32 + kGroups - 1) / kGroups;
  const int item = 4 * slices * kItemFloats;
  if (norm && tile + raw + item <= kSmemMax) return {tile, tile + raw};
  return {0, tile > raw ? tile : raw};
}

int mma_slices(int K) { return ((K + 31) / 32 + kGroups - 1) / kGroups; }

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

template <typename TX>
int launch_mma(const Group& grp, const Prologue& pro, const void* x, long long ldx, int M,
               int K, cudaStream_t stream) {
  const int pitch = mma_pitch(K);
  const int S = mma_slices(K);
  const int tiles = grp.tile0[grp.count];
  const int blocks = tiles < num_sms() ? tiles : num_sms();
  const int nt = (tiles + blocks - 1) / blocks;
  const MmaLayout lay = mma_layout(K, sizeof(TX), pro.norm);
  const int item_bytes = S * kItemFloats * 4;
  int wave = (kSmemMax - lay.part_off) / item_bytes;
  if (wave < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (wave > nt) wave = nt;
  const int smem = lay.part_off + wave * item_bytes;
  static int configured = 0;
  const cudaError_t err = allow_smem(fixed_mma_kernel<TX>, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mtiles = (M + kMmaRows - 1) / kMmaRows;
  if (mtiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(mtiles));
  fixed_mma_kernel<TX><<<grid, kThreads, smem, stream>>>(
      grp, pro, static_cast<const TX*>(x), ldx, M, K, pitch, S, wave, lay.raw_off, lay.part_off);
  return static_cast<int>(cudaGetLastError());
}

// The tiled form: the group's tiles of kTileN rows.
int launch_tiled(const void* const* ws, void* const* outs, const int* ns, const int* out_bf16,
                 int count, const void* x, long long ldx, int M, int K, cudaStream_t stream) {
  Group grp{};
  grp.count = count;
  long long tiles = 0;
  for (int i = 0; i < count; ++i) {
    grp.w[i] = ws[i];
    grp.out[i] = outs[i];
    grp.n[i] = ns[i];
    grp.out_bf16[i] = out_bf16[i];
    grp.tile0[i] = static_cast<int>(tiles);
    tiles += (ns[i] + kTileN - 1) / kTileN;
  }
  for (int i = count; i <= kMaxW; ++i) grp.tile0[i] = static_cast<int>(tiles);
  const long long mtiles = (M + kTileM - 1) / kTileM;
  if (tiles > 65535 || mtiles > (1LL << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  constexpr int smem = 2 * kStageBytes;
  static int configured = 0;
  const cudaError_t err = allow_smem(fixed_tiled_kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(mtiles), static_cast<unsigned>(tiles));
  fixed_tiled_kernel<<<grid, kThreads, smem, stream>>>(grp, static_cast<const bf16*>(x), ldx, M,
                                                       K);
  return static_cast<int>(cudaGetLastError());
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

// The largest K a launch takes, for the weights' dtype (0 fp32, 1 bf16), x's
// dtype (the same codes) and the norm: the rows of x and the partials must
// fit the block's shared memory, and with the norm a thread normalises at
// most kNormPer elements of a row.
extern "C" int fixed_linear_max_k(int dtype, int x_dtype, int norm) {
  int lo = 8, hi = 1 << 20;
  const int x_bytes = x_dtype == 0 ? 4 : 2;
  while (lo < hi) {
    const int K = (lo + hi + 8) / 16 * 8;
    bool fits;
    if (dtype == 1) {
      fits = static_cast<long long>(mma_layout(K, x_bytes, norm).part_off) +
                 4LL * mma_slices(K) * kItemFloats <= kSmemMax;
    } else {
      fits = fma_rows(K, norm) > 0;
    }
    if (norm && K > kThreads * kNormPer) fits = false;
    if (fits) {
      lo = K;
    } else {
      hi = K - 8;
    }
  }
  return lo;
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
// scale_bf16), eps, plus_one.  Returns a cudaError_t as int (0 = launched).
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
