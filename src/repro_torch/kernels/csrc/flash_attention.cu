// Flash attention for Hopper (sm_90a): online-softmax attention with fp32
// running max m, running sum l and accumulator acc, in two forms of one
// function.
//
//   prefill  q (B, H, Sq, hd), k and v (B, KV, Sk, hd): query i sits at
//            position Sk - Sq + i, key j at position j (the reference's
//            convention: a right-padded ragged prefill);
//   decode   q (B, H, hd), caches (B, slots, KV, hd), pos (B,): one query a
//            row at pos[b], over a ring whose slot s holds position
//            pos - ((pos - s) mod slots), valid where that is >= 0 (the
//            reference's decode mask, src/repro/models/layers/attention.py:
//            296-305, for any pos, also pos >= slots).
//
// Both apply the causal, sliding-window and chunked masks of the reference,
// group the q heads by kv head (head h reads kv head h / (H / KV), without
// copying K/V), scale after the dot, s = (q . k) * scale, and finish with
// acc / max(l, 1e-30), so a fully masked row returns 0.
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (pallas_call at :123, _flash_kernel
// at :39), whose function is the prefill form; the decode form is the same
// function with a per-row query position and ring slots, which the Pallas
// kernel cannot serve (one Sk for the batch).
//
// A fixed order per row, whatever the batch and the padding: this is what
// the kernel is for.  The serving engine's continuous batching must give
// the slot-at-a-time oracle's greedy streams, so a row's result may not
// depend on how many rows share a launch, nor on whether its prompt was
// padded.  So:
//   * key tiles have a fixed width from key (or slot) 0, and keys past the
//     end are masked in the tile, never a tile width that follows Sk;
//   * every dot product, every row sum and every accumulation runs in one
//     order fixed by hd and the tile width alone (an fma chain over the
//     head dimension; over a tile's keys in index order; butterflies whose
//     pairs are fixed);
//   * a tile in which no (row, key) of the block is admitted is skipped;
//     a tile processed for other rows of the block leaves a row with no
//     admitted key in it bitwise unchanged, by the Pallas kernel's guards:
//     p = 0 where s is at NEG_INF, alpha = 0 while m is still NEG_INF and
//     exp(0) = 1 otherwise.  NEG_INF is -2e38, never -INFINITY, which would
//     give inf - inf = NaN.
// Arithmetic is IEEE fp32: fmaf, expf (not __expf), no --use_fast_math.
//
// What bounds it on this card (H100 SXM: 67 TFLOP/s fp32 outside the tensor
// cores, 3.35 TB/s).  Prefill: 4 * hd operations per admitted (query, key)
// pair and head, against q, k, v and out read or written once, so at the
// served lengths the operations bound it: Gemma3's global layer over a wave
// of 8 prompts of ~2,000 tokens is ~65 GFLOP, ~1 ms.  The kernel stays on
// the fp32 pipe (no TF32, no bf16 products: the port's fp32 rule), so its
// floor is that rate, not the tensor cores'.  Decode: each row reads its
// valid K/V once for 4 * hd operations a (slot, head) pair, so the bytes
// bound it: 2 * valid slots * hd * 2 bytes a (row, kv head) in bf16, 4 us
// for Gemma3's global layer at 8 rows near position 2,048.
//
// How the design meets it (PERF.md has its times):
//   * prefill: one block of 256 threads per (64 rows, kv head, b), a row
//     being a (query, q head of the group) pair, so GQA groups of any size
//     share each K/V tile; Q stays in shared memory as fp32, K and V tiles
//     of 32 keys are loaded (converted to fp32) once per block; scores in
//     2 x 4 register micro-tiles of float4 loads from shared memory, rows
//     padded by 4 floats so that the loads of a quarter-warp fall on
//     distinct banks; p . V: each thread holds 4 dims of its rows'
//     accumulators in registers;
//   * decode: the ring's slots are cut into spans from slot 0, of a width
//     fixed at compile time by hd (span_slots: 64 slots at hd 256, 128
//     below), and one block of hd threads takes one (span, kv head, batch
//     row): 256 blocks for Gemma3's global layer at 8 rows, 64 for its
//     512-slot ring, 256 for Qwen2's, where one block per (kv head, row)
//     gave 8 and 16 on 132 SMs.  A span above the row's position is skipped
//     before any load, and so is a tile of 32 slots with no admitted slot
//     (the block's rows share one position).  K and V tiles travel as
//     16-byte cp.async copies into a ring of 3 stages in shared memory, in
//     the cache's dtype, with one barrier a tile.  The block's rows are the
//     group's q heads (an instance for G <= 4 and one for G <= 8), held in
//     registers: lane l of a key group holds dims 8l..8l+7 of every row, so
//     a dot is an fma chain over 8 dims and a fixed butterfly over the
//     hd / 8 lanes of the key.  Each of the 8 key groups takes keys j,
//     j + 8, j + 16, j + 24 of a tile with its own running (m, l, acc); the
//     groups merge in group order and write the span's (m, l, acc) in fp32
//     to scratch; a second kernel merges the spans in span order (m = max,
//     l and acc weighted by e^(m_i - m), a span or group with m at NEG_INF
//     left out) and writes acc / max(l, 1e-30).  Every one of these orders
//     is fixed by hd and the span width, never by B or pos: a masked slot
//     adds p = 0 and leaves (m, l, acc) bitwise as they were, so a skipped
//     tile or span changes nothing.
//
// q, k, v and out are read through strides (the layer's (B, S, H, hd)
// layout is read in place); the head dimension is contiguous, every other
// stride a multiple of 4 elements and every base 16-byte aligned (the
// wrapper checks; the decode form's q and caches: every stride a multiple
// of 16 bytes).  hd is 32, 64, 128 or 256.  The C launchers take PyTorch's
// current stream, allocate nothing (the decode form's scratch comes from
// the wrapper) and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;           // keys (slots) of a tile, from key 0
constexpr int kPS = kTile + 1;      // row stride of the score tile, in floats
constexpr int kPrefillRows = 64;    // (query, head) rows of a prefill block
constexpr float kNegInf = -2.0e38f;

struct Mask {
  int causal;
  int has_window;
  long long window;
  int has_chunk;
  long long chunk;
};

// strides in elements of (batch, head, sequence); the head dim is contiguous
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// floor division, as Python's and jnp's // (positions may be negative when
// Sq > Sk)
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// the reference's masks for a query at pq and a key at pk
__device__ __forceinline__ bool admitted(long long pq, long long pk, const Mask& m) {
  if (m.causal && pk > pq) return false;
  if (m.has_window && pq - pk >= m.window) return false;
  if (m.has_chunk && floordiv(pq, m.chunk) != floordiv(pk, m.chunk)) return false;
  return true;
}

// Key j of nkeys for a query at pq (prefill: keys sit at j).
__device__ __forceinline__ bool key_ok(long long pq, long long j, long long nkeys,
                                       const Mask& m) {
  return j < nkeys && admitted(pq, j, m);
}

// The slots of a ring of nslots for a query at pq (decode): slot j holds
// the most recent position = j (mod nslots) that is <= pq, pq - ((pq - j)
// mod nslots), and is empty where that is negative.  With r = pq mod nslots
// that is pq - r + j for j <= r and pq - r + j - nslots above: one division
// for the query, none a slot.
struct Ring {
  long long pq, base, r, n;
  __device__ __forceinline__ Ring(long long pq_, long long n_) : pq(pq_), n(n_) {
    r = pq_ % n_;
    if (r < 0) r += n_;
    base = pq_ - r;
  }
  __device__ __forceinline__ bool ok(long long j, const Mask& m) const {
    if (j >= n) return false;
    const long long pk = base + j - (j > r ? n : 0);
    return pk >= 0 && admitted(pq, pk, m);
  }
};

// Thread layouts of a block of kRows rows, by phase.
template <int kRows, int HD>
struct Layout {
  static constexpr int QS = HD + 4;                      // Q and K row stride
  // scores: kColLanes lanes over the tile's keys, the rest over rows
  static constexpr int kColLanes = kRows == 64 ? 8 : 32;
  static constexpr int kRowLanes = kThreads / kColLanes;
  static constexpr int kSRows = kRows / kRowLanes;       // rows a thread scores
  static constexpr int kSCols = kTile / kColLanes;       // keys a thread scores
  // softmax: kRowThreads threads a row
  static constexpr int kRowThreads = kThreads / kRows;
  static constexpr int kRowKeys = kTile / kRowThreads;
  // p . V: 4 dims a thread, kRowGroups groups of rows
  static constexpr int kDimGroups = HD / 4;
  static constexpr int kRowGroups = kThreads / kDimGroups;
  static constexpr int kAccRows = (kRows + kRowGroups - 1) / kRowGroups;
  // shared memory, in floats
  static constexpr int kQ = kRows * QS;
  static constexpr int kK = kTile * QS;
  static constexpr int kV = kTile * HD;
  static constexpr int kP = kRows * kPS;
  static constexpr int kBytes = (kQ + kK + kV + kP + 3 * kRows) * 4;
  static_assert(kSRows >= 1 && kSCols >= 1 && kRowKeys >= 1, "layout");
  static_assert(kRowThreads <= 32 && (kRowThreads & (kRowThreads - 1)) == 0, "layout");
};

// One block: kRows rows of (query, head) against one kv head of one batch
// row.  Grid (ceil(Sq * G / kRows), KV, B), row r of block x is (query
// (x * kRows + r) / G, head (x * kRows + r) % G of the group).  nq = Sq,
// nkeys = Sk.
template <typename T, int HD, int kRows>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int H, int KV, long long nq, long long nkeys, Strides qs,
             Strides ks, Strides vs, Strides os, Mask mask, float scale) {
  using L = Layout<kRows, HD>;
  constexpr int QS = L::QS;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kRows][QS]
  float* Ks = Qs + L::kQ;                       // [kTile][QS]
  float* Vs = Ks + L::kK;                       // [kTile][HD]
  float* Ps = Vs + L::kV;                       // [kRows][kPS] scores, then p
  float* Ms = Ps + L::kP;                       // running max m, per row
  float* Ls = Ms + kRows;                       // running sum l
  float* As = Ls + kRows;                       // this tile's alpha

  const int G = H / KV;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const long long rows = nq * G;
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long qpos0 = nkeys - nq;   // position of query 0
  const int t = threadIdx.x;

  // Q rows as fp32 (rows past the last as zeros)
  for (int e = t; e < kRows * L::kDimGroups; e += kThreads) {
    const int r = e / L::kDimGroups, d = (e % L::kDimGroups) * 4;
    const long long rg = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rg < rows) {
      const long long i = rg / G;
      const int g = static_cast<int>(rg % G);
      val = load4(q + b * qs.b + (long long)(kvh * G + g) * qs.h + i * qs.s + d);
    }
    *reinterpret_cast<float4*>(Qs + r * QS + d) = val;
  }
  if (t < kRows) {
    Ms[t] = kNegInf;
    Ls[t] = 0.f;
  }

  // the rows this thread scores: whether each exists, and its query position
  const int tr = t / L::kColLanes, tc = t % L::kColLanes;
  bool row_ok[L::kSRows];
  long long pq[L::kSRows];
#pragma unroll
  for (int i = 0; i < L::kSRows; ++i) {
    const long long rg = row0 + tr + i * L::kRowLanes;
    row_ok[i] = rg < rows;
    pq[i] = qpos0 + (!row_ok[i] ? 0 : rg / G);
  }

  // the accumulator rows and dims this thread holds
  const int dg = t % L::kDimGroups, rgrp = t / L::kDimGroups;
  float acc[L::kAccRows][4];
#pragma unroll
  for (int a = 0; a < L::kAccRows; ++a) {
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[a][x] = 0.f;
  }
  __syncthreads();

  const long long ntiles = (nkeys + kTile - 1) / kTile;
  for (long long kt = 0; kt < ntiles; ++kt) {
    const long long k0 = kt * kTile;
    // skip a tile where no (row, key) of the block is admitted
    bool any = false;
#pragma unroll
    for (int i = 0; i < L::kSRows; ++i) {
#pragma unroll
      for (int j = 0; j < L::kSCols; ++j) {
        any |= row_ok[i] && key_ok(pq[i], k0 + tc + j * L::kColLanes, nkeys, mask);
      }
    }
    if (!__syncthreads_or(any)) continue;

    // the K and V tile as fp32 (keys past the end as zeros)
    for (int e = t; e < kTile * L::kDimGroups; e += kThreads) {
      const int c = e / L::kDimGroups, d = (e % L::kDimGroups) * 4;
      const long long key = k0 + c;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < nkeys) {
        kk = load4(k + b * ks.b + (long long)kvh * ks.h + key * ks.s + d);
        vv = load4(v + b * vs.b + (long long)kvh * vs.h + key * vs.s + d);
      }
      *reinterpret_cast<float4*>(Ks + c * QS + d) = kk;
      *reinterpret_cast<float4*>(Vs + c * HD + d) = vv;
    }
    __syncthreads();

    // scores s = (q . k) * scale, each dot an fma chain over d in order
    float s[L::kSRows][L::kSCols];
#pragma unroll
    for (int i = 0; i < L::kSRows; ++i) {
#pragma unroll
      for (int j = 0; j < L::kSCols; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < HD; d += 4) {
      float4 qv[L::kSRows], kv[L::kSCols];
#pragma unroll
      for (int i = 0; i < L::kSRows; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(Qs + (tr + i * L::kRowLanes) * QS + d);
      }
#pragma unroll
      for (int j = 0; j < L::kSCols; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tc + j * L::kColLanes) * QS + d);
      }
#pragma unroll
      for (int i = 0; i < L::kSRows; ++i) {
#pragma unroll
        for (int j = 0; j < L::kSCols; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L::kSRows; ++i) {
#pragma unroll
      for (int j = 0; j < L::kSCols; ++j) {
        const int c = tc + j * L::kColLanes;
        const bool ok = row_ok[i] && key_ok(pq[i], k0 + c, nkeys, mask);
        Ps[(tr + i * L::kRowLanes) * kPS + c] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: kRowThreads consecutive threads a row, kRowKeys keys each
    {
      const int r = t / L::kRowThreads, part = t % L::kRowThreads;
      float x[L::kRowKeys];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < L::kRowKeys; ++c) {
        x[c] = Ps[r * kPS + part * L::kRowKeys + c];
        mx = fmaxf(mx, x[c]);
      }
#pragma unroll
      for (int off = 1; off < L::kRowThreads; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < L::kRowKeys; ++c) {
        const float p = x[c] > kNegInf * 0.5f ? expf(x[c] - m_new) : 0.f;
        Ps[r * kPS + part * L::kRowKeys + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < L::kRowThreads; off <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (part == 0) {
        const float alpha = m_prev > kNegInf * 0.5f ? expf(m_prev - m_new) : 0.f;
        Ls[r] = alpha * Ls[r] + sum;
        Ms[r] = m_new;
        As[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V, over the tile's keys in order
#pragma unroll
    for (int a = 0; a < L::kAccRows; ++a) {
      const int r = rgrp + a * L::kRowGroups;
      if (r < kRows) {
        const float alpha = As[r];
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[a][x] *= alpha;
      }
    }
    for (int c = 0; c < kTile; ++c) {
      const float4 vv = *reinterpret_cast<const float4*>(Vs + c * HD + dg * 4);
#pragma unroll
      for (int a = 0; a < L::kAccRows; ++a) {
        const int r = rgrp + a * L::kRowGroups;
        if (r < kRows) {
          const float p = Ps[r * kPS + c];
          acc[a][0] = fmaf(p, vv.x, acc[a][0]);
          acc[a][1] = fmaf(p, vv.y, acc[a][1]);
          acc[a][2] = fmaf(p, vv.z, acc[a][2]);
          acc[a][3] = fmaf(p, vv.w, acc[a][3]);
        }
      }
    }
    __syncthreads();   // the next tile overwrites Ks, Vs and Ps
  }

  // out = acc / max(l, 1e-30)
#pragma unroll
  for (int a = 0; a < L::kAccRows; ++a) {
    const int r = rgrp + a * L::kRowGroups;
    const long long rg = row0 + r;
    if (r < kRows && rg < rows) {
      const float l = fmaxf(Ls[r], 1e-30f);
      const long long i = rg / G;
      const int g = static_cast<int>(rg % G);
      store4(out + b * os.b + (long long)(kvh * G + g) * os.h + i * os.s + dg * 4,
             make_float4(acc[a][0] / l, acc[a][1] / l, acc[a][2] / l, acc[a][3] / l));
    }
  }
}

template <typename T, int HD>
int launch_prefill(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int KV, long long nq, long long nkeys, Strides qs, Strides ks, Strides vs,
                   Strides os, Mask mask, float scale, cudaStream_t stream) {
  using L = Layout<kPrefillRows, HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD, kPrefillRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long rows = nq * (H / KV);
  const long long blocks = (rows + kPrefillRows - 1) / kPrefillRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), KV, B);
  flash_kernel<T, HD, kPrefillRows><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KV, nq, nkeys, qs, ks, vs, os, mask, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// Decode form: the slots split into spans from slot 0, one block a
// (span, kv head, batch row), then a merge over the spans in span order.
// ------------------------------------------------------------------------

// slots a span holds: 64 at hd 256 and 128 below, so that a span's K and V
// are 64 KB of bf16 (at hd 256, 128-slot spans left the 512-slot ring 32
// blocks; at hd 128, 64-slot spans spent more on merging than they gained)
constexpr int span_slots(int hd) { return hd >= 256 ? 64 : 128; }
constexpr int kGroups = 8;                     // key groups of a decode block
constexpr int kGroupKeys = kTile / kGroups;    // keys a group takes from a tile
constexpr int kLaneElems = 8;                  // head dims a lane holds
constexpr int kStages = 3;                     // tiles in flight (cp.async ring)
constexpr int kDecodeGroupMax = 8;             // q heads a kv head, at most
constexpr int kMergeThreads = 256;

// 8 consecutive elements as floats, from 16-byte aligned global or shared
// memory
__device__ __forceinline__ void load8(const float* p, float (&f)[kLaneElems]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[kLaneElems]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes global -> shared without registers; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int HD, int kG>
struct DecodeLayout {
  static constexpr int KL = HD / kLaneElems;            // lanes a key: 4..32
  static constexpr int kThreadsD = kGroups * KL;        // = HD
  static constexpr int kStageElems = 2 * kTile * HD;    // a K tile, then a V tile
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));   // elements a copy
  static constexpr int kChunksRow = HD / kVec;
  static constexpr int kStageBytes = kStages * kStageElems * static_cast<int>(sizeof(T));
  static constexpr int kSpan = span_slots(HD);
  static constexpr int kSpanTiles = kSpan / kTile;      // tiles of 32 slots a span
  static constexpr int kMergeBytes = kGroups * kG * (HD + 2) * 4;
  static constexpr int kBytes = kStageBytes > kMergeBytes ? kStageBytes : kMergeBytes;
  static_assert(KL >= 1 && KL <= 32 && (KL & (KL - 1)) == 0, "decode layout");
};

// One block: the G <= kG q heads of kv head blockIdx.y of batch row
// blockIdx.z, all at query position pos[b], against slots [s0, s0 + span)
// of the ring, s0 = blockIdx.x * span, span = span_slots(HD).  Key group j (kLaneElems dims a
// lane, KL lanes a key) takes keys j, j + 8, j + 16, j + 24 of each tile,
// in tile order, with its own running (m, l, acc); the groups then merge in
// group order, and the block writes the span's (m, l, acc) in fp32.
template <typename T, int HD, int kG>
__global__ void __launch_bounds__(HD, 2)
decode_span_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const long long* __restrict__ pos,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int H, int KV, long long slots, int nspans,
                   Strides qs, Strides ks, Strides vs, Mask mask, float scale) {
  using DL = DecodeLayout<T, HD, kG>;
  constexpr int KL = DL::KL;
  constexpr int NT = DL::kThreadsD;
  constexpr int kSpan = DL::kSpan, kSpanTiles = DL::kSpanTiles;
  extern __shared__ float4 smem4[];
  T* stage = reinterpret_cast<T*>(smem4);

  const int G = H / KV;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const long long s0 = (long long)blockIdx.x * kSpan;
  const long long pq = pos[b];
  const Ring ring(pq, slots);
  const long long part = (b * KV + kvh) * nspans + blockIdx.x;
  const int t = threadIdx.x, grp = t / KL, kl = t % KL;

  // a span above the query position holds no written slot: skip it before
  // any load
  if (s0 > pq) {
    if (t < G) {
      part_m[part * G + t] = kNegInf;
      part_l[part * G + t] = 0.f;
    }
    return;
  }

  // the span's tiles that hold an admitted slot, in order (one query
  // position for the whole block, so the list is the block's)
  bool mine[kSpanTiles];
#pragma unroll
  for (int i = 0; i < kSpanTiles; ++i) mine[i] = false;
  for (int j = t; j < kSpan; j += NT) {
    mine[j / kTile] |= ring.ok(s0 + j, mask);
  }
  int tiles[kSpanTiles];
  int ntiles = 0;
#pragma unroll
  for (int i = 0; i < kSpanTiles; ++i) {
    if (__syncthreads_or(mine[i])) tiles[ntiles++] = i;
  }

  // start the first kStages - 1 tiles' K and V on their way (cp.async, 16
  // bytes a copy; slots past the ring's end as zeros)
  const T* kb = k + b * ks.b + (long long)kvh * ks.h;
  const T* vb = v + b * vs.b + (long long)kvh * vs.h;
  auto issue = [&](int i) {
    if (i < ntiles) {
      const long long k0 = s0 + (long long)tiles[i] * kTile;
      T* st = stage + (i % kStages) * DL::kStageElems;
      for (int c = t; c < 2 * kTile * DL::kChunksRow; c += NT) {
        const int is_v = c / (kTile * DL::kChunksRow);
        const int rem = c % (kTile * DL::kChunksRow);
        const int row = rem / DL::kChunksRow, ch = rem % DL::kChunksRow;
        const long long key = k0 + row;
        const bool in = key < slots;
        const long long off = (in ? key : 0) * (is_v ? vs.s : ks.s) + ch * DL::kVec;
        cp_async16(st + is_v * kTile * HD + row * HD + ch * DL::kVec,
                   (is_v ? vb : kb) + off, in ? 16 : 0);
      }
    }
    cp_async_commit();   // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // this lane's dims of the group's q heads, as fp32
  float qf[kG][kLaneElems];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < G) {
      load8(q + b * qs.b + (long long)(kvh * G + g) * qs.h + kl * kLaneElems, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e) qf[g][e] = 0.f;
    }
  }
  float m[kG], l[kG], acc[kG][kLaneElems];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();   // tile i has landed (this thread's copies)
    __syncthreads();                // ... every thread's; tile i - 1 is done
    issue(i + kStages - 1);         // into the stage tile i - 1 used
    const T* Kt = stage + (i % kStages) * DL::kStageElems;
    const T* Vt = Kt + kTile * HD;
    const long long k0 = s0 + (long long)tiles[i] * kTile;

    // scores: each dot an fma chain over the lane's dims in order, then a
    // fixed butterfly over the KL lanes of the key
    float p[kG][kGroupKeys];
#pragma unroll
    for (int u = 0; u < kGroupKeys; ++u) {
      const int row = grp + u * kGroups;
      const bool ok = ring.ok(k0 + row, mask);
      float kf[kLaneElems];
      load8(Kt + row * HD + kl * kLaneElems, kf);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float dot = 0.f;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
          for (int off = KL / 2; off >= 1; off >>= 1) {
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          }
        }
        p[g][u] = ok ? dot * scale : kNegInf;
      }
    }
    // online softmax over the group's keys of the tile, in key order (rows
    // past G are never written, and skipped)
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= G) continue;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kGroupKeys; ++u) mx = fmaxf(mx, p[g][u]);
      const float alpha = m[g] > kNegInf * 0.5f ? expf(m[g] - mx) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kGroupKeys; ++u) {
        p[g][u] = p[g][u] > kNegInf * 0.5f ? expf(p[g][u] - mx) : 0.f;
        sum += p[g][u];
      }
      l[g] = alpha * l[g] + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e) acc[g][e] *= alpha;
    }
    // acc += p . V, over the group's keys in order
#pragma unroll
    for (int u = 0; u < kGroupKeys; ++u) {
      float vf[kLaneElems];
      load8(Vt + (grp + u * kGroups) * HD + kl * kLaneElems, vf);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g >= G) continue;
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) acc[g][e] = fmaf(p[g][u], vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the stages are free: the merge reuses their memory

  // merge the groups in group order: m = max, l and acc weighted by
  // e^(m_j - m); a group with no admitted key (m_j at NEG_INF) is left out
  float* Mg = reinterpret_cast<float*>(smem4);   // [kGroups][kG]
  float* Lg = Mg + kGroups * kG;                  // [kGroups][kG]
  float* Ag = Lg + kGroups * kG;                  // [kGroups][kG][HD]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (kl == 0) {
      Mg[grp * kG + g] = m[g];
      Lg[grp * kG + g] = l[g];
    }
    float* a = Ag + (grp * kG + g) * HD + kl * kLaneElems;
    *reinterpret_cast<float4*>(a) = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    *reinterpret_cast<float4*>(a + 4) = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
  }
  __syncthreads();
  for (int idx = t; idx < G * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) mx = fmaxf(mx, Mg[j * kG + g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const float mj = Mg[j * kG + g];
      if (mj > kNegInf * 0.5f) {
        const float w = expf(mj - mx);
        ls = fmaf(Lg[j * kG + g], w, ls);
        as = fmaf(Ag[(j * kG + g) * HD + d], w, as);
      }
    }
    part_acc[(part * G + g) * HD + d] = as;
    if (d == 0) {
      part_m[part * G + g] = mx;
      part_l[part * G + g] = ls;
    }
  }
}

// The spans' (m, l, acc) merged in span order as the groups were, then
// out = acc / max(l, 1e-30).  Grid (KV, B, ceil(G * hd / kMergeThreads)),
// one thread an output element (q head g, dim d).  The spans' weights
// e^(m_s - m) (-1 for a span left out) and the merged l are formed once a
// row in shared memory, so that a thread's loop over the spans is a chain
// of independent loads and one fma each.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out, int H, int KV,
                    int hd, int nspans, Strides os) {
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);    // [G][nspans]: m, then the weights
  float* Ls = W + (H / KV) * nspans;             // [G][nspans]: l
  float* Lrow = Ls + (H / KV) * nspans;          // [G]: the merged l
  const int G = H / KV;
  const int kvh = blockIdx.x;
  const long long b = blockIdx.y;
  const long long part0 = (b * KV + kvh) * nspans;
  for (int e = threadIdx.x; e < G * nspans; e += kMergeThreads) {
    const int g = e / nspans, sp = e % nspans;
    W[e] = part_m[(part0 + sp) * G + g];
    Ls[e] = part_l[(part0 + sp) * G + g];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float* w = W + g * nspans;
    float mx = kNegInf;
    for (int sp = 0; sp < nspans; ++sp) mx = fmaxf(mx, w[sp]);
    float ls = 0.f;
    for (int sp = 0; sp < nspans; ++sp) {
      const float ms = w[sp];
      float wt = -1.f;
      if (ms > kNegInf * 0.5f) {
        wt = expf(ms - mx);
        ls = fmaf(Ls[g * nspans + sp], wt, ls);
      }
      w[sp] = wt;
    }
    Lrow[g] = fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  const int idx = blockIdx.z * kMergeThreads + threadIdx.x;
  if (idx >= G * hd) return;
  const int g = idx / hd, d = idx % hd;
  const float* w = W + g * nspans;
  const float* a = part_acc + (part0 * G + g) * hd + d;
  float as = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < nspans; ++sp) {
    if (w[sp] >= 0.f) as = fmaf(a[(long long)sp * G * hd], w[sp], as);
  }
  store1(out + b * os.b + (long long)(kvh * G + g) * os.h + d, as / Lrow[g]);
}

long long decode_spans(long long slots, int hd) {
  return (slots + span_slots(hd) - 1) / span_slots(hd);
}

template <typename T, int HD, int kG>
int launch_decode(const void* q, const void* k, const void* v, void* out,
                  const long long* pos, float* scratch, int B, int H, int KV, long long slots,
                  Strides qs, Strides ks, Strides vs, Strides os, Mask mask, float scale,
                  cudaStream_t stream) {
  using DL = DecodeLayout<T, HD, kG>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_span_kernel<T, HD, kG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DL::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long nspans = decode_spans(slots, HD);
  if (nspans > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long parts = (long long)B * KV * nspans * (H / KV);
  float* part_m = scratch;
  float* part_l = part_m + parts;
  float* part_acc = part_l + parts;
  decode_span_kernel<T, HD, kG>
      <<<dim3(static_cast<unsigned>(nspans), KV, B), DL::kThreadsD, DL::kBytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
          part_m, part_l, part_acc, H, KV, slots, static_cast<int>(nspans), qs, ks, vs, mask,
          scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / KV;
  const size_t merge_smem = ((size_t)2 * G * nspans + G) * sizeof(float);
  if (merge_smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidConfiguration);
  decode_merge_kernel<T>
      <<<dim3(KV, B, (G * HD + kMergeThreads - 1) / kMergeThreads), kMergeThreads,
         merge_smem, stream>>>(part_m, part_l, part_acc, static_cast<T*>(out), H, KV, HD,
                               static_cast<int>(nspans), os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kG>
int launch_decode_hd(int hd, const void* q, const void* k, const void* v, void* out,
                     const long long* pos, float* scratch, int B, int H, int KV,
                     long long slots, Strides qs, Strides ks, Strides vs, Strides os,
                     Mask mask, float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch_decode<T, 32, kG>(q, k, v, out, pos, scratch, B, H, KV, slots, qs, ks,
                                      vs, os, mask, scale, s);
    case 64:
      return launch_decode<T, 64, kG>(q, k, v, out, pos, scratch, B, H, KV, slots, qs, ks,
                                      vs, os, mask, scale, s);
    case 128:
      return launch_decode<T, 128, kG>(q, k, v, out, pos, scratch, B, H, KV, slots, qs, ks,
                                       vs, os, mask, scale, s);
    case 256:
      return launch_decode<T, 256, kG>(q, k, v, out, pos, scratch, B, H, KV, slots, qs, ks,
                                       vs, os, mask, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_prefill_hd(int hd, const void* q, const void* k, const void* v, void* out, int B,
                      int H, int KV, long long nq, long long nkeys, Strides qs, Strides ks,
                      Strides vs, Strides os, Mask mask, float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch_prefill<T, 32>(q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs, os, mask,
                                   scale, s);
    case 64:
      return launch_prefill<T, 64>(q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs, os, mask,
                                   scale, s);
    case 128:
      return launch_prefill<T, 128>(q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs, os, mask,
                                    scale, s);
    case 256:
      return launch_prefill<T, 256>(q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs, os, mask,
                                    scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Mask make_mask(int causal, int has_window, long long window, int has_chunk,
               long long chunk) {
  Mask m;
  m.causal = causal;
  m.has_window = has_window;
  m.window = window;
  m.has_chunk = has_chunk;
  m.chunk = chunk;
  return m;
}

}  // namespace

// Prefill form.  dtype: 0 = fp32 q, k, v and out, 1 = bf16.  Strides in
// elements, (batch, head, sequence) for each of q, k, v and out.  window and
// chunk are read where has_window / has_chunk; chunk must be > 0.  Returns a
// cudaError_t as int (0 = launched).
extern "C" int flash_prefill_launch(int dtype, int hd, const void* q, const void* k,
                                    const void* v, void* out, int B, int H, int KV,
                                    long long Sq, long long Sk, long long qsb,
                                    long long qsh, long long qss, long long ksb,
                                    long long ksh, long long kss, long long vsb,
                                    long long vsh, long long vss, long long osb,
                                    long long osh, long long oss, int causal,
                                    int has_window, long long window, int has_chunk,
                                    long long chunk, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Sk <= 0 || B > 65535 ||
      KV > 65535 || (has_chunk && chunk <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  const Mask m = make_mask(causal, has_window, window, has_chunk, chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_prefill_hd<float>(hd, q, k, v, out, B, H, KV, Sq, Sk, qs, ks, vs, os, m,
                                    scale, s);
  }
  if (dtype == 1) {
    return launch_prefill_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, KV, Sq, Sk, qs, ks, vs,
                                            os, m, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Floats of fp32 scratch the decode form needs: (m, l, acc) of every span
// of every (batch row, q head).
extern "C" long long flash_decode_scratch_floats(int B, int H, long long slots, int hd) {
  return (long long)B * H * decode_spans(slots, hd) * (hd + 2);
}

// Decode form.  q and out (B, H, hd) with strides (batch, head); the caches
// (B, slots, KV, hd) with strides (batch, head, slot); pos (B,) int64 on
// the device; scratch holds flash_decode_scratch_floats floats.  H / KV must
// be at most 8.  Launches the span kernel, then the merge.  Returns a
// cudaError_t as int.
extern "C" int flash_decode_launch(int dtype, int hd, const void* q, const void* kc,
                                   const void* vc, void* out, const void* pos, void* scratch,
                                   int B, int H, int KV, long long slots, long long qsb,
                                   long long qsh, long long ksb, long long ksh,
                                   long long kss, long long vsb, long long vsh,
                                   long long vss, long long osb, long long osh,
                                   int causal, int has_window, long long window,
                                   int has_chunk, long long chunk, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || H / KV > kDecodeGroupMax || slots <= 0 ||
      B > 65535 || KV > 65535 || (has_chunk && chunk <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{qsb, qsh, 0}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, 0};
  const Mask m = make_mask(causal, has_window, window, has_chunk, chunk);
  const long long* p = static_cast<const long long*>(pos);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = H / KV <= 4;
  if (dtype == 0) {
    return small ? launch_decode_hd<float, 4>(hd, q, kc, vc, out, p, sc, B, H, KV, slots, qs,
                                              ks, vs, os, m, scale, s)
                 : launch_decode_hd<float, 8>(hd, q, kc, vc, out, p, sc, B, H, KV, slots, qs,
                                              ks, vs, os, m, scale, s);
  }
  if (dtype == 1) {
    return small ? launch_decode_hd<__nv_bfloat16, 4>(hd, q, kc, vc, out, p, sc, B, H, KV,
                                                      slots, qs, ks, vs, os, m, scale, s)
                 : launch_decode_hd<__nv_bfloat16, 8>(hd, q, kc, vc, out, p, sc, B, H, KV,
                                                      slots, qs, ks, vs, os, m, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
