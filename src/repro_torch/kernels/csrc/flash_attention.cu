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
//     order fixed by hd and the tile width alone (an fma chain, or a chain
//     of tensor-core products through their accumulator, over the head
//     dimension; over a tile's keys in index order; butterflies whose pairs
//     are fixed);
//   * a tile in which no (row, key) of the block is admitted is skipped;
//     a tile processed for other rows of the block leaves a row with no
//     admitted key in it bitwise unchanged, by the Pallas kernel's guards:
//     p = 0 where s is at NEG_INF, alpha = 0 while m is still NEG_INF and
//     exp(0) = 1 otherwise.  NEG_INF is -2e38, never -INFINITY, which would
//     give inf - inf = NaN.
// Arithmetic: fp32 operands (and the decode form) are IEEE fp32 on the SIMT
// pipe: fmaf, expf (not __expf), no --use_fast_math.  bf16 operands of the
// prefill form go to the tensor cores (flash_mma_kernel), under three
// conditions: every product is exact (bf16 x bf16 is exact in fp32, and
// each fp32 probability enters P . V as three bf16 terms hi + mid + lo,
// which hold its 24 significant bits); the sums are fp32, in the
// accumulator of mma.sync, in an order fixed by hd and the key tile alone;
// no TF32 anywhere.  Softmax, rescaling and the final division stay IEEE
// fp32 (expf, fmaf, div.rn).
//
// What bounds it on this card (H100 SXM: 67 TFLOP/s fp32 outside the tensor
// cores, 989 TFLOP/s bf16 in them, 3.35 TB/s).  Prefill: 4 * hd operations
// per admitted (query, key) pair and head, against q, k, v and out read or
// written once, so at the served lengths the operations bound it: Gemma3's
// global layer over a wave of 8 prompts of ~2,000 tokens is ~63 GFLOP,
// 0.94 ms at the fp32 rate and 0.064 ms at the bf16 tensor-core rate.  The
// three terms of p make the tensor-core kernel do 8 * hd operations a pair
// (2 * hd for Q . K^T, 6 * hd for P . V), so its own floor there is ~0.13
// ms.  Decode: each row reads its valid K/V once for 4 * hd operations a
// (slot, head) pair, so the bytes bound it: 2 * valid slots * hd * 2 bytes
// a (row, kv head) in bf16, 4 us for Gemma3's global layer at 8 rows near
// position 2,048.
//
// How the design meets it (PERF.md has its times):
//   * prefill, fp32 operands (flash_kernel): one block of 256 threads per
//     (64 rows, kv head, b), a row being a (query, q head of the group)
//     pair, so GQA groups of any size share each K/V tile; Q stays in
//     shared memory as fp32, K and V tiles of 32 keys are loaded (converted
//     to fp32) once per block; scores in 2 x 4 register micro-tiles of
//     float4 loads from shared memory, rows padded by 4 floats so that the
//     loads of a quarter-warp fall on distinct banks; p . V: each thread
//     holds 4 dims of its rows' accumulators in registers;
//   * prefill, bf16 operands (flash_mma_kernel): one block of 4 warps per
//     (64 rows, kv head, b), rows as above, each warp owning 16 rows for
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulator).  K and V tiles of 64
//     keys (32 at hd 256) from key 0 travel as 16-byte cp.async copies into
//     a ring of 2 stages in shared memory, in bf16, rows padded by 16 bytes
//     so that ldmatrix (.trans for V) reads 8 rows on 8 distinct bank
//     groups; one barrier a tile, the next tile's copies in flight during
//     this tile's products.  Q is read once into shared memory and, up to
//     hd 128, into registers (at hd 256 the O accumulator alone takes 128
//     registers a thread, so Q is read from shared memory by ldmatrix at
//     each k-step).  S = Q . K^T chains the k16 steps over hd in index
//     order through the accumulator; the masks are one interval of keys a
//     row (causal, window and chunk all bound it), applied on S's fragment
//     by position.  The online softmax runs in registers: a row's values
//     sit in a quad of 4 lanes, max and sum by a fixed in-thread order and
//     a fixed xor butterfly (1, 2).  The S accumulator has the layout of
//     P's A fragment, so P never leaves registers: O is rescaled by alpha
//     (an IEEE fp32 multiply), then each k16 step of keys, in key order, is
//     split into hi, mid and lo bf16 fragments, multiplied with V's in that
//     order of terms into O through the accumulator.  A row with no
//     admitted key in a tile has alpha = 1 and p = 0 there, and a product
//     of zeros leaves the accumulator bitwise as it was, so the tile
//     changes nothing for it (the card's bitwise checks hold this).  A tile
//     with no admitted key for a warp's 16 rows is skipped by that warp,
//     one inside all of them needs no mask; blocks run last rows first, so
//     the longest causal rows start first.
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
// wrapper checks; the bf16 prefill form's operands and the decode form's q
// and caches: every stride a multiple of 16 bytes).  hd is 32, 64, 128 or
// 256.  The C launchers take PyTorch's current stream, allocate nothing
// (the decode form's scratch comes from the wrapper) and return
// cudaGetLastError().

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
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

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
// Prefill form, bf16 operands: tensor cores through mma.sync.m16n8k16
// (bf16 x bf16 -> fp32), one warp a 16-row fragment.
// ------------------------------------------------------------------------

constexpr int kMmaWarps = 4;                     // warps of a block
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = kMmaWarps * 16;         // (query, head) rows of a block
constexpr int kMmaTerms = 3;                     // bf16 terms of p in P . V
constexpr int kMmaStages = 2;                    // K/V tiles in flight

// keys of a tile: 32 at hd 256, where O alone holds 128 registers a thread,
// and 64 below
constexpr int mma_tile_keys(int hd) { return hd >= 256 ? 32 : 64; }

template <int HD>
struct MmaLayout {
  static constexpr int kN = mma_tile_keys(HD);   // keys a tile
  static constexpr int RS = HD + 8;              // shared row stride, bf16 (16 bytes of pad)
  static constexpr int kChunks = HD / 8;         // 16-byte chunks a row
  static constexpr int kSteps = HD / 16;         // k16 steps of Q . K^T
  static constexpr int kNB = kN / 8;             // n8 blocks of S
  static constexpr int kPSteps = kN / 16;        // k16 steps of P . V
  static constexpr int kOB = HD / 8;             // n8 blocks of O
  static constexpr bool kQInRegs = HD <= 128;
  static constexpr int kQ = kMmaRows * RS;       // Q, in bf16 elements
  static constexpr int kStage = 2 * kN * RS;     // a K tile, then a V tile
  static constexpr int kBytes = (kQ + kMmaStages * kStage) * 2;
  static_assert(kNB % 2 == 0 && kOB % 2 == 0, "mma layout");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 address matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d = a . b + d: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x, y) as bf16 pairs hi + mid + lo, each the bf16 rounding of what the
// terms before leave (x - hi and x - hi - mid are exact in fp32)
__device__ __forceinline__ void split_terms(float x, float y, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

// One block: kMmaRows rows of (query, head) against one kv head of one
// batch row, rows as in flash_kernel; grid (ceil(Sq * G / kMmaRows), KV, B),
// the last rows in the first blocks.  Lane l of warp w holds rows
// 16w + l / 4 and 16w + l / 4 + 8 of the block, and of each n8 block of S
// and O the columns 2 (l % 4) and 2 (l % 4) + 1 (the mma fragment layout).
// terms (1 to 3) is kMmaTerms on the served path.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 int H, int KV, int nq, int nkeys, Strides qs, Strides ks, Strides vs,
                 Strides os, Mask mask, float scale, int terms) {
  using L = MmaLayout<HD>;
  constexpr int kN = L::kN, RS = L::RS;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);   // [kMmaRows][RS]
  __nv_bfloat16* Ts = Qs + L::kQ;                                 // stages: K, then V
  __shared__ int block_lo[kMmaWarps], block_hi[kMmaWarps];

  const int G = H / KV;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const long long rows = (long long)nq * G;
  const long long row0 = (long long)(gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const long long qpos0 = (long long)nkeys - nq;   // position of query 0
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;

  // the keys each of this thread's two rows admits: one interval [lo, hi]
  // (causal, window and chunk each bound it), empty as [nkeys, -1]
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long rg = row0 + warp * 16 + gq + 8 * h;
    long long l0 = 0, h0 = (long long)nkeys - 1;
    if (rg < rows) {
      const long long pq = qpos0 + rg / G;
      if (mask.causal) h0 = min(h0, pq);
      if (mask.has_window) l0 = max(l0, pq - mask.window + 1);
      if (mask.has_chunk) {
        const long long c0 = floordiv(pq, mask.chunk) * mask.chunk;
        l0 = max(l0, c0);
        h0 = min(h0, c0 + mask.chunk - 1);
      }
    } else {
      l0 = 1;
      h0 = 0;
    }
    if (l0 > h0) {
      l0 = nkeys;
      h0 = -1;
    }
    lo[h] = static_cast<int>(l0);
    hi[h] = static_cast<int>(h0);
  }
  // the warp's and the block's keys: consecutive rows admit overlapping or
  // adjacent intervals, so their union is [min lo, max hi]
  int wlo = min(lo[0], lo[1]), whi = max(hi[0], hi[1]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, off));
  }
  if (lane == 0) {
    block_lo[warp] = wlo;
    block_hi[warp] = whi;
  }
  __syncthreads();
  int blo = block_lo[0], bhi = block_hi[0];
#pragma unroll
  for (int w = 1; w < kMmaWarps; ++w) {
    blo = min(blo, block_lo[w]);
    bhi = max(bhi, block_hi[w]);
  }
  const int t_first = blo <= bhi ? blo / kN : 0;
  const int t_last = blo <= bhi ? bhi / kN : -1;

  // Q (rows past the last as zeros) and the first tile on their way
  for (int c = t; c < kMmaRows * L::kChunks; c += kMmaThreads) {
    const int r = c / L::kChunks, ch = c % L::kChunks;
    const long long rg = row0 + r;
    const bool in = rg < rows;
    const long long i = in ? rg / G : 0;
    const int g = in ? static_cast<int>(rg % G) : 0;
    cp_async16(Qs + r * RS + ch * 8,
               q + b * qs.b + (long long)(kvh * G + g) * qs.h + i * qs.s + ch * 8, in ? 16 : 0);
  }
  // a tile's copies: this thread takes chunk cp_ch of rows cp_row,
  // cp_row + kRowStep, ... of K and of V (keys past the end as zeros)
  constexpr int kRowStep = kMmaThreads / L::kChunks;
  const int cp_ch = t % L::kChunks, cp_row = t / L::kChunks;
  const __nv_bfloat16* kb = k + b * ks.b + (long long)kvh * ks.h + cp_ch * 8;
  const __nv_bfloat16* vb = v + b * vs.b + (long long)kvh * vs.h + cp_ch * 8;
  auto load_tile = [&](int kt, int stage) {
    __nv_bfloat16* st = Ts + stage * L::kStage + cp_row * RS + cp_ch * 8;
#pragma unroll
    for (int r = 0; r < kN; r += kRowStep) {
      const int key = kt * kN + cp_row + r;
      const bool in = key < nkeys;
      const long long kk = in ? key : 0;
      cp_async16(st + r * RS, kb + kk * ks.s, in ? 16 : 0);
      cp_async16(st + (kN + r) * RS, vb + kk * vs.s, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) {
    if (t_first + i <= t_last) load_tile(t_first + i, i);
    cp_async_commit();   // an empty group past the last tile keeps the count
  }

  float o[L::kOB][4];
#pragma unroll
  for (int n = 0; n < L::kOB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  uint32_t qf[L::kQInRegs ? L::kSteps : 1][4];
  // this lane's row and column in an ldmatrix of Q (A), K (B) and V (B^T)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;
  const __nv_bfloat16* Qw = Qs + (warp * 16 + a_row) * RS + a_col;

  for (int kt = t_first; kt <= t_last; ++kt) {
    const int stage = (kt - t_first) % kMmaStages;
    cp_async_wait<kMmaStages - 2>();   // tile kt has landed (this thread's copies)
    __syncthreads();                   // ... every thread's; tile kt - 1 is done
    if (kt + kMmaStages - 1 <= t_last) {
      load_tile(kt + kMmaStages - 1, (stage + kMmaStages - 1) % kMmaStages);
    }
    cp_async_commit();
    if constexpr (L::kQInRegs) {
      if (kt == t_first) {
#pragma unroll
        for (int s = 0; s < L::kSteps; ++s) ldmatrix_x4(qf[s], smem_addr(Qw + s * 16));
      }
    }
    const int k0 = kt * kN;
    if (k0 > whi || k0 + kN - 1 < wlo) continue;   // no admitted key for the warp
    const __nv_bfloat16* Kt = Ts + stage * L::kStage;
    const __nv_bfloat16* Vt = Kt + kN * RS;

    // S = Q . K^T: the k16 steps over hd in index order, through the
    // accumulator
    float sc[L::kNB][4];
#pragma unroll
    for (int n = 0; n < L::kNB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < L::kSteps; ++s) {
      uint32_t a[4];
      if constexpr (L::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[s][e];
      } else {
        ldmatrix_x4(a, smem_addr(Qw + s * 16));
      }
#pragma unroll
      for (int n = 0; n < L::kNB; n += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(Kt + (n * 8 + k_row) * RS + s * 16 + k_col));
        mma_bf16(sc[n], a, bk[0], bk[1]);
        mma_bf16(sc[n + 1], a, bk[2], bk[3]);
      }
    }

    // scale after the dot, masks by position, online softmax: a row's keys
    // lie in the quad's 4 lanes; in-thread order, then xor 1 and 2
    // (a tile inside every row interval of the warp needs no mask)
    const bool whole = __all_sync(0xffffffffu, lo[0] <= k0 && lo[1] <= k0 &&
                                                   hi[0] >= k0 + kN - 1 && hi[1] >= k0 + kN - 1);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < L::kNB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        if (whole) {
          sc[n][e] *= scale;
        } else {
          const int key = k0 + n * 8 + 2 * tq + (e & 1);
          sc[n][e] = key >= lo[h] && key <= hi[h] ? sc[n][e] * scale : kNegInf;
        }
        mx[h] = fmaxf(mx[h], sc[n][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = m_run[h] > kNegInf * 0.5f ? expf(m_run[h] - m_new) : 0.f;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < L::kNB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = sc[n][e] > kNegInf * 0.5f ? expf(sc[n][e] - m_run[h]) : 0.f;
        sc[n][e] = p;
        sum[h] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = fmaf(alpha[h], l_run[h], sum[h]);
    }

    // P as A fragments straight from S's registers (the C fragments of n8
    // blocks 2j and 2j + 1 are the A fragment of k16 step j), in terms; a
    // term past `terms` is 0, and adds nothing (no branch in the products)
    uint32_t pa[L::kPSteps][kMmaTerms][4];
#pragma unroll
    for (int j = 0; j < L::kPSteps; ++j) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float* c = sc[2 * j + (f >> 1)] + 2 * (f & 1);
        split_terms(c[0], c[1], pa[j][0][f], pa[j][1][f], pa[j][2][f]);
        pa[j][1][f] = terms > 1 ? pa[j][1][f] : 0u;
        pa[j][2][f] = terms > 2 ? pa[j][2][f] : 0u;
      }
    }
    // O = O * alpha + P . V: O rescaled before the tile, then each k16
    // step of keys in key order, its terms hi, mid, lo in that order,
    // through the accumulator
#pragma unroll
    for (int n = 0; n < L::kOB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int j = 0; j < L::kPSteps; ++j) {
#pragma unroll
      for (int n = 0; n < L::kOB; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(Vt + (j * 16 + v_row) * RS + n * 8 + v_col));
#pragma unroll
        for (int u = 0; u < kMmaTerms; ++u) {
          mma_bf16(o[n], pa[j][u], bv[0], bv[1]);
          mma_bf16(o[n + 1], pa[j][u], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // out = O / max(l, 1e-30), as bf16 pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long rg = row0 + warp * 16 + gq + 8 * h;
    if (rg < rows) {
      const float l = fmaxf(l_run[h], 1e-30f);
      const long long i = rg / G;
      const int g = static_cast<int>(rg % G);
      __nv_bfloat16* orow = out + b * os.b + (long long)(kvh * G + g) * os.h + i * os.s;
#pragma unroll
      for (int n = 0; n < L::kOB; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(o[n][2 * h] / l, o[n][2 * h + 1] / l);
      }
    }
  }
}

template <int HD>
int launch_prefill_mma(const void* q, const void* k, const void* v, void* out, int B, int H,
                       int KV, long long nq, long long nkeys, Strides qs, Strides ks,
                       Strides vs, Strides os, Mask mask, float scale, int terms,
                       cudaStream_t stream) {
  using L = MmaLayout<HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // keys and rows as 32-bit ints, with room for a tile past the end
  if (nkeys > 0x7fffffffLL - L::kN || nq > 0x7fffffffLL || terms < 1 || terms > kMmaTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = nq * (H / KV);
  const long long blocks = (rows + kMmaRows - 1) / kMmaRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), KV, B);
  flash_mma_kernel<HD><<<grid, kMmaThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, KV,
      static_cast<int>(nq), static_cast<int>(nkeys), qs, ks, vs, os, mask, scale, terms);
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

// fp32 operands to flash_kernel, bf16 operands to flash_mma_kernel (with p
// in `terms` bf16 terms); no other route
template <int HD>
int launch_prefill_dtype(int dtype, const void* q, const void* k, const void* v, void* out,
                         int B, int H, int KV, long long nq, long long nkeys, Strides qs,
                         Strides ks, Strides vs, Strides os, Mask mask, float scale,
                         int terms, cudaStream_t s) {
  if (dtype == 0) {
    return launch_prefill<float, HD>(q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs, os, mask,
                                     scale, s);
  }
  if (dtype == 1) {
    return launch_prefill_mma<HD>(q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs, os, mask,
                                  scale, terms, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_prefill_hd(int dtype, int hd, const void* q, const void* k, const void* v,
                      void* out, int B, int H, int KV, long long nq, long long nkeys,
                      Strides qs, Strides ks, Strides vs, Strides os, Mask mask, float scale,
                      int terms, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch_prefill_dtype<32>(dtype, q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs,
                                      os, mask, scale, terms, s);
    case 64:
      return launch_prefill_dtype<64>(dtype, q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs,
                                      os, mask, scale, terms, s);
    case 128:
      return launch_prefill_dtype<128>(dtype, q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs,
                                       os, mask, scale, terms, s);
    case 256:
      return launch_prefill_dtype<256>(dtype, q, k, v, out, B, H, KV, nq, nkeys, qs, ks, vs,
                                       os, mask, scale, terms, s);
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

namespace {

int prefill(int dtype, int hd, const void* q, const void* k, const void* v, void* out, int B,
            int H, int KV, long long Sq, long long Sk, long long qsb, long long qsh,
            long long qss, long long ksb, long long ksh, long long kss, long long vsb,
            long long vsh, long long vss, long long osb, long long osh, long long oss,
            int causal, int has_window, long long window, int has_chunk, long long chunk,
            float scale, int terms, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Sk <= 0 || B > 65535 ||
      KV > 65535 || (has_chunk && chunk <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  const Mask m = make_mask(causal, has_window, window, has_chunk, chunk);
  return launch_prefill_hd(dtype, hd, q, k, v, out, B, H, KV, Sq, Sk, qs, ks, vs, os, m, scale,
                           terms, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Prefill form.  dtype: 0 = fp32 q, k, v and out (flash_kernel), 1 = bf16
// (flash_mma_kernel).  Strides in elements, (batch, head, sequence) for
// each of q, k, v and out.  window and chunk are read where has_window /
// has_chunk; chunk must be > 0.  Returns a cudaError_t as int (0 =
// launched).
extern "C" int flash_prefill_launch(int dtype, int hd, const void* q, const void* k,
                                    const void* v, void* out, int B, int H, int KV,
                                    long long Sq, long long Sk, long long qsb,
                                    long long qsh, long long qss, long long ksb,
                                    long long ksh, long long kss, long long vsb,
                                    long long vsh, long long vss, long long osb,
                                    long long osh, long long oss, int causal,
                                    int has_window, long long window, int has_chunk,
                                    long long chunk, float scale, void* stream) {
  return prefill(dtype, hd, q, k, v, out, B, H, KV, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb,
                 vsh, vss, osb, osh, oss, causal, has_window, window, has_chunk, chunk, scale,
                 kMmaTerms, stream);
}

// The bf16 prefill form with p in `terms` (1 to 3) bf16 terms instead of
// three: a reading of that precision choice, on no served path.  Arguments
// as flash_prefill_launch's, without dtype (bf16).
extern "C" int flash_prefill_terms_launch(int terms, int hd, const void* q, const void* k,
                                          const void* v, void* out, int B, int H, int KV,
                                          long long Sq, long long Sk, long long qsb,
                                          long long qsh, long long qss, long long ksb,
                                          long long ksh, long long kss, long long vsb,
                                          long long vsh, long long vss, long long osb,
                                          long long osh, long long oss, int causal,
                                          int has_window, long long window, int has_chunk,
                                          long long chunk, float scale, void* stream) {
  return prefill(1, hd, q, k, v, out, B, H, KV, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
                 vss, osb, osh, oss, causal, has_window, window, has_chunk, chunk, scale, terms,
                 stream);
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
