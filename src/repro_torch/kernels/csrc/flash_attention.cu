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
// bound it: 2 * slots * hd * 2 bytes a (row, kv head) in bf16.
//
// How the design meets it (a simple first kernel; PERF.md has its times):
//   * prefill: one block of 256 threads per (64 rows, kv head, b), a row
//     being a (query, q head of the group) pair, so GQA groups of any size
//     share each K/V tile; Q stays in shared memory as fp32, K and V tiles
//     of 32 keys are loaded (converted to fp32) once per block;
//   * decode: one block per (kv head, b) with the group's q heads as its
//     (up to 8) rows, tiles of 32 slots;
//   * scores: register micro-tiles (2 x 4 in prefill, 1 x 1 in decode) of
//     float4 loads from shared memory, rows padded by 4 floats so that the
//     loads of a quarter-warp fall on distinct banks; p . V: each thread
//     holds 4 dims of its rows' accumulators in registers.
//
// q, k, v and out are read through strides (the layer's (B, S, H, hd)
// layout is read in place); the head dimension is contiguous, every other
// stride a multiple of 4 elements and every base 16-byte aligned (the
// wrapper checks).  hd is 32, 64, 128 or 256.  The C launchers take
// PyTorch's current stream, allocate nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;           // keys (slots) of a tile, from key 0
constexpr int kPS = kTile + 1;      // row stride of the score tile, in floats
constexpr int kPrefillRows = 64;    // (query, head) rows of a prefill block
constexpr int kDecodeRows = 8;      // q heads of a group a decode block holds
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

// Key j of nkeys for a query at pq: prefill keys sit at j; decode slot j
// holds the most recent position = j (mod nkeys) that is <= pq, and is
// empty where that is negative.
template <bool kDecode>
__device__ __forceinline__ bool key_ok(long long pq, long long j, long long nkeys,
                                       const Mask& m) {
  if (j >= nkeys) return false;
  long long pk = j;
  if (kDecode) {
    long long d = (pq - j) % nkeys;
    if (d < 0) d += nkeys;
    pk = pq - d;
    if (pk < 0) return false;
  }
  return admitted(pq, pk, m);
}

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
// row.  Prefill: grid (ceil(Sq * G / kRows), KV, B), row r of block x is
// (query (x * kRows + r) / G, head (x * kRows + r) % G of the group).
// Decode: grid (1, KV, B), row r is head r of the group, its query at
// pos[b].  nq = Sq (prefill) or 1; nkeys = Sk or slots.
template <typename T, int HD, int kRows, bool kDecode>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, const long long* __restrict__ pos, int H, int KV,
             long long nq, long long nkeys, Strides qs, Strides ks, Strides vs,
             Strides os, Mask mask, float scale) {
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
  const long long rows = kDecode ? (long long)G : nq * G;
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long qpos0 = kDecode ? pos[b] : nkeys - nq;   // position of query 0
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
    pq[i] = qpos0 + (kDecode || !row_ok[i] ? 0 : rg / G);
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
        any |= row_ok[i] && key_ok<kDecode>(pq[i], k0 + tc + j * L::kColLanes, nkeys, mask);
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
        const bool ok = row_ok[i] && key_ok<kDecode>(pq[i], k0 + c, nkeys, mask);
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

template <typename T, int HD, int kRows, bool kDecode>
int launch(const void* q, const void* k, const void* v, void* out, const long long* pos,
           int B, int H, int KV, long long nq, long long nkeys, Strides qs, Strides ks,
           Strides vs, Strides os, Mask mask, float scale, cudaStream_t stream) {
  using L = Layout<kRows, HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD, kRows, kDecode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long rows = kDecode ? (long long)(H / KV) : nq * (H / KV);
  const long long blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), KV, B);
  flash_kernel<T, HD, kRows, kDecode><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), pos, H, KV, nq, nkeys, qs, ks, vs, os, mask, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kRows, bool kDecode>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              const long long* pos, int B, int H, int KV, long long nq, long long nkeys,
              Strides qs, Strides ks, Strides vs, Strides os, Mask mask, float scale,
              cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32, kRows, kDecode>(q, k, v, out, pos, B, H, KV, nq, nkeys, qs, ks,
                                           vs, os, mask, scale, s);
    case 64:
      return launch<T, 64, kRows, kDecode>(q, k, v, out, pos, B, H, KV, nq, nkeys, qs, ks,
                                           vs, os, mask, scale, s);
    case 128:
      return launch<T, 128, kRows, kDecode>(q, k, v, out, pos, B, H, KV, nq, nkeys, qs, ks,
                                            vs, os, mask, scale, s);
    case 256:
      return launch<T, 256, kRows, kDecode>(q, k, v, out, pos, B, H, KV, nq, nkeys, qs, ks,
                                            vs, os, mask, scale, s);
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
    return launch_hd<float, kPrefillRows, false>(hd, q, k, v, out, nullptr, B, H, KV, Sq,
                                                 Sk, qs, ks, vs, os, m, scale, s);
  }
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16, kPrefillRows, false>(hd, q, k, v, out, nullptr, B, H,
                                                         KV, Sq, Sk, qs, ks, vs, os, m,
                                                         scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Decode form.  q and out (B, H, hd) with strides (batch, head); the caches
// (B, slots, KV, hd) with strides (batch, head, slot); pos (B,) int64 on
// the device.  H / KV must be at most 8.  Returns a cudaError_t as int.
extern "C" int flash_decode_launch(int dtype, int hd, const void* q, const void* kc,
                                   const void* vc, void* out, const void* pos, int B,
                                   int H, int KV, long long slots, long long qsb,
                                   long long qsh, long long ksb, long long ksh,
                                   long long kss, long long vsb, long long vsh,
                                   long long vss, long long osb, long long osh,
                                   int causal, int has_window, long long window,
                                   int has_chunk, long long chunk, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || H / KV > kDecodeRows || slots <= 0 ||
      B > 65535 || KV > 65535 || (has_chunk && chunk <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{qsb, qsh, 0}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, 0};
  const Mask m = make_mask(causal, has_window, window, has_chunk, chunk);
  const long long* p = static_cast<const long long*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_hd<float, kDecodeRows, true>(hd, q, kc, vc, out, p, B, H, KV, 1, slots,
                                               qs, ks, vs, os, m, scale, s);
  }
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16, kDecodeRows, true>(hd, q, kc, vc, out, p, B, H, KV, 1,
                                                       slots, qs, ks, vs, os, m, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
