// Mamba-2 SSD chunk scan for Hopper (sm_90a), the chunked dual form of
// arXiv:2405.21060 in IEEE fp32.  For each (batch b, head h) and each chunk
// c of L steps, with cum the running (inclusive) sum of log_a over the chunk
// and cl its last value:
//   y[t]      = sum_{s <= t} (C_t . B_s) * exp(min(cum_t - cum_s, 0)) * dx[s]
//             + exp(cum_t) * (C_t . h_c)           (h_c: the (P, N) state
//                                                    entering the chunk)
//   h_{c + 1} = h_c * exp(cl) + S_c,   S_c = sum_s exp(cl - cum_s) * dx[s] (x) B_s
// with h_0 = h0 (or zeros), and h_final the state after the last chunk.
//
// Replaces the Pallas TPU kernel ssd_chunk_scan of src/repro/kernels/ssd_scan.py
// (pallas_call at :105, _ssd_kernel at :34; oracle ssd_chunk_scan_ref in ref.py).
//
// What bounds it on this card (H100 SXM: 67 TFLOP/s fp32 outside the tensor
// cores, 3.35 TB/s): C.B^T on the causal triangle, 2*N*L*(L+1)/2 operations
// per (b, chunk) (B and C have no head axis), and per head and chunk the
// masked product with dx (2*P*L*(L+1)/2), the chunk's state (2*L*P*N) and
// the carried state's term (2*L*P*N), on L*(P + 2N + 1) inputs: at the
// served shapes (P = 64, N = 128, L = 256 .. ~1000) the fp32 operations
// bound it, ~0.06 ms at (1, 80, 1024), L = 256, ~0.11 ms at one chunk of
// 956.  No tensor cores: the operands (B, C from fp32 projections, dx = dt*x
// formed in fp32) are fp32, TF32 is barred, and an exact fp32 product
// through bf16 mma takes 9 products (989/9 ~ 110 TFLOP/s before overhead,
// against 67 on the SIMT pipe), so the design feeds the SIMT pipe instead.
//
// How the design meets it: four kernels, launched in this order on the
// caller's stream, each parallel over what is independent in the dual form
// (a first version walked one (b, h) a block with its chunks in order: 80
// blocks on 132 SMs, and C.B^T once per head).
//   1. ssd_cum_kernel, a block per (b, chunk, 8 heads): cum, a running fp32
//      sum in index order (the order of its definition, which the served
//      decays, |cum| ~ 1e4 over a chunk, make matter).  log_a is read through
//      its strides by cp.async, 512 steps at a time into a ring of two
//      buffers; one lane per head adds them in order, 16 loads ahead.  cum
//      goes to scratch (B, H, S).
//   2. ssd_state_kernel, a block per (b, h, chunk, part of 128 steps): the
//      part's share of the chunk's state from zero, S_c^T[n][p] =
//      sum_s B_s[n] * (exp(cl - cum_s) * dx_s[p]), dx scaled in shared memory
//      first.  Parts give one chunk of ~1000 steps 8 blocks a head.  The
//      grid's last blocks are independent work that fills its last wave: the
//      C.B^T tiles, a block per (b, chunk, t-tile, s-tile <= t-tile) of
//      64 x 64, summed over n in order once for all heads and stored as G^T
//      tiles, and each t-tile's C^T, in scratch the heads read from L2.
//   3. ssd_pass_kernel, a thread per 4 entries of (N, P) of a (b, h): the
//      sequential pass over chunks, S_c = the chunk's parts summed in part
//      order, h_{c+1} = h_c * exp(cl) + S_c; it writes each h_c^T to scratch
//      (B, H, S/L, N, P rounded up to 4) and h_final.
//   4. ssd_out_kernel, a block per (b, h, chunk, 64-row t-tile), issued by
//      t-tile with the last first, so the short tiles fill in behind the long
//      ones: exp(cum_t) * (C_t . h_c) (none in the first chunk without h0),
//      then for each s-tile up to the diagonal the G^T tile decayed and
//      masked in place in shared memory and multiplied into the output tile.
//      On the diagonal tile a warp stops at its own last row.
// Feeding the SIMT pipe: every tile moves as 16-byte cp.async copies into a
// ring of two stages (the next tile lands while this one is multiplied).
// The products are outer products over rows of k, an 8 x 8 register tile a
// thread from four 16-byte loads a step (a quarter-warp shares the A
// address and reads 8 consecutive chunks of B); the block's four (out) or
// two (state) groups of threads each take a quarter or half of every tile's
// rows, and their partial tiles are summed in group order at the end.  So
// that every operand is k-major, C.B^T is stored transposed and the states
// as [n][p]: nothing is transposed on the way to shared memory.  Tiles a
// decay or weight pass walks down a column of have rows padded to 68 floats
// (conflict-free); the C and B tiles of C.B^T, read along n by rows 4 apart,
// use an XOR swizzle of their 16-byte chunks.  256 threads a block, <= 128
// registers and <= 101 KB of shared memory keep two blocks on each SM.
// What is left (PERF.md): the products run at ~40 % of the fp32 rate.  An
// 8 x 8 tile reads as many bytes from shared memory per step as its fmas
// take cycles, and the decay pass's expf and the tiles' copies add to that
// traffic, so shared memory, not the FMA pipe, is the limit.
//
// Workspace: cum (B*H*S floats), and per chunk its G^T and C^T tiles and,
// per head, its parts' states and the state entering it, stored at their
// real (N, P) (P rounded up to 4): ~33 MB at (1, 80, 1024), L = 256.  At
// small L that is ~S/L states a head, so the launcher runs the four stages
// over segments of chunks, as many as a workspace bound allows (the wrapper
// passes it; every served shape is one segment), each segment entering with
// the state the last one left in hout.  Nothing is summed across a segment
// boundary but that state, so the result does not depend on the segments.
//
// Order: every sum runs in an order fixed by (L, P, N) and the tile alone,
// never by B, H, S/L or the launch, and there are no atomics, so a (b, h)
// result is bitwise the same alone and inside a batch, and call to call.
// Arithmetic: fmaf / fp32 adds, expf (not __expf), no fast math, no mma.
//
// Ragged L (not a multiple of 64, down to L = 1) is masked: rows and
// columns past the chunk load zeros and store nothing; exp(min(diff, 0))
// clamps as the reference does, and entries above the diagonal are 0.
//
// Operands, fp32: log_a (B, H, S) and dx (B, H, S, P) through their element
// strides (the SSD layer passes transposes of (B, S, H[, P]) tensors), Bm
// and Cm (B, S, N) contiguous, h0 (B, H, P, N) contiguous or null for zeros;
// outputs y (B, H, S, P) and hout (B, H, P, N); a workspace of
// ssd_chunk_scan_workspace(B, H, S, P, N, L, seg) floats for segments of seg
// chunks (ssd_chunk_scan_segment gives seg for a bound).  P <= 64, N <= 128,
// L divides S.  The C launcher takes PyTorch's current stream, allocates nothing and
// returns the first nonzero cudaGetLastError() of its launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows (t) and columns (s) of a tile
constexpr int kLd = kT + 4;     // row stride of the tiles a decay or weight
                                // pass walks down a column of
constexpr int kPMax = 64;
constexpr int kNMax = 128;
constexpr int kTile = kT * kT;          // a G^T tile, floats
constexpr int kState = kPMax * kNMax;   // a padded (P, N) state in shared memory
constexpr int kPart = 128;              // steps of a chunk per state block
constexpr int kCumHeads = 8;            // heads of a cum block, one lane each
constexpr int kCumSteps = 512;          // steps of log_a staged at a time
constexpr int kCumSmem = 2 * kCumSteps * (kCumHeads + 1) * 4;   // 36,864 bytes
static_assert(kCumSmem <= 48 * 1024, "no opt-in needed for the cum kernel");

// out kernel: a slot of the ring holds a decayed G^T tile, a dx tile and
// the s-tile's cum; for the carried term slot 0 holds the C^T tile and slot
// 1 the state h_c^T (128 x 64 each); at the end the slots hold the four
// k-groups' partial outputs.
constexpr int kOffX = kT * kLd;                     // 4352
constexpr int kOffCs = 2 * kT * kLd;                // 8704
constexpr int kSlot = kOffCs + kT;                  // 8768 floats
constexpr int kOutSmem = (2 * kSlot + kT) * 4;      // 70,400 bytes
static_assert(kSlot >= kNMax * kT && 2 * kSlot >= 4 * kTile, "out slots");

// state kernel: a slot holds a dx tile, a B tile and the tile's cum
constexpr int kSOffB = kT * kLd;                    // 4352
constexpr int kSOffW = kSOffB + kT * kNMax;         // 12544
constexpr int kSSlot = kSOffW + kT;                 // 12608 floats
constexpr int kStateSmem = 2 * kSSlot * 4;          // 100,864 bytes
static_assert(2 * kSSlot >= 2 * kState, "state slots");

static_assert(kStateSmem >= 2 * kT * kNMax * 4, "C.B^T tiles in the state kernel");

struct ScanArgs {
  const float* la;
  long long la_s[3];        // element strides of log_a (b, h, s)
  const float* dx;
  long long dx_s[4];        // element strides of dx (b, h, s, p)
  const float* Bm;
  const float* Cm;
  const float* h0;          // null: zeros
  float* y;
  float* hout;
  float* cum;               // scratch (B, H, S)
  // scratch for the segment's C chunks, c its chunk index (chunk c_off + c
  // of the sequence); a state is stored as [n][p], N rows of Pp floats
  float* G;                 // (B, C, nTri, 64 s, 64 t): G^T tiles
  float* CT;                // (B, C, nT, N n, 64 t): C^T tiles
  float* parts;             // (B, H, C, nParts, N n, Pp p)
  float* hin;               // (B, H, C, N n, Pp p): h_c^T
  int B, H, S, P, N, L;
  int Pp, st;               // P rounded up to 4, floats of a stored state
  int C, c_off;             // chunks of the segment, its first chunk
  int nT, nTri, nParts;     // 64-row tiles a chunk, tile pairs, parts
  int dx_vec, bc_vec;       // 16-byte copies allowed
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the 16-byte chunk q of row r of a swizzled 128-float tile
__device__ __forceinline__ int swz(int r, int q) { return r * kNMax + 4 * (q ^ ((r >> 2) & 7)); }

// ROWS x W floats from src, element (r, k) at src[r * rs + k * ks], into
// shared memory (row stride ds, or the swizzled 128-float layout); rows
// >= nr and columns >= nk are zero-filled.  vec: ks == 1 and every row start
// 16-byte aligned, so whole 16-byte copies (a partial chunk reads only its
// valid bytes).  base: any valid address, the source of empty copies.
template <int ROWS, int W, bool SWZ>
__device__ __forceinline__ void load_tile(float* dst, int ds, const float* src, long long rs,
                                          long long ks, int nr, int nk, bool vec,
                                          const float* base) {
  constexpr int Q = W / 4;
  for (int e = threadIdx.x; e < ROWS * Q; e += kThreads) {
    const int r = e / Q, q = e % Q;
    float* d = SWZ ? dst + swz(r, q) : dst + r * ds + 4 * q;
    const int n = r < nr ? min(max(nk - 4 * q, 0), 4) : 0;
    if (vec) {
      cp_async16(d, n > 0 ? src + r * rs + 4 * q : base, 4 * n);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cp_async4(d + k, k < n ? src + r * rs + (4 * q + k) * ks : base, k < n ? 4 : 0);
      }
    }
  }
}

// acc[i][j] += A[k][ra + i] * B[k][cb + j'] over k in [k0, k1), in order,
// with j' = j for j < 4 and 28 + j after: the outer-product form, an 8 x 8
// register tile from four 16-byte loads a step.  A quarter-warp shares ra
// (one broadcast address) and reads 8 consecutive chunks of B.
__device__ __forceinline__ void fma_tile(float (&acc)[8][8], const float* A, int lda, int ra,
                                         const float* B, int ldb, int cb, int k0, int k1) {
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const float4 a0 = ld4(A + k * lda + ra), a1 = ld4(A + k * lda + ra + 4);
    const float4 b0 = ld4(B + k * ldb + cb), b1 = ld4(B + k * ldb + cb + 32);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// a group's 8 x 8 tile into red[g] (rows of 64 floats)
__device__ __forceinline__ void stash(float* red, const float (&acc)[8][8], int ra, int cb) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    st4(red + (ra + i) * 64 + cb, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    st4(red + (ra + i) * 64 + cb + 32, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

// ---------------------------------------------------------------- stage 1 --
// grid B * C * ceil(H / kCumHeads); block 128 threads; dynamic shared memory
// kCumSmem
__global__ void __launch_bounds__(128)
ssd_cum_kernel(const ScanArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int ld = kCumHeads + 1;
  const int groups = (a.H + kCumHeads - 1) / kCumHeads;
  const int g = blockIdx.x % groups, c = (blockIdx.x / groups) % a.C,
            b = blockIdx.x / (groups * a.C);
  const int hb = g * kCumHeads, nh = min(kCumHeads, a.H - hb), c0 = (a.c_off + c) * a.L;
  const int tid = threadIdx.x;
  const float* la = a.la + b * a.la_s[0] + hb * a.la_s[1] + c0 * a.la_s[2];
  const int pieces = (a.L + kCumSteps - 1) / kCumSteps;

  auto load = [&](int piece) {
    float* buf = smem + (piece & 1) * kCumSteps * ld;
    const int base = piece * kCumSteps, len = min(kCumSteps, a.L - base);
    for (int e = tid; e < len * kCumHeads; e += 128) {
      const int i = e / kCumHeads, hh = e % kCumHeads;
      cp_async4(buf + i * ld + hh, hh < nh ? la + hh * a.la_s[1] + (base + i) * a.la_s[2] : a.la,
                hh < nh ? 4 : 0);
    }
    cp_async_commit();
  };

  float run = 0.f;                     // lane hh's carry
  load(0);
  for (int k = 0; k < pieces; ++k) {
    if (k + 1 < pieces) {
      load(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* buf = smem + (k & 1) * kCumSteps * ld;
    const int base = k * kCumSteps, len = min(kCumSteps, a.L - base);
    if (tid < kCumHeads) {             // 16 steps at a time: loads first, then
      float* col = buf + tid;          // the adds in order
      int i = 0;
      for (; i + 16 <= len; i += 16) {
        float v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = col[(i + j) * ld];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          run += v[j];
          v[j] = run;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) col[(i + j) * ld] = v[j];
      }
      for (; i < len; ++i) {
        run += col[i * ld];
        col[i * ld] = run;
      }
    }
    __syncthreads();
    for (int e = tid; e < nh * len; e += 128) {
      const int hh = e / len, i = e % len;
      a.cum[((long long)b * a.H + hb + hh) * a.S + c0 + base + i] = buf[i * ld + hh];
    }
    __syncthreads();                   // before piece k + 2 lands in this buffer
  }
}

// --------------------------------------------------------- C.B^T, in stage 2 --
// C.B^T tile pair number idx of B * C * nTri (a block of the state kernel)
__device__ __forceinline__ void cb_tile(const ScanArgs& a, float* smem, int idx) {
  float* Cs = smem;
  float* Bs = Cs + kT * kNMax;
  const int tile = idx % a.nTri, bc = idx / a.nTri;
  const int b = bc / a.C, c0 = (a.c_off + bc % a.C) * a.L;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int si = tile - ti * (ti + 1) / 2;
  const int t0 = ti * kT, s0 = si * kT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const long long row = (long long)b * a.S + c0;
  load_tile<kT, kNMax, true>(Cs, 0, a.Cm + (row + t0) * a.N, a.N, 1, min(kT, a.L - t0), a.N,
                             a.bc_vec, a.Cm);
  load_tile<kT, kNMax, true>(Bs, 0, a.Bm + (row + s0) * a.N, a.N, 1, min(kT, a.L - s0), a.N,
                             a.bc_vec, a.Bm);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // G[t][s], t = ty*4 + i, s = tx*4 + j, summed over n in order
  float acc[4][4] = {};
  const int nq = (a.N + 3) / 4;
  for (int q = 0; q < nq; ++q) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = ld4(Cs + swz(ty * 4 + i, q));
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(Bs + swz(tx * 4 + j, q));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(cv[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(cv[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(cv[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(cv[i].w, bv[j].w, acc[i][j]);
      }
  }
  float* g = a.G + ((long long)bc * a.nTri + tile) * kTile;     // stored as G^T
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    st4(g + (tx * 4 + j) * kT + ty * 4, make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]));
  }
  if (si == ti) {                      // the t-tile's C^T, for the carried term
    float* ct = a.CT + ((long long)bc * a.nT + ti) * a.N * kT;
    for (int e = tid; e < a.N * kT / 4; e += kThreads) {
      const int n = e / (kT / 4), t = (e % (kT / 4)) * 4, q = n >> 2, r = n & 3;
      st4(ct + n * kT + t, make_float4(Cs[swz(t, q) + r], Cs[swz(t + 1, q) + r],
                                       Cs[swz(t + 2, q) + r], Cs[swz(t + 3, q) + r]));
    }
  }
}

// ---------------------------------------------------------------- stage 2 --
// grid B * H * C * nParts chunk-state blocks, then B * C * nTri C.B^T blocks
// (independent work that fills the last wave); block kThreads; dynamic
// shared memory kStateSmem
__global__ void __launch_bounds__(kThreads, 2)
ssd_state_kernel(const ScanArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int states = a.B * a.H * a.C * a.nParts;
  if (static_cast<int>(blockIdx.x) >= states) {
    cb_tile(a, smem, blockIdx.x - states);
    return;
  }
  const int part = blockIdx.x % a.nParts;
  const int c = (blockIdx.x / a.nParts) % a.C;
  const long long bh = blockIdx.x / (a.nParts * a.C);
  const int b = static_cast<int>(bh / a.H), h = static_cast<int>(bh % a.H);
  const int c0 = (a.c_off + c) * a.L, sb = part * kPart, se = min(a.L, sb + kPart);
  const int tiles = (se - sb + kT - 1) / kT;
  const int tid = threadIdx.x;
  // two groups of 128 threads split each tile's steps; a thread's 8 x 8
  // tile is n = ra .. +7, p = cb .. +3 and cb + 32 .. +35
  const int grp = tid / 128, ra = 8 * ((tid % 128) / 8), cb = 4 * (tid % 8);
  const float* cum_r = a.cum + bh * a.S + c0;
  const float cl = cum_r[a.L - 1];
  const float* dx_r = a.dx + b * a.dx_s[0] + h * a.dx_s[1];

  auto load = [&](int k) {
    float* st = smem + (k & 1) * kSSlot;
    const int s0 = sb + k * kT, ns = min(kT, se - s0);
    load_tile<kT, kPMax, false>(st, kLd, dx_r + (c0 + s0) * a.dx_s[2], a.dx_s[2], a.dx_s[3], ns,
                                a.P, a.dx_vec, a.dx);
    load_tile<kT, kNMax, false>(st + kSOffB, kNMax, a.Bm + ((long long)b * a.S + c0 + s0) * a.N,
                                a.N, 1, ns, a.N, a.bc_vec, a.Bm);
    for (int s = tid; s < kT; s += kThreads) {
      cp_async4(st + kSOffW + s, s < ns ? cum_r + s0 + s : a.cum, s < ns ? 4 : 0);
    }
    cp_async_commit();
  };

  float acc[8][8] = {};
  load(0);
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) {
      load(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* X = smem + (k & 1) * kSSlot;
    const int ns = min(kT, se - (sb + k * kT));
    {  // dx[s] *= exp(cl - cum_s): row s = tid % 64, 16 columns a thread
      const int s = tid % kT, p0 = (tid / kT) * 16;
      const float w = s < ns ? expf(cl - X[kSOffW + s]) : 0.f;
#pragma unroll
      for (int q = 0; q < 16; q += 4) {
        const float4 d = ld4(X + s * kLd + p0 + q);
        st4(X + s * kLd + p0 + q, make_float4(w * d.x, w * d.y, w * d.z, w * d.w));
      }
    }
    __syncthreads();
    fma_tile(acc, X + kSOffB, kNMax, ra, X, kLd, cb, 32 * grp, min(32 * grp + 32, ns));
    __syncthreads();                   // before tile k + 2 lands in this slot
  }
  // S^T = the two groups' sums, group 0 first
  float* red = smem;
  stash(red + grp * kState, acc, ra, cb);
  __syncthreads();
  float* out = a.parts + ((bh * a.C + c) * a.nParts + part) * a.st;
  const int pq = a.Pp / 4;
  for (int e = tid; e < a.N * pq; e += kThreads) {
    const int n = e / pq, p = 4 * (e % pq);
    st4(out + n * a.Pp + p, add4(ld4(red + n * kPMax + p), ld4(red + kState + n * kPMax + p)));
  }
}

// ---------------------------------------------------------------- stage 3 --
// grid B * H * pass_blocks(st); block kThreads
__host__ __device__ __forceinline__ int pass_blocks(int st) {
  return (st / 4 + kThreads - 1) / kThreads;
}

__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(const ScanArgs a) {
  const int blocks = pass_blocks(a.st);
  const long long bh = blockIdx.x / blocks;
  const int e = (blockIdx.x % blocks) * kThreads + threadIdx.x;
  if (e >= a.st / 4) return;
  const int n = e / (a.Pp / 4), p = (e % (a.Pp / 4)) * 4;     // h^T[n][p .. p + 3]
  const int off = n * a.Pp + p;
  const long long hcol = bh * a.P * a.N + n;                   // h0[b, h, ., n]

  float hv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hv[k] = a.h0 != nullptr && p + k < a.P ? a.h0[hcol + (long long)(p + k) * a.N] : 0.f;
  }
  auto chunk_state = [&](int c) {    // S_c^T: the parts summed in part order
    const float* src = a.parts + (bh * a.C + c) * a.nParts * a.st + off;
    float4 s = ld4(src);
    for (int q = 1; q < a.nParts; ++q) s = add4(s, ld4(src + q * a.st));
    return s;
  };
  float4 next = chunk_state(0);
  for (int c = 0; c < a.C; ++c) {
    const float4 s = next;
    if (c + 1 < a.C) next = chunk_state(c + 1);
    if (c > 0 || a.h0 != nullptr) {
      st4(a.hin + (bh * a.C + c) * a.st + off, make_float4(hv[0], hv[1], hv[2], hv[3]));
    }
    const float d = expf(a.cum[bh * a.S + (long long)(a.c_off + c) * a.L + a.L - 1]);
    hv[0] = hv[0] * d + s.x;
    hv[1] = hv[1] * d + s.y;
    hv[2] = hv[2] * d + s.z;
    hv[3] = hv[3] * d + s.w;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (p + k < a.P) a.hout[hcol + (long long)(p + k) * a.N] = hv[k];
  }
}

// ---------------------------------------------------------------- stage 4 --
// grid B * H * C * nT; block kThreads; dynamic shared memory kOutSmem
__global__ void __launch_bounds__(kThreads, 2)
ssd_out_kernel(const ScanArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* cumt = smem + 2 * kSlot;
  const int per = a.B * a.H * a.C;
  const int ti = a.nT - 1 - static_cast<int>(blockIdx.x / per);   // the longest rows first
  const int rem = blockIdx.x % per;
  const int h = rem % a.H, c = (rem / a.H) % a.C, b = rem / (a.H * a.C);
  const long long bh = (long long)b * a.H + h;
  const int c0 = (a.c_off + c) * a.L, t0 = ti * kT, nt = min(kT, a.L - t0);
  const int tid = threadIdx.x;
  // four groups of 64 threads split each reduction four ways; a thread's
  // 8 x 8 tile is t = ra .. +7, p = cb .. +3 and cb + 32 .. +35, and a
  // warp's rows are 32 * half .. +31
  const int grp = tid / 64, half = (tid % 64) / 32, lane = tid % 32;
  const int ra = 32 * half + 8 * (lane / 8), cb = 4 * (lane % 8);
  const float* cum_r = a.cum + bh * a.S + c0;
  for (int t = tid; t < kT; t += kThreads) cumt[t] = t < nt ? cum_r[t0 + t] : 0.f;

  float acc[8][8] = {};
  if (c > 0 || a.h0 != nullptr) {      // exp(cum_t) * (C_t . h_c), n split four ways
    float* CTs = smem;
    float* HTs = smem + kSlot;
    load_tile<kNMax, kT, false>(CTs, kT, a.CT + (((long long)b * a.C + c) * a.nT + ti) * a.N * kT,
                                kT, 1, a.N, kT, true, a.CT);
    load_tile<kNMax, kPMax, false>(HTs, kPMax, a.hin + (bh * a.C + c) * a.st, a.Pp, 1, a.N,
                                   a.Pp, true, a.hin);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    fma_tile(acc, CTs, kT, ra, HTs, kPMax, cb, 32 * grp, min(32 * grp + 32, a.N));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float et = expf(cumt[ra + i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= et;
    }
    __syncthreads();                   // the slots are the ring's below
  }

  const float* dx_r = a.dx + b * a.dx_s[0] + h * a.dx_s[1];
  const float* g_r =
      a.G + (((long long)b * a.C + c) * a.nTri + ti * (ti + 1) / 2) * kTile;
  auto load = [&](int si) {
    float* st = smem + (si & 1) * kSlot;
    const int s0 = si * kT, ns = min(kT, a.L - s0);
    load_tile<kT, kT, false>(st, kLd, g_r + si * kTile, kT, 1, kT, kT, true, a.G);
    load_tile<kT, kPMax, false>(st + kOffX, kLd, dx_r + (c0 + s0) * a.dx_s[2], a.dx_s[2],
                                a.dx_s[3], ns, a.P, a.dx_vec, a.dx);
    for (int s = tid; s < kT; s += kThreads) {
      cp_async4(st + kOffCs + s, s < ns ? cum_r + s0 + s : a.cum, s < ns ? 4 : 0);
    }
    cp_async_commit();
  };

  load(0);
  for (int si = 0; si <= ti; ++si) {
    if (si < ti) {
      load(si + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* MT = smem + (si & 1) * kSlot;
    const int s0 = si * kT, ns = min(kT, a.L - s0);
    {  // G^T[s][t] -> G * exp(min(cum_t - cum_s, 0)) for s <= t, else 0:
       // row s = tid % 64, 16 columns a thread
      const int s = tid % kT, tb = (tid / kT) * 16;
      const float cs = MT[kOffCs + s];
#pragma unroll
      for (int k = 0; k < 16; k += 4) {
        const float4 g = ld4(MT + s * kLd + tb + k);
        float m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = tb + k + q;
          m[q] = s0 + s <= t0 + t ? at(g, q) * expf(fminf(cumt[t] - cs, 0.f)) : 0.f;
        }
        st4(MT + s * kLd + tb + k, make_float4(m[0], m[1], m[2], m[3]));
      }
    }
    __syncthreads();
    // the group's 16 steps of the tile; columns past the chunk hold zeros,
    // and on the diagonal tile a warp's rows see no column past their last
    int k1 = min(16 * grp + 16, ns);
    if (si == ti) k1 = min(k1, 32 * half + 32);
    fma_tile(acc, MT, kLd, ra, MT + kOffX, kLd, cb, 16 * grp, k1);
    __syncthreads();                   // before s-tile si + 2 lands in this slot
  }

  // y = the four groups' sums, group 0 first
  float* red = smem;
  stash(red + grp * kTile, acc, ra, cb);
  __syncthreads();
  const bool vec = (a.P & 3) == 0;
  for (int e = tid; e < kTile / 4; e += kThreads) {
    const int t = e / (kT / 4), p = (e % (kT / 4)) * 4;
    if (t >= nt || p >= a.P) continue;
    float4 v = ld4(red + 4 * e);
    v = add4(v, ld4(red + kTile + 4 * e));
    v = add4(v, ld4(red + 2 * kTile + 4 * e));
    v = add4(v, ld4(red + 3 * kTile + 4 * e));
    float* yr = a.y + (bh * a.S + c0 + t0 + t) * a.P + p;
    if (vec) {
      st4(yr, v);
    } else {
      for (int j = 0; j < 4 && p + j < a.P; ++j) yr[j] = at(v, j);
    }
  }
}

struct Layout {
  int C, nT, nTri, nParts, Pp, st;
  long long chunk;                           // scratch floats a chunk needs
  long long cum, G, CT, parts, hin;          // offsets into the workspace, floats
};

// the workspace's layout for segments of seg chunks (seg = 0: none yet)
Layout layout(int B, int H, int S, int P, int N, int L, int seg) {
  Layout l;
  l.C = S / L;
  l.nT = (L + kT - 1) / kT;
  l.nTri = l.nT * (l.nT + 1) / 2;
  l.nParts = (L + kPart - 1) / kPart;
  l.Pp = (P + 3) / 4 * 4;
  l.st = N * l.Pp;
  l.chunk = (long long)B * (l.nTri * kTile + l.nT * N * kT) +
            (long long)B * H * (l.nParts + 1) * l.st;
  l.cum = 0;
  l.G = ((long long)B * H * S + 3) / 4 * 4;
  l.CT = l.G + (long long)B * seg * l.nTri * kTile;
  l.parts = l.CT + (long long)B * seg * l.nT * N * kT;
  l.hin = l.parts + (long long)B * H * seg * l.nParts * l.st;
  return l;
}

bool valid(int B, int H, int S, int P, int N, int L) {
  return B > 0 && H > 0 && S > 0 && P > 0 && P <= kPMax && N > 0 && N <= kNMax && L > 0 &&
         S % L == 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Chunks a segment may hold so that its scratch stays within max_floats
// (at least 1, at most S / L); -1 for shapes the kernel does not take.
extern "C" int ssd_chunk_scan_segment(int B, int H, int S, int P, int N, int L,
                                      long long max_floats) {
  if (!valid(B, H, S, P, N, L)) return -1;
  const Layout l = layout(B, H, S, P, N, L, 0);
  const long long fit = (max_floats - l.G) / l.chunk;
  return static_cast<int>(fit < 1 ? 1 : fit > l.C ? l.C : fit);
}

// Floats of the workspace ssd_chunk_scan_launch needs for segments of seg
// chunks; -1 for shapes the kernel does not take.
extern "C" long long ssd_chunk_scan_workspace(int B, int H, int S, int P, int N, int L, int seg) {
  if (!valid(B, H, S, P, N, L) || seg <= 0) return -1;
  const Layout l = layout(B, H, S, P, N, L, seg);
  return l.hin + (long long)B * H * seg * l.st;
}

// Returns a cudaError_t as int (0 = launched).  h0 may be null (zero state).
// la_s and dx_s are element strides; a stride of a dimension of size 1 may
// be passed as 0.  The stages run over the chunks seg at a time (the
// workspace holds one segment's scratch), each segment entering with the
// state the last one left in hout.
extern "C" int ssd_chunk_scan_launch(const void* la, long long la_sb, long long la_sh,
                                     long long la_ss, const void* dx, long long dx_sb,
                                     long long dx_sh, long long dx_ss, long long dx_sp,
                                     const void* Bm, const void* Cm, const void* h0, void* y,
                                     void* hout, void* work, int B, int H, int S, int P, int N,
                                     int L, int seg, void* stream) {
  if (!valid(B, H, S, P, N, L) || seg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(work) || !aligned16(y)) return static_cast<int>(cudaErrorMisalignedAddress);
  const Layout l = layout(B, H, S, P, N, L, seg);
  seg = seg < l.C ? seg : l.C;
  const long long groups = (H + kCumHeads - 1) / kCumHeads;
  const long long grids[] = {(long long)B * seg * groups,
                             (long long)B * H * seg * l.nParts + (long long)B * seg * l.nTri,
                             (long long)B * H * pass_blocks(l.st),
                             (long long)B * H * seg * l.nT};
  for (long long g : grids) {
    if (g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStateSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ssd_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kOutSmem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }

  ScanArgs a;
  float* w = static_cast<float*>(work);
  a.la = static_cast<const float*>(la);
  a.la_s[0] = la_sb, a.la_s[1] = la_sh, a.la_s[2] = la_ss;
  a.dx = static_cast<const float*>(dx);
  a.dx_s[0] = dx_sb, a.dx_s[1] = dx_sh, a.dx_s[2] = dx_ss, a.dx_s[3] = dx_sp;
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.y = static_cast<float*>(y);
  a.hout = static_cast<float*>(hout);
  a.cum = w + l.cum;
  a.G = w + l.G;
  a.CT = w + l.CT;
  a.parts = w + l.parts;
  a.hin = w + l.hin;
  a.B = B, a.H = H, a.S = S, a.P = P, a.N = N, a.L = L;
  a.Pp = l.Pp, a.st = l.st;
  a.nT = l.nT, a.nTri = l.nTri, a.nParts = l.nParts;
  a.dx_vec = dx_sp == 1 && dx_sb % 4 == 0 && dx_sh % 4 == 0 && dx_ss % 4 == 0 && aligned16(dx);
  a.bc_vec = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  for (int c_off = 0; c_off < l.C; c_off += seg) {
    const int C = l.C - c_off < seg ? l.C - c_off : seg;
    a.C = C, a.c_off = c_off;
    a.h0 = c_off == 0 ? static_cast<const float*>(h0) : a.hout;
    ssd_cum_kernel<<<static_cast<unsigned>((long long)B * C * groups), 128, kCumSmem, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ssd_state_kernel<<<static_cast<unsigned>((long long)B * H * C * l.nParts +
                                             (long long)B * C * l.nTri),
                       kThreads, kStateSmem, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ssd_pass_kernel<<<static_cast<unsigned>(grids[2]), kThreads, 0, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ssd_out_kernel<<<static_cast<unsigned>((long long)B * H * C * l.nT), kThreads, kOutSmem,
                     s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
