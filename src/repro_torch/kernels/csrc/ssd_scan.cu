// Mamba-2 SSD chunk scan for Hopper (sm_90a), the chunked dual form of
// arXiv:2405.21060 in IEEE fp32.  For each (batch b, head h) and each chunk
// of L steps, with cum the running (inclusive) sum of log_a over the chunk:
//   y[t]   = sum_{s <= t} (C_t . B_s) * exp(min(cum_t - cum_s, 0)) * dx[s]
//          + exp(cum_t) * (C_t . h)                       (h: the (P, N) state)
//   h_next = h * exp(cum_{L-1}) + sum_s exp(cum_{L-1} - cum_s) * dx[s] (x) B_s
// and h_final is the state after the last chunk.
//
// Replaces the Pallas TPU kernel ssd_chunk_scan of src/repro/kernels/ssd_scan.py
// (pallas_call at :105, _ssd_kernel at :34; oracle ssd_chunk_scan_ref in ref.py).
//
// What bounds it on this card (H100 SXM: 67 TFLOP/s fp32 outside the tensor
// cores, 3.35 TB/s): per head and chunk it does 2·L²·N + 2·L²·P + 4·L·P·N
// operations on L·(P + 2N + 1) inputs, so at the served shapes (P = 64,
// N = 128, L = 256 .. ~1000) it is bound by fp32 operations, not bytes.  No
// tensor cores: the reference is IEEE fp32 throughout and TF32 is not.
//
// How the design meets it (a first kernel: right and simple, SIMT fp32):
//   * The TPU grid walked (B·H, chunks) with the chunk axis sequential and the
//     state in VMEM scratch.  Here one block of 256 threads owns one (b, h)
//     and walks its chunks in order, with the (P, N) state in shared memory
//     from the first chunk to the last: it never goes to device memory.
//   * The (L, L) score block does not fit on chip (256 KB at L = 256, 4 MB at
//     L = 1000, against 227 KB of shared memory), so the intra-chunk term is
//     tiled: 64-row tiles of t, and for each the 64-column tiles of s up to
//     the diagonal.  A tile of C·Bᵀ is summed over N in registers (4 x 4 a
//     thread), masked and decayed, staged in shared memory, and multiplied
//     into the thread's 4 x 4 block of the (64, P) output tile at once, so
//     no score block is ever stored whole.  Tiles above the diagonal are
//     skipped: they are all masked.
//   * cum is a running fp32 sum in index order, the order of its definition:
//     the block stages the chunk's log_a in shared memory 1024 steps at a
//     time and one thread adds them in order, keeping the carry in a register.
//     It goes to a scratch row in device memory (the wrapper allocates it),
//     so any L works; each tile reads its 64 values back into shared memory.
//   * exp(min(diff, 0)) clamps as the reference does, so masked entries stay
//     finite; entries above the diagonal are set to 0 without an exp.
//   * Ragged L (not a multiple of 64, down to L = 1) is masked: rows and
//     columns past the chunk load zeros and store nothing.
//   * Only B·H blocks run (80 at the served shapes, of 132 SMs), one a
//     multiprocessor (141 KB of shared memory each): splitting a head's
//     chunks across blocks needs a second pass for the state, later work.
//
// Operands, all fp32 contiguous: log_a (B, H, S), dx (B, H, S, P), Bm and Cm
// (B, S, N), h0 (B, H, P, N) or null for zeros; outputs y (B, H, S, P) and
// hout (B, H, P, N); scratch cum (B, H, S).  P <= 64, N <= 128, L divides S.
// The C launcher takes PyTorch's current stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kT = 64;          // rows (t) of an output tile
constexpr int kS = 64;          // columns (s) of a score tile
constexpr int kPMax = 64;
constexpr int kNMax = 128;
constexpr int kPad = kT + 4;    // row stride of the transposed tiles: 16-byte
                                // aligned, and spreads their column writes
constexpr int kScan = 1024;     // log_a steps staged at a time for the scan

// shared memory, in floats
constexpr int kOffH = 0;                            // hT [n][p], kNMax x kPMax
constexpr int kOffC = kOffH + kNMax * kPMax;        // CT [n][t], kNMax x kPad
constexpr int kOffB = kOffC + kNMax * kPad;         // BT [n][s], kNMax x kPad
                                                    //  or Bs [s][n], kS x kNMax
constexpr int kOffM = kOffB + kNMax * kPad;         // Ms [s][t], kS x kPad
constexpr int kOffX = kOffM + kS * kPad;            // dxs [s][p], kS x kPMax
constexpr int kOffCt = kOffX + kS * kPMax;          // cum of the t tile, kT
constexpr int kOffCs = kOffCt + kT;                 // cum of the s tile, kS
constexpr int kOffW = kOffCs + kS;                  // exp(cum_last - cum_s), kS
constexpr int kOffScan = kOffW + kS;                // kScan
constexpr int kSmemFloats = kOffScan + kScan;
constexpr int kSmemBytes = kSmemFloats * 4;         // 141,056 bytes

static_assert(kS * kNMax <= kNMax * kPad, "Bs must fit where BT lives");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// grid (H, B); block kThreads; dynamic shared memory kSmemBytes
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const float* __restrict__ la, const float* __restrict__ dx,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ hout,
           float* cum, int H, int S, int P, int N, int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hT = smem + kOffH;
  float* CT = smem + kOffC;
  float* BT = smem + kOffB;
  float* Ms = smem + kOffM;
  float* dxs = smem + kOffX;
  float* cumt = smem + kOffCt;
  float* cums = smem + kOffCs;
  float* wt = smem + kOffW;
  float* scan = smem + kOffScan;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = (long long)blockIdx.y * H + blockIdx.x;
  const float* la_r = la + bh * S;
  float* cum_r = cum + bh * S;         // written and read back by this block
  const float* dx_r = dx + bh * S * P;
  float* y_r = y + bh * S * P;
  const float* B_r = Bm + (long long)blockIdx.y * S * N;
  const float* C_r = Cm + (long long)blockIdx.y * S * N;

  for (int e = tid; e < kNMax * kPMax; e += kThreads) {
    const int n = e / kPMax, p = e % kPMax;
    hT[e] = (h0 != nullptr && n < N && p < P) ? h0[(bh * P + p) * N + n] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += L) {
    // ---- cum: a running sum in index order, kScan steps at a time ----
    float run = 0.f;                   // thread 0's carry
    for (int base = 0; base < L; base += kScan) {
      const int len = min(kScan, L - base);
      __syncthreads();
      for (int i = tid; i < len; i += kThreads) scan[i] = la_r[c0 + base + i];
      __syncthreads();
      if (tid == 0) {
        for (int i = 0; i < len; ++i) {
          run += scan[i];
          scan[i] = run;
        }
      }
      __syncthreads();
      for (int i = tid; i < len; i += kThreads) cum_r[c0 + base + i] = scan[i];
    }
    __syncthreads();
    const float cl = cum_r[c0 + L - 1];

    // ---- outputs, one 64-row tile of t at a time ----
    for (int t0 = 0; t0 < L; t0 += kT) {
      __syncthreads();
      for (int e = tid; e < kT * N; e += kThreads) {
        const int t = e / N, n = e % N;
        CT[n * kPad + t] = t0 + t < L ? C_r[(long long)(c0 + t0 + t) * N + n] : 0.f;
      }
      for (int t = tid; t < kT; t += kThreads) cumt[t] = t0 + t < L ? cum_r[c0 + t0 + t] : 0.f;
      __syncthreads();

      // inter-chunk term: C_t . h, for the thread's 4 rows x 4 columns of p
      float inter[4][4] = {};
      for (int n = 0; n < N; ++n) {
        const float4 c = ld4(CT + n * kPad + ty * 4);
        const float4 hv = ld4(hT + n * kPMax + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] += at(c, i) * at(hv, j);
      }

      // intra-chunk term over the s tiles up to the diagonal
      float acc[4][4] = {};
      for (int s0 = 0; s0 <= t0; s0 += kS) {
        __syncthreads();
        for (int e = tid; e < kS * N; e += kThreads) {
          const int s = e / N, n = e % N;
          BT[n * kPad + s] = s0 + s < L ? B_r[(long long)(c0 + s0 + s) * N + n] : 0.f;
        }
        for (int e = tid; e < kS * kPMax; e += kThreads) {
          const int s = e / kPMax, p = e % kPMax;
          dxs[e] = (s0 + s < L && p < P) ? dx_r[(long long)(c0 + s0 + s) * P + p] : 0.f;
        }
        for (int s = tid; s < kS; s += kThreads) cums[s] = s0 + s < L ? cum_r[c0 + s0 + s] : 0.f;
        __syncthreads();

        float cb[4][4] = {};
        for (int n = 0; n < N; ++n) {
          const float4 c = ld4(CT + n * kPad + ty * 4);
          const float4 b = ld4(BT + n * kPad + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cb[i][j] += at(c, i) * at(b, j);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx * 4 + j;
          float m[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = ty * 4 + i;
            m[i] = (s0 + s <= t0 + t)
                       ? cb[i][j] * expf(fminf(cumt[t] - cums[s], 0.f))
                       : 0.f;
          }
          *reinterpret_cast<float4*>(Ms + s * kPad + ty * 4) = make_float4(m[0], m[1], m[2], m[3]);
        }
        __syncthreads();
        for (int s = 0; s < kS; ++s) {
          const float4 m = ld4(Ms + s * kPad + ty * 4);
          const float4 d = ld4(dxs + s * kPMax + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += at(m, i) * at(d, j);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        if (t0 + t >= L) continue;
        const float et = expf(cumt[t]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx * 4 + j;
          if (p < P) y_r[(long long)(c0 + t0 + t) * P + p] = acc[i][j] + et * inter[i][j];
        }
      }
    }

    // ---- state: h * exp(cl) + sum_s exp(cl - cum_s) dx_s (x) B_s ----
    // the thread owns p = ty*4 .. +3 and n = tx*8 .. +7
    float hacc[4][8] = {};
    float* Bs = BT;                    // [s][n] now
    for (int s0 = 0; s0 < L; s0 += kS) {
      __syncthreads();
      for (int e = tid; e < kS * N; e += kThreads) {
        const int s = e / N, n = e % N;
        Bs[s * kNMax + n] = s0 + s < L ? B_r[(long long)(c0 + s0 + s) * N + n] : 0.f;
      }
      for (int e = tid; e < kS * kPMax; e += kThreads) {
        const int s = e / kPMax, p = e % kPMax;
        dxs[e] = (s0 + s < L && p < P) ? dx_r[(long long)(c0 + s0 + s) * P + p] : 0.f;
      }
      for (int s = tid; s < kS; s += kThreads) {
        wt[s] = s0 + s < L ? expf(cl - cum_r[c0 + s0 + s]) : 0.f;
      }
      __syncthreads();
      const int ns = min(kS, L - s0);
      for (int s = 0; s < ns; ++s) {
        const float w = wt[s];
        const float4 d = ld4(dxs + s * kPMax + ty * 4);
        const float4 b0 = ld4(Bs + s * kNMax + tx * 8);
        const float4 b1 = ld4(Bs + s * kNMax + tx * 8 + 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wd = w * at(d, i);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hacc[i][j] += wd * at(b0, j);
            hacc[i][j + 4] += wd * at(b1, j);
          }
        }
      }
    }
    const float a = expf(cl);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = ty * 4 + i, n = tx * 8 + j;
        if (p < P && n < N) hT[n * kPMax + p] = hT[n * kPMax + p] * a + hacc[i][j];
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    hout[(bh * P + p) * N + n] = hT[n * kPMax + p];
  }
}

}  // namespace

// Returns a cudaError_t as int (0 = launched).  h0 may be null (zero state).
extern "C" int ssd_chunk_scan_launch(const void* la, const void* dx, const void* Bm,
                                     const void* Cm, const void* h0, void* y, void* hout,
                                     void* cum, int B, int H, int S, int P, int N, int L,
                                     void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0 || P <= 0 || P > kPMax || N <= 0 ||
      N > kNMax || L <= 0 || S % L != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_kernel<<<dim3(H, B), kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(la), static_cast<const float*>(dx),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hout),
      static_cast<float*>(cum), H, S, P, N, L);
  return static_cast<int>(cudaGetLastError());
}
