// Fused nearest-centroid assignment for Hopper (sm_90a):
//   out[p, i] = argmin_c ( ||c||^2 - 2 * x_i . c ),  ties to the lowest index.
//
// Replaces the Pallas TPU kernel kmeans_assign_pallas of
// src/repro/kernels/kmeans_assign.py (pallas_call at :75, _assign_kernel at :37).
//
// What bounds it on this card: at the main path's shapes (d = 4096, k = 50)
// it does 2*k fp32 operations for every element of X it reads, above the
// card's fp32 operations-per-byte line, so it is bound by fp32 operations
// (no tensor cores: fp32 here means IEEE fp32, not TF32).
//
// How the design meets that:
//   * one block owns kBR rows of one partition and computes the (rows x k)
//     scores of its tile as a register-tiled product: X and centroid tiles of
//     depth kBD are staged in shared memory (transposed, so a thread reads its
//     rows and its centroids as float4), each thread accumulates an 8 x 4
//     block of dot products in fp32 registers, and the next depth tile is
//     loaded from device memory into registers while the current one is
//     multiplied;
//   * the epilogue adds ||c||^2 (computed once by the wrapper) and keeps a
//     running (min, first index) per row across centroid tiles of kBK, so any
//     k works, and the (rows x k) scores never reach device memory.  On the
//     TPU the whole (rows, k) score block sat in VMEM scratch; here only one
//     centroid tile's scores exist at a time, in registers.
//
// X is (P, n, d) with element strides (sxp, sxn, 1), fp32 or bf16; C is
// (k, d) fp32 contiguous, cn (k,) fp32; out is (P, n) int32.  Ragged n, d and
// k are masked in the kernel.  The C launcher takes PyTorch's current stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kTM = 8;               // rows per thread
constexpr int kTN = 4;               // centroids per thread
constexpr int kBR = 16 * kTM;        // 128 rows per block
constexpr int kBK = 16 * kTN;        // 64 centroids per tile
constexpr int kBD = 16;              // depth of one shared-memory tile
constexpr int kXLoads = kBR * kBD / kThreads;   // 8
constexpr int kCLoads = kBK * kBD / kThreads;   // 4

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Load the (kBR x kBD) tile of X and the (kBK x kBD) tile of C at depth d0 into
// registers, zero outside the matrix.  Element e of a tile is row e / kBD,
// depth e % kBD, so a warp reads kBD consecutive depths of each of 32 / kBD
// rows (64-byte segments).
template <typename T>
__device__ __forceinline__ void load_tiles(const T* __restrict__ xb, long long sxn,
                                           const float* __restrict__ C, int n, int d,
                                           int k, int r0, int k0, int d0,
                                           float (&xr)[kXLoads], float (&cr)[kCLoads]) {
#pragma unroll
  for (int j = 0; j < kXLoads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int gr = r0 + e / kBD, gc = d0 + e % kBD;
    xr[j] = (gr < n && gc < d) ? to_float(xb[(long long)gr * sxn + gc]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kCLoads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int gk = k0 + e / kBD, gc = d0 + e % kBD;
    cr[j] = (gk < k && gc < d) ? C[(long long)gk * d + gc] : 0.f;
  }
}

// grid (ceil(n / kBR), P); block kThreads; at most 128 registers a thread, so
// two blocks share an SM and one's loads and barriers overlap the other's
// arithmetic.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
assign_kernel(const T* __restrict__ X, long long sxp, long long sxn,
              const float* __restrict__ C, const float* __restrict__ cn,
              int* __restrict__ out, int n, int d, int k) {
  __shared__ __align__(16) float xs[kBD][kBR + 4];
  __shared__ __align__(16) float cs[kBD][kBK + 4];
  const int p = blockIdx.y;
  const int r0 = blockIdx.x * kBR;
  const int tx = threadIdx.x & 15;   // centroids tx*kTN .. +kTN-1 of a tile
  const int ty = threadIdx.x >> 4;   // rows ty*kTM .. +kTM-1 of the block
  const T* xb = X + (long long)p * sxp;

  float best[kTM];
  int best_idx[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    best[i] = INFINITY;
    best_idx[i] = 0;
  }
  float xr[kXLoads], cr[kCLoads];

  for (int k0 = 0; k0 < k; k0 += kBK) {
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    load_tiles(xb, sxn, C, n, d, k, r0, k0, 0, xr, cr);
    for (int d0 = 0; d0 < d; d0 += kBD) {
#pragma unroll
      for (int j = 0; j < kXLoads; ++j) {
        const int e = threadIdx.x + j * kThreads;
        xs[e % kBD][e / kBD] = xr[j];
      }
#pragma unroll
      for (int j = 0; j < kCLoads; ++j) {
        const int e = threadIdx.x + j * kThreads;
        cs[e % kBD][e / kBD] = cr[j];
      }
      __syncthreads();
      if (d0 + kBD < d) load_tiles(xb, sxn, C, n, d, k, r0, k0, d0 + kBD, xr, cr);
#pragma unroll
      for (int dd = 0; dd < kBD; ++dd) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[dd][ty * kTM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[dd][ty * kTM + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[dd][tx * kTN]);
        const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Epilogue of this centroid tile: score, then (min, first index) over the
    // tile's kBK centroids across the 16 lanes that share these rows, then
    // against the running best.  A later tile wins only when strictly lower,
    // because its indices are all higher.
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float v = INFINITY;
      int vi = INT_MAX;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = k0 + tx * kTN + j;
        if (c < k) {
          const float s = cn[c] - 2.f * acc[i][j];
          if (s < v) {
            v = s;
            vi = c;
          }
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {  // stays within the 16-lane half
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, vi, o);
        if (ov < v || (ov == v && oi < vi)) {
          v = ov;
          vi = oi;
        }
      }
      if (v < best[i]) {
        best[i] = v;
        best_idx[i] = vi;
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gr = r0 + ty * kTM + i;
      if (gr < n) out[(long long)p * n + gr] = best_idx[i];
    }
  }
}

}  // namespace

// dtype: 0 = fp32 X, 1 = bf16 X.  Returns a cudaError_t as int (0 = launched).
extern "C" int kmeans_assign_launch(int dtype, const void* X, long long sxp, long long sxn,
                                    const void* C, const void* cn, void* out,
                                    int P, int n, int d, int k, void* stream) {
  const dim3 grid((n + kBR - 1) / kBR, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    assign_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(X), sxp, sxn, static_cast<const float*>(C),
        static_cast<const float*>(cn), static_cast<int*>(out), n, d, k);
  } else if (dtype == 1) {
    assign_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(X), sxp, sxn, static_cast<const float*>(C),
        static_cast<const float*>(cn), static_cast<int*>(out), n, d, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
