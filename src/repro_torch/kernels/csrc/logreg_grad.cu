// Fused logistic-regression gradient, g = X^T (sigmoid(X w) - y), for Hopper
// (sm_90a) as two kernels.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/logreg_grad.py:
//   logreg_margin  (pallas_call at :85, _margin_kernel at :40)  z = sigmoid(Xw) - y
//   logreg_xt_z    (pallas_call at :111, _xtz_kernel at :59)    g = X^T z
//
// What bounds them on this card: each reads X once and does two floating-point
// operations per element it reads, far below the card's operations-per-byte
// line, so both are bound by the bytes of X read from device memory.
//
// How the design meets that:
//   * margin: the feature axis is cut into segments of kMarginSeg columns and
//     one block owns kMarginRows rows x one segment of one partition,
//     accumulating in fp32 registers.  Blocks are numbered segment-fastest, so
//     the blocks resident at one time read neighbouring columns of the same
//     few rows, which keeps DRAM page locality; a first form in which one
//     block walked all of d for its rows was markedly slower on the card (see
//     PERF.md).  On the TPU the feature axis was the sequential grid axis with
//     the sum in VMEM scratch; Hopper blocks run in no order, so each block
//     writes its partial sums to scratch, and the last block of a row tile to
//     finish (a ticket per tile) adds the partials in segment order (so the
//     result does not depend on which block finishes last) and writes
//     sigmoid(m) - y: the margin never goes to device memory whole.  Each
//     thread loads w[c] once for all its rows, and the kMarginRows loads of
//     one step are independent, which keeps bytes in flight.
//   * xt_z: one block owns kThreads columns of one partition and walks all the
//     rows of that partition, so each output has one owner and no atomics are
//     needed.  Neighbouring threads read neighbouring columns (coalesced),
//     z is staged through shared memory, and kXtzUnroll independent
//     accumulators per thread keep that many loads in flight.
//
// Both take a leading partition dimension, X (P, n, d) with element strides
// (sxp, sxn, 1), so a column slice of a row-major table (the features after
// the label column) is read in place.  X is fp32 or bf16; accumulation is
// fp32 either way.  Ragged n and d are masked in the kernels: any shape goes.
// The C launchers take PyTorch's current stream, allocate nothing (the margin's
// scratch comes from the wrapper, sized by logreg_margin_scratch) and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
// w is (P, d) with row stride swp, or (d,) shared by all partitions (swp = 0).
// partial holds P * RT * S * kMarginRows floats; tickets P * RT zeros.
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
  if (last && threadIdx.x < nr) {
    __threadfence();
    float m = 0.f;
    for (int t = 0; t < S; ++t) m += __ldcg(&partial[(tile * S + t) * kMarginRows + threadIdx.x]);
    const long long row = (long long)p * n + r0 + threadIdx.x;
    z[row] = 1.f / (1.f + expf(-m)) - y[row];
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

}  // namespace

// Scratch the margin kernel needs for P partitions of n rows and d columns.
extern "C" void logreg_margin_scratch(int P, int n, int d, long long* partial_floats,
                                      long long* tickets) {
  const long long tiles = (long long)P * ((n + kMarginRows - 1) / kMarginRows);
  *partial_floats = tiles * ((d + kMarginSeg - 1) / kMarginSeg) * kMarginRows;
  *tickets = tiles;
}

// dtype: 0 = fp32 X, 1 = bf16 X.  Returns a cudaError_t as int (0 = launched).
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
