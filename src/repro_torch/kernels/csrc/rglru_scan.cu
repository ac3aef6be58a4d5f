// The RG-LRU recurrence of a prefill for Hopper (sm_90a):
//
//   h_t = a_t * h_{t-1} + b_t          per (row, channel), t = 0 .. S-1,
//
// in IEEE fp32 from h_{-1} = h0 (zeros when none is given), writing every
// h_t and the final state.
//
// Replaces no TPU kernel: the reference (src/repro/models/layers/rglru.py,
// rglru_apply) takes this recurrence as jax.lax.associative_scan over time,
// left to XLA.  The port needs it on the card because a recurrent block
// prefills each request alone, and a loop of PyTorch launches would cost
// ~2,000 steps x 26 layers a request at RecurrentGemma-9B's prompts.
//
// One order, the decode step's.  Each h_t is __fmul_rn(a_t, h_{t-1}) then
// __fadd_rn(., b_t): two IEEE roundings, never contracted into an FMA.  A
// decode step computes h * exp(log_a) + gated as two PyTorch launches, a
// multiply and an add, so a state this kernel prefills is bitwise the state
// token-by-token decode steps reach from the same a and b.  (The reference's
// associative scan pairs the terms in a tree and lies within fp32 rounding
// of it, which the CPU tests hold.)
//
// What bounds it on this card (H100 SXM: 3.35 TB/s): 2 operations an
// element against 12 bytes (a and b read, h_t written), so the bytes: at
// (1, 2,000, 4,096) that is 98 MB, 29 us.  The sequence is walked in time
// order by one thread a channel, so parallelism is B x r threads (4,096 at
// one request); to keep enough bytes in flight each thread loads kUnroll
// steps of a and b before it runs their dependent chain.  Loads and stores
// are coalesced: neighbouring threads hold neighbouring channels.
//
// a, b and hs are (B, S, r) contiguous fp32, h0 and h_last (B, r).  The C
// launcher takes PyTorch's current stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels a block
constexpr int kUnroll = 8;      // steps whose loads are in flight at once

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  float* __restrict__ h_last, int S, int r) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= r) return;
  const long long row = blockIdx.y;
  const long long base = row * S * (long long)r + c;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = hs + base;
  float h = h0 != nullptr ? h0[row * r + c] : 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(ap + (long long)(t + u) * r);
      bv[u] = __ldg(bp + (long long)(t + u) * r);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      op[(long long)(t + u) * r] = h;
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(__ldg(ap + (long long)t * r), h), __ldg(bp + (long long)t * r));
    op[(long long)t * r] = h;
  }
  h_last[row * r + c] = h;
}

}  // namespace

// a, b, hs (B, S, r) contiguous fp32; h0 (B, r) fp32 or null (zeros);
// h_last (B, r).  Returns a cudaError_t as int (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0, void* hs,
                                 void* h_last, int B, int S, int r, void* stream) {
  if (B <= 0 || S <= 0 || r <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((r + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(hs), static_cast<float*>(h_last), S,
      r);
  return static_cast<int>(cudaGetLastError());
}
