// Device code that several of the port's kernels share, so that each piece
// exists once and every kernel that uses it computes the same bits:
//   * the bf16 tensor-core step of the fixed-order products (lm_head.cu's
//     tied_mma_kernel, fixed_linear.cu's fixed_mma_kernel): an m16n8k16 mma
//     summed from zero by the tensor core, then added to an fp32 sum with one
//     IEEE add, and the streaming 16-byte load that feeds it;
//   * RMSNorm's statistics and scaling in the one order rmsnorm.cu fixes
//     (rmsnorm_kernel, and fixed_linear.cu's norm prologue): a row cut into
//     16-byte chunks, chunk c to thread c % 256 of 256 (kRmsThreads), each
//     thread's squares summed in chunk order by fma, an xor butterfly in each
//     warp, the 8 warp sums added in warp order; then x * r * w with
//     r = 1 / sqrt(mean + eps).
// Arithmetic is IEEE fp32 (no --use_fast_math); sums are written as explicit
// fmaf / __fadd_rn so that no contraction choice of the compiler can differ
// between two kernels that must agree bit for bit.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace port {

// ---- the fixed-order bf16 tensor-core step ------------------------------- //

// 16 bytes of a weight table, not kept in L1 (each is read once).  The loads
// and the mma's are volatile, so they keep their program order: a batch's
// loads stay ahead of the mma's of the batch before it.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// acc += the m16n8k16 product of A (a0..a3) and B (b0, b1), summed by the
// tensor core from zero.  An output element of mma is its own dot product, so
// column j of the result does not depend on the other columns of B: a row of
// x that is column j gives the same bits whatever the other columns hold.
__device__ __forceinline__ void mma_bf16_add(float (&acc)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  float d[4];
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// ---- RMSNorm statistics in rmsnorm.cu's order --------------------------- //

// threads whose chunks a row's sum of squares is cut over
constexpr int kRmsThreads = 256;
constexpr int kRmsWarps = kRmsThreads / 32;

// a thread's running sum of squares, one element more
__device__ __forceinline__ float sq_add(float s, float v) { return fmaf(v, v, s); }

// the warp's 32 sums in a fixed xor butterfly (every lane ends with the same
// value: each step adds two operands in either order, which IEEE addition
// does not notice)
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// r = 1 / sqrt(t / d + eps) for a row's sum of squares t
__device__ __forceinline__ float rms_inv_of(float t, int d, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(t, static_cast<float>(d)), eps)));
}

// the 8 warp sums in warp order, then r (a warp with no chunk adds +0,
// which leaves the sum as it is, so a caller may stop at the last warp that
// holds one)
__device__ __forceinline__ float rms_inv(const float (&part)[kRmsWarps], int d, float eps) {
  float t = part[0];
#pragma unroll
  for (int i = 1; i < kRmsWarps; ++i) t = __fadd_rn(t, part[i]);
  return rms_inv_of(t, d, eps);
}

// the scale of element e: w[e], or 1 + w[e] (the models' (1 + scale) form)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename W>
__device__ __forceinline__ float norm_weight(const W* __restrict__ w, long long e,
                                             bool plus_one) {
  return plus_one ? __fadd_rn(1.0f, to_f32(w[e])) : to_f32(w[e]);
}

// one normalised element: (x * r) * w
__device__ __forceinline__ float rms_scale(float v, float r, float w) {
  return __fmul_rn(__fmul_rn(v, r), w);
}

// PyTorch's CUDA silu in fp32, x / (1 + exp(-x)), with the same expf and an
// IEEE division (ATen's silu_kernel), so that y * silu(z) is bitwise what
// the layer's composition computes
__device__ __forceinline__ float silu_f32(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

}  // namespace port
