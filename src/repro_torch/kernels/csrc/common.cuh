// Device code that several of the port's kernels share, so that each piece
// exists once and every kernel that uses it computes the same bits:
//   * the bf16 tensor-core steps of the fixed-order products: lm_head.cu's
//     tied_mma_kernel sums each m16n8k16 mma from zero and adds it to an fp32
//     sum with one IEEE add (mma_bf16_add); fixed_linear.cu's two forms chain
//     a slice's k16 steps in the tensor core's own accumulator, mma.sync at
//     a decode step (mma_bf16_chain) and wgmma on a prefill wave (WgmmaBf16),
//     the two of them the same bits (fixed_linear.cu's note); the streaming
//     16-byte load that feeds the decode steps;
//   * Hopper's asynchronous copies and clusters (quant_matmul.cu's and
//     fixed_linear.cu's TMA rings and cluster reductions): mbarriers, TMA
//     loads and stores, the 128-byte-swizzle wgmma operand descriptor, the
//     cluster barrier and stores into a neighbour's shared memory, and on the
//     host the TMA map (cuTensorMapEncodeTiled looked up in the loaded
//     libcuda) and the SM count;
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <type_traits>

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

// acc = the m16n8k16 product of A (a0..a3) and B (b0, b1) added to acc by the
// tensor core itself (acc = 0 before a chain's first step): a chain of these
// over a slice's k16 steps is what wgmma computes with scale_d = 1 after the
// slice's first step (fixed_linear.cu).
__device__ __forceinline__ void mma_bf16_chain(float (&acc)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- wgmma on bf16 operands --------------------------------------------- //

// d (m64 x nN, fp32) = A (64 x 16, K-major) . B (N x 16, K-major)^T + (scale_d
// ? d : 0), both from shared memory through sw128_desc descriptors.
// Accumulator element 4j + i of lane (g, t) of warp w: row 16w + g (+ 8 for
// i >= 2), column 8j + 2t + (i & 1).  N = 128, fixed_wgmma_kernel's shape
// (tests/csrc/mma_chain_probe.cu adds the others it probes).
template <int N>
struct WgmmaBf16;

template <>
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ---- Hopper's asynchronous copies ---------------------------------------- //

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Wait for the phase of parity `parity` of the barrier to complete.  A
// phase that never completes (a ring out of step) traps after ~2 s of the
// SM's clock instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 4000000000LL) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// rows [row, row + box) x elements [k, k + box) of the map's tensor into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// A wgmma operand in shared memory: rows of 128 bytes (K-major), 8-row
// groups 1024 bytes apart, in the 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)   // start address
         | static_cast<uint64_t>(1) << 16                // leading offset (unused)
         | static_cast<uint64_t>(1024 >> 4) << 32        // stride between 8-row groups
         | static_cast<uint64_t>(1) << 62;               // 128-byte swizzle
}

// the staged box at src (64 rows x 128 bytes, 128-byte swizzle) into the
// map's tensor at (row, col); rows and columns past the tensor are not
// written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator register
// across a wgmma fence or wait.
template <typename T, int R>
__device__ __forceinline__ void fence_regs(T (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      asm volatile("" : "+f"(d[i])::"memory");
    } else {
      asm volatile("" : "+r"(d[i])::"memory");
    }
  }
}

// ---- thread block clusters ---------------------------------------------- //
// The block's rank, a barrier over the cluster (which also orders
// shared-memory writes before it with reads after it), and stores into
// another block's shared memory at the address a variable has in ours.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the same barrier split in two: no block may touch another's shared memory
// before every block of the cluster has started, so each arrives at once
// and waits just before its first remote store
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// ... and with release: this thread's stores (remote ones too) are seen by
// every thread of the cluster once it has waited
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, const uint4& v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, const float (&v)[4]) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v[0]),
               "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// ---- on the host --------------------------------------------------------- //

inline int num_sms() {
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

// cuTensorMapEncodeTiled, looked up by name in libcuda (which PyTorch has
// already loaded), so that a library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr) {
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

// A TMA map of a (rows, cols) tensor of `elem`-byte elements with a row
// stride of `ld` elements (cols when 0), read or written in boxes of
// box_rows x box_cols elements (128 bytes a row in the 128-byte swizzle, or
// fewer unswizzled); reads past the tensor fill zeros, writes past it are
// dropped.
inline bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                     int rows, int cols, int box_rows, int box_cols,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
                     long long ld = 0) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld > 0 ? ld : cols) * elem};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box_cols),
                               static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, boxes, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
