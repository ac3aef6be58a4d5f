// A probe of the tensor core's chained accumulation on Hopper (sm_90a): does
// a chain of bf16 k16 steps accumulated by the tensor core itself give the
// same fp32 bits through mma.sync.m16n8k16 as through wgmma.m64nNk16, at any
// N and with either operand on the A side?  fixed_linear.cu's decode form
// (mma.sync, weights as A) and its tiled form (wgmma, x as A) compute one
// sum order only if it does.  tests/test_torch_cuda.py builds this file and
// compares the outputs bitwise.
//
// x (64, ld) and w (N, ld) bf16, row-major; each output is the chain over the
// first K elements (K / 16 steps at natural positions, the first from zero):
//   out_wgmma      (64, N)  wgmma.m64nNk16, A = x, B = w (N = 64, 128, 256)
//   out_wgmma_swap (N, 64)  wgmma.m64n64k16, A = 64 rows of w, B = x
//   out_mma_wa     (64, N)  mma.sync, A = 16 rows of w, B = 8 rows of x
//   out_mma_xa     (64, N)  mma.sync, A = 16 rows of x, B = 8 rows of w
//   out_mma_steps  (64, N)  mma.sync as out_mma_wa, but each step from zero
//                           and added to an fp32 sum with an IEEE add
// The wgmma outputs need K % 64 == 0 (pass nullptr otherwise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

// wgmma's other shapes that the probe runs beside common.cuh's N = 128
namespace port {

template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

}  // namespace port

namespace {

using bf16 = __nv_bfloat16;

// the operand rows [0, R) of src into 64-element stages of R rows x 128
// bytes at dst, in the 128-byte swizzle that TMA writes
__device__ void stage_swizzled(const bf16* src, long long ld, int R, int K, char* dst) {
  for (int e = threadIdx.x; e < R * (K / 8); e += blockDim.x) {
    const int r = e / (K / 8), c = e % (K / 8);          // 16-byte chunk c of row r
    const int st = c / 8, piece = c % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * ld + c * 8);
    *reinterpret_cast<uint4*>(dst + st * R * 128 + r * 128 + ((piece ^ (r & 7)) << 4)) = v;
  }
}

template <int N>
__global__ void probe_wgmma(const bf16* a_rows, const bf16* b_rows, long long ld, int K,
                            float* out, long long ldo) {
  extern __shared__ uint8_t smem_raw[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int stages = K / 64;
  char* a_s = base;
  char* b_s = base + stages * 64 * 128;
  stage_swizzled(a_rows, ld, 64, K, a_s);
  stage_swizzled(b_rows, ld, N, K, b_s);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  port::fence_regs(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  for (int s = 0; s < K / 16; ++s) {
    const uint32_t a = port::smem_addr(a_s + (s / 4) * 64 * 128 + (s % 4) * 32);
    const uint32_t b = port::smem_addr(b_s + (s / 4) * N * 128 + (s % 4) * 32);
    port::WgmmaBf16<N>::mma(acc, port::sw128_desc(a), port::sw128_desc(b), s > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  port::fence_regs(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * warp + g + (i >= 2 ? 8 : 0), col = 8 * j + 2 * t + (i & 1);
      out[row * ldo + col] = acc[4 * j + i];
    }
  }
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one warp: the 16 x 8 tile of A rows a0.. and B rows b0..; D[i][j] to
// out[i * lo_i + j * lo_j]
__global__ void probe_mma(const bf16* arows, const bf16* brows, long long ld, int K, float* out,
                          long long lo_a, long long lo_b, int steps_apart) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  const bf16* A = arows + blockIdx.x * 16 * ld;
  const bf16* B = brows + blockIdx.y * 8 * ld;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < K / 16; ++s) {
    const int k = 16 * s + 2 * t;
    const uint32_t a0 = word(A + g * ld + k), a1 = word(A + (g + 8) * ld + k);
    const uint32_t a2 = word(A + g * ld + k + 8), a3 = word(A + (g + 8) * ld + k + 8);
    const uint32_t b0 = word(B + g * ld + k), b1 = word(B + g * ld + k + 8);
    if (steps_apart) {
      port::mma_bf16_add(acc, a0, a1, a2, a3, b0, b1);
    } else {
      port::mma_bf16_chain(acc, a0, a1, a2, a3, b0, b1);
    }
  }
  float* o = out + blockIdx.x * 16 * lo_a + blockIdx.y * 8 * lo_b;
  o[g * lo_a + (2 * t) * lo_b] = acc[0];
  o[g * lo_a + (2 * t + 1) * lo_b] = acc[1];
  o[(g + 8) * lo_a + (2 * t) * lo_b] = acc[2];
  o[(g + 8) * lo_a + (2 * t + 1) * lo_b] = acc[3];
}

template <int N>
int launch_wgmma(const bf16* a, const bf16* b, long long ld, int K, float* out, long long ldo,
                 int blocks, long long a_step, long long o_step, cudaStream_t s) {
  const int smem = (K / 64) * (64 + N) * 128 + 1024;
  cudaError_t err = cudaFuncSetAttribute(probe_wgmma<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < blocks; ++i) {
    probe_wgmma<N><<<1, 128, smem, s>>>(a + i * a_step, b, ld, K, out + i * o_step, ldo);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mma_chain_probe(const void* xv, const void* wv, long long ld, int N, int K,
                               float* out_wgmma, float* out_wgmma_swap, float* out_mma_wa,
                               float* out_mma_xa, float* out_mma_steps, void* stream) {
  const bf16* x = static_cast<const bf16*>(xv);
  const bf16* w = static_cast<const bf16*>(wv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16 || K > 256 || N % 64 || N > 256 || ld < K || ld % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = 0;
  if (out_wgmma != nullptr) {
    if (K % 64) return static_cast<int>(cudaErrorInvalidValue);
    err = N == 64 ? launch_wgmma<64>(x, w, ld, K, out_wgmma, N, 1, 0, 0, s)
        : N == 128 ? launch_wgmma<128>(x, w, ld, K, out_wgmma, N, 1, 0, 0, s)
                   : launch_wgmma<256>(x, w, ld, K, out_wgmma, N, 1, 0, 0, s);
    if (err) return err;
  }
  if (out_wgmma_swap != nullptr) {
    if (K % 64) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_wgmma<64>(w, x, ld, K, out_wgmma_swap, 64, N / 64, 64 * ld, 64 * 64, s);
    if (err) return err;
  }
  // A = w: D[n][m] to out[m * N + n]
  probe_mma<<<dim3(N / 16, 8), 32, 0, s>>>(w, x, ld, K, out_mma_wa, 1, N, 0);
  probe_mma<<<dim3(4, N / 8), 32, 0, s>>>(x, w, ld, K, out_mma_xa, N, 1, 0);
  probe_mma<<<dim3(N / 16, 8), 32, 0, s>>>(w, x, ld, K, out_mma_steps, 1, N, 1);
  return static_cast<int>(cudaGetLastError());
}
