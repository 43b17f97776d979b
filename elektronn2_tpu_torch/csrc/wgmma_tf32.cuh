// Device helpers of the 3xTF32 `wgmma` implicit GEMMs K1 (tailconv.cu,
// through tailconv_tc_body.cuh) and K4 (headconv.cu), and of their probes
// P1 (ptail_dot.cu) and P2 (ptail_ablate.cu), for sm_90a: cp.async staging
// (cp_async.cuh), the shared-memory matrix descriptor of the packed
// weights, the TF32 split, and one m64nNk8 `wgmma` per N tile;
// utils/cuda_build.py puts the text of every included header into a
// library's build key.
//
// The split: v = hi + lo, hi = v rounded to TF32 (10 explicit mantissa
// bits, round half away from zero, as cvt.rna.tf32.f32) and lo = (v - hi)
// rounded the same way; v - hi is exact and |lo| <= 2^-11 |v|, so hi + lo
// keeps about 21 bits of v's 24. A product is hi*hi + hi*lo + lo*hi (the
// dropped lo*lo is below 2^-22 of it), each term exact on the tensor cores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int KC = 8;              // input channels per stage: one TF32 k

// B's descriptor: K-major, no swizzle. A core matrix is 8 rows (n) of 16
// bytes (4 k) stored contiguously; the two k halves of a k8 step lie LBO
// bytes apart, consecutive 8-row groups of n SBO bytes apart.
constexpr uint32_t LBO = 128;
constexpr uint32_t SBO = 256;

__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(LBO >> 4) << 16)
         | (static_cast<uint64_t>(SBO >> 4) << 32);
}

// float32 -> TF32 bits, round half away from zero (cvt.rna.tf32.f32): the
// sign-magnitude bits plus half a TF32 ulp, the low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving an accumulator's reads or writes across a
// wgmma fence or wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D(64 x N, float32, in registers) += A(64 x 8, TF32 fragment in registers)
// * B(8 x N, TF32 in shared memory at descriptor b): `wgmma` m64nNk8, one
// specialization per N the kernels take. The asm operands are numbered A's
// four registers (%0-%3), B's descriptor (%4), the scale flag (%5), then D's
// N/2 registers, so that every N's D list is a prefix of one list:
// WGMMA_D<R> names %6 .. %(5 + R) and WGMMA_C<R> binds d[0 .. R-1]. A, b
// and the flag are tied in-out operands only to come first; the asm does
// not change them.
#define WGMMA_D4 "%6, %7, %8, %9"
#define WGMMA_D8 WGMMA_D4 ", %10, %11, %12, %13"
#define WGMMA_D12 WGMMA_D8 ", %14, %15, %16, %17"
#define WGMMA_D16 WGMMA_D12 ", %18, %19, %20, %21"
#define WGMMA_D20 WGMMA_D16 ", %22, %23, %24, %25"
#define WGMMA_D24 WGMMA_D20 ", %26, %27, %28, %29"
#define WGMMA_D28 WGMMA_D24 ", %30, %31, %32, %33"
#define WGMMA_D32 WGMMA_D28 ", %34, %35, %36, %37"
#define WGMMA_D64                                                          \
  WGMMA_D32 ", %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49" \
            ", %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61" \
            ", %62, %63, %64, %65, %66, %67, %68, %69"
#define WGMMA_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_C4 WGMMA_F4(0)
#define WGMMA_C8 WGMMA_C4, WGMMA_F4(4)
#define WGMMA_C12 WGMMA_C8, WGMMA_F4(8)
#define WGMMA_C16 WGMMA_C12, WGMMA_F4(12)
#define WGMMA_C20 WGMMA_C16, WGMMA_F4(16)
#define WGMMA_C24 WGMMA_C20, WGMMA_F4(20)
#define WGMMA_C28 WGMMA_C24, WGMMA_F4(24)
#define WGMMA_C32 WGMMA_C28, WGMMA_F4(28)
#define WGMMA_C64                                                        \
  WGMMA_C32, WGMMA_F4(32), WGMMA_F4(36), WGMMA_F4(40), WGMMA_F4(44),     \
      WGMMA_F4(48), WGMMA_F4(52), WGMMA_F4(56), WGMMA_F4(60)

template <int N>
struct Mma;

// the specialization for N (R = N / 2 accumulator registers a thread)
#define WGMMA_TF32(N, R)                                                   \
  template <>                                                              \
  struct Mma<N> {                                                          \
    static_assert(2 * (R) == (N), "R must be N / 2");                      \
    static __device__ __forceinline__ void run(float (&d)[R],              \
                                               const uint32_t (&a)[4],     \
                                               uint64_t b, int scale_d) {  \
      uint32_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];                 \
      asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {"        \
        WGMMA_D##R "}, {%0, %1, %2, %3}, %4, p, 1, 1;\n}\n"                \
          : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+l"(b),               \
            "+r"(scale_d), WGMMA_C##R);                                    \
    }                                                                      \
  };

WGMMA_TF32(8, 4)
WGMMA_TF32(16, 8)
WGMMA_TF32(24, 12)
WGMMA_TF32(32, 16)
WGMMA_TF32(40, 20)
WGMMA_TF32(48, 24)
WGMMA_TF32(56, 28)
WGMMA_TF32(64, 32)
WGMMA_TF32(128, 64)

// One k group (a staged chunk at one ky shift) of a warpgroup's tile, into
// the partial sums `part`: the TF32 split of its A fragment, then hi*lo,
// lo*hi and hi*hi (the small terms first, into fresh partials when
// `first`). `p` is this thread's fragment origin in a staged row block of
// stride RS (rows = the chunk's 8 channels), `w` the (hi, lo) B tiles. The
// group three back, whose fragment registers these reuse, is waited for
// first.
template <int NP>
__device__ __forceinline__ void mma_group(float (&part)[NP / 2],
                                          const float* p, const float* w,
                                          int RS, bool first) {
  wgmma_wait<2>();
  // fragment: rows lane/4 (+8), channels lane%4 (+4) of the warp's 16 rows
  const float v[4] = {p[0], p[8], p[4 * RS], p[4 * RS + 8]};
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32_rna(v[i]);
    al[i] = tf32_rna(v[i] - __uint_as_float(ah[i]));
  }
  const uint64_t bh = smem_desc(w);
  const uint64_t bl = smem_desc(w + NP * KC);
  wgmma_fence();
  Mma<NP>::run(part, ah, bl, first ? 0 : 1);
  Mma<NP>::run(part, al, bh, 1);
  Mma<NP>::run(part, ah, bh, 1);
  wgmma_commit();
}

}  // namespace
