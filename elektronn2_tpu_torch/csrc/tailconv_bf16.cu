// K1's bfloat16 mode for Hopper: the dense-sweep tail conv, valid (3,3,3),
// z-dilation 1, xy-dilation (dx, dy), bias and ReLU fused, float32 in and
// out, the input and the weights rounded to bf16 (round to nearest even)
// and their products summed in float32 on the tensor cores: an implicit
// GEMM on `wgmma` m64nNk16 with bf16 operands.
//
// Replaces the bf16 mode of the Pallas TPU kernel elektronn2_tpu/ops/
// pallas_tailconv.py::conv3x3_dilated (compute_dtype="bfloat16", its
// operands cast to bf16, Cin padded to 16, preferred_element_type float32).
// As in the JAX package no serving route takes it: it is reached by a direct
// call (ops/tailconv.py::conv3x3_dilated(..., compute_dtype="bfloat16")).
//
// What bounds it on this card: at the flagship's conv2/conv3 the bytes and
// the bf16 operations are close (float32 in and out at 3.35 TB/s against
// the products at 989 TFLOP/s), at the wide U-Net's d1 the operations.
//
// The design is K1's (tailconv.cu, tailconv_tc_body.cuh) with one bf16
// `wgmma` a ky shift where K1 issues three TF32 ones:
//  - GEMM: M = output voxels along y of a (n, zo, xo) row, N = output
//    channels (one block owns Cout padded to a multiple of 8 up to 64, else
//    a 128-channel group), K = 27 taps x Cin walked as stages of (16-channel
//    chunk of Cin, kz, kx), each stage 3 ky shifts of one m64nNk16 `wgmma`.
//    Cin is zero-filled up to a multiple of 16, as the JAX kernel's c_align.
//  - A (the input) comes from registers: the three ky taps read one staged
//    row at offsets 0, dy, 2dy, where a shared-memory descriptor (plain or
//    swizzled, as P1's bf16 kernel takes its operands) cannot start. So the
//    input is staged as float32 by cp.async, as K1 stages it, and each
//    thread rounds its fragment to bf16 with cvt.rn when it loads it. The
//    other choice, a bf16 copy of the input made by a pass before the
//    kernel (as K3's bf16 mode stages bf16 windows), would halve the
//    staged bytes but add a pass that reads 4 and writes 2 bytes a value
//    of the whole input, about a third of the bytes bound at the
//    flagship's shapes, and a buffer of half the input; the staging reads
//    come from L2 after the first of the 9 (kz, kx) stages that read a row.
//    Rounding in the kernel also makes the bf16 values exactly those of
//    the plain version's x.bfloat16().
//  - The staged row stride is 4 mod 32 words: a fragment load reads
//    channels 2q (+1, +8, +9) at rows m0 (+8), so the 32 lanes of one load
//    hit 32 banks.
//  - B (the weights) comes from shared memory by descriptor: packed on the
//    host (ops/tailconv.py::pack_weights_bf16) as the K-major, unswizzled
//    core-matrix tile K1's TF32 descriptor reads, 8 output channels x 8
//    bf16 channels (16 bytes) a core matrix row: the same byte geometry, so
//    the same descriptor (LBO 128, SBO 256).
//  - A ring of STAGES shared-memory stages filled STAGES - 2 ahead; every
//    PROMOTE stages the partial sums are added into float32 totals with a
//    round-to-nearest FADD (the tensor cores' accumulation truncates, as
//    K1's note says); bias and ReLU on the totals; stores along y in NCDHW
//    with 64-bit offsets.

#include <cuda_bf16.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int KB = 16;             // input channels per stage: one bf16 k
constexpr int WG = 2;              // warpgroups per block
constexpr int THREADS = WG * 128;
constexpr int STAGES = 5;          // shared-memory ring depth
constexpr int PROMOTE = 3;         // stages summed into one set of partials

// D(64 x N, float32, in registers) += A(64 x 16, bf16 fragment in
// registers) * B(16 x N, bf16 in shared memory at descriptor b, K-major):
// `wgmma` m64nNk16, one specialization per N the kernel takes. The operand
// numbering is wgmma_tf32.cuh's (A %0-%3, b %4, the scale flag %5, D from
// %6 on), so its WGMMA_D / WGMMA_C lists serve here too.
template <int N>
struct MmaBf16;

#define WGMMA_BF16(N, R)                                                   \
  template <>                                                              \
  struct MmaBf16<N> {                                                      \
    static_assert(2 * (R) == (N), "R must be N / 2");                      \
    static __device__ __forceinline__ void run(float (&d)[R],              \
                                               const uint32_t (&a)[4],     \
                                               uint64_t b, int scale_d) {  \
      uint32_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];                 \
      asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"       \
        WGMMA_D##R "}, {%0, %1, %2, %3}, %4, p, 1, 1, 0;\n}\n"             \
          : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+l"(b),               \
            "+r"(scale_d), WGMMA_C##R);                                    \
    }                                                                      \
  };

WGMMA_BF16(8, 4)
WGMMA_BF16(16, 8)
WGMMA_BF16(24, 12)
WGMMA_BF16(32, 16)
WGMMA_BF16(40, 20)
WGMMA_BF16(48, 24)
WGMMA_BF16(56, 28)
WGMMA_BF16(64, 32)
WGMMA_BF16(128, 64)

// two float32 values rounded to bf16 (nearest even), the first in the low
// half: one 32-bit register of an A fragment (lower k first)
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One ky shift of a stage: this thread's A fragment at p (rows m0, m0 + 8,
// channels 2q, 2q+1, 2q+8, 2q+9 of a staged block of stride RS) rounded to
// bf16, then one wgmma into `part` (fresh partials when `first`). The
// group three back, whose fragment registers these reuse, is waited for
// first.
template <int NP>
__device__ __forceinline__ void mma_ky(float (&part)[NP / 2], const float* p,
                                       int RS, uint64_t bdesc, bool first) {
  wgmma_wait<2>();
  uint32_t a[4];
  a[0] = bf16x2(p[0], p[RS]);
  a[1] = bf16x2(p[8], p[RS + 8]);
  a[2] = bf16x2(p[8 * RS], p[9 * RS]);
  a[3] = bf16x2(p[8 * RS + 8], p[9 * RS + 8]);
  wgmma_fence();
  MmaBf16<NP>::run(part, a, bdesc, first ? 0 : 1);
  wgmma_commit();
}

// One block: its two warpgroups' 64-output tiles cover R = 2 / tpr output
// rows (n, zo, xo0 .. xo0+R-1) of tpr tiles (64 tpr y outputs) each, as in
// K1. `RS` is the staged row stride (>= 64 tpr + 2dy, 4 mod 32).
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
tailconv_bf16_kernel(const float* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wp,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int Cin, int Z, int X, int Y, int Cout, int Zo, int Xo,
                     int Yo, int dx, int dy, int tpr, int RS) {
  constexpr int WB = 3 * NP * KB * 2;      // weight bytes per stage
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = WG / tpr;
  const int SB = WB + R * KB * RS * 4;     // bytes per stage

  const int xblocks = (Xo + R - 1) / R;
  const int64_t bx = blockIdx.x;           // (n, zo, x block), x fastest
  const int xo0 = static_cast<int>(bx % xblocks) * R;
  const int64_t rz = bx / xblocks;
  const int zo = static_cast<int>(rz % Zo);
  const int64_t n = rz / Zo;
  const int y0 = blockIdx.y * tpr * 64;
  const int g = blockIdx.z;                // output-channel group
  const int CC = (Cin + KB - 1) / KB;
  const int nsteps = CC * 9;

  // this thread's staging copies: elements tid, tid + THREADS, ... of the
  // R*KB rows of `cols` columns; (rc, j) advance by (qd, rm) per step
  const int cols = tpr * 64 + 2 * dy;
  const int total = R * KB * cols;
  const int qd = THREADS / cols, rm = THREADS % cols;
  const int rc0 = threadIdx.x / cols, j0 = threadIdx.x % cols;

  const int64_t plane = static_cast<int64_t>(X) * Y;
  const float* xn = x + n * Cin * Z * plane + zo * plane + y0;

  // stage s = (channel chunk cc, tap kz, kx) into ring slot `slot`: its
  // packed weights (16-byte copies) and the R x 16 input rows (4-byte
  // copies, which start at any y; zero-filled past Cin and Y)
  auto load_stage = [&](int s, int slot) {
    unsigned char* sw = smem + slot * SB;
    float* si = reinterpret_cast<float*>(sw + WB);
    const int cc = s / 9, tap = s - cc * 9;
    const int kz = tap / 3, kx = tap - kz * 3;
    const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(wp)
        + (static_cast<int64_t>(g * CC + cc) * 9 + tap) * WB;
    for (int i = threadIdx.x; i < WB / 16; i += THREADS)
      cp_async16(reinterpret_cast<float*>(sw + 16 * i),
                 reinterpret_cast<const float*>(wsrc + 16 * i));
    const float* xs = xn + kz * plane + static_cast<int64_t>(kx) * dx * Y;
    int rc = rc0, j = j0;
    for (int idx = threadIdx.x; idx < total; idx += THREADS) {
      const int ci = cc * KB + rc % KB;
      const int xr = min(xo0 + rc / KB, Xo - 1);
      const float* src = xs + min(ci, Cin - 1) * Z * plane
                         + static_cast<int64_t>(xr) * Y;
      const bool ok = ci < Cin && y0 + j < Y;
      cp_async4(si + rc * RS + j, ok ? src + j : src, ok ? 4 : 0);
      rc += qd;
      j += rm;
      if (j >= cols) {
        j -= cols;
        ++rc;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();
  }

  float acc[NP / 2], part[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = part[i] = 0.f;

  // this warpgroup's tile (staged row wg / tpr, y tile wg % tpr); this
  // thread's fragment rows 16 * warp + lane / 4 (+ 8), channels 2 (lane %
  // 4) (+ 1, + 8, + 9)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;
  const int m0 = 16 * warp + lane / 4;
  const int toff = (wg / tpr) * KB * RS + (wg % tpr) * 64 + 2 * q * RS + m0;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 3>();           // this thread's copies of s landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                       // everyone's; s-2's math done
    if (s + STAGES - 2 < nsteps)
      load_stage(s + STAGES - 2, (s + STAGES - 2) % STAGES);
    cp_async_commit();
    const unsigned char* sw = smem + (s % STAGES) * SB;
    const float* si = reinterpret_cast<const float*>(sw + WB) + toff;
    const bool fresh = s % PROMOTE == 0;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      mma_ky<NP>(part, si + ky * dy, RS,
                 smem_desc(reinterpret_cast<const float*>(
                     sw + ky * NP * KB * 2)),
                 ky == 0 && fresh);
    if (s % PROMOTE == PROMOTE - 1 || s == nsteps - 1) {
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[i] += part[i];
    }
  }
  cp_async_wait<0>();

  // epilogue: bias + ReLU; accumulator 4j+e holds tile row m0 + 8 (e / 2),
  // channel 8j + 2q + e % 2
  const int xo = xo0 + wg / tpr;
  if (xo >= Xo) return;
  const int64_t ostride = static_cast<int64_t>(Zo) * Xo * Yo;  // per channel
  float* yrow = y + n * Cout * ostride + static_cast<int64_t>(zo) * Xo * Yo
                + static_cast<int64_t>(xo) * Yo;
  const int yb = y0 + (wg % tpr) * 64 + m0;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int co = g * NP + 8 * j + 2 * q + e2;
      if (co >= Cout) continue;
      const float bv = __ldg(bias + co);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int yo = yb + 8 * h;
        if (yo < Yo)
          yrow[co * ostride + yo] = fmaxf(acc[4 * j + 2 * h + e2] + bv, 0.f);
      }
    }
  }
}

template <int NP>
int launch(const float* x, const __nv_bfloat16* wp, const float* bias,
           float* y, int N, int Cin, int Z, int X, int Y, int Cout, int dx,
           int dy, cudaStream_t stream) {
  const int Zo = Z - 2, Xo = X - 2 * dx, Yo = Y - 2 * dy;
  // tiles per row: both of the block's, or one where a tile covers a row
  const int tpr = Yo > 64 ? WG : 1;
  const int R = WG / tpr;
  const int RS = (tpr * 64 + 2 * dy + 27) / 32 * 32 + 4;
  const size_t smem = static_cast<size_t>(STAGES)
                      * (3 * NP * KB * 2 + R * KB * RS * 4);
  cudaError_t err = cudaFuncSetAttribute(
      tailconv_bf16_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(
      static_cast<unsigned>(static_cast<int64_t>(N) * Zo * ((Xo + R - 1) / R)),
      static_cast<unsigned>((Yo + tpr * 64 - 1) / (tpr * 64)),
      static_cast<unsigned>((Cout + NP - 1) / NP));
  tailconv_bf16_kernel<NP><<<grid, THREADS, smem, stream>>>(
      x, wp, bias, y, Cin, Z, X, Y, Cout, Zo, Xo, Yo, dx, dy, tpr, RS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   x    (N, Cin, Z, X, Y) float32, contiguous
//   wp   the weights (Cout, Cin, 3, 3, 3) rounded to bf16 and packed by
//        ops/tailconv.py::pack_weights_bf16 for N tile `np` (8, 16, ...,
//        64 or 128; Cout runs as ceil(Cout/np) groups), Cout and Cin
//        zero-padded
//   bias (Cout,) float32
//   y    (N, Cout, Z-2, X-2dx, Y-2dy) float32, written
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int e2t_tailconv_bf16(const float* x, const void* wp,
                                 const float* bias, float* y, int N, int Cin,
                                 int Z, int X, int Y, int Cout, int np,
                                 int dx, int dy, void* stream) {
  if (N < 1 || Cin < 1 || Cout < 1 || Z - 2 < 1 || X - 2 * dx < 1
      || Y - 2 * dy < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wp);
#define E2T_CASE(NP)                                                     \
  case NP:                                                               \
    return launch<NP>(x, w, bias, y, N, Cin, Z, X, Y, Cout, dx, dy, s);
  switch (np) {
    E2T_CASE(8) E2T_CASE(16) E2T_CASE(24) E2T_CASE(32) E2T_CASE(40)
    E2T_CASE(48) E2T_CASE(56) E2T_CASE(64) E2T_CASE(128)
  }
#undef E2T_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
