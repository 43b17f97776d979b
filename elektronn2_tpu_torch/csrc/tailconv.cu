// K1 for Hopper: the dense-sweep tail conv, valid (3,3,3), z-dilation 1,
// xy-dilation (dx, dy), bias and ReLU fused, float32 in and out, at float32
// accuracy, on the tensor cores: a 3xTF32 implicit GEMM on `wgmma`.
//
// Replaces the Pallas TPU kernel elektronn2_tpu/ops/pallas_tailconv.py::
// conv3x3_dilated (the dense MFP path's conv2 and conv3, 93% of the
// multiply-adds per output voxel of the flagship net; on the conv-dense path
// the wide U-Net's (3,3,3) ReLU convs).
//
// Why 3xTF32 is float32-grade: each operand splits as v = hi + lo, hi = v
// rounded to TF32 (10 explicit mantissa bits, round half away from zero, as
// cvt.rna.tf32.f32) and lo = (v - hi) rounded the same way; v - hi is exact
// and |lo| <= 2^-11 |v|, so hi + lo keeps about 21 bits of v's 24. Each
// product is hi*hi + hi*lo + lo*hi (the dropped lo*lo is below 2^-22 of
// it), each term exact on the tensor cores. Their float32 accumulation
// truncates instead of rounding, and that bias adds up over a long sum, so
// every PROMOTE = 3 stages (216 products per output) sum into fresh
// partials that are then added into the totals with an ordinary
// round-to-nearest FADD. The weights are split once per weight tensor on
// the host (ops/tailconv.py::pack_weights, cached by packed_weights), the
// input in registers here.
//
// What bounds it on this card: three TF32 products per multiply-add at 495
// TFLOP/s (165 TFLOP/s of float32-grade work, 2.5x the 67 of the FP32
// pipe), or its bytes at 3.35 TB/s; at every shape of the main paths the
// operations (~330 FLOP per byte and more).
//
// The GEMM: M = output voxels along y of a (n, zo, xo) row, N = output
// channels, K = 27 taps x Cin, walked as stages of (8-channel chunk of Cin,
// kz, kx), each 3 ky shifts x 3 terms of one m64nNk8 `wgmma`. What the
// design does about the four limits of K1's earlier FFMA body:
//  1. It ran on the FP32 pipe (58% of 67 TFLOP/s; cuDNN's f32 conv 61-66%):
//     the products run on the tensor cores.
//  2. Its loads and FFMAs serialized: a ring of STAGES shared-memory stages,
//     each an 8-channel chunk of the (kz, kx) input rows and the matching
//     weights, is filled by cp.async (4-byte copies for the input rows, which
//     start at any y, zero-filled past Cin and Y; 16-byte copies for the
//     packed weights) STAGES - 2 = 3 stages ahead of the math.
//  3. Cout 128 ran as 4 groups of 40, each reloading the input: one block
//     owns N = Cout (padded to a multiple of 8) up to 64 channels, else a
//     128-channel group (Cout 256: two groups in the grid).
//  4. A short row ran a whole block for a few outputs: a block is 2
//     warpgroups of one 64-output tile each, 128 outputs along a row, and a
//     row of at most 64 outputs shares its block with the next row; the
//     ragged y edge and padded channels are masked in the epilogue.
// A (the input) comes from registers: the three ky taps read one staged row
// at offsets 0, dy, 2dy, where a swizzled shared-memory descriptor cannot
// start. Each thread loads its fragment with ld.shared (the row stride is 8
// mod 32 words, so a warp's 32 loads hit 32 banks) and splits it. B (the
// weights, hi and lo) comes from shared memory by descriptor, packed on the
// host as the K-major, unswizzled core-matrix tile the descriptor reads.
// One tile a warpgroup: its totals and partials take N registers a thread
// (128 at N = 128). Bias and ReLU are applied to the totals; stores run
// along y in NCDHW with 64-bit offsets (a 2-slab batch at 120x496x496 has
// more than 2^31 output elements).

#include "wgmma_tf32.cuh"

namespace {

constexpr int WG = 2;              // warpgroups per block
constexpr int THREADS = WG * 128;
constexpr int STAGES = 5;          // shared-memory ring depth
// Stages summed into one set of partials before they are added into the
// totals. The tensor cores' float32 accumulation truncates: summed in one
// accumulator over all 9 x Cin/8 stages its bias built up to 5-16x the
// error of cuDNN's float32 conv against float64 at the main paths' shapes
// (on an H100); added in every 3 stages it stays at 0.2-0.55x, at no
// measurable cost in time.
constexpr int PROMOTE = 3;

// One block: its two warpgroups' 64-output tiles cover R = 2 / tpr output
// rows (n, zo, xo0 .. xo0+R-1) of tpr tiles (64 tpr y outputs) each; a row
// of up to 64 outputs shares a block with the next instead of leaving half
// of it idle. `RS` is the staged row stride (>= 64 tpr + 2dy, 8 mod 32).
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
tailconv_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int Cin, int Z, int X, int Y, int Cout, int Zo, int Xo,
                   int Yo, int dx, int dy, int tpr, int RS) {
  constexpr int WF = 3 * 2 * NP * KC;      // weight floats per stage
  extern __shared__ __align__(128) float smem[];
  const int R = WG / tpr;
  const int SF = WF + R * KC * RS;         // floats per stage

  const int xblocks = (Xo + R - 1) / R;
  const int64_t bx = blockIdx.x;           // (n, zo, x block), x fastest
  const int xo0 = static_cast<int>(bx % xblocks) * R;
  const int64_t rz = bx / xblocks;
  const int zo = static_cast<int>(rz % Zo);
  const int64_t n = rz / Zo;
  const int y0 = blockIdx.y * tpr * 64;
  const int g = blockIdx.z;                // output-channel group
  const int CC = (Cin + KC - 1) / KC;
  const int nsteps = CC * 9;

  // this thread's staging copies: elements tid, tid + THREADS, ... of the
  // R*KC rows of `cols` columns; (rc, j) advance by (qd, rm) per step
  const int cols = tpr * 64 + 2 * dy;
  const int total = R * KC * cols;
  const int qd = THREADS / cols, rm = THREADS % cols;
  const int rc0 = threadIdx.x / cols, j0 = threadIdx.x % cols;

  const int64_t plane = static_cast<int64_t>(X) * Y;
  const float* xn = x + n * Cin * Z * plane + zo * plane + y0;

  // stage s = (channel chunk cc, tap kz, kx) into ring slot `slot`
  auto load_stage = [&](int s, int slot) {
    float* sw = smem + slot * SF;
    float* si = sw + WF;
    const int cc = s / 9, tap = s - cc * 9;
    const int kz = tap / 3, kx = tap - kz * 3;
    const float* wsrc = wp + (static_cast<int64_t>(g * CC + cc) * 9 + tap) * WF;
    for (int i = threadIdx.x; i < WF / 4; i += THREADS)
      cp_async16(sw + 4 * i, wsrc + 4 * i);
    const float* xs = xn + kz * plane + static_cast<int64_t>(kx) * dx * Y;
    int rc = rc0, j = j0;
    for (int idx = threadIdx.x; idx < total; idx += THREADS) {
      const int ci = cc * KC + rc % KC;
      const int xr = min(xo0 + rc / KC, Xo - 1);
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

  // ring of STAGES slots, filled STAGES - 2 stages ahead: the slot refilled
  // at stage s was read by stage s - 2, whose wgmmas every warpgroup has
  // waited for before the barrier at s (a group waits for all but the two
  // before it)
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();
  }

  // totals and partial sums
  float acc[NP / 2], part[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = part[i] = 0.f;

  // this warpgroup's tile (staged row wg / tpr, y tile wg % tpr); this
  // thread's fragment rows 16 * warp + lane / 4 (+ 8), channels lane % 4
  // (+ 4)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;
  const int m0 = 16 * warp + lane / 4;
  const int toff = (wg / tpr) * KC * RS + (wg % tpr) * 64 + q * RS + m0;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 3>();           // this thread's copies of s landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                       // everyone's; s-2's math done
    if (s + STAGES - 2 < nsteps)
      load_stage(s + STAGES - 2, (s + STAGES - 2) % STAGES);
    cp_async_commit();
    const float* sw = smem + (s % STAGES) * SF;
    const float* si = sw + WF + toff;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      mma_group<NP>(part, si + ky * dy, sw + 2 * ky * NP * KC, RS,
                    ky == 0 && s % PROMOTE == 0);
    // every PROMOTE stages (and at the end) the partials, once done, are
    // added into the totals in float32 with round-to-nearest
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
int launch(const float* x, const float* wp, const float* bias, float* y,
           int N, int Cin, int Z, int X, int Y, int Cout, int dx, int dy,
           cudaStream_t stream) {
  const int Zo = Z - 2, Xo = X - 2 * dx, Yo = Y - 2 * dy;
  // tiles per row: both of the block's, or one where a tile covers a row
  const int tpr = Yo > 64 ? WG : 1;
  const int R = WG / tpr;
  const int RS = (tpr * 64 + 2 * dy + 23) / 32 * 32 + 8;
  const size_t smem = sizeof(float) * STAGES * (6 * NP * KC + R * KC * RS);
  cudaError_t err = cudaFuncSetAttribute(
      tailconv_tc_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(
      static_cast<unsigned>(static_cast<int64_t>(N) * Zo * ((Xo + R - 1) / R)),
      static_cast<unsigned>((Yo + tpr * 64 - 1) / (tpr * 64)),
      static_cast<unsigned>((Cout + NP - 1) / NP));
  tailconv_tc_kernel<NP><<<grid, THREADS, smem, stream>>>(
      x, wp, bias, y, Cin, Z, X, Y, Cout, Zo, Xo, Yo, dx, dy, tpr, RS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   x    (N, Cin, Z, X, Y) float32, contiguous
//   wp   the weights (Cout, Cin, 3, 3, 3) split into TF32 hi and lo and
//        packed by ops/tailconv.py::pack_weights for N tile `np` (the
//        output channels of one block: 8, 16, ..., 64 or 128; Cout runs as
//        ceil(Cout/np) groups), Cout and Cin zero-padded
//   bias (Cout,) float32
//   y    (N, Cout, Z-2, X-2dx, Y-2dy) float32, written
// Launches on `stream` and returns cudaGetLastError() (0 on success): a
// refused launch shows only there.
extern "C" int e2t_tailconv_tc(const float* x, const float* wp,
                               const float* bias, float* y, int N, int Cin,
                               int Z, int X, int Y, int Cout, int np, int dx,
                               int dy, void* stream) {
  if (N < 1 || Cin < 1 || Cout < 1 || Z - 2 < 1 || X - 2 * dx < 1
      || Y - 2 * dy < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define E2T_CASE(NP)                                                     \
  case NP:                                                               \
    return launch<NP>(x, wp, bias, y, N, Cin, Z, X, Y, Cout, dx, dy, s);
  switch (np) {
    E2T_CASE(8) E2T_CASE(16) E2T_CASE(24) E2T_CASE(32) E2T_CASE(40)
    E2T_CASE(48) E2T_CASE(56) E2T_CASE(64) E2T_CASE(128)
  }
#undef E2T_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
