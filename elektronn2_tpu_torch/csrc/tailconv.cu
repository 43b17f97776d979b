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

// The kernel body and its launch live in tailconv_tc_body.cuh, which the
// ablation probe P2 (ptail_ablate.cu) builds too; this file builds only
// the full body, one instance per N tile.
#include "tailconv_tc_body.cuh"

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
