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
// each (tile, stage) sums its 216 TF32 products an output into fresh
// partials that are then added into the totals with an ordinary
// round-to-nearest FADD. The weights are split once per weight tensor on
// the host (ops/tailconv.py::pack_weights, cached by packed_weights), the
// input in registers here.
//
// What bounds it on this card, and what the design does about each limit:
//  - The math: three TF32 products per multiply-add at 495 TFLOP/s (165
//    TFLOP/s of float32-grade work, 2.5x the 67 of the FP32 pipe). Its HBM
//    bytes at 3.35 TB/s are ~330 times fewer per FLOP at every shape of the
//    main paths, so HBM never sets the pace.
//  - Staging from L2. The body before this one copied, per 128 outputs
//    and per (8-channel chunk, kz, kx), the input rows again for each kx
//    tap and the stage's weights again, by per-thread cp.async taking
//    turns with the math: 235 GB a flagship request at 2.1 TB/s, staging
//    51% of its time and the math 30% (its ablation probe P2). Here a
//    producer warpgroup stages each (tile, chunk, kz) once for all 9 taps,
//    by TMA, into a ring the consumers read while it fills the next slots:
//    77 GB a request, overlapped with the math (P2's dmaonly, the copies
//    alone, is a quarter of the full kernel at the flagship's N 40).
//  - The consumers' own work on A. A comes from registers, so each thread
//    loads and splits its A fragment (4 ld.shared, then the TF32 split)
//    for every tap of every m64 tile, in the same stream as the wgmmas
//    that read it, while those wgmmas read B from the same shared memory:
//    at N 40 that costs about a quarter of the kernel (P2's nostage,
//    fragments split once, against full), and its cost a FLOP halves as
//    N doubles. Each fragment is loaded a tap ahead, so its loads are in
//    flight while the thread waits for the wgmma group three back (5% of
//    the kernel at the flagship and at d1). And wherever Cout is over 64
//    the N tile is 128 with one m64 tile a warpgroup: fewer outputs share
//    a weight stage (465 GB staged at the U-Net's d1), but each split
//    feeds twice the math, 5-7% faster at the U-Net's four K1 shapes than
//    four m64 tiles of 64 channels.
//  - Registers: float32 totals for T m64 tiles and one set of partials,
//    (T + 1) NP / 2 a consumer thread, within the 224 that `setmaxnreg`
//    gives the consumers: T = 4 up to N 64 (160 at most), 1 at N 128.
//
// The design (kernel body and launch in tailconv_tc_body.cuh):
//  - Persistent and warp-specialised: one block per SM walks the output
//    tiles (zo fastest, then the channel group, y tile, x tile, n, so the
//    blocks in flight share one (x, y) column's kz planes in L2). A
//    producer warpgroup keeps a ring of shared-memory stages full
//    (`mbarrier`s full/empty); two consumer warpgroups take its registers
//    (`setmaxnreg`) and run the math while it stages ahead.
//  - A tile is R = 2T output rows of one x phase (xo = px + dx (i0 + i),
//    so a dilated row's kx taps are rows of the same phase) x 64 y, N = one
//    group of NP output channels (ops/tailconv.py::n_tile: Cout rounded up
//    to 8 up to 64, else 128 a group). Each consumer warpgroup holds T m64
//    tiles (T rows).
//  - A stage is one (8-channel chunk, kz): the tile's R + 2 input rows of
//    the chunk at plane zo + kz, staged once and read by all 9 (kx, ky)
//    taps (tap (kx, ky) of row i = staged row i + kx from y offset ky dy),
//    and the stage's packed weights for all 9 taps (one bulk copy), read
//    by the tile's 2T m64 tiles. At N 40 that is R + 2 = 10 input rows for
//    8 output rows, and one weight stage for 512 outputs; the body before
//    staged 3 input rows an output row, and the weights once per 128
//    outputs.
//  - The input is staged straight from x in NCDHW, with no layout pass:
//    A comes from registers, so the ky shift stays a free offset of dy
//    floats. By TMA (`cp.async.bulk.tensor`, one box of W values x 8
//    channels a staged row, W = 64 + 2dy padded to 8 mod 16) through a
//    tensor map of x as (Z X Y flattened, Cin, N): a float32 map needs
//    16-byte strides, which Z X Y % 4 == 0 gives where Y % 4 == 0 would
//    ask more; a row's values past Y or X read the next row's or plane's
//    (only outputs past the edge use them; channels past Cin, and past the
//    volume's end, read as zeros). Where no such map exists (Z X Y % 4 !=
//    0, an unaligned x) the producer's 128 threads stage the same ring by
//    4-byte cp.async with zero fill, arriving on the barrier as their
//    copies land. Where 64 + 2dy passes 216 values a row is three
//    segments of 72, one per ky, from y0 + ky dy.
//  - A fragments: each thread loads its fragment with ld.shared a tap
//    ahead (the row stride W is 8 mod 16 words, so a warp's 32 loads hit
//    32 banks) and splits it; B (hi and lo) by no-swizzle descriptor from
//    the stage.
//    Three taps' `wgmma`s are in flight a warpgroup; the promotion drains
//    one warpgroup while the other keeps the tensor cores busy.
//  - Epilogue: bias and ReLU on the totals; stores along y in NCDHW with
//    64-bit offsets (a 2-slab batch at 120x496x496 has more than 2^31
//    output elements); the producer meanwhile stages the next tile.
//  - The kernel allocates nothing: the tensor map travels as a
//    __grid_constant__ parameter (a CUDA graph captures it); the producer
//    adds the bytes it staged to `staged` (one atomic a block).
//
// This file builds only the full body, one instance per N tile; the
// ablation probe P2 (ptail_ablate.cu) builds the same body with legs
// removed.
#include "tailconv_tc_body.cuh"

// Plain C entry point, loaded with ctypes.
//   x      (N, Cin, Z, X, Y) float32, contiguous
//   wp     the weights (Cout, Cin, 3, 3, 3) split into TF32 hi and lo and
//          packed by ops/tailconv.py::pack_weights for N tile `np` (the
//          output channels of one tile: 8, 16, ..., 64 or 128,
//          tailconv.tc_plan; Cout runs as ceil(Cout/np) groups), Cout and
//          Cin zero-padded
//   bias   (Cout,) float32
//   y      (N, Cout, Z-2, X-2dx, Y-2dy) float32, written
//   staged one uint64 the kernel adds the bytes it staged to
// Launches on `stream` and returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a shape it refuses (an empty output, more than
// 2^31 - 1 tiles).
extern "C" int e2t_tailconv_tc(const float* x, const float* wp,
                               const float* bias, float* y,
                               unsigned long long* staged, int N, int Cin,
                               int Z, int X, int Y, int Cout, int np, int dx,
                               int dy, void* stream) {
  if (N < 1 || Cin < 1 || Cout < 1 || Z - 2 < 1 || X - 2 * dx < 1
      || Y - 2 * dy < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define E2T_CASE(NP)                                                       \
  case NP:                                                                 \
    return launch<NP>(x, wp, bias, y, staged, N, Cin, Z, X, Y, Cout, dx,   \
                      dy, s);
  switch (np) {
    E2T_CASE(8) E2T_CASE(16) E2T_CASE(24) E2T_CASE(32) E2T_CASE(40)
    E2T_CASE(48) E2T_CASE(56) E2T_CASE(64) E2T_CASE(128)
  }
#undef E2T_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
