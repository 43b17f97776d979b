// P2 for Hopper: ablation probes of K1, the tensor-core tail conv. WRONG
// VALUES except for `full` and `noepi`: the other probes are for timing
// only.
//
// Replaces the Pallas TPU probe kernel scripts/exp_ptail_ablate.py::main.
// make (its pallas_call), which is the production tail body with legs
// removed. So is this file: it builds K1's own body, tailconv_tc_kernel of
// tailconv_tc_body.cuh, once per probe, the probe a template parameter that
// removes legs at compile time. `full` is K1 (the same instance text, so
// the same values bit for bit); the header lists the legs (dma, stage, dot,
// epi, out) and what each probe keeps.
//
// Instances: the eight probes at the N tiles the probe's runs and tests
// use, 40 (the flagship's Cout 40), 48 (Cout 45) and 128 (the U-Net's
// Cout 128 and 256): 24 instances. Each holds 9 wgmmas a stage when it has
// the dot leg and none without; the build counts against chip_smoke.py's
// time, so the other six N tiles of K1 are not built here.
//
// What bounds it on this card: K1's bound, three TF32 products per
// multiply-add at 495 TFLOP/s; a probe's time against `full`'s says what
// the legs it drops cost.

#include "tailconv_tc_body.cuh"

namespace {

using ProbeLaunch = int (*)(const float*, const float*, const float*, float*,
                            int, int, int, int, int, int, int, int,
                            cudaStream_t);

// one launch per probe, in Probe order, for N tile NP
template <int NP>
constexpr ProbeLaunch PROBE_LAUNCH[N_PROBES] = {
    launch<NP, FULL>, launch<NP, NODOT>, launch<NP, NOSTAGE>,
    launch<NP, NOEPI>, launch<NP, DOTONLY>, launch<NP, NONE>,
    launch<NP, DMAONLY>, launch<NP, OUTONLY>};

}  // namespace

// Plain C entry point, loaded with ctypes. The arguments are K1's
// (e2t_tailconv_tc) with the probe's index first:
//   probe 0..7 = full, nodot, nostage, noepi, dotonly, none, dmaonly, outonly
//   x    (N, Cin, Z, X, Y) float32, contiguous
//   wp   the weights packed for N tile `np` by ops/tailconv.py::pack_weights
//   bias (Cout,) float32
//   y    (N, Cout, Z-2, X-2dx, Y-2dy) float32; for dmaonly a block of
//        e2t_ptail_ablate_tiny() floats
//   np   40, 48 or 128 (cudaErrorInvalidValue for another tile)
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int e2t_ptail_ablate(int probe, const float* x, const float* wp,
                                const float* bias, float* y, int N, int Cin,
                                int Z, int X, int Y, int Cout, int np, int dx,
                                int dy, void* stream) {
  if (probe < 0 || probe >= N_PROBES || N < 1 || Cin < 1 || Cout < 1
      || Z - 2 < 1 || X - 2 * dx < 1 || Y - 2 * dy < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define E2T_CASE(NP)                                                       \
  case NP:                                                                 \
    return PROBE_LAUNCH<NP>[probe](x, wp, bias, y, N, Cin, Z, X, Y, Cout,  \
                                   dx, dy, s);
  switch (np) {
    E2T_CASE(40) E2T_CASE(48) E2T_CASE(128)
  }
#undef E2T_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Floats in dmaonly's shared output block.
extern "C" int e2t_ptail_ablate_tiny() { return THREADS; }
