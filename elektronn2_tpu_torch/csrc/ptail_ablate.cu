// P2 for Hopper: ablation probes of K1's per-row cost. WRONG VALUES except
// for `full` and `noepi`: the other probes are for timing only.
//
// Replaces the Pallas TPU probe kernel scripts/exp_ptail_ablate.py::main.
// make (its pallas_call), which is a standalone copy of the TPU tail conv's
// body with legs removed. This file is the same for the card: a standalone
// copy of the FFMA body K1 had until its redesign as a 3xTF32 tensor-core
// GEMM (csrc/tailconv.cu before then, tailconv_f32_kernel), with the probe
// as a template parameter. It probes that FFMA design and is kept as it
// was: the probe script prints the redesigned K1's time (`k1_ms`) beside
// this body's `full`, so the gap between them is the redesign's gain, not
// drift.
//
// The FFMA body's legs on the card:
//   dma   its global input loads (__ldg along y)
//   stage its shared-memory weight staging, 8 input channels at a time
//   dot   the FFMA loop: 40 FFMAs per loaded value, weights from shared memory
//   epi   bias + ReLU
//   out   the stores along y
// Probes:
//   full     the FFMA body unchanged
//   nodot    loads, staging, epilogue; each loaded value is folded into the
//            accumulators with one add instead of 40 FFMAs
//   nostage  the dot reads its weights with __ldg from global memory, no
//            shared-memory staging
//   noepi    stores the raw accumulators (no bias, no ReLU)
//   dotonly  the FFMA loop on register values, no input loads, weights
//            staged once; raw stores
//   none     loads and stores only
//   dmaonly  loads; every block writes one shared tiny block
//   outonly  stores only
//
// Keeping each leg live: a value that is loaded is always added into an
// accumulator that is stored; the staged weights are read in every probe
// that stages them (nodot reads one word per input channel); dotonly's
// register values and outonly's stored value come from a run-time argument.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COT = 40;            // output channels per block (one group)
constexpr int THREADS = 256;       // threads per block at most
constexpr int YPT = 2;             // y outputs per thread
constexpr int CI_CHUNK = 8;        // input channels of weights staged at once
constexpr int TAPS = 27;

enum Probe { FULL, NODOT, NOSTAGE, NOEPI, DOTONLY, NONE, DMAONLY, OUTONLY,
             N_PROBES };

template <int P>
__global__ void __launch_bounds__(THREADS, 2)
ablate_kernel(const float* __restrict__ x, const float* __restrict__ wt,
              const float* __restrict__ bias, float* __restrict__ y,
              int Cin, int Z, int X, int Y, int Cout,
              int Zo, int Xo, int Yo, int dx, int dy, float fill) {
  constexpr bool LOADS = P != DOTONLY && P != OUTONLY;
  constexpr bool STAGE = P == FULL || P == NODOT || P == NOEPI
                         || P == DOTONLY;
  constexpr bool DOT = P == FULL || P == NOSTAGE || P == NOEPI
                       || P == DOTONLY;
  constexpr bool EPI = P == FULL || P == NODOT || P == NOSTAGE;
  __shared__ __align__(16) float w_s[CI_CHUNK * TAPS * COT];

  const int64_t row = blockIdx.x;            // (n, zo, xo), xo fastest
  const int xo = static_cast<int>(row % Xo);
  const int64_t t = row / Xo;
  const int zo = static_cast<int>(t % Zo);
  const int64_t n = t / Zo;
  const int g = blockIdx.z;                  // output-channel group

  int yo[YPT];
  bool ok[YPT];
#pragma unroll
  for (int j = 0; j < YPT; ++j) {
    yo[j] = (blockIdx.y * YPT + j) * blockDim.x + threadIdx.x;
    ok[j] = yo[j] < Yo;
  }

  float acc[YPT][COT];
#pragma unroll
  for (int j = 0; j < YPT; ++j)
#pragma unroll
    for (int co = 0; co < COT; ++co) acc[j][co] = P == OUTONLY ? fill : 0.f;

  const int64_t plane = static_cast<int64_t>(X) * Y;
  const int64_t chan = static_cast<int64_t>(Z) * plane;
  const int64_t xstep = static_cast<int64_t>(dx) * Y;
  const float* xn = x + n * Cin * chan + zo * plane + static_cast<int64_t>(xo) * Y;

  if (P == DOTONLY) {  // the weights of the first chunk, staged once
    const float4* src = reinterpret_cast<const float4*>(
        wt + static_cast<int64_t>(g) * Cin * TAPS * COT);
    float4* dst = reinterpret_cast<float4*>(w_s);
    const int n4 = min(CI_CHUNK, Cin) * TAPS * COT / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
    __syncthreads();
  }

  if (P != OUTONLY) {
    for (int ci0 = 0; ci0 < Cin; ci0 += CI_CHUNK) {
      const int cc = min(CI_CHUNK, Cin - ci0);
      if (STAGE && P != DOTONLY) {
        __syncthreads();  // every thread is done with the previous chunk
        const float4* src = reinterpret_cast<const float4*>(
            wt + (static_cast<int64_t>(g) * Cin + ci0) * TAPS * COT);
        float4* dst = reinterpret_cast<float4*>(w_s);
        const int n4 = cc * TAPS * COT / 4;
        for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
        __syncthreads();
      }

      for (int c = 0; c < cc; ++c) {
        const float* xc = xn + (ci0 + c) * chan;
        if (P == NODOT)  // read the staged weights: one word per channel
          acc[0][1] += w_s[(c * TAPS + threadIdx.x % TAPS) * COT];
#pragma unroll
        for (int kz = 0; kz < 3; ++kz) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* xr = xc + kz * plane + kx * xstep;
            float v[3][YPT];
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
              for (int j = 0; j < YPT; ++j)
                v[ky][j] = LOADS ? (ok[j] ? __ldg(xr + yo[j] + ky * dy) : 0.f)
                                 : fill + static_cast<float>(ky * YPT + j);
            if (DOT) {
              const int tap = ((c * 3 + kz) * 3 + kx) * 3 * COT;
              const float4* wp = reinterpret_cast<const float4*>(w_s + tap);
              const float4* wg = reinterpret_cast<const float4*>(
                  wt + ((static_cast<int64_t>(g) * Cin + ci0) * TAPS) * COT
                  + tap);
#pragma unroll
              for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
                for (int q = 0; q < COT / 4; ++q) {
                  const float4 wv = STAGE ? wp[ky * (COT / 4) + q]
                                          : __ldg(wg + ky * (COT / 4) + q);
#pragma unroll
                  for (int j = 0; j < YPT; ++j) {
                    acc[j][4 * q + 0] = fmaf(v[ky][j], wv.x, acc[j][4 * q + 0]);
                    acc[j][4 * q + 1] = fmaf(v[ky][j], wv.y, acc[j][4 * q + 1]);
                    acc[j][4 * q + 2] = fmaf(v[ky][j], wv.z, acc[j][4 * q + 2]);
                    acc[j][4 * q + 3] = fmaf(v[ky][j], wv.w, acc[j][4 * q + 3]);
                  }
                }
              }
            } else {  // one add per loaded value
#pragma unroll
              for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                for (int j = 0; j < YPT; ++j) acc[j][0] += v[ky][j];
            }
          }
        }
      }
    }
  }

  if (P == DMAONLY) {  // every block writes the same tiny block
#pragma unroll
    for (int j = 0; j < YPT; ++j) y[j * blockDim.x + threadIdx.x] = acc[j][0];
    return;
  }

  // epilogue: bias + ReLU (EPI), stores along y
  const int64_t ostride = static_cast<int64_t>(Zo) * Xo * Yo;  // per channel
  float* yrow = y + (n * Cout + static_cast<int64_t>(g) * COT) * ostride
                + static_cast<int64_t>(zo) * Xo * Yo
                + static_cast<int64_t>(xo) * Yo;
#pragma unroll
  for (int co = 0; co < COT; ++co) {
    if (g * COT + co < Cout) {
      const float bv = EPI ? __ldg(bias + g * COT + co) : 0.f;
#pragma unroll
      for (int j = 0; j < YPT; ++j)
        if (ok[j])
          yrow[co * ostride + yo[j]] =
              EPI ? fmaxf(acc[j][co] + bv, 0.f) : acc[j][co];
    }
  }
}

using AblateKernel = void (*)(const float*, const float*, const float*,
                              float*, int, int, int, int, int, int, int, int,
                              int, int, float);

// one instance per probe, in Probe order
const AblateKernel KERNELS[N_PROBES] = {
    ablate_kernel<FULL>, ablate_kernel<NODOT>, ablate_kernel<NOSTAGE>,
    ablate_kernel<NOEPI>, ablate_kernel<DOTONLY>, ablate_kernel<NONE>,
    ablate_kernel<DMAONLY>, ablate_kernel<OUTONLY>};

}  // namespace

// Plain C entry point, loaded with ctypes. The arguments are the FFMA
// body's (its entry e2t_tailconv_f32), with the probe's index first and
// `fill` last:
//   probe 0..7 = full, nodot, nostage, noepi, dotonly, none, dmaonly, outonly
//   x    (N, Cin, Z, X, Y) float32, contiguous
//   wt   (G, Cin, 27, 40) float32, as ops/tailconv.py::regroup_weights
//        gives them
//   bias (G*40,) float32
//   y    (N, Cout, Z-2, X-2dx, Y-2dy) float32; for dmaonly a block of
//        e2t_ptail_ablate_tiny() floats
//   fill a run-time value for dotonly's registers and outonly's stores
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int e2t_ptail_ablate_f32(int probe, const float* x, const float* wt,
                                    const float* bias, float* y, int N,
                                    int Cin, int Z, int X, int Y, int Cout,
                                    int dx, int dy, float fill, void* stream) {
  const int Zo = Z - 2, Xo = X - 2 * dx, Yo = Y - 2 * dy;
  if (probe < 0 || probe >= N_PROBES || N < 1 || Cin < 1 || Cout < 1
      || Zo < 1 || Xo < 1 || Yo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (Cout + COT - 1) / COT;
  const int threads = min(THREADS, ((Yo + YPT - 1) / YPT + 31) / 32 * 32);
  const int yt = threads * YPT;
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(N) * Zo * Xo),
                  static_cast<unsigned>((Yo + yt - 1) / yt),
                  static_cast<unsigned>(G));
  KERNELS[probe]<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wt, bias, y, Cin, Z, X, Y, Cout, Zo, Xo, Yo, dx, dy, fill);
  return static_cast<int>(cudaGetLastError());
}

// The channel-group width the wrapper must regroup the weights to.
extern "C" int e2t_ptail_ablate_cout_tile() { return COT; }

// Floats in dmaonly's shared output block.
extern "C" int e2t_ptail_ablate_tiny() { return THREADS * YPT; }
