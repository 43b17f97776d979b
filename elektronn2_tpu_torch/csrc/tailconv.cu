// K1 for Hopper: the dense-sweep tail conv, valid (3,3,3), z-dilation 1,
// xy-dilation (dx, dy), bias and ReLU fused, exact float32 FFMA.
//
// Replaces the Pallas TPU kernel elektronn2_tpu/ops/pallas_tailconv.py::
// conv3x3_dilated (the dense MFP path's conv2 and conv3, 93% of the
// multiply-adds per output voxel of the flagship net).
//
// What bounds it on this card: float32 FFMA throughput. One 120x496x496
// request sends about 4.6 TFLOP through this kernel (conv2 30->40 and conv3
// 40->40 channels, 27 taps each) against about 14 GB of input and output
// traffic, i.e. ~330 FLOP per byte, far above the card's FP32 ridge of ~20
// FLOP/byte. Tensor cores are not used: TF32 would break float32 parity with
// the JAX package (about 1e-3), so this first version stays on the FP32 pipe.
//
// What the design does about it: keep the FFMA pipe fed from registers.
//  * A block of up to 256 threads owns one (n, z, x) output row and a run
//    of 2 x 256 = 512 y outputs (the whole 504- or 496-wide row of the main
//    path, so its weights are staged once per row); each thread keeps
//    2 x 40 accumulators (40 output channels = one channel group) in
//    registers. 128 registers a thread, two blocks an SM; on the card this
//    measured 12% faster than 128-thread blocks with 256-wide y runs.
//    A shorter row gets a block sized to it (a multiple of 32 threads): the
//    wide U-Net's 228- to 236-wide rows take 128 threads and its 115-wide
//    bottleneck rows 64, where a 256-thread block left 55% and 78% of its
//    lanes without an output.
//  * Weights are staged in shared memory in chunks of 8 input channels
//    (8*27*40*4 = 34,560 bytes, under the 48 KB static limit), laid out
//    [ci][kz][kx][ky][co] so that every thread reads the same float4
//    (a broadcast): one LDS.128 feeds 4 x 2 FFMAs.
//  * Input reads run along y, so a warp's loads are coalesced; each input
//    value loaded feeds 40 FFMAs. Rows reused by the kx / kz taps of
//    neighbouring blocks come from L1/L2.
//  * Bias and ReLU are applied in the epilogue; stores run along y.
//  * Offsets are 64-bit: a 2-slab batch at 120x496x496 has more than 2^31
//    output elements. Ragged y (504, 496 are not multiples of 512) and Cout
//    not a multiple of 40 are masked; Cin needs no padding (the chunk loop
//    takes the remainder).
// wgmma / TMA / reduced-precision modes are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COT = 40;            // output channels per block (one group)
constexpr int THREADS = 256;       // threads per block at most
constexpr int YPT = 2;             // y outputs per thread
constexpr int CI_CHUNK = 8;        // input channels of weights staged at once
constexpr int TAPS = 27;

__global__ void __launch_bounds__(THREADS, 2)
tailconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int Cin, int Z, int X, int Y, int Cout,
                    int Zo, int Xo, int Yo, int dx, int dy) {
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
    for (int co = 0; co < COT; ++co) acc[j][co] = 0.f;

  const int64_t plane = static_cast<int64_t>(X) * Y;
  const int64_t chan = static_cast<int64_t>(Z) * plane;
  const int64_t xstep = static_cast<int64_t>(dx) * Y;
  // input row of tap (ci, kz, kx): xn + ci*chan + kz*plane + kx*xstep
  const float* xn = x + n * Cin * chan + zo * plane + static_cast<int64_t>(xo) * Y;

  for (int ci0 = 0; ci0 < Cin; ci0 += CI_CHUNK) {
    const int cc = min(CI_CHUNK, Cin - ci0);
    __syncthreads();  // every thread is done with the previous chunk
    {
      const float4* src = reinterpret_cast<const float4*>(
          wt + (static_cast<int64_t>(g) * Cin + ci0) * TAPS * COT);
      float4* dst = reinterpret_cast<float4*>(w_s);
      const int n4 = cc * TAPS * COT / 4;
      for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
    }
    __syncthreads();

    for (int c = 0; c < cc; ++c) {
      const float* xc = xn + (ci0 + c) * chan;
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
              v[ky][j] = ok[j] ? __ldg(xr + yo[j] + ky * dy) : 0.f;
          const float4* wp = reinterpret_cast<const float4*>(
              w_s + ((c * 3 + kz) * 3 + kx) * 3 * COT);
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
            for (int q = 0; q < COT / 4; ++q) {
              const float4 wv = wp[ky * (COT / 4) + q];
#pragma unroll
              for (int j = 0; j < YPT; ++j) {
                acc[j][4 * q + 0] = fmaf(v[ky][j], wv.x, acc[j][4 * q + 0]);
                acc[j][4 * q + 1] = fmaf(v[ky][j], wv.y, acc[j][4 * q + 1]);
                acc[j][4 * q + 2] = fmaf(v[ky][j], wv.z, acc[j][4 * q + 2]);
                acc[j][4 * q + 3] = fmaf(v[ky][j], wv.w, acc[j][4 * q + 3]);
              }
            }
          }
        }
      }
    }
  }

  // epilogue: bias + ReLU, stores along y
  const int64_t ostride = static_cast<int64_t>(Zo) * Xo * Yo;  // per channel
  float* yrow = y + (n * Cout + static_cast<int64_t>(g) * COT) * ostride
                + static_cast<int64_t>(zo) * Xo * Yo
                + static_cast<int64_t>(xo) * Yo;
#pragma unroll
  for (int co = 0; co < COT; ++co) {
    if (g * COT + co < Cout) {
      const float bv = __ldg(bias + g * COT + co);
#pragma unroll
      for (int j = 0; j < YPT; ++j)
        if (ok[j]) yrow[co * ostride + yo[j]] = fmaxf(acc[j][co] + bv, 0.f);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   x    (N, Cin, Z, X, Y) float32, contiguous
//   wt   (G, Cin, 27, 40) float32: the weights (Cout, Cin, 3, 3, 3)
//        regrouped by the wrapper, Cout zero-padded to G*40
//   bias (G*40,) float32, zero-padded
//   y    (N, Cout, Z-2, X-2dx, Y-2dy) float32, written
// Launches on `stream` and returns cudaGetLastError() (0 on success): a
// refused launch shows only there.
extern "C" int e2t_tailconv_f32(const float* x, const float* wt,
                                const float* bias, float* y, int N, int Cin,
                                int Z, int X, int Y, int Cout, int dx, int dy,
                                void* stream) {
  const int Zo = Z - 2, Xo = X - 2 * dx, Yo = Y - 2 * dy;
  if (N < 1 || Cin < 1 || Cout < 1 || Zo < 1 || Xo < 1 || Yo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (Cout + COT - 1) / COT;
  // threads: enough for the row's y outputs, a multiple of 32, at most 256
  const int threads = min(THREADS, ((Yo + YPT - 1) / YPT + 31) / 32 * 32);
  const int yt = threads * YPT;
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(N) * Zo * Xo),
                  static_cast<unsigned>((Yo + yt - 1) / yt),
                  static_cast<unsigned>(G));
  tailconv_f32_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wt, bias, y, Cin, Z, X, Y, Cout, Zo, Xo, Yo, dx, dy);
  return static_cast<int>(cudaGetLastError());
}

// The channel-group width the wrapper must regroup the weights to.
extern "C" int e2t_tailconv_cout_tile() { return COT; }
