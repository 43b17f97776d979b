// K5 for Hopper: the im2col dilated conv, valid (3,3,3) with isotropic
// dilation d, no bias, no ReLU, exact float32 FFMA, in the (Z, X, Cin, Y)
// activation layout of the JAX package's experimental kernel.
//
// Replaces the Pallas TPU kernel elektronn2_tpu/ops/experimental/
// pallas_dilated_conv.py::dilated_conv_pallas. The TPU kernel gathered the
// 27 taps of one output row into an im2col buffer so that its matrix unit
// saw one K = 27*Cin contraction. On this card the contraction runs on the
// FP32 pipe, and the im2col buffer is the order of the loop: every thread
// walks (ci, kz, kx, ky), the whole K, for its own y outputs, so no buffer
// is written to memory at all.
//
// What bounds it on this card: float32 FFMA throughput. Its own benchmark
// shape (x 44x307x30x640, Cout 40, d 4, Yo 512) is 3.57e11 FLOP against
// 1.92 GB of input and output, about 190 FLOP per byte, far above the FP32
// ridge of ~20 FLOP/byte.
//
// What the design does about it (the design of K1, csrc/tailconv.cu, in
// this layout): keep the FFMA pipe fed from registers.
//  * A block owns one (zo, xo) output row and a run of 2 x blockDim y
//    outputs (256 threads cover a 512-wide row, a shorter row gets a block
//    sized to it, a multiple of 32 threads); each thread keeps 2 x 40
//    accumulators (one group of 40 output channels) in registers.
//  * Weights are staged in shared memory in chunks of 8 input channels
//    (34,560 bytes), laid out [ci][kz][kx][ky][co], so every thread reads
//    the same float4 (a broadcast) and one LDS.128 feeds 4 x 2 FFMAs.
//  * In this layout the Cin rows of one (z, x) input position are one
//    contiguous run of Cin*Y floats; reads run along y, coalesced, and each
//    value feeds 40 FFMAs. Rows shared with neighbouring blocks' taps come
//    from L1/L2.
//  * Output rows (co, y) are stored along y. Channels Cout..Cout_pad-1 are
//    written as exact zeros, as the TPU kernel's padded weight rows give.
//  * Offsets are 64-bit. Y may be longer than Yo + 2d (an over-padded
//    input); Cin needs no padding (the chunk loop takes the remainder).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COT = 40;            // output channels per block (one group)
constexpr int THREADS = 256;       // threads per block at most
constexpr int YPT = 2;             // y outputs per thread
constexpr int CI_CHUNK = 8;        // input channels of weights staged at once
constexpr int TAPS = 27;

__global__ void __launch_bounds__(THREADS, 2)
dilated_conv_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ wt, float* __restrict__ y,
                        int X, int Cin, int Y, int Cout, int Cout_pad,
                        int Xo, int Yo, int d) {
  __shared__ __align__(16) float w_s[CI_CHUNK * TAPS * COT];

  const int64_t row = blockIdx.x;            // (zo, xo), xo fastest
  const int xo = static_cast<int>(row % Xo);
  const int zo = static_cast<int>(row / Xo);
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

  const int64_t crow = static_cast<int64_t>(Cin) * Y;   // one (z, x) position
  const int64_t zstep = static_cast<int64_t>(d) * X * crow;
  const int64_t xstep = static_cast<int64_t>(d) * crow;
  const int ystep = d;
  // input row of tap (ci, kz, kx): xz + ci*Y + kz*zstep + kx*xstep
  const float* xz = x + (static_cast<int64_t>(zo) * X + xo) * crow;

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
      const float* xc = xz + static_cast<int64_t>(ci0 + c) * Y;
#pragma unroll
      for (int kz = 0; kz < 3; ++kz) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* xr = xc + kz * zstep + kx * xstep;
          float v[3][YPT];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int j = 0; j < YPT; ++j)
              v[ky][j] = ok[j] ? __ldg(xr + yo[j] + ky * ystep) : 0.f;
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

  // stores along y into (Zo, Xo, Cout_pad, Yo); pad channels are zeros
  float* yrow = y + (row * Cout_pad + static_cast<int64_t>(g) * COT) * Yo;
#pragma unroll
  for (int co = 0; co < COT; ++co) {
    const int c_out = g * COT + co;
    if (c_out < Cout_pad) {
      const bool real = c_out < Cout;
#pragma unroll
      for (int j = 0; j < YPT; ++j)
        if (ok[j])
          yrow[static_cast<int64_t>(co) * Yo + yo[j]] = real ? acc[j][co] : 0.f;
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   x  (Z, X, Cin, Y) float32, contiguous; Y >= Yo + 2d
//   wt (G, Cin, 27, 40) float32: the weights (Cout, Cin, 3, 3, 3)
//      regrouped by the wrapper, Cout zero-padded to G*40
//   y  (Z-2d, X-2d, Cout_pad, Yo) float32, written in full
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int e2t_dilated_conv_f32(const float* x, const float* wt, float* y,
                                    int Z, int X, int Cin, int Y, int Cout,
                                    int Cout_pad, int Yo, int d,
                                    void* stream) {
  const int Zo = Z - 2 * d, Xo = X - 2 * d;
  if (Cin < 1 || Cout < 1 || Cout_pad < Cout || d < 1 || Zo < 1 || Xo < 1
      || Yo < 1 || Yo > Y - 2 * d)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (Cout_pad + COT - 1) / COT;
  const int threads = min(THREADS, ((Yo + YPT - 1) / YPT + 31) / 32 * 32);
  const int yt = threads * YPT;
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(Zo) * Xo),
                  static_cast<unsigned>((Yo + yt - 1) / yt),
                  static_cast<unsigned>(G));
  dilated_conv_f32_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, wt, y, X, Cin, Y, Cout, Cout_pad, Xo, Yo, d);
  return static_cast<int>(cudaGetLastError());
}

// The channel-group width the wrapper must regroup the weights to.
extern "C" int e2t_dilated_conv_cout_tile() { return COT; }
