// K4 for Hopper: the head unit. A valid (1,3,3) conv with isotropic
// xy-dilation d, plus bias, an optional stride-1 (2,2) max window dilated
// by d, then ReLU, in one pass, exact float32 FFMA.
//
// Replaces the Pallas TPU kernel elektronn2_tpu/ops/pallas_tailconv.py::
// conv1x3x3_pool_dilated (the flagship's conv0+pool0 and conv1+pool1 in
// the dense sweep, and the kz=1 layers of the conv-dense U-Net path).
//
// What bounds it on this card: it depends on the layer. conv0 of the
// flagship (1 -> 20 channels, d=1) does 9 multiply-adds per input voxel and
// output channel: ~12 GFLOP against ~2.8 GB of output, so it is bound by
// the bytes it writes (~0.8 ms at 3.35 TB/s). conv1 (20 -> 30, d=2) does
// 354 GFLOP against ~2 GB: bound by FP32 FFMA throughput (~5.3 ms at 67
// TFLOP/s). cuDNN runs the same unit as a conv, a max pool that also
// writes int64 indices, a bias add and a ReLU: four round trips of the
// full-size map through device memory.
//
// What the design does about it: nothing but the pooled output reaches
// device memory, and every conv value is computed once in its block.
//  * A block owns a strip of ROWS output rows of one (n, z) plane, a run of
//    output columns and COT = 16 output channels. It walks the strip's conv
//    rows in order; each thread computes YPT = 2 conv columns x 16
//    channels in registers (the input row loads run along y, coalesced; one
//    weight float4 read from shared memory is a broadcast feeding 8 FFMAs).
//  * With pool=2 the biased conv rows go to a ring of d+1 rows in shared
//    memory; conv row r completes output row r-d: the max over conv rows
//    r-d and r at columns c and c+d, then ReLU, then one store along y.
//    The strip recomputes d conv rows of its neighbour ((ROWS+d)/ROWS
//    conv work) and a block run of columns d columns of the next run.
//  * Weights are staged in shared memory in chunks of 16 input channels
//    (16*9*16*4 = 9,216 bytes), once per block when Cin <= 16. The ring
//    takes the rest of the dynamic shared memory: at d=2 and 320 columns,
//    61 KB, so three blocks fit on an SM.
//  * Offsets are 64-bit: the probe's wide U-Net layer e0a writes ~2^31
//    floats. Ragged Y, X and Cout (not a multiple of 16) are masked.
// Tensor cores (3xTF32 for float32 parity), a channels-last layout and a
// register ring for the x pool are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COT = 16;            // output channels per block (one group)
constexpr int YPT = 2;             // conv columns per thread
constexpr int MAX_THREADS = 256;   // threads per block at most
constexpr int CI_CHUNK = 16;       // input channels of weights staged at once
constexpr int ROWS = 16;           // output rows per block (the x strip)
constexpr int TAPS = 9;
constexpr int SMEM_LIMIT = 232448; // dynamic shared memory a block may use

__device__ __forceinline__ void stage_weights(float* w_s, const float* wt,
                                              int g, int Cin, int ci0,
                                              int cc) {
  const float4* src = reinterpret_cast<const float4*>(
      wt + (static_cast<int64_t>(g) * Cin + ci0) * TAPS * COT);
  float4* dst = reinterpret_cast<float4*>(w_s);
  const int n4 = cc * TAPS * COT / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
}

template <int POOL>
__global__ void __launch_bounds__(MAX_THREADS)
headconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int Cin, int Z, int X, int Y, int Cout, int Xo, int Yo,
                    int d, int n_strips, int ystep) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                            // [CI_CHUNK][3][3][COT]
  float* ring = smem + CI_CHUNK * TAPS * COT;   // [d+1][COT][cols], pool=2
  const int cols = blockDim.x * YPT;
  const int dp = d * (POOL - 1);

  const int64_t bx = blockIdx.x;                // (n, z, strip), strip fastest
  const int strip = static_cast<int>(bx % n_strips);
  const int64_t t = bx / n_strips;
  const int z = static_cast<int>(t % Z);
  const int64_t n = t / Z;
  const int g = blockIdx.z;                     // output-channel group
  const int out0 = blockIdx.y * ystep;          // first output column
  const int n_out = min(ystep, Yo - out0);
  const int xo0 = strip * ROWS;
  const int rows_conv = min(ROWS, Xo - xo0) + dp;
  const int n_co = min(COT, Cout - g * COT);

  int cl[YPT];                                  // column within the block
  bool ok[YPT];                                 // a conv column we need
#pragma unroll
  for (int j = 0; j < YPT; ++j) {
    cl[j] = threadIdx.x + j * blockDim.x;
    ok[j] = cl[j] < n_out + dp;
  }
  float bv[COT];
#pragma unroll
  for (int co = 0; co < COT; ++co) bv[co] = __ldg(bias + g * COT + co);

  const int64_t plane = static_cast<int64_t>(X) * Y;
  const int64_t chan = static_cast<int64_t>(Z) * plane;
  const float* xz = x + n * Cin * chan + z * plane + out0;
  const int64_t oplane = static_cast<int64_t>(Xo) * Yo;
  const int64_t ochan = static_cast<int64_t>(Z) * oplane;
  float* yz = y + (n * Cout + static_cast<int64_t>(g) * COT) * ochan
              + z * oplane + out0;
  const int n_chunks = (Cin + CI_CHUNK - 1) / CI_CHUNK;

  if (n_chunks == 1) {
    stage_weights(w_s, wt, g, Cin, 0, Cin);
    __syncthreads();
  }
  for (int r = 0; r < rows_conv; ++r) {
    const int xc = xo0 + r;                     // conv row
    float acc[YPT][COT];
#pragma unroll
    for (int j = 0; j < YPT; ++j)
#pragma unroll
      for (int co = 0; co < COT; ++co) acc[j][co] = 0.f;

    for (int ch = 0; ch < n_chunks; ++ch) {
      const int ci0 = ch * CI_CHUNK;
      const int cc = min(CI_CHUNK, Cin - ci0);
      if (n_chunks > 1) {
        __syncthreads();        // every thread is done with the last chunk
        stage_weights(w_s, wt, g, Cin, ci0, cc);
        __syncthreads();
      }
      for (int c = 0; c < cc; ++c) {
        const float* xr0 = xz + (ci0 + c) * chan + static_cast<int64_t>(xc) * Y;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* xr = xr0 + static_cast<int64_t>(kx) * d * Y;
          float v[3][YPT];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int j = 0; j < YPT; ++j)
              v[ky][j] = ok[j] ? __ldg(xr + cl[j] + ky * d) : 0.f;
          const float4* wp = reinterpret_cast<const float4*>(
              w_s + (c * 3 + kx) * 3 * COT);
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

    if (POOL == 1) {
      // conv row == output row: bias + ReLU, stores along y
      float* yr = yz + static_cast<int64_t>(xc) * Yo;
#pragma unroll
      for (int co = 0; co < COT; ++co) {
        if (co < n_co) {
#pragma unroll
          for (int j = 0; j < YPT; ++j)
            if (cl[j] < n_out)
              yr[co * ochan + cl[j]] = fmaxf(acc[j][co] + bv[co], 0.f);
        }
      }
    } else {
      float* cur = ring + (r % (d + 1)) * COT * cols;
#pragma unroll
      for (int co = 0; co < COT; ++co)
#pragma unroll
        for (int j = 0; j < YPT; ++j)
          if (ok[j]) cur[co * cols + cl[j]] = acc[j][co] + bv[co];
      __syncthreads();
      if (r >= d) {
        // output row xc - d: max over conv rows xc - d and xc, columns c
        // and c + d, then ReLU (the reference pools before the activation;
        // the same for a monotone ReLU)
        const float* prev = ring + ((r - d) % (d + 1)) * COT * cols;
        float* yr = yz + static_cast<int64_t>(xc - d) * Yo;
        for (int co = 0; co < n_co; ++co) {
#pragma unroll
          for (int j = 0; j < YPT; ++j) {
            const int c = cl[j];
            if (c < n_out) {
              const int o = co * cols + c;
              const float m = fmaxf(fmaxf(prev[o], prev[o + d]),
                                    fmaxf(cur[o], cur[o + d]));
              yr[co * ochan + c] = fmaxf(m, 0.f);
            }
          }
        }
      }
      __syncthreads();          // the slot read here is written next
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   x    (N, Cin, Z, X, Y) float32, contiguous
//   wt   (G, Cin, 3, 3, 16) float32: the weights (Cout, Cin, 1, 3, 3)
//        regrouped by the wrapper, Cout zero-padded to G*16
//   bias (G*16,) float32, zero-padded
//   y    (N, Cout, Z, X-2d-d(pool-1), Y-2d-d(pool-1)) float32, written
// Launches on `stream` and returns a CUDA error code (0 on success): a
// refused launch shows only there.
extern "C" int e2t_headconv_f32(const float* x, const float* wt,
                                const float* bias, float* y, int N, int Cin,
                                int Z, int X, int Y, int Cout, int d,
                                int pool, void* stream) {
  if (pool != 1 && pool != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int dp = d * (pool - 1);
  const int Xo = X - 2 * d - dp, Yo = Y - 2 * d - dp;
  if (N < 1 || Cin < 1 || Cout < 1 || Z < 1 || d < 1 || Xo < 1 || Yo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w_bytes = CI_CHUNK * TAPS * COT * static_cast<int>(sizeof(float));
  // conv columns per block: as many as the threads and, with a ring, the
  // shared memory allow; runs of columns overlap by dp conv columns
  int max_cols = MAX_THREADS * YPT;
  if (pool == 2) {
    const int per_col = (d + 1) * COT * static_cast<int>(sizeof(float));
    max_cols = min(max_cols, (SMEM_LIMIT - w_bytes) / per_col / 32 * 32);
  }
  if (max_cols - dp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nby = (Yo + max_cols - dp - 1) / (max_cols - dp);
  const int ystep = (Yo + nby - 1) / nby;
  const int threads = ((ystep + dp + YPT - 1) / YPT + 31) / 32 * 32;
  const int cols = threads * YPT;
  const int smem = w_bytes + (pool == 2 ? (d + 1) * COT * cols
                                              * static_cast<int>(sizeof(float))
                                        : 0);
  const int n_strips = (Xo + ROWS - 1) / ROWS;
  const int G = (Cout + COT - 1) / COT;
  const int64_t nblk = static_cast<int64_t>(N) * Z * n_strips;
  if (nblk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(nby),
                  static_cast<unsigned>(G));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pool == 1) {
    err = cudaFuncSetAttribute(headconv_f32_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    headconv_f32_kernel<1><<<grid, threads, smem, s>>>(
        x, wt, bias, y, Cin, Z, X, Y, Cout, Xo, Yo, d, n_strips, ystep);
  } else {
    err = cudaFuncSetAttribute(headconv_f32_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    headconv_f32_kernel<2><<<grid, threads, smem, s>>>(
        x, wt, bias, y, Cin, Z, X, Y, Cout, Xo, Yo, d, n_strips, ystep);
  }
  return static_cast<int>(cudaGetLastError());
}

// The channel-group width the wrapper must regroup the weights to.
extern "C" int e2t_headconv_cout_tile() { return COT; }
