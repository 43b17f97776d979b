// K4 for Hopper: the head unit. A valid (1,3,3) conv with isotropic
// xy-dilation d, plus bias, an optional stride-1 (2,2) max window dilated
// by d, then ReLU, in one pass, at float32 accuracy. Two bodies: a 3xTF32
// implicit GEMM on `wgmma` (headconv_tc_kernel) and exact float32 FFMA
// (headconv_f32_kernel); ops/tailconv.py::conv1x3x3_pool_dilated picks one
// by Cin (head_body, with the measured crossovers).
//
// Replaces the Pallas TPU kernel elektronn2_tpu/ops/pallas_tailconv.py::
// conv1x3x3_pool_dilated (the flagship's conv0+pool0 and conv1+pool1 in
// the dense sweep, and the kz=1 layers of the conv-dense U-Net path).
//
// What bounds it on this card: it depends on the layer. conv0 of the
// flagship (1 -> 20 channels, d=1) does 9 multiply-adds per input voxel and
// output channel: ~12 GFLOP against ~2.8 GB of output, so it is bound by
// the bytes it writes (~0.8 ms at 3.35 TB/s). conv1 (20 -> 30, d=2) does
// 354 GFLOP against ~2 GB and the wide U-Net's d0 (128 -> 64) 3.9 TFLOP:
// bound by the float32-grade rate, three TF32 products per multiply-add at
// 495 TFLOP/s (2.1 and 23.6 ms). cuDNN runs the same unit as a conv, a max
// pool that also writes int64 indices, a bias add and a ReLU: four round
// trips of the full-size map through device memory.
//
// The tensor-core body is K1's GEMM (tailconv.cu) with kz = 1: M = conv
// columns along y of one conv row (two warpgroups of one 64-column tile,
// 128 columns a block), N = Cout padded to a multiple of 8 up to 64 (pool
// 1: else 128-channel groups in the grid; pool 2: 64-channel groups, so
// that the pool ring fits beside the stage ring), K = 9 taps x Cin walked
// in stages of (8-channel chunk, kx), each 3 ky shifts x 3 TF32 terms of
// one m64nNk8 `wgmma`, A from registers at y offsets 0, d, 2d of one staged
// row, B packed on the host (ops/tailconv.py::pack_weights, kz = 1). The
// partials of each chunk (72 products per output) are added into float32
// totals after `wgmma.wait_group 0`, so the totals are never `wgmma`
// operands (reading live accumulators would serialize `wgmma`, ptxas
// C7514). A block owns a strip of TC_ROWS output rows and OC = 128 - d(pool
// - 1) output columns; its cp.async stage ring runs on across the strip's
// conv rows, and up to N = 64 two blocks share an SM (TcShape). Each
// finished conv row, biased, goes to a shared-memory
// ring; with pool = 2 the strip's conv rows are walked in chains x, x+d,
// x+2d, ... so that output row r, the max over conv rows r and r+d at
// columns c and c+d, needs only the last two conv rows: two slots of 64 x
// 132 floats whatever d. Output rows are stored along y from the ring,
// coalesced, with 64-bit offsets (the probe's e0a writes ~2^31 floats); the
// strip recomputes d conv rows and a block d conv columns of its
// neighbours; ragged y and padded channels are masked.
//
// The FFMA body: a block owns a strip of ROWS output rows of one (n, z)
// plane, a run of output columns and COT = 16 output channels; each thread
// computes YPT = 2 conv columns x 16 channels in registers, the weights
// staged in shared memory in chunks of 16 input channels; with pool=2 the
// biased conv rows go to a ring of d+1 rows in shared memory.

#include "wgmma_tf32.cuh"

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
  extern __shared__ __align__(128) float smem[];
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


// ---- the tensor-core body

constexpr int TC_WG = 2;                 // warpgroups per block
constexpr int TC_THREADS = TC_WG * 128;
constexpr int TC_COLS = TC_WG * 64;      // conv columns per block
constexpr int TC_ROWS = 32;              // output rows per block (the strip)
// row stride of the conv-tile ring: 4 mod 32 words, so that a warp's
// fragment writes (8 columns x 4 channel pairs) hit 32 banks
constexpr int RING_RS = TC_COLS + 4;

// Blocks per SM and shared-memory ring depth of an N tile: up to N = 64,
// two blocks (128 registers a thread; ptxas spills up to 96 bytes at some
// N from 40 to 64) of a 4-stage ring, so that one block's barrier and load
// waits hide behind the other's wgmmas (on an H100, against one block of 5
// stages: flagship conv1, N = 32, 21.3 -> 16.2 ms; the wide U-Net's d0,
// N = 64, 85.1 -> 76.1 ms; scripts/exp_headconv_tc.py); above, one block
// of 5 stages, as K1.
template <int NP>
struct TcShape {
  static constexpr int BLOCKS = NP <= 64 ? 2 : 1;
  static constexpr int STAGES = NP <= 64 ? 4 : 5;
};

// the conv row after `row` in the strip's walk: chains row, row+step, ...,
// then the next chain (step = d with pool 2, else 1)
__device__ __forceinline__ int next_conv_row(int row, int step, int n_conv) {
  row += step;
  return row < n_conv ? row : row % step + 1;
}

// One block: conv columns y0 .. y0+127 of the conv rows of one strip of
// output rows (n, z, xo0 .. xo0+TC_ROWS-1), output channels g*NP ..
// g*NP+NP-1. `RS` is the staged row stride (>= 128 + 2d, 8 mod 32).
template <int NP>
__global__ void __launch_bounds__(TC_THREADS, TcShape<NP>::BLOCKS)
headconv_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int Cin, int Z, int X, int Y, int Cout, int Xo, int Yo,
                   int d, int pool, int n_strips, int RS) {
  constexpr int WF = 3 * 2 * NP * KC;      // weight floats per stage
  constexpr int STAGES = TcShape<NP>::STAGES;
  extern __shared__ __align__(128) float smem[];
  const int SF = WF + KC * RS;             // floats per stage
  float* ring = smem + STAGES * SF;        // [pool][NP][RING_RS]
  const int dp = d * (pool - 1);
  const int OC = TC_COLS - dp;             // output columns per block

  const int64_t bx = blockIdx.x;           // (n, z, strip), strip fastest
  const int xo0 = static_cast<int>(bx % n_strips) * TC_ROWS;
  const int64_t t = bx / n_strips;
  const int z = static_cast<int>(t % Z);
  const int64_t n = t / Z;
  const int y0 = blockIdx.y * OC;
  const int g = blockIdx.z;                // output-channel group
  const int n_conv = min(TC_ROWS, Xo - xo0) + dp;
  const int step = pool == 2 ? d : 1;
  const int CC = (Cin + KC - 1) / KC;
  const int nsteps = n_conv * CC * 3;

  // this thread's staging copies: elements tid, tid + TC_THREADS, ... of
  // the KC rows of `cols` columns; (rc, j) advance by (qd, rm) per step
  const int cols = TC_COLS + 2 * d;
  const int total = KC * cols;
  const int qd = TC_THREADS / cols, rm = TC_THREADS % cols;
  const int rc0 = threadIdx.x / cols, j0 = threadIdx.x % cols;

  const int64_t plane = static_cast<int64_t>(X) * Y;
  const int64_t chan = static_cast<int64_t>(Z) * plane;
  const float* xz = x + n * Cin * chan + z * plane + y0;

  // the loads' walk: conv row, chunk, kx of the next stage to stage
  int lrow = 0, lcc = 0, lkx = 0;
  auto load_next = [&](int slot) {
    float* sw = smem + slot * SF;
    float* si = sw + WF;
    const float* wsrc = wp + (static_cast<int64_t>(g * CC + lcc) * 3 + lkx) * WF;
    for (int i = threadIdx.x; i < WF / 4; i += TC_THREADS)
      cp_async16(sw + 4 * i, wsrc + 4 * i);
    const float* xs = xz + static_cast<int64_t>(xo0 + lrow + lkx * d) * Y;
    int rc = rc0, j = j0;
    for (int idx = threadIdx.x; idx < total; idx += TC_THREADS) {
      const int ci = lcc * KC + rc;
      const float* src = xs + min(ci, Cin - 1) * chan;
      const bool ok = ci < Cin && y0 + j < Y;
      cp_async4(si + rc * RS + j, ok ? src + j : src, ok ? 4 : 0);
      rc += qd;
      j += rm;
      if (j >= cols) {
        j -= cols;
        ++rc;
      }
    }
    if (++lkx == 3) {
      lkx = 0;
      if (++lcc == CC) {
        lcc = 0;
        lrow = next_conv_row(lrow, step, n_conv);
      }
    }
  };

  // ring of STAGES slots, filled STAGES - 2 stages ahead, as in K1
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nsteps) load_next(s);
    cp_async_commit();
  }

  float acc[NP / 2], part[NP / 2];         // totals and partial sums
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = part[i] = 0.f;

  // this warpgroup's 64 columns; this thread's fragment rows 16 * warp +
  // lane / 4 (+ 8), channels lane % 4 (+ 4)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;
  const int m0 = 16 * warp + lane / 4;
  const int toff = wg * 64 + q * RS + m0;

  const int64_t oplane = static_cast<int64_t>(Xo) * Yo;
  const int64_t ochan = static_cast<int64_t>(Z) * oplane;
  const int n_co = min(NP, Cout - g * NP);
  int row = 0, cc = 0, kx = 0, k = 0;      // the math's walk; k rows done
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 3>();           // this thread's copies of s landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                       // everyone's; s-2's math done
    if (s + STAGES - 2 < nsteps) load_next((s + STAGES - 2) % STAGES);
    cp_async_commit();
    const float* sw = smem + (s % STAGES) * SF;
    const float* si = sw + WF + toff;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      mma_group<NP>(part, si + ky * d, sw + 2 * ky * NP * KC, RS,
                    ky == 0 && kx == 0);
    if (++kx < 3) continue;
    // a chunk's 9 taps done: its partials, once retired, go into the
    // totals in float32 with round-to-nearest
    kx = 0;
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] += part[i];
    if (++cc < CC) continue;
    cc = 0;

    // conv row done: its biased totals into the ring; accumulator 4j+e
    // holds column m0 + 8 (e / 2), channel 8j + 2q + e % 2
    float* cur = ring + (k & (pool - 1)) * NP * RING_RS;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int co = 8 * j + 2 * q + e2;
        const float bv = co < n_co ? __ldg(bias + g * NP + co) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          cur[co * RING_RS + wg * 64 + m0 + 8 * h] = acc[4 * j + 2 * h + e2] + bv;
      }
    }
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
    __syncthreads();
    // output row xo0 + row - dp: the conv row itself (pool 1), or the max
    // over conv rows row - d (the walk's previous row) and row at columns
    // c and c + d (pool 2; the reference pools before the activation, the
    // same for a monotone ReLU); then ReLU, stored along y. The slots read
    // here are written again only after the next row's stages, each behind
    // a barrier. (Deferring this epilogue into the next row's first stages,
    // and branching the wgmma issue around warpgroups past the conv width,
    // each ran slower on an H100.)
    if (row >= dp) {
      const float* prev = ring + ((k ^ 1) & (pool - 1)) * NP * RING_RS;
      const int c = threadIdx.x % TC_COLS;
      if (c < OC && y0 + c < Yo) {
        float* yr = y + (n * Cout + g * NP) * ochan + z * oplane
                    + static_cast<int64_t>(xo0 + row - dp) * Yo + y0 + c;
        for (int co = threadIdx.x / TC_COLS; co < n_co;
             co += TC_THREADS / TC_COLS) {
          const float* a = cur + co * RING_RS + c;
          float v = a[0];
          if (dp) {
            const float* b = prev + co * RING_RS + c;
            v = fmaxf(fmaxf(v, a[d]), fmaxf(b[0], b[d]));
          }
          yr[co * ochan] = fmaxf(v, 0.f);
        }
      }
    }
    ++k;
    row = next_conv_row(row, step, n_conv);
  }
  cp_async_wait<0>();
}

template <int NP>
int launch_tc(const float* x, const float* wp, const float* bias, float* y,
              int N, int Cin, int Z, int X, int Y, int Cout, int d, int pool,
              cudaStream_t stream) {
  const int dp = d * (pool - 1);
  const int Xo = X - 2 * d - dp, Yo = Y - 2 * d - dp;
  const int RS = (TC_COLS + 2 * d + 23) / 32 * 32 + 8;
  const size_t smem = sizeof(float)
      * (TcShape<NP>::STAGES * (6 * NP * KC + KC * RS) + pool * NP * RING_RS);
  cudaError_t err = cudaFuncSetAttribute(
      headconv_tc_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_strips = (Xo + TC_ROWS - 1) / TC_ROWS;
  const int64_t nblk = static_cast<int64_t>(N) * Z * n_strips;
  if (nblk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblk),
                  static_cast<unsigned>((Yo + TC_COLS - dp - 1) / (TC_COLS - dp)),
                  static_cast<unsigned>((Cout + NP - 1) / NP));
  headconv_tc_kernel<NP><<<grid, TC_THREADS, smem, stream>>>(
      x, wp, bias, y, Cin, Z, X, Y, Cout, Xo, Yo, d, pool, n_strips, RS);
  return static_cast<int>(cudaGetLastError());
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

// Plain C entry point of the tensor-core body, loaded with ctypes.
//   x    (N, Cin, Z, X, Y) float32, contiguous
//   wp   the weights (Cout, Cin, 1, 3, 3) split into TF32 hi and lo and
//        packed by ops/tailconv.py::pack_weights for N tile `np` (8, 16,
//        ..., 64, or 128 with pool 1; Cout runs as ceil(Cout/np) groups),
//        Cout and Cin zero-padded
//   bias (Cout,) float32
//   y    (N, Cout, Z, X-2d-d(pool-1), Y-2d-d(pool-1)) float32, written
// Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int e2t_headconv_tc(const float* x, const float* wp,
                               const float* bias, float* y, int N, int Cin,
                               int Z, int X, int Y, int Cout, int np, int d,
                               int pool, void* stream) {
  if (pool != 1 && pool != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int dp = d * (pool - 1);
  if (N < 1 || Cin < 1 || Cout < 1 || Z < 1 || d < 1 || X - 2 * d - dp < 1
      || Y - 2 * d - dp < 1 || dp >= TC_COLS || (pool == 2 && np > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define E2T_CASE(NP)                                                     \
  case NP:                                                               \
    return launch_tc<NP>(x, wp, bias, y, N, Cin, Z, X, Y, Cout, d, pool, s);
  switch (np) {
    E2T_CASE(8) E2T_CASE(16) E2T_CASE(24) E2T_CASE(32) E2T_CASE(40)
    E2T_CASE(48) E2T_CASE(56) E2T_CASE(64) E2T_CASE(128)
  }
#undef E2T_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
