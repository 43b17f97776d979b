// P1 for Hopper: the dot-rate probe at the tail conv's dot shapes.
//
// Replaces the Pallas TPU probe kernel scripts/exp_ptail_dot.py::main (its
// pallas_call). For each of `cells` grid cells and each zz < ZB it computes
// the whole product w (M,K) @ x[zz*K:(zz+1)*K] (K,N) with float32
// accumulation and writes one row of it into out (ZB, N); every cell writes
// the same block. Only the rate of the dots matters; the one row stored
// keeps them live.
//
// Two routes, one per operand type:
//  * float32 runs on the FP32 pipe (FFMA), the pipe K1 (csrc/tailconv.cu)
//    uses: a 128 x 128 output tile per block of 256 threads, each thread
//    an 8 x 8 register tile (rows ty*4+i and 64+ty*4+i, columns likewise, so
//    the float4 reads of shared memory are free of bank conflicts), K in
//    steps of 8 staged in shared memory (A transposed).
//  * bfloat16 runs on the tensor cores through nvcuda::wmma (16x16x16 bf16
//    fragments, float32 accumulators): the same 128 x 128 tile, 8 warps of
//    32 x 64 each (2 x 4 fragments), K in steps of 16 staged in shared
//    memory. M = 120 is zero-padded to the tile in shared memory.
//
// What bounds it on this card: operations. The operands (w and a ZB-block
// of x, a few MB) stay in L2 across cells, so no cell waits on device
// memory; the bound is the FLOP count over 67 TFLOP/s (FP32) or 989 TFLOP/s
// (dense BF16 tensor cores).
//
// Keeping the work live: the stored row is a run-time argument
// (`store_row`), so the compiler cannot know which accumulators are stored
// and keeps every multiply-add; the bf16 fragments go through shared
// memory, from which the row is read with a run-time index.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;
constexpr int BK_F32 = 8;
constexpr int BK_BF16 = 16;

__global__ void __launch_bounds__(THREADS, 2)
dot_f32_kernel(const float* __restrict__ w, const float* __restrict__ x,
               float* __restrict__ out, int M, int K, int N, int store_row) {
  __shared__ __align__(16) float As[BK_F32][BM];   // A transposed: [k][m]
  __shared__ __align__(16) float Bs[BK_F32][BN];

  const int nt = N / BN;
  const int n0 = (blockIdx.x % nt) * BN;
  const int m0 = (blockIdx.x / nt) * BM;
  const int zz = blockIdx.y;
  const float* xb = x + static_cast<int64_t>(zz) * K * N;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // tile loads: A as (row, 4 k), B as (k, 4 columns), one float4 each
  const int a_row = tid / 2, a_k = (tid % 2) * 4;
  const int b_k = tid / 32, b_n = (tid % 32) * 4;
  const bool a_ok = m0 + a_row < M;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK_F32) {
    const float4 av = a_ok ? *reinterpret_cast<const float4*>(
        w + static_cast<int64_t>(m0 + a_row) * K + k0 + a_k)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bv = *reinterpret_cast<const float4*>(
        xb + static_cast<int64_t>(k0 + b_k) * N + n0 + b_n);
    __syncthreads();  // every thread is done with the previous tile
    As[a_k + 0][a_row] = av.x;
    As[a_k + 1][a_row] = av.y;
    As[a_k + 2][a_row] = av.z;
    As[a_k + 3][a_row] = av.w;
    *reinterpret_cast<float4*>(&Bs[b_k][b_n]) = bv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK_F32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // only the row `store_row` of the product is written
  float* orow = out + static_cast<int64_t>(zz) * N + n0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m == store_row) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        orow[j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
dot_bf16_kernel(const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                int M, int K, int N, int store_row) {
  using namespace nvcuda;
  constexpr int LDA = BK_BF16 + 8;     // padded rows, 48 bytes
  constexpr int LDB = BN + 8;          // 272 bytes
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];    // [m][k]
  __shared__ __align__(32) __nv_bfloat16 Bs[BK_BF16 * LDB];  // [k][n]
  __shared__ __align__(32) float Cs[THREADS / 32][16 * 16];

  const int nt = N / BN;
  const int n0 = (blockIdx.x % nt) * BN;
  const int m0 = (blockIdx.x / nt) * BM;
  const int zz = blockIdx.y;
  const __nv_bfloat16* xb = x + static_cast<int64_t>(zz) * K * N;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;          // 4 x 2 warps

  // tile loads, 8 bf16 (16 bytes) a thread: A (row, 8 k), B (k, 8 columns)
  const int a_row = tid / 2, a_k = (tid % 2) * 8;
  const int b_k = tid / 16, b_n = (tid % 16) * 8;
  const bool a_ok = m0 + a_row < M;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK_BF16) {
    const uint4 av = a_ok ? *reinterpret_cast<const uint4*>(
        w + static_cast<int64_t>(m0 + a_row) * K + k0 + a_k)
        : make_uint4(0u, 0u, 0u, 0u);
    const uint4 bv = *reinterpret_cast<const uint4*>(
        xb + static_cast<int64_t>(k0 + b_k) * N + n0 + b_n);
    __syncthreads();
    *reinterpret_cast<uint4*>(&As[a_row * LDA + a_k]) = av;
    *reinterpret_cast<uint4*>(&Bs[b_k * LDB + b_n]) = bv;
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fb;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], &As[(wm * 32 + i * 16) * LDA], LDA);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::load_matrix_sync(fb, &Bs[wn * 64 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
    }
  }

  // every fragment goes through shared memory; only the row `store_row`
  // is written out
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r0 = m0 + wm * 32 + i * 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      if (store_row >= r0 && store_row < r0 + 16 && lane < 16)
        out[static_cast<int64_t>(zz) * N + n0 + wn * 64 + j * 16 + lane] =
            cs[(store_row - r0) * 16 + lane];
      __syncwarp();
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   w   (M, K) float32 or bfloat16 (`bf16` != 0), contiguous
//   x   (zb*K, N) of the same type, contiguous
//   out (zb, N) float32: row `store_row` of w @ x[zz*K:(zz+1)*K]
// Needs N % 128 == 0 and K % 8 == 0 (float32) or K % 16 == 0 (bfloat16).
// Launches cells * zb * (N/128) * ceil(M/128) blocks on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int e2t_ptail_dot(const void* w, const void* x, float* out, int M,
                             int K, int N, int zb, int cells, int store_row,
                             int bf16, void* stream) {
  const int bk = bf16 ? BK_BF16 : BK_F32;
  if (M < 1 || K < bk || N < BN || N % BN || K % bk || zb < 1 || zb > 65535
      || cells < 1 || cells > 65535 || store_row < 0 || store_row >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N / BN) * ((M + BM - 1) / BM)),
                  static_cast<unsigned>(zb), static_cast<unsigned>(cells));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    dot_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(x), out, M, K, N, store_row);
  else
    dot_f32_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(w),
                                            static_cast<const float*>(x), out,
                                            M, K, N, store_row);
  return static_cast<int>(cudaGetLastError());
}
