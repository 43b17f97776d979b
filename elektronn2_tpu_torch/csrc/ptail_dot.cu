// P1 for Hopper: the dot-rate probe at the tail conv's dot shapes, on the
// tensor cores (`wgmma`, sm_90a).
//
// Replaces the Pallas TPU probe kernel scripts/exp_ptail_dot.py::main (its
// pallas_call). For each of `cells` grid cells and each zz < ZB it computes
// the whole product w (M,K) @ x[zz*K:(zz+1)*K] (K,N) with float32
// accumulation and writes row `store_row` of it into out (ZB, N); every
// cell writes the same block. Only the rate of the dots matters; the row
// stored is a run-time argument, so the compiler cannot know which
// accumulators are stored and keeps every product.
//
// Work: an item is one (cell, zz, 128 columns of x) product, 128 x 128
// outputs (w's M rows zero-padded to 128). The blocks are persistent: as
// many as fit on the card, each walking the items blockIdx.x, + gridDim.x,
// ..., with its cp.async ring running on across items. Two warpgroups a
// block, one block an SM. Each kernel has a dot-only instance (DOT_ONLY):
// one stage filled once and reused by every step, so it times the wgmmas
// without the staging (values wrong; timing only).
//
// float32 (dot_tf32_kernel): K1's arithmetic (csrc/tailconv.cu), 3xTF32 on
// `wgmma` m64n128k8, laid out as K1 lays out its GEMM: the wgmma M is 64
// columns of x a warpgroup, the A fragment read by ld.shared from a staged
// [k][n] chunk of x and split hi/lo in registers (mma_group of
// wgmma_tf32.cuh); the wgmma N is w's rows, 120 padded to 128. That layout
// is forced: a TF32 B operand must be K-major, and w's rows are
// K-contiguous while x's are not. w is split and packed on the host into
// the descriptor's core-matrix layout (the probe's pack_weights, cached per
// tensor). A stage is 3 chunks of 8 k, as K1's stage is its 3 ky shifts
// (9 wgmmas a warpgroup): one linear copy of the chunks' packed w (24 KB)
// and x's 24 rows (12 KB), k past K zero-filled, in a ring of 5 slots
// filled 3 stages ahead. The partials are promoted into float32 totals
// after every stage, 72 TF32 products (24 multiply-adds x 3 terms), a
// third of K1's cadence: at K1's 216 the tensor cores' truncating
// accumulation put these unit-normal sums further from float64 than twice
// cuBLAS's float32 product on an H100, over the probe's rule.
//
// bfloat16 (dot_bf16_kernel): `wgmma` m64n128k16, bf16 in, float32
// accumulation, both operands from shared memory by descriptor in the
// 128-byte swizzled layout. A is w (K-major): each warpgroup takes 64 of
// its 128 (padded) rows. w (at most 128 x 512 bf16, 128 KB) is staged once
// per block and stays; B is x, [k][n] (N-major, the wgmma's transpose flag
// for 16-bit types), streamed in 64-k stages of 16 KB through a ring of 6
// slots, 4 stages ahead (each warpgroup waits for all but its newest
// group). K is zero-filled up to a multiple of 64 in shared memory.
//
// What bounds it on this card: operations. The operands (w and a ZB-block
// of x, a few MB) stay in L2 across cells, so no cell waits on device
// memory; the bound is 3 x the FLOPs over 495 TFLOP/s (TF32, three
// products per multiply-add) or the FLOPs over 989 TFLOP/s (bf16). What
// holds it back is its staging from L2: every item reads its x block (bf16:
// 128 FLOP a byte), and float32 also its packed w (64 FLOP a byte of both),
// and on the card the staging and the wgmmas take about the sum of their
// times apart (the dot-only instances time the latter).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int WG = 2;              // warpgroups per block
constexpr int THREADS = WG * 128;
constexpr int NT = 128;            // x columns per item; padded w rows

// ---- float32: 3xTF32 ----------------------------------------------------
constexpr int KS = 3;              // k chunks of 8 a stage, as K1's 3 ky
constexpr int SK = KS * KC;        // k a stage
constexpr int RS = NT + 8;         // staged x row stride (8 mod 32 words)
constexpr int WF = 2 * NT * KC;    // packed w floats per 8-k chunk (hi, lo)
constexpr int SF = KS * WF + SK * RS;  // floats per stage
constexpr int STAGES = 5;
constexpr int AHEAD = STAGES - 2;

template <bool DOT_ONLY>
__global__ void __launch_bounds__(THREADS, 1)
dot_tf32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                float* __restrict__ out, int K, int N, int zb, int items,
                int store_row) {
  extern __shared__ __align__(128) float smem[];
  const int ns = (K + SK - 1) / SK;        // stages per item
  const int ntiles = N / NT;
  const int mine = (items - 1 - blockIdx.x) / gridDim.x + 1;
  const int total = mine * ns;             // this block's stages

  // stage t (this block's item t / ns, stage t % ns) into ring slot `slot`:
  // its KS chunks of packed w (1536 16-byte copies) and x's 24 rows of 128
  // (768), rows past K zero-filled
  auto load = [&](int t, int slot) {
    const int i = t / ns, s = t - i * ns;
    const int item = blockIdx.x + i * gridDim.x;
    const int nt = item % ntiles, zz = (item / ntiles) % zb;
    float* sw = smem + slot * SF;
    const float* wsrc = wp + static_cast<int64_t>(s) * KS * WF;
    for (int j = threadIdx.x; j < KS * WF / 4; j += THREADS)
      cp_async16(sw + 4 * j, wsrc + 4 * j);
    for (int j = threadIdx.x; j < SK * (NT / 4); j += THREADS) {
      const int r = j / (NT / 4), p = j % (NT / 4);
      const int k = s * SK + r;
      const bool ok = k < K;
      cp_async16_zfill(
          sw + KS * WF + r * RS + 4 * p,
          ok ? x + (static_cast<int64_t>(zz) * K + k) * N + nt * NT + 4 * p
             : x,
          ok ? 16 : 0);
    }
  };

  if (DOT_ONLY) {        // one stage, filled once: the math alone
    load(0, 0);
    cp_async_commit();
  } else {
#pragma unroll
    for (int t = 0; t < AHEAD; ++t) {
      if (t < total) load(t, t);
      cp_async_commit();
    }
  }

  float acc[NT / 2], part[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = part[i] = 0.f;

  // this warpgroup's 64 columns; this thread's fragment rows (columns of
  // x) 16 * warp + lane / 4 (+ 8), k lane % 4 (+ 4)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;
  const int m0 = 16 * warp + lane / 4;
  const int toff = wg * 64 + q * RS + m0;
  // accumulator 4j+e holds column m0 + 8 (e / 2), w row 8j + 2q + e % 2:
  // the stored row is j = jr, e % 2 = er, in the threads with q == qr
  const int jr = store_row / 8, qr = (store_row % 8) / 2, er = store_row % 2;

  int item = blockIdx.x, s = 0;
  for (int t = 0; t < total; ++t) {
    if (!DOT_ONLY || t == 0) {
      cp_async_wait<DOT_ONLY ? 0 : AHEAD - 1>();  // this thread's copies of t
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();                     // everyone's; t-2's math done
    }
    if (!DOT_ONLY) {
      if (t + AHEAD < total) load(t + AHEAD, (t + AHEAD) % STAGES);
      cp_async_commit();
    }
    const float* sw = smem + (DOT_ONLY ? 0 : t % STAGES) * SF;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      mma_group<NT>(part, sw + KS * WF + j * KC * RS + toff, sw + j * WF, RS,
                    j == 0);
    // every stage the partials, once done, are added into the totals in
    // float32 with round-to-nearest
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] += part[i];
    if (s == ns - 1) {                     // the item's product is done
      if (q == qr) {
        const int nt = item % ntiles, zz = (item / ntiles) % zb;
        float* o = out + static_cast<int64_t>(zz) * N + nt * NT + wg * 64
                   + m0;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          if (j == jr) {
            o[0] = er ? acc[4 * j + 1] : acc[4 * j];
            o[8] = er ? acc[4 * j + 3] : acc[4 * j + 2];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    }
    if (++s == ns) {
      s = 0;
      item += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

// ---- bfloat16 -------------------------------------------------------------
constexpr int BK = 64;             // k per stage: one 128-byte row of A
constexpr int KMAX = 512;          // w stays in shared memory up to this K
constexpr int A_KB = 16 * 1024;    // bytes of A per 64-k block (128 rows)
constexpr int B_STAGE = 16 * 1024; // bytes of B per stage (64 k x 128 n)
constexpr int STAGES_BF16 = 6;
constexpr int AHEAD_BF16 = STAGES_BF16 - 2;

// 128-byte swizzled matrix descriptor: start address, LBO and SBO in bytes
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (1ull << 62);
}

// Byte offset of 16-byte chunk `c` (0..7) of row r in a 128-byte swizzled
// atom of 8 rows (1024 bytes, 1024-byte aligned): the chunk index XOR r % 8.
__device__ __forceinline__ int swz(int r, int c) {
  return (r / 8) * 1024 + (r % 8) * 128 + ((c ^ (r % 8)) * 16);
}

// D(64 x 128, float32) (+)= A(64 x 16, bf16, K-major, descriptor a) *
// B(16 x 128, bf16, N-major, descriptor b); D is zeroed first when
// scale_d == 0.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : WGMMA_C64
      : "l"(a), "l"(b), "r"(scale_d));
}

template <bool DOT_ONLY>
__global__ void __launch_bounds__(THREADS, 1)
dot_bf16_kernel(const uint16_t* __restrict__ w,
                const uint16_t* __restrict__ x, float* __restrict__ out,
                int M, int K, int N, int zb, int items, int store_row) {
  extern __shared__ __align__(1024) unsigned char smem_b[];
  // the swizzle atoms need 1024-byte aligned shared addresses
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_b));
  unsigned char* base = smem_b + ((1024 - (s0 & 1023)) & 1023);
  const int nkb = (K + BK - 1) / BK;       // stages per item
  unsigned char* sa = base;                // A: nkb blocks of 128 x 64
  unsigned char* sb = base + nkb * A_KB;   // B: the ring
  const int ntiles = N / NT;
  const int mine = (items - 1 - blockIdx.x) / gridDim.x + 1;
  const int total = mine * nkb;

  // A once: row r, 16-byte chunk k8 (8 bf16) -> block k8 / 8, chunk k8 % 8;
  // rows past M and k past K zero-filled
  const int k8s = nkb * (BK / 8);
  for (int i = threadIdx.x; i < NT * k8s; i += THREADS) {
    const int r = i / k8s, k8 = i - r * k8s;
    const bool ok = r < M && 8 * k8 < K;
    cp_async16_zfill(
        reinterpret_cast<float*>(sa + (k8 / 8) * A_KB + swz(r, k8 % 8)),
        reinterpret_cast<const float*>(
            ok ? w + static_cast<int64_t>(r) * K + 8 * k8 : w),
        ok ? 16 : 0);
  }
  cp_async_commit();

  // stage t (this block's item t / nkb, k block t % nkb): x's 64 rows of
  // 128 as two 64-column atoms stacks (n block 0 at 0, 1 at 8 KB), each
  // k row a 128-byte swizzled row; rows past K zero-filled
  auto load = [&](int t, int slot) {
    const int i = t / nkb, kb = t - i * nkb;
    const int item = blockIdx.x + i * gridDim.x;
    const int nt = item % ntiles, zz = (item / ntiles) % zb;
    unsigned char* dst = sb + slot * B_STAGE;
    for (int j = threadIdx.x; j < BK * (NT / 8); j += THREADS) {
      const int k = j / (NT / 8), c = j % (NT / 8);
      const bool ok = kb * BK + k < K;
      const uint16_t* src =
          x + (static_cast<int64_t>(zz) * K + kb * BK + k) * N + nt * NT
          + 8 * c;
      cp_async16_zfill(
          reinterpret_cast<float*>(dst + (c / 8) * (B_STAGE / 2)
                                   + swz(k, c % 8)),
          reinterpret_cast<const float*>(ok ? src : x), ok ? 16 : 0);
    }
  };

  if (DOT_ONLY) {        // one stage, filled once: the math alone
    load(0, 0);
    cp_async_commit();
  } else {
#pragma unroll
    for (int t = 0; t < AHEAD_BF16; ++t) {
      if (t < total) load(t, t);
      cp_async_commit();
    }
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;
  // accumulator 4j+e holds w row 64 wg + 16 warp + lane/4 + 8 (e / 2),
  // column 8j + 2q + e % 2: the stored row's threads and half
  const int sr = store_row - 64 * wg - 16 * warp;
  const bool mine_row = sr >= 0 && sr < 16 && sr % 8 == lane / 4;
  const int hr = sr / 8;
  const uint32_t a0 = static_cast<uint32_t>(__cvta_generic_to_shared(sa))
                      + wg * (A_KB / 2);
  const uint32_t b0 = static_cast<uint32_t>(__cvta_generic_to_shared(sb));

  int item = blockIdx.x, kb = 0;
  for (int t = 0; t < total; ++t) {
    if (!DOT_ONLY || t == 0) {
      cp_async_wait<DOT_ONLY ? 0 : AHEAD_BF16 - 1>();  // A, stage t
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();                     // everyone's; t-2's math done
    }
    if (!DOT_ONLY) {
      if (t + AHEAD_BF16 < total)
        load(t + AHEAD_BF16, (t + AHEAD_BF16) % STAGES_BF16);
      cp_async_commit();
    }
    const uint32_t a = a0 + kb * A_KB;
    const uint32_t b = b0 + (DOT_ONLY ? 0 : t % STAGES_BF16) * B_STAGE;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)      // k16 step j: A +32 bytes along
      wgmma_bf16(acc, desc128(a + 32 * j, 16, 1024),   // the row, B +2
                 desc128(b + 2048 * j, B_STAGE / 2, 1024),  // k atoms
                 kb == 0 && j == 0 ? 0 : 1);
    wgmma_commit();
    if (kb == nkb - 1) {                   // the item's product is done
      wgmma_wait<0>();
      fence_regs(acc);
      if (mine_row) {
        const int nt = item % ntiles, zz = (item / ntiles) % zb;
        float* o = out + static_cast<int64_t>(zz) * N + nt * NT + 2 * q;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          o[8 * j] = hr ? acc[4 * j + 2] : acc[4 * j];
          o[8 * j + 1] = hr ? acc[4 * j + 3] : acc[4 * j + 1];
        }
      }
    } else {
      wgmma_wait<1>();
    }
    if (++kb == nkb) {
      kb = 0;
      item += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

// Blocks that fit on the card at once for `kernel` with `smem` bytes.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   w   float32: the weights (M, K) packed by the probe's pack_weights,
//       (K'/8, 2, 16, 2, 8, 4) TF32 hi/lo with K' = K rounded up to a
//       multiple of 24, rows and k zero-padded to 128 and K'; bfloat16
//       (`bf16` != 0): (M, K) as they are, contiguous
//   x   (zb*K, N) float32 or bfloat16, contiguous
//   out (zb, N) float32: row `store_row` of w @ x[zz*K:(zz+1)*K]
//   dot_only != 0: the dot-only instance (timing only, `out` wrong)
// Needs M <= 128, N % 128 == 0, K % 8 == 0 (float32) or K % 16 == 0 and
// K <= 512 (bfloat16), 16-byte aligned operands. Launches persistent
// blocks over the cells * zb * N/128 items on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int e2t_ptail_dot(const void* w, const void* x, float* out, int M,
                             int K, int N, int zb, int cells, int store_row,
                             int bf16, int dot_only, void* stream) {
  if (M < 1 || M > NT || N < NT || N % NT || K < 16 || K % (bf16 ? 16 : 8)
      || (bf16 && K > KMAX) || zb < 1 || cells < 1 || store_row < 0
      || store_row >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items64 = static_cast<int64_t>(cells) * zb * (N / NT);
  if (items64 > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int items = static_cast<int>(items64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0, err = 0;
  if (bf16) {
    const size_t smem = 1024 + static_cast<size_t>((K + BK - 1) / BK) * A_KB
                        + STAGES_BF16 * B_STAGE;
    const auto kernel = dot_only ? dot_bf16_kernel<true>
                                 : dot_bf16_kernel<false>;
    err = resident_blocks(kernel, smem, &blocks);
    if (err) return err;
    kernel<<<blocks < items ? blocks : items, THREADS, smem, s>>>(
        static_cast<const uint16_t*>(w), static_cast<const uint16_t*>(x),
        out, M, K, N, zb, items, store_row);
  } else {
    const size_t smem = sizeof(float) * STAGES * SF;
    const auto kernel = dot_only ? dot_tf32_kernel<true>
                                 : dot_tf32_kernel<false>;
    err = resident_blocks(kernel, smem, &blocks);
    if (err) return err;
    kernel<<<blocks < items ? blocks : items, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), out, K,
        N, zb, items, store_row);
  }
  return static_cast<int>(cudaGetLastError());
}
