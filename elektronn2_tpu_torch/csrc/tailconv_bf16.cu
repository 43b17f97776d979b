// K1's bfloat16 mode for Hopper: the dense-sweep tail conv, valid (3,3,3),
// z-dilation 1, xy-dilation (dx, dy), bias and ReLU fused, float32 in and
// out, the input and the weights rounded to bf16 (round to nearest even)
// and their products summed in float32 on the tensor cores: an implicit
// GEMM on `wgmma` m64nNk16 with both bf16 operands read from shared memory
// by descriptor.
//
// Replaces the bf16 mode of the Pallas TPU kernel elektronn2_tpu/ops/
// pallas_tailconv.py::conv3x3_dilated (compute_dtype="bfloat16", its
// operands cast to bf16, Cin padded to 16, preferred_element_type float32).
// As in the JAX package no serving route takes it: it is reached by a direct
// call (ops/tailconv.py::conv3x3_dilated(..., compute_dtype="bfloat16")).
//
// What bounds it on this card: at the flagship's conv2/conv3 (Cin 30/40,
// Cout 40) the bytes (float32 in and out at 3.35 TB/s), at the wide U-Net's
// d1 (Cin 256, Cout 128) the bf16 operations (989 TFLOP/s). What a design
// must not do is stage, from L2, many times the bytes the bound counts: the
// first design of this mode staged every weight stage again for each 128
// outputs and each float32 input row 9 times, by 4-byte copies, and ran at
// 7.6% of the bound at the flagship and 0.36x cuDNN's rate at d1.
//
// Two kernels a call:
//  1. `bf16_cast_layout_kernel`: x -> a bf16 copy `xb`, laid out (N, Z, X,
//     CG, Y, 8) with CG = 2 ceil(Cin/16) groups of 8 channels, the channels
//     past Cin zero: each value read once (4 bytes) and written once (2).
//     Every global stride of xb is a multiple of 16 bytes whatever Y is, so
//     one TMA tensor map serves every shape; a group's 8 channels of one y
//     are one 16-byte row, the K-major row of a `wgmma` core matrix. (The
//     other way, float32 tiles by TMA converted in shared memory, needs
//     Y % 4 == 0 for its tensor map and spends shared-memory bandwidth that
//     the descriptor-fed `wgmma` already takes most of: PERF.md.)
//  2. `tailconv_bf16_kernel`: persistent (one block per SM, walking output
//     tiles), warp-specialised: one thread of a producer warpgroup keeps a
//     ring of shared-memory stages full by TMA (`cp.async.bulk.tensor` /
//     `cp.async.bulk` into `mbarrier`s); two consumer warpgroups run `wgmma`
//     on them, with the registers the producer gives up (`setmaxnreg`).
//
// The GEMM of a block tile: M = R = 2T output rows of one (n, zo, x phase)
// times 64 y outputs (one m64 tile a row; T rows a warpgroup), N = one group
// of up to NP output channels, K = 27 taps x Cin. A dilated x axis splits
// into dx phases: the tile's rows are xo = px + dx (i0 + i), so their kx
// taps read the R + 2 input rows px + dx (i0 + j), not R + 2dx.
//  - A stage is one (16-channel chunk cc, kz): the R + 2 input rows of the
//    chunk at plane zo + kz, each one TMA box of 2 x (64 + 2dy) x 8 bf16
//    ([group][y][8 channels]), staged once and read by all 9 (kx, ky) taps:
//    tap (kx, ky) of row i is the descriptor at row i + kx, y start ky dy,
//    so a ky shift is a start 16 dy bytes on (the descriptor counts its
//    start in 16-byte units: any dy), its core matrices 8 consecutive
//    16-byte rows (SBO 128), the chunk's two channel groups 16 (64 + 2dy)
//    bytes apart (LBO). The nine `wgmma`s of a tile issue back to back.
//    A box holds at most 256 values a dimension, so past dy = 96 a row is
//    staged segmented: three boxes of 2 x 64 x 8, one per ky, from y0 +
//    ky dy, 2048 bytes apart; tap (kx, ky) then starts at segment ky of
//    row i + kx and the groups lie 1024 bytes apart. That stages 192
//    values a row, not 64 + 2dy.
//  - B, the weights (ops/tailconv.py::pack_weights_bf16: one stage's 9 taps
//    contiguous, each tap the K-major core-matrix tile of LBO 128, SBO
//    256), comes from shared memory too: held for the whole launch when one
//    channel group's weights fit beside the ring (the flagship: 69 KB at
//    conv2, 104 KB at conv3), else streamed with each stage (d1: 36 KB a
//    stage, shared by 4 m64 tiles, where the first design shared it by 2).
//  - Tile order: zo fastest, then the channel group, y tile, x tile, n: the
//    blocks in flight walk one (x, y) column, so the kz planes a tile
//    stages again are still in L2.
//  - Promotion: the tensor cores' float32 accumulation truncates (the head
//    note of tailconv_tc_body.cuh), so a tile's 9 `wgmma`s of a stage (144
//    products a sum) go into fresh partials, which are then added into the
//    tile's float32 totals with a round-to-nearest FADD: one promotion a
//    stage, 9 `wgmma`s, the cadence of the first design (which promoted every
//    3 of its (cc, kz, kx) stages). One set of partials serves a warpgroup's
//    T tiles in turn, so each turn waits for its `wgmma`s; the other
//    warpgroup's keep the tensor cores busy meanwhile. Registers: NP/2
//    partials + T NP/2 totals a thread (T = 4 up to NP = 64, else 2).
//  - Epilogue: bias and ReLU on the totals, the tile staged through shared
//    memory 32 channels at a time and written as runs of 64 y per channel,
//    16-byte streaming stores where Yo % 4 == 0, else 4-byte ones; the
//    producer meanwhile stages the next tile.
//  - The kernel allocates nothing: xb is the caller's scratch, the tensor
//    map travels as a __grid_constant__ parameter (so a CUDA graph captures
//    it), and `cuTensorMapEncodeTiled` is found with
//    cudaGetDriverEntryPoint, so the library links no libcuda. The producer
//    adds the bytes it staged to `staged` (one atomic a block).
//  - A wait that outlasts 2^34 clocks (about 9 s) traps: a fault in the
//    pipeline ends the launch with an error instead of hanging the card.

#include <cuda.h>
#include <cuda_bf16.h>

#include "mbarrier_tma.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int CONSUMERS = 2;             // consumer warpgroups
// + the producer warpgroup: one thread of it issues every copy; it gives
// registers up to the consumers (setmaxnreg), whose totals need them
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(CONSUMERS * CONSUMER_REGS + PRODUCER_REGS
              <= (CONSUMERS + 1) * (65536 / THREADS / 8 * 8),
              "setmaxnreg: the consumers take what the producer gives up");
constexpr int MAX_STAGES = 8;
constexpr int HDR = 256;                 // the barriers' bytes
constexpr int EPC = 32;                  // channels an epilogue pass stages
constexpr int EPS = 68;                  // its row stride, floats
constexpr int EPI_BYTES = CONSUMERS * EPC * EPS * 4;

// m64 tiles (output rows) a consumer warpgroup holds totals for at N tile NP
template <int NP>
__host__ __device__ constexpr int tiles_per_wg() { return NP <= 64 ? 4 : 2; }

// `wgmma` m64nNk16, bf16 A and B from shared memory (descriptors a, b, both
// K-major), float32 D in registers; operands numbered a %0, b %1, the
// scale flag %2, D from %3 (a, b and the flag are tied in-out operands only
// to come first; the asm does not change them).
#define SS_D4 "%3, %4, %5, %6"
#define SS_D8 SS_D4 ", %7, %8, %9, %10"
#define SS_D12 SS_D8 ", %11, %12, %13, %14"
#define SS_D16 SS_D12 ", %15, %16, %17, %18"
#define SS_D20 SS_D16 ", %19, %20, %21, %22"
#define SS_D24 SS_D20 ", %23, %24, %25, %26"
#define SS_D28 SS_D24 ", %27, %28, %29, %30"
#define SS_D32 SS_D28 ", %31, %32, %33, %34"
#define SS_D64                                                          \
  SS_D32 ", %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46" \
         ", %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58"  \
         ", %59, %60, %61, %62, %63, %64, %65, %66"

template <int N>
struct MmaSS;

#define WGMMA_BF16_SS(N, R)                                              \
  template <>                                                            \
  struct MmaSS<N> {                                                      \
    static_assert(2 * (R) == (N), "R must be N / 2");                    \
    static __device__ __forceinline__ void run(float (&d)[R], uint64_t a, \
                                               uint64_t b, int scale_d) { \
      asm volatile(                                                      \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                      \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"     \
        SS_D##R "}, %0, %1, p, 1, 1, 0, 0;\n}\n"                         \
          : "+l"(a), "+l"(b), "+r"(scale_d), WGMMA_C##R);                \
    }                                                                    \
  };

WGMMA_BF16_SS(8, 4)
WGMMA_BF16_SS(16, 8)
WGMMA_BF16_SS(24, 12)
WGMMA_BF16_SS(32, 16)
WGMMA_BF16_SS(40, 20)
WGMMA_BF16_SS(48, 24)
WGMMA_BF16_SS(56, 28)
WGMMA_BF16_SS(64, 32)
WGMMA_BF16_SS(128, 64)

// A no-swizzle shared-memory matrix descriptor: start address (16-byte
// units) | LBO, SBO in `hi`.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint64_t hi) {
  return hi | static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
}

__host__ __device__ constexpr uint64_t desc_hi(uint32_t lbo, uint32_t sbo) {
  return (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// the 128 threads of consumer warpgroup `wg`
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// two float32 values rounded to bf16 (nearest even), the first in the low
// half (the lower channel at the lower address)
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x (N, Cin, Z, X, Y) float32 -> xb (N, Z, X, CG, Y, 8) bf16, channels past
// Cin zero. A block is 128 y of one (n, z, x) row, a thread one y: its reads
// of a channel and its 16-byte writes of a group are coalesced across the
// warp.
__global__ void __launch_bounds__(128)
bf16_cast_layout_kernel(const float* __restrict__ x, uint4* __restrict__ xb,
                        int Cin, int CG, int ZX, int Y, int yblocks) {
  const int64_t b = blockIdx.x;
  const int64_t row = b / yblocks;                 // (n, z, x)
  const int y = static_cast<int>(b - row * yblocks) * 128 + threadIdx.x;
  if (y >= Y) return;
  const int64_t n = row / ZX;
  const int64_t plane = static_cast<int64_t>(ZX) * Y;   // one channel
  const float* src = x + (n * Cin * ZX + (row - n * ZX)) * Y + y;
  uint4* dst = xb + row * CG * Y + y;
#pragma unroll 2
  for (int cg = 0; cg < CG; ++cg) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = cg * 8 + k;
      v[k] = c < Cin ? __ldg(src + c * plane) : 0.f;
    }
    dst[static_cast<int64_t>(cg) * Y] =
        make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]),
                   bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
  }
}

// The launch's geometry; byte offsets are from the 128-aligned base of the
// dynamic shared memory.
struct Params {
  const unsigned char* wp;      // packed bf16 weights
  const float* bias;
  float* y;
  unsigned long long* staged;   // += the bytes this launch staged
  int Z, Cout, CC, G, Zo, Xo, Yo, dx, dy;
  int xtp;                      // block tiles per x phase
  int ytiles, ntiles, stages, resident;
  uint32_t rsb;                 // shared-memory stride of a staged row
  uint32_t ys;                  // staged y values of a row: 64 + 2dy, or
                                // 192 segmented (3 boxes of 64)
  uint32_t bys;                 // y values of one TMA box (ys, or 64)
  uint32_t kyoff;               // bytes from tap ky to ky + 1 in a row
  uint32_t slot_bytes, wres_bytes, ring, epi;
};

struct Tile {
  int n, g, zo, px, i0, y0;
};

// tile t: zo fastest, then the channel group, y tile, x tile (phase
// fastest), n
__device__ __forceinline__ Tile decode(int t, const Params& p, int R) {
  Tile tl;
  tl.zo = t % p.Zo;
  int r = t / p.Zo;
  tl.g = r % p.G;
  r /= p.G;
  tl.y0 = (r % p.ytiles) * 64;
  r /= p.ytiles;
  const int xtiles = p.dx * p.xtp;
  const int xt = r % xtiles;
  tl.n = r / xtiles;
  tl.px = xt % p.dx;
  tl.i0 = (xt / p.dx) * R;
  return tl;
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
tailconv_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ Params p) {
  constexpr int T = tiles_per_wg<NP>();
  constexpr int R = CONSUMERS * T;           // output rows of a block tile
  constexpr uint32_t TAPB = NP * 32;         // one tap: NP x 16 bf16
  constexpr uint32_t WSTAGE = 9 * TAPB;      // one (cc, kz) stage's taps
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  const uint32_t full0 = base, empty0 = base + 8 * MAX_STAGES;
  const uint32_t wbar = base + 16 * MAX_STAGES;
  const uint32_t wres = base + HDR, ring = base + p.ring;
  const int nsteps = p.CC * 3;               // stages a tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);    // each consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x != CONSUMERS * 128) return;
    unsigned long long staged = 0;
    if (p.resident) {
      mbar_expect_tx(wbar, p.wres_bytes);
      for (uint32_t off = 0; off < p.wres_bytes; off += 32768)
        bulk_load(wres + off, p.wp + off, min(32768u, p.wres_bytes - off),
                  wbar);
      staged += p.wres_bytes;
    }
    const uint32_t box = 32 * p.ys;
    const uint32_t tx = (R + 2) * box + (p.resident ? 0 : WSTAGE);
    int slot = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
      const Tile tl = decode(t, p, R);
      for (int s = 0; s < nsteps; ++s) {
        const int cc = s / 3, kz = s - 3 * cc;
        mbar_wait(empty0 + 8 * slot, ph ^ 1);
        const uint32_t full = full0 + 8 * slot;
        const uint32_t dst = ring + slot * p.slot_bytes;
        mbar_expect_tx(full, tx);
        for (int j = 0; j < R + 2; ++j) {
          const int xr = tl.px + p.dx * (tl.i0 + j);
          const int zr = tl.n * p.Z + tl.zo + kz;
          if (p.bys == p.ys) {
            tma_load5(dst + j * p.rsb, &xmap, full, 0, tl.y0, 2 * cc, xr, zr);
          } else {
            for (int ky = 0; ky < 3; ++ky)
              tma_load5(dst + j * p.rsb + ky * p.kyoff, &xmap, full, 0,
                        tl.y0 + ky * p.dy, 2 * cc, xr, zr);
          }
        }
        if (!p.resident)
          bulk_load(dst + (R + 2) * p.rsb,
                    p.wp + (static_cast<int64_t>(tl.g) * nsteps + s) * WSTAGE,
                    WSTAGE, full);
        staged += tx;
        if (++slot == p.stages) {
          slot = 0;
          ph ^= 1;
        }
      }
    }
    atomicAdd(p.staged, staged);
    return;
  }

  // the consumers: warpgroup wg holds rows wg T .. wg T + T - 1 of a tile;
  // this thread's accumulators 4j + 2h + e: row m0 + 8h, channel 8j + 2q + e
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int m0 = 16 * (tid >> 5) + (lane >> 2);
  const uint64_t a_hi = desc_hi(16 * p.bys, 128);
  constexpr uint64_t b_hi = desc_hi(128, 256);
  const uint32_t kyoff = p.kyoff;
  float* epis = reinterpret_cast<float*>(smem_raw + (base - raw) + p.epi)
                + wg * EPC * EPS;
  const int64_t plane = static_cast<int64_t>(p.Xo) * p.Yo;
  const int64_t cstride = static_cast<int64_t>(p.Zo) * plane;
  if (p.resident) mbar_wait(wbar, 0);

  float part[NP / 2];
  float tot[T][NP / 2];
  int slot = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
    const Tile tl = decode(t, p, R);
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int k = 0; k < NP / 2; ++k) tot[i][k] = 0.f;

    for (int s = 0; s < nsteps; ++s) {
      mbar_wait(full0 + 8 * slot, ph);
      const uint32_t in = ring + slot * p.slot_bytes;
      const uint32_t w = p.resident ? wres + s * WSTAGE
                                    : in + (R + 2) * p.rsb;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const uint32_t a = in + (wg * T + i) * p.rsb;
        wgmma_fence();
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
            MmaSS<NP>::run(part, desc(a + kx * p.rsb + ky * kyoff, a_hi),
                           desc(w + (kx * 3 + ky) * TAPB, b_hi), kx + ky);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int k = 0; k < NP / 2; ++k) tot[i][k] += part[k];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);   // this warp is done
      if (++slot == p.stages) {
        slot = 0;
        ph ^= 1;
      }
    }

    // epilogue: bias + ReLU into shared memory, EPC channels a pass as rows
    // of 64 y, then runs of y per channel into y (NCDHW)
    const int cbase = tl.g * NP;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int xo = tl.px + p.dx * (tl.i0 + wg * T + i);
#pragma unroll
      for (int pass = 0; pass < (NP + EPC - 1) / EPC; ++pass) {
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          if (j / (EPC / 8) != pass) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * q + e;
            const float bv = cbase + c < p.Cout ? __ldg(p.bias + cbase + c)
                                                : 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              epis[(c - pass * EPC) * EPS + m0 + 8 * h] =
                  fmaxf(tot[i][4 * j + 2 * h + e] + bv, 0.f);
          }
        }
        wg_sync(wg);
        const int nc = min(EPC, p.Cout - cbase - pass * EPC);
        const int yv = min(64, p.Yo - tl.y0);
        if (xo < p.Xo && nc > 0) {
          float* out = p.y
              + (static_cast<int64_t>(tl.n) * p.Cout + cbase + pass * EPC)
                    * cstride
              + tl.zo * plane + static_cast<int64_t>(xo) * p.Yo + tl.y0;
          if ((p.Yo & 3) == 0) {
            for (int it = tid; it < nc * 16; it += 128) {
              const int c = it >> 4, y4 = (it & 15) * 4;
              if (y4 < yv)
                __stcs(reinterpret_cast<float4*>(out + c * cstride + y4),
                       *reinterpret_cast<const float4*>(epis + c * EPS + y4));
            }
          } else {
            for (int it = tid; it < nc * 64; it += 128) {
              const int c = it >> 6, yy = it & 63;
              if (yy < yv) __stcs(out + c * cstride + yy, epis[c * EPS + yy]);
            }
          }
        }
        wg_sync(wg);
      }
    }
  }
}

// x -> xb, the bf16 copy (bf16_cast_layout_kernel)
cudaError_t cast(const float* x, void* xb, int N, int Cin, int Z, int X,
                 int Y, cudaStream_t stream) {
  const int yblocks = (Y + 127) / 128;
  const int64_t blocks = static_cast<int64_t>(N) * Z * X * yblocks;
  bf16_cast_layout_kernel<<<static_cast<unsigned>(blocks), 128, 0,
                            stream>>>(x, static_cast<uint4*>(xb), Cin,
                                      2 * ((Cin + 15) / 16), Z * X, Y,
                                      yblocks);
  return cudaGetLastError();
}

// The host side of a launch: the shared-memory plan (ops/tailconv.py::
// bf16_plan computes the same), the cast, the tensor map, the kernel.
template <int NP>
int launch(const float* x, void* xb, const unsigned char* wp,
           const float* bias, float* y, unsigned long long* staged, int N,
           int Cin, int Z, int X, int Y, int Cout, int dx, int dy,
           cudaStream_t stream) {
  constexpr int T = tiles_per_wg<NP>();
  constexpr int R = CONSUMERS * T;
  Params p;
  p.wp = wp;
  p.bias = bias;
  p.y = y;
  p.staged = staged;
  p.Z = Z;
  p.Cout = Cout;
  p.CC = (Cin + 15) / 16;
  p.G = (Cout + NP - 1) / NP;
  p.Zo = Z - 2;
  p.Xo = X - 2 * dx;
  p.Yo = Y - 2 * dy;
  p.dx = dx;
  p.dy = dy;
  // a TMA box holds at most 256 values a dimension: past dy = 96 a row is
  // three boxes of 64, one per ky
  const bool segmented = 64 + 2 * dy > 256;
  p.bys = segmented ? 64 : 64 + 2 * dy;
  p.ys = segmented ? 3 * 64 : p.bys;
  p.kyoff = segmented ? 32 * 64 : 16 * dy;
  p.rsb = (32 * p.ys + 127) / 128 * 128;
  const int xp = (p.Xo + dx - 1) / dx;        // rows of the longest phase
  p.xtp = (xp + R - 1) / R;
  p.ytiles = (p.Yo + 63) / 64;
  const int64_t ntiles = static_cast<int64_t>(N) * dx * p.xtp * p.ytiles
                         * p.G * p.Zo;
  if (ntiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  p.ntiles = static_cast<int>(ntiles);

  int dev = 0, optin = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t slot_in = (R + 2) * p.rsb;
  const uint32_t wstage = 9 * NP * 32;
  const int64_t fixed = 128 + HDR + EPI_BYTES;
  const int64_t wres = static_cast<int64_t>(p.CC) * 3 * wstage;
  p.resident = p.G == 1 && fixed + wres + 3 * slot_in <= optin;
  p.wres_bytes = p.resident ? static_cast<uint32_t>(wres) : 0;
  p.slot_bytes = slot_in + (p.resident ? 0 : wstage);
  const int64_t stages = (optin - fixed - p.wres_bytes) / p.slot_bytes;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  p.stages = static_cast<int>(stages < MAX_STAGES ? stages : MAX_STAGES);
  p.ring = HDR + p.wres_bytes;
  p.epi = p.ring + p.stages * p.slot_bytes;
  const size_t smem = 128 + p.epi + EPI_BYTES;

  // 1. the bf16 copy
  const int CG = 2 * p.CC;
  err = cast(x, xb, N, Cin, Z, X, Y, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2. its tensor map: (8 channels, Y, CG, X, N Z), boxes of (8, 64 + 2dy,
  // 2, 1, 1), or (8, 64, 2, 1, 1) segmented; coordinates past an edge read
  // as zeros
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(Y),
                              static_cast<cuuint64_t>(CG),
                              static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(N) * Z};
  const cuuint64_t strides[4] = {16, 16ull * Y, 16ull * Y * CG,
                                 16ull * Y * CG * X};
  const cuuint32_t box[5] = {8, p.bys, 2, 1, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, xb, dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  // 3. the GEMM: one persistent block per SM
  err = cudaFuncSetAttribute(tailconv_bf16_kernel<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.ntiles < nsm ? p.ntiles : nsm;
  tailconv_bf16_kernel<NP><<<grid, THREADS, smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   x      (N, Cin, Z, X, Y) float32, contiguous
//   xb     scratch of N Z X 2 ceil(Cin/16) Y 16 bytes, 16-byte aligned: the
//          bf16 copy of x (ops/tailconv.py::bf16_scratch_bytes)
//   wp     the weights (Cout, Cin, 3, 3, 3) rounded to bf16 and packed by
//          ops/tailconv.py::pack_weights_bf16 for N tile `np` (8, 16, ...,
//          64 or 128; Cout runs as ceil(Cout/np) groups), Cout and Cin
//          zero-padded
//   bias   (Cout,) float32
//   y      (N, Cout, Z-2, X-2dx, Y-2dy) float32, written
//   staged one uint64 the kernel adds the bytes it staged to
// Launches on `stream` and returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a shape it refuses (an empty output, a ring of
// two stages that does not fit the card's shared memory).
extern "C" int e2t_tailconv_bf16(const float* x, void* xb, const void* wp,
                                 const float* bias, float* y,
                                 unsigned long long* staged, int N, int Cin,
                                 int Z, int X, int Y, int Cout, int np,
                                 int dx, int dy, void* stream) {
  if (N < 1 || Cin < 1 || Cout < 1 || Z - 2 < 1 || X - 2 * dx < 1
      || Y - 2 * dy < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* w = static_cast<const unsigned char*>(wp);
#define E2T_CASE(NP)                                                      \
  case NP:                                                                \
    return launch<NP>(x, xb, w, bias, y, staged, N, Cin, Z, X, Y, Cout,   \
                      dx, dy, s);
  switch (np) {
    E2T_CASE(8) E2T_CASE(16) E2T_CASE(24) E2T_CASE(32) E2T_CASE(40)
    E2T_CASE(48) E2T_CASE(56) E2T_CASE(64) E2T_CASE(128)
  }
#undef E2T_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The first of the two kernels alone (x -> xb, arguments as above), for
// timing its share of a call.
extern "C" int e2t_tailconv_bf16_cast(const float* x, void* xb, int N,
                                      int Cin, int Z, int X, int Y,
                                      void* stream) {
  if (N < 1 || Cin < 1 || Z < 1 || X < 1 || Y < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cast(x, xb, N, Cin, Z, X, Y, static_cast<cudaStream_t>(stream)));
}
