// K1's kernel body, `tailconv_tc_kernel`, with its legs switchable at
// compile time, and its launch (the plan ops/tailconv.py::tc_plan computes
// the same). K1 (tailconv.cu, whose head note gives the design) builds
// only the full body, one instance per N tile; its ablation probe P2
// (ptail_ablate.cu) builds every probe at a few N tiles. So P2's `full` is
// K1 by construction, and any change to K1 reaches its probes.
//
// The legs, on the producer/consumer split:
//   dma   the producer's copies into the ring (TMA boxes or cp.async rows,
//         the weights' bulk copy) and its waits for free slots
//   stage the consumers' A fragment ld.shared and its TF32 split
//   dot   the 27 `wgmma`s of a (tile, stage) (9 taps x 3 terms)
//   epi   the promotion once a (tile, stage) (wgmma_wait<0> plus the adds
//         into the totals), then bias and ReLU
//   out   the stores
// The probes (`Probe`, in the order of ops' PROBES): FULL runs every leg;
// NODOT folds each split fragment into the partials by one add instead of
// its wgmmas; NOSTAGE loads and splits the A fragments once, before the
// loop; NOEPI sums all stages into one accumulator a tile, with no
// promotion, no bias and no ReLU (the bare conv); DOTONLY issues the
// wgmmas on a stage filled once and on fragments split once, and stores
// them raw; NONE copies and stores; DMAONLY copies, and every block writes
// one tiny shared block (THREADS floats); OUTONLY stores. Only FULL (K1's
// values) and NOEPI (the conv without bias and ReLU) compute values anyone
// reads.

#pragma once

#include "mbarrier_tma.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int CONSUMERS = 2;             // consumer warpgroups
// + the producer warpgroup: one thread of it issues the TMA route's
// copies, all 128 the cp.async route's; it gives registers up to the
// consumers (setmaxnreg), whose totals need them
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
static_assert(CONSUMERS * CONSUMER_REGS + PRODUCER_REGS
              <= (CONSUMERS + 1) * (65536 / THREADS / 8 * 8),
              "setmaxnreg: the consumers take what the producer gives up");
constexpr int MAX_STAGES = 8;
constexpr int HDR = 256;                 // the barriers' bytes
// y values of a staged row segment: 64 outputs' worth, padded to 8 mod 16
// (the fragment loads' bank rule, below)
constexpr int SEG_W = 72;

enum Probe { FULL, NODOT, NOSTAGE, NOEPI, DOTONLY, NONE, DMAONLY, OUTONLY,
             N_PROBES };

// The legs probe P runs.
template <int P>
struct Legs {
  static constexpr bool dma = P != DOTONLY && P != OUTONLY;
  static constexpr bool stage = P == FULL || P == NODOT || P == NOEPI;
  static constexpr bool dot = P == FULL || P == NOSTAGE || P == NOEPI
                              || P == DOTONLY;
  static constexpr bool epi = P == FULL || P == NODOT || P == NOSTAGE;
};

// m64 tiles (output rows) a consumer warpgroup holds totals for at N tile
// NP: 4 up to N 64 (its totals and one set of partials, 5 NP / 2
// registers a thread), 1 at N 128 (128 registers; each split A fragment
// then feeds a wgmma twice as wide, which measured faster than four m64
// tiles of 64 channels, tailconv.cu)
template <int NP>
__host__ __device__ constexpr int tiles_per_wg() { return NP <= 64 ? 4 : 1; }

// This thread's A fragment's four values at p (rows lane/4 (+8), channels
// lane%4 (+4) of the warp's 16 rows, in a staged row of channel stride RS).
__device__ __forceinline__ void load_fragment(const float* p, int RS,
                                              float (&v)[4]) {
  v[0] = p[0];
  v[1] = p[8];
  v[2] = p[4 * RS];
  v[3] = p[4 * RS + 8];
}

// Fragment values split into TF32 hi and lo: what mma_values does before
// its wgmmas.
__device__ __forceinline__ void split_values(const float (&v)[4],
                                             uint32_t (&ah)[4],
                                             uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32_rna(v[i]);
    al[i] = tf32_rna(v[i] - __uint_as_float(ah[i]));
  }
}

// The A fragment at p, split (NOSTAGE, DOTONLY, NODOT).
__device__ __forceinline__ void split_fragment(const float* p, int RS,
                                               uint32_t (&ah)[4],
                                               uint32_t (&al)[4]) {
  float v[4];
  load_fragment(p, RS, v);
  split_values(v, ah, al);
}

// One tap's three wgmmas on its split fragment, hi*lo, lo*hi and hi*hi
// (into fresh partials when `first`), as wgmma_tf32.cuh::mma_group issues
// them; the caller has waited for the group three back.
template <int NP>
__device__ __forceinline__ void mma3(float (&part)[NP / 2],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float* w,
                                     bool first) {
  const uint64_t bh = smem_desc(w);
  const uint64_t bl = smem_desc(w + NP * KC);
  wgmma_fence();
  Mma<NP>::run(part, ah, bl, first ? 0 : 1);
  Mma<NP>::run(part, al, bh, 1);
  Mma<NP>::run(part, ah, bh, 1);
  wgmma_commit();
}

// One tap on a fragment loaded a tap ahead (load_fragment), so that its
// shared loads are in flight while this waits for the group three back.
template <int NP>
__device__ __forceinline__ void mma_values(float (&part)[NP / 2],
                                           const float (&v)[4],
                                           const float* w, bool first) {
  wgmma_wait<2>();
  uint32_t ah[4], al[4];
  split_values(v, ah, al);
  mma3<NP>(part, ah, al, w, first);
}

// NODOT's stand-in for mma_values: the fragment loaded and split, each of
// its 8 split values added once into the partials.
template <int NP>
__device__ __forceinline__ void fold_group(float (&part)[NP / 2],
                                           const float* p, int RS) {
  uint32_t ah[4], al[4];
  split_fragment(p, RS, ah, al);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    part[i] += __uint_as_float(ah[i]);
    part[i] += __uint_as_float(al[i]);
  }
}

// The launch's geometry.
struct TcParams {
  const float* x;               // the cp.async route's source
  const float* wp;              // packed TF32 hi/lo weights
  const float* bias;
  float* y;
  unsigned long long* staged;   // += the bytes this launch staged (or null)
  int Cin, Z, X, Y, Cout, CC, G, Zo, Xo, Yo, dx, dy;
  int xtp;                      // block tiles per x phase
  int ytiles, ntiles, stages;
  int W;                        // y values of a staged row segment: the
                                // channel stride, 8 mod 16
  int nseg;                     // segments a staged row: 1 (64 + 2dy
                                // values), or 3 (64 from y0 + ky dy each)
  int kyoff;                    // floats from tap ky to ky + 1 in a row
  int dys;                      // y from segment ky to ky + 1 (0: one)
  int shmask;                   // TMA: 3, a box starts at the 16-byte
                                // boundary at or before its first value;
                                // cp.async: 0, at its first value
  uint32_t rowb;                // bytes of a staged row: nseg x 8 x W x 4
  uint32_t slot_bytes;          // (R + 2) rows, then the stage's weights
  int tma;                      // 1: TMA route, 0: cp.async route
};

struct Tile {
  int n, g, zo, px, i0, y0;
};

// tile t: zo fastest, then the channel group, y tile, x tile (phase
// fastest), n
__device__ __forceinline__ Tile decode(int t, const TcParams& p, int R) {
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

// The cp.async route's copies of one stage, by the producer's 128
// threads: the (R + 2) x nseg x 8 rows of W values (row j = input x px +
// dx (i0 + j), segment ky from y0 + ky dy, channel 8 cc + c of plane zr),
// a warp a row, zero-filled past Cin, X and Y.
template <int R>
__device__ __forceinline__ void stage_rows_cp(float* dst, const TcParams& p,
                                              const Tile& tl, int cc, int zr,
                                              int pt) {
  const int warp = pt >> 5, lane = pt & 31;
  const int rows = (R + 2) * p.nseg * 8;
  const int64_t plane = static_cast<int64_t>(p.X) * p.Y;
  for (int r = warp; r < rows; r += 4) {
    const int j = r / (p.nseg * 8);
    const int rem = r - j * p.nseg * 8;
    const int seg = rem >> 3, c = rem & 7;
    const int ci = cc * KC + c;
    const int xr = tl.px + p.dx * (tl.i0 + j);
    const bool row_ok = ci < p.Cin && xr < p.X;
    const float* src = p.x
        + ((static_cast<int64_t>(tl.n) * p.Cin + (row_ok ? ci : 0)) * p.Z
           + zr) * plane
        + static_cast<int64_t>(row_ok ? xr : 0) * p.Y;
    const int ys = tl.y0 + seg * p.dy;
    float* d = dst + (j * p.nseg + seg) * 8 * p.W + c * p.W;
    for (int yy = lane; yy < p.W; yy += 32) {
      const bool ok = row_ok && ys + yy < p.Y;
      cp_async4(d + yy, ok ? src + ys + yy : p.x, ok ? 4 : 0);
    }
  }
}

// One persistent block per SM walks the output tiles. A tile: R = 2T
// output rows of one x phase (xo = px + dx (i0 + i)), 64 y outputs each
// (one m64 tile; warpgroup wg holds rows wg T .. wg T + T - 1), N = one
// group of NP output channels. A stage is one (8-channel chunk cc, kz): the
// tile's R + 2 input rows of the chunk at plane zo + kz and the stage's 9
// taps of packed weights; tap (kx, ky) of row i reads staged row i + kx
// from y offset ky dy (or segment ky).
template <int NP, int P = FULL>
__global__ void __launch_bounds__(THREADS, 1)
tailconv_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ TcParams p) {
  using L = Legs<P>;
  constexpr int T = tiles_per_wg<NP>();
  constexpr int R = CONSUMERS * T;
  constexpr int TAPF = 2 * NP * KC;           // one tap's hi + lo floats
  constexpr uint32_t WSTAGE = 9 * TAPF * 4;   // one stage's weight bytes
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  const uint32_t full0 = base, empty0 = base + 8 * MAX_STAGES;
  const uint32_t ring = base + HDR;
  float* const ringp = reinterpret_cast<float*>(smem_raw + (ring - raw));
  const uint32_t in_bytes = (R + 2) * p.rowb;
  const int nsteps = p.CC * 3;                 // stages a tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      // TMA: the producer's arrival with the bytes; cp.async: also each
      // producer thread's arrival once its copies landed
      mbar_init(full0 + 8 * s, p.tma ? 1 : 1 + 128);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);    // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    const int pt = threadIdx.x - CONSUMERS * 128;
    if constexpr (!L::dma && P != DOTONLY) return;
    if (p.tma && pt != 0) return;
    unsigned long long staged = 0;
    int slot = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
      const Tile tl = decode(t, p, R);
      for (int s = 0; s < nsteps; ++s) {
        const int cc = s / 3, kz = s - 3 * cc;
        const int zr = tl.zo + kz;
        mbar_wait(empty0 + 8 * slot, ph ^ 1);
        const uint32_t full = full0 + 8 * slot;
        const uint32_t dst = ring + slot * p.slot_bytes;
        if (pt == 0) {
          mbar_expect_tx(full, WSTAGE + (p.tma ? in_bytes : 0));
          bulk_load(dst + in_bytes,
                    p.wp + (static_cast<int64_t>(tl.g * p.CC + cc) * 3 + kz)
                               * (9 * TAPF),
                    WSTAGE, full);
          if (p.tma) {
            // one box (W, 8 channels) a row segment, at the flattened
            // (z, x, y) coordinate of its first value rounded down to 16
            // bytes (a box must start there); channels past Cin and
            // coordinates past Z X Y read as zeros
            for (int j = 0; j < R + 2; ++j) {
              const int xr = tl.px + p.dx * (tl.i0 + j);
              const int f = (zr * p.X + xr) * p.Y + tl.y0;
              for (int seg = 0; seg < p.nseg; ++seg)
                tma_load3(dst + (j * p.nseg + seg) * (32 * p.W), &xmap, full,
                          (f + seg * p.dy) & ~3, cc * KC, tl.n);
            }
          }
          staged += WSTAGE + in_bytes;
        }
        if (!p.tma) {
          stage_rows_cp<R>(ringp + (dst - ring) / 4, p, tl, cc, zr, pt);
          cp_async_mbar_arrive(full);
        }
        if (++slot == p.stages) {
          slot = 0;
          ph ^= 1;
        }
        if constexpr (P == DOTONLY) break;   // one stage, read throughout
      }
      if constexpr (P == DOTONLY) break;
    }
    if (pt == 0 && p.staged != nullptr) atomicAdd(p.staged, staged);
    return;
  }

  // the consumers: this thread's accumulators 4j + 2h + e: row m0 + 8h,
  // channel 8j + 2q + e of each of its warpgroup's T tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int m0 = 16 * (tid >> 5) + (lane >> 2);
  const int rowf = static_cast<int>(p.rowb / 4);
  const int slotf = static_cast<int>(p.slot_bytes / 4);
  // this thread's fragment origin in a staged row; the row stride (8 mod
  // 16 floats) puts a warp's 32 loads in 32 banks
  const int toff = q * p.W + m0;
  const int64_t plane = static_cast<int64_t>(p.Xo) * p.Yo;
  const int64_t cstride = static_cast<int64_t>(p.Zo) * plane;
  const uint32_t dxy = static_cast<uint32_t>(p.dx * p.Y);

  // NOSTAGE, DOTONLY: the three ky fragments of the first stage's row
  // wg T, split once
  uint32_t fh[3][4], fl[3][4];
  if constexpr (L::dot && !L::stage) {
    mbar_wait(full0, 0);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      split_fragment(ringp + wg * T * rowf + toff + ky * p.kyoff, p.W,
                     fh[ky], fl[ky]);
  }

  float part[NP / 2];
  float tot[T][NP / 2];
#pragma unroll
  for (int k = 0; k < NP / 2; ++k) part[k] = 0.f;
  int slot = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
    const Tile tl = decode(t, p, R);
    // (a wgmma straight into the totals starts them afresh itself)
    if constexpr (L::epi || !L::dot) {
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int k = 0; k < NP / 2; ++k) tot[i][k] = 0.f;
    }

    if constexpr (P != OUTONLY) {
      for (int s = 0; s < nsteps; ++s) {
        if constexpr (L::dma) mbar_wait(full0 + 8 * slot, ph);
        const float* in = ringp + (L::dma ? slot : 0) * slotf;
        const float* w = in + (R + 2) * rowf;
        // the flattened x coordinate of staged row wg T's first value, mod
        // 4: where each box starts before it (y0 is a multiple of 4)
        const uint32_t rb = static_cast<uint32_t>(
            ((tl.zo + s % 3) * p.X + tl.px + p.dx * (tl.i0 + wg * T)) * p.Y);
        // tap (kx, ky) of row i: staged row i + kx from y offset ky dy (or
        // segment ky), past where its box starts before its first value
        auto frag = [&](int i, int kx, int ky) {
          const uint32_t sh = (rb + (i + kx) * dxy + ky * p.dys) & p.shmask;
          return in + (wg * T + i + kx) * rowf + toff + ky * p.kyoff + sh;
        };
        float v[4];                  // the next tap's fragment, loaded ahead
        if constexpr (L::stage && L::dot) load_fragment(frag(0, 0, 0), p.W, v);
#pragma unroll
        for (int i = 0; i < T; ++i) {
          // the 9 taps into fresh partials (with the epilogue), else
          // straight into the tile's one accumulator
          float(&acc)[NP / 2] = L::epi ? part : tot[i];
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
              const bool first = kx + ky == 0 && (L::epi || s == 0);
              const float* wk = w + (kx * 3 + ky) * TAPF;
              if constexpr (L::stage && L::dot) {
                const int k = 9 * i + 3 * kx + ky + 1;    // the next tap
                float vk[4] = {v[0], v[1], v[2], v[3]};
                if (k < 9 * T)
                  load_fragment(frag(k / 9, k / 3 % 3, k % 3), p.W, v);
                mma_values<NP>(acc, vk, wk, first);
              } else if constexpr (L::dot) {
                wgmma_wait<2>();
                mma3<NP>(acc, fh[ky], fl[ky], wk, first);
              } else if constexpr (L::stage) {
                fold_group<NP>(acc, frag(i, kx, ky), p.W);
              }
            }
          }
          // the partials, once done, added into the totals in float32
          // with round-to-nearest: 216 TF32 products an output
          if constexpr (L::epi) {
            if constexpr (L::dot) {
              wgmma_wait<0>();
              fence_regs(part);
            }
#pragma unroll
            for (int k = 0; k < NP / 2; ++k) tot[i][k] += part[k];
            if constexpr (!L::dot) {
#pragma unroll
              for (int k = 0; k < NP / 2; ++k) part[k] = 0.f;
            }
          }
        }
        if constexpr (L::dma) {
          // the slot's wgmmas read its weights until they are done
          if constexpr (L::dot && !L::epi) wgmma_wait<0>();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // this warp is done
          if (++slot == p.stages) {
            slot = 0;
            ph ^= 1;
          }
        }
      }
    }
    if constexpr (L::dot && !L::epi) {       // the raw sums, once done
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < T; ++i) fence_regs(tot[i]);
    }
    if constexpr (P == DMAONLY) continue;

    // epilogue: bias + ReLU (raw sums without the epi leg), stores along y
    // in NCDHW with 64-bit offsets
    const int cbase = tl.g * NP;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int xo = tl.px + p.dx * (tl.i0 + wg * T + i);
      if (xo >= p.Xo) continue;
      float* yrow = p.y + static_cast<int64_t>(tl.n) * p.Cout * cstride
                    + static_cast<int64_t>(tl.zo) * plane
                    + static_cast<int64_t>(xo) * p.Yo;
      const int yb = tl.y0 + m0;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = cbase + 8 * j + 2 * q + e;
          if (co >= p.Cout) continue;
          const float bv = L::epi ? __ldg(p.bias + co) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int yo = yb + 8 * h;
            if (yo < p.Yo) {
              const float v = tot[i][4 * j + 2 * h + e];
              yrow[co * cstride + yo] = L::epi ? fmaxf(v + bv, 0.f) : v;
            }
          }
        }
      }
    }
  }
  if constexpr (P == DMAONLY) p.y[threadIdx.x] = tot[0][0] + part[0];
}

// The host side of a launch: the plan (ops/tailconv.py::tc_plan computes
// the same), the route, the tensor map, the kernel. `staged` may be null.
template <int NP, int P = FULL>
int launch(const float* x, const float* wp, const float* bias, float* y,
           unsigned long long* staged, int N, int Cin, int Z, int X, int Y,
           int Cout, int dx, int dy, cudaStream_t stream) {
  constexpr int T = tiles_per_wg<NP>();
  constexpr int R = CONSUMERS * T;
  TcParams p;
  p.x = x;
  p.wp = wp;
  p.bias = bias;
  p.y = y;
  p.staged = staged;
  p.Cin = Cin;
  p.Z = Z;
  p.X = X;
  p.Y = Y;
  p.Cout = Cout;
  p.CC = (Cin + KC - 1) / KC;
  p.G = (Cout + NP - 1) / NP;
  p.Zo = Z - 2;
  p.Xo = X - 2 * dx;
  p.Yo = Y - 2 * dy;
  p.dx = dx;
  p.dy = dy;
  // a staged row: 64 + 2dy values (3 more where Y % 4 != 0: a TMA box
  // starts up to 3 values early) padded to 8 mod 16, or, where that takes
  // more room than three segments of SEG_W, one segment per ky
  const int w1 = (64 + 2 * dy + (Y % 4 ? 3 : 0) + 7) / 16 * 16 + 8;
  p.nseg = w1 > 3 * SEG_W ? 3 : 1;
  p.W = p.nseg == 3 ? SEG_W : w1;
  p.kyoff = p.nseg == 3 ? 8 * SEG_W : dy;
  p.dys = p.nseg == 3 ? dy : 0;
  p.rowb = static_cast<uint32_t>(p.nseg * 32 * p.W);
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
  p.slot_bytes = (R + 2) * p.rowb + 9 * 2 * NP * KC * 4;
  const int64_t stages = (optin - 128 - HDR) / p.slot_bytes;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  p.stages = static_cast<int>(stages < MAX_STAGES ? stages : MAX_STAGES);
  const size_t smem = 128 + HDR + static_cast<size_t>(p.stages) * p.slot_bytes;

  // the route: TMA where a float32 tensor map of x as (Z X Y, Cin, N) can
  // exist (16-byte aligned base and strides) and its flattened coordinates
  // stay far inside int32; else cp.async
  const int64_t zxy = static_cast<int64_t>(Z) * X * Y;
  p.tma = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && zxy % 4 == 0
          && zxy <= (1ll << 30);
  p.shmask = p.tma ? 3 : 0;
  CUtensorMap map = {};
  if (p.tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(zxy),
                                static_cast<cuuint64_t>(Cin),
                                static_cast<cuuint64_t>(N)};
    const cuuint64_t strides[2] = {4ull * zxy, 4ull * zxy * Cin};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(p.W), KC, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
               const_cast<float*>(x), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }

  err = cudaFuncSetAttribute(tailconv_tc_kernel<NP, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.ntiles < nsm ? p.ntiles : nsm;
  tailconv_tc_kernel<NP, P><<<grid, THREADS, smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
