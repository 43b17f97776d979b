// K1's kernel body, `tailconv_tc_kernel`, with its legs switchable at
// compile time. K1 (tailconv.cu, whose head note gives the design) builds
// only the full body, one instance per N tile; its ablation probe P2
// (ptail_ablate.cu) builds every probe at a few N tiles. So P2's `full` is
// K1 by construction, and any change to K1 reaches its probes.
//
// The legs:
//   dma   the cp.async copies of input rows and packed weights into the
//         ring, with their waits and barriers
//   stage the A fragment's ld.shared and its TF32 split
//   dot   the 9 `wgmma`s a stage (3 ky x 3 terms)
//   epi   the promotion every PROMOTE stages (wgmma_wait<0> plus the adds
//         into the totals), then bias and ReLU
//   out   the stores
// The probes (`Probe`, in the order of ops' PROBES): FULL runs every leg;
// NODOT folds each split fragment into the partials by one add instead of
// its wgmmas; NOSTAGE loads and splits the A fragments once, before the
// loop; NOEPI sums all stages into one accumulator, with no promotion, no
// bias and no ReLU (the bare conv); DOTONLY issues the wgmmas on a stage
// filled once and on fragments split once, and stores them raw; NONE copies
// and stores; DMAONLY copies, and every block writes one tiny shared block
// (THREADS floats); OUTONLY stores. Only FULL (K1's values) and NOEPI (the
// conv without bias and ReLU) compute values anyone reads.

#pragma once

#include "wgmma_tf32.cuh"

namespace {

constexpr int WG = 2;              // warpgroups per block
constexpr int THREADS = WG * 128;
constexpr int STAGES = 5;          // shared-memory ring depth
// Stages summed into one set of partials before they are added into the
// totals. The tensor cores' float32 accumulation truncates: summed in one
// accumulator over all 9 x Cin/8 stages its bias built up to 5-16x the
// error of cuDNN's float32 conv against float64 at the main paths' shapes
// (on an H100); added in every 3 stages it stays at 0.2-0.55x, at no
// measurable cost in time.
constexpr int PROMOTE = 3;

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

// This thread's A fragment at p (rows lane/4 (+8), channels lane%4 (+4) of
// the warp's 16 rows, in a staged row block of stride RS), split into
// TF32 hi and lo: what mma_group does before its wgmmas.
__device__ __forceinline__ void split_fragment(const float* p, int RS,
                                               uint32_t (&ah)[4],
                                               uint32_t (&al)[4]) {
  const float v[4] = {p[0], p[8], p[4 * RS], p[4 * RS + 8]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32_rna(v[i]);
    al[i] = tf32_rna(v[i] - __uint_as_float(ah[i]));
  }
}

// mma_group's wgmmas on fragments split earlier (NOSTAGE, DOTONLY).
template <int NP>
__device__ __forceinline__ void mma_split(float (&part)[NP / 2],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float* w, bool first) {
  wgmma_wait<2>();
  const uint64_t bh = smem_desc(w);
  const uint64_t bl = smem_desc(w + NP * KC);
  wgmma_fence();
  Mma<NP>::run(part, ah, bl, first ? 0 : 1);
  Mma<NP>::run(part, al, bh, 1);
  Mma<NP>::run(part, ah, bh, 1);
  wgmma_commit();
}

// NODOT's stand-in for mma_group: the fragment loaded and split, each of
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

// One block: its two warpgroups' 64-output tiles cover R = 2 / tpr output
// rows (n, zo, xo0 .. xo0+R-1) of tpr tiles (64 tpr y outputs) each; a row
// of up to 64 outputs shares a block with the next instead of leaving half
// of it idle. `RS` is the staged row stride (>= 64 tpr + 2dy, 8 mod 32).
template <int NP, int P = FULL>
__global__ void __launch_bounds__(THREADS, 1)
tailconv_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int Cin, int Z, int X, int Y, int Cout, int Zo, int Xo,
                   int Yo, int dx, int dy, int tpr, int RS) {
  using L = Legs<P>;
  constexpr int WF = 3 * 2 * NP * KC;      // weight floats per stage
  extern __shared__ __align__(128) float smem[];
  const int R = WG / tpr;
  const int SF = WF + R * KC * RS;         // floats per stage

  const int xblocks = (Xo + R - 1) / R;
  const int64_t bx = blockIdx.x;           // (n, zo, x block), x fastest
  const int xo0 = static_cast<int>(bx % xblocks) * R;
  const int64_t rz = bx / xblocks;
  const int zo = static_cast<int>(rz % Zo);
  const int64_t n = rz / Zo;
  const int y0 = blockIdx.y * tpr * 64;
  const int g = blockIdx.z;                // output-channel group
  const int CC = (Cin + KC - 1) / KC;
  const int nsteps = CC * 9;

  // this thread's staging copies: elements tid, tid + THREADS, ... of the
  // R*KC rows of `cols` columns; (rc, j) advance by (qd, rm) per step
  const int cols = tpr * 64 + 2 * dy;
  const int total = R * KC * cols;
  const int qd = THREADS / cols, rm = THREADS % cols;
  const int rc0 = threadIdx.x / cols, j0 = threadIdx.x % cols;

  const int64_t plane = static_cast<int64_t>(X) * Y;
  const float* xn = x + n * Cin * Z * plane + zo * plane + y0;

  // stage s = (channel chunk cc, tap kz, kx) into ring slot `slot`
  auto load_stage = [&](int s, int slot) {
    float* sw = smem + slot * SF;
    float* si = sw + WF;
    const int cc = s / 9, tap = s - cc * 9;
    const int kz = tap / 3, kx = tap - kz * 3;
    const float* wsrc = wp + (static_cast<int64_t>(g * CC + cc) * 9 + tap) * WF;
    for (int i = threadIdx.x; i < WF / 4; i += THREADS)
      cp_async16(sw + 4 * i, wsrc + 4 * i);
    const float* xs = xn + kz * plane + static_cast<int64_t>(kx) * dx * Y;
    int rc = rc0, j = j0;
    for (int idx = threadIdx.x; idx < total; idx += THREADS) {
      const int ci = cc * KC + rc % KC;
      const int xr = min(xo0 + rc / KC, Xo - 1);
      const float* src = xs + min(ci, Cin - 1) * Z * plane
                         + static_cast<int64_t>(xr) * Y;
      const bool ok = ci < Cin && y0 + j < Y;
      cp_async4(si + rc * RS + j, ok ? src + j : src, ok ? 4 : 0);
      rc += qd;
      j += rm;
      if (j >= cols) {
        j -= cols;
        ++rc;
      }
    }
  };

  // ring of STAGES slots, filled STAGES - 2 stages ahead: the slot refilled
  // at stage s was read by stage s - 2, whose wgmmas every warpgroup has
  // waited for before the barrier at s (a group waits for all but the two
  // before it); DOTONLY fills slot 0 once
  if constexpr (P == DOTONLY) {
    load_stage(0, 0);
    cp_async_commit();
  } else if constexpr (L::dma) {
#pragma unroll
    for (int s = 0; s < STAGES - 2; ++s) {
      if (s < nsteps) load_stage(s, s);
      cp_async_commit();
    }
  }

  // totals and partial sums
  float acc[NP / 2], part[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = part[i] = 0.f;

  // this warpgroup's tile (staged row wg / tpr, y tile wg % tpr); this
  // thread's fragment rows 16 * warp + lane / 4 (+ 8), channels lane % 4
  // (+ 4)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;
  const int m0 = 16 * warp + lane / 4;
  const int toff = (wg / tpr) * KC * RS + (wg % tpr) * 64 + q * RS + m0;

  // NOSTAGE, DOTONLY: the three ky fragments of stage 0, split once
  uint32_t fh[3][4], fl[3][4];
  if constexpr (L::dot && !L::stage) {
    cp_async_wait<P == DOTONLY ? 0 : STAGES - 3>();
    __syncthreads();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      split_fragment(smem + WF + toff + ky * dy, RS, fh[ky], fl[ky]);
  }

  if constexpr (P != OUTONLY) {
    for (int s = 0; s < nsteps; ++s) {
      if constexpr (L::dma) {
        cp_async_wait<STAGES - 3>();       // this thread's copies of s landed
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();                   // everyone's; s-2's math done
        if (s + STAGES - 2 < nsteps)
          load_stage(s + STAGES - 2, (s + STAGES - 2) % STAGES);
        cp_async_commit();
      }
      const float* sw = smem + (L::dma ? s % STAGES : 0) * SF;
      const float* si = sw + WF + toff;
      // the partials start afresh every PROMOTE stages (without the
      // epilogue: once)
      const bool fresh = L::epi ? s % PROMOTE == 0 : s == 0;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        if constexpr (L::stage && L::dot)
          mma_group<NP>(part, si + ky * dy, sw + 2 * ky * NP * KC, RS,
                        ky == 0 && fresh);
        else if constexpr (L::dot)
          mma_split<NP>(part, fh[ky], fl[ky], sw + 2 * ky * NP * KC,
                        ky == 0 && fresh);
        else if constexpr (L::stage)
          fold_group<NP>(part, si + ky * dy, RS);
      }
      // every PROMOTE stages (and at the end) the partials, once done, are
      // added into the totals in float32 with round-to-nearest
      if constexpr (L::epi) {
        if (s % PROMOTE == PROMOTE - 1 || s == nsteps - 1) {
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < NP / 2; ++i) acc[i] += part[i];
          if constexpr (!L::dot) {
#pragma unroll
            for (int i = 0; i < NP / 2; ++i) part[i] = 0.f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (L::dot && !L::epi) {       // the raw sums, once done
    wgmma_wait<0>();
    fence_regs(part);
  }
  if constexpr (P == DMAONLY) {
    y[threadIdx.x] = part[0];
    return;
  }

  // epilogue: bias + ReLU (raw sums without the epi leg); accumulator 4j+e
  // holds tile row m0 + 8 (e / 2), channel 8j + 2q + e % 2
  const int xo = xo0 + wg / tpr;
  if (xo >= Xo) return;
  const int64_t ostride = static_cast<int64_t>(Zo) * Xo * Yo;  // per channel
  float* yrow = y + n * Cout * ostride + static_cast<int64_t>(zo) * Xo * Yo
                + static_cast<int64_t>(xo) * Yo;
  const int yb = y0 + (wg % tpr) * 64 + m0;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int co = g * NP + 8 * j + 2 * q + e2;
      if (co >= Cout) continue;
      const float bv = L::epi ? __ldg(bias + co) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int yo = yb + 8 * h;
        if (yo < Yo)
          yrow[co * ostride + yo] =
              L::epi ? fmaxf(acc[4 * j + 2 * h + e2] + bv, 0.f)
                     : part[4 * j + 2 * h + e2];
      }
    }
  }
}

template <int NP, int P = FULL>
int launch(const float* x, const float* wp, const float* bias, float* y,
           int N, int Cin, int Z, int X, int Y, int Cout, int dx, int dy,
           cudaStream_t stream) {
  const int Zo = Z - 2, Xo = X - 2 * dx, Yo = Y - 2 * dy;
  // tiles per row: both of the block's, or one where a tile covers a row
  const int tpr = Yo > 64 ? WG : 1;
  const int R = WG / tpr;
  const int RS = (tpr * 64 + 2 * dy + 23) / 32 * 32 + 8;
  const size_t smem = sizeof(float) * STAGES * (6 * NP * KC + R * KC * RS);
  cudaError_t err = cudaFuncSetAttribute(
      tailconv_tc_kernel<NP, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(
      static_cast<unsigned>(static_cast<int64_t>(N) * Zo * ((Xo + R - 1) / R)),
      static_cast<unsigned>((Yo + tpr * 64 - 1) / (tpr * 64)),
      static_cast<unsigned>((Cout + NP - 1) / NP));
  tailconv_tc_kernel<NP, P><<<grid, THREADS, smem, stream>>>(
      x, wp, bias, y, Cin, Z, X, Y, Cout, Zo, Xo, Yo, dx, dy, tpr, RS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
