// K3 for Hopper: frame-aligned (rotated) trilinear patch extraction plus
// the out-of-bounds flag, the patch cut of every step of the rotated
// tracing rollout (DeviceTracer(rotate_to_heading=True)), in two modes.
//
// Replaces the Pallas TPU kernel elektronn2_tpu/ops/pallas_extract_rot.py::
// rotated_patches_pallas in both its modes. Semantics are those of the XLA
// oracle DeviceTracer._extract_rot_batch (elektronn2_tpu/data/
// tracing_utils.py): for sample i of agent b with frame rows F (3x3),
//   coord = pos + F^T (i - (p-1)/2),
//   c0 = floor(coord), frac = coord - c0 (taken BEFORE the clip),
//   c0 clipped to [0, dims-2], the 8-corner sum ((wz*wx)*wy) * vol[...]
//   in the order dz, dx, dy, and
//   ok[b] = all samples have 0 <= coord <= dims-2.
// The bf16 mode (compute_dtype="bfloat16", pallas_extract_rot.py:284-301,
// :370-377) is the TPU kernel's single-pass bf16 contraction: its hat
// weights are non-zero at the two neighbouring corners of each axis only,
// so per sample
//   t[dy] = sum over (dz, dx) of bf16(wz*wx) * bf16(v[dz, dx, dy]),
//   out = wy0 * t[0] + wy1 * t[1],
// the products exact in float32 and every sum in float32, in the order
// (dz, dx) = (0,0), (0,1), (1,0), (1,1), then dy = 0, 1. The volume comes
// as a bf16 copy (made once by the caller), so its values are bf16 as
// staged; the coordinates, weights and ok are the float32 mode's.
//
// What bounds it on this card: the corner gathers. A rotated patch does
// not map to rows of the volume, so each sample reads 8 corners no
// neighbouring thread shares along a row; at B = 512 agents, patch 16^3,
// that is 16.8 M corner reads per call. Served from L1/L2 they cost 36 us
// (the former form of this kernel); the bytes the call must move (each
// agent's (p+1)^3 voxels once, 8 MB of patches) take 5.5 us at 3.35 TB/s.
// The TPU kernel's hat-weight matrix contraction on the MXU exists only
// because the TPU has no fast gather and is not carried over; its staged
// window (pallas_extract_rot.py::_geom) is.
//
// What the design does about it:
//  * each agent's window, the axis-aligned box of its rotated lattice, is
//    staged in shared memory and the 8 corners of every sample are read
//    from there. Along axis d the samples span pos_d -+ t_d, t_d = sum_j
//    |F_jd| (p_j-1)/2; the box runs from floor(pos_d - t_d - e) to
//    floor(pos_d + t_d + e) + 1, where e = 2^-20 (|pos_d| + t_d) is over
//    twice the float rounding of any sample's coordinate, and is clipped to
//    the volume. At 16^3 an edge is at most 28 voxels;
//  * float32 mode: the box's rows are copied with 16-byte cp.async from the
//    16-byte group that holds each row's start (stage_rows16 in
//    cp_async.cuh), so a row lands in shared memory at the same offset
//    within 16 bytes as in device memory; a sample finds its corner rows'
//    offsets from the row start's address (constant over the box when Y %
//    4 == 0);
//  * a block stages one (agent, channel) item's box into a window of
//    25088 floats (98 KB, a 28 x 28 box of 32-float rows at 16^3), waits
//    and blends it; two blocks share an SM and overlap each other's copies
//    and blends. A ring of two windows in one block (the next box copied
//    while this one is blended) measured 14-17% slower on an H100, and
//    blocks that walk over several items were no faster than one block per
//    item (PERF.md);
//  * bf16 mode (redesigned; PERF.md, scripts/exp_k3_legs.py): its first
//    form was the float32 body on rows of bf16 values, 8 two-byte corner
//    loads a sample. On an H100 it took 29.6 us a launch at the tracer's
//    shape, its blend alone 27.3 us, 13 of them the shared-memory bank
//    conflicts of a rotated lattice's corners (7.1 wavefronts a load: a
//    row of 40 values put most rows of a warp's corners on a few banks).
//    Now a box is staged as a pair window (stage_pairs), word j of a row
//    holding the values at y and y + 1, so a sample makes 4 32-bit loads,
//    with pitches (ops/extract_rot.py::pair_pitches) that spread a warp's
//    rows over the banks (simulated on the tracer's frames: 9.5 wavefronts
//    a warp-sample, 57 before). A 16-byte copy cannot build a pair at an
//    odd y, so a thread loads 8 pieces (and each one's next value) into
//    registers before it stores their pair words. The blend walks one
//    column (ix, iy) of the patch a thread, takes the interior floor with
//    one rounding-down add (floor_magic) and rounds bf16(wz*wx) two at a
//    time. The window, 94.7 KB at 16^3 (23688 words: 28 planes of 28 rows
//    of 30 words, + 6 a plane), lets two blocks share an SM;
//  * no shared-memory value is read unless this item's copy wrote it (the
//    0*NaN trap of pallas_extract_rot.py:239-247): a sample whose corners
//    fall outside the staged box, or an item whose box outgrows the window
//    (only frames that are not orthonormal do), reads its corners from
//    device memory instead, with the same arithmetic;
//  * what was staged is counted, by one atomic add per item into `stats`:
//    stats[0] the items whose box outgrew the window, stats[1] the values
//    copied into shared memory (floats, or two bf16 values a pair word
//    written), so a window sized too small for the boxes the kernel
//    computes shows as stats[0] > 0 (ops/extract_rot.py::staging_stats);
//  * the float32 mode's sample walk steps its mixed-radix digits by the
//    block's stride, with one carry at most per digit: no division per
//    sample;
//  * coordinates are computed in the oracle's order, t = F0i*o0 + F1i*o1,
//    t = t + F2i*o2, coord = pos_i + t, with __fmul_rn / __fadd_rn so nvcc
//    contracts nothing into FMAs: patches and ok equal the plain PyTorch
//    version bit for bit;
//  * ok is the all-samples criterion on those same coordinates, reduced
//    over the block with __syncthreads_and;
//  * an agent whose box, before the clip, lies in [0, dims-2] (the common
//    case) takes a sample loop without the per-sample bound test, clip and
//    box test: every coordinate lies in [pos - t - e, pos + t + e], inside
//    that box, so all three hold for every sample and ok is true, as the
//    plain version finds.
// The kernel's dynamic shared-memory limit is lifted to the card's opt-in
// once, by e2t_rotated_patches_init, outside any CUDA graph capture.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Geometry {
  int F, Z, X, Y;      // volume (F, Z, X, Y)
  int pz, px, py;      // patch
  int cap;             // values of the window (bf16 mode: 32-bit words)
  int row_words;       // bf16 mode: pitch of a staged row, in words
  int plane_words;     // bf16 mode: pitch of a staged plane, in words
  const T* end;        // the end of the volume, never read
};

// Values of T in a 16-byte piece.
template <typename T>
constexpr int kPer = 16 / sizeof(T);

struct Digits {
  int z, x, y;
};

__device__ __forceinline__ Digits digits(int i, int ex, int ey) {
  Digits d;
  const int plane = ex * ey;
  d.z = i / plane;
  const int r = i - d.z * plane;
  d.x = r / ey;
  d.y = r - d.x * ey;
  return d;
}

// Advance (z, x, y) by `st` (with st.x < ex, st.y < ey): one carry at most
// per digit.
__device__ __forceinline__ void advance(int& z, int& x, int& y,
                                        const Digits& st, int ex, int ey) {
  y += st.y;
  x += st.x;
  z += st.z;
  if (y >= ey) {
    y -= ey;
    ++x;
  }
  if (x >= ex) {
    x -= ex;
    ++z;
  }
}

// Values a staged row takes: 16-byte pieces enough for n values from any
// offset within 16 bytes (ops/extract_rot.py::row_values).
template <typename T>
__device__ __forceinline__ int row_values(int n) {
  return kPer<T> * ((n + 2 * kPer<T> - 2) / kPer<T>);
}

struct Agent {
  float fr[9];   // frame rows: fr[3*j + i] = F[j][i]
  float p0[3];
  int lo[3];     // the staged box: origin and edges
  int ext[3];
  int rp;        // floats per staged row
  bool staged;   // the box fits the window
  bool interior; // staged, and its unclipped box lies in [0, dims-2]
};

template <typename T>
__device__ __forceinline__ Agent load_agent(const float* __restrict__ pos,
                                            const float* __restrict__ frames,
                                            int b, const Geometry<T>& g) {
  Agent a;
#pragma unroll
  for (int k = 0; k < 9; ++k) a.fr[k] = __ldg(frames + 9 * b + k);
#pragma unroll
  for (int d = 0; d < 3; ++d) a.p0[d] = __ldg(pos + 3 * b + d);
  const int dims[3] = {g.Z, g.X, g.Y};
  const float half[3] = {0.5f * (float)(g.pz - 1), 0.5f * (float)(g.px - 1),
                         0.5f * (float)(g.py - 1)};
  bool interior = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float t = __fadd_rn(__fmul_rn(fabsf(a.fr[d]), half[0]),
                        __fmul_rn(fabsf(a.fr[3 + d]), half[1]));
    t = __fadd_rn(t, __fmul_rn(fabsf(a.fr[6 + d]), half[2]));
    const float e = __fmul_rn(__fadd_rn(fabsf(a.p0[d]), t), 0x1p-20f);
    const float lo_f = floorf(__fsub_rn(__fsub_rn(a.p0[d], t), e));
    const float hi_f = floorf(__fadd_rn(__fadd_rn(a.p0[d], t), e)) + 1.f;
    interior = interior && lo_f >= 0.f && hi_f <= (float)(dims[d] - 2);
    // the bf16 mode's interior floor (floor_magic) holds below 2^22
    if (sizeof(T) == 2) interior = interior && dims[d] <= (1 << 22);
    const float lo = fminf(fmaxf(lo_f, 0.f), (float)(dims[d] - 2));
    const float hi = fminf(fmaxf(hi_f, lo + 1.f), (float)(dims[d] - 1));
    a.lo[d] = (int)lo;
    a.ext[d] = (int)hi - a.lo[d] + 1;
  }
  a.rp = row_values<T>(a.ext[2]);
  if (sizeof(T) == 2)
    a.staged = a.ext[2] + 1 <= g.row_words
        && (int64_t)a.ext[1] * g.row_words <= g.plane_words
        && (int64_t)a.ext[0] * g.plane_words <= g.cap;
  else
    a.staged = (int64_t)a.ext[0] * a.ext[1] * a.rp <= g.cap;
  a.interior = a.staged && interior;
  return a;
}

// The 8-corner sum of one sample from its corner rows r00 (dz, dx) = (0,
// 0), r01 (0, 1), r10 (1, 0), r11 (1, 1), each pointing at the corner's y.
// float32: in the oracle's order, w = (wz*wx)*wy, acc = acc + w*v from 0.
__device__ __forceinline__ float corner_sum(const float* r00,
                                            const float* r01,
                                            const float* r10,
                                            const float* r11,
                                            const float w0[3],
                                            const float w1[3]) {
  const float* rows[4] = {r00, r01, r10, r11};
  float acc = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float w = __fmul_rn(
            __fmul_rn(dz ? w1[0] : w0[0], dx ? w1[1] : w0[1]),
            dy ? w1[2] : w0[2]);
        acc = __fadd_rn(acc, __fmul_rn(w, rows[2 * dz + dx][dy]));
      }
  return acc;
}

// bf16: t[dy] = sum over (dz, dx) of bf16(wz*wx) * v, then
// out = wy0*t[0] + wy1*t[1], every sum in float32 from 0 (the products of
// two bf16 values are exact in float32).
__device__ __forceinline__ float corner_sum(const __nv_bfloat16* r00,
                                            const __nv_bfloat16* r01,
                                            const __nv_bfloat16* r10,
                                            const __nv_bfloat16* r11,
                                            const float w0[3],
                                            const float w1[3]) {
  const __nv_bfloat16* rows[4] = {r00, r01, r10, r11};
  float wzx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wzx[k] = __bfloat162float(__float2bfloat16_rn(
        __fmul_rn(k >> 1 ? w1[0] : w0[0], k & 1 ? w1[1] : w0[1])));
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      t = __fadd_rn(t, __fmul_rn(wzx[k], __bfloat162float(rows[k][dy])));
    acc = __fadd_rn(acc, __fmul_rn(dy ? w1[2] : w0[2], t));
  }
  return acc;
}

// The same sum read from device memory: the rare sample whose corners lie
// outside the staged box. Not inlined, so the hot path keeps its shared-
// memory loads and nothing of this one.
template <typename T>
__device__ __noinline__ float corner_sum_global(const T* __restrict__ v,
                                                int64_t plane, int row,
                                                float wz0, float wz1,
                                                float wx0, float wx1,
                                                float wy0, float wy1) {
  const float w0[3] = {wz0, wx0, wy0}, w1[3] = {wz1, wx1, wy1};
  return corner_sum(v, v + row, v + plane, v + plane + row, w0, w1);
}

// Blend item (b, c) of agent `a`, staged at `win` from `box` (the device
// address of the box's first voxel in channel base vc); returns this
// thread's ok (every sample it computed in bounds).
//   kInterior: `a` is interior, so every sample lies in bounds (ok), its
//     clip does nothing and its corners lie in the staged box, and none of
//     the three is tested;
//   kAligned: Y % kPer<T> == 0, so every staged row has the first row's
//     offset within 16 bytes.
template <typename T, bool kInterior, bool kAligned>
__device__ __forceinline__ int blend_box(const T* win,
                                         const T* __restrict__ vc,
                                         const T* box,
                                         float* __restrict__ o,
                                         const Agent& a, const Geometry<T>& g,
                                         Digits t0, Digits st) {
  constexpr int kM = kPer<T> - 1;
  const int dims[3] = {g.Z, g.X, g.Y};
  const float half[3] = {0.5f * (float)(g.pz - 1), 0.5f * (float)(g.px - 1),
                         0.5f * (float)(g.py - 1)};
  const int64_t XY = (int64_t)g.X * g.Y;
  const int ex = a.ext[1], rp = a.rp;
  // a staged row (z, x) starts at win + (z*ex + x)*rp + its shift, the
  // row start's offset within 16 bytes: (s0 + z*mz + x*mx) mod kPer values
  const int s0 = row_shift(box);
  const int mz = (int)(XY & kM), mx = g.Y & kM;
  const int n_out = g.pz * g.px * g.py;
  int all_ok = 1;
  int iz = t0.z, ix = t0.x, iy = t0.y;
  // F1d*o1 and F2d*o2 of the last ix and iy: a thread's samples lie
  // THREADS apart, so (ix, iy) change rarely (never at a 16^3 patch)
  int last_x = -1, last_y = -1;
  float fx[3], fy[3];
  for (int i = threadIdx.x; i < n_out; i += THREADS) {
    if (ix != last_x) {
      last_x = ix;
      const float o1 = __fsub_rn((float)ix, half[1]);
#pragma unroll
      for (int d = 0; d < 3; ++d) fx[d] = __fmul_rn(a.fr[3 + d], o1);
    }
    if (iy != last_y) {
      last_y = iy;
      const float o2 = __fsub_rn((float)iy, half[2]);
#pragma unroll
      for (int d = 0; d < 3; ++d) fy[d] = __fmul_rn(a.fr[6 + d], o2);
    }
    const float o0 = __fsub_rn((float)iz, half[0]);
    int c0[3];
    float w0[3], w1[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float t = __fadd_rn(__fadd_rn(__fmul_rn(a.fr[d], o0), fx[d]),
                                fy[d]);
      const float c = __fadd_rn(a.p0[d], t);
      const float hi = (float)(dims[d] - 2);
      if (!kInterior) all_ok &= (c >= 0.f) & (c <= hi);
      const float fl = floorf(c);
      const float f1 = __fsub_rn(c, fl);
      c0[d] = kInterior ? (int)fl : (int)fminf(fmaxf(fl, 0.f), hi);
      w0[d] = __fsub_rn(1.f, f1);
      w1[d] = f1;
    }
    const int lz = c0[0] - a.lo[0], lx = c0[1] - a.lo[1],
              ly = c0[2] - a.lo[2];
    const bool inside = kInterior || (a.staged
        && (unsigned)lz <= (unsigned)(a.ext[0] - 2)
        && (unsigned)lx <= (unsigned)(ex - 2)
        && (unsigned)ly <= (unsigned)(a.ext[2] - 2));
    if (inside) {
      const T* r00 = win + (lz * ex + lx) * rp + ly;
      const T* r10 = r00 + ex * rp;
      if (kAligned) {
        o[i] = corner_sum(r00 + s0, r00 + rp + s0, r10 + s0, r10 + rp + s0,
                          w0, w1);
      } else {
        const int h00 = (s0 + lz * mz + lx * mx) & kM;
        const int h01 = (h00 + mx) & kM, h10 = (h00 + mz) & kM;
        const int h11 = (h10 + mx) & kM;
        o[i] = corner_sum(r00 + h00, r00 + rp + h01, r10 + h10,
                          r10 + rp + h11, w0, w1);
      }
    } else {
      o[i] = corner_sum_global(vc + c0[0] * XY + (int64_t)c0[1] * g.Y + c0[2],
                               XY, g.Y, w0[0], w1[0], w0[1], w1[1], w0[2],
                               w1[2]);
    }
    advance(iz, ix, iy, st, g.px, g.py);
  }
  return all_ok;
}

// The device address of the first voxel of a's box in channel base vc.
template <typename T>
__device__ __forceinline__ const T* box_origin(const T* vc, const Agent& a,
                                              const Geometry<T>& g) {
  return vc + (a.lo[0] * (int64_t)g.X + a.lo[1]) * g.Y + a.lo[2];
}

// Start this thread's copies of a's box (channel base vc) into `win`.
template <typename T>
__device__ __forceinline__ void stage_box(T* win, const T* vc,
                                          const Agent& a,
                                          const Geometry<T>& g) {
  const int64_t XY = (int64_t)g.X * g.Y;
  stage_rows16(win, a.ext[1] * a.rp, a.rp, box_origin(vc, a, g), XY, g.Y,
               a.ext[0], a.ext[1], a.rp / kPer<T>, g.end, threadIdx.x,
               THREADS);
}

// ------------------------------------------------------------ the bf16 mode
//
// The pair window. Word j of staged row (z, x) holds the bf16 values of the
// volume at y and y + 1, the one at y in its low half, y = lo_y - par + j:
// a sample reads both dy corners of one (dz, dx) row with one 32-bit load
// (4 shared loads a sample, not 8) and unpacks each by a shift or a mask (a
// bf16 is the high half of a float32). Rows lie g.row_words apart, planes
// g.plane_words, both launch constants (ops/extract_rot.py::pair_pitches):
// row_words is even, at least the box's y edge + 1 and 2 mod 4, and
// plane_words is the x edge times row_words + 6, so that the rows a warp's
// rotated 2 x 16 sheet of samples touches spread over the banks. par is the
// parity of the box's row start within its 16-byte piece in the aligned
// instance (0 otherwise), so the aligned instance stores whole 8-byte pairs
// of words.

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The 8-corner sum of one sample from its four pair words q[k], k = 2*dz +
// dx, in the arithmetic of the bf16 corner_sum above: bf16(wz*wx) rounded to
// nearest even (two at a time), products and sums in float32 from 0.
__device__ __forceinline__ float pair_sum(const uint32_t q[4],
                                          const float w0[3],
                                          const float w1[3]) {
  const __nv_bfloat162 z0 = __floats2bfloat162_rn(__fmul_rn(w0[0], w0[1]),
                                                  __fmul_rn(w0[0], w1[1]));
  const __nv_bfloat162 z1 = __floats2bfloat162_rn(__fmul_rn(w1[0], w0[1]),
                                                  __fmul_rn(w1[0], w1[1]));
  const uint32_t u0 = *reinterpret_cast<const uint32_t*>(&z0);
  const uint32_t u1 = *reinterpret_cast<const uint32_t*>(&z1);
  const float wzx[4] = {bf16_lo(u0), bf16_hi(u0), bf16_lo(u1), bf16_hi(u1)};
  float t0 = 0.f, t1 = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t0 = __fadd_rn(t0, __fmul_rn(wzx[k], bf16_lo(q[k])));
    t1 = __fadd_rn(t1, __fmul_rn(wzx[k], bf16_hi(q[k])));
  }
  return __fadd_rn(__fadd_rn(0.f, __fmul_rn(w0[2], t0)),
                   __fmul_rn(w1[2], t1));
}

// 32 bits of the volume at p (4-byte aligned); values at or past `end` read
// as zero, never loaded.
__device__ __forceinline__ uint32_t load_word(const __nv_bfloat16* p,
                                              const __nv_bfloat16* end) {
  if (p + 2 <= end) return __ldg(reinterpret_cast<const unsigned int*>(p));
  if (p < end)
    return static_cast<uint32_t>(
        __ldg(reinterpret_cast<const unsigned short*>(p)));
  return 0u;
}

// The 16-byte piece of the volume at p (16-byte aligned), guarded as
// load_word.
__device__ __forceinline__ uint4 load_piece(const __nv_bfloat16* p,
                                            const __nv_bfloat16* end) {
  if (p + 8 <= end) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(load_word(p, end), load_word(p + 2, end),
                    load_word(p + 4, end), load_word(p + 6, end));
}

// Words of the pair window a staged row gets (stats): the aligned instance
// stores whole pairs of words up to the last one a sample reads.
template <bool kAligned>
__device__ __forceinline__ int pair_row_written(int ny, int par) {
  return kAligned ? 2 * ((ny - 2 + par) / 2 + 1) : ny - 1;
}

// Pieces a thread loads before it stores any (stage_pairs): the loads of a
// batch are in flight together, so a thread waits for device memory once a
// batch, not once a piece.
constexpr int kStageBatch = 8;

// Stage a's box (channel base vc) into the pair window: each thread takes
// the 16-byte pieces tid, tid + THREADS, ... of the box's rows in (z, x,
// piece) order, stepping its digits with one carry at most each, in
// batches of kStageBatch. A piece (8 values from its 16-byte aligned start)
// gives the pair words of its 8 values, the last one completed by the next
// piece's first value.
//   kSafe: every piece, and the value after it, lies before the volume's
//     end, so no load is guarded.
template <bool kAligned, bool kSafe>
__device__ __forceinline__ void stage_pairs(uint32_t* win,
                                            const __nv_bfloat16* vc,
                                            const Agent& a,
                                            const Geometry<__nv_bfloat16>& g,
                                            int par) {
  const int64_t XY = (int64_t)g.X * g.Y;
  const __nv_bfloat16* box = box_origin(vc, a, g);
  const int nz = a.ext[0], nx = a.ext[1], ny = a.ext[2];
  const int chunks = (ny + 13) / 8;          // pieces of a row, any shift
  const int s0 = row_shift(box);
  const int per_z = nx * chunks;
  int z = threadIdx.x / per_z;
  int r = threadIdx.x - z * per_z;
  int x = r / chunks;
  int c = r - x * chunks;
  const int st_z = THREADS / per_z;
  r = THREADS - st_z * per_z;
  const int st_x = r / chunks;
  const int st_c = r - st_x * chunks;
  while (z < nz) {
    uint4 v[kStageBatch];
    uint32_t n[kStageBatch];
    int dst[kStageBatch];    // the piece's first word in the window, or -1
    int j0[kStageBatch];     // ... and the row word of its first value
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      dst[k] = -1;
      if (z < nz) {
        const __nv_bfloat16* row = box + z * XY + (int64_t)x * g.Y;
        const int s = kAligned ? s0 : row_shift(row);
        // the piece's values sit at positions 8c .. 8c+7 of the row's
        // aligned start; pairs start at positions s .. s + ny - 2
        if (8 * c <= s + ny - 2) {
          const __nv_bfloat16* pa = row - s + 8 * c;
          const bool next = 8 * c + 7 <= s + ny - 2;
          if (kSafe) {
            v[k] = __ldg(reinterpret_cast<const uint4*>(pa));
            n[k] = next ? __ldg(reinterpret_cast<const unsigned int*>(pa + 8))
                        : 0u;
          } else {
            v[k] = load_piece(pa, g.end);
            n[k] = next ? load_word(pa + 8, g.end) : 0u;
          }
          dst[k] = z * g.plane_words + x * g.row_words;
          j0[k] = 8 * c - s + par;   // aligned: even, as s - par is
        }
        c += st_c;
        x += st_x;
        z += st_z;
        if (c >= chunks) {
          c -= chunks;
          ++x;
        }
        if (x >= nx) {
          x -= nx;
          ++z;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      if (dst[k] < 0) continue;
      const uint32_t p[8] = {v[k].x, __byte_perm(v[k].x, v[k].y, 0x5432),
                             v[k].y, __byte_perm(v[k].y, v[k].z, 0x5432),
                             v[k].z, __byte_perm(v[k].z, v[k].w, 0x5432),
                             v[k].w, __byte_perm(v[k].w, n[k], 0x5432)};
      uint32_t* wr = win + dst[k];
      if (kAligned) {
        const int jn = ny - 2 + par;           // the last word read
#pragma unroll
        for (int q = 0; q < 8; q += 2)
          if (j0[k] + q >= 0 && j0[k] + q <= jn)
            *reinterpret_cast<uint2*>(wr + j0[k] + q) =
                make_uint2(p[q], p[q + 1]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (j0[k] + q >= 0 && j0[k] + q <= ny - 2) wr[j0[k] + q] = p[q];
      }
    }
  }
}

// floor(c) and its integer for 0 <= c < 2^22 by one rounding-down add:
// c + 1.5 * 2^23 lies in [2^23, 2^24), where floats are the integers, so
// the add rounded down is floor(c) + 1.5 * 2^23 and its bits differ from
// those of 1.5 * 2^23 by floor(c). (floorf and a float-to-int conversion
// take the card's conversion unit, a quarter of the add's rate.)
__device__ __forceinline__ float floor_magic(float c, int* ci) {
  constexpr float kMagic = 12582912.0f;      // 1.5 * 2^23
  const float m = __fadd_rd(c, kMagic);
  *ci = __float_as_int(m) - __float_as_int(kMagic);
  return __fsub_rn(m, kMagic);
}

// Blend item (b, c) of agent `a` from the pair window: each thread takes a
// column (ix, iy) of the patch and walks its iz (so F1*o1 and F2*o2 are
// computed once a column and the samples of the walk are independent), a
// warp taking 32 neighbouring columns, so its output stores are
// contiguous. Returns this thread's ok.
//   kInterior: as in blend_box (no per-sample bound test, clip or box
//     test), and the floor is floor_magic's.
template <bool kInterior>
__device__ __forceinline__ int blend_pairs(
    const uint32_t* win, const __nv_bfloat16* __restrict__ vc,
    float* __restrict__ o, const Agent& a, const Geometry<__nv_bfloat16>& g,
    int par) {
  const int dims[3] = {g.Z, g.X, g.Y};
  const float half[3] = {0.5f * (float)(g.pz - 1), 0.5f * (float)(g.px - 1),
                         0.5f * (float)(g.py - 1)};
  const int64_t XY = (int64_t)g.X * g.Y;
  const int RX = g.row_words, RZ = g.plane_words;
  const int cols = g.px * g.py;
  const int reps = cols >= THREADS ? 1 : THREADS / cols;
  const float step = (float)reps;
  int all_ok = 1;
  for (int u = threadIdx.x; u < cols * reps; u += THREADS) {
    const int z0 = u / cols, col = u - z0 * cols;
    const int ix = col / g.py, iy = col - ix * g.py;
    const float o1 = __fsub_rn((float)ix, half[1]);
    const float o2 = __fsub_rn((float)iy, half[2]);
    float fx[3], fy[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      fx[d] = __fmul_rn(a.fr[3 + d], o1);
      fy[d] = __fmul_rn(a.fr[6 + d], o2);
    }
    float o0 = __fsub_rn((float)z0, half[0]);  // exact: integers and halves
    float* oc = o + col;
#pragma unroll 2
    for (int iz = z0; iz < g.pz; iz += reps) {
      int c0[3];
      float w0[3], w1[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float t = __fadd_rn(__fadd_rn(__fmul_rn(a.fr[d], o0), fx[d]),
                                  fy[d]);
        const float c = __fadd_rn(a.p0[d], t);
        float fl;
        if (kInterior) {
          fl = floor_magic(c, &c0[d]);
        } else {
          const float hi = (float)(dims[d] - 2);
          all_ok &= (c >= 0.f) & (c <= hi);
          fl = floorf(c);
          c0[d] = (int)fminf(fmaxf(fl, 0.f), hi);
        }
        const float f1 = __fsub_rn(c, fl);
        w0[d] = __fsub_rn(1.f, f1);
        w1[d] = f1;
      }
      o0 = __fadd_rn(o0, step);
      const int lz = c0[0] - a.lo[0], lx = c0[1] - a.lo[1],
                ly = c0[2] - a.lo[2];
      const bool inside = kInterior || (a.staged
          && (unsigned)lz <= (unsigned)(a.ext[0] - 2)
          && (unsigned)lx <= (unsigned)(a.ext[1] - 2)
          && (unsigned)ly <= (unsigned)(a.ext[2] - 2));
      float v;
      if (inside) {
        const uint32_t* r = win + lz * RZ + lx * RX + ly + par;
        const uint32_t q[4] = {r[0], r[RX], r[RZ], r[RZ + RX]};
        v = pair_sum(q, w0, w1);
      } else {
        v = corner_sum_global(vc + c0[0] * XY + (int64_t)c0[1] * g.Y + c0[2],
                              XY, g.Y, w0[0], w1[0], w0[1], w1[1], w0[2],
                              w1[2]);
      }
      oc[iz * cols] = v;
    }
  }
  return all_ok;
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(THREADS, 2)
rotated_patches_kernel(const T* __restrict__ vol,
                       const float* __restrict__ pos,
                       const float* __restrict__ frames,
                       float* __restrict__ out, unsigned char* __restrict__ ok,
                       unsigned long long* __restrict__ stats,
                       const Geometry<T> g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = blockIdx.x;
  const int b = w / g.F, c = w - b * g.F;
  const Agent a = load_agent(pos, frames, b, g);
  const T* vc = vol + c * ((int64_t)g.Z * g.X * g.Y);
  float* o = out + (int64_t)w * (g.pz * g.px * g.py);
  int mine;
  if constexpr (sizeof(T) == 4) {
    T* win = reinterpret_cast<T*>(smem);
    if (a.staged) stage_box(win, vc, a, g);
    cp_async_commit();
    cp_async_wait<0>();              // this thread's copies landed
    __syncthreads();                 // ... and every other thread's
    if (threadIdx.x == 0) {
      if (a.staged)
        atomicAdd(stats + 1, (unsigned long long)a.ext[0] * a.ext[1] * a.rp);
      else
        atomicAdd(stats, 1ull);
    }
    const Digits t0 = digits(threadIdx.x, g.px, g.py);
    const Digits st = digits(THREADS, g.px, g.py);
    const T* box = box_origin(vc, a, g);
    mine = a.interior
               ? blend_box<T, true, kAligned>(win, vc, box, o, a, g, t0, st)
               : blend_box<T, false, kAligned>(win, vc, box, o, a, g, t0, st);
  } else {
    uint32_t* win = reinterpret_cast<uint32_t*>(smem);
    const int par = kAligned ? row_shift(box_origin(vc, a, g)) & 1 : 0;
    if (a.staged) {
      // the last row's pieces end last: its aligned start, its pieces and
      // the value after them
      const __nv_bfloat16* last = box_origin(vc, a, g)
          + (a.ext[0] - 1) * ((int64_t)g.X * g.Y)
          + (int64_t)(a.ext[1] - 1) * g.Y;
      if (last - row_shift(last) + 8 * ((a.ext[2] + 13) / 8) + 2 <= g.end)
        stage_pairs<kAligned, true>(win, vc, a, g, par);
      else
        stage_pairs<kAligned, false>(win, vc, a, g, par);
    }
    __syncthreads();                 // every thread's stores landed
    if (threadIdx.x == 0) {
      if (a.staged)
        atomicAdd(stats + 1, 2ull * a.ext[0] * a.ext[1] *
                                 pair_row_written<kAligned>(a.ext[2], par));
      else
        atomicAdd(stats, 1ull);
    }
    mine = a.interior ? blend_pairs<true>(win, vc, o, a, g, par)
                      : blend_pairs<false>(win, vc, o, a, g, par);
  }
  const int all_ok = __syncthreads_and(mine);
  if (threadIdx.x == 0 && c == 0)
    ok[b] = static_cast<unsigned char>(all_ok != 0);
}

template <typename T>
cudaError_t set_optin(int optin_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      rotated_patches_kernel<T, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, optin_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rotated_patches_kernel<T, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin_bytes);
  return e;
}

template <typename T>
int launch(const T* vol, const float* pos, const float* frames, float* out,
           unsigned char* ok, unsigned long long* stats, int B, int F, int Z,
           int X, int Y, int pz, int px, int py, int cap, int row_words,
           int plane_words, void* stream) {
  if (B < 1 || F < 1 || pz < 1 || px < 1 || py < 1 || Z < 2 || X < 2 ||
      Y < 2 || cap < 4 * kPer<T> ||
      (reinterpret_cast<uintptr_t>(vol) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the bf16 mode's pair window: even pitches keep 8-byte pairs of words
  // aligned
  if (sizeof(T) == 2 && (row_words < 2 || (row_words & 1) ||
                         plane_words < row_words || (plane_words & 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry<T> g;
  g.F = F;
  g.Z = Z;
  g.X = X;
  g.Y = Y;
  g.pz = pz;
  g.px = px;
  g.py = py;
  g.cap = cap & ~(kPer<T> - 1);          // the window stays 16-byte aligned
  g.row_words = row_words;
  g.plane_words = plane_words;
  g.end = vol + (int64_t)F * Z * X * Y;
  const size_t smem = 4 * (size_t)g.cap;   // floats, or pair words
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Y % kPer<T> == 0)
    rotated_patches_kernel<T, true><<<B * F, THREADS, smem, s>>>(
        vol, pos, frames, out, ok, stats, g);
  else
    rotated_patches_kernel<T, false><<<B * F, THREADS, smem, s>>>(
        vol, pos, frames, out, ok, stats, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Set every kernel form's dynamic shared-memory limit (both modes, both
// alignments) to the current device's per-block opt-in and report that
// opt-in. Call it once per device before the first launch, outside any CUDA
// graph capture.
extern "C" int e2t_rotated_patches_init(int* optin_bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin_bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = set_optin<float>(*optin_bytes);
  if (e == cudaSuccess) e = set_optin<__nv_bfloat16>(*optin_bytes);
  return static_cast<int>(e);
}

// Plain C entry points, loaded with ctypes.
//   vol    (F, Z, X, Y), contiguous, 16-byte aligned: float32 for
//          e2t_rotated_patches_f32, bf16 for e2t_rotated_patches_bf16
//   pos    (B, 3) float32, contiguous
//   frames (B, 3, 3) float32, contiguous: flight-frame rows per agent
//   out    (B, F, pz, px, py) float32, written
//   ok     (B,) one byte per agent (a torch.bool tensor), written 0 / 1
//   stats  two running counts, added to: items not staged, values staged
//          (bf16 mode: two a word written into the pair window)
//   cap    values of the window (a box that takes more is not staged),
//          within the opt-in set by e2t_rotated_patches_init; in the bf16
//          mode 32-bit words of the pair window, whose rows lie row_words
//          and planes plane_words apart (both even;
//          ops/extract_rot.py::pair_pitches)
// One block per (agent, channel) item.
// Each launches on `stream` and returns a CUDA error code (0 on success):
// cudaErrorInvalidValue for shapes the kernel does not take (a volume with
// an edge under 2, a volume not 16-byte aligned, odd pitches), else
// cudaGetLastError() after the launch. Nothing here synchronises or sets an
// attribute: they run inside CUDA graph captures.
extern "C" int e2t_rotated_patches_f32(const float* vol, const float* pos,
                                       const float* frames, float* out,
                                       unsigned char* ok,
                                       unsigned long long* stats, int B,
                                       int F, int Z, int X, int Y, int pz,
                                       int px, int py, int cap,
                                       void* stream) {
  return launch(vol, pos, frames, out, ok, stats, B, F, Z, X, Y, pz, px, py,
                cap, 0, 0, stream);
}

extern "C" int e2t_rotated_patches_bf16(const void* vol, const float* pos,
                                        const float* frames, float* out,
                                        unsigned char* ok,
                                        unsigned long long* stats, int B,
                                        int F, int Z, int X, int Y, int pz,
                                        int px, int py, int cap,
                                        int row_words, int plane_words,
                                        void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(vol), pos, frames, out, ok,
                stats, B, F, Z, X, Y, pz, px, py, cap, row_words, plane_words,
                stream);
}
