// K2 for Hopper: batched trilinear patch extraction at float positions
// (translation only), the patch cut of every step of the tracing rollout.
//
// Replaces the Pallas TPU kernel elektronn2_tpu/ops/pallas_extract.py::
// trilinear_patches_pallas. Semantics are those of DeviceTracer._extract
// (elektronn2_tpu/data/tracing_utils.py): per agent,
//   corner = pos - (p-1)/2, base = floor(corner), frac = corner - base
//   (taken BEFORE the clip), base clipped to [0, dim-(p+1)],
//   out[i] = sum over the 8 corners (dz, dx, dy) of
//            ((wz*wx)*wy) * vol[base + i + (dz, dx, dy)],
// summed in that order (dz, then dx, then dy) from 0.
//
// What bounds it on this card: memory traffic. At the tracer's shape
// (B = 1024 agents, one channel, patch 16^3, a 256^3 volume) one call reads
// each agent's 17^3 window (~20 MB in all) and writes 16^3 outputs per
// agent (~17 MB), about 11 us at 3.35 TB/s; the 8 products per output are
// little beside that, as long as the loads and the blend overlap and the
// instructions around them stay few.
//
// What the design does about it (the TPU kernel's idea, window copies in
// flight while other windows are blended, not its blocks):
//  * a block stages one (agent, channel) item's window with cp.async,
//    waits and blends it; four blocks share an SM, so one block's copy
//    overlaps the others' blends. A ring of 2 or 3 slots per block, copying
//    the next window while blending this one, measured 5-12% slower on an
//    H100 at four blocks an SM, and 15-40% slower at one or two blocks an
//    SM with 4 to 8 slots; blocks that walk over several items were no
//    faster than one block per item (PERF.md);
//  * the window's rows are copied with 16-byte cp.async from the 16-byte
//    group that holds each row's start (stage_rows16 in cp_async.cuh): any
//    Y, 5 pieces per 17-float row instead of 17 single floats. A row lands
//    in shared memory at its offset within 16 bytes in device memory, which
//    steps by Y mod 4 from row to row (0 when Y % 4 == 0);
//  * the blend gives each thread a (z, y) column of the patch and slides it
//    along x: the 2x2 (z, y) window values of the current x stay in
//    registers, so each output reads 4 values from shared memory, not 8;
//    consecutive threads take consecutive y, so loads hit consecutive banks
//    (window planes are padded to 16 banks mod 32) and stores coalesce;
//  * products and sums use __fmul_rn / __fadd_rn, so nvcc contracts nothing
//    into FMAs: the result is the plain PyTorch version's, bit for bit.
// A window is (p+1)^3 floats in rows of 16-byte pieces (25 KB at 16^3). The
// kernel's dynamic shared-memory limit is lifted to the card's per-block
// opt-in once, by e2t_trilinear_patches_init, outside any CUDA graph
// capture; a window over the opt-in (a cubic patch's edge 37 and up) is
// refused.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int THREADS = 256;

struct Geometry {
  int F, Z, X, Y;      // volume (F, Z, X, Y)
  int pz, px, py;      // patch
  int sx, sz;          // window edges along z and x (p + 1)
  int rp;              // floats per staged window row (py + 1 floats)
  int pitch;           // floats between window z-planes in shared memory
  int window;          // floats of a staged window
  const float* end;    // the end of the volume, never read
};

// The window origin and the per-axis weights of agent b.
__device__ __forceinline__ void agent_window(const float* __restrict__ pos,
                                             int b, const Geometry& g,
                                             int base[3], float w0[3],
                                             float w1[3]) {
  const int p[3] = {g.pz, g.px, g.py};
  const int hi[3] = {g.Z - (g.pz + 1), g.X - (g.px + 1), g.Y - (g.py + 1)};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float corner = __fsub_rn(__ldg(pos + 3 * b + d),
                                   0.5f * (float)(p[d] - 1));
    const float fl = floorf(corner);
    const float fr = __fsub_rn(corner, fl);
    base[d] = (int)fminf(fmaxf(fl, 0.f), (float)hi[d]);
    w0[d] = __fsub_rn(1.f, fr);
    w1[d] = fr;
  }
}

// The device address of the first voxel of item (b, c)'s window.
__device__ __forceinline__ const float* window_origin(
    const float* vol, const int base[3], int c, const Geometry& g) {
  return vol + (((int64_t)c * g.Z + base[0]) * g.X + base[1]) * g.Y
         + base[2];
}

// Start this thread's cp.async copies of item (b, c)'s window into `win`.
__device__ __forceinline__ void stage_window(float* win,
                                             const float* __restrict__ vol,
                                             const float* __restrict__ pos,
                                             int b, int c,
                                             const Geometry& g) {
  int base[3];
  float w0[3], w1[3];
  agent_window(pos, b, g, base, w0, w1);
  stage_rows16(win, g.pitch, g.rp, window_origin(vol, base, c, g),
               (int64_t)g.X * g.Y, g.Y, g.sz, g.sx, g.rp / 4, g.end,
               threadIdx.x, THREADS);
}

// Blend item (b, c) from its staged window: each thread slides (z, y)
// columns of the patch along x. kAligned: Y % 4 == 0, so every staged row
// has the first row's offset within 16 bytes.
template <bool kAligned>
__device__ __forceinline__ void blend_window(const float* win,
                                             const float* __restrict__ vol,
                                             const float* __restrict__ pos,
                                             float* __restrict__ out, int b,
                                             int c, const Geometry& g) {
  int base[3];
  float w0[3], w1[3];
  agent_window(pos, b, g, base, w0, w1);
  float w[8];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
        w[(dz * 2 + dx) * 2 + dy] =
            __fmul_rn(__fmul_rn(dz ? w1[0] : w0[0], dx ? w1[1] : w0[1]),
                      dy ? w1[2] : w0[2]);
  // staged row (z, x) holds its voxels from offset (s0 + z*mz + x*mx) mod 4
  const int s0 = row_shift(window_origin(vol, base, c, g));
  const int mz = kAligned ? 0 : (int)(((int64_t)g.X * g.Y) & 3);
  const int mx = kAligned ? 0 : g.Y & 3;
  const int n_col = g.pz * g.py;
  float* o = out + ((int64_t)b * g.F + c) * (g.pz * g.px * g.py);
  for (int col = threadIdx.x; col < n_col; col += THREADS) {
    const int iz = col / g.py;            // once per column of px outputs
    const int iy = col - iz * g.py;
    const float* r0 = win + iz * g.pitch + iy;
    const float* r1 = r0 + g.pitch;
    int h0 = (s0 + iz * mz) & 3;
    int h1 = (h0 + mz) & 3;
    float a00 = r0[h0], a01 = r0[h0 + 1], a10 = r1[h1], a11 = r1[h1 + 1];
    float* oc = o + iz * g.px * g.py + iy;
    for (int ix = 0; ix < g.px; ++ix) {
      r0 += g.rp;
      r1 += g.rp;
      h0 = (h0 + mx) & 3;
      h1 = (h1 + mx) & 3;
      const float b00 = r0[h0], b01 = r0[h0 + 1], b10 = r1[h1],
                  b11 = r1[h1 + 1];
      float acc = 0.f;
      acc = __fadd_rn(acc, __fmul_rn(w[0], a00));   // dz 0, dx 0
      acc = __fadd_rn(acc, __fmul_rn(w[1], a01));
      acc = __fadd_rn(acc, __fmul_rn(w[2], b00));   // dz 0, dx 1
      acc = __fadd_rn(acc, __fmul_rn(w[3], b01));
      acc = __fadd_rn(acc, __fmul_rn(w[4], a10));   // dz 1, dx 0
      acc = __fadd_rn(acc, __fmul_rn(w[5], a11));
      acc = __fadd_rn(acc, __fmul_rn(w[6], b10));   // dz 1, dx 1
      acc = __fadd_rn(acc, __fmul_rn(w[7], b11));
      oc[ix * g.py] = acc;
      a00 = b00;
      a01 = b01;
      a10 = b10;
      a11 = b11;
    }
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(THREADS)
trilinear_patches_kernel(const float* __restrict__ vol,
                         const float* __restrict__ pos,
                         float* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(16) float win[];
  const int b = blockIdx.x / g.F;
  const int c = blockIdx.x - b * g.F;
  stage_window(win, vol, pos, b, c, g);
  cp_async_commit();
  cp_async_wait<0>();                // this thread's copies landed
  __syncthreads();                   // ... and every other thread's
  blend_window<kAligned>(win, vol, pos, out, b, c, g);
}

Geometry make_geometry(const float* vol, int F, int Z, int X, int Y, int pz,
                       int px, int py) {
  Geometry g;
  g.F = F;
  g.Z = Z;
  g.X = X;
  g.Y = Y;
  g.pz = pz;
  g.px = px;
  g.py = py;
  g.sz = pz + 1;
  g.sx = px + 1;
  g.rp = 4 * ((py + 1 + 6) / 4);          // pieces for py + 1 floats
  const int plane = g.sx * g.rp;
  g.pitch = plane + (48 - plane % 32) % 32;   // pitch % 32 == 16
  g.window = g.sz * g.pitch;
  g.end = vol ? vol + (int64_t)F * Z * X * Y : nullptr;
  return g;
}

}  // namespace

// Set both kernel forms' dynamic shared-memory limit to the current
// device's per-block opt-in and report that opt-in. Call it once per device
// before the first launch, outside any CUDA graph capture.
extern "C" int e2t_trilinear_patches_init(int* optin_bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin_bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(trilinear_patches_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *optin_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(trilinear_patches_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *optin_bytes);
  return static_cast<int>(e);
}

// Bytes of shared memory the kernel's window takes for this patch.
extern "C" int e2t_trilinear_patches_window_bytes(int pz, int px, int py) {
  return static_cast<int>(sizeof(float))
         * make_geometry(nullptr, 1, 1, 1, 1, pz, px, py).window;
}

// Plain C entry point, loaded with ctypes.
//   vol  (F, Z, X, Y) float32, contiguous, 16-byte aligned
//   pos  (B, 3) float32, contiguous
//   out  (B, F, pz, px, py) float32, written
// One block per (agent, channel) item; the window must fit the opt-in set
// by e2t_trilinear_patches_init.
// Launches on `stream` and returns a CUDA error code (0 on success):
// cudaErrorInvalidValue for shapes the kernel does not take (a volume
// smaller than patch+1 or not 16-byte aligned), else
// cudaGetLastError() after the launch. Nothing here synchronises or sets an
// attribute: it runs inside CUDA graph captures.
extern "C" int e2t_trilinear_patches_f32(const float* vol, const float* pos,
                                         float* out, int B, int F, int Z,
                                         int X, int Y, int pz, int px, int py,
                                         void* stream) {
  if (B < 1 || F < 1 || pz < 1 || px < 1 || py < 1 || Z < pz + 1 ||
      X < px + 1 || Y < py + 1 ||
      (reinterpret_cast<uintptr_t>(vol) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(vol, F, Z, X, Y, pz, px, py);
  const size_t smem = sizeof(float) * (size_t)g.window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Y % 4 == 0)
    trilinear_patches_kernel<true><<<B * F, THREADS, smem, s>>>(vol, pos,
                                                                out, g);
  else
    trilinear_patches_kernel<false><<<B * F, THREADS, smem, s>>>(vol, pos,
                                                                 out, g);
  return static_cast<int>(cudaGetLastError());
}
