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
// nothing beside that. The TPU kernel's DMA windows and lane rolls exist for
// the TPU's tiled VMEM and have no counterpart here.
//
// What the design does about it:
//  * one block per (agent, channel); the block computes its agent's base
//    and fractions itself from pos, so no host-built meta array exists;
//  * the agent's (pz+1)(px+1)(py+1) window is staged in shared memory once
//    (19.7 KB at patch 16^3), with consecutive threads on consecutive y, so
//    the loads of a warp are coalesced along rows; each window value then
//    feeds up to 8 outputs from shared memory;
//  * one thread per output voxel (looping when the patch exceeds the
//    block), writes consecutive along y;
//  * products and sums use __fmul_rn / __fadd_rn, so nvcc contracts nothing
//    into FMAs: the result is the plain PyTorch version's, bit for bit.
// A window over 48 KB takes the dynamic shared-memory opt-in; one over the
// card's opt-in limit (227 KB, patch edge ~37) is refused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
trilinear_patches_kernel(const float* __restrict__ vol,
                         const float* __restrict__ pos,
                         float* __restrict__ out, int F, int Z, int X, int Y,
                         int pz, int px, int py) {
  extern __shared__ float win[];
  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int p[3] = {pz, px, py};
  const int hi[3] = {Z - (pz + 1), X - (px + 1), Y - (py + 1)};
  int base[3];
  float w0[3], w1[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float corner = __fsub_rn(pos[3 * b + d], 0.5f * (float)(p[d] - 1));
    const float fl = floorf(corner);
    const float fr = __fsub_rn(corner, fl);
    base[d] = (int)fminf(fmaxf(fl, 0.f), (float)hi[d]);
    w0[d] = __fsub_rn(1.f, fr);
    w1[d] = fr;
  }

  // stage the window, y fastest
  const int sx = px + 1, sy = py + 1;
  const int n_win = (pz + 1) * sx * sy;
  const float* vc = vol + (int64_t)c * Z * X * Y;
  for (int i = threadIdx.x; i < n_win; i += THREADS) {
    const int wz = i / (sx * sy);
    const int r = i - wz * sx * sy;
    const int wx = r / sy;
    const int wy = r - wx * sy;
    win[i] = __ldg(vc + ((int64_t)(base[0] + wz) * X + base[1] + wx) * Y
                   + base[2] + wy);
  }
  __syncthreads();

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

  const int n_out = pz * px * py;
  float* o = out + ((int64_t)b * F + c) * n_out;
  for (int i = threadIdx.x; i < n_out; i += THREADS) {
    const int iz = i / (px * py);
    const int r = i - iz * px * py;
    const int ix = r / py;
    const int iy = r - ix * py;
    float acc = 0.f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
          acc = __fadd_rn(acc, __fmul_rn(
              w[(dz * 2 + dx) * 2 + dy],
              win[((iz + dz) * sx + ix + dx) * sy + iy + dy]));
    o[i] = acc;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   vol  (F, Z, X, Y) float32, contiguous
//   pos  (B, 3) float32, contiguous
//   out  (B, F, pz, px, py) float32, written
// Launches on `stream` and returns a CUDA error code (0 on success):
// cudaErrorInvalidValue for shapes the kernel does not take (a volume
// smaller than patch+1, or a window beyond the card's shared memory), else
// cudaGetLastError() after the launch.
extern "C" int e2t_trilinear_patches_f32(const float* vol, const float* pos,
                                         float* out, int B, int F, int Z,
                                         int X, int Y, int pz, int px, int py,
                                         void* stream) {
  if (B < 1 || F < 1 || pz < 1 || px < 1 || py < 1 || Z < pz + 1 ||
      X < px + 1 || Y < py + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)(pz + 1) * (px + 1) * (py + 1);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trilinear_patches_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(F));
  trilinear_patches_kernel<<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      vol, pos, out, F, Z, X, Y, pz, px, py);
  return static_cast<int>(cudaGetLastError());
}
