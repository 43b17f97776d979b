// K3 for Hopper: frame-aligned (rotated) trilinear patch extraction plus
// the out-of-bounds flag, the patch cut of every step of the rotated
// tracing rollout (DeviceTracer(rotate_to_heading=True)).
//
// Replaces the Pallas TPU kernel elektronn2_tpu/ops/pallas_extract_rot.py::
// rotated_patches_pallas (float32 mode). Semantics are those of the XLA
// oracle DeviceTracer._extract_rot_batch (elektronn2_tpu/data/
// tracing_utils.py): for sample i of agent b with frame rows F (3x3),
//   coord = pos + F^T (i - (p-1)/2),
//   c0 = floor(coord), frac = coord - c0 (taken BEFORE the clip),
//   c0 clipped to [0, dims-2], the 8-corner sum ((wz*wx)*wy) * vol[...]
//   in the order dz, dx, dy, and
//   ok[b] = all samples have 0 <= coord <= dims-2.
//
// What bounds it on this card: the scattered corner loads. A rotated patch
// box does not map to a window along y, so each sample reads 8 corners that
// no neighbouring thread shares along a row; at B = 512 agents, patch 16^3,
// that is 16.8 M corner loads (67 MB through L1/L2) per call against 8 MB
// written. The agent's samples all fall in a 30^3 rotation-invariant window
// (108 KB per channel), which stays in L1/L2 while the block works on it.
// The TPU kernel's hat-weight matrix contraction on the MXU exists only
// because the TPU has no fast gather and is not carried over.
//
// What the design does about it:
//  * one block per agent, one thread per output sample (looping over the
//    patch); the sample's coordinates, corners and weights are computed
//    once and serve every channel;
//  * the 8 corner loads go through the read-only path (__ldg), and the
//    neighbouring samples of a warp hit the same cache lines;
//  * coordinates are computed in the oracle's order, t = F0i*o0 + F1i*o1,
//    t = t + F2i*o2, coord = pos_i + t, with __fmul_rn / __fadd_rn so nvcc
//    contracts nothing into FMAs: patches and ok equal the plain PyTorch
//    version bit for bit;
//  * ok is the all-samples criterion on those same coordinates, reduced
//    over the block with __syncthreads_and (the TPU kernel used the
//    equivalent 8-box-corner test, rotated_ok).
// Staging the window in shared memory is later work; nothing is staged, so
// no unread window tail can poison a weighted sum (the 0*NaN trap).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rotated_patches_kernel(const float* __restrict__ vol,
                       const float* __restrict__ pos,
                       const float* __restrict__ frames,
                       float* __restrict__ out, unsigned char* __restrict__ ok,
                       int F, int Z, int X, int Y, int pz, int px, int py) {
  const int b = blockIdx.x;
  float fr[9];  // frame rows: fr[3*j + i] = F[j][i]
#pragma unroll
  for (int k = 0; k < 9; ++k) fr[k] = __ldg(frames + 9 * b + k);
  float p0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) p0[d] = __ldg(pos + 3 * b + d);
  const int dims[3] = {Z, X, Y};
  const float half[3] = {0.5f * (float)(pz - 1), 0.5f * (float)(px - 1),
                         0.5f * (float)(py - 1)};
  const int n_out = pz * px * py;
  const int64_t plane = (int64_t)X * Y;
  const int64_t chan = (int64_t)Z * plane;
  int all_ok = 1;

  for (int i = threadIdx.x; i < n_out; i += THREADS) {
    const int iz = i / (px * py);
    const int r = i - iz * px * py;
    const int ix = r / py;
    const int iy = r - ix * py;
    const float o[3] = {__fsub_rn((float)iz, half[0]),
                        __fsub_rn((float)ix, half[1]),
                        __fsub_rn((float)iy, half[2])};
    int c0[3];
    float w0[3], w1[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float t = __fadd_rn(__fmul_rn(fr[d], o[0]), __fmul_rn(fr[3 + d], o[1]));
      t = __fadd_rn(t, __fmul_rn(fr[6 + d], o[2]));
      const float c = __fadd_rn(p0[d], t);
      const float hi = (float)(dims[d] - 2);
      all_ok &= (c >= 0.f) & (c <= hi);
      const float fl = floorf(c);
      const float f1 = __fsub_rn(c, fl);
      c0[d] = (int)fminf(fmaxf(fl, 0.f), hi);
      w0[d] = __fsub_rn(1.f, f1);
      w1[d] = f1;
    }
    const int64_t base = c0[0] * plane + (int64_t)c0[1] * Y + c0[2];
    for (int ch = 0; ch < F; ++ch) {
      const float* v = vol + ch * chan + base;
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
            acc = __fadd_rn(acc, __fmul_rn(
                w, __ldg(v + dz * plane + (int64_t)dx * Y + dy)));
          }
      out[((int64_t)b * F + ch) * n_out + i] = acc;
    }
  }
  all_ok = __syncthreads_and(all_ok);
  if (threadIdx.x == 0) ok[b] = static_cast<unsigned char>(all_ok != 0);
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   vol    (F, Z, X, Y) float32, contiguous
//   pos    (B, 3) float32, contiguous
//   frames (B, 3, 3) float32, contiguous: flight-frame rows per agent
//   out    (B, F, pz, px, py) float32, written
//   ok     (B,) one byte per agent (a torch.bool tensor), written 0 / 1
// Launches on `stream` and returns a CUDA error code (0 on success):
// cudaErrorInvalidValue for shapes the kernel does not take (a volume with
// an edge under 2), else cudaGetLastError() after the launch.
extern "C" int e2t_rotated_patches_f32(const float* vol, const float* pos,
                                       const float* frames, float* out,
                                       unsigned char* ok, int B, int F, int Z,
                                       int X, int Y, int pz, int px, int py,
                                       void* stream) {
  if (B < 1 || F < 1 || pz < 1 || px < 1 || py < 1 || Z < 2 || X < 2 ||
      Y < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  rotated_patches_kernel<<<static_cast<unsigned>(B), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      vol, pos, frames, out, ok, F, Z, X, Y, pz, px, py);
  return static_cast<int>(cudaGetLastError());
}
