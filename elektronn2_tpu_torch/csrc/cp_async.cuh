// cp.async helpers for sm_90a: asynchronous copies from device memory into
// shared memory, committed in groups and waited on by group count, and the
// row stager of the patch kernels. Shared by the tensor-core GEMMs K1 and
// K4 and the probes P1 and P2 (through wgmma_tf32.cuh) and by the patch
// kernels K2 (extract.cu) and K3 (extract_rot.cu); utils/cuda_build.py puts
// the text of every included header into a library's build key.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Copies `bytes` (0 or 4) from src and zero-fills the rest of the 4-byte
// destination: bytes = 0 writes a zero without reading src.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

// Copies the first `bytes` (0 to 16) of the 16 at src and zero-fills the
// rest of the 16-byte destination; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shift, in values of T (4 floats or 8 bf16 values to 16 bytes), of a row
// start within its 16-byte group.
template <typename T>
__device__ __forceinline__ int row_shift(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / sizeof(T)) &
                          (16 / sizeof(T) - 1));
}

// Start this thread's 16-byte cp.async copies of a box of rows of values of
// T (float or a 2-byte type; kPer = 16 / sizeof(T) values to a piece) into
// shared memory. Row (z, x), for z < nz and x < nx, starts at src0 + z*zs +
// x*xs in device memory; it is copied in `chunks` aligned 16-byte pieces
// from the 16-byte group that holds its start, so it lands at dst + z*dz +
// x*dx + row_shift(row start), and `chunks` = (ny + 2*kPer - 2) / kPer
// covers ny values from any shift. dst, dz and dx must keep 16-byte
// alignment, src0's storage must start 16-byte aligned, and bytes at or past
// src_end are zero-filled, never read. The thread takes the pieces tid,
// tid + nthreads, ... in (z, x, chunk) order, stepping its digits with one
// carry at most each: no division per piece.
template <typename T>
__device__ __forceinline__ void stage_rows16(
    T* dst, int dz, int dx, const T* src0, int64_t zs, int64_t xs, int nz,
    int nx, int chunks, const T* src_end, int tid, int nthreads) {
  constexpr int kPer = 16 / sizeof(T);
  const int per_z = nx * chunks;
  int z = tid / per_z;
  int r = tid - z * per_z;
  int x = r / chunks;
  int c = r - x * chunks;
  const int st_z = nthreads / per_z;
  r = nthreads - st_z * per_z;
  const int st_x = r / chunks;
  const int st_c = r - st_x * chunks;
  while (z < nz) {
    const T* row = src0 + z * zs + x * xs;
    const T* a = reinterpret_cast<const T*>(
        reinterpret_cast<uintptr_t>(row) & ~static_cast<uintptr_t>(15)) +
        kPer * c;
    const int64_t left = src_end - a;                // values before the end
    const int bytes = left >= kPer ? 16
                      : (left > 0 ? static_cast<int>(sizeof(T)) * (int)left
                                  : 0);
    cp_async16_zfill(reinterpret_cast<float*>(dst + z * dz + x * dx +
                                              kPer * c),
                     reinterpret_cast<const float*>(a), bytes);
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

}  // namespace
