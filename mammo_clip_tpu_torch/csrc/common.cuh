// Device helpers shared by the package's CUDA sources (flash_attention.cu,
// mbconv6_e6.cu, probes.cu): the PTX of Hopper's warp-level matrix product
// (mma.sync with ldmatrix operands), asynchronous copies to shared memory, a warp
// sum, and the launchers' device guard. Each source includes it once, so every
// translation unit keeps its own copy (anonymous namespace). The build hashes
// and recompiles on a change of any csrc/*.cuh as of any csrc/*.cu
// (ops/cuda_lib.py).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Asynchronous copies to shared memory; a source size of 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits for all but the newest committed group.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and gets row l / 4, columns 2 (l % 4), +1 of each (of
// its transpose with .trans).
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b for one m16n8k16 tile: a 16 x 16 bf16 (row-major), b 16 x 8 bf16
// (column-major), d 16 x 8 fp32. Lane l = 4 g + t holds a rows g and g + 8 at
// columns 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]), b rows 2t,
// 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g, and d rows g and g + 8,
// columns 2t and 2t + 1.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Makes `device` current for the launcher's life when it is not already (the
// kernels run on the device of their tensors), and restores the caller's device.
struct DeviceGuard {
  int prev = -1, want;
  int err;
  explicit DeviceGuard(int device) : want(device) {
    err = (int)cudaGetDevice(&prev);
    if (!err && prev != want) err = (int)cudaSetDevice(want);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != want) cudaSetDevice(prev);
  }
};

}  // namespace
