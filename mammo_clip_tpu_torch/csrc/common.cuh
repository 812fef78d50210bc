// Device helpers shared by the package's CUDA sources (flash_attention.cu,
// mbconv6_e6.cu, probes.cu): the PTX of Hopper's warp-level matrix product
// (mma.sync with ldmatrix operands), asynchronous copies to shared memory
// (cp.async, and bulk copies completing on mbarriers), programmatic dependent
// launch, a warp sum, and the launchers' device guard. Each source includes it once, so every
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

// Shared-memory barriers (mbarrier) and the Tensor Memory Accelerator's 1-D bulk
// copy, global to shared, whose completion counts `bytes` against the barrier's
// expected transaction bytes (src and dst 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Makes the barriers' initialisation visible to the async proxy (the bulk copies).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed. A wait that
// has not completed after 2^26 polls traps, so that a broken protocol fails the
// launch instead of holding the device.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Programmatic dependent launch: a kernel launched with the programmatic stream
// serialization attribute may start while the kernel before it on the stream
// runs, once every block of that kernel has called grid_dependents_launch (or
// exited); grid_dependency_wait then waits until that kernel has completed and
// its memory writes are visible. Without the attribute the wait returns at once.
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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
