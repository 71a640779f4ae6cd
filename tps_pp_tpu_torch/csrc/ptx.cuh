// Hopper building blocks written as inline PTX, shared by the kernels that
// feed their tensor cores from a ring of shared-memory tiles: mbarriers,
// 16-byte asynchronous copies that arrive on them, programmatic dependent
// launch, ldmatrix / stmatrix and mma.sync (bf16 in, f32 accumulation).
// All need sm_90.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes a phase once `count` threads have arrived.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the asynchronous proxy;
// follow with __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once: completes a phase that copies no data.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A phase that never
// completes (an arrival that never comes) traps after ~2^28 tries, so that
// a fault surfaces as an error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries == (1u << 28)) __trap();
}

// Copy 16 bytes (both addresses 16-byte aligned) from global to shared
// memory asynchronously, through L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Wait until every cp.async this thread has issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Programmatic dependent launch. A kernel launched with the
// programmatic-stream-serialization attribute may start while the kernel
// before it on the stream still runs; grid_dep_wait() returns once that
// kernel has completed and its writes are visible (at once for a kernel
// launched without the attribute). grid_dep_launch() lets the next such
// kernel start early, once every block of this one has called it (or
// exited).
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Arrive on `bar` once every cp.async this thread has issued so far has
// landed; the arrival is one of the count the mbarrier was initialised
// with (.noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes, 16-byte aligned). Register i holds matrix i: lane t has
// row t / 4, columns 2 (t % 4) and 2 (t % 4) + 1 (the lower column in the
// lower half).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each matrix transposed: lane t has rows 2 (t % 4) and
// 2 (t % 4) + 1 of column t / 4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The inverse of ldsm_x4: register i (in ldsm_x4's layout) to matrix i,
// whose row l % 8 lane l addresses.
__device__ __forceinline__ void stsm_x4(void* p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
          smem_addr(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// The same, each matrix transposed: memory row i receives column i.
__device__ __forceinline__ void stsm_x4_t(void* p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};" ::"r"(smem_addr(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// d += a @ b for one 16x8x16 bf16 tile, f32 accumulation. With g = lane / 4
// and q = lane % 4: a = {(g, 2q..), (g+8, 2q..), (g, 2q+8..), (g+8, 2q+8..)},
// b = {(2q.., g), (2q+8.., g)} (k pairs, n), d = {(g, 2q), (g, 2q+1),
// (g+8, 2q), (g+8, 2q+1)}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ptx
