// Hopper building blocks written as inline PTX, shared by the kernels that
// feed their tensor cores from a ring of shared-memory tiles: mbarriers,
// 16-byte asynchronous copies and TMA tile loads that arrive on them,
// programmatic dependent launch, ldmatrix / stmatrix, mma.sync and the
// warpgroup products (wgmma; bf16 in, f32 accumulation), register
// reallocation between warpgroups and named barriers. All need sm_90; wgmma
// and setmaxnreg need sm_90a.
#pragma once

#include <cuda.h>
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

// Close the group of this thread's cp.asyncs issued since the last one;
// wait until at most N of its groups are pending.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

// ---- TMA ----------------------------------------------------------------
// Arrive once and expect `bytes` more of asynchronous copies: the phase
// completes when they have landed.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Copy the box of the 2-D tensor map `map` at (c0 along the contiguous
// dimension, c1 along the other) into shared memory at `dst` (1024-byte
// aligned for a 128-byte swizzle), completing its bytes on `bar`. Elements
// outside the tensor land as zeros. `map` is a __grid_constant__ parameter.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// ---- warpgroups ----------------------------------------------------------
// Registers a thread of this warpgroup may hold from here on (all four
// warps execute it): fewer for a warpgroup that only issues copies, more
// for one that holds a product's accumulator.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads, whole warps.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma ---------------------------------------------------------------
// The shared-memory descriptor of an operand tile in the 128-byte swizzle
// that TMA writes (SWIZZLE_128B; the tile 1024-byte aligned): its address,
// the leading byte offset `lbo` and the stride byte offset `sbo`. A K-major
// tile (rows of 64 bf16 = 128 bytes along K): sbo = 1024 (the next 8 rows),
// lbo unused; the k-th 16-deep slice starts 32 k bytes on. An MN-major tile
// stored as 64-wide column chunks of `rows` K rows each: sbo = 1024 (the
// next 8 K rows), lbo = the chunk stride (128 bytes times its K rows); the
// k-th 16-deep slice starts 2048 k bytes on.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// Orders this warpgroup's register and shared-memory accesses before the
// wgmmas that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a @ b for a 64 x 256 tile of one warpgroup, bf16 operands from
// shared memory (a: 64 x 16 K-major, descriptor da; b: 16 x 256 MN-major,
// descriptor db), f32 accumulation in registers. Thread t of the
// warpgroup holds rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns
// c = 8 j + 2 (t % 4) and the next: d[4 j] (r, c), d[4 j + 1] (r, c + 1),
// d[4 j + 2] (r + 8, c), d[4 j + 3] (r + 8, c + 1).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                              uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace ptx
