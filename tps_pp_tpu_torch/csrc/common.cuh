// Shared helpers of the port's CUDA kernels (built for sm_90a, bound to
// Python with ctypes through a plain C interface; see ops/_lib.py).
//
// Every extern "C" entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() as an int (0 = success) so that the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

#define TPK_CHECK()                                   \
  do {                                                \
    cudaError_t tpk_err_ = cudaGetLastError();        \
    if (tpk_err_ != cudaSuccess) return (int)tpk_err_; \
  } while (0)

#define TPK_TRY(call)              \
  do {                             \
    int tpk_rc_ = (call);          \
    if (tpk_rc_ != 0) return tpk_rc_; \
  } while (0)

static __device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

static __device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; every thread gets the result. `red` holds >= 32
// floats of shared memory. Safe to call repeatedly with the same buffer.
static __device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = (lane < nwarps) ? red[lane] : 0.f;
  return warp_sum(t);
}

static __device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = (lane < nwarps) ? red[lane] : -INFINITY;
  return warp_max(t);
}

// Host launchers defined in encoder.cu and reused by full_decode.cu.
// C[M,N] = epilogue(A[M,K] @ B[K,N]): bf16 operands, f32 accumulation;
// epilogue = (+bias[N]) -> (erf-GELU) -> (residual[M,N] +) -> f32 or bf16.
// `residual` may alias C (in-place residual add). Needs K % 32 == 0,
// N % 64 == 0, lda/ldb % 8 == 0 and 16-byte aligned A/B.
int tpk_launch_gemm(const bf16* A, int lda, const bf16* B, int ldb, void* C,
                    int ldc, int M, int N, int K, const float* bias,
                    const float* residual, int ldr, int gelu, int out_bf16,
                    cudaStream_t stream);
// Row LayerNorm of f32 rows: (x - mean) * rsqrt(var + eps), then the affine
// when scale/bias are given; output f32 or bf16.
int tpk_launch_layernorm(const float* x, int ldx, void* y, int ldy, int M,
                         int D, float eps, const float* scale,
                         const float* bias, int out_bf16,
                         cudaStream_t stream);
