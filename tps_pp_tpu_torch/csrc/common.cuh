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

#include <mutex>

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

// The bilinear taps of a border-padded, align_corners=True sampler at the
// grid point (px, py) (the [-1, 1] convention) over an H x W map, as the
// JAX package's _gather_impl takes them: unnormalize, clamp to the map,
// floor; the far taps clamp back onto the last column / row. Offsets are
// pixel indices y * W + x; the weights stay f32.
struct BilinearTaps {
  int o00, o01, o10, o11;        // (y0,x0) (y0,x1) (y1,x0) (y1,x1)
  float wx, wy;                  // fractional parts
  float w00, w01, w10, w11;      // (1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx wy
};

static __device__ __forceinline__ BilinearTaps bilinear_taps(float px,
                                                             float py, int H,
                                                             int W) {
  float gx = (px + 1.f) * 0.5f * (float)(W - 1);
  float gy = (py + 1.f) * 0.5f * (float)(H - 1);
  gx = fminf(fmaxf(gx, 0.f), (float)(W - 1));
  gy = fminf(fmaxf(gy, 0.f), (float)(H - 1));
  const float x0f = floorf(gx), y0f = floorf(gy);
  BilinearTaps t;
  t.wx = gx - x0f;
  t.wy = gy - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  t.o00 = y0 * W + x0;
  t.o01 = y0 * W + x1;
  t.o10 = y1 * W + x0;
  t.o11 = y1 * W + x1;
  t.w00 = (1.f - t.wx) * (1.f - t.wy);
  t.w01 = t.wx * (1.f - t.wy);
  t.w10 = (1.f - t.wx) * t.wy;
  t.w11 = t.wx * t.wy;
  return t;
}

// Two neighbouring channels (c2 counts pairs) as f32, and back.
static __device__ __forceinline__ float2 load2(const bf16* p, int c2) {
  return __bfloat1622float2(reinterpret_cast<const bf162*>(p)[c2]);
}
static __device__ __forceinline__ float2 load2(const float* p, int c2) {
  return reinterpret_cast<const float2*>(p)[c2];
}
static __device__ __forceinline__ float2 load2(const signed char* p,
                                               int c2) {
  const char2 v = reinterpret_cast<const char2*>(p)[c2];
  return make_float2((float)v.x, (float)v.y);
}
static __device__ __forceinline__ void store2(bf16* p, int c2, float a,
                                              float b) {
  reinterpret_cast<bf162*>(p)[c2] = __floats2bfloat162_rn(a, b);
}
static __device__ __forceinline__ void store2(float* p, int c2, float a,
                                              float b) {
  reinterpret_cast<float2*>(p)[c2] = make_float2(a, b);
}

// One channel as f32, and back (the odd-channel paths of the warp).
static __device__ __forceinline__ float load1(const bf16* p, int c) {
  return __bfloat162float(p[c]);
}
static __device__ __forceinline__ float load1(const float* p, int c) {
  return p[c];
}
static __device__ __forceinline__ void store1(bf16* p, int c, float v) {
  p[c] = __float2bfloat16(v);
}
static __device__ __forceinline__ void store1(float* p, int c, float v) {
  p[c] = v;
}

// One warp samples one pixel: each lane takes channel pairs c2 = lane,
// lane + 32, ... of the four taps of `img` (pixel rows of C channels) and
// writes their weighted sum to `out`, rounded once.
template <typename T>
static __device__ __forceinline__ void warp_sample_pixel(
    const T* __restrict__ img, const BilinearTaps& t, T* __restrict__ out,
    int C, int lane) {
  const T* r00 = img + (size_t)t.o00 * C;
  const T* r01 = img + (size_t)t.o01 * C;
  const T* r10 = img + (size_t)t.o10 * C;
  const T* r11 = img + (size_t)t.o11 * C;
  for (int c2 = lane; c2 < (C >> 1); c2 += 32) {
    const float2 a = load2(r00, c2), b = load2(r01, c2);
    const float2 c = load2(r10, c2), d = load2(r11, c2);
    store2(out, c2, t.w00 * a.x + t.w01 * b.x + t.w10 * c.x + t.w11 * d.x,
           t.w00 * a.y + t.w01 * b.y + t.w10 * c.y + t.w11 * d.y);
  }
}
