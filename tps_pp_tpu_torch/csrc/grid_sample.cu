// Bilinear grid_sample of the training warp (border padding,
// align_corners=True, NHWC) and its gradient: three kernels.
//
//   kernel 8, forward    replaces tps_pp_tpu/ops/pallas_grid_sample.py
//                        `_fwd_kernel` (grid_sample_pallas)
//   kernel 9, full VJP   replaces `_bwd_fused_kernel` (grid_sample_grad):
//                        d_img and d_grid
//   kernel 10, d_img     replaces `_bwd_kernel` (grid_sample_grad_img)
//
// The TPU builds the dense (TILE x H*W) interpolation matrix from an iota
// and runs every direction as an MXU product (d_img as W2^T @ cot, d_grid
// through Q = cot @ img^T), because gathers and scatters are slow there.
// On Hopper that matrix is ~1,000x the work of the 4 taps it encodes, so
// the kernels gather and scatter instead: one warp per output pixel, its
// lanes over channel pairs (one tap of a 64-channel bf16 row is one
// 128-byte access); the taps and weights come from common.cuh, shared with
// the serving sampler.
//
// Gradient conventions (those of the Pallas backward, which are autodiff
// of the floor-based lerp):
//   d out/d gx = (1-wy)(v01 - v00) + wy (v11 - v10), with v01 = v00 at the
//     last column (the clamped far tap), so 0 there; at a pixel centre the
//     far tap is x0+1;
//   the border clip passes the gradient where 0 <= g <= size-1, ties
//     included, and d_grid = d gx * (W-1)/2 (align_corners=True).
// d_img: each lane adds w_ij * cot into a zeroed f32 (N, H, W, C) buffer
// with f32 atomicAdd (the order of the atomics varies, so d_img varies in
// its last bits from run to run).
//
// Bound on the H100: memory and atomics. At the flagship's training shape
// (N=256, 16x64 samples of a 32x128x64 map) the forward reads 4 taps of
// 128 B per sample (mostly L2 hits: one bf16 map is 512 KB) and writes
// 32 MB; the backward reads the cotangent and the taps and issues 67 M f32
// atomics into a 268 MB buffer.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerBlock = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_kernel(const T* __restrict__ img,      // (N, H, W, C)
                       const float* __restrict__ grid,  // (N, npix, 2)
                       T* __restrict__ out,             // (N, npix, C)
                       int H, int W, int C, int npix) {
  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p_end = min((int)(blockIdx.x + 1) * kPixPerBlock, npix);
  const T* im = img + (size_t)n * H * W * C;
  for (int p = blockIdx.x * kPixPerBlock + warp; p < p_end; p += kWarps) {
    const size_t np = (size_t)n * npix + p;
    const float2 g = reinterpret_cast<const float2*>(grid)[np];
    warp_sample_pixel(im, bilinear_taps(g.x, g.y, H, W), out + np * C, C,
                      lane);
  }
}

// kWithGrid: kernel 9 (d_img and d_grid); else kernel 10 (d_img only, img
// unread).
template <typename T, bool kWithGrid>
__global__ void __launch_bounds__(kThreads)
grid_sample_bwd_kernel(const float* __restrict__ grid,  // (N, npix, 2)
                       const T* __restrict__ cot,       // (N, npix, C)
                       const T* __restrict__ img,       // (N, H, W, C)
                       float* __restrict__ d_img,       // (N, H, W, C), zeroed
                       float* __restrict__ d_grid,      // (N, npix, 2)
                       int H, int W, int C, int npix) {
  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p_end = min((int)(blockIdx.x + 1) * kPixPerBlock, npix);
  const size_t img_off = (size_t)n * H * W * C;
  float* di = d_img + img_off;
  for (int p = blockIdx.x * kPixPerBlock + warp; p < p_end; p += kWarps) {
    const size_t np = (size_t)n * npix + p;
    const float2 g = reinterpret_cast<const float2*>(grid)[np];
    const BilinearTaps t = bilinear_taps(g.x, g.y, H, W);
    const T* co = cot + np * C;
    float* d00 = di + (size_t)t.o00 * C;
    float* d01 = di + (size_t)t.o01 * C;
    float* d10 = di + (size_t)t.o10 * C;
    float* d11 = di + (size_t)t.o11 * C;
    float sx = 0.f, sy = 0.f;
    for (int c2 = lane; c2 < (C >> 1); c2 += 32) {
      const float2 c = load2(co, c2);
      const int c0 = 2 * c2;
      atomicAdd(d00 + c0, t.w00 * c.x);
      atomicAdd(d00 + c0 + 1, t.w00 * c.y);
      atomicAdd(d01 + c0, t.w01 * c.x);
      atomicAdd(d01 + c0 + 1, t.w01 * c.y);
      atomicAdd(d10 + c0, t.w10 * c.x);
      atomicAdd(d10 + c0 + 1, t.w10 * c.y);
      atomicAdd(d11 + c0, t.w11 * c.x);
      atomicAdd(d11 + c0 + 1, t.w11 * c.y);
      if constexpr (kWithGrid) {
        const T* im = img + img_off;
        const float2 a = load2(im + (size_t)t.o00 * C, c2);
        const float2 b = load2(im + (size_t)t.o01 * C, c2);
        const float2 e = load2(im + (size_t)t.o10 * C, c2);
        const float2 d = load2(im + (size_t)t.o11 * C, c2);
        sx += c.x * ((1.f - t.wy) * (b.x - a.x) + t.wy * (d.x - e.x)) +
              c.y * ((1.f - t.wy) * (b.y - a.y) + t.wy * (d.y - e.y));
        sy += c.x * ((1.f - t.wx) * (e.x - a.x) + t.wx * (d.x - b.x)) +
              c.y * ((1.f - t.wx) * (e.y - a.y) + t.wx * (d.y - b.y));
      }
    }
    if constexpr (kWithGrid) {
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      if (lane == 0) {
        const float gx = (g.x + 1.f) * 0.5f * (float)(W - 1);
        const float gy = (g.y + 1.f) * 0.5f * (float)(H - 1);
        const bool in_x = gx >= 0.f && gx <= (float)(W - 1);
        const bool in_y = gy >= 0.f && gy <= (float)(H - 1);
        reinterpret_cast<float2*>(d_grid)[np] =
            make_float2(in_x ? sx * (0.5f * (float)(W - 1)) : 0.f,
                        in_y ? sy * (0.5f * (float)(H - 1)) : 0.f);
      }
    }
  }
}

dim3 blocks(int N, int npix) {
  return dim3((npix + kPixPerBlock - 1) / kPixPerBlock, N);
}

}  // namespace

// is_bf16 selects the element type of img / cot / out: 1 = bf16, 0 = f32.
extern "C" int tpk_grid_sample_fwd(const void* img, const float* grid,
                                   void* out, int N, int H, int W, int C,
                                   int npix, int is_bf16, void* stream) {
  if (C & 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    grid_sample_fwd_kernel<bf16><<<blocks(N, npix), kThreads, 0, s>>>(
        (const bf16*)img, grid, (bf16*)out, H, W, C, npix);
  else
    grid_sample_fwd_kernel<float><<<blocks(N, npix), kThreads, 0, s>>>(
        (const float*)img, grid, (float*)out, H, W, C, npix);
  TPK_CHECK();
  return 0;
}

extern "C" int tpk_grid_sample_grad(const float* grid, const void* cot,
                                    const void* img, float* d_img,
                                    float* d_grid, int N, int H, int W, int C,
                                    int npix, int is_bf16, void* stream) {
  if (C & 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    grid_sample_bwd_kernel<bf16, true><<<blocks(N, npix), kThreads, 0, s>>>(
        grid, (const bf16*)cot, (const bf16*)img, d_img, d_grid, H, W, C,
        npix);
  else
    grid_sample_bwd_kernel<float, true><<<blocks(N, npix), kThreads, 0, s>>>(
        grid, (const float*)cot, (const float*)img, d_img, d_grid, H, W, C,
        npix);
  TPK_CHECK();
  return 0;
}

extern "C" int tpk_grid_sample_grad_img(const float* grid, const void* cot,
                                        float* d_img, int N, int H, int W,
                                        int C, int npix, int is_bf16,
                                        void* stream) {
  if (C & 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    grid_sample_bwd_kernel<bf16, false><<<blocks(N, npix), kThreads, 0, s>>>(
        grid, (const bf16*)cot, nullptr, d_img, nullptr, H, W, C, npix);
  else
    grid_sample_bwd_kernel<float, false>
        <<<blocks(N, npix), kThreads, 0, s>>>(grid, (const float*)cot,
                                              nullptr, d_img, nullptr, H, W,
                                              C, npix);
  TPK_CHECK();
  return 0;
}
