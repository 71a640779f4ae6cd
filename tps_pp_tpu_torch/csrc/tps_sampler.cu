// TPS++ rectification: grid generation + bilinear warp in one kernel.
//
// Replaces the TPU kernel tps_pp_tpu/ops/pallas_tps.py `_kernel` (reached
// from tps_grid_sample_fused, with_mp=False). Contract:
//   T  = inv_delta_C @ [C'; 0]                                (F+3, 2)
//   P' = [1 | P | P_hat * (0.5 * score + 1)] @ T              per pixel
//   out = bilinear sample of feat at P', align_corners=True, border clamp,
// with the reference's quirk kept: the [0,1] grid goes into a [-1,1]
// sampler, gx = (p + 1) / 2 * (W - 1) clamped to [0, W - 1].
//
// The TPU builds a dense (TILE x H*W) interpolation matrix and multiplies it
// with the (H*W x C) feature block on the MXU, because gathers are slow
// there. That is a TPU choice and is not carried over: on Hopper this is a
// gather. Each block computes T for its image once, in shared memory; each
// warp then takes one output pixel at a time, computes P' in f32 (lanes split
// the F+3 terms, a shuffle reduction sums them) and reads its 4 taps. Lanes
// run over channels, two bf16 channels each, so one tap of a 64-channel row
// is one coalesced 128-byte read. The taps and the gather are shared with
// the training warp (grid_sample.cu) through common.cuh.
//
// Bound on the H100: memory. Per image it reads the (n, F) f32 scores
// (128 KB at n=1024, F=32) and 4 taps of 128 B per pixel (mostly L2 hits:
// the 32x128x64 bf16 feature map is 512 KB), and writes 128 KB. About
// 0.4 MB per image, so ~0.2 GB at B=512: ~70 us at 3.35 TB/s.
//
// Numerics: the bilinear weights stay in f32 (the TPU rounds them to bf16,
// pallas_tps.py:76, before its MXU product); the output is rounded to bf16
// once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kPixPerBlock = 64;
constexpr int kMaxF3 = 128;     // F + 3 fiducial terms held in shared memory

__global__ void __launch_bounds__(kThreads)
tps_sampler_kernel(const bf16* __restrict__ feat,   // (N, Hg, Wg, C)
                   const float* __restrict__ cp,    // (N, F, 2)
                   const float* __restrict__ score, // (N, npix, F)
                   const float* __restrict__ inv,   // (F+3, F+3)
                   const float* __restrict__ phat,  // (npix, F)
                   const float* __restrict__ P,     // (npix, 2)
                   bf16* __restrict__ out,          // (N, npix, C)
                   int Hg, int Wg, int C, int npix, int F) {
  __shared__ float Ts[kMaxF3 * 2];
  const int n = blockIdx.y;
  const int F3 = F + 3;
  for (int e = threadIdx.x; e < F3 * 2; e += blockDim.x) {
    const int r = e >> 1, c = e & 1;
    const float* cpn = cp + (size_t)n * F * 2;
    float acc = 0.f;
    for (int k = 0; k < F; ++k) acc += inv[r * F3 + k] * cpn[k * 2 + c];
    Ts[e] = acc;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p_end = min((int)(blockIdx.x + 1) * kPixPerBlock, npix);
  const bf16* img = feat + (size_t)n * Hg * Wg * C;
  for (int p = blockIdx.x * kPixPerBlock + warp; p < p_end;
       p += kThreads / 32) {
    const float* sc = score + ((size_t)n * npix + p) * F;
    const float* ph = phat + (size_t)p * F;
    float px = 0.f, py = 0.f;
    for (int k = lane; k < F3; k += 32) {
      float a;
      if (k == 0) a = 1.f;
      else if (k < 3) a = P[p * 2 + (k - 1)];
      else a = ph[k - 3] * (sc[k - 3] * 0.5f + 1.f);
      px += a * Ts[k * 2];
      py += a * Ts[k * 2 + 1];
    }
    px = warp_sum(px);
    py = warp_sum(py);
    warp_sample_pixel(img, bilinear_taps(px, py, Hg, Wg),
                      out + ((size_t)n * npix + p) * C, C, lane);
  }
}

}  // namespace

extern "C" int tpk_tps_sampler(const void* feat, const float* cp,
                               const float* score, const float* inv,
                               const float* phat, const float* P, void* out,
                               int N, int Hg, int Wg, int C, int npix, int F,
                               void* stream) {
  if (F + 3 > kMaxF3 || (C & 1)) return (int)cudaErrorInvalidValue;
  dim3 grid((npix + kPixPerBlock - 1) / kPixPerBlock, N);
  tps_sampler_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)feat, cp, score, inv, phat, P, (bf16*)out, Hg, Wg, C, npix,
      F);
  TPK_CHECK();
  return 0;
}
