// TPS++ rectification: grid generation + bilinear warp in one kernel.
//
// Replaces the TPU kernels tps_pp_tpu/ops/pallas_tps.py `_kernel` (variant
// 'dense') and `_kernel_twostage` (variant 'twostage'), both reached from
// tps_grid_sample_fused. Contract:
//   T  = inv_delta_C @ [C'; 0]                                (F+3, 2)
//   P' = [1 | P | P_hat * (0.5 * score + 1)] @ T              per pixel
//   out = bilinear sample of feat at P', align_corners=True, border clamp,
// with the reference's quirk kept: the [0,1] grid goes into a [-1,1]
// sampler, gx = (p + 1) / 2 * (W - 1) clamped to [0, W - 1]. With a second
// map (with_mp) the same P' also samples it, at its own size, into out_mp.
//
// The TPU builds a dense (TILE x H*W) interpolation matrix and multiplies it
// with the (H*W x C) feature block on the MXU (the two-stage variant: a
// (TILE x W) hat matrix against the map transposed to (W, H*C), then a fold
// over h), because gathers are slow there. That is a TPU choice and is not
// carried over: on Hopper this is a gather. Each block computes T for its
// image once, in shared memory; each warp then takes one output pixel at a
// time, computes P' in f32 (lanes split the F+3 terms, a shuffle reduction
// sums them) and reads its 4 taps. Lanes run over channels, two bf16
// channels each, so one tap of a 64-channel row is one coalesced 128-byte
// read. The dense taps and the gather are shared with the training warp
// (grid_sample.cu) through common.cuh.
//
// Bound on the H100: memory. Per image it reads the (n, F) f32 scores
// (128 KB at n=1024, F=32) and 4 taps of 128 B per pixel (mostly L2 hits:
// the 32x128x64 bf16 feature map is 512 KB), and writes 128 KB. About
// 0.4 MB per image, so ~0.2 GB at B=512: ~70 us at 3.35 TB/s. Both
// variants move the same bytes.
//
// Numerics. Dense: the bilinear weights stay in f32 (the TPU rounds their
// products to bf16, pallas_tps.py:76, before its MXU product); the output
// is rounded to the map's type (bf16 or f32, as the TPU kernel takes
// either) once. Two-stage, as the TPU kernel rounds (pallas_tps.py:
// 119-145): the hat weights max(0, 1 - |g - i|) of the two columns, rounded
// to the map's type, sum each of the two rows in f32; the f32 hat weights
// of the two rows blend those sums; products and sums are rounded one by
// one (no fused multiply-add, as the TPU's two products), the output once.
//
// Limits (cudaErrorInvalidValue otherwise): F + 3 <= 128, C even.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kPixPerBlock = 64;
constexpr int kMaxF3 = 128;     // F + 3 fiducial terms held in shared memory

// The two-stage variant's taps of one coordinate g in [0, size - 1]: the
// pixel at or below g and the next one, with their hat weights (the next
// one's 0 past the last pixel).
struct HatPair {
  int i0, i1;
  float w0, w1;
};

static __device__ __forceinline__ HatPair hat_pair(float g, int size) {
  HatPair h;
  const float f = floorf(g);
  h.i0 = (int)f;
  h.i1 = min(h.i0 + 1, size - 1);
  h.w0 = fmaxf(0.f, 1.f - fabsf(g - f));
  h.w1 = h.i0 + 1 < size ? fmaxf(0.f, 1.f - fabsf(g - (f + 1.f))) : 0.f;
  return h;
}

static __device__ __forceinline__ float round_to(float v, const bf16*) {
  return bf_round(v);
}
static __device__ __forceinline__ float round_to(float v, const float*) {
  return v;
}

// One warp samples one pixel of `img` (H x W pixel rows of C channels) at
// P' = (px, py) into `out`, in either variant.
template <bool kTwoStage, typename T>
static __device__ __forceinline__ void sample_pixel(
    const T* __restrict__ img, float px, float py, int H, int W,
    T* __restrict__ out, int C, int lane) {
  if (!kTwoStage) {
    warp_sample_pixel(img, bilinear_taps(px, py, H, W), out, C, lane);
    return;
  }
  float gx = (px + 1.f) * 0.5f * (float)(W - 1);
  float gy = (py + 1.f) * 0.5f * (float)(H - 1);
  gx = fminf(fmaxf(gx, 0.f), (float)(W - 1));
  gy = fminf(fmaxf(gy, 0.f), (float)(H - 1));
  const HatPair x = hat_pair(gx, W), y = hat_pair(gy, H);
  const float wx0 = round_to(x.w0, img), wx1 = round_to(x.w1, img);
  const T* r00 = img + ((size_t)y.i0 * W + x.i0) * C;
  const T* r01 = img + ((size_t)y.i0 * W + x.i1) * C;
  const T* r10 = img + ((size_t)y.i1 * W + x.i0) * C;
  const T* r11 = img + ((size_t)y.i1 * W + x.i1) * C;
  for (int c2 = lane; c2 < (C >> 1); c2 += 32) {
    const float2 a = load2(r00, c2), b = load2(r01, c2);
    const float2 c = load2(r10, c2), d = load2(r11, c2);
    const float s0x = __fadd_rn(__fmul_rn(wx0, a.x), __fmul_rn(wx1, b.x));
    const float s0y = __fadd_rn(__fmul_rn(wx0, a.y), __fmul_rn(wx1, b.y));
    const float s1x = __fadd_rn(__fmul_rn(wx0, c.x), __fmul_rn(wx1, d.x));
    const float s1y = __fadd_rn(__fmul_rn(wx0, c.y), __fmul_rn(wx1, d.y));
    store2(out, c2, __fadd_rn(__fmul_rn(y.w0, s0x), __fmul_rn(y.w1, s1x)),
           __fadd_rn(__fmul_rn(y.w0, s0y), __fmul_rn(y.w1, s1y)));
  }
}

template <typename T, bool kTwoStage>
__global__ void __launch_bounds__(kThreads)
tps_sampler_kernel(const T* __restrict__ feat,      // (N, Hg, Wg, C)
                   const T* __restrict__ img,       // (N, Hi, Wi, C) or null
                   const float* __restrict__ cp,    // (N, F, 2)
                   const float* __restrict__ score, // (N, npix, F)
                   const float* __restrict__ inv,   // (F+3, F+3)
                   const float* __restrict__ phat,  // (npix, F)
                   const float* __restrict__ P,     // (npix, 2)
                   T* __restrict__ out,             // (N, npix, C)
                   T* __restrict__ out_mp,          // (N, npix, C) or null
                   int Hg, int Wg, int Hi, int Wi, int C, int npix, int F) {
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
  const T* fmap = feat + (size_t)n * Hg * Wg * C;
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
    const size_t o = ((size_t)n * npix + p) * C;
    sample_pixel<kTwoStage>(fmap, px, py, Hg, Wg, out + o, C, lane);
    if (img)
      sample_pixel<kTwoStage>(img + (size_t)n * Hi * Wi * C, px, py, Hi, Wi,
                              out_mp + o, C, lane);
  }
}

template <typename T, bool kTwoStage>
void launch_sampler(dim3 grid, cudaStream_t s, const void* feat,
                    const void* img, const float* cp, const float* score,
                    const float* inv, const float* phat, const float* P,
                    void* out, void* out_mp, int Hg, int Wg, int Hi, int Wi,
                    int C, int npix, int F) {
  tps_sampler_kernel<T, kTwoStage><<<grid, kThreads, 0, s>>>(
      (const T*)feat, (const T*)img, cp, score, inv, phat, P, (T*)out,
      (T*)out_mp, Hg, Wg, Hi, Wi, C, npix, F);
}

}  // namespace

// is_bf16 selects the element type of the maps and outputs: 1 = bf16, 0 =
// f32; twostage the variant. img / out_mp are null without the second map.
extern "C" int tpk_tps_sampler(const void* feat, const void* img,
                               const float* cp, const float* score,
                               const float* inv, const float* phat,
                               const float* P, void* out, void* out_mp, int N,
                               int Hg, int Wg, int Hi, int Wi, int C, int npix,
                               int F, int is_bf16, int twostage,
                               void* stream) {
  if (F + 3 > kMaxF3 || (C & 1) || (img != nullptr) != (out_mp != nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((npix + kPixPerBlock - 1) / kPixPerBlock, N);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16 && twostage)
    launch_sampler<bf16, true>(grid, s, feat, img, cp, score, inv, phat, P,
                               out, out_mp, Hg, Wg, Hi, Wi, C, npix, F);
  else if (is_bf16)
    launch_sampler<bf16, false>(grid, s, feat, img, cp, score, inv, phat, P,
                                out, out_mp, Hg, Wg, Hi, Wi, C, npix, F);
  else if (twostage)
    launch_sampler<float, true>(grid, s, feat, img, cp, score, inv, phat, P,
                                out, out_mp, Hg, Wg, Hi, Wi, C, npix, F);
  else
    launch_sampler<float, false>(grid, s, feat, img, cp, score, inv, phat, P,
                                 out, out_mp, Hg, Wg, Hi, Wi, C, npix, F);
  TPK_CHECK();
  return 0;
}
