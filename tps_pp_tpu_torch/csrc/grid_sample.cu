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
// through Q = cot @ img^T), because gathers and scatters are slow there;
// its backward keeps one image's whole f32 d_img resident as the output
// block and writes it once. On Hopper that matrix is ~1,000x the work of
// the 4 taps it encodes, so the kernels gather instead, a warp per sample
// with its lanes over channel pairs (one tap of a 64-channel bf16 row is
// one 128-byte access); the taps and weights come from common.cuh, shared
// with the serving sampler. The backward keeps the TPU's resident sum at
// the size of shared memory: each CTA owns a band of source rows and sums
// its d_img there (below), so nothing scatters into device memory.
//
// Gradient conventions (those of the Pallas backward, which are autodiff
// of the floor-based lerp):
//   d out/d gx = (1-wy)(v01 - v00) + wy (v11 - v10), with v01 = v00 at the
//     last column (the clamped far tap), so 0 there; at a pixel centre the
//     far tap is x0+1;
//   the border clip passes the gradient where 0 <= g <= size-1, ties
//     included, and d_grid = d gx * (W-1)/2 (align_corners=True).
// d_img: the f32 sums of each element are the same terms in another order
// than the plain version's, added by shared-memory atomics from several
// warps whose order varies, so d_img varies in its last bits from run to
// run.
//
// Bound on the H100: memory. At the flagship's training shape (N=256,
// 16x64 samples of a 32x128x64 map) the forward reads 4 taps of 128 B a
// sample (mostly L2 hits: one bf16 map is 512 KB) and writes 32 MB; the
// backward writes the 268 MB f32 d_img once and reads the 34 MB cotangent
// (a little more: samples that straddle two bands) and, in kernel 9, the
// 134 MB map.
//
// Odd channel counts (the one-channel 32x100 crops that the CTC family's
// TPS-STN warps, C = 1; RGB crops, C = 3) cannot be loaded as pairs, and a
// warp over one channel would leave 31 of its lanes idle. There each
// kernel takes its narrow path: one thread a sample, four scalar taps from
// bilinear_taps, one load or store a channel. The backward's slab is all
// of C, and a 32x100 f32 band of one channel is 12.8 KB, so one CTA holds
// a whole image. Each of its threads takes every 512th sample, with no
// list: it adds the four weighted cotangents of a sample that meets its
// band with scalar shared-memory atomics, and kernel 9 takes d_grid from
// the four taps directly, with no shuffle sum. (Cutting the images of a
// B=64 batch into 5 bands, to put CTAs on every SM, measured slower on an
// H100: each band scans all of its image's samples.) Even C keeps the
// paths above. At CRNN-TPS's serving shape (N=512 bf16) the forward moves
// ~20 MB, a few microseconds at the memory rate: it is bound by its
// launch.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerBlock = 64;

// The forward's narrow path (odd C): one thread a sample.
template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_narrow_kernel(const T* __restrict__ img,      // (N, H, W, C)
                              const float* __restrict__ grid,  // (N, npix, 2)
                              T* __restrict__ out,             // (N, npix, C)
                              int H, int W, int C, int npix) {
  const int n = blockIdx.y, p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  const size_t np = (size_t)n * npix + p;
  const float2 g = reinterpret_cast<const float2*>(grid)[np];
  const BilinearTaps t = bilinear_taps(g.x, g.y, H, W);
  const T* im = img + (size_t)n * H * W * C;
  const T* r00 = im + (size_t)t.o00 * C;
  const T* r01 = im + (size_t)t.o01 * C;
  const T* r10 = im + (size_t)t.o10 * C;
  const T* r11 = im + (size_t)t.o11 * C;
  for (int c = 0; c < C; ++c)
    store1(out + np * C, c,
           t.w00 * load1(r00, c) + t.w01 * load1(r01, c) +
               t.w10 * load1(r10, c) + t.w11 * load1(r11, c));
}

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

// ---- kernels 9 and 10: owner-computes over source bands -----------------
//
// A CTA owns a band: `rows` source rows of one image over all W columns and
// a slab of `slab` channels (slab = C unless one row of C does not fit).
// It sums the band's d_img in f32 in shared memory and stores it once,
// zeros included, so d_img needs no zero pass and no global atomic:
//   1. zero the band's accumulator;
//   2. per chunk of kChunk samples, list the samples whose tap rows y0 or
//      y1 meet the band, with their grid points (a thread's grid loads all
//      in flight at once; warp ballots and a prefix over the warps' counts,
//      so the list keeps the samples' order);
//   3. each warp takes kUnroll listed samples at a time (their cotangent
//      rows in flight together), two channels a lane, and adds w * cot to
//      the band's tap rows with shared-memory f32 atomics; lanes 16-31
//      add the odd channel of their pair first, so one instruction's 32
//      addresses fall in 32 banks;
//   4. store the band to d_img with 16-byte stores.
// A sample whose taps straddle two bands is listed by both CTAs. Kernel 9:
// the CTA of slab 0 whose band holds y0 also reads the sample's four image
// taps and writes its d_grid (the sum over channels by shuffles), so each
// d_grid is written once; kernel 10 reads no image. The CTAs run
// image-major (one image's bands and slabs in a row), so an image's map
// and grid stay in L2 while its bands run.
//
// What bounds it (tools/grid_sample_variants.py): zeroing, listing and the
// store alone reach the bytes bound; the accumulate is latency-bound, each
// warp waiting on its samples' cotangent rows and on the compare-and-swap
// loops that shared f32 atomicAdd compiles to on Hopper (there is no
// native shared f32 add), one after another. So a CTA has 16 warps, two
// CTAs an SM, with few samples each in flight (the registers of two
// 512-thread CTAs allow 64 a thread): more warps hide more of the wait
// than 8 with more samples each.
constexpr int kChunk = 1024;     // samples listed at a time
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMinCtasPerSm = 2;
static_assert(kChunk % kBwdThreads == 0, "a chunk is whole rounds");
// samples a warp has in flight: kernel 9 also holds four image taps of each
template <bool kWithGrid>
constexpr int kUnroll = kWithGrid ? 2 : 4;

// Shared memory of a CTA: the band's f32 accumulator, the listed samples'
// grid points and indices, the warps' counts.
size_t bwd_smem(int rows, int W, int slab) {
  return (size_t)rows * W * slab * sizeof(float) +
         kChunk * (sizeof(float2) + sizeof(int)) + kBwdWarps * sizeof(int);
}

struct BwdPlan {
  int rows, slab, ctas_per_sm, blocks;
  size_t smem;
};

// The plan on the current device: the widest slab (an even divisor of C;
// all of an odd C) of which one row fits kMinCtasPerSm CTAs an SM (C
// unless a row of C is too wide), then as many rows as fit beside it.
// cudaErrorInvalidValue where none fits or the CTAs overflow a 1-D grid.
int bwd_plan(int N, int H, int W, int C, BwdPlan& p) {
  if (N < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  int dev, per_sm, per_block, reserved;
  TPK_TRY((int)cudaGetDevice(&dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev));
  const size_t budget =
      (size_t)std::min(per_block, per_sm / kMinCtasPerSm - reserved);
  if (C & 1) {
    p.slab = C;
    if (bwd_smem(1, W, C) > budget) return (int)cudaErrorInvalidValue;
  } else {
    for (p.slab = C; p.slab >= 2; p.slab -= 2)
      if (C % p.slab == 0 && bwd_smem(1, W, p.slab) <= budget) break;
    if (p.slab < 2) return (int)cudaErrorInvalidValue;
  }
  p.rows = 1;
  while (p.rows < H && bwd_smem(p.rows + 1, W, p.slab) <= budget) ++p.rows;
  p.smem = bwd_smem(p.rows, W, p.slab);
  p.ctas_per_sm = std::min(2048 / kBwdThreads,
                           per_sm / (int)(p.smem + reserved));
  const long long blocks =
      (long long)N * ((H + p.rows - 1) / p.rows) * (C / p.slab);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.blocks = (int)blocks;
  return 0;
}

// Adds v * w to the channel pair at p (8-byte aligned); lanes 16-31
// (first = 1) add the odd channel first.
static __device__ __forceinline__ void add_pair(float* p, float2 v, float w,
                                                int first) {
  atomicAdd(p + first, w * (first ? v.y : v.x));
  atomicAdd(p + 1 - first, w * (first ? v.x : v.y));
}

// kNarrow: the path of an odd C (slab = C), one thread a sample.
template <typename T, bool kWithGrid, bool kNarrow>
__global__ void __launch_bounds__(kBwdThreads, kMinCtasPerSm)
grid_sample_bwd_kernel(const float* __restrict__ grid,  // (N, npix, 2)
                       const T* __restrict__ cot,       // (N, npix, C)
                       const T* __restrict__ img,       // (N, H, W, C)
                       float* __restrict__ d_img,       // (N, H, W, C)
                       float* __restrict__ d_grid,      // (N, npix, 2)
                       int H, int W, int C, int npix, int rows, int slab) {
  extern __shared__ __align__(16) float acc[];  // (rows, W, slab)
  float2* lg = reinterpret_cast<float2*>(acc + (size_t)rows * W * slab);
  int* list = reinterpret_cast<int*>(lg + kChunk);
  int* wcnt = list + kChunk;
  constexpr int kU = kUnroll<kWithGrid>;
  constexpr int kPer = kChunk / kBwdThreads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slabs = C / slab, bands = (H + rows - 1) / rows;
  const int s = blockIdx.x % slabs, band = blockIdx.x / slabs % bands;
  const int n = blockIdx.x / slabs / bands;
  const int nrows = min(rows, H - band * rows);
  // the band as pixel indices y * W + x: [lo, lo + span)
  const int lo = band * rows * W, span = nrows * W;
  const int elems = span * slab, pairs = slab / 2;

  // ---- 1. zero the accumulator (the first list's sync orders it)
  for (int e = tid; e < elems / 4; e += kBwdThreads)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = (elems & ~3) + tid; e < elems; e += kBwdThreads)
    acc[e] = 0.f;

  const float2* gr = reinterpret_cast<const float2*>(grid) + (size_t)n * npix;
  const T* co_n = cot + (size_t)n * npix * C;
  const T* im = kWithGrid ? img + (size_t)n * H * W * C : nullptr;
  const int c2_lo = s * pairs, c2_hi = c2_lo + pairs;
  const int first = lane >= 16;
  if constexpr (kNarrow) {
    // ---- 2n-3n. the narrow path lists nothing: a thread takes the samples
    // p = tid, tid + 512, ..., adds the taps of those that meet the band
    // and, in kernel 9, writes the d_grid of those whose y0 it holds
    __syncthreads();  // the zeroed accumulator
    for (int p = tid; p < npix; p += kBwdThreads) {
      const float2 g = gr[p];
      const BilinearTaps t = bilinear_taps(g.x, g.y, H, W);
      const bool in0 = (unsigned)(t.o00 - lo) < (unsigned)span;
      const bool in1 = (unsigned)(t.o10 - lo) < (unsigned)span;
      if (!in0 && !in1) continue;
      const T* co = co_n + (size_t)p * C;
      float sx = 0.f, sy = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = load1(co, c);
        if (in0) {
          atomicAdd(acc + (size_t)(t.o00 - lo) * C + c, t.w00 * v);
          atomicAdd(acc + (size_t)(t.o01 - lo) * C + c, t.w01 * v);
        }
        if (in1) {
          atomicAdd(acc + (size_t)(t.o10 - lo) * C + c, t.w10 * v);
          atomicAdd(acc + (size_t)(t.o11 - lo) * C + c, t.w11 * v);
        }
        if constexpr (kWithGrid) {
          if (in0) {
            const float a = load1(im + (size_t)t.o00 * C, c);
            const float b = load1(im + (size_t)t.o01 * C, c);
            const float e = load1(im + (size_t)t.o10 * C, c);
            const float d = load1(im + (size_t)t.o11 * C, c);
            sx += v * ((1.f - t.wy) * (b - a) + t.wy * (d - e));
            sy += v * ((1.f - t.wx) * (e - a) + t.wx * (d - b));
          }
        }
      }
      if constexpr (kWithGrid) {
        if (in0) {
          const float gx = (g.x + 1.f) * 0.5f * (float)(W - 1);
          const float gy = (g.y + 1.f) * 0.5f * (float)(H - 1);
          const bool in_x = gx >= 0.f && gx <= (float)(W - 1);
          const bool in_y = gy >= 0.f && gy <= (float)(H - 1);
          reinterpret_cast<float2*>(d_grid)[(size_t)n * npix + p] =
              make_float2(in_x ? sx * (0.5f * (float)(W - 1)) : 0.f,
                          in_y ? sy * (0.5f * (float)(H - 1)) : 0.f);
        }
      }
    }
  } else {
    for (int p0 = 0; p0 < npix; p0 += kChunk) {
      const int cnt = min(kChunk, npix - p0);
      // ---- 2. list the chunk's samples that meet the band
      float2 gv[kPer];
  #pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = r * kBwdThreads + tid;
        gv[r] = i < cnt ? gr[p0 + i] : make_float2(0.f, 0.f);
      }
      int nsel = 0;
  #pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = r * kBwdThreads + tid;
        bool keep = false;
        if (i < cnt) {
          const BilinearTaps t = bilinear_taps(gv[r].x, gv[r].y, H, W);
          keep = (unsigned)(t.o00 - lo) < (unsigned)span ||
                 (unsigned)(t.o10 - lo) < (unsigned)span;
        }
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        // the last round's counts (and the chunk's list) have been read
        __syncthreads();
        if (lane == 0) wcnt[warp] = __popc(m);
        __syncthreads();
        int off = nsel;
        for (int w = 0; w < kBwdWarps; ++w) {
          off += w < warp ? wcnt[w] : 0;
          nsel += wcnt[w];
        }
        if (keep) {
          const int k = off + __popc(m & ((1u << lane) - 1u));
          list[k] = i;
          lg[k] = gv[r];
        }
      }
      __syncthreads();

      // ---- 3. add the listed samples' contributions, kU a warp
      for (int k0 = warp * kU; k0 < nsel; k0 += kBwdWarps * kU) {
        BilinearTaps t[kU];
        const T* co[kU];
        bool in0[kU], in1[kU], own[kU];
        bool any_own = false;
  #pragma unroll
        for (int u = 0; u < kU; ++u) {
          // past the list's end: the first sample again, adding nothing
          const bool valid = k0 + u < nsel;
          const int k = valid ? k0 + u : k0;
          t[u] = bilinear_taps(lg[k].x, lg[k].y, H, W);
          co[u] = co_n + (size_t)(p0 + list[k]) * C;
          in0[u] = valid && (unsigned)(t[u].o00 - lo) < (unsigned)span;
          in1[u] = valid && (unsigned)(t[u].o10 - lo) < (unsigned)span;
          own[u] = kWithGrid && s == 0 && in0[u];
          any_own |= own[u];
        }
        // d_grid sums over every channel: an owner reads them all
        const int c2_begin = any_own ? 0 : c2_lo;
        const int c2_end = any_own ? C / 2 : c2_hi;
        float sx[kU], sy[kU];
  #pragma unroll
        for (int u = 0; u < kU; ++u) sx[u] = sy[u] = 0.f;
        for (int c2 = c2_begin + lane; c2 < c2_end; c2 += 32) {
          float2 v[kU];
  #pragma unroll
          for (int u = 0; u < kU; ++u) v[u] = load2(co[u], c2);
          if (c2 >= c2_lo && c2 < c2_hi) {
            const int cl = 2 * (c2 - c2_lo);
  #pragma unroll
            for (int u = 0; u < kU; ++u) {
              if (in0[u]) {
                add_pair(acc + (size_t)(t[u].o00 - lo) * slab + cl, v[u],
                         t[u].w00, first);
                add_pair(acc + (size_t)(t[u].o01 - lo) * slab + cl, v[u],
                         t[u].w01, first);
              }
              if (in1[u]) {
                add_pair(acc + (size_t)(t[u].o10 - lo) * slab + cl, v[u],
                         t[u].w10, first);
                add_pair(acc + (size_t)(t[u].o11 - lo) * slab + cl, v[u],
                         t[u].w11, first);
              }
            }
          }
          if constexpr (kWithGrid) {
  #pragma unroll
            for (int u = 0; u < kU; ++u) {
              if (!own[u]) continue;
              const float2 a = load2(im + (size_t)t[u].o00 * C, c2);
              const float2 b = load2(im + (size_t)t[u].o01 * C, c2);
              const float2 e = load2(im + (size_t)t[u].o10 * C, c2);
              const float2 d = load2(im + (size_t)t[u].o11 * C, c2);
              const float wy = t[u].wy, wx = t[u].wx;
              sx[u] += v[u].x * ((1.f - wy) * (b.x - a.x) + wy * (d.x - e.x)) +
                       v[u].y * ((1.f - wy) * (b.y - a.y) + wy * (d.y - e.y));
              sy[u] += v[u].x * ((1.f - wx) * (e.x - a.x) + wx * (d.x - b.x)) +
                       v[u].y * ((1.f - wx) * (e.y - a.y) + wx * (d.y - b.y));
            }
          }
        }
        if constexpr (kWithGrid) {
  #pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (!own[u]) continue;  // warp-uniform
            const float dx = warp_sum(sx[u]), dy = warp_sum(sy[u]);
            if (lane == 0) {
              const float2 g = lg[k0 + u];
              const float gx = (g.x + 1.f) * 0.5f * (float)(W - 1);
              const float gy = (g.y + 1.f) * 0.5f * (float)(H - 1);
              const bool in_x = gx >= 0.f && gx <= (float)(W - 1);
              const bool in_y = gy >= 0.f && gy <= (float)(H - 1);
              reinterpret_cast<float2*>(d_grid)[(size_t)n * npix + p0 +
                                                list[k0 + u]] =
                  make_float2(in_x ? dx * (0.5f * (float)(W - 1)) : 0.f,
                              in_y ? dy * (0.5f * (float)(H - 1)) : 0.f);
            }
          }
        }
      }
      // (the next chunk's first sync orders its list after these reads)
    }
  }

  // ---- 4. store the band, once
  __syncthreads();
  float* dst = d_img + ((size_t)n * H * W + lo) * C + 2 * c2_lo;
  if (slab == C && elems % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int e = tid; e < elems / 4; e += kBwdThreads)
      reinterpret_cast<float4*>(dst)[e] =
          reinterpret_cast<const float4*>(acc)[e];
  } else if (kNarrow) {
    for (int e = tid; e < elems; e += kBwdThreads) dst[e] = acc[e];
  } else {
    for (int e = tid; e < span * pairs; e += kBwdThreads) {
      const int px = e / pairs, c2 = e - px * pairs;
      reinterpret_cast<float2*>(dst + (size_t)px * C)[c2] =
          reinterpret_cast<const float2*>(acc + (size_t)px * slab)[c2];
    }
  }
}

// Writes {rows, slab, CTAs an SM, blocks, shared memory bytes} to plan.
void report(const BwdPlan& p, int* plan) {
  if (!plan) return;
  plan[0] = p.rows;
  plan[1] = p.slab;
  plan[2] = p.ctas_per_sm;
  plan[3] = p.blocks;
  plan[4] = (int)p.smem;
}

template <typename T, bool kWithGrid>
void launch_typed(const float* grid, const void* cot, const void* img,
                  float* d_img, float* d_grid, int H, int W, int C, int npix,
                  const BwdPlan& p, cudaStream_t s) {
  auto kernel = (C & 1) ? grid_sample_bwd_kernel<T, kWithGrid, true>
                        : grid_sample_bwd_kernel<T, kWithGrid, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)p.smem);
  kernel<<<p.blocks, kBwdThreads, p.smem, s>>>(grid, (const T*)cot,
                                            (const T*)img, d_img, d_grid, H,
                                            W, C, npix, p.rows, p.slab);
}

template <bool kWithGrid>
int launch_bwd(const float* grid, const void* cot, const void* img,
               float* d_img, float* d_grid, int N, int H, int W, int C,
               int npix, int is_bf16, int* plan, cudaStream_t s) {
  BwdPlan p;
  TPK_TRY(bwd_plan(N, H, W, C, p));
  if (is_bf16)
    launch_typed<bf16, kWithGrid>(grid, cot, img, d_img, d_grid, H, W, C,
                                  npix, p, s);
  else
    launch_typed<float, kWithGrid>(grid, cot, img, d_img, d_grid, H, W, C,
                                   npix, p, s);
  TPK_CHECK();
  report(p, plan);
  return 0;
}

dim3 blocks(int N, int npix) {
  return dim3((npix + kPixPerBlock - 1) / kPixPerBlock, N);
}

}  // namespace

// is_bf16 selects the element type of img / cot / out: 1 = bf16, 0 = f32.
extern "C" int tpk_grid_sample_fwd(const void* img, const float* grid,
                                   void* out, int N, int H, int W, int C,
                                   int npix, int is_bf16, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C & 1) {
    const dim3 nb((npix + kThreads - 1) / kThreads, N);
    if (is_bf16)
      grid_sample_fwd_narrow_kernel<bf16><<<nb, kThreads, 0, s>>>(
          (const bf16*)img, grid, (bf16*)out, H, W, C, npix);
    else
      grid_sample_fwd_narrow_kernel<float><<<nb, kThreads, 0, s>>>(
          (const float*)img, grid, (float*)out, H, W, C, npix);
  } else if (is_bf16)
    grid_sample_fwd_kernel<bf16><<<blocks(N, npix), kThreads, 0, s>>>(
        (const bf16*)img, grid, (bf16*)out, H, W, C, npix);
  else
    grid_sample_fwd_kernel<float><<<blocks(N, npix), kThreads, 0, s>>>(
        (const float*)img, grid, (float*)out, H, W, C, npix);
  TPK_CHECK();
  return 0;
}

// d_img (N, H, W, C) f32 is written whole (no zeroing needed); d_grid
// (N, npix, 2) f32. plan, if not null, gets the plan the kernel ran (see
// tpk_grid_sample_plan).
extern "C" int tpk_grid_sample_grad(const float* grid, const void* cot,
                                    const void* img, float* d_img,
                                    float* d_grid, int N, int H, int W, int C,
                                    int npix, int is_bf16, int* plan,
                                    void* stream) {
  return launch_bwd<true>(grid, cot, img, d_img, d_grid, N, H, W, C, npix,
                          is_bf16, plan, (cudaStream_t)stream);
}

extern "C" int tpk_grid_sample_grad_img(const float* grid, const void* cot,
                                        float* d_img, int N, int H, int W,
                                        int C, int npix, int is_bf16,
                                        int* plan, void* stream) {
  return launch_bwd<false>(grid, cot, nullptr, d_img, nullptr, N, H, W, C,
                           npix, is_bf16, plan, (cudaStream_t)stream);
}

// The plan of kernels 9 and 10 at this shape on the current device: plan =
// {rows a band, channels a slab, CTAs an SM, CTAs, shared memory bytes of
// a CTA}. cudaErrorInvalidValue where none fits.
extern "C" int tpk_grid_sample_plan(int N, int H, int W, int C, int* plan) {
  BwdPlan p;
  TPK_TRY(bwd_plan(N, H, W, C, p));
  report(p, plan);
  return 0;
}
