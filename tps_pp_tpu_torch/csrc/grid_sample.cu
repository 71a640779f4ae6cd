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
// its d_img there (below), so nothing scatters into device memory (the
// narrow path adds its CTAs' copies of a band to d_img whole, coalesced).
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
// warps whose order varies (and on the narrow path the cluster's copies
// added to d_img in any order), so d_img varies in its last bits from run
// to run.
//
// Bound on the H100: memory. At the flagship's training shape (N=256,
// 16x64 samples of a 32x128x64 map) the forward reads 4 taps of 128 B a
// sample (mostly L2 hits: one bf16 map is 512 KB) and writes 32 MB; the
// backward writes the 268 MB f32 d_img once and reads the 34 MB cotangent
// (a little more: samples that straddle two bands) and, in kernel 9, the
// 134 MB map.
//
// Odd channel counts (the one-channel 32x100 crops that the CTC family's
// TPS-STN warps, C = 1; RGB crops, C = 3; MORAN's 3x11 and SPIN's 2x8
// offset maps sampled up to the crop) cannot be loaded as pairs, and a
// warp over one channel would leave 31 of its lanes idle. There each
// kernel takes its narrow path: the forward a lane a sample, a warp a run
// of adjacent samples (below), the backward a cluster of CTAs an image, a
// run of samples a thread (below, "the narrow path"). At these shapes the
// backward's bounds are under the launch latency, so the narrow backward
// is built to leave nothing waiting in series. At CRNN-TPS's serving shape
// (N=512 bf16) the forward moves ~20 MB, 5.9 us at the memory rate.
#include <algorithm>
#include <cstring>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

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

// ---- kernel 8 at an odd C: the narrow forward ---------------------------
//
// At an odd C a pixel's channels cannot be loaded as pairs, so the lanes of
// a warp span samples, not channels, and gather a channel at a time. The
// bytes are mostly the grid, read once (8 bytes a sample against 2-6 of
// output and a map of a few KB an image: 13.1 of CRNN-TPS's 19.7 MB at
// B=512 bf16), so the design keeps as much of it in flight as an SM holds
// and waits on no tap in series with it:
//   * a warp takes a run of 32 x `run` adjacent samples as pairs, lane l
//     the pairs l, l + 32, ...: each of its run / 2 grid loads is one
//     16-byte word a lane, 512 contiguous bytes a warp (ld.global.cs: read
//     once), all issued before the first tap. `run` is kFwdMaxRun, halved
//     (to 2) while the warps would not fill kFillWarps an SM (small
//     batches);
//   * a CTA takes up to kFwdMaxWarps of an image's runs (a larger image is
//     split evenly over CTAs, so that none is left mostly idle at the
//     image's end) and stages the image's map in shared memory where it
//     fits kMapSmemMax (`taps_shared`), while the grid loads are in
//     flight: the 16-byte window that holds it, or at C = 3 its pixels as
//     RGBx f32, a tap's three channels one 16-byte load and no
//     conversion. As neighbouring lanes hold neighbouring pairs, a warp's
//     taps fall in distinct banks or on one word (a C = 1 map in f32 would
//     put them two to a bank: measured slower). A larger map is read where
//     it lies, through L1;
//   * at C = 1 a pair's two outputs go out as one store, a warp's as whole
//     lines; at C = 3 through the warp's tile of shared memory, laid at the
//     same offset modulo 16 as their place in `out`, as whole 16-byte words
//     (the run's first and last few elements one by one); any other odd C
//     a channel at a time.
// Where an image's first sample is odd (an odd npix) or a tensor is not
// aligned, a pair is loaded and stored a sample at a time. Each sample's
// arithmetic is bilinear_taps and tap_sum, the expression of the kernel
// this one replaced, so the outputs are bit-equal to that kernel's.
// Measured and not kept (tools/grid_sample_variants.py; PERF.md section
// 6): a thread 8 adjacent samples, whose lanes' taps fell 4 to a bank; a
// lane every 32nd sample, 8-byte loads and every output through shared
// memory; a persistent grid of 2 CTAs an SM over tiles of an image,
// their grid and map brought into a ring of 2-3 shared-memory stages by
// 1-D bulk copies (cp.async.bulk on an mbarrier), the outputs written back
// by a bulk copy: faster warm at all three serving shapes, slower cold at
// CRNN-TPS's and MORAN's and on every f32 training forward.
constexpr int kFwdMaxRun = 8;      // samples a lane, even
constexpr int kFwdMaxWarps = 16;   // a CTA's
constexpr int kFillWarps = 16;     // warps an SM that the runs are cut to fill
constexpr int kMapSmemMax = 24 * 1024;  // bytes of a staged map's window

// The bilinear sum of channel c at t's taps of a map of C-channel pixels,
// in f32.
template <typename T>
static __device__ __forceinline__ float tap_sum(const T* m,
                                                const BilinearTaps& t, int C,
                                                int c) {
  return t.w00 * load1(m + (size_t)t.o00 * C, c) +
         t.w01 * load1(m + (size_t)t.o01 * C, c) +
         t.w10 * load1(m + (size_t)t.o10 * C, c) +
         t.w11 * load1(m + (size_t)t.o11 * C, c);
}

// The same sums, all three channels, over a map staged as RGBx f32 pixels.
// The values are the ones load1 gives, so the sums are bit-equal to
// tap_sum's.
static __device__ __forceinline__ float3 tap_sum(const float4* m,
                                                 const BilinearTaps& t) {
  const float4 a = m[t.o00], b = m[t.o01], c = m[t.o10], d = m[t.o11];
  return make_float3(t.w00 * a.x + t.w01 * b.x + t.w10 * c.x + t.w11 * d.x,
                     t.w00 * a.y + t.w01 * b.y + t.w10 * c.y + t.w11 * d.y,
                     t.w00 * a.z + t.w01 * b.z + t.w10 * c.z + t.w11 * d.z);
}
template <typename T>
static __device__ __forceinline__ float3 tap_sum3(const T* m,
                                                  const BilinearTaps& t) {
  return make_float3(tap_sum(m, t, 3, 0), tap_sum(m, t, 3, 1),
                     tap_sum(m, t, 3, 2));
}

// The 16-byte aligned window that holds the bytes [p, p + bytes): its
// first word, its words and p's offset into it. A 16-byte word that holds
// a byte of a tensor lies in that byte's page, so reading the window
// cannot fault.
struct Window16 {
  const uint4* lo;
  int words, skew;
};
static __device__ __forceinline__ Window16 window16(const void* p,
                                                    size_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~(uintptr_t)15;
  const uintptr_t hi = (a + bytes + 15) & ~(uintptr_t)15;
  return {reinterpret_cast<const uint4*>(lo), (int)((hi - lo) >> 4),
          (int)(a - lo)};
}
// its bytes at most
static __host__ __device__ size_t window16_bytes(size_t bytes) {
  return (bytes + 15) / 16 * 16 + 16;
}
// the bytes of an H x W x C map of elt-byte elements as the narrow forward
// stages it: RGBx f32 pixels (C = 3) or its window
static __host__ __device__ size_t staged_bytes(int H, int W, int C,
                                               int elt) {
  return C == 3 ? (size_t)H * W * 16
                : window16_bytes((size_t)H * W * C * elt);
}
// the bytes of a warp's output tile: its samples' outputs and a skew
static __host__ __device__ int tile_bytes(int run, int C, int elt) {
  return (32 * run * C * elt + 31) & ~15;
}

// Copies `bytes` of outputs from the warp's tile (at the same offset modulo
// 16 as dst) to dst: whole 16-byte words a lane at a time, the elements
// before the first and after the last word one by one.
template <typename T>
static __device__ __forceinline__ void store_tile(T* dst, const T* tile,
                                                  int bytes, int lane) {
  const int skew = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = min(bytes, (16 - skew) & 15);
  const int words = (bytes - head) >> 4;
  uint4* dw = reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst) + head);
  const uint4* tw = reinterpret_cast<const uint4*>(
      reinterpret_cast<const char*>(tile) + head);
  for (int k = lane; k < words; k += 32) dw[k] = tw[k];
  constexpr int E = (int)sizeof(T);
  const int tail = (head + words * 16) / E, total = bytes / E;
  if (lane < head / E) dst[lane] = tile[lane];
  if (tail + lane < total) dst[tail + lane] = tile[tail + lane];
}

// kC: the channels, 1 or 3 (unrolled), or 0 for any other odd C. run: the
// samples of a lane, even; stage_off: the byte offset of the warps' tiles
// (C = 3) in shared memory, after the staged map.
template <typename T, int kC, bool kTapsShared>
__global__ void __launch_bounds__(kFwdMaxWarps * 32, 2)
grid_sample_fwd_narrow_kernel(const T* __restrict__ img,      // (N, H, W, C)
                              const float* __restrict__ grid,  // (N, npix, 2)
                              T* __restrict__ out,             // (N, npix, C)
                              int H, int W, int C_, int npix, int run,
                              int stage_off) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  constexpr int kPairs = kFwdMaxRun / 2;
  const int C = kC ? kC : C_;
  const int n = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int span = 32 * run;  // a warp's samples
  const int base = (blockIdx.x * (blockDim.x >> 5) + warp) * span;
  const int count = max(0, min(span, npix - base));
  const size_t s0 = (size_t)n * npix + base;  // the warp's first sample
  // pairs of samples loaded as one 16-byte word and (C = 1) stored as one
  // where the first sample of a pair is even (the image's first is) and
  // the tensors aligned
  const bool vec =
      !(s0 & 1) && !(reinterpret_cast<uintptr_t>(grid) & 15) &&
      !(reinterpret_cast<uintptr_t>(out) & (2 * sizeof(T) - 1));

  // ---- 1. the warp's grid points, all in flight before the first tap:
  // lane l's pairs l, l + 32, ... (a 16-byte word of the image's last, odd
  // sample holds the next image's first, read and not used)
  float4 g[kPairs];
  const float2* g2 = reinterpret_cast<const float2*>(grid) + s0;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int i = 2 * (lane + 32 * k);
    g[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (2 * k < run && i < count) {
      if (vec) {
        g[k] = __ldcs(reinterpret_cast<const float4*>(g2 + i));
      } else {
        const float2 a = __ldcs(g2 + i);
        const float2 b = i + 1 < count ? __ldcs(g2 + i + 1) : a;
        g[k] = make_float4(a.x, a.y, b.x, b.y);
      }
    }
  }

  // ---- 2. the image's map, staged in shared memory (C = 3: its pixels as
  // RGBx in f32; any other C: the 16-byte window that holds it), or read
  // where it lies
  const T* taps = img + (size_t)n * H * W * C;
  const float4* m3 = nullptr;
  if constexpr (kTapsShared) {
    if constexpr (kC == 3) {
      float4* m = reinterpret_cast<float4*>(fwd_smem);
      for (int p = tid; p < H * W; p += blockDim.x) {
        const T* px = taps + 3 * (size_t)p;
        m[p] = make_float4(load1(px, 0), load1(px, 1), load1(px, 2), 0.f);
      }
      m3 = m;
    } else {
      const Window16 w = window16(taps, (size_t)H * W * C * sizeof(T));
      uint4* dst = reinterpret_cast<uint4*>(fwd_smem);
      for (int i = tid; i < w.words; i += blockDim.x)
        dst[i] = __ldg(w.lo + i);
      taps = reinterpret_cast<const T*>(fwd_smem + w.skew);
    }
    __syncthreads();
  }

  // ---- 3. the samples. C = 1: a pair's two outputs in one store (a warp
  // writes a whole line); C = 3: through the warp's tile; any other odd C
  // a channel at a time
  T* dst = out + s0 * C;
  T* tile = reinterpret_cast<T*>(fwd_smem + stage_off +
                                 warp * tile_bytes(run, 3, sizeof(T)) +
                                 (reinterpret_cast<uintptr_t>(dst) & 15));
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int i = 2 * (lane + 32 * k);
    if (2 * k < run && i < count) {
      const bool second = i + 1 < count;
      const BilinearTaps t0 = bilinear_taps(g[k].x, g[k].y, H, W);
      const BilinearTaps t1 = bilinear_taps(g[k].z, g[k].w, H, W);
      if constexpr (kC == 1) {
        const float a = tap_sum(taps, t0, 1, 0);
        const float b = tap_sum(taps, t1, 1, 0);
        if (vec && second) {
          store2(dst + i, 0, a, b);
        } else {
          store1(dst, i, a);
          if (second) store1(dst, i + 1, b);
        }
      } else if constexpr (kC == 3) {
        const float3 a = kTapsShared ? tap_sum(m3, t0) : tap_sum3(taps, t0);
        const float3 b = kTapsShared ? tap_sum(m3, t1) : tap_sum3(taps, t1);
        T* o = tile + i * 3;
        store1(o, 0, a.x);
        store1(o, 1, a.y);
        store1(o, 2, a.z);
        store1(o, 3, b.x);
        store1(o, 4, b.y);
        store1(o, 5, b.z);
      } else {
        T* o = dst + (size_t)i * C;
        for (int c = 0; c < C; ++c) {
          store1(o, c, tap_sum(taps, t0, C, c));
          if (second) store1(o + C, c, tap_sum(taps, t1, C, c));
        }
      }
    }
  }
  if constexpr (kC == 3) {
    __syncwarp();
    store_tile(dst, tile, count * 3 * (int)sizeof(T), lane);
  }
}

struct FwdPlan {
  int narrow, taps_shared, run, threads, blocks, smem;
};

// Kernel 8's plan for N images of H x W x C elements of elt bytes and npix
// samples each, on the current device. Even C: a warp a sample,
// kPixPerBlock samples a CTA. Odd C (above): runs of kFwdMaxRun samples a
// lane, halved (to 2) while the runs would not fill kFillWarps an SM; an
// image's runs over the fewest CTAs of at most kFwdMaxWarps warps, split
// evenly; the map staged where it fits kMapSmemMax as staged; a warp's
// output tile at C = 3. cudaErrorInvalidValue where the grid overflows.
int fwd_plan(int N, int H, int W, int C, int npix, int elt, FwdPlan& p) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || npix < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  p = FwdPlan{};
  long long ctas;
  if (!(C & 1)) {
    p.threads = kThreads;
    ctas = (npix + kPixPerBlock - 1) / kPixPerBlock;
    if (ctas * N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.blocks = (int)(ctas * N);
    return 0;
  }
  int dev, sms;
  TPK_TRY((int)cudaGetDevice(&dev));
  TPK_TRY((int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev));
  p.narrow = 1;
  const size_t staged = staged_bytes(H, W, C, elt);
  p.taps_shared = staged <= (size_t)kMapSmemMax;
  const auto warp_runs = [&](int run) {
    return ((long long)npix + 32 * run - 1) / (32 * run);
  };
  p.run = kFwdMaxRun;
  while (p.run > 2 && N * warp_runs(p.run) < (long long)sms * kFillWarps)
    p.run /= 2;
  ctas = (warp_runs(p.run) + kFwdMaxWarps - 1) / kFwdMaxWarps;
  const int warps = (int)((warp_runs(p.run) + ctas - 1) / ctas);
  p.threads = 32 * warps;
  p.smem = (p.taps_shared ? (int)staged : 0) +
           (C == 3 ? warps * tile_bytes(p.run, 3, elt) : 0);
  if (ctas * N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.blocks = (int)(ctas * N);
  return 0;
}

template <typename T, int kC>
int launch_fwd_narrow(const void* img, const float* grid, void* out, int N,
                      int H, int W, int C, int npix, const FwdPlan& p,
                      cudaStream_t s) {
  auto kernel = p.taps_shared ? grid_sample_fwd_narrow_kernel<T, kC, true>
                              : grid_sample_fwd_narrow_kernel<T, kC, false>;
  // the tiles of three f32 channels beside a staged map
  if (p.smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           p.smem) != cudaSuccess)
    return (int)cudaGetLastError();
  const int stage_off =
      p.taps_shared ? (int)staged_bytes(H, W, C, sizeof(T)) : 0;
  kernel<<<dim3(p.blocks / N, N), p.threads, p.smem, s>>>(
      (const T*)img, grid, (T*)out, H, W, C, npix, p.run, stage_off);
  return 0;
}

template <typename T>
int launch_fwd(const void* img, const float* grid, void* out, int N, int H,
               int W, int C, int npix, const FwdPlan& p, cudaStream_t s) {
  if (!p.narrow) {
    grid_sample_fwd_kernel<T><<<dim3(p.blocks / N, N), p.threads, 0, s>>>(
        (const T*)img, grid, (T*)out, H, W, C, npix);
    return 0;
  }
  if (C == 1)
    return launch_fwd_narrow<T, 1>(img, grid, out, N, H, W, C, npix, p, s);
  if (C == 3)
    return launch_fwd_narrow<T, 3>(img, grid, out, N, H, W, C, npix, p, s);
  return launch_fwd_narrow<T, 0>(img, grid, out, N, H, W, C, npix, p, s);
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
// loops that a shared-memory f32 atomicAdd compiles to on Hopper (the
// sm_90a SASS has no native shared f32 add: ATOMS.CAST.SPIN in a loop, as
// the tool's SASS count shows), one after another. So a CTA has 16 warps,
// two CTAs an SM, with few samples each in flight (the registers of two
// 512-thread CTAs allow 64 a thread): more warps hide more of the wait than
// 8 with more samples each.
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

// ---- kernels 9 and 10 at an odd C: the narrow path ----------------------
//
// At an odd C the slab is all of C, and a band of a small map is small
// (12.8 KB for a 32x100 crop of one channel; 132 B for MORAN's 3x11 offset
// map). One CTA an image would leave most of the card idle (B=64 images
// on 132 SMs), a thread a sample would wait on its samples' loads in
// series, and the upsampled offset maps would send thousands of atomics
// an image to a few dozen addresses. So:
//   * a cluster of `cluster` CTAs takes one image's band: CTA r of the
//     cluster takes the r-th share of the image's samples, so no sample is
//     read twice, and every CTA sums into its own copy of the band. The
//     plan takes clusters of 2 while there are fewer (image, band) pairs
//     than SMs, else of 1 (below);
//   * a thread takes a contiguous run of samples along the rows, loads a
//     piece of kRun of them (grid and cotangent; kernel 9 one sample at a
//     time, its four image taps with it) all in flight at once, and adds
//     their weighted cotangents into registers: a 2x2 window of taps at
//     (x0, y0). The window carries over while the samples' near tap
//     stays, slides by a column when x0 steps by one (its left column is
//     added to the band), and is added whole when the taps jump.
//     Upsampled maps keep one window over 9-16 samples; a 1:1 warp adds
//     two taps a sample, not four; zero terms (the taps of a pixel centre,
//     the border) are not added at all;
//   * where the band has few elements (`private`: a copy for each thread
//     fits shared memory, as MORAN's 33 and SPIN's 48 do), each thread adds
//     into its own copy with plain adds and no atomic, and the CTA sums the
//     copies after; elsewhere the threads share one copy and add with
//     shared-memory atomics, each a compare-and-swap loop (above);
//   * d_img is written whole in the one launch, with no zero pass before
//     it: each CTA first zeroes its 1/cluster slice of the band in d_img and
//     arrives on the cluster's barrier, and waits on it only when its own
//     copy is summed; then it adds the copy to d_img by global reductions
//     (RED, 16 bytes each where aligned) that no thread waits on. The
//     barrier's latency hides behind the samples, and no CTA reads
//     another's shared memory, so none waits for another to finish.
// A tall map whose band of all rows does not fit takes several bands, a
// cluster each, each scanning its image's samples for those that meet it;
// kernel 9's d_grid is written by the band that holds y0, from the CTA
// whose share holds the sample: one writer.
//
// What bounds it (tools/grid_sample_variants.py --shape crnn_tps | moran |
// spin [--batch N], device time by CUDA graph on an H100 80GB HBM3 at
// 700.00 W; the breakdown by phase is in PERF.md section 6): every bound
// is under a microsecond, and an empty kernel of this grid takes 1.3 us.
// At a near 1:1 warp (CRNN-TPS's crops on the config's initial grid) a
// thread adds ~2.5 taps a sample to the shared band, each a
// compare-and-swap loop; those and the samples' loads take most of the
// ~10-11 us, the zeroing, the barrier and the reductions ~3 us. Measured
// and not kept: the copies summed through distributed shared memory
// between two cluster barriers, ~0.5 us slower; a global reduction for
// every tap and no shared band, ~3 us slower; clusters of 4 CTAs, or CTAs
// of 256 threads, slower at all three shapes; 8 samples in flight in
// kernel 10, 6-8 us slower from B=100 up (registers); clusters of 2 at
// B=140, ~5 us slower than 1 (at B=100 they tie, at B=64 2 is ~1 us
// faster); 2 or 4 samples in flight in kernel 9, up to 0.6 us slower at
// B=64 and 1.5-8 us from B=140 up.
constexpr int kNarrowThreads = 512;
constexpr int kMaxCluster = 2;
// samples a thread has in flight (kernel 9 also holds their image taps)
template <bool kWithGrid>
constexpr int kRun = kWithGrid ? 1 : 4;

// Adds v to element i of the band: to this thread's own copy (private: the
// copies interleaved, element-major, so a warp's adds fall in 32 banks) or
// to the CTA's one copy by a shared-memory atomic.
static __device__ __forceinline__ void band_add(float* acc, int i, float v,
                                                bool priv) {
  if (priv)
    acc[i * kNarrowThreads + threadIdx.x] += v;
  else
    atomicAdd(acc + i, v);
}

// Adds a column of the window, its taps at (x, y) and (x, yb), to the rows
// of the band [r0, r0 + nrows) that hold them; zero terms are not added.
template <int G>
static __device__ __forceinline__ void add_column(
    float* acc, const float (&top)[G], const float (&bottom)[G], int x,
    int y, int yb, int r0, int nrows, int W, int C, int c0, bool priv) {
  const bool in_top = (unsigned)(y - r0) < (unsigned)nrows;
  const bool in_bottom = (unsigned)(yb - r0) < (unsigned)nrows;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (in_top && top[g] != 0.f)
      band_add(acc, ((y - r0) * W + x) * C + c0 + g, top[g], priv);
    if (in_bottom && bottom[g] != 0.f)
      band_add(acc, ((yb - r0) * W + x) * C + c0 + g, bottom[g], priv);
  }
}

// kC: the channels, 1 or 3 (unrolled, all in one pass), or 0 for any other
// odd C (one channel a pass over the samples).
template <typename T, bool kWithGrid, int kC>
__global__ void __launch_bounds__(kNarrowThreads)
grid_sample_bwd_narrow_kernel(const float* __restrict__ grid,  // (N, npix, 2)
                              const T* __restrict__ cot,       // (N, npix, C)
                              const T* __restrict__ img,       // (N, H, W, C)
                              float* __restrict__ d_img,       // (N, H, W, C)
                              float* __restrict__ d_grid,      // (N, npix, 2)
                              int H, int W, int C_, int npix, int rows,
                              int priv) {
  // (rows, W, C) f32: one copy, or kNarrowThreads interleaved copies
  extern __shared__ __align__(16) float acc[];
  constexpr int G = kC ? kC : 1;  // channels a pass
  constexpr int kR = kRun<kWithGrid>;
  const int C = kC ? kC : C_;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int bands = (H + rows - 1) / rows;
  const int cid = blockIdx.x / k, band = cid % bands, n = cid / bands;
  const int r0 = band * rows, nrows = min(rows, H - r0);
  const int elems = nrows * W * C, tid = threadIdx.x;
  float* dst = d_img + ((size_t)n * H * W + (size_t)r0 * W) * C;
  const bool vec = (elems & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(dst) & 15) == 0;

  // ---- 1. zero the band (a private copy is this thread's alone)
  if (priv) {
    for (int e = 0; e < elems; ++e) acc[e * kNarrowThreads + tid] = 0.f;
  } else {
    for (int e = tid; e < elems / 4; e += kNarrowThreads)
      reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = (elems & ~3) + tid; e < elems; e += kNarrowThreads)
      acc[e] = 0.f;
    __syncthreads();
  }
  // and this CTA's slice of the band in d_img; the cluster's barrier
  // orders the zeros before every CTA's adds (step 4), and is waited on
  // only there, so its latency hides behind the samples
  {
    const int per = ((elems + k - 1) / k + 3) & ~3;
    const int e_lo = min(rank * per, elems), e_hi = min(e_lo + per, elems);
    if (vec) {
      for (int e = e_lo / 4 + tid; e < e_hi / 4; e += kNarrowThreads)
        reinterpret_cast<float4*>(dst)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int e = e_lo + tid; e < e_hi; e += kNarrowThreads) dst[e] = 0.f;
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  // ---- 2. this CTA's share of the image's samples, a run a thread
  const int p_lo = (int)((long long)npix * rank / k);
  const int p_hi = (int)((long long)npix * (rank + 1) / k);
  const int run = (p_hi - p_lo + kNarrowThreads - 1) / kNarrowThreads;
  const int p_begin = min(p_lo + tid * run, p_hi);
  const int p_end = min(p_begin + run, p_hi);
  const float2* gr = reinterpret_cast<const float2*>(grid) + (size_t)n * npix;
  const T* co_n = cot + (size_t)n * npix * C;
  const T* im = kWithGrid ? img + (size_t)n * H * W * C : nullptr;

  for (int c0 = 0; c0 < C; c0 += G) {
    // the window: taps (y0, x0), (y0, x1), (y1, x0), (y1, x1) at (wx, wy)
    float a[4][G];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int g = 0; g < G; ++g) a[j][g] = 0.f;
    int wx = -2, wy = -1;
    // adds the window's left (col 0) or right (col 1) column to the band
#define TPK_FLUSH(col)                                                    \
  add_column<G>(acc, a[col], a[2 + col],                                  \
                (col) ? min(wx + 1, W - 1) : wx, wy, min(wy + 1, H - 1), \
                r0, nrows, W, C, c0, priv)
    for (int p0 = p_begin; p0 < p_end; p0 += kR) {
      // the piece's loads, all in flight; past the run's end the run's
      // last sample again, added to nothing
      float2 gv[kR];
      float v[kR][G];
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const int p = min(p0 + u, p_end - 1);
        gv[u] = gr[p];
#pragma unroll
        for (int g = 0; g < G; ++g)
          v[u][g] = load1(co_n + (size_t)p * C, c0 + g);
      }
      BilinearTaps t[kR];
#pragma unroll
      for (int u = 0; u < kR; ++u)
        t[u] = bilinear_taps(gv[u].x, gv[u].y, H, W);
      if constexpr (kWithGrid) {
        if (c0 == 0) {
          // d_grid sums over every channel; the band that holds y0 writes
          // it (the image taps of every sample are loaded, so that the
          // piece's loads are in flight together)
          float sx[kR], sy[kR];
#pragma unroll
          for (int u = 0; u < kR; ++u) {
            sx[u] = sy[u] = 0.f;
            const T* co = co_n + (size_t)min(p0 + u, p_end - 1) * C;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float vc = c < G ? v[u][kC ? c : 0] : load1(co, c);
              const float av = load1(im + (size_t)t[u].o00 * C, c);
              const float bv = load1(im + (size_t)t[u].o01 * C, c);
              const float ev = load1(im + (size_t)t[u].o10 * C, c);
              const float dv = load1(im + (size_t)t[u].o11 * C, c);
              const float wx = t[u].wx, wy = t[u].wy;
              sx[u] += vc * ((1.f - wy) * (bv - av) + wy * (dv - ev));
              sy[u] += vc * ((1.f - wx) * (ev - av) + wx * (dv - bv));
            }
          }
#pragma unroll
          for (int u = 0; u < kR; ++u) {
            if (p0 + u >= p_end ||
                (unsigned)(t[u].y0 - r0) >= (unsigned)nrows)
              continue;
            const float gx = (gv[u].x + 1.f) * 0.5f * (float)(W - 1);
            const float gy = (gv[u].y + 1.f) * 0.5f * (float)(H - 1);
            const bool in_x = gx >= 0.f && gx <= (float)(W - 1);
            const bool in_y = gy >= 0.f && gy <= (float)(H - 1);
            reinterpret_cast<float2*>(d_grid)[(size_t)n * npix + p0 + u] =
                make_float2(in_x ? sx[u] * (0.5f * (float)(W - 1)) : 0.f,
                            in_y ? sy[u] * (0.5f * (float)(H - 1)) : 0.f);
          }
        }
      }
      // ---- the window: carry, slide or add
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        if (p0 + u >= p_end) break;
        if (t[u].y0 != wy || (t[u].x0 != wx && t[u].x0 != wx + 1)) {
          TPK_FLUSH(0);
          TPK_FLUSH(1);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int g = 0; g < G; ++g) a[j][g] = 0.f;
          wx = t[u].x0;
          wy = t[u].y0;
        } else if (t[u].x0 == wx + 1) {
          TPK_FLUSH(0);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            a[0][g] = a[1][g];
            a[2][g] = a[3][g];
            a[1][g] = a[3][g] = 0.f;
          }
          wx = t[u].x0;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          a[0][g] += t[u].w00 * v[u][g];
          a[1][g] += t[u].w01 * v[u][g];
          a[2][g] += t[u].w10 * v[u][g];
          a[3][g] += t[u].w11 * v[u][g];
        }
      }
    }
    TPK_FLUSH(0);
    TPK_FLUSH(1);
#undef TPK_FLUSH
  }

  // ---- 3. every CTA adds its copy of the band to d_img: reductions
  // (RED) that no thread waits on; the private copies summed over the CTA
  // first, a warp an element
  __syncthreads();
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (priv) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int e = warp; e < elems; e += kNarrowThreads / 32) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kNarrowThreads / 32; ++j)
        s += acc[e * kNarrowThreads + j * 32 + lane];
      s = warp_sum(s);
      if (lane == 0) atomicAdd(dst + e, s);
    }
  } else if (vec) {
    for (int e = tid; e < elems / 4; e += kNarrowThreads)
      atomicAdd(reinterpret_cast<float4*>(dst) + e,
                reinterpret_cast<const float4*>(acc)[e]);
  } else {
    for (int e = tid; e < elems; e += kNarrowThreads)
      atomicAdd(dst + e, acc[e]);
  }
}

struct BwdPlan {
  int rows, slab, ctas_per_sm, blocks, cluster, priv;
  size_t smem;
};

// The plan on the current device. Even C: the widest slab (an even divisor
// of C) of which one row fits kMinCtasPerSm CTAs an SM (C unless a row of C
// is too wide), then as many rows as fit beside it; a CTA a band. Odd C
// (the narrow path): the slab all of C, as many rows as fit, the band
// private where a copy for each thread fits, and clusters of 1 or 2 CTAs
// a band: 2 while there are fewer (image, band) pairs than SMs.
// cudaErrorInvalidValue where none fits or the CTAs overflow a 1-D grid.
int bwd_plan(int N, int H, int W, int C, BwdPlan& p) {
  if (N < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  int dev, per_sm, per_block, reserved, sms;
  TPK_TRY((int)cudaGetDevice(&dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev));
  TPK_TRY((int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev));
  const size_t budget =
      (size_t)std::min(per_block, per_sm / kMinCtasPerSm - reserved);
  long long blocks;
  if (C & 1) {
    const size_t row = (size_t)W * C * sizeof(float);
    p.slab = C;
    if (row > budget) return (int)cudaErrorInvalidValue;
    p.rows = (int)std::min<size_t>(H, budget / row);
    const int bands = (H + p.rows - 1) / p.rows;
    p.priv = row * p.rows * kNarrowThreads <= budget;
    p.smem = row * p.rows * (p.priv ? kNarrowThreads : 1);
    p.cluster = 1;
    while (p.cluster < kMaxCluster && (long long)N * bands * p.cluster < sms)
      p.cluster *= 2;
    p.ctas_per_sm = std::min(2048 / kNarrowThreads,
                             per_sm / (int)(p.smem + reserved));
    blocks = (long long)N * bands * p.cluster;
  } else {
    for (p.slab = C; p.slab >= 2; p.slab -= 2)
      if (C % p.slab == 0 && bwd_smem(1, W, p.slab) <= budget) break;
    if (p.slab < 2) return (int)cudaErrorInvalidValue;
    p.rows = 1;
    while (p.rows < H && bwd_smem(p.rows + 1, W, p.slab) <= budget) ++p.rows;
    p.smem = bwd_smem(p.rows, W, p.slab);
    p.cluster = 1;
    p.priv = 0;
    p.ctas_per_sm = std::min(2048 / kBwdThreads,
                             per_sm / (int)(p.smem + reserved));
    blocks = (long long)N * ((H + p.rows - 1) / p.rows) * (C / p.slab);
  }
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

// The path of an even C (channel pairs, listed samples).
template <typename T, bool kWithGrid>
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

  // ---- 4. store the band, once
  __syncthreads();
  float* dst = d_img + ((size_t)n * H * W + lo) * C + 2 * c2_lo;
  if (slab == C && elems % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int e = tid; e < elems / 4; e += kBwdThreads)
      reinterpret_cast<float4*>(dst)[e] =
          reinterpret_cast<const float4*>(acc)[e];
  } else {
    for (int e = tid; e < span * pairs; e += kBwdThreads) {
      const int px = e / pairs, c2 = e - px * pairs;
      reinterpret_cast<float2*>(dst + (size_t)px * C)[c2] =
          reinterpret_cast<const float2*>(acc + (size_t)px * slab)[c2];
    }
  }
}

// Writes {rows, slab, CTAs an SM, blocks, shared memory bytes, cluster,
// private} to plan.
void report(const BwdPlan& p, int* plan) {
  if (!plan) return;
  plan[0] = p.rows;
  plan[1] = p.slab;
  plan[2] = p.ctas_per_sm;
  plan[3] = p.blocks;
  plan[4] = (int)p.smem;
  plan[5] = p.cluster;
  plan[6] = p.priv;
}

// The narrow path's launch: clusters of p.cluster CTAs along x. A launch
// the device refuses returns its error; nothing falls back.
template <typename T, bool kWithGrid>
int launch_narrow(const float* grid, const void* cot, const void* img,
                  float* d_img, float* d_grid, int H, int W, int C, int npix,
                  const BwdPlan& p, cudaStream_t s) {
  auto kernel = C == 1   ? grid_sample_bwd_narrow_kernel<T, kWithGrid, 1>
                : C == 3 ? grid_sample_bwd_narrow_kernel<T, kWithGrid, 3>
                         : grid_sample_bwd_narrow_kernel<T, kWithGrid, 0>;
  if (p.smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem) != cudaSuccess)
    return (int)cudaGetLastError();
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(kNarrowThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, grid, (const T*)cot, (const T*)img, d_img, d_grid, H, W,
      C, npix, p.rows, p.priv);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return 0;
}

template <typename T, bool kWithGrid>
int launch_typed(const float* grid, const void* cot, const void* img,
                 float* d_img, float* d_grid, int H, int W, int C, int npix,
                 const BwdPlan& p, cudaStream_t s) {
  if (C & 1)
    return launch_narrow<T, kWithGrid>(grid, cot, img, d_img, d_grid, H, W,
                                       C, npix, p, s);
  auto kernel = grid_sample_bwd_kernel<T, kWithGrid>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)p.smem);
  kernel<<<p.blocks, kBwdThreads, p.smem, s>>>(grid, (const T*)cot,
                                            (const T*)img, d_img, d_grid, H,
                                            W, C, npix, p.rows, p.slab);
  return 0;
}

template <bool kWithGrid>
int launch_bwd(const float* grid, const void* cot, const void* img,
               float* d_img, float* d_grid, int N, int H, int W, int C,
               int npix, int is_bf16, int* plan, cudaStream_t s) {
  BwdPlan p;
  TPK_TRY(bwd_plan(N, H, W, C, p));
  if (is_bf16)
    TPK_TRY((launch_typed<bf16, kWithGrid>(grid, cot, img, d_img, d_grid, H,
                                           W, C, npix, p, s)));
  else
    TPK_TRY((launch_typed<float, kWithGrid>(grid, cot, img, d_img, d_grid, H,
                                            W, C, npix, p, s)));
  TPK_CHECK();
  report(p, plan);
  return 0;
}

}  // namespace

// is_bf16 selects the element type of img / cot / out: 1 = bf16, 0 = f32.
extern "C" int tpk_grid_sample_fwd(const void* img, const float* grid,
                                   void* out, int N, int H, int W, int C,
                                   int npix, int is_bf16, void* stream) {
  FwdPlan p;
  TPK_TRY(fwd_plan(N, H, W, C, npix, is_bf16 ? 2 : 4, p));
  cudaStream_t s = (cudaStream_t)stream;
  TPK_TRY(is_bf16 ? launch_fwd<bf16>(img, grid, out, N, H, W, C, npix, p, s)
                  : launch_fwd<float>(img, grid, out, N, H, W, C, npix, p,
                                      s));
  TPK_CHECK();
  return 0;
}

// Kernel 8's plan at this shape on the current device: plan = {1 on the
// narrow (odd-C) path, 1 where the map is staged in shared memory, samples
// a lane, threads a CTA, CTAs, shared memory bytes of a CTA}.
// cudaErrorInvalidValue where none fits.
extern "C" int tpk_grid_sample_fwd_plan(int N, int H, int W, int C, int npix,
                                        int is_bf16, int* plan) {
  FwdPlan p;
  TPK_TRY(fwd_plan(N, H, W, C, npix, is_bf16 ? 2 : 4, p));
  const int v[] = {p.narrow, p.taps_shared, p.run, p.threads, p.blocks,
                   p.smem};
  memcpy(plan, v, sizeof(v));
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
// a CTA, CTAs a cluster, 1 where each thread sums into its own copy of the
// band}. cudaErrorInvalidValue where none fits.
extern "C" int tpk_grid_sample_plan(int N, int H, int W, int C, int* plan) {
  BwdPlan p;
  TPK_TRY(bwd_plan(N, H, W, C, p));
  report(p, plan);
  return 0;
}
