// The fused stem's kernels in the (C, P) layout: a BasicBlock with its
// BatchNorms folded (kernel 12) and a 3x3 SAME convolution (kernel 11).
//
// Replace the TPU kernels tps_pp_tpu/ops/pallas_stem.py `_block_kernel`
// (basic_block_cp) and `_conv3x3_kernel` (conv3x3_cp). Activations are
// (C, P) with P = N*H*W the flat pixel index, w fastest; tap weights are
// (C_out, 9*C) with the taps (dy, dx) row-major and C fastest. Contract:
//   kernel 12: y = round(relu(w1 @ t + b1)) (zero outside the image: SAME
//              padding), z = wt @ taps(y) + b2,
//              out = round(relu(z + t)) if residual else round(z);
//   kernel 11: out = round(relu?(wt @ taps(x) + b)),
// with f32 accumulation and the rounding points of the TPU kernels.
//
// The TPU stacks the nine lane-rolled, masked taps of a whole batch block
// into one (9C, P) VMEM operand. Here both kernels keep a window of input
// rows in shared memory, pixel-major with a zero column on either side, and
// run the 3x3 as an implicit GEMM: each tap is the same window read at a
// pixel offset of dy*(W+2) + dx, so the nine taps cost no copies.
//
// bf16 (both kernels): band_kernel below, persistent blocks that walk bands
// of output rows, the weights loaded once a block, the input rows copied by
// cp.async into a ring ahead of use, each input row read and (kernel 12) its
// first stage computed once a walk, mma.sync on the tensor cores, 16-byte
// output stores.
//
// float32 (both kernels): stem_kernel, on the CUDA cores (no TF32), one
// block per (image, band of R = 256 / W output rows), one thread per
// (pixel, 8 output channels), weights read through L1. It copies the R + 2
// input rows it needs (zero outside the image) into shared memory, pixel
// major, 16-byte loads with eight in flight a thread; kernel 12 computes y
// for those rows there (halo rows twice, once in each band that reads
// them); kernel 11 loads its input straight into the window.
//
// Bound on the H100, at the flagship's shapes (B=512): layer1's block and
// the 3x3 at (32, 2^21) move ~268 MB and do ~39-43 GFLOP, bound by bytes
// (~0.080 ms); layer2's block0 (32 -> 64 -> 64 at full resolution) does
// ~163 GFLOP and its blocks 1-3 ~43 GFLOP over 134 MB, bound by operations
// (~0.165 and ~0.043 ms).
//
// Limits (cudaErrorInvalidValue otherwise): every channel count a multiple
// of 16, W a multiple of 16, C_out == C_in with `residual`, 16-byte
// aligned activations and weights, and a plan within the shared memory
// (float32: one row of W pixels; bf16: band_plan).
#include <algorithm>

#include "common.cuh"
#include "ptx.cuh"

namespace {

// ---- float32: stem_kernel -------------------------------------------------
constexpr int kThreads = 256;  // 8 warps
constexpr int kBandPixels = 256;  // output pixels per block, R = 256 / W
constexpr int kInFlight = 8;      // 16-byte loads in flight per thread
constexpr size_t kMaxSmem = 227 * 1024;

// Elements per pixel row of a pixel-major f32 tile of C channels: padded by
// 1 (one thread per pixel reads a channel column).
__host__ __device__ constexpr int pix_stride(int C) { return C + 1; }

// Rows hbeg .. hbeg+nrows-1 of image n of src (C, P) into the pixel-major
// tile dst: pixel (r, w) at dst[(r * pitch + col0 + w) * S + c], zero for
// rows outside the image. 16-byte vectors along w, channels fastest across
// the threads (conflict-free stores), kInFlight loads issued before the
// first store.
__device__ void load_rows(const float* __restrict__ src, int C, size_t P,
                          int n, int H, int W, int hbeg, int nrows,
                          float* dst, int pitch, int col0, int S) {
  constexpr int V = 4;
  const int wv = W / V, nvec = nrows * wv * C;
  for (int e0 = threadIdx.x; e0 < nvec; e0 += kInFlight * blockDim.x) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < nvec) {
        const int c = e % C, rest = e / C, h = hbeg + rest / wv;
        if (h >= 0 && h < H)
          v[u] = __ldg(reinterpret_cast<const uint4*>(
                           src + (size_t)c * P + ((size_t)n * H + h) * W) +
                       rest % wv);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < nvec) {
        const int c = e % C, rest = e / C;
        const int r = rest / wv, w0 = (rest % wv) * V;
        float* d = dst + ((size_t)r * pitch + col0 + w0) * S + c;
        d[0] = __uint_as_float(v[u].x);
        d[S] = __uint_as_float(v[u].y);
        d[2 * S] = __uint_as_float(v[u].z);
        d[3 * S] = __uint_as_float(v[u].w);
      }
    }
  }
}

// The zero columns left and right of the y tile (SAME padding in w).
__device__ void zero_edge_columns(float* ys, int nrows, int W, int S) {
  for (int e = threadIdx.x; e < nrows * 2 * S; e += blockDim.x) {
    const int r = e / (2 * S), side = (e / S) & 1, c = e % S;
    ys[((size_t)r * (W + 2) + side * (W + 1)) * S + c] = 0.f;
  }
}

// ---- first stage: y = relu(w1 @ t + b1), rows hbeg .. hbeg+nrows-1 ------
__device__ void stage1(const float* ts, int SI, const float* __restrict__ w1,
                       const float* __restrict__ b1, int C_in, int C_mid,
                       float* ys, int SM, int H, int W, int hbeg, int nrows) {
  const int npix = nrows * W;
  for (int e = threadIdx.x; e < npix * (C_mid / 8); e += blockDim.x) {
    const int qp = e % npix, c0 = (e / npix) * 8;
    const int r = qp / W, w = qp % W, h = hbeg + r;
    const bool live = h >= 0 && h < H;
    float acc[8] = {};
    if (live)
      for (int k = 0; k < C_in; ++k) {
        const float v = ts[(size_t)qp * SI + k];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[j] += __ldg(w1 + (size_t)(c0 + j) * C_in + k) * v;
      }
    float* dst = ys + ((size_t)r * (W + 2) + w + 1) * SM + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = live ? fmaxf(acc[j] + b1[c0 + j], 0.f) : 0.f;
  }
}

// ---- second stage: out = epilogue(wt @ taps(y) + b2) for the R output rows
// h0 .. h0+R-1; ts (residual) holds t for rows h0-1 .. h0+R ------------------
__device__ void stage2(const float* ys, int SM, const float* __restrict__ wt,
                       const float* __restrict__ b2, int C_mid, int C_out,
                       const float* ts, int SI, int residual, int relu,
                       float* __restrict__ out, size_t P, int n, int H, int W,
                       int h0, int R) {
  const int K = 9 * C_mid, npix = R * W;
  for (int e = threadIdx.x; e < npix * (C_out / 8); e += blockDim.x) {
    const int qp = e % npix, c0 = (e / npix) * 8;
    if (h0 + qp / W >= H) continue;
    const int ctr = (qp / W + 1) * (W + 2) + qp % W + 1;
    float acc[8] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const float* src = ys + (size_t)(ctr + (tap / 3 - 1) * (W + 2) +
                                       tap % 3 - 1) * SM;
      const float* wk = wt + (size_t)c0 * K + tap * C_mid;
      for (int k = 0; k < C_mid; ++k) {
        const float v = src[k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += __ldg(wk + (size_t)j * K + k) * v;
      }
    }
    const size_t pix = ((size_t)n * H + h0) * W + qp;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[j] + b2[c0 + j];
      if (residual)
        v = fmaxf(v + ts[(size_t)(qp + W) * SI + c0 + j], 0.f);
      else if (relu)
        v = fmaxf(v, 0.f);
      out[(size_t)(c0 + j) * P + pix] = v;
    }
  }
}

// Shared memory of one block, in floats: [ts (kernel 12 only)] [ys].
template <bool kBlock>
struct StemSmem {
  size_t ts, ys;
  __host__ __device__ StemSmem(int C_in, int C_mid, int W, int R) {
    ts = kBlock ? (size_t)(R + 2) * W * pix_stride(C_in) : 0;
    ys = (size_t)(R + 2) * (W + 2) * pix_stride(C_mid);
  }
  __host__ __device__ size_t bytes() const {
    return (ts + ys) * sizeof(float);
  }
};

// One block: image blockIdx.x / bands, output rows h0 .. h0+R-1.
// kBlock: kernel 12 (src = t, both stages); else kernel 11 (src = x, C_mid
// = its channels, second stage only; w1, b1 unused).
template <bool kBlock>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ src, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ wt,
            const float* __restrict__ b2, float* __restrict__ out, int C_in,
            int C_mid, int C_out, int N, int H, int W, int R, int residual,
            int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bands = (H + R - 1) / R;
  const int n = blockIdx.x / bands, h0 = (blockIdx.x % bands) * R;
  const size_t P = (size_t)N * H * W;
  const int SI = pix_stride(C_in), SM = pix_stride(C_mid);
  const StemSmem<kBlock> lay(C_in, C_mid, W, R);
  float* ts = reinterpret_cast<float*>(smem_raw);
  float* ys = ts + lay.ts;
  zero_edge_columns(ys, R + 2, W, SM);
  if (kBlock) {
    load_rows(src, C_in, P, n, H, W, h0 - 1, R + 2, ts, W, 0, SI);
    __syncthreads();
    stage1(ts, SI, w1, b1, C_in, C_mid, ys, SM, H, W, h0 - 1, R + 2);
  } else {
    load_rows(src, C_mid, P, n, H, W, h0 - 1, R + 2, ys, W + 2, 1, SM);
  }
  __syncthreads();
  stage2(ys, SM, wt, b2, C_mid, C_out, ts, SI, residual, relu, out, P, n, H,
         W, h0, R);
}

// The limits common to both routes and both kernels.
bool outside_limits(const void* src, const void* w1, const void* wt,
                    const void* out, int C_in, int C_mid, int C_out, int N,
                    int H, int W, int residual) {
  return C_in % 16 || C_mid % 16 || C_out % 16 || C_in <= 0 || C_mid <= 0 ||
         C_out <= 0 || W % 16 || W <= 0 || H <= 0 || N <= 0 ||
         (residual && C_out != C_in) ||
         ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(w1) |
           reinterpret_cast<uintptr_t>(wt) | reinterpret_cast<uintptr_t>(out)) &
          15);
}

template <bool kBlock>
int launch_stem(const float* src, const float* w1, const float* b1,
                const float* wt, const float* b2, float* out, int C_in,
                int C_mid, int C_out, int N, int H, int W, int residual,
                int relu, cudaStream_t s) {
  if (outside_limits(src, w1, wt, out, C_in, C_mid, C_out, N, H, W, residual))
    return (int)cudaErrorInvalidValue;
  int R = std::min(H, std::max(1, kBandPixels / W));
  while (R > 1 && StemSmem<kBlock>(C_in, C_mid, W, R).bytes() > kMaxSmem) --R;
  const size_t smem = StemSmem<kBlock>(C_in, C_mid, W, R).bytes();
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = stem_kernel<kBlock>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  TPK_CHECK();
  const int blocks = N * ((H + R - 1) / R);
  kernel<<<blocks, kThreads, smem, s>>>(src, w1, b1, wt, b2, out, C_in, C_mid,
                                        C_out, N, H, W, R, residual, relu);
  TPK_CHECK();
  return 0;
}

// ---- bf16: band_kernel, persistent blocks over bands of output rows ------
// The output rows of the batch are cut into groups: group g is image
// g / bands and rows h0 .. h0+cnt-1, h0 = (g % bands) * R, cnt =
// min(R, H - h0). Block b takes groups [b*G/grid, (b+1)*G/grid) and walks
// them in order. A group needs input rows h0-1 .. h0+cnt (zero outside the
// image); when the block's previous group is the band above in the same
// image, its last two are already in the window, so a walk reads each
// input row once, plus two halo rows where it enters an image.
//
// Shared memory, bf16 unless noted (C_in = C_mid = C for kernel 11):
//   ws   (C_out, 9 C_mid + 8): the tap weights, loaded once;
//   w1s  (C_mid, C_in + 8): kernel 12's 1x1 weights, loaded once;
//   ys   (R + 2, W + 2, C_mid + 8): the pixel-major window of the second
//        stage's input (kernel 11: x; kernel 12: y), input row h in slot
//        (h + 1) % (R + 2), columns 0 and W + 1 zero (SAME padding);
//   os   (C_out, R*W + 8): the group's output, channel-major; with
//        `residual` it first receives t at the output pixels;
//   raw  (NR, C_in, W + 8): a ring of input rows as copied, channel-major;
//   bar  (NR + kBlock) mbarriers (uint64), one per raw slot, then one for
//        the residual tile.
// Row paddings keep ldmatrix / stmatrix free of bank conflicts (8 rows at
// strides of 16 mod 128 bytes or its odd multiples).
//
// The j-th input row the block needs goes to raw slot j % NR: every thread
// copies its share in 16-byte asynchronous copies (cp.async, neighbouring
// threads along the pixels of a channel) and arrives on the slot's
// mbarrier once its copies have landed; for a row outside the image the
// threads arrive and copy nothing. The block keeps NR rows ahead: after a
// group's rows have left the ring, it issues every row up to NR past them.
// (On the H100 at kernel 11's flagship shape: issued by one warp alone,
// the copies held that warp back from its share of the products, 0.325
// against 0.311 ms; as one bulk copy of W*2 bytes per channel, counted on
// the mbarrier, 0.33 ms, since the SM's copy engine issues 256-byte bulk
// copies one at a time.)
//
// Per group:
// 1. its new input rows into the window. Kernel 11 transposes each
//    (ldmatrix.trans of 8x8 channel-by-pixel blocks, stmatrix: a 16-byte
//    aligned pixel-major row per pixel, which a tap offset of +-1 pixel
//    keeps aligned). Kernel 12 multiplies instead: a warp takes 16 pixels
//    of a row by 32 of C_mid, A = 16 pixels x 16 channels of t by
//    ldmatrix.trans from the raw slot, B = w1s by ldmatrix, mma.sync
//    m16n8k16, + b1, ReLU, one rounding, stmatrix into the window (the
//    accumulator is the non-transposed 8x8 layout stmatrix stores); zero
//    for a row outside the image. Each warp waits on the mbarriers of its
//    own rows only.
// 2. sync; with `residual`, cp.async of t at the group's cnt*W output
//    pixels into os (an L2 read: the ring copied those rows moments
//    before), counted on the last mbarrier; the next ring copies.
// 3. the 3x3 as an implicit GEMM (mma.sync m16n8k16: 16 pixels of one
//    output row by 8 output channels, K over the 9 taps x C_mid; A by
//    ldmatrix from the window at the tap's pixel offset and row slot, B by
//    ldmatrix from ws), + bias, with `residual` + t read back from os by
//    ldmatrix.trans (a channel-major 8x8 block, transposed, is the m16n8
//    accumulator layout: pixel g, channels 2q and 2q + 1), all in f32, then
//    ReLU, one bf16 rounding, stmatrix.trans into os at the same place;
// 4. sync, and 16-byte stores of cnt*W contiguous pixels per output
//    channel.
constexpr int kBandThreads = 256;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kBandGroupPixels = 256;  // output pixels of a group: 2 m tiles
                                       // a warp

struct BandSmem {
  size_t ws, w1s, ys, os, raw, bar, bytes;
  __host__ __device__ BandSmem(int C_in, int C_mid, int C_out, int W, int R,
                               int NR, bool block) {
    ws = 0;
    w1s = ws + (size_t)C_out * (9 * C_mid + 8) * 2;
    ys = w1s + (block ? (size_t)C_mid * (C_in + 8) * 2 : 0);
    os = ys + (size_t)(R + 2) * (W + 2) * (C_mid + 8) * 2;
    raw = os + (size_t)C_out * (R * W + 8) * 2;
    bar = raw + (size_t)NR * C_in * (W + 8) * 2;
    bytes = bar + (size_t)(NR + (block ? 1 : 0)) * 8;
  }
};

// rows x cols of src (row-major, cols a multiple of 8) into dst with a row
// stride of cols + 8.
__device__ void load_weights(const bf16* __restrict__ src, int rows, int cols,
                             bf16* dst) {
  const int cv = cols / 8;
  for (int e = threadIdx.x; e < rows * cv; e += blockDim.x) {
    const int r = e / cv, c = (e % cv) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * (cols + 8) + c) =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * cols + c));
  }
}

// kBlock: kernel 12 (src = t; w1, b1 its 1x1 stage; w, b = wt, b2);
// else kernel 11 (src = x, C_in = C_mid; w1, b1 unused).
template <bool kBlock>
__global__ void __launch_bounds__(kBandThreads, 2)
band_kernel(const bf16* __restrict__ src, const bf16* __restrict__ w1,
            const float* __restrict__ b1, const bf16* __restrict__ w,
            const float* __restrict__ b, bf16* __restrict__ out, int C_in,
            int C_mid, int C_out, int N, int H, int W, int R, int NR,
            int residual, int relu) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  if constexpr (!kBlock) C_mid = C_in;  // one value for the compiler
  const BandSmem lay(C_in, C_mid, C_out, W, R, NR, kBlock);
  bf16* ws = reinterpret_cast<bf16*>(band_smem + lay.ws);
  bf16* w1s = reinterpret_cast<bf16*>(band_smem + lay.w1s);
  bf16* ys = reinterpret_cast<bf16*>(band_smem + lay.ys);
  bf16* os = reinterpret_cast<bf16*>(band_smem + lay.os);
  bf16* raw = reinterpret_cast<bf16*>(band_smem + lay.raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(band_smem + lay.bar);
  uint64_t* res_bar = bar + NR;  // kBlock only
  const int KW = 9 * C_mid + 8, SM = C_mid + 8, OS = R * W + 8, RW = W + 8;
  const int NS = R + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bands = (H + R - 1) / R, G = N * bands;
  const int gb = (int)((long long)blockIdx.x * G / gridDim.x);
  const int ge = (int)((long long)(blockIdx.x + 1) * G / gridDim.x);
  const size_t P = (size_t)N * H * W;
  const bool res = kBlock && residual;

  if (tid == 0) {
    for (int s = 0; s < NR + (kBlock ? 1 : 0); ++s)
      ptx::mbar_init(&bar[s], kBandThreads);
    ptx::mbar_fence_init();
  }
  load_weights(w, C_out, 9 * C_mid, ws);
  if (kBlock) load_weights(w1, C_mid, C_in, w1s);
  for (int e = tid; e < NS * 2 * C_mid; e += kBandThreads) {
    const int r = e / (2 * C_mid), side = (e / C_mid) & 1, c = e % C_mid;
    ys[((size_t)r * (W + 2) + side * (W + 1)) * SM + c] = __float2bfloat16(0.f);
  }
  __syncthreads();

  // the rows of group g: the first and how many (fresh: with both halos)
  auto group_rows = [&](int g, int& n, int& h0, int& cnt, int& first,
                        int& count) {
    n = g / bands;
    h0 = (g % bands) * R;
    cnt = min(R, H - h0);
    const bool fresh = g == gb || h0 == 0;
    first = fresh ? h0 - 1 : h0 + 1;
    count = cnt + (fresh ? 2 : 0);
  };

  // the copy state, the same in every thread: the next row to issue is row
  // pj of group pg, the issued-th of the walk
  int pg = gb, pj = 0, issued = 0;
  auto issue_upto = [&](int limit) {
    while (issued < limit && pg < ge) {
      int n, h0, cnt, first, count;
      group_rows(pg, n, h0, cnt, first, count);
      const int h = first + pj, slot = issued % NR;
      if (h < 0 || h >= H) {
        ptx::mbar_arrive(&bar[slot]);
      } else {
        const bf16* rsrc = src + ((size_t)n * H + h) * W;
        bf16* dst = raw + (size_t)slot * C_in * RW;
        for (int e = tid; e < C_in * (W / 8); e += kBandThreads) {
          const int c = e / (W / 8), v = (e % (W / 8)) * 8;
          ptx::cp_async16(dst + (size_t)c * RW + v, rsrc + (size_t)c * P + v);
        }
        ptx::cp_async_mbar_arrive(&bar[slot]);
      }
      ++issued;
      if (++pj == count) {
        ++pg;
        pj = 0;
      }
    }
  };
  issue_upto(NR);

  int consumed = 0;
  for (int g = gb; g < ge; ++g) {
    int n, h0, cnt, first, count;
    group_rows(g, n, h0, cnt, first, count);
    // ---- 1. the group's new input rows into the window
    if constexpr (kBlock) {
      const int mtr = W / 16, nch = (C_mid + 31) / 32, LW = C_in + 8;
      const int mi = lane >> 3, r8 = lane & 7, q = lane & 3;
      for (int u = warp; u < count * mtr * nch; u += kBandWarps) {
        const int j = u / (mtr * nch), p0 = (u / nch) % mtr * 16;
        const int nc0 = (u % nch) * 32, npair = min(2, (C_mid - nc0) / 16);
        const int i = consumed + j, slot = i % NR, h = first + j;
        const bool live = h >= 0 && h < H;
        float acc[4][4] = {};
        if (live) {
          ptx::mbar_wait(&bar[slot], (uint32_t)((i / NR) & 1));
          // a0..a3: (pixels 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
          // (8-15, 8-15) of the channel-major slot, transposed
          const bf16* ap = raw + (size_t)slot * C_in * RW +
                           (size_t)((mi >> 1) * 8 + r8) * RW + p0 +
                           (mi & 1) * 8;
          const bf16* bp = w1s +
                           (size_t)(nc0 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                               LW +
                           ((lane >> 3) & 1) * 8;
#pragma unroll 2
          for (int k0 = 0; k0 < C_in; k0 += 16) {
            uint32_t a[4];
            ptx::ldsm_x4_t(a, ap + (size_t)k0 * RW);
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              if (jp >= npair) break;
              uint32_t bb[4];
              ptx::ldsm_x4(bb, bp + (size_t)jp * 16 * LW + k0);
              ptx::mma_bf16(acc[2 * jp], a, bb[0], bb[1]);
              ptx::mma_bf16(acc[2 * jp + 1], a, bb[2], bb[3]);
            }
          }
        }
        // + b1, ReLU, one rounding (zero outside the image); the register
        // of (pixel block m & 1, channel block m >> 1) to that 8x8 block
        bf16* yrow = ys + (size_t)((h + 1) % NS) * (W + 2) * SM + SM;
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          if (jp >= npair) break;
          uint32_t v[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int nt = 2 * jp + (m >> 1), c = nc0 + nt * 8 + 2 * q;
            float v0 = 0.f, v1 = 0.f;
            if (live) {
              v0 = fmaxf(acc[nt][(m & 1) * 2] + b1[c], 0.f);
              v1 = fmaxf(acc[nt][(m & 1) * 2 + 1] + b1[c + 1], 0.f);
            }
            const bf162 h2 = __floats2bfloat162_rn(v0, v1);
            v[m] = *reinterpret_cast<const uint32_t*>(&h2);
          }
          ptx::stsm_x4(yrow + (size_t)(p0 + (mi & 1) * 8 + r8) * SM + nc0 +
                           jp * 16 + (mi >> 1) * 8,
                       v);
        }
      }
    } else {
      const int units = (C_in / 16) * (W / 16);  // 16x16 transposes a row
      const int mi = lane >> 3, r8 = lane & 7;
      for (int j = 0; j < count; ++j) {
        const int i = consumed + j, slot = i % NR, h = first + j;
        bf16* yrow = ys + (size_t)((h + 1) % NS) * (W + 2) * SM + SM;
        ptx::mbar_wait(&bar[slot], (uint32_t)((i / NR) & 1));
        if (h < 0 || h >= H) {
          for (int e = tid; e < W * (C_in / 8); e += kBandThreads)
            *reinterpret_cast<uint4*>(yrow + (size_t)(e / (C_in / 8)) * SM +
                                      (e % (C_in / 8)) * 8) =
                make_uint4(0u, 0u, 0u, 0u);
        } else {
          const bf16* rs = raw + (size_t)slot * C_in * RW;
          for (int u = warp; u < units; u += kBandWarps) {
            const int c0 = (u % (C_in / 16)) * 16 + (mi & 1) * 8;
            const int p0 = (u / (C_in / 16)) * 16 + (mi >> 1) * 8;
            uint32_t v[4];
            ptx::ldsm_x4_t(v, rs + (size_t)(c0 + r8) * RW + p0);
            ptx::stsm_x4(yrow + (size_t)(p0 + r8) * SM + c0, v);
          }
        }
      }
    }
    consumed += count;
    __syncthreads();
    // ---- 2. the residual tile into os (free: the sync above follows the
    // last group's stores), then the next ring rows
    if (res) {
      const int vecs = cnt * W / 8;
      const bf16* t0 = src + ((size_t)n * H + h0) * W;
      for (int e = tid; e < C_out * vecs; e += kBandThreads) {
        const int c = e / vecs, u = e % vecs;
        ptx::cp_async16(os + (size_t)c * OS + u * 8, t0 + (size_t)c * P + u * 8);
      }
      ptx::cp_async_mbar_arrive(res_bar);
    }
    issue_upto(consumed + NR);

    // ---- 3. the 3x3 of rows h0 .. h0+cnt-1
    const int nmt = cnt * W / 16;
    for (int nc0 = 0; nc0 < C_out; nc0 += 32) {
      const int npair = min(2, (C_out - nc0) / 16);  // pairs of n tiles
      for (int mt0 = warp * 2; mt0 < nmt; mt0 += 2 * kBandWarps) {
        const bool two = mt0 + 1 < nmt;
        float acc[2][4][4] = {};
        // this lane's A row in each m tile: its pixel in the window rows
        // of dy = -1, 0, 1, at dx = -1 (taps step from there by SM)
        const bf16* arow[2][3];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pix = min(mt0 + i, nmt - 1) * 16 + (lane & 15);
          const int r = pix / W, col = pix % W;
#pragma unroll
          for (int d = 0; d < 3; ++d)
            arow[i][d] = ys +
                         ((size_t)((h0 + r + d) % NS) * (W + 2) + col) * SM +
                         (lane >> 4) * 8;
        }
        const bf16* bcol = ws +
                           (size_t)(nc0 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                               KW +
                           ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const bf16* ap0 = arow[0][tap / 3] + (tap % 3) * SM;
          const bf16* ap1 = arow[1][tap / 3] + (tap % 3) * SM;
          const bf16* bp = bcol + tap * C_mid;
#pragma unroll 2
          for (int c0 = 0; c0 < C_mid; c0 += 16) {
            uint32_t a0[4], a1[4];
            ptx::ldsm_x4(a0, ap0 + c0);
            ptx::ldsm_x4(a1, ap1 + c0);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (j >= npair) break;
              uint32_t bb[4];
              ptx::ldsm_x4(bb, bp + (size_t)j * 16 * KW + c0);
              ptx::mma_bf16(acc[0][2 * j], a0, bb[0], bb[1]);
              ptx::mma_bf16(acc[0][2 * j + 1], a0, bb[2], bb[3]);
              ptx::mma_bf16(acc[1][2 * j], a1, bb[0], bb[1]);
              ptx::mma_bf16(acc[1][2 * j + 1], a1, bb[2], bb[3]);
            }
          }
        }
        if (res) ptx::mbar_wait(res_bar, (uint32_t)((g - gb) & 1));
        // + bias (+ t), ReLU, one rounding; transposed into os
        const int q = lane & 3, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i == 1 && !two) break;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= npair) break;
            bf16* op = os + (size_t)(nc0 + j * 16 + (mi >> 1) * 8 + r8) * OS +
                       (mt0 + i) * 16 + (mi & 1) * 8;
            uint32_t tr[4] = {0u, 0u, 0u, 0u}, v[4];
            if (res) ptx::ldsm_x4_t(tr, op);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int nt = 2 * j + (m >> 1), c = nc0 + nt * 8 + 2 * q;
              float v0 = acc[i][nt][(m & 1) * 2] + b[c];
              float v1 = acc[i][nt][(m & 1) * 2 + 1] + b[c + 1];
              if (res) {
                const float2 t2 = __bfloat1622float2(
                    *reinterpret_cast<const bf162*>(&tr[m]));
                v0 += t2.x;
                v1 += t2.y;
              }
              if (relu) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
              const bf162 h2 = __floats2bfloat162_rn(v0, v1);
              v[m] = *reinterpret_cast<const uint32_t*>(&h2);
            }
            ptx::stsm_x4_t(op, v);
          }
        }
      }
    }
    __syncthreads();
    // ---- 4. cnt * W contiguous pixels of every output channel
    const int vecs = cnt * W / 8;
    bf16* dst = out + ((size_t)n * H + h0) * W;
    for (int e = tid; e < C_out * vecs; e += kBandThreads) {
      const int c = e / vecs, u = e % vecs;
      *reinterpret_cast<uint4*>(dst + (size_t)c * P + u * 8) =
          *reinterpret_cast<const uint4*>(os + (size_t)c * OS + u * 8);
    }
  }
}

// The plan of band_kernel on the current device: R output rows a group
// (kBandGroupPixels / W, fewer where the window does not fit), NR raw row
// slots (at least R + 2, a fresh group's rows; up to twice that), two
// blocks an SM where their shared memory fits, else one, and no more blocks
// than groups. cudaErrorInvalidValue where no plan fits.
int band_plan(int C_in, int C_mid, int C_out, int N, int H, int W, bool block,
              int& R, int& NR, int& blocks, size_t& smem) {
  int dev, sms, per_sm, per_block, reserved;
  TPK_TRY((int)cudaGetDevice(&dev));
  TPK_TRY((int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev));
  auto bytes = [&](int r, int nr) {
    return BandSmem(C_in, C_mid, C_out, W, r, nr, block).bytes;
  };
  for (R = std::min(H, std::max(1, kBandGroupPixels / W)); R >= 1; --R) {
    for (int k = 2; k >= 1; --k) {
      const size_t budget =
          (size_t)std::min(per_block, per_sm / k - reserved);
      NR = 2 * (R + 2);
      while (NR > R + 2 && bytes(R, NR) > budget) --NR;
      smem = bytes(R, NR);
      if (smem <= budget) {
        blocks = (int)std::min((long long)N * ((H + R - 1) / R),
                               (long long)k * sms);
        return 0;
      }
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kBlock>
int launch_band(const void* src, const void* w1, const float* b1,
                const void* w, const float* b, void* out, int C_in, int C_mid,
                int C_out, int N, int H, int W, int residual, int relu,
                cudaStream_t s) {
  if (outside_limits(src, w1, w, out, C_in, C_mid, C_out, N, H, W, residual))
    return (int)cudaErrorInvalidValue;
  int R, NR, blocks;
  size_t smem;
  TPK_TRY(band_plan(C_in, C_mid, C_out, N, H, W, kBlock, R, NR, blocks, smem));
  auto kernel = band_kernel<kBlock>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  TPK_CHECK();
  kernel<<<blocks, kBandThreads, smem, s>>>(
      (const bf16*)src, (const bf16*)w1, b1, (const bf16*)w, b, (bf16*)out,
      C_in, C_mid, C_out, N, H, W, R, NR, residual, relu);
  TPK_CHECK();
  return 0;
}

}  // namespace

// t (C_in, N*H*W), w1 (C_mid, C_in), wt (C_out, 9*C_mid) of one type (is_bf16:
// bf16, else f32), b1 (C_mid) and b2 (C_out) f32 -> out (C_out, N*H*W).
// bf16 runs band_kernel<true> as band_plan plans it, float32 stem_kernel.
extern "C" int tpk_basic_block_cp(const void* t, const void* w1,
                                  const float* b1, const void* wt,
                                  const float* b2, void* out, int C_in,
                                  int C_mid, int C_out, int N, int H, int W,
                                  int residual, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_band<true>(t, w1, b1, wt, b2, out, C_in, C_mid, C_out, N, H,
                             W, residual, residual, s);
  return launch_stem<true>((const float*)t, (const float*)w1, b1,
                           (const float*)wt, b2, (float*)out, C_in, C_mid,
                           C_out, N, H, W, residual, 0, s);
}

// x (C_in, N*H*W), w (C_out, 9*C_in) of one type, b (C_out) f32 -> out.
// bf16 runs band_kernel<false> as band_plan plans it, float32 the second
// stage of stem_kernel.
extern "C" int tpk_conv3x3_cp(const void* x, const void* w, const float* b,
                              void* out, int C_in, int C_out, int N, int H,
                              int W, int relu, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_band<false>(x, nullptr, nullptr, w, b, out, C_in, C_in,
                              C_out, N, H, W, 0, relu, s);
  return launch_stem<false>((const float*)x, nullptr, nullptr,
                            (const float*)w, b, (float*)out, C_in, C_in,
                            C_out, N, H, W, 0, relu, s);
}

// The bf16 plan of kernel 12 (block != 0) or kernel 11 (C_mid = C_in) at
// this shape on the current device: plan = {R, NR, blocks, shared memory
// bytes of a block}. cudaErrorInvalidValue where none fits.
extern "C" int tpk_stem_plan(int C_in, int C_mid, int C_out, int N, int H,
                             int W, int block, int* plan) {
  int R, NR, blocks;
  size_t smem;
  TPK_TRY(band_plan(C_in, block ? C_mid : C_in, C_out, N, H, W, block != 0, R,
                    NR, blocks, smem));
  plan[0] = R;
  plan[1] = NR;
  plan[2] = blocks;
  plan[3] = (int)smem;
  return 0;
}
