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
// into one (9C, P) VMEM operand. Here one block takes one image and a band
// of R output rows (R*W ~ 256 pixels). It copies the R + 2 input rows it
// needs (one halo row above and below, zero outside the image, so no tap
// reaches another image) into shared memory transposed to pixel-major
// [pixel][channel] rows, 16-byte loads with eight in flight a thread (the
// copy is latency-bound otherwise: one 2-byte load at a time made the
// first version 30x slower than its bound), computes y for those rows
// there (a product over C_in, bias, ReLU, rounding), with a zero column on
// either side, and then runs the 3x3 as an implicit GEMM: each tap is the
// same y tile read at a pixel offset of dy*(W+2) + dx, so the nine taps cost
// no copies. Kernel 11 in float32 loads its input straight into that y tile
// and runs the second stage alone (in bf16 it has a kernel of its own,
// conv3x3_band_kernel below). The halo rows are read by two blocks and
// their y computed twice ((R+2)/R of the first stage's work, ~1/9 of the
// second's).
//
// bf16: the products are mma.sync m16n8k16 (bf16 in, f32 accumulation),
// pixels as the M dimension and channels as N, so each fragment of a tap is
// a 32-bit shared-memory load of two neighbouring channels of one pixel;
// the weights are copied into shared memory too. Rows of both are padded by
// 8 elements, so the fragment loads are free of bank conflicts. A warp
// holds 32 pixels by up to 64 output channels (32 for 32-channel layers,
// which keeps two blocks an SM). float32 runs on the CUDA cores (no TF32),
// one thread per (pixel, 8 output channels), weights read through L1.
//
// Bound on the H100, at the flagship's shapes (B=512): layer1's block and
// the 3x3 at (32, 2^21) move ~268 MB and do ~39-43 GFLOP, bound by bytes
// (~0.080 ms); layer2's block0 (32 -> 64 -> 64 at full resolution) does
// ~163 GFLOP and its blocks 1-3 ~43 GFLOP over 134 MB, bound by operations
// (~0.165 and ~0.043 ms). This first version uses mma.sync without
// cp.async or TMA pipelining and reads the weights through L1, so it runs
// well below either bound; making it fast is later work.
//
// Limits (cudaErrorInvalidValue otherwise): every channel count a multiple
// of 16, W a multiple of 16, C_out == C_in with `residual`, 16-byte
// aligned activations and weights, and the band's shared memory within
// 227 KB (one row of W pixels must fit).
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBandPixels = 256;  // output pixels per block, R = 256 / W
constexpr int kInFlight = 8;      // 16-byte loads in flight per thread
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// Elements per pixel row of a pixel-major tile of C channels: bf16 rows are
// padded by 8 (32-bit fragment loads free of bank conflicts), f32 rows by 1
// (one thread per pixel reads a channel column).
template <typename T>
__host__ __device__ constexpr int pix_stride(int C) {
  return std::is_same<T, bf16>::value ? C + 8 : C + 1;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a @ b for one 16x8x16 bf16 tile (f32 accumulation). Fragments as the
// PTX ISA lays them out for m16n8k16: with g = lane / 4 and q = lane % 4,
// a = {(g, 2q..), (g+8, 2q..), (g, 2q+8..), (g+8, 2q+8..)} (row, col pairs),
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

// The elements of a 16-byte vector to dst[0], dst[S], dst[2S], ...
__device__ __forceinline__ void scatter(const uint4& v, bf16* d, int S) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d[(2 * j) * S] = __ushort_as_bfloat16((unsigned short)(w[j] & 0xffffu));
    d[(2 * j + 1) * S] = __ushort_as_bfloat16((unsigned short)(w[j] >> 16));
  }
}
__device__ __forceinline__ void scatter(const uint4& v, float* d, int S) {
  d[0] = __uint_as_float(v.x);
  d[S] = __uint_as_float(v.y);
  d[2 * S] = __uint_as_float(v.z);
  d[3 * S] = __uint_as_float(v.w);
}

// Rows hbeg .. hbeg+nrows-1 of image n of src (C, P) into the pixel-major
// tile dst: pixel (r, w) at dst[(r * pitch + col0 + w) * S + c], zero for
// rows outside the image. 16-byte vectors along w, channels fastest across
// the threads (conflict-free stores), kInFlight loads issued before the
// first store.
template <typename T>
__device__ void load_rows(const T* __restrict__ src, int C, size_t P, int n,
                          int H, int W, int hbeg, int nrows, T* dst,
                          int pitch, int col0, int S) {
  constexpr int V = 16 / sizeof(T);
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
        scatter(v[u], dst + ((size_t)r * pitch + col0 + w0) * S + c, S);
      }
    }
  }
}

// rows x cols of src (row-major, cols a multiple of 8) into dst with a row
// stride of cols + 8 (bf16 weights for the fragment loads).
__device__ void load_weights(const bf16* __restrict__ src, int rows, int cols,
                             bf16* dst) {
  const int cv = cols / 8;
  for (int e = threadIdx.x; e < rows * cv; e += blockDim.x) {
    const int r = e / cv, c = (e % cv) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * (cols + 8) + c) =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * cols + c));
  }
}

// The zero columns left and right of the y tile (SAME padding in w).
template <typename T>
__device__ void zero_edge_columns(T* ys, int nrows, int W, int S) {
  for (int e = threadIdx.x; e < nrows * 2 * S; e += blockDim.x) {
    const int r = e / (2 * S), side = (e / S) & 1, c = e % S;
    ys[((size_t)r * (W + 2) + side * (W + 1)) * S + c] = from_f<T>(0.f);
  }
}

// ---- first stage: y = round(relu(w1 @ t + b1)), rows hbeg .. hbeg+R+1;
// w1 in shared memory with rows of C_in + 8 ----------------------------------
template <int kNT>
__device__ void stage1(const bf16* ts, int SI, const bf16* w1,
                       const float* __restrict__ b1, int C_in, int C_mid,
                       bf16* ys, int SM, int H, int W, int hbeg, int nrows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int nmt = nrows * W / 16;  // 16-pixel tiles, each within one row
  const int LW = C_in + 8;
  for (int nc0 = 0; nc0 < C_mid; nc0 += 8 * kNT) {
    const int nnt = min(kNT, (C_mid - nc0) / 8);
    for (int mt0 = warp * 2; mt0 < nmt; mt0 += kWarps * 2) {
      float acc[2][kNT][4] = {};
      bool live[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int h = hbeg + (mt0 + i) * 16 / W;
        live[i] = mt0 + i < nmt && h >= 0 && h < H;
      }
      if (live[0] || live[1]) {
        for (int k0 = 0; k0 < C_in; k0 += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bf16* p0 = ts + (size_t)((mt0 + i) * 16 + g) * SI + k0 +
                             2 * q4;
            const bf16* p1 = p0 + 8 * SI;
            a[i][0] = live[i] ? ld32(p0) : 0u;
            a[i][1] = live[i] ? ld32(p1) : 0u;
            a[i][2] = live[i] ? ld32(p0 + 8) : 0u;
            a[i][3] = live[i] ? ld32(p1 + 8) : 0u;
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt >= nnt) break;
            const bf16* wp = w1 + (size_t)(nc0 + nt * 8 + g) * LW + k0 + 2 * q4;
            const uint32_t b0 = ld32(wp), b1v = ld32(wp + 8);
            mma_bf16(acc[0][nt], a[0], b0, b1v);
            mma_bf16(acc[1][nt], a[1], b0, b1v);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (mt0 + i >= nmt) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qp = (mt0 + i) * 16 + g + 8 * half;
          const int r = qp / W, w = qp % W;
          bf16* dst = ys + ((size_t)r * (W + 2) + w + 1) * SM + nc0;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt >= nnt) break;
            const int c = nt * 8 + 2 * q4;
            float v0 = 0.f, v1 = 0.f;
            if (live[i]) {
              v0 = fmaxf(acc[i][nt][2 * half] + b1[nc0 + c], 0.f);
              v1 = fmaxf(acc[i][nt][2 * half + 1] + b1[nc0 + c + 1], 0.f);
            }
            *reinterpret_cast<bf162*>(dst + c) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

template <int kNT>
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

// ---- second stage: out = round(epilogue(wt @ taps(y) + b2)) for the R
// output rows h0 .. h0+R-1; ts (residual) holds t for rows h0-1 .. h0+R;
// wt in shared memory with rows of 9 * C_mid + 8 ----------------------------
template <int kNT>
__device__ void stage2(const bf16* ys, int SM, const bf16* wt,
                       const float* __restrict__ b2, int C_mid, int C_out,
                       const bf16* ts, int SI, int residual, int relu,
                       bf16* __restrict__ out, size_t P, int n, int H, int W,
                       int h0, int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int KW = 9 * C_mid + 8, nmt = R * W / 16;
  for (int nc0 = 0; nc0 < C_out; nc0 += 8 * kNT) {
    const int nnt = min(kNT, (C_out - nc0) / 8);
    for (int mt0 = warp * 2; mt0 < nmt; mt0 += kWarps * 2) {
      bool live[2];
      int ctr[2][2];  // y-tile index of the centre tap of rows g and g + 8
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        live[i] = mt0 + i < nmt && h0 + (mt0 + i) * 16 / W < H;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qp = (mt0 + i) * 16 + g + 8 * half;
          ctr[i][half] = (qp / W + 1) * (W + 2) + qp % W + 1;
        }
      }
      if (!live[0] && !live[1]) continue;
      float acc[2][kNT][4] = {};
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3 - 1) * (W + 2) + tap % 3 - 1;
        for (int c0 = 0; c0 < C_mid; c0 += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bf16* p0 = ys + (size_t)(ctr[i][0] + off) * SM + c0 + 2 * q4;
            const bf16* p1 = ys + (size_t)(ctr[i][1] + off) * SM + c0 + 2 * q4;
            a[i][0] = live[i] ? ld32(p0) : 0u;
            a[i][1] = live[i] ? ld32(p1) : 0u;
            a[i][2] = live[i] ? ld32(p0 + 8) : 0u;
            a[i][3] = live[i] ? ld32(p1 + 8) : 0u;
          }
          const bf16* wk = wt + (size_t)(nc0 + g) * KW + tap * C_mid + c0 +
                           2 * q4;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt >= nnt) break;
            const bf16* wp = wk + (size_t)nt * 8 * KW;
            const uint32_t b0 = ld32(wp), b1v = ld32(wp + 8);
            mma_bf16(acc[0][nt], a[0], b0, b1v);
            mma_bf16(acc[1][nt], a[1], b0, b1v);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!live[i]) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qp = (mt0 + i) * 16 + g + 8 * half;
          const size_t pix = ((size_t)n * H + h0) * W + qp;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt >= nnt) break;
            const int c = nc0 + nt * 8 + 2 * q4;
            float v[2] = {acc[i][nt][2 * half] + b2[c],
                          acc[i][nt][2 * half + 1] + b2[c + 1]};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (residual)
                v[j] = fmaxf(v[j] + to_f(ts[(size_t)(qp + W) * SI + c + j]),
                             0.f);
              else if (relu)
                v[j] = fmaxf(v[j], 0.f);
              out[(size_t)(c + j) * P + pix] = __float2bfloat16(v[j]);
            }
          }
        }
      }
    }
  }
}

template <int kNT>
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

// Shared memory of one block, in elements of T: [wt, w1 (bf16 only)] [ts
// (kernel 12 only)] [ys].
template <typename T, bool kBlock>
struct StemSmem {
  size_t wt, w1, ts, ys;
  __host__ __device__ StemSmem(int C_in, int C_mid, int C_out, int W, int R) {
    const bool bf = std::is_same<T, bf16>::value;
    wt = bf ? (size_t)C_out * (9 * C_mid + 8) : 0;
    w1 = bf && kBlock ? (size_t)C_mid * (C_in + 8) : 0;
    ts = kBlock ? (size_t)(R + 2) * W * pix_stride<T>(C_in) : 0;
    ys = (size_t)(R + 2) * (W + 2) * pix_stride<T>(C_mid);
  }
  __host__ __device__ size_t bytes() const {
    return (wt + w1 + ts + ys) * sizeof(T);
  }
};

// One block: image blockIdx.x / bands, output rows h0 .. h0+R-1.
// kBlock: kernel 12 (src = t, both stages); else kernel 11 (src = x, C_mid
// = its channels, second stage only; w1, b1 unused). kNT * 8: the output
// channels of a warp's pass (32 keeps two blocks an SM).
template <typename T, bool kBlock, int kNT>
__global__ void __launch_bounds__(kThreads, kNT <= 4 ? 2 : 1)
stem_kernel(const T* __restrict__ src, const T* __restrict__ w1,
            const float* __restrict__ b1, const T* __restrict__ wt,
            const float* __restrict__ b2, T* __restrict__ out, int C_in,
            int C_mid, int C_out, int N, int H, int W, int R, int residual,
            int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bands = (H + R - 1) / R;
  const int n = blockIdx.x / bands, h0 = (blockIdx.x % bands) * R;
  const size_t P = (size_t)N * H * W;
  const int SI = pix_stride<T>(C_in), SM = pix_stride<T>(C_mid);
  const StemSmem<T, kBlock> lay(C_in, C_mid, C_out, W, R);
  T* wts = reinterpret_cast<T*>(smem_raw);
  T* w1s = wts + lay.wt;
  T* ts = w1s + lay.w1;
  T* ys = ts + lay.ts;
  const T* wsrc = wt;
  const T* w1src = w1;
  if constexpr (std::is_same<T, bf16>::value) {
    load_weights(wt, C_out, 9 * C_mid, wts);
    if (kBlock) load_weights(w1, C_mid, C_in, w1s);
    wsrc = wts;
    w1src = w1s;
  }
  zero_edge_columns(ys, R + 2, W, SM);
  if (kBlock) {
    load_rows(src, C_in, P, n, H, W, h0 - 1, R + 2, ts, W, 0, SI);
    __syncthreads();
    stage1<kNT>(ts, SI, w1src, b1, C_in, C_mid, ys, SM, H, W, h0 - 1, R + 2);
  } else {
    load_rows(src, C_mid, P, n, H, W, h0 - 1, R + 2, ys, W + 2, 1, SM);
  }
  __syncthreads();
  stage2<kNT>(ys, SM, wsrc, b2, C_mid, C_out, ts, SI, residual, relu, out, P,
              n, H, W, h0, R);
}

template <typename T, bool kBlock, int kNT>
int launch_stem_nt(const void* src, const void* w1, const float* b1,
                const void* wt, const float* b2, void* out, int C_in,
                int C_mid, int C_out, int N, int H, int W, int residual,
                int relu, cudaStream_t s) {
  int R = std::min(H, std::max(1, kBandPixels / W));
  while (R > 1 &&
         StemSmem<T, kBlock>(C_in, C_mid, C_out, W, R).bytes() > kMaxSmem)
    --R;
  const size_t smem = StemSmem<T, kBlock>(C_in, C_mid, C_out, W, R).bytes();
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = stem_kernel<T, kBlock, kNT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  TPK_CHECK();
  const int blocks = N * ((H + R - 1) / R);
  kernel<<<blocks, kThreads, smem, s>>>(
      (const T*)src, (const T*)w1, b1, (const T*)wt, b2, (T*)out, C_in, C_mid,
      C_out, N, H, W, R, residual, relu);
  TPK_CHECK();
  return 0;
}

template <typename T, bool kBlock>
int launch_stem(const void* src, const void* w1, const float* b1,
                const void* wt, const float* b2, void* out, int C_in,
                int C_mid, int C_out, int N, int H, int W, int residual,
                int relu, cudaStream_t s) {
  if (C_in % 16 || C_mid % 16 || C_out % 16 || C_in <= 0 || C_mid <= 0 ||
      C_out <= 0 || W % 16 || W <= 0 || H <= 0 || N <= 0 ||
      (residual && C_out != C_in) ||
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(w1) |
        reinterpret_cast<uintptr_t>(wt)) & 15))
    return (int)cudaErrorInvalidValue;
  if (C_mid <= 32 && C_out <= 32)
    return launch_stem_nt<T, kBlock, 4>(src, w1, b1, wt, b2, out, C_in,
                                        C_mid, C_out, N, H, W, residual, relu,
                                        s);
  return launch_stem_nt<T, kBlock, 8>(src, w1, b1, wt, b2, out, C_in, C_mid,
                                      C_out, N, H, W, residual, relu, s);
}

// ---- kernel 11 in bf16: persistent blocks over bands of output rows -------
// The output rows of the batch are cut into groups: group g is image
// g / bands and rows h0 .. h0+cnt-1, h0 = (g % bands) * R, cnt =
// min(R, H - h0). Block b takes groups [b*G/grid, (b+1)*G/grid) and walks
// them in order. A group needs input rows h0-1 .. h0+cnt (zero outside the
// image); when the block's previous group is the band above in the same
// image, its last two are already in shared memory, so a walk reads each
// input row once, plus two halo rows where it enters an image.
//
// Shared memory, bf16 unless noted:
//   ws   (C_out, 9C + 8): the tap weights, loaded once;
//   ys   (R + 2, W + 2, C + 8): the pixel-major window, input row h in
//        slot (h + 1) % (R + 2), columns 0 and W + 1 zero (SAME padding);
//   os   (C_out, R*W + 8): the group's output, channel-major;
//   raw  (NR, C, W + 8): a ring of input rows as copied, channel-major;
//   bar  (NR) mbarriers (uint64), one per raw slot.
// Row paddings keep ldmatrix / stmatrix free of bank conflicts (8 rows at
// strides of 16 mod 128 bytes or its odd multiples).
//
// The j-th input row the block needs goes to raw slot j % NR: every thread
// copies its share in 16-byte asynchronous copies (cp.async, neighbouring
// threads along the pixels of a channel) and arrives on the slot's
// mbarrier once its copies have landed; for a row outside the image the
// threads arrive and copy nothing. The block keeps NR rows ahead: after a
// group's rows have been moved out of the ring, it issues every row up to
// NR past them. (On the H100 at the flagship's shape: issued by one warp
// alone, the copies held that warp back from its share of the products,
// 0.325 against 0.311 ms; as one bulk copy of W*2 bytes per channel,
// counted on the mbarrier, 0.33 ms, since the SM's copy engine issues
// 256-byte bulk copies one at a time.)
//
// Per group: wait for its rows, transpose each (ldmatrix.trans of 8x8
// channel-by-pixel blocks, stmatrix into the window: a 16-byte aligned
// pixel-major row per pixel, which a tap offset of +-1 pixel keeps
// aligned), sync, issue the next copies, then the 3x3 as an implicit GEMM
// (mma.sync m16n8k16: 16 pixels of one output row by 8 output channels, K
// over the 9 taps x C; A by ldmatrix from the window at the tap's pixel
// offset and row slot, B by ldmatrix from ws), + bias, ReLU, one bf16
// rounding, stmatrix.trans into os, sync, and 16-byte stores of cnt*W
// contiguous pixels per output channel.
constexpr int kConvThreads = 256;
constexpr int kConvWarps = kConvThreads / 32;
constexpr int kConvBandPixels = 256;  // output pixels of a group: 2 m tiles
                                      // a warp

struct ConvSmem {
  size_t ws, ys, os, raw, bytes;
  __host__ __device__ ConvSmem(int C, int C_out, int W, int R, int NR) {
    ws = 0;
    ys = ws + (size_t)C_out * (9 * C + 8) * 2;
    os = ys + (size_t)(R + 2) * (W + 2) * (C + 8) * 2;
    raw = os + (size_t)C_out * (R * W + 8) * 2;
    bytes = raw + (size_t)NR * C * (W + 8) * 2 + (size_t)NR * 8;
  }
};

__global__ void __launch_bounds__(kConvThreads, 2)
conv3x3_band_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ b, bf16* __restrict__ out,
                    int C, int C_out, int N, int H, int W, int R, int NR,
                    int relu) {
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const ConvSmem lay(C, C_out, W, R, NR);
  bf16* ws = reinterpret_cast<bf16*>(conv_smem + lay.ws);
  bf16* ys = reinterpret_cast<bf16*>(conv_smem + lay.ys);
  bf16* os = reinterpret_cast<bf16*>(conv_smem + lay.os);
  bf16* raw = reinterpret_cast<bf16*>(conv_smem + lay.raw);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(conv_smem + lay.bytes - (size_t)NR * 8);
  const int KW = 9 * C + 8, SM = C + 8, OS = R * W + 8, RW = W + 8;
  const int NS = R + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bands = (H + R - 1) / R, G = N * bands;
  const int gb = (int)((long long)blockIdx.x * G / gridDim.x);
  const int ge = (int)((long long)(blockIdx.x + 1) * G / gridDim.x);
  const size_t P = (size_t)N * H * W;

  if (tid == 0) {
    for (int s = 0; s < NR; ++s) ptx::mbar_init(&bar[s], kConvThreads);
    ptx::mbar_fence_init();
  }
  load_weights(w, C_out, 9 * C, ws);
  for (int e = tid; e < NS * 2 * C; e += kConvThreads) {
    const int r = e / (2 * C), side = (e / C) & 1, c = e % C;
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
        const bf16* src = x + ((size_t)n * H + h) * W;
        bf16* dst = raw + (size_t)slot * C * RW;
        for (int e = tid; e < C * (W / 8); e += kConvThreads) {
          const int c = e / (W / 8), v = (e % (W / 8)) * 8;
          ptx::cp_async16(dst + (size_t)c * RW + v, src + (size_t)c * P + v);
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

  const int units = (C / 16) * (W / 16);  // 16x16 transposes of a row
  int consumed = 0;
  for (int g = gb; g < ge; ++g) {
    int n, h0, cnt, first, count;
    group_rows(g, n, h0, cnt, first, count);
    // ---- the group's new input rows into the window
    for (int j = 0; j < count; ++j) {
      const int i = consumed + j, slot = i % NR, h = first + j;
      bf16* yrow = ys + (size_t)((h + 1) % NS) * (W + 2) * SM + SM;
      ptx::mbar_wait(&bar[slot], (uint32_t)((i / NR) & 1));
      if (h < 0 || h >= H) {
        for (int e = tid; e < W * (C / 8); e += kConvThreads)
          *reinterpret_cast<uint4*>(yrow + (size_t)(e / (C / 8)) * SM +
                                    (e % (C / 8)) * 8) =
              make_uint4(0u, 0u, 0u, 0u);
      } else {
        const bf16* rs = raw + (size_t)slot * C * RW;
        const int mi = lane >> 3, r8 = lane & 7;
        for (int u = warp; u < units; u += kConvWarps) {
          const int c0 = (u % (C / 16)) * 16 + (mi & 1) * 8;
          const int p0 = (u / (C / 16)) * 16 + (mi >> 1) * 8;
          uint32_t v[4];
          ptx::ldsm_x4_t(v, rs + (size_t)(c0 + r8) * RW + p0);
          ptx::stsm_x4(yrow + (size_t)(p0 + r8) * SM + c0, v);
        }
      }
    }
    consumed += count;
    __syncthreads();
    issue_upto(consumed + NR);

    // ---- the 3x3 of rows h0 .. h0+cnt-1
    const int nmt = cnt * W / 16;
    for (int nc0 = 0; nc0 < C_out; nc0 += 32) {
      const int npair = min(2, (C_out - nc0) / 16);  // pairs of n tiles
      for (int mt0 = warp * 2; mt0 < nmt; mt0 += 2 * kConvWarps) {
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
          const bf16* bp = bcol + tap * C;
#pragma unroll 2
          for (int c0 = 0; c0 < C; c0 += 16) {
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
        // + bias, ReLU, one rounding; transposed into os
        const int q = lane & 3, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i == 1 && !two) break;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= npair) break;
            uint32_t v[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int nt = 2 * j + (m >> 1), c = nc0 + nt * 8 + 2 * q;
              float v0 = acc[i][nt][(m & 1) * 2] + b[c];
              float v1 = acc[i][nt][(m & 1) * 2 + 1] + b[c + 1];
              if (relu) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
              const bf162 h2 = __floats2bfloat162_rn(v0, v1);
              v[m] = *reinterpret_cast<const uint32_t*>(&h2);
            }
            ptx::stsm_x4_t(os + (size_t)(nc0 + j * 16 + (mi >> 1) * 8 + r8) * OS +
                               (mt0 + i) * 16 + (mi & 1) * 8,
                           v);
          }
        }
      }
    }
    __syncthreads();
    // ---- cnt * W contiguous pixels of every output channel
    const int vecs = cnt * W / 8;
    bf16* dst = out + ((size_t)n * H + h0) * W;
    for (int e = tid; e < C_out * vecs; e += kConvThreads) {
      const int c = e / vecs, u = e % vecs;
      *reinterpret_cast<uint4*>(dst + (size_t)c * P + u * 8) =
          *reinterpret_cast<const uint4*>(os + (size_t)c * OS + u * 8);
    }
  }
}

// The plan of conv3x3_band_kernel on the current device: R output rows a
// group (kConvBandPixels / W, fewer where the window does not fit), NR raw
// row slots (at least R + 2, a fresh group's rows; up to twice that), two
// blocks an SM where their shared memory fits, else one, and no more blocks
// than groups. cudaErrorInvalidValue where no plan fits.
int conv3x3_plan(int C, int C_out, int N, int H, int W, int& R, int& NR,
                 int& blocks, size_t& smem) {
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
  for (R = std::min(H, std::max(1, kConvBandPixels / W)); R >= 1; --R) {
    for (int k = 2; k >= 1; --k) {
      const size_t budget =
          (size_t)std::min(per_block, per_sm / k - reserved);
      NR = 2 * (R + 2);
      while (NR > R + 2 && ConvSmem(C, C_out, W, R, NR).bytes > budget) --NR;
      smem = ConvSmem(C, C_out, W, R, NR).bytes;
      if (smem <= budget) {
        blocks = (int)std::min((long long)N * ((H + R - 1) / R),
                               (long long)k * sms);
        return 0;
      }
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// t (C_in, N*H*W), w1 (C_mid, C_in), wt (C_out, 9*C_mid) of one type (is_bf16:
// bf16, else f32), b1 (C_mid) and b2 (C_out) f32 -> out (C_out, N*H*W).
extern "C" int tpk_basic_block_cp(const void* t, const void* w1,
                                  const float* b1, const void* wt,
                                  const float* b2, void* out, int C_in,
                                  int C_mid, int C_out, int N, int H, int W,
                                  int residual, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_stem<bf16, true>(t, w1, b1, wt, b2, out, C_in, C_mid,
                                           C_out, N, H, W, residual, 0, s)
                 : launch_stem<float, true>(t, w1, b1, wt, b2, out, C_in,
                                            C_mid, C_out, N, H, W, residual, 0,
                                            s);
}

// x (C_in, N*H*W), w (C_out, 9*C_in) of one type, b (C_out) f32 -> out.
// bf16 runs conv3x3_band_kernel as conv3x3_plan plans it (besides the limits
// above: a plan must fit the shared memory); float32 runs the second stage
// of kernel 12 on the CUDA cores.
extern "C" int tpk_conv3x3_cp(const void* x, const void* w, const float* b,
                              void* out, int C_in, int C_out, int N, int H,
                              int W, int relu, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    return launch_stem<float, false>(x, nullptr, nullptr, w, b, out, C_in,
                                     C_in, C_out, N, H, W, 0, relu, s);
  if (C_in % 16 || C_out % 16 || C_in <= 0 || C_out <= 0 || W % 16 ||
      W <= 0 || H <= 0 || N <= 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) & 15))
    return (int)cudaErrorInvalidValue;
  int R, NR, blocks;
  size_t smem;
  TPK_TRY(conv3x3_plan(C_in, C_out, N, H, W, R, NR, blocks, smem));
  cudaFuncSetAttribute(conv3x3_band_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  TPK_CHECK();
  conv3x3_band_kernel<<<blocks, kConvThreads, smem, s>>>(
      (const bf16*)x, (const bf16*)w, b, (bf16*)out, C_in, C_out, N, H, W, R,
      NR, relu);
  TPK_CHECK();
  return 0;
}
