// NRTR encoder: all layers of pre-norm self-attention + FFN, then the final
// LayerNorm.
//
// Replaces the TPU kernel tps_pp_tpu/ops/pallas_encoder.py `_encoder_kernel`
// (reached from fused_encoder_forward). Contract, per layer, on the f32
// residual stream x of (N*T, D) rows:
//   y = LN(x) -> qkv = y @ Wqkv + bqkv -> per-(image, head) masked softmax
//   attention -> x += att @ Wfc -> y = LN(x) -> x += GELU(y @ W1 + b1) @ W2
//   + b2; finally out = LN(x) * s + b.
// The LayerNorm affines and the 1/sqrt(d_k) scale are folded into Wqkv/bqkv
// and W1/b1 once, when the weights are loaded (ops/encoder.py), not on every
// call as the TPU version does under jit.
//
// The TPU runs all layers in one launch with ~31 MB of weights resident in
// VMEM, and batches attention block-diagonally over several images. Neither
// carries over: an SM has 227 KB of shared memory. Here each layer is five
// launches: a bf16 tensor-core GEMM (WMMA 16x16x16, f32 accumulation) with a
// fused bias / erf-GELU / residual epilogue, a row LayerNorm without affine,
// and an attention kernel in which one block takes one (image, head) and
// keeps its T x d_k Q, K and V tiles in shared memory. No block-diagonal
// over-compute.
//
// Bound on the H100: at B=512 (32768 tokens of width 512) the GEMMs do
// ~0.54 TFLOP per forward, ~0.55 ms at the bf16 tensor-core peak; the
// activations moved between launches are ~64 MB per layer (~20 us each at
// 3.35 TB/s). This first version is bound by its GEMM: 64x64 tiles, no
// cp.async/TMA pipelining, no wgmma, so it runs far below that peak. Making
// it fast (wgmma + TMA ring, fused LN prologue) is later work.
//
// Numerics follow the TPU kernel: bf16 operands rounded where it rounds them
// (normalised activations, q/k/v, softmax weights, GELU output), f32
// accumulation, f32 LayerNorm and softmax, masked scores = -1e9. GELU uses
// CUDA's erff (within 1.5e-7 of the Abramowitz-Stegun polynomial the TPU
// kernel uses, ops/pallas_decode.py:41-50).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kGemmThreads = 128;  // 4 warps, 2 x 2, each 32 x 32
constexpr int kALd = kBK + 8;      // bf16 elements
constexpr int kBLd = kBN + 8;      // bf16 elements
constexpr int kCLd = kBN + 4;      // f32 elements

__global__ void __launch_bounds__(kGemmThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, int lda,
                 const bf16* __restrict__ B, int ldb, void* C, int ldc, int M,
                 int N, int K, const float* __restrict__ bias,
                 const float* residual, int ldr, int gelu, int out_bf16) {
  __shared__ __align__(128) bf16 As[kBM * kALd];
  __shared__ __align__(128) bf16 Bs[kBK * kBLd];
  __shared__ __align__(128) float Cs[kBM * kCLd];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int v = tid; v < kBM * kBK / 8; v += kGemmThreads) {
      const int r = v / (kBK / 8), c8 = (v % (kBK / 8)) * 8;
      const int gr = bm + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < M)
        val = *reinterpret_cast<const uint4*>(A + (size_t)gr * lda + k0 + c8);
      *reinterpret_cast<uint4*>(&As[r * kALd + c8]) = val;
    }
    for (int v = tid; v < kBK * kBN / 8; v += kGemmThreads) {
      const int r = v / (kBN / 8), c8 = (v % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * kBLd + c8]) =
          *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * ldb + bn +
                                          c8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * kALd + kk],
                               kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * kBLd + wn * 32 + j * 16], kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * kCLd + wn * 32 + j * 16],
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN, c = e % kBN;
    const int gr = bm + r, gc = bn + c;
    if (gr >= M) continue;
    float v = Cs[r * kCLd + c];
    if (bias) v += bias[gc];
    if (gelu) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    if (residual) v = residual[(size_t)gr * ldr + gc] + v;
    if (out_bf16)
      reinterpret_cast<bf16*>(C)[(size_t)gr * ldc + gc] = __float2bfloat16(v);
    else
      reinterpret_cast<float*>(C)[(size_t)gr * ldc + gc] = v;
  }
}

// One warp per row.
__global__ void layernorm_kernel(const float* __restrict__ x, int ldx,
                                 void* __restrict__ y, int ldy, int M, int D,
                                 float eps, const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 int out_bf16) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (size_t)row * ldx;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += xr[d];
  const float mu = warp_sum(s) / (float)D;
  float v = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float t = xr[d] - mu;
    v += t * t;
  }
  const float rstd = rsqrtf(warp_sum(v) / (float)D + eps);
  for (int d = lane; d < D; d += 32) {
    float o = (xr[d] - mu) * rstd;
    if (scale) o = o * scale[d] + bias[d];
    if (out_bf16)
      reinterpret_cast<bf16*>(y)[(size_t)row * ldy + d] = __float2bfloat16(o);
    else
      reinterpret_cast<float*>(y)[(size_t)row * ldy + d] = o;
  }
}

__global__ void bf16_to_f32_kernel(const bf16* __restrict__ x,
                                   float* __restrict__ y, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = __bfloat162float(x[i]);
}

// One block per (image, head); one thread per query row.
// qkv: (N*T, 3*H*DK) bf16, q|k|v column blocks; mask: (N, T) or null;
// out: (N*T, H*DK) bf16.
__global__ void encoder_attn_kernel(const bf16* __restrict__ qkv,
                                    const float* __restrict__ mask,
                                    bf16* __restrict__ out, int T, int H,
                                    int DK) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // T x (DK+1)
  float* Ss = Qs + T * (DK + 1);                   // T x (T+1)
  float* Ms = Ss + T * (T + 1);                    // T
  bf16* Ks = reinterpret_cast<bf16*>(Ms + T);      // T x DK
  bf16* Vs = Ks + T * DK;                          // T x DK
  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int HD = H * DK, rs = 3 * HD;
  const bf16* base = qkv + (size_t)n * T * rs;
  for (int e = threadIdx.x; e < T * DK; e += blockDim.x) {
    const int i = e / DK, d = e % DK;
    const bf16* row = base + (size_t)i * rs + h * DK + d;
    Qs[i * (DK + 1) + d] = __bfloat162float(row[0]);
    Ks[e] = row[HD];
    Vs[e] = row[2 * HD];
  }
  for (int j = threadIdx.x; j < T; j += blockDim.x)
    Ms[j] = mask ? mask[(size_t)n * T + j] : 1.f;
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const float* q = Qs + i * (DK + 1);
    float* s = Ss + i * (T + 1);
    float m = -INFINITY;
    for (int j = 0; j < T; ++j) {
      float acc = 0.f;
      const bf16* k = Ks + j * DK;
      for (int d = 0; d < DK; ++d) acc += q[d] * __bfloat162float(k[d]);
      acc = Ms[j] > 0.f ? acc : -1e9f;
      s[j] = acc;
      m = fmaxf(m, acc);
    }
    float sum = 0.f;
    for (int j = 0; j < T; ++j) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    for (int j = 0; j < T; ++j) s[j] = bf_round(s[j] / sum);
    bf16* o = out + ((size_t)n * T + i) * HD + h * DK;
    for (int d = 0; d < DK; ++d) {
      float acc = 0.f;
      for (int j = 0; j < T; ++j) acc += s[j] * __bfloat162float(Vs[j * DK + d]);
      o[d] = __float2bfloat16(acc);
    }
  }
}

size_t encoder_attn_smem(int T, int DK) {
  return sizeof(float) * ((size_t)T * (DK + 1) + (size_t)T * (T + 1) + T) +
         sizeof(bf16) * 2 * (size_t)T * DK;
}

}  // namespace

int tpk_launch_gemm(const bf16* A, int lda, const bf16* B, int ldb, void* C,
                    int ldc, int M, int N, int K, const float* bias,
                    const float* residual, int ldr, int gelu, int out_bf16,
                    cudaStream_t stream) {
  if (K % kBK || N % kBN || lda % 8 || ldb % 8 ||
      (reinterpret_cast<uintptr_t>(A) & 15) ||
      (reinterpret_cast<uintptr_t>(B) & 15))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  gemm_bf16_kernel<<<grid, kGemmThreads, 0, stream>>>(
      A, lda, B, ldb, C, ldc, M, N, K, bias, residual, ldr, gelu, out_bf16);
  TPK_CHECK();
  return 0;
}

int tpk_launch_layernorm(const float* x, int ldx, void* y, int ldy, int M,
                         int D, float eps, const float* scale,
                         const float* bias, int out_bf16,
                         cudaStream_t stream) {
  if (M == 0) return 0;
  const int rows_per_block = 8;
  layernorm_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                     rows_per_block * 32, 0, stream>>>(
      x, ldx, y, ldy, M, D, eps, scale, bias, out_bf16);
  TPK_CHECK();
  return 0;
}

// Whole encoder. Weights are stacked over layers and already folded:
// wqkv (L, D, 3HD) bf16, bqkv (L, 3HD) f32, wfc (L, HD, D) bf16,
// w1 (L, D, DI) bf16, b1 (L, DI) f32, w2 (L, DI, D) bf16, b2 (L, D) f32,
// lnf_s/lnf_b (D) f32. Scratch: x32 (N*T, D) f32, y (N*T, D) bf16,
// qkv (N*T, 3HD) bf16, att (N*T, HD) bf16, hid (N*T, DI) bf16.
extern "C" int tpk_encoder_forward(
    const void* x_in, const float* mask, const void* wqkv, const float* bqkv,
    const void* wfc, const void* w1, const float* b1, const void* w2,
    const float* b2, const float* lnf_s, const float* lnf_b, float* x32,
    void* y, void* qkv, void* att, void* hid, void* out, int N, int T, int D,
    int H, int DK, int DI, int L, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = N * T, HD = H * DK;
  const size_t smem = encoder_attn_smem(T, DK);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(encoder_attn_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  TPK_CHECK();
  const size_t total = (size_t)M * D;
  bf16_to_f32_kernel<<<(unsigned)((total + 255) / 256 < 65535
                                      ? (total + 255) / 256
                                      : 65535),
                       256, 0, st>>>((const bf16*)x_in, x32, total);
  TPK_CHECK();
  const int attn_threads = T < 32 ? 32 : (T > 256 ? 256 : ((T + 31) / 32) * 32);
  for (int l = 0; l < L; ++l) {
    const bf16* Wqkv = (const bf16*)wqkv + (size_t)l * D * 3 * HD;
    const bf16* Wfc = (const bf16*)wfc + (size_t)l * HD * D;
    const bf16* W1 = (const bf16*)w1 + (size_t)l * D * DI;
    const bf16* W2 = (const bf16*)w2 + (size_t)l * DI * D;
    TPK_TRY(tpk_launch_layernorm(x32, D, y, D, M, D, 1e-5f, nullptr, nullptr,
                                 1, st));
    TPK_TRY(tpk_launch_gemm((const bf16*)y, D, Wqkv, 3 * HD, qkv, 3 * HD, M,
                            3 * HD, D, bqkv + (size_t)l * 3 * HD, nullptr, 0,
                            0, 1, st));
    encoder_attn_kernel<<<N * H, attn_threads, smem, st>>>(
        (const bf16*)qkv, mask, (bf16*)att, T, H, DK);
    TPK_CHECK();
    TPK_TRY(tpk_launch_gemm((const bf16*)att, HD, Wfc, D, x32, D, M, D, HD,
                            nullptr, x32, D, 0, 0, st));
    TPK_TRY(tpk_launch_layernorm(x32, D, y, D, M, D, 1e-5f, nullptr, nullptr,
                                 1, st));
    TPK_TRY(tpk_launch_gemm((const bf16*)y, D, W1, DI, hid, DI, M, DI, D,
                            b1 + (size_t)l * DI, nullptr, 0, 1, 1, st));
    TPK_TRY(tpk_launch_gemm((const bf16*)hid, DI, W2, D, x32, D, M, D, DI,
                            b2 + (size_t)l * D, x32, D, 0, 0, st));
  }
  TPK_TRY(tpk_launch_layernorm(x32, D, out, D, M, D, 1e-5f, lnf_s, lnf_b, 1,
                               st));
  return 0;
}
