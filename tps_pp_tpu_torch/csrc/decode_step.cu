// One NRTR decode step of one layer: self-attention, and cross-attention +
// FFN.
//
// Replaces the TPU kernels tps_pp_tpu/ops/pallas_decode.py
// `_self_attn_kernel` (reached from self_attn_step) and `_cross_ffn_kernel`
// (cross_ffn_step), which the JAX `steps` decode runs per layer and step
// with use_fused_step=True. Contracts, x (N, D) of type X (bf16 or f32,
// as the TPU kernels take either; the caches and encoder K/V are of type X
// too, the weights bf16), f32 inside a call:
//   tpk_self_attn_step: y = LN(x) * s + b -> qkv = bf16(y) @ Wqkv (no bias)
//     -> q *= 1/sqrt(d_k) -> cache slot t <- X(k), X(v) -> per head a
//     softmax over slots 0..t, reading slot t as the unrounded f32 k/v and
//     the earlier slots as stored, f32 weights -> x_out = X(x +
//     bf16(merged) @ Wfc).
//   tpk_cross_ffn_step: y = LN2(x) -> q = bf16(y) @ Wq * 1/sqrt(d_k) ->
//     softmax over the encoder K/V (key valid iff mask > 0, else -1e9), f32
//     weights -> x2 = x + bf16(merged) @ Wfc (f32, not rounded) -> h =
//     GELU(bf16(LN3(x2)) @ W1 + b1) -> x_out = X(x2 + bf16(h) @ W2 + b2).
// LayerNorms keep their affine (eps 1e-5); nothing is folded, unlike the
// whole-decode kernel.
//
// The TPU kernels hold a batch block's caches or encoder K/V and all the
// layer's weights in VMEM for one launch, and, because Pallas aliases the
// caches, write the whole cache block back every step: twice the cache
// traffic of an in-place slot update, which is what made them lose to
// XLA's loop at large batch on the TPU (tps_pp_tpu/apis/flagship.py:53-58).
// Here each entry point is a few launches: a LayerNorm that also keeps the
// f32 copy of x, a WMMA GEMM with fused epilogues (bias, GELU, residual,
// f32 or bf16 out; 64 x 64 tiles, unpipelined: these products have N <= 512
// rows), and one attention kernel for both, one
// warp per (row, head) (d_k = 64: two dims per lane; scores of a warp in
// shared memory). The self-attention reads slots 0..t-1 and writes slot t
// only.
//
// Bound on the H100 at N=512 (flagship: D=512, H=8, T=41, TE=64, DI=256):
// memory. The self-attention step moves the weights (2 MB bf16) and t
// cache slots of K and V (1.05 MB per slot), ~21 MB at the mean step t=20,
// ~7 us at 3.35 TB/s; the cross step reads 67 MB of encoder K/V, ~20 us.
// Both are far below that in this first version: each is 4-7 launches of
// a few microseconds, the attention's key loop is serial within a warp,
// and the host loop of the `steps` decode issues 2 x 6 of them per step.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

// ---- the products and the LayerNorm of the step --------------------------
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

// C[M,N] = epilogue(A[M,K] @ B[K,N]): bf16 operands, f32 accumulation;
// epilogue = (+bias[N]) -> (erf-GELU) -> (residual[M,N] +) -> f32 or bf16.
// `residual` may alias C (in-place residual add). Needs K % 32 == 0,
// N % 64 == 0, lda/ldb % 8 == 0 and 16-byte aligned A/B.
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

// Row LayerNorm of f32 rows: (x - mean) * rsqrt(var + eps), then the affine
// when scale/bias are given; output f32 or bf16.
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

constexpr int kWarps = 4;
constexpr int kMaxKeys = 256;
constexpr int kDk = 64;

static __device__ __forceinline__ float to_f32(bf16 v) {
  return __bfloat162float(v);
}
static __device__ __forceinline__ float to_f32(float v) { return v; }

// One warp per row: x32 = f32(x); y = bf16((x - mean) * rstd * s + b).
template <typename X>
__global__ void ln_affine_kernel(const X* __restrict__ x,
                                 float* __restrict__ x32,
                                 bf16* __restrict__ y,
                                 const float* __restrict__ s,
                                 const float* __restrict__ b, int M, int D,
                                 float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const X* xr = x + (size_t)row * D;
  float* xo = x32 + (size_t)row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_f32(xr[d]);
    xo[d] = v;
    sum += v;
  }
  const float mu = warp_sum(sum) / (float)D;
  float var = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float u = xo[d] - mu;
    var += u * u;
  }
  const float rstd = rsqrtf(warp_sum(var) / (float)D + eps);
  for (int d = lane; d < D; d += 32)
    y[(size_t)row * D + d] = __float2bfloat16((xo[d] - mu) * rstd * s[d] +
                                              b[d]);
}

// One warp per (row n, head h): the softmax attention of q (f32 rows of
// stride q_rs, unscaled) over the keys 0..nkeys-1 of k/v (N, H, kv_len, 64)
// of type KV, with f32 weights. mask (N, nkeys): key j valid iff mask > 0, else
// -1e9 (null = all valid). With t_new >= 0 this step's k/v are the f32
// values at q + HD and q + 2HD: they are stored to slot t_new, rounded to
// KV, and read there unrounded. att (N, HD) bf16.
template <typename KV>
__global__ void __launch_bounds__(kWarps * 32)
attend_step_kernel(const float* __restrict__ q, int q_rs,
                   KV* __restrict__ k, KV* __restrict__ v, int kv_len,
                   int nkeys, const float* __restrict__ mask, int t_new,
                   bf16* __restrict__ att, int N, int H, float scale) {
  __shared__ float sc[kWarps][kMaxKeys];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;  // = n * H + h
  if (w >= N * H) return;
  const int n = w / H, h = w % H, HD = H * kDk;
  const float* row = q + (size_t)n * q_rs + h * kDk;
  float2 qv = load2(row, lane);
  qv.x *= scale;
  qv.y *= scale;
  KV* kr = k + (size_t)w * kv_len * kDk;
  KV* vr = v + (size_t)w * kv_len * kDk;
  float2 kt = make_float2(0.f, 0.f), vt = kt;
  if (t_new >= 0) {
    kt = load2(row + HD, lane);
    vt = load2(row + 2 * HD, lane);
    store2(kr + (size_t)t_new * kDk, lane, kt.x, kt.y);
    store2(vr + (size_t)t_new * kDk, lane, vt.x, vt.y);
  }
  const float* mr = mask ? mask + (size_t)n * nkeys : nullptr;
  float m = -INFINITY;
#pragma unroll 4
  for (int j = 0; j < nkeys; ++j) {
    const float2 kf = j == t_new ? kt : load2(kr + (size_t)j * kDk, lane);
    float s = warp_sum(qv.x * kf.x + qv.y * kf.y);
    if (mr && !(mr[j] > 0.f)) s = -1e9f;
    if (lane == 0) sc[warp][j] = s;
    m = fmaxf(m, s);
  }
  __syncwarp();
  float sum = 0.f;
  for (int j = 0; j < nkeys; ++j) sum += expf(sc[warp][j] - m);
  float ox = 0.f, oy = 0.f;
#pragma unroll 4
  for (int j = 0; j < nkeys; ++j) {
    const float p = expf(sc[warp][j] - m) / sum;
    const float2 vf = j == t_new ? vt : load2(vr + (size_t)j * kDk, lane);
    ox += p * vf.x;
    oy += p * vf.y;
  }
  store2(att + (size_t)n * HD + h * kDk, lane, ox, oy);
}

constexpr int kLnRows = 8;  // rows (warps) per LayerNorm block

int launch_ln_affine(const void* x, int is_bf16, float* x32, void* y,
                     const float* s, const float* b, int M, int D,
                     cudaStream_t st) {
  const int blocks = (M + kLnRows - 1) / kLnRows, threads = kLnRows * 32;
  if (is_bf16)
    ln_affine_kernel<bf16><<<blocks, threads, 0, st>>>(
        (const bf16*)x, x32, (bf16*)y, s, b, M, D, 1e-5f);
  else
    ln_affine_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, x32, (bf16*)y, s, b, M, D, 1e-5f);
  TPK_CHECK();
  return 0;
}

// attend_step_kernel over k/v of type bf16 (is_bf16) or f32.
int launch_attend_step(const float* q, int q_rs, void* k, void* v,
                       int kv_len, int nkeys, const float* mask, int t_new,
                       void* att, int N, int H, int is_bf16,
                       cudaStream_t st) {
  const int blocks = (N * H + kWarps - 1) / kWarps, threads = kWarps * 32;
  const float scale = 1.f / sqrtf((float)kDk);
  if (is_bf16)
    attend_step_kernel<bf16><<<blocks, threads, 0, st>>>(
        q, q_rs, (bf16*)k, (bf16*)v, kv_len, nkeys, mask, t_new, (bf16*)att,
        N, H, scale);
  else
    attend_step_kernel<float><<<blocks, threads, 0, st>>>(
        q, q_rs, (float*)k, (float*)v, kv_len, nkeys, mask, t_new,
        (bf16*)att, N, H, scale);
  TPK_CHECK();
  return 0;
}

}  // namespace

// The limits of both entry points, the only copy of them: d_k == 64 (two
// dims per lane of a warp), d_model and d_inner multiples of 64 (the GEMM's
// tiles), at most kMaxKeys keys (a warp's scores sit in shared memory).
// Outside them an entry point launches nothing and returns
// cudaErrorInvalidValue.
//
// Self-attention step. is_bf16 selects X: 1 = bf16, 0 = f32. x (N, D) X;
// ck/cv (N, H, T, DK) X, slot t written in place; wqkv (D, 3HD), wfc
// (HD, D) bf16; ln_s/ln_b (D) f32. Scratch: x32 (N, D) f32, y (N, D) bf16,
// qkv (N, 3HD) f32, att (N, HD) bf16. Output x_out (N, D) X.
extern "C" int tpk_self_attn_step(const void* x, void* ck, void* cv,
                                  const void* wqkv, const void* wfc,
                                  const float* ln_s, const float* ln_b,
                                  float* x32, void* y, float* qkv, void* att,
                                  void* x_out, int N, int D, int H, int DK,
                                  int T, int t, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * DK;
  if (DK != kDk || D % 64 || t < 0 || t >= T || t >= kMaxKeys)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  TPK_TRY(launch_ln_affine(x, is_bf16, x32, y, ln_s, ln_b, N, D, st));
  TPK_TRY(tpk_launch_gemm((const bf16*)y, D, (const bf16*)wqkv, 3 * HD, qkv,
                          3 * HD, N, 3 * HD, D, nullptr, nullptr, 0, 0, 0,
                          st));
  TPK_TRY(launch_attend_step(qkv, 3 * HD, ck, cv, T, t + 1, nullptr, t, att,
                             N, H, is_bf16, st));
  TPK_TRY(tpk_launch_gemm((const bf16*)att, HD, (const bf16*)wfc, D, x_out,
                          D, N, D, HD, nullptr, x32, D, 0, is_bf16, st));
  return 0;
}

// Cross-attention + FFN step. x (N, D) X; ek/ev (N, H, TE, DK) X; mask
// (N, TE) f32; wq (D, HD), wfc (HD, D), w1 (D, DI), w2 (DI, D) bf16; b1
// (DI), b2 (D), ln2_s/ln2_b/ln3_s/ln3_b (D) f32. Scratch: x32 (N, D) f32,
// y (N, D) bf16, q32 (N, HD) f32, att (N, HD) bf16, hid (N, DI) bf16.
// Output x_out (N, D) X.
extern "C" int tpk_cross_ffn_step(
    const void* x, const void* ek, const void* ev, const float* mask,
    const void* wq, const void* wfc, const float* ln2_s, const float* ln2_b,
    const void* w1, const float* b1, const void* w2, const float* b2,
    const float* ln3_s, const float* ln3_b, float* x32, void* y, float* q32,
    void* att, void* hid, void* x_out, int N, int D, int H, int DK, int TE,
    int DI, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * DK;
  if (DK != kDk || D % 64 || DI % 64 || TE < 1 || TE > kMaxKeys)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  TPK_TRY(launch_ln_affine(x, is_bf16, x32, y, ln2_s, ln2_b, N, D, st));
  TPK_TRY(tpk_launch_gemm((const bf16*)y, D, (const bf16*)wq, HD, q32, HD, N,
                          HD, D, nullptr, nullptr, 0, 0, 0, st));
  // the encoder K/V are read only: t_new < 0 stores nothing
  TPK_TRY(launch_attend_step(q32, HD, (void*)ek, (void*)ev, TE, TE, mask, -1,
                             att, N, H, is_bf16, st));
  // x2 = x + bf16(merged) @ Wfc, kept in f32 (in place over x32)
  TPK_TRY(tpk_launch_gemm((const bf16*)att, HD, (const bf16*)wfc, D, x32, D,
                          N, D, HD, nullptr, x32, D, 0, 0, st));
  TPK_TRY(tpk_launch_layernorm(x32, D, y, D, N, D, 1e-5f, ln3_s, ln3_b, 1,
                               st));
  TPK_TRY(tpk_launch_gemm((const bf16*)y, D, (const bf16*)w1, DI, hid, DI, N,
                          DI, D, b1, nullptr, 0, 1, 1, st));
  TPK_TRY(tpk_launch_gemm((const bf16*)hid, DI, (const bf16*)w2, D, x_out, D,
                          N, D, DI, b2, x32, D, 0, is_bf16, st));
  return 0;
}
