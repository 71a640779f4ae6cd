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
// carries over: an SM has 227 KB of shared memory. Here a forward is 1 + 5 L
// launches (31 for the flagship): the first LayerNorm with the bf16 -> f32
// cast of the tokens, then per layer the four products on the tensor-core
// GEMM of gemm.cu and one attention kernel.
//
// Bound on the H100 at B=512 (32768 tokens of width 512): 541 GFLOP of bf16
// products (the four GEMMs and the attention's two), 0.547 ms at 989
// TFLOP/s. Launched layer by layer, the activations cross device memory
// between launches (the f32 residual stream read and written by fc and W2,
// y, qkv, the attention output, the FFN hidden): ~0.68 GB a layer, ~0.2 ms
// at 3.35 TB/s, ~1.2 ms a forward unless the 50 MB L2 keeps some. The
// design follows from that:
//
// * the products run on wgmma fed by TMA (gemm.cu), with their bias, GELU
//   and residual in the epilogue;
// * the LayerNorm has no pass of its own after the first: fc and W2 take
//   tiles of whole rows (64 x 512), and their epilogue writes x and also
//   y = LN(x) in bf16 for the next product (the last W2 writes the final
//   LayerNorm with its affine, and no x). The first LayerNorm also makes
//   the f32 copy of the tokens, one read of each row with 16-byte loads;
// * the attention runs on the tensor cores: one block takes one image and
//   two heads, copies their Q, K and V (T x d_k = 64 x 64 bf16 each) into
//   shared memory with 16-byte asynchronous copies, and each of its 4 warps
//   takes 16 query rows: S = Q K^T with ldmatrix + mma.sync m16n8k16, the
//   mask and softmax in f32 registers (a quad of lanes holds a row),
//   normalised and rounded to bf16 as the contract has it, then P V from
//   the same registers (the accumulator layout of S is the A operand's)
//   with V through ldmatrix.trans, and the bf16 output written back through
//   the warp's own Q rows as 16-byte stores. T = 64 keys fit whole, so the
//   softmax is exact in one pass; an image with every key masked gets
//   uniform weights over its own 64 keys, as in the plain version.
//
// Numerics follow the TPU kernel: bf16 operands rounded where it rounds them
// (normalised activations, q/k/v, softmax weights, GELU output), f32
// accumulation, f32 LayerNorm and softmax, masked scores = -1e9. GELU uses
// CUDA's erff (within 1.5e-7 of the Abramowitz-Stegun polynomial the TPU
// kernel uses, ops/pallas_decode.py:41-50).
#include "gemm.cuh"
#include "ptx.cuh"

namespace {

constexpr int kT = 64;               // tokens of an image (4 x 16 cells)
constexpr int kDk = 64;              // dims of a head
constexpr int kD = kGemmLnWidth;     // d_model: a LayerNorm row
constexpr int kLd = kDk + 8;         // shared row stride (bf16), 144 bytes:
                                     // ldmatrix rows fall in distinct banks
constexpr int kAttnThreads = 128;    // 4 warps x 16 query rows
constexpr float kEps = 1e-5f;

// The first LayerNorm, with the cast: one warp a row, a lane 8 columns of
// each 256-column half (16-byte loads and stores): x32 = f32(x);
// y = bf16(LN(x32)) (eps, no affine).
__global__ void __launch_bounds__(256)
layernorm_cast_kernel(const bf16* __restrict__ x, float* __restrict__ x32,
                      bf16* __restrict__ y, int M) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  constexpr int G = kD / 256;
  float v[G][8];
  float sum = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t at = (size_t)row * kD + 256 * g + 8 * lane;
    const uint4 u = *reinterpret_cast<const uint4*>(x + at);
    const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[g][2 * i] = f.x;
      v[g][2 * i + 1] = f.y;
      sum += f.x + f.y;
    }
    reinterpret_cast<float4*>(x32 + at)[0] =
        make_float4(v[g][0], v[g][1], v[g][2], v[g][3]);
    reinterpret_cast<float4*>(x32 + at)[1] =
        make_float4(v[g][4], v[g][5], v[g][6], v[g][7]);
  }
  const float mu = warp_sum(sum) / (float)kD;
  float var = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float t = v[g][i] - mu;
      var += t * t;
    }
  const float rstd = rsqrtf(warp_sum(var) / (float)kD + kEps);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bf162 h = __floats2bfloat162_rn((v[g][2 * i] - mu) * rstd,
                                            (v[g][2 * i + 1] - mu) * rstd);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(y + (size_t)row * kD + 256 * g + 8 * lane) = u;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Grid N * (H / hg): block b takes image b / (H / hg) and heads
// hg (b % (H / hg)) .. + hg - 1. qkv (N*T, 3 H d_k) bf16, q|k|v column
// blocks; mask (N, T), key valid iff > 0; out (N*T, H d_k) bf16. Dynamic
// shared memory: hg x (Q, K, V) tiles of kT x kLd bf16, then kT floats.
__global__ void __launch_bounds__(kAttnThreads)
encoder_attn_kernel(const bf16* __restrict__ qkv,
                    const float* __restrict__ mask, bf16* __restrict__ out,
                    int H, int hg) {
  extern __shared__ __align__(16) uint8_t attn_smem[];
  bf16* tiles = reinterpret_cast<bf16*>(attn_smem);
  float* keep = reinterpret_cast<float*>(tiles + hg * 3 * kT * kLd);
  const int groups = H / hg;
  const int n = blockIdx.x / groups, h0 = (blockIdx.x % groups) * hg;
  const int HD = H * kDk, rs = 3 * HD;
  const bf16* src = qkv + (size_t)n * kT * rs;
  // tile t = head * 3 + (q | k | v), row r, 16-byte chunk c
  for (int e = threadIdx.x; e < hg * 3 * kT * 8; e += kAttnThreads) {
    const int c = e & 7, r = (e >> 3) % kT, t = (e >> 3) / kT;
    ptx::cp_async16(tiles + (t * kT + r) * kLd + 8 * c,
                    src + (size_t)r * rs + (t % 3) * HD +
                        (h0 + t / 3) * kDk + 8 * c);
  }
  if (threadIdx.x < kT) keep[threadIdx.x] = mask[(size_t)n * kT + threadIdx.x];
  ptx::cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q4 = lane % 4, mi = lane / 8;
  const int r0 = 16 * warp;  // this warp's query rows r0 .. r0 + 15
  for (int hh = 0; hh < hg; ++hh) {
    bf16* Q = tiles + hh * 3 * kT * kLd;
    const bf16* Kt = Q + kT * kLd;
    const bf16* V = Kt + kT * kLd;
    // S = Q K^T: 8 tiles of 8 keys, s[j] = {(g, 2q4), (g, 2q4 + 1),
    // (g + 8, 2q4), (g + 8, 2q4 + 1)} of keys 8 j .., g = lane / 4
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk) {
      uint32_t a[4];
      ptx::ldsm_x4(a, Q + (r0 + (lane & 15)) * kLd + 16 * kk + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ptx::ldsm_x4(b, Kt + (16 * jp + (mi >> 1) * 8 + (lane & 7)) * kLd +
                            16 * kk + (mi & 1) * 8);
        ptx::mma_bf16(s[2 * jp], a, b[0], b[1]);
        ptx::mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
    // mask, then the softmax of rows g and g + 8 over the quad's lanes
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!(keep[8 * j + 2 * q4 + (i & 1)] > 0.f)) s[j][i] = -1e9f;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = expf(s[j][i] - mx[i >> 1]);
        sum[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
    // p = bf16(e / sum), as A fragments of P V: keys 16 kk .. are S tiles
    // 2 kk and 2 kk + 1
    uint32_t p[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[j][0] = pack_bf16(s[j][0] / sum[0], s[j][1] / sum[0]);
      p[j][1] = pack_bf16(s[j][2] / sum[1], s[j][3] / sum[1]);
    }
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                             p[2 * kk + 1][1]};
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ptx::ldsm_x4_t(b, V + (16 * kk + (mi & 1) * 8 + (lane & 7)) * kLd +
                              16 * jp + (mi >> 1) * 8);
        ptx::mma_bf16(o[2 * jp], a, b[0], b[1]);
        ptx::mma_bf16(o[2 * jp + 1], a, b[2], b[3]);
      }
    }
    // the bf16 output through this warp's own Q rows, then 16-byte stores
    __syncwarp();
    const int g = lane / 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(Q + (r0 + g) * kLd + 8 * j + 2 * q4) =
          pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(Q + (r0 + g + 8) * kLd + 8 * j + 2 * q4) =
          pack_bf16(o[j][2], o[j][3]);
    }
    __syncwarp();
    bf16* dst = out + ((size_t)n * kT + r0) * HD + (h0 + hh) * kDk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * i + lane / 8, c = lane % 8;
      *reinterpret_cast<uint4*>(dst + (size_t)rr * HD + 8 * c) =
          *reinterpret_cast<const uint4*>(Q + (r0 + rr) * kLd + 8 * c);
    }
  }
}

// Two heads a block where H allows it.
int launch_attention(const bf16* qkv, const float* mask, bf16* out, int N,
                     int H, cudaStream_t st) {
  const int hg = H % 2 ? 1 : 2;
  const size_t smem =
      sizeof(bf16) * hg * 3 * kT * kLd + sizeof(float) * kT;
  TPK_TRY((int)cudaFuncSetAttribute(
      encoder_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem));
  encoder_attn_kernel<<<N * (H / hg), kAttnThreads, smem, st>>>(qkv, mask,
                                                                out, H, hg);
  TPK_CHECK();
  return 0;
}

}  // namespace

// The attention alone (tests and chip_smoke.py hold it against the plain
// version): qkv (N*T, 3 H DK) bf16, mask (N, T) f32, out (N*T, H DK) bf16.
// Needs T == 64, DK == 64.
extern "C" int tpk_encoder_attention(const void* qkv, const float* mask,
                                     void* out, int N, int T, int H, int DK,
                                     void* stream) {
  if (T != kT || DK != kDk || H < 1 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_attention((const bf16*)qkv, mask, (bf16*)out, N, H,
                          (cudaStream_t)stream);
}

// Whole encoder. Weights are stacked over layers and already folded:
// wqkv (L, D, 3HD) bf16, bqkv (L, 3HD) f32, wfc (L, HD, D) bf16,
// w1 (L, D, DI) bf16, b1 (L, DI) f32, w2 (L, DI, D) bf16, b2 (L, D) f32,
// lnf_s/lnf_b (D) f32. Scratch: x32 (N*T, D) f32, y (N*T, D) bf16,
// qkv (N*T, 3HD) bf16, att (N*T, HD) bf16, hid (N*T, DI) bf16. Needs
// T == 64, DK == 64, D == 512, 3 HD and DI multiples of 256.
extern "C" int tpk_encoder_forward(
    const void* x_in, const float* mask, const void* wqkv, const float* bqkv,
    const void* wfc, const void* w1, const float* b1, const void* w2,
    const float* b2, const float* lnf_s, const float* lnf_b, float* x32,
    void* y, void* qkv, void* att, void* hid, void* out, int N, int T, int D,
    int H, int DK, int DI, int L, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = N * T, HD = H * DK;
  if (T != kT || DK != kDk || D != kD || H < 1 || L < 1 || N < 0 ||
      (3 * HD) % 256 || DI < 256 || DI % 256)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  bf16* yb = (bf16*)y;
  layernorm_cast_kernel<<<(M + 7) / 8, 256, 0, st>>>((const bf16*)x_in, x32,
                                                     yb, M);
  TPK_CHECK();
  for (int l = 0; l < L; ++l) {
    const bf16* Wqkv = (const bf16*)wqkv + (size_t)l * D * 3 * HD;
    const bf16* Wfc = (const bf16*)wfc + (size_t)l * HD * D;
    const bf16* W1 = (const bf16*)w1 + (size_t)l * D * DI;
    const bf16* W2 = (const bf16*)w2 + (size_t)l * DI * D;
    const bool last = l == L - 1;
    // c, ldc, out_bf16, bias, gelu, residual, ldr, ln_out, ld_ln, ln_s,
    // ln_b, ln_eps
    const GemmEpilogue e_qkv = {qkv, 3 * HD, 1, bqkv + (size_t)l * 3 * HD,
                                0, nullptr, 0, nullptr, 0, nullptr,
                                nullptr, 0.f};
    const GemmEpilogue e_fc = {x32, D, 0, nullptr, 0, x32, D, yb, D,
                               nullptr, nullptr, kEps};
    const GemmEpilogue e_w1 = {hid, DI, 1, b1 + (size_t)l * DI, 1, nullptr,
                               0, nullptr, 0, nullptr, nullptr, 0.f};
    const GemmEpilogue e_w2 = {last ? nullptr : x32, D, 0,
                               b2 + (size_t)l * D, 0, x32, D,
                               last ? (bf16*)out : yb, D,
                               last ? lnf_s : nullptr,
                               last ? lnf_b : nullptr, kEps};
    TPK_TRY(gemm_tc(yb, D, Wqkv, 3 * HD, M, 3 * HD, D, e_qkv, st));
    TPK_TRY(launch_attention((const bf16*)qkv, mask, (bf16*)att, N, H, st));
    TPK_TRY(gemm_tc((const bf16*)att, HD, Wfc, D, M, D, HD, e_fc, st));
    TPK_TRY(gemm_tc(yb, D, W1, DI, M, DI, D, e_w1, st));
    TPK_TRY(gemm_tc((const bf16*)hid, DI, W2, D, M, D, DI, e_w2, st));
  }
  return 0;
}
