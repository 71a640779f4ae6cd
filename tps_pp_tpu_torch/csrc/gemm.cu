// Large-M GEMM on Hopper's tensor cores: C = epilogue(A @ B), bf16
// operands, f32 accumulation, with the epilogue of gemm.cuh (bias,
// erf-GELU, f32 residual, bf16 or f32 out, and a row LayerNorm).
//
// It carries the products of kernel 3, the encoder (the matmuls of the TPU
// kernel tps_pp_tpu/ops/pallas_encoder.py `_encoder_kernel`, which runs
// them on the matrix unit out of VMEM), and the encoder K/V projection of
// kernel 4, the whole decode (tps_pp_tpu/ops/pallas_full_decode.py, ahead
// of its step loop). At B=512 each has M = 32768 rows: the encoder's QKV
// (N 1536, K 512), fc (512, 512), W1 (256, 512) and W2 (512, 256), and the
// decode's K/V projection (6144, 512).
//
// Bound on the H100: 2 M N K operations over the tensor cores' 989 TFLOP/s
// against the bytes of A, B and C (and the residual and y) over 3.35 TB/s.
// QKV and the K/V projection are bound by operations (0.052 and 0.21 ms);
// fc and W2, which read and write the f32 residual stream and write y, by
// bytes (~0.057 and ~0.053 ms); W1 is near the line.
//
// Design. A block computes one output tile with three warpgroups: 128 x 256
// or, when the epilogue takes the LayerNorm of whole rows, 64 x 512. One thread of the producer
// warpgroup keeps a ring of shared-memory stages full by TMA (a 64-deep
// slice of A and of B a stage, in the 128-byte swizzle that wgmma reads,
// completion counted on the stage's mbarrier; rows past M land as zeros),
// so several stages of loads are in flight while the tensor cores work.
// Each consumer warpgroup owns a 64 x 256 part of the tile and runs
// wgmma m64n256k16 on each stage as it lands, with one stage's products in
// flight, and releases a stage once its products are done. B is read
// MN-major straight from the (in, out) weights: nothing is transposed. The
// epilogue stages the f32 tile in the ring's shared memory and writes
// 16-byte vectors; with the LayerNorm a warp takes whole rows, so that fc
// and W2 write x and also y = LN(x) for the next product, and no LayerNorm
// pass reads x again. The plan (tile, stages, grid) is chosen here, in the
// launcher, from N, K and the device's shared memory. One tile a block, no
// persistence: a block's epilogue does not overlap the next tile's loads.
#include <algorithm>

#include "gemm.cuh"
#include "ptx.cuh"

namespace {

constexpr int kWg = 128;                          // threads of a warpgroup
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * kWg;  // and the producer's
constexpr int kBK = 64;                           // depth of a stage: 128 B
constexpr int kMaxStages = 4;
constexpr int kWN = 256;           // columns of a consumer warpgroup
constexpr int kPad = 8;            // f32 words a staged row is padded by
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// A block's tile: WG_M x WG_N consumer warpgroups of 64 rows x kWN columns.
template <int WG_M, int WG_N>
struct Tile {
  static_assert(WG_M * WG_N == kConsumers, "two consumer warpgroups");
  static constexpr int BM = 64 * WG_M, BN = kWN * WG_N;
  static constexpr int A_BYTES = BM * kBK * 2;  // BM rows of 128 B
  static constexpr int B_BYTES = kBK * BN * 2;  // BN / 64 chunks of kBK rows
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int CLD = BN + kPad;         // staged f32 row stride
  static constexpr int C_BYTES = BM * CLD * 4;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  bf162 h[4] = {__floats2bfloat162_rn(v[0], v[1]),
                __floats2bfloat162_rn(v[2], v[3]),
                __floats2bfloat162_rn(v[4], v[5]),
                __floats2bfloat162_rn(v[6], v[7])};
  u.x = *reinterpret_cast<uint32_t*>(&h[0]);
  u.y = *reinterpret_cast<uint32_t*>(&h[1]);
  u.z = *reinterpret_cast<uint32_t*>(&h[2]);
  u.w = *reinterpret_cast<uint32_t*>(&h[3]);
  *reinterpret_cast<uint4*>(p) = u;
}

// bias, GELU and residual on 8 columns from n of output row `row`, then the
// store to c.
__device__ __forceinline__ void epilogue8(const GemmEpilogue& ep, size_t row,
                                          int n, float (&v)[8]) {
  if (ep.bias) {
    float b[8];
    load8(ep.bias + n, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += b[i];
  }
  if (ep.gelu) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = gelu_erf(v[i]);
  }
  if (ep.residual) {
    float r[8];
    load8(ep.residual + row * ep.ldr + n, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = r[i] + v[i];
  }
  if (!ep.c) return;
  if (ep.out_bf16)
    store8(reinterpret_cast<bf16*>(ep.c) + row * ep.ldc + n, v);
  else
    store8(reinterpret_cast<float*>(ep.c) + row * ep.ldc + n, v);
}

// Grid (N / BN, ceil(M / BM)); kThreads threads: consumer warpgroups 0 and
// 1, the producer warpgroup 2. `stages` stages of T::STAGE bytes, then the
// full and empty mbarriers, in dynamic shared memory.
template <int WG_M, int WG_N>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const GemmEpilogue ep, int M, int K, int stages) {
  using T = Tile<WG_M, WG_N>;
  extern __shared__ uint8_t smem_raw[];
  // the ring, and later the staged tile, 1024-byte aligned for the swizzle
  uint8_t* ring =
      smem_raw + ((1024u - (ptx::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + max(stages * T::STAGE, T::C_BYTES));
  uint64_t* empty = full + kMaxStages;
  const int wg = threadIdx.x / kWg;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int kblocks = K / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], kConsumers * 4);  // each consumer warp
    }
    ptx::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // the producer: one thread, one stage a k-block, once it is released
    ptx::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * kWg) {
      for (int kb = 0; kb < kblocks; ++kb) {
        const int s = kb % stages;
        if (kb >= stages)
          ptx::mbar_wait(&empty[s], (uint32_t)((kb / stages - 1) & 1));
        uint8_t* a = ring + s * T::STAGE;
        ptx::mbar_arrive_expect_tx(&full[s], T::STAGE);
        ptx::tma_load_2d(a, &map_a, &full[s], kb * kBK, m0);
#pragma unroll
        for (int j = 0; j < T::BN / 64; ++j)
          ptx::tma_load_2d(a + T::A_BYTES + j * kBK * 128, &map_b, &full[s],
                           n0 + 64 * j, kb * kBK);
      }
    }
    return;
  }

  ptx::setmaxnreg_inc<kConsumerRegs>();
  const int wm = WG_M > 1 ? wg : 0, wn = WG_N > 1 ? wg : 0;
  const int warp = (threadIdx.x % kWg) / 32, lane = threadIdx.x % 32;
  float acc[kWN / 2];
#pragma unroll
  for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;
  ptx::fence_acc(acc);
  for (int kb = 0; kb < kblocks; ++kb) {
    const int s = kb % stages;
    ptx::mbar_wait(&full[s], (uint32_t)((kb / stages) & 1));
    const uint8_t* a = ring + s * T::STAGE + wm * 64 * 128;
    const uint8_t* b = ring + s * T::STAGE + T::A_BYTES +
                       wn * (kWN / 64) * kBK * 128;
    ptx::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k)
      ptx::wgmma_m64n256k16(acc, ptx::wgmma_desc(a + 32 * k, 16, 1024),
                            ptx::wgmma_desc(b + 2048 * k, kBK * 128, 1024));
    ptx::wgmma_commit();
    // k-block kb - 1's products are done: release its stage
    ptx::wgmma_wait<1>();
    if (kb > 0 && lane == 0) ptx::mbar_arrive(&empty[(kb - 1) % stages]);
  }
  ptx::wgmma_wait<0>();
  ptx::fence_acc(acc);

  // every consumer is done with the ring (all its loads landed and were
  // read): stage the f32 tile there
  ptx::named_barrier_sync(1, kConsumers * kWg);
  float* cs = reinterpret_cast<float*>(ring);
  const int r = wm * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
    const int c = wn * kWN + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(cs + r * T::CLD + c) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(cs + (r + 8) * T::CLD + c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  ptx::named_barrier_sync(1, kConsumers * kWg);

  const int ct = threadIdx.x;  // 0 .. kConsumers * kWg - 1
  if constexpr (WG_M == 1) {
    static_assert(T::BN == kGemmLnWidth, "a LayerNorm row is one tile");
    // whole rows (BN == N == kGemmLnWidth): warp w takes rows 8w .. 8w + 7,
    // lane l the columns 8 l .. 8 l + 7 of each 256-column half
    constexpr int G = T::BN / 256;
    const int cw = ct / 32;
    for (int rr = 0; rr < 8; ++rr) {
      const int rl = cw * 8 + rr;
      if (m0 + rl >= M) break;
      const size_t row = (size_t)(m0 + rl);
      float v[G][8];
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 256 * g + 8 * lane;
        load8(cs + rl * T::CLD + c, v[g]);
        epilogue8(ep, row, c, v[g]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[g][i];
      }
      const float mu = warp_sum(sum) / (float)T::BN;
      float var = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float t = v[g][i] - mu;
          var += t * t;
        }
      const float rstd = rsqrtf(warp_sum(var) / (float)T::BN + ep.ln_eps);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 256 * g + 8 * lane;
        float y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = (v[g][i] - mu) * rstd;
        if (ep.ln_s) {
          float s8[8], b8[8];
          load8(ep.ln_s + c, s8);
          load8(ep.ln_b + c, b8);
#pragma unroll
          for (int i = 0; i < 8; ++i) y[i] = y[i] * s8[i] + b8[i];
        }
        store8(ep.ln_out + row * ep.ld_ln + c, y);
      }
    }
  } else {
    // 8 columns a thread, rows in order
    constexpr int G = T::BN / 8;
    for (int e = ct; e < T::BM * G; e += kConsumers * kWg) {
      const int rl = e / G, c = (e % G) * 8;
      if (m0 + rl >= M) break;
      float v[8];
      load8(cs + rl * T::CLD + c, v);
      epilogue8(ep, (size_t)(m0 + rl), n0 + c, v);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's entry point, looked up once (a function-local static's
// initialisation is thread-safe).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      return reinterpret_cast<EncodeTiled>(p);
    return nullptr;
  }();
  return fn;
}

// The map of a (rows, inner) bf16 matrix of row stride ld whose boxes are
// box_rows x 64 (128 bytes, the swizzle's width).
int tile_map(CUtensorMap* map, const bf16* base, int inner, int rows, int ld,
             int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64u, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base),
          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The plan of one tile shape: as many stages (at most kMaxStages, at most
// one a k-block) as the device's shared memory holds beside the
// alignment slack and the barriers; the staged tile reuses the ring.
template <int WG_M, int WG_N>
int launch(const bf16* A, int lda, const bf16* B, int ldb, int M, int N,
           int K, const GemmEpilogue& ep, cudaStream_t st) {
  using T = Tile<WG_M, WG_N>;
  int dev = 0, optin = 0;
  TPK_TRY((int)cudaGetDevice(&dev));
  TPK_TRY((int)cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  const int fixed = 1024 + 2 * kMaxStages * (int)sizeof(uint64_t);
  const int stages =
      std::min({kMaxStages, K / kBK, (optin - fixed) / T::STAGE});
  const int smem = fixed + std::max(stages * T::STAGE, T::C_BYTES);
  // one stage would deadlock the ring unless one k-block is all there is
  if (stages < std::min(2, K / kBK) || smem > optin)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  TPK_TRY(tile_map(&ma, A, K, M, lda, T::BM));
  TPK_TRY(tile_map(&mb, B, N, K, ldb, kBK));
  auto kernel = wgmma_gemm_kernel<WG_M, WG_N>;
  TPK_TRY((int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid(N / T::BN, (M + T::BM - 1) / T::BM);
  kernel<<<grid, kThreads, smem, st>>>(ma, mb, ep, M, K, stages);
  TPK_CHECK();
  return 0;
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

}  // namespace

int gemm_tc(const bf16* A, int lda, const bf16* B, int ldb, int M, int N,
            int K, const GemmEpilogue& ep, cudaStream_t stream) {
  if (M < 0 || K <= 0 || K % kBK || N <= 0 || N % kWN || lda % 8 ||
      ldb % 8 || misaligned(A) || misaligned(B) || (!ep.c && !ep.ln_out) ||
      (ep.c && (ep.ldc % 8 || misaligned(ep.c))) ||
      (ep.bias && misaligned(ep.bias)) ||
      (ep.residual && (ep.ldr % 8 || misaligned(ep.residual))) ||
      (ep.ln_out && (N != kGemmLnWidth || ep.ld_ln % 8 ||
                     misaligned(ep.ln_out) || !ep.ln_s != !ep.ln_b ||
                     (ep.ln_s && (misaligned(ep.ln_s) ||
                                  misaligned(ep.ln_b))))))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if (ep.ln_out) return launch<1, 2>(A, lda, B, ldb, M, N, K, ep, stream);
  return launch<2, 1>(A, lda, B, ldb, M, N, K, ep, stream);
}

// The GEMM alone (tests and chip_smoke.py hold it against the plain
// product): A (M, K), B (K, N) bf16, contiguous; c (M, N) bf16 or f32
// (out_bf16) or null; bias (N), residual (M, N) f32 or null; with ln_out
// (M, N) bf16, LN eps 1e-5, affine ln_s / ln_b or null.
extern "C" int tpk_gemm(const void* A, const void* B, void* c,
                        const float* bias, const float* residual,
                        void* ln_out, const float* ln_s, const float* ln_b,
                        int M, int N, int K, int out_bf16, int gelu,
                        void* stream) {
  GemmEpilogue ep = {c,        N,      out_bf16, bias, gelu, residual, N,
                     (bf16*)ln_out, N, ln_s,     ln_b, 1e-5f};
  return gemm_tc((const bf16*)A, K, (const bf16*)B, N, M, N, K, ep,
                 (cudaStream_t)stream);
}
