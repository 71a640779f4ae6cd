// The NRTR decode's building blocks, shared by the whole decode
// (full_decode.cu) and the per-step kernels (decode_step.cu): dependent
// launch, the skinny-M step GEMM with split-K through clusters, the row
// LayerNorm of the whole decode, and the one-query attention with lanes
// over keys. Everything here has internal linkage (an anonymous namespace), so
// each source that includes it gets its own copy.
//
// A kernel here that takes a `go` gate (the whole decode's step gate)
// returns at once when *go is 0; step_gemm_kernel also takes a null gate
// (the per-step kernels have none), and attend_keys_kernel's per-step
// contract reads none. The per-step kernels' gate is `skip` instead, a
// one-byte flag (null: none), "every row ended before this step": where
// it is set, attend_keys_kernel returns at once and step_gemm_kernel
// writes its residual through to C (C = res) and returns. Every
// kernel calls ptx::grid_dep_wait() before it reads what an earlier kernel
// of the stream wrote, before it writes anything and before it exits, and
// ptx::grid_dep_launch() only after that wait, so that each kernel's
// completion implies every earlier one's; without the launch attribute
// both are no-ops.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kAttnWarps = 4;
constexpr int kShortKeys = 256;   // keys of the first template case
constexpr int kMaxKeys = 512;     // keys of the second
constexpr int kDk = 64;           // the step kernels' head width

// Launches `kernel` in clusters of cluster_z blocks along z, with
// programmatic stream serialization: it may start while the kernel before
// it on the stream still runs, and waits for it in ptx::grid_dep_wait().
template <typename... KArgs, typename... Args>
int launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem,
               cudaStream_t st, unsigned cluster_z, Args... args) {
  cudaLaunchAttribute attr[2];
  int n = 0;
  attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[n++].val.programmaticStreamSerializationAllowed = 1;
  if (cluster_z > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = 1;
    attr[n].val.clusterDim.y = 1;
    attr[n++].val.clusterDim.z = cluster_z;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  TPK_CHECK();
  return 0;
}

// Lets `kernel` take up to 227 KB of dynamic shared memory when a launch
// needs more than 48 KB: set once per (kernel, device), a host call that
// a decode step would otherwise repeat at every launch. The record is read
// and written under a lock: host threads launch on their cards at once.
template <typename... KArgs>
int allow_smem(void (*kernel)(KArgs...), size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  static const void* done_fn[32];
  static int done_dev[32], done_n = 0;
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < done_n; ++i)
    if (done_fn[i] == (const void*)kernel && done_dev[i] == dev) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (done_n < 32) {
    done_fn[done_n] = (const void*)kernel;
    done_dev[done_n++] = dev;
  }
  return 0;
}

static __device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---- the step products ---------------------------------------------------
// Each step product as step_gemm_kernel: 64-row tiles (M = 64 fits one),
// BN in {16, 32, 64} columns, and split-K, so that every product runs on
// >= 132 blocks. Each block streams its K range through a ring of 4
// shared-memory stages of A and B tiles fed by 16-byte asynchronous copies
// (cp.async; every thread arrives on the stage's mbarrier once its copies
// have landed), so up to 4 stages of loads are in flight while the tensor
// cores work on the oldest (mma.sync m16n8k16 from ldmatrix fragments;
// rows padded by 16 bytes, free of bank conflicts). mma.sync, not wgmma:
// the products are ~1 GFLOP a step, ~1 us at the tensor cores' peak, and
// their time is load latency. Split-K is deterministic and stays on chip:
// the parts of a tile are one cluster of blocks, each keeps its f32
// partial tile in its shared memory, and each sums a share of the tile's
// rows over the cluster's partials in split order (distributed shared
// memory) and runs their epilogue, so replays give equal bits.
constexpr int kBM = 64;            // rows of a tile: 4 warps x 16
constexpr int kBK = 32;            // depth of a stage (16 for a 16-deep rest)
constexpr int kStages = 4;         // stages in flight
constexpr int kGemmThreads = 128;

// C[M, N] = epilogue(A[M, K] @ B[K, N]), bf16 operands (A rows of lda, B
// the (K, N) weights of ldb), f32 accumulation; epilogue = (+bias[N]) ->
// (erf-GELU) -> (res[M, N] +, res f32 or bf16 of row stride ldr; res may be
// an f32 C, read then written in place) -> f32 or bf16. `splits` parts of K
// (K % (16 * splits) == 0, splits <= kMaxSplits), one block each, the
// blocks of a tile one cluster.
constexpr int kMaxSplits = 8;      // the portable cluster size
struct StepGemm {
  const bf16* A;
  const bf16* B;
  void* C;
  const float* bias;
  const void* res;
  const int* go;
  const unsigned char* skip;   // set: C = res, no product (needs res)
  int lda, ldb, ldc, ldr, M, N, K, splits, gelu, res_bf16, out_bf16;
};

// Elements c, c + 1 of an f32 or bf16 row.
static __device__ __forceinline__ float2 load_pair(const void* p, bool is_bf16,
                                                   size_t at) {
  return is_bf16 ? load2(reinterpret_cast<const bf16*>(p) + at, 0)
                 : load2(reinterpret_cast<const float*>(p) + at, 0);
}

// The epilogue of columns c, c + 1 of row r.
static __device__ __forceinline__ void epilogue2(const StepGemm& p, int r,
                                                 int c, float v0, float v1) {
  if (p.bias) {
    v0 += p.bias[c];
    v1 += p.bias[c + 1];
  }
  if (p.gelu) {
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  }
  if (p.res) {
    const float2 old = load_pair(p.res, p.res_bf16, (size_t)r * p.ldr + c);
    v0 = old.x + v0;
    v1 = old.y + v1;
  }
  const size_t at = (size_t)r * p.ldc + c;
  if (p.out_bf16)
    store2(reinterpret_cast<bf16*>(p.C) + at, 0, v0, v1);
  else
    store2(reinterpret_cast<float*>(p.C) + at, 0, v0, v1);
}

// Every thread copies its share of one stage: `depth` rows from k0 of the
// tile's B columns (fill_b; the weights, which no kernel of the loop
// writes), and the `depth` columns from k0 of its A rows (fill_a), in
// 16-byte asynchronous copies (rows of A past M are not copied; they only
// reach output rows that are not stored); then it arrives on the stage's
// mbarrier, which completes once they have landed.
template <int BN>
static __device__ __forceinline__ void fill_b(const StepGemm& p, bf16* bs,
                                              int n0, int k0, int depth,
                                              int tid) {
  constexpr int BLD = BN + 8, BV = BN / 8;
  for (int e = tid; e < depth * BV; e += kGemmThreads) {
    const int r = e / BV, c = (e % BV) * 8;
    ptx::cp_async16(bs + r * BLD + c,
                    p.B + (size_t)(k0 + r) * p.ldb + n0 + c);
  }
}

static __device__ __forceinline__ void fill_a(const StepGemm& p, bf16* as,
                                              uint64_t* bar, int m0, int rows,
                                              int k0, int depth, int tid) {
  constexpr int ALD = kBK + 8;
  const int av = depth / 8;
  for (int e = tid; e < rows * av; e += kGemmThreads) {
    const int r = e / av, c = (e % av) * 8;
    ptx::cp_async16(as + r * ALD + c, p.A + (size_t)(m0 + r) * p.lda + k0 + c);
  }
  ptx::cp_async_mbar_arrive(bar);
}

// Grid (N / BN, ceil(M / 64), splits), clusters of splits blocks along z.
// Warp w owns rows 16w .. 16w+15 of the tile and all BN columns.
template <int BN>
__global__ void __launch_bounds__(kGemmThreads)
step_gemm_kernel(const StepGemm p) {
  constexpr int NF = BN / 8;       // n fragments of a warp
  constexpr int ALD = kBK + 8;     // A row stride in smem (80 B)
  constexpr int BLD = BN + 8;      // B row stride (2 BN + 16 B)
  __shared__ __align__(128) bf16 As[kStages][kBM * ALD];
  __shared__ __align__(128) bf16 Bs[kStages][kBK * BLD];
  __shared__ __align__(8) uint64_t bar[kStages];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int rows = min(kBM, p.M - m0);
  const int krange = p.K / p.splits, kbeg = blockIdx.z * krange;
  const int nsteps = (krange + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) ptx::mbar_init(&bar[s], kGemmThreads);
    ptx::mbar_fence_init();
  }
  __syncthreads();

  // the first stages' weights before the wait on the kernel before, their
  // activations after it
  const int pre = min(kStages, nsteps);
  for (int st = 0; st < pre; ++st)
    fill_b<BN>(p, Bs[st], n0, kbeg + st * kBK, min(kBK, krange - st * kBK),
               tid);
  ptx::grid_dep_wait();
  if (p.go && !*p.go) {
    ptx::cp_async_wait_all();
    return;
  }
  if (p.skip && *p.skip) {
    // a skipped step: the tile's first part writes res through to C
    ptx::cp_async_wait_all();
    if (blockIdx.z == 0)
      for (int e = tid; e < rows * (BN / 2); e += kGemmThreads) {
        const int r = m0 + e / (BN / 2), c = n0 + (e % (BN / 2)) * 2;
        const float2 v = load_pair(p.res, p.res_bf16, (size_t)r * p.ldr + c);
        const size_t at = (size_t)r * p.ldc + c;
        if (p.out_bf16)
          store2(reinterpret_cast<bf16*>(p.C) + at, 0, v.x, v.y);
        else
          store2(reinterpret_cast<float*>(p.C) + at, 0, v.x, v.y);
      }
    return;
  }
  ptx::grid_dep_launch();
  for (int st = 0; st < pre; ++st)
    fill_a(p, As[st], &bar[st], m0, rows, kbeg + st * kBK,
           min(kBK, krange - st * kBK), tid);

  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const int wr = warp * 16, mi = lane >> 3;
  for (int st = 0; st < nsteps; ++st) {
    const int s = st % kStages;
    ptx::mbar_wait(&bar[s], (uint32_t)((st / kStages) & 1));
    const int depth = min(kBK, krange - st * kBK);
    for (int kk = 0; kk < depth; kk += 16) {
      uint32_t a[4];
      ptx::ldsm_x4(a, &As[s][(wr + (lane & 15)) * ALD + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < NF / 2; ++j) {
        uint32_t b[4];
        ptx::ldsm_x4_t(b, &Bs[s][(kk + (mi & 1) * 8 + (lane & 7)) * BLD +
                                 j * 16 + (mi >> 1) * 8]);
        ptx::mma_bf16(acc[2 * j], a, b[0], b[1]);
        ptx::mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (st + kStages < nsteps) {
      const int nx = st + kStages;
      const int k0 = kbeg + nx * kBK, depth = min(kBK, krange - nx * kBK);
      fill_b<BN>(p, Bs[s], n0, k0, depth, tid);
      fill_a(p, As[s], &bar[s], m0, rows, k0, depth, tid);
    }
  }

  const int g = lane >> 2, q = lane & 3;
  if (p.splits == 1) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + g + 8 * h;
        if (r < rows)
          epilogue2(p, m0 + r, n0 + j * 8 + 2 * q, acc[j][2 * h],
                    acc[j][2 * h + 1]);
      }
  } else {
    // the tile's parts, one a block of the cluster: each block stores its
    // partial tile in its own shared memory (the ring, which every warp is
    // done with), then block z sums its share of the tile's rows over the
    // parts, in split order, through distributed shared memory, and runs
    // their epilogue (bias and residual loaded beside the partials)
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int PLD = BN + 4;  // f32 row stride of a partial tile
    float* part = reinterpret_cast<float*>(&As[0][0]);
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + g + 8 * h;
        if (r < rows)
          *reinterpret_cast<float2*>(part + r * PLD + j * 8 + 2 * q) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    cluster.sync();
    const int per = (rows + p.splits - 1) / p.splits;
    const int r0 = (int)cluster.block_rank() * per;
    const int r1 = min(rows, r0 + per);
    constexpr int C4 = BN / 4;
    for (int e = tid; e < (r1 - r0) * C4; e += kGemmThreads) {
      const int r = r0 + e / C4, c = (e % C4) * 4;
      const size_t at = (size_t)(m0 + r) * p.ldc + n0 + c;
      const float4 b4 = p.bias ? *reinterpret_cast<const float4*>(
                                     p.bias + n0 + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      if (p.res) {
        const size_t ra = (size_t)(m0 + r) * p.ldr + n0 + c;
        if (p.res_bf16) {
          const float2 lo = load2(reinterpret_cast<const bf16*>(p.res) + ra, 0);
          const float2 hi = load2(reinterpret_cast<const bf16*>(p.res) + ra, 1);
          o[0] = lo.x;
          o[1] = lo.y;
          o[2] = hi.x;
          o[3] = hi.y;
        } else {
          const float4 o4 =
              *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(
                                                   p.res) + ra);
          o[0] = o4.x;
          o[1] = o4.y;
          o[2] = o4.z;
          o[3] = o4.w;
        }
      }
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < p.splits; ++sp) {
        const float4 u = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, sp) + r * PLD + c);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      float t[4] = {v.x + b4.x, v.y + b4.y, v.z + b4.z, v.w + b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (p.gelu) t[i] = gelu_erf(t[i]);
        if (p.res) t[i] = o[i] + t[i];
      }
      if (p.out_bf16) {
        bf16* dst = reinterpret_cast<bf16*>(p.C) + at;
        store2(dst, 0, t[0], t[1]);
        store2(dst, 1, t[2], t[3]);
      } else {
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(p.C) + at) =
            make_float4(t[0], t[1], t[2], t[3]);
      }
    }
    cluster.sync();  // the partials are read until every block is done
  }
}

template <int BN>
int launch_step_gemm_bn(const StepGemm& p, cudaStream_t st) {
  const dim3 grid(p.N / BN, (p.M + kBM - 1) / kBM, p.splits);
  return launch_pdl(step_gemm_kernel<BN>, grid, kGemmThreads, 0, st, p.splits,
                    p);
}

int launch_step_gemm(const StepGemm& p, int bn, cudaStream_t st) {
  switch (bn) {
    case 16: return launch_step_gemm_bn<16>(p, st);
    case 32: return launch_step_gemm_bn<32>(p, st);
    case 64: return launch_step_gemm_bn<64>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// (BN, splits) of step_gemm_kernel for (M, K) @ (K, N) on `sms` SMs: at
// least `sms` blocks where some choice gives them, then the least
// estimated time of the slowest SM, in bytes: each wave of blocks (4
// resident an SM) costs a round trip (~8 KB of streaming) and its A and B
// loads, and a split tile's blocks then each read their share of every
// part's partial from the cluster; fewer splits, then wider tiles, on a
// tie. Splits are powers of two up to kMaxSplits with K % (16 * splits)
// == 0. The whole decode takes the same rule from its wrapper
// (ops/full_decode.py gemm_plan, with 132 SMs); returns {0, 0} if N or K
// is not a multiple of 16.
struct GemmPlan {
  int bn, splits;
};

GemmPlan step_gemm_plan(int M, int N, int K, int sms) {
  const long long kLatencyBytes = 8192, kResident = 4;
  const long long m_tiles = (M + kBM - 1) / kBM, rows = std::min(M, kBM);
  GemmPlan best = {0, 0};
  long long bkey[4] = {0, 0, 0, 0};
  for (int bn : {64, 32, 16}) {
    if (N % bn) continue;
    const long long tiles = m_tiles * (N / bn);
    for (int splits = 1; splits <= kMaxSplits && K % (16 * splits) == 0;
         splits *= 2) {
      const long long blocks = tiles * splits, part = K / splits;
      const long long waves = (blocks + sms * kResident - 1) /
                              (sms * kResident);
      long long cost =
          waves * (kLatencyBytes + 2 * rows * part + 2 * part * bn);
      if (splits > 1) cost += kLatencyBytes + 4 * rows * bn;
      const long long key[4] = {std::max(0LL, sms - blocks), cost, splits,
                                -bn};
      if (!best.bn || std::lexicographical_compare(key, key + 4, bkey,
                                                   bkey + 4)) {
        std::copy(key, key + 4, bkey);
        best = {bn, splits};
      }
    }
  }
  return best;
}

// ---- LayerNorm of rows held in registers -----------------------------------
constexpr int kLnWarps = 8;
constexpr int kLnMaxPerLane = 32;  // D <= 1024

// One warp per row: y = bf16((x - mean) * rsqrt(var + eps)), no affine (it
// is folded into the next product), the row held in registers between the
// two passes.
__global__ void __launch_bounds__(kLnWarps * 32)
ln_rows_kernel(const int* __restrict__ go, const float* __restrict__ x,
               bf16* __restrict__ y, int N, int D, float eps) {
  ptx::grid_dep_wait();
  if (!*go) return;
  ptx::grid_dep_launch();
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const float2* xr = reinterpret_cast<const float2*>(x + (size_t)row * D);
  const int pairs = D / 64;
  float2 v[kLnMaxPerLane / 2];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane / 2; ++i)
    if (i < pairs) {
      v[i] = xr[i * 32 + lane];
      s += v[i].x + v[i].y;
    }
  const float mu = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane / 2; ++i)
    if (i < pairs) {
      const float a = v[i].x - mu, b = v[i].y - mu;
      q += a * a + b * b;
    }
  const float rstd = rsqrtf(warp_sum(q) / (float)D + eps);
  bf16* yr = y + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane / 2; ++i)
    if (i < pairs)
      store2(yr, i * 32 + lane, (v[i].x - mu) * rstd, (v[i].y - mu) * rstd);
}

// ---- one-query attention -------------------------------------------------
// The f32 dot product of a 16-byte vector of a key row with the matching
// dims of q (8 bf16, 16 int8 or 4 f32 values).
static __device__ __forceinline__ float dot_vec(const float* q, uint4 v,
                                                const bf16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += q[2 * i] * __uint_as_float(w[i] << 16);
    s += q[2 * i + 1] * __uint_as_float(w[i] & 0xffff0000u);
  }
  return s;
}
static __device__ __forceinline__ float dot_vec(const float* q, uint4 v,
                                                const signed char*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      s += q[4 * i + b] * (float)((int)(w[i] << (24 - 8 * b)) >> 24);
  return s;
}
static __device__ __forceinline__ float dot_vec(const float* q, uint4 v,
                                                const float*) {
  return q[0] * __uint_as_float(v.x) + q[1] * __uint_as_float(v.y) +
         q[2] * __uint_as_float(v.z) + q[3] * __uint_as_float(v.w);
}

// acc[i] += p * (element i of a 16-byte vector of a V row).
static __device__ __forceinline__ void axpy_vec(float* acc, float p, uint4 v,
                                                const bf16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += p * __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += p * __uint_as_float(w[i] & 0xffff0000u);
  }
}
static __device__ __forceinline__ void axpy_vec(float* acc, float p, uint4 v,
                                                const signed char*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[4 * i + b] += p * (float)((int)(w[i] << (24 - 8 * b)) >> 24);
}
static __device__ __forceinline__ void axpy_vec(float* acc, float p, uint4 v,
                                                const float*) {
  acc[0] += p * __uint_as_float(v.x);
  acc[1] += p * __uint_as_float(v.y);
  acc[2] += p * __uint_as_float(v.z);
  acc[3] += p * __uint_as_float(v.w);
}

// One warp per (row n, head h); head width DK (32 or 64), at most MP * 32
// keys (MP passes of 32: 8 up to kShortKeys, 16 up to kMaxKeys; at 64 keys
// a 16-pass case takes 17% longer in the whole decode's attention and 32%
// in kernel 7's, on an H100: tools/torch_profile_slice.py --stages
// decode,fused_step); two contracts, chosen at compile time so that each
// compiles to its own code:
// * the whole decode's (STEP false): q (bf16, or f32 for int8 K/V) at q +
//   n*q_rs + h*DK, scaled already; K and V of key j at kbase/vbase +
//   n*kv_rs + h*DK + j*kv_ks (bf16 or int8); with app_k (bf16), this
//   step's K/V (app_k/app_v + n*app_rs + h*DK) are copied to key slot
//   app_slot and read there; softmax weights rounded to bf16 before P.V;
//   the go gate;
// * the per-step kernels' (STEP true): q (f32) times qmul; K and V (bf16
//   or f32) at kbase/vbase + n*kv_rs + h*kv_hs + j*kv_ks; with app_k (f32),
//   this step's K/V are written to slot app_slot rounded to the K/V type
//   and read unrounded; softmax weights f32; the skip flag (null: none),
//   set: nothing is read or written.
// mask (N, nkeys): key j valid iff mask > 0, else -1e9 (null = all
// valid). int8 K/V come with the layer's per-head scales: q is rounded to
// bf16 after the K scale, the output takes the V scale. The output, (N,
// H*DK) bf16 of row stride out_rs.
//
// Scores with lanes over keys: key j = pass * 32 + lane, each lane's whole
// K row in 16-byte loads, PIF passes' loads (64 keys for bf16 and int8, 32
// for f32) in flight at once, q broadcast from shared memory. The first
// passes' K rows are loaded before the wait on the kernel before
// (grid_dep_wait): the encoder K/V and the cached steps were written by
// kernels that completed earlier, so the loads overlap that kernel's tail
// and this one's launch; only this step's key (app_slot) waits. An
// appended key of another type than the cache's (f32 this step, bf16
// cache) is staged in shared memory as f32 and its lane reads it there.
// One warp max, one warp sum; then P.V with lanes over the DK dims, NV
// lanes a V row, each row read coalesced, up to 64 rows in flight.
template <bool STEP, typename Q, typename KV, typename A, int DK, int MP>
__global__ void __launch_bounds__(kAttnWarps * 32)
attend_keys_kernel(const int* __restrict__ go,
                   const unsigned char* __restrict__ skip,
                   const Q* __restrict__ q,
                   long long q_rs, float qmul, KV* kbase, KV* vbase,
                   long long kv_rs, long long kv_hs, long long kv_ks,
                   int nkeys, const float* __restrict__ mask, int mask_rs,
                   const float* __restrict__ kscale,
                   const float* __restrict__ vscale, bf16* __restrict__ out,
                   long long out_rs, int N, int H, const A* app_k,
                   const A* app_v, long long app_rs, int app_slot) {
  constexpr int NV = DK * (int)sizeof(KV) / 16;    // 16-byte vectors a row
  constexpr int VD = 16 / (int)sizeof(KV);          // dims a vector
  constexpr int PIF = sizeof(KV) == 4 ? 1 : 2;      // key passes in flight
  constexpr bool kInt8 = std::is_same<KV, signed char>::value;
  constexpr bool kAppF32 = !kInt8 && !std::is_same<A, KV>::value;
  static_assert(DK == 32 || DK == 64, "a head of 32 or 64 dims");
  __shared__ __align__(16) float qs[kAttnWarps][DK];
  __shared__ float ps[kAttnWarps][MP * 32];
  // (a key of one float when unused, as in the whole decode)
  __shared__ __align__(16) float apk[kAttnWarps][kAppF32 ? DK : 1];
  __shared__ __align__(16) float apv[kAttnWarps][kAppF32 ? DK : 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kAttnWarps + warp;
  const bool live = w < N * H;
  const int n = live ? w / H : 0, h = w % H;
  const int off = h * DK;
  // the lanes that hold two dims of q (and copy two of an appended key)
  const bool pair_lane = 2 * lane < DK;
  KV* kr = kbase + n * kv_rs + (STEP ? h * kv_hs : off);
  KV* vr = vbase + n * kv_rs + (STEP ? h * kv_hs : off);
  auto load_k = [&](uint4 (&kv)[NV], const KV* kp) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      kv[i] = __ldg(reinterpret_cast<const uint4*>(kp) + i);
  };
  uint4 kv[PIF][NV];
  if (live) {
#pragma unroll
    for (int u = 0; u < PIF; ++u) {
      const int j = u * 32 + lane;
      if (j < nkeys && !(app_k && j == app_slot))
        load_k(kv[u], kr + (size_t)j * kv_ks);
    }
  }
  ptx::grid_dep_wait();
  if (!live || (!STEP && !*go) || (STEP && skip && *skip)) return;
  ptx::grid_dep_launch();

  if (pair_lane) {
    float2 qf = load2(q + n * q_rs + off, lane);
    if constexpr (STEP) {
      qf.x *= qmul;
      qf.y *= qmul;
    }
    if (kscale) {
      qf.x = bf_round(qf.x * kscale[h]);
      qf.y = bf_round(qf.y * kscale[h]);
    }
    qs[warp][2 * lane] = qf.x;
    qs[warp][2 * lane + 1] = qf.y;
  }
  const KV* ak = nullptr;
  const KV* av = nullptr;
  if constexpr (!STEP && !kInt8) {
    if (app_k) {
      const bf16* sk = app_k + n * app_rs + off;
      const bf16* sv = app_v + n * app_rs + off;
      if (pair_lane) {
        reinterpret_cast<bf162*>(kr + app_slot * kv_ks)[lane] =
            reinterpret_cast<const bf162*>(sk)[lane];
        reinterpret_cast<bf162*>(vr + app_slot * kv_ks)[lane] =
            reinterpret_cast<const bf162*>(sv)[lane];
      }
      ak = reinterpret_cast<const KV*>(sk);
      av = reinterpret_cast<const KV*>(sv);
#pragma unroll
      for (int u = 0; u < PIF; ++u)
        if (u * 32 + lane == app_slot) load_k(kv[u], ak);
    }
  }
  if constexpr (STEP) {
    if (app_k) {
      const A* sk = app_k + n * app_rs + off;
      const A* sv = app_v + n * app_rs + off;
      if (pair_lane) {
        const float2 k2 = load2(sk, lane), v2 = load2(sv, lane);
        store2(kr + app_slot * kv_ks, lane, k2.x, k2.y);
        store2(vr + app_slot * kv_ks, lane, v2.x, v2.y);
        if constexpr (kAppF32) {
          apk[warp][2 * lane] = k2.x;
          apk[warp][2 * lane + 1] = k2.y;
          apv[warp][2 * lane] = v2.x;
          apv[warp][2 * lane + 1] = v2.y;
        }
      }
      if constexpr (!kAppF32) {
        ak = reinterpret_cast<const KV*>(sk);
        av = reinterpret_cast<const KV*>(sv);
#pragma unroll
        for (int u = 0; u < PIF; ++u)
          if (u * 32 + lane == app_slot) load_k(kv[u], ak);
      }
    }
  }
  __syncwarp();
  // the lane of key j reads it from the f32 copy in shared memory
  const bool app_smem = kAppF32 && app_k;

  // scores: key j = pass * 32 + lane
  float sc[MP];
#pragma unroll
  for (int i = 0; i < MP; ++i) sc[i] = -INFINITY;
  float m = -INFINITY;
#pragma unroll
  for (int pp = 0; pp < MP; pp += PIF) {
    if (pp * 32 >= nkeys) break;
    if (pp > 0) {
#pragma unroll
      for (int u = 0; u < PIF; ++u) {
        const int j = (pp + u) * 32 + lane;
        if (j < nkeys && !(app_smem && j == app_slot))
          load_k(kv[u], (ak && j == app_slot) ? ak : kr + (size_t)j * kv_ks);
      }
    }
#pragma unroll
    for (int u = 0; u < PIF; ++u) {
      const int j = (pp + u) * 32 + lane;
      if (j < nkeys) {
        float s = 0.f;
        if (app_smem && j == app_slot) {
          for (int d = 0; d < (kAppF32 ? DK : 1); ++d)
            s += qs[warp][d] * apk[warp][d];
        } else {
#pragma unroll
          for (int i = 0; i < NV; ++i)
            s += dot_vec(&qs[warp][i * VD], kv[u][i], (const KV*)nullptr);
        }
        if (mask && !(mask[(size_t)n * mask_rs + j] > 0.f)) s = -1e9f;
        sc[pp + u] = s;
        m = fmaxf(m, s);
      }
    }
  }
  m = warp_max(m);
  float e[MP];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    e[i] = expf(sc[i] - m);
    sum += e[i];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    const int j = i * 32 + lane;
    if (j < nkeys) ps[warp][j] = STEP ? e[i] / sum : bf_round(e[i] / sum);
  }
  __syncwarp();

  // P.V: NV lanes read one V row, 16 bytes each (dims VD*dg ..), KPL rows
  // a warp-wide load, kVInFlight loads a lane in flight; then the lanes of
  // one dim group sum their keys' shares
  constexpr int KPL = 32 / NV;
  constexpr int kVInFlight = 64 / KPL < 16 ? 64 / KPL : 16;
  const int dg = lane % NV, kq = lane / NV;
  float acc[VD];
#pragma unroll
  for (int i = 0; i < VD; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < nkeys; j0 += KPL * kVInFlight) {
    uint4 vv[kVInFlight];
#pragma unroll
    for (int u = 0; u < kVInFlight; ++u) {
      const int j = j0 + u * KPL + kq;
      if (j < nkeys && !(app_smem && j == app_slot)) {
        const KV* vp = (av && j == app_slot) ? av : vr + (size_t)j * kv_ks;
        vv[u] = __ldg(reinterpret_cast<const uint4*>(vp) + dg);
      }
    }
#pragma unroll
    for (int u = 0; u < kVInFlight; ++u) {
      const int j = j0 + u * KPL + kq;
      if (j < nkeys) {
        if (app_smem && j == app_slot) {
#pragma unroll
          for (int i = 0; i < VD; ++i)
            acc[i] += ps[warp][j] * apv[warp][kAppF32 ? VD * dg + i : 0];
        } else {
          axpy_vec(acc, ps[warp][j], vv[u], (const KV*)nullptr);
        }
      }
    }
  }
#pragma unroll
  for (int o = NV; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < VD; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  if (kq == 0) {
    const float vs = vscale ? vscale[h] : 1.f;
    bf16* dst = out + n * out_rs + off + VD * dg;
#pragma unroll
    for (int i = 0; i < VD / 2; ++i)
      store2(dst, i, acc[2 * i] * vs, acc[2 * i + 1] * vs);
  }
}

// Up to kShortKeys keys on the first case (8 passes), up to kMaxKeys on
// the second (16); more is cudaErrorInvalidValue.
template <bool STEP, typename Q, typename KV, typename A, int DK = kDk>
int launch_attend(const int* go, const unsigned char* skip, const Q* q,
                  long long q_rs, float qmul,
                  KV* k, KV* v, long long kv_rs, long long kv_hs,
                  long long kv_ks, int nkeys, const float* mask, int mask_rs,
                  const float* kscale, const float* vscale, bf16* out,
                  long long out_rs, int N, int H, const A* app_k,
                  const A* app_v, long long app_rs, int app_slot,
                  cudaStream_t st) {
  const int blocks = (N * H + kAttnWarps - 1) / kAttnWarps;
  if (nkeys > kMaxKeys) return (int)cudaErrorInvalidValue;
  auto kernel = nkeys <= kShortKeys
                    ? attend_keys_kernel<STEP, Q, KV, A, DK, kShortKeys / 32>
                    : attend_keys_kernel<STEP, Q, KV, A, DK, kMaxKeys / 32>;
  return launch_pdl(kernel, blocks, kAttnWarps * 32, 0, st, 1, go, skip, q,
                    q_rs,
                    qmul, k, v, kv_rs, kv_hs, kv_ks, nkeys, mask, mask_rs,
                    kscale, vscale, out, out_rs, N, H, app_k, app_v, app_rs,
                    app_slot);
}

}  // namespace
