// NRTR greedy decode: every step of every layer, with the all-rows-EOS exit.
//
// Replaces the TPU kernel tps_pp_tpu/ops/pallas_full_decode.py
// `_full_decode_kernel` (reached from full_greedy_decode) in both its
// encoder-K/V branches, bf16 and int8 (`enc_quant`), with `end_idx`.
// Contract, per step t < S:
//   x = embed[token] + pe[t]; for each layer: x += SelfAttn(LN(x)) over the
//   cached steps 0..t; x += CrossAttn(LN(x)) over the encoder K/V with the
//   source mask; x += FFN(LN(x)); then LN(x, eps 1e-6) -> classifier ->
//   softmax over the C-1 classes -> probs[:, t]; next token = argmax (first
//   index on ties, like jnp.argmax). Optional early exit once every row has
//   emitted EOS; rows whose source mask is all invalid count as finished;
//   steps after the exit read back as 0.
//
// The TPU keeps ~31 MB of weights, the block's encoder K/V and the KV caches
// resident in VMEM for the whole 40-step loop. An SM has 227 KB of shared
// memory, and at N=512 the encoder K/V alone is ~400 MB, so this keeps the
// output contract and drops the residency: the encoder K/V of all layers
// ((N, TE, L, 2HD) bf16, one product on the tensor-core GEMM of gemm.cu)
// and the self-attention cache
// ((L, N, S, 2HD) bf16) live in global scratch that the wrapper allocates.
//
// Bound on the H100: per step the weights (~7 MB bf16, mostly L2-resident)
// and the encoder K/V (~400 MB at N=512, read once per layer-step) dominate:
// ~16 GB over 40 steps, ~5 ms at 3.35 TB/s; the matmuls take ~0.5 ms at the
// bf16 peak. With M = N <= 512 rows every step product is skinny and the
// step is ~50 dependent launches, so latency, not bytes, is what a design
// has to remove. This one:
//
// * enqueues all S steps at once, with no host synchronisation: the exit is
//   decided on the device. The first kernel of a step (embed_ln_kernel)
//   opens with the gate: go = (remaining > 0) (always 1 without end_idx),
//   written to `go` by one thread, which also adds go to *steps_run; every
//   later kernel of the step reads `go` and returns at once when it is 0.
//   The head kernel of step t-1 is the only writer of `remaining`, so the
//   gate sees it as the host check before each step did. The wrapper
//   captures the whole enqueue as one CUDA graph and replays it.
// * launches every kernel of the loop with programmatic dependent launch
//   (launch_pdl): a kernel starts while the
//   one before it finishes, and what it reads that no kernel of the loop
//   writes (the step products' weight tiles, the attention's encoder K/V
//   and cached steps) is loaded before it waits for that kernel
//   (ptx::grid_dep_wait), so a node's launch and first loads overlap the
//   node before.
// * runs each step product (QKV, fc1, q2, fc2, w1, w2) as step_gemm_kernel:
//   64-row tiles (M = 64 fits one), BN in {16, 32, 64} columns, and split-K,
//   chosen per product and bucket by the wrapper (ops/full_decode.py
//   `gemm_plan`) so that every product runs on >= 132 blocks. Each block
//   streams its K range through a ring of 4 shared-memory stages of A and B
//   tiles fed by 16-byte asynchronous copies (cp.async; every thread
//   arrives on the stage's mbarrier once its copies have landed), so up to
//   4 stages of loads are in flight while the tensor cores work on the
//   oldest (mma.sync m16n8k16 from ldmatrix fragments; rows padded by 16
//   bytes, free of bank conflicts). A tile's rows are 32-128 bytes: fed as
//   one bulk copy (cp.async.bulk) a row, ~100 a stage issued one at a time
//   by the SM's copy engine, the products took 43 us each at N=512 on the
//   H100, no faster than the unpipelined WMMA GEMM this replaces. mma.sync,
//   not wgmma: the products are ~1 GFLOP a step, ~1 us
//   at the tensor cores' peak, and their time is load latency. Split-K is
//   deterministic and stays on chip: the parts of a tile are one cluster
//   of blocks, each keeps its f32 partial tile in its shared memory, and
//   each sums a share of the tile's rows over the cluster's partials in
//   split order (distributed shared memory) and runs their epilogue (bias,
//   GELU, residual in place, f32 or bf16 out), so replays give equal bits.
// * keeps the LayerNorm after fc1, fc2 and w2 a kernel of its own
//   (ln_rows_kernel, one warp a row): folded into the next product as a
//   prologue, each of the next product's 256-512 blocks would read the
//   whole f32 band of its 64 rows (128 KB at D = 512) for their statistics,
//   where the kernel reads each row once.
// * attends one query per (row, head) with one warp (attend_keys_kernel):
//   lanes over keys, every lane's 16-byte K loads issued before its dot
//   products, q broadcast from shared memory, one warp max and one warp
//   sum, then P.V with lanes over the 64 dims, each V row read coalesced.
// * computes the classifier a class a warp over a few rows a block
//   (decode_head_kernel), from the classifier transposed (a copy that the
//   wrapper's graph makes at every replay, so that it reads the weights
//   live, as every other kernel here does).
//
// Per step: 1 + 11 L - 1 + 1 launches (67 for the flagship).
//
// Numerics follow the TPU kernel: LN affines, the 1/sqrt(d_k) scale and the
// final LN are folded into the weights (ops/full_decode.py); bf16 operands
// rounded where the TPU rounds them; f32 residual stream, accumulation,
// LayerNorm and softmax.
//
// int8 encoder K/V (`enc_q8` given; the JAX package's `fused40`): from the
// projection that the wrapper computes (outside the kernel, as in JAX), one
// absmax scale per (layer, K|V, head) over the whole batch as passed,
// max|x| / 127 + 1e-8 (pallas_full_decode.py:302-313), and the values
// round(x / scale), half to even, clipped to +-127. The cross-attention
// (the same one-query kernel, on int8) then reads half the bytes of the
// bf16 branch: ~8 GB over 40 steps at N=512, ~2.4 ms at 3.35 TB/s. Rounding
// points of the TPU kernel's `_attend_allheads`: q = bf16(q_f32 * k_scale),
// scores = q . k8 in f32, softmax weights rounded to bf16 before . v8, the
// f32 result times v_scale. The self-attention and the rest of the step are
// the bf16 branch's.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"
#include "ptx.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kAttnWarps = 4;
constexpr int kMaxKeys = 256;
constexpr int kMaxPass = kMaxKeys / 32;
constexpr int kDk = 64;
constexpr int kRowsPerBlock = 8;  // embed_ln_kernel: one warp per row

// Launches `kernel` in clusters of cluster_z blocks along z, with
// programmatic stream serialization: it may start while
// the kernel before it on the stream still runs, and waits for it in
// ptx::grid_dep_wait(). Every kernel of the step loop is launched so, and
// each waits before it reads what an earlier kernel of the loop wrote and
// before it exits, so each kernel's completion still implies all earlier
// ones'.
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

// ---- gate + embedding + the first LayerNorm ------------------------------
// go = remaining > 0 (1 without the exit check), read by every block before
// anyone writes go; block 0 publishes it and counts the step. Then one warp
// per row: x32 = embed[tok] + pe_t; y = bf16(LN(x32)) (eps, no affine).
__global__ void embed_ln_kernel(const int* __restrict__ remaining,
                                int check_exit, int* go, int* steps_run,
                                const int* __restrict__ tok,
                                const bf16* __restrict__ embed,
                                const float* __restrict__ pe_t,
                                float* __restrict__ x32, bf16* __restrict__ y,
                                int N, int D, float eps) {
  ptx::grid_dep_wait();
  const int g = !check_exit || *remaining > 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *go = g;
    *steps_run += g;
  }
  if (!g) return;
  ptx::grid_dep_launch();
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const bf16* e = embed + (size_t)tok[row] * D;
  float* xr = x32 + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = __bfloat162float(e[d]) + pe_t[d];
    xr[d] = v;
    s += v;
  }
  const float mu = warp_sum(s) / (float)D;
  float v = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float u = xr[d] - mu;
    v += u * u;
  }
  const float rstd = rsqrtf(warp_sum(v) / (float)D + eps);
  for (int d = lane; d < D; d += 32)
    y[(size_t)row * D + d] = __float2bfloat16((xr[d] - mu) * rstd);
}

// ---- the step products ---------------------------------------------------
constexpr int kBM = 64;            // rows of a tile: 4 warps x 16
constexpr int kBK = 32;            // depth of a stage (16 for a 16-deep rest)
constexpr int kStages = 4;         // stages in flight
constexpr int kGemmThreads = 128;

// C[M, N] = epilogue(A[M, K] @ B[K, N]), bf16 operands (A rows of lda, B
// the (K, N) weights of ldb), f32 accumulation; epilogue = (+bias[N]) ->
// (erf-GELU) -> (residual: C f32 += in place) -> f32 or bf16. `splits`
// parts of K (K % (16 * splits) == 0, splits <= kMaxSplits), one block
// each, the blocks of a tile one cluster.
constexpr int kMaxSplits = 8;      // the portable cluster size
struct StepGemm {
  const bf16* A;
  const bf16* B;
  void* C;
  const float* bias;
  const int* go;
  int lda, ldb, ldc, M, N, K, splits, gelu, residual, out_bf16;
};

static __device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
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
  const size_t at = (size_t)r * p.ldc + c;
  if (p.residual) {
    const float2 old = *reinterpret_cast<const float2*>(
        reinterpret_cast<float*>(p.C) + at);
    v0 = old.x + v0;
    v1 = old.y + v1;
  }
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
  if (!*p.go) {
    ptx::cp_async_wait_all();
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
      const float4 o4 = p.residual ? *reinterpret_cast<const float4*>(
                                         reinterpret_cast<float*>(p.C) + at)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
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
      const float o[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (p.gelu) t[i] = gelu_erf(t[i]);
        if (p.residual) t[i] = o[i] + t[i];
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

// ---- LayerNorm of the residual stream ------------------------------------
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
// dims of q (8 bf16 or 16 int8 values).
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

// One warp per (row n, head h); head width 64. q: row n at q + n*q_rs (bf16;
// f32 for int8 K/V). K and V of key j at kbase/vbase + n*kv_rs + j*kv_ks
// (bf16 or int8). When app_k is given (bf16 K/V), this step's K/V
// (app_k/app_v + n*app_rs) are written to key slot app_slot, and key
// app_slot is read from them. mask (N, nkeys): key j valid iff mask > 0
// (null = all valid). int8 K/V come with the layer's per-head scales: q is
// rounded to bf16 after the K scale, the output takes the V scale.
//
// Scores with lanes over keys: key j = pass * 32 + lane, each lane's whole
// K row in 16-byte loads, two passes' loads (64 keys, every key of the
// flagship's cross- and self-attention) in flight at once, q broadcast
// from shared memory. The first two passes' K rows are loaded before the
// wait on the kernel before (grid_dep_wait): the encoder K/V and the
// cached steps were written by kernels that completed earlier, so the
// loads overlap that kernel's tail and this one's launch; only this step's
// key (app_slot) waits. One warp max, one warp sum; then P.V with lanes
// over the 64 dims, NV lanes a V row, each row read coalesced, 64 rows in
// flight.
template <typename Q, typename KV>
__global__ void __launch_bounds__(kAttnWarps * 32)
attend_keys_kernel(const int* __restrict__ go, const Q* __restrict__ q,
                   long long q_rs, KV* kbase, KV* vbase, long long kv_rs,
                   long long kv_ks, int nkeys, const float* __restrict__ mask,
                   int mask_rs, const float* __restrict__ kscale,
                   const float* __restrict__ vscale, bf16* __restrict__ out,
                   long long out_rs, int N, int H, const bf16* app_k,
                   const bf16* app_v, long long app_rs, int app_slot) {
  constexpr int NV = kDk * (int)sizeof(KV) / 16;   // 16-byte vectors a row
  constexpr int VD = 16 / (int)sizeof(KV);          // dims a vector
  __shared__ __align__(16) float qs[kAttnWarps][kDk];
  __shared__ float ps[kAttnWarps][kMaxKeys];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kAttnWarps + warp;
  const bool live = w < N * H;
  const int n = live ? w / H : 0, h = w % H;
  const int off = h * kDk;
  KV* kr = kbase + n * kv_rs + off;
  KV* vr = vbase + n * kv_rs + off;
  auto load_k = [&](uint4 (&kv)[NV], const KV* kp) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      kv[i] = __ldg(reinterpret_cast<const uint4*>(kp) + i);
  };

  uint4 kv[2][NV];
  if (live) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = u * 32 + lane;
      if (j < nkeys && !(app_k && j == app_slot))
        load_k(kv[u], kr + (size_t)j * kv_ks);
    }
  }
  ptx::grid_dep_wait();
  if (!live || !*go) return;
  ptx::grid_dep_launch();

  float2 qf = load2(q + n * q_rs + off, lane);
  if (kscale) {
    qf.x = bf_round(qf.x * kscale[h]);
    qf.y = bf_round(qf.y * kscale[h]);
  }
  qs[warp][2 * lane] = qf.x;
  qs[warp][2 * lane + 1] = qf.y;
  const KV* ak = nullptr;
  const KV* av = nullptr;
  if (app_k) {
    const bf16* sk = app_k + n * app_rs + off;
    const bf16* sv = app_v + n * app_rs + off;
    reinterpret_cast<bf162*>(kr + app_slot * kv_ks)[lane] =
        reinterpret_cast<const bf162*>(sk)[lane];
    reinterpret_cast<bf162*>(vr + app_slot * kv_ks)[lane] =
        reinterpret_cast<const bf162*>(sv)[lane];
    ak = reinterpret_cast<const KV*>(sk);
    av = reinterpret_cast<const KV*>(sv);
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (u * 32 + lane == app_slot) load_k(kv[u], ak);
  }
  __syncwarp();

  // scores: key j = pass * 32 + lane
  float sc[kMaxPass];
#pragma unroll
  for (int i = 0; i < kMaxPass; ++i) sc[i] = -INFINITY;
  float m = -INFINITY;
#pragma unroll
  for (int pp = 0; pp < kMaxPass; pp += 2) {
    if (pp * 32 >= nkeys) break;
    if (pp > 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = (pp + u) * 32 + lane;
        if (j < nkeys)
          load_k(kv[u], (ak && j == app_slot) ? ak : kr + (size_t)j * kv_ks);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = (pp + u) * 32 + lane;
      if (j < nkeys) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i)
          s += dot_vec(&qs[warp][i * VD], kv[u][i], (const KV*)nullptr);
        if (mask && !(mask[(size_t)n * mask_rs + j] > 0.f)) s = -1e9f;
        sc[pp + u] = s;
        m = fmaxf(m, s);
      }
    }
  }
  m = warp_max(m);
  float e[kMaxPass];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPass; ++i) {
    e[i] = expf(sc[i] - m);
    sum += e[i];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < kMaxPass; ++i) {
    const int j = i * 32 + lane;
    if (j < nkeys) ps[warp][j] = bf_round(e[i] / sum);
  }
  __syncwarp();

  // P.V: NV lanes read one V row, 16 bytes each (dims VD*dg ..), KPL rows
  // a warp-wide load, 64 rows in flight; then the lanes of one dim group
  // sum their keys' shares
  constexpr int KPL = 32 / NV, kVInFlight = 64 / KPL;
  const int dg = lane % NV, kq = lane / NV;
  float acc[VD];
#pragma unroll
  for (int i = 0; i < VD; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < nkeys; j0 += KPL * kVInFlight) {
    uint4 vv[kVInFlight];
#pragma unroll
    for (int u = 0; u < kVInFlight; ++u) {
      const int j = j0 + u * KPL + kq;
      if (j < nkeys) {
        const KV* vp = (av && j == app_slot) ? av : vr + (size_t)j * kv_ks;
        vv[u] = __ldg(reinterpret_cast<const uint4*>(vp) + dg);
      }
    }
#pragma unroll
    for (int u = 0; u < kVInFlight; ++u) {
      const int j = j0 + u * KPL + kq;
      if (j < nkeys) axpy_vec(acc, ps[warp][j], vv[u], (const KV*)nullptr);
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

template <typename Q, typename KV>
int launch_attend(const int* go, const Q* q, long long q_rs, KV* k, KV* v,
                  long long kv_rs, long long kv_ks, int nkeys,
                  const float* mask, int mask_rs, const float* kscale,
                  const float* vscale, bf16* out, long long out_rs, int N,
                  int H, const bf16* app_k, const bf16* app_v,
                  long long app_rs, int app_slot, cudaStream_t st) {
  const int blocks = (N * H + kAttnWarps - 1) / kAttnWarps;
  return launch_pdl(attend_keys_kernel<Q, KV>, blocks, kAttnWarps * 32, 0, st,
                    1, go, q, q_rs, k, v, kv_rs, kv_ks, nkeys, mask, mask_rs,
                    kscale, vscale, out, out_rs, N, H, app_k, app_v, app_rs,
                    app_slot);
}

// ---- int8 encoder K/V ----------------------------------------------------
// amax[g] = max |ekv[r, g*64 + c]| over every row r and c < 64, as the bits
// of a non-negative float (which order as unsigned ints). Block (g, chunk
// of rows_per_block rows); one warp per row, two columns per lane.
__global__ void group_absmax_kernel(const bf16* __restrict__ ekv, int rows,
                                    int KV, int rows_per_block,
                                    unsigned* __restrict__ amax) {
  __shared__ float red[32];
  const int g = blockIdx.x, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  float m = 0.f;
  for (int r = r0 + (threadIdx.x >> 5); r < r1; r += blockDim.x >> 5) {
    const float2 v = load2(ekv + (size_t)r * KV + g * 64, lane);
    m = fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y)));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) atomicMax(amax + g, __float_as_uint(m));
}

static __device__ __forceinline__ float group_scale(const unsigned* amax,
                                                    int g) {
  return __uint_as_float(amax[g]) / 127.f + 1e-8f;
}

static __device__ __forceinline__ signed char quantize(float x, float s) {
  return (signed char)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// scales[g] from amax; q8 = round(ekv / scale of its column group), half to
// even, clipped to +-127. Two columns per thread (never across a group).
__global__ void quantize_groups_kernel(const bf16* __restrict__ ekv,
                                       const unsigned* __restrict__ amax,
                                       float* __restrict__ scales,
                                       signed char* __restrict__ q8,
                                       size_t n_pairs, int KV, int G) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 < (size_t)G) scales[i0] = group_scale(amax, (int)i0);
  for (size_t i = i0; i < n_pairs; i += stride) {
    const float s = group_scale(amax, (int)((2 * i) % KV) / 64);
    const float2 v = load2(ekv + 2 * i, 0);
    reinterpret_cast<char2*>(q8)[i] = make_char2(quantize(v.x, s),
                                                 quantize(v.y, s));
  }
}

// tok = start; a row is finished from the start iff its source mask is all
// invalid; remaining counts the unfinished rows (zeroed beforehand).
__global__ void decode_init_kernel(const float* __restrict__ mask, int TE,
                                   int N, int start_idx, int* tok,
                                   int* finished, int* remaining) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int valid = 0;
  for (int j = 0; j < TE; ++j) valid |= mask[(size_t)n * TE + j] > 0.f;
  tok[n] = start_idx;
  finished[n] = !valid;
  if (valid) atomicAdd(remaining, 1);
}

// R rows a block, one warp a row for the final LN (affine folded into
// wcls_t/bcls; the normalised row rounded to bf16, as the TPU rounds the
// operand) -> logits over NC classes, one warp a class with its lanes over
// D in 16-byte vectors of the transposed classifier (NC, D), every row of
// the block at once -> one warp a row: softmax -> probs[n, t, :] -> argmax
// (ties to the lower index) -> next token + EOS bookkeeping. The wrapper
// takes R = ceil(N / 132) (at most kHeadWarps), so that the classifier is
// read once a block and the blocks still cover the SMs. Dynamic shared
// memory: R (D + NC) floats.
constexpr int kHeadWarps = 8;

__global__ void __launch_bounds__(kHeadWarps * 32)
decode_head_kernel(const int* __restrict__ go, const float* __restrict__ x,
                   int D, const bf16* __restrict__ wcls_t,
                   const float* __restrict__ bcls, int NC,
                   float* __restrict__ probs, int S, int t, int* tok,
                   int* finished, int* remaining, int end_idx, float eps,
                   int N, int R) {
  extern __shared__ __align__(16) float hsm[];
  float* xn = hsm;          // (R, D)
  float* lg = hsm + R * D;  // (R, NC)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * R, rows = min(R, N - n0);
  ptx::grid_dep_wait();
  if (!*go) return;
  ptx::grid_dep_launch();
  if (warp < rows) {
    const float* xr = x + (size_t)(n0 + warp) * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += xr[d];
    const float mu = warp_sum(s) / (float)D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float u = xr[d] - mu;
      v += u * u;
    }
    const float rstd = rsqrtf(warp_sum(v) / (float)D + eps);
    for (int d = lane; d < D; d += 32)
      xn[warp * D + d] = bf_round((xr[d] - mu) * rstd);
  }
  __syncthreads();
  for (int c = warp; c < NC; c += kHeadWarps) {
    const bf16* wr = wcls_t + (size_t)c * D;
    float a[kHeadWarps];
#pragma unroll
    for (int r = 0; r < kHeadWarps; ++r) a[r] = 0.f;
#pragma unroll 2
    for (int d0 = lane * 8; d0 < D; d0 += 256) {
      const uint4 wv = *reinterpret_cast<const uint4*>(wr + d0);
      const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
      float wf[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wf[2 * i] = __uint_as_float(ww[i] << 16);
        wf[2 * i + 1] = __uint_as_float(ww[i] & 0xffff0000u);
      }
#pragma unroll
      for (int r = 0; r < kHeadWarps; ++r) {
        if (r >= rows) break;
        const float4 x0 = *reinterpret_cast<const float4*>(xn + r * D + d0);
        const float4 x1 =
            *reinterpret_cast<const float4*>(xn + r * D + d0 + 4);
        a[r] += x0.x * wf[0] + x0.y * wf[1] + x0.z * wf[2] + x0.w * wf[3] +
                x1.x * wf[4] + x1.y * wf[5] + x1.z * wf[6] + x1.w * wf[7];
      }
    }
#pragma unroll
    for (int r = 0; r < kHeadWarps; ++r) {
      if (r >= rows) break;
      const float s = warp_sum(a[r]);
      if (lane == 0) lg[r * NC + c] = s + bcls[c];
    }
  }
  __syncthreads();
  if (warp >= rows) return;
  const int n = n0 + warp;
  float* l = lg + warp * NC;
  float m = -INFINITY;
  for (int c = lane; c < NC; c += 32) m = fmaxf(m, l[c]);
  m = warp_max(m);
  float z = 0.f;
  for (int c = lane; c < NC; c += 32) {
    const float e = expf(l[c] - m);
    l[c] = e;
    z += e;
  }
  z = warp_sum(z);
  float bv = -1.f;
  int bi = 0x7fffffff;
  float* pr = probs + ((size_t)n * S + t) * NC;
  for (int c = lane; c < NC; c += 32) {
    const float p = l[c] / z;
    pr[c] = p;
    if (p > bv) {  // c increases within a lane: keeps the first max
      bv = p;
      bi = c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    tok[n] = bi;
    if (end_idx >= 0 && bi == end_idx && !finished[n]) {
      finished[n] = 1;
      atomicSub(remaining, 1);
    }
  }
}

}  // namespace

// Whole greedy decode, enqueued on `stream` without a host synchronisation
// (the wrapper captures it as a CUDA graph). Weights (folded, stacked over
// layers):
//   wkv_enc (D, L*2HD) bf16: per layer [K | V] of the cross-attention;
//   embed (C, D) bf16; pe (S, D) f32;
//   wqkv (L, D, 3HD), wfc1 (L, HD, D), wq2 (L, D, HD), wfc2 (L, HD, D),
//   w1 (L, D, DI), w2 (L, DI, D) bf16; bqkv (L, 3HD), bq2 (L, HD),
//   b1 (L, DI), b2 (L, D) f32; wcls_t (NC, D) bf16 (the classifier,
//   transposed), bcls (NC) f32.
// Scratch: enc_kv (N*TE, L*2HD) bf16, cache (L, N, S, 2HD) bf16,
//   x32 (N, D) f32, y (N, D) bf16, qkv (N, 3HD) bf16, att (N, HD) bf16,
//   hid (N, DI) bf16, tok/finished (N) int32, remaining (1) int32, go (1)
//   int32.
// plan: host array of (BN, splits) for the products QKV, fc1, q2, fc2, w1,
//   w2 (ops/full_decode.py gemm_plan).
// probs (N, S, NC) f32; *steps_run (device int32) receives the number of
// steps run. int8 encoder K/V when enc_q8 is given: enc_kv then holds the
// projection on entry (the wrapper computes it, as the JAX package does
// outside its kernel), and the scratch is enc_q8 (N*TE, L*2HD) int8, amax
// (L*2H) uint32, scales (L*2H) f32 (index l*2H + {0: K, 1: V}*H + h) and q32
// (N, HD) f32; all null for the bf16 branch, whose projection is the first
// GEMM here. end_idx < 0 disables the early exit.
extern "C" int tpk_full_decode(
    const void* out_enc, const float* src_mask, const void* wkv_enc,
    const void* embed, const float* pe, const void* wqkv, const float* bqkv,
    const void* wfc1, const void* wq2, const float* bq2, const void* wfc2,
    const void* w1, const float* b1, const void* w2, const float* b2,
    const void* wcls_t, const float* bcls, void* enc_kv, void* cache,
    float* x32, void* y, void* qkv, void* att, void* hid, int* tok,
    int* finished, int* remaining, float* probs, void* enc_q8,
    unsigned* amax, float* scales, float* q32, int* go, int* steps_run,
    const int* plan, int N, int TE, int D, int H, int DK, int DI, int L,
    int S, int NC, int start_idx, int end_idx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * DK, KV = L * 2 * HD;
  if (N < 1 || TE < 1 || DK != kDk || S > kMaxKeys || TE > kMaxKeys ||
      D % 64 || DI % 64 || D > 32 * kLnMaxPerLane)
    return (int)cudaErrorInvalidValue;
  // the head's rows a block: enough blocks for the SMs, then what fits
  int head_rows = std::min(kHeadWarps, std::max(1, (N + 131) / 132));
  while (head_rows > 1 &&
         sizeof(float) * (size_t)head_rows * (D + NC) > 48 * 1024)
    --head_rows;
  const size_t head_smem = sizeof(float) * (size_t)head_rows * (D + NC);
  if (head_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  // the products: QKV, fc1, q2, fc2, w1, w2 as (N_out, K)
  const int prod_n[6] = {3 * HD, D, HD, D, DI, D};
  const int prod_k[6] = {D, HD, D, HD, D, DI};
  for (int i = 0; i < 6; ++i) {
    const int bn = plan[2 * i], sp = plan[2 * i + 1];
    if ((bn != 16 && bn != 32 && bn != 64) || prod_n[i] % bn || sp < 1 ||
        sp > kMaxSplits || prod_k[i] % (16 * sp))
      return (int)cudaErrorInvalidValue;
  }
  bf16* ekv = (bf16*)enc_kv;
  bf16* ch = (bf16*)cache;
  bf16* yb = (bf16*)y;
  bf16* qb = (bf16*)qkv;
  bf16* ab = (bf16*)att;
  bf16* hb = (bf16*)hid;

  signed char* q8 = (signed char*)enc_q8;
  if (!q8) {
    // c, ldc, out_bf16, bias, gelu, residual, ldr, ln_out, ld_ln, ln_s,
    // ln_b, ln_eps
    const GemmEpilogue ep = {ekv,     KV, 1,       nullptr, 0, nullptr, 0,
                             nullptr, 0,  nullptr, nullptr, 0.f};
    TPK_TRY(gemm_tc((const bf16*)out_enc, D, (const bf16*)wkv_enc, KV,
                    N * TE, KV, D, ep, st));
  } else {
    const int G = KV / 64, rows = N * TE, rpb = 256;
    cudaMemsetAsync(amax, 0, sizeof(unsigned) * G, st);
    TPK_CHECK();
    group_absmax_kernel<<<dim3(G, (rows + rpb - 1) / rpb), 256, 0, st>>>(
        ekv, rows, KV, rpb, amax);
    TPK_CHECK();
    const size_t pairs = (size_t)rows * KV / 2;
    quantize_groups_kernel<<<1024, 256, 0, st>>>(ekv, amax, scales, q8,
                                                 pairs, KV, G);
    TPK_CHECK();
  }
  cudaMemsetAsync(probs, 0, sizeof(float) * (size_t)N * S * NC, st);
  cudaMemsetAsync(remaining, 0, sizeof(int), st);
  cudaMemsetAsync(steps_run, 0, sizeof(int), st);
  TPK_CHECK();
  decode_init_kernel<<<(N + 127) / 128, 128, 0, st>>>(
      src_mask, TE, N, start_idx, tok, finished, remaining);
  TPK_CHECK();

  // product i of layer l: C = epilogue(A @ B)
  auto gemm = [&](int i, const bf16* A, int lda, const void* B, int l,
                  void* C, int ldc, const float* bias, int gelu, int residual,
                  int out_bf16) {
    StepGemm p;
    p.A = A;
    p.B = (const bf16*)B + (size_t)l * prod_k[i] * prod_n[i];
    p.C = C;
    p.bias = bias ? bias + (size_t)l * prod_n[i] : nullptr;
    p.go = go;
    p.lda = lda;
    p.ldb = prod_n[i];
    p.ldc = ldc;
    p.M = N;
    p.N = prod_n[i];
    p.K = prod_k[i];
    p.splits = plan[2 * i + 1];
    p.gelu = gelu;
    p.residual = residual;
    p.out_bf16 = out_bf16;
    return launch_step_gemm(p, plan[2 * i], st);
  };
  // y = bf16(LN(x32)), the operand of the next product
  auto layernorm = [&]() {
    return launch_pdl(ln_rows_kernel, (N + kLnWarps - 1) / kLnWarps,
                      kLnWarps * 32, 0, st, 1, go, x32, yb, N, D, 1e-5f);
  };

  for (int t = 0; t < S; ++t) {
    TPK_TRY(launch_pdl(embed_ln_kernel,
                       (N + kRowsPerBlock - 1) / kRowsPerBlock,
                       kRowsPerBlock * 32, 0, st, 1, remaining, end_idx >= 0,
                       go, steps_run, tok, (const bf16*)embed,
                       pe + (size_t)t * D, x32, yb, N, D, 1e-5f));
    for (int l = 0; l < L; ++l) {
      bf16* cl = ch + (size_t)l * N * S * 2 * HD;
      // self-attention over the cached steps 0..t (y = LN1(x) on entry)
      TPK_TRY(gemm(0, yb, D, wqkv, l, qb, 3 * HD, bqkv, 0, 0, 1));
      TPK_TRY(launch_attend(go, qb, 3 * HD, cl, cl + HD, (long long)S * 2 * HD,
                            2 * HD, t + 1, nullptr, 0, nullptr, nullptr, ab,
                            HD, N, H, qb + HD, qb + 2 * HD, 3 * HD, t, st));
      TPK_TRY(gemm(1, ab, HD, wfc1, l, x32, D, nullptr, 0, 1, 0));
      TPK_TRY(layernorm());
      // cross-attention over the encoder K/V (q2 reuses the qkv buffer;
      // int8: q2 stays f32 until it meets the K scale)
      TPK_TRY(gemm(2, yb, D, wq2, l, q8 ? (void*)q32 : (void*)qb, HD, bq2, 0,
                   0, q8 ? 0 : 1));
      if (q8) {
        signed char* ek8 = q8 + (size_t)l * 2 * HD;
        const float* sl = scales + (size_t)l * 2 * H;
        TPK_TRY(launch_attend(go, q32, HD, ek8, ek8 + HD, (long long)TE * KV,
                              KV, TE, src_mask, TE, sl, sl + H, ab, HD, N, H,
                              nullptr, nullptr, 0, 0, st));
      } else {
        bf16* ek = ekv + (size_t)l * 2 * HD;
        TPK_TRY(launch_attend(go, qb, HD, ek, ek + HD, (long long)TE * KV, KV,
                              TE, src_mask, TE, nullptr, nullptr, ab, HD, N,
                              H, nullptr, nullptr, 0, 0, st));
      }
      TPK_TRY(gemm(3, ab, HD, wfc2, l, x32, D, nullptr, 0, 1, 0));
      TPK_TRY(layernorm());
      // FFN, then the next layer's LN1 (the head normalises after the last)
      TPK_TRY(gemm(4, yb, D, w1, l, hb, DI, b1, 1, 0, 1));
      TPK_TRY(gemm(5, hb, DI, w2, l, x32, D, b2, 0, 1, 0));
      if (l + 1 < L) TPK_TRY(layernorm());
    }
    TPK_TRY(launch_pdl(decode_head_kernel, (N + head_rows - 1) / head_rows,
                       kHeadWarps * 32, head_smem, st, 1, go, x32, D,
                       (const bf16*)wcls_t, bcls, NC, probs, S, t, tok,
                       finished, remaining, end_idx, 1e-6f, N, head_rows));
  }
  return 0;
}
