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
// * runs each step product (QKV, fc1, q2, fc2, w1, w2) as step_gemm_kernel
//   (decode_blocks.cuh, shared with the per-step kernels of
//   decode_step.cu): 64-row tiles, BN in {16, 32, 64} columns and split-K
//   through clusters, chosen per product and bucket by the wrapper
//   (ops/full_decode.py `gemm_plan`) so that every product runs on >= 132
//   blocks, fed by a 4-stage cp.async ring into mma.sync. A tile's rows are
//   32-128 bytes: fed as one bulk copy (cp.async.bulk) a row, ~100 a stage
//   issued one at a time by the SM's copy engine, the products took 43 us
//   each at N=512 on the H100, no faster than an unpipelined WMMA GEMM.
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
#include "decode_blocks.cuh"
#include "gemm.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // embed_ln_kernel: one warp per row

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
    p.res = residual ? C : nullptr;
    p.go = go;
    p.lda = lda;
    p.ldb = prod_n[i];
    p.ldc = ldc;
    p.ldr = ldc;
    p.M = N;
    p.N = prod_n[i];
    p.K = prod_k[i];
    p.splits = plan[2 * i + 1];
    p.gelu = gelu;
    p.res_bf16 = 0;
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
      TPK_TRY((launch_attend<false, bf16, bf16, bf16>(
          go, qb, 3 * HD, 1.f, cl, cl + HD, (long long)S * 2 * HD, kDk,
          2 * HD, t + 1, nullptr, 0, nullptr, nullptr, ab, HD, N, H,
          qb + HD, qb + 2 * HD, 3 * HD, t, st)));
      TPK_TRY(gemm(1, ab, HD, wfc1, l, x32, D, nullptr, 0, 1, 0));
      TPK_TRY(layernorm());
      // cross-attention over the encoder K/V (q2 reuses the qkv buffer;
      // int8: q2 stays f32 until it meets the K scale)
      TPK_TRY(gemm(2, yb, D, wq2, l, q8 ? (void*)q32 : (void*)qb, HD, bq2, 0,
                   0, q8 ? 0 : 1));
      if (q8) {
        signed char* ek8 = q8 + (size_t)l * 2 * HD;
        const float* sl = scales + (size_t)l * 2 * H;
        TPK_TRY((launch_attend<false, float, signed char, signed char>(
            go, q32, HD, 1.f, ek8, ek8 + HD, (long long)TE * KV, kDk, KV, TE,
            src_mask, TE, sl, sl + H, ab, HD, N, H, nullptr, nullptr, 0,
            0, st)));
      } else {
        bf16* ek = ekv + (size_t)l * 2 * HD;
        TPK_TRY((launch_attend<false, bf16, bf16, bf16>(
            go, qb, HD, 1.f, ek, ek + HD, (long long)TE * KV, kDk, KV, TE,
            src_mask, TE, nullptr, nullptr, ab, HD, N, H, nullptr,
            nullptr, 0, 0, st)));
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
