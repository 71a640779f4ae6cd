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
// ((N, TE, L, 2HD) bf16, one GEMM) and the self-attention cache
// ((L, N, S, 2HD) bf16) live in global scratch that the wrapper allocates,
// and a host loop runs the steps. Each step is one embed kernel, per layer
// the encoder's GEMM and LayerNorm kernels plus a one-query attention kernel
// (one warp per (row, head); the self-attention variant appends this step's
// K/V to the cache first), and one head kernel that fuses the final
// LayerNorm, the classifier, the softmax, the probs store, the argmax and the
// EOS bookkeeping.
//
// Bound on the H100: per step the weights (~12 MB bf16, L2-resident) and the
// encoder K/V (~400 MB at N=512, read once per layer-step) dominate: ~16 GB
// over 40 steps, ~5 ms at 3.35 TB/s. The GEMMs are skinny (M = N rows) and
// the launches are many (~70 per step). Early exit costs one device-to-host
// copy and a stream synchronisation per step, which drains the queue before
// the next step is enqueued. Replacing the host loop (CUDA graphs, a
// persistent kernel) is later work.
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
// bf16 branch: ~8 GB over 40 steps at N=512, ~2.4 ms at 3.35 TB/s; its
// serial per-key loop, not the bytes, sets its time for now. Rounding points of the TPU
// kernel's `_attend_allheads`: q = bf16(q_f32 * k_scale), scores = q .
// k8 in f32, softmax weights rounded to bf16 before . v8, the f32 result
// times v_scale. The self-attention and the rest of the step are the bf16
// branch's.
#include "common.cuh"

namespace {

constexpr int kAttnWarps = 4;
constexpr int kMaxKeys = 256;

// x32[n, :] = embed[tok[n], :] + pe_t[:]
__global__ void embed_kernel(const int* __restrict__ tok,
                             const bf16* __restrict__ embed,
                             const float* __restrict__ pe_t,
                             float* __restrict__ x32, int D) {
  const int n = blockIdx.x;
  const bf16* e = embed + (size_t)tok[n] * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    x32[(size_t)n * D + d] = __bfloat162float(e[d]) + pe_t[d];
}

// One warp per (row n, head h); head width DK = 64, two dims per lane.
// q: row n at q + n*q_rs (bf16; f32 for int8 K/V). K and V of key j at
// kbase/vbase + n*kv_rs + j*kv_ks (bf16 or int8). When app_k is given
// (bf16 K/V), this step's K/V (app_k/app_v + n*app_rs) are first written to
// key slot app_slot. mask (N, nkeys): key j valid iff mask > 0 (null = all
// valid). int8 K/V come with the layer's per-head scales: q is rounded to
// bf16 after the K scale, the output takes the V scale.
template <typename Q, typename KV>
__global__ void __launch_bounds__(kAttnWarps * 32)
attend_one_query_kernel(const Q* __restrict__ q, long long q_rs, KV* kbase,
                        KV* vbase, long long kv_rs, long long kv_ks,
                        int nkeys, const float* __restrict__ mask,
                        int mask_rs, const float* __restrict__ kscale,
                        const float* __restrict__ vscale,
                        bf16* __restrict__ out, long long out_rs, int N,
                        int H, int DK, const bf16* app_k, const bf16* app_v,
                        long long app_rs, int app_slot) {
  __shared__ float sc[kAttnWarps][kMaxKeys];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kAttnWarps + warp;
  if (w >= N * H) return;
  const int n = w / H, h = w % H;
  const int off = h * DK;
  KV* kr = kbase + n * kv_rs + off;
  KV* vr = vbase + n * kv_rs + off;
  float2 qf = load2(q + n * q_rs + off, lane);
  if (kscale) {
    qf.x = bf_round(qf.x * kscale[h]);
    qf.y = bf_round(qf.y * kscale[h]);
  }
  if (app_k) {
    reinterpret_cast<bf162*>(kr + app_slot * kv_ks)[lane] =
        reinterpret_cast<const bf162*>(app_k + n * app_rs + off)[lane];
    reinterpret_cast<bf162*>(vr + app_slot * kv_ks)[lane] =
        reinterpret_cast<const bf162*>(app_v + n * app_rs + off)[lane];
  }
  float m = -INFINITY;
  for (int j = 0; j < nkeys; ++j) {
    const float2 kf = load2(kr + j * kv_ks, lane);
    float s = warp_sum(qf.x * kf.x + qf.y * kf.y);
    if (mask && !(mask[(size_t)n * mask_rs + j] > 0.f)) s = -1e9f;
    if (lane == 0) sc[warp][j] = s;
    m = fmaxf(m, s);
  }
  __syncwarp();
  float sum = 0.f;
  for (int j = 0; j < nkeys; ++j) sum += expf(sc[warp][j] - m);
  float ox = 0.f, oy = 0.f;
  for (int j = 0; j < nkeys; ++j) {
    const float p = bf_round(expf(sc[warp][j] - m) / sum);
    const float2 vf = load2(vr + j * kv_ks, lane);
    ox += p * vf.x;
    oy += p * vf.y;
  }
  if (vscale) {
    ox *= vscale[h];
    oy *= vscale[h];
  }
  store2(out + n * out_rs + off, lane, ox, oy);
}

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

// One block per row: final LN (affine folded into wcls/bcls) -> logits over
// NC classes -> softmax -> probs[n, t, :] -> argmax -> next token + EOS
// bookkeeping. Dynamic shared memory: (D + NC) floats.
__global__ void decode_head_kernel(const float* __restrict__ x, int D,
                                   const bf16* __restrict__ wcls,
                                   const float* __restrict__ bcls, int NC,
                                   float* __restrict__ probs, int S, int t,
                                   int* tok, int* finished, int* remaining,
                                   int end_idx, float eps) {
  extern __shared__ __align__(16) float hsm[];
  float* xn = hsm;
  float* lg = hsm + D;
  __shared__ float red[32];
  __shared__ float best_v[32];
  __shared__ int best_i[32];
  const int n = blockIdx.x, tid = threadIdx.x;
  const float* xr = x + (size_t)n * D;
  float s = 0.f;
  for (int d = tid; d < D; d += blockDim.x) s += xr[d];
  const float mu = block_sum(s, red) / (float)D;
  float v = 0.f;
  for (int d = tid; d < D; d += blockDim.x) {
    const float u = xr[d] - mu;
    v += u * u;
  }
  const float rstd = rsqrtf(block_sum(v, red) / (float)D + eps);
  for (int d = tid; d < D; d += blockDim.x) xn[d] = bf_round((xr[d] - mu) * rstd);
  __syncthreads();
  float m = -INFINITY;
  for (int c = tid; c < NC; c += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < D; ++k)
      acc += xn[k] * __bfloat162float(wcls[(size_t)k * NC + c]);
    acc += bcls[c];
    lg[c] = acc;
    m = fmaxf(m, acc);
  }
  m = block_max(m, red);
  float z = 0.f;
  for (int c = tid; c < NC; c += blockDim.x) {
    const float e = expf(lg[c] - m);
    lg[c] = e;
    z += e;
  }
  z = block_sum(z, red);
  float bv = -1.f;
  int bi = 0x7fffffff;
  float* pr = probs + ((size_t)n * S + t) * NC;
  for (int c = tid; c < NC; c += blockDim.x) {
    const float p = lg[c] / z;
    pr[c] = p;
    if (p > bv) {  // c increases within a thread: keeps the first max
      bv = p;
      bi = c;
    }
  }
  // block argmax, ties to the lower index
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int w = 1; w < nwarps; ++w)
      if (best_v[w] > bv || (best_v[w] == bv && best_i[w] < bi)) {
        bv = best_v[w];
        bi = best_i[w];
      }
    tok[n] = bi;
    if (end_idx >= 0 && bi == end_idx && !finished[n]) {
      finished[n] = 1;
      atomicSub(remaining, 1);
    }
  }
}

template <typename Q, typename KV>
int launch_attend(const Q* q, long long q_rs, KV* k, KV* v, long long kv_rs,
                  long long kv_ks, int nkeys, const float* mask, int mask_rs,
                  const float* kscale, const float* vscale, bf16* out,
                  long long out_rs, int N, int H, int DK, const bf16* app_k,
                  const bf16* app_v, long long app_rs, int app_slot,
                  cudaStream_t st) {
  const int blocks = (N * H + kAttnWarps - 1) / kAttnWarps;
  attend_one_query_kernel<<<blocks, kAttnWarps * 32, 0, st>>>(
      q, q_rs, k, v, kv_rs, kv_ks, nkeys, mask, mask_rs, kscale, vscale, out,
      out_rs, N, H, DK, app_k, app_v, app_rs, app_slot);
  TPK_CHECK();
  return 0;
}

}  // namespace

// Whole greedy decode. Weights (folded, stacked over layers):
//   wkv_enc (D, L*2HD) bf16: per layer [K | V] of the cross-attention;
//   embed (C, D) bf16; pe (S, D) f32;
//   wqkv (L, D, 3HD), wfc1 (L, HD, D), wq2 (L, D, HD), wfc2 (L, HD, D),
//   w1 (L, D, DI), w2 (L, DI, D) bf16; bqkv (L, 3HD), bq2 (L, HD),
//   b1 (L, DI), b2 (L, D) f32; wcls (D, NC) bf16, bcls (NC) f32.
// Scratch: enc_kv (N*TE, L*2HD) bf16, cache (L, N, S, 2HD) bf16,
//   x32 (N, D) f32, y (N, D) bf16, qkv (N, 3HD) bf16, att (N, HD) bf16,
//   hid (N, DI) bf16, tok/finished (N) int32, remaining (1) int32.
// probs (N, S, NC) f32. int8 encoder K/V when enc_q8 is given: enc_kv
// then holds the projection on entry (the wrapper computes it, as the JAX
// package does outside its kernel), and the scratch is enc_q8
// (N*TE, L*2HD) int8, amax (L*2H) uint32, scales (L*2H) f32 (index
// l*2H + {0: K, 1: V}*H + h) and q32 (N, HD) f32; all null for the bf16
// branch, whose projection is the first GEMM here. end_idx < 0 disables the early exit. *steps_run receives the
// number of steps run.
extern "C" int tpk_full_decode(
    const void* out_enc, const float* src_mask, const void* wkv_enc,
    const void* embed, const float* pe, const void* wqkv, const float* bqkv,
    const void* wfc1, const void* wq2, const float* bq2, const void* wfc2,
    const void* w1, const float* b1, const void* w2, const float* b2,
    const void* wcls, const float* bcls, void* enc_kv, void* cache,
    float* x32, void* y, void* qkv, void* att, void* hid, int* tok,
    int* finished, int* remaining, float* probs, void* enc_q8,
    unsigned* amax, float* scales, float* q32, int N, int TE, int D, int H,
    int DK, int DI, int L, int S, int NC, int start_idx, int end_idx,
    int* steps_run, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * DK, KV = L * 2 * HD;
  *steps_run = 0;
  if (DK != 64 || S > kMaxKeys || TE > kMaxKeys)
    return (int)cudaErrorInvalidValue;
  const size_t head_smem = sizeof(float) * (size_t)(D + NC);
  if (head_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  bf16* ekv = (bf16*)enc_kv;
  bf16* ch = (bf16*)cache;
  bf16* yb = (bf16*)y;
  bf16* qb = (bf16*)qkv;
  bf16* ab = (bf16*)att;
  bf16* hb = (bf16*)hid;

  signed char* q8 = (signed char*)enc_q8;
  if (!q8) {
    TPK_TRY(tpk_launch_gemm((const bf16*)out_enc, D, (const bf16*)wkv_enc,
                            KV, ekv, KV, N * TE, KV, D, nullptr, nullptr, 0,
                            0, 1, st));
  } else {
    const int G = KV / 64, rows = N * TE, rpb = 256;
    cudaMemsetAsync(amax, 0, sizeof(unsigned) * G, st);
    TPK_CHECK();
    if (rows > 0) {
      group_absmax_kernel<<<dim3(G, (rows + rpb - 1) / rpb), 256, 0, st>>>(
          ekv, rows, KV, rpb, amax);
      TPK_CHECK();
    }
    const size_t pairs = (size_t)rows * KV / 2;
    quantize_groups_kernel<<<1024, 256, 0, st>>>(ekv, amax, scales, q8,
                                                 pairs, KV, G);
    TPK_CHECK();
  }
  cudaMemsetAsync(probs, 0, sizeof(float) * (size_t)N * S * NC, st);
  cudaMemsetAsync(remaining, 0, sizeof(int), st);
  TPK_CHECK();
  decode_init_kernel<<<(N + 127) / 128, 128, 0, st>>>(
      src_mask, TE, N, start_idx, tok, finished, remaining);
  TPK_CHECK();

  for (int t = 0; t < S; ++t) {
    if (end_idx >= 0) {  // checked before each step, as the TPU loop does
      int left = 0;
      cudaMemcpyAsync(&left, remaining, sizeof(int), cudaMemcpyDeviceToHost,
                      st);
      cudaStreamSynchronize(st);
      TPK_CHECK();
      if (left == 0) break;
    }
    embed_kernel<<<N, 256, 0, st>>>(tok, (const bf16*)embed,
                                    pe + (size_t)t * D, x32, D);
    TPK_CHECK();
    for (int l = 0; l < L; ++l) {
      bf16* cl = ch + (size_t)l * N * S * 2 * HD;
      // self-attention over the cached steps 0..t
      TPK_TRY(tpk_launch_layernorm(x32, D, yb, D, N, D, 1e-5f, nullptr,
                                   nullptr, 1, st));
      TPK_TRY(tpk_launch_gemm(yb, D, (const bf16*)wqkv + (size_t)l * D * 3 * HD,
                              3 * HD, qb, 3 * HD, N, 3 * HD, D,
                              bqkv + (size_t)l * 3 * HD, nullptr, 0, 0, 1, st));
      TPK_TRY(launch_attend(qb, 3 * HD, cl, cl + HD, (long long)S * 2 * HD,
                            2 * HD, t + 1, nullptr, 0, nullptr, nullptr, ab,
                            HD, N, H, DK, qb + HD, qb + 2 * HD, 3 * HD, t,
                            st));
      TPK_TRY(tpk_launch_gemm(ab, HD, (const bf16*)wfc1 + (size_t)l * HD * D,
                              D, x32, D, N, D, HD, nullptr, x32, D, 0, 0, st));
      // cross-attention over the encoder K/V (q2 reuses the qkv buffer)
      TPK_TRY(tpk_launch_layernorm(x32, D, yb, D, N, D, 1e-5f, nullptr,
                                   nullptr, 1, st));
      // int8: q2 stays f32 until it meets the K scale
      TPK_TRY(tpk_launch_gemm(yb, D, (const bf16*)wq2 + (size_t)l * D * HD,
                              HD, q8 ? (void*)q32 : (void*)qb, HD, N, HD, D,
                              bq2 + (size_t)l * HD, nullptr, 0, 0, q8 ? 0 : 1,
                              st));
      if (q8) {
        signed char* ek8 = q8 + (size_t)l * 2 * HD;
        const float* sl = scales + (size_t)l * 2 * H;
        TPK_TRY(launch_attend(q32, HD, ek8, ek8 + HD, (long long)TE * KV, KV,
                              TE, src_mask, TE, sl, sl + H, ab, HD, N, H, DK,
                              nullptr, nullptr, 0, 0, st));
      } else {
        bf16* ek = ekv + (size_t)l * 2 * HD;
        TPK_TRY(launch_attend(qb, HD, ek, ek + HD, (long long)TE * KV, KV,
                              TE, src_mask, TE, nullptr, nullptr, ab, HD, N,
                              H, DK, nullptr, nullptr, 0, 0, st));
      }
      TPK_TRY(tpk_launch_gemm(ab, HD, (const bf16*)wfc2 + (size_t)l * HD * D,
                              D, x32, D, N, D, HD, nullptr, x32, D, 0, 0, st));
      // FFN
      TPK_TRY(tpk_launch_layernorm(x32, D, yb, D, N, D, 1e-5f, nullptr,
                                   nullptr, 1, st));
      TPK_TRY(tpk_launch_gemm(yb, D, (const bf16*)w1 + (size_t)l * D * DI, DI,
                              hb, DI, N, DI, D, b1 + (size_t)l * DI, nullptr,
                              0, 1, 1, st));
      TPK_TRY(tpk_launch_gemm(hb, DI, (const bf16*)w2 + (size_t)l * DI * D, D,
                              x32, D, N, D, DI, b2 + (size_t)l * D, x32, D, 0,
                              0, st));
    }
    decode_head_kernel<<<N, 128, head_smem, st>>>(
        x32, D, (const bf16*)wcls, bcls, NC, probs, S, t, tok, finished,
        remaining, end_idx, 1e-6f);
    TPK_CHECK();
    *steps_run = t + 1;
  }
  return 0;
}
