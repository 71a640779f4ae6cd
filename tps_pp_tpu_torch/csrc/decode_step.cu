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
// traffic of an in-place slot update. An SM holds 227 KB, not the layer's
// 2.5 MB of weights, so here each entry point is three launches chained
// with programmatic dependent launch, built from the whole decode's blocks
// (decode_blocks.cuh):
//
// * LayerNorm + the first product (ln_product_kernel): a block owns 16 rows
//   and W in {32, 64, 128} columns of the product; it stages its rows of x
//   and the affine in shared memory, normalises them there (8 threads a
//   row), then streams its columns of the weights through a ring of 64-deep
//   cp.async stages (the first issued before the wait on the kernel
//   before: no kernel writes the weights) into mma.sync with f32
//   accumulation, K split over the warps, and stores f32 (qkv, or q). The
//   launcher picks W and the ring's depth from N, the SM count and the
//   shared memory.
// * The attention: attend_keys_kernel, one warp a (row, head), lanes over
//   keys, whole K rows in 16-byte loads, the keys that earlier kernels
//   wrote loaded before the wait; the self-attention stores this step's
//   k/v to slot t rounded to X and reads them unrounded.
// * Self-attention: the output product + residual on step_gemm_kernel (the
//   skinny-M split-K GEMM; plan from N and the SM count), its residual x
//   read in place of a copy, out in X.
// * Cross + FFN: ffn_cluster_kernel, one cluster of CS blocks a band of 16
//   rows, each block 1/CS of every product's columns: x2 = x + att @ Wfc
//   kept in registers; LN3's row statistics summed over the cluster
//   through distributed shared memory (two passes, in rank order); each
//   block writes its columns of bf16(LN3(x2)) and gathers the others' from
//   the cluster, then its columns of GELU(. @ W1 + b1), gathered likewise,
//   then x_out = x2 + (. @ W2 + b2). One ring streams the three products'
//   weight columns, so W1's and W2's loads are in flight during the
//   exchanges; it is 8 stages deep when every cluster of the grid is
//   resident at once with that, else 4. No f32 copy of the residual stream
//   goes through memory.
//
// Bound on the H100 at N=512 (flagship: D=512, H=8, T=41, TE=64, DI=256):
// memory. The self-attention step moves the weights (2 MB bf16) and t
// cache slots of K and V (1.05 MB per slot), ~21 MB at the mean step t=20,
// ~7 us at 3.35 TB/s; the cross step reads 67 MB of encoder K/V, ~20 us.
// A block of the row-block kernels here is 4 warps, one a scheduler, so
// their time is the latency of each warp's chain of instructions and
// memory round trips, not their bytes; the notes at each kernel say what
// its layout does about that.
#include "decode_blocks.cuh"

namespace {

// ---- row blocks: 16 rows a block, weights streamed -------------------------
constexpr int kRbM = 16;          // rows a block (one m16 tile)
constexpr int kRbK = 64;          // depth of a ring stage
constexpr int kRbThreads = 128;   // 4 warps, a quarter of the columns each
constexpr int kRbMaxNF = 4;       // n fragments a warp: <= 128 columns
constexpr int kStepMaxD = 512;    // the LayerNorm prologue's row width
constexpr float kQScale = 0.125f; // 1 / sqrt(d_k)

// The weights' ring of S slots (4 or 8, the launcher's choice): stage g
// holds rows k0 .. k0 + 63 of w columns of B (w in {32, 64, 128}) in slot
// g % S, rows of bld elements (w + 8 at most: 16 bytes of padding, free of
// bank conflicts for ldmatrix). Each thread's copies of a stage are one
// cp.async group; S - 1 stages are in flight. A block here runs one warp
// a scheduler, so its time is the latency of each warp's instruction
// chain: the addressing is shifts and masks, and the stages are deep.
// (Tracked by an mbarrier a stage, with cp.async.mbarrier.arrive, and 32
// deep with divisions in the addressing, a stage cost about a memory
// round trip on the H100.)
template <int S>
struct RbRing {
  bf16* bs;
  int bld;

  __device__ __forceinline__ void fill(int g, const bf16* B, int ldb, int c0,
                                       int k0, int w, int tid) const {
    bf16* dst = stage(g);
    const int lv = w == 128 ? 4 : w == 64 ? 3 : 2;  // log2(w / 8)
    const bf16* src = B + (size_t)k0 * ldb + c0;
    for (int e = tid; e < kRbK << lv; e += kRbThreads) {
      const int r = e >> lv, c = (e & ((1 << lv) - 1)) << 3;
      ptx::cp_async16(dst + r * bld + c, src + r * ldb + c);
    }
  }

  __device__ __forceinline__ bf16* stage(int g) const {
    return bs + (g & (S - 1)) * kRbK * bld;
  }
};

// acc[j] += A[0:16, ka:ka+64] @ Bs[0:64, wc + 8j : wc + 8j + 8], j < nf:
// A in shared memory (row stride ald), one ring stage Bs (stride bld).
static __device__ __forceinline__ void rb_mma(const bf16* As, int ald, int ka,
                                              const bf16* Bs, int bld, int wc,
                                              int nf,
                                              float (&acc)[kRbMaxNF][4],
                                              int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kRbK; kk += 16) {
    uint32_t a[4];
    ptx::ldsm_x4(a, As + (lane & 15) * ald + ka + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < kRbMaxNF; j += 2) {
      if (j >= nf) break;
      uint32_t b[4];
      ptx::ldsm_x4_t(b, Bs + (kk + (mi & 1) * 8 + (lane & 7)) * bld + wc +
                            j * 8 + (mi >> 1) * 8);
      ptx::mma_bf16(acc[j], a, b[0], b[1]);
      if (j + 1 < nf) ptx::mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// Consumes ring stages g .. g + nst - 1 as the k-steps of A @ (the stages'
// columns) into acc. Before stage g a thread waits for its copies of it,
// the block syncs (so every warp is done with stage g - 1), and issue(g +
// S - 1) refills g - 1's slot (issue commits a group, empty past the last
// stage). A caller that then writes what the warps read here syncs first.
template <int S, typename Issue>
static __device__ __forceinline__ void rb_product(
    const RbRing<S>& ring, const Issue& issue, int& g, const bf16* A, int ald,
    int nst, int wc, int nf, float (&acc)[kRbMaxNF][4], int lane) {
#pragma unroll
  for (int j = 0; j < kRbMaxNF; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int i = 0; i < nst; ++i, ++g) {
    ptx::cp_async_wait_group<S - 2>();
    __syncthreads();
    issue(g + S - 1);
    rb_mma(A, ald, i * kRbK, ring.stage(g), ring.bld, wc, nf, acc, lane);
  }
}

// ---- LayerNorm + product --------------------------------------------------
// C (N, Nout) f32 = bf16(LN(x) * s + b) @ B (D, Nout). Grid (Nout / W,
// ceil(N / 16)). A block here is 4 warps, one a scheduler, so its time is
// the latency of each warp's chain; both phases are laid out for
// independent work. The LayerNorm's affine (before the wait) and the
// band's rows of x (after it) land in shared memory by cp.async; 8
// threads a row then normalise all 16 rows at once, each thread's 64
// values of its row read once, in 16-byte vectors, and held in registers
// (8-lane sums). The product: warp w takes the
// k16 slice w of every 64-deep stage over all W columns (W / 8
// independent mma chains), and the four warps' partial sums are added in
// warp order through shared memory (the ring, drained) at the end. (A
// warp a quarter of the columns, over all of K, with rows normalised from
// global memory four a warp, was slower on the H100.) Shared memory:
// A (16 x (D + 8) bf16), the x band (16 rows of D of X and 16 bytes, free
// of bank conflicts), the affine (2 x D f32), the ring.
template <typename X, int S>
__global__ void __launch_bounds__(kRbThreads)
ln_product_kernel(const X* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const bf16* __restrict__ B,
                  float* __restrict__ C, int N, int D, int Nout, int W,
                  const unsigned char* __restrict__ skip) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ald = D + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);
  constexpr int VX = 16 / (int)sizeof(X);  // values a 16-byte vector
  const int xld = D + VX;                  // x band row stride
  X* xs = reinterpret_cast<X*>(As + kRbM * ald);
  float* aff = reinterpret_cast<float*>(xs + kRbM * xld);  // s, then b
  const RbRing<S> ring = {reinterpret_cast<bf16*>(aff + 2 * D), W + 8};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kRbM, c0 = blockIdx.x * W;
  const int rows = min(kRbM, N - m0), nst = D / kRbK;
  for (int v = tid; v < D / 4; v += kRbThreads) {
    ptx::cp_async16(aff + 4 * v, ln_s + 4 * v);
    ptx::cp_async16(aff + D + 4 * v, ln_b + 4 * v);
  }
  auto issue = [&](int g) {
    if (g < nst) ring.fill(g, B, Nout, c0, g * kRbK, W, tid);
    ptx::cp_async_commit();
  };
  for (int g = 0; g < S - 1; ++g) issue(g);
  ptx::grid_dep_wait();
  if (skip && *skip) {
    ptx::cp_async_wait_all();
    return;
  }
  ptx::grid_dep_launch();

  const int xv = D / VX;  // 16-byte vectors a row
  for (int r = 0; r < rows; ++r)
    for (int v = tid; v < xv; v += kRbThreads)
      ptx::cp_async16(reinterpret_cast<uint4*>(xs + r * xld) + v,
                      reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * D) +
                          v);
  ptx::cp_async_commit();
  ptx::cp_async_wait_all();
  __syncthreads();
  {
    // row r, its 16-byte vectors p + 8 i (D / (8 VX) <= 64 / VX of them)
    constexpr int NV = 64 / VX;
    const int r = tid >> 3, p = tid & 7, nv = xv / 8;
    const uint4* xr = reinterpret_cast<const uint4*>(xs + r * xld);
    float v[NV][VX];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i < nv) {
        const uint4 u = xr[p + 8 * i];
        if constexpr (VX == 8) {
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[i][2 * k] = __uint_as_float(w[k] << 16);
            v[i][2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
          }
        } else {
          v[i][0] = __uint_as_float(u.x);
          v[i][1] = __uint_as_float(u.y);
          v[i][2] = __uint_as_float(u.z);
          v[i][3] = __uint_as_float(u.w);
        }
      }
    // every lane runs the sums (rows past N on whatever the band holds:
    // the shuffles need the whole warp), rows past N store zeros
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int k = 0; k < VX; ++k)
        if (i < nv) sum += v[i][k];
    for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / (float)D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int k = 0; k < VX; ++k)
        if (i < nv) q += (v[i][k] - mu) * (v[i][k] - mu);
    for (int o = 1; o < 8; o <<= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rstd = rsqrtf(q / (float)D + 1e-5f);
    bf16* yr = As + r * ald;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i < nv) {
        const int c = (p + 8 * i) * VX;
#pragma unroll
        for (int k = 0; k < VX; k += 2) {
          const float2 s2 = load2(aff + c + k, 0);
          const float2 b2 = load2(aff + D + c + k, 0);
          const float a = r < rows ? (v[i][k] - mu) * rstd * s2.x + b2.x : 0.f;
          const float b = r < rows ? (v[i][k + 1] - mu) * rstd * s2.y + b2.y
                                   : 0.f;
          store2(yr + c + k, 0, a, b);
        }
      }
  }

  // the product, K split over the warps
  constexpr int kMaxNF = 16;  // W <= 128
  const int nf = W / 8, mi = lane >> 3, kk = warp * 16;
  float acc[kMaxNF][4];
#pragma unroll
  for (int j = 0; j < kMaxNF; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int g = 0; g < nst; ++g) {
    ptx::cp_async_wait_group<S - 2>();
    __syncthreads();  // stage g landed; every warp is done with g - 1
    issue(g + S - 1);
    const bf16* Bs = ring.stage(g);
    uint32_t a[4];
    ptx::ldsm_x4(a, As + (lane & 15) * ald + g * kRbK + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < kMaxNF; j += 2) {
      if (j >= nf) break;
      uint32_t b[4];
      ptx::ldsm_x4_t(b, Bs + (kk + (mi & 1) * 8 + (lane & 7)) * ring.bld +
                            j * 8 + (mi >> 1) * 8);
      ptx::mma_bf16(acc[j], a, b[0], b[1]);
      ptx::mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
  // the warps' partial tiles (16 x W f32 each) into the drained ring,
  // then each thread sums four columns of a row over the warps, in order
  ptx::cp_async_wait_all();
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring.bs);
  const int gr = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < kMaxNF; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (j < nf)
        *reinterpret_cast<float2*>(part + (warp * kRbM + gr + 8 * h) * W +
                                   j * 8 + 2 * q) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  __syncthreads();
  const int w4 = W / 4;
  for (int e = tid; e < rows * w4; e += kRbThreads) {
    const int r = e / w4, c = (e % w4) * 4;
    float4 v = *reinterpret_cast<const float4*>(part + r * W + c);
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      const float4 u =
          *reinterpret_cast<const float4*>(part + (w * kRbM + r) * W + c);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(C + (size_t)(m0 + r) * Nout + c0 + c) = v;
  }
}

size_t ln_product_smem(int D, int W, size_t x_bytes, int S) {
  return sizeof(bf16) * ((size_t)kRbM * (D + 8) +
                         (size_t)S * kRbK * (W + 8)) +
         x_bytes * kRbM * D + 16 * kRbM + 2 * sizeof(float) * D;
}

// The current device's SM count, read once a device (under a lock: host
// threads launch on their cards at once).
int sm_count() {
  static int sms[64];
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) dev = 63;
  std::lock_guard<std::mutex> hold(mu);
  if (!sms[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 1;
  }
  return sms[dev];
}

// (W, S): W in {128, 64, 32} (dividing Nout) and 8 or 4 ring slots; the
// fewest waves of blocks (as many resident an SM as its 228 KB of shared
// memory hold, at most 4), then the deeper ring, then, with a block for
// every SM, the widest W, else the narrowest (more blocks in flight).
template <typename X>
int launch_ln_product(const X* x, const float* s, const float* b,
                      const bf16* B, float* C, int N, int D, int Nout,
                      int sms, const unsigned char* skip, cudaStream_t st) {
  const long long bands = (N + kRbM - 1) / kRbM;
  int W = 0, S = 0;
  long long best[3] = {0, 0, 0};
  for (int slots : {8, 4})
    for (int w : {128, 64, 32}) {
      if (Nout % w) continue;
      const long long blocks = Nout / w * bands;
      const long long res = std::min<long long>(
          4, 227 * 1024 / (ln_product_smem(D, w, sizeof(X), slots) + 1024));
      if (res < 1) continue;
      const long long key[3] = {(blocks + sms * res - 1) / (sms * res),
                                -slots, blocks >= sms ? -w : w};
      if (!W || std::lexicographical_compare(key, key + 3, best, best + 3)) {
        W = w;
        S = slots;
        std::copy(key, key + 3, best);
      }
    }
  const size_t smem = ln_product_smem(D, W, sizeof(X), S);
  auto kernel = S == 8 ? ln_product_kernel<X, 8> : ln_product_kernel<X, 4>;
  TPK_TRY(allow_smem(kernel, smem));
  return launch_pdl(kernel, dim3(Nout / W, bands), kRbThreads, smem, st, 1,
                    x, s, b, B, C, N, D, Nout, W, skip);
}

// ---- fc + residual -> LN3 -> W1 + GELU -> W2 + b2 + residual -------------
// Grid (1, ceil(N / 16), CS) in clusters of CS blocks along z: cluster =
// band of 16 rows, block rank q = columns q sd .. (q+1) sd - 1 of fc and
// W2 (sd = D / CS) and q si .. of W1 (si = DI / CS). Shared memory: A
// (16 x (max(D, HD) + 8) bf16: att, then bf16(LN3(x2))), H (16 x (DI + 8)
// bf16), the ring, and the row sums.
struct FfnLayout {
  size_t a, h, ring, red, bytes;
  int ald, hld, bld;
};

static __host__ __device__ FfnLayout ffn_layout(int D, int HD, int DI,
                                                int CS, int S) {
  FfnLayout l;
  l.ald = (D > HD ? D : HD) + 8;
  l.hld = DI + 8;
  l.bld = (D / CS > DI / CS ? D / CS : DI / CS) + 8;
  l.a = 0;
  l.h = l.a + sizeof(bf16) * kRbM * l.ald;
  l.ring = l.h + sizeof(bf16) * kRbM * l.hld;
  l.red = l.ring + sizeof(bf16) * S * kRbK * l.bld;
  // red (4 warps x 16 rows), two passes' partials and sums (16 rows each)
  l.bytes = l.red + sizeof(float) * (4 * kRbM + 4 * kRbM);
  return l;
}

template <typename X, int S>
__global__ void __launch_bounds__(kRbThreads)
ffn_cluster_kernel(const X* __restrict__ x, const bf16* __restrict__ att,
                   const bf16* __restrict__ wfc,
                   const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   const bf16* __restrict__ w2, const float* __restrict__ b2,
                   X* __restrict__ out, int N, int D, int HD, int DI,
                   const unsigned char* __restrict__ skip) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const FfnLayout L = ffn_layout(D, HD, DI, CS, S);
  bf16* As = reinterpret_cast<bf16*>(smem + L.a);
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.h);
  float* red = reinterpret_cast<float*>(smem + L.red);   // [4][16]
  float* part = red + 4 * kRbM;                           // [2][16]
  float* stat = part + 2 * kRbM;                          // [2][16]
  const RbRing<S> ring = {reinterpret_cast<bf16*>(smem + L.ring), L.bld};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, q4 = lane & 3;
  const int m0 = blockIdx.y * kRbM, rows = min(kRbM, N - m0);
  const int sd = D / CS, si = DI / CS;
  const int n0 = HD / kRbK, n1 = D / kRbK, n2 = DI / kRbK;
  const int total = n0 + n1 + n2;
  auto issue = [&](int g) {
    if (g < n0)
      ring.fill(g, wfc, D, rank * sd, g * kRbK, sd, tid);
    else if (g < n0 + n1)
      ring.fill(g, w1, DI, rank * si, (g - n0) * kRbK, si, tid);
    else if (g < total)
      ring.fill(g, w2, D, rank * sd, (g - n0 - n1) * kRbK, sd, tid);
    ptx::cp_async_commit();
  };
  for (int g = 0; g < S - 1; ++g) issue(g);
  // this thread's columns of LN3's affine, b1 and b2, and (after the wait)
  // of x, all loaded before any store: a load after a store that may alias
  // it would wait for it
  const int nfd = sd / 32, wcd = warp * (sd / 4);
  const int nfi = si / 32, wci = warp * (si / 4);
  float2 lns[kRbMaxNF], lnb[kRbMaxNF], bb1[kRbMaxNF], bb2[kRbMaxNF];
  float2 xv[kRbMaxNF][2];
#pragma unroll
  for (int j = 0; j < kRbMaxNF; ++j) {
    const int cd = rank * sd + wcd + j * 8 + 2 * q4;
    const int ci = rank * si + wci + j * 8 + 2 * q4;
    if (j < nfd) {
      lns[j] = __ldg(reinterpret_cast<const float2*>(ln_s + cd));
      lnb[j] = __ldg(reinterpret_cast<const float2*>(ln_b + cd));
      bb2[j] = __ldg(reinterpret_cast<const float2*>(b2 + cd));
    }
    if (j < nfi) bb1[j] = __ldg(reinterpret_cast<const float2*>(b1 + ci));
  }
  ptx::grid_dep_wait();
  ptx::grid_dep_launch();
  const X* xb = x + (size_t)m0 * D + rank * sd + wcd;
#pragma unroll
  for (int j = 0; j < kRbMaxNF; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gr + 8 * h;
      xv[j][h] = j < nfd && r < rows
                     ? load2(xb + (size_t)r * D + j * 8 + 2 * q4, 0)
                     : make_float2(0.f, 0.f);
    }
  if (skip && *skip) {
    // a skipped step: x written through, every block its own columns
    ptx::cp_async_wait_all();
    X* ob = out + (size_t)m0 * D + rank * sd + wcd;
#pragma unroll
    for (int j = 0; j < kRbMaxNF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = gr + 8 * h;
        if (j < nfd && r < rows)
          store2(ob + (size_t)r * D + j * 8 + 2 * q4, 0, xv[j][h].x,
                 xv[j][h].y);
      }
    return;
  }

  // the band's rows of att (zeros past N)
  const int av = HD / 8;
  for (int e = tid; e < kRbM * av; e += kRbThreads) {
    const int r = e / av, c = (e % av) * 8;
    if (r < rows)
      ptx::cp_async16(As + r * L.ald + c, att + (size_t)(m0 + r) * HD + c);
    else
      *reinterpret_cast<uint4*>(As + r * L.ald + c) = make_uint4(0, 0, 0, 0);
  }
  ptx::cp_async_commit();
  ptx::cp_async_wait_all();
  __syncthreads();

  // x2 = x + att @ Wfc[:, this block's columns], kept in registers
  float x2[kRbMaxNF][4];
  int g = 0;
  rb_product(ring, issue, g, As, L.ald, n0, wcd, nfd, x2, lane);
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int j = 0; j < kRbMaxNF; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (j >= nfd) continue;
      x2[j][2 * h] = xv[j][h].x + x2[j][2 * h];
      x2[j][2 * h + 1] = xv[j][h].y + x2[j][2 * h + 1];
      (h ? hi : lo) += x2[j][2 * h] + x2[j][2 * h + 1];
    }

  // sums over the cluster of the band's rows: this thread's rows gr and
  // gr + 8, summed over the quad, the warps and then the cluster's blocks
  // in rank order into stat[pass][row]
  auto cluster_row_sums = [&](float a, float b, int pass) {
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    b += __shfl_xor_sync(0xffffffffu, b, 1);
    b += __shfl_xor_sync(0xffffffffu, b, 2);
    if (q4 == 0) {
      red[warp * kRbM + gr] = a;
      red[warp * kRbM + gr + 8] = b;
    }
    __syncthreads();
    float* pp = part + pass * kRbM;
    if (tid < kRbM)
      pp[tid] = red[tid] + red[kRbM + tid] + red[2 * kRbM + tid] +
                red[3 * kRbM + tid];
    cluster.sync();
    if (tid < kRbM) {
      float s = 0.f;
      for (int c = 0; c < CS; ++c) s += cluster.map_shared_rank(pp, c)[tid];
      stat[pass * kRbM + tid] = s;
    }
    __syncthreads();
  };
  cluster_row_sums(lo, hi, 0);
  const float mu[2] = {stat[gr] / (float)D, stat[gr + 8] / (float)D};
  lo = hi = 0.f;
#pragma unroll
  for (int j = 0; j < kRbMaxNF; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (j >= nfd) continue;
      const float a = x2[j][2 * h] - mu[h], b = x2[j][2 * h + 1] - mu[h];
      (h ? hi : lo) += a * a + b * b;
    }
  cluster_row_sums(lo, hi, 1);
  const float rstd[2] = {rsqrtf(stat[kRbM + gr] / (float)D + 1e-5f),
                         rsqrtf(stat[kRbM + gr + 8] / (float)D + 1e-5f)};
  // this block's columns of bf16(LN3(x2)) into A, then the cluster's
#pragma unroll
  for (int j = 0; j < kRbMaxNF; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (j >= nfd) continue;
      const int c = rank * sd + wcd + j * 8 + 2 * q4;
      store2(As + (gr + 8 * h) * L.ald + c, 0,
             (x2[j][2 * h] - mu[h]) * rstd[h] * lns[j].x + lnb[j].x,
             (x2[j][2 * h + 1] - mu[h]) * rstd[h] * lns[j].y + lnb[j].y);
    }
  // the other blocks' columns of a bf16 band (cols of width w from q w),
  // from their shared memory: eight 16-byte loads a thread in flight, then
  // their stores
  auto gather = [&](bf16* buf, int ld, int w) {
    const int vw = w / 8, n = CS * kRbM * vw;
    for (int e0 = 0; e0 < n; e0 += 8 * kRbThreads) {
      uint4 v[8];
      int off[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kRbThreads + tid;
        const int c = e / (kRbM * vw), rem = e % (kRbM * vw);
        off[u] = e < n && c != rank
                     ? (rem / vw) * ld + c * w + (rem % vw) * 8
                     : -1;
        if (off[u] >= 0)
          v[u] = *reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(buf, c) + off[u]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (off[u] >= 0) *reinterpret_cast<uint4*>(buf + off[u]) = v[u];
    }
  };
  cluster.sync();
  gather(As, L.ald, sd);
  __syncthreads();

  // h = GELU(y3 @ W1[:, this block's columns] + b1) into H, then the
  // cluster's
  float acc[kRbMaxNF][4];
  rb_product(ring, issue, g, As, L.ald, n1, wci, nfi, acc, lane);
#pragma unroll
  for (int j = 0; j < kRbMaxNF; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (j >= nfi) continue;
      const int c = rank * si + wci + j * 8 + 2 * q4;
      store2(Hs + (gr + 8 * h) * L.hld + c, 0,
             gelu_erf(acc[j][2 * h] + bb1[j].x),
             gelu_erf(acc[j][2 * h + 1] + bb1[j].y));
    }
  cluster.sync();
  gather(Hs, L.hld, si);
  cluster.sync();  // no block reads another's shared memory after this

  // x_out = x2 + (h @ W2[:, this block's columns] + b2)
  rb_product(ring, issue, g, Hs, L.hld, n2, wcd, nfd, acc, lane);
  X* ob = out + (size_t)m0 * D + rank * sd + wcd;
#pragma unroll
  for (int j = 0; j < kRbMaxNF; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gr + 8 * h;
      if (j >= nfd || r >= rows) continue;
      store2(ob + (size_t)r * D + j * 8 + 2 * q4, 0,
             x2[j][2 * h] + (acc[j][2 * h] + bb2[j].x),
             x2[j][2 * h + 1] + (acc[j][2 * h + 1] + bb2[j].y));
    }
}

// CS: the largest of 8, 4, 2, 1 that leaves each block 32, 64 or 128
// columns of fc and W2 and of W1 (0: none).
int ffn_cluster_size(int D, int DI) {
  auto fits = [](int w) { return w == 32 || w == 64 || w == 128; };
  for (int cs : {8, 4, 2, 1})
    if (D % cs == 0 && DI % cs == 0 && fits(D / cs) && fits(DI / cs))
      return cs;
  return 0;
}

// S: 8 ring slots if every cluster of the grid is resident at once with
// them (cudaOccupancyMaxActiveClusters), else 4.
template <typename X>
int launch_ffn(const X* x, const bf16* att, const bf16* wfc,
               const float* ln_s, const float* ln_b, const bf16* w1,
               const float* b1, const bf16* w2, const float* b2, X* out,
               int N, int D, int HD, int DI, const unsigned char* skip,
               cudaStream_t st) {
  const int cs = ffn_cluster_size(D, DI), bands = (N + kRbM - 1) / kRbM;
  const size_t smem8 = ffn_layout(D, HD, DI, cs, 8).bytes;
  TPK_TRY(allow_smem(ffn_cluster_kernel<X, 8>, smem8));
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, bands, cs);
  cfg.blockDim = kRbThreads;
  cfg.dynamicSmemBytes = smem8;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // the clusters resident at once, cached per (device, kernel, shared
  // memory, cluster size): the query is a host call; the cache is read and
  // written under a lock
  static long long key[16][4];
  static int val[16], n_cached = 0;
  static std::mutex mu;
  int dev = 0, fit = -1;
  cudaGetDevice(&dev);
  const long long k[4] = {dev, std::is_same<X, bf16>::value, (long long)smem8,
                          cs};
  std::unique_lock<std::mutex> hold(mu);
  for (int i = 0; i < n_cached && fit < 0; ++i)
    if (std::equal(k, k + 4, key[i])) fit = val[i];
  if (fit < 0) {
    if (cudaOccupancyMaxActiveClusters(&fit, ffn_cluster_kernel<X, 8>,
                                       &cfg) != cudaSuccess) {
      cudaGetLastError();
      fit = 0;
    }
    if (n_cached < 16) {
      std::copy(k, k + 4, key[n_cached]);
      val[n_cached++] = fit;
    }
  }
  hold.unlock();
  const int S = fit >= bands ? 8 : 4;
  const size_t smem = ffn_layout(D, HD, DI, cs, S).bytes;
  auto kernel = S == 8 ? ffn_cluster_kernel<X, 8> : ffn_cluster_kernel<X, 4>;
  TPK_TRY(allow_smem(kernel, smem));
  return launch_pdl(kernel, dim3(1, bands, cs), kRbThreads, smem, st, cs, x,
                    att, wfc, ln_s, ln_b, w1, b1, w2, b2, out, N, D, HD, DI,
                    skip);
}

template <typename X>
int self_attn_step(const X* x, X* ck, X* cv, const bf16* wqkv,
                   const bf16* wfc, const float* ln_s, const float* ln_b,
                   void* scratch, X* x_out, const unsigned char* skip, int N,
                   int D, int H, int T, int t, cudaStream_t st) {
  const int HD = H * kDk, sms = sm_count();
  float* qkv = reinterpret_cast<float*>(scratch);
  bf16* att = reinterpret_cast<bf16*>(qkv + (size_t)N * 3 * HD);
  TPK_TRY(launch_ln_product(x, ln_s, ln_b, wqkv, qkv, N, D, 3 * HD, sms, skip,
                            st));
  TPK_TRY((launch_attend<true, float, X, float>(
      nullptr, skip, qkv, 3 * HD, kQScale, ck, cv, (long long)H * T * kDk,
      (long long)T * kDk, kDk, t + 1, nullptr, 0, nullptr, nullptr, att,
      HD, N, H, qkv + HD, qkv + 2 * HD, 3 * HD, t, st)));
  const GemmPlan plan = step_gemm_plan(N, D, HD, sms);
  StepGemm p = {};
  p.A = att;
  p.B = wfc;
  p.C = x_out;
  p.res = x;
  p.skip = skip;
  p.lda = HD;
  p.ldb = D;
  p.ldc = D;
  p.ldr = D;
  p.M = N;
  p.N = D;
  p.K = HD;
  p.splits = plan.splits;
  p.res_bf16 = p.out_bf16 = std::is_same<X, bf16>::value;
  return launch_step_gemm(p, plan.bn, st);
}

template <typename X>
int cross_ffn_step(const X* x, const X* ek, const X* ev, const float* mask,
                   const bf16* wq, const bf16* wfc, const float* ln2_s,
                   const float* ln2_b, const bf16* w1, const float* b1,
                   const bf16* w2, const float* b2, const float* ln3_s,
                   const float* ln3_b, void* scratch, X* x_out,
                   const unsigned char* skip, int N, int D, int H, int TE,
                   int DI, cudaStream_t st) {
  const int HD = H * kDk;
  float* q32 = reinterpret_cast<float*>(scratch);
  bf16* att = reinterpret_cast<bf16*>(q32 + (size_t)N * HD);
  TPK_TRY(launch_ln_product(x, ln2_s, ln2_b, wq, q32, N, D, HD, sm_count(),
                            skip, st));
  // the encoder K/V are read only: no appended key
  TPK_TRY((launch_attend<true, float, X, X>(
      nullptr, skip, q32, HD, kQScale, const_cast<X*>(ek),
      const_cast<X*>(ev), (long long)H * TE * kDk, (long long)TE * kDk, kDk,
      TE, mask, TE, nullptr, nullptr, att, HD, N, H, nullptr, nullptr, 0, -1,
      st)));
  return launch_ffn(x, att, wfc, ln3_s, ln3_b, w1, b1, w2, b2, x_out, N, D,
                    HD, DI, skip, st);
}

// Whether every pointer is 16-byte aligned (the kernels copy 16 bytes at
// a time; PyTorch's allocations are).
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

}  // namespace

// The limits of both entry points, the only copy of them: d_k == 64 (the
// attention's head width), d_model and d_inner multiples of 64, d_model at
// most 512 (the x band of a LayerNorm + product block sits in shared
// memory), a cache of at most kShortKeys steps and at most kMaxKeys
// encoder keys (a warp's softmax weights sit in shared memory), every
// pointer 16-byte aligned. Outside them an entry point
// launches nothing and returns cudaErrorInvalidValue.
//
// skip (both entry points): null, or a device byte that says every row
// ended before this step. Where it is set, every block of the three
// launches returns after its wait on the kernel before, but for the last
// launch's, which write x through to x_out: x_out = x, the caches and the
// scratch untouched.
//
// Self-attention step. is_bf16 selects X: 1 = bf16, 0 = f32. x (N, D) X;
// ck/cv (N, H, T, DK) X, slot t written in place; wqkv (D, 3HD), wfc
// (HD, D) bf16; ln_s/ln_b (D) f32. Scratch: N * HD * 14 bytes (qkv (N, 3HD)
// f32, then att (N, HD) bf16). Output x_out (N, D) X.
extern "C" int tpk_self_attn_step(const void* x, void* ck, void* cv,
                                  const void* wqkv, const void* wfc,
                                  const float* ln_s, const float* ln_b,
                                  void* scratch, void* x_out,
                                  const unsigned char* skip, int N, int D,
                                  int H, int DK, int T, int t, int is_bf16,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (DK != kDk || D % 64 || D > kStepMaxD || t < 0 || t >= T ||
      t >= kShortKeys ||
      !aligned16({x, ck, cv, wqkv, wfc, ln_s, ln_b, scratch, x_out}))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (is_bf16)
    return self_attn_step((const bf16*)x, (bf16*)ck, (bf16*)cv,
                          (const bf16*)wqkv, (const bf16*)wfc, ln_s, ln_b,
                          scratch, (bf16*)x_out, skip, N, D, H, T, t, st);
  return self_attn_step((const float*)x, (float*)ck, (float*)cv,
                        (const bf16*)wqkv, (const bf16*)wfc, ln_s, ln_b,
                        scratch, (float*)x_out, skip, N, D, H, T, t, st);
}

// Cross-attention + FFN step. x (N, D) X; ek/ev (N, H, TE, DK) X; mask
// (N, TE) f32; wq (D, HD), wfc (HD, D), w1 (D, DI), w2 (DI, D) bf16; b1
// (DI), b2 (D), ln2_s/ln2_b/ln3_s/ln3_b (D) f32. Scratch: N * HD * 6 bytes
// (q (N, HD) f32, then att (N, HD) bf16). Output x_out (N, D) X.
extern "C" int tpk_cross_ffn_step(
    const void* x, const void* ek, const void* ev, const float* mask,
    const void* wq, const void* wfc, const float* ln2_s, const float* ln2_b,
    const void* w1, const float* b1, const void* w2, const float* b2,
    const float* ln3_s, const float* ln3_b, void* scratch, void* x_out,
    const unsigned char* skip, int N, int D, int H, int DK, int TE, int DI,
    int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (DK != kDk || D % 64 || D > kStepMaxD || DI % 64 || TE < 1 ||
      TE > kMaxKeys || !ffn_cluster_size(D, DI) ||
      !aligned16({x, ek, ev, wq, wfc, ln2_s, ln2_b, w1, b1, w2, b2, ln3_s,
                  ln3_b, scratch, x_out}))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (is_bf16)
    return cross_ffn_step(
        (const bf16*)x, (const bf16*)ek, (const bf16*)ev, mask,
        (const bf16*)wq, (const bf16*)wfc, ln2_s, ln2_b, (const bf16*)w1, b1,
        (const bf16*)w2, b2, ln3_s, ln3_b, scratch, (bf16*)x_out, skip, N, D,
        H, TE, DI, st);
  return cross_ffn_step(
      (const float*)x, (const float*)ek, (const float*)ev, mask,
      (const bf16*)wq, (const bf16*)wfc, ln2_s, ln2_b, (const bf16*)w1, b1,
      (const bf16*)w2, b2, ln3_s, ln3_b, scratch, (float*)x_out, skip, N, D,
      H, TE, DI, st);
}
