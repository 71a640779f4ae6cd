// The large-M tensor-core GEMM of gemm.cu, shared by the encoder
// (encoder.cu) and the whole decode's encoder K/V projection
// (full_decode.cu).
#pragma once

#include "common.cuh"

// What follows the product of one output row v (f32, N values), in order:
// v += bias; v = GELU(v) (erf); v = residual + v; store v to c (bf16 or
// f32); with ln_out, y = LN(v) (f32 statistics, eps, no affine unless ln_s
// and ln_b are given: y * ln_s + ln_b), stored to ln_out in bf16.
struct GemmEpilogue {
  void* c;                 // (M, N) of row stride ldc, or null with ln_out
  int ldc;
  int out_bf16;            // c in bf16, else f32
  const float* bias;       // (N) or null
  int gelu;
  const float* residual;   // (M, N) f32 of row stride ldr, or null; may
  int ldr;                 // alias an f32 c (read, then written in place)
  bf16* ln_out;            // (M, N) of row stride ld_ln, or null; needs
  int ld_ln;               // N == kGemmLnWidth and an f32 v
  const float* ln_s;       // (N) or null
  const float* ln_b;       // (N) or null
  float ln_eps;
};

// The row width for which the epilogue can take the LayerNorm.
constexpr int kGemmLnWidth = 512;

// C = epilogue(A[M, K] @ B[K, N]): A bf16 rows of stride lda (K
// contiguous), B the (K, N) bf16 weights of row stride ldb, f32
// accumulation. Needs K % 64 == 0, N % 256 == 0, strides % 8 == 0 and
// 16-byte aligned pointers; returns cudaErrorInvalidValue otherwise.
// Allocates nothing and never waits on the host, so a CUDA graph may
// capture it.
int gemm_tc(const bf16* A, int lda, const bf16* B, int ldb, int M, int N,
            int K, const GemmEpilogue& ep, cudaStream_t stream);
