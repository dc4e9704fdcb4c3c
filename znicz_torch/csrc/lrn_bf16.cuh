// The bf16 operand variants of K3 and K3b (csrc/lrn.cu, csrc/lrn_bwd.cu)
// share this arithmetic.  Unlike K1, K1b, K2 and K2b, the TPU kernels they
// replace (znicz_tpu/ops/lrn_pallas.py _fwd_kernel :78, _bwd_kernel :86)
// compute in the operand dtype: every product, sum, quotient and power of
// a bf16 operand rounds to bf16, and the constants alpha, k, -beta and
// 2*alpha*beta come rounded to bf16 first (JAX's weak typing; the wrappers
// pass them so, ops/lrn.operand_constants).  So each operation here is a
// float32 operation on widened bf16 values, written __fmul_rn, __fadd_rn,
// __fdiv_rn or __fsub_rn so that nvcc contracts nothing into an FMA, and
// rounded to bf16 (__float2bfloat16_rn, round to nearest even) before the
// next one.  A float32 operation on two bf16 values, rounded to bf16, is
// the correctly rounded bf16 operation, which is how PyTorch computes a
// bf16 tensor's arithmetic on the card, and so the plain versions
// (ops/lrn.lrn_plain, lrn_bwd_plain) on bf16 tensors.
//
// W_n sums the taps lo .. lo+taps-1 in that order: the first alone, then
// each of the others added and rounded; a tap past a channel end adds +0,
// as the plain version's zero parts do (a skipped +0 would turn a -0
// partial sum of t into another signed zero of dx).
//
// Layout, simple: a block of kThreads threads takes r whole rows of the
// (rows, C) view, a contiguous run of r*C elements, copies them into shared
// memory as bf16 (every intermediate is a bf16 value, so nothing is lost)
// and walks the run one element a thread at a time, with a barrier between
// passes.  ops/lrn._bf16_plan chooses r and the shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace lrnbf16 {

constexpr int kThreads = 256;

__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// s^nb as torch.pow computes it on the card for a bf16 tensor and a
// scalar exponent: -0.5, -1 and -2 (beta 0.5, 1, 2) take its special
// cases (rsqrt, reciprocal, 1 / (s*s)), every other exponent powf.
__device__ __forceinline__ float pow_bf16(float s, float nb) {
  if (nb == -0.5f) return rb(rsqrtf(s));
  if (nb == -1.0f) return rb(__fdiv_rn(1.0f, s));
  if (nb == -2.0f) return rb(__fdiv_rn(1.0f, rb(__fmul_rn(s, s))));
  return rb(powf(s, nb));
}

// W_n at channel c of the C-value row `row` (shared memory).
__device__ __forceinline__ float window(const __nv_bfloat16* row, int c,
                                        int C, int lo, int taps) {
  float acc = 0.0f;
  for (int o = 0; o < taps; ++o) {
    const int cc = c + lo + o;
    const float v = (cc >= 0 && cc < C) ? ld(row + cc) : 0.0f;
    acc = o == 0 ? v : rb(__fadd_rn(acc, v));
  }
  return acc;
}

// sb = (k + alpha * acc)^nb, and s through `s`.
__device__ __forceinline__ float inv_pow_of(float acc, float alpha, float k,
                                            float nb, float& s) {
  s = rb(__fadd_rn(k, rb(__fmul_rn(alpha, acc))));
  return pow_bf16(s, nb);
}

// Checks shared by both entry points; the number of blocks, or -1 for a
// plan the kernels do not take.  `arrays` is the bf16 arrays of r*C values
// a block keeps in shared memory.
inline long long blocks_for(long long rows, int C, int lo, int taps, int r,
                            int smem, int arrays) {
  if (rows < 0 || C < 1 || taps < 1 || lo > 0 || r < 1 ||
      (long long)smem < 2LL * arrays * r * C)
    return -1;
  const long long blocks = (rows + r - 1) / r;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

// Allow `smem` bytes of dynamic shared memory for `fn` where that is more
// than 48 KB and the device allows it.
template <typename F>
inline cudaError_t allow_smem(F fn, int smem, int device) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  if (smem > optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace lrnbf16
