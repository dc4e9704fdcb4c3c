// The bf16 operand variants of K3 and K3b (csrc/lrn.cu, csrc/lrn_bwd.cu)
// share this arithmetic.  Unlike K1, K1b, K2 and K2b, the TPU kernels they
// replace (znicz_tpu/ops/lrn_pallas.py _fwd_kernel :78, _bwd_kernel :86)
// compute in the operand dtype: every product, sum, quotient and power of
// a bf16 operand rounds to bf16, and the constants alpha, k, -beta and
// 2*alpha*beta come rounded to bf16 first (JAX's weak typing; the wrappers
// pass them so, ops/lrn.operand_constants).  A float32 operation on two
// bf16 values, rounded to bf16 (round to nearest even), is the correctly
// rounded bf16 operation: the exact product of two bf16 values fits a
// float32, and float32's 24 bits (>= 2*8+2) make the double rounding of a
// sum, difference or quotient innocuous.  That is how PyTorch computes a
// bf16 tensor's arithmetic on the card, and so the plain versions
// (ops/lrn.lrn_plain, lrn_bwd_plain) on bf16 tensors.
//
// W_n sums the taps lo .. lo+taps-1 in that order: the first alone, then
// each of the others added and rounded; a tap past a channel end adds +0,
// as the plain version's zero parts do (a skipped +0 would turn a -0
// partial sum of t into another signed zero of dx).
//
// Two designs.  The simple kernels take every shape: a block of
// kThreads threads copies r whole rows of the (rows, C) view into shared
// memory and walks them one element a thread at a time, each operation a
// float32 one written __fmul_rn, __fadd_rn, __fdiv_rn or __fsub_rn (so
// that nvcc contracts nothing into an FMA) and rounded to bf16 before the
// next (ops/lrn._bf16_simple_plan chooses r).  The ring kernels run the
// float32 K3's and K3b's design on 16-byte units of eight bf16 channels
// (ops/lrn._bf16_fwd_plan and _bf16_bwd_plan choose their launch, or None
// and the simple kernels run: C % 8 != 0, an operand not 16-byte aligned,
// a row wider than kRingUnits units a thread).  Their arithmetic is
// packed bf16x2, mul/add/sub.rn.bf16x2, two lanes each rounded once,
// which gives the bits of the float32 operation rounded to bf16 (above)
// for two elements an instruction.  The explicit .rn matters: the
// unsuffixed forms behind __hmul2 and __hadd2 may be contracted into
// fma.rn.bf16x2, which rounds a*b+c once where the reference rounds
// twice.  Quotients are float32 operations on the widened lanes, rounded
// to bf16 by one cvt.  Powers are read from a table of s^nb over every
// bf16 s (65536 values, 128 KB, read through L1), filled by pow_bf16
// itself (pow_table_kernel): the same bits by construction, one load for
// powf's chain of branches and polynomials, which set the pace of the
// ring kernels with powf (PERF.md) as it does the float32 K3's and K3b's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace lrnbf16 {

constexpr int kThreads = 256;

__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// s^nb as torch.pow computes it on the card for a bf16 tensor and a
// scalar exponent, before its rounding to bf16: -0.5, -1 and -2 (beta 0.5,
// 1, 2) take its special cases (rsqrt, reciprocal, 1 / (s*s) with s*s
// rounded), every other exponent powf.
__device__ __forceinline__ float pow_f(float s, float nb) {
  if (nb == -0.5f) return rsqrtf(s);
  if (nb == -1.0f) return __fdiv_rn(1.0f, s);
  if (nb == -2.0f) return __fdiv_rn(1.0f, rb(__fmul_rn(s, s)));
  return powf(s, nb);
}

__device__ __forceinline__ float pow_bf16(float s, float nb) {
  return rb(pow_f(s, nb));
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

// ---- the ring kernels ---------------------------------------------------
//
// A unit is eight channels, 16 bytes, held as four 32-bit words of two
// bf16 lanes (the lower channel in the low half).  A thread owns the units
// of one pixel row at t, t+tpr (at most kRingUnits), `r` rows make a
// group, a contiguous run of memory, and a block walks a contiguous run of
// groups; each thread copies its own units of the next stages-1 groups
// into a ring in shared memory with 16-byte cp.async while it computes the
// current group, and reads back only what it copied, so the ring needs no
// barrier.  Squares (and in K3b t) go into rows padded with +0 as far as
// the window reaches, to 16 bytes: every intermediate is a bf16 value, so
// a bf16 row loses nothing.

constexpr int kRingUnits = 2;        // most units a thread takes of a row
constexpr int kRingStages = 2;       // most groups in a thread's ring
constexpr int kRingBlocksPerSm = 4;  // __launch_bounds__' resident blocks

struct RingPlan {
  long long rows;              // pixel rows of the tensor
  long long groups;            // groups of `r` rows
  long long groups_per_block;
  int C, lo, taps;
  int tpr;                     // threads a row
  int r;                       // rows a group
  int stages;                  // ring slots of each thread
  int pad, stride;             // padded rows: zeros before them, elements
  uint32_t alpha, k, c2;       // the constants, both lanes
};

// Both lanes of the bf16 value v (a float that is one: the wrappers round
// the constants first), or false for a float that is not.
inline bool lanes_of(float v, uint32_t& pair) {
  uint32_t u;
  memcpy(&u, &v, 4);
  if ((u & 0xffffu) != 0) return false;
  pair = (u >> 16) | (u & 0xffff0000u);
  return true;
}

// Checks shared by both ring entry points; false for a plan the kernels do
// not take.  `arrays` is the operands a ring slot holds (x; x and dy): the
// layout is `stages` slots of arrays * r * C elements, then two padded
// rows of `stride` elements for each row of a group (K3's two buffers of
// squares; K3b's squares and t).
inline bool ring_plan(RingPlan& p, long long rows, int C, int lo, int taps,
                      float alpha, float k, float c2, int tpr,
                      int r, int stages, long long groups_per_block,
                      int blocks, int pad, int stride, int smem,
                      int arrays) {
  const int units = C / 8;
  const long long need =
      2LL * ((long long)arrays * stages * r * C + 2LL * r * stride);
  if (rows < 0 || C < 8 || C % 8 != 0 || taps < 1 || lo > 0 || tpr < 1 ||
      r < 1 || tpr * r > kThreads || tpr > units ||
      (units + tpr - 1) / tpr > kRingUnits || stages < 1 ||
      stages > kRingStages || pad < -lo || pad % 8 != 0 || stride % 8 != 0 ||
      stride - pad - C < lo + taps - 1 || smem < need ||
      groups_per_block < 1 || blocks < 0)
    return false;
  const long long groups = (rows + r - 1) / r;
  if ((long long)blocks * groups_per_block < groups) return false;
  p.rows = rows;
  p.groups = groups;
  p.groups_per_block = groups_per_block;
  p.C = C;
  p.lo = lo;
  p.taps = taps;
  p.tpr = tpr;
  p.r = r;
  p.stages = stages;
  p.pad = pad;
  p.stride = stride;
  return lanes_of(alpha, p.alpha) && lanes_of(k, p.k) && lanes_of(c2, p.c2);
}

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float lo_of(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_of(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Two floats rounded to bf16 (nearest even) by one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The lanes at channels e, e+1 of a padded row of words: the high lane of
// one word and the low lane of the next where e is odd.
__device__ __forceinline__ uint32_t pair_at(const uint32_t* w, int e) {
  const int q = e >> 1;
  return (e & 1) ? __byte_perm(w[q], w[q + 1], 0x5432) : w[q];
}

// acc[m] = W_n of channels c+2m, c+2m+1 (m < 4), from the padded row of
// words `w` whose element e0 is channel c: taps lo .. lo+taps-1 in order,
// from the first.  N = 5 (lo = -2): channels c-2 .. c+9 from one 16-byte
// and two 4-byte reads; words v[j] hold channels c-2+2j, c-1+2j, and
// the odd taps are their neighbours' halves.  N = 0: any window, each tap
// read as a pair.
template <int N>
__device__ __forceinline__ void window8(uint32_t (&acc)[4], const uint32_t* w,
                                        int e0, int lo, int taps) {
  if constexpr (N == 5) {
    const int q = e0 >> 1;
    const uint4 b = *reinterpret_cast<const uint4*>(w + q);
    const uint32_t v[6] = {w[q - 1], b.x, b.y, b.z, b.w, w[q + 4]};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t s = v[m];                                     // tap -2
      s = add2(s, __byte_perm(v[m], v[m + 1], 0x5432));      // -1
      s = add2(s, v[m + 1]);                                 // 0
      s = add2(s, __byte_perm(v[m + 1], v[m + 2], 0x5432));  // +1
      acc[m] = add2(s, v[m + 2]);                            // +2
    }
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = e0 + 2 * m + lo;
      uint32_t s = pair_at(w, e);
      for (int o = 1; o < taps; ++o) s = add2(s, pair_at(w, e + o));
      acc[m] = s;
    }
  }
}

// sb = (k + alpha * acc)^nb of both lanes, read from the table `sbt` of
// every bf16 s's power (pow_table_kernel), and s through `s`.
__device__ __forceinline__ uint32_t inv_pow2(uint32_t acc, const RingPlan& p,
                                             const uint16_t* __restrict__ sbt,
                                             uint32_t& s) {
  s = add2(p.k, mul2(p.alpha, acc));
  return (uint32_t)__ldg(sbt + (s & 0xffffu)) |
         ((uint32_t)__ldg(sbt + (s >> 16)) << 16);
}

// The ring kernels' table of powers: sbt[i] = pow_bf16(s, nb) for the
// bf16 value s whose bits are i, every one of the 65536.
__global__ void pow_table_kernel(uint16_t* __restrict__ sbt, float nb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 65536) {
    const __nv_bfloat16 v =
        __float2bfloat16_rn(pow_f(__uint_as_float((uint32_t)i << 16), nb));
    sbt[i] = *reinterpret_cast<const uint16_t*>(&v);
  }
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(saddr(dst)),
               "l"((uint64_t)src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` (0 or 1) of this thread's cp.async groups
// are open.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 0) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  }
}

// Zero the pads of the padded row `row` (stride elements, the channels at
// pad .. pad+C-1), shared by the tpr threads of a row (t of them).
__device__ __forceinline__ void zero_pads(uint16_t* row, int t,
                                          const RingPlan& p) {
  for (int e = t; e < p.stride - p.C; e += p.tpr)
    row[e < p.pad ? e : p.C + e] = 0;
}

// Copy this thread's units of row `row` into its ring slot: x's at `slot`,
// with A == 2 dy's `at` elements further.
template <int A>
__device__ __forceinline__ void load_units(const __nv_bfloat16* x,
                                           const __nv_bfloat16* dy,
                                           uint16_t* slot, size_t at,
                                           long long row, int c0, int step,
                                           const RingPlan& p) {
  if (row < p.rows) {
    const long long off = row * p.C;
    for (int c = c0; c < p.C; c += step) {
      cp_async16(slot + c, x + off + c);
      if constexpr (A == 2) cp_async16(slot + at + c, dy + off + c);
    }
  }
  cp_async_commit();
}

// 16 bytes of a row of bf16 (shared or global memory) as four words.
__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st16(void* p, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void words(uint32_t (&w)[4], uint4 v) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

}  // namespace lrnbf16
