// K3 lrn_fwd: cross-channel local response normalisation over a float32
// (rows, C) view of an NHWC tensor:
//   s = k + alpha * W_n(x*x);  y = x * powf(s, -beta)
// with W_n the n-channel window summed over the offsets lo .. lo+taps-1
// (lo = -(n/2), taps = n) in that order, zero past the channel ends.
//
// Replaces: znicz_tpu/ops/lrn_pallas.py _fwd_kernel (:78), tiled by
// _pallas_2d (:97) and exposed as lrn (:165).  That kernel raises s to
// -beta with jnp.power, not with the rsqrt form the fused block kernel
// uses; this one keeps its own formulation (powf), and rounds every
// product and sum on its own (__fmul_rn/__fadd_rn), so nvcc contracts
// nothing into an FMA and y is bit-identical to lrn_plain's on the card.
//
// Bound on an H100 SXM: memory.  One read of x and one write of y, about
// n + 4 operations and one powf per element.  At AlexNet's conv1 output
// (B=128, 55x55x96) that is 297 MB, or 89 us at 3.35 TB/s.
//
// Design.  The Python planner (ops/lrn._fwd_plan) chooses everything
// below; the entry point takes its plan as given and checks it.
//  - A thread owns units of one pixel row, tpr apart: a unit is four
//    consecutive channels (the float4 path) or one (the scalar path:
//    C % 4 != 0 or an unaligned operand).  The planner gives a thread two
//    units where the row has them, which halves the threads, barriers and
//    per-group bookkeeping that a row costs.  `rows` pixel rows make a group, a
//    contiguous run of memory; a block walks a contiguous run of groups.
//    The mapping is fixed, so no thread divides per element.
//  - Loads overlap compute.  Each thread copies its own units of the next
//    stages-1 groups into a ring in shared memory with cp.async (16 bytes,
//    or 4 on the scalar path) while it computes the current group.  A
//    thread reads back only what it copied, so the ring needs no barrier.
//  - Each x is squared once.  A thread writes the squares of its units into
//    a row of squares padded with zeros on both sides as far as the window
//    reaches; after one barrier it sums each channel's window from that
//    row, with no bounds checks.  Adding a +0 pad to the non-negative sum
//    changes no bit, and the plain version adds its zeros too, so the sum
//    is the reference's in its order.  Rows of squares alternate between
//    two buffers, so one barrier a group suffices.  At n = 5 on the float4
//    path the taps are unrolled from three 16-byte reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lrn_bf16.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 2;

struct Plan {
  long long rows;              // pixel rows of the tensor
  long long groups;            // groups of `r` rows
  long long groups_per_block;
  int C, lo, taps;
  int tpr;                     // threads a row
  int r;                       // rows a group
  int stages;                  // ring slots of each thread
  int pad, stride;             // row of squares: zeros before it, its floats
  float alpha, beta, k;
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     saddr(dst)),
                 "l"((uint64_t)src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(saddr(dst)),
                 "l"((uint64_t)src)
                 : "memory");
  }
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

__device__ __forceinline__ float normalise(float x, float acc, const Plan& p) {
  const float s = __fadd_rn(p.k, __fmul_rn(p.alpha, acc));
  return __fmul_rn(x, powf(s, -p.beta));
}

// Copy this thread's units of group g (row `row` of it) into its ring slot.
template <int V>
__device__ __forceinline__ void load_group(const float* x, float* slot,
                                           long long row, int t,
                                           const Plan& p) {
  if (row < p.rows) {
    const float* src = x + row * p.C;
    for (int e = t * V; e < p.C; e += p.tpr * V) cp_async<V>(slot + e, src + e);
  }
  cp_async_commit();
}

// V: channels a unit (4 or 1).  N: the window when it is unrolled (5 on the
// float4 path), else 0 and the window runs over p.lo .. p.lo+p.taps-1.
template <int V, int N>
__global__ void __launch_bounds__(kMaxThreads)
lrn_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
               const Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int row_in_group = threadIdx.x / p.tpr;   // fixed for the block
  const int t = threadIdx.x - row_in_group * p.tpr;
  float* ring = smem + (size_t)row_in_group * p.C;
  const size_t slot_floats = (size_t)p.r * p.C;
  float* sq = smem + (size_t)p.stages * slot_floats +
              (size_t)row_in_group * p.stride;
  const size_t sq_buffer = (size_t)p.r * p.stride;
  // the pads of this row of squares, in both buffers; the data between
  // them is written every group, the pads never
  for (int e = t; e < p.stride - p.C; e += p.tpr) {
    const int at = e < p.pad ? e : p.C + e;
    sq[at] = 0.0f;
    sq[sq_buffer + at] = 0.0f;
  }
  const long long g0 = (long long)blockIdx.x * p.groups_per_block;
  long long g1 = g0 + p.groups_per_block;
  if (g1 > p.groups) g1 = p.groups;
  const int G = (int)(g1 - g0);                    // the same for the block
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < G) {
      load_group<V>(x, ring + s * slot_floats,
                    (g0 + s) * p.r + row_in_group, t, p);
    } else {
      cp_async_commit();
    }
  }
  int slot = 0;                                    // ring slot of group i
  int fill = p.stages - 1;                         // ring slot of i+stages-1
  for (int i = 0; i < G; ++i) {
    if (i + p.stages - 1 < G) {
      load_group<V>(x, ring + fill * slot_floats,
                    (g0 + i + p.stages - 1) * p.r + row_in_group, t, p);
    } else {
      cp_async_commit();
    }
    cp_async_wait(p.stages - 1);
    const long long row = (g0 + i) * p.r + row_in_group;
    const bool live = row < p.rows;
    const float* xs = ring + slot * slot_floats;
    float* sr = sq + (i & 1) * sq_buffer + p.pad;  // channel 0 of the row
    if (live) {
      for (int c = t * V; c < p.C; c += p.tpr * V) {
        if constexpr (V == 4) {
          const float4 v = *reinterpret_cast<const float4*>(xs + c);
          *reinterpret_cast<float4*>(sr + c) =
              make_float4(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y),
                          __fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w));
        } else {
          sr[c] = __fmul_rn(xs[c], xs[c]);
        }
      }
    }
    __syncthreads();
    if (live) {
      float* dst = y + row * p.C;
      for (int c = t * V; c < p.C; c += p.tpr * V) {
        if constexpr (V == 4) {
          float acc[4];
          if constexpr (N == 5) {
            // channels c-4 .. c+7; channel c+j sums w[2+j] .. w[6+j]
            const float4 a = *reinterpret_cast<const float4*>(sr + c - 4);
            const float4 b = *reinterpret_cast<const float4*>(sr + c);
            const float4 d = *reinterpret_cast<const float4*>(sr + c + 4);
            const float w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                                 b.z, b.w, d.x, d.y, d.z, d.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float s = 0.0f;
#pragma unroll
              for (int o = 0; o < 5; ++o) s = __fadd_rn(s, w[2 + j + o]);
              acc[j] = s;
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float* w = sr + c + j + p.lo;
              float s = 0.0f;
              for (int o = 0; o < p.taps; ++o) s = __fadd_rn(s, w[o]);
              acc[j] = s;
            }
          }
          const float4 v = *reinterpret_cast<const float4*>(xs + c);
          *reinterpret_cast<float4*>(dst + c) = make_float4(
              normalise(v.x, acc[0], p), normalise(v.y, acc[1], p),
              normalise(v.z, acc[2], p), normalise(v.w, acc[3], p));
        } else {
          const float* w = sr + c + p.lo;
          float s = 0.0f;
          for (int o = 0; o < p.taps; ++o) s = __fadd_rn(s, w[o]);
          dst[c] = normalise(xs[c], s, p);
        }
      }
    }
    slot = slot + 1 == p.stages ? 0 : slot + 1;
    fill = fill + 1 == p.stages ? 0 : fill + 1;
  }
}

}  // namespace

extern "C" const char* znicz_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// rows = elements / C.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan this file does not take: the caller
// (ops/lrn._fwd_plan) chooses vec (C % 4 == 0, x and y 16-byte aligned),
// tpr threads a row and r rows a group (tpr * r <= 256), stages (1..2),
// the groups of each block and the blocks, the row of squares (pad zeros
// before its C floats, stride floats in all, reaching the window and,
// on the float4 path, 16-byte aligned) and smem, the bytes of that layout.
extern "C" int znicz_lrn_fwd(const float* x, float* y, long long rows, int C,
                             int lo, int taps, float alpha, float beta,
                             float k, int vec, int tpr, int r, int stages,
                             long long groups_per_block, int blocks, int pad,
                             int stride, int smem, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int V = vec ? 4 : 1;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const int right = stride - pad - C;
  const long long groups = r > 0 ? (rows + r - 1) / r : 0;
  const long long need =
      4LL * ((long long)stages * r * C + 2LL * r * stride);
  if (C < 1 || taps < 1 || lo > 0 || tpr < 1 || r < 1 || tpr * r > kMaxThreads ||
      (long long)tpr * V > C + V - 1 || stages < 1 || stages > kMaxStages ||
      pad < -lo || right < lo + taps - 1 || smem < need ||
      groups_per_block < 1 || blocks < 0 ||
      (long long)blocks * groups_per_block < groups ||
      (vec && (C % 4 != 0 || !aligned || pad % 4 != 0 || stride % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  const bool unrolled = vec && taps == 5 && lo == -2 && pad >= 4 && right >= 4;
  void (*fn)(const float*, float*, const Plan) = lrn_fwd_kernel<1, 0>;
  if (unrolled) {
    fn = lrn_fwd_kernel<4, 5>;
  } else if (vec) {
    fn = lrn_fwd_kernel<4, 0>;
  }
  if (rows == 0) return 0;
  if (smem > 48 * 1024) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return (int)e;
    if (smem > optin) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Plan p{rows, groups, groups_per_block, C,   lo,    taps, tpr,
               r,    stages, pad,              stride, alpha, beta, k};
  fn<<<(unsigned)blocks, tpr * r, (size_t)smem, (cudaStream_t)stream>>>(x, y,
                                                                        p);
  return (int)cudaGetLastError();
}

// K3 for bf16 operands: y = x * (k + alpha * W_n(x*x))^nb in the operand
// dtype, every operation rounded to bf16 (csrc/lrn_bf16.cuh, which also
// says how a block walks its rows).  A simple kernel: one pass squares the
// block's rows into shared memory, a second sums each window from there.
// Its bound is memory: 2 bytes of x read and 2 of y written an element,
// 0.073 ms at AlexNet's conv1 and conv2 outputs (B=128) at 3.35 TB/s.

namespace {

__global__ void __launch_bounds__(lrnbf16::kThreads)
lrn_bf16_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                    __nv_bfloat16* __restrict__ y, long long rows, int C,
                    int lo, int taps, int r, float alpha, float k, float nb) {
  extern __shared__ __align__(16) unsigned char lrn_bf16_smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(lrn_bf16_smem);
  __nv_bfloat16* sq = xs + (size_t)r * C;
  const long long row0 = (long long)blockIdx.x * r;
  const long long left = rows - row0;
  const int n = (int)(left < r ? left : r) * C;
  const __nv_bfloat16* src = x + row0 * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const __nv_bfloat16 v = src[e];
    const float f = __bfloat162float(v);
    xs[e] = v;
    sq[e] = __float2bfloat16_rn(__fmul_rn(f, f));
  }
  __syncthreads();
  __nv_bfloat16* dst = y + row0 * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % C;
    float s;
    const float sb = lrnbf16::inv_pow_of(
        lrnbf16::window(sq + (e - c), c, C, lo, taps), alpha, k, nb, s);
    dst[e] = __float2bfloat16_rn(__fmul_rn(lrnbf16::ld(xs + e), sb));
  }
}

}  // namespace

// rows = elements / C; alpha, k and nb (= -beta) already rounded to bf16;
// r rows a block and smem bytes of shared memory (two bf16 arrays of r*C
// values), from ops/lrn._bf16_simple_plan.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a plan this kernel does
// not take.
extern "C" int znicz_lrn_bf16_fwd(const void* x, void* y, long long rows,
                                  int C, int lo, int taps, int r, float alpha,
                                  float k, float nb, int smem, int device,
                                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = lrnbf16::blocks_for(rows, C, lo, taps, r, smem, 2);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  e = lrnbf16::allow_smem(lrn_bf16_fwd_kernel, smem, device);
  if (e != cudaSuccess) return (int)e;
  lrn_bf16_fwd_kernel<<<(unsigned)blocks, lrnbf16::kThreads, (size_t)smem,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)y, rows, C, lo, taps, r, alpha,
      k, nb);
  return (int)cudaGetLastError();
}

// K3 for bf16 operands on K3's ring design (above), in 16-byte units of
// eight channels, with the simple kernel's arithmetic in packed bf16x2
// (csrc/lrn_bf16.cuh): y = x * (k + alpha * W_n(x*x))^nb, every operation
// rounded to bf16, so y has the simple kernel's and lrn_plain's bits.
//  - A thread squares its units once (mul.rn.bf16x2) into a row of bf16
//    squares padded with +0, keeping x in registers; after one barrier it
//    sums each pair of channels' window from that row, then s, sb = s^nb
//    (from the table of powers, csrc/lrn_bf16.cuh) and y.  Rows of
//    squares alternate between two buffers: one barrier a group.
//  - Each window starts from its first tap (for squares, +0 or -0 alike).
// Bound on an H100 SXM: memory, 2 bytes of x read and 2 of y written an
// element (0.073 ms at AlexNet's conv1 and conv2 outputs, B=128); about
// n + 4 bf16x2 operations and two table reads an element pair.

namespace lrnbf16 {   // its helpers' names, not the float32 kernels'

template <int N>
__global__ void __launch_bounds__(kThreads, kRingBlocksPerSm)
lrn_bf16_ring_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                         __nv_bfloat16* __restrict__ y,
                         const uint16_t* __restrict__ sbt, const RingPlan p) {
  extern __shared__ __align__(16) unsigned char lrn_bf16_smem[];
  uint16_t* base = reinterpret_cast<uint16_t*>(lrn_bf16_smem);
  const int row_in_group = threadIdx.x / p.tpr;   // fixed for the block
  const int t = threadIdx.x - row_in_group * p.tpr;
  const size_t slot_elems = (size_t)p.r * p.C;
  uint16_t* ring = base + (size_t)row_in_group * p.C;
  uint16_t* sq = base + (size_t)p.stages * slot_elems +
                 (size_t)row_in_group * p.stride;
  const size_t sq_buffer = (size_t)p.r * p.stride;
  zero_pads(sq, t, p);
  zero_pads(sq + sq_buffer, t, p);
  const long long g0 = (long long)blockIdx.x * p.groups_per_block;
  long long g1 = g0 + p.groups_per_block;
  if (g1 > p.groups) g1 = p.groups;
  const int G = (int)(g1 - g0);                    // the same for the block
  const int c0 = t * 8, step = p.tpr * 8;
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < G) {
      load_units<1>(x, nullptr, ring + s * slot_elems, 0,
                    (g0 + s) * p.r + row_in_group, c0, step, p);
    } else {
      cp_async_commit();
    }
  }
  int slot = 0;                                    // ring slot of group i
  int fill = p.stages - 1;                         // ring slot of i+stages-1
  for (int i = 0; i < G; ++i) {
    if (i + p.stages - 1 < G) {
      load_units<1>(x, nullptr, ring + fill * slot_elems, 0,
                    (g0 + i + p.stages - 1) * p.r + row_in_group, c0, step,
                    p);
    } else {
      cp_async_commit();
    }
    cp_async_wait(p.stages - 1);
    const long long row = (g0 + i) * p.r + row_in_group;
    const bool live = row < p.rows;
    const uint16_t* xs = ring + slot * slot_elems;
    uint16_t* sr = sq + (i & 1) * sq_buffer;       // the padded row
    uint32_t xw[kRingUnits][4];
    if (live) {
#pragma unroll
      for (int u = 0; u < kRingUnits; ++u) {
        const int c = c0 + u * step;
        if (c < p.C) {
          words(xw[u], ld16(xs + c));
          uint32_t q[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) q[m] = mul2(xw[u][m], xw[u][m]);
          st16(sr + p.pad + c, q);
        }
      }
    }
    __syncthreads();
    if (live) {
      __nv_bfloat16* dst = y + row * p.C;
      const uint32_t* w = reinterpret_cast<const uint32_t*>(sr);
#pragma unroll
      for (int u = 0; u < kRingUnits; ++u) {
        const int c = c0 + u * step;
        if (c < p.C) {
          uint32_t acc[4], out[4];
          window8<N>(acc, w, p.pad + c, p.lo, p.taps);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            uint32_t s;
            out[m] = mul2(xw[u][m], inv_pow2(acc[m], p, sbt, s));
          }
          st16(dst + c, out);
        }
      }
    }
    slot = slot + 1 == p.stages ? 0 : slot + 1;
    fill = fill + 1 == p.stages ? 0 : fill + 1;
  }
}

}  // namespace lrnbf16

// rows = elements / C; alpha and k already rounded to bf16; pow_table the
// 65536 bf16 powers s^nb from znicz_lrn_bf16_pow_table, nb = -beta
// rounded to bf16; the launch from ops/lrn._bf16_fwd_plan: tpr threads a
// row and r rows a group (tpr * r <= 256, at most two 8-channel units a
// thread), stages (1..2), the groups of each block and the blocks, the two
// buffers of padded rows of squares (pad zeros before their C values,
// stride values in all, 16-byte multiples reaching the window) and smem,
// the bytes of that layout.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a plan, operand or constant the kernel does
// not take (C % 8 != 0, an operand not 16-byte aligned).
extern "C" int znicz_lrn_bf16_ring_fwd(const void* x, void* y,
                                       const void* pow_table, long long rows,
                                       int C, int lo, int taps, float alpha,
                                       float k, int tpr, int r,
                                       int stages, long long groups_per_block,
                                       int blocks, int pad, int stride,
                                       int smem, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  lrnbf16::RingPlan p;
  if (!lrnbf16::ring_plan(p, rows, C, lo, taps, alpha, k, 0.0f, tpr, r,
                          stages, groups_per_block, blocks, pad, stride, smem,
                          1) ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0 ||
      pow_table == nullptr || (uintptr_t)pow_table % 2 != 0)
    return (int)cudaErrorInvalidValue;
  void (*fn)(const __nv_bfloat16*, __nv_bfloat16*, const uint16_t*,
             const lrnbf16::RingPlan) = lrnbf16::lrn_bf16_ring_fwd_kernel<0>;
  if (taps == 5 && lo == -2) fn = lrnbf16::lrn_bf16_ring_fwd_kernel<5>;
  if (rows == 0) return 0;
  e = lrnbf16::allow_smem(fn, smem, device);
  if (e != cudaSuccess) return (int)e;
  fn<<<(unsigned)blocks, tpr * r, (size_t)smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)y,
      (const uint16_t*)pow_table, p);
  return (int)cudaGetLastError();
}

// Fill pow_table (65536 bf16 values) with the power s^nb of every bf16 s,
// as pow_bf16 computes it: the table the bf16 ring kernels (K3 here, K3b
// in csrc/lrn_bwd.cu) read.  nb already rounded to bf16.
extern "C" int znicz_lrn_bf16_pow_table(void* pow_table, float nb, int device,
                                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (pow_table == nullptr || (uintptr_t)pow_table % 2 != 0)
    return (int)cudaErrorInvalidValue;
  lrnbf16::pow_table_kernel<<<256, 256, 0, (cudaStream_t)stream>>>(
      (uint16_t*)pow_table, nb);
  return (int)cudaGetLastError();
}
