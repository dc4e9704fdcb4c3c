// K3b lrn_bwd: the backward of the cross-channel LRN over a float32
// (rows, C) view of an NHWC tensor, from the forward's input x and the
// output cotangent dy:
//   s  = k + alpha * W_n(x*x);  sb = powf(s, -beta)
//   t  = ((dy * x) * sb) / s
//   dx = dy * sb - (c2 * x) * W_n(t),   c2 = 2 * alpha * beta
// with W_n the n-channel window summed over the offsets lo .. lo+taps-1
// (lo = -(n/2), taps = n, from ops/lrn.window_offsets) in that order, zero
// past the channel ends.
//
// Replaces: znicz_tpu/ops/lrn_pallas.py _bwd_kernel (:86), tiled by
// _pallas_2d (:97) under lrn's custom vjp (:149-156).  Same association
// of every product and quotient; each is rounded on its own
// (__fmul_rn/__fdiv_rn/__fadd_rn/__fsub_rn), so nvcc does not contract
// them into FMAs the reference does not do.  Each window sum starts from
// its first tap, as lrn_bwd_plain's does, not from +0: a window of -0s
// sums to -0, and dx keeps the plain version's signed zeros.
//
// Bound on an H100 SXM: memory.  Reads x and dy once, writes dx once;
// about 2n + 12 operations, one powf and one division per element.  At
// AlexNet's conv1 (B=128, 55x55x96) that is 446 MB, or 133 us at
// 3.35 TB/s.  It runs at about half that bound (PERF.md): each powf and
// each IEEE division is a chain of special-case branches of its own, so a
// thread's elements do not interleave, and the pace is that of those
// chains.  A third ring slot, a fifth block an SM, a strided walk of the
// groups and streaming stores did not move it; at beta = 0.75 (AlexNet's)
// the exponent is a constant of the code, so that nvcc folds powf's
// branches on it: the same powf, the same bits, fewer instructions.
//
// Design: K3's (csrc/lrn.cu).  The Python planner (ops/lrn._bwd_plan)
// chooses everything below; the entry point takes its plan as given and
// checks it.
//  - A thread owns units of one pixel row, tpr apart: a unit is four
//    consecutive channels (the float4 path) or one (the scalar path:
//    C % 4 != 0 or an unaligned operand), two a thread where the row has
//    them.  `r` pixel rows make a group, a contiguous run of memory; a
//    block walks a contiguous run of groups.  The mapping is fixed, so no
//    thread divides per element.
//  - Loads overlap compute.  Each thread copies its own units of x and dy
//    of the next stages-1 groups into a ring in shared memory with
//    cp.async (16 bytes, or 4 on the scalar path) while it computes the
//    current group.  A thread reads back only what it copied, so the
//    ring needs no barrier.
//  - Pass 1: each x is squared once into a row of squares padded with
//    zeros as far as the window reaches; after a barrier each channel's
//    window is summed from that row with no bounds checks (at n = 5 on
//    the float4 path, unrolled from three 16-byte reads), then s, sb and
//    t; t goes into a second padded row.  Pass 2, after a second barrier,
//    sums the t windows the same way and writes dx.  The +0 pads are
//    exact: the plain version adds a +0 for every tap past a channel end.
//  - One row of squares and one of t suffice: the barrier after t is
//    written orders every read of the squares before the next group's
//    squares, and the barrier after the squares orders every read of t
//    before the next group's t.  So each pass costs one barrier a group.
//  - A thread with at most kRegUnits units keeps x and dy * sb in
//    registers across the barriers; with more (rows past 512 units) it
//    writes dy * sb over its own dy in the ring and reads both back.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lrn_bf16.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 2;
constexpr int kRegUnits = 2;

struct Plan {
  long long rows;              // pixel rows of the tensor
  long long groups;            // groups of `r` rows
  long long groups_per_block;
  int C, lo, taps;
  int tpr;                     // threads a row
  int r;                       // rows a group
  int stages;                  // ring slots of each thread
  int pad, stride;             // rows of squares and of t: zeros before, floats
  float alpha, beta, k, c2;
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

template <int V>
__device__ __forceinline__ void load(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// acc[j] = W_n of channel c+j, `w` pointing at channel c of a padded row:
// taps lo .. lo+taps-1 added in order, starting from the first.
template <int V, int N>
__device__ __forceinline__ void window(float (&acc)[V], const float* w,
                                       const Plan& p) {
  if constexpr (N == 5) {
    // V == 4: channels c-4 .. c+7; channel c+j sums q[2+j] .. q[6+j]
    const float4 a = *reinterpret_cast<const float4*>(w - 4);
    const float4 b = *reinterpret_cast<const float4*>(w);
    const float4 d = *reinterpret_cast<const float4*>(w + 4);
    const float q[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, d.x, d.y, d.z, d.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = q[2 + j];
#pragma unroll
      for (int o = 1; o < 5; ++o) s = __fadd_rn(s, q[2 + j + o]);
      acc[j] = s;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float* tap = w + j + p.lo;
      float s = tap[0];
      for (int o = 1; o < p.taps; ++o) s = __fadd_rn(s, tap[o]);
      acc[j] = s;
    }
  }
}

// Copy this thread's units of x and dy of row `row` into its ring slot
// (x at `slot`, dy `dy_at` floats further).
template <int V>
__device__ __forceinline__ void load_group(const float* x, const float* dy,
                                           float* slot, size_t dy_at,
                                           long long row, int c0, int step,
                                           const Plan& p) {
  if (row < p.rows) {
    const long long at = row * p.C;
    for (int c = c0; c < p.C; c += step) {
      cp_async<V>(slot + c, x + at + c);
      cp_async<V>(slot + dy_at + c, dy + at + c);
    }
  }
  cp_async_commit();
}

// V: channels a unit (4 or 1).  N: the window when it is unrolled (5 on the
// float4 path), else 0 and the window runs over p.lo .. p.lo+p.taps-1.
// U: units a thread keeps in registers (kRegUnits), or 0 to keep them in
// the ring.  B: beta is the constant 0.75 (the unrolled register path
// only).
template <int V, int N, int U, bool B>
__global__ void __launch_bounds__(kMaxThreads)
lrn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
               float* __restrict__ dx, const Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int row_in_group = threadIdx.x / p.tpr;   // fixed for the block
  const int t = threadIdx.x - row_in_group * p.tpr;
  const size_t rows_floats = (size_t)p.r * p.C;   // a slot's x, then its dy
  float* ring = smem + (size_t)row_in_group * p.C;
  float* sq = smem + 2 * (size_t)p.stages * rows_floats +
              (size_t)row_in_group * p.stride;
  float* tw = sq + (size_t)p.r * p.stride;
  // the pads of this row of squares and of t; the data between them is
  // written every group, the pads never
  for (int e = t; e < p.stride - p.C; e += p.tpr) {
    const int at = e < p.pad ? e : p.C + e;
    sq[at] = 0.0f;
    tw[at] = 0.0f;
  }
  float* sr = sq + p.pad;                          // channel 0 of each row
  float* tr = tw + p.pad;
  const long long g0 = (long long)blockIdx.x * p.groups_per_block;
  long long g1 = g0 + p.groups_per_block;
  if (g1 > p.groups) g1 = p.groups;
  const int G = (int)(g1 - g0);                    // the same for the block
  const int c0 = t * V, step = p.tpr * V;
  // units of this thread: U where the plan gives it at most U, else all
  const int nu = U > 0 ? U : (p.C - c0 + step - 1) / step;
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < G) {
      load_group<V>(x, dy, ring + 2 * s * rows_floats, rows_floats,
                    (g0 + s) * p.r + row_in_group, c0, step, p);
    } else {
      cp_async_commit();
    }
  }
  int slot = 0;                                    // ring slot of group i
  int fill = p.stages - 1;                         // ring slot of i+stages-1
  float xr[U > 0 ? U : 1][V];                      // x of each unit
  float gr[U > 0 ? U : 1][V];                      // dy * sb of each unit
  for (int i = 0; i < G; ++i) {
    if (i + p.stages - 1 < G) {
      load_group<V>(x, dy, ring + 2 * fill * rows_floats, rows_floats,
                    (g0 + i + p.stages - 1) * p.r + row_in_group, c0, step,
                    p);
    } else {
      cp_async_commit();
    }
    cp_async_wait(p.stages - 1);
    const long long row = (g0 + i) * p.r + row_in_group;
    const bool live = row < p.rows;
    float* xs = ring + 2 * slot * rows_floats;
    float* ds = xs + rows_floats;
    if (live) {
#pragma unroll
      for (int u = 0; u < nu; ++u) {
        const int c = c0 + u * step;
        if (c < p.C) {
          float v[V], q[V];
          load<V>(v, xs + c);
#pragma unroll
          for (int j = 0; j < V; ++j) q[j] = __fmul_rn(v[j], v[j]);
          store<V>(sr + c, q);
          if constexpr (U > 0) {
#pragma unroll
            for (int j = 0; j < V; ++j) xr[u][j] = v[j];
          }
        }
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int u = 0; u < nu; ++u) {
        const int c = c0 + u * step;
        if (c < p.C) {
          float acc[V], v[V], d[V], tv[V], g[V];
          window<V, N>(acc, sr + c, p);
          if constexpr (U > 0) {
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = xr[u][j];
          } else {
            load<V>(v, xs + c);
          }
          load<V>(d, ds + c);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float s = __fadd_rn(p.k, __fmul_rn(p.alpha, acc[j]));
            const float sb = powf(s, B ? -0.75f : -p.beta);
            tv[j] = __fdiv_rn(__fmul_rn(__fmul_rn(d[j], v[j]), sb), s);
            g[j] = __fmul_rn(d[j], sb);
          }
          store<V>(tr + c, tv);
          if constexpr (U > 0) {
#pragma unroll
            for (int j = 0; j < V; ++j) gr[u][j] = g[j];
          } else {
            store<V>(ds + c, g);                   // over this thread's dy
          }
        }
      }
    }
    __syncthreads();
    if (live) {
      float* dst = dx + row * p.C;
#pragma unroll
      for (int u = 0; u < nu; ++u) {
        const int c = c0 + u * step;
        if (c < p.C) {
          float acc[V], v[V], g[V], out[V];
          window<V, N>(acc, tr + c, p);
          if constexpr (U > 0) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              v[j] = xr[u][j];
              g[j] = gr[u][j];
            }
          } else {
            load<V>(v, xs + c);
            load<V>(g, ds + c);
          }
#pragma unroll
          for (int j = 0; j < V; ++j)
            out[j] = __fsub_rn(g[j], __fmul_rn(__fmul_rn(p.c2, v[j]), acc[j]));
          store<V>(dst + c, out);
        }
      }
    }
    slot = slot + 1 == p.stages ? 0 : slot + 1;
    fill = fill + 1 == p.stages ? 0 : fill + 1;
  }
}

using Kernel = void (*)(const float*, const float*, float*, const Plan);

template <int U>
Kernel pick(bool vec, bool unrolled, bool beta_075) {
  if constexpr (U > 0) {
    if (unrolled && beta_075) return lrn_bwd_kernel<4, 5, U, true>;
  }
  if (unrolled) return lrn_bwd_kernel<4, 5, U, false>;
  return vec ? lrn_bwd_kernel<4, 0, U, false>
             : lrn_bwd_kernel<1, 0, U, false>;
}

}  // namespace

extern "C" const char* znicz_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// rows = elements / C.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan this file does not take: the caller
// (ops/lrn._bwd_plan) chooses vec (C % 4 == 0, x, dy and dx 16-byte
// aligned), tpr threads a row and r rows a group (tpr * r <= 256), stages
// (1..2), the groups of each block and the blocks, the rows of squares
// and of t (pad zeros before their C floats, stride floats in all,
// reaching the window and, on the float4 path, 16-byte aligned) and
// smem, the bytes of that layout (ops/lrn._bwd_smem).
extern "C" int znicz_lrn_bwd(const float* x, const float* dy, float* dx,
                             long long rows, int C, int lo, int taps,
                             float alpha, float beta, float k, float c2,
                             int vec, int tpr, int r, int stages,
                             long long groups_per_block, int blocks, int pad,
                             int stride, int smem, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int V = vec ? 4 : 1;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)dy % 16 == 0) &&
                       ((uintptr_t)dx % 16 == 0);
  const int right = stride - pad - C;
  const long long groups = r > 0 ? (rows + r - 1) / r : 0;
  const long long need =
      4LL * (2LL * stages * r * C + 2LL * r * stride);
  if (C < 1 || taps < 1 || lo > 0 || tpr < 1 || r < 1 ||
      tpr * r > kMaxThreads || (long long)tpr * V > C + V - 1 || stages < 1 ||
      stages > kMaxStages || pad < -lo || right < lo + taps - 1 ||
      smem < need || groups_per_block < 1 || blocks < 0 ||
      (long long)blocks * groups_per_block < groups ||
      (vec && (C % 4 != 0 || !aligned || pad % 4 != 0 || stride % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  const bool unrolled = vec && taps == 5 && lo == -2 && pad >= 4 && right >= 4;
  const bool b075 = beta == 0.75f;
  const Kernel fn = (C / V + tpr - 1) / tpr <= kRegUnits
                        ? pick<kRegUnits>(vec, unrolled, b075)
                        : pick<0>(vec, unrolled, b075);
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
  const Plan p{rows, groups, groups_per_block, C,   lo,     taps,  tpr, r,
               stages, pad,  stride,          alpha, beta, k,    c2};
  fn<<<(unsigned)blocks, tpr * r, (size_t)smem, (cudaStream_t)stream>>>(
      x, dy, dx, p);
  return (int)cudaGetLastError();
}

// K3b for bf16 operands, in the operand dtype, every operation rounded to
// bf16 (csrc/lrn_bf16.cuh, which also says how a block walks its rows):
//   s = k + alpha * W_n(x*x);  sb = s^nb;  t = ((dy * x) * sb) / s
//   dx = dy * sb - (c2 * x) * W_n(t)
// with nb = -beta and c2 = 2*alpha*beta rounded to bf16.  A simple kernel
// in three passes over the block's rows in shared memory: x, dy and x*x;
// s, sb and t; dx.  Its bound is memory: 2 bytes of x and of dy read and 2
// of dx written an element, 0.109 ms at AlexNet's conv1 and conv2 outputs
// (B=128) at 3.35 TB/s.

namespace {

__global__ void __launch_bounds__(lrnbf16::kThreads)
lrn_bf16_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ dy,
                    __nv_bfloat16* __restrict__ dx, long long rows, int C,
                    int lo, int taps, int r, float alpha, float k, float nb,
                    float c2) {
  extern __shared__ __align__(16) unsigned char lrn_bf16_smem[];
  const size_t tile = (size_t)r * C;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(lrn_bf16_smem);
  __nv_bfloat16* gs = xs + tile;        // dy
  __nv_bfloat16* sq = gs + tile;        // x*x
  __nv_bfloat16* ts = sq + tile;        // t
  __nv_bfloat16* sbs = ts + tile;       // sb
  const long long row0 = (long long)blockIdx.x * r;
  const long long left = rows - row0;
  const int n = (int)(left < r ? left : r) * C;
  const __nv_bfloat16* xsrc = x + row0 * C;
  const __nv_bfloat16* gsrc = dy + row0 * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const __nv_bfloat16 v = xsrc[e];
    const float f = __bfloat162float(v);
    xs[e] = v;
    gs[e] = gsrc[e];
    sq[e] = __float2bfloat16_rn(__fmul_rn(f, f));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % C;
    float s;
    const float sb = lrnbf16::inv_pow_of(
        lrnbf16::window(sq + (e - c), c, C, lo, taps), alpha, k, nb, s);
    const float g = lrnbf16::ld(gs + e), v = lrnbf16::ld(xs + e);
    const float t = __fdiv_rn(
        lrnbf16::rb(__fmul_rn(lrnbf16::rb(__fmul_rn(g, v)), sb)), s);
    ts[e] = __float2bfloat16_rn(t);
    sbs[e] = __float2bfloat16_rn(sb);
  }
  __syncthreads();
  __nv_bfloat16* dst = dx + row0 * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % C;
    const float wt = lrnbf16::window(ts + (e - c), c, C, lo, taps);
    const float g = lrnbf16::ld(gs + e), v = lrnbf16::ld(xs + e);
    const float a = lrnbf16::rb(__fmul_rn(g, lrnbf16::ld(sbs + e)));
    const float b = lrnbf16::rb(__fmul_rn(lrnbf16::rb(__fmul_rn(c2, v)), wt));
    dst[e] = __float2bfloat16_rn(__fsub_rn(a, b));
  }
}

}  // namespace

// rows = elements / C; alpha, k, nb (= -beta) and c2 (= 2*alpha*beta)
// already rounded to bf16; r rows a block and smem bytes of shared memory
// (five bf16 arrays of r*C values), from ops/lrn._bf16_simple_plan.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a plan this kernel does not take.
extern "C" int znicz_lrn_bf16_bwd(const void* x, const void* dy, void* dx,
                                  long long rows, int C, int lo, int taps,
                                  int r, float alpha, float k, float nb,
                                  float c2, int smem, int device,
                                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = lrnbf16::blocks_for(rows, C, lo, taps, r, smem, 5);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  e = lrnbf16::allow_smem(lrn_bf16_bwd_kernel, smem, device);
  if (e != cudaSuccess) return (int)e;
  lrn_bf16_bwd_kernel<<<(unsigned)blocks, lrnbf16::kThreads, (size_t)smem,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx,
      rows, C, lo, taps, r, alpha, k, nb, c2);
  return (int)cudaGetLastError();
}

// K3b for bf16 operands on K3b's ring design (above), in 16-byte units of
// eight channels, with the simple kernel's arithmetic in packed bf16x2
// (csrc/lrn_bf16.cuh), every operation rounded to bf16, so dx has the
// simple kernel's and lrn_bwd_plain's bits, signed zeros included:
//   s = k + alpha * W_n(x*x);  sb = s^nb;  t = ((dy * x) * sb) / s
//   dx = dy * sb - (c2 * x) * W_n(t)
//  - Pass 1 squares a thread's units into a row padded with +0, keeping x
//    in registers.  Pass 2, after a barrier: the windows of squares, s, sb
//    (from the table of powers, csrc/lrn_bf16.cuh), t (a float32 division
//    of the widened lanes, then one rounding: bf16 has no division) into
//    a second padded row, and dy * sb kept in registers.  Pass 3, after
//    a second barrier: the windows of t, dx.  One row of squares and one
//    of t suffice, as for the float32 kernel.
//  - Each window of t starts from its first tap, not from +0: a window of
//    -0s sums to -0, and the +0 pads add exactly where lrn_bwd_plain adds
//    its zero parts.
// Bound on an H100 SXM: memory, 2 bytes of x and of dy read and 2 of dx
// written an element (0.109 ms at AlexNet's conv1 and conv2, B=128); about
// 2n + 8 bf16x2 operations and two table reads an element pair, one
// division an element.

namespace lrnbf16 {   // its helpers' names, not the float32 kernels'

template <int N>
__global__ void __launch_bounds__(kThreads, kRingBlocksPerSm)
lrn_bf16_ring_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ dy,
                         __nv_bfloat16* __restrict__ dx,
                         const uint16_t* __restrict__ sbt, const RingPlan p) {
  extern __shared__ __align__(16) unsigned char lrn_bf16_smem[];
  uint16_t* base = reinterpret_cast<uint16_t*>(lrn_bf16_smem);
  const int row_in_group = threadIdx.x / p.tpr;   // fixed for the block
  const int t = threadIdx.x - row_in_group * p.tpr;
  const size_t rows_elems = (size_t)p.r * p.C;    // a slot's x, then its dy
  uint16_t* ring = base + (size_t)row_in_group * p.C;
  uint16_t* sq = base + 2 * (size_t)p.stages * rows_elems +
                 (size_t)row_in_group * p.stride;
  uint16_t* tw = sq + (size_t)p.r * p.stride;
  zero_pads(sq, t, p);
  zero_pads(tw, t, p);
  const uint32_t* sqw = reinterpret_cast<const uint32_t*>(sq);
  const uint32_t* tww = reinterpret_cast<const uint32_t*>(tw);
  const long long g0 = (long long)blockIdx.x * p.groups_per_block;
  long long g1 = g0 + p.groups_per_block;
  if (g1 > p.groups) g1 = p.groups;
  const int G = (int)(g1 - g0);                    // the same for the block
  const int c0 = t * 8, step = p.tpr * 8;
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < G) {
      load_units<2>(x, dy, ring + 2 * s * rows_elems, rows_elems,
                    (g0 + s) * p.r + row_in_group, c0, step, p);
    } else {
      cp_async_commit();
    }
  }
  int slot = 0;                                    // ring slot of group i
  int fill = p.stages - 1;                         // ring slot of i+stages-1
  for (int i = 0; i < G; ++i) {
    if (i + p.stages - 1 < G) {
      load_units<2>(x, dy, ring + 2 * fill * rows_elems, rows_elems,
                    (g0 + i + p.stages - 1) * p.r + row_in_group, c0, step,
                    p);
    } else {
      cp_async_commit();
    }
    cp_async_wait(p.stages - 1);
    const long long row = (g0 + i) * p.r + row_in_group;
    const bool live = row < p.rows;
    const uint16_t* xs = ring + 2 * slot * rows_elems;
    const uint16_t* ds = xs + rows_elems;
    uint32_t xw[kRingUnits][4];                    // x of each unit
    uint32_t gw[kRingUnits][4];                    // dy * sb of each unit
    if (live) {
#pragma unroll
      for (int u = 0; u < kRingUnits; ++u) {
        const int c = c0 + u * step;
        if (c < p.C) {
          words(xw[u], ld16(xs + c));
          uint32_t q[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) q[m] = mul2(xw[u][m], xw[u][m]);
          st16(sq + p.pad + c, q);
        }
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int u = 0; u < kRingUnits; ++u) {
        const int c = c0 + u * step;
        if (c < p.C) {
          uint32_t acc[4], d[4], tv[4];
          window8<N>(acc, sqw, p.pad + c, p.lo, p.taps);
          words(d, ld16(ds + c));
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            uint32_t s;
            const uint32_t sb = inv_pow2(acc[m], p, sbt, s);
            const uint32_t a = mul2(mul2(d[m], xw[u][m]), sb);
            tv[m] = pack(__fdiv_rn(lo_of(a), lo_of(s)),
                         __fdiv_rn(hi_of(a), hi_of(s)));
            gw[u][m] = mul2(d[m], sb);
          }
          st16(tw + p.pad + c, tv);
        }
      }
    }
    __syncthreads();
    if (live) {
      __nv_bfloat16* dst = dx + row * p.C;
#pragma unroll
      for (int u = 0; u < kRingUnits; ++u) {
        const int c = c0 + u * step;
        if (c < p.C) {
          uint32_t acc[4], out[4];
          window8<N>(acc, tww, p.pad + c, p.lo, p.taps);
#pragma unroll
          for (int m = 0; m < 4; ++m)
            out[m] = sub2(gw[u][m], mul2(mul2(p.c2, xw[u][m]), acc[m]));
          st16(dst + c, out);
        }
      }
    }
    slot = slot + 1 == p.stages ? 0 : slot + 1;
    fill = fill + 1 == p.stages ? 0 : fill + 1;
  }
}

}  // namespace lrnbf16

// rows = elements / C; alpha, k and c2 (= 2*alpha*beta) already rounded to
// bf16; pow_table the 65536 bf16 powers s^nb from znicz_lrn_bf16_pow_table
// (csrc/lrn.cu), nb = -beta rounded to bf16; the launch from
// ops/lrn._bf16_bwd_plan: tpr threads a row and r rows a group (tpr * r <=
// 256, at most two 8-channel units a thread), stages (1..2), the groups of
// each block and the blocks, the padded rows of squares and of t (pad
// zeros before their C values, stride values in all, 16-byte multiples
// reaching the window) and smem, the bytes of that layout.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// plan, operand or constant the kernel does not take (C % 8 != 0, an
// operand not 16-byte aligned).
extern "C" int znicz_lrn_bf16_ring_bwd(const void* x, const void* dy, void* dx,
                                       const void* pow_table, long long rows,
                                       int C, int lo, int taps, float alpha,
                                       float k, float c2, int tpr, int r,
                                       int stages, long long groups_per_block,
                                       int blocks,
                                       int pad, int stride, int smem,
                                       int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  lrnbf16::RingPlan p;
  if (!lrnbf16::ring_plan(p, rows, C, lo, taps, alpha, k, c2, tpr, r,
                          stages, groups_per_block, blocks, pad, stride, smem,
                          2) ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)dy % 16 != 0 ||
      (uintptr_t)dx % 16 != 0 || pow_table == nullptr ||
      (uintptr_t)pow_table % 2 != 0)
    return (int)cudaErrorInvalidValue;
  void (*fn)(const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*,
             const uint16_t*, const lrnbf16::RingPlan) =
      lrnbf16::lrn_bf16_ring_bwd_kernel<0>;
  if (taps == 5 && lo == -2) fn = lrnbf16::lrn_bf16_ring_bwd_kernel<5>;
  if (rows == 0) return 0;
  e = lrnbf16::allow_smem(fn, smem, device);
  if (e != cudaSuccess) return (int)e;
  fn<<<(unsigned)blocks, tpr * r, (size_t)smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx,
      (const uint16_t*)pow_table, p);
  return (int)cudaGetLastError();
}
