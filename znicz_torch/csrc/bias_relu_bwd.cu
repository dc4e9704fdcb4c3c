// K2b bias_relu_bwd: the backward of y = max(x + b, 0) over an NHWC
// float32 tensor, from the forward's input x, the bias b and the output
// cotangent dp:
//   dx = dp * [x + b > 0]      (the gate recomputed, never stored)
//   db = sum over B, H, W of dx
//
// Replaces: znicz_tpu/pallas_fused_block.py _bias_relu_bwd_kernel (:400),
// reached through _call_bias_relu_bwd (:437) under fused_bias_relu's
// custom vjp (:456-473) — AlexNet's conv3-5 stage, and conv1/conv2's
// bias+ReLU under pallas_lrn.
//
// Bound on an H100 SXM: memory.  Reads x and dp once, writes dx once, and
// a few operations per element.  At conv3 (B=128, 13x13x384) that is
// 99.7 MB, or 30 us at 3.35 TB/s.
//
// Design: the TPU kernel takes one image per grid step and adds its
// column sums into db in scratch, relying on the TPU's in-order grid.
// Here the Python planner (fused_block._bias_relu_bwd_plan) fixes, from
// the shape alone, which rows each block sums and in what order, so db
// has the same bits on every run.
//  - A thread owns one unit of channels: four (float4 path: 16-byte loads
//    of x and dp, a 16-byte store of dx) or one (scalar path: C % 4 != 0
//    or an unaligned operand).  Its bias and its running column sums stay
//    in registers.  tpr threads take a pixel row of one channel chunk
//    (gridDim.y chunks cover any C), r rows are in flight a block, and the
//    row loop is unrolled four deep, so each thread has eight loads in
//    flight.
//  - Block (i, j) walks rows [i*rows/nb, (i+1)*rows/nb) of chunk j; its
//    thread of row slot ty takes every r-th row from ty, in order.  The
//    block adds its r row slots in order in shared memory (r x chunk
//    floats) and writes one row of partials.
//  - The last block to finish, found by an integer ticket (atomicAdd
//    after __threadfence, no float atomics), adds the partial rows in
//    order: `splits` threads a unit each sum a fixed run of rows with
//    coalesced loads, then one thread a unit adds the runs in order.  It
//    resets the ticket for the next launch.  One launch in all.
//  - dx = __fmul_rn(dp, gate ? 1 : 0), the plain version's multiply, so
//    dx is bit-identical, signed zeros and NaNs included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "column_sum.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;

struct Plan {
  long long rows;
  int C, tpr, r, chunks, row_blocks, splits;
};

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ float gate(float x, float b, float d) {
  return __fmul_rn(d, __fadd_rn(x, b) > 0.0f ? 1.0f : 0.0f);
}

__device__ __forceinline__ float4 gate(float4 x, float4 b, float4 d) {
  return make_float4(gate(x.x, b.x, d.x), gate(x.y, b.y, d.y),
                     gate(x.z, b.z, d.z), gate(x.w, b.w, d.w));
}

__device__ __forceinline__ void add(float* acc, float v) {
  acc[0] = __fadd_rn(acc[0], v);
}

__device__ __forceinline__ void add(float* acc, float4 v) {
  acc[0] = __fadd_rn(acc[0], v.x);
  acc[1] = __fadd_rn(acc[1], v.y);
  acc[2] = __fadd_rn(acc[2], v.z);
  acc[3] = __fadd_rn(acc[3], v.w);
}

// V: channels a unit (4 or 1).
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
bias_relu_bwd_kernel(const float* __restrict__ x, const float* __restrict__ b,
                     const float* __restrict__ dp, float* __restrict__ dx,
                     float* __restrict__ db, float* __restrict__ partial,
                     unsigned* __restrict__ ticket, const Plan p) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) float red[];  // r x tpr*V, then splits x C
  __shared__ bool last;
  const int ty = threadIdx.x / p.tpr;            // row slot, fixed
  const int t = threadIdx.x - ty * p.tpr;
  const int units = p.C / V;
  const int unit = blockIdx.y * p.tpr + t;
  const bool on = unit < units;
  const long long r0 = (long long)blockIdx.x * p.rows / p.row_blocks;
  const long long r1 = (long long)(blockIdx.x + 1) * p.rows / p.row_blocks;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (on) {
    const T bv = __ldg(reinterpret_cast<const T*>(b) + unit);
    const T* xs = reinterpret_cast<const T*>(x) + unit;
    const T* ds = reinterpret_cast<const T*>(dp) + unit;
    T* out = reinterpret_cast<T*>(dx) + unit;
    const long long step = (long long)p.r * units;  // r rows, in units
    long long row = r0 + ty;
    for (; row + (kUnroll - 1) * p.r < r1; row += kUnroll * p.r) {
      const long long at = row * units;
      T xv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xv[u] = __ldg(xs + at + u * step);
        dv[u] = __ldg(ds + at + u * step);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T d = gate(xv[u], bv, dv[u]);
        out[at + u * step] = d;
        add(acc, d);
      }
    }
    for (; row < r1; row += p.r) {
      const long long at = row * units;
      const T d = gate(__ldg(xs + at), bv, __ldg(ds + at));
      out[at] = d;
      add(acc, d);
    }
  }
  // the block's partial row: its row slots added in order
  const int width = p.tpr * V;                   // floats of a chunk
  if (on) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[ty * width + t * V + j] = acc[j];
  }
  __syncthreads();
  const int c0 = blockIdx.y * width;
  for (int col = threadIdx.x; col < width && c0 + col < p.C;
       col += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < p.r; ++k) s = __fadd_rn(s, red[k * width + col]);
    partial[(long long)blockIdx.x * p.C + c0 + col] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: db from the partial rows, in order
  const T* part = reinterpret_cast<const T*>(partial);
  T* out = reinterpret_cast<T*>(db);
  if (p.splits == 1) {
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      float s[V];
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = 0.0f;
      for (int i = 0; i < p.row_blocks; ++i)
        add(s, __ldcg(part + (long long)i * units + u));
      if constexpr (V == 4) {
        out[u] = make_float4(s[0], s[1], s[2], s[3]);
      } else {
        out[u] = s[0];
      }
    }
  } else {
    if ((int)threadIdx.x < p.splits * units) {
      const int k = threadIdx.x / units;
      const int u = threadIdx.x - k * units;
      const int i0 = (int)((long long)k * p.row_blocks / p.splits);
      const int i1 = (int)((long long)(k + 1) * p.row_blocks / p.splits);
      float s[V];
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = 0.0f;
      for (int i = i0; i < i1; ++i)
        add(s, __ldcg(part + (long long)i * units + u));
#pragma unroll
      for (int j = 0; j < V; ++j) red[k * p.C + u * V + j] = s[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
      float s = 0.0f;
      for (int k = 0; k < p.splits; ++k) s = __fadd_rn(s, red[k * p.C + c]);
      db[c] = s;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

extern "C" const char* znicz_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// rows = elements / C.  partial holds row_blocks * C floats and ticket one
// unsigned int, 0 on entry and left 0.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a plan this file does not take: the
// caller (fused_block._bias_relu_bwd_plan) chooses vec (C % 4 == 0 and
// every operand 16-byte aligned), tpr threads a row of a channel chunk and
// r rows (tpr * r <= 512), chunks covering C, row_blocks >= 1, and splits
// (splits * units <= tpr * r, or 1).
extern "C" int znicz_bias_relu_bwd(const float* x, const float* b,
                                   const float* dp, float* dx, float* db,
                                   float* partial, unsigned* ticket,
                                   long long rows, int C, int vec, int tpr,
                                   int r, int chunks, int row_blocks,
                                   int splits, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const int V = vec ? 4 : 1;
  const int threads = tpr * r;
  const long long units = C / V;
  const bool aligned = ((uintptr_t)x | (uintptr_t)b | (uintptr_t)dp |
                        (uintptr_t)dx | (uintptr_t)db |
                        (uintptr_t)partial) % 16 == 0;
  if (C < 1 || tpr < 1 || r < 1 || threads > kMaxThreads || chunks < 1 ||
      (long long)chunks * tpr < units ||
      (long long)(chunks - 1) * tpr >= units || row_blocks < 1 ||
      splits < 1 || (splits > 1 && splits * units > threads) ||
      (vec && (C % 4 != 0 || !aligned)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaMemsetAsync(db, 0, C * sizeof(float), s);
  const size_t smem = (size_t)threads * V * sizeof(float);
  const dim3 grid((unsigned)row_blocks, (unsigned)chunks);
  const Plan p{rows, C, tpr, r, chunks, row_blocks, splits};
  if (vec) {
    bias_relu_bwd_kernel<4><<<grid, threads, smem, s>>>(x, b, dp, dx, db,
                                                        partial, ticket, p);
  } else {
    bias_relu_bwd_kernel<1><<<grid, threads, smem, s>>>(x, b, dp, dx, db,
                                                        partial, ticket, p);
  }
  return (int)cudaGetLastError();
}

// K2b for bf16 operands (x, b, dp; dx bf16, db float32): a simple kernel
// beside the float32 one, and column_sum.cuh.  dx = dp * [x + b > 0] in
// float32 on the widened operands (__fmul_rn(dp, gate ? 1 : 0), signed
// zeros kept), rounded to bf16 once at the store.  Block (i, j) of the
// row_blocks x chunks grid walks rows [i*rows/row_blocks,
// (i+1)*rows/row_blocks) of channel chunk j, `slots` rows at a time, one
// thread a channel; each thread sums its dx in order, the block adds its
// slots in order into one row of partials, and column_sum.cuh adds the
// rows: the same db bits on every run, no atomics.

namespace {

constexpr int kBf16Threads = 256;

__global__ void __launch_bounds__(kBf16Threads)
bias_relu_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ b,
                          const __nv_bfloat16* __restrict__ dp,
                          __nv_bfloat16* __restrict__ dx,
                          float* __restrict__ partial, long long rows, int C,
                          int tpc) {
  extern __shared__ float red[];              // slots x tpc
  const int slots = blockDim.x / tpc;
  const int slot = threadIdx.x / tpc;
  const int t = threadIdx.x - slot * tpc;
  const int c = blockIdx.y * tpc + t;
  const long long r0 = blockIdx.x * rows / gridDim.x;
  const long long r1 = (blockIdx.x + 1) * rows / gridDim.x;
  float acc = 0.0f;
  if (c < C) {
    const float bc = __bfloat162float(b[c]);
    for (long long r = r0 + slot; r < r1; r += slots) {
      const long long i = r * C + c;
      const float d = __fmul_rn(
          __bfloat162float(dp[i]),
          __fadd_rn(__bfloat162float(x[i]), bc) > 0.0f ? 1.0f : 0.0f);
      dx[i] = __float2bfloat16_rn(d);
      acc = __fadd_rn(acc, d);
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  if (slot == 0 && c < C) {
    float s = 0.0f;
    for (int k = 0; k < slots; ++k) s = __fadd_rn(s, red[k * tpc + t]);
    partial[(long long)blockIdx.x * C + c] = s;
  }
}

}  // namespace

// rows = elements / C; partial holds row_blocks * C floats.  tpc threads
// take a row of a channel chunk (a multiple of 32, at most 256), chunks of
// tpc channels cover C, row_blocks >= 1 (fused_block._bf16_relu_plan).
// Returns cudaGetLastError() after both launches, or
// cudaErrorInvalidValue for a plan this file does not take.
extern "C" int znicz_bias_relu_bf16_bwd(const void* x, const void* b,
                                        const void* dp, void* dx, float* db,
                                        float* partial, long long rows, int C,
                                        int tpc, int chunks, int row_blocks,
                                        int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (C < 1 || tpc < 32 || tpc % 32 != 0 || tpc > kBf16Threads ||
      chunks < 1 || (long long)chunks * tpc < C || row_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaMemsetAsync(db, 0, C * sizeof(float), s);
  const int slots = kBf16Threads / tpc;
  bias_relu_bwd_bf16_kernel<<<dim3((unsigned)row_blocks, (unsigned)chunks),
                              slots * tpc, (size_t)slots * tpc * sizeof(float),
                              s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)b,
      (const __nv_bfloat16*)dp, (__nv_bfloat16*)dx, partial, rows, C, tpc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_column_sum(partial, row_blocks, C, db, s);
}
