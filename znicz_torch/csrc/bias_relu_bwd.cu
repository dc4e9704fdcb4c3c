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
//    or an unaligned operand); for bf16 operands eight (16 bytes, below).  Its bias and its running column sums stay
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

// A unit of V channels of operand type E: its load type T, widened to V
// floats exactly and narrowed from them (bf16: each lane rounded once to
// nearest even by cvt.rn.bf16x2.f32, as __float2bfloat16_rn rounds).
template <typename E, int V>
struct Unit;
template <>
struct Unit<float, 1> {
  using T = float;
  static __device__ __forceinline__ void widen(T v, float* f) { f[0] = v; }
  static __device__ __forceinline__ T narrow(const float* f) { return f[0]; }
};
template <>
struct Unit<float, 4> {
  using T = float4;
  static __device__ __forceinline__ void widen(T v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ T narrow(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Unit<__nv_bfloat16, 8> {
  using T = uint4;  // eight bf16
  static __device__ __forceinline__ void pair(uint32_t w, float* f) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    f[0] = v.x;
    f[1] = v.y;
  }
  static __device__ __forceinline__ uint32_t round_pair(const float* f) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void widen(T v, float* f) {
    pair(v.x, f);
    pair(v.y, f + 2);
    pair(v.z, f + 4);
    pair(v.w, f + 6);
  }
  static __device__ __forceinline__ T narrow(const float* f) {
    uint4 u;
    u.x = round_pair(f);
    u.y = round_pair(f + 2);
    u.z = round_pair(f + 4);
    u.w = round_pair(f + 6);
    return u;
  }
};

__device__ __forceinline__ float gate(float x, float b, float d) {
  return __fmul_rn(d, __fadd_rn(x, b) > 0.0f ? 1.0f : 0.0f);
}

// dx of one unit, in floats, from its x and dp and the widened bias.
template <typename U, int V>
__device__ __forceinline__ void gate_unit(typename U::T xv,
                                          typename U::T dv, const float* bf,
                                          float* d) {
  float xf[V], df[V];
  U::widen(xv, xf);
  U::widen(dv, df);
#pragma unroll
  for (int j = 0; j < V; ++j) d[j] = gate(xf[j], bf[j], df[j]);
}

template <int V>
__device__ __forceinline__ void add(float* acc, const float* v) {
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
}

// s += unit u of a row of partials (floats), read past L1 (__ldcg): the
// other blocks wrote it.
template <int V>
__device__ __forceinline__ void add_partial(float* s,
                                            const float* __restrict__ row,
                                            int u) {
  if constexpr (V == 1) {
    s[0] = __fadd_rn(s[0], __ldcg(row + u));
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(row) + u * (V / 4) + q);
      const float f[4] = {v.x, v.y, v.z, v.w};
      add<4>(s + 4 * q, f);
    }
  }
}

template <int V>
__device__ __forceinline__ void put_db(float* db, int u, const float* s) {
  if constexpr (V == 1) {
    db[u] = s[0];
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(db)[u * (V / 4) + q] =
          make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  }
}

// E: operand type (float, or bf16 for x, b, dp and dx); V: channels a
// unit (float 4 or 1, bf16 8).  db and the partial rows are float32.  The
// bf16 instance asks for two resident blocks an SM, as the planner assumes
// (fused_block._BR_BLOCKS_PER_SM): its eight accumulators and four
// unrolled pairs of 16-byte loads must fit 64 registers a thread.
template <typename E, int V>
__global__ void __launch_bounds__(kMaxThreads, sizeof(E) == 2 ? 2 : 1)
bias_relu_bwd_kernel(const E* __restrict__ x, const E* __restrict__ b,
                     const E* __restrict__ dp, E* __restrict__ dx,
                     float* __restrict__ db, float* __restrict__ partial,
                     unsigned* __restrict__ ticket, const Plan p) {
  using U = Unit<E, V>;
  using T = typename U::T;
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
    float bf[V];
    U::widen(__ldg(reinterpret_cast<const T*>(b) + unit), bf);
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
        float d[V];
        gate_unit<U, V>(xv[u], dv[u], bf, d);
        out[at + u * step] = U::narrow(d);
        add<V>(acc, d);
      }
    }
    for (; row < r1; row += p.r) {
      const long long at = row * units;
      float d[V];
      gate_unit<U, V>(__ldg(xs + at), __ldg(ds + at), bf, d);
      out[at] = U::narrow(d);
      add<V>(acc, d);
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
  if (p.splits == 1) {
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      float s[V];
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = 0.0f;
      for (int i = 0; i < p.row_blocks; ++i)
        add_partial<V>(s, partial + (long long)i * p.C, u);
      put_db<V>(db, u, s);
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
        add_partial<V>(s, partial + (long long)i * p.C, u);
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

// Check the plan and launch bias_relu_bwd_kernel<E, V>.
template <typename E, int V>
int launch_bwd(const E* x, const E* b, const E* dp, E* dx, float* db,
               float* partial, unsigned* ticket, long long rows, int C,
               int tpr, int r, int chunks, int row_blocks, int splits,
               int device, cudaStream_t s) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = tpr * r;
  const long long units = C / V;
  const bool aligned = ((uintptr_t)x | (uintptr_t)b | (uintptr_t)dp |
                        (uintptr_t)dx | (uintptr_t)db |
                        (uintptr_t)partial) % 16 == 0;
  if (C < 1 || tpr < 1 || r < 1 || threads > kMaxThreads || chunks < 1 ||
      (long long)chunks * tpr < units ||
      (long long)(chunks - 1) * tpr >= units || row_blocks < 1 ||
      splits < 1 || (splits > 1 && splits * units > threads) ||
      (V > 1 && (C % V != 0 || !aligned)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaMemsetAsync(db, 0, C * sizeof(float), s);
  const size_t smem = (size_t)threads * V * sizeof(float);
  const dim3 grid((unsigned)row_blocks, (unsigned)chunks);
  const Plan p{rows, C, tpr, r, chunks, row_blocks, splits};
  bias_relu_bwd_kernel<E, V><<<grid, threads, smem, s>>>(x, b, dp, dx, db,
                                                         partial, ticket, p);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    return launch_bwd<float, 4>(x, b, dp, dx, db, partial, ticket, rows, C,
                                tpr, r, chunks, row_blocks, splits, device,
                                s);
  return launch_bwd<float, 1>(x, b, dp, dx, db, partial, ticket, rows, C,
                              tpr, r, chunks, row_blocks, splits, device, s);
}

// K2b for bf16 operands on 16-byte units (znicz_bias_relu_bf16_vec_bwd):
// the kernel above with E = bf16 and V = 8, for C % 8 == 0 and x, b, dp,
// dx, db and partial 16-byte aligned (fused_block._bf16_relu_bwd_plan, the
// float32 plan on 8-channel units; None, and the simple kernel below,
// elsewhere).  A thread's unit is a 16-byte load of x and of dp and a
// 16-byte store of dx, four rows deep: eight 16-byte loads in flight a
// thread, where the simple kernel has two 2-byte loads.  Everything else is
// float32 and the float32 kernel's: the gate __fmul_rn(dp, x + b > 0 ? 1 :
// 0) on the widened lanes (signed zeros and NaNs kept), eight running
// column sums in registers, the block's row slots added in order in shared
// memory (16 KB at 512 threads), the ticket and the last block's ordered
// sum of the partial rows: one launch, the same db bits on every run.  dx
// is rounded once, to nearest even, at the store: the simple kernel's and
// bias_relu_bwd_plain's bits.
//
// The partial rows and the ticket are the workspace the float32 K2b uses
// (fused_block._br_workspace, one per device and stream): launches on one
// stream run in order and each leaves the ticket 0, so the two kernels can
// share it; another stream gets its own.
extern "C" int znicz_bias_relu_bf16_vec_bwd(
    const void* x, const void* b, const void* dp, void* dx, float* db,
    float* partial, unsigned* ticket, long long rows, int C, int tpr, int r,
    int chunks, int row_blocks, int splits, int device, void* stream) {
  using E = __nv_bfloat16;
  return launch_bwd<E, 8>((const E*)x, (const E*)b, (const E*)dp, (E*)dx, db,
                          partial, ticket, rows, C, tpr, r, chunks,
                          row_blocks, splits, device, (cudaStream_t)stream);
}

// K2b for bf16 operands (x, b, dp; dx bf16, db float32): the simple
// kernel, for the shapes the 16-byte kernel does not take, and
// column_sum.cuh.  dx = dp * [x + b > 0] in
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
// tpc channels cover C, row_blocks >= 1
// (fused_block._bf16_simple_relu_plan).
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
