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
// Here a block owns a run of whole pixel rows (each row a pixel's C
// channels); its 8 warps take every 8th row, lanes over channels, so a
// warp reads 128 contiguous bytes at a time.  Each lane keeps the running
// sums of its channels in registers; the block adds its warps' sums in a
// fixed order and writes one row of partials, and column_sum.cuh adds the
// rows.  The number of rows per block depends on the shape only, so db
// is the same on every run.

#include <cuda_runtime.h>

#include "column_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 32;  // channels per lane: C <= 1024

__global__ void __launch_bounds__(kThreads)
bias_relu_bwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ b,
                     const float* __restrict__ dp, float* __restrict__ dx,
                     float* __restrict__ partial, long long rows, int C,
                     int rows_per_block) {
  __shared__ float red[kWarps * 32 * kMaxPerLane];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  long long r1 = r0 + rows_per_block;
  if (r1 > rows) r1 = rows;
  float acc[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) acc[j] = 0.0f;
  for (long long r = r0 + warp; r < r1; r += kWarps) {
    const long long base = r * C;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        const float a = __fadd_rn(x[base + c], __ldg(b + c));
        const float d = __fmul_rn(dp[base + c], a > 0.0f ? 1.0f : 0.0f);
        dx[base + c] = d;
        acc[j] = __fadd_rn(acc[j], d);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c < C) red[warp * C + c] = acc[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w * C + c]);
    partial[(long long)blockIdx.x * C + c] = s;
  }
}

}  // namespace

extern "C" const char* znicz_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The number of partial rows (blocks) the launch writes for these
// shapes, and the rows per block: the caller allocates partial as
// (blocks, C) floats.
extern "C" long long znicz_bias_relu_bwd_blocks(long long rows,
                                                int* rows_per_block) {
  long long rpb = (rows + 1023) / 1024;
  if (rpb < kWarps) rpb = kWarps;
  rpb = (rpb + kWarps - 1) / kWarps * kWarps;
  *rows_per_block = (int)rpb;
  return (rows + rpb - 1) / rpb;
}

// rows = elements / C; partial holds znicz_bias_relu_bwd_blocks(rows) * C
// floats.  Returns cudaGetLastError() after both launches.
extern "C" int znicz_bias_relu_bwd(const float* x, const float* b,
                                   const float* dp, float* dx, float* db,
                                   float* partial, long long rows, int C,
                                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (C > 32 * kMaxPerLane || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 0) return (int)cudaMemsetAsync(db, 0, C * sizeof(float), s);
  int rpb = 0;
  const long long blocks = znicz_bias_relu_bwd_blocks(rows, &rpb);
  bias_relu_bwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      x, b, dp, dx, partial, rows, C, rpb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_column_sum(partial, (int)blocks, C, db, s);
}
