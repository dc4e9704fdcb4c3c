// Deterministic column sums of a (rows, C) float32 matrix of per-block
// partial sums: the second pass of the bias gradients of K1b and K2b.
//
// The TPU kernels accumulate db across their grid in scratch memory,
// which relies on the TPU running the grid in order.  Blocks on a GPU run
// in no order, so the first pass writes one row of partials per block and
// this pass adds them up: one block per column, each thread summing a
// fixed strided subset of the rows in order, then a fixed tree in shared
// memory.  No atomics: the same inputs give the same db on every run.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
column_sum_kernel(const float* __restrict__ partial, int rows, int C,
                  float* __restrict__ out) {
  __shared__ float red[kSumThreads];
  const int c = blockIdx.x;
  float acc = 0.0f;
  for (int r = threadIdx.x; r < rows; r += kSumThreads) {
    acc = __fadd_rn(acc, partial[(long long)r * C + c]);
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[c] = red[0];
}

inline cudaError_t launch_column_sum(const float* partial, int rows, int C,
                                     float* out, cudaStream_t stream) {
  column_sum_kernel<<<C, kSumThreads, 0, stream>>>(partial, rows, C, out);
  return cudaGetLastError();
}

}  // namespace
