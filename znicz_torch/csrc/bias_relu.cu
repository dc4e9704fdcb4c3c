// K2 bias_relu_fwd: y = max(x + b, 0) over an NHWC float32 tensor, b
// broadcast over the last (channel) axis.
//
// Replaces: znicz_tpu/pallas_fused_block.py _bias_relu_fwd_kernel (:392),
// reached through _call_bias_relu_fwd (:421) and fused_bias_relu (:479) —
// AlexNet's conv3-5 stage.
//
// Bound on an H100 SXM: memory.  One read of x and one write of y, two
// operations per element.  At conv3 (B=128, 13x13x384) that is 66.5 MB, or
// 20 us at 3.35 TB/s.
//
// Design: the TPU kernel takes one image per grid step; here a grid-stride
// loop walks the flat tensor with 16-byte float4 loads and stores
// (neighbouring threads on neighbouring addresses) where C % 4 == 0 and the
// pointers are 16-byte aligned, one float at a time otherwise.  The channel
// of element i is i % C; the bias (at most a few KB) stays in L1/L2.  The
// grid is capped at a few blocks per SM so each thread streams several
// vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
bias_relu_vec4_kernel(const float4* __restrict__ x,
                      const float4* __restrict__ b, float4* __restrict__ y,
                      long long n4, int c4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 v = x[i];
    const float4 bb = __ldg(b + (int)(i % c4));
    v.x = fmaxf(v.x + bb.x, 0.0f);
    v.y = fmaxf(v.y + bb.y, 0.0f);
    v.z = fmaxf(v.z + bb.z, 0.0f);
    v.w = fmaxf(v.w + bb.w, 0.0f);
    y[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
bias_relu_scalar_kernel(const float* __restrict__ x,
                        const float* __restrict__ b, float* __restrict__ y,
                        long long n, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    y[i] = fmaxf(x[i] + __ldg(b + (int)(i % C)), 0.0f);
  }
}

}  // namespace

extern "C" const char* znicz_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// n = elements of x (a multiple of C).  Returns cudaGetLastError().
extern "C" int znicz_bias_relu_fwd(const float* x, const float* b, float* y,
                                   long long n, int C, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const bool vec = C % 4 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)b % 16) == 0 && ((uintptr_t)y % 16) == 0;
  const long long items = vec ? n / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSm) blocks = (long long)sms * kBlocksPerSm;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    bias_relu_vec4_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float4*)x, (const float4*)b, (float4*)y, items, C / 4);
  } else {
    bias_relu_scalar_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, b, y, n,
                                                                  C);
  }
  return (int)cudaGetLastError();
}

// K2 for bf16 operands: the same grid-stride walk, one element a thread,
// y = max(x + b, 0) in float32 on the widened operands, rounded to bf16
// once at the store (__float2bfloat16_rn, round to nearest even), as the
// TPU kernel computes bf16 operands in float32.  A simple kernel beside
// the float32 one, with 2-byte accesses.

namespace {

__global__ void __launch_bounds__(kThreads)
bias_relu_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ b,
                      __nv_bfloat16* __restrict__ y, long long n, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    y[i] = __float2bfloat16_rn(fmaxf(
        __fadd_rn(__bfloat162float(x[i]), __bfloat162float(b[(int)(i % C)])),
        0.0f));
  }
}

}  // namespace

extern "C" int znicz_bias_relu_bf16_fwd(const void* x, const void* b, void* y,
                                        long long n, int C, int device,
                                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (C < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSm)
    blocks = (long long)sms * kBlocksPerSm;
  bias_relu_bf16_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)b, (__nv_bfloat16*)y, n,
      C);
  return (int)cudaGetLastError();
}
