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

// Blocks of kThreads for `items` units of the grid-stride walk: one a unit,
// capped at kBlocksPerSm blocks an SM, so each thread streams several.
static cudaError_t grid_blocks(long long items, int device,
                               long long* blocks) {
  int sms = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *blocks = (items + kThreads - 1) / kThreads;
  if (*blocks > (long long)sms * kBlocksPerSm)
    *blocks = (long long)sms * kBlocksPerSm;
  return cudaSuccess;
}

// n = elements of x (a multiple of C).  Returns cudaGetLastError().
extern "C" int znicz_bias_relu_fwd(const float* x, const float* b, float* y,
                                   long long n, int C, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const bool vec = C % 4 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)b % 16) == 0 && ((uintptr_t)y % 16) == 0;
  const long long items = vec ? n / 4 : n;
  long long blocks = 0;
  e = grid_blocks(items, device, &blocks);
  if (e != cudaSuccess) return (int)e;
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

// The simple kernel: every shape (fused_block._bf16_relu_fwd_route takes
// it where the 16-byte kernel below does not run).
extern "C" int znicz_bias_relu_bf16_fwd(const void* x, const void* b, void* y,
                                        long long n, int C, int device,
                                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (C < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  long long blocks = 0;
  e = grid_blocks(n, device, &blocks);
  if (e != cudaSuccess) return (int)e;
  bias_relu_bf16_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)b, (__nv_bfloat16*)y, n,
      C);
  return (int)cudaGetLastError();
}

// K2 for bf16 operands on 16-byte units (znicz_bias_relu_bf16_vec_fwd):
// the float32 vec4 kernel's design on units of eight bf16 channels, for
// C % 8 == 0 and x, b and y 16-byte aligned (fused_block.
// _bf16_relu_fwd_route chooses it; the simple kernel above takes the
// rest).  The simple kernel moves 2 bytes a thread at a time, so with the
// grid capped at kBlocksPerSm blocks an SM it keeps about 0.5 MB of loads
// in flight, and it pays a 64-bit i % C an element; halving the bytes
// against the float32 kernel barely moved its time.
//
// Per unit: one 16-byte load of x; each bf16 pair widened exactly
// (__bfloat1622float2); fmaxf(__fadd_rn(x, b), 0) in float32 on each lane;
// each lane rounded once by __floats2bfloat162_rn (cvt.rn.bf16x2.f32:
// round to nearest even and the canonical NaN, as the simple kernel's
// __float2bfloat16_rn and PyTorch's own conversion on the card); one
// 16-byte store.  So y has the simple kernel's and bias_relu_plain's bits,
// and the same grid now keeps 16 bytes a thread in flight, as the float32
// kernel does (75-77% of its bound).
//
// The bias unit: a thread computes its first unit's channel unit once (one
// 64-bit modulo a thread) and steps it by the grid stride modulo C/8, one
// compare and subtract a unit, so the loop divides nothing; the unit is a
// 16-byte __ldg through L1 (at most a few KB of bias).  Walking rows x
// units, as K2b does, would keep the bias in registers but tie the block's
// shape to C; the flat walk keeps neighbouring threads on neighbouring
// units for every C, as the float32 kernel does.

namespace {

__device__ __forceinline__ uint32_t relu_pair(uint32_t xw, uint32_t bw) {
  const float2 xv =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw));
  const float2 bv =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw));
  const __nv_bfloat162 y =
      __floats2bfloat162_rn(fmaxf(__fadd_rn(xv.x, bv.x), 0.0f),
                            fmaxf(__fadd_rn(xv.y, bv.y), 0.0f));
  return *reinterpret_cast<const uint32_t*>(&y);
}

__global__ void __launch_bounds__(kThreads)
bias_relu_bf16x8_kernel(const uint4* __restrict__ x,
                        const uint4* __restrict__ b, uint4* __restrict__ y,
                        long long n8, int c8) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  int u = (int)(i % c8);                 // channel unit of unit i
  const int du = (int)(stride % c8);
  for (; i < n8; i += stride) {
    const uint4 v = x[i];
    const uint4 bb = __ldg(b + u);
    uint4 o;
    o.x = relu_pair(v.x, bb.x);
    o.y = relu_pair(v.y, bb.y);
    o.z = relu_pair(v.z, bb.z);
    o.w = relu_pair(v.w, bb.w);
    y[i] = o;
    u += du;
    if (u >= c8) u -= c8;
  }
}

}  // namespace

// n = elements of x (a multiple of C).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue where C % 8 != 0 or an operand is not 16-byte
// aligned.
extern "C" int znicz_bias_relu_bf16_vec_fwd(const void* x, const void* b,
                                            void* y, long long n, int C,
                                            int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (C < 1 || C % 8 != 0 ||
      ((uintptr_t)x | (uintptr_t)b | (uintptr_t)y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long items = n / 8;
  long long blocks = 0;
  e = grid_blocks(items, device, &blocks);
  if (e != cudaSuccess) return (int)e;
  bias_relu_bf16x8_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const uint4*)x, (const uint4*)b, (uint4*)y, items, C / 8);
  return (int)cudaGetLastError();
}
