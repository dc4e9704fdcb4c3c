// K3 lrn_fwd: cross-channel local response normalisation over a float32
// (rows, C) view of an NHWC tensor:
//   s = k + alpha * W_n(x*x);  y = x * powf(s, -beta)
// with W_n the n-channel window summed from offset -n/2 to +n/2 in that
// order, zero past the channel ends.
//
// Replaces: znicz_tpu/ops/lrn_pallas.py _fwd_kernel (:78), tiled by
// _pallas_2d (:97) and exposed as lrn (:165).  That kernel raises s to
// -beta with jnp.power, not with the rsqrt form the fused block kernel
// uses; this one keeps its own formulation (powf).
//
// Bound on an H100 SXM: memory.  One read of x and one write of y, about
// n + 4 operations and one powf per element.  At AlexNet's conv1 output
// (B=128, 55x55x96) that is 297 MB, or 89 us at 3.35 TB/s.
//
// Design: one block per group of pixels.  A block copies its rows (each
// row a pixel's C channels, the group a contiguous run of memory) into
// shared memory with coalesced loads, then every thread normalises
// elements of the group, reading the n channel neighbours of its element
// from shared memory instead of from device memory.  The group holds
// about 8192 floats (32 KB), so several blocks share an SM; no row is
// read twice from device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;

__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
               long long rows, int C, int rows_per_block, int n, float alpha,
               float beta, float k) {
  extern __shared__ float tile[];  // rows_per_block * C
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long left = rows - r0;
  const int nr = left < rows_per_block ? (int)left : rows_per_block;
  const int len = nr * C;
  const float* src = x + r0 * C;
  float* dst = y + r0 * C;
  for (int i = threadIdx.x; i < len; i += blockDim.x) tile[i] = src[i];
  __syncthreads();
  const int half = n / 2;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int c = i % C;
    const float* px = tile + (i - c);
    float acc = 0.0f;
    for (int o = -half; o <= half; ++o) {
      const int cc = c + o;
      if (cc >= 0 && cc < C) {
        // no fused multiply-add: the square is rounded first, as in the
        // reference's x * x
        acc = __fadd_rn(acc, __fmul_rn(px[cc], px[cc]));
      }
    }
    const float s = __fadd_rn(k, __fmul_rn(alpha, acc));
    dst[i] = px[c] * powf(s, -beta);
  }
}

}  // namespace

extern "C" const char* znicz_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// rows = elements / C.  Returns cudaGetLastError().  The caller keeps
// C * 4 bytes within 48 KB (one row must fit the static limit).
extern "C" int znicz_lrn_fwd(const float* x, float* y, long long rows, int C,
                             int n, float alpha, float beta, float k,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows == 0) return 0;
  int rows_per_block = kTileFloats / C;
  if (rows_per_block < 1) rows_per_block = 1;
  const size_t smem = (size_t)rows_per_block * C * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  lrn_fwd_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, y, rows, C, rows_per_block, n, alpha, beta, k);
  return (int)cudaGetLastError();
}
