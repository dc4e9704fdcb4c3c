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
// them into FMAs the reference does not do.
//
// Bound on an H100 SXM: memory.  Reads x and dy once, writes dx once;
// about 2n + 12 operations and one powf per element.  At AlexNet's conv1
// (B=128, 55x55x96) that is 446 MB, or 133 us at 3.35 TB/s.
//
// Design: K3's rows x C tiling.  One block owns a run of whole rows (a
// contiguous piece of memory).  It stages x and dy into shared memory
// with coalesced loads; pass 1 computes each element's t (which needs the
// x window of its row) into a third buffer and replaces its own dy by
// dy * sb; pass 2 takes the t window from shared memory and writes dx.
// Three buffers of 4096 floats, 48 KB, fit without an opt-in.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 4096;  // per buffer

__device__ __forceinline__ float window_sum(const float* row, int c, int C,
                                            int lo, int taps, bool square) {
  float acc = 0.0f;
  for (int o = lo; o < lo + taps; ++o) {
    const int cc = c + o;
    if (cc >= 0 && cc < C) {
      const float v = square ? __fmul_rn(row[cc], row[cc]) : row[cc];
      acc = __fadd_rn(acc, v);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
               float* __restrict__ dx, long long rows, int C,
               int rows_per_block, int lo, int taps, float alpha, float beta,
               float k, float c2) {
  extern __shared__ float smem[];
  float* xs = smem;                                  // rows_per_block * C
  float* ds = smem + (size_t)rows_per_block * C;     // dy, then dy * sb
  float* ts = ds + (size_t)rows_per_block * C;       // t
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long left = rows - r0;
  const int nr = left < rows_per_block ? (int)left : rows_per_block;
  const int len = nr * C;
  const long long base = r0 * C;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    xs[i] = x[base + i];
    ds[i] = dy[base + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int c = i % C;
    const float xv = xs[i];
    const float s = __fadd_rn(k, __fmul_rn(alpha,
                                           window_sum(xs + (i - c), c, C,
                                                      lo, taps, true)));
    const float sb = powf(s, -beta);
    const float d = ds[i];
    ts[i] = __fdiv_rn(__fmul_rn(__fmul_rn(d, xv), sb), s);
    ds[i] = __fmul_rn(d, sb);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int c = i % C;
    const float w = window_sum(ts + (i - c), c, C, lo, taps, false);
    dx[base + i] = __fsub_rn(ds[i], __fmul_rn(__fmul_rn(c2, xs[i]), w));
  }
}

}  // namespace

extern "C" const char* znicz_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// rows = elements / C.  Returns cudaGetLastError().  The caller keeps
// 3 * C * 4 bytes within 48 KB.
extern "C" int znicz_lrn_bwd(const float* x, const float* dy, float* dx,
                             long long rows, int C, int lo, int taps,
                             float alpha, float beta, float k, float c2,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows == 0) return 0;
  if (lo > 0 || taps < 1) return (int)cudaErrorInvalidValue;
  int rows_per_block = kTileFloats / C;
  if (rows_per_block < 1) rows_per_block = 1;
  const size_t smem = (size_t)3 * rows_per_block * C * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  lrn_bwd_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, dy, dx, rows, C, rows_per_block, lo, taps, alpha, beta, k, c2);
  return (int)cudaGetLastError();
}
