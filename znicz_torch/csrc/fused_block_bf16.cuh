// The bf16 operand variants of K1 and K1b share this header.  The simple
// kernels (for the shapes the ring kernels do not take) share this
// arithmetic: bf16
// loads widened to float32, then the float32 plain version's operations
// in its order (fused_block.fused_block_plain, fused_block_bwd_plain),
// each rounded on its own, so nvcc contracts nothing into an FMA:
//   a = x + b;  r = max(a, 0);  s = k + alpha * W_n(r*r);  y = r * s^-beta
// W_n takes its first offset alone, then adds the others left to right,
// zero past the channel ends; s^-0.75 is q * sqrtf(q), q = rsqrtf(s),
// powf otherwise, as PyTorch computes them on the card.  The results are
// rounded to bf16 once, at the store, with __float2bfloat16_rn (round to
// nearest even, as PyTorch's and XLA's converts round).
//
// The TPU kernels they replace (znicz_tpu/pallas_fused_block.py _fwd_kernel
// :112 and _bwd_kernel :125) do the same: they load bf16 operands, compute
// in float32 and write out / dx in the operand dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bf16k {

struct Shape {
  int B, H, W, C, OH, OW, n, ky, kx, sy, sx, rsqrt_form;
  float alpha, beta, k, c2;
};

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float relu_bias(float v, float b) {
  return fmaxf(__fadd_rn(v, b), 0.0f);
}

__device__ __forceinline__ float inv_pow(float s, const Shape& p) {
  if (p.rsqrt_form) {
    const float q = rsqrtf(s);  // as PyTorch's rsqrt computes it on the card
    return __fmul_rn(q, sqrtf(q));
  }
  return powf(s, -p.beta);
}

// r, s and s^-beta of channel c of the NHWC pixel `pix` (C bf16 values).
__device__ __forceinline__ void lrn_at(const __nv_bfloat16* pix,
                                       const __nv_bfloat16* __restrict__ bias,
                                       int c, const Shape& p, float& r,
                                       float& s, float& sb) {
  const int lo = -(p.n / 2);
  float acc = 0.0f;
  for (int o = 0; o < p.n; ++o) {
    const int cc = c + lo + o;
    float sq = 0.0f;
    if (cc >= 0 && cc < p.C) {
      const float v = relu_bias(ld(pix + cc), ld(bias + cc));
      sq = __fmul_rn(v, v);
    }
    acc = o == 0 ? sq : __fadd_rn(acc, sq);
  }
  r = relu_bias(ld(pix + c), ld(bias + c));
  s = __fadd_rn(p.k, __fmul_rn(p.alpha, acc));
  sb = inv_pow(s, p);
}

__device__ __forceinline__ float y_at(const __nv_bfloat16* pix,
                                      const __nv_bfloat16* __restrict__ bias,
                                      int c, const Shape& p) {
  float r, s, sb;
  lrn_at(pix, bias, c, p, r, s, sb);
  return __fmul_rn(r, sb);
}

// The ring kernels (K1, K1b) on float or bf16 rows: channel group q (4
// channels) of a row, widened to float32 by one 16- or 8-byte load (ld4
// from shared or global memory, ldg4 from global memory through the
// read-only path); group or channel i of `out` stored, float32 as it is,
// bf16 rounded to nearest even once, 8 bytes for a group.
__device__ __forceinline__ float4 widen4(uint2 u) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const float* p, int q) {
  return reinterpret_cast<const float4*>(p)[q];
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p, int q) {
  return widen4(reinterpret_cast<const uint2*>(p)[q]);
}
__device__ __forceinline__ float4 ldg4(const float* p, long long q) {
  return __ldg(reinterpret_cast<const float4*>(p) + q);
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p, long long q) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(p) + q));
}
__device__ __forceinline__ void put(float* out, long long i, float4 v) {
  reinterpret_cast<float4*>(out)[i] = v;
}
__device__ __forceinline__ void put(float* out, long long i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void put(__nv_bfloat16* out, long long i,
                                    float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  reinterpret_cast<uint2*>(out)[i] = u;
}

constexpr int kMaxWindow = 16;   // window inputs window_max keeps

// The max of pooled window (b, oy, ox) in channel c, over its ky x kx
// inputs taken i outer, j inner; with `nt`, the number of inputs equal to
// it, added in the same order (the plain version's tie count).  Windows of
// more than kMaxWindow inputs compute each input's y twice.
__device__ __forceinline__ float window_max(
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ bias, int b, int oy, int ox, int c,
    const Shape& p, float* nt) {
  float ys[kMaxWindow];
  const bool keep = p.ky * p.kx <= kMaxWindow;
  float m = 0.0f;
  for (int i = 0, e = 0; i < p.ky; ++i) {
    const long long row = ((long long)b * p.H + oy * p.sy + i) * p.W;
    for (int j = 0; j < p.kx; ++j, ++e) {
      const float y = y_at(x + (row + ox * p.sx + j) * p.C, bias, c, p);
      if (keep) ys[e] = y;
      m = e == 0 ? y : fmaxf(m, y);
    }
  }
  if (nt != nullptr) {
    float cnt = 0.0f;
    for (int i = 0, e = 0; i < p.ky; ++i) {
      const long long row = ((long long)b * p.H + oy * p.sy + i) * p.W;
      for (int j = 0; j < p.kx; ++j, ++e) {
        const float y = keep ? ys[e]
                             : y_at(x + (row + ox * p.sx + j) * p.C, bias, c,
                                    p);
        const float mk = y == m ? 1.0f : 0.0f;
        cnt = e == 0 ? mk : __fadd_rn(cnt, mk);
      }
    }
    *nt = cnt;
  }
  return m;
}

}  // namespace bf16k
