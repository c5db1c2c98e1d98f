// Per-point triplane decode helpers shared by the decode kernels
// (decode.cu, decode_composite.cu, decode_banded.cu): the bilinear taps of
// the three channels-last planes and the decoder MLP.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ void pixel(float c, int res, int& i0, int& i1,
                                      float& w) {
  float f = (c + 1.0f) * (res * 0.5f) - 0.5f;
  f = fminf(fmaxf(f, 0.0f), res - 1.0f);
  i0 = (int)floorf(f);
  i1 = min(i0 + 1, res - 1);
  w = f - (float)i0;
}

// Plane p samples (u, v) = (x, y), (x, z), (y, z); u indexes W, v indexes H.
__device__ __forceinline__ void plane_uv(int p, float x, float y, float z,
                                         float& cu, float& cv) {
  cu = p < 2 ? x : y;
  cv = p == 0 ? y : z;
}

// The 3C bilinear features of one point, column order c * 3 + p.
// planes_s: one scene's (3, res, res, C) channels-last planes.
// kWindowed: a tap whose u index lies outside the plane's window [lo,
// lo + band_w) (lo = wx for planes xy and xz, wy for plane yz) has weight 0
// and is not read.
template <int C, bool kWindowed = false>
__device__ __forceinline__ void sample_features(
    const float* __restrict__ planes_s, float x, float y, float z, int res,
    float* feat, int wx = 0, int wy = 0, int band_w = 0) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float cu, cv;
    plane_uv(p, x, y, z, cu, cv);
    int u0, u1, v0, v1;
    float wu, wv;
    pixel(cu, res, u0, u1, wu);
    pixel(cv, res, v0, v1, wv);
    const float* P = planes_s + (size_t)p * res * res * C;
    const float* p00 = P + ((size_t)v0 * res + u0) * C;
    const float* p01 = P + ((size_t)v0 * res + u1) * C;
    const float* p10 = P + ((size_t)v1 * res + u0) * C;
    const float* p11 = P + ((size_t)v1 * res + u1) * C;
    if (!kWindowed) {
      const float au = 1.0f - wu, av = 1.0f - wv;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        feat[c * 3 + p] = av * (au * p00[c] + wu * p01[c]) +
                          wv * (au * p10[c] + wu * p11[c]);
      }
    } else {
      const int lo = p < 2 ? wx : wy;
      const bool in0 = u0 >= lo && u0 < lo + band_w;
      const bool in1 = u1 >= lo && u1 < lo + band_w;
      const float au = in0 ? 1.0f - wu : 0.0f, av = 1.0f - wv;
      const float bu = in1 ? wu : 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float t00 = in0 ? p00[c] : 0.0f, t10 = in0 ? p10[c] : 0.0f;
        const float t01 = in1 ? p01[c] : 0.0f, t11 = in1 ? p11[c] : 0.0f;
        feat[c * 3 + p] = av * (au * t00 + bu * t01) +
                          wv * (au * t10 + bu * t11);
      }
    }
  }
}

// The decoder MLP of one point from its 3C features: raw density out[0]
// and, when dir (the ray's dir_out row) is not null, raw colour out[1..3].
// w: the parameter block (see ops/kernels/decode.py:pack_params), in
// shared memory: base weight (hidden, 3C), base bias, density weight,
// colour weight (3, hidden), [density bias, colour bias (3)].
template <int C>
__device__ __forceinline__ void mlp_forward(const float* w, int hidden,
                                            const float* feat,
                                            const float* dir, float* out) {
  constexpr int F = 3 * C;
  const float* wb = w;                    // (hidden, F)
  const float* bb = wb + hidden * F;      // (hidden,)
  const float* wd = bb + hidden;          // (hidden,)
  const float* wc = wd + hidden;          // (3, hidden)
  const float* bd_bc = wc + 3 * hidden;   // [bd, bc0, bc1, bc2]
  const bool colour = dir != nullptr;
  float sig = bd_bc[0];
  float r = bd_bc[1], g = bd_bc[2], b = bd_bc[3];
  for (int h = 0; h < hidden; ++h) {
    float a = bb[h];
#pragma unroll
    for (int f = 0; f < F; ++f) a += wb[h * F + f] * feat[f];
    sig += wd[h] * silu(a);
    if (colour) {
      const float cx = silu(a + dir[h]);
      r += wc[h] * cx;
      g += wc[hidden + h] * cx;
      b += wc[2 * hidden + h] * cx;
    }
  }
  out[0] = sig;
  out[1] = r;
  out[2] = g;
  out[3] = b;
}

// Dynamic shared memory of a launch: raise the block's limit above the
// 48 KB default where needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
