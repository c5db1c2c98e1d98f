// Per-point triplane decode helpers shared by the decode kernels
// (decode.cu, decode_composite.cu, decode_banded.cu): the bilinear taps of
// the three channels-last planes and the decoder MLP, in f32 or in the bf16
// operand mode (kB).
//
// The bf16 mode rounds where the Pallas kernels round
// (ssdnerf_tpu/ops/pallas/decode.py:_sample_feats, _fwd_tail): planes are
// bf16, padded to CP = C rounded up to 4 channels (one 8- or 16-byte load
// a tap); the hat weights of the first coordinate of each plane pair (u:
// x for planes xy and xz, y for yz) are rounded to bf16 and the second's
// stay f32; each row's two taps times their bf16 weights are exact in f32,
// their sum rounds once, and the two rows' weighted sum is formed without
// a fused multiply-add (as the plain version computes it); the features,
// dir_out, SiLU(base) and SiLU(base + dir) are rounded to bf16 before
// their products.  The parameter block holds bf16 values for the weights.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// x rounded to bf16 (to nearest, ties to even), as an f32, for finite x:
// three integer operations, where the conversion instruction and the
// shift back took ~10% of the forward kernels' time on the H100.
__device__ __forceinline__ float round_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// Channels a tap of the bf16 planes holds: C padded to a multiple of 4.
template <int C>
__host__ __device__ constexpr int padded_channels() {
  return (C + 3) / 4 * 4;
}

// The plane element type of a mode.
template <bool kB>
using PlaneT = std::conditional_t<kB, __nv_bfloat16, float>;

// The C channels of one tap of bf16 planes (CP of them stored, the tap
// 8- or 16-byte aligned), as f32.
template <int C>
__device__ __forceinline__ void load_tap_bf16(const __nv_bfloat16* p,
                                              float* v) {
  constexpr int CP = padded_channels<C>();
  uint32_t w[CP / 2];
  if constexpr (CP == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  } else {
    static_assert(CP == 4, "4 or 8 stored channels");
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x, w[1] = a.y;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    v[c] = __uint_as_float(c & 1 ? w[c / 2] & 0xffff0000u : w[c / 2] << 16);
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

// The taps and the weight of the second tap of coordinate c along an axis
// of res pixels.  The bf16 mode (kB) forms the pixel coordinate without a
// fused multiply-add, as the plain version rounds each step, since its
// weights are rounded to bf16 after; the f32 mode keeps the contracted form.
template <bool kB = false>
__device__ __forceinline__ void pixel(float c, int res, int& i0, int& i1,
                                      float& w) {
  float f = kB ? __fsub_rn(__fmul_rn(__fadd_rn(c, 1.0f), res * 0.5f), 0.5f)
               : (c + 1.0f) * (res * 0.5f) - 0.5f;
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

// The bf16 mode's features of plane p at one point (module comment):
// feat[c * 3 + p], rounded to bf16.  kWindowed as sample_features.
template <int C, bool kWindowed>
__device__ __forceinline__ void sample_plane_bf16(
    const __nv_bfloat16* __restrict__ P, int u0, int u1, int v0, int v1,
    float wu, float wv, int res, int p, float* feat, int lo, int band_w) {
  constexpr int CP = padded_channels<C>();
  const bool in0 = !kWindowed || (u0 >= lo && u0 < lo + band_w);
  const bool in1 = !kWindowed || (u1 >= lo && u1 < lo + band_w);
  const float au = in0 ? round_bf16(1.0f - wu) : 0.0f;
  const float bu = in1 ? round_bf16(wu) : 0.0f;
  const float av = 1.0f - wv;
  float t[2][2][C];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const __nv_bfloat16* row = P + (size_t)(r ? v1 : v0) * res * CP;
#pragma unroll
    for (int c = 0; c < C; ++c) t[r][0][c] = t[r][1][c] = 0.0f;
    if (in0) load_tap_bf16<C>(row + (size_t)u0 * CP, t[r][0]);
    if (in1) load_tap_bf16<C>(row + (size_t)u1 * CP, t[r][1]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float r0 = au * t[0][0][c] + bu * t[0][1][c];  // exact products
    const float r1 = au * t[1][0][c] + bu * t[1][1][c];
    feat[c * 3 + p] =
        round_bf16(__fadd_rn(__fmul_rn(av, r0), __fmul_rn(wv, r1)));
  }
}

// The 3C bilinear features of one point, column order c * 3 + p.
// planes_s: one scene's (3, res, res, C) channels-last planes (CP channels
// in bf16).  kWindowed: a tap whose u index lies outside the plane's
// window [lo, lo + band_w) (lo = wx for planes xy and xz, wy for plane yz)
// has weight 0 and is not read.
template <int C, bool kWindowed = false, bool kB = false>
__device__ __forceinline__ void sample_features(
    const PlaneT<kB>* __restrict__ planes_s, float x, float y, float z,
    int res, float* feat, int wx = 0, int wy = 0, int band_w = 0) {
  constexpr int CS = kB ? padded_channels<C>() : C;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float cu, cv;
    plane_uv(p, x, y, z, cu, cv);
    int u0, u1, v0, v1;
    float wu, wv;
    pixel<kB>(cu, res, u0, u1, wu);
    pixel<kB>(cv, res, v0, v1, wv);
    if constexpr (kB) {
      sample_plane_bf16<C, kWindowed>(planes_s + (size_t)p * res * res * CS,
                                      u0, u1, v0, v1, wu, wv, res, p, feat,
                                      p < 2 ? wx : wy, band_w);
    } else {
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
}

// The decoder MLP of one point from its 3C features: raw density out[0]
// and, when dir (the ray's dir_out row) is not null, raw colour out[1..3].
// w: the parameter block (see ops/kernels/decode.py:pack_params), in
// shared memory: base weight (hidden, 3C), base bias, density weight,
// colour weight (3, hidden), [density bias, colour bias (3)].  kB rounds
// dir, SiLU(base) and SiLU(base + dir) to bf16 (the features come
// rounded).
template <int C, bool kB = false>
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
    const float bx = silu(a);
    sig += wd[h] * (kB ? round_bf16(bx) : bx);
    if (colour) {
      const float c = silu(a + (kB ? round_bf16(dir[h]) : dir[h]));
      const float cx = kB ? round_bf16(c) : c;
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

// fn(std::integral_constant<int, C>, std::integral_constant<bool, kB>) for
// an instantiated channel count (4, 6, 8) and mode, else
// cudaErrorInvalidValue.
template <typename Fn>
int with_channels(int C, int bf16, Fn fn) {
  auto mode = [&](auto c) {
    return bf16 ? fn(c, std::true_type{}) : fn(c, std::false_type{});
  };
  switch (C) {
    case 4: return mode(std::integral_constant<int, 4>{});
    case 6: return mode(std::integral_constant<int, 6>{});
    case 8: return mode(std::integral_constant<int, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
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
