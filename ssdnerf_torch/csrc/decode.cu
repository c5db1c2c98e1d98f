// Triplane decode forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel ssdnerf_tpu/ops/pallas/decode.py:_fwd_kernel
// (reached through triplane_decode -> _fwd).  Per sample: bilinear samples
// of the three planes (xy, xz, yz), border-clamped, align_corners=False;
// 3C features in column order c * 3 + p; base Linear 3C -> hidden; density
// head hidden -> 1 on SiLU(base); colour head hidden -> 3 on
// SiLU(base + dir_out[ray]).  Outputs are raw (before trunc_exp / sigmoid).
// A density-only mode (dir_out == rgb == nullptr) skips the colour head.
//
// The TPU kernel expressed the taps as hat-function matmuls and rounded
// planes to bf16 for the MXU; here each tap is a direct read and everything
// is f32.
//
// Bound on the H100: memory latency of the 12 tap reads per sample (4 taps
// x 3 planes, C contiguous floats each from the channels-last planes), and
// then FMA throughput of the ~(3C + 5) * hidden MACs.  One thread per
// sample; the MLP weights (about 6 KB) sit in shared memory and are read as
// warp-wide broadcasts; features stay in registers (C is a template
// parameter, so every feature loop unrolls).  A scene's planes are 1.2 MB
// in f32, so all scenes of a batch stay resident in the 50 MB L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <int C>
__global__ void __launch_bounds__(kThreads)
triplane_decode_kernel(const float* __restrict__ planes,
                       const float* __restrict__ xyz,
                       const int32_t* __restrict__ rid,
                       const float* __restrict__ dir_out,
                       const float* __restrict__ params,
                       float* __restrict__ sigma, float* __restrict__ rgb,
                       int M, int n_rays, int res, int hidden) {
  constexpr int F = 3 * C;
  extern __shared__ float w[];
  const int n_params = hidden * F + 5 * hidden + 4;
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) w[i] = params[i];
  __syncthreads();
  // parameter block layout (see ops/kernels/decode.py:_pack_params)
  const float* wb = w;                    // (hidden, F)
  const float* bb = wb + hidden * F;      // (hidden,)
  const float* wd = bb + hidden;          // (hidden,)
  const float* wc = wd + hidden;          // (3, hidden)
  const float* bd_bc = wc + 3 * hidden;   // [bd, bc0, bc1, bc2]

  const int s = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const size_t si = (size_t)s * M + i;
  const float x = xyz[si * 3 + 0];
  const float y = xyz[si * 3 + 1];
  const float z = xyz[si * 3 + 2];

  float feat[F];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    // plane p: (u, v) = (x, y), (x, z), (y, z); u indexes W, v indexes H
    const float cu = p < 2 ? x : y;
    const float cv = p == 0 ? y : z;
    int u0, u1, v0, v1;
    float wu, wv;
    pixel(cu, res, u0, u1, wu);
    pixel(cv, res, v0, v1, wv);
    const float* P = planes + (size_t)(s * 3 + p) * res * res * C;
    const float* p00 = P + ((size_t)v0 * res + u0) * C;
    const float* p01 = P + ((size_t)v0 * res + u1) * C;
    const float* p10 = P + ((size_t)v1 * res + u0) * C;
    const float* p11 = P + ((size_t)v1 * res + u1) * C;
    const float au = 1.0f - wu, av = 1.0f - wv;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      feat[c * 3 + p] = av * (au * p00[c] + wu * p01[c]) +
                        wv * (au * p10[c] + wu * p11[c]);
    }
  }

  const bool colour = rgb != nullptr;
  const float* dir = colour ? dir_out + ((size_t)s * n_rays + rid[si]) * hidden
                            : nullptr;
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
  sigma[si] = sig;
  if (colour) {
    rgb[si * 3 + 0] = r;
    rgb[si * 3 + 1] = g;
    rgb[si * 3 + 2] = b;
  }
}

template <int C>
int launch(const void* planes, const void* xyz, const void* rid,
           const void* dir_out, const void* params, void* sigma, void* rgb,
           int S, int M, int n_rays, int res, int hidden,
           cudaStream_t stream) {
  const int smem = (hidden * 3 * C + 5 * hidden + 4) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        triplane_decode_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((M + kThreads - 1) / kThreads, S);
  triplane_decode_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(planes), static_cast<const float*>(xyz),
      static_cast<const int32_t*>(rid), static_cast<const float*>(dir_out),
      static_cast<const float*>(params), static_cast<float*>(sigma),
      static_cast<float*>(rgb), M, n_rays, res, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// planes: (S, 3, res, res, C) f32 channels-last; xyz: (S, M, 3) f32;
// rid: (S, M) int32 ray ids into dir_out (S, n_rays, hidden) f32, both
// nullptr in density-only mode (then rgb is nullptr too); params: the
// packed MLP block; sigma: (S, M) f32; rgb: (S, M, 3) f32.
// Returns cudaErrorInvalidValue for a channel count without an instance.
extern "C" int triplane_decode(const void* planes, const void* xyz,
                               const void* rid, const void* dir_out,
                               const void* params, void* sigma, void* rgb,
                               int S, int M, int n_rays, int res, int C,
                               int hidden, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 4:
      return launch<4>(planes, xyz, rid, dir_out, params, sigma, rgb, S, M,
                       n_rays, res, hidden, st);
    case 6:
      return launch<6>(planes, xyz, rid, dir_out, params, sigma, rgb, S, M,
                       n_rays, res, hidden, st);
    case 8:
      return launch<8>(planes, xyz, rid, dir_out, params, sigma, rgb, S, M,
                       n_rays, res, hidden, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
