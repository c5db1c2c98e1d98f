// Triplane decode forward and backward, for Hopper (sm_90a).
//
// Forward: replaces the Pallas kernel ssdnerf_tpu/ops/pallas/decode.py:
// _fwd_kernel (reached through triplane_decode -> _fwd).  Per sample:
// bilinear samples of the three planes (xy, xz, yz), border-clamped,
// align_corners=False; 3C features in column order c * 3 + p; base Linear
// 3C -> hidden; density head hidden -> 1 on SiLU(base); colour head
// hidden -> 3 on SiLU(base + dir_out[ray]).  Outputs are raw (before
// trunc_exp / sigmoid).  A density-only mode (dir_out == rgb == nullptr)
// skips the colour head.
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
//
// Backward: replaces ssdnerf_tpu/ops/pallas/decode.py:_bwd_kernel (reached
// through triplane_decode -> _bwd).  From the upstream gradients of raw
// sigma and raw rgb it forms the gradients of the planes, of the per-ray
// dir_out rows and of the whole parameter block; positions get none.  The
// TPU kernel read a bf16 feature residual saved by the forward because its
// hat matmuls were expensive; here the 4-tap recompute is cheap, so the
// forward saves nothing.  A block of 256 threads walks tiles of 256
// samples of one scene in three phases:
//   1. thread = sample: recompute the features and the hidden-wide base
//      pre-activation; stage both, the upstream gradients and the ray id in
//      shared memory;
//   2. thread = (hidden unit h, quarter of the tile): d_base = W_d^T g_sigma
//      silu'(base) + W_c^T g_rgb silu'(base + dir); accumulate the weight
//      and bias gradients of unit h in registers across all the block's
//      tiles; sum d_dir over runs of samples with the same ray and add each
//      run once (atomicAdd, coalesced over h); d_base replaces base in
//      shared memory;
//   3. thread = sample: d_feat = W_b^T d_base, scattered through the 4 taps
//      x 3 planes into the (S, 3, res, res, C) plane gradient with float2
//      atomicAdds.
// At the end the block adds its parameter-gradient partials once
// (atomicAdd).  All atomics are f32 sums in a run-dependent order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBwdTile = 256;  // samples per tile = threads per block

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
template <int C>
__device__ __forceinline__ void sample_features(
    const float* __restrict__ planes_s, float x, float y, float z, int res,
    float* feat) {
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
    const float au = 1.0f - wu, av = 1.0f - wv;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      feat[c * 3 + p] = av * (au * p00[c] + wu * p01[c]) +
                        wv * (au * p10[c] + wu * p11[c]);
    }
  }
}

// Adjoint of sample_features: adds d_feat through the 4 taps of each plane
// into one scene's (3, res, res, C) gradient.  C is even, so each tap's C
// channels go as C / 2 float2 atomics (8-byte aligned: tap offsets are
// multiples of C floats).
template <int C>
__device__ __forceinline__ void scatter_features(float* dplanes_s, float x,
                                                 float y, float z, int res,
                                                 const float* dfeat) {
  static_assert(C % 2 == 0, "float2 atomics need an even channel count");
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float cu, cv;
    plane_uv(p, x, y, z, cu, cv);
    int u0, u1, v0, v1;
    float wu, wv;
    pixel(cu, res, u0, u1, wu);
    pixel(cv, res, v0, v1, wv);
    float* P = dplanes_s + (size_t)p * res * res * C;
    const float au = 1.0f - wu, av = 1.0f - wv;
    float* taps[4] = {P + ((size_t)v0 * res + u0) * C,
                      P + ((size_t)v0 * res + u1) * C,
                      P + ((size_t)v1 * res + u0) * C,
                      P + ((size_t)v1 * res + u1) * C};
    const float tw[4] = {av * au, av * wu, wv * au, wv * wu};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int c = 0; c < C; c += 2) {
        atomicAdd(reinterpret_cast<float2*>(taps[t] + c),
                  make_float2(tw[t] * dfeat[c * 3 + p],
                              tw[t] * dfeat[(c + 1) * 3 + p]));
      }
    }
  }
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
  // parameter block layout (see ops/kernels/decode.py:pack_params)
  const float* wb = w;                    // (hidden, F)
  const float* bb = wb + hidden * F;      // (hidden,)
  const float* wd = bb + hidden;          // (hidden,)
  const float* wc = wd + hidden;          // (3, hidden)
  const float* bd_bc = wc + 3 * hidden;   // [bd, bc0, bc1, bc2]

  const int s = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const size_t si = (size_t)s * M + i;
  float feat[F];
  sample_features<C>(planes + (size_t)s * 3 * res * res * C, xyz[si * 3 + 0],
                     xyz[si * 3 + 1], xyz[si * 3 + 2], res, feat);

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
__host__ __device__ constexpr int bwd_accumulators() {
  return 3 * C + 6;  // W_b row, b_b, W_d, W_c (3), one of [b_d, b_c (3)]
}

template <int C>
int bwd_smem_bytes(int hidden) {
  const int n_params = hidden * 3 * C + 5 * hidden + 4;
  return (n_params + kBwdTile * (hidden + 1) + kBwdTile * (3 * C + 1) +
          kBwdTile * 4) * (int)sizeof(float) + kBwdTile * (int)sizeof(int);
}

// Grid (blocks per scene, S); each block walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of its scene.  hidden must divide kBwdTile and
// be a multiple of 32 (so a warp's threads share one tile quarter in phase
// 2), and 3C + 6 <= hidden + 1 (the final reduction reuses the base tile).
template <int C>
__global__ void __launch_bounds__(kBwdTile)
triplane_decode_bwd_kernel(const float* __restrict__ planes,
                           const float* __restrict__ xyz,
                           const int32_t* __restrict__ rid,
                           const float* __restrict__ dir_out,
                           const float* __restrict__ params,
                           const float* __restrict__ g_sigma,
                           const float* __restrict__ g_rgb,
                           float* __restrict__ d_planes,
                           float* __restrict__ d_dir_out,
                           float* __restrict__ d_params, int M, int n_rays,
                           int res, int hidden) {
  constexpr int F = 3 * C;
  constexpr int FS = F + 1;
  constexpr int NACC = bwd_accumulators<C>();
  extern __shared__ float smem[];
  const int n_params = hidden * F + 5 * hidden + 4;
  const int HS = hidden + 1;
  float* w = smem;
  float* sB = w + n_params;           // (tile, HS): base, then d_base
  float* sF = sB + kBwdTile * HS;     // (tile, FS): features
  float* sG = sF + kBwdTile * FS;     // (tile, 4): g_sigma, g_rgb
  int* sR = reinterpret_cast<int*>(sG + kBwdTile * 4);  // (tile): ray ids
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) w[i] = params[i];
  __syncthreads();
  const float* wb = w;
  const float* bb = wb + hidden * F;
  const float* wd = bb + hidden;
  const float* wc = wd + hidden;

  const bool colour = dir_out != nullptr;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int h = tid % hidden;
  const int part = tid / hidden;
  const size_t plane_size = (size_t)3 * res * res * C;
  const float* planes_s = planes + s * plane_size;
  float* dplanes_s = d_planes + s * plane_size;
  const float w_d = wd[h];
  const float w_c0 = wc[h], w_c1 = wc[hidden + h], w_c2 = wc[2 * hidden + h];

  float acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = 0.0f;

  const int n_tiles = (M + kBwdTile - 1) / kBwdTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // ---- phase 1: thread = sample ----
    const int i = tile * kBwdTile + tid;
    const bool valid = i < M;
    const size_t si = (size_t)s * M + (valid ? i : 0);
    float x = 0.0f, y = 0.0f, z = 0.0f;
    float feat[F];
    if (valid) {
      x = xyz[si * 3 + 0];
      y = xyz[si * 3 + 1];
      z = xyz[si * 3 + 2];
      sample_features<C>(planes_s, x, y, z, res, feat);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) feat[f] = 0.0f;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) sF[tid * FS + f] = feat[f];
    for (int hh = 0; hh < hidden; ++hh) {
      float a = bb[hh];
#pragma unroll
      for (int f = 0; f < F; ++f) a += wb[hh * F + f] * feat[f];
      sB[tid * HS + hh] = a;
    }
    sG[tid * 4 + 0] = valid ? g_sigma[si] : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      sG[tid * 4 + 1 + k] = valid && colour ? g_rgb[si * 3 + k] : 0.0f;
    sR[tid] = valid && colour ? rid[si] : 0;
    __syncthreads();

    // ---- phase 2: thread = (unit h, tile part) ----
    const int n_valid = min(kBwdTile, M - tile * kBwdTile);
    const int t_lo = part * hidden;
    const int t_hi = min(t_lo + hidden, n_valid);
    int run_ray = -1;
    float run_d = 0.0f;
    for (int t = t_lo; t < t_hi; ++t) {
      const float b = sB[t * HS + h];
      const float gs = sG[t * 4];
      const float sg = 1.0f / (1.0f + expf(-b));
      acc[F + 1] += gs * b * sg;                        // W_d
      float db = w_d * gs * sg * (1.0f + b * (1.0f - sg));
      if (colour) {
        const int r = sR[t];
        const float c = b + dir_out[((size_t)s * n_rays + r) * hidden + h];
        const float sc = 1.0f / (1.0f + expf(-c));
        const float cx = c * sc;
        const float gr = sG[t * 4 + 1], gg = sG[t * 4 + 2],
                    gb = sG[t * 4 + 3];
        acc[F + 2] += gr * cx;                          // W_c
        acc[F + 3] += gg * cx;
        acc[F + 4] += gb * cx;
        const float dc = (w_c0 * gr + w_c1 * gg + w_c2 * gb) * sc *
                         (1.0f + c * (1.0f - sc));
        if (r != run_ray) {
          if (run_ray >= 0)
            atomicAdd(d_dir_out + ((size_t)s * n_rays + run_ray) * hidden + h,
                      run_d);
          run_ray = r;
          run_d = 0.0f;
        }
        run_d += dc;
        db += dc;
      }
      acc[F] += db;                                     // b_b
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += db * sF[t * FS + f];  // W_b
      if (h < 4) acc[F + 5] += sG[t * 4 + h];           // b_d, b_c
      sB[t * HS + h] = db;
    }
    if (run_ray >= 0)
      atomicAdd(d_dir_out + ((size_t)s * n_rays + run_ray) * hidden + h,
                run_d);
    __syncthreads();

    // ---- phase 3: thread = sample ----
    if (valid) {
      float dfeat[F];
#pragma unroll
      for (int f = 0; f < F; ++f) dfeat[f] = 0.0f;
      for (int hh = 0; hh < hidden; ++hh) {
        const float d = sB[tid * HS + hh];
#pragma unroll
        for (int f = 0; f < F; ++f) dfeat[f] += wb[hh * F + f] * d;
      }
      scatter_features<C>(dplanes_s, x, y, z, res, dfeat);
    }
    __syncthreads();  // the next tile overwrites the staged arrays
  }

  // sum the tile parts of each unit, then one atomicAdd per entry
  float* red = sB;  // (kBwdTile, NACC) <= (kBwdTile, HS)
#pragma unroll
  for (int a = 0; a < NACC; ++a) red[tid * NACC + a] = acc[a];
  __syncthreads();
  if (tid < hidden) {
    const int parts = kBwdTile / hidden;
    float tot[NACC];
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      tot[a] = 0.0f;
      for (int pp = 0; pp < parts; ++pp)
        tot[a] += red[(pp * hidden + tid) * NACC + a];
    }
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(d_params + tid * F + f, tot[f]);
    float* d_bb = d_params + hidden * F;
    atomicAdd(d_bb + tid, tot[F]);
    atomicAdd(d_bb + hidden + tid, tot[F + 1]);
    if (colour) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        atomicAdd(d_bb + (2 + k) * hidden + tid, tot[F + 2 + k]);
    }
    if (tid < 4 && (colour || tid == 0))
      atomicAdd(d_bb + 5 * hidden + tid, tot[F + 5]);
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

template <int C>
int launch_bwd(const void* planes, const void* xyz, const void* rid,
               const void* dir_out, const void* params, const void* g_sigma,
               const void* g_rgb, void* d_planes, void* d_dir_out,
               void* d_params, int S, int M, int n_rays, int res, int hidden,
               cudaStream_t stream) {
  if (hidden % 32 != 0 || kBwdTile % hidden != 0 ||
      bwd_accumulators<C>() > hidden + 1)
    return (int)cudaErrorInvalidValue;
  const int smem = bwd_smem_bytes<C>(hidden);
  cudaError_t err = cudaFuncSetAttribute(
      triplane_decode_bwd_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // about four blocks per SM in all: each block's parameter partials are
  // added once, so fewer, longer-lived blocks mean fewer atomics
  const int n_tiles = (M + kBwdTile - 1) / kBwdTile;
  const int per_scene = min(n_tiles, max(1, (4 * sms + S - 1) / S));
  dim3 grid(per_scene, S);
  triplane_decode_bwd_kernel<C><<<grid, kBwdTile, smem, stream>>>(
      static_cast<const float*>(planes), static_cast<const float*>(xyz),
      static_cast<const int32_t*>(rid), static_cast<const float*>(dir_out),
      static_cast<const float*>(params), static_cast<const float*>(g_sigma),
      static_cast<const float*>(g_rgb), static_cast<float*>(d_planes),
      static_cast<float*>(d_dir_out), static_cast<float*>(d_params), M,
      n_rays, res, hidden);
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

// Inputs as triplane_decode, plus g_sigma (S, M) and g_rgb (S, M, 3) f32,
// the gradients of the raw outputs (g_rgb nullptr in density-only mode).
// Outputs, zero-filled by the caller and accumulated into: d_planes (S, 3,
// res, res, C), d_dir_out (S, n_rays, hidden) (nullptr in density-only
// mode), d_params (the parameter block's size).  Returns
// cudaErrorInvalidValue for a channel count or width without an instance.
extern "C" int triplane_decode_bwd(const void* planes, const void* xyz,
                                   const void* rid, const void* dir_out,
                                   const void* params, const void* g_sigma,
                                   const void* g_rgb, void* d_planes,
                                   void* d_dir_out, void* d_params, int S,
                                   int M, int n_rays, int res, int C,
                                   int hidden, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 4:
      return launch_bwd<4>(planes, xyz, rid, dir_out, params, g_sigma, g_rgb,
                           d_planes, d_dir_out, d_params, S, M, n_rays, res,
                           hidden, st);
    case 6:
      return launch_bwd<6>(planes, xyz, rid, dir_out, params, g_sigma, g_rgb,
                           d_planes, d_dir_out, d_params, S, M, n_rays, res,
                           hidden, st);
    case 8:
      return launch_bwd<8>(planes, xyz, rid, dir_out, params, g_sigma, g_rgb,
                           d_planes, d_dir_out, d_params, S, M, n_rays, res,
                           hidden, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
