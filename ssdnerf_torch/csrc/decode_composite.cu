// Fused triplane decode + packed alpha composite (forward only), for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel ssdnerf_tpu/ops/pallas/decode.py:
// _fwd_kernel_composite (reached through triplane_decode_composite).  Input
// is the cross-ray packed layout of ops/packing.py:pack_groups: groups of GR
// rays share P slots, each ray's samples a contiguous 8-aligned segment that
// starts at soffs[ray].  Per slot it decodes as decode.cu does (4 taps x 3
// planes, the MLP, dir_out[rid]); per ray it writes weights_sum, depth and
// the premultiplied rgb.  Density and colour never reach device memory.
//
// Semantics are those of the port's split path (trunc_exp / sigmoid with
// saturation, then ops/packing.py:composite_packed), not the TPU kernel's:
// the TPU kernel took a group-wide lane cumsum and subtracted a prefix-max
// segment base, a subtraction that perturbs T on saturated scenes (the
// cancellation behind the round-5 soak NaN).  Here each ray's optical depth
// is scanned over its own segment only:
//   tau = valid ? min(exp(sigma_raw) * dt, 60) : 0,
//   T = exp(-(incl - tau)),  w = valid && T >= T_thresh ? (1 - e^-tau) T : 0,
// and w, w t, w r, w g, w b are summed per ray.  Dead slots inside a
// segment (a ray's last block past its valid count, the group's tail) carry
// tau = 0 and w = 0.  A fully truncated ray (soffs == P) gets zeros.
//
// A bf16 instance reads bf16 planes (padded to 4-channel taps) and rounds
// as the Pallas kernel does (triplane.cuh); the composite stays f32.
//
// Bound on the H100: the decode's f32 FMAs (~1.5 k MACs per valid slot);
// the composite adds ~20 flops and two exps per slot.  Design: one block of
// 256 threads per group.  Phase 1, thread = slot (P / 256 slots a thread):
// decode valid slots only, keep tau and the activated rgb in shared memory
// (16 bytes a slot).  Phase 2, warp = ray (GR / 8 rays a warp): walk the
// ray's segment in chunks of 32 slots with a shuffle inclusive scan carried
// across chunks, then reduce the five sums over the warp and write them
// once.  Outputs are 20 bytes a ray instead of 16 bytes a slot.

#include "triplane.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int C, bool kB>
__global__ void __launch_bounds__(kThreads)
triplane_decode_composite_kernel(
    const PlaneT<kB>* __restrict__ planes, const float* __restrict__ xyz,
    const int32_t* __restrict__ rid, const float* __restrict__ dir_out,
    const float* __restrict__ params, const float* __restrict__ pt,
    const float* __restrict__ pdt, const uint8_t* __restrict__ pvalid,
    const int32_t* __restrict__ soffs, float* __restrict__ weights_sum,
    float* __restrict__ depth, float* __restrict__ image, int G, int P,
    int GR, int res, int hidden, float scale, float sat, float T_thresh) {
  constexpr int F = 3 * C;
  extern __shared__ float smem[];
  const int n_params = hidden * F + 5 * hidden + 4;
  float* w = smem;
  float* s_tau = w + n_params;   // (P) optical depth of each slot
  float* s_rgb = s_tau + P;      // (P, 3) activated colour
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_rgb + 3 * P);  // (P)
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) w[i] = params[i];
  __syncthreads();

  const int g = blockIdx.x, s = blockIdx.y;
  const int n_rays = G * GR;
  const size_t base = ((size_t)s * G + g) * P;  // first slot of the group
  constexpr int CS = kB ? padded_channels<C>() : C;
  const PlaneT<kB>* planes_s = planes + (size_t)s * 3 * res * res * CS;

  // ---- phase 1: thread = slot ----
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const size_t si = base + i;
    const bool valid = pvalid[si] != 0;
    float tau = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
    if (valid) {
      float feat[F];
      sample_features<C, false, kB>(planes_s, xyz[si * 3 + 0],
                                    xyz[si * 3 + 1], xyz[si * 3 + 2], res,
                                    feat);
      float out[4];
      mlp_forward<C, kB>(w, hidden, feat,
                     dir_out + ((size_t)s * n_rays + rid[si]) * hidden, out);
      tau = fminf(expf(out[0]) * pdt[si], 60.0f);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rgb[k] = 1.0f / (1.0f + expf(-out[1 + k])) * scale - sat;
    }
    s_tau[i] = tau;
#pragma unroll
    for (int k = 0; k < 3; ++k) s_rgb[i * 3 + k] = rgb[k];
    s_valid[i] = valid;
  }
  __syncthreads();

  // ---- phase 2: warp = ray ----
  const int lane = threadIdx.x & 31;
  const int32_t* so = soffs + ((size_t)s * G + g) * GR;
  for (int r = threadIdx.x >> 5; r < GR; r += blockDim.x >> 5) {
    const int start = so[r];
    const int end = r + 1 < GR ? so[r + 1] : P;
    float carry = 0.0f;
    float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int c0 = start; c0 < end; c0 += 32) {
      const int i = c0 + lane;
      const bool in = i < end;
      const float tau = in ? s_tau[i] : 0.0f;
      float incl = tau;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      incl += carry;
      carry = __shfl_sync(kFull, incl, 31);
      if (in && s_valid[i]) {
        const float T = expf(-(incl - tau));
        if (T >= T_thresh) {
          const float wgt = (1.0f - expf(-tau)) * T;
          acc[0] += wgt;
          acc[1] += wgt * pt[base + i];
#pragma unroll
          for (int k = 0; k < 3; ++k) acc[2 + k] += wgt * s_rgb[i * 3 + k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    }
    if (lane == 0) {
      const size_t ray = (size_t)s * n_rays + (size_t)g * GR + r;
      weights_sum[ray] = acc[0];
      depth[ray] = acc[1];
#pragma unroll
      for (int k = 0; k < 3; ++k) image[ray * 3 + k] = acc[2 + k];
    }
  }
}

template <int C, bool kB>
int launch(const void* planes, const void* xyz, const void* rid,
           const void* dir_out, const void* params, const void* pt,
           const void* pdt, const void* pvalid, const void* soffs,
           void* weights_sum, void* depth, void* image, int S, int G, int P,
           int GR, int res, int hidden, float scale, float sat,
           float T_thresh, cudaStream_t stream) {
  const int smem = (hidden * 3 * C + 5 * hidden + 4 + 4 * P) *
                       (int)sizeof(float) + P;
  auto kernel = triplane_decode_composite_kernel<C, kB>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(G, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const PlaneT<kB>*>(planes), static_cast<const float*>(xyz),
      static_cast<const int32_t*>(rid), static_cast<const float*>(dir_out),
      static_cast<const float*>(params), static_cast<const float*>(pt),
      static_cast<const float*>(pdt), static_cast<const uint8_t*>(pvalid),
      static_cast<const int32_t*>(soffs), static_cast<float*>(weights_sum),
      static_cast<float*>(depth), static_cast<float*>(image), G, P, GR, res,
      hidden, scale, sat, T_thresh);
  return (int)cudaGetLastError();
}

}  // namespace

// planes: (S, 3, res, res, C) f32 channels-last, or with bf16 != 0 bf16
// with C padded to a multiple of 4; xyz: (S, G * P, 3) f32;
// rid: (S, G * P) int32 ray ids into dir_out (S, G * GR, hidden) f32;
// params: the packed MLP block; pt, pdt: (S, G, P) f32 slot t and dt;
// pvalid: (S, G, P) uint8 (bool); soffs: (S, G, GR) int32 segment starts
// (8-aligned, non-decreasing, P for fully truncated rays).  Outputs
// weights_sum, depth: (S, G * GR) f32; image: (S, G * GR, 3) f32.
// scale, sat: the colour head's saturation, rgb = sigmoid * scale - sat.
// Returns cudaErrorInvalidValue for a channel count without an instance.
extern "C" int triplane_decode_composite(
    const void* planes, const void* xyz, const void* rid, const void* dir_out,
    const void* params, const void* pt, const void* pdt, const void* pvalid,
    const void* soffs, void* weights_sum, void* depth, void* image, int S,
    int G, int P, int GR, int res, int C, int hidden, int bf16, float scale,
    float sat, float T_thresh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto c, auto b) {
    return launch<decltype(c)::value, decltype(b)::value>(
        planes, xyz, rid, dir_out, params, pt, pdt, pvalid, soffs,
        weights_sum, depth, image, S, G, P, GR, res, hidden, scale, sat,
        T_thresh, st);
  };
  return with_channels(C, bf16, run);
}
