// Banded triplane decode (forward only), for Hopper (sm_90a).
//
// Replaces the Pallas kernel ssdnerf_tpu/ops/pallas/decode.py:
// _fwd_kernel_banded (reached through triplane_decode_banded).  Its input
// is the band layout of ops/packing.py:pack_groups_banded, in which each
// 128-slot tile of samples lies in a narrow band of the plane axes, and one
// packed window start per tile, win = wx | (wy << 8) (banded_windows).  It
// computes the decode of decode.cu with every tap whose u index (the W
// axis of the channels-last planes: x for planes xy and xz, y for plane yz)
// lies outside [w, w + band_w) given weight 0.  Where the caller's guard
// holds (every tap of every valid sample inside its tile's window), that is
// exactly the full decode.  Outputs are raw sigma and rgb in the band
// layout; the caller routes them back to the ray layout.
//
// The TPU kernel contracted hat-function matmuls against a band_w-row
// slice of the transposed plane, halving its MXU work.  A 4-tap gather has
// no hat contraction to window, so on Hopper the banding buys locality:
// the 128 threads of a tile read a band_w x res strip of each plane, which
// stays in L1 through the read-only path, where the split decode's
// scattered slots miss.  Staging the strip in shared memory does not fit
// in f32: 64 u rows x 128 v rows x C=6 channels is 196 KB for one plane,
// three planes 590 KB, against 227 KB a block; a staged (bf16, or narrower
// v range) design is later work.
//
// A bf16 instance reads bf16 planes (padded to 4-channel taps) and rounds
// as the Pallas kernel does (triplane.cuh): the windowed hat it rounds is
// the u axis's, the one the TPU kernel's window cuts.
//
// Bound on the H100: the decode's f32 FMAs (~1.5 k MACs a slot), as for
// decode.cu.  One thread per slot, 256-thread blocks (two tiles), MLP
// weights in shared memory.

#include "triplane.cuh"

namespace {

constexpr int kThreads = 256;

template <int C, bool kB>
__global__ void __launch_bounds__(kThreads)
triplane_decode_banded_kernel(const PlaneT<kB>* __restrict__ planes,
                              const float* __restrict__ xyz,
                              const int32_t* __restrict__ rid,
                              const float* __restrict__ dir_out,
                              const float* __restrict__ params,
                              const int32_t* __restrict__ win,
                              float* __restrict__ sigma,
                              float* __restrict__ rgb, int M, int n_rays,
                              int res, int hidden, int tile, int band_w) {
  constexpr int F = 3 * C;
  extern __shared__ float w[];
  const int n_params = hidden * F + 5 * hidden + 4;
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) w[i] = params[i];
  __syncthreads();

  const int s = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const size_t si = (size_t)s * M + i;
  const int wv = win[(size_t)s * (M / tile) + i / tile];
  constexpr int CS = kB ? padded_channels<C>() : C;
  float feat[F];
  sample_features<C, true, kB>(planes + (size_t)s * 3 * res * res * CS,
                               xyz[si * 3 + 0], xyz[si * 3 + 1],
                               xyz[si * 3 + 2], res, feat, wv & 0xFF,
                               wv >> 8, band_w);
  float out[4];
  mlp_forward<C, kB>(w, hidden, feat,
                 dir_out + ((size_t)s * n_rays + rid[si]) * hidden, out);
  sigma[si] = out[0];
  rgb[si * 3 + 0] = out[1];
  rgb[si * 3 + 1] = out[2];
  rgb[si * 3 + 2] = out[3];
}

template <int C, bool kB>
int launch(const void* planes, const void* xyz, const void* rid,
           const void* dir_out, const void* params, const void* win,
           void* sigma, void* rgb, int S, int M, int n_rays, int res,
           int hidden, int tile, int band_w, cudaStream_t stream) {
  const int smem = (hidden * 3 * C + 5 * hidden + 4) * (int)sizeof(float);
  auto kernel = triplane_decode_banded_kernel<C, kB>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kThreads - 1) / kThreads, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const PlaneT<kB>*>(planes), static_cast<const float*>(xyz),
      static_cast<const int32_t*>(rid), static_cast<const float*>(dir_out),
      static_cast<const float*>(params), static_cast<const int32_t*>(win),
      static_cast<float*>(sigma), static_cast<float*>(rgb), M, n_rays, res,
      hidden, tile, band_w);
  return (int)cudaGetLastError();
}

}  // namespace

// planes: (S, 3, res, res, C) f32 channels-last, or with bf16 != 0 bf16
// with C padded to a multiple of 4; xyz: (S, M, 3) f32 in the
// band layout; rid: (S, M) int32 ray ids into dir_out (S, n_rays, hidden)
// f32; params: the packed MLP block; win: (S, M / tile) int32 packed
// window starts wx | (wy << 8) of each tile of `tile` slots.  Outputs
// sigma: (S, M) f32; rgb: (S, M, 3) f32, raw.  M must be a multiple of
// tile.  Returns cudaErrorInvalidValue for a channel count without an
// instance.
extern "C" int triplane_decode_banded(const void* planes, const void* xyz,
                                      const void* rid, const void* dir_out,
                                      const void* params, const void* win,
                                      void* sigma, void* rgb, int S, int M,
                                      int n_rays, int res, int C, int hidden,
                                      int tile, int band_w, int bf16,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto c, auto b) {
    return launch<decltype(c)::value, decltype(b)::value>(
        planes, xyz, rid, dir_out, params, win, sigma, rgb, S, M, n_rays,
        res, hidden, tile, band_w, st);
  };
  return with_channels(C, bf16, run);
}
