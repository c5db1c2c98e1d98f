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
// exactly the full decode.  It decodes every slot, valid or not, as the
// TPU kernel does.  Outputs are raw sigma and rgb in the band layout; the
// caller routes them back to the ray layout.
//
// The TPU kernel contracted hat-function matmuls against a band_w-row
// slice of the transposed plane, halving its MXU work.  A 4-tap gather has
// no hat contraction to window, so on Hopper the banding buys locality:
// the threads of a tile read a band_w x res strip of each plane, which
// stays in L1 through the read-only path, where the split decode's
// scattered slots miss.
//
// What bounds it on the H100: the work of the split forward (decode.cu),
// whose bottleneck it shares: the SFU's sigmoids and the elementwise
// instructions of the heads, then the tap reads.  The first design here
// (one thread a slot, the MLP as f32 FMA loops over weights in shared
// memory, exact expf and division in SiLU) took 1.5-1.8x the split
// forward's time on as many slots (PERF.md).  So the kernel is the split
// forward's warp tiles (decode_fwd.cuh, kWindowed): persistent blocks, the
// base product on the tensor cores, the heads from the accumulator
// fragments by quad shuffles, SFU sigmoids.  A 32-sample warp tile lies
// inside one band tile, so the window is one value a warp tile.  In f32 a
// plane row is read as one run of two taps, or, where the window edge
// falls between them, as the inside tap alone; in the bf16 mode
// triplane.cuh's windowed taps (the windowed hat the bf16 mode rounds is
// the u axis's, the one the TPU kernel's window cuts).

#include "decode_fwd.cuh"

namespace {

template <int C, int H, bool kB>
__global__ void __launch_bounds__(kThreads)
triplane_decode_banded_kernel(const PlaneT<kB>* __restrict__ planes,
                              const float* __restrict__ xyz,
                              const int32_t* __restrict__ rid,
                              const float* __restrict__ dir_out,
                              const float* __restrict__ params,
                              const int32_t* __restrict__ win,
                              float* __restrict__ sigma,
                              float* __restrict__ rgb, int S, int M,
                              int n_rays, int res, int tile, int band_w) {
  extern __shared__ uint4 smem[];
  decode_forward<C, H, kB, true>(smem, planes, xyz, rid, dir_out, params,
                                 win, sigma, rgb, S, M, n_rays, res, tile,
                                 band_w);
}

}  // namespace

// planes: (S, 3, res, res, C) f32 channels-last, or with bf16 != 0 bf16
// with C padded to a multiple of 4; xyz: (S, M, 3) f32 in the
// band layout; rid: (S, M) int32 ray ids into dir_out (S, n_rays, hidden)
// f32; params: the packed MLP block; win: (S, M / tile) int32 packed
// window starts wx | (wy << 8) of each tile of `tile` slots.  Outputs
// sigma: (S, M) f32; rgb: (S, M, 3) f32, raw.  M must be a multiple of
// tile, and tile of 32.  Returns cudaErrorInvalidValue for a (C, hidden)
// without an instance (C in {4, 6, 8}, hidden in {32, 64, 128}).
extern "C" int triplane_decode_banded(const void* planes, const void* xyz,
                                      const void* rid, const void* dir_out,
                                      const void* params, const void* win,
                                      void* sigma, void* rgb, int S, int M,
                                      int n_rays, int res, int C, int hidden,
                                      int tile, int band_w, int bf16,
                                      void* stream) {
  if (tile <= 0 || tile % 32 != 0 || M % tile != 0)
    return (int)cudaErrorInvalidValue;
  return with_shape(C, hidden, bf16, [&](auto shape) {
    using Sh = decltype(shape);
    return launch_persistent(
        triplane_decode_banded_kernel<Sh::C, Sh::H, Sh::kB>,
        FwdSmem<Sh::C, Sh::H>::kBytes, S * ((M + kTile - 1) / kTile), stream,
        static_cast<const PlaneT<Sh::kB>*>(planes),
        static_cast<const float*>(xyz), static_cast<const int32_t*>(rid),
        static_cast<const float*>(dir_out), static_cast<const float*>(params),
        static_cast<const int32_t*>(win), static_cast<float*>(sigma),
        static_cast<float*>(rgb), S, M, n_rays, res, tile, band_w);
  });
}
