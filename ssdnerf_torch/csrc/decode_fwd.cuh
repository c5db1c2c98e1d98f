// The triplane decode forward's warp-tile machinery, shared by the split
// forward (decode.cu: triplane_decode), the banded decode
// (decode_banded.cu), which is the split forward with its taps windowed,
// and the fused decode + composite (decode_composite.cu), which runs it on
// the compacted valid slots of each packed group.  decode.cu's header
// says what bounds the decode on the H100 and why the design is this one.
//
// Feature tiles.  Thread = sample: the taps' 3C features go into a shared
// tile whose rows are padded with zero columns to FP, a multiple of 8; the
// row stride FS = FP + 4 keeps every fragment load free of bank conflicts.
//
// Warp = 32 samples: the warp stages its samples' features, split into hi
// / lo, in its own rows (so warps never wait for each other and one warp's
// tap reads overlap another's products); base = F W_b^T (K = FP, N =
// hidden) on the tensor cores (mma_tf32.cuh: three TF32 passes in f32, one
// in the bf16 mode) with W_b's fragments from shared memory (one 16-byte
// load a lane for the three passes of an 8x8 block); then the density and
// colour heads from the accumulator fragments: each lane holds 2 rows x 2
// columns of every 8-column tile, adds the bias, the row's dir_out values
// and SiLU (the SFU's ex2 and rcp), and the dot products over hidden end
// in a quad shuffle sum.
#pragma once

#include "mma_tf32.cuh"
#include "triplane.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kThreads;  // samples a tile: one a thread
constexpr int kMT = kTile / 16;  // m tiles a tile

// The feature tile of C channels: F = 3C features, padded to FP, rows FS
// floats apart (FS = 4 mod 8: the A fragment's gr * FS + t and, with the
// sample order of the dW_b product, its B fragment's 2t * FS + gr and
// (2t + 1) * FS + gr fall in distinct banks).
template <int C>
struct Feat {
  static constexpr int F = 3 * C;
  static constexpr int FP = (F + 7) / 8 * 8;
  static constexpr int FS = FP + 4;
  static constexpr int KF = FP / 8;
};

// 1 / (1 + 2^(-x log2 e)) by the SFU's ex2 and rcp (relative errors of
// about 2^-22 each; denormals flush to zero, so the result is 0 or 1 where
// the exponential under- or overflows).
__device__ __forceinline__ float sigmoid_fast(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * -1.44269504f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return r;
}

// x as a TF32 operand pair: split into hi / lo, or for a bf16 value (kB)
// itself, exactly, with lo unused.
template <bool kB>
__device__ __forceinline__ void operand(float x, uint32_t& hi,
                                        uint32_t& lo) {
  if constexpr (kB) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split(x, hi, lo);
  }
}

// Visits the N (even) contiguous floats at p (8-byte aligned) in 16-byte
// pieces where aligned and 8-byte ones for the rest: f4(k) for the piece
// of 4 floats at offset k, f2(k) for one of 2.  The taps' reads and the
// plane-gradient atomics are limited by their count a sample (each is one
// L1 wavefront a lane for scattered lanes), so wider pieces are fewer.
template <int N, typename F4, typename F2>
__device__ __forceinline__ void for_run(const float* p, F4 f4, F2 f2) {
  static_assert(N % 2 == 0, "runs of whole float2s");
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int k = 0; k + 4 <= N; k += 4) f4(k);
    if constexpr (N % 4 != 0) f2(N - 2);
  } else {
    f2(0);
#pragma unroll
    for (int k = 2; k + 4 <= N; k += 4) f4(k);
    if constexpr (N % 4 == 0) f2(N - 2);
  }
}

template <int N>
__device__ __forceinline__ void load_run(const float* p, float* v) {
  auto ld2 = [&](int c) {
    const float2 a = *reinterpret_cast<const float2*>(p + c);
    v[c] = a.x;
    v[c + 1] = a.y;
  };
  auto ld4 = [&](int c) {
    const float4 a = *reinterpret_cast<const float4*>(p + c);
    v[c] = a.x;
    v[c + 1] = a.y;
    v[c + 2] = a.z;
    v[c + 3] = a.w;
  };
  for_run<N>(p, ld4, ld2);
}

// The f32 mode's 3C bilinear features of one point, column order c * 3 +
// p (planes_s: one scene's (3, res, res, C) channels-last planes), read a
// plane row at a time: taps (v, u0) and (v, u1) are one run of 2C floats
// (u1 = u0 + 1), or one tap twice where the border clamps u1 to u0.
// kWindowed as sample_features_bf16: a tap whose u index lies outside the
// plane's window [lo, lo + band_w) has weight 0 and is not read; a row
// whose window edge falls between its two taps reads the inside tap alone
// (C floats).
template <int C, bool kWindowed = false>
__device__ __forceinline__ void load_features(const float* planes_s, float x,
                                              float y, float z, int res,
                                              float* feat, int wx = 0,
                                              int wy = 0, int band_w = 0) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float cu, cv;
    plane_uv(p, x, y, z, cu, cv);
    int u0, u1, v0, v1;
    float wu, wv;
    pixel(cu, res, u0, u1, wu);
    pixel(cv, res, v0, v1, wv);
    const float* P = planes_s + (size_t)p * res * res * C;
    float au = 1.0f - wu, bu = wu;
    bool in0 = true, in1 = true;
    if constexpr (kWindowed) {
      const int lo = p < 2 ? wx : wy;
      in0 = u0 >= lo && u0 < lo + band_w;
      in1 = u1 >= lo && u1 < lo + band_w;
      if (!in0) au = 0.0f;
      if (!in1) bu = 0.0f;
    }
    float t[2][2 * C];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* q = P + ((size_t)(r ? v1 : v0) * res + u0) * C;
      if (kWindowed && !(in0 && in1)) {
#pragma unroll
        for (int c = 0; c < 2 * C; ++c) t[r][c] = 0.0f;
        if (in0) load_run<C>(q, t[r]);
        if (in1) load_run<C>(q + (u1 - u0) * C, t[r] + C);
      } else if (u1 != u0) {
        load_run<2 * C>(q, t[r]);
      } else {
        load_run<C>(q, t[r]);
#pragma unroll
        for (int c = 0; c < C; ++c) t[r][C + c] = t[r][c];
      }
    }
    const float av = 1.0f - wv;
#pragma unroll
    for (int c = 0; c < C; ++c)
      feat[c * 3 + p] = av * (au * t[0][c] + bu * t[0][C + c]) +
                        wv * (au * t[1][c] + bu * t[1][C + c]);
  }
}

// One sample's features, padded with zeros to FP columns, all zero where
// the sample is past the end (bf16 values in the bf16 mode).  kWindowed as
// load_features, with the window starts wx, wy of band_w rows.
template <int C, bool kB, bool kWindowed = false>
__device__ __forceinline__ void features(const PlaneT<kB>* planes_s,
                                         float x, float y, float z, int res,
                                         bool valid,
                                         float (&feat)[Feat<C>::FP],
                                         int wx = 0, int wy = 0,
                                         int band_w = 0) {
  constexpr int F = Feat<C>::F, FP = Feat<C>::FP;
  if (valid) {
    if constexpr (kB)
      sample_features_bf16<C, kWindowed>(planes_s, x, y, z, res, feat, wx,
                                         wy, band_w);
    else
      load_features<C, kWindowed>(planes_s, x, y, z, res, feat, wx, wy,
                                  band_w);
  }
#pragma unroll
  for (int f = 0; f < FP; ++f)
    if (!valid || f >= F) feat[f] = 0.0f;
}

// One sample's features into its rows of the feature tiles: split into
// the hi and lo tiles, or in the bf16 mode (exact in TF32) into the hi
// tile alone.
template <int C, bool kB, bool kWindowed = false>
__device__ __forceinline__ void stage_features(const PlaneT<kB>* planes_s,
                                               float x, float y, float z,
                                               int res, bool valid,
                                               uint32_t* rh, uint32_t* rl,
                                               int wx = 0, int wy = 0,
                                               int band_w = 0) {
  constexpr int FP = Feat<C>::FP;
  float feat[FP];
  features<C, kB, kWindowed>(planes_s, x, y, z, res, valid, feat, wx, wy,
                             band_w);
#pragma unroll
  for (int f = 0; f < FP; f += 4) {
    uint4 h, l;
    operand<kB>(feat[f], h.x, l.x);
    operand<kB>(feat[f + 1], h.y, l.y);
    operand<kB>(feat[f + 2], h.z, l.z);
    operand<kB>(feat[f + 3], h.w, l.w);
    *reinterpret_cast<uint4*>(rh + f) = h;
    if constexpr (!kB) *reinterpret_cast<uint4*>(rl + f) = l;
  }
}

// The A fragment (hi and lo; hi alone for kB) of rows r0 .. r0 + 15,
// columns 8 ks .. of a split tile of row stride RS.
template <int RS, bool kB>
__device__ __forceinline__ void load_a(const uint32_t* th, const uint32_t* tl,
                                       int r0, int ks, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31;
  const int o = (r0 + (lane >> 2)) * RS + 8 * ks + (lane & 3);
  ah[0] = th[o];
  ah[1] = th[o + 8 * RS];
  ah[2] = th[o + 4];
  ah[3] = th[o + 8 * RS + 4];
  if constexpr (!kB) {
    al[0] = tl[o];
    al[1] = tl[o + 8 * RS];
    al[2] = tl[o + 4];
    al[3] = tl[o + 8 * RS + 4];
  }
}

// The forward's shared memory: W_b^T's B fragments (KF, NT, lane), the
// head rows (H / 2, 3) and the block's feature tiles and ray ids.
template <int C, int H>
struct FwdSmem {
  static constexpr int KF = Feat<C>::KF, NT = H / 8, FS = Feat<C>::FS;
  static constexpr int kBytes = KF * NT * 32 * 16 + (H / 2) * 3 * 16 +
                                kThreads * (2 * FS + 1) * 4;
  uint4* wfr;
  float4* head;
  uint32_t* sFh;  // (thread, FS) each
  uint32_t* sFl;
  int* sR;        // (thread)
  __device__ explicit FwdSmem(uint4* smem)
      : wfr(smem),
        head(reinterpret_cast<float4*>(smem + KF * NT * 32)),
        sFh(reinterpret_cast<uint32_t*>(head + (H / 2) * 3)),
        sFl(sFh + kThreads * FS),
        sR(reinterpret_cast<int*>(sFl + kThreads * FS)) {}
  // the first byte past the forward's part (16-byte aligned)
  __device__ uint8_t* end() const {
    return reinterpret_cast<uint8_t*>(sR + kThreads);
  }
};

// The block's weights into shared memory: W_b^T's B fragments (k =
// feature, n = hidden unit), split once, and per column pair j (columns
// 2j, 2j + 1) b_b, W_d, W_c rows 0-2.  The caller synchronises.
template <int C, int H, bool kB>
__device__ __forceinline__ void stage_weights(const float* __restrict__ params,
                                              const FwdSmem<C, H>& sm) {
  constexpr int F = Feat<C>::F, KF = Feat<C>::KF, NT = H / 8;
  const float* bb = params + H * F;
  const float* wd = bb + H;
  const float* wc = wd + H;
  for (int e = threadIdx.x; e < KF * NT * 32; e += kThreads) {
    const int l = e & 31, nt = (e >> 5) % NT, ks = (e >> 5) / NT;
    const int h = 8 * nt + (l >> 2), f = 8 * ks + (l & 3);
    uint4 v;
    operand<kB>(f < F ? params[h * F + f] : 0.0f, v.x, v.z);
    operand<kB>(f + 4 < F ? params[h * F + f + 4] : 0.0f, v.y, v.w);
    sm.wfr[e] = v;
  }
  for (int j = threadIdx.x; j < H / 2; j += kThreads) {
    sm.head[3 * j] = make_float4(bb[2 * j], bb[2 * j + 1], wd[2 * j],
                                 wd[2 * j + 1]);
    sm.head[3 * j + 1] = make_float4(wc[2 * j], wc[2 * j + 1], wc[H + 2 * j],
                                     wc[H + 2 * j + 1]);
    sm.head[3 * j + 2] = make_float4(wc[2 * H + 2 * j],
                                     wc[2 * H + 2 * j + 1], 0.0f, 0.0f);
  }
}

// The base product and the heads of m tile mt (rows 16 mt ..) of the
// staged feature tiles, then store(i, v) with lane (gr, t) holding output
// t (raw sigma, r, g, b, without the output bias) of row 16 mt + gr + 8 i.
// dir_out rows ray0 + sR[row] are added in colour mode.  Storing through
// the callback, row by row, keeps the split forward's registers on the
// H100: a form that returned both rows' values made ptxas take 168
// registers for the bf16 forward in place of 96 (3 blocks an SM, not 5),
// and the forward 17% slower.
template <int C, int H, bool kB, typename Store>
__device__ __forceinline__ void mlp_rows(const FwdSmem<C, H>& sm,
                                         const float* __restrict__ dir_out,
                                         size_t ray0, bool colour, int mt,
                                         Store store) {
  constexpr int FS = Feat<C>::FS, KF = Feat<C>::KF, NT = H / 8;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KF; ++ks) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    load_a<FS, kB>(sm.sFh, sm.sFl, 16 * mt, ks, ah, al);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint4 w = sm.wfr[(ks * NT + n) * 32 + lane];
      bh[n][0] = w.x;
      bh[n][1] = w.y;
      bl[n][0] = w.z;
      bl[n][1] = w.w;
    }
    mma3_split<NT, kB>(acc, ah, al, bh, bl);
  }
  // heads: lane = rows gr, gr + 8 x columns 2t, 2t + 1 of each tile
  float out[2][4];
  const float* drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    out[i][0] = out[i][1] = out[i][2] = out[i][3] = 0.0f;
    drow[i] = colour ? dir_out + (ray0 + sm.sR[16 * mt + gr + 8 * i]) * H +
                           2 * t
                     : nullptr;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float4 hb = sm.head[3 * (4 * n + t)];
    const float4 hc = sm.head[3 * (4 * n + t) + 1];
    const float4 hd = sm.head[3 * (4 * n + t) + 2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2 dv = make_float2(0.0f, 0.0f);
      if (colour) dv = *reinterpret_cast<const float2*>(drow[i] + 8 * n);
      if (kB) dv = make_float2(round_bf16(dv.x), round_bf16(dv.y));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float b = acc[n][2 * i + j] + (j ? hb.y : hb.x);
        const float bx = b * sigmoid_fast(b);
        out[i][0] += (j ? hb.w : hb.z) * (kB ? round_bf16(bx) : bx);
        if (colour) {
          const float c = b + (j ? dv.y : dv.x);
          const float cs = c * sigmoid_fast(c);
          const float cx = kB ? round_bf16(cs) : cs;
          out[i][1] += (j ? hc.y : hc.x) * cx;
          out[i][2] += (j ? hc.w : hc.z) * cx;
          out[i][3] += (j ? hd.y : hd.x) * cx;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[i][k] += __shfl_xor_sync(0xffffffffu, out[i][k], 1);
      out[i][k] += __shfl_xor_sync(0xffffffffu, out[i][k], 2);
    }
    // lane t stores output t (sigma, r, g, b) of its two rows
    store(i, t == 0 ? out[i][0] : t == 1 ? out[i][1]
             : t == 2 ? out[i][2] : out[i][3]);
  }
}

// The decode forward over warp tiles of 32 samples, persistent: warp w of
// block b takes every (gridDim.x kWarps)-th tile from b kWarps + w.
// kWindowed (the banded decode): each tile_w-slot tile of the band layout
// has its window starts win = wx | (wy << 8); a warp tile lies inside one
// (tile_w a multiple of 32, M of tile_w), so its window is one value.
template <int C, int H, bool kB, bool kWindowed>
__device__ __forceinline__ void decode_forward(
    uint4* smem, const PlaneT<kB>* __restrict__ planes,
    const float* __restrict__ xyz, const int32_t* __restrict__ rid,
    const float* __restrict__ dir_out, const float* __restrict__ params,
    const int32_t* __restrict__ win, float* __restrict__ sigma,
    float* __restrict__ rgb, int S, int M, int n_rays, int res, int tile_w,
    int band_w) {
  constexpr int F = Feat<C>::F, FS = Feat<C>::FS;
  const FwdSmem<C, H> sm(smem);
  stage_weights<C, H, kB>(params, sm);
  __syncthreads();

  const bool colour = rgb != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const float out_bias = params[H * F + 5 * H + t];
  const size_t plane_size =
      (size_t)3 * res * res * (kB ? padded_channels<C>() : C);
  const int tiles = (M + 31) / 32;  // a warp's tiles a scene
  for (int tile = blockIdx.x * kWarps + warp; tile < S * tiles;
       tile += gridDim.x * kWarps) {
    const int s = tile / tiles, i0 = (tile % tiles) * 32;
    int wx = 0, wy = 0;
    if constexpr (kWindowed) {
      const int w = win[(size_t)s * (M / tile_w) + i0 / tile_w];
      wx = w & 0xFF;
      wy = w >> 8;
    }
    {  // lane = sample
      const int i = i0 + lane;
      const bool valid = i < M;
      const size_t si = (size_t)s * M + (valid ? i : 0);
      float x = 0.0f, y = 0.0f, z = 0.0f;
      if (valid) {
        x = xyz[si * 3 + 0];
        y = xyz[si * 3 + 1];
        z = xyz[si * 3 + 2];
      }
      stage_features<C, kB, kWindowed>(planes + s * plane_size, x, y, z, res,
                                       valid, sm.sFh + threadIdx.x * FS,
                                       sm.sFl + threadIdx.x * FS, wx, wy,
                                       band_w);
      sm.sR[threadIdx.x] = valid && colour ? rid[si] : 0;
    }
    __syncwarp();

#pragma unroll 1
    for (int mt = 2 * warp; mt < 2 * warp + 2; ++mt) {
      mlp_rows<C, H, kB>(sm, dir_out, (size_t)s * n_rays, colour, mt,
                         [&](int i, float v) {
        const int r = i0 + 16 * (mt - 2 * warp) + gr + 8 * i;
        if (r < M) {
          const size_t si = (size_t)s * M + r;
          if (t == 0)
            sigma[si] = v + out_bias;
          else if (colour)
            rgb[si * 3 + t - 1] = v + out_bias;
        }
      });
    }
    __syncwarp();  // the warp's next tile overwrites its rows
  }
}

// Blocks for a persistent launch of `kernel` over n_tiles tiles: as many
// as fit the card at once, at most one a tile.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int smem, int n_tiles,
                            int& grid) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  grid = min(n_tiles, max(1, per_sm) * sms);
  return cudaSuccess;
}

// A persistent launch of `kernel` (kThreads a block, smem bytes of dynamic
// shared memory) over n_tiles tiles; nothing to do for none.
template <typename... Params, typename... Args>
int launch_persistent(void (*kernel)(Params...), int smem, int n_tiles,
                      void* stream, Args... args) {
  if (n_tiles == 0) return (int)cudaSuccess;
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, smem, n_tiles, grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int C_, int H_, bool kB_>
struct Shape {
  static constexpr int C = C_, H = H_;
  static constexpr bool kB = kB_;
};

// fn(Shape<C, hidden, kB>{}) for an instantiated (C, hidden) and mode,
// else cudaErrorInvalidValue.
template <typename Fn>
int with_shape(int C, int hidden, int bf16, Fn fn) {
  return with_channels(C, bf16, [&](auto c, auto b) {
    constexpr int Cv = decltype(c)::value;
    constexpr bool kB = decltype(b)::value;
    switch (hidden) {
      case 32: return fn(Shape<Cv, 32, kB>{});
      case 64: return fn(Shape<Cv, 64, kB>{});
      case 128: return fn(Shape<Cv, 128, kB>{});
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

}  // namespace
