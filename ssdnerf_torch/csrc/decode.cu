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
// Backward: replaces ssdnerf_tpu/ops/pallas/decode.py:_bwd_kernel (reached
// through triplane_decode -> _bwd).  From the upstream gradients of raw
// sigma and raw rgb it forms the gradients of the planes, of the per-ray
// dir_out rows and of the whole parameter block; positions get none.  The
// TPU kernel read a bf16 feature residual saved by the forward because its
// hat matmuls were expensive; here the 4-tap recompute is cheap, so the
// forward saves nothing.
//
// What bounds them on the H100.  The first versions (one thread a sample,
// the MLP as f32 FMA loops over weights in shared memory, exact expf and
// division in SiLU) were split with one-line variants of the backward
// (tools/decode_profile.py, PERF.md): of its 1.91 ms at the training shape
// the three MLP products took 0.43 ms, the plane-gradient scatter 0.38 ms
// and the rest 1.01 ms, mostly the elementwise work per (sample, hidden
// unit): ~150 instructions, of which the exact expf and division of two
// sigmoids were most.  So the design:
//   - products on the tensor cores: mma.sync m16n8k8 TF32 in three passes
//     (mma_tf32.cuh, as the attention), each weight operand split into
//     hi / lo once a block (in shared memory, or in registers where a
//     warp keeps its own columns);
//   - the sigmoids by the SFU's ex2 and rcp (f32, about 2^-22 relative
//     each), which keeps the outputs within 1e-5 of the plain version;
//   - the taps read and the plane gradient scattered a plane row at a
//     time (two adjacent taps, 2C contiguous floats) in 16-byte pieces
//     where aligned: at C = 6, 21 loads and 21 atomics a sample in place
//     of 72 scalar loads and 36 float2 atomics.  Scattered lanes cost an
//     L1 wavefront each, so the count of memory instructions, not their
//     bytes, bounded both: the backward with float2 atomics alone takes
//     1.24 ms against 0.95.
// What bounds them now (PERF.md): the SFU (4 ex2 / rcp a sample and
// hidden unit in colour mode, 0.13 ms at the training shape), the
// instructions of the elementwise pass, the scatter's atomics and the tap
// reads; both kernels stay well above their bound.  Staging the taps by
// cp.async one tile ahead was tried and made both slower.
//
// Feature tiles.  Thread = sample: the taps' 3C features go into a shared
// tile whose rows are padded with zero columns to FP, a multiple of 8; the
// row stride FS = FP + 4 keeps every fragment load free of bank conflicts.
//
// Forward, warp = 32 samples: the warp stages its samples' features,
// split into hi / lo, in its own rows (so warps never wait for each other
// and one warp's tap reads overlap another's products); base = F W_b^T
// (K = FP, N = hidden) with W_b's fragments from shared memory (one
// 16-byte load a lane for the three passes of an 8x8 block); then the
// density and colour heads from the accumulator fragments: each lane holds
// 2 rows x 2 columns of every 8-column tile, adds the bias, the row's
// dir_out values and SiLU, and the dot products over hidden end in a quad
// shuffle sum.
//
// Backward, a block of 4 warps walks tiles of 128 samples of one scene
// (persistent: as many blocks as fit the card, each taking every
// gridDim.x-th tile; 3 blocks an SM):
//   1. thread = sample: features (f32), upstream gradients, ray id to
//      shared memory;
//   2. warp = hidden columns (the warp's W_b fragments in registers): base
//      = F W_b^T + b_b; d_base = W_d g_sigma silu'(base) + W_c^T g_rgb
//      silu'(base + dir); the column sums of the head and bias gradients
//      stay in registers for the block's whole walk; d_dir is summed over
//      each 16-row m tile that holds one ray (shuffles), then over runs of
//      such tiles, and added once a run (every row added alone where a
//      tile holds more than one ray); d_base to shared memory;
//   3. warp = 16 hidden units: dW_b += d_base^T F (K = the tile's
//      samples); then warp = rows: dF = d_base W_b (K = hidden, N = FP),
//      into the feature tile.  Each tile's mma chain starts from zero and
//      is added to the block's running f32 sums with ordinary adds,
//      because the tensor cores' accumulation does not round to nearest;
//   4. thread = sample: dF through the 4 taps x 3 planes into the (S, 3,
//      res, res, C) plane gradient.
// At the end the block adds its parameter-gradient sums once (atomicAdd).
// All atomics are f32 sums in a run-dependent order.
//
// bf16 operand mode (kB; the JAX package's default compute_dtype, whose
// renderer feeds the Pallas kernels bf16 planes and weights): bf16 planes
// padded to 4-channel taps, and the roundings of triplane.cuh and of the
// Pallas backward (_bwd_kernel): the upstream gradients are rounded before
// the head products and dW_d, dW_c (the bias sums take them unrounded),
// d_base before dW_b and dF (db_b takes it unrounded), the colour head's
// d_base before d_dir, and dF * (second coordinate's hat) before the plane
// gradient, which the first coordinate's bf16 hat multiplies exactly.
// Every product's operands are then bf16 values, which TF32 holds exactly:
// one TF32 pass (mma3_split / mma3_batch with kOne) in place of three.
// The plane gradient is summed in f32 by the same atomics and rounded to
// bf16 after the kernel.

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

template <int N>
__device__ __forceinline__ void add_run(float* p, const float* v) {
  auto add2 = [&](int c) {
    atomicAdd(reinterpret_cast<float2*>(p + c), make_float2(v[c], v[c + 1]));
  };
  auto add4 = [&](int c) {
    atomicAdd(reinterpret_cast<float4*>(p + c),
              make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]));
  };
  for_run<N>(p, add4, add2);
}

// The features of sample_features (same taps, weights and order), read a
// plane row at a time: taps (v, u0) and (v, u1) are one run of 2C floats
// (u1 = u0 + 1), or one tap twice where the border clamps u1 to u0.
template <int C>
__device__ __forceinline__ void load_features(const float* planes_s, float x,
                                              float y, float z, int res,
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
    float t[2][2 * C];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* q = P + ((size_t)(r ? v1 : v0) * res + u0) * C;
      if (u1 != u0) {
        load_run<2 * C>(q, t[r]);
      } else {
        load_run<C>(q, t[r]);
#pragma unroll
        for (int c = 0; c < C; ++c) t[r][C + c] = t[r][c];
      }
    }
    const float au = 1.0f - wu, av = 1.0f - wv;
#pragma unroll
    for (int c = 0; c < C; ++c)
      feat[c * 3 + p] = av * (au * t[0][c] + wu * t[0][C + c]) +
                        wv * (au * t[1][c] + wu * t[1][C + c]);
  }
}

// Adjoint of sample_features: adds dfeat through the 4 taps of each plane
// into one scene's (3, res, res, C) gradient, a plane row (two taps, 2C
// floats) at a time as load_features reads them.
template <int C>
__device__ __forceinline__ void scatter_features(float* dplanes_s, float x,
                                                 float y, float z, int res,
                                                 const float* dfeat) {
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
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float rw = r ? wv : av;
      float v[2 * C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = (rw * au) * dfeat[c * 3 + p];
        v[C + c] = (rw * wu) * dfeat[c * 3 + p];
      }
      float* q = P + ((size_t)(r ? v1 : v0) * res + u0) * C;
      if (u1 != u0) {
        add_run<2 * C>(q, v);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] += v[C + c];
        add_run<C>(q, v);
      }
    }
  }
}

// The bf16 mode's adjoint of the features (Pallas _bwd_kernel): for each
// plane and tap row, bf16(dfeat * row hat) times the bf16 u hats of the
// row's two taps, added in f32 into one scene's (3, res, res, C) gradient
// as scatter_features adds.
template <int C>
__device__ __forceinline__ void scatter_features_bf16(float* dplanes_s,
                                                      float x, float y,
                                                      float z, int res,
                                                      const float* dfeat) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float cu, cv;
    plane_uv(p, x, y, z, cu, cv);
    int u0, u1, v0, v1;
    float wu, wv;
    pixel<true>(cu, res, u0, u1, wu);
    pixel<true>(cv, res, v0, v1, wv);
    float* P = dplanes_s + (size_t)p * res * res * C;
    const float au = round_bf16(1.0f - wu), bu = round_bf16(wu);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float rw = r ? wv : 1.0f - wv;
      float v[2 * C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = round_bf16(rw * dfeat[c * 3 + p]);
        v[c] = d * au;
        v[C + c] = d * bu;
      }
      float* q = P + ((size_t)(r ? v1 : v0) * res + u0) * C;
      if (u1 != u0) {
        add_run<2 * C>(q, v);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] += v[C + c];
        add_run<C>(q, v);
      }
    }
  }
}

// One sample's features, padded with zeros to FP columns, all zero where
// the sample is past the end (bf16 values in the bf16 mode).
template <int C, bool kB>
__device__ __forceinline__ void features(const PlaneT<kB>* planes_s,
                                         float x, float y, float z, int res,
                                         bool valid,
                                         float (&feat)[Feat<C>::FP]) {
  constexpr int F = Feat<C>::F, FP = Feat<C>::FP;
  if (valid) {
    if constexpr (kB)
      sample_features<C, false, true>(planes_s, x, y, z, res, feat);
    else
      load_features<C>(planes_s, x, y, z, res, feat);
  }
#pragma unroll
  for (int f = 0; f < FP; ++f)
    if (!valid || f >= F) feat[f] = 0.0f;
}

// One sample's features into its rows of the feature tiles: split into
// the hi and lo tiles, or in the bf16 mode (exact in TF32) into the hi
// tile alone.
template <int C, bool kB>
__device__ __forceinline__ void stage_features(const PlaneT<kB>* planes_s,
                                               float x, float y, float z,
                                               int res, bool valid,
                                               uint32_t* rh, uint32_t* rl) {
  constexpr int FP = Feat<C>::FP;
  float feat[FP];
  features<C, kB>(planes_s, x, y, z, res, valid, feat);
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

// The A fragment of rows r0 .. r0 + 15, columns 8 ks .. of an f32 tile of
// row stride RS, as operands (operand<kB>).
template <int RS, bool kB>
__device__ __forceinline__ void load_a_split(const float* tile, int r0,
                                             int ks, uint32_t (&ah)[4],
                                             uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31;
  const float* a = tile + (r0 + (lane >> 2)) * RS + 8 * ks + (lane & 3);
  operand<kB>(a[0], ah[0], al[0]);
  operand<kB>(a[8 * RS], ah[1], al[1]);
  operand<kB>(a[4], ah[2], al[2]);
  operand<kB>(a[8 * RS + 4], ah[3], al[3]);
}

template <int C, int H>
constexpr int fwd_smem_bytes() {
  return Feat<C>::KF * (H / 8) * 32 * 16 + (H / 2) * 3 * 16 +
         kThreads * (2 * Feat<C>::FS + 1) * 4;
}

// The forward's tiles are a warp's: 32 samples (2 m tiles), staged in the
// warp's own rows of the shared tiles, so that warps never wait for each
// other and one warp's tap reads overlap another's products.
template <int C, int H, bool kB>
__global__ void __launch_bounds__(kThreads)
triplane_decode_kernel(const PlaneT<kB>* __restrict__ planes,
                       const float* __restrict__ xyz,
                       const int32_t* __restrict__ rid,
                       const float* __restrict__ dir_out,
                       const float* __restrict__ params,
                       float* __restrict__ sigma, float* __restrict__ rgb,
                       int S, int M, int n_rays, int res) {
  using Fe = Feat<C>;
  constexpr int F = Fe::F, FS = Fe::FS, KF = Fe::KF, NT = H / 8;
  extern __shared__ uint4 smem[];
  uint4* wfr = smem;                                   // (KF, NT, lane)
  float4* head = reinterpret_cast<float4*>(wfr + KF * NT * 32);  // (H/2, 3)
  uint32_t* sFh = reinterpret_cast<uint32_t*>(head + (H / 2) * 3);
  uint32_t* sFl = sFh + kThreads * FS;                 // (thread, FS) each
  int* sR = reinterpret_cast<int*>(sFl + kThreads * FS);
  const float* bb = params + H * F;
  const float* wd = bb + H;
  const float* wc = wd + H;
  const float* bd_bc = wc + 3 * H;

  // W_b^T's B fragments (k = feature, n = hidden unit), split once
  for (int e = threadIdx.x; e < KF * NT * 32; e += kThreads) {
    const int l = e & 31, nt = (e >> 5) % NT, ks = (e >> 5) / NT;
    const int h = 8 * nt + (l >> 2), f = 8 * ks + (l & 3);
    uint4 v;
    operand<kB>(f < F ? params[h * F + f] : 0.0f, v.x, v.z);
    operand<kB>(f + 4 < F ? params[h * F + f + 4] : 0.0f, v.y, v.w);
    wfr[e] = v;
  }
  // per column pair j (columns 2j, 2j + 1): b_b, W_d, W_c rows 0-2
  for (int j = threadIdx.x; j < H / 2; j += kThreads) {
    head[3 * j] = make_float4(bb[2 * j], bb[2 * j + 1], wd[2 * j],
                              wd[2 * j + 1]);
    head[3 * j + 1] = make_float4(wc[2 * j], wc[2 * j + 1], wc[H + 2 * j],
                                  wc[H + 2 * j + 1]);
    head[3 * j + 2] = make_float4(wc[2 * H + 2 * j], wc[2 * H + 2 * j + 1],
                                  0.0f, 0.0f);
  }
  __syncthreads();

  const bool colour = rgb != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const float out_bias = bd_bc[t];
  const size_t plane_size =
      (size_t)3 * res * res * (kB ? padded_channels<C>() : C);
  const int tiles = (M + 31) / 32;  // a warp's tiles a scene
  for (int tile = blockIdx.x * kWarps + warp; tile < S * tiles;
       tile += gridDim.x * kWarps) {
    const int s = tile / tiles, i0 = (tile % tiles) * 32;
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
      stage_features<C, kB>(planes + s * plane_size, x, y, z, res, valid,
                            sFh + threadIdx.x * FS, sFl + threadIdx.x * FS);
      sR[threadIdx.x] = valid && colour ? rid[si] : 0;
    }
    __syncwarp();

#pragma unroll 1
    for (int mt = 2 * warp; mt < 2 * warp + 2; ++mt) {
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KF; ++ks) {
        uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
        load_a<FS, kB>(sFh, sFl, 16 * mt, ks, ah, al);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint4 v = wfr[(ks * NT + n) * 32 + lane];
          bh[n][0] = v.x;
          bh[n][1] = v.y;
          bl[n][0] = v.z;
          bl[n][1] = v.w;
        }
        mma3_split<NT, kB>(acc, ah, al, bh, bl);
      }
      // heads: lane = rows gr, gr + 8 x columns 2t, 2t + 1 of each tile
      float out[2][4];
      const float* drow[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        out[i][0] = out[i][1] = out[i][2] = out[i][3] = 0.0f;
        drow[i] = colour ? dir_out + ((size_t)s * n_rays +
                                      sR[16 * mt + gr + 8 * i]) * H + 2 * t
                         : nullptr;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 hb = head[3 * (4 * n + t)];
        const float4 hc = head[3 * (4 * n + t) + 1];
        const float4 hd = head[3 * (4 * n + t) + 2];
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
        // lane t writes output t (sigma, r, g, b) of its two rows
        const int r = i0 + 16 * (mt - 2 * warp) + gr + 8 * i;
        const float v = t == 0 ? out[i][0] : t == 1 ? out[i][1]
                        : t == 2 ? out[i][2] : out[i][3];
        if (r < M) {
          const size_t si = (size_t)s * M + r;
          if (t == 0)
            sigma[si] = v + out_bias;
          else if (colour)
            rgb[si * 3 + t - 1] = v + out_bias;
        }
      }
    }
    __syncwarp();  // the warp's next tile overwrites its rows
  }
}

template <int C, int H>
constexpr int bwd_smem_bytes() {
  using Fe = Feat<C>;
  return (H / 8) * Fe::KF * 32 * 16 + kTile * 16 +
         kTile * (Fe::FS + (H + 4) + 1) * 4;
}

template <int C, int H, bool kB>
__global__ void __launch_bounds__(kThreads, 3)
triplane_decode_bwd_kernel(const PlaneT<kB>* __restrict__ planes,
                           const float* __restrict__ xyz,
                           const int32_t* __restrict__ rid,
                           const float* __restrict__ dir_out,
                           const float* __restrict__ params,
                           const float* __restrict__ g_sigma,
                           const float* __restrict__ g_rgb,
                           float* __restrict__ d_planes,
                           float* __restrict__ d_dir_out,
                           float* __restrict__ d_params, int S, int M,
                           int n_rays, int res) {
  using Fe = Feat<C>;
  constexpr int F = Fe::F, FP = Fe::FP, FS = Fe::FS, KF = Fe::KF;
  constexpr int HS = H + 4;  // d_base row stride (= 4 mod 32)
  constexpr int NT = H / 8, NTW = NT / kWarps;  // column tiles, a warp's
  // dW_b: 16-unit row blocks; RB < kWarps shares each out across warps
  // by halves of the tile's samples
  constexpr int RB = H / 16;
  constexpr int WPR = RB >= kWarps ? 1 : kWarps / RB;  // warps a row block
  constexpr int RBW = RB >= kWarps ? RB / kWarps : 1;  // row blocks a warp
  constexpr int KSD = kTile / 8 / WPR;                 // k steps a warp
  static_assert(NT % kWarps == 0 && kMT == 2 * kWarps, "tile split");
  extern __shared__ uint4 smem[];
  uint4* dfr = smem;                                   // (NT, KF, lane)
  float4* sG = reinterpret_cast<float4*>(dfr + NT * KF * 32);  // (tile)
  float* sF = reinterpret_cast<float*>(sG + kTile);  // (tile, FS): F, then dF
  float* sDB = sF + kTile * FS;                                // (tile, HS)
  int* sR = reinterpret_cast<int*>(sDB + kTile * HS);          // (tile)
  const float* bb = params + H * F;
  const float* wd = bb + H;
  const float* wc = wd + H;

  const bool colour = dir_out != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;

  // W_b's B fragments for dF (k = hidden unit, n = feature), split once
  for (int e = tid; e < NT * KF * 32; e += kThreads) {
    const int l = e & 31, nt = (e >> 5) % KF, ks = (e >> 5) / KF;
    const int h = 8 * ks + (l & 3), f = 8 * nt + (l >> 2);
    uint4 v;
    operand<kB>(f < F ? params[h * F + f] : 0.0f, v.x, v.z);
    operand<kB>(f < F ? params[(h + 4) * F + f] : 0.0f, v.y, v.w);
    dfr[e] = v;
  }
  // this warp's columns 8 (warp NTW + j) + ..: W_b^T's B fragments (k =
  // feature, n = hidden unit) and, for the lane's columns 2t, 2t + 1, the
  // base bias and head weights
  uint32_t bh[NTW][KF][2], bl[NTW][KF][2];
  float cb[NTW][2], cw[NTW][2][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = warp * NTW + j;
    const int h = 8 * nt + gr;
#pragma unroll
    for (int ks = 0; ks < KF; ++ks) {
      const int f = 8 * ks + t;
      operand<kB>(f < F ? params[h * F + f] : 0.0f, bh[j][ks][0],
                  bl[j][ks][0]);
      operand<kB>(f + 4 < F ? params[h * F + f + 4] : 0.0f, bh[j][ks][1],
                  bl[j][ks][1]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = 8 * nt + 2 * t + q;
      cb[j][q] = bb[col];
      cw[j][q][0] = wd[col];
      cw[j][q][1] = wc[col];
      cw[j][q][2] = wc[H + col];
      cw[j][q][3] = wc[2 * H + col];
    }
  }

  float csum[NTW][2][5];  // column sums: W_d, W_c (3), b_b
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int k = 0; k < 5; ++k) csum[j][q][k] = 0.0f;
  float wsum[RBW][KF][4];  // dW_b running sums
#pragma unroll
  for (int r = 0; r < RBW; ++r)
#pragma unroll
    for (int n = 0; n < KF; ++n)
      wsum[r][n][0] = wsum[r][n][1] = wsum[r][n][2] = wsum[r][n][3] = 0.0f;
  float4 gsum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // b_d, b_c

  const size_t plane_size =
      (size_t)3 * res * res * (kB ? padded_channels<C>() : C);
  const size_t dplane_size = (size_t)3 * res * res * C;
  const int tiles = (M + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < S * tiles; tile += gridDim.x) {
    const int s = tile / tiles, i0 = (tile % tiles) * kTile;
    float* d_dir_s = colour ? d_dir_out + (size_t)s * n_rays * H : nullptr;
    const float* dir_s = colour ? dir_out + (size_t)s * n_rays * H : nullptr;

    // ---- 1. thread = sample: features, upstream gradients, ray id ----
    const int i = i0 + tid;
    const bool valid = i < M;
    const size_t si = (size_t)s * M + (valid ? i : 0);
    float x = 0.0f, y = 0.0f, z = 0.0f;
    float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int r_id = -1;
    if (valid) {
      x = xyz[si * 3 + 0];
      y = xyz[si * 3 + 1];
      z = xyz[si * 3 + 2];
      g.x = g_sigma[si];
      if (colour) {
        g.y = g_rgb[si * 3 + 0];
        g.z = g_rgb[si * 3 + 1];
        g.w = g_rgb[si * 3 + 2];
        r_id = rid[si];
      }
    }
    {
      float feat[FP];
      features<C, kB>(planes + s * plane_size, x, y, z, res, valid, feat);
#pragma unroll
      for (int f = 0; f < FP; f += 4)
        *reinterpret_cast<float4*>(sF + tid * FS + f) =
            make_float4(feat[f], feat[f + 1], feat[f + 2], feat[f + 3]);
    }
    sG[tid] = g;
    sR[tid] = r_id;
    gsum.x += g.x;
    gsum.y += g.y;
    gsum.z += g.z;
    gsum.w += g.w;
    __syncthreads();

    // ---- 2. warp = columns: base, d_base ----
    int run_ray = -1;
    float run_d[NTW][2];
#pragma unroll
    for (int j = 0; j < NTW; ++j) run_d[j][0] = run_d[j][1] = 0.0f;
    auto flush = [&]() {
      if (run_ray >= 0 && gr == 0) {
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          atomicAdd(reinterpret_cast<float2*>(
                        d_dir_s + (size_t)run_ray * H +
                        8 * (warp * NTW + j) + 2 * t),
                    make_float2(run_d[j][0], run_d[j][1]));
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) run_d[j][0] = run_d[j][1] = 0.0f;
    };
    for (int mt = 0; mt < kMT; mt += 2) {  // two m tiles at a time
      float acc[2][NTW][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          acc[m][j][0] = acc[m][j][2] = cb[j][0];
          acc[m][j][1] = acc[m][j][3] = cb[j][1];
        }
#pragma unroll
      for (int ks = 0; ks < KF; ++ks) {
        uint32_t ah[2][4], al[2][4], fh[2][NTW][2], fl[2][NTW][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          load_a_split<FS, kB>(sF, 16 * (mt + m), ks, ah[m], al[m]);
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            fh[m][j][0] = bh[j][ks][0];
            fh[m][j][1] = bh[j][ks][1];
            fl[m][j][0] = bl[j][ks][0];
            fl[m][j][1] = bl[j][ks][1];
          }
        }
        mma3_batch<2, NTW, kB>(acc, ah, al, fh, fl);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r0 = 16 * (mt + m) + gr;
        const float4 gg[2] = {sG[r0], sG[r0 + 8]};
        const int ray[2] = {sR[r0], sR[r0 + 8]};
        // one ray over the m tile: its d_dir is summed by shuffles
        const int ray0 = __shfl_sync(0xffffffffu, ray[0], 0);
        const bool one = __all_sync(0xffffffffu,
                                    ray[0] == ray0 && ray[1] == ray0);
        float dsum[NTW][2];
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int c0 = 8 * (warp * NTW + j) + 2 * t;
          dsum[j][0] = dsum[j][1] = 0.0f;
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            // the products take the upstream gradients rounded (kB)
            float4 q = gg[ri];
            if (kB)
              q = make_float4(round_bf16(q.x), round_bf16(q.y),
                              round_bf16(q.z), round_bf16(q.w));
            float2 dv = make_float2(0.0f, 0.0f);
            if (colour && ray[ri] >= 0)
              dv = *reinterpret_cast<const float2*>(
                  dir_s + (size_t)ray[ri] * H + c0);
            if (kB) dv = make_float2(round_bf16(dv.x), round_bf16(dv.y));
            float db[2], dc[2];
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
              const float b = acc[m][j][2 * ri + qq];
              const float sg = sigmoid_fast(b);
              const float bx = b * sg;
              csum[j][qq][0] += q.x * (kB ? round_bf16(bx) : bx);    // W_d
              db[qq] = cw[j][qq][0] * q.x * sg * (1.0f + b * (1.0f - sg));
              dc[qq] = 0.0f;
              if (colour) {
                const float c = b + (qq ? dv.y : dv.x);
                const float sc = sigmoid_fast(c);
                const float cx = kB ? round_bf16(c * sc) : c * sc;
                csum[j][qq][1] += q.y * cx;                          // W_c
                csum[j][qq][2] += q.z * cx;
                csum[j][qq][3] += q.w * cx;
                dc[qq] = (cw[j][qq][1] * q.y + cw[j][qq][2] * q.z +
                          cw[j][qq][3] * q.w) *
                         sc * (1.0f + c * (1.0f - sc));
                db[qq] += dc[qq];
              }
              csum[j][qq][4] += db[qq];                              // b_b
              if (kB) {  // dW_b, dF and d_dir take them rounded
                db[qq] = round_bf16(db[qq]);
                dc[qq] = round_bf16(dc[qq]);
              }
              dsum[j][qq] += dc[qq];
            }
            *reinterpret_cast<float2*>(sDB + (r0 + 8 * ri) * HS + c0) =
                make_float2(db[0], db[1]);
            if (colour && !one && ray[ri] >= 0)
              atomicAdd(reinterpret_cast<float2*>(
                            d_dir_s + (size_t)ray[ri] * H + c0),
                        make_float2(dc[0], dc[1]));
          }
        }
        if (colour) {
          if (one) {
            if (ray0 != run_ray) {
              flush();
              run_ray = ray0;
            }
#pragma unroll
            for (int j = 0; j < NTW; ++j)
#pragma unroll
              for (int qq = 0; qq < 2; ++qq) {
                float v = dsum[j][qq];
                v += __shfl_xor_sync(0xffffffffu, v, 4);
                v += __shfl_xor_sync(0xffffffffu, v, 8);
                v += __shfl_xor_sync(0xffffffffu, v, 16);
                run_d[j][qq] += v;
              }
          } else {
            flush();
            run_ray = -1;
          }
        }
      }
    }
    if (colour) flush();
    __syncthreads();

    // ---- 3a. warp = 16 hidden units: dW_b += d_base^T F ----
    // k = t reads sample 2t and k = t + 4 sample 2t + 1 of each 8-sample
    // step (a sum over samples ignores their order; this order keeps the
    // B fragment's loads free of bank conflicts); two k steps at a time
    // into two accumulators
#pragma unroll
    for (int rw = 0; rw < RBW; ++rw) {
      const int rb = warp % (kWarps / WPR) + rw * (kWarps / WPR);
      const int k0 = (warp / (kWarps / WPR)) * KSD;
      float acc[2][KF][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < KF; ++n)
          acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;
      for (int ks = k0; ks < k0 + KSD; ks += 2) {
        uint32_t ah[2][4], al[2][4], fh[2][KF][2], fl[2][KF][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int s0 = 8 * (ks + m) + 2 * t;
          const float* a = sDB + s0 * HS + 16 * rb + gr;
          operand<kB>(a[0], ah[m][0], al[m][0]);
          operand<kB>(a[8], ah[m][1], al[m][1]);
          operand<kB>(a[HS], ah[m][2], al[m][2]);
          operand<kB>(a[HS + 8], ah[m][3], al[m][3]);
#pragma unroll
          for (int n = 0; n < KF; ++n) {
            const int o = s0 * FS + 8 * n + gr;
            operand<kB>(sF[o], fh[m][n][0], fl[m][n][0]);
            operand<kB>(sF[o + FS], fh[m][n][1], fl[m][n][1]);
          }
        }
        mma3_batch<2, KF, kB>(acc, ah, al, fh, fl);
      }
#pragma unroll
      for (int n = 0; n < KF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wsum[rw][n][e] += acc[0][n][e] + acc[1][n][e];
    }
    __syncthreads();

    // ---- 3b. warp = rows (m tiles warp, warp + 4): dF = d_base W_b, into
    // the feature tile (F is read no more) ----
    {
      float acc[2][KF][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < KF; ++n)
          acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) {
        uint32_t ah[2][4], al[2][4], fh[2][KF][2], fl[2][KF][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* a =
              sDB + (16 * (warp + kWarps * m) + gr) * HS + 8 * ks + t;
          operand<kB>(a[0], ah[m][0], al[m][0]);
          operand<kB>(a[8 * HS], ah[m][1], al[m][1]);
          operand<kB>(a[4], ah[m][2], al[m][2]);
          operand<kB>(a[8 * HS + 4], ah[m][3], al[m][3]);
#pragma unroll
          for (int n = 0; n < KF; ++n) {
            const uint4 v = dfr[(ks * KF + n) * 32 + lane];
            fh[m][n][0] = v.x;
            fh[m][n][1] = v.y;
            fl[m][n][0] = v.z;
            fl[m][n][1] = v.w;
          }
        }
        mma3_batch<2, KF, kB>(acc, ah, al, fh, fl);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < KF; ++n) {
          float* o =
              sF + (16 * (warp + kWarps * m) + gr) * FS + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[m][n][0], acc[m][n][1]);
          *reinterpret_cast<float2*>(o + 8 * FS) =
              make_float2(acc[m][n][2], acc[m][n][3]);
        }
    }
    __syncthreads();

    // ---- 4. thread = sample: scatter dF (the thread's own row, which only
    // it writes next, in phase 1) ----
    if (valid) {
      float df[FP];
#pragma unroll
      for (int f = 0; f < FP; f += 4) {
        const float4 v = *reinterpret_cast<const float4*>(sF + tid * FS + f);
        df[f] = v.x;
        df[f + 1] = v.y;
        df[f + 2] = v.z;
        df[f + 3] = v.w;
      }
      if constexpr (kB)
        scatter_features_bf16<C>(d_planes + s * dplane_size, x, y, z, res,
                                 df);
      else
        scatter_features<C>(d_planes + s * dplane_size, x, y, z, res, df);
    }
  }

  // ---- the block's parameter-gradient sums, once ----
#pragma unroll
  for (int rw = 0; rw < RBW; ++rw) {
    const int rb = warp % (kWarps / WPR) + rw * (kWarps / WPR);
#pragma unroll
    for (int n = 0; n < KF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 16 * rb + gr + (e >> 1) * 8;
        const int f = 8 * n + 2 * t + (e & 1);
        if (f < F) atomicAdd(d_params + h * F + f, wsum[rw][n][e]);
      }
  }
  float* d_bb = d_params + H * F;
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
      const int col = 8 * (warp * NTW + j) + 2 * t + qq;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        float v = csum[j][qq][k];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        // b_b, W_d, W_c rows 0-2 at d_bb + {0, 1, 2, 3, 4} * H
        const int at = k == 4 ? 0 : k + 1;
        if (gr == 0 && (colour || k == 0 || k == 4))
          atomicAdd(d_bb + at * H + col, v);
      }
    }
  float gs[4] = {gsum.x, gsum.y, gsum.z, gsum.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      gs[k] += __shfl_xor_sync(0xffffffffu, gs[k], o);
    if (lane == 0 && (colour || k == 0)) atomicAdd(d_bb + 5 * H + k, gs[k]);
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

// planes: (S, 3, res, res, C) f32 channels-last, or with bf16 != 0 bf16
// with C padded to a multiple of 4 (the bf16 operand mode); xyz: (S, M, 3)
// f32; rid: (S, M) int32 ray ids into dir_out (S, n_rays, hidden) f32,
// both nullptr in density-only mode (then rgb is nullptr too); params: the
// packed MLP block (bf16 values for the weights in the bf16 mode); sigma:
// (S, M) f32; rgb: (S, M, 3) f32.  Returns cudaErrorInvalidValue for a
// (C, hidden) without an instance (C in {4, 6, 8}, hidden in {32, 64,
// 128}).
extern "C" int triplane_decode(const void* planes, const void* xyz,
                               const void* rid, const void* dir_out,
                               const void* params, void* sigma, void* rgb,
                               int S, int M, int n_rays, int res, int C,
                               int hidden, int bf16, void* stream) {
  return with_shape(C, hidden, bf16, [&](auto shape) {
    using Sh = decltype(shape);
    auto kernel = triplane_decode_kernel<Sh::C, Sh::H, Sh::kB>;
    constexpr int smem = fwd_smem_bytes<Sh::C, Sh::H>();
    const int n_tiles = S * ((M + kTile - 1) / kTile);
    if (n_tiles == 0) return (int)cudaSuccess;
    int grid = 0;
    cudaError_t err = persistent_grid(kernel, smem, n_tiles, grid);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const PlaneT<Sh::kB>*>(planes),
        static_cast<const float*>(xyz), static_cast<const int32_t*>(rid),
        static_cast<const float*>(dir_out), static_cast<const float*>(params),
        static_cast<float*>(sigma), static_cast<float*>(rgb), S, M, n_rays,
        res);
    return (int)cudaGetLastError();
  });
}

// Inputs as triplane_decode, plus g_sigma (S, M) and g_rgb (S, M, 3) f32,
// the gradients of the raw outputs (g_rgb nullptr in density-only mode).
// Outputs, zero-filled by the caller and accumulated into: d_planes (S, 3,
// res, res, C) f32 (C unpadded in either mode), d_dir_out (S, n_rays,
// hidden) (nullptr in density-only mode), d_params (the parameter block's
// size).  Returns cudaErrorInvalidValue for a (C, hidden) without an
// instance.
extern "C" int triplane_decode_bwd(const void* planes, const void* xyz,
                                   const void* rid, const void* dir_out,
                                   const void* params, const void* g_sigma,
                                   const void* g_rgb, void* d_planes,
                                   void* d_dir_out, void* d_params, int S,
                                   int M, int n_rays, int res, int C,
                                   int hidden, int bf16, void* stream) {
  return with_shape(C, hidden, bf16, [&](auto shape) {
    using Sh = decltype(shape);
    auto kernel = triplane_decode_bwd_kernel<Sh::C, Sh::H, Sh::kB>;
    constexpr int smem = bwd_smem_bytes<Sh::C, Sh::H>();
    const int n_tiles = S * ((M + kTile - 1) / kTile);
    if (n_tiles == 0) return (int)cudaSuccess;
    int grid = 0;
    cudaError_t err = persistent_grid(kernel, smem, n_tiles, grid);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const PlaneT<Sh::kB>*>(planes),
        static_cast<const float*>(xyz), static_cast<const int32_t*>(rid),
        static_cast<const float*>(dir_out), static_cast<const float*>(params),
        static_cast<const float*>(g_sigma), static_cast<const float*>(g_rgb),
        static_cast<float*>(d_planes), static_cast<float*>(d_dir_out),
        static_cast<float*>(d_params), S, M, n_rays, res);
    return (int)cudaGetLastError();
  });
}
