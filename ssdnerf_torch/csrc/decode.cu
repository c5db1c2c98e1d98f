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
// Forward: the warp tiles of decode_fwd.cuh (feature tiles, the base
// product on the tensor cores, the heads from the accumulator fragments),
// shared with the banded decode (decode_banded.cu) and the fused decode +
// composite (decode_composite.cu).
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

#include "decode_fwd.cuh"

namespace {

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

// Adjoint of load_features: adds dfeat through the 4 taps of each plane
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

// The split forward: decode_fwd.cuh's warp tiles over every sample.
template <int C, int H, bool kB>
__global__ void __launch_bounds__(kThreads)
triplane_decode_kernel(const PlaneT<kB>* __restrict__ planes,
                       const float* __restrict__ xyz,
                       const int32_t* __restrict__ rid,
                       const float* __restrict__ dir_out,
                       const float* __restrict__ params,
                       float* __restrict__ sigma, float* __restrict__ rgb,
                       int S, int M, int n_rays, int res) {
  extern __shared__ uint4 smem[];
  decode_forward<C, H, kB, false>(smem, planes, xyz, rid, dir_out, params,
                                  nullptr, sigma, rgb, S, M, n_rays, res, 0,
                                  0);
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
    return launch_persistent(
        triplane_decode_kernel<Sh::C, Sh::H, Sh::kB>,
        FwdSmem<Sh::C, Sh::H>::kBytes, S * ((M + kTile - 1) / kTile), stream,
        static_cast<const PlaneT<Sh::kB>*>(planes),
        static_cast<const float*>(xyz), static_cast<const int32_t*>(rid),
        static_cast<const float*>(dir_out), static_cast<const float*>(params),
        static_cast<float*>(sigma), static_cast<float*>(rgb), S, M, n_rays,
        res);
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
    return launch_persistent(
        triplane_decode_bwd_kernel<Sh::C, Sh::H, Sh::kB>,
        bwd_smem_bytes<Sh::C, Sh::H>(), S * ((M + kTile - 1) / kTile), stream,
        static_cast<const PlaneT<Sh::kB>*>(planes),
        static_cast<const float*>(xyz), static_cast<const int32_t*>(rid),
        static_cast<const float*>(dir_out), static_cast<const float*>(params),
        static_cast<const float*>(g_sigma), static_cast<const float*>(g_rgb),
        static_cast<float*>(d_planes), static_cast<float*>(d_dir_out),
        static_cast<float*>(d_params), S, M, n_rays, res);
  });
}
