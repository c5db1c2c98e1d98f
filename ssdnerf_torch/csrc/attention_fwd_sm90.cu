// The bf16 attention forward on Hopper's warpgroup products (sm_90a).
//
// Replaces, for bf16 operands at head dim 40 or 64 and T a multiple of 128
// (the bf16 UNet's 32^2 level: T = 1024, hd 64, 8 scenes x 4 heads; the
// tiled config's 16 x 48 level: T = 768, hd 40), the Pallas kernel
// ssdnerf_tpu/ops/pallas/attention.py:_fwd_kernel (reached through
// vmem_attention -> _fwd_call); attention.cu's mma.sync kernel keeps the
// other shapes.  Semantics are that kernel's (attention.cu, "bf16
// operands"): S = Q K^T in f32, each row's log-sum-exp found in a first
// pass over the key tiles, then P = exp(s - lse) rounded to bf16 into
// P V, summed in f32 and rounded to bf16.  An online softmax would round
// other values than the Pallas kernel does, and a 64 x 1024 f32 score slab
// does not fit a block's shared memory, so the two passes stay: three
// products where a flash forward has two.
//
// Bound on the H100: tensor-core operations (4 hd T^2 a program, 2 hd T^2
// more for the first pass's S) and 2 T^2 exponentials a program on the
// SFU; the bytes are a few MB.  The mma.sync kernel ran ~4x slower than
// one scaled_dot_product_attention call (PERF.md); this design:
//   - a CTA owns 64 query rows a consumer warpgroup: three warpgroups (192
//     rows) where T is a multiple of 192, so that the tiled level's G = 32
//     x T = 768 is 128 CTAs, one to an SM of the 132 (128-row CTAs would
//     be 192, two on 60 SMs and one on the others: 0.028 device ms where
//     192-row ones take 0.022, PERF.md), else two (128 rows); and one
//     producer warp;
//   - the producer loads Q once and streams the key tiles (64 keys) by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle) into a ring of 4 stages
//     guarded by mbarriers: pass 1 loads K tiles, pass 2 K and V tiles;
//   - shared memory holds a token as a 64-column row whatever the head
//     dim; at hd 40 TMA fills columns 40-63 with zeros, S = Q K^T runs 3
//     k16 steps (columns 0-47) instead of 4, and P V computes 64 output
//     columns of which the first 40 are stored (the canonical MN-major
//     layout of a 128-byte-swizzled B tile spans 64 columns, so N stays 64);
//   - S = Q K^T is wgmma.mma_async m64n64k16 with both operands in shared
//     memory (K-major); P V takes P from registers (the S accumulator of
//     two n8 tiles is the A fragment of one k16 step, rounded to bf16) and
//     V from shared memory, transposed (MN-major);
//   - the softmax runs in exp2: log2(e) * scale is folded into one FMA.
// Each consumer warp releases a stage (mbarrier arrive) once its products
// on it are complete, so the producer runs up to 4 tiles ahead of the
// slowest warpgroup.

#include "sm90.cuh"

namespace {

constexpr int kBN = 64;          // keys a tile
constexpr int kStages = 4;
constexpr int kTileBytes = kBN * kRow * 2;   // one K or V tile

// kConsumers warpgroups of 64 query rows each and one producer warp.
template <int kConsumers>
struct Fwd {
  static constexpr int kBM = 64 * kConsumers;  // query rows a CTA
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kQBytes = kBM * kRow * 2;
  static constexpr int kSmemBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + 256;
};

// S = Q K^T for the warpgroup's 64 rows against one 64-key tile: the k16
// steps over the head dim (32 bytes each in the swizzled rows).
template <int HD>
__device__ __forceinline__ void scores(float (&s)[32], const bf16* q,
                                       const bf16* k) {
  const uint64_t dq = desc_k_major(q), dk = desc_k_major(k);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSteps<HD>; ++ks)
    wgmma_ss(s, dq + 2 * ks, dk + 2 * ks, ks > 0);
  wgmma_commit();
  wgmma_wait();
}

// Grid (T / (64 kConsumers), G); block: warpgroups 0 .. kConsumers - 1
// consume (64 query rows each), warp 4 kConsumers produces.  lse, o32 may
// be null.
template <int HD, int kConsumers>
__global__ void __launch_bounds__(Fwd<kConsumers>::kThreads, 1)
attention_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          bf16* __restrict__ o, float* __restrict__ o32,
                          float* __restrict__ lse, int T, float scale) {
  constexpr int kBM = Fwd<kConsumers>::kBM;
  constexpr int kQBytes = Fwd<kConsumers>::kQBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sK = reinterpret_cast<bf16*>(base + kQBytes);
  bf16* sV = reinterpret_cast<bf16*>(base + kQBytes + kStages * kTileBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      base + kQBytes + 2 * kStages * kTileBytes);
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* qbar = bars + 2 * kStages;

  const int g = blockIdx.y, q0 = blockIdx.x * kBM;
  const int row0 = g * T;  // first row of program g in the (G T, hd) view
  const int tiles = T / kBN;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 4);  // one arrive a consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ---- producer: Q once, then K (pass 1) and K, V (pass 2) tiles ----
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(qbar, kQBytes);
      tma_load(sQ, &tm_q, 0, row0 + q0, qbar);
      for (int it = 0; it < 2 * tiles; ++it) {
        const int st = it % kStages, round = it / kStages;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        const int key = row0 + (it % tiles) * kBN;
        if (it < tiles) {
          mbar_expect_tx(&full[st], kTileBytes);
          tma_load(sK + st * (kTileBytes / 2), &tm_k, 0, key, &full[st]);
        } else {
          mbar_expect_tx(&full[st], 2 * kTileBytes);
          tma_load(sK + st * (kTileBytes / 2), &tm_k, 0, key, &full[st]);
          tma_load(sV + st * (kTileBytes / 2), &tm_v, 0, key, &full[st]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, rows q0 + 64 wg + 16 (warp % 4) + ... ----
  const int wg = warp >> 2, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const bf16* q = sQ + wg * 64 * kRow;
  const float c = scale * 1.4426950408889634f;  // scale log2(e)
  mbar_wait(qbar, 0);

  // pass 1: the row max m (in units of c s) and the row sum l of 2^(c s -
  // m), online; each thread holds rows gr and gr + 8 of its warp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int it = 0; it < tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    float s[32];
    scores<HD>(s, q, sK + st * (kTileBytes / 2));
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e] * c);
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      l[h] *= ex2(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      sum[h] += ex2(fmaf(s[e], c, -m[h]));
    }
    l[0] += sum[0];
    l[1] += sum[1];
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / l[h];
  }

  // pass 2: O = bf16(2^(c s - m) / l) V
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  for (int it = tiles; it < 2 * tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    float s[32];
    scores<HD>(s, q, sK + st * (kTileBytes / 2));
    uint32_t p[4][4];  // A fragments of the 4 k16 steps over the tile's keys
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // r: rows gr / gr + 8 (r & 1), keys 16 ks + 2t / + 8 (r >> 1),
        // i.e. columns of n8 tile 2 ks + (r >> 1)
        const int e = 4 * (2 * ks + (r >> 1)) + 2 * (r & 1);
        const int h = r & 1;
        p[ks][r] = pack_bf16(ex2(fmaf(s[e], c, -m[h])) * inv[h],
                             ex2(fmaf(s[e + 1], c, -m[h])) * inv[h]);
      }
    wgmma_fence();
    wgmma_rs_tile(acc, p, sV + st * (kTileBytes / 2));
    wgmma_commit();
    wgmma_wait();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // rows gr and gr + 8 of the warp: o (and o32), the HD / 8 n8 tiles of
  // the head dim (the zero columns past it are not stored), and lse = m /
  // log2(e) + ln(l) in units of the scaled scores
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + gr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t off = (size_t)(row0 + r0 + 8 * h) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      *reinterpret_cast<uint32_t*>(o + off + 8 * j) = pack_bf16(a, b);
      if (o32 != nullptr)
        *reinterpret_cast<float2*>(o32 + off + 8 * j) = make_float2(a, b);
    }
    if (lse != nullptr && t == 0)
      lse[row0 + r0 + 8 * h] = m[h] * 0.6931471805599453f + logf(l[h]);
  }
}

template <int HD, int kConsumers>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* o32, void* lse, int G, int T, float scale,
               cudaStream_t stream) {
  using F = Fwd<kConsumers>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, G * T, HD, F::kBM) ||
      !tensor_map(&tk, k, G * T, HD, kBN) ||
      !tensor_map(&tv, v, G * T, HD, kBN))
    return (int)cudaErrorInvalidValue;
  auto kernel = attention_fwd_sm90_kernel<HD, kConsumers>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T / F::kBM, G);
  kernel<<<grid, F::kThreads, F::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(o32),
      static_cast<float*>(lse), T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// True if attention_fwd_bf16_sm90 takes (T, hd): hd 40 or 64, T a
// multiple of 128.
extern "C" int attention_fwd_bf16_sm90_supported(int T, int hd) {
  return (hd == 40 || hd == 64) && T > 0 && T % 128 == 0;
}

// q, k, v, o: (G, T, hd) bf16 contiguous, 16-byte aligned; o32: (G, T, hd)
// f32 or nullptr; lse: (G, T) f32 or nullptr.  CTAs of 192 query rows
// where T is a multiple of 192, else of 128.  Returns
// cudaErrorInvalidValue for a shape without support (see
// attention_fwd_bf16_sm90_supported) or a tensor map that could not be
// made.
extern "C" int attention_fwd_bf16_sm90(const void* q, const void* k,
                                       const void* v, void* o, void* o32,
                                       void* lse, int G, int T, int hd,
                                       float scale, void* stream) {
  if (!attention_fwd_bf16_sm90_supported(T, hd) || G <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool three = T % 192 == 0;
  if (hd == 40)
    return three ? launch_fwd<40, 3>(q, k, v, o, o32, lse, G, T, scale, st)
                 : launch_fwd<40, 2>(q, k, v, o, o32, lse, G, T, scale, st);
  return three ? launch_fwd<64, 3>(q, k, v, o, o32, lse, G, T, scale, st)
               : launch_fwd<64, 2>(q, k, v, o, o32, lse, G, T, scale, st);
}
