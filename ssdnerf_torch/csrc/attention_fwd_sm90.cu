// The bf16 attention forward on Hopper's warpgroup products (sm_90a).
//
// Replaces, for bf16 operands at head dim 64 and T a multiple of 128 (the
// bf16 UNet's 32^2 level: T = 1024, 8 scenes x 4 heads), the Pallas kernel
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
//   - a CTA owns 128 query rows: two consumer warpgroups of 64 rows each,
//     and one producer warp;
//   - the producer loads Q once and streams the key tiles (64 keys) by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle) into a ring of 4 stages
//     guarded by mbarriers: pass 1 loads K tiles, pass 2 K and V tiles;
//   - S = Q K^T is wgmma.mma_async m64n64k16 with both operands in shared
//     memory (K-major); P V takes P from registers (the S accumulator of
//     two n8 tiles is the A fragment of one k16 step, rounded to bf16) and
//     V from shared memory, transposed (MN-major);
//   - the softmax runs in exp2: log2(e) * scale is folded into one FMA.
// Each consumer warp releases a stage (mbarrier arrive) once its products
// on it are complete, so the producer runs up to 4 tiles ahead of the
// slower warpgroup.

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;         // query rows a CTA (2 x 64)
constexpr int kBN = 64;          // keys a tile
constexpr int kStages = 4;
constexpr int kConsumers = 2;    // warpgroups
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kTileBytes = kBN * kHD * 2;   // one K or V tile
constexpr int kQBytes = kBM * kHD * 2;
constexpr int kSmemBytes = 1024 + kQBytes + 2 * kStages * kTileBytes + 256;

// S = Q K^T for the warpgroup's 64 rows against one 64-key tile: four k16
// steps over the head dim (32 bytes each in the swizzled rows).
__device__ __forceinline__ void scores(float (&s)[32], const bf16* q,
                                       const bf16* k) {
  const uint64_t dq = desc_k_major(q), dk = desc_k_major(k);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kHD / 16; ++ks)
    wgmma_ss(s, dq + 2 * ks, dk + 2 * ks, ks > 0);
  wgmma_commit();
  wgmma_wait();
}

// Grid (T / 128, G); block: warpgroups 0-1 consume (64 query rows each),
// warp 8 produces.  lse, o32 may be null.
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          bf16* __restrict__ o, float* __restrict__ o32,
                          float* __restrict__ lse, int T, float scale) {
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
  const bf16* q = sQ + wg * 64 * kHD;
  const float c = scale * 1.4426950408889634f;  // scale log2(e)
  mbar_wait(qbar, 0);

  // pass 1: the row max m (in units of c s) and the row sum l of 2^(c s -
  // m), online; each thread holds rows gr and gr + 8 of its warp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int it = 0; it < tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    float s[32];
    scores(s, q, sK + st * (kTileBytes / 2));
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
    scores(s, q, sK + st * (kTileBytes / 2));
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

  // rows gr and gr + 8 of the warp: o (and o32), and lse = m / log2(e) +
  // ln(l) in units of the scaled scores
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + gr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t off = (size_t)(row0 + r0 + 8 * h) * kHD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      *reinterpret_cast<uint32_t*>(o + off + 8 * j) = pack_bf16(a, b);
      if (o32 != nullptr)
        *reinterpret_cast<float2*>(o32 + off + 8 * j) = make_float2(a, b);
    }
    if (lse != nullptr && t == 0)
      lse[row0 + r0 + 8 * h] = m[h] * 0.6931471805599453f + logf(l[h]);
  }
}

}  // namespace

// True if attention_fwd_bf16_sm90 takes (T, hd): hd 64, T a multiple of
// 128.
extern "C" int attention_fwd_bf16_sm90_supported(int T, int hd) {
  return hd == kHD && T > 0 && T % kBM == 0;
}

// q, k, v, o: (G, T, 64) bf16 contiguous, 16-byte aligned; o32: (G, T, 64)
// f32 or nullptr; lse: (G, T) f32 or nullptr.  Returns
// cudaErrorInvalidValue for a shape without support (see
// attention_fwd_bf16_sm90_supported) or a tensor map that could not be
// made.
extern "C" int attention_fwd_bf16_sm90(const void* q, const void* k,
                                       const void* v, void* o, void* o32,
                                       void* lse, int G, int T, float scale,
                                       void* stream) {
  if (!attention_fwd_bf16_sm90_supported(T, kHD) || G <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, G * T, kBM) || !tensor_map(&tk, k, G * T, kBN) ||
      !tensor_map(&tv, v, G * T, kBN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T / kBM, G);
  attention_fwd_sm90_kernel<<<grid, kThreads, kSmemBytes,
                              (cudaStream_t)stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(o32),
      static_cast<float*>(lse), T, scale);
  return (int)cudaGetLastError();
}
