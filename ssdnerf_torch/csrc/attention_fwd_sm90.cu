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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHD = 64;          // head dim
constexpr int kBM = 128;         // query rows a CTA (2 x 64)
constexpr int kBN = 64;          // keys a tile
constexpr int kStages = 4;
constexpr int kConsumers = 2;    // warpgroups
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kTileBytes = kBN * kHD * 2;   // one K or V tile
constexpr int kQBytes = kBM * kHD * 2;
constexpr int kSmemBytes = 1024 + kQBytes + 2 * kStages * kTileBytes + 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2D TMA load (coordinates: column, row) into shared memory, completing
// on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile (rows of
// 128 bytes, 8-row atoms of 1024 bytes, 1024-byte aligned): start address,
// leading and stride byte offsets.  K-major operands use only the stride
// (1024, from one 8-row atom to the next); the transposed V tile steps its
// k atoms by the same 1024, which is passed as both offsets.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64 f32 over the warpgroup, 32 a thread) = or += A B, A and B
// from shared memory (K-major), one k16 step.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (64 x 16 bf16) from registers in the mma.sync A fragment
// layout, B from shared memory transposed (MN-major), one k16 step.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for the warpgroup's 64 rows against one 64-key tile: four k16
// steps over the head dim (32 bytes each in the swizzled rows).
__device__ __forceinline__ void scores(float (&s)[32], const bf16* q,
                                       const bf16* k) {
  const uint64_t dq = smem_desc(q, 16, 1024), dk = smem_desc(k, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kHD / 16; ++ks)
    wgmma_ss(s, dq + 2 * ks, dk + 2 * ks, ks > 0);
  wgmma_commit();
  wgmma_wait();
}

// Accumulator element e of a thread (lane = 4 gr + t of warp w): row 16 w
// + gr + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 t + (e & 1).

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
    const uint64_t dv = smem_desc(sV + st * (kTileBytes / 2), 1024, 1024);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs(acc, p[ks], dv + 128 * ks);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (rows, 64) bf16 matrix at `ptr` as a TMA map with boxes of
// `box_rows` rows of 128 bytes, 128-byte swizzled.
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {kHD, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {kHD * sizeof(bf16)};
  const cuuint32_t box[2] = {kHD, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
