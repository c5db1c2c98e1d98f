// Self-attention forward and backward on Hopper's tensor cores (sm_90a).
//
// Forward: replaces the Pallas kernel
// ssdnerf_tpu/ops/pallas/attention.py:_fwd_kernel (reached through
// vmem_attention -> _fwd_call).  Computes, per program g,
// softmax(q k^T * scale) v with an f32 softmax.  The TPU kernel held the
// whole (T, T) score matrix of one program in VMEM; a Hopper block has at
// most 227 KB of shared memory, so this kernel streams instead (online
// softmax): one block per (g, tile of query rows), 16 query rows a warp, K
// and V in tiles of 64 keys (32 from hd = 80) through shared memory, a
// running max and sum per row.  Under autograd it also writes each row's
// log-sum-exp (LSE, in units of the scaled scores) for the backward.
//
// Backward: replaces ssdnerf_tpu/ops/pallas/attention.py:_bwd_kernel
// (reached through vmem_attention -> _bwd_rule), which recomputed the
// softmax of 256-row query blocks against all of K in VMEM.  Here, in the
// flash-attention-2 form:
//   D_i = rowsum(dO_i * O_i)        (attention_bwd_dot_kernel: a row
//                                    reduction, bound by its bytes)
//   P_ij = exp(scale * q_i.k_j - LSE_i)  (the forward's own LSE)
//   dS_ij = P_ij * (dO_i.v_j - D_i)
//   dV_j = sum_i P_ij dO_i, dK_j = scale * sum_i dS_ij q_i
//       (one block per (g, key tile), streaming the query tiles; it forms
//        S^T = K Q^T and dP^T = V dO^T directly, so that its accumulators
//        are indexed by key row as dK and dV are)
//   dQ_i = scale * sum_j dS_ij k_j  (one block per (g, query tile),
//                                    streaming the key tiles)
// Two kernels instead of one with atomics on dQ: every output element has
// one writer, so the gradients are bitwise reproducible.
//
// bf16 operands (the "bf16 operands" section below) take the same flash
// form on mma.sync bf16 products; at hd 40 or 64 and T a multiple of 128
// (the bf16 UNet's 32^2 level, the tiled config's 16 x 48 level) the
// forward and the backward dispatch to the wgmma + TMA kernels of
// attention_fwd_sm90.cu and attention_bwd_sm90.cu, so this file's bf16
// kernels serve hd 16, 32, 80 and 128 and hd 40 and 64 at other lengths.
//
// Products: every matrix product (Q K^T and P V forward; K Q^T, V dO^T,
// P^T dO, dS^T Q, Q K^T, dO V^T and dS K backward) runs on the tensor cores
// as mma.sync.m16n8k8 TF32 with f32 accumulators, in three passes: each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// acc += lo*hi + hi*lo + hi*hi, the small terms first ("3xTF32").  One
// TF32 pass keeps ~11 bits and misses the f32 tolerances of the tests by
// 10x or more (tests/test_torch_attention_precision.py); three passes carry
// the operands' f32 precision into the products.  The error left is the
// tensor cores' f32 accumulation, which does not round each sum to nearest:
// on an H100 the kernels are 5.0e-6 (forward) and 1.1e-5 (backward) off
// the plain f32 version at T = 1024 (chip_smoke.py phase 2), several times
// what f32 FMA loops give; tests/test_torch_gpu.py holds them within
// 1.5e-5 / 3e-5 of f64.  Operands are split as the fragments are
// loaded from shared memory, so tiles stay f32; the rounding is integer
// arithmetic, not the conversion instruction (to_tf32, split, mma_tf32
// and mma3 live in mma_tf32.cuh, shared with decode.cu).  Each pass runs
// over a group of up to 8 accumulator tiles, so that independent products
// separate two that share an accumulator.
//
// Fragments: a lane (group gr = lane / 4, t = lane % 4) holds rows gr and
// gr + 8, columns 2t and 2t + 1 of each 16x8 accumulator tile.  Softmax row
// maxima and sums therefore combine the 4 lanes of a quad (__shfl_xor 1, 2).
// The accumulator of S (or P^T, dS, dS^T) is the A operand of the next
// product as it stands: the m16n8k8 A fragment wants keys t and t + 4 of an
// 8-key step, the accumulator holds keys 2t and 2t + 1, and since a sum over
// keys ignores their order, the B fragment is loaded with key 2t at k = t
// and key 2t + 1 at k = t + 4.  Tile rows are padded by 4 floats (row stride
// HD + 4, 4 times an odd number mod 32 banks: 4 at hd 32, 64 and 128, 12 at
// 40, 20 at 16 and 80), which keeps 16-byte cp.async copies aligned and
// every fragment load of the three access patterns free of bank conflicts.
//
// Copies: tiles arrive by cp.async, 16 B a thread, double-buffered: the next
// tile's copy is in flight while the current one is multiplied.  Rows past
// T are zero-filled (src-size 0); scores past T are -inf in the forward and
// P = 0 there in the backward.
//
// Filling the card: 16 rows a warp, and the rows a block owns (query rows,
// or keys in the dK/dV kernel) follow T so that each UNet level launches
// >= 128 blocks at G = 32: 64 rows (4 warps) from T = 512, 32 from T = 128,
// else 16.  Streamed tiles have 64 rows, 32 from hd = 80 (shared memory and
// registers, see tile_rows).
//
// Head dims: 16, 32, 40, 64, 80 and 128 (every attention level of the
// shipped UNets and the grouped UNet of the tests: hd 40 and 80 are the
// tiled-triplane config's 16x48 and 8x24 / 4x12 levels; hd 16 the grouped
// UNet's), in f32 and bf16; any other head dim returns
// cudaErrorInvalidValue.  At hd 80 the 10 accumulator tiles of P V run as
// a group of 8 and a group of 2 (mma_pb).  The bf16 products sum over hd
// in steps of 16, so hd 40 is padded to 48 inside the kernels: columns
// past hd are zero-filled in shared memory (cp.async with source size 0)
// and never stored, so Q K^T, dO V^T and the stored dQ, dK and dV are
// exact.
//
// Bound on the H100: tensor-core operations, 3 passes x (4 hd T^2 forward,
// 10 hd T^2 backward) per program at 495 TFLOP/s dense TF32, at the 32^2
// level (T = 1024); bytes at the 8^2 level (T = 64).  What holds the kernels
// above it (PERF.md): mma.sync, which reaches only part of the dense rate
// (wgmma is the next step), and the splits, ~20% of the forward's time.
// The backward runs 7 products where the bound counts 5: the dQ kernel
// recomputes S and dP rather than sum dQ across key tiles with atomics.
// Neither more blocks an SM (32-row tiles at every head dim) nor a
// register cap for three blocks an SM made either kernel faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kMaxThreads = 128;  // 4 warps: 64 rows a block

// Rows (query rows, or keys in the dK/dV kernel) a block owns, 16 a warp.
int rows_per_block(int T) { return T >= 512 ? 64 : T >= 128 ? 32 : 16; }

// Rows a streamed tile (keys in the forward and the dQ kernel, queries in
// the dK/dV kernel): 32 from hd = 80, where a 64-row f32 tile is 21-33 KB
// (two blocks fit an SM with double-buffered K and V) and the dK and dV
// accumulators take 80-128 registers a thread; else 64.
template <int HD>
__host__ __device__ constexpr int tile_rows() {
  return HD >= 80 ? 32 : 64;
}

// The head dim the bf16 kernels compute at: hd rounded up to the 16 of an
// m16n8k16 step (48 at hd = 40; every other head dim as it is).
template <int HD>
__host__ __device__ constexpr int padded_hd() {
  return (HD + 15) / 16 * 16;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + n) of a (T, HD) f32 matrix into a tile of row stride
// HD + 4, by cp.async; rows past T are zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n, int T) {
  constexpr int C4 = HD / 4;
  for (int e = threadIdx.x; e < n * C4; e += blockDim.x) {
    const int r = e / C4, c = (e % C4) * 4;
    const bool in = r0 + r < T;
    cp_async16(dst + r * (HD + 4) + c,
               src + (size_t)(in ? r0 + r : 0) * HD + c, in);
  }
}

// Entries [r0, r0 + n) of a length-T f32 vector, by cp.async; past T zero.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int r0, int n, int T) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in = r0 + i < T;
    cp_async4(dst + i, src + (in ? r0 + i : 0), in);
  }
}

// Independent accumulator tiles a three-pass group runs over (see mma3 in
// mma_tf32.cuh).
constexpr int kGroup = 8;

// acc (16 x 8 NT) += A Bt^T over 8 KS columns: A is the warp's 16 rows of a
// row-major shared tile, Bt 8 NT rows of another (row stride RS both).
// The k loop is unrolled whole up to hd = 64 and by 2 from hd = 80 (at 128
// the whole loop made the kernels slower on the H100, PERF.md).
template <int KS, int NT, int RS>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const float* A,
                                        const float* Bt) {
  static_assert(NT <= kGroup, "one group of accumulator tiles");
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll(KS <= 8 ? KS : 2)
  for (int ks = 0; ks < KS; ++ks) {
    const float* a = A + gr * RS + 8 * ks + t;
    uint32_t ah[4], al[4];
    split(a[0], ah[0], al[0]);
    split(a[8 * RS], ah[1], al[1]);
    split(a[4], ah[2], al[2]);
    split(a[8 * RS + 4], ah[3], al[3]);
    const float* bp = Bt + gr * RS + 8 * ks + t;
    float b[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      b[n][0] = bp[8 * n * RS];
      b[n][1] = bp[8 * n * RS + 4];
    }
    mma3<NT>(acc, ah, al, b);
  }
}

// The N accumulator tiles from tile c of acc += A B, B's fragments read
// from bp (see mma_pb).
template <int N, int RS>
__device__ __forceinline__ void mma_pb_group(float (*acc)[4],
                                             const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             const float* bp, int c) {
  float b[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    b[n][0] = bp[8 * (c + n)];
    b[n][1] = bp[8 * (c + n) + RS];
  }
  mma3<N>(acc + c, ah, al, b);
}

// acc (16 x 8 NT) += P B over 8 KS rows of B: P (16 x 8 KS) in the
// accumulator layout, B a row-major shared tile (row stride RS).  Within an
// 8-row step, k = t reads row 2t and k = t + 4 row 2t + 1 (see the note).
// The tiles run in groups of kGroup and a last group of the rest (2 at
// hd = 80).
template <int KS, int NT, int RS>
__device__ __forceinline__ void mma_pb(float (&acc)[NT][4],
                                       const float (&p)[KS][4],
                                       const float* B) {
  constexpr int N = NT < kGroup ? NT : kGroup;
  constexpr int NF = NT / N * N, NR = NT - NF;  // whole groups, the rest
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ah[4], al[4];
    split(p[ks][0], ah[0], al[0]);
    split(p[ks][2], ah[1], al[1]);
    split(p[ks][1], ah[2], al[2]);
    split(p[ks][3], ah[3], al[3]);
    const float* bp = B + (8 * ks + 2 * t) * RS + gr;
#pragma unroll
    for (int c = 0; c < NF; c += N) mma_pb_group<N, RS>(acc, ah, al, bp, c);
    if constexpr (NR > 0) mma_pb_group<NR, RS>(acc, ah, al, bp, NF);
  }
}

// Store rows gr and gr + 8 of the warp's accumulator (16 x HD) times `mul`
// to rows r0 + gr, r0 + gr + 8 of out (row length HD), those below T.
template <int HD>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[HD / 8][4],
                                           int r0, int T, const float mul[2]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gr + 8 * h;
    if (row >= T) continue;
    float* o = out + (size_t)row * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
}

template <int HD>
int fwd_smem(int rows) {
  return (rows + 4 * tile_rows<HD>()) * (HD + 4) * (int)sizeof(float);
}

// Block: (g = blockIdx.y, query rows blockIdx.x * R .. + R), R = blockDim.x
// / 2.  Shared: Q (R rows), K and V (two buffers of tile_rows keys each).
template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int T, float scale) {
  constexpr int RS = HD + 4, BK = tile_rows<HD>(), KT = BK / 8, NO = HD / 8;
  extern __shared__ __align__(16) float smem[];
  const int R = blockDim.x / 2;
  float* sQ = smem;
  float* sK = sQ + R * RS;
  float* sV = sK + 2 * BK * RS;
  const int g = blockIdx.y, q0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const size_t base = (size_t)g * T * HD;
  const float* kg = k + base;
  const float* vg = v + base;

  load_rows<HD>(sQ, q + base, q0, R, T);
  load_rows<HD>(sK, kg, 0, BK, T);
  load_rows<HD>(sV, vg, 0, BK, T);
  cp_async_commit();

  float acc[NO][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float* sQw = sQ + warp * 16 * RS;
  const int tiles = (T + BK - 1) / BK;
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < tiles) {  // the buffer it overwrites was released below
      load_rows<HD>(sK + (cur ^ 1) * BK * RS, kg, (it + 1) * BK, BK, T);
      load_rows<HD>(sV + (cur ^ 1) * BK * RS, vg, (it + 1) * BK, BK, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cK = sK + cur * BK * RS;
    const float* cV = sV + cur * BK * RS;

    float s[KT][4] = {};
    mma_abt<HD / 8, KT, RS>(s, sQw, cK);  // S = Q K^T
    const int k0 = it * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = col < T ? s[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);  // finite: key k0 < T is valid
      alpha[h] = expf(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rsum[e >> 1] += s[n][e];
      }
    // l stays a per-lane partial sum until the end (alpha is the quad's)
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_pb<KT, NO, RS>(acc, s, cV);  // O += P V
    __syncthreads();  // this buffer is free for the copy after next
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / l[h];
  }
  const int r0 = q0 + warp * 16;
  store_rows<HD>(o + base, acc, r0, T, inv);
  if (lse != nullptr && t == 0) {
    const int gr = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + gr + 8 * h < T)
        lse[(size_t)g * T + r0 + gr + 8 * h] = m[h] + logf(l[h]);
  }
}

// ------------------------------------------------------------- backward

// D[r] = sum_c dO[r, c] * O[r, c], one warp per row of the (G * T, hd)
// view.
__global__ void attention_bwd_dot_kernel(const float* __restrict__ o,
                                         const float* __restrict__ dout,
                                         float* __restrict__ D, int rows,
                                         int hd) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // uniform over the warp
  const float* a = o + (size_t)r * hd;
  const float* b = dout + (size_t)r * hd;
  float s = 0.0f;
  for (int c = lane; c < hd; c += 32) s += a[c] * b[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) D[r] = s;
}

template <int HD>
int dkdv_smem(int rows) {
  constexpr int BN = tile_rows<HD>();
  return ((2 * rows + 4 * BN) * (HD + 4) + 4 * BN) * (int)sizeof(float);
}

template <int HD>
int dq_smem(int rows) {
  constexpr int BN = tile_rows<HD>();
  return ((2 * rows + 4 * BN) * (HD + 4) + 2 * rows) * (int)sizeof(float);
}

// Block: (g, keys blockIdx.x * R .. + R), R = blockDim.x / 2: dK and dV of
// those keys, streaming every query tile (Q, dO, LSE and D double-buffered).
template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
attention_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int T, float scale) {
  constexpr int RS = HD + 4, BN = tile_rows<HD>(), NT = BN / 8, NO = HD / 8;
  extern __shared__ __align__(16) float smem[];
  const int R = blockDim.x / 2;
  float* sK = smem;
  float* sV = sK + R * RS;
  float* sQ = sV + R * RS;       // two buffers
  float* sdO = sQ + 2 * BN * RS;  // two buffers
  float* sL = sdO + 2 * BN * RS;  // two buffers
  float* sD = sL + 2 * BN;        // two buffers
  const int g = blockIdx.y, k0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const size_t base = (size_t)g * T * HD;
  const float* qg = q + base;
  const float* dog = dout + base;
  const float* lg = lse + (size_t)g * T;
  const float* Dg = D + (size_t)g * T;

  load_rows<HD>(sK, k + base, k0, R, T);
  load_rows<HD>(sV, v + base, k0, R, T);
  load_rows<HD>(sQ, qg, 0, BN, T);
  load_rows<HD>(sdO, dog, 0, BN, T);
  load_vec(sL, lg, 0, BN, T);
  load_vec(sD, Dg, 0, BN, T);
  cp_async_commit();

  float acc_k[NO][4] = {}, acc_v[NO][4] = {};
  const float* sKw = sK + warp * 16 * RS;
  const float* sVw = sV + warp * 16 * RS;
  const int kr0 = k0 + warp * 16 + gr;  // key rows kr0 and kr0 + 8
  const int tiles = (T + BN - 1) / BN;
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    if (it + 1 < tiles) {
      const int r1 = (it + 1) * BN;
      load_rows<HD>(sQ + nxt * BN * RS, qg, r1, BN, T);
      load_rows<HD>(sdO + nxt * BN * RS, dog, r1, BN, T);
      load_vec(sL + nxt * BN, lg, r1, BN, T);
      load_vec(sD + nxt * BN, Dg, r1, BN, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cQ = sQ + cur * BN * RS;
    const float* cdO = sdO + cur * BN * RS;
    const float* cL = sL + cur * BN;
    const float* cD = sD + cur * BN;

    float st[NT][4] = {}, dpt[NT][4] = {};
    mma_abt<HD / 8, NT, RS>(st, sKw, cQ);    // S^T = K Q^T
    mma_abt<HD / 8, NT, RS>(dpt, sVw, cdO);  // dP^T = V dO^T
    const int q0 = it * BN;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + 2 * t + (e & 1);  // query within the tile
        const bool in = q0 + i < T && kr0 + 8 * (e >> 1) < T;
        const float p = in ? expf(st[n][e] * scale - cL[i]) : 0.0f;
        dpt[n][e] = p * (dpt[n][e] - cD[i]);  // dS^T
        st[n][e] = p;                         // P^T
      }
    mma_pb<NT, NO, RS>(acc_v, st, cdO);  // dV += P^T dO
    mma_pb<NT, NO, RS>(acc_k, dpt, cQ);  // dK += dS^T Q
    __syncthreads();  // this buffer is free for the copy after next
  }
  const float one[2] = {1.0f, 1.0f}, sc[2] = {scale, scale};
  store_rows<HD>(dv + base, acc_v, k0 + warp * 16, T, one);
  store_rows<HD>(dk + base, acc_k, k0 + warp * 16, T, sc);
}

// Block: (g, query rows blockIdx.x * R .. + R), R = blockDim.x / 2: dQ of
// those rows, streaming every key tile (K and V double-buffered).
template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
attention_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, float* __restrict__ dq,
                        int T, float scale) {
  constexpr int RS = HD + 4, BN = tile_rows<HD>(), NT = BN / 8, NO = HD / 8;
  extern __shared__ __align__(16) float smem[];
  const int R = blockDim.x / 2;
  float* sQ = smem;
  float* sdO = sQ + R * RS;
  float* sK = sdO + R * RS;      // two buffers
  float* sV = sK + 2 * BN * RS;  // two buffers
  float* sL = sV + 2 * BN * RS;
  float* sD = sL + R;
  const int g = blockIdx.y, q0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const size_t base = (size_t)g * T * HD;
  const float* kg = k + base;
  const float* vg = v + base;

  load_rows<HD>(sQ, q + base, q0, R, T);
  load_rows<HD>(sdO, dout + base, q0, R, T);
  load_vec(sL, lse + (size_t)g * T, q0, R, T);
  load_vec(sD, D + (size_t)g * T, q0, R, T);
  load_rows<HD>(sK, kg, 0, BN, T);
  load_rows<HD>(sV, vg, 0, BN, T);
  cp_async_commit();

  float acc[NO][4] = {};
  const int w0 = warp * 16;  // the warp's rows within the block
  const int tiles = (T + BN - 1) / BN;
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    if (it + 1 < tiles) {
      load_rows<HD>(sK + nxt * BN * RS, kg, (it + 1) * BN, BN, T);
      load_rows<HD>(sV + nxt * BN * RS, vg, (it + 1) * BN, BN, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cK = sK + cur * BN * RS;
    const float* cV = sV + cur * BN * RS;

    float s[NT][4] = {}, dp[NT][4] = {};
    mma_abt<HD / 8, NT, RS>(s, sQ + w0 * RS, cK);    // S = Q K^T
    mma_abt<HD / 8, NT, RS>(dp, sdO + w0 * RS, cV);  // dP = dO V^T
    const int kb = it * BN;
    float Lr[2], Dr[2];
    bool row_in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Lr[h] = sL[w0 + gr + 8 * h];
      Dr[h] = sD[w0 + gr + 8 * h];
      row_in[h] = q0 + w0 + gr + 8 * h < T;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool in = row_in[h] && kb + 8 * n + 2 * t + (e & 1) < T;
        const float p = in ? expf(s[n][e] * scale - Lr[h]) : 0.0f;
        s[n][e] = p * (dp[n][e] - Dr[h]);  // dS
      }
    mma_pb<NT, NO, RS>(acc, s, cK);  // dQ += dS K
    __syncthreads();  // this buffer is free for the copy after next
  }
  const float sc[2] = {scale, scale};
  store_rows<HD>(dq + base, acc, q0 + w0, T, sc);
}

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int G, int T, float scale, cudaStream_t stream) {
  const int rows = rows_per_block(T);
  const int smem = fwd_smem<HD>(rows);
  cudaError_t err = raise_smem(attention_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + rows - 1) / rows, G);
  attention_fwd_kernel<HD><<<grid, 2 * rows, smem, stream>>>(q, k, v, o, lse,
                                                             T, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* dq, float* dk, float* dv, float* D, int G, int T,
               float scale, cudaStream_t stream) {
  const int nrows = G * T;
  attention_bwd_dot_kernel<<<(nrows * 32 + kMaxThreads - 1) / kMaxThreads,
                             kMaxThreads, 0, stream>>>(o, dout, D, nrows, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int rows = rows_per_block(T);
  dim3 grid((T + rows - 1) / rows, G);
  const int smem_kv = dkdv_smem<HD>(rows);
  err = raise_smem(attention_bwd_dkdv_kernel<HD>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_kernel<HD><<<grid, 2 * rows, smem_kv, stream>>>(
      q, k, v, dout, lse, D, dk, dv, T, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_q = dq_smem<HD>(rows);
  err = raise_smem(attention_bwd_dq_kernel<HD>, smem_q);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<HD><<<grid, 2 * rows, smem_q, stream>>>(
      q, k, v, dout, lse, D, dq, T, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16 operands
//
// The Pallas kernels' bf16 mode: products of bf16 operands with f32
// accumulation (mma.sync.m16n8k16, one pass), an f32 softmax, and a
// rounding to bf16 wherever the Pallas kernels round (_fwd_kernel,
// _bwd_kernel): the normalised weights w before w v, ds * scale before dq
// and dk, the outputs.  An online softmax would round exp(s - running max)
// instead, at other values, so the forward makes two passes over the key
// tiles: the row max and sum (the log-sum-exp) first, then P = exp(s -
// lse) rounded to bf16 into P V.  The backward is the flash form of the
// f32 kernels above, with the Pallas kernel's row term D = rowsum(P * dP)
// of the f32 softmax, which the dQ kernel recomputes in a first pass over
// the key tiles (rowsum(dO * O) of the forward's output would hold bf16(P)
// in place of P).  These
// kernels serve the shapes the wgmma kernels do not tile: hd 16, 32, 80
// and 128, and hd 40 and 64 at a T that is not a multiple of 128
// (attention_fwd_bf16 and attention_bwd_bf16 below dispatch).
//
// Tiles are bf16 rows of the padded head dim HP (padded_hd) and 8 more
// elements (row stride HP + 8: 16-byte cp.async copies stay aligned, and
// HP / 2 + 4 words, 4 times an odd number mod 32 banks (4 at hd 32, 64 and
// 128, 28 at 40, 12 at 80, 12 at 16), keeps the fragment loads and the
// ldmatrix rows free of conflicts).  A fragments and the B fragments
// of S = Q K^T are 32-bit loads of two neighbouring columns; the B
// fragments of P V (V, dO, Q or K read along their rows) come by
// ldmatrix.trans.  The accumulator of S (or P^T, dS, dS^T) is the A
// fragment of the next product once rounded: tiles 2j and 2j + 1 hold keys
// 2t, 2t + 1 and 8 + 2t, 9 + 2t of key step j, as m16n8k16 wants them.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: rows of matrix m from lanes 8m..8m+7.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Rows [r0, r0 + n) of a (T, HD) bf16 matrix into a tile of row stride
// HP + 8, by cp.async; rows past T and columns past HD are zero-filled.
template <int HD, int HP>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src,
                                               int r0, int n, int T) {
  static_assert(HD % 8 == 0 && HP >= HD, "16-byte chunks of a row");
  constexpr int C8 = HP / 8;
  for (int e = threadIdx.x; e < n * C8; e += blockDim.x) {
    const int r = e / C8, c = (e % C8) * 8;
    const bool in = r0 + r < T && c < HD;
    cp_async16(dst + r * (HP + 8) + c,
               src + (size_t)(in ? r0 + r : 0) * HD + (in ? c : 0), in);
  }
}

// acc (16 x 8 NT) += A Bt^T over 16 KS columns: A is the warp's 16 rows of
// a row-major shared tile, Bt 8 NT rows of another (row stride RS both).
template <int KS, int NT, int RS>
__device__ __forceinline__ void mma_abt_bf16(float (&acc)[NT][4],
                                             const bf16* A, const bf16* Bt) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* a = A + gr * RS + 16 * ks + 2 * t;
    const uint32_t af[4] = {ld32(a), ld32(a + 8 * RS), ld32(a + 8),
                            ld32(a + 8 * RS + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* b = Bt + (8 * n + gr) * RS + 16 * ks + 2 * t;
      mma_bf16(acc[n], af, ld32(b), ld32(b + 8));
    }
  }
}

// acc (16 x 8 NO) += P B over 16 KS rows of B: P's A fragments (see
// pack_frags), B a row-major shared tile (row stride RS).
template <int KS, int NO, int RS>
__device__ __forceinline__ void mma_pb_bf16(float (&acc)[NO][4],
                                            const uint32_t (&p)[KS][4],
                                            const bf16* B) {
  const int lane = threadIdx.x & 31;
  const bf16* base = B + (lane & 15) * RS + 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + 16 * ks * RS + 8 * n);
      mma_bf16(acc[n], p[ks], b[0], b[1]);
      mma_bf16(acc[n + 1], p[ks], b[2], b[3]);
    }
  }
}

// An accumulator of 8 KT columns, rounded to bf16, as the A fragments of
// KT / 2 key steps.
template <int KT>
__device__ __forceinline__ void pack_frags(uint32_t (&p)[KT / 2][4],
                                           const float (&s)[KT][4]) {
#pragma unroll
  for (int j = 0; j < KT / 2; ++j) {
    p[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    p[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    p[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    p[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

// Rows gr and gr + 8 of the warp's accumulator (16 x HP) to rows r0 + gr,
// r0 + gr + 8 of a bf16 out (and of an f32 out32 unless null) of row
// length HD, those below T; the padding columns are not stored.
template <int HD, int HP>
__device__ __forceinline__ void store_rows_bf16(bf16* out, float* out32,
                                                const float (&acc)[HP / 8][4],
                                                int r0, int T) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gr + 8 * h;
    if (row >= T) continue;
    const size_t off = (size_t)row * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float a = acc[n][2 * h], b = acc[n][2 * h + 1];
      *reinterpret_cast<uint32_t*>(out + off + 8 * n) = pack_bf16(a, b);
      if (out32 != nullptr)
        *reinterpret_cast<float2*>(out32 + off + 8 * n) = make_float2(a, b);
    }
  }
}

template <int HD>
int fwd_bf16_smem(int rows) {
  return (rows + 4 * tile_rows<HD>()) * (padded_hd<HD>() + 8) *
         (int)sizeof(bf16);
}

// Block: (g = blockIdx.y, query rows blockIdx.x * R .. + R), R = blockDim.x
// / 2.  Shared: Q (R rows), K and V (two buffers of tile_rows keys each).
// Pass 1 streams K for each row's max and sum; pass 2 streams K and V.
template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
attention_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ o32, float* __restrict__ lse,
                          int T, float scale) {
  constexpr int HP = padded_hd<HD>(), RS = HP + 8, BK = tile_rows<HD>(),
                KT = BK / 8, NO = HP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  const int R = blockDim.x / 2;
  bf16* sK = sQ + R * RS;
  bf16* sV = sK + 2 * BK * RS;
  const int g = blockIdx.y, q0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const size_t base = (size_t)g * T * HD;
  const bf16* kg = k + base;
  const bf16* vg = v + base;
  const bf16* sQw = sQ + warp * 16 * RS;
  const int tiles = (T + BK - 1) / BK;

  // pass 1: the row max m and sum l of exp(s - m)
  load_rows_bf16<HD, HP>(sQ, q + base, q0, R, T);
  load_rows_bf16<HD, HP>(sK, kg, 0, BK, T);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < tiles) {
      load_rows_bf16<HD, HP>(sK + (cur ^ 1) * BK * RS, kg, (it + 1) * BK, BK,
                             T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[KT][4] = {};
    mma_abt_bf16<HP / 16, KT, RS>(s, sQw, sK + cur * BK * RS);
    const int k0 = it * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = col < T ? s[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);  // finite: key k0 < T is valid
      alpha[h] = expf(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) rsum[e >> 1] += expf(s[n][e] - m[e >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];
    __syncthreads();  // this buffer is free for the copy after next
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / l[h];
  }

  // pass 2: O = bf16(exp(s - m) / l) V
  load_rows_bf16<HD, HP>(sK, kg, 0, BK, T);
  load_rows_bf16<HD, HP>(sV, vg, 0, BK, T);
  cp_async_commit();
  float acc[NO][4] = {};
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < tiles) {
      const int k1 = (it + 1) * BK;
      load_rows_bf16<HD, HP>(sK + (cur ^ 1) * BK * RS, kg, k1, BK, T);
      load_rows_bf16<HD, HP>(sV + (cur ^ 1) * BK * RS, vg, k1, BK, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[KT][4] = {};
    mma_abt_bf16<HP / 16, KT, RS>(s, sQw, sK + cur * BK * RS);
    const int k0 = it * BK;
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = col < T ? expf(s[n][e] * scale - m[e >> 1]) * inv[e >> 1]
                          : 0.0f;
      }
    uint32_t p[KT / 2][4];
    pack_frags<KT>(p, s);
    mma_pb_bf16<KT / 2, NO, RS>(acc, p, sV + cur * BK * RS);
    __syncthreads();  // this buffer is free for the copy after next
  }
  const int r0 = q0 + warp * 16;
  store_rows_bf16<HD, HP>(o + base, o32 == nullptr ? nullptr : o32 + base,
                          acc, r0, T);
  if (lse != nullptr && t == 0) {
    const int gr = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + gr + 8 * h < T)
        lse[(size_t)g * T + r0 + gr + 8 * h] = m[h] + logf(l[h]);
  }
}

template <int HD>
int bwd_bf16_smem(int rows, int vec) {
  return (2 * rows + 4 * tile_rows<HD>()) * (padded_hd<HD>() + 8) *
             (int)sizeof(bf16) +
         vec * (int)sizeof(float);
}

// Block: (g, keys blockIdx.x * R .. + R): dK and dV of those keys, streaming
// every query tile (Q, dO, LSE and D double-buffered).
template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
attention_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ D,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int T, float scale) {
  constexpr int HP = padded_hd<HD>(), RS = HP + 8, BN = tile_rows<HD>(),
                NT = BN / 8, NO = HP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = blockDim.x / 2;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + R * RS;
  bf16* sQ = sV + R * RS;         // two buffers
  bf16* sdO = sQ + 2 * BN * RS;   // two buffers
  float* sL = reinterpret_cast<float*>(sdO + 2 * BN * RS);  // two buffers
  float* sD = sL + 2 * BN;                                  // two buffers
  const int g = blockIdx.y, k0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const size_t base = (size_t)g * T * HD;
  const bf16* qg = q + base;
  const bf16* dog = dout + base;
  const float* lg = lse + (size_t)g * T;
  const float* Dg = D + (size_t)g * T;

  load_rows_bf16<HD, HP>(sK, k + base, k0, R, T);
  load_rows_bf16<HD, HP>(sV, v + base, k0, R, T);
  load_rows_bf16<HD, HP>(sQ, qg, 0, BN, T);
  load_rows_bf16<HD, HP>(sdO, dog, 0, BN, T);
  load_vec(sL, lg, 0, BN, T);
  load_vec(sD, Dg, 0, BN, T);
  cp_async_commit();

  float acc_k[NO][4] = {}, acc_v[NO][4] = {};
  const bf16* sKw = sK + warp * 16 * RS;
  const bf16* sVw = sV + warp * 16 * RS;
  const int kr0 = k0 + warp * 16 + gr;  // key rows kr0 and kr0 + 8
  const int tiles = (T + BN - 1) / BN;
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    if (it + 1 < tiles) {
      const int r1 = (it + 1) * BN;
      load_rows_bf16<HD, HP>(sQ + nxt * BN * RS, qg, r1, BN, T);
      load_rows_bf16<HD, HP>(sdO + nxt * BN * RS, dog, r1, BN, T);
      load_vec(sL + nxt * BN, lg, r1, BN, T);
      load_vec(sD + nxt * BN, Dg, r1, BN, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + cur * BN * RS;
    const bf16* cdO = sdO + cur * BN * RS;
    const float* cL = sL + cur * BN;
    const float* cD = sD + cur * BN;

    float st[NT][4] = {}, dst[NT][4] = {};
    mma_abt_bf16<HP / 16, NT, RS>(st, sKw, cQ);    // S^T = K Q^T
    mma_abt_bf16<HP / 16, NT, RS>(dst, sVw, cdO);  // dP^T = V dO^T
    const int q0 = it * BN;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + 2 * t + (e & 1);  // query within the tile
        const bool in = q0 + i < T && kr0 + 8 * (e >> 1) < T;
        const float p = in ? expf(st[n][e] * scale - cL[i]) : 0.0f;
        dst[n][e] = p * (dst[n][e] - cD[i]) * scale;  // dS^T * scale
        st[n][e] = p;                                 // P^T
      }
    uint32_t pf[NT / 2][4], dsf[NT / 2][4];
    pack_frags<NT>(pf, st);
    pack_frags<NT>(dsf, dst);
    mma_pb_bf16<NT / 2, NO, RS>(acc_v, pf, cdO);  // dV += P^T dO
    mma_pb_bf16<NT / 2, NO, RS>(acc_k, dsf, cQ);  // dK += dS^T Q
    __syncthreads();  // this buffer is free for the copy after next
  }
  store_rows_bf16<HD, HP>(dv + base, nullptr, acc_v, k0 + warp * 16, T);
  store_rows_bf16<HD, HP>(dk + base, nullptr, acc_k, k0 + warp * 16, T);
}

// Block: (g, query rows blockIdx.x * R .. + R): the row terms D of those
// rows and then dQ, streaming every key tile twice (K and V
// double-buffered).  D = rowsum(P * dP) with the f32 softmax P, the Pallas
// kernel's row term; rowsum(dO * O) with the forward's output would put
// bf16(P) in its place (O = bf16(P) V), which moves dq and dk by about half
// the bf16-vs-f32 gap.  D goes to global memory for the dK/dV kernel,
// launched after this one.
template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ D, bf16* __restrict__ dq,
                             int T, float scale) {
  constexpr int HP = padded_hd<HD>(), RS = HP + 8, BN = tile_rows<HD>(),
                NT = BN / 8, NO = HP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = blockDim.x / 2;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + R * RS;
  bf16* sK = sdO + R * RS;       // two buffers
  bf16* sV = sK + 2 * BN * RS;   // two buffers
  float* sL = reinterpret_cast<float*>(sV + 2 * BN * RS);
  const int g = blockIdx.y, q0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const size_t base = (size_t)g * T * HD;
  const bf16* kg = k + base;
  const bf16* vg = v + base;

  load_rows_bf16<HD, HP>(sQ, q + base, q0, R, T);
  load_rows_bf16<HD, HP>(sdO, dout + base, q0, R, T);
  load_vec(sL, lse + (size_t)g * T, q0, R, T);
  load_rows_bf16<HD, HP>(sK, kg, 0, BN, T);
  load_rows_bf16<HD, HP>(sV, vg, 0, BN, T);
  cp_async_commit();

  float acc[NO][4] = {};
  const int w0 = warp * 16;  // the warp's rows within the block
  float Dr[2] = {0.0f, 0.0f};  // per-lane partial sums during pass 1
  const int tiles = (T + BN - 1) / BN;
  // iterations 0 .. tiles - 1: pass 1 (D); tiles .. 2 tiles - 1: dQ
  for (int it = 0; it < 2 * tiles; ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    if (it + 1 < 2 * tiles) {
      const int k1 = ((it + 1) % tiles) * BN;
      load_rows_bf16<HD, HP>(sK + nxt * BN * RS, kg, k1, BN, T);
      load_rows_bf16<HD, HP>(sV + nxt * BN * RS, vg, k1, BN, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + cur * BN * RS;
    const bf16* cV = sV + cur * BN * RS;

    float s[NT][4] = {}, dp[NT][4] = {};
    mma_abt_bf16<HP / 16, NT, RS>(s, sQ + w0 * RS, cK);    // S = Q K^T
    mma_abt_bf16<HP / 16, NT, RS>(dp, sdO + w0 * RS, cV);  // dP = dO V^T
    const int kb = (it % tiles) * BN;
    float Lr[2];
    bool row_in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Lr[h] = sL[w0 + gr + 8 * h];
      row_in[h] = q0 + w0 + gr + 8 * h < T;
    }
    if (it == tiles) {  // D complete: the quad's sum, stored for dK/dV
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Dr[h] += __shfl_xor_sync(0xffffffffu, Dr[h], 1);
        Dr[h] += __shfl_xor_sync(0xffffffffu, Dr[h], 2);
        if (t == 0 && row_in[h])
          D[(size_t)g * T + q0 + w0 + gr + 8 * h] = Dr[h];
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool in = row_in[h] && kb + 8 * n + 2 * t + (e & 1) < T;
        const float p = in ? expf(s[n][e] * scale - Lr[h]) : 0.0f;
        if (it < tiles)
          Dr[h] += p * dp[n][e];
        else
          s[n][e] = p * (dp[n][e] - Dr[h]) * scale;  // dS * scale
      }
    if (it >= tiles) {
      uint32_t dsf[NT / 2][4];
      pack_frags<NT>(dsf, s);
      mma_pb_bf16<NT / 2, NO, RS>(acc, dsf, cK);  // dQ += dS K
    }
    __syncthreads();  // this buffer is free for the copy after next
  }
  store_rows_bf16<HD, HP>(dq + base, nullptr, acc, q0 + w0, T);
}

template <int HD>
int launch_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                    float* o32, float* lse, int G, int T, float scale,
                    cudaStream_t stream) {
  const int rows = rows_per_block(T);
  const int smem = fwd_bf16_smem<HD>(rows);
  cudaError_t err = raise_smem(attention_fwd_bf16_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + rows - 1) / rows, G);
  attention_fwd_bf16_kernel<HD><<<grid, 2 * rows, smem, stream>>>(
      q, k, v, o, o32, lse, T, scale);
  return (int)cudaGetLastError();
}

// The dQ kernel (which writes D), then the dK/dV kernel.
template <int HD>
int launch_bwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* lse, bf16* dq, bf16* dk,
                    bf16* dv, float* D, int G, int T, float scale,
                    cudaStream_t stream) {
  const int rows = rows_per_block(T);
  dim3 grid((T + rows - 1) / rows, G);
  const int smem_q = bwd_bf16_smem<HD>(rows, rows);
  cudaError_t err = raise_smem(attention_bwd_dq_bf16_kernel<HD>, smem_q);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_bf16_kernel<HD><<<grid, 2 * rows, smem_q, stream>>>(
      q, k, v, dout, lse, D, dq, T, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_kv = bwd_bf16_smem<HD>(rows, 4 * tile_rows<HD>());
  err = raise_smem(attention_bwd_dkdv_bf16_kernel<HD>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_bf16_kernel<HD><<<grid, 2 * rows, smem_kv, stream>>>(
      q, k, v, dout, lse, D, dk, dv, T, scale);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, HD>) for the head dims with instances;
// cudaErrorInvalidValue for any other.
template <typename F>
int with_hd(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 40: return f(std::integral_constant<int, 40>());
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The dynamic shared memory of this file's kernels at (T, hd), in bytes:
// out[0] the forward's, out[1] the dQ kernel's, out[2] the dK/dV kernel's
// (f32 operands, or bf16 ones with is_bf16 != 0).  cudaErrorInvalidValue
// for a head dim without an instance.
extern "C" int attention_smem_bytes(int T, int hd, int is_bf16, int* out) {
  return with_hd(hd, [&](auto h) {
    constexpr int HD = decltype(h)::value;
    const int rows = rows_per_block(T);
    out[0] = is_bf16 ? fwd_bf16_smem<HD>(rows) : fwd_smem<HD>(rows);
    out[1] = is_bf16 ? bwd_bf16_smem<HD>(rows, rows) : dq_smem<HD>(rows);
    out[2] = is_bf16 ? bwd_bf16_smem<HD>(rows, 4 * tile_rows<HD>())
                     : dkdv_smem<HD>(rows);
    return 0;
  });
}

// q, k, v, o: (G, T, hd) f32 contiguous, 16-byte aligned; lse: (G, T) f32
// or nullptr (the row log-sum-exps the backward reads).  Returns
// cudaErrorInvalidValue for a head dim without an instance.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int G, int T, int hd,
                             float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = (cudaStream_t)stream;
  return with_hd(hd, [&](auto h) {
    return launch_fwd<decltype(h)::value>(qf, kf, vf, of, lf, G, T, scale,
                                          st);
  });
}

// q, k, v, o, dout, dq, dk, dv: (G, T, hd) f32 contiguous, 16-byte aligned;
// lse: (G, T) from attention_fwd; D: (G, T) f32 scratch.  Returns
// cudaErrorInvalidValue for a head dim without an instance.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dq, void* dk, void* dv, void* D, int G,
                             int T, int hd, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* Df = static_cast<float*>(D);
  cudaStream_t st = (cudaStream_t)stream;
  return with_hd(hd, [&](auto h) {
    return launch_bwd<decltype(h)::value>(qf, kf, vf, of, gf, lf, dqf, dkf,
                                          dvf, Df, G, T, scale, st);
  });
}

extern "C" int attention_fwd_bf16_sm90_supported(int T, int hd);
extern "C" int attention_fwd_bf16_sm90(const void* q, const void* k,
                                       const void* v, void* o, void* o32,
                                       void* lse, int G, int T, int hd,
                                       float scale, void* stream);

// The bf16 instances.  q, k, v, o: (G, T, hd) bf16 contiguous, 16-byte
// aligned; o32: (G, T, hd) f32 or nullptr (the output before its
// rounding); lse: (G, T) f32 or nullptr (what the backward reads).  The
// forward runs attention_fwd_sm90.cu's wgmma kernel where it tiles the
// shape (hd 40 or 64, T a multiple of 128: the bf16 UNet's 32^2 level and
// the tiled config's 16 x 48 level), this file's mma.sync kernel
// elsewhere.
extern "C" int attention_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* o32, void* lse, int G, int T,
                                  int hd, float scale, void* stream) {
  if (attention_fwd_bf16_sm90_supported(T, hd))
    return attention_fwd_bf16_sm90(q, k, v, o, o32, lse, G, T, hd, scale,
                                   stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  float* of = static_cast<float*>(o32);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = (cudaStream_t)stream;
  return with_hd(hd, [&](auto h) {
    return launch_fwd_bf16<decltype(h)::value>(qb, kb, vb, ob, of, lf, G, T,
                                               scale, st);
  });
}

extern "C" int attention_bwd_bf16_sm90_supported(int T, int hd);
extern "C" int attention_bwd_bf16_sm90(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, void* dq, void* dk,
                                       void* dv, void* D, int G, int T,
                                       int hd, float scale, void* stream);

// q, k, v, dout, dq, dk, dv: (G, T, hd) bf16 contiguous, 16-byte aligned;
// lse (G, T) f32 from attention_fwd_bf16, 16-byte aligned; D: (G, T) f32
// scratch, where the dQ kernel puts the row terms.  o32 is not read: the
// row terms are rowsum(P * dP) with the f32 softmax, recomputed (see
// attention_bwd_dq_bf16_kernel); the argument keeps the f32 entry's
// order.  attention_bwd_sm90.cu's wgmma kernels
// run where they tile the shape (the forward's gate: hd 40 or 64, T a
// multiple of 128, the bf16 UNet's 32^2 level and the tiled config's 16 x
// 48 level), this file's mma.sync kernels elsewhere (the other head dims,
// and hd 40 or 64 at other lengths).
extern "C" int attention_bwd_bf16(const void* q, const void* k, const void* v,
                                  const void* o32, const void* dout,
                                  const void* lse, void* dq, void* dk,
                                  void* dv, void* D, int G, int T, int hd,
                                  float scale, void* stream) {
  if (attention_bwd_bf16_sm90_supported(T, hd))
    return attention_bwd_bf16_sm90(q, k, v, dout, lse, dq, dk, dv, D, G, T,
                                   hd, scale, stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* gb = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  float* Df = static_cast<float*>(D);
  cudaStream_t st = (cudaStream_t)stream;
  return with_hd(hd, [&](auto h) {
    return launch_bwd_bf16<decltype(h)::value>(qb, kb, vb, gb, lf, dqb, dkb,
                                               dvb, Df, G, T, scale, st);
  });
}
