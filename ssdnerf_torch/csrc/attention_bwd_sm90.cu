// The bf16 attention backward on Hopper's warpgroup products (sm_90a).
//
// Replaces, for bf16 operands at head dim 40 or 64 and T a multiple of 128
// (the bf16 UNet's 32^2 level: T = 1024, hd 64, 8 scenes x 4 heads; the
// tiled config's 16 x 48 level: T = 768, hd 40), the Pallas kernel
// ssdnerf_tpu/ops/pallas/attention.py:_bwd_kernel (reached through
// vmem_attention -> _bwd_rule); attention.cu's mma.sync kernels keep the
// other shapes.  Semantics are those of attention.cu's bf16 backward, at
// the Pallas kernel's rounding points: with the forward's own log-sum-exp
// L and the Pallas kernel's row term D = rowsum(P * dP),
//   P = exp(scale q.k - L),  dP = dO V^T,  dS = P (dP - D)  (all f32),
//   dV = sum bf16(P)^T dO,  dK = sum bf16(scale dS)^T Q,
//   dQ = sum bf16(scale dS) K,
// the sums in f32, each gradient rounded to bf16 once.
//
// Bound on the H100: the five products, 10 hd T^2 operations a program,
// at the dense bf16 rate (0.0217 ms at G = 32, T = 1024, hd 64; 0.0076 at
// T = 768, hd 40; the bytes are a few MB).  Two kernels, so that every
// output element has one writer and the gradients are bitwise
// reproducible (no atomics on dQ): the dQ kernel forms D in a first pass
// over the key tiles (S and dP) and then runs three products (S and dP
// again, and dQ); the dK/dV kernel, launched after it, four (S^T, dP^T,
// dV, dK).  That is 18 hd T^2 operations (0.038 ms at the dense rate at T
// = 1024, hd 64) and 3 T^2 exponentials a program (~0.025 ms on the SFU).
// The design follows attention_fwd_sm90.cu:
//   - a CTA owns 128 rows (keys in the dK/dV kernel, queries in the dQ
//     kernel): two consumer warpgroups of 64 rows each, and a producer
//     warpgroup of which one thread issues the copies; setmaxnreg moves
//     its registers to the consumers (240 a thread);
//   - the owned tiles arrive once by TMA, and each consumer keeps the A
//     fragments of its 64 rows (K and V, or Q and dO) in registers;
//   - the producer streams 64-row tiles by TMA (128-byte swizzle) into a
//     ring of 4 stages guarded by mbarriers: Q and dO with their L and D
//     slices (bulk copies), or K and V;
//   - S^T = K Q^T and dP^T = V dO^T (S = Q K^T and dP = dO V^T) are wgmma
//     m64n64k16 with A from registers and B in shared memory, K-major;
//   - P^T and dS^T are formed in registers in exp2 (log2(e) scale folded
//     into one FMA); L and D index the columns (queries) of the transposed
//     accumulators, so each thread reads those of its columns from the
//     stage's slices;
//   - P^T and dS^T, rounded to bf16, are the register A fragments of
//     dV += P^T dO and dK += dS^T Q (keys on M), with dO and Q read from
//     the same shared tiles MN-major (dQ += dS K reads K so);
//   - shared memory holds a token as a 64-column row whatever the head
//     dim; at hd 40 TMA fills columns 40-63 with zeros, the products over
//     the head dim (S, dP) run 3 k16 steps instead of 4, and those whose N
//     is the head dim (dV, dK, dQ) compute 64 columns of which the first
//     40 are stored (the canonical MN-major layout of a 128-byte-swizzled
//     B tile spans 64 columns, so N stays 64);
//   - the two consumer warpgroups take turns at issuing their products,
//     each turn the last two products of one tile with the first two of
//     the next, so that one warpgroup's exponentials overlap the other's
//     products; a stage is released (mbarrier arrive of each consumer
//     warp) once the wait on the turn after it covers every product that
//     read it.
// What keeps it above the bound: the dQ kernel's four extra products (its
// first pass runs without turns), the exponentials and the elementwise
// work, which the turns hide only in part, the m64n64 products (N = 64 is
// the head dim, or its padding), and one CTA an SM (256 CTAs at G = 32, T =
// 1024: two waves over 132 SMs; 192 at T = 768, 1.45 waves: 240 registers
// a consumer thread leave no room for a third consumer warpgroup).

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;       // rows a CTA owns (2 warpgroups x 64)
constexpr int kBN = 64;        // rows a streamed tile
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups
// a third warpgroup produces (one thread issues the copies), so that
// setmaxnreg can move its registers to the consumers
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kTileBytes = kBN * kRow * 2;  // one 64-row bf16 tile
constexpr int kVecBytes = kBN * 4;         // a 64-row f32 slice of L or D
constexpr float kLog2e = 1.4426950408889634f;
// owned tiles (two 64-row halves of each of two matrices), the ring, the
// L and D slices (dK/dV only), barriers, alignment slack
constexpr int kDkdvSmem = 1024 + 4 * kTileBytes + 2 * kStages * kTileBytes +
                          2 * kStages * kVecBytes + 256;
constexpr int kDqSmem = 1024 + 4 * kTileBytes + 2 * kStages * kTileBytes + 256;

// d (64 x 64) = A B over the head dim, A the register fragments of its
// k16 steps (see load_frags), B a K-major 64-row tile in shared memory;
// issued, not waited for.
template <int HD>
__device__ __forceinline__ void wgmma_rs_hd(float (&d)[32],
                                            const uint32_t (&a)[4][4],
                                            const bf16* b) {
  const uint64_t db = desc_k_major(b);
#pragma unroll
  for (int ks = 0; ks < kSteps<HD>; ++ks)
    wgmma_rs<0>(d, a[ks], db + 2 * ks, ks > 0);
}

// The A fragments (the k16 steps over the head dim) of the warp's 16
// rows of a 64-row, 128-byte-swizzled tile in shared memory: register r
// of step ks holds row 16 w + gr (+ 8 if r & 1), columns 16 ks + 2 t (+ 8
// if r >> 1) and the next, whose 16-byte chunk 2 ks + (r >> 1) the swizzle
// stores at chunk (2 ks + (r >> 1)) ^ (row % 8).
template <int HD>
__device__ __forceinline__ void load_frags(uint32_t (&f)[4][4],
                                           const bf16* tile) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const uint8_t* base = reinterpret_cast<const uint8_t*>(tile);
#pragma unroll
  for (int ks = 0; ks < kSteps<HD>; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * ((threadIdx.x >> 5) & 3) + gr + 8 * (r & 1);
      const int chunk = (2 * ks + (r >> 1)) ^ (row & 7);
      f[ks][r] = *reinterpret_cast<const uint32_t*>(base + row * 128 +
                                                    chunk * 16 + 4 * t);
    }
}

// Rows gr and gr + 8 of the warp's 16 rows of an accumulator to row `r0`
// (and r0 + 8) of a (rows, HD) bf16 matrix, rounded once: its first HD / 8
// n8 tiles (the columns past HD, zero, are not stored).
template <int HD>
__device__ __forceinline__ void store_rows_bf16(bf16* out,
                                                const float (&acc)[32],
                                                size_t r0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* o = out + (r0 + 8 * h) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 4);  // one arrive a consumer warp
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Rows row .. row + 127 of a map's matrix into two 64-row halves at dst.
__device__ __forceinline__ void load_owned(bf16* dst, const CUtensorMap* map,
                                           int row, uint64_t* bar) {
  tma_load(dst, map, 0, row, bar);
  tma_load(dst + kBN * kRow, map, 0, row + kBN, bar);
}

// The two consumer warpgroups take turns at issuing their products: named
// barrier 1 + w is warpgroup w's turn, which the other warpgroup's arrive
// opens.  One warpgroup's softmax and dS then run while the other's
// products keep the tensor cores busy.
__device__ __forceinline__ void turn_wait(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 2, 256;\n" ::: "memory");
  else
    asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

// Registers move from the producer warpgroup to the consumers, which hold
// up to four 64 x 64 f32 accumulators and four sets of A fragments: 384
// threads launch with 168 each (64,512 of the SM's 65,536), and 128 x 24 +
// 256 x 240 is the same 64,512.  setmaxnreg.inc waits for registers that
// the block does not hold, so the sum must not grow.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// A consumer warp's release of ring stage st.
__device__ __forceinline__ void release(uint64_t* empty, int st) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
}

// The A fragments of P^T and bf16(scale dS^T) of a tile from the S^T and
// dP^T accumulators (which it leaves as they are: an accumulator that
// other instructions write would serialise the products in flight); L and
// Dq: the tile's L and D slices from the thread's first column 2 t
// (fragment register r of step ks holds queries 16 ks + 2 t + 8 (r >> 1)
// and the next).
__device__ __forceinline__ void dkdv_softmax(uint32_t (&pf)[4][4],
                                             uint32_t (&dsf)[4][4],
                                             const float (&s)[32],
                                             const float (&dp)[32],
                                             const float* L, const float* Dq,
                                             float c, float scale) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int col = 16 * ks + 8 * hi;
      const float2 l = *reinterpret_cast<const float2*>(L + col);
      const float2 d = *reinterpret_cast<const float2*>(Dq + col);
      const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
      const float d0 = d.x * scale, d1 = d.y * scale;
#pragma unroll
      for (int lo = 0; lo < 2; ++lo) {  // rows gr, gr + 8
        const int r = 2 * hi + lo, e = 4 * (2 * ks + hi) + 2 * lo;
        const float p0 = ex2(fmaf(s[e], c, -l0));
        const float p1 = ex2(fmaf(s[e + 1], c, -l1));
        pf[ks][r] = pack_bf16(p0, p1);
        dsf[ks][r] = pack_bf16(p0 * fmaf(dp[e], scale, -d0),
                               p1 * fmaf(dp[e + 1], scale, -d1));
      }
    }
}

// Grid (T / 128, G): dK and dV of keys blockIdx.x * 128 .. + 128 of program
// blockIdx.y, streaming every query tile.  Warpgroups 0-1 consume (64 keys
// each), warpgroup 2 produces.  D comes from the dQ kernel, launched
// first.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ D,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int T, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(base);
  bf16* sV = reinterpret_cast<bf16*>(base + 2 * kTileBytes);
  bf16* sQ = reinterpret_cast<bf16*>(base + 4 * kTileBytes);
  bf16* sdO = sQ + kStages * kBN * kRow;
  float* sL = reinterpret_cast<float*>(sdO + kStages * kBN * kRow);
  float* sD = sL + kStages * kBN;
  uint64_t* full = reinterpret_cast<uint64_t*>(sD + kStages * kBN);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int g = blockIdx.y, k0 = blockIdx.x * kBM;
  const int row0 = g * T;  // first row of program g in the (G T, hd) view
  const int tiles = T / kBN;
  const int warp = threadIdx.x >> 5;
  init_ring(full, empty, kvbar);

  if (warp >= kConsumers * 4) {
    // ---- producer: K and V once, then Q, dO, L and D tiles ----
    producer_regs();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(kvbar, 4 * kTileBytes);
      load_owned(sK, &tm_k, row0 + k0, kvbar);
      load_owned(sV, &tm_v, row0 + k0, kvbar);
      for (int it = 0; it < tiles; ++it) {
        const int st = it % kStages, round = it / kStages;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        const int q = row0 + it * kBN;
        mbar_expect_tx(&full[st], 2 * kTileBytes + 2 * kVecBytes);
        tma_load(sQ + st * kBN * kRow, &tm_q, 0, q, &full[st]);
        tma_load(sdO + st * kBN * kRow, &tm_do, 0, q, &full[st]);
        bulk_load(sL + st * kBN, lse + q, kVecBytes, &full[st]);
        bulk_load(sD + st * kBN, D + q, kVecBytes, &full[st]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg, keys k0 + 64 wg + 16 (warp % 4) + ...
    // Each turn issues dV += P^T dO and dK += dS^T Q of tile it together
    // with S^T = K Q^T and dP^T = V dO^T of tile it + 1 (one group), then
    // passes the turn; the wait for that group starts the next tile's
    // softmax.  The last tile's turn, without a next tile, is peeled off,
    // so that no product is issued under a condition.
    consumer_regs();
    const int wg = warp >> 2, t = threadIdx.x & 3;
    const bf16* k = sK + wg * kBN * kRow;
    const bf16* v = sV + wg * kBN * kRow;
    const float c = scale * kLog2e;
    float acc_v[32], acc_k[32], s[32], dp[32];  // sums start at tile 0
    uint32_t pf[4][4], dsf[4][4], kf[4][4], vf[4][4];
    mbar_wait(kvbar, 0);
    load_frags<HD>(kf, k);  // the warpgroup's keys, A of S^T and dP^T
    load_frags<HD>(vf, v);
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    mbar_wait(&full[0], 0);
    turn_wait(wg);
    wgmma_fence();
    wgmma_rs_hd<HD>(s, kf, sQ);    // S^T = K Q^T
    wgmma_rs_hd<HD>(dp, vf, sdO);  // dP^T = V dO^T
    wgmma_commit();
    turn_pass(wg);

    for (int it = 0; it < tiles - 1; ++it) {
      const int st = it % kStages, nst = (it + 1) % kStages;
      wgmma_wait();
      if (it > 0) release(empty, (it - 1) % kStages);
      dkdv_softmax(pf, dsf, s, dp, sL + st * kBN + 2 * t,
                   sD + st * kBN + 2 * t, c, scale);
      mbar_wait(&full[nst], ((it + 1) / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      // dV += P^T dO, dK += dS^T Q
      wgmma_rs_tile(acc_v, pf, sdO + st * kBN * kRow, it > 0);
      wgmma_rs_tile(acc_k, dsf, sQ + st * kBN * kRow, it > 0);
      wgmma_rs_hd<HD>(s, kf, sQ + nst * kBN * kRow);
      wgmma_rs_hd<HD>(dp, vf, sdO + nst * kBN * kRow);
      wgmma_commit();
      turn_pass(wg);
    }
    const int st = (tiles - 1) % kStages;
    wgmma_wait();
    if (tiles > 1) release(empty, (tiles - 2) % kStages);
    dkdv_softmax(pf, dsf, s, dp, sL + st * kBN + 2 * t,
                 sD + st * kBN + 2 * t, c, scale);
    turn_wait(wg);
    wgmma_fence();
    wgmma_rs_tile(acc_v, pf, sdO + st * kBN * kRow);
    wgmma_rs_tile(acc_k, dsf, sQ + st * kBN * kRow);
    wgmma_commit();
    if (wg == 0) turn_pass(wg);  // the last turn is warpgroup 1's
    wgmma_wait();
    release(empty, st);

    const size_t r0 = (size_t)row0 + k0 + wg * 64 + (warp & 3) * 16 +
                      ((threadIdx.x & 31) >> 2);
    store_rows_bf16<HD>(dv, acc_v, r0);
    store_rows_bf16<HD>(dk, acc_k, r0);
  }
}

// Adds to dsum[h] the thread's share of rowsum(P * dP) of its rows gr and
// gr + 8 (h) over a tile, P the f32 softmax, from the S and dP
// accumulators (left as they are).
__device__ __forceinline__ void row_sums(float (&dsum)[2],
                                         const float (&s)[32],
                                         const float (&dp)[32],
                                         const float (&l2)[2], float c) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = (e >> 1) & 1;
    dsum[h] = fmaf(ex2(fmaf(s[e], c, -l2[h])), dp[e], dsum[h]);
  }
}

// The A fragments of bf16(scale dS) of a tile from the S and dP
// accumulators (left as they are, as in dkdv_softmax); l2 and ds: L
// log2(e) and D scale of the thread's rows.
__device__ __forceinline__ void dq_softmax(uint32_t (&dsf)[4][4],
                                           const float (&s)[32],
                                           const float (&dp)[32],
                                           const float (&l2)[2],
                                           const float (&ds)[2], float c,
                                           float scale) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r & 1, e = 4 * (2 * ks + (r >> 1)) + 2 * h;
      const float p0 = ex2(fmaf(s[e], c, -l2[h]));
      const float p1 = ex2(fmaf(s[e + 1], c, -l2[h]));
      dsf[ks][r] = pack_bf16(p0 * fmaf(dp[e], scale, -ds[h]),
                             p1 * fmaf(dp[e + 1], scale, -ds[h]));
    }
}

// Grid (T / 128, G): the row terms D of query rows blockIdx.x * 128 .. +
// 128 of program blockIdx.y, then their dQ, streaming every key tile
// twice.  D = rowsum(P * dP) with the f32 softmax P is the Pallas kernel's
// row term (rowsum(dO * O) of the forward's output would hold bf16(P) in
// place of P, which moves dq and dk by about half the bf16-vs-f32 gap); it
// goes to global memory for the dK/dV kernel.  Warpgroups 0-1 consume (64
// rows each), warpgroup 2 produces.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             float* __restrict__ D, bf16* __restrict__ dq,
                             int T, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sdO = reinterpret_cast<bf16*>(base + 2 * kTileBytes);
  bf16* sK = reinterpret_cast<bf16*>(base + 4 * kTileBytes);
  bf16* sV = sK + kStages * kBN * kRow;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kBN * kRow);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int g = blockIdx.y, q0 = blockIdx.x * kBM;
  const int row0 = g * T;
  const int tiles = T / kBN;
  const int warp = threadIdx.x >> 5;
  init_ring(full, empty, qbar);

  if (warp >= kConsumers * 4) {
    // ---- producer: Q and dO once, then K and V tiles, twice ----
    producer_regs();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(qbar, 4 * kTileBytes);
      load_owned(sQ, &tm_q, row0 + q0, qbar);
      load_owned(sdO, &tm_do, row0 + q0, qbar);
      for (int it = 0; it < 2 * tiles; ++it) {
        const int st = it % kStages, round = it / kStages;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        const int key = row0 + (it % tiles) * kBN;
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        tma_load(sK + st * kBN * kRow, &tm_k, 0, key, &full[st]);
        tma_load(sV + st * kBN * kRow, &tm_v, 0, key, &full[st]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg, rows q0 + 64 wg + 16 (warp % 4) + ...
    // Ring iterations 0 .. tiles - 1 form D; tiles .. 2 tiles - 1 take
    // turns as in the dK/dV kernel: dQ += dS K of a tile with S = Q K^T
    // and dP = dO V^T of the next.
    consumer_regs();
    const int wg = warp >> 2;
    const float c = scale * kLog2e;
    // the thread's rows r0 and r0 + 8
    const size_t r0 = (size_t)row0 + q0 + wg * 64 + (warp & 3) * 16 +
                      ((threadIdx.x & 31) >> 2);
    const float l2[2] = {lse[r0] * kLog2e, lse[r0 + 8] * kLog2e};
    float acc[32], s[32], dp[32];  // the sum starts at tile 0
    uint32_t dsf[4][4], qf[4][4], dof[4][4];
    mbar_wait(qbar, 0);
    load_frags<HD>(qf, sQ + wg * kBN * kRow);  // the warpgroup's rows, A
    load_frags<HD>(dof, sdO + wg * kBN * kRow);  // of S and of dP

    float dsum[2] = {0.0f, 0.0f};
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      wgmma_fence();
      wgmma_rs_hd<HD>(s, qf, sK + st * kBN * kRow);
      wgmma_rs_hd<HD>(dp, dof, sV + st * kBN * kRow);
      wgmma_commit();
      wgmma_wait();
      release(empty, st);
      row_sums(dsum, s, dp, l2, c);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the quad's sum
      dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 1);
      dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 2);
    }
    if ((threadIdx.x & 3) == 0) {
      D[r0] = dsum[0];
      D[r0 + 8] = dsum[1];
    }
    const float ds[2] = {dsum[0] * scale, dsum[1] * scale};

    // ring iteration n0 + it: tile it of the second pass
    const int n0 = tiles;
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    mbar_wait(&full[n0 % kStages], (n0 / kStages) & 1);
    turn_wait(wg);
    wgmma_fence();
    // S = Q K^T, dP = dO V^T
    wgmma_rs_hd<HD>(s, qf, sK + (n0 % kStages) * kBN * kRow);
    wgmma_rs_hd<HD>(dp, dof, sV + (n0 % kStages) * kBN * kRow);
    wgmma_commit();
    turn_pass(wg);

    for (int it = 0; it < tiles - 1; ++it) {
      const int i = n0 + it, st = i % kStages, nst = (i + 1) % kStages;
      wgmma_wait();
      if (it > 0) release(empty, (i - 1) % kStages);
      dq_softmax(dsf, s, dp, l2, ds, c, scale);
      mbar_wait(&full[nst], ((i + 1) / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      wgmma_rs_tile(acc, dsf, sK + st * kBN * kRow, it > 0);  // dQ += dS K
      wgmma_rs_hd<HD>(s, qf, sK + nst * kBN * kRow);
      wgmma_rs_hd<HD>(dp, dof, sV + nst * kBN * kRow);
      wgmma_commit();
      turn_pass(wg);
    }
    const int last = n0 + tiles - 1, st = last % kStages;
    wgmma_wait();
    if (tiles > 1) release(empty, (last - 1) % kStages);
    dq_softmax(dsf, s, dp, l2, ds, c, scale);
    turn_wait(wg);
    wgmma_fence();
    wgmma_rs_tile(acc, dsf, sK + st * kBN * kRow);
    wgmma_commit();
    if (wg == 0) turn_pass(wg);  // the last turn is warpgroup 1's
    wgmma_wait();
    release(empty, st);
    store_rows_bf16<HD>(dq, acc, r0);
  }
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, void* dq, void* dk, void* dv, void* D,
               int G, int T, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, G * T, HD, kBN) ||
      !tensor_map(&tk, k, G * T, HD, kBN) ||
      !tensor_map(&tv, v, G * T, HD, kBN) ||
      !tensor_map(&tdo, dout, G * T, HD, kBN))
    return (int)cudaErrorInvalidValue;
  auto dkdv = attention_bwd_dkdv_sm90_kernel<HD>;
  auto dqk = attention_bwd_dq_sm90_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const float* lf = static_cast<const float*>(lse);
  float* Df = static_cast<float*>(D);
  dim3 grid(T / kBM, G);
  dqk<<<grid, kThreads, kDqSmem, stream>>>(tq, tk, tv, tdo, lf, Df,
                                           static_cast<bf16*>(dq), T, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<grid, kThreads, kDkdvSmem, stream>>>(
      tq, tk, tv, tdo, lf, Df, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// True if attention_bwd_bf16_sm90 takes (T, hd): hd 40 or 64, T a
// multiple of 128 (the forward's gate, attention_fwd_bf16_sm90_supported).
extern "C" int attention_bwd_bf16_sm90_supported(int T, int hd) {
  return (hd == 40 || hd == 64) && T > 0 && T % kBM == 0;
}

// q, k, v, dout, dq, dk, dv: (G, T, hd) bf16 contiguous, 16-byte aligned;
// lse (G, T) f32 from the forward, 16-byte aligned; D: (G, T) f32 scratch.
// Launches the dQ kernel (which also writes D), then the dK/dV kernel.
// Returns cudaErrorInvalidValue for a shape without support or a tensor
// map that could not be made.
extern "C" int attention_bwd_bf16_sm90(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, void* dq, void* dk,
                                       void* dv, void* D, int G, int T,
                                       int hd, float scale, void* stream) {
  if (!attention_bwd_bf16_sm90_supported(T, hd) || G <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return hd == 40 ? launch_bwd<40>(q, k, v, dout, lse, dq, dk, dv, D, G, T,
                                   scale, st)
                  : launch_bwd<64>(q, k, v, dout, lse, dq, dk, dv, D, G, T,
                                   scale, st);
}
