// Fused triplane decode + packed alpha composite (forward only), for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel ssdnerf_tpu/ops/pallas/decode.py:
// _fwd_kernel_composite (reached through triplane_decode_composite).  Input
// is the cross-ray packed layout of ops/packing.py:pack_groups: groups of GR
// rays share P slots, each ray's samples a contiguous 8-aligned segment that
// starts at soffs[ray].  Per slot it decodes as decode.cu does (4 taps x 3
// planes, the MLP, dir_out[rid]); per ray it writes weights_sum, depth and
// the premultiplied rgb.  Density and colour never reach device memory.
//
// Semantics are those of the port's split path (trunc_exp / sigmoid with
// saturation, then ops/packing.py:composite_packed), not the TPU kernel's:
// the TPU kernel took a group-wide lane cumsum and subtracted a prefix-max
// segment base, a subtraction that perturbs T on saturated scenes (the
// cancellation behind the round-5 soak NaN).  Here each ray's optical depth
// is scanned over its own segment only:
//   tau = valid ? min(exp(sigma_raw) * dt, 60) : 0,
//   T = exp(-(incl - tau)),  w = valid && T >= T_thresh ? (1 - e^-tau) T : 0,
// and w, w t, w r, w g, w b are summed per ray.  Dead slots inside a
// segment (a ray's last block past its valid count, the group's tail) carry
// tau = 0 and w = 0.  A fully truncated ray (soffs == P) gets zeros.
//
// A bf16 instance reads bf16 planes (padded to 4-channel taps) and rounds
// as the Pallas kernel does (triplane.cuh); the composite stays f32.
//
// What bounds it on the H100: the decode of the valid slots, as for the
// split forward (decode.cu): the SFU's sigmoids and the heads' elementwise
// instructions, then the tap reads; the composite adds ~20 flops and two
// exponentials a slot.  The first design here (a 256-thread block a group,
// thread = slot, the MLP as f32 FMA loops over weights in shared memory,
// exact expf and division in SiLU, the whole parameter block copied into
// shared memory by each of the S x G blocks) spent 61% of the time the
// tensor-core split forward spends on all slots, though it decodes only
// the valid ones, ~25% of them on a coherent render (PERF.md).  On such a
// render most groups hold no valid slot and most of the rest are nearly
// full, and a ray's dead slots (past its valid count) can fill the rest of
// its group.  So:
//   - blocks of 4 warps walk runs of kGroups (scene, group) pairs, staging
//     the base weight's B fragments, split once, and the head rows once a
//     run (decode_fwd.cuh).  Runs, not a persistent walk with a stride:
//     the work of a group varies from none to full, and a stride of a
//     card's worth of blocks (528 on the H100) is a multiple of the 8
//     groups of an image row, so each block met the same columns of the
//     image, some only empty groups and others only full ones; the block
//     scheduler balances runs as they end;
//   - compaction: each thread holds 8 slots' validity a word (read during
//     the scan of the group before); a block prefix of the counts (warp
//     shuffles, one barrier) writes the valid slots' indices, in slot
//     order, and each word's count of valid slots before it;
//   - warp = 32 compacted slots: the split forward's warp tiles (features
//     staged in the warp's rows, the base product on the tensor cores, the
//     heads from the accumulator fragments by quad shuffles, SFU sigmoids;
//     an m tile with no valid slot is skipped); tau, the raw colour and t
//     go to shared memory by compacted index (20 bytes a slot; tau and the
//     colour at a fixed offset, which holds no register).  The colour's
//     sigmoid, whose exact division calls a slow path, waits for the scan,
//     which takes it only for the slots that weigh: in the decode loop it
//     made ptxas spill.  A group without a valid slot skips this and its
//     barrier;
//   - warp = ray (GR / 4 rays a warp): a ray's valid slots are one run of
//     the compacted order (its segment is one of the slot order), scanned
//     in chunks of 32 with a shuffle inclusive scan carried across chunks;
//     then the five sums are reduced over the warp and written once.  The
//     dead slots, whose tau is 0 and weight 0, are not visited.  Outputs
//     are 20 bytes a ray instead of 16 bytes a slot.
// The warps' counts, the segment starts, the words' prefixes and bits are
// double-buffered by the group's parity, so that the next group's
// compaction does not wait for this group's scan: two or three barriers a
// group.  Shared memory: the forward's (decode_fwd.cuh) plus ~22.3 bytes a
// slot, at most 151 KB (C = 8, hidden 128, P = 4096, GR = 16).  No launch
// bound: ptxas's own choice spills nothing in 14 of the 18 instances, the
// flagship's (C = 6, hidden 64) among them, and 12-60 bytes in four (f32
// at hidden 128 with C = 4, 6 and at C = 4, hidden 64; bf16 at C = 4,
// hidden 32); a bound of 4 blocks an SM (128 registers) made it spill in
// the f32 instances at hidden 64 and C = 6, 8 instead.

#include "decode_fwd.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWords = 4;  // 8-slot words a thread at most: P <= 4096

constexpr int kGroups = 4;  // groups a block walks

// Shared memory of a launch: the forward's part, per row the compacted
// index and dt of its slot (kThreads each), then per valid slot in
// compacted order tau and raw r, g, b (float4) and t, and two buffers (by the
// group's parity) of: the warps' counts, the segment starts (GR), each
// 8-slot word's count of valid slots before it (u16, P / 8 + 1) and
// validity bits (u8, P / 8); then the compacted slot indices (u16, P).
template <int C, int H>
constexpr int composite_smem_bytes(int P, int GR) {
  return FwdSmem<C, H>::kBytes + kThreads * 8 + 20 * P +
         2 * (kWarps * 4 + GR * 4 + (P / 8 + 1) * 2 + P / 8) + 2 * P;
}

// A thread's run of 8-slot words [w0, w1) of one group's validity bytes:
// raw loads, issued together (8 bytes at once where pv is 8-byte aligned).
__device__ __forceinline__ void load_valid(const uint8_t* __restrict__ pv,
                                           int w0, int w1, bool aligned,
                                           uint2 (&raw)[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int w = w0 + k;
    raw[k] = make_uint2(0u, 0u);
    if (w >= w1) continue;
    if (aligned) {
      raw[k] = *reinterpret_cast<const uint2*>(pv + 8 * w);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b)
        (b < 4 ? raw[k].x : raw[k].y) |= (uint32_t)pv[8 * w + b]
                                         << (8 * (b & 3));
    }
  }
}

// The validity bits of the raw words, a byte a word (bit b: slot 8 w + b),
// packed into one word, and their count.
__device__ __forceinline__ uint32_t valid_bits(const uint2 (&raw)[kWords],
                                               int& n) {
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      bits |= (uint32_t)(((raw[k].x >> (8 * b)) & 0xffu) != 0)
              << (8 * k + b);
      bits |= (uint32_t)(((raw[k].y >> (8 * b)) & 0xffu) != 0)
              << (8 * k + b + 4);
    }
  }
  n = __popc(bits);
  return bits;
}

template <int C, int H, bool kB>
__global__ void __launch_bounds__(kThreads)
triplane_decode_composite_kernel(
    const PlaneT<kB>* __restrict__ planes, const float* __restrict__ xyz,
    const int32_t* __restrict__ rid, const float* __restrict__ dir_out,
    const float* __restrict__ params, const float* __restrict__ pt,
    const float* __restrict__ pdt, const uint8_t* __restrict__ pvalid,
    const int32_t* __restrict__ soffs, float* __restrict__ weights_sum,
    float* __restrict__ depth, float* __restrict__ image, int S, int G,
    int P, int GR, int res, float scale, float sat, float T_thresh) {
  constexpr int F = Feat<C>::F, FS = Feat<C>::FS;
  const int n_rays = G * GR, n_words = P / 8;
  extern __shared__ uint4 smem[];
  const FwdSmem<C, H> sm(smem);
  int* sJ = reinterpret_cast<int*>(sm.end());  // (thread) compacted index
  float* sDt = reinterpret_cast<float*>(sJ + kThreads);  // (thread) dt
  // (P) tau and raw r, g, b: at a fixed offset, as the heads store them
  float4* s_out = reinterpret_cast<float4*>(sDt + kThreads);
  float* s_t = reinterpret_cast<float*>(s_out + P);         // (P) t
  int* s_count = reinterpret_cast<int*>(s_t + P);           // (2, warps)
  int* s_so = s_count + 2 * kWarps;                         // (2, GR)
  uint16_t* s_pre = reinterpret_cast<uint16_t*>(s_so + 2 * GR);
  uint8_t* s_bits = reinterpret_cast<uint8_t*>(s_pre + 2 * (n_words + 1));
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(s_bits + 2 * n_words);
  stage_weights<C, H, kB>(params, sm);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const float out_bias = params[H * F + 5 * H + t];
  constexpr int CS = kB ? padded_channels<C>() : C;
  const bool aligned = (reinterpret_cast<uintptr_t>(pvalid) & 7) == 0;
  // each thread's run of 8-slot words of a group
  const int words = (n_words + kThreads - 1) / kThreads;
  const int w0 = min(threadIdx.x * words, n_words);
  const int w1 = min(w0 + words, n_words);
  const int first = blockIdx.x * kGroups;
  const int last = min(first + kGroups, S * G);

  // the first group's validity; each later group's is read during the
  // scan of the one before
  uint2 raw[kWords];
  load_valid(pvalid + (size_t)first * P, w0, w1, aligned, raw);
  __syncthreads();  // the weights
  for (int pair = first; pair < last; ++pair) {
    const int s = pair / G, g = pair % G, parity = pair & 1;
    const size_t base = (size_t)pair * P;  // first slot of the group
    int* count = s_count + parity * kWarps;
    int* so = s_so + parity * GR;
    uint16_t* pre = s_pre + parity * (n_words + 1);
    uint8_t* wbits = s_bits + parity * n_words;

    // ---- 1. compaction: the valid slots' indices in slot order, and
    // each word's count of valid slots before it and its bits ----
    for (int r = threadIdx.x; r < GR; r += kThreads)
      so[r] = soffs[(size_t)pair * GR + r];
    int n;
    const uint32_t bits = valid_bits(raw, n);
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) count[warp] = incl;
    __syncthreads();
    int at = incl - n, n_valid = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int v = count[k];
      if (k < warp) at += v;
      n_valid += v;
    }
    for (int w = w0; w < w1; ++w) {
      const uint32_t m = (bits >> (8 * (w - w0))) & 0xffu;
      pre[w] = (uint16_t)at;
      wbits[w] = (uint8_t)m;
      for (uint32_t q = m; q; q &= q - 1)
        s_idx[at++] = (uint16_t)(8 * w + __ffs(q) - 1);
    }
    if (threadIdx.x == 0) pre[n_words] = (uint16_t)n_valid;
    __syncthreads();

    // ---- 2. warp = 32 compacted slots: decode; tau, rgb and t by
    // compacted index ----
    if (n_valid > 0) {
      const PlaneT<kB>* planes_s = planes + (size_t)s * 3 * res * res * CS;
      for (int j0 = 32 * warp; j0 < n_valid; j0 += 32 * kWarps) {
        {  // lane = slot
          const int j = j0 + lane;
          const bool ok = j < n_valid;
          const size_t si = base + (ok ? s_idx[j] : 0);
          float x = 0.0f, y = 0.0f, z = 0.0f;
          if (ok) {
            x = xyz[si * 3 + 0];
            y = xyz[si * 3 + 1];
            z = xyz[si * 3 + 2];
            sDt[threadIdx.x] = pdt[si];
            s_t[j] = pt[si];
          }
          stage_features<C, kB>(planes_s, x, y, z, res, ok,
                                sm.sFh + threadIdx.x * FS,
                                sm.sFl + threadIdx.x * FS);
          sm.sR[threadIdx.x] = ok ? rid[si] : 0;
          sJ[threadIdx.x] = ok ? j : -1;
        }
        __syncwarp();
#pragma unroll 1
        for (int m = 0; m < 2 && j0 + 16 * m < n_valid; ++m) {
          const int mt = 2 * warp + m;
          mlp_rows<C, H, kB>(sm, dir_out, (size_t)s * n_rays, true, mt,
                             [&](int i, float v) {
            const int row = 16 * mt + gr + 8 * i, j = sJ[row];
            if (j < 0) return;
            const float o = v + out_bias;
            reinterpret_cast<float*>(s_out)[4 * j + t] =
                t ? o : fminf(expf(o) * sDt[row], 60.0f);
          });
        }
        __syncwarp();  // the warp's next slots overwrite its rows
      }
      __syncthreads();
    }
    if (pair + 1 < last)
      load_valid(pvalid + base + P, w0, w1, aligned, raw);

    // ---- 3. warp = ray: the scan of its valid slots (a run of the
    // compacted order, as its segment is one of the slot order) and the
    // sums ----
    // valid slots before slot x (x <= P)
    auto before = [&](int x) {
      const int w = x >> 3;
      return w < n_words
          ? pre[w] + __popc(wbits[w] & ((1u << (x & 7)) - 1u))
          : (int)pre[n_words];
    };
    for (int r = warp; r < GR; r += kWarps) {
      const int start = before(so[r]);
      const int end = before(r + 1 < GR ? so[r + 1] : P);
      float carry = 0.0f;
      float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int c0 = start; c0 < end; c0 += 32) {
        const int j = c0 + lane;
        const bool in = j < end;
        const float4 q = in ? s_out[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float tau = q.x;
        float incl_tau = tau;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float v = __shfl_up_sync(kFull, incl_tau, off);
          if (lane >= off) incl_tau += v;
        }
        incl_tau += carry;
        carry = __shfl_sync(kFull, incl_tau, 31);
        if (in) {
          const float T = expf(-(incl_tau - tau));
          if (T >= T_thresh) {
            const float wgt = (1.0f - expf(-tau)) * T;
            acc[0] += wgt;
            acc[1] += wgt * s_t[j];
            acc[2] += wgt * (1.0f / (1.0f + expf(-q.y)) * scale - sat);
            acc[3] += wgt * (1.0f / (1.0f + expf(-q.z)) * scale - sat);
            acc[4] += wgt * (1.0f / (1.0f + expf(-q.w)) * scale - sat);
          }
        }
      }
      if (start < end) {
#pragma unroll
        for (int k = 0; k < 5; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[k] += __shfl_xor_sync(kFull, acc[k], off);
        }
      }
      if (lane == 0) {
        const size_t ray = (size_t)s * n_rays + (size_t)g * GR + r;
        weights_sum[ray] = acc[0];
        depth[ray] = acc[1];
#pragma unroll
        for (int k = 0; k < 3; ++k) image[ray * 3 + k] = acc[2 + k];
      }
    }
  }
}

}  // namespace

// planes: (S, 3, res, res, C) f32 channels-last, or with bf16 != 0 bf16
// with C padded to a multiple of 4; xyz: (S, G * P, 3) f32;
// rid: (S, G * P) int32 ray ids into dir_out (S, G * GR, hidden) f32;
// params: the packed MLP block; pt, pdt: (S, G, P) f32 slot t and dt;
// pvalid: (S, G, P) uint8 (bool); soffs: (S, G, GR) int32 segment starts
// (non-decreasing, P for fully truncated rays).  Outputs
// weights_sum, depth: (S, G * GR) f32; image: (S, G * GR, 3) f32.
// scale, sat: the colour head's saturation, rgb = sigmoid * scale - sat.
// P must be a multiple of 8, at most 4096, and the shared memory of P slots
// and GR segment starts must fit a block (a CUDA error otherwise).
// Returns cudaErrorInvalidValue for a P outside that or a (C, hidden)
// without an instance (C in {4, 6,
// 8}, hidden in {32, 64, 128}).
extern "C" int triplane_decode_composite(
    const void* planes, const void* xyz, const void* rid, const void* dir_out,
    const void* params, const void* pt, const void* pdt, const void* pvalid,
    const void* soffs, void* weights_sum, void* depth, void* image, int S,
    int G, int P, int GR, int res, int C, int hidden, int bf16, float scale,
    float sat, float T_thresh, void* stream) {
  if (P <= 0 || P % 8 != 0 || P > 4096 || GR <= 0)
    return (int)cudaErrorInvalidValue;
  return with_shape(C, hidden, bf16, [&](auto shape) {
    using Sh = decltype(shape);
    auto kernel = triplane_decode_composite_kernel<Sh::C, Sh::H, Sh::kB>;
    const int smem = composite_smem_bytes<Sh::C, Sh::H>(P, GR);
    const int blocks = (S * G + kGroups - 1) / kGroups;
    if (blocks == 0) return (int)cudaSuccess;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const PlaneT<Sh::kB>*>(planes),
        static_cast<const float*>(xyz), static_cast<const int32_t*>(rid),
        static_cast<const float*>(dir_out), static_cast<const float*>(params),
        static_cast<const float*>(pt), static_cast<const float*>(pdt),
        static_cast<const uint8_t*>(pvalid),
        static_cast<const int32_t*>(soffs), static_cast<float*>(weights_sum),
        static_cast<float*>(depth), static_cast<float*>(image), S, G, P, GR,
        res, scale, sat, T_thresh);
    return (int)cudaGetLastError();
  });
}
