// Self-attention forward and backward, for Hopper (sm_90a).
//
// Forward: replaces the Pallas kernel
// ssdnerf_tpu/ops/pallas/attention.py:_fwd_kernel (reached through
// vmem_attention -> _fwd_call).  Computes, per program g,
// softmax(q k^T * scale) v in f32.  The TPU kernel held the whole (T, T)
// score matrix of one program in VMEM; a Hopper block has at most 227 KB of
// shared memory, so this kernel streams instead (online softmax): one block
// per (g, 64-query tile), K and V in 64-row tiles through shared memory, and
// a running max and sum per query row.  Under autograd it also writes each
// row's log-sum-exp (in units of the scaled scores) for the backward.
//
// Backward: replaces ssdnerf_tpu/ops/pallas/attention.py:_bwd_kernel
// (reached through vmem_attention -> _bwd_rule), which recomputed the
// softmax of 256-row query blocks against all of K in VMEM.  Here, in the
// flash-attention-2 form and plain f32 FMA:
//   D_i = rowsum(dO_i * O_i)                         (attention_bwd_dot)
//   P_ij = exp(scale * q_i.k_j - LSE_i)  (the forward's own LSE)
//   dS_ij = P_ij * (dO_i.v_j - D_i)
//   dV_j = sum_i P_ij dO_i, dK_j = scale * sum_i dS_ij q_i
//                                  (one block per (g, 64-key tile), streams
//                                   the query tiles)
//   dQ_i = scale * sum_j dS_ij k_j  (one block per (g, 64-query tile),
//                                    streams the key tiles)
// Two kernels instead of one with atomics on dQ: every output element is
// written by exactly one thread, so the gradients are deterministic.
//
// Bound on the H100: f32 FMA throughput of the products (no tensor cores
// yet: 4 threads per row, each owning a quarter of the output columns),
// and shared-memory bandwidth of the tile reads.  Rows are padded by one
// float so the 4 threads of a row and the 8 rows of a warp hit distinct
// banks.  Shared memory per block (hd = 128): forward 116 KB, dK/dV 166 KB,
// dQ 149 KB; every launch raises the block's dynamic shared-memory limit
// first.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;   // query rows per block / per streamed tile
constexpr int kBK = 64;   // key rows per block / per streamed tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;  // padded row of a (query, key) tile

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int T, float scale) {
  constexpr int QS = HD + 1;
  constexpr int PS = kBK + 1;
  constexpr int CPT = HD / 4;        // output columns per thread
  constexpr int SPT = kBK / 4;       // scores per thread per tile
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sV + kBK * HD;

  const int g = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const size_t base = (size_t)g * T * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    sQ[r * QS + c] = q0 + r < T ? q[base + (size_t)(q0 + r) * HD + c] : 0.0f;
  }

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();  // Q loaded / previous tile fully consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < T;
      const size_t off = base + (size_t)(k0 + r) * HD + c;
      sK[r * QS + c] = in ? k[off] : 0.0f;
      sV[r * HD + c] = in ? v[off] : 0.0f;
    }
    __syncthreads();

    float sc[SPT];
    float mt = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int j = sub + 4 * jj;
      float a = 0.0f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) a += sQ[row * QS + d] * sK[j * QS + d];
      a = k0 + j < T ? a * scale : -INFINITY;
      sc[jj] = a;
      mt = fmaxf(mt, a);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);   // finite: tile holds a valid key
    const float alpha = expf(m - m_new);
    float ls = 0.0f;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const float p = expf(sc[jj] - m_new);
      sP[row * PS + sub + 4 * jj] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= alpha;
    __syncwarp();  // a row's P is written by the 4 lanes of one warp
    for (int j = 0; j < kBK; ++j) {
      const float p = sP[row * PS + j];
      const float* vr = sV + j * HD + sub;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += p * vr[4 * c];
    }
  }

  if (q0 + row < T) {
    const float inv = 1.0f / l;
    float* out = o + base + (size_t)(q0 + row) * HD + sub;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[4 * c] = acc[c] * inv;
    if (lse != nullptr && sub == 0) lse[(size_t)g * T + q0 + row] = m + logf(l);
  }
}

// ------------------------------------------------------------- backward

// D[r] = sum_c dO[r, c] * O[r, c], one warp per row of the (G * T, hd) view.
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

// Copy rows [r0, r0 + 64) of a (T, HD) matrix into a padded tile; rows past
// T read as 0.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int T) {
  for (int e = threadIdx.x; e < 64 * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    dst[r * (HD + 1) + c] = r0 + r < T ? src[(size_t)(r0 + r) * HD + c]
                                       : 0.0f;
  }
}

// The (64 query x 64 key) tile of P and dS from staged Q, dO (query rows)
// and K, V (key rows).  Thread (row = tid / 4, sub = tid % 4) forms the 16
// entries (row, sub + 4 jj).  Entries outside [0, T) on either side are 0.
// sP may be null (the dQ kernel needs dS only).
template <int HD>
__device__ __forceinline__ void score_tile(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    const float* sLse, const float* sD, float* sP, float* sDS, int q0,
    int k0, int T, float scale) {
  constexpr int QS = HD + 1;
  constexpr int SPT = kBK / 4;
  const int row = threadIdx.x >> 2;
  const int sub = threadIdx.x & 3;
  float s[SPT], dp[SPT];
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) s[jj] = dp[jj] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float qd = sQ[row * QS + d];
    const float gd = sdO[row * QS + d];
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int j = sub + 4 * jj;
      s[jj] += qd * sK[j * QS + d];
      dp[jj] += gd * sV[j * QS + d];
    }
  }
  const bool row_in = q0 + row < T;
  const float lse = sLse[row], Di = sD[row];
#pragma unroll
  for (int jj = 0; jj < SPT; ++jj) {
    const int j = sub + 4 * jj;
    const bool in = row_in && k0 + j < T;
    const float p = in ? expf(s[jj] * scale - lse) : 0.0f;
    if (sP != nullptr) sP[row * kPS + j] = p;
    sDS[row * kPS + j] = p * (dp[jj] - Di);
  }
}

template <int HD>
constexpr int dkdv_smem_floats() {
  return 4 * 64 * (HD + 1) + 2 * 64 * kPS + 2 * 64;
}

template <int HD>
constexpr int dq_smem_floats() {
  return 4 * 64 * (HD + 1) + 64 * kPS + 2 * 64;
}

// One block per (g, 64-key tile): dK, dV of those keys, streaming every
// query tile.  Thread (j = tid / 4, sub) owns columns sub + 4 c of key row j.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int T, float scale) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 4;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + 64 * QS;
  float* sQ = sV + 64 * QS;
  float* sdO = sQ + 64 * QS;
  float* sP = sdO + 64 * QS;
  float* sDS = sP + 64 * kPS;
  float* sLse = sDS + 64 * kPS;
  float* sD = sLse + 64;

  const int g = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int jr = tid >> 2;
  const int sub = tid & 3;
  const size_t base = (size_t)g * T * HD;
  load_tile<HD>(sK, k + base, k0, T);
  load_tile<HD>(sV, v + base, k0, T);

  float acc_k[CPT], acc_v[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc_k[c] = acc_v[c] = 0.0f;

  for (int q0 = 0; q0 < T; q0 += kBQ) {
    __syncthreads();  // previous query tile fully consumed
    load_tile<HD>(sQ, q + base, q0, T);
    load_tile<HD>(sdO, dout + base, q0, T);
    if (tid < 64) {
      const bool in = q0 + tid < T;
      sLse[tid] = in ? lse[(size_t)g * T + q0 + tid] : 0.0f;
      sD[tid] = in ? D[(size_t)g * T + q0 + tid] : 0.0f;
    }
    __syncthreads();
    score_tile<HD>(sQ, sdO, sK, sV, sLse, sD, sP, sDS, q0, k0, T, scale);
    __syncthreads();
    for (int i = 0; i < kBQ; ++i) {
      const float p = sP[i * kPS + jr];
      const float ds = sDS[i * kPS + jr];
      const float* gr = sdO + i * QS + sub;
      const float* qr = sQ + i * QS + sub;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        acc_v[c] += p * gr[4 * c];
        acc_k[c] += ds * qr[4 * c];
      }
    }
  }

  if (k0 + jr < T) {
    const size_t off = base + (size_t)(k0 + jr) * HD + sub;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[off + 4 * c] = acc_k[c] * scale;
      dv[off + 4 * c] = acc_v[c];
    }
  }
}

// One block per (g, 64-query tile): dQ of those queries, streaming every key
// tile.  Thread (i = tid / 4, sub) owns columns sub + 4 c of query row i.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, float* __restrict__ dq,
                        int T, float scale) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 4;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + 64 * QS;
  float* sK = sdO + 64 * QS;
  float* sV = sK + 64 * QS;
  float* sDS = sV + 64 * QS;
  float* sLse = sDS + 64 * kPS;
  float* sD = sLse + 64;

  const int g = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int ir = tid >> 2;
  const int sub = tid & 3;
  const size_t base = (size_t)g * T * HD;
  load_tile<HD>(sQ, q + base, q0, T);
  load_tile<HD>(sdO, dout + base, q0, T);
  if (tid < 64) {
    const bool in = q0 + tid < T;
    sLse[tid] = in ? lse[(size_t)g * T + q0 + tid] : 0.0f;
    sD[tid] = in ? D[(size_t)g * T + q0 + tid] : 0.0f;
  }

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.0f;

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();  // previous key tile fully consumed
    load_tile<HD>(sK, k + base, k0, T);
    load_tile<HD>(sV, v + base, k0, T);
    __syncthreads();
    score_tile<HD>(sQ, sdO, sK, sV, sLse, sD, nullptr, sDS, q0, k0, T,
                   scale);
    __syncthreads();
    for (int j = 0; j < kBK; ++j) {
      const float ds = sDS[ir * kPS + j];
      const float* kr = sK + j * QS + sub;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += ds * kr[4 * c];
    }
  }

  if (q0 + ir < T) {
    float* out = dq + base + (size_t)(q0 + ir) * HD + sub;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[4 * c] = acc[c] * scale;
  }
}

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int G, int T, float scale, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = raise_smem(attention_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBQ - 1) / kBQ, G);
  attention_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse,
                                                            T, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* dq, float* dk, float* dv, float* D, int G, int T,
               float scale, cudaStream_t stream) {
  const int rows = G * T;
  attention_bwd_dot_kernel<<<(rows * 32 + kThreads - 1) / kThreads, kThreads,
                             0, stream>>>(o, dout, D, rows, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_kv = dkdv_smem_floats<HD>() * (int)sizeof(float);
  err = raise_smem(attention_bwd_dkdv_kernel<HD>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_k((T + kBK - 1) / kBK, G);
  attention_bwd_dkdv_kernel<HD><<<grid_k, kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, D, dk, dv, T, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_q = dq_smem_floats<HD>() * (int)sizeof(float);
  err = raise_smem(attention_bwd_dq_kernel<HD>, smem_q);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((T + kBQ - 1) / kBQ, G);
  attention_bwd_dq_kernel<HD><<<grid_q, kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, D, dq, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (G, T, hd) f32 contiguous; lse: (G, T) f32 or nullptr (the
// row log-sum-exps the backward reads).  Returns cudaErrorInvalidValue for
// a head dim without an instance.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int G, int T, int hd,
                             float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32: return launch_fwd<32>(qf, kf, vf, of, lf, G, T, scale, st);
    case 64: return launch_fwd<64>(qf, kf, vf, of, lf, G, T, scale, st);
    case 128: return launch_fwd<128>(qf, kf, vf, of, lf, G, T, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, o, dout, dq, dk, dv: (G, T, hd) f32 contiguous; lse: (G, T) from
// attention_fwd; D: (G, T) f32 scratch.  Returns cudaErrorInvalidValue for a
// head dim without an instance.
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
  switch (hd) {
    case 32:
      return launch_bwd<32>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, Df, G, T,
                            scale, st);
    case 64:
      return launch_bwd<64>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, Df, G, T,
                            scale, st);
    case 128:
      return launch_bwd<128>(qf, kf, vf, of, gf, lf, dqf, dkf, dvf, Df, G, T,
                             scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
