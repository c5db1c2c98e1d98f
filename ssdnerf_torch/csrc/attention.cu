// Self-attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel ssdnerf_tpu/ops/pallas/attention.py:_fwd_kernel
// (reached through vmem_attention -> _fwd_call).  Computes, per program g,
// softmax(q k^T * scale) v in f32.  The TPU kernel held the whole (T, T)
// score matrix of one program in VMEM; a Hopper block has at most 227 KB of
// shared memory, so this kernel streams instead (online softmax): one block
// per (g, 64-query tile), K and V in 64-row tiles through shared memory, and
// a running max and sum per query row.
//
// Bound on the H100: f32 FMA throughput of the two products (no tensor
// cores yet: plain f32, 4 threads per query row, each owning a quarter of
// the output columns), and shared-memory bandwidth for the K/V tile reads.
// Q and K rows are padded by one float so the 4 threads of a row and the 8
// rows of a warp hit distinct banks.  Shared memory is 66 KB at hd = 64 and
// 116 KB at hd = 128, above the 48 KB default, so the launch raises the
// block's dynamic shared-memory limit first.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // key rows per tile
constexpr int kThreads = 256;

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int T, float scale) {
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
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int G,
           int T, float scale, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBQ - 1) / kBQ, G);
  attention_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(q, k, v, o, T,
                                                            scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (G, T, hd) f32 contiguous.  Returns cudaErrorInvalidValue
// for a head dim without an instance.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int G, int T, int hd, float scale,
                             void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32: return launch<32>(qf, kf, vf, of, G, T, scale, st);
    case 64: return launch<64>(qf, kf, vf, of, G, T, scale, st);
    case 128: return launch<128>(qf, kf, vf, of, G, T, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
