// Occupancy test of the ray march, for Hopper (sm_90a).
//
// Replaces the Pallas kernel ssdnerf_tpu/ops/pallas/march.py:_march_kernel
// (reached through march_valid_mask).  The TPU kernel turned the bitfield
// lookup into an int8 one-hot matmul because TPU gathers are slow; on the
// GPU it is a byte load.
//
// Division of labour (kept from the TPU design): the closed-form t grid,
// clamping, voxel quantization and the far test run in torch
// (ssdnerf_torch/ops/kernels/march.py) and reach this kernel as one int32
// per sample: the linear voxel index (ix * H + iy) * H + iz, or -1 past far.
// Computing t here with expf/log1pf would not be bit-exact against torch,
// and one ulp moves a sample across a voxel boundary.
//
// Bound on the H100: device memory.  Per sample the kernel reads 4 bytes and
// writes 1, and does one shared-memory byte load.  The scene's bitfield
// (H^3 / 8 bytes: 32 KB at H = 64) is staged in shared memory once per
// block, and each block walks many samples of one scene so that staging is
// small next to the index traffic.
//
// march_popcount replaces the Pallas kernel
// tools/march_scalar_probe.py:_scalar_kernel (reached through
// scalar_march): the count of live, occupied samples in each row of 1024
// sample indices, bit ji & 7 of byte ji >> 3 of the row's scene table,
// ji < 0 dead.  The TPU kernel walked the samples one by one on the scalar
// core from an SMEM table packed into int32 words (the scalar core loads
// words); here it is the same byte lookup as march_occupancy, one warp per
// row (16-byte index loads, a shuffle sum), the 32 KB table in shared
// memory.  Bound: device memory, 4 bytes a sample.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSamplesPerThread = 64;
constexpr int kRowsPerWarp = 16;

// Copy a scene's nbytes-byte table into shared memory (the caller syncs).
__device__ __forceinline__ void stage_table(uint8_t* bits, const uint8_t* src,
                                            int nbytes) {
  if ((nbytes & 15) == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* dst4 = reinterpret_cast<uint4*>(bits);
    for (int i = threadIdx.x; i < (nbytes >> 4); i += blockDim.x)
      dst4[i] = src4[i];
  } else {
    for (int i = threadIdx.x; i < nbytes; i += blockDim.x) bits[i] = src[i];
  }
}

// Occupancy bit of sample index v: bit v & 7 of byte v >> 3; v < 0 is dead.
__device__ __forceinline__ int occupied(const uint8_t* bits, int v) {
  return v >= 0 ? (bits[v >> 3] >> (v & 7)) & 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
march_occupancy_kernel(const int32_t* __restrict__ idx,
                       const uint8_t* __restrict__ bitfield,
                       uint8_t* __restrict__ valid, int n, int nbytes) {
  extern __shared__ __align__(16) uint8_t bits[];
  const int s = blockIdx.y;
  stage_table(bits, bitfield + (size_t)s * nbytes, nbytes);
  __syncthreads();

  const int32_t* in = idx + (size_t)s * n;
  uint8_t* out = valid + (size_t)s * n;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = occupied(bits, in[i]);
}

// Rows of scene s = blockIdx.y are [s * rows, (s + 1) * rows) of ji (n
// indices each, n % 4 == 0); one warp per row.
__global__ void __launch_bounds__(kThreads)
march_popcount_kernel(const int32_t* __restrict__ ji,
                      const uint8_t* __restrict__ table,
                      int32_t* __restrict__ counts, int rows, int n,
                      int nbytes) {
  extern __shared__ __align__(16) uint8_t bits[];
  const int s = blockIdx.y;
  stage_table(bits, table + (size_t)s * nbytes, nbytes);
  __syncthreads();

  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * warps) {
    const size_t row = (size_t)s * rows + r;
    const int4* in = reinterpret_cast<const int4*>(ji + row * n);
    int c = 0;
    for (int i = lane; i < (n >> 2); i += 32) {
      const int4 w = in[i];
      c += occupied(bits, w.x) + occupied(bits, w.y) + occupied(bits, w.z) +
           occupied(bits, w.w);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    if (lane == 0) counts[row] = c;
  }
}

template <typename Kernel>
cudaError_t fit_table(Kernel kernel, int nbytes) {
  if (nbytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
}

}  // namespace

// idx: (S, n) int32; bitfield: (S, nbytes) uint8; valid: (S, n) uint8/bool.
extern "C" int march_occupancy(const void* idx, const void* bitfield,
                               void* valid, int S, int n, int nbytes,
                               void* stream) {
  int blocks = (n + kThreads * kSamplesPerThread - 1) /
               (kThreads * kSamplesPerThread);
  if (blocks < 1) blocks = 1;
  dim3 grid(blocks, S);
  cudaError_t err = fit_table(march_occupancy_kernel, nbytes);
  if (err != cudaSuccess) return (int)err;
  march_occupancy_kernel<<<grid, kThreads, nbytes, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(bitfield),
      static_cast<uint8_t*>(valid), n, nbytes);
  return (int)cudaGetLastError();
}

// ji: (S * rows, n) int32, 16-byte aligned, n % 4 == 0, rows [s * rows,
// (s + 1) * rows) of scene s; table: (S, nbytes) uint8; counts: (S * rows)
// int32.
extern "C" int march_popcount(const void* ji, const void* table, void* counts,
                              int S, int rows, int n, int nbytes,
                              void* stream) {
  constexpr int rows_per_block = (kThreads / 32) * kRowsPerWarp;
  int blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks < 1) blocks = 1;
  dim3 grid(blocks, S);
  cudaError_t err = fit_table(march_popcount_kernel, nbytes);
  if (err != cudaSuccess) return (int)err;
  march_popcount_kernel<<<grid, kThreads, nbytes, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(ji), static_cast<const uint8_t*>(table),
      static_cast<int32_t*>(counts), rows, n, nbytes);
  return (int)cudaGetLastError();
}
