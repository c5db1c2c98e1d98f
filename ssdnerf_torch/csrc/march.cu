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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSamplesPerThread = 64;

__global__ void __launch_bounds__(kThreads)
march_occupancy_kernel(const int32_t* __restrict__ idx,
                       const uint8_t* __restrict__ bitfield,
                       uint8_t* __restrict__ valid, int n, int nbytes) {
  extern __shared__ __align__(16) uint8_t bits[];
  const int s = blockIdx.y;
  const uint8_t* src = bitfield + (size_t)s * nbytes;
  if ((nbytes & 15) == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* dst4 = reinterpret_cast<uint4*>(bits);
    for (int i = threadIdx.x; i < (nbytes >> 4); i += blockDim.x)
      dst4[i] = src4[i];
  } else {
    for (int i = threadIdx.x; i < nbytes; i += blockDim.x) bits[i] = src[i];
  }
  __syncthreads();

  const int32_t* in = idx + (size_t)s * n;
  uint8_t* out = valid + (size_t)s * n;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int v = in[i];
    out[i] = v >= 0 ? (bits[v >> 3] >> (v & 7)) & 1 : 0;
  }
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
  if (nbytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        march_occupancy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        nbytes);
    if (err != cudaSuccess) return (int)err;
  }
  march_occupancy_kernel<<<grid, kThreads, nbytes, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(bitfield),
      static_cast<uint8_t*>(valid), n, nbytes);
  return (int)cudaGetLastError();
}
