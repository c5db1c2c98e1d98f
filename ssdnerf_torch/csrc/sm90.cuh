// Hopper (sm_90a) building blocks shared by the bf16 attention kernels of
// attention_fwd_sm90.cu and attention_bwd_sm90.cu: mbarriers, TMA loads,
// wgmma shared-memory descriptors and products, and the TMA maps of the
// (rows, hd) bf16 matrices they stream (hd 40 or 64).  Shared memory holds
// a token as one 128-byte swizzled row of 64 columns whatever the head
// dim: TMA fills the columns past hd with zeros, so the products over the
// head dim are exact and the zero columns of a result are never stored.
//
// Accumulator element e of a thread of a m64n64 product (lane = 4 gr + t
// of warp w of the warpgroup): row 16 w + gr + 8 ((e >> 1) & 1), column
// 8 (e >> 2) + 2 t + (e & 1).  The accumulator of two neighbouring n8
// tiles, rounded to bf16, is the register A fragment of one k16 step:
// register r of step ks holds rows gr / gr + 8 (r & 1) and columns 16 ks +
// 2 t (+ 8 if r >> 1) and the next, i.e. accumulator elements 4 (2 ks +
// (r >> 1)) + 2 (r & 1) and the next.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// columns of a shared-memory row: one 128-byte swizzled row a token
constexpr int kRow = 64;

// k16 steps of a product over the head dim: its columns rounded up to 16
// (the zero-filled ones past it included)
template <int HD>
constexpr int kSteps = (HD + 15) / 16;

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

// A contiguous bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile (rows of
// 128 bytes, 8-row atoms of 1024 bytes, 1024-byte aligned): start address,
// leading and stride byte offsets.  K-major operands use only the stride
// (1024, from one 8-row atom to the next) and step k16 by 32 bytes (+2);
// an MN-major operand (a tile whose rows run along k) steps its k atoms by
// the same 1024, which is passed as both offsets, and k16 by 2048 bytes
// (+128).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_k_major(const void* p) {
  return smem_desc(p, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mn_major(const void* p) {
  return smem_desc(p, 1024, 1024);
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

// d = or += A B, A (64 x 16 bf16) from registers in the mma.sync A
// fragment layout, B from shared memory, transposed (MN-major) if
// kTransB, else K-major; one k16 step.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

// d (= 0 unless `accumulate`) += A B over 64 rows of a tile B (MN-major),
// A the register fragments of four k16 steps; issued, not waited for.
// Starting a sum with accumulate = 0, rather than from zeroed registers,
// keeps its registers out of reach of other instructions while products
// are in flight, which would make ptxas serialise them.
__device__ __forceinline__ void wgmma_rs_tile(float (&d)[32],
                                              const uint32_t (&a)[4][4],
                                              const bf16* b,
                                              int accumulate = 1) {
  const uint64_t db = desc_mn_major(b);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs<1>(d, a[ks], db + 128 * ks, ks > 0 || accumulate);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda).
inline EncodeTiled encode_tiled() {
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

// The (rows, hd) bf16 matrix at `ptr` (hd a multiple of 8 up to 64, so
// that a row is a multiple of 16 bytes, as TMA needs) as a TMA map with
// boxes of `box_rows` shared-memory rows of 128 bytes, 128-byte swizzled;
// a box is 64 columns wide whatever hd, the columns past hd zero-filled.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int hd,
                       int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || hd <= 0 || hd > kRow || hd % 8 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)hd, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {hd * sizeof(bf16)};
  const cuuint32_t box[2] = {kRow, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
