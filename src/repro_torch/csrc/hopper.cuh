// Hopper building blocks shared by flash_attention.cu (the bf16 forward) and
// flash_attention_bwd.cu (the bf16 backward): TMA loads of 128-byte-swizzled
// bf16 tiles completed on mbarriers, wgmma descriptors and the three wgmma
// shapes the two use, and the host side that encodes a tensor map.
//
// Tiles: a (B, S, heads, D) bf16 tensor is a 4-D map (D, heads, S, B) whose
// box is 64 columns (one 128-byte swizzle slab) x 1 head x rows x 1 batch;
// a tile of R rows and D columns sits in shared memory as D / 64 slabs of
// R x 128 bytes, each on a 1024-byte boundary (the swizzle's period).  Rows
// past S arrive as zeros.
//
// wgmma fragments (per warpgroup, thread t = 32 * warp + lane): accumulator
// entry 4*j + 2*i + c of an m64nN product holds row 16*warp + lane/4 + 8*i,
// column 8*j + 2*(lane%4) + c.  The 16 columns 16*kk.. of that fragment, as
// bf16 pairs in the order of entries 8*kk .. 8*kk+7 (pack_bf16), are the
// register A fragment of k-step kk of a product whose K dimension is those
// columns.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

constexpr int SLAB = 64;             // columns of one 128-byte swizzle slab
constexpr int ROW_BYTES = SLAB * 2;  // 128
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also announces the bytes the TMA loads will bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// box (64 columns, 1 head, rows, 1 batch) at (column, head, row, batch)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory: start
// address, leading and stride byte offsets, all in 16-byte units; layout 1
// is the 128-byte swizzle.  The stride offset steps 8 rows of 128 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// K-major operand: k-step kk over the columns of a tile whose slab c holds
// columns 64c.. (16 columns of 2 bytes a step, 4 steps a slab); the tile
// address may point at a later row, on an 8-row boundary
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, uint32_t slab_bytes, int kk) {
  return desc(tile + (kk / 4) * slab_bytes + (kk % 4) * 32, 16);
}

// MN-major operand: slab c (64 columns of N) of a tile, k-step kk over its
// rows 16*kk .. 16*kk+15 (two 8-row groups of 1024 bytes)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, uint32_t slab_bytes, int c, int kk) {
  return desc(tile + c * slab_bytes + kk * 16 * ROW_BYTES, slab_bytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from touching accumulators across the async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HOPPER_ACC8(d, i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), A and B bf16 in shared
// memory, both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24),
        HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40), HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B bf16 in shared
// memory, both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64): A bf16 in registers, B bf16
// in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime's entry-point
// query, so the library links no -lcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (B, S, heads, D) bf16 as a 4-D map (D, heads, S, B); a box is 64 columns
// x 1 head x box_rows rows x 1 batch, 128-byte swizzled, zeros past S
template <int D>
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int batch, int rows,
                int heads, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {SLAB, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
