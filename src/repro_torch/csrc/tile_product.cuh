// The float32 tile product shared by the two bottleneck kernels.
//
// One block computes a (BM x BN) tile of A (n x k) @ B (k x m) on the CUDA
// cores, with one fmaf per term in ascending k order: no tensor cores and no
// TF32, whose rounding would flip int8 wire codes.  Both kernels sum in the
// same order, so every branch of a kernel gives bit-identical results.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "kernel_error.cuh"

namespace sei {

// Thread t of the block owns rows ty + i * kThreadsY (i < TM) and columns
// tx + j * kThreadsX (j < TN) of the tile, with tx = t % kThreadsX and
// ty = t / kThreadsX: neighbouring threads read neighbouring columns of B.
template <int BM, int BN, int BK, int TM, int TN>
struct Tile {
  static constexpr int kThreadsX = BN / TN;
  static constexpr int kThreadsY = BM / TM;
  static constexpr int kThreads = kThreadsX * kThreadsY;
  static constexpr int kAStride = BM + 1;  // padded: the transposing store is conflict-free
  static constexpr int kSmemFloats = BK * kAStride + BK * BN;
  static_assert(BM % TM == 0 && BN % TN == 0, "tile must split evenly over threads");
};

// acc[i][j] = sum_k A(row0 + ty + i*kThreadsY, k) * B(k, col0 + tx + j*kThreadsX).
// load_a(r, k) returns A(r, k) for k < k_total and must give 0 for rows past
// the end; it may dequantise.  Columns of B past m read as 0.  smem holds
// Tile::kSmemFloats floats.  Every thread of the block must call this.
template <int BM, int BN, int BK, int TM, int TN, class LoadA>
__device__ __forceinline__ void tile_product(LoadA load_a, const float* __restrict__ b,
                                             int k_total, int m, int row0, int col0,
                                             float* smem, float (&acc)[TM][TN]) {
  using T = Tile<BM, BN, BK, TM, TN>;
  float* as = smem;                     // [BK][BM + 1], A transposed
  float* bs = smem + BK * T::kAStride;  // [BK][BN]
  const int tid = threadIdx.x;
  const int tx = tid % T::kThreadsX;
  const int ty = tid / T::kThreadsX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += T::kThreads) {
      const int r = idx / BK, kk = idx % BK;
      as[kk * T::kAStride + r] = (k0 + kk < k_total) ? load_a(row0 + r, k0 + kk) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += T::kThreads) {
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gc = col0 + c;
      bs[kk * BN + c] = (gk < k_total && gc < m) ? b[(size_t)gk * m + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk * T::kAStride + ty + i * T::kThreadsY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk * BN + tx + j * T::kThreadsX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ReLU that gives +0 for every non-positive input, so the bit patterns of
// the results order like the floats (the compress kernel's atomicMax relies
// on it).
__device__ __forceinline__ float relu_pos(float t) { return t > 0.f ? t : 0.f; }

// The wire quantiser of repro/kernels/bottleneck_compress.py:74-75: IEEE
// division (no fast-math), rintf rounds half to even as jnp.round does.
__device__ __forceinline__ int8_t quantise(float v, float scale) {
  float t = rintf(v / scale);
  t = fminf(fmaxf(t, -127.f), 127.f);
  return static_cast<int8_t>(t);
}

__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.f ? amax / 127.0f : 1.0f;
}

}  // namespace sei
