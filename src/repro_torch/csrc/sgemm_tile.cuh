// The float32 tile product shared by the two bottleneck kernels.
//
// One block computes a (BM x BN) tile of A (n x k) @ B (k x m), row-major,
// on the CUDA cores in full f32.  Each output is one fmaf per term in
// ascending k, starting from 0: no tensor cores, no reduced-precision
// inputs, no split of the sum and no other order.  Every tile
// configuration sums the same terms in the same order, so the choice of
// tile moves only time, never a bit of the result, and int8 codes computed
// from it do not depend on it.
//
// Register blocking: thread (tx, ty) owns TM x TN outputs, rows
// ty + i * kThreadsY (i < TM) and columns in TN / V chunks of V = min(TN, 4)
// adjacent columns, chunk j at j * kThreadsX * V + tx * V: neighbouring
// threads read neighbouring vectors of B, and the rows of one warp's A reads
// fall in distinct banks.  Per four steps of k a thread reads one float4 of
// A per row and, per step, one V-vector of B per chunk.
//
// Pipelining: a ring of STAGES k-tiles of A and B in shared memory, filled by
// cp.async; tile t + STAGES - 1 is in flight while tile t computes, with one
// cp.async.wait_group and one __syncthreads a tile.  Rows that start on a
// 16-byte boundary take 16-byte cp.async.cg copies, others 4-byte copies (a
// layout case: any n, k, m is legal).  Copies past an edge zero-fill through
// cp.async's source size, so the padded terms add exact zeros.
//
// An int8 A (the decompress kernel's codes) is staged raw, then dequantised
// once per element as static_cast<float>(q) * s[row] into one of two float
// tiles, one k-tile ahead of the product; rows of codes that are not 4-byte
// aligned are copied byte by byte with plain loads.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"
#include "kernel_error.cuh"

namespace sei {

// MIN_BLOCKS is the kernels' __launch_bounds__ minimum of resident blocks:
// 0 leaves the register count to the compiler, which keeps it low for
// occupancy; 1 lets it spend registers on loads in flight.
template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int kThreadsX = BN / TN;
  static constexpr int kThreadsY = BM / TM;
  static constexpr int kThreads = kThreadsX * kThreadsY;
  static constexpr int V = TN < 4 ? TN : 4;
  // padded by 4 floats: rows stay 16-byte aligned and four (or eight)
  // consecutive rows of one float4 read fall in distinct banks
  static constexpr int kAStride = BK + 4;
  static constexpr int kAFloats = BM * kAStride;
  static constexpr int kBFloats = BK * BN;
  static_assert(BM % TM == 0 && BN % TN == 0 && TN % V == 0, "tile must split evenly");
  static_assert(BM % 4 == 0, "slots of the ring stay 16-byte aligned");
  static_assert(BK % 16 == 0, "int8 rows split into 16-byte copies");
  static_assert(STAGES >= 3, "the int8 path dequantises one k-tile ahead");
  static_assert(kThreadsX % 32 == 0 || 32 % kThreadsX == 0, "a row's threads share one warp");

  // dynamic shared memory of the ring for an A of element type AT
  template <class AT>
  static constexpr size_t smem_bytes() {
    if constexpr (std::is_same_v<AT, float>)
      return sizeof(float) * (STAGES * kAFloats + STAGES * kBFloats);
    else
      return sizeof(float) * (2 * kAFloats + STAGES * kBFloats + BM) + STAGES * BM * BK;
  }
};

// The configurations both kernels choose from, in the order of the index
// the launchers take (kernels/tiles.py holds the same table and the pick;
// a CPU test holds the two equal).
// Sized on an H100 (132 SMs) at the codec's shapes:
//   wide:   64 x 64 blocks of 64 threads, 8 x 8 outputs each, for many rows
//           and columns (the llama3.2-3b cut: 125 x 24 blocks);
//   mid:    32 x 64 blocks of 128 threads, 4 x 4 each, for widths that are
//           multiples of 64 at a few hundred blocks (pool16, pool23);
//   narrow: 64 x 32 blocks of 128 threads, 4 x 4 each, for other widths
//           (relu3's L = 32, ragged ones);
//   stream: N <= 16 (flatten, fc0_relu), bound by the bytes of B: 8 rows,
//           128 threads of 2 x 1, seven 8 KB stages of B, sized so that
//           three blocks share an SM for either kernel (flatten's 392 and
//           784 column blocks fill whole waves), and registers spent on
//           loads in flight.
using Wide = Tile<64, 64, 16, 8, 8, 4, 0>;
using Mid = Tile<32, 64, 32, 4, 4, 3, 0>;
using Narrow = Tile<64, 32, 32, 4, 4, 3, 0>;
using Stream = Tile<8, 32, 64, 2, 1, 7, 1>;

// f(Cfg{}) for the configuration at `tile`; cudaErrorInvalidValue for an
// index out of range
template <class F>
int with_tile(int tile, F f) {
  switch (tile) {
    case 0: return f(Wide{});
    case 1: return f(Mid{});
    case 2: return f(Narrow{});
    case 3: return f(Stream{});
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- copies

// rows x cols elements of T from src (row stride ld, origin (r0, c0), bounds
// nr x nc) into dst (row stride dst_ld), in BYTES-wide copies.  BYTES = 1 is
// the plain-load path for int8 rows that are not 4-byte aligned.
template <class Cfg, int ROWS, int COLS, int BYTES, class T>
__device__ __forceinline__ void copy_tile(T* dst, int dst_ld, const T* __restrict__ src,
                                          int ld, int r0, int c0, int nr, int nc) {
  constexpr int kPer = BYTES / static_cast<int>(sizeof(T));
  constexpr int kChunks = ROWS * COLS / kPer;
  static_assert(COLS % kPer == 0, "a row splits into whole copies");
  auto copy = [&](int idx) {
    const int r = idx / (COLS / kPer), cc = (idx % (COLS / kPer)) * kPer;
    const int gr = r0 + r, gc = c0 + cc;
    const bool ok = gr < nr && gc < nc;
    const T* from = ok ? src + (size_t)gr * ld + gc : src;
    if constexpr (BYTES == 1)
      dst[r * dst_ld + cc] = ok ? *from : T(0);
    else
      cp_async<BYTES>(dst + r * dst_ld + cc, from, ok);
  };
  if constexpr (BYTES == 16) {
#pragma unroll
    for (int it = 0; it < (kChunks + Cfg::kThreads - 1) / Cfg::kThreads; ++it) {
      const int idx = threadIdx.x + it * Cfg::kThreads;
      if (kChunks % Cfg::kThreads != 0 && idx >= kChunks) break;
      copy(idx);
    }
  } else {
    // rows off the 16-byte boundary: a rolled loop keeps the addresses of
    // these narrower copies out of registers
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kChunks; idx += Cfg::kThreads) copy(idx);
  }
}

// ---------------------------------------------------------------- product

template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// acc += the BK terms of one k-tile, in ascending k
template <class Cfg>
__device__ __forceinline__ void fma_tile(const float* as, const float* bs,
                                         float (&acc)[Cfg::TM][Cfg::TN]) {
  constexpr int TM = Cfg::TM, TN = Cfg::TN, V = Cfg::V;
  const int tx = threadIdx.x % Cfg::kThreadsX, ty = threadIdx.x / Cfg::kThreadsX;
  const float* arow = as + ty * Cfg::kAStride;
  const float* bcol = bs + tx * V;
#pragma unroll
  for (int k4 = 0; k4 < Cfg::BK; k4 += 4) {
    float av[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) load_vec<4>(av[i], arow + i * Cfg::kThreadsY * Cfg::kAStride + k4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float bv[TN];
#pragma unroll
      for (int j = 0; j < TN / V; ++j) {
        float t[V];
        load_vec<V>(t, bcol + (k4 + u) * Cfg::BN + j * Cfg::kThreadsX * V);
#pragma unroll
        for (int v = 0; v < V; ++v) bv[j * V + v] = t[v];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i][u], bv[j], acc[i][j]);
    }
  }
}

// Byte width of the copies of a row-major operand of `cols` elements of T a
// row at `p`: 16 where every row starts on a 16-byte boundary, else 4 where
// every row is 4-byte aligned, else 1 (int8 only).
template <class T>
inline int copy_bytes(const T* p, int cols) {
  const size_t row = sizeof(T) * static_cast<size_t>(cols);
  const auto addr = reinterpret_cast<uintptr_t>(p);
  if (row % 16 == 0 && addr % 16 == 0) return 16;
  if (row % 4 == 0 && addr % 4 == 0) return 4;
  return 1;
}

// acc[i][j] = sum over kk < k, ascending, of A(row(i), kk) * B(kk, col(j)),
// with A(r, kk) = a[r * k + kk] for a float A and
// static_cast<float>(a[r * k + kk]) * a_scale[r] for an int8 A; rows past n
// and columns past m come out as 0.  a_bytes and b_bytes are copy_bytes of
// the two operands.  smem holds Cfg::smem_bytes<AT>() bytes, 16-byte
// aligned.  Every thread of the block calls this.
template <class Cfg, class AT>
__device__ __forceinline__ void tile_product(const AT* __restrict__ a,
                                             const float* __restrict__ a_scale,
                                             const float* __restrict__ b, int n, int k, int m,
                                             int row0, int col0, int a_bytes, int b_bytes,
                                             float* smem, float (&acc)[Cfg::TM][Cfg::TN]) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, BK = Cfg::BK, S = Cfg::STAGES;
  constexpr bool kInt8 = std::is_same_v<AT, int8_t>;
  static_assert(kInt8 || std::is_same_v<AT, float>, "A is float or int8");
#pragma unroll
  for (int i = 0; i < Cfg::TM; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::TN; ++j) acc[i][j] = 0.f;

  // float A: [S][BM][kAStride] ring; int8 A: [2][BM][kAStride] dequantised
  float* as = smem;
  float* bs = as + (kInt8 ? 2 : S) * Cfg::kAFloats;  // [S][BK][BN]
  float* scale = bs + S * Cfg::kBFloats;              // [BM], int8 only
  AT* raw = reinterpret_cast<AT*>(scale + BM);        // [S][BM][BK], int8 only

  auto load = [&](int t) {
    const int slot = t % S, k0 = t * BK;
    if (b_bytes == 16)
      copy_tile<Cfg, BK, BN, 16>(bs + slot * Cfg::kBFloats, BN, b, m, k0, col0, k, m);
    else
      copy_tile<Cfg, BK, BN, 4>(bs + slot * Cfg::kBFloats, BN, b, m, k0, col0, k, m);
    if constexpr (kInt8) {
      AT* dst = raw + slot * BM * BK;
      if (a_bytes == 16) copy_tile<Cfg, BM, BK, 16>(dst, BK, a, k, row0, k0, n, k);
      else if (a_bytes == 4) copy_tile<Cfg, BM, BK, 4>(dst, BK, a, k, row0, k0, n, k);
      else copy_tile<Cfg, BM, BK, 1>(dst, BK, a, k, row0, k0, n, k);
    } else {
      float* dst = as + slot * Cfg::kAFloats;
      if (a_bytes == 16) copy_tile<Cfg, BM, BK, 16>(dst, Cfg::kAStride, a, k, row0, k0, n, k);
      else copy_tile<Cfg, BM, BK, 4>(dst, Cfg::kAStride, a, k, row0, k0, n, k);
    }
  };
  // int8 only: raw slot of k-tile t -> dequantised tile t % 2
  auto dequantise = [&](int t) {
    const AT* src = raw + (t % S) * BM * BK;
    float* dst = as + (t % 2) * Cfg::kAFloats;
    for (int idx = threadIdx.x; idx < BM * BK / 4; idx += Cfg::kThreads) {
      const int r = idx / (BK / 4), kk = (idx % (BK / 4)) * 4;
      const char4 c = *reinterpret_cast<const char4*>(src + r * BK + kk);
      const float sc = scale[r];
      *reinterpret_cast<float4*>(dst + r * Cfg::kAStride + kk) =
          make_float4(static_cast<float>(c.x) * sc, static_cast<float>(c.y) * sc,
                      static_cast<float>(c.z) * sc, static_cast<float>(c.w) * sc);
    }
  };

  const int kt = (k + BK - 1) / BK;
  if constexpr (kInt8) {
    for (int r = threadIdx.x; r < BM; r += Cfg::kThreads)
      scale[r] = row0 + r < n ? a_scale[row0 + r] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < kt) load(t);
    cp_async_commit();
  }
  if constexpr (kInt8) {
    cp_async_wait<S - 2>();  // k-tile 0 has landed
    __syncthreads();
    dequantise(0);
  }
  for (int t = 0; t < kt; ++t) {
    // float A: tile t has landed; int8 A: tile t + 1 has, and tile t was
    // dequantised in the step before
    cp_async_wait<kInt8 ? S - 3 : S - 2>();
    __syncthreads();
    // the slot of tile t - 1, free now that every thread is past it
    if (t + S - 1 < kt) load(t + S - 1);
    cp_async_commit();
    if constexpr (kInt8) {
      if (t + 1 < kt) dequantise(t + 1);
      fma_tile<Cfg>(as + (t % 2) * Cfg::kAFloats, bs + (t % S) * Cfg::kBFloats, acc);
    } else {
      fma_tile<Cfg>(as + (t % S) * Cfg::kAFloats, bs + (t % S) * Cfg::kBFloats, acc);
    }
  }
  cp_async_wait<0>();
}

// the global row and column of acc[i][j]
template <class Cfg>
__device__ __forceinline__ int tile_row(int row0, int i) {
  return row0 + threadIdx.x / Cfg::kThreadsX + i * Cfg::kThreadsY;
}
template <class Cfg>
__device__ __forceinline__ int tile_col(int col0, int j) {
  return col0 + (j / Cfg::V) * Cfg::kThreadsX * Cfg::V + (threadIdx.x % Cfg::kThreadsX) * Cfg::V +
         j % Cfg::V;
}

// The block's (row0, col0): a 1-D grid, column tiles fastest, so the blocks
// that run together share their rows of A and all of B stays in L2.
template <class Cfg>
__device__ __forceinline__ void tile_origin(int m, int& row0, int& col0) {
  const int col_tiles = (m + Cfg::BN - 1) / Cfg::BN;
  row0 = (blockIdx.x / col_tiles) * Cfg::BM;
  col0 = (blockIdx.x % col_tiles) * Cfg::BN;
}

template <class Cfg>
inline unsigned tile_grid(int n, int m) {
  const size_t rows = (n + Cfg::BM - 1) / Cfg::BM, cols = (m + Cfg::BN - 1) / Cfg::BN;
  return static_cast<unsigned>(rows * cols);
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
