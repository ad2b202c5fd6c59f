// bottleneck_compress for sm_90a: z = relu(f @ w + b), then per row
// s = amax / 127 (1 where amax = 0) and q = clip(rint(z / s), -127, 127).
//
// Replaces the TPU kernel bottleneck_compress (repro/kernels/bottleneck_compress.py:80,
// pallas_call at :94).  Shapes: f (N, C) f32, w (C, L) f32, b (L,) f32 ->
// q (N, L) int8, s (N,) f32, any N, C, L: every copy and store is masked.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32 off the tensor cores):
// 2*N*C*L operations against 4*(N*C + C*L + L + N) + N*L bytes.  The cuts of
// a batch-8 VGG16 with many rows (pool16, pool23) and the llama3.2-3b cut are
// bound by operations; relu3 (C 64) and the N = 8 cuts (flatten, fc0_relu,
// w of 1.26 GB and 33.5 MB) by bytes.
//
// The per-row amax needs the whole latent row before any code is written,
// which the TPU kernel gets from one (rows, L) VMEM block.  Here one path:
// the product runs on sgemm_tile.cuh's pipelined tile, picked by shape
// (kernels/tiles.py), and its epilogue writes relu(z + b) to a scratch (N, L)
// and folds each row's maximum into an (N,) scratch by atomicMax on the bits
// of non-negative floats, which is exact and order-free; a second, light
// pass quantises.  The grid covers the output tiles, so a handful of rows
// still spreads over the card.
#include "sgemm_tile.cuh"

namespace {

template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::MIN_BLOCKS)
compress_product(const float* __restrict__ f, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ z,
                 unsigned* __restrict__ row_max, int n, int c, int l, int f_bytes, int w_bytes) {
  extern __shared__ float4 smem4[];
  int row0, col0;
  sei::tile_origin<Cfg>(l, row0, col0);
  float acc[Cfg::TM][Cfg::TN];
  sei::tile_product<Cfg, float>(f, nullptr, w, n, c, l, row0, col0, f_bytes, w_bytes,
                                reinterpret_cast<float*>(smem4), acc);

#pragma unroll
  for (int i = 0; i < Cfg::TM; ++i) {
    const int r = sei::tile_row<Cfg>(row0, i);
    float mx = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < Cfg::TN; j0 += Cfg::V) {
      const int cc = sei::tile_col<Cfg>(col0, j0);
      float v[Cfg::V];
#pragma unroll
      for (int u = 0; u < Cfg::V; ++u) {
        v[u] = cc + u < l ? sei::relu_pos(acc[i][j0 + u] + bias[cc + u]) : 0.f;
        mx = fmaxf(mx, v[u]);
      }
      if (r >= n || cc >= l) continue;
      float* out = z + (size_t)r * l + cc;
      if constexpr (Cfg::V == 4) {
        if (l % 4 == 0) {
          *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
      }
#pragma unroll
      for (int u = 0; u < Cfg::V; ++u)
        if (cc + u < l) out[u] = v[u];
    }
    // the row's threads are consecutive lanes of one warp (or whole warps)
    constexpr int kLanes = Cfg::kThreadsX < 32 ? Cfg::kThreadsX : 32;
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (threadIdx.x % kLanes == 0 && r < n) atomicMax(&row_max[r], __float_as_uint(mx));
  }
}

// one thread per 4 latent values of a row where L % 4 == 0, else per value
__global__ void __launch_bounds__(256)
compress_quantise(const float* __restrict__ z, const unsigned* __restrict__ row_max,
                  int8_t* __restrict__ q, float* __restrict__ s, int n, int l, int per) {
  const size_t e = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) * per;
  if (e >= (size_t)n * l) return;
  const int row = static_cast<int>(e / l), col = static_cast<int>(e % l);
  const float sc = sei::row_scale(__uint_as_float(row_max[row]));
  if (per == 4) {
    const float4 v = *reinterpret_cast<const float4*>(z + e);
    *reinterpret_cast<char4*>(q + e) = make_char4(sei::quantise(v.x, sc), sei::quantise(v.y, sc),
                                                  sei::quantise(v.z, sc), sei::quantise(v.w, sc));
  } else {
    q[e] = sei::quantise(z[e], sc);
  }
  if (col == 0) s[row] = sc;
}

template <class Cfg>
int launch_compress(const float* f, const float* w, const float* b, float* z,
                    unsigned* row_max, int8_t* q, float* s, int n, int c, int l,
                    cudaStream_t st) {
  constexpr size_t smem = Cfg::template smem_bytes<float>();
  cudaError_t e = cudaFuncSetAttribute(compress_product<Cfg>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  compress_product<Cfg><<<sei::tile_grid<Cfg>(n, l), Cfg::kThreads, smem, st>>>(
      f, w, b, z, row_max, n, c, l, sei::copy_bytes(f, c), sei::copy_bytes(w, l));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int per = l % 4 == 0 ? 4 : 1;
  const size_t threads = ((size_t)n * l + per - 1) / per;
  compress_quantise<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      z, row_max, q, s, n, l, per);
  return cudaGetLastError();
}

}  // namespace

// Tile `tile` of sgemm_tile.cuh.  z (N, L) f32 and row_max (N,) zeroed are
// scratch the caller allocates.
extern "C" int bottleneck_compress(int tile, const float* f, const float* w, const float* b,
                                   float* z, unsigned* row_max, int8_t* q, float* s, int n,
                                   int c, int l, void* stream) {
  return sei::with_tile(tile, [&](auto cfg) {
    return launch_compress<decltype(cfg)>(f, w, b, z, row_max, q, s, n, c, l,
                                          static_cast<cudaStream_t>(stream));
  });
}
