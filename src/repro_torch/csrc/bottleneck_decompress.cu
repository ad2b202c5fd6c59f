// bottleneck_decompress for sm_90a: out = (q * s) @ w + b.
//
// Replaces the TPU kernel bottleneck_decompress
// (repro/kernels/bottleneck_decompress.py:41, pallas_call at :54).  Shapes:
// q (N, L) int8, s (N,) f32, w (L, C) f32, b (C,) f32 -> out (N, C) f32, any
// N, L, C: every copy and store is masked, so no padding is needed.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32 off the tensor cores):
// 2*N*L*C operations against N*L + 4*(N + L*C + C + N*C) bytes.  pool16,
// pool23 and the llama3.2-3b cut are bound by operations; relu3 (L 32) and
// the N = 8 cuts (flatten, fc0_relu) by bytes.
//
// Design: the product runs on sgemm_tile.cuh's pipelined tile, picked by
// shape (kernels/tiles.py), with the codes as its int8 A: each k-tile of q
// arrives by cp.async like w's and is dequantised once per element, as
// static_cast<float>(q) * s[row], as it leaves shared memory, so the f32
// latent never reaches device memory.  The loop runs over L and the bias is
// added after it, as in the reference.  The grid covers the output tiles,
// so small N still spreads over the card.
#include "sgemm_tile.cuh"

namespace {

template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::MIN_BLOCKS)
decompress(const int8_t* __restrict__ q, const float* __restrict__ s,
           const float* __restrict__ w, const float* __restrict__ bias,
           float* __restrict__ out, int n, int l, int c, int q_bytes, int w_bytes) {
  extern __shared__ float4 smem4[];
  int row0, col0;
  sei::tile_origin<Cfg>(c, row0, col0);
  float acc[Cfg::TM][Cfg::TN];
  sei::tile_product<Cfg, int8_t>(q, s, w, n, l, c, row0, col0, q_bytes, w_bytes,
                                 reinterpret_cast<float*>(smem4), acc);
#pragma unroll
  for (int i = 0; i < Cfg::TM; ++i) {
    const int r = sei::tile_row<Cfg>(row0, i);
    if (r >= n) continue;
#pragma unroll
    for (int j0 = 0; j0 < Cfg::TN; j0 += Cfg::V) {
      const int cc = sei::tile_col<Cfg>(col0, j0);
      if (cc >= c) continue;
      float* dst = out + (size_t)r * c + cc;
      if constexpr (Cfg::V == 4) {
        if (c % 4 == 0) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][j0] + bias[cc], acc[i][j0 + 1] + bias[cc + 1],
                          acc[i][j0 + 2] + bias[cc + 2], acc[i][j0 + 3] + bias[cc + 3]);
          continue;
        }
      }
#pragma unroll
      for (int u = 0; u < Cfg::V; ++u)
        if (cc + u < c) dst[u] = acc[i][j0 + u] + bias[cc + u];
    }
  }
}

template <class Cfg>
int launch_decompress(const int8_t* q, const float* s, const float* w, const float* b,
                      float* out, int n, int l, int c, cudaStream_t st) {
  constexpr size_t smem = Cfg::template smem_bytes<int8_t>();
  cudaError_t e = cudaFuncSetAttribute(decompress<Cfg>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  decompress<Cfg><<<sei::tile_grid<Cfg>(n, c), Cfg::kThreads, smem, st>>>(
      q, s, w, b, out, n, l, c, sei::copy_bytes(q, l), sei::copy_bytes(w, c));
  return cudaGetLastError();
}

}  // namespace

// Tile `tile` of sgemm_tile.cuh.
extern "C" int bottleneck_decompress(int tile, const int8_t* q, const float* s, const float* w,
                                     const float* b, float* out, int n, int l, int c,
                                     void* stream) {
  return sei::with_tile(tile, [&](auto cfg) {
    return launch_decompress<decltype(cfg)>(q, s, w, b, out, n, l, c,
                                            static_cast<cudaStream_t>(stream));
  });
}
