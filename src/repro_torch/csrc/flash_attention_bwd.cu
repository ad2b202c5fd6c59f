// flash_attention_bwd for sm_90a: the gradient of flash_attention's
// softmax attention (causal and/or sliding-window masks, GQA) with respect to
// q, k and v.
//
// No TPU kernel has a backward: the JAX package differentiates its plain XLA
// attention (repro/models/layers.py:96-100, softmax weights p in f32).  The
// port puts its forward kernel in the model (models/layers.py), so a training
// step on the card needs a backward kernel too; this is it, and it computes
// the gradient of that same f32-p function for both dtypes.  Shapes as the
// forward's (csrc/flash_attention.cu): q, o, dO (B, Sq, H, D), k and v
// (B, Sk, K, D) with H % K == 0, D 64 or 128, queries at the LAST Sq of Sk key
// positions, the ragged edge masked; Sq > Sk only without masks.  Inputs
// float32 or bfloat16, all math in f32, dQ, dK and dV written in the inputs'
// dtype.
//
// FlashAttention-2's algorithm, in three kernels on the CUDA cores (f32 FMA,
// SIMT; no tensor cores yet), 256 threads each:
//   1. flash_bwd_stats, one block per (64-query tile, batch * head): each
//      row's log-sum-exp of its scaled scores, recomputed over its live keys
//      (an extra Q K^T pass: the forward kernels keep no statistics and stay
//      as they are), and delta = rowsum(dO * O);
//   2. flash_bwd_dkdv, one block per (64-key tile, batch * kv head): for each
//      of the group's H / K query heads and each query tile that can see the
//      key tile, P = exp(S - lse), dV += P^T dO, dP = dO V^T,
//      dS = P (dP - delta), dK += dS^T Q; dK and dV are written once, with no
//      atomics;
//   3. flash_bwd_dq, one block per (64-query tile, batch * head): over the
//      live key tiles, S, P, dP and dS again, and dQ += dS K.
// Key (query) tiles no query (key) of the block can see are skipped, as in
// the forward.  Operations: 8 products of 2 * D flops a live query-key pair
// (1 in pass 1, 4 in pass 2, 3 in pass 3) against the 5 the function needs;
// bytes: q, k, v, o, dO read and dQ, dK, dV written, each some times over.
// Bound on an H100 by operations at every shape the zoo trains: the 10 * D
// flops a live pair at 67 TFLOP/s (f32) or 989 TFLOP/s (bf16 inputs).
//
// Thread t owns tile rows ty + 16 i (i < 4), ty = t / 16, and of a 64 x 64
// score tile the columns tx + 16 j (j < 4), of a D-wide accumulator the
// columns tx + 16 c (c < D / 16), tx = t % 16.  Tiles sit in shared memory in
// f32 with padded rows, so that a column read is free of bank conflicts.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernel_error.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the forward's mask value
constexpr unsigned FULL = 0xffffffffu;
constexpr int BQ = 64, BK = 64, NT = 256;
constexpr int PS = BK + 1;  // a padded row of a score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Geom {
  int n_heads, n_kv_heads, sq, sk, causal, window;
  float scale;
};

// is the key at position kp live for the query at position qp
__device__ __forceinline__ bool live(int qp, int kp, const Geom& g) {
  bool ok = kp < g.sk;
  if (g.causal) ok = ok && kp <= qp;
  if (g.window > 0) ok = ok && kp > qp - g.window;
  return ok;
}

// rows [r0, r0 + R) of one head (row stride ``stride``) into an f32 tile of
// row length ``ld``; rows at or past n are zeros
template <class T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, size_t stride,
                                          int r0, int n, int ld) {
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    dst[r * ld + d] = r0 + r < n ? to_f32(src[(size_t)(r0 + r) * stride + d]) : 0.f;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two D-wide tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, float (&s)[4][4],
                                         int tx, int ty) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// the sum of x over the 16 lanes of a half-warp
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int w = 8; w > 0; w >>= 1) x += __shfl_xor_sync(FULL, x, w, 16);
  return x;
}

// keys the queries [q0, q0 + BQ) can see: [k_begin, k_end), k_begin on a tile
__device__ __forceinline__ void key_range(int q0, const Geom& g, int& k_begin, int& k_end) {
  const int shift = g.sk - g.sq;
  const int q_lo = q0 + shift, q_hi = min(q0 + BQ, g.sq) - 1 + shift;
  k_end = g.causal ? min(g.sk, q_hi + 1) : g.sk;
  k_begin = g.window > 0 ? max(0, q_lo - g.window + 1) / BK * BK : 0;
}

// 1. lse and delta of each query row
template <class T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_stats(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
                Geom g) {
  constexpr int DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;          // [BQ][DP]
  float* ks = qs + BQ * DP;  // [BK][DP]
  const int bh = blockIdx.y, b = bh / g.n_heads, h = bh % g.n_heads;
  const int kvh = h / (g.n_heads / g.n_kv_heads);
  const int q0 = blockIdx.x * BQ, shift = g.sk - g.sq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_stride = (size_t)g.n_heads * D, kv_stride = (size_t)g.n_kv_heads * D;
  const size_t q_off = (size_t)b * g.sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * g.sk * kv_stride + (size_t)kvh * D;
  load_tile<T, D, BQ>(qs, q + q_off, q_stride, q0, g.sq, DP);

  float dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    float acc = 0.f;
    if (r < g.sq) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const size_t off = q_off + (size_t)r * q_stride + tx + 16 * c;
        acc = fmaf(to_f32(o[off]), to_f32(dout[off]), acc);
      }
    }
    dl[i] = half_warp_sum(acc);
  }

  int k_begin, k_end;
  key_range(q0, g, k_begin, k_end);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = NEG_INF, l[i] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<T, D, BK>(ks, kb, kv_stride, k0, g.sk, DP);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(qs, ks, s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + shift;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = live(qp, k0 + tx + 16 * j, g);
        s[i][j] = ok[j] ? s[i][j] * g.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w, 16));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += ok[j] ? expf(s[i][j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(rs);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r < g.sq) {
        lse[(size_t)bh * g.sq + r] = m[i] + logf(l[i]);
        delta[(size_t)bh * g.sq + r] = dl[i];
      }
    }
  }
}

// P and dS of a (query tile, key tile) pair into ps and dss ([BQ][PS]; ps may
// be null), from the q, dO, k and v tiles in shared memory
template <int D>
__device__ __forceinline__ void probs_and_dscores(const float* qs, const float* dos,
                                                  const float* ks, const float* vs, float* ps,
                                                  float* dss, const float (&lse_r)[4],
                                                  const float (&dl_r)[4], int q0, int k0,
                                                  const Geom& g, int tx, int ty) {
  float s[4][4], dp[4][4];
  tile_dot<D>(qs, ks, s, tx, ty);
  tile_dot<D>(dos, vs, dp, tx, ty);
  const int shift = g.sk - g.sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = r < g.sq && live(r + shift, k0 + tx + 16 * j, g);
      const float p = ok ? expf(s[i][j] * g.scale - lse_r[i]) : 0.f;
      const int at = (ty + 16 * i) * PS + tx + 16 * j;
      if (ps) ps[at] = p;
      dss[at] = p * (dp[i][j] - dl_r[i]);
    }
  }
}

// 2. dK and dV of one key tile of one kv head
template <class T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Geom g) {
  constexpr int DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;            // [BK][DP]
  float* vs = ks + BK * DP;    // [BK][DP]
  float* qs = vs + BK * DP;    // [BQ][DP]
  float* dos = qs + BQ * DP;   // [BQ][DP]
  float* ps = dos + BQ * DP;   // [BQ][PS]
  float* dss = ps + BQ * PS;   // [BQ][PS]
  const int bk = blockIdx.y, b = bk / g.n_kv_heads, kvh = bk % g.n_kv_heads;
  const int grp = g.n_heads / g.n_kv_heads;
  const int k0 = blockIdx.x * BK, shift = g.sk - g.sq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_stride = (size_t)g.n_heads * D, kv_stride = (size_t)g.n_kv_heads * D;
  const size_t kv_off = (size_t)b * g.sk * kv_stride + (size_t)kvh * D;
  load_tile<T, D, BK>(ks, k + kv_off, kv_stride, k0, g.sk, DP);
  load_tile<T, D, BK>(vs, v + kv_off, kv_stride, k0, g.sk, DP);

  // query rows that can see a key of this tile: [r_lo, r_hi]
  const int k_last = min(k0 + BK, g.sk) - 1;
  const int r_lo = g.causal ? max(0, k0 - shift) : 0;
  const int r_hi = g.window > 0 ? min(g.sq - 1, k_last + g.window - 1 - shift) : g.sq - 1;

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[a][c] = 0.f, acc_v[a][c] = 0.f;

  for (int hh = 0; hh < grp; ++hh) {
    const int h = kvh * grp + hh;
    const size_t q_off = (size_t)b * g.sq * q_stride + (size_t)h * D;
    const float* lb = lse + ((size_t)b * g.n_heads + h) * g.sq;
    const float* db = delta + ((size_t)b * g.n_heads + h) * g.sq;
    for (int q0 = r_lo / BQ * BQ; q0 <= r_hi; q0 += BQ) {
      __syncthreads();  // every thread is done with the previous query tile
      load_tile<T, D, BQ>(qs, q + q_off, q_stride, q0, g.sq, DP);
      load_tile<T, D, BQ>(dos, dout + q_off, q_stride, q0, g.sq, DP);
      float lse_r[4], dl_r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        lse_r[i] = r < g.sq ? lb[r] : 0.f;
        dl_r[i] = r < g.sq ? db[r] : 0.f;
      }
      __syncthreads();
      probs_and_dscores<D>(qs, dos, ks, vs, ps, dss, lse_r, dl_r, q0, k0, g, tx, ty);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's query rows
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pr[4], dr[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) pr[a] = ps[i * PS + ty + 16 * a], dr[a] = dss[i * PS + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float o_ = dos[i * DP + tx + 16 * c], q_ = qs[i * DP + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc_v[a][c] = fmaf(pr[a], o_, acc_v[a][c]);
            acc_k[a][c] = fmaf(dr[a], q_, acc_k[a][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= g.sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t off = kv_off + (size_t)j * kv_stride + tx + 16 * c;
      dk[off] = from_f32<T>(acc_k[a][c] * g.scale);
      dv[off] = from_f32<T>(acc_v[a][c]);
    }
  }
}

// 3. dQ of one query tile of one head
template <class T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, Geom g) {
  constexpr int DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][DP]
  float* dos = qs + BQ * DP;   // [BQ][DP]
  float* ks = dos + BQ * DP;   // [BK][DP]
  float* vs = ks + BK * DP;    // [BK][DP]
  float* dss = vs + BK * DP;   // [BQ][PS]
  const int bh = blockIdx.y, b = bh / g.n_heads, h = bh % g.n_heads;
  const int kvh = h / (g.n_heads / g.n_kv_heads);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_stride = (size_t)g.n_heads * D, kv_stride = (size_t)g.n_kv_heads * D;
  const size_t q_off = (size_t)b * g.sq * q_stride + (size_t)h * D;
  const size_t kv_off = (size_t)b * g.sk * kv_stride + (size_t)kvh * D;
  load_tile<T, D, BQ>(qs, q + q_off, q_stride, q0, g.sq, DP);
  load_tile<T, D, BQ>(dos, dout + q_off, q_stride, q0, g.sq, DP);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < g.sq ? lse[(size_t)bh * g.sq + r] : 0.f;
    dl_r[i] = r < g.sq ? delta[(size_t)bh * g.sq + r] : 0.f;
  }
  int k_begin, k_end;
  key_range(q0, g, k_begin, k_end);
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous key tile
    load_tile<T, D, BK>(ks, k + kv_off, kv_stride, k0, g.sk, DP);
    load_tile<T, D, BK>(vs, v + kv_off, kv_stride, k0, g.sk, DP);
    __syncthreads();
    probs_and_dscores<D>(qs, dos, ks, vs, nullptr, dss, lse_r, dl_r, q0, k0, g, tx, ty);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = ks[j * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dr[i], kk, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= g.sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[q_off + (size_t)r * q_stride + tx + 16 * c] = from_f32<T>(acc[i][c] * g.scale);
  }
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int b, int sq, int sk,
           int h, int kh, int causal, int window, float scale, cudaStream_t st) {
  constexpr int DP = D + 1;
  constexpr int smem_stats = sizeof(float) * (BQ + BK) * DP;
  constexpr int smem_dkdv = sizeof(float) * (2 * BK * DP + 2 * BQ * DP + 2 * BQ * PS);
  constexpr int smem_dq = sizeof(float) * (2 * BQ * DP + 2 * BK * DP + BQ * PS);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(flash_bwd_stats<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem_stats)) ||
      (e = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv)) ||
      (e = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq)))
    return e;
  const Geom g{h, kh, sq, sk, causal, window, scale};
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *dot = static_cast<const T*>(dout);
  const dim3 q_grid((sq + BQ - 1) / BQ, b * h), k_grid((sk + BK - 1) / BK, b * kh);
  flash_bwd_stats<T, D><<<q_grid, NT, smem_stats, st>>>(qt, kt, ot, dot, lse, delta, g);
  if ((e = cudaGetLastError())) return e;
  flash_bwd_dkdv<T, D><<<k_grid, NT, smem_dkdv, st>>>(qt, kt, vt, dot, lse, delta,
                                                      static_cast<T*>(dk), static_cast<T*>(dv), g);
  if ((e = cudaGetLastError())) return e;
  flash_bwd_dq<T, D><<<q_grid, NT, smem_dq, st>>>(qt, kt, vt, dot, lse, delta,
                                                  static_cast<T*>(dq), g);
  return cudaGetLastError();
}

}  // namespace

// dq, dk, dv (the inputs' shapes and dtype) from q, k, v, the forward's o and
// dout; lse and delta are (B, H, Sq) f32 scratch.  dtype: 0 float32, 1 bfloat16.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                                   float* delta, int dtype, int b, int sq, int sk, int h,
                                   int kh, int d, int causal, int window, float scale,
                                   void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || (sk < sq && (causal || window > 0)) || h <= 0 ||
      kh <= 0 || h % kh != 0 || (d != 64 && d != 128) || b * h > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = d == 64;
  switch (dtype) {
    case 0:
      return d64 ? launch<float, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, sq, sk, h, kh,
                                     causal, window, scale, st)
                 : launch<float, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, sq, sk, h,
                                      kh, causal, window, scale, st);
    case 1:
      return d64 ? launch<__nv_bfloat16, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, sq, sk,
                                             h, kh, causal, window, scale, st)
                 : launch<__nv_bfloat16, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, sq,
                                              sk, h, kh, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
