// flash_attention_bwd for sm_90a: the gradient of flash_attention's
// softmax attention (causal and/or sliding-window masks, GQA) with respect to
// q, k and v.
//
// No TPU kernel has a backward: the JAX package differentiates its plain XLA
// attention (repro/models/layers.py:96-100, softmax weights p in f32).  The
// port puts its forward kernel in the model (models/layers.py), so a training
// step on the card needs a backward kernel too; this is it.  Shapes as the
// forward's (csrc/flash_attention.cu): q, o, dO (B, Sq, H, D), k and v
// (B, Sk, K, D) with H % K == 0, D 64 or 128, queries at the LAST Sq of Sk key
// positions, the ragged edge masked; Sq > Sk only without masks.  lse is the
// forward's (B, H, Sq) f32 output: each row's natural log-sum-exp of its
// scaled scores, so no pass here recomputes the row statistics.  dQ, dK and
// dV are written in the inputs' dtype, each once, with no atomics: two calls
// give equal bits.
//
// FlashAttention-2's algorithm.  First, for both dtypes, flash_bwd_delta:
// delta = rowsum(dO * O) in f32, one warp a row, one read of o and dO.  Then
// two kernels a dtype, with S = Q K^T / sqrt(D), P = exp(S - lse),
// dP = dO V^T, dS = P (dP - delta):
//   flash_bwd_dkdv*: one block per (batch * kv head, key tile).  For each of
//     the group's H / K query heads and each query tile that can see the key
//     tile: dV += P^T dO, dK += dS^T Q; dK (times 1/sqrt(D)) and dV are
//     written once, the GQA sum kept in registers;
//   flash_bwd_dq*: one block per (batch * head, query tile): over the live
//     key tiles, dQ += dS K.
// Key (query) tiles no query (key) of a block can see are skipped, as in the
// forward.  Operations: 7 products of 2 * D flops a live query-key pair (4 in
// dK/dV, 3 in dQ) against the 5 the function needs; bytes: q, k, v, o, dO
// read and dQ, dK, dV written, the streamed tiles some times over (from L2).
// Bound on an H100 by operations at every shape the zoo trains: the 10 * D
// flops a live pair at 989 TFLOP/s (bf16 inputs, tensor cores) or 67 TFLOP/s
// (f32 inputs).
//
// bf16 (flash_bwd_dkdv_wgmma<D>, flash_bwd_dq_wgmma<D>): every product is
// wgmma with f32 accumulators on bf16 tiles that TMA loads into shared memory
// (128-byte swizzle, hopper.cuh), 256 threads = two warpgroups of 64 rows.
//   dK/dV: a block holds 128 keys (64 a warpgroup); K and V are loaded once,
//     64-query tiles of Q and dO stream through a two-stage ring on
//     mbarriers (thread 0 asks for tile i+1 before the warpgroups start on
//     tile i), each tile's lse (times log2 e) and delta staged beside it.  A
//     warpgroup computes S^T = K Q^T and dP^T = V dO^T (m64n64, both operands
//     in shared memory), P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T on
//     the accumulator fragment, masked entries exact zeros, then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 in
//     registers as the A operand and dO, Q MN-major B operands (one m64n64
//     chain per 64-column slab).  At D 128 dK and dV take 64 f32 registers
//     a thread each, S^T and dP^T 32 each.
//   dQ: a block holds 128 queries; Q, dO, lse and delta are loaded once,
//     64-key tiles of K and V stream through the ring; S = Q K^T,
//     dP = dO V^T, dS, and dQ += dS K with dS in bf16 registers and K
//     MN-major.
//   A warpgroup whose 64 rows see no key of a tile (the causal diagonal, a
//   window's edge, rows past Sq) skips its products.  P and dS are rounded
//   to bf16 before their products, dS computed from the f32 P; the JAX
//   model's chunked attention rounds P so too (repro/models/layers.py:139-144).
//
// f32 (flash_bwd_dkdv<D>, flash_bwd_dq<D>): f32 FMA on the CUDA cores,
// 64 x 64 tiles, 256 threads.  Thread t owns tile rows ty + 16 i (i < 4),
// ty = t / 16, and of a 64 x 64 score tile the columns tx + 16 j (j < 4), of
// a D-wide accumulator the columns tx + 16 c (c < D / 16), tx = t % 16.
// Tiles sit in shared memory with padded rows, so that a column read is free
// of bank conflicts.  Both dtypes' kernels share Geom, live, key_range and
// query_range.
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "kernel_error.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BQ = 64, BK = 64, NT = 256;
constexpr int PS = BK + 1;  // a padded row of a score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// delta = rowsum(dO * O) of each of the n_rows = B * Sq * H query rows, one
// warp a row, into (B, H, Sq)
template <class T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                int n_heads, int sq, int n_rows) {
  const int row = blockIdx.x * (NT / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const T* orow = o + (size_t)row * D;
  const T* drow = dout + (size_t)row * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(FULL, acc, w);
  if (lane == 0) {
    const int h = row % n_heads, s = (row / n_heads) % sq, b = row / (n_heads * sq);
    delta[((size_t)b * n_heads + h) * sq + s] = acc;
  }
}

template <class T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int b, int sq, int h,
                 cudaStream_t st) {
  const int n_rows = b * sq * h;
  flash_bwd_delta<T, D><<<(n_rows + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, h, sq, n_rows);
  return cudaGetLastError();
}

struct Geom {
  int n_heads, n_kv_heads, sq, sk, causal, window;
  float scale;
};

// is the key at position kp live for query row qr (position qr + shift).
// Plain ints, not a Geom: with the Geom form ptxas spilled 24 bytes of the
// bf16 dK/dV kernel at D 128, which sits at the 255-register cap
__device__ __forceinline__ bool live(int qr, int kp, int sq, int sk, int shift, int causal,
                                     int window) {
  const int qp = qr + shift;
  return qr < sq && kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// keys the queries [q0, q0 + NQ) can see: [k_begin, k_end), k_begin on an
// NK-key tile
template <int NQ, int NK>
__device__ __forceinline__ void key_range(int q0, const Geom& g, int& k_begin, int& k_end) {
  const int shift = g.sk - g.sq;
  const int q_lo = q0 + shift, q_hi = min(q0 + NQ, g.sq) - 1 + shift;
  k_end = g.causal ? min(g.sk, q_hi + 1) : g.sk;
  k_begin = g.window > 0 ? max(0, q_lo - g.window + 1) / NK * NK : 0;
}

// query rows that can see a key of [k0, k0 + NK): [r_lo, r_hi]
template <int NK>
__device__ __forceinline__ void query_range(int k0, const Geom& g, int& r_lo, int& r_hi) {
  const int shift = g.sk - g.sq, k_last = min(k0 + NK, g.sk) - 1;
  r_lo = g.causal ? max(0, k0 - shift) : 0;
  r_hi = g.window > 0 ? min(g.sq - 1, k_last + g.window - 1 - shift) : g.sq - 1;
}

// ------------------------------------------------------------------ f32 ----
// rows [r0, r0 + R) of one head (row stride ``stride``) into a tile of row
// length ``ld``; rows at or past n are zeros
template <int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          size_t stride, int r0, int n, int ld) {
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    dst[r * ld + d] = r0 + r < n ? src[(size_t)(r0 + r) * stride + d] : 0.f;
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
      // r < g.sq twice: without the first, ptxas spills 8 bytes of dQ at D 128
      const bool ok =
          r < g.sq && live(r, k0 + tx + 16 * j, g.sq, g.sk, shift, g.causal, g.window);
      const float p = ok ? expf(s[i][j] * g.scale - lse_r[i]) : 0.f;
      const int at = (ty + 16 * i) * PS + tx + 16 * j;
      if (ps) ps[at] = p;
      dss[at] = p * (dp[i][j] - dl_r[i]);
    }
  }
}

// 2. dK and dV of one key tile of one kv head
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, Geom g) {
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
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_stride = (size_t)g.n_heads * D, kv_stride = (size_t)g.n_kv_heads * D;
  const size_t kv_off = (size_t)b * g.sk * kv_stride + (size_t)kvh * D;
  load_tile<D, BK>(ks, k + kv_off, kv_stride, k0, g.sk, DP);
  load_tile<D, BK>(vs, v + kv_off, kv_stride, k0, g.sk, DP);
  int r_lo, r_hi;
  query_range<BK>(k0, g, r_lo, r_hi);

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
      load_tile<D, BQ>(qs, q + q_off, q_stride, q0, g.sq, DP);
      load_tile<D, BQ>(dos, dout + q_off, q_stride, q0, g.sq, DP);
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
      dk[off] = acc_k[a][c] * g.scale;
      dv[off] = acc_v[a][c];
    }
  }
}

// 3. dQ of one query tile of one head
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, Geom g) {
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
  load_tile<D, BQ>(qs, q + q_off, q_stride, q0, g.sq, DP);
  load_tile<D, BQ>(dos, dout + q_off, q_stride, q0, g.sq, DP);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < g.sq ? lse[(size_t)bh * g.sq + r] : 0.f;
    dl_r[i] = r < g.sq ? delta[(size_t)bh * g.sq + r] : 0.f;
  }
  int k_begin, k_end;
  key_range<BQ, BK>(q0, g, k_begin, k_end);
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous key tile
    load_tile<D, BK>(ks, k + kv_off, kv_stride, k0, g.sk, DP);
    load_tile<D, BK>(vs, v + kv_off, kv_stride, k0, g.sk, DP);
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
      dq[q_off + (size_t)r * q_stride + tx + 16 * c] = acc[i][c] * g.scale;
  }
}

// the f32 kernels' shared memory: k, v, q, dO tiles of padded rows, and P
// and dS (dK/dV) or dS (dQ)
template <int D>
constexpr int smem_dkdv = sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * PS);
template <int D>
constexpr int smem_dq = sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PS);

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* delta, int b, int sq,
               int sk, int h, int kh, int causal, int window, float scale, cudaStream_t st) {
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(flash_bwd_dkdv<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv<D>)) ||
      (e = cudaFuncSetAttribute(flash_bwd_dq<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq<D>)))
    return e;
  const Geom g{h, kh, sq, sk, causal, window, scale};
  const float *qt = static_cast<const float*>(q), *kt = static_cast<const float*>(k),
              *vt = static_cast<const float*>(v), *dot = static_cast<const float*>(dout);
  if ((e = static_cast<cudaError_t>(launch_delta<float, D>(o, dout, delta, b, sq, h, st))))
    return e;
  const dim3 q_grid((sq + BQ - 1) / BQ, b * h), k_grid((sk + BK - 1) / BK, b * kh);
  flash_bwd_dkdv<D><<<k_grid, NT, smem_dkdv<D>, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), g);
  if ((e = cudaGetLastError())) return e;
  flash_bwd_dq<D><<<q_grid, NT, smem_dq<D>, st>>>(qt, kt, vt, dot, lse, delta,
                                                      static_cast<float*>(dq), g);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16 ----
namespace wg {

using namespace hopper;

constexpr int BKV = 128;  // keys a dK/dV block: two warpgroups of 64
constexpr int BQT = 64;   // queries a tile of the dK/dV ring
constexpr int BQD = 128;  // queries a dQ block: two warpgroups of 64
constexpr int BKT = 64;   // keys a tile of the dQ ring
constexpr int SLAB_BIG = 128 * ROW_BYTES;   // one slab of a 128-row tile, 16 KB
constexpr int SLAB_SMALL = 64 * ROW_BYTES;  // one slab of a 64-row tile, 8 KB

// the shared-memory plan of both kernels at head dim D: two 128-row tiles
// loaded once (K and V, or Q and dO) and a two-stage ring of two 64-row
// tiles (Q and dO, or K and V), each on a 1024-byte boundary
template <int D>
struct Plan {
  static_assert(D % SLAB == 0, "head dim: whole 64-column slabs");
  static constexpr int NS = D / SLAB;
  static constexpr int BIG = NS * SLAB_BIG;
  static constexpr int SMALL = NS * SLAB_SMALL;
  static constexpr int STAGE = 2 * SMALL;
  static constexpr int SMEM = 1024 + 2 * BIG + 2 * STAGE;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Geom g,
                     float scale_log2) {
  using P = Plan<D>;
  constexpr int NS = P::NS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // k and v, stage 0, stage 1
  __shared__ float s_lse[2][BQT], s_dl[2][BQT];

  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = base, s_v = base + P::BIG;
  auto stage_q = [&](int st) { return base + 2 * P::BIG + st * P::STAGE; };  // dO after it
  const uint32_t bar_kv = smem_addr(&bars[0]);
  auto bar_q = [&](int st) { return smem_addr(&bars[1 + st]); };

  const int bk = blockIdx.x, b = bk / g.n_kv_heads, kvh = bk % g.n_kv_heads;
  const int grp = g.n_heads / g.n_kv_heads;
  // the first key tiles see the most queries under a causal mask: launched first
  const int k0 = blockIdx.y * BKV, shift = g.sk - g.sq;
  const int tid = threadIdx.x;
  const int group = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int kw0 = k0 + 64 * group;                  // this warpgroup's first key
  const int krow0 = kw0 + 16 * warp + lane / 4;     // and krow0 + 8
  const int col0 = 2 * (lane % 4);

  // query rows that can see a key of this block, in 64-row tiles
  int r_lo, r_hi;
  query_range<BKV>(k0, g, r_lo, r_hi);
  const int t_lo = r_lo / BQT;
  const int n_qt = r_hi >= r_lo ? r_hi / BQT - t_lo + 1 : 0;
  const int n_tiles = grp * n_qt;  // (query head, query tile) pairs, head by head

  const CUtensorMap *map_q = &tq, *map_do = &tdo;
  auto load_q_tile = [&](int st, int it) {  // thread 0: Q and dO of tile it
    const int h = kvh * grp + it / n_qt, q0 = (t_lo + it % n_qt) * BQT;
    const uint32_t dst = stage_q(st), bar = bar_q(st);
    mbar_expect_tx(bar, P::STAGE);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load(dst + c * SLAB_SMALL, map_q, bar, c * SLAB, h, q0, b);
      tma_load(dst + P::SMALL + c * SLAB_SMALL, map_do, bar, c * SLAB, h, q0, b);
    }
  };
  auto load_stats = [&](int st, int it) {  // threads < BQT: lse and delta of tile it
    if (tid < BQT) {
      const int h = kvh * grp + it / n_qt, r = (t_lo + it % n_qt) * BQT + tid;
      const size_t i = ((size_t)b * g.n_heads + h) * g.sq + r;
      s_lse[st][tid] = r < g.sq ? lse[i] * LOG2E : 0.f;
      s_dl[st][tid] = r < g.sq ? delta[i] : 0.f;
    }
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_q(0), 1);
    mbar_init(bar_q(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * P::BIG);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load(s_k + c * SLAB_BIG, &tk, bar_kv, c * SLAB, kvh, k0, b);
      tma_load(s_v + c * SLAB_BIG, &tv, bar_kv, c * SLAB, kvh, k0, b);
    }
    if (n_tiles > 0) load_q_tile(0, 0);
  }
  if (n_tiles > 0) load_stats(0, 0);

  float sT[32], dpt[32], acc_k[NS][32], acc_v[NS][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sT[i] = 0.f, dpt[i] = 0.f;
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[c][i] = 0.f, acc_v[c][i] = 0.f;
  const uint32_t k_rows = s_k + 64 * group * ROW_BYTES;  // this warpgroup's 64 keys
  const uint32_t v_rows = s_v + 64 * group * ROW_BYTES;
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, q0 = (t_lo + it % n_qt) * BQT;
    // both warpgroups are done with tile it - 1, which stage st ^ 1 holds,
    // and tile it's lse and delta are in
    __syncthreads();
    if (it + 1 < n_tiles) {
      if (tid == 0) load_q_tile(st ^ 1, it + 1);
      load_stats(st ^ 1, it + 1);
    }
    mbar_wait(bar_q(st), (it >> 1) & 1);
    const int q_lo = q0 + shift, q_hi = q0 + BQT - 1 + shift;  // positions
    if (kw0 >= g.sk || (g.causal && kw0 > q_hi) || (g.window > 0 && kw0 + 63 <= q_lo - g.window))
      continue;  // no key of this warpgroup is live for the tile
    const uint32_t q_tile = stage_q(st), do_tile = q_tile + P::SMALL;

    // S^T = K Q^T and dP^T = V dO^T: D / 16 k-steps each over D
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sT, desc_k(k_rows, SLAB_BIG, kk), desc_k(q_tile, SLAB_SMALL, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, desc_k(v_rows, SLAB_BIG, kk), desc_k(do_tile, SLAB_SMALL, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sT);
    fence_regs(dpt);

    // P^T and dS^T on the fragment: entry idx is key krow0 + 8 ((idx / 2) % 2),
    // query column 8 (idx / 4) + col0 + idx % 2 of the tile
    const bool whole = q0 + BQT <= g.sq && kw0 + 64 <= g.sk && (!g.causal || kw0 + 63 <= q_lo) &&
                       (g.window <= 0 || kw0 > q_hi - g.window);
    const float* lse_t = s_lse[st];
    const float* dl_t = s_dl[st];
    uint32_t pa[BQT / 16][4], dsa[BQT / 16][4];
#pragma unroll
    for (int idx = 0; idx < 32; idx += 2) {
      const int kp = krow0 + 8 * ((idx / 2) % 2);
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = 8 * (idx / 4) + col0 + c;
        float x = exp2f(sT[idx + c] * scale_log2 - lse_t[qc]);
        if (!whole && !live(q0 + qc, kp, g.sq, g.sk, shift, g.causal, g.window)) x = 0.f;
        p[c] = x;
        ds[c] = x * (dpt[idx + c] - dl_t[qc]);
      }
      pa[idx / 8][(idx % 8) / 2] = pack_bf16(p[0], p[1]);
      dsa[idx / 8][(idx % 8) / 2] = pack_bf16(ds[0], ds[1]);
    }

    // dV += P^T dO and dK += dS^T Q: one chain of BQT / 16 k-steps over the
    // tile's queries per 64-column slab
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs_n64(acc_v[c], pa[kk], desc_mn(do_tile, SLAB_SMALL, c, kk));
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs_n64(acc_k[c], dsa[kk], desc_mn(q_tile, SLAB_SMALL, c, kk));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      fence_regs(acc_v[c]);
      fence_regs(acc_k[c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = krow0 + 8 * i;
    if (kp >= g.sk) continue;
    const size_t off = ((size_t)(b * g.sk + kp) * g.n_kv_heads + kvh) * D;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int idx = 4 * j + 2 * i, col = c * SLAB + 8 * j + col0;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
            __floats2bfloat162_rn(acc_k[c][idx] * g.scale, acc_k[c][idx + 1] * g.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            __floats2bfloat162_rn(acc_v[c][idx], acc_v[c][idx + 1]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, Geom g, float scale_log2) {
  using P = Plan<D>;
  constexpr int NS = P::NS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // q and dO, stage 0, stage 1

  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base, s_do = base + P::BIG;
  auto stage_k = [&](int st) { return base + 2 * P::BIG + st * P::STAGE; };  // v after it
  const uint32_t bar_q = smem_addr(&bars[0]);
  auto bar_kv = [&](int st) { return smem_addr(&bars[1 + st]); };

  const int bh = blockIdx.x, b = bh / g.n_heads, h = bh % g.n_heads;
  const int kvh = h / (g.n_heads / g.n_kv_heads);
  // the last query tiles see the most keys under a causal mask: launched first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQD, shift = g.sk - g.sq;
  const int tid = threadIdx.x;
  const int group = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int wq0 = q0 + 64 * group;                 // this warpgroup's first row
  const int row0 = wq0 + 16 * warp + lane / 4;     // and row0 + 8
  const int col0 = 2 * (lane % 4);

  // keys any query of this block can see, in 64-key tiles
  int k_begin, k_end;
  key_range<BQD, BKT>(q0, g, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BKT - 1) / BKT;

  const CUtensorMap *map_k = &tk, *map_v = &tv;
  auto load_kv = [&](int st, int kt0) {  // thread 0
    const uint32_t dst = stage_k(st), bar = bar_kv(st);
    mbar_expect_tx(bar, P::STAGE);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load(dst + c * SLAB_SMALL, map_k, bar, c * SLAB, kvh, kt0, b);
      tma_load(dst + P::SMALL + c * SLAB_SMALL, map_v, bar, c * SLAB, kvh, kt0, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv(0), 1);
    mbar_init(bar_kv(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * P::BIG);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load(s_q + c * SLAB_BIG, &tq, bar_q, c * SLAB, h, q0, b);
      tma_load(s_do + c * SLAB_BIG, &tdo, bar_q, c * SLAB, h, q0, b);
    }
    load_kv(0, k_begin);
  }

  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    lse2[i] = r < g.sq ? lse[(size_t)bh * g.sq + r] * LOG2E : 0.f;
    dl[i] = r < g.sq ? delta[(size_t)bh * g.sq + r] : 0.f;
  }
  float s[32], dp[32], acc[NS][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f, dp[i] = 0.f;
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const uint32_t q_rows = s_q + 64 * group * ROW_BYTES;  // this warpgroup's 64 rows
  const uint32_t do_rows = s_do + 64 * group * ROW_BYTES;
  const int w_lo = wq0 + shift, w_hi = min(wq0 + 64, g.sq) - 1 + shift;  // its positions
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = k_begin + it * BKT, st = it & 1;
    // both warpgroups are done with tile it - 1, which stage st ^ 1 holds
    __syncthreads();
    if (tid == 0 && it + 1 < n_tiles) load_kv(st ^ 1, kt0 + BKT);
    mbar_wait(bar_kv(st), (it >> 1) & 1);
    if (wq0 >= g.sq || (g.causal && kt0 > w_hi) ||
        (g.window > 0 && kt0 + BKT - 1 <= w_lo - g.window))
      continue;  // no key of the tile is live for this warpgroup's rows
    const uint32_t k_tile = stage_k(st), v_tile = k_tile + P::SMALL;

    // S = Q K^T and dP = dO V^T: D / 16 k-steps each over D
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k(q_rows, SLAB_BIG, kk), desc_k(k_tile, SLAB_SMALL, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(do_rows, SLAB_BIG, kk), desc_k(v_tile, SLAB_SMALL, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // dS on the fragment: entry idx is row row0 + 8 ((idx / 2) % 2), key
    // kt0 + 8 (idx / 4) + col0 + idx % 2
    const bool whole = wq0 + 64 <= g.sq && kt0 + BKT <= g.sk &&
                       (!g.causal || kt0 + BKT - 1 <= w_lo) &&
                       (g.window <= 0 || kt0 > w_hi - g.window);
    uint32_t dsa[BKT / 16][4];
#pragma unroll
    for (int idx = 0; idx < 32; idx += 2) {
      const int i = (idx / 2) % 2;
      const int r = row0 + 8 * i;
      float ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = exp2f(s[idx + c] * scale_log2 - lse2[i]);
        if (!whole &&
            !live(r, kt0 + 8 * (idx / 4) + col0 + c, g.sq, g.sk, shift, g.causal, g.window))
          x = 0.f;
        ds[c] = x * (dp[idx + c] - dl[i]);
      }
      dsa[idx / 8][(idx % 8) / 2] = pack_bf16(ds[0], ds[1]);
    }

    // dQ += dS K: one chain of BKT / 16 k-steps over the tile's keys per
    // 64-column slab
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
        wgmma_rs_n64(acc[c], dsa[kk], desc_mn(k_tile, SLAB_SMALL, c, kk));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < NS; ++c) fence_regs(acc[c]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= g.sq) continue;
    __nv_bfloat16* qrow = dq + ((size_t)(b * g.sq + r) * g.n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int idx = 4 * j + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(qrow + c * SLAB + 8 * j + col0) =
            __floats2bfloat162_rn(acc[c][idx] * g.scale, acc[c][idx + 1] * g.scale);
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* delta, int b, int sq, int sk,
           int h, int kh, int causal, int window, float scale, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // 64-row boxes for the streamed tiles, 128-row boxes for the ones loaded once
  CUtensorMap tq_s, tdo_s, tk_b, tv_b, tq_b, tdo_b, tk_s, tv_s;
  if (!tensor_map<D>(encode, &tq_s, q, b, sq, h, BQT) ||
      !tensor_map<D>(encode, &tdo_s, dout, b, sq, h, BQT) ||
      !tensor_map<D>(encode, &tk_b, k, b, sk, kh, BKV) ||
      !tensor_map<D>(encode, &tv_b, v, b, sk, kh, BKV) ||
      !tensor_map<D>(encode, &tq_b, q, b, sq, h, BQD) ||
      !tensor_map<D>(encode, &tdo_b, dout, b, sq, h, BQD) ||
      !tensor_map<D>(encode, &tk_s, k, b, sk, kh, BKT) ||
      !tensor_map<D>(encode, &tv_s, v, b, sk, kh, BKT))
    return cudaErrorInvalidValue;
  constexpr int smem = Plan<D>::SMEM;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) ||
      (e = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return e;
  if ((e = static_cast<cudaError_t>(launch_delta<__nv_bfloat16, D>(o, dout, delta, b, sq, h, st))))
    return e;
  const Geom g{h, kh, sq, sk, causal, window, scale};
  const float scale_log2 = scale * LOG2E;
  flash_bwd_dkdv_wgmma<D><<<dim3(b * kh, (sk + BKV - 1) / BKV), NT, smem, st>>>(
      tq_s, tk_b, tv_b, tdo_s, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g, scale_log2);
  if ((e = cudaGetLastError())) return e;
  flash_bwd_dq_wgmma<D><<<dim3(b * h, (sq + BQD - 1) / BQD), NT, smem, st>>>(
      tq_b, tk_s, tv_s, tdo_b, lse, delta, static_cast<__nv_bfloat16*>(dq), g, scale_log2);
  return cudaGetLastError();
}

}  // namespace wg

// registers, static and dynamic shared memory and local (spilled) bytes of
// a kernel, into out[0..3]
template <class F>
int attributes(F* fn, int dynamic_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = dynamic_smem;
  out[3] = (int)a.localSizeBytes;
  return cudaSuccess;
}

template <int D>
int info(int dtype, int* out) {
  int e;
  if (dtype == 1) {
    const int tiles[4] = {wg::BKV, wg::BQT, wg::BQD, wg::BKT};
    for (int i = 0; i < 4; ++i) out[i] = tiles[i];
    if ((e = attributes(wg::flash_bwd_dkdv_wgmma<D>, wg::Plan<D>::SMEM, out + 4)) ||
        (e = attributes(wg::flash_bwd_dq_wgmma<D>, wg::Plan<D>::SMEM, out + 8)) ||
        (e = attributes(flash_bwd_delta<__nv_bfloat16, D>, 0, out + 12)))
      return e;
    return cudaSuccess;
  }
  const int tiles[4] = {BK, BQ, BQ, BK};
  for (int i = 0; i < 4; ++i) out[i] = tiles[i];
  if ((e = attributes(flash_bwd_dkdv<D>, smem_dkdv<D>, out + 4)) ||
      (e = attributes(flash_bwd_dq<D>, smem_dq<D>, out + 8)) ||
      (e = attributes(flash_bwd_delta<float, D>, 0, out + 12)))
    return e;
  return cudaSuccess;
}

}  // namespace

// dq, dk, dv (the inputs' shapes and dtype) from q, k, v, the forward's o and
// lse ((B, H, Sq) f32, natural log) and dout; delta is (B, H, Sq) f32
// scratch.  dtype: 0 float32, 1 bfloat16.  bf16 needs q, k, v and dout on
// 16-byte boundaries (TMA).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* delta, int dtype, int b, int sq, int sk,
                                   int h, int kh, int d, int causal, int window, float scale,
                                   void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || (sk < sq && (causal || window > 0)) || h <= 0 ||
      kh <= 0 || h % kh != 0 || (d != 64 && d != 128) || b * h > 65535 ||
      (sk + wg::BKV - 1) / wg::BKV > 65535 || (sq + wg::BQD - 1) / wg::BQD > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = d == 64;
  switch (dtype) {
    case 0:
      return d64 ? launch_f32<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kh,
                                  causal, window, scale, st)
                 : launch_f32<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kh,
                                   causal, window, scale, st);
    case 1:
      return d64 ? wg::launch<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kh,
                                  causal, window, scale, st)
                 : wg::launch<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kh,
                                   causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// the tiles (keys a dK/dV block, queries a tile of its loop, queries a dQ
// block, keys a tile of its loop) into out[0..3], then registers, static and
// dynamic shared memory and local bytes of the dK/dV, dQ and delta kernels
// of a dtype and head dim into out[4..15]
extern "C" int flash_attention_bwd_info(int dtype, int d, int* out) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128)) return cudaErrorInvalidValue;
  return d == 64 ? info<64>(dtype, out) : info<128>(dtype, out);
}
