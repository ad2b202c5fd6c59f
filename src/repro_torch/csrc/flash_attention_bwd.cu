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
// f32 (flash_bwd_dkdv<D>, flash_bwd_dq<D>): f32 FMA on the CUDA cores, on
// flash_f32.cuh's register tiles (8 rows x 4 columns a thread in every
// product, float4 operand reads, a cp.async ring with the next 32-wide slice
// in flight); bound by the 10 D flops a live pair at 67 TFLOP/s (19.25 ms
// before this design at the llama3.2-3b train_4k step, 20% of its bound).
//   dK/dV: a block holds 64 keys, K and V loaded once; D-query tiles of Q
//     and dO stream through the ring twice, as d-slices for S^T = K Q^T and
//     dP^T = V dO^T, then as 32-row slices for dV += P^T dO and dK += dS^T Q.
//     Its 4 D threads are two halves: one makes P^T (into shared memory) and
//     dV, the other dP^T, dS^T (reading P^T after the next stage's barrier)
//     and dK, so a thread holds one D-wide accumulator (8 x 4) beside one
//     score tile.  At D 128 one 512-thread block an SM (204 KB of shared
//     memory), at D 64 two of 256 (104 KB).
//   dQ: a block holds 64 queries and 2 D threads; a D-key tile streams as
//     d-slices of Q beside K (S), of dO beside V (dP), then 32-row slices
//     of K (dQ += dS K), P and then dS in one shared tile.  88 KB at D 128
//     (two blocks an SM), 54 KB at D 64 (four).
//   Every block holds 16 warps an SM at most 128 registers a thread.  Both
//   dtypes' kernels share Geom, key_range and query_range.
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_f32.cuh"
#include "hopper.cuh"
#include "kernel_error.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;  // threads of a delta block

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

// is the key at position kp live for query row qr (flash_f32.cuh; plain
// ints, not a Geom: with the Geom form ptxas spilled 24 bytes of the bf16
// dK/dV kernel at D 128, which sits at the 255-register cap)
using f32::live;

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
namespace simt {

using f32::all_live;
using f32::cmax;
using f32::copy_rows;
using f32::KC;
using f32::Lanes;
using f32::make_ring;
using f32::mma_nn;
using f32::mma_nt;
using f32::ROWS;
using f32::STAGES;
using f32::TM;
using f32::TN;
using f32::zero;

// dQ at head dim D: 64 queries a block, D-key tiles.  A ring stage holds a
// d-slice of the Q (then dO) tile beside one of the K (then V) tile, or 32
// rows of the K tile.
template <int D>
struct DqPlan {
  using L = Lanes<D>;
  static constexpr int BQ = ROWS, BK = D;
  static constexpr int STAGE = cmax((BQ + BK) * L::LK, KC * L::LD);
  static constexpr int SMEM = sizeof(float) * (BQ * L::LD + 2 * BQ + STAGES * STAGE);
};

// dK and dV at head dim D: 64 keys a block, D-query tiles, two halves of
// 2 D threads.  A ring stage holds d-slices of the Q and dO tiles side by
// side, or 32 rows of each.
template <int D>
struct DkdvPlan {
  using L = Lanes<D>;
  static constexpr int BK = ROWS, BQ = D, NT = 2 * L::NT;
  static constexpr int STAGE = cmax(2 * BQ * L::LK, 2 * KC * L::LD);
  static constexpr int SMEM = sizeof(float) * (4 * BK * L::LD + STAGES * STAGE);
};

// 2. dK and dV of one key tile of one kv head.  The first half computes
// S^T = K Q^T, P^T = exp(S^T scale - lse) and dV += P^T dO; the second
// dP^T = V dO^T, dS^T = P^T (dP^T - delta) (P^T read back from the first
// half's shared tile after the stage barrier) and dK += dS^T Q.  Lane l of
// group gr of a half owns keys gr + NG i (i < 8), of a query tile the
// queries l + NL j, of its accumulator the columns 4 l .. 4 l + 3.  The GQA
// group's query heads add into the same registers, head after head.
template <int D>
__global__ void __launch_bounds__(DkdvPlan<D>::NT, 512 / DkdvPlan<D>::NT)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, Geom g) {
  using L = Lanes<D>;
  using P = DkdvPlan<D>;
  constexpr int NT = P::NT, NTH = L::NT, NL = L::NL, NG = L::NG, LD = L::LD, LK = L::LK;
  constexpr int BK = P::BK, BQ = P::BQ, NS = D / KC, NR = BQ / KC;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* vs = ks + BK * LD;                      // [BK][LD]
  float* pts = vs + BK * LD;                     // [BK][LD]: P^T of the query tile (BQ = D)
  float* dsts = pts + BK * LD;                   // [BK][LD]: dS^T
  float* ring = dsts + BK * LD;

  const int bk = blockIdx.y, b = bk / g.n_kv_heads, kvh = bk % g.n_kv_heads;
  const int grp = g.n_heads / g.n_kv_heads;
  // the first key tiles see the most queries under a causal mask: launched first
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, half = tid / NTH, gr = (tid % NTH) / NL, l = tid % NL;
  const size_t q_stride = (size_t)g.n_heads * D, kv_stride = (size_t)g.n_kv_heads * D;
  const size_t kv_off = (size_t)b * g.sk * kv_stride + (size_t)kvh * D;

  // query rows that can see a key of this block, in BQ-row tiles, head by head
  int r_lo, r_hi;
  query_range<BK>(k0, g, r_lo, r_hi);
  const int t_lo = r_lo / BQ;
  const int n_qt = r_hi >= r_lo ? r_hi / BQ - t_lo + 1 : 0;
  const int n_tiles = grp * n_qt;
  // stage n (the ring asks for them in order): of the tile of head it / n_qt,
  // query tile it % n_qt, the d-slices of Q and dO, then both by 32 rows
  auto stage = [=, hh = 0, qt = 0, c = 0](float* dst, int) mutable {
    const int q0 = (t_lo + qt) * BQ;
    const size_t off = (size_t)b * g.sq * q_stride + (size_t)(kvh * grp + hh) * D;
    if (c < NS) {
      copy_rows<BQ, KC, NT>(dst, LK, q + off + c * KC, q_stride, q0, g.sq, tid);
      copy_rows<BQ, KC, NT>(dst + BQ * LK, LK, dout + off + c * KC, q_stride, q0, g.sq, tid);
    } else {
      const int r0 = q0 + (c - NS) * KC;
      copy_rows<KC, D, NT>(dst, LD, q + off, q_stride, r0, g.sq, tid);
      copy_rows<KC, D, NT>(dst + KC * LD, LD, dout + off, q_stride, r0, g.sq, tid);
    }
    if (++c == NS + NR) c = 0, qt = qt + 1 == n_qt ? (++hh, 0) : qt + 1;
  };
  if (n_tiles > 0) {
    copy_rows<BK, D, NT>(ks, LD, k + kv_off, kv_stride, k0, g.sk, tid);
    copy_rows<BK, D, NT>(vs, LD, v + kv_off, kv_stride, k0, g.sk, tid);
  }
  auto tiles = make_ring<P::STAGE>(ring, stage, n_tiles * (NS + NR));
  tiles.start();

  // the first half: S^T from K and Q, its accumulator dV; the second: dP^T
  // from V and dO, its accumulator dK
  const float* kv_rows = (half == 0 ? ks : vs) + gr * LD;
  float* mine = (half == 0 ? pts : dsts) + gr * LD;
  const float* stats = half == 0 ? lse : delta;
  float acc[TM][TN], x[TM][TN];
  zero(acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int h = kvh * grp + it / n_qt, q0 = (t_lo + it % n_qt) * BQ;
    // this thread's queries' lse (first half) or delta (second)
    float st[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = q0 + l + NL * j;
      st[j] = r < g.sq ? stats[((size_t)b * g.n_heads + h) * g.sq + r] : 0.f;
    }
    zero(x);
#pragma unroll 1
    for (int c = 0; c < NS; ++c)
      mma_nt<NG, NL, LD, LK>(x, kv_rows + c * KC, tiles.next() + half * BQ * LK + l * LK);

    if (half == 0) {  // P^T, masked entries exact zeros
      const bool whole = all_live(q0, BQ, k0, BK, g.sq, g.sk, g.causal, g.window);
      const int shift = g.sk - g.sq;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const bool ok = whole || live(q0 + l + NL * j, k0 + gr + NG * i, g.sq, g.sk,
                                             shift, g.causal, g.window);
          pts[(gr + NG * i) * LD + l + NL * j] = ok ? expf(x[i][j] * g.scale - st[j]) : 0.f;
        }
    }
#pragma unroll 1
    for (int c = 0; c < NR; ++c) {
      const float* s = tiles.next();
      if (half == 1 && c == 0) {  // dS^T, after the barrier that shows P^T
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int at = (gr + NG * i) * LD + l + NL * j;
            dsts[at] = pts[at] * (x[i][j] - st[j]);
          }
        __syncwarp();
      }
      // dV += P^T dO (dO's rows after Q's in the stage), dK += dS^T Q
      mma_nn<NG, LD, LD>(acc, mine + c * KC, s + (1 - half) * KC * LD + 4 * l);
    }
  }

  float* out = half == 0 ? dv : dk;
  const float sc = half == 0 ? 1.f : g.scale;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int j = k0 + gr + NG * i;
    if (j >= g.sk) continue;
    *reinterpret_cast<float4*>(out + kv_off + (size_t)j * kv_stride + 4 * l) =
        make_float4(acc[i][0] * sc, acc[i][1] * sc, acc[i][2] * sc, acc[i][3] * sc);
  }
}

// 3. dQ of one query tile of one head: over the live key tiles, S = Q K^T
// to P (into shared memory), dP = dO V^T to dS = P (dP - delta) in place,
// then dQ += dS K.  Lane l of group gr owns query rows gr + NG i (i < 8), of
// a key tile the keys l + NL j, of dQ the columns 4 l .. 4 l + 3.
template <int D>
__global__ void __launch_bounds__(Lanes<D>::NT, 512 / Lanes<D>::NT)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, Geom g) {
  using L = Lanes<D>;
  using P = DqPlan<D>;
  constexpr int NT = L::NT, NL = L::NL, NG = L::NG, LD = L::LD, LK = L::LK;
  constexpr int BQ = P::BQ, BK = P::BK, NS = D / KC, NR = BK / KC;
  constexpr int PER_TILE = 2 * NS + NR;
  extern __shared__ float4 smem4[];
  float* dss = reinterpret_cast<float*>(smem4);  // [BQ][LD]: P, then dS, of the key tile
  float* lse_s = dss + BQ * LD;                   // [BQ]
  float* dl_s = lse_s + BQ;                       // [BQ]
  float* ring = dl_s + BQ;

  const int bh = blockIdx.y, b = bh / g.n_heads, h = bh % g.n_heads;
  const int kvh = h / (g.n_heads / g.n_kv_heads);
  // the last query tiles see the most keys under a causal mask: launched first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x, gr = tid / NL, l = tid % NL;
  const size_t q_stride = (size_t)g.n_heads * D, kv_stride = (size_t)g.n_kv_heads * D;
  const size_t q_off = (size_t)b * g.sq * q_stride + (size_t)h * D;
  const size_t kv_off = (size_t)b * g.sk * kv_stride + (size_t)kvh * D;
  for (int i = tid; i < BQ; i += NT) {
    const int r = q0 + i;
    lse_s[i] = r < g.sq ? lse[(size_t)bh * g.sq + r] : 0.f;
    dl_s[i] = r < g.sq ? delta[(size_t)bh * g.sq + r] : 0.f;
  }
  int k_begin, k_end;
  key_range<BQ, BK>(q0, g, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // stage n: of key tile n / PER_TILE, the d-slices of Q beside K, of dO
  // beside V, then K by 32 rows
  auto stage = [=](float* dst, int n) {
    const int k0 = k_begin + n / PER_TILE * BK;
    int c = n % PER_TILE;
    if (c < 2 * NS) {
      const float* a = c < NS ? q : dout;
      const float* bm = c < NS ? k : v;
      c %= NS;
      copy_rows<BQ, KC, NT>(dst, LK, a + q_off + c * KC, q_stride, q0, g.sq, tid);
      copy_rows<BK, KC, NT>(dst + BQ * LK, LK, bm + kv_off + c * KC, kv_stride, k0, g.sk, tid);
    } else {
      copy_rows<KC, D, NT>(dst, LD, k + kv_off, kv_stride, k0 + (c - 2 * NS) * KC, g.sk, tid);
    }
  };
  auto tiles = make_ring<P::STAGE>(ring, stage, n_tiles * PER_TILE);
  tiles.start();

  float acc[TM][TN], x[TM][TN];
  zero(acc);
  const int shift = g.sk - g.sq;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    // S = Q K^T, then P into shared memory, masked entries exact zeros
    zero(x);
#pragma unroll 1
    for (int c = 0; c < NS; ++c) {
      const float* s = tiles.next();
      mma_nt<NG, NL, LK, LK>(x, s + gr * LK, s + BQ * LK + l * LK);
    }
    const bool whole = all_live(q0, BQ, k0, BK, g.sq, g.sk, g.causal, g.window);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = gr + NG * i;
        const bool ok = whole || live(q0 + r, k0 + l + NL * j, g.sq, g.sk, shift,
                                           g.causal, g.window);
        dss[r * LD + l + NL * j] = ok ? expf(x[i][j] * g.scale - lse_s[r]) : 0.f;
      }
    // dP = dO V^T, then dS = P (dP - delta) over P, each thread its own entries
    zero(x);
#pragma unroll 1
    for (int c = 0; c < NS; ++c) {
      const float* s = tiles.next();
      mma_nt<NG, NL, LK, LK>(x, s + gr * LK, s + BQ * LK + l * LK);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = gr + NG * i, at = r * LD + l + NL * j;
        dss[at] = dss[at] * (x[i][j] - dl_s[r]);
      }
    __syncwarp();
    // dQ += dS K over the tile's keys, 32 at a time
#pragma unroll 1
    for (int c = 0; c < NR; ++c)
      mma_nn<NG, LD, LD>(acc, dss + gr * LD + c * KC, tiles.next() + 4 * l);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + gr + NG * i;
    if (r >= g.sq) continue;
    *reinterpret_cast<float4*>(dq + q_off + (size_t)r * q_stride + 4 * l) =
        make_float4(acc[i][0] * g.scale, acc[i][1] * g.scale, acc[i][2] * g.scale,
                    acc[i][3] * g.scale);
  }
}

}  // namespace simt

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* delta, int b, int sq,
               int sk, int h, int kh, int causal, int window, float scale, cudaStream_t st) {
  using KvPlan = simt::DkdvPlan<D>;
  using QPlan = simt::DqPlan<D>;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(simt::flash_bwd_dkdv<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, KvPlan::SMEM)) ||
      (e = cudaFuncSetAttribute(simt::flash_bwd_dq<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, QPlan::SMEM)))
    return e;
  const Geom g{h, kh, sq, sk, causal, window, scale};
  const float *qt = static_cast<const float*>(q), *kt = static_cast<const float*>(k),
              *vt = static_cast<const float*>(v), *dot = static_cast<const float*>(dout);
  if ((e = static_cast<cudaError_t>(launch_delta<float, D>(o, dout, delta, b, sq, h, st))))
    return e;
  const dim3 k_grid((sk + KvPlan::BK - 1) / KvPlan::BK, b * kh);
  const dim3 q_grid((sq + QPlan::BQ - 1) / QPlan::BQ, b * h);
  simt::flash_bwd_dkdv<D><<<k_grid, KvPlan::NT, KvPlan::SMEM, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), g);
  if ((e = cudaGetLastError())) return e;
  simt::flash_bwd_dq<D><<<q_grid, f32::Lanes<D>::NT, QPlan::SMEM, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), g);
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

using f32::attributes;

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
  const int tiles[4] = {simt::DkdvPlan<D>::BK, simt::DkdvPlan<D>::BQ, simt::DqPlan<D>::BQ,
                        simt::DqPlan<D>::BK};
  for (int i = 0; i < 4; ++i) out[i] = tiles[i];
  if ((e = attributes(simt::flash_bwd_dkdv<D>, simt::DkdvPlan<D>::SMEM, out + 4)) ||
      (e = attributes(simt::flash_bwd_dq<D>, simt::DqPlan<D>::SMEM, out + 8)) ||
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
