// flash_attention for sm_90a: online-softmax attention with causal and/or
// sliding-window masking and grouped-query heads (GQA).
//
// Replaces the TPU kernel flash_attention
// (repro/kernels/flash_attention.py:86, pallas_call at :106).  Shapes, in the
// JAX package's layout: q (B, Sq, H, D), k and v (B, Sk, K, D) with H % K == 0,
// o (B, Sq, H, D) in q's dtype (float32 or bfloat16); D is 64 or 128, the
// head dims the TPU kernel names (:6).  Queries sit at the LAST Sq key
// positions (flash_attention.py:44): query row r has position r + Sk - Sq.
// Any Sq and Sk: the ragged edge is masked, where the TPU kernel asserts
// whole tiles.  Sq > Sk only without causal or window masks (a
// cross-attention): there the offset masks nothing, while under a causal
// mask rows would be left with no live key, which the TPU kernel writes as 0
// (:73, :82) and a plain softmax as the mean of v.
// Key tiles that no query of a block can see are never loaded (the loop
// bounds follow the causal and window limits, :54-60); inside a visited
// tile masked entries get -1e30 and, after the exponential, exactly 0 (:74),
// so a row whose first live tile is all masked for it adds nothing.
// Given an lse pointer (the training route), each kernel also writes each
// query row's natural log-sum-exp of its scaled scores over its live keys,
// (B, H, Sq) f32, from the running max and sum it holds (the bf16 kernel's
// are in base 2, and it converts), so the backward recomputes no row
// statistics; without one it writes nothing more and o is the same.
// The bf16 kernel's TMA, mbarrier and wgmma helpers live in hopper.cuh,
// which the bf16 backward shares.
//
// Bound on an H100: the bytes of q, k, v and o once at 3.35 TB/s against
// 4*B*H*D*(live query-key pairs) operations, at 989 TFLOP/s for bf16 inputs
// (tensor cores) or 67 TFLOP/s for f32 inputs.  Both dtypes are bound by
// operations at the served shapes (bf16: 0.0994 ms at the llama3.2-3b
// prefill, B 4, S 2000, H 24, K 8).  Each dtype has one kernel:
//
// bf16 (flash_fwd_wgmma<D>): the two products on the tensor cores.  One block of
// two warpgroups per (batch * head, 128-query tile), each warpgroup 64 query
// rows.  TMA loads q once and k, v in 128-key tiles into a two-stage ring in
// shared memory (128-byte swizzle, one 64-column slab per box, D / 64 slabs a
// row; rows past Sq or Sk arrive as zeros and are masked as keys), each stage
// completed on an mbarrier; thread 0 asks
// for tile i+1 before the warpgroups start on tile i, after a barrier that
// says both are done with the stage it refills.  S = Q K^T is wgmma
// m64n128k16 (D / 16 k-steps) with both operands in shared memory, f32 accumulators; the
// softmax runs on the accumulator fragment in registers, in base 2 (scores
// times scale * log2 e, exp2f), its row max and sum reduced over the 4
// threads that share a row.  P is rounded to bf16 in registers, where the
// fragment of 16 score columns is wgmma's A operand, and O += P V is one
// m64n64k16 chain per 64-column slab of V (B from shared memory, MN-major):
// one chain at D 64, two at D 128.
// Rounding P to bf16 is what the JAX model's own chunked attention does
// (repro/models/layers.py:139-144); the TPU kernel keeps P in f32.
//
// f32 (flash_fwd): f32 FMA on the CUDA cores, as the TPU kernel computes in
// f32 (:66-79).  One block per (batch * head, 64-query tile), 256 threads; a
// loop over 64-key tiles takes the place of the TPU kernel's sequential kv
// grid axis (:36-39), with the running max and sum in registers and an f32
// accumulator of 4 rows x D/16 columns per thread.  q (pre-scaled by
// 1/sqrt(D), as :66), k and v tiles sit in shared memory; the P.V product
// takes each softmax weight from the thread that computed it by a warp
// shuffle.
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "kernel_error.cuh"

namespace {

constexpr float NEG_INF = -1e30f;            // the TPU kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------------ f32 ----
constexpr int BQ = 64, BK = 64, NT = 256;  // 16 x 16 threads

__device__ __forceinline__ float to_f32(float x) { return x; }

template <class T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Thread t owns query rows ty + 16*i (i < 4) with ty = t / 16, and within a
// key tile the columns tx + 16*j (j < 4) of the scores, of the output the
// columns tx + 16*c (c < D/16), with tx = t % 16.  The 16 threads of one ty
// are one half of a warp, so a row's max and sum are shuffle reductions
// within 16 lanes.
template <class T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int n_heads, int n_kv_heads, int sq,
          int sk, int causal, int window, float scale) {
  constexpr int DP = D + 1;  // padded rows: reading a column is conflict-free
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][DP], q * scale
  float* ks = qs + BQ * DP;   // [BK][DP]
  float* vs = ks + BK * DP;   // [BK][D]

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv_heads);  // the index map at :111-112
  // the last tiles carry the most keys under a causal mask: launch them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int shift = sk - sq;  // query row r sits at key position r + shift
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const size_t q_stride = (size_t)n_heads * D, kv_stride = (size_t)n_kv_heads * D;
  const T* qb = q + (size_t)b * sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    qs[r * DP + d] = q0 + r < sq ? to_f32(qb[(size_t)(q0 + r) * q_stride + d]) * scale : 0.f;
  }

  // keys any query of this tile can see: [k_begin, k_end)
  const int q_lo = q0 + shift, q_hi = min(q0 + BQ, sq) - 1 + shift;
  int k_end = sk, k_begin = 0;
  if (causal) k_end = min(sk, q_hi + 1);
  if (window > 0) k_begin = max(0, q_lo - window + 1) / BK * BK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < sk;
      const size_t off = (size_t)(k0 + r) * kv_stride + d;
      ks[r * DP + d] = in ? to_f32(kb[off]) : 0.f;
      vs[r * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    // online softmax, row by row; s[i][j] becomes the weight p
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + shift;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        live[j] = ok;
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rs += __shfl_xor_sync(FULL, rs, w, 16);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }

    // acc += P V: the weight of key tx' + 16*j lives in lane tx' of this half-warp
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll 4
      for (int src = 0; src < 16; ++src) {
        const int kk = src + 16 * j;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = __shfl_sync(FULL, s[i][j], src, 16);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float vv = vs[kk * D + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

  T* ob = o + (size_t)b * sq * q_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[(size_t)r * q_stride + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * sq + r] = m[i] + logf(l[i]);
  }
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
           int sk, int h, int kh, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + BQ - 1) / BQ);
  flash_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, h, kh, sq, sk, causal, window, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16 ----
namespace wg {

using namespace hopper;

constexpr int BQ = 128;                  // query rows a block: 2 warpgroups of 64
constexpr int BK = 128;                  // keys a tile
constexpr int NT = 256;
constexpr int Q_SLAB = BQ * ROW_BYTES;   // 16 KB
constexpr int KV_SLAB = BK * ROW_BYTES;  // 16 KB

// the shared-memory plan at head dim D: a row is D / 64 slabs
template <int D>
struct Plan {
  static_assert(D % SLAB == 0, "head dim: whole 64-column slabs");
  static constexpr int NS = D / SLAB;
  static constexpr int Q_BYTES = NS * Q_SLAB;    // the q tile
  static constexpr int KV_BYTES = NS * KV_SLAB;  // one k or v tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // the swizzled tiles start on 1024-byte boundaries (the swizzle's period)
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGE_BYTES;
};

// Fragments (per warpgroup, thread t = 32 * warp + lane): accumulator entry
// 4*j + 2*i + c holds row 16*warp + lane/4 + 8*i, column 8*j + 2*(lane%4) + c.
// The 16 columns 16*kk.. of that fragment, as bf16 pairs in the order of
// entries 8*kk .. 8*kk+7, are the A fragment of k-step kk.
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int n_heads, int n_kv_heads, int sq, int sk, int causal, int window,
                float scale_log2) {
  using P = Plan<D>;
  constexpr int NS = P::NS, Q_BYTES = P::Q_BYTES, KV_BYTES = P::KV_BYTES;
  constexpr int STAGE_BYTES = P::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // q, stage 0, stage 1

  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;  // slab c holds columns 64c.. of all BQ rows
  const uint32_t bar_q = smem_addr(&bars[0]);
  // stage st: k slabs at stage_k(st), v slabs KV_BYTES after them
  auto stage_k = [&](int st) { return base + Q_BYTES + st * STAGE_BYTES; };
  auto bar_kv = [&](int st) { return smem_addr(&bars[1 + st]); };

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  // the last tiles carry the most keys under a causal mask: launch them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int shift = sk - sq;  // query row r sits at key position r + shift
  const int tid = threadIdx.x;
  const int group = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + 64 * group + 16 * warp + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);

  // keys any query of this block can see: [k_begin, k_end)
  const int q_lo = q0 + shift, q_hi = min(q0 + BQ, sq) - 1 + shift;
  const int k_end = causal ? min(sk, q_hi + 1) : sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  const CUtensorMap *map_k = &tk, *map_v = &tv;
  auto load_kv = [&](int st, int k0) {
    const uint32_t dst = stage_k(st), bar = bar_kv(st);
    mbar_expect_tx(bar, STAGE_BYTES);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load(dst + c * KV_SLAB, map_k, bar, c * SLAB, kvh, k0, b);
      tma_load(dst + KV_BYTES + c * KV_SLAB, map_v, bar, c * SLAB, kvh, k0, b);
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
    mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
    for (int c = 0; c < NS; ++c) tma_load(s_q + c * Q_SLAB, &tq, bar_q, c * SLAB, h, q0, b);
    load_kv(0, k_begin);
  }

  float s[64], acc[NS][32];
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // l: this thread's columns
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const uint32_t q_rows = s_q + 64 * group * ROW_BYTES;  // this warpgroup's 64 rows
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK, st = it & 1;
    // both warpgroups are done with tile it - 1, which stage st ^ 1 holds
    __syncthreads();
    if (tid == 0 && it + 1 < n_tiles) load_kv(st ^ 1, k0 + BK);
    mbar_wait(bar_kv(st), (it >> 1) & 1);
    const uint32_t k_tile = stage_k(st), v_tile = k_tile + KV_BYTES;

    // S = Q K^T: D / 16 k-steps of 16 over D, 4 in each 64-column slab
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, desc_k(q_rows, Q_SLAB, kk), desc_k(k_tile, KV_SLAB, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // online softmax in base 2 on the fragment
    const bool whole = k0 + BK <= sk && (!causal || k0 + BK - 1 <= q_lo) &&
                       (window <= 0 || k0 > q_hi - window);
    auto live = [&](int idx) {
      const int kp = k0 + 8 * (idx / 4) + col0 + idx % 2;
      const int qp = row0 + 8 * ((idx / 2) % 2) + shift;
      return kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
    };
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int idx = 0; idx < 64; ++idx) {
      float x = s[idx] * scale_log2;
      if (!whole && !live(idx)) x = NEG_INF;
      s[idx] = x;
      mx[(idx / 2) % 2] = fmaxf(mx[(idx / 2) % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      alpha[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha[i];
    }
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int idx = 0; idx < 64; idx += 2) {
      const int i = (idx / 2) % 2;
      float p0 = exp2f(s[idx] - mx[i]), p1 = exp2f(s[idx + 1] - mx[i]);
      if (!whole) {
        p0 = live(idx) ? p0 : 0.f;
        p1 = live(idx + 1) ? p1 : 0.f;
      }
      l_run[i] += p0 + p1;
      p[idx / 8][(idx % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) acc[c][idx] *= alpha[(idx / 2) % 2];

    // O += P V: one chain of 8 k-steps per 64-column slab of V; k-step kk
    // reads keys 16*kk.. (two 8-row groups of 1024 bytes)
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_n64(acc[c], p[kk], desc_mn(v_tile, KV_SLAB, c, kk));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < NS; ++c) fence_regs(acc[c]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(FULL, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(FULL, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= sq) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    __nv_bfloat16* orow = o + ((size_t)(b * sq + r) * n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int idx = 4 * j + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(orow + c * SLAB + 8 * j + col0) =
            __floats2bfloat162_rn(acc[c][idx] / denom, acc[c][idx + 1] / denom);
      }
    // m_run and l_run are in base 2; lse is kept in base e
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t)bh * sq + r] = (m_run[i] + log2f(l_run[i])) * LN2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
           int sk, int h, int kh, int causal, int window, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<D>(encode, &tq, q, b, sq, h, BQ) ||
      !tensor_map<D>(encode, &tk, k, b, sk, kh, BK) ||
      !tensor_map<D>(encode, &tv, v, b, sk, kh, BK))
    return cudaErrorInvalidValue;
  constexpr int smem = Plan<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + BQ - 1) / BQ);
  flash_fwd_wgmma<D><<<grid, NT, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse,
                                                 h, kh, sq, sk, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no window.  Sq > Sk only
// with neither mask.  lse, where not null, gets each query row's natural
// log-sum-exp of its scaled scores over its live keys, (B, H, Sq) f32, for
// the backward; null writes nothing.  o is the same either way.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, float* lse,
                               int dtype, int b, int sq, int sk, int h, int kh, int d,
                               int causal, int window, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || (sk < sq && (causal || window > 0)) || h <= 0 ||
      kh <= 0 || h % kh != 0 || (d != 64 && d != 128) || (sq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = d == 64;
  switch (dtype) {
    case 0:
      return d64 ? launch<float, 64>(q, k, v, o, lse, b, sq, sk, h, kh, causal, window, scale, st)
                 : launch<float, 128>(q, k, v, o, lse, b, sq, sk, h, kh, causal, window, scale,
                                      st);
    case 1:
      return d64 ? wg::launch<64>(q, k, v, o, lse, b, sq, sk, h, kh, causal, window, scale, st)
                 : wg::launch<128>(q, k, v, o, lse, b, sq, sk, h, kh, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
