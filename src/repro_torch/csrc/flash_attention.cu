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
// f32 (flash_fwd_f32<D>): f32 FMA on the CUDA cores, as the TPU kernel
// computes in f32 (:66-79); bound by those operations at 67 TFLOP/s (2.825
// ms before this design at the deepseek-moe-16b prefill, 35% of its bound).
// flash_f32.cuh's register tiles: one block of 2 D threads per (batch *
// head, 64-query tile), 8 query rows x 4 columns a thread in both products;
// a loop over D-key tiles takes the place of the TPU kernel's sequential kv
// grid axis (:36-39).  q (64 x D) sits in shared memory for the block; a key
// tile streams through the cp.async ring as D / 32 d-slices of K, for S =
// q K^T, then D / 32 slices of 32 V rows, for O += P V, the next slice in
// flight while one is read.  Between the two, the online softmax runs on S
// in registers (a row's max and sum over its group's lanes, the running max
// and sum a row in registers, natural exp), and P goes to shared memory in
// the layout P V reads, where only its row group reads it back.  At D 128 a
// block takes 103 KB of shared memory (two a multiprocessor), at D 64 53 KB
// (four); either way 16 warps an SM and at most 128 registers a thread.
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_f32.cuh"
#include "hopper.cuh"
#include "kernel_error.cuh"

namespace {

constexpr float NEG_INF = -1e30f;            // the TPU kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------------ f32 ----
namespace simt {

using f32::all_live;
using f32::cmax;
using f32::copy_rows;
using f32::cp_wait;
using f32::KC;
using f32::Lanes;
using f32::live;
using f32::make_ring;
using f32::mma_nn;
using f32::mma_nt;
using f32::ROWS;
using f32::STAGES;
using f32::TM;
using f32::TN;
using f32::zero;

// the f32 block at head dim D: 64 queries, D-key tiles; the ring's stage
// holds a d-slice of a K tile ([D keys][32]) or 32 rows of a V tile
template <int D>
struct Plan {
  using L = Lanes<D>;
  static constexpr int BQ = ROWS, BK = D;
  static constexpr int K_SLICE = BK * L::LK, V_ROWS = KC * L::LD;
  static constexpr int STAGE = cmax(K_SLICE, V_ROWS);
  static constexpr int SMEM = sizeof(float) * (2 * BQ * L::LD + STAGES * STAGE + 2 * BQ);
};

// Lane l of group g owns query rows g + NG i (i < 8), of a key tile's
// scores the keys l + NL j, of the output the columns 4 l .. 4 l + 3 (j < 4).
// Each row's running max and sum sit in shared memory (lane 0 of its group
// writes them), not in the group's registers.
template <int D>
__global__ void __launch_bounds__(Lanes<D>::NT, 512 / Lanes<D>::NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int n_heads, int n_kv_heads, int sq, int sk, int causal, int window, float scale) {
  using L = Lanes<D>;
  using P = Plan<D>;
  constexpr int NT = L::NT, NL = L::NL, NG = L::NG, LD = L::LD, LK = L::LK;
  constexpr int BQ = P::BQ, BK = P::BK, NKS = D / KC, NVS = BK / KC;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]: the block's queries
  float* ps = qs + BQ * LD;                      // [BQ][LD]: P of the key tile (BK = D)
  float* ring = ps + BQ * LD;                    // STAGES x STAGE
  float* ms = ring + STAGES * P::STAGE;          // [BQ]: each row's running max
  float* ls = ms + BQ;                           // [BQ]: and sum of weights

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv_heads);  // the index map at :111-112
  // the last tiles carry the most keys under a causal mask: launch them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int shift = sk - sq;  // query row r sits at key position r + shift
  const int tid = threadIdx.x, g = tid / NL, l = tid % NL;

  const size_t q_stride = (size_t)n_heads * D, kv_stride = (size_t)n_kv_heads * D;
  const float* qb = q + (size_t)b * sq * q_stride + (size_t)h * D;
  const float* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * D;

  // keys any query of this tile can see: [k_begin, k_end)
  const int q_lo = q0 + shift, q_hi = min(q0 + BQ, sq) - 1 + shift;
  const int k_end = causal ? min(sk, q_hi + 1) : sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // stage n: of key tile n / (NKS + NVS), the d-slices of K, then V by 32 rows
  auto stage = [=](float* dst, int n) {
    const int k0 = k_begin + n / (NKS + NVS) * BK, c = n % (NKS + NVS);
    if (c < NKS)
      copy_rows<BK, KC, NT>(dst, LK, kb + c * KC, kv_stride, k0, sk, tid);
    else
      copy_rows<KC, D, NT>(dst, LD, vb, kv_stride, k0 + (c - NKS) * KC, sk, tid);
  };
  copy_rows<BQ, D, NT>(qs, LD, qb, q_stride, q0, sq, tid);
  auto tiles = make_ring<P::STAGE>(ring, stage, n_tiles * (NKS + NVS));
  tiles.start();

  float acc[TM][TN], s[TM][TN];
  if (tid < BQ) ms[tid] = NEG_INF, ls[tid] = 0.f;
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    // S = q K^T over the tile's d-slices
    zero(s);
#pragma unroll 1
    for (int c = 0; c < NKS; ++c)
      mma_nt<NG, NL, LD, LK>(s, qs + g * LD + c * KC, tiles.next() + l * LK);

    // online softmax, row by row: a row's max and sum over the group's NL
    // lanes; P into shared memory for the group's P V
    const bool whole = all_live(q0, BQ, k0, BK, sq, sk, causal, window);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = g + NG * i;
      bool ok[TN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        ok[j] = whole || live(q0 + r, k0 + l + NL * j, sq, sk, shift, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = NL / 2; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w, NL));
      // every lane reads the row's max before lane 0, past the shuffles
      // below, writes the new one
      const float m_old = ms[r], m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[r * LD + l + NL * j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = NL / 2; w > 0; w >>= 1) rs += __shfl_xor_sync(FULL, rs, w, NL);
      if (l == 0) ls[r] = ls[r] * alpha + rs, ms[r] = m_new;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();

    // O += P V over the tile's keys, 32 at a time
#pragma unroll 1
    for (int c = 0; c < NVS; ++c)
      mma_nn<NG, LD, LD>(acc, ps + g * LD + c * KC, tiles.next() + 4 * l);
  }
  cp_wait<0>();
  __syncthreads();  // every row's sum and max are in

  float* ob = o + (size_t)b * sq * q_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + g + NG * i;
    if (r >= sq) continue;
    const float lsum = ls[g + NG * i], denom = fmaxf(lsum, 1e-30f);
    *reinterpret_cast<float4*>(ob + (size_t)r * q_stride + 4 * l) =
        make_float4(acc[i][0] / denom, acc[i][1] / denom, acc[i][2] / denom, acc[i][3] / denom);
    if (lse != nullptr && l == 0) lse[(size_t)bh * sq + r] = ms[g + NG * i] + logf(lsum);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
           int sk, int h, int kh, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = Plan<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + Plan<D>::BQ - 1) / Plan<D>::BQ);
  flash_fwd_f32<D><<<grid, Lanes<D>::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, h, kh, sq, sk, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace simt

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

using f32::attributes;

template <int D>
int info(int dtype, int* out) {
  if (dtype == 1) {
    out[0] = wg::BQ, out[1] = wg::BK, out[2] = wg::NT;
    return attributes(wg::flash_fwd_wgmma<D>, wg::Plan<D>::SMEM, out + 3);
  }
  out[0] = simt::Plan<D>::BQ, out[1] = simt::Plan<D>::BK, out[2] = f32::Lanes<D>::NT;
  return attributes(simt::flash_fwd_f32<D>, simt::Plan<D>::SMEM, out + 3);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no window.  Sq > Sk only
// with neither mask.  lse, where not null, gets each query row's natural
// log-sum-exp of its scaled scores over its live keys, (B, H, Sq) f32, for
// the backward; null writes nothing.  o is the same either way.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, float* lse,
                               int dtype, int b, int sq, int sk, int h, int kh, int d,
                               int causal, int window, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || (sk < sq && (causal || window > 0)) || h <= 0 ||
      kh <= 0 || h % kh != 0 || (d != 64 && d != 128) || (sq + f32::ROWS - 1) / f32::ROWS > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = d == 64;
  switch (dtype) {
    case 0:
      return d64 ? simt::launch<64>(q, k, v, o, lse, b, sq, sk, h, kh, causal, window, scale, st)
                 : simt::launch<128>(q, k, v, o, lse, b, sq, sk, h, kh, causal, window, scale,
                                     st);
    case 1:
      return d64 ? wg::launch<64>(q, k, v, o, lse, b, sq, sk, h, kh, causal, window, scale, st)
                 : wg::launch<128>(q, k, v, o, lse, b, sq, sk, h, kh, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// the forward's tiles (queries a block, keys a tile, threads a block) into
// out[0..2], then its kernel's registers, static and dynamic shared memory
// and local bytes into out[3..6], for a dtype and head dim
extern "C" int flash_attention_info(int dtype, int d, int* out) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128)) return cudaErrorInvalidValue;
  return d == 64 ? info<64>(dtype, out) : info<128>(dtype, out);
}
