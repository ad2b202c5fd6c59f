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
          T* __restrict__ o, int n_heads, int n_kv_heads, int sq, int sk, int causal,
          int window, float scale) {
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
  }
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
           int h, int kh, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + BQ - 1) / BQ);
  flash_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), h, kh, sq, sk, causal, window, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16 ----
namespace wg {

constexpr int BQ = 128;                  // query rows a block: 2 warpgroups of 64
constexpr int BK = 128;                  // keys a tile
constexpr int NT = 256;
constexpr int SLAB = 64;                 // columns of one 128-byte swizzle slab
constexpr int ROW_BYTES = SLAB * 2;      // 128
constexpr int Q_SLAB = BQ * ROW_BYTES;   // 16 KB
constexpr int KV_SLAB = BK * ROW_BYTES;  // 16 KB
constexpr float LOG2E = 1.4426950408889634f;

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

#define ACC8(d, i)                                                                        \
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
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
        ACC8(d, 48), ACC8(d, 56)
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
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragments (per warpgroup, thread t = 32 * warp + lane): accumulator entry
// 4*j + 2*i + c holds row 16*warp + lane/4 + 8*i, column 8*j + 2*(lane%4) + c.
// The 16 columns 16*kk.. of that fragment, as bf16 pairs in the order of
// entries 8*kk .. 8*kk+7, are the A fragment of k-step kk.
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                int n_heads, int n_kv_heads, int sq, int sk, int causal, int window,
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
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns of 2 bytes
      wgmma_ss_n128(s, desc(q_rows + (kk / 4) * Q_SLAB + off, 16),
                    desc(k_tile + (kk / 4) * KV_SLAB + off, 16), kk > 0);
    }
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
        wgmma_rs_n64(acc[c], p[kk], desc(v_tile + c * KV_SLAB + kk * 16 * ROW_BYTES, KV_SLAB));
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
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime's entry-point
// query, so the library links no -lcuda
EncodeTiled encode_tiled() {
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h,
           int kh, int causal, int window, float scale, cudaStream_t stream) {
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
  flash_fwd_wgmma<D><<<grid, NT, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), h,
                                                 kh, sq, sk, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no window.  Sq > Sk only
// with neither mask.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int b, int sq, int sk, int h, int kh, int d,
                               int causal, int window, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || (sk < sq && (causal || window > 0)) || h <= 0 ||
      kh <= 0 || h % kh != 0 || (d != 64 && d != 128) || (sq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = d == 64;
  switch (dtype) {
    case 0:
      return d64 ? launch<float, 64>(q, k, v, o, b, sq, sk, h, kh, causal, window, scale, st)
                 : launch<float, 128>(q, k, v, o, b, sq, sk, h, kh, causal, window, scale, st);
    case 1:
      return d64 ? wg::launch<64>(q, k, v, o, b, sq, sk, h, kh, causal, window, scale, st)
                 : wg::launch<128>(q, k, v, o, b, sq, sk, h, kh, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
