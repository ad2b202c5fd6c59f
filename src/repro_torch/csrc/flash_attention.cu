// flash_attention for sm_90a: online-softmax attention with causal and/or
// sliding-window masking and grouped-query heads (GQA).
//
// Replaces the TPU kernel flash_attention
// (repro/kernels/flash_attention.py:86, pallas_call at :106).  Shapes, in the
// JAX package's layout: q (B, Sq, H, D), k and v (B, Sk, K, D) with H % K == 0
// and Sq <= Sk, o (B, Sq, H, D) in q's dtype (float32 or bfloat16); D is
// 128, the head dim of every dense configuration.  Queries sit at the LAST Sq key positions
// (flash_attention.py:44): query row r has position r + Sk - Sq.  Any Sq and
// Sk: the ragged edge is masked, where the TPU kernel asserts whole tiles.
//
// Bound on an H100: the bytes of q, k, v and o once at 3.35 TB/s against
// 4*B*H*D*(live query-key pairs) operations, at 989 TFLOP/s for bf16 inputs
// (tensor cores) or 67 TFLOP/s for f32 inputs.  This first version computes
// in f32 FMA on the CUDA cores, as the TPU kernel computes in f32 (:66-79),
// so for bf16 it sits far above the bound: wgmma and TMA come later.
//
// Design: one block per (batch * head, 64-query tile), 256 threads.  The
// TPU kernel's sequential kv grid axis, whose m / l / acc scratch carries
// across steps (:36-39), becomes a loop over 64-key tiles inside the block,
// with the running max and sum in registers and an f32 accumulator of
// 4 rows x D/16 columns per thread.  q (pre-scaled by 1/sqrt(D), as :66),
// k and v tiles sit in shared memory as f32; the softmax weights of a tile
// never leave registers: the P.V product takes each weight from the thread
// that computed it by a warp shuffle.  Key tiles that no query of the tile
// can see are never visited (the loop bounds follow the causal and window
// limits, :54-60); inside a visited tile masked entries get -1e30 and, after
// exp, exactly 0 (:74), so a row whose first live tile is all masked for it
// adds nothing.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernel_error.cuh"

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;            // the TPU kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no window.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int b, int sq, int sk, int h, int kh, int d,
                               int causal, int window, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk < sq || h <= 0 || kh <= 0 || h % kh != 0 || d != 128 ||
      (sq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, 128>(q, k, v, o, b, sq, sk, h, kh, causal, window, scale, st);
    case 1:
      return launch<__nv_bfloat16, 128>(q, k, v, o, b, sq, sk, h, kh, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
