// rwkv6_scan for sm_90a: the RWKV-6 (Finch) WKV recurrence with its final
// state, from a given initial state.
//
// Replaces the TPU kernel rwkv6_scan (repro/kernels/rwkv6_scan.py:56,
// pallas_call at :69).  Per (batch, head), with state S (D x D, k-dim x v-dim):
//     out_t = r_t . (S + u (.) k_t v_t^T)        S <- diag(w_t) S + k_t v_t^T
// Shapes, in the JAX package's layout, all float32: r, k, v, w (B, S, H, D),
// u (H, D), state0 (B, H, D, D) -> out (B, S, H, D), state1 (B, H, D, D);
// D is 64, the head dim of rwkv6-1.6b, S >= 1 (the TPU kernel asserts whole chunks and starts
// from zero; a zero state0 reproduces it).
//
// Bound on an H100: the bytes of r, k, v, w and out (f32) plus both states at
// 3.35 TB/s; the 4*D*D operations a step are few.  But the recurrence is a
// chain of S dependent steps, so a run of S steps also takes S times one
// step's latency, whatever the bytes.
//
// Design: one block per (batch, head), D threads; the TPU kernel's chunk
// axis, whose state scratch carries across chunks (:33-48), becomes a loop
// over all S steps inside the block.  Thread j keeps column j of the state in
// registers for the whole sequence: the state never reaches device memory
// until the final state is written.  r, k, w and v of CH steps are staged in
// shared memory at once, so a step costs no barrier.  Each step keeps the
// reference's order (rwkv6_scan_ref): the output from the old state plus
// u k v, then the decay; the sum over k runs in ascending order, so runs are
// bit-reproducible.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "kernel_error.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(D)
wkv6(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
     const float* __restrict__ w, const float* __restrict__ u,
     const float* __restrict__ state0, float* __restrict__ out, float* __restrict__ state1,
     int seq, int n_heads) {
  constexpr int CH = 2048 / D;  // steps staged at once: 32 KB of shared memory
  __shared__ float rs[CH][D], ks[CH][D], vs[CH][D], ws[CH][D], us[D];
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int j = threadIdx.x;
  const size_t stride = (size_t)n_heads * D;
  const size_t base = (size_t)b * seq * stride + (size_t)h * D + j;

  float st[D];
  const float* s0 = state0 + (size_t)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = s0[i * D + j];
  us[j] = u[h * D + j];

  for (int t0 = 0; t0 < seq; t0 += CH) {
    const int n = min(CH, seq - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int t = 0; t < n; ++t) {
      const size_t off = base + (size_t)(t0 + t) * stride;
      rs[t][j] = r[off];
      ks[t][j] = k[off];
      vs[t][j] = v[off];
      ws[t][j] = w[off];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float kv = ks[t][i] * vj;
        acc = fmaf(rs[t][i], st[i] + us[i] * kv, acc);
        st[i] = fmaf(ws[t][i], st[i], kv);
      }
      out[base + (size_t)(t0 + t) * stride] = acc;
    }
  }

  float* s1 = state1 + (size_t)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) s1[i * D + j] = st[i];
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, float* out, float* s1, int b, int s, int h, cudaStream_t stream) {
  wkv6<D><<<b * h, D, 0, stream>>>(r, k, v, w, u, s0, out, s1, s, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_scan(const float* r, const float* k, const float* v, const float* w,
                          const float* u, const float* state0, float* out, float* state1,
                          int b, int s, int h, int d, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || d != 64) return cudaErrorInvalidValue;
  return launch<64>(r, k, v, w, u, state0, out, state1, b, s, h,
                    static_cast<cudaStream_t>(stream));
}
