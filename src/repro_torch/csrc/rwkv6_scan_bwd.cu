// rwkv6_scan_bwd for sm_90a: the gradient of the WKV-6 recurrence
// (csrc/rwkv6_scan.cu) with respect to r, k, v, w, u and the start state.
//
// No TPU kernel has a backward: the JAX package differentiates its chunked
// lax.scan (repro/models/rwkv.py:89-120).  The port puts its forward kernel
// in the model (models/rwkv.py), so a training step on the card needs a
// backward kernel too; this is it.  Shapes as the forward's: r, k, v, w, dout
// (B, S, H, D) f32 with D = 64; u (H, D); state0 and dstate (B, H, D, D).
//
// With S_t the state after step t (S_0 the given one) and G_t the gradient of
// the loss with respect to it, from G_S = dstate backwards:
//   dr_t = (S_{t-1} + u k_t v_t^T) dout_t
//   dk_t = r_t u (v_t . dout_t) + G_t v_t
//   dv_t = (r_t . (u k_t)) dout_t + G_t^T k_t
//   dw_t = rowsum(G_t * S_{t-1})
//   du  += r_t k_t (v_t . dout_t)
//   G_{t-1} = diag(w_t) G_t + r_t dout_t^T,   dstate0 = G_0.
// Column j of S and of G depends only on column j of v and dout, so a block
// holds CW = 16 of a head's 64 columns: one block per (batch, head, column
// group), one thread a state row with its 16 entries of S and of G in
// registers.  The sums over columns (dr, dk, dw, du) are each block's
// partial, written to scratch and summed in a fixed order by a second kernel
// (deterministic, no float atomics); dv's sum over rows is a reduce-scatter
// over each warp's lanes (16 shuffles a step) and the two warps' partials
// added once a chunk.
//
// S_{t-1} is needed in reverse order.  A first pass runs the recurrence
// forwards and keeps the state at the start of every L = 16-step chunk
// (scratch: B H ceil(S / 16) D D floats, 134 MB at B 1, S 4096, H 32); the
// backward pass then takes the chunks last to first, recomputes each chunk's
// states from its start into shared memory (each thread its own entries, so
// no barrier) and walks the chunk backwards.  r, k, w (64 rows) and v, dout
// (the block's 16 columns) of each chunk arrive by cp.async in a two-stage
// ring that overlaps the steps.
//
// Bound on an H100: the bytes of r, k, v, w, dout read and dr, dk, dv, dw
// written (f32) plus u and the three states, at 3.35 TB/s, against 14 f32
// operations a state entry and step (the state recomputed: k v, w S and the
// sum; dr, dk, dv and dw: a product and a sum each; G: w G, r dout and the
// sum) at 67 TFLOP/s; the operations are the larger.  The kernel walks the
// steps one after another, two passes of S steps, so at B H = 32 it is held by
// the steps' latency, far from either.
#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "kernel_error.cuh"

namespace {

constexpr int D = 64;          // head dim: rows (and columns) of the state
constexpr int CW = 16;         // state columns a block holds
constexpr int NCG = D / CW;    // column groups: blocks a (batch, head)
constexpr int L = 16;          // steps a chunk
constexpr int NT = D;          // one thread a state row
constexpr int NW = NT / 32;    // warps a block
constexpr unsigned FULL = 0xffffffffu;

struct __align__(16) Stage {
  float r[L][D], k[L][D], w[L][D];
  float v[L][CW], g[L][CW];  // v and dout in the block's columns
};

struct __align__(16) Smem {
  Stage st[2];
  float hist[L][CW][NT];  // S_{t-1} of each step of the chunk, [step][column][row]
  float dvp[L][NW][CW];   // each warp's partial of dv
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// steps [t0, t0 + n) of the head into st, 16 bytes a copy: k, w and v, and
// with ``full`` also r and dout.  ``off`` is step t0's row of the head.
__device__ __forceinline__ void load_stage(Stage& st, const float* __restrict__ r,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ w,
                                           const float* __restrict__ dout, size_t off,
                                           size_t stride, int j0, int n, bool full) {
  for (int c = threadIdx.x; c < L * D / 4; c += NT) {
    const int t = c / (D / 4), e = (c % (D / 4)) * 4;
    if (t < n) {
      const size_t g = off + t * stride + e;
      cp_async16(&st.k[t][e], k + g);
      cp_async16(&st.w[t][e], w + g);
      if (full) cp_async16(&st.r[t][e], r + g);
    }
  }
  for (int c = threadIdx.x; c < L * CW / 4; c += NT) {
    const int t = c / (CW / 4), e = (c % (CW / 4)) * 4;
    if (t < n) {
      const size_t g = off + t * stride + j0 + e;
      cp_async16(&st.v[t][e], v + g);
      if (full) cp_async16(&st.g[t][e], dout + g);
    }
  }
}

// one halving of reduce_scatter: lanes whose bit DIST is set keep the upper
// HALF of their values, the others the lower, each adding its partner's
template <int HALF, int DIST>
__device__ __forceinline__ void halve(float (&x)[CW], int lane) {
  const bool hi = lane & DIST;
#pragma unroll
  for (int m = 0; m < HALF; ++m) {
    const float send = hi ? x[m] : x[m + HALF];
    const float keep = hi ? x[m + HALF] : x[m];
    x[m] = keep + __shfl_xor_sync(FULL, send, DIST);
  }
}

// the 16 values x, summed over the warp's 32 lanes: lane l returns the sum of
// x[l >> 1] (halving the values at the xor distances 16, 8, 4 and 2, then the
// pair's two lanes added)
__device__ __forceinline__ float reduce_scatter(float (&x)[CW], int lane) {
  static_assert(CW == 16, "four halvings take 16 values to one");
  halve<8, 16>(x, lane);
  halve<4, 8>(x, lane);
  halve<2, 4>(x, lane);
  halve<1, 2>(x, lane);
  return x[0] + __shfl_xor_sync(FULL, x[0], 1);
}

__device__ __forceinline__ void load_row(float (&x)[CW], const float* p) {
#pragma unroll
  for (int c = 0; c < CW; c += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + c);
    x[c] = f.x, x[c + 1] = f.y, x[c + 2] = f.z, x[c + 3] = f.w;
  }
}

__device__ __forceinline__ void store_row(float* p, const float (&x)[CW]) {
#pragma unroll
  for (int c = 0; c < CW; c += 4)
    *reinterpret_cast<float4*>(p + c) = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
}

// part: the (3, NCG, B, S, H, D) partials of dr, dk and dw; du_part (NCG, B, H, D);
// ckpt (B, H, ceil(S / L), D, D)
__global__ void __launch_bounds__(NT)
wkv6_bwd(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ w, const float* __restrict__ u,
         const float* __restrict__ state0, const float* __restrict__ dout,
         const float* __restrict__ dstate, float* __restrict__ part,
         float* __restrict__ du_part, float* __restrict__ dv, float* __restrict__ dstate0,
         float* __restrict__ ckpt, int s, int n_heads, size_t n) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int cg = blockIdx.x % NCG, bh = blockIdx.x / NCG;
  const int b = bh / n_heads, h = bh % n_heads;
  const int i = threadIdx.x, lane = i % 32, warp = i / 32;
  const int j0 = cg * CW;
  const size_t stride = (size_t)n_heads * D;
  const size_t base = ((size_t)b * s * n_heads + h) * D;  // step 0, row 0 of the head
  const int nc = (s + L - 1) / L;
  float* ck = ckpt + (size_t)bh * nc * D * D;
  const size_t row = ((size_t)bh * D + i) * D + j0;  // row i, column j0 of a (D, D) state

  // pass 1: the recurrence forwards, the state kept at each chunk's start
  float S[CW];
  load_row(S, state0 + row);
  load_stage(sm.st[0], r, k, v, w, dout, base, stride, j0, min(L, s), false);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc)
      load_stage(sm.st[(c + 1) & 1], r, k, v, w, dout, base + (size_t)(c + 1) * L * stride,
                 stride, j0, min(L, s - (c + 1) * L), false);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // chunk c has landed, every thread's copies
    store_row(ck + ((size_t)c * D + i) * D + j0, S);
    const Stage& st = sm.st[c & 1];
    const int len = min(L, s - c * L);
    for (int t = 0; t < len; ++t) {
      const float kk = st.k[t][i], ww = st.w[t][i];
#pragma unroll
      for (int c4 = 0; c4 < CW; c4 += 4) {
        const float4 v4 = lds4(&st.v[t][c4]);
        S[c4] = fmaf(ww, S[c4], kk * v4.x);
        S[c4 + 1] = fmaf(ww, S[c4 + 1], kk * v4.y);
        S[c4 + 2] = fmaf(ww, S[c4 + 2], kk * v4.z);
        S[c4 + 3] = fmaf(ww, S[c4 + 3], kk * v4.w);
      }
    }
    __syncthreads();  // every thread is done with the stage before it refills
  }

  // pass 2: the chunks last to first
  float G[CW];
  load_row(G, dstate + row);
  const float ui = u[h * D + i];
  float du = 0.f;
  float* dr_p = part + (size_t)cg * n;
  float* dk_p = part + (size_t)(NCG + cg) * n;
  float* dw_p = part + (size_t)(2 * NCG + cg) * n;
  load_stage(sm.st[(nc - 1) & 1], r, k, v, w, dout, base + (size_t)(nc - 1) * L * stride, stride,
             j0, s - (nc - 1) * L, true);
  cp_async_commit();
  for (int c = nc - 1; c >= 0; --c) {
    if (c > 0)
      load_stage(sm.st[(c - 1) & 1], r, k, v, w, dout, base + (size_t)(c - 1) * L * stride,
                 stride, j0, L, true);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // chunk c has landed
    const Stage& st = sm.st[c & 1];
    const int len = min(L, s - c * L);
    load_row(S, ck + ((size_t)c * D + i) * D + j0);
    for (int t = 0; t < len; ++t) {
      const float kk = st.k[t][i], ww = st.w[t][i];
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) {
        sm.hist[t][jj][i] = S[jj];
        S[jj] = fmaf(ww, S[jj], kk * st.v[t][jj]);
      }
    }
    for (int t = len - 1; t >= 0; --t) {
      const float rr = st.r[t][i], kk = st.k[t][i], ww = st.w[t][i];
      float vv[CW], gg[CW];
#pragma unroll
      for (int c4 = 0; c4 < CW; c4 += 4) {
        const float4 v4 = lds4(&st.v[t][c4]), g4 = lds4(&st.g[t][c4]);
        vv[c4] = v4.x, vv[c4 + 1] = v4.y, vv[c4 + 2] = v4.z, vv[c4 + 3] = v4.w;
        gg[c4] = g4.x, gg[c4 + 1] = g4.y, gg[c4 + 2] = g4.z, gg[c4 + 3] = g4.w;
      }
      float vd = 0.f;  // v_t . dout_t over the block's columns
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) vd = fmaf(vv[jj], gg[jj], vd);
      const float ruk = rr * ui * kk;
      float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f, dvp[CW];
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) {
        const float sp = sm.hist[t][jj][i];
        a_dr = fmaf(sp, gg[jj], a_dr);
        a_dk = fmaf(G[jj], vv[jj], a_dk);
        a_dw = fmaf(G[jj], sp, a_dw);
        dvp[jj] = fmaf(G[jj], kk, ruk * gg[jj]);
        G[jj] = fmaf(ww, G[jj], rr * gg[jj]);
      }
      const size_t at = base + (size_t)(c * L + t) * stride + i;
      dr_p[at] = fmaf(ui * kk, vd, a_dr);
      dk_p[at] = fmaf(rr * ui, vd, a_dk);
      dw_p[at] = a_dw;
      du = fmaf(rr * kk, vd, du);
      const float col_sum = reduce_scatter(dvp, lane);
      if ((lane & 1) == 0) sm.dvp[t][warp][lane >> 1] = col_sum;
    }
    __syncthreads();  // the chunk's dv partials are in
    for (int idx = i; idx < len * CW; idx += NT) {
      const int t = idx / CW, jj = idx % CW;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < NW; ++wp) acc += sm.dvp[t][wp][jj];
      dv[base + (size_t)(c * L + t) * stride + j0 + jj] = acc;
    }
    __syncthreads();  // every thread is done with the stage and dvp
  }
  store_row(dstate0 + row, G);
  du_part[((size_t)cg * gridDim.x / NCG + bh) * D + i] = du;
}

// dr, dk, dw: the NCG column groups' partials summed in order; du: the
// partials of every column group and batch row summed in order
__global__ void wkv6_bwd_reduce(const float* __restrict__ part,
                                const float* __restrict__ du_part, float* __restrict__ dr,
                                float* __restrict__ dk, float* __restrict__ dw,
                                float* __restrict__ du, size_t n, int n_b, int hd) {
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f, bk = 0.f, c = 0.f;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg) {
      a += part[(size_t)cg * n + idx];
      bk += part[(size_t)(NCG + cg) * n + idx];
      c += part[(size_t)(2 * NCG + cg) * n + idx];
    }
    dr[idx] = a, dk[idx] = bk, dw[idx] = c;
    if (idx < (size_t)hd) {
      float acc = 0.f;
      for (int cg = 0; cg < NCG; ++cg)
        for (int bb = 0; bb < n_b; ++bb) acc += du_part[((size_t)cg * n_b + bb) * hd + idx];
      du[idx] = acc;
    }
  }
}

constexpr size_t SMEM = sizeof(Smem);

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// floats of scratch rwkv6_scan_bwd takes at (b, s, h): the chunk states, the
// partials of dr, dk and dw, and those of du
extern "C" long long rwkv6_scan_bwd_workspace(int b, int s, int h) {
  const long long nc = (s + L - 1) / L, n = (long long)b * s * h * D;
  return (long long)b * h * nc * D * D + 3LL * NCG * n + (long long)NCG * b * h * D;
}

// dr, dk, dv, dw (B, S, H, D), du (H, D) and dstate0 (B, H, D, D) from the
// forward's inputs and the gradients of its two outputs; ``work`` holds
// rwkv6_scan_bwd_workspace(b, s, h) floats
extern "C" int rwkv6_scan_bwd(const float* r, const float* k, const float* v, const float* w,
                              const float* u, const float* state0, const float* dout,
                              const float* dstate, float* dr, float* dk, float* dv, float* dw,
                              float* du, float* dstate0, float* work, int b, int s, int h, int d,
                              void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || d != D) return cudaErrorInvalidValue;
  if (!(aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) && aligned16(dout) &&
        aligned16(state0) && aligned16(dstate) && aligned16(dstate0) && aligned16(work)))
    return cudaErrorMisalignedAddress;  // the wrapper refuses these first
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nc = (s + L - 1) / L;
  const size_t n = (size_t)b * s * h * D;
  float* ckpt = work;
  float* part = ckpt + (size_t)b * h * nc * D * D;
  float* du_part = part + 3 * NCG * n;
  wkv6_bwd<<<b * h * NCG, NT, SMEM, st>>>(r, k, v, w, u, state0, dout, dstate, part, du_part, dv,
                                          dstate0, ckpt, s, h, n);
  if ((e = cudaGetLastError())) return e;
  const int threads = 256;
  const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 132 * 16);
  wkv6_bwd_reduce<<<blocks, threads, 0, st>>>(part, du_part, dr, dk, dw, du, n, b, h * D);
  return cudaGetLastError();
}
