// rwkv6_scan for sm_90a: the RWKV-6 (Finch) WKV recurrence with its final
// state, from a given initial state.
//
// Replaces the TPU kernel rwkv6_scan (repro/kernels/rwkv6_scan.py:56,
// pallas_call at :69).  Per (batch, head), with state S (D x D, k-dim x v-dim):
//     out_t = r_t . (S + u (.) k_t v_t^T)        S <- diag(w_t) S + k_t v_t^T
// Shapes, in the JAX package's layout, all float32: r, k, v, w (B, S, H, D),
// u (H, D), state0 (B, H, D, D) -> out (B, S, H, D), state1 (B, H, D, D);
// D is 64, the head dim of rwkv6-1.6b, S >= 1 (the TPU kernel asserts whole
// chunks and starts from zero; a zero state0 reproduces it).
//
// Bound on an H100 at the rwkv6-1.6b prefill (B 4, S 1000, H 32): the bytes
// of r, k, v, w and out plus both states, 0.050 ms at 3.35 TB/s; 5 f32
// operations a state entry and step at 67 TFLOP/s take 0.040 ms.  The
// recurrence is a chain of S dependent steps, but column j of out and of S
// needs only column j of S, v_t[j] and the r, k, w and u every column
// shares, so a head's 4096 entries split over threads with no communication
// but the sum over i.
//
// Design, led by what shared memory hands each thread a step.  A thread
// that holds entries of row i needs r_i, k_i and w_i in registers every
// step; an SM's shared memory delivers 128 bytes a clock, and an LDS.128
// that a warp reads at a few addresses takes some four clocks of it.  So the
// columns a thread holds, which each row's three values serve, set the
// traffic; the warps an SM holds and the shuffles trade against them.
// - Bonus out of the loop.  out_j = sum_i r_i S_ij + v_j a_t with
//   a_t = sum_i r_i (u_i k_i), one scalar a step: an entry-step is 3 FP
//   instructions (acc += r_i S_ij, k_i v_j, S_ij = w_i S_ij + k_i v_j), not
//   4.  a_t of a stage's steps is computed once per block after the stage
//   lands: 16 threads a step, 4 rows each (a product, then 3 fmas in
//   ascending row), their partials added by xor shuffles 1, 2, 4, 8.
// - Lanes and columns.  LANES = 4 lanes share COLS = 2 columns: thread
//   (g, q) holds columns 2g, 2g + 1 of rows 4 (m LANES + q) + e, m < 4,
//   e < 4, 32 entries, so a block of 128 threads holds one head and an SM
//   at the prefill holds 4 warps, one a scheduler.  r, k and w of a row
//   block are an LDS.128 each, a broadcast to the warp's 8 column pairs,
//   each value serving 2 entries; the 4 lanes read 64 contiguous bytes, on
//   distinct banks.  One column a thread doubles the reads a step for 8
//   warps an SM; more lanes a column halve them again for more shuffles.
// - Groups.  The lanes' sums of GROUP = 4 steps are added after the group's
//   last step, 8 sums a lane: xor 1 halves them (the lane with bit 1 keeps
//   the upper half), xor 2 again, 6 shuffles for 4 steps, and their latency
//   overlaps.  Each lane's partial runs over its rows in the order above;
//   the partials are added pairwise (lanes 0 + 1 and 2 + 3, then the two),
//   and out_j = fma(v_j, a_t, sum).  The sums are in another order than the
//   reference's: f32, within 1e-4 of max.  Each lane stores its 2 sums.
// - Loads.  r, k, v and w of T = 16 steps a stage arrive by 16-byte
//   cp.async in a ring of NS = 3 stages, chunks k+1 and k+2 in flight while
//   chunk k computes, with one cp.async.wait_group and two __syncthreads a
//   chunk (the second publishes a_t).  A tail chunk loads only its steps
//   and runs them one at a time; S = 1 is one chunk, no more.  The wrapper
//   refuses r, k, v, w or u off a 16-byte boundary.
// - State.  In registers for the whole sequence; it reaches device memory
//   only as the final state.
// The ring takes 49.3 KB, over the 48 KB of dynamic shared memory a launch
// gets by default; the launcher raises the limit once a device.
#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "kernel_error.cuh"

namespace {

constexpr int D = 64;                   // head dim
constexpr int LANES = 4;                // lanes a column: partners under __shfl_xor 1, 2
constexpr int COLS = 2;                 // columns a thread: g COLS, g COLS + 1
constexpr int R = D / LANES;            // state rows a lane
constexpr int NT = D * LANES / COLS;    // threads a block: one block a (batch, head)
constexpr int T = 16;                   // steps a stage
constexpr int NS = 3;                   // stages in the ring
constexpr int GROUP = 4;                // steps whose sums the lanes add together
constexpr int PARTS = 16;               // threads a step's a_t, 4 rows each

static_assert(R % 4 == 0 && NT % 32 == 0, "whole row blocks and warps");
static_assert(T * PARTS % 32 == 0 && T % 2 == 0, "a_t: whole warps, two steps a warp");
static_assert(T % GROUP == 0, "whole groups a stage");

struct __align__(16) Stage {
  float r[T][D], k[T][D], v[T][D], w[T][D];
  float a[T];  // a_t = sum_i r_i (u_i k_i)
};
constexpr size_t SMEM = NS * sizeof(Stage);

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// steps [t0, t0 + n) of the head into st: rows of r, k, v, w at off + t *
// stride, 16 bytes a copy
__device__ __forceinline__ void load_stage(Stage& st, const float* __restrict__ r,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ w, size_t off,
                                           size_t stride, int n) {
  constexpr int kChunks = T * D / 4;
#pragma unroll
  for (int i = 0; i < (kChunks + NT - 1) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int t = c / (D / 4), e = (c % (D / 4)) * 4;
    if (c < kChunks && t < n) {
      const size_t g = off + t * stride + e;
      cp_async16(&st.r[t][e], r + g);
      cp_async16(&st.k[t][e], k + g);
      cp_async16(&st.v[t][e], v + g);
      cp_async16(&st.w[t][e], w + g);
    }
  }
}

// a_t of steps [0, n) of st: thread p of a step's 16 sums rows 4p .. 4p+3
// (uk: u_i k_i of them is formed here, u4 its u)
__device__ __forceinline__ void bonus(Stage& st, float4 u4, int n) {
  const int p = threadIdx.x % PARTS;
#pragma unroll
  for (int i = 0; i < (T * PARTS + NT - 1) / NT; ++i) {
    const int t = (threadIdx.x + i * NT) / PARTS;  // t and t+1 in a warp's two halves
    if ((t & ~1) < n) {                             // the same in both halves
      const float4 r4 = lds4(&st.r[t][4 * p]), k4 = lds4(&st.k[t][4 * p]);
      float s = r4.x * (u4.x * k4.x);
      s = fmaf(r4.y, u4.y * k4.y, s);
      s = fmaf(r4.z, u4.z * k4.z, s);
      s = fmaf(r4.w, u4.w * k4.w, s);
#pragma unroll
      for (int o = 1; o < PARTS; o *= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (p == 0 && t < n) st.a[t] = s;
    }
  }
}

// steps t .. t+U-1 of st for lane q of column group g, step by step: the
// lane's partials of out from the old state, then the decay.  The U * COLS
// column sums are added over the lanes after the last step, pairwise (xor o
// = 1, 2): while a lane holds more than one sum, each xor halves them, the
// lane with bit o keeping the upper half; then plain sums.  A lane ends
// with N sums from index base (step base / COLS, column base % COLS) and,
// unless a lower lane holds the same ones, stores fma(v_j, a_t, sum) at
// outp + step * stride.
template <int U>
__device__ __forceinline__ void steps(const Stage& st, int t, int g, int q,
                                      float (&s)[R][COLS], float* outp, size_t stride) {
  float acc[U * COLS];
#pragma unroll
  for (int x = 0; x < U; ++x) {
    float vj[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) vj[c] = st.v[t + x][g * COLS + c], acc[x * COLS + c] = 0.f;
#pragma unroll
    for (int m = 0; m < R / 4; ++m) {
      const int i0 = 4 * (m * LANES + q);
      const float4 r4 = lds4(&st.r[t + x][i0]), k4 = lds4(&st.k[t + x][i0]),
                   w4 = lds4(&st.w[t + x][i0]);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w},
                  ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          float& sv = s[4 * m + e][c];
          float& a = acc[x * COLS + c];
          a = fmaf(rr[e], sv, a);
          sv = fmaf(ww[e], sv, kk[e] * vj[c]);
        }
      }
    }
  }
  constexpr int V = U * COLS;                        // sums a lane holds
  constexpr int LV = V < LANES ? ilog2(V) : ilog2(LANES);  // xors that halve them
  constexpr int N = V >> LV;                         // sums a lane ends with
  int base = 0;
#pragma unroll
  for (int l = 0; l < LV; ++l) {
    const int n = V >> (l + 1);
    const bool hi = q & (1 << l);
#pragma unroll
    for (int x = 0; x < n; ++x) {
      const float keep = hi ? acc[x + n] : acc[x], send = hi ? acc[x] : acc[x + n];
      acc[x] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << l);
    }
    base += hi ? n : 0;
  }
#pragma unroll
  for (int o = 1 << LV; o < LANES; o *= 2) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
  if (q < V) {
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const int y = (base + x) / COLS, c = (base + x) % COLS;
      outp[y * stride + c] = fmaf(st.v[t + y][g * COLS + c], st.a[t + y], acc[x]);
    }
  }
}

__global__ void __launch_bounds__(NT)
wkv6(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
     const float* __restrict__ w, const float* __restrict__ u,
     const float* __restrict__ state0, float* __restrict__ out, float* __restrict__ state1,
     int seq, int n_heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* ring = reinterpret_cast<Stage*>(smem);
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int q = threadIdx.x % LANES;   // this lane's rows: 4 (m LANES + q) + e
  const int g = threadIdx.x / LANES;   // column group: columns g COLS .. + COLS - 1
  const size_t stride = (size_t)n_heads * D;
  const size_t off = (size_t)b * seq * stride + (size_t)h * D;  // (b, t = 0, h, 0)
  const int nk = (seq + T - 1) / T;

  // chunks 0 .. NS-2 in flight before the state is read
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nk)
      load_stage(ring[c], r, k, v, w, off + (size_t)c * T * stride, stride, min(T, seq - c * T));
    cp_async_commit();
  }

  float s[R][COLS];
  const float* s0 = state0 + (size_t)bh * D * D + g * COLS;
#pragma unroll
  for (int m = 0; m < R / 4; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (m * LANES + q) + e;
#pragma unroll
      for (int c = 0; c < COLS; ++c) s[4 * m + e][c] = s0[i * D + c];
    }
  }
  const float4 u4 = *reinterpret_cast<const float4*>(u + h * D + 4 * (threadIdx.x % PARTS));

  float* outp = out + off + g * COLS;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<NS - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();          // everyone's copies; chunk c-1's stage is free
    const int n = min(T, seq - c * T);
    if (c + NS - 1 < nk)
      load_stage(ring[(c + NS - 1) % NS], r, k, v, w, off + (size_t)(c + NS - 1) * T * stride,
                 stride, min(T, seq - (c + NS - 1) * T));
    cp_async_commit();
    Stage& st = ring[c % NS];
    bonus(st, u4, n);
    __syncthreads();          // a_t of the stage's steps
    if (n == T) {
#pragma unroll 1
      for (int t = 0; t < T; t += GROUP, outp += GROUP * stride)
        steps<GROUP>(st, t, g, q, s, outp, stride);
    } else {
#pragma unroll 1
      for (int t = 0; t < n; ++t, outp += stride) steps<1>(st, t, g, q, s, outp, stride);
    }
  }

  float* s1 = state1 + (size_t)bh * D * D + g * COLS;
#pragma unroll
  for (int m = 0; m < R / 4; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (m * LANES + q) + e;
#pragma unroll
      for (int c = 0; c < COLS; ++c) s1[i * D + c] = s[4 * m + e][c];
    }
  }
}

// raise wkv6's dynamic shared-memory limit to SMEM, once for each device
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  return once_per_device(done, [] { return allow_dynamic_smem(wkv6, SMEM); });
}

}  // namespace

extern "C" int rwkv6_scan(const float* r, const float* k, const float* v, const float* w,
                          const float* u, const float* state0, float* out, float* state1,
                          int b, int s, int h, int d, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || d != D) return cudaErrorInvalidValue;
  if (!(aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) && aligned16(u)))
    return cudaErrorMisalignedAddress;  // the wrapper refuses these first
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return e;
  wkv6<<<b * h, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(r, k, v, w, u, state0, out,
                                                              state1, s, h);
  return cudaGetLastError();
}
