// mamba_scan for sm_90a: the Mamba (S6) selective scan with its final state,
// from a given initial state.
//
// Replaces the TPU kernel mamba_scan (repro/kernels/mamba_scan.py:55,
// pallas_call at :73).  Per (batch, channel d), with a state row h (DS floats):
//     h_t = exp(dt_t * A[d]) (.) h_{t-1} + (dt_t * x_t) B_t      y_t = h_t . C_t
// Shapes, in the JAX package's layout, all float32: dt, x (B, S, DI),
// B, C (B, S, DS), A (DI, DS) negative, state0 (B, DI, DS) -> y (B, S, DI),
// state1 (B, DI, DS).  DS is 16, jamba's d_state; any DI >= 1 and S >= 1
// (the TPU kernel asserts whole blocks and chunks and starts from zero; a
// zero state0 reproduces it).
//
// Bound on an H100 at jamba's prefill (B 4, S 2000, DI 8192), two floors side
// by side.  The special-function units compute the B*S*DI*DS = 1.05e9
// exponentials at 16 a clock on each of the 132 SMs: 0.251 ms at 1.98 GHz.
// The bytes of dt, x and y (f32, 3*B*S*DI*4) plus B, C, A and both states
// take 0.236 ms at 3.35 TB/s.  The recurrence is a chain of S dependent
// steps, but a step's chain is one FMA deep per state entry, and the DS
// entries of a channel are independent.
//
// Design, led by the instructions a state entry costs a step:
// - Exponentials.  A is scaled by log2(e) once, in registers, and
//   dA = ex2.approx.ftz(dt * A') is one MUFU.EX2 after one FMUL, where expf
//   is some eight instructions.  With dx*B_t and the two FMAs (h, and y's
//   sum) an entry-step is 5 instructions, under the 8 issue slots' time the
//   MUFU takes for a warp's 32 exponentials; with the per-step loads,
//   shuffle and store both pipes run near full.  The exponentials do not
//   depend on h: the step loop is unrolled 8 deep so that they are issued
//   ahead of the chain.  ex2.approx is within 2 ulp of 2^x; rounding the pre-scaled
//   argument moves dA = e^-|dt*A| by about |dt*A| * 6e-8 of itself.
// - Lanes.  LANES = 2 lanes share a channel, 8 state entries each, so a
//   block of 128 threads holds 64 channels and an SM at jamba's prefill
//   holds 16 warps (8 with one thread a channel).  y_t is each lane's
//   partial sum over its 8 entries (a product, then 7 FMAs in ascending
//   entry), the two partials added by one __shfl_xor_sync.  B_t and C_t are
//   read from shared memory 16 bytes at a time, a broadcast to the warp.
// - Loads.  dt and x of 64 channels and B_t and C_t, T = 16 steps a stage,
//   arrive by cp.async in a ring of NS = 3 stages (30 KB a block, so four
//   blocks fit an SM): chunks k+1 and k+2 are in flight while chunk k
//   computes, with one cp.async.wait_group and one __syncthreads a chunk.
//   A tail chunk loads only its steps; S = 1 is one chunk, no more.  16-byte
//   copies where DI is a multiple of 4 and the rows start on 16-byte
//   boundaries, 4-byte copies else; channels past DI are zero-filled and
//   never written.  y is written by one lane of each channel, 16 channels
//   (64 contiguous bytes) a warp a step.
// No step is computed twice: the exponentials are the floor, and a scan in
// parallel over time would compute them again.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "kernel_error.cuh"

namespace {

constexpr int DS = 16;             // d_state
constexpr int LANES = 2;           // lanes a channel: partners under __shfl_xor 1
constexpr int E = DS / LANES;      // state entries a lane
constexpr int CPB = 64;            // channels a block
constexpr int TPB = CPB * LANES;   // threads a block
constexpr int T = 16;              // steps a stage
constexpr int NS = 3;              // stages in the ring
constexpr int UNROLL = 8;          // steps issued together
constexpr float LOG2E = 1.4426950408889634f;

static_assert(LANES == 2 && E % 4 == 0, "two lanes a channel, B and C read as float4");

struct Stage {
  float dt[T][CPB];
  float x[T][CPB];
  float b[T][DS];
  float c[T][DS];
};

// steps [t0, t0 + n) into st: dt and x of the block's channels from dtb and
// xb (their (t = 0, d0) elements; live_cols of the CPB columns lie inside
// DI), B and C of the batch row from bb and cb; copies of W floats (4: 16
// bytes, 1: 4 bytes).  Each thread copies column j of dt and x in rows r,
// r + kRows, ...
template <int W>
__device__ __forceinline__ void load_stage(Stage& st, const float* __restrict__ dtb,
                                           const float* __restrict__ xb,
                                           const float* __restrict__ bb,
                                           const float* __restrict__ cb, int t0, int n, int di,
                                           int live_cols) {
  constexpr int kRowThreads = CPB / W;
  constexpr int kRows = TPB / kRowThreads;
  const int j = (threadIdx.x % kRowThreads) * W, r = threadIdx.x / kRowThreads;
  const bool ok = j < live_cols;
#pragma unroll
  for (int i = 0; i < T / kRows; ++i) {
    const int t = r + i * kRows;
    if (t < n) {
      const size_t off = ok ? (size_t)(t0 + t) * di + j : 0;
      cp_async<4 * W>(&st.dt[t][j], dtb + off, ok);
      cp_async<4 * W>(&st.x[t][j], xb + off, ok);
    }
  }
  // B's rows, then C's, W floats a thread
#pragma unroll
  for (int k = threadIdx.x * W; k < 2 * T * DS; k += TPB * W) {
    const int e = k % (T * DS);
    if (e < n * DS) {
      const size_t off = (size_t)t0 * DS + e;
      if (k < T * DS)
        cp_async<4 * W>(&st.b[0][e], bb + off, true);
      else
        cp_async<4 * W>(&st.c[0][e], cb + off, true);
    }
  }
}

// step t of stage st for lane q's entries [q*E, q*E + E) of block channel c:
// h advances, and y_t, the sum of the two lanes' partials, is stored at yp
// where store holds
__device__ __forceinline__ void step(const Stage& st, int t, int c, int q, const float (&a2)[E],
                                     float (&h)[E], float* yp, bool store) {
  const float dtv = st.dt[t][c];
  const float dx = dtv * st.x[t][c];
  float da[E], bv[E], cv[E];
#pragma unroll
  for (int i = 0; i < E; ++i) da[i] = ex2(dtv * a2[i]);
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 b4 = *reinterpret_cast<const float4*>(&st.b[t][q * E + i]);
    const float4 c4 = *reinterpret_cast<const float4*>(&st.c[t][q * E + i]);
    bv[i] = b4.x, bv[i + 1] = b4.y, bv[i + 2] = b4.z, bv[i + 3] = b4.w;
    cv[i] = c4.x, cv[i + 1] = c4.y, cv[i + 2] = c4.z, cv[i + 3] = c4.w;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) h[i] = fmaf(da[i], h[i], dx * bv[i]);
  float acc = h[0] * cv[0];
#pragma unroll
  for (int i = 1; i < E; ++i) acc = fmaf(h[i], cv[i], acc);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (store) *yp = acc;
}

template <int W>
__global__ void __launch_bounds__(TPB, 4)
selective_scan(const float* __restrict__ dt, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ x,
               const float* __restrict__ a, const float* __restrict__ state0,
               float* __restrict__ y, float* __restrict__ state1, int seq, int di) {
  __shared__ __align__(16) Stage ring[NS];
  const int c = threadIdx.x / LANES;           // channel in the block
  const int q = threadIdx.x % LANES;           // this lane's entries: [q*E, q*E + E)
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < di;
  const size_t row0 = (size_t)b * seq * di + d0;  // (b, t = 0, d0) of dt, x, y
  const float* bb = bm + (size_t)b * seq * DS;
  const float* cb = cm + (size_t)b * seq * DS;
  const int nk = (seq + T - 1) / T;

  // chunks 0 .. NS-2 in flight before the state is read
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    if (k < nk)
      load_stage<W>(ring[k], dt + row0, x + row0, bb, cb, k * T, min(T, seq - k * T), di,
                    di - d0);
    cp_async_commit();
  }

  float h[E], a2[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    h[i] = live ? state0[((size_t)b * di + d) * DS + q * E + i] : 0.f;
    a2[i] = live ? a[(size_t)d * DS + q * E + i] * LOG2E : 0.f;
  }

  const bool store = live && q == 0;
  float* yp = y + row0 + c;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<NS - 2>();  // chunk k has landed (this thread's copies)
    __syncthreads();          // everyone's copies; chunk k-1's stage is free
    const int t0 = k * T, n = min(T, seq - t0);
    if (k + NS - 1 < nk)
      load_stage<W>(ring[(k + NS - 1) % NS], dt + row0, x + row0, bb, cb, t0 + (NS - 1) * T,
                    min(T, seq - t0 - (NS - 1) * T), di, di - d0);
    cp_async_commit();
    const Stage& st = ring[k % NS];
    if (n == T) {
#pragma unroll 1
      for (int t = 0; t < T; t += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u, yp += di) step(st, t + u, c, q, a2, h, yp, store);
      }
    } else {
#pragma unroll 1
      for (int t = 0; t < n; ++t, yp += di) step(st, t, c, q, a2, h, yp, store);
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < E; ++i) state1[((size_t)b * di + d) * DS + q * E + i] = h[i];
  }
}

}  // namespace

extern "C" int mamba_scan(const float* dt, const float* bm, const float* cm, const float* x,
                          const float* a, const float* state0, float* y, float* state1,
                          int b, int s, int di, int ds, void* stream) {
  if (b <= 0 || s <= 0 || di <= 0 || ds != DS || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid((di + CPB - 1) / CPB, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (di % 4 == 0 && aligned16(dt) && aligned16(x) && aligned16(bm) && aligned16(cm))
    selective_scan<4><<<grid, TPB, 0, st>>>(dt, bm, cm, x, a, state0, y, state1, s, di);
  else
    selective_scan<1><<<grid, TPB, 0, st>>>(dt, bm, cm, x, a, state0, y, state1, s, di);
  return cudaGetLastError();
}
