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
// Bound on an H100: the bytes of dt, x and y (f32, 3*B*S*DI*4) plus B, C,
// A and both states at 3.35 TB/s, 0.24 ms at jamba's prefill (B 4, S 2000,
// DI 8192).  The B*S*DI*DS exponentials run on the special-function units
// and cost about as much.  The recurrence is a chain of S dependent steps,
// but the DS state entries of a channel are independent, so a step's chain
// is one FMA deep per entry.
//
// Design: one thread per (batch, channel), TPB channels a block, grid
// (ceil(DI / TPB), B).  The TPU kernel's chunk axis, whose state scratch
// carries across chunks, becomes a loop over all S steps inside the thread:
// its DS state floats and its row of A stay in registers for the whole
// sequence, and the discretised dA and dt*x*B never leave them.  B_t and C_t
// are shared by every channel of a batch row: CH steps of them are staged in
// shared memory at once and read as broadcasts.  dt and x of the same CH
// steps are staged beside them, each thread loading its own channel (loads
// coalesced along DI and all in flight together), so the step loop waits on
// no device memory; y is written coalesced along DI.  expf, not __expf: the
// kernel holds its plain version to about 1e-6.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "kernel_error.cuh"

namespace {

constexpr int TPB = 128;  // channels a block
constexpr int CH = 32;    // steps staged at once: 2 * 32 * 128 + 2 * 32 * 16 floats, 36 KB

template <int DS>
__global__ void __launch_bounds__(TPB)
selective_scan(const float* __restrict__ dt, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ x,
               const float* __restrict__ a, const float* __restrict__ state0,
               float* __restrict__ y, float* __restrict__ state1, int seq, int di) {
  __shared__ float dts[CH][TPB], xs[CH][TPB], bs[CH][DS], cs[CH][DS];
  const int j = threadIdx.x;
  const int d = blockIdx.x * TPB + j;
  const int b = blockIdx.y;
  const bool live = d < di;
  const size_t row = (size_t)b * seq * di + d;        // (b, t = 0, d) of dt, x, y
  const float* bb = bm + (size_t)b * seq * DS;
  const float* cb = cm + (size_t)b * seq * DS;

  float h[DS], av[DS];
  if (live) {
    const float* s0 = state0 + ((size_t)b * di + d) * DS;
    const float* ad = a + (size_t)d * DS;
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      h[i] = s0[i];
      av[i] = ad[i];
    }
  }

  for (int t0 = 0; t0 < seq; t0 += CH) {
    const int n = min(CH, seq - t0);
    __syncthreads();  // every thread is done with the previous chunk's B, C
    for (int k = j; k < n * DS; k += TPB) {
      bs[k / DS][k % DS] = bb[(size_t)t0 * DS + k];
      cs[k / DS][k % DS] = cb[(size_t)t0 * DS + k];
    }
    if (live) {
      for (int t = 0; t < n; ++t) {
        const size_t off = row + (size_t)(t0 + t) * di;
        dts[t][j] = dt[off];
        xs[t][j] = x[off];
      }
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < n; ++t) {
        const float dtv = dts[t][j];
        const float dx = dtv * xs[t][j];
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < DS; ++i) {
          h[i] = fmaf(expf(dtv * av[i]), h[i], dx * bs[t][i]);
          acc = fmaf(h[i], cs[t][i], acc);
        }
        y[row + (size_t)(t0 + t) * di] = acc;
      }
    }
  }

  if (live) {
    float* s1 = state1 + ((size_t)b * di + d) * DS;
#pragma unroll
    for (int i = 0; i < DS; ++i) s1[i] = h[i];
  }
}

}  // namespace

extern "C" int mamba_scan(const float* dt, const float* bm, const float* cm, const float* x,
                          const float* a, const float* state0, float* y, float* state1,
                          int b, int s, int di, int ds, void* stream) {
  if (b <= 0 || s <= 0 || di <= 0 || ds != 16 || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid((di + TPB - 1) / TPB, b);
  selective_scan<16><<<grid, TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      dt, bm, cm, x, a, state0, y, state1, s, di);
  return cudaGetLastError();
}
