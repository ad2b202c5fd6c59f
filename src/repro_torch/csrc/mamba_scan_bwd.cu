// mamba_scan_bwd for sm_90a: the gradient of the Mamba (S6) selective scan
// (csrc/mamba_scan.cu) with respect to dt, B, C, x, A and the start state.
//
// No TPU kernel has a backward: the JAX package differentiates its chunked
// lax.scan under jax.checkpoint (repro/models/mamba.py:80-103), keeping the
// state at each chunk boundary and recomputing the chunk.  The port puts its
// forward kernel in the model (models/mamba.py), so a training step on the
// card needs a backward kernel too; this is it.  Shapes as the forward's, all
// float32: dt, x, dy (B, S, DI); B, C (B, S, DS) with DS = 16; A (DI, DS)
// negative; state0 and dstate (B, DI, DS); any S >= 1 and DI >= 1.
//
// Each state entry (b, d, n) is a scalar recurrence h_t = a_t h_{t-1} + u_t
// with a_t = exp(dt_t A[d,n]) and u_t = dt_t x_t B_t[n]; y_t[d] = sum_n h_t C_t.
// With g_t the gradient of the loss with respect to h_t (g_S = dstate +
// C_S dy_S, g_{t-1} = C_{t-1} dy_{t-1} + a_t g_t):
//   dx_t[d]  = dt_t sum_n g_t B_t               dB_t[n] = sum_d g_t dt_t x_t
//   ddt_t[d] = sum_n g_t (x_t B_t + A a_t h_{t-1})   dC_t[n] = sum_d h_t dy_t
//   dA[d,n]  = sum_{b,t} g_t dt_t a_t h_{t-1}    dstate0 = a_1 g_1.
//
// Chunk-parallel in time.  The S steps split into nc = ceil(S / T) chunks of
// T, and with ghat(c) the gradient of the state at chunk c's end from the
// steps after it, both carries between chunks are pointwise:
//   h_start(c + 1) = P_c h_start(c) + S_loc(c),  ghat(c - 1) = P_c ghat(c) + G_loc(c)
// with P_c = prod_t a_t over the chunk, S_loc the chunk's state from zero and
// G_loc = sum_t (prod_{t' <= t} a_t') C_t dy_t, its gradient from zero.  So:
//   A  mamba_bwd_local: a block a (batch row, chunk, CPB channels) walks its
//      chunk once, forming S_loc, G_loc and P of every entry (one exponential
//      an entry and step, a running product p_t for G_loc: no quotient).
//   B  mamba_bwd_carry: a thread scans 4 entries over the chunks, h from
//      state0 or (another thread) ghat from dstate, the last of which is
//      dstate0; each chunk's h_start and ghat overwrite A's S_loc and G_loc.
//   C  mamba_bwd_chunk: a block as in A walks its chunk backwards from
//      h_start(c) and ghat(c).  A forward walk keeps h at the start of each
//      L-step sub-chunk in shared memory; the sub-chunks then go last to
//      first, each one's h_t and a_t recomputed into registers (fully
//      unrolled) and walked backwards.
//   mamba_bwd_sum adds the blocks' partials of dB and dC over the channel
//      groups, and dA's over batch rows and chunks, each in a fixed order.
// h is never walked backwards by dividing by a_t, which falls to e^-20 at the
// served A; each a_t is computed in A, once in C's forward walk and once in
// C's recompute, and kept in registers for the walk back.
//
// A thread holds E = 4 of a channel's 16 entries, so a channel's 4 lanes and
// 8 channels share a warp.  dx and ddt sum over the channel's entries: in the
// thread, then over its 4 lanes by a reduce-scatter of 2 shuffles; the owner
// lanes overwrite the step's dt and x in shared memory with them, and the
// chunk's dx and ddt are stored once at its end.  dB and dC sum over
// channels: a reduce-scatter of 7 shuffles over the warp's 8 channels leaves
// each lane one of its group's 8 values, the 8 warps' partials of each
// sub-chunk step are added in warp order, and each block writes its partial
// of every step; the sum over blocks is mamba_bwd_sum's.  No float atomic is
// used and every sum is in a fixed order, so two calls give the same bits.
// A chunk's dt, x, dy (the block's channels) and B, C arrive by cp.async once
// for A and again for C; steps past S and channels past DI are zero-filled
// (dt 0 gives a_t = 1: h and ghat pass through them unchanged).  Scratch:
// each chunk's h_start, ghat and P (P then dA's partials; 3 B nc DI DS
// floats) and the blocks' partials of dB and dC (B S ceil(DI / CPB) 2 DS).
//
// Bound on an H100 at jamba's train_4k step (B 1, S 4096, DI 8192): the
// bytes of dt, x, dy read and ddt, dx written (f32) plus B, C, dB, dC, A, dA
// and the three states, 0.67 GB at 3.35 TB/s, 0.20 ms; the B S DI DS =
// 5.37e8 exponentials at 16 a clock on each of 132 SMs, 0.128 ms taken once;
// 19 f32 operations an entry and step, 0.152 ms.  This design takes each
// exponential three times and reads the inputs twice.
#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "kernel_error.cuh"
#include "warp_scatter.cuh"

namespace {

constexpr int DS = 16;          // d_state
constexpr int E = 4;            // state entries a thread
constexpr int LPC = DS / E;     // lanes a channel
constexpr int CPB = 64;         // channels a block
constexpr int NT = CPB * LPC;   // threads a block
constexpr int NW = NT / 32;     // warps a block
constexpr int T = 64;           // steps a chunk
constexpr int L = 8;            // steps a sub-chunk, whose h and a_t phase C keeps in registers
constexpr int NQ = T / L;       // sub-chunks a chunk
constexpr int U = 8;            // chunks whose loads phase B keeps in flight together
constexpr int NV = 2 * DS;      // dB and dC values a step
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(E == 4 && LPC == 4 && 32 / LPC == 8,
              "float4 entries; 4 lanes a channel and 8 channels a warp for the reduce-scatters");
static_assert(T % L == 0 && NT == L * NV, "whole sub-chunks; a thread a sub-chunk step's value");

// a chunk's inputs: dt, x, dy of the block's channels; B and C of the batch
// row.  Phase C overwrites dt and x of step t, channel j, with dx and ddt
// once the channel's lanes are done with them
struct __align__(16) Chunk {
  float dt[T][CPB], x[T][CPB], dy[T][CPB];
  float b[T][DS], c[T][DS];
};

struct __align__(16) ChunkSmem {
  Chunk in;
  float4 start[NQ][NT];      // each thread's entries of h at each sub-chunk's start
  float part[2][L][NW][NV];  // each warp's partials of dB, dC, two sub-chunks in turn
};

constexpr size_t SMEM_LOCAL = sizeof(Chunk);
constexpr size_t SMEM_CHUNK = sizeof(ChunkSmem);

__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// the chunk's steps [0, len) into ch: dt, x, dy from ``row`` (their (b, t0,
// d0) element), live of the CPB channels inside DI; B, C from ``brow``
// (their (b, t0, 0)); copies of W floats (4: 16 bytes, 1: 4 bytes); the rest
// zero-filled
template <int W>
__device__ void load_chunk(Chunk& ch, const float* __restrict__ dt, const float* __restrict__ x,
                           const float* __restrict__ dy, const float* __restrict__ bm,
                           const float* __restrict__ cm, size_t row, size_t brow, int di,
                           int len, int live) {
  constexpr int kRowThreads = CPB / W;
  constexpr int kRows = NT / kRowThreads;
  const int j = threadIdx.x % kRowThreads * W;
  for (int t = threadIdx.x / kRowThreads; t < T; t += kRows) {
    const bool ok = t < len && j < live;
    const size_t off = ok ? row + (size_t)t * di + j : 0;
    cp_async<4 * W>(&ch.dt[t][j], dt + off, ok);
    cp_async<4 * W>(&ch.x[t][j], x + off, ok);
    cp_async<4 * W>(&ch.dy[t][j], dy + off, ok);
  }
  for (int k = threadIdx.x * W; k < 2 * T * DS; k += NT * W) {  // B's rows, then C's
    const int e = k % (T * DS);
    const bool ok = e < len * DS;
    const size_t off = ok ? brow + e : 0;
    if (k < T * DS)
      cp_async<4 * W>(&ch.b[0][e], bm + off, ok);
    else
      cp_async<4 * W>(&ch.c[0][e], cm + off, ok);
  }
  cp_async_wait_all();
  __syncthreads();  // every thread's copies are in
}

// phase A, a block a (batch row, chunk, channel group): S_loc, G_loc and P of
// every entry, into sbuf, gbuf and pbuf: (B, nc, DI, DS)
template <int W>
__global__ void __launch_bounds__(NT)
mamba_bwd_local(const float* __restrict__ dt, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ dy,
                float* __restrict__ sbuf, float* __restrict__ gbuf, float* __restrict__ pbuf,
                int s, int di, int nc, int ng) {
  extern __shared__ __align__(16) unsigned char raw[];
  Chunk& ch = *reinterpret_cast<Chunk*>(raw);
  const int grp = blockIdx.x % ng, c = blockIdx.x / ng % nc, b = blockIdx.x / ng / nc;
  const int d0 = grp * CPB, t0 = c * T, len = min(T, s - t0);
  load_chunk<W>(ch, dt, x, dy, bm, cm, ((size_t)b * s + t0) * di + d0, ((size_t)b * s + t0) * DS,
                di, len, di - d0);
  const int cl = threadIdx.x / LPC, q = threadIdx.x % LPC, d = d0 + cl;
  if (d >= di) return;  // no barrier follows
  float a2[E], S[E], G[E], p[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    a2[i] = a[(size_t)d * DS + q * E + i] * LOG2E;
    S[i] = 0.f, G[i] = 0.f, p[i] = 1.f;
  }
#pragma unroll 4
  for (int t = 0; t < len; ++t) {
    const float dtv = ch.dt[t][cl], dxv = dtv * ch.x[t][cl], dyv = ch.dy[t][cl];
    float bv[E], cv[E];
    load4(bv, &ch.b[t][q * E]);
    load4(cv, &ch.c[t][q * E]);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float at = ex2(dtv * a2[i]);
      S[i] = fmaf(at, S[i], dxv * bv[i]);
      p[i] *= at;
      G[i] = fmaf(p[i], cv[i] * dyv, G[i]);
    }
  }
  const size_t slot = (((size_t)b * nc + c) * di + d) * DS + q * E;
  store4(sbuf + slot, S);
  store4(gbuf + slot, G);
  store4(pbuf + slot, p);
}

// phase B: thread e < n / 4 scans h, the others ghat, each over 4 entries of
// the n = B DI DS (float4): sbuf and gbuf come in holding S_loc and G_loc
// and leave holding h_start and ghat of each chunk
__global__ void mamba_bwd_carry(const float* __restrict__ state0,
                                const float* __restrict__ dstate, float* __restrict__ sbuf,
                                float* __restrict__ gbuf, const float* __restrict__ pbuf,
                                float* __restrict__ dstate0, int nc, size_t per_b, size_t n) {
  const size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (idx >= n / 2) return;
  const bool fwd = idx < n / 4;  // h from state0, chunks first to last; else ghat from dstate
  const size_t e = (fwd ? idx : idx - n / 4) * 4;
  const size_t base = e / per_b * nc * per_b + e % per_b;
  float* buf = (fwd ? sbuf : gbuf) + base;
  const float* p = pbuf + base;
  float4 acc = *reinterpret_cast<const float4*>((fwd ? state0 : dstate) + e);
  // the chunks in walk order, U at a time; chunk c's slot: in, S_loc(c) (or
  // G_loc(c)); out, the carry before it
  for (int c0 = 0; c0 < nc; c0 += U) {
    float4 loc[U], pc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = fwd ? c0 + u : nc - 1 - c0 - u;
      if (c0 + u < nc) {
        loc[u] = *reinterpret_cast<const float4*>(buf + c * per_b);
        pc[u] = *reinterpret_cast<const float4*>(p + c * per_b);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = fwd ? c0 + u : nc - 1 - c0 - u;
      if (c0 + u < nc) {
        *reinterpret_cast<float4*>(buf + c * per_b) = acc;
        acc.x = fmaf(pc[u].x, acc.x, loc[u].x), acc.y = fmaf(pc[u].y, acc.y, loc[u].y);
        acc.z = fmaf(pc[u].z, acc.z, loc[u].z), acc.w = fmaf(pc[u].w, acc.w, loc[u].w);
      }
    }
  }
  if (!fwd) *reinterpret_cast<float4*>(dstate0 + e) = acc;
}

// phase C, a block as in A.  dx, ddt: (B, S, DI); dapart: (B, nc, DI, DS),
// each chunk's partial of dA; bcpart: (B, S, ng, NV), each block's partial
// of dB (values [0, DS)) and dC ([DS, NV)) at every step
template <int W>
__global__ void __launch_bounds__(NT, 2)
mamba_bwd_chunk(const float* __restrict__ dt, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ dy,
                const float* __restrict__ sbuf, const float* __restrict__ gbuf,
                float* __restrict__ ddt, float* __restrict__ dx, float* __restrict__ dapart,
                float* __restrict__ bcpart, int s, int di, int nc, int ng) {
  extern __shared__ __align__(16) unsigned char raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(raw);
  Chunk& ch = sm.in;
  const int grp = blockIdx.x % ng, c = blockIdx.x / ng % nc, b = blockIdx.x / ng / nc;
  const int d0 = grp * CPB, t0 = c * T, len = min(T, s - t0), live = di - d0;
  const size_t row = ((size_t)b * s + t0) * di + d0;
  load_chunk<W>(ch, dt, x, dy, bm, cm, row, ((size_t)b * s + t0) * DS, di, len, live);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cl = tid / LPC, q = tid % LPC, d = d0 + cl;
  const size_t slot = (((size_t)b * nc + c) * di + d) * DS + q * E;
  float a2[E], S[E], G[E], dA[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    a2[i] = cl < live ? a[(size_t)d * DS + q * E + i] * LOG2E : 0.f;
    S[i] = 0.f, G[i] = 0.f, dA[i] = 0.f;
  }
  if (cl < live) {
    load4(S, sbuf + slot);
    load4(G, gbuf + slot);
  }
  // the forward walk: h at each sub-chunk's start; sub-chunks past len are
  // all padding, through which h and ghat pass unchanged: skipped
  const int nq = (len + L - 1) / L;
  for (int sq = 0; sq < nq; ++sq) {
    sm.start[sq][tid] = make_float4(S[0], S[1], S[2], S[3]);
    if (sq + 1 == nq) break;
#pragma unroll 4
    for (int t = sq * L; t < (sq + 1) * L; ++t) {
      const float dtv = ch.dt[t][cl], dxv = dtv * ch.x[t][cl];
      float bv[E];
      load4(bv, &ch.b[t][q * E]);
#pragma unroll
      for (int i = 0; i < E; ++i) S[i] = fmaf(ex2(dtv * a2[i]), S[i], dxv * bv[i]);
    }
  }

  // the lane's value after the dB, dC reduce-scatter: dB (k < E) or dC of
  // entry q E + k % E
  const int k = scatter_first<2 * E, 16, 4>(lane);
  const int vslot = (k < E ? 0 : DS) + q * E + k % E;
  for (int sq = nq - 1; sq >= 0; --sq) {
    // the sub-chunk's h_{t-1} and a_t, recomputed from its start
    float hist[L][E], ahist[L][E];
    {
      const float4 f = sm.start[sq][tid];
      S[0] = f.x, S[1] = f.y, S[2] = f.z, S[3] = f.w;
    }
#pragma unroll
    for (int tt = 0; tt < L; ++tt) {
      const int t = sq * L + tt;
      const float dtv = ch.dt[t][cl], dxv = dtv * ch.x[t][cl];
      float bv[E];
      load4(bv, &ch.b[t][q * E]);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float at = ex2(dtv * a2[i]);
        hist[tt][i] = S[i];
        ahist[tt][i] = at;
        S[i] = fmaf(at, S[i], dxv * bv[i]);
      }
    }
    float (&part)[L][NW][NV] = sm.part[sq & 1];
#pragma unroll
    for (int tt = L - 1; tt >= 0; --tt) {
      const int t = sq * L + tt;
      const float dtv = ch.dt[t][cl], xv = ch.x[t][cl], dyv = ch.dy[t][cl];
      const float dtx = dtv * xv;
      float bv[E], cv[E], v[2 * E];
      load4(bv, &ch.b[t][q * E]);
      load4(cv, &ch.c[t][q * E]);
      float sb = 0.f, sa = 0.f;  // sum_n g B, sum_n g a_t h_{t-1} A log2 e
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float at = ahist[tt][i];
        const float g = fmaf(cv[i], dyv, G[i]);
        const float gq = g * (at * hist[tt][i]);
        sb = fmaf(g, bv[i], sb);
        sa = fmaf(gq, a2[i], sa);
        dA[i] = fmaf(gq, dtv, dA[i]);
        v[i] = g * dtx;         // dB_t's partial
        v[E + i] = S[i] * dyv;  // dC_t's partial, from h_t
        G[i] = at * g;
        S[i] = hist[tt][i];
      }
      float y[2] = {dtv * sb, fmaf(xv, sb, sa * LN2)};  // dx_t, ddt_t partials
      scatter<2, 2, 1>(y, lane);          // over the channel's 4 lanes
      scatter<2 * E, 16, 4>(v, lane);     // over the warp's 8 channels
      __syncwarp();                       // every lane has read step t's dt and x
      if (q == 0) ch.dt[t][cl] = y[0];    // lanes 0 and 2 of a channel hold dx, ddt
      if (q == 2) ch.x[t][cl] = y[0];
      part[tt][warp][vslot] = v[0];
    }
    __syncthreads();  // the sub-chunk's warp partials are in
    {
      const int tt = tid / NV, vv = tid % NV, t = sq * L + tt;
      if (t < len) {
        float acc = part[tt][0][vv];
#pragma unroll
        for (int w = 1; w < NW; ++w) acc += part[tt][w][vv];
        bcpart[(((size_t)b * s + t0 + t) * ng + grp) * NV + vv] = acc;
      }
    }
  }
  __syncthreads();  // every step's dx and ddt are in
  constexpr int kRowThreads = CPB / W;
  const int j = tid % kRowThreads * W;
  if (j < live) {
    for (int t = tid / kRowThreads; t < len; t += NT / kRowThreads) {
      const size_t off = row + (size_t)t * di + j;
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(dx + off) = *reinterpret_cast<const float4*>(&ch.dt[t][j]);
        *reinterpret_cast<float4*>(ddt + off) = *reinterpret_cast<const float4*>(&ch.x[t][j]);
      } else {
        dx[off] = ch.dt[t][j];
        ddt[off] = ch.x[t][j];
      }
    }
  }
  if (cl < live) store4(dapart + slot, dA);
}

// dB, dC: the ng channel groups' partials of each (b, t, value) added in
// order; then dA: the (B, nc) chunks' partials of each entry added in order
__global__ void mamba_bwd_sum(const float* __restrict__ bcpart,
                              const float* __restrict__ dapart, float* __restrict__ db,
                              float* __restrict__ dc, float* __restrict__ da, size_t n_bc,
                              int ng, int n_da, int n_parts) {
  const size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (idx < n_bc) {
    const size_t bt = idx / NV;
    const int v = (int)(idx % NV);
    const float* p = bcpart + bt * ng * NV + v;
    float acc = p[0];
    for (int g = 1; g < ng; ++g) acc += p[(size_t)g * NV];
    (v < DS ? db : dc)[bt * DS + v % DS] = acc;
  } else if (idx - n_bc < (size_t)n_da) {
    const size_t e = idx - n_bc;
    float acc = dapart[e];
    for (int p = 1; p < n_parts; ++p) acc += dapart[(size_t)p * n_da + e];
    da[e] = acc;
  }
}

// raise A's and C's dynamic shared-memory limits, once for each device
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  return once_per_device(done, [] {
    cudaError_t e;
    if ((e = allow_dynamic_smem(mamba_bwd_local<4>, SMEM_LOCAL))) return e;
    if ((e = allow_dynamic_smem(mamba_bwd_local<1>, SMEM_LOCAL))) return e;
    if ((e = allow_dynamic_smem(mamba_bwd_chunk<4>, SMEM_CHUNK))) return e;
    return allow_dynamic_smem(mamba_bwd_chunk<1>, SMEM_CHUNK);
  });
}

constexpr int CARRY_THREADS = 256, SUM_THREADS = 256;

long long chunks(int s) { return (s + T - 1) / T; }
long long groups(int di) { return (di + CPB - 1) / CPB; }

}  // namespace

// floats of scratch mamba_scan_bwd takes at (b, s, di): each chunk's h_start,
// ghat and P (then dA's partials), and the blocks' partials of dB and dC
extern "C" long long mamba_scan_bwd_workspace(int b, int s, int di) {
  return 3LL * b * chunks(s) * di * DS + (long long)b * s * groups(di) * NV;
}

// the sizes (T, L, CPB, E) into out[0..3], then out[4 + 6 m .. 10 + 6 m] for
// the kernels m = local, carry, chunk, sum: registers, static and dynamic
// shared memory, local bytes, threads and resident blocks an SM
extern "C" int mamba_scan_bwd_info(int* out) {
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return e;
  out[0] = T, out[1] = L, out[2] = CPB, out[3] = E;
  if ((e = attributes(mamba_bwd_local<4>, NT, SMEM_LOCAL, out + 4))) return e;
  if ((e = attributes(mamba_bwd_carry, CARRY_THREADS, 0, out + 10))) return e;
  if ((e = attributes(mamba_bwd_chunk<4>, NT, SMEM_CHUNK, out + 16))) return e;
  return attributes(mamba_bwd_sum, SUM_THREADS, 0, out + 22);
}

// ddt, dx (B, S, DI), db, dc (B, S, DS), da (DI, DS) and dstate0 (B, DI, DS)
// from the forward's inputs and the gradients of its two outputs; ``work``
// holds mamba_scan_bwd_workspace(b, s, di) floats.  Four launches: A, B, C
// and the sums.
extern "C" int mamba_scan_bwd(const float* dt, const float* bm, const float* cm, const float* x,
                              const float* a, const float* state0, const float* dy,
                              const float* dstate, float* ddt, float* db, float* dc, float* dx,
                              float* da, float* dstate0, float* work, int b, int s, int di,
                              int ds, void* stream) {
  if (b <= 0 || s <= 0 || di <= 0 || ds != DS) return cudaErrorInvalidValue;
  const long long nc = chunks(s), ng = groups(di), blocks = b * nc * ng;
  if (blocks > INT32_MAX || (long long)di * DS > INT32_MAX || b * nc > INT32_MAX)
    return cudaErrorInvalidValue;
  if (!(aligned16(state0) && aligned16(dstate) && aligned16(dstate0) && aligned16(work)))
    return cudaErrorMisalignedAddress;  // the wrapper copies these first
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t per_b = (size_t)di * DS, n = (size_t)b * per_b, per_buf = n * nc;
  float* sbuf = work;
  float* gbuf = sbuf + per_buf;
  float* pbuf = gbuf + per_buf;  // P, then dA's partials
  float* bcpart = pbuf + per_buf;
  const bool wide = di % 4 == 0 && aligned16(dt) && aligned16(x) && aligned16(dy) &&
                    aligned16(bm) && aligned16(cm) && aligned16(ddt) && aligned16(dx);
  if (wide)
    mamba_bwd_local<4><<<(int)blocks, NT, SMEM_LOCAL, st>>>(dt, bm, cm, x, a, dy, sbuf, gbuf,
                                                            pbuf, s, di, (int)nc, (int)ng);
  else
    mamba_bwd_local<1><<<(int)blocks, NT, SMEM_LOCAL, st>>>(dt, bm, cm, x, a, dy, sbuf, gbuf,
                                                            pbuf, s, di, (int)nc, (int)ng);
  if ((e = cudaGetLastError())) return e;
  mamba_bwd_carry<<<(int)((n / 2 + CARRY_THREADS - 1) / CARRY_THREADS), CARRY_THREADS, 0, st>>>(
      state0, dstate, sbuf, gbuf, pbuf, dstate0, (int)nc, per_b, n);
  if ((e = cudaGetLastError())) return e;
  if (wide)
    mamba_bwd_chunk<4><<<(int)blocks, NT, SMEM_CHUNK, st>>>(dt, bm, cm, x, a, dy, sbuf, gbuf,
                                                            ddt, dx, pbuf, bcpart, s, di,
                                                            (int)nc, (int)ng);
  else
    mamba_bwd_chunk<1><<<(int)blocks, NT, SMEM_CHUNK, st>>>(dt, bm, cm, x, a, dy, sbuf, gbuf,
                                                            ddt, dx, pbuf, bcpart, s, di,
                                                            (int)nc, (int)ng);
  if ((e = cudaGetLastError())) return e;
  const size_t n_bc = (size_t)b * s * NV, total = n_bc + per_b;
  mamba_bwd_sum<<<(int)((total + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0, st>>>(
      bcpart, pbuf, db, dc, da, n_bc, (int)ng, (int)per_b, (int)(b * nc));
  return cudaGetLastError();
}
