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
//
// Chunk-parallel in time.  The decay is diagonal, so every entry (i, j) of S
// and of G is a first-order scalar recurrence (S <- w_i S + k_i v_j, G <- w_i G
// + r_i dout_j), and the S steps split into nc = ceil(S / T) chunks of T that
// are walked at once, in three kernels and a small fourth:
//   A  wkv6_bwd_local: a CTA a (batch, head, chunk) forms each chunk's state
//      and gradient from zero, S_loc(c) = sum_t k~_t v_t^T and G_loc(c) =
//      sum_t r~_t dout_t^T with k~_t = k_t prod_{t' > t} w_t' and r~_t = r_t
//      prod_{t' < t} w_t' (each product walked step by step by one thread a
//      row), as two (D, T) by (T, D) products on 4 x 4 register tiles, and
//      P_c = prod_t w_t, each row's decay over the chunk.
//   B  wkv6_bwd_carry: a thread scans 4 state entries over the nc chunks,
//      S_start(c + 1) = P_c S_start(c) + S_loc(c) from state0, or (another
//      thread) G_end(c - 1) = P_c G_end(c) + G_loc(c) from dstate, the last of
//      which is dstate0; each chunk's start S and end G overwrite A's S_loc
//      and G_loc, U chunks' loads in flight at a time.
//   C  wkv6_bwd_chunk: a CTA a (batch, head, chunk, column group) runs the
//      recurrences above over its chunk from S_start(c) and G_end(c).  A
//      forward walk keeps the state at the start of each L-step sub-chunk in
//      shared memory; the sub-chunks then go last to first, each one's states
//      recomputed into registers (fully unrolled) and walked backwards.
//   wkv6_bwd_du adds du's partials of the chunks and batch rows in order.
// Only products of decays are formed, never a quotient, so decays whose
// products underflow to 0 over a chunk give the right answer to f32 precision.
//
// In C, column j of S and of G depends only on column j of v and dout, so a
// CTA holds CW of a head's 64 columns and a thread EC of them in one row
// (CW / EC threads a row, neighbours in a warp).  The sums over columns (dr,
// dk, dw) are summed in the thread, then over the row's threads by a
// reduce-scatter of shuffles, and each CTA keeps its partial of step t and row
// i in the shared slot of r, k and w it has read for the last time (stored a
// step late, so that two steps' work can interleave).  The NCG CTAs of one
// (batch, head, chunk) form a thread-block cluster: after a cluster barrier,
// rank q adds rows [q D / NCG, (q + 1) D / NCG) of every rank's partials,
// through distributed shared memory in rank order, and writes dr, dk and dw
// once.  dv's sum over rows is a reduce-scatter over each warp's rows and the
// warps' partials added once a sub-chunk, with the bonus a_t dout_t (a_t =
// sum_i r_i u_i k_i, once a step for the CTA).  du's partial of each row and
// chunk goes through the cluster too.  Every sum is in a fixed order and no
// float atomic is used, so two calls give the same bits.
//
// The sizes come from a timed sweep on an H100 (tools/rwkv_bwd_sweep.py): the
// larger a thread's tile (EC), the fewer shuffles and shared-memory reads an
// entry and step, which is what holds C; the chunk (T) is the longest whose
// shared memory still lets two CTAs of 8 warps share an SM.  A chunk's r, k, w
// (all rows) and v, dout (the CTA's columns) arrive by 16-byte cp.async once,
// for A and again for C; the steps past the end of the sequence hold w = 1 and
// zeros, which leave S and G as they are.  Scratch: the chunk boundaries' S
// and G (2 B H nc D D floats, 90 MB at B 1, S 4096, H 32), P and du's partials.
//
// Bound on an H100: the bytes of r, k, v, w, dout read and dr, dk, dv, dw
// written (f32) plus u and the three states, at 3.35 TB/s, against 14 f32
// operations a state entry and step (the state recomputed: k v, w S and the
// sum; dr, dk, dv and dw: a product and a sum each; G: w G, r dout and the
// sum) at 67 TFLOP/s; the operations are the larger.  This design does more:
// C's forward walk and its recompute, A's products and the shuffles of the
// sums over rows and columns.
#include <atomic>
#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "kernel_error.cuh"
#include "warp_scatter.cuh"

namespace coop = cooperative_groups;

namespace {

constexpr int D = 64;          // head dim: rows (and columns) of the state
constexpr int T = 48;          // steps a chunk
constexpr int L = 8;           // steps a sub-chunk, whose states C keeps in registers
constexpr int CW = 32;         // state columns a CTA of phase C holds
constexpr int EC = 8;          // state columns a thread of phase C holds, in one row
constexpr int NCG = D / CW;    // column groups: the CTAs of a cluster
constexpr int CPT = CW / EC;   // threads a row
constexpr int NT = D * CPT;    // threads a CTA
constexpr int RPW = 32 / CPT;  // rows a warp
constexpr int NW = NT / 32;    // warps a CTA
constexpr int NQ = T / L;      // sub-chunks a chunk
constexpr int RPR = D / NCG;   // rows each rank of a cluster sums
constexpr int U = 16;          // chunks whose loads phase B keeps in flight together
constexpr int TA = 4;          // phase A: a thread holds TA rows by TA columns of S and G
constexpr int NTA = D * D / (TA * TA);  // threads a CTA of phase A: the whole state
constexpr unsigned FULL = 0xffffffffu;
static_assert(D % CW == 0 && CW % EC == 0 && EC % 4 == 0, "float4 columns");
static_assert(32 % CPT == 0 && EC <= RPW, "a row's threads in one warp, dv to one a lane");
static_assert(T % L == 0 && NCG <= 8 && RPR % 4 == 0, "whole sub-chunks, a portable cluster");
static_assert(TA == 4 && NTA == 256, "phase A: float4 tiles, a warp 32 rows by 16 columns");

// a chunk's inputs, r, k, w in every row and v, dout in NC columns.  A scales
// k and r by their decay products in place; C overwrites r, k and w of step
// t, row i, with dr, dk and dw's partials once row i's threads are done with
// them
template <int NC>
struct __align__(16) Chunk {
  float rkw[3][T][D];
  float v[T][NC], g[T][NC];
};

struct __align__(16) ChunkSmem {
  Chunk<CW> in;
  float start[NQ][NT][EC];  // each thread's entries of S at each sub-chunk's start
  float dvp[2][L][NW][CW];  // each warp's partial of dv, two sub-chunks in turn
  float at[T];              // a_t = sum_i r_i u_i k_i
  float du[D];              // the CTA's partial of du, a row each
};

constexpr size_t SMEM_LOCAL = sizeof(Chunk<D>);
constexpr size_t SMEM_CHUNK = sizeof(ChunkSmem);

template <int K>
__device__ __forceinline__ void load_cols(float (&x)[K], const float* p) {
#pragma unroll
  for (int c = 0; c < K; c += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + c);
    x[c] = f.x, x[c + 1] = f.y, x[c + 2] = f.z, x[c + 3] = f.w;
  }
}

template <int K>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[K]) {
#pragma unroll
  for (int c = 0; c < K; c += 4)
    *reinterpret_cast<float4*>(p + c) = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
}

// the chunk's steps [0, len) into ch, 16 bytes a copy by each of NTH threads,
// from ``off``, the head's row of its first step, v and dout from column j0;
// the steps from len on get w 1 and zeros
template <int NC, int NTH>
__device__ void load_chunk(Chunk<NC>& ch, const float* __restrict__ r,
                           const float* __restrict__ k, const float* __restrict__ v,
                           const float* __restrict__ w, const float* __restrict__ dout,
                           size_t off, size_t stride, int j0, int len) {
  for (int c = threadIdx.x; c < 3 * T * D / 4; c += NTH) {
    const int a = c / (T * D / 4), t = c / (D / 4) % T, e = c % (D / 4) * 4;
    if (t < len)
      cp_async16(&ch.rkw[a][t][e], (a == 0 ? r : a == 1 ? k : w) + off + t * stride + e);
    else
      *reinterpret_cast<float4*>(&ch.rkw[a][t][e]) = a == 2 ? make_float4(1.f, 1.f, 1.f, 1.f)
                                                           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = threadIdx.x; c < T * NC / 4; c += NTH) {
    const int t = c / (NC / 4), e = c % (NC / 4) * 4;
    if (t < len) {
      const size_t g = off + t * stride + j0 + e;
      cp_async16(&ch.v[t][e], v + g);
      cp_async16(&ch.g[t][e], dout + g);
    } else {
      *reinterpret_cast<float4*>(&ch.v[t][e]) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&ch.g[t][e]) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every thread's copies and fills are in
}

// phase A, a CTA a (batch, head, chunk).  With k~_t = k_t prod_{t' > t} w_t'
// and r~_t = r_t prod_{t' < t} w_t' (each product walked by one thread a row,
// over k and r in place), S_loc = sum_t k~_t v_t^T and G_loc = sum_t r~_t
// dout_t^T: two products of (D, T) by (T, D), a thread a 4 x 4 tile of each,
// a warp 32 rows by 16 columns, so that each float4 read of k~, r~, v and
// dout serves 4 FMAs.  sloc, gloc: (B, H, nc, D, D); pdec: (B, H, nc, D)
__global__ void __launch_bounds__(NTA)
wkv6_bwd_local(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ dout, float* __restrict__ sloc,
               float* __restrict__ gloc, float* __restrict__ pdec, int s, int n_heads, int nc) {
  extern __shared__ __align__(16) unsigned char raw[];
  Chunk<D>& ch = *reinterpret_cast<Chunk<D>*>(raw);
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / n_heads, h = bh % n_heads;
  const size_t stride = (size_t)n_heads * D;
  const size_t off = ((size_t)(b * s + c * T) * n_heads + h) * D;
  load_chunk<D, NTA>(ch, r, k, v, w, dout, off, stride, 0, min(T, s - c * T));
  if (threadIdx.x < D) {  // k~, walked last step to first
    const int row = threadIdx.x;
    float p = 1.f;
#pragma unroll 8
    for (int t = T - 1; t >= 0; --t) {
      ch.rkw[1][t][row] *= p;
      p *= ch.rkw[2][t][row];
    }
  } else if (threadIdx.x < 2 * D) {  // r~ and the chunk's decay P
    const int row = threadIdx.x - D;
    float p = 1.f;
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      ch.rkw[0][t][row] *= p;
      p *= ch.rkw[2][t][row];
    }
    pdec[((size_t)bh * nc + c) * D + row] = p;
  }
  __syncthreads();  // k~ and r~ are in

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i0 = (warp / 4 * 8 + lane / 4) * TA, j0 = (warp % 4 * 4 + lane % 4) * TA;
  float S[TA][TA], G[TA][TA];
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int e = 0; e < TA; ++e) S[a][e] = 0.f, G[a][e] = 0.f;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    float kk[TA], rr[TA], vv[TA], gg[TA];
    load_cols(kk, &ch.rkw[1][t][i0]);
    load_cols(rr, &ch.rkw[0][t][i0]);
    load_cols(vv, &ch.v[t][j0]);
    load_cols(gg, &ch.g[t][j0]);
#pragma unroll
    for (int a = 0; a < TA; ++a)
#pragma unroll
      for (int e = 0; e < TA; ++e) {
        S[a][e] = fmaf(kk[a], vv[e], S[a][e]);
        G[a][e] = fmaf(rr[a], gg[e], G[a][e]);
      }
  }
  const size_t slot = (((size_t)bh * nc + c) * D + i0) * D + j0;
#pragma unroll
  for (int a = 0; a < TA; ++a) {
    store_cols(sloc + slot + a * D, S[a]);
    store_cols(gloc + slot + a * D, G[a]);
  }
}

// phase B: thread e < n / 4 scans S, the others G, each over 4 entries of
// the n = B H D D (one row, float4): sbuf and gbuf come in holding S_loc and
// G_loc and leave holding S_start and G_end of each chunk
__global__ void wkv6_bwd_carry(const float* __restrict__ state0,
                               const float* __restrict__ dstate, float* __restrict__ sbuf,
                               float* __restrict__ gbuf, const float* __restrict__ pdec,
                               float* __restrict__ dstate0, int nc, size_t n) {
  const size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (idx >= n / 2) return;
  const bool fwd = idx < n / 4;  // S from state0, chunks first to last; else G from dstate
  const size_t e = (fwd ? idx : idx - n / 4) * 4, DD = (size_t)D * D;
  const size_t bh = e / DD, ij = e % DD;
  float* buf = (fwd ? sbuf : gbuf) + bh * nc * DD + ij;
  const float* p = pdec + bh * nc * D + ij / D;
  float4 acc = *reinterpret_cast<const float4*>((fwd ? state0 : dstate) + e);
  // the chunks in walk order, U at a time; chunk c's slot: in, S_loc(c) (or
  // G_loc(c)); out, the carry before it
  for (int c0 = 0; c0 < nc; c0 += U) {
    float4 loc[U];
    float pc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = fwd ? c0 + u : nc - 1 - c0 - u;
      if (c0 + u < nc) {
        loc[u] = *reinterpret_cast<const float4*>(buf + c * DD);
        pc[u] = p[c * D];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = fwd ? c0 + u : nc - 1 - c0 - u;
      if (c0 + u < nc) {
        *reinterpret_cast<float4*>(buf + c * DD) = acc;
        acc.x = fmaf(pc[u], acc.x, loc[u].x), acc.y = fmaf(pc[u], acc.y, loc[u].y);
        acc.z = fmaf(pc[u], acc.z, loc[u].z), acc.w = fmaf(pc[u], acc.w, loc[u].w);
      }
    }
  }
  if (!fwd) *reinterpret_cast<float4*>(dstate0 + e) = acc;
}

constexpr int XL = scatter_left<4, CPT / 2, 1>();  // dr, dk, dw (and a spare) a lane

// phase C's partials of step t (sub-chunk step tt): a lane's of dr, dk, dw
// (values x_slot, x_slot + 1, .. of the four) over r, k, w of step t, row i,
// and a warp's of dv; after a warp barrier, by which every lane of the warp
// has read step t's r, k and w
__device__ __forceinline__ void store_partials(Chunk<CW>& ch, float (&dvb)[L][NW][CW],
                                               const float (&px)[XL], float pdv, int t, int tt,
                                               int i, int x_slot, bool x_owner, int warp,
                                               int dv_col, bool dv_owner) {
  __syncwarp();
  if (x_owner) {
#pragma unroll
    for (int m = 0; m < XL; ++m)
      if (x_slot + m < 3) ch.rkw[x_slot + m][t][i] = px[m];
  }
  if (dv_owner) dvb[tt][warp][dv_col] = pdv;
}

// phase C.  du_part: (B, nc, H, D), the chunks' partials of du
__global__ void __cluster_dims__(NCG, 1, 1) __launch_bounds__(NT, 512 / NT)
wkv6_bwd_chunk(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ dout,
               const float* __restrict__ sbuf, const float* __restrict__ gbuf,
               float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part, int s, int n_heads, int nc) {
  extern __shared__ __align__(16) unsigned char raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(raw);
  Chunk<CW>& ch = sm.in;
  coop::cluster_group cluster = coop::this_cluster();
  const int q = (int)cluster.block_rank();  // the column group
  const int c = blockIdx.x / NCG % nc, bh = blockIdx.x / NCG / nc;
  const int b = bh / n_heads, h = bh % n_heads;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i = tid / CPT, jt = tid % CPT * EC;
  const size_t stride = (size_t)n_heads * D;
  const size_t off = ((size_t)(b * s + c * T) * n_heads + h) * D;
  const int len = min(T, s - c * T);
  load_chunk<CW, NT>(ch, r, k, v, w, dout, off, stride, q * CW, len);

  // a_t for every step, each warp its steps, each lane two rows
  const float u0 = u[h * D + lane], u1 = u[h * D + lane + 32];
  for (int t = warp; t < T; t += NW) {
    float a = fmaf(ch.rkw[0][t][lane] * u0, ch.rkw[1][t][lane],
                   ch.rkw[0][t][lane + 32] * u1 * ch.rkw[1][t][lane + 32]);
#pragma unroll
    for (int m = 16; m; m >>= 1) a += __shfl_xor_sync(FULL, a, m);
    if (lane == 0) sm.at[t] = a;
  }

  // the forward walk: S at each sub-chunk's start
  const size_t slot = (((size_t)bh * nc + c) * D + i) * D + q * CW + jt;
  float S[EC], G[EC];
  load_cols(S, sbuf + slot);
  load_cols(G, gbuf + slot);
  for (int sq = 0; sq < NQ; ++sq) {
    store_cols(sm.start[sq][tid], S);
    if (sq + 1 == NQ) break;
#pragma unroll 4
    for (int t = sq * L; t < (sq + 1) * L; ++t) {
      const float kk = ch.rkw[1][t][i], ww = ch.rkw[2][t][i];
      float vv[EC];
      load_cols(vv, &ch.v[t][jt]);
#pragma unroll
      for (int e = 0; e < EC; ++e) S[e] = fmaf(ww, S[e], kk * vv[e]);
    }
  }
  const float ui = u[h * D + i];
  float du = 0.f;
  __syncthreads();  // a_t is in; from here on row i's r, k, w are row i's threads' alone

  const int x_slot = scatter_first<4, CPT / 2, 1>(lane);
  const bool x_owner = scatter_owner<4, CPT / 2, 1>(lane);
  const int dv_col = jt + scatter_first<EC, 16, CPT>(lane);
  const bool dv_owner = scatter_owner<EC, 16, CPT>(lane);
  for (int sq = NQ - 1; sq >= 0; --sq) {
    // the sub-chunk's states S_{t-1}, recomputed from its start
    float hist[L][EC];
    load_cols(S, sm.start[sq][tid]);
#pragma unroll
    for (int tt = 0; tt < L; ++tt) {
#pragma unroll
      for (int e = 0; e < EC; ++e) hist[tt][e] = S[e];
      if (tt + 1 < L) {
        const int t = sq * L + tt;
        const float kk = ch.rkw[1][t][i], ww = ch.rkw[2][t][i];
        float vv[EC];
        load_cols(vv, &ch.v[t][jt]);
#pragma unroll
        for (int e = 0; e < EC; ++e) S[e] = fmaf(ww, S[e], kk * vv[e]);
      }
    }
    float (&dvb)[L][NW][CW] = sm.dvp[sq & 1];
    // each step's partials are stored a step late, after the next step's
    // loads, so that the two steps' work can interleave
    float px[XL], pdv = 0.f;
#pragma unroll
    for (int m = 0; m < XL; ++m) px[m] = 0.f;
#pragma unroll
    for (int tt = L - 1; tt >= 0; --tt) {
      const int t = sq * L + tt;
      const float rr = ch.rkw[0][t][i], kk = ch.rkw[1][t][i], ww = ch.rkw[2][t][i];
      float vv[EC], gg[EC], dvp[EC];
      load_cols(vv, &ch.v[t][jt]);
      load_cols(gg, &ch.g[t][jt]);
      if (tt + 1 < L) store_partials(ch, dvb, px, pdv, t + 1, tt + 1, i, x_slot, x_owner,
                                     warp, dv_col, dv_owner);
      float vd = 0.f, x[4] = {0.f, 0.f, 0.f, 0.f};  // v_t . dout_t; dr, dk, dw's partials
#pragma unroll
      for (int e = 0; e < EC; ++e) {
        vd = fmaf(vv[e], gg[e], vd);
        x[0] = fmaf(hist[tt][e], gg[e], x[0]);
        x[1] = fmaf(G[e], vv[e], x[1]);
        x[2] = fmaf(G[e], hist[tt][e], x[2]);
        dvp[e] = G[e] * kk;
        G[e] = fmaf(ww, G[e], rr * gg[e]);
      }
      x[0] = fmaf(ui * kk, vd, x[0]);
      x[1] = fmaf(rr * ui, vd, x[1]);
      du = fmaf(rr * kk, vd, du);
      scatter<4, CPT / 2, 1>(x, lane);
      scatter<EC, 16, CPT>(dvp, lane);
#pragma unroll
      for (int m = 0; m < XL; ++m) px[m] = x[m];
      pdv = dvp[0];
    }
    store_partials(ch, dvb, px, pdv, sq * L, 0, i, x_slot, x_owner, warp, dv_col, dv_owner);
    __syncthreads();  // the sub-chunk's dv partials are in
    for (int idx = tid; idx < L * CW; idx += NT) {
      const int tt = idx / CW, jj = idx % CW, t = sq * L + tt;
      if (t < len) {
        float acc = dvb[tt][0][jj];
#pragma unroll
        for (int wp = 1; wp < NW; ++wp) acc += dvb[tt][wp][jj];
        dv[off + t * stride + q * CW + jj] = fmaf(sm.at[t], ch.g[t][jj], acc);
      }
    }
  }
#pragma unroll
  for (int m = CPT / 2; m; m >>= 1) du += __shfl_xor_sync(FULL, du, m);
  if (jt == 0) sm.du[i] = du;

  cluster.sync();  // every rank's partials are in its shared memory
  // rank q: rows [q RPR, (q + 1) RPR) of dr, dk and dw, 4 rows a thread, the
  // ranks added in order
  for (int idx = tid; idx < 3 * T * RPR / 4; idx += NT) {
    const int a = idx / (T * RPR / 4), t = idx / (RPR / 4) % T;
    const int row = q * RPR + idx % (RPR / 4) * 4;
    float* mine = &ch.rkw[a][t][row];
    float4 acc = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, 0));
#pragma unroll
    for (int rk = 1; rk < NCG; ++rk) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, rk));
      acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
    }
    float* out = a == 0 ? dr : a == 1 ? dk : dw;
    if (t < len) *reinterpret_cast<float4*>(out + off + t * stride + row) = acc;
  }
  if (tid < RPR) {
    const int row = q * RPR + tid;
    float acc = *cluster.map_shared_rank(&sm.du[row], 0);
#pragma unroll
    for (int rk = 1; rk < NCG; ++rk) acc += *cluster.map_shared_rank(&sm.du[row], rk);
    du_part[(((size_t)b * nc + c) * n_heads + h) * D + row] = acc;
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

// du: the (B, nc) chunks' partials of each (head, row) added in order
__global__ void wkv6_bwd_du(const float* __restrict__ du_part, float* __restrict__ du,
                            int n_parts, int hd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hd) return;
  float acc = 0.f;
#pragma unroll 8
  for (int p = 0; p < n_parts; ++p) acc += du_part[(size_t)p * hd + e];
  du[e] = acc;
}

// raise A's and C's dynamic shared-memory limits, once for each device
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  return once_per_device(done, [] {
    const cudaError_t e = allow_dynamic_smem(wkv6_bwd_local, SMEM_LOCAL);
    return e ? e : allow_dynamic_smem(wkv6_bwd_chunk, SMEM_CHUNK);
  });
}

constexpr int CARRY_THREADS = 256, DU_THREADS = 128;

}  // namespace

// floats of scratch rwkv6_scan_bwd takes at (b, s, h): each chunk's boundary
// S and G, the rows' decay over each chunk and each chunk's partial of du
extern "C" long long rwkv6_scan_bwd_workspace(int b, int s, int h) {
  const long long nc = (s + T - 1) / T, bh = (long long)b * h;
  return 2 * bh * nc * D * D + 2 * bh * nc * D;
}

// the sizes (T, L, CW, EC) into out[0..3], then out[4 + 6 m .. 10 + 6 m] for
// the kernels m = local, carry, chunk, du: registers, static and dynamic
// shared memory, local bytes, threads and resident CTAs an SM; out[28] the
// clusters of the chunk kernel the device holds at once
extern "C" int rwkv6_scan_bwd_info(int* out) {
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return e;
  out[0] = T, out[1] = L, out[2] = CW, out[3] = EC;
  if ((e = attributes(wkv6_bwd_local, NTA, SMEM_LOCAL, out + 4))) return e;
  if ((e = attributes(wkv6_bwd_carry, CARRY_THREADS, 0, out + 10))) return e;
  if ((e = attributes(wkv6_bwd_chunk, NT, SMEM_CHUNK, out + 16))) return e;
  if ((e = attributes(wkv6_bwd_du, DU_THREADS, 0, out + 22))) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NCG * 1024), cfg.blockDim = dim3(NT), cfg.dynamicSmemBytes = SMEM_CHUNK;
  return cudaOccupancyMaxActiveClusters(out + 28, wkv6_bwd_chunk, &cfg);
}

// dr, dk, dv, dw (B, S, H, D), du (H, D) and dstate0 (B, H, D, D) from the
// forward's inputs and the gradients of its two outputs; ``work`` holds
// rwkv6_scan_bwd_workspace(b, s, h) floats.  Four launches: A, B, C and du.
extern "C" int rwkv6_scan_bwd(const float* r, const float* k, const float* v, const float* w,
                              const float* u, const float* state0, const float* dout,
                              const float* dstate, float* dr, float* dk, float* dv, float* dw,
                              float* du, float* dstate0, float* work, int b, int s, int h, int d,
                              void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || d != D) return cudaErrorInvalidValue;
  const long long nc = (s + T - 1) / T, ctas = (long long)b * h * nc * NCG;
  if (ctas > INT32_MAX) return cudaErrorInvalidValue;
  if (!(aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) && aligned16(dout) &&
        aligned16(state0) && aligned16(dstate) && aligned16(dr) && aligned16(dk) &&
        aligned16(dw) && aligned16(dstate0) && aligned16(work)))
    return cudaErrorMisalignedAddress;  // the wrapper refuses or copies these first
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bh = (size_t)b * h, n = bh * D * D;
  float* sbuf = work;
  float* gbuf = sbuf + bh * nc * D * D;
  float* pdec = gbuf + bh * nc * D * D;
  float* du_part = pdec + bh * nc * D;
  wkv6_bwd_local<<<(int)(ctas / NCG), NTA, SMEM_LOCAL, st>>>(r, k, v, w, dout, sbuf, gbuf, pdec,
                                                             s, h, (int)nc);
  if ((e = cudaGetLastError())) return e;
  wkv6_bwd_carry<<<(int)((n / 2 + CARRY_THREADS - 1) / CARRY_THREADS), CARRY_THREADS, 0, st>>>(
      state0, dstate, sbuf, gbuf, pdec, dstate0, (int)nc, n);
  if ((e = cudaGetLastError())) return e;
  wkv6_bwd_chunk<<<(int)ctas, NT, SMEM_CHUNK, st>>>(r, k, v, w, u, dout, sbuf, gbuf, dr, dk, dv,
                                                    dw, du_part, s, h, (int)nc);
  if ((e = cudaGetLastError())) return e;
  wkv6_bwd_du<<<(h * D + DU_THREADS - 1) / DU_THREADS, DU_THREADS, 0, st>>>(
      du_part, du, b * (int)nc, h * D);
  return cudaGetLastError();
}
