// The register-tiled f32 tile machinery of flash_attention's f32 routes:
// flash_fwd_f32 (csrc/flash_attention.cu) and flash_bwd_dq, flash_bwd_dkdv
// (csrc/flash_attention_bwd.cu).
//
// What bounds them: f32 FMA on the CUDA cores, 67 TFLOP/s on an H100 (128
// lanes an SM), and, below that, shared memory, which hands each SM 128
// bytes a clock to its lanes (a float4 that 32 lanes read at one address
// costs as much as 32 distinct ones).  Operands read one at a time cap a
// product at a quarter of the FMA rate or less.  So every product here is
// register tiled: a thread owns TM x TN = 8 x 4 outputs and reads its
// operands as float4, TM + TN loads for every TM * TN * 4 = 128 FMAs (one
// load for 10.7 FMAs, 1.5 bytes a FMA: at most 2/3 of the FMA rate).  An
// 8 x 8 tile (1 byte a FMA) would need 64 accumulators a product, and the
// forward holds two tile products' accumulators at once; 16 resident warps
// an SM leave a thread 128 registers.
//
// Rows and columns.  A product of ROWS = 64 rows and D columns runs on
// NT = 2 D threads: NG = 8 row groups of NL = D / 4 lanes (a group is one
// warp at D 128, half of one at D 64).  Lane l of group g owns rows
// g + NG i (i < TM) and either the columns l + NL j (a product whose right
// operand is stored [column][k], "nt": the scores) or 4 l .. 4 l + 3 (one
// stored [k][column], "nn": the D-wide accumulators).  A row's outputs all
// sit in one group, so a row's softmax reduces over the group's lanes by
// shuffles, and the weights a group writes to shared memory are read by that
// group alone (a __syncwarp, not a block barrier).  The left operand is read
// along k, four k at a time (one float4 a row); so is an nt right operand, an
// nn one as the float4 of its four columns at each k.  Nothing is transposed:
// read along k, a tile costs the loads a FMA a transposed one would, and it
// rides the cp.async ring as it lies in device memory, with no registers
// held to transpose it on the way; rows are padded by PAD floats so that 8
// consecutive rows of one float4 read fall in distinct banks.
//
// The next tile in flight.  Operands stream through a ring of STAGES stages
// filled by 16-byte cp.async copies (rows past the sequence zero-filled
// through the source size, as sgemm_tile.cuh does); a stage holds one
// KC = 32-wide slice of k: a d-slice [rows][32] of a tile stored along D, or
// 32 rows [32][D] of one.  Stage n + 1 is copied while stage n is read, with
// one cp.async wait and one __syncthreads a stage.
//
// Every output sums its terms in ascending k, one fmaf each, from 0; no
// atomics, so two launches give equal bits.
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace f32 {

constexpr int ROWS = 64;   // rows of one product: 8 groups of 8
constexpr int KC = 32;     // the k-slice of one ring stage
constexpr int STAGES = 2;  // ring stages
constexpr int TM = 8, TN = 4;
constexpr int PAD = 4;     // floats of padding a shared row

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// the thread layout of one ROWS x D product
template <int D>
struct Lanes {
  static_assert(D % 32 == 0 && D / TN <= 32, "head dim: 4 columns a lane, a group within a warp");
  static constexpr int NL = D / TN;      // lanes a row group
  static constexpr int NG = ROWS / TM;   // row groups
  static constexpr int NT = NL * NG;     // threads: 2 D
  static constexpr int LD = D + PAD;     // a shared row D wide
  static constexpr int LK = KC + PAD;    // a shared row of one d-slice
};

// ---------------------------------------------------------------- copies
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zeros where !valid (src is then not read)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + R) x C floats of a matrix (row stride ld floats, rows at or
// past n read as zeros; src at row 0 of the wanted columns, on a 16-byte
// boundary) into dst (row stride sld), as float4 copies by the NTH threads
// t = 0 .. NTH - 1: thread t copies float4 t % V of rows t / V + i NTH / V
template <int R, int C, int NTH>
__device__ __forceinline__ void copy_rows(float* dst, int sld, const float* __restrict__ src,
                                          size_t ld, int r0, int n, int t) {
  constexpr int V = C / 4, RS = NTH / V;
  static_assert(C % 4 == 0 && NTH % V == 0 && R % RS == 0, "whole float4 copies, the same count a thread");
  const int r = r0 + t / V, c = 4 * (t % V);
  const float* s = src + (size_t)r * ld + c;
  float* d = dst + (t / V) * sld + c;
#pragma unroll
  for (int i = 0; i < R / RS; ++i) {
    const bool ok = r + i * RS < n;
    cp16(d + i * RS * sld, ok ? s + (size_t)(i * RS) * ld : src, ok);
  }
}

// --------------------------------------------------------------- products
// acc[i][j] += sum_k a[i NG lda + k] b[j NL ldb + k], k < KC: a at the
// thread's first row, b at its first column, both stored along k
template <int NG, int NL, int LDA, int LDB>
__device__ __forceinline__ void mma_nt(float (&acc)[TM][TN], const float* a, const float* b) {
#pragma unroll 1
  for (int k = 0; k < KC; k += 4) {
    float4 y[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) y[j] = *reinterpret_cast<const float4*>(b + j * NL * LDB + k);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(a + i * NG * LDA + k);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(x.x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x.y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x.z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x.w, y[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_k a[i NG lda + k] b[k ldb + j], k < KC: a at the thread's
// first row (stored along k), b at its 4 columns (stored along them)
template <int NG, int LDA, int LDB>
__device__ __forceinline__ void mma_nn(float (&acc)[TM][TN], const float* a, const float* b) {
#pragma unroll 1
  for (int k = 0; k < KC; k += 4) {
    float4 y[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) y[kk] = *reinterpret_cast<const float4*>(b + (k + kk) * LDB);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(a + i * NG * LDA + k);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[i][0] = fmaf(xs[kk], y[kk].x, acc[i][0]);
        acc[i][1] = fmaf(xs[kk], y[kk].y, acc[i][1]);
        acc[i][2] = fmaf(xs[kk], y[kk].z, acc[i][2]);
        acc[i][3] = fmaf(xs[kk], y[kk].w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// ------------------------------------------------------------------ masks
// is the key at position kp live for query row qr (position qr + shift)
__device__ __forceinline__ bool live(int qr, int kp, int sq, int sk, int shift, int causal,
                                     int window) {
  const int qp = qr + shift;
  return qr < sq && kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// is every pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) live
__device__ __forceinline__ bool all_live(int q0, int nq, int k0, int nk, int sq, int sk,
                                         int causal, int window) {
  const int shift = sk - sq;
  return q0 + nq <= sq && k0 + nk <= sk && (!causal || k0 + nk - 1 <= q0 + shift) &&
         (window <= 0 || k0 > q0 + nq - 1 + shift - window);
}

// ------------------------------------------------------------------- ring
// The stages' sequence: stage(n) copies stage n of the block's sequence
// into the ring (every thread calls it); next() waits for the stage it
// returns, with the one barrier a stage, and starts the copy of the stage
// STAGES - 1 further on.
template <int STAGE_FLOATS, class Stage>
struct Ring {
  float* base;
  Stage stage;
  int n_stages, n = 0;

  __device__ __forceinline__ Ring(float* base_, Stage s, int count)
      : base(base_), stage(s), n_stages(count) {}

  __device__ __forceinline__ float* at(int i) const { return base + (i % STAGES) * STAGE_FLOATS; }

  // copies of the first STAGES - 1 stages (with whatever the caller put in
  // the first commit group)
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n_stages) stage(at(i), i);
      cp_commit();
    }
  }

  __device__ __forceinline__ const float* next() {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage n is in for every thread; every thread is done with n - 1
    const int ahead = n + STAGES - 1;
    if (ahead < n_stages) stage(at(ahead), ahead);
    cp_commit();
    return at(n++);
  }
};

template <int STAGE_FLOATS, class Stage>
__device__ __forceinline__ Ring<STAGE_FLOATS, Stage> make_ring(float* base, Stage s, int count) {
  return Ring<STAGE_FLOATS, Stage>(base, s, count);
}

// registers, static and dynamic shared memory and local (spilled) bytes of
// a kernel, into out[0..3] (both flash sources' info entry points)
template <class F>
int attributes(F* fn, int dynamic_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = dynamic_smem;
  out[3] = (int)a.localSizeBytes;
  return cudaSuccess;
}

}  // namespace f32
