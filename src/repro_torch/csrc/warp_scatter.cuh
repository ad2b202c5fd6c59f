// Reduce-scatters within a warp by xor shuffles, shared by the backward
// kernels: N values a lane summed over the lanes that differ in some bits,
// each halving leaving a lane half the values it held, so that no shuffle
// moves a value twice.
#pragma once

namespace {

// one halving of a reduce-scatter: lanes whose bit DIST is set keep the upper
// HALF of their first 2 HALF values, the others the lower, each adding its
// partner's
template <int HALF, int DIST, int K>
__device__ __forceinline__ void halve(float (&x)[K], int lane) {
  const bool hi = lane & DIST;
#pragma unroll
  for (int m = 0; m < HALF; ++m) {
    const float send = hi ? x[m] : x[m + HALF];
    const float keep = hi ? x[m + HALF] : x[m];
    x[m] = keep + __shfl_xor_sync(0xffffffffu, send, DIST);
  }
}

// x[0, N) summed over the lanes that differ in bits DIST, DIST / 2, .., LO:
// a halving a bit while a lane holds more than one value, then whole adds
template <int N, int DIST, int LO, int K>
__device__ __forceinline__ void scatter(float (&x)[K], int lane) {
  if constexpr (DIST >= LO && DIST > 0) {
    if constexpr (N > 1) {
      halve<N / 2, DIST>(x, lane);
      scatter<N / 2, DIST / 2, LO>(x, lane);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], DIST);
      scatter<1, DIST / 2, LO>(x, lane);
    }
  }
}

// values a lane holds after scatter<N, DIST, LO>
template <int N, int DIST, int LO>
__host__ __device__ constexpr int scatter_left() {
  if constexpr (DIST >= LO && DIST > 0 && N > 1) return scatter_left<N / 2, DIST / 2, LO>();
  else return N;
}

// the index, among the N, of a lane's first value after scatter<N, DIST, LO>
template <int N, int DIST, int LO>
__device__ __forceinline__ int scatter_first(int lane) {
  if constexpr (DIST >= LO && DIST > 0 && N > 1)
    return (lane & DIST ? N / 2 : 0) + scatter_first<N / 2, DIST / 2, LO>(lane);
  else return 0;
}

// whether a lane stores its values: of the lanes a whole add left equal, the
// one with those bits clear
template <int N, int DIST, int LO>
__device__ __forceinline__ bool scatter_owner(int lane) {
  if constexpr (DIST >= LO && DIST > 0) {
    if constexpr (N > 1) return scatter_owner<N / 2, DIST / 2, LO>(lane);
    else return !(lane & DIST) && scatter_owner<1, DIST / 2, LO>(lane);
  } else {
    return true;
  }
}

}  // namespace
