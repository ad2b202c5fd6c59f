// Helpers shared by the scan and codec kernels: the SFU's exponential,
// asynchronous copies into shared memory, and the host side's alignment test,
// once-a-device set-up and kernel attributes.
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// 2^v, one MUFU.EX2 (within 2 ulp; denormals flushed): e^x is ex2(x log2 e)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// BYTES from src to dst, or BYTES zeros where !valid (src is then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(to), "l"(src),
                 "n"(BYTES), "r"(n));
}

// 16 bytes from src to dst
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// commit this thread's copies and wait for all of them
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// fn's dynamic shared memory allowed up to bytes
template <class F>
cudaError_t allow_dynamic_smem(F* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// set() once for each device that succeeds, a bit a device in done (a device
// past the 64th runs it every time)
template <class Set>
cudaError_t once_per_device(std::atomic<uint64_t>& done, Set set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  if ((e = set()) == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// registers, static and dynamic shared memory, local (spilled) bytes,
// threads and resident blocks an SM of one kernel, into out[0..5]
template <class F>
cudaError_t attributes(F* fn, int threads, size_t dynamic_smem, int* out) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, dynamic_smem);
  if (e != cudaSuccess) return e;
  out[0] = at.numRegs, out[1] = (int)at.sharedSizeBytes, out[2] = (int)dynamic_smem;
  out[3] = (int)at.localSizeBytes, out[4] = threads, out[5] = blocks;
  return cudaSuccess;
}

}  // namespace
