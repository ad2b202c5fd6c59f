// The one C entry point every kernel library exports beside its launchers:
// the text of a CUDA error code, for the Python wrapper's exception.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
