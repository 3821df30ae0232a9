// Shared by every kernel library of the port. Each csrc/*.cu is built into a
// shared library of its own, so each exports its own copy of this function.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
