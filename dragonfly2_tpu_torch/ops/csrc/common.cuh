// Shared by every kernel library: the C interface's error reporting.
// Each C entry point returns cudaGetLastError() after its launch (0 on
// success); the Python wrapper raises on anything else, with this text.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* df2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
