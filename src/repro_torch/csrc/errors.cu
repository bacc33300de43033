// The text of a CUDA error code, for the Python wrappers' exceptions.

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
