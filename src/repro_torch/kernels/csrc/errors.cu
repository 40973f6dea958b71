// Shared C entry point of the kernel library: the message of a CUDA error
// code returned by one of the launchers (they return cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
