// Error text for the codes the kernel entries return (cudaGetLastError).

#include "common.cuh"

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
