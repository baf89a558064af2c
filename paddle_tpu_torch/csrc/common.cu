// Error text for the codes the kernel entries return (cudaGetLastError),
// and an empty kernel.

#include "common.cuh"

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// Launch one empty kernel: chip_smoke.py times a CUDA graph of it, the
// floor under every kernel time it reports.
extern "C" int ptt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
