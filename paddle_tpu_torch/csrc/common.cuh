// Shared device helpers for the port's hand-written Hopper kernels.
//
// The counterpart of paddle_tpu/ops/pallas/core.py: type conversion into
// f32 math, warp/block reductions, and the online-softmax sentinel. Every
// kernel computes its statistics in f32 whatever its storage type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// storage-type codes passed by the Python wrappers (ops/cuda/core.py)
enum { PTT_F32 = 0, PTT_BF16 = 1, PTT_I8 = 2 };

// the -inf sentinel of the online softmax (paddle_tpu NEG_INF): a fully
// masked row keeps m at this value and its probabilities are masked to 0
#define PTT_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max. `red` is >= 32 floats of shared memory. Every
// thread sums the per-warp partials in the same order, so every thread
// gets the same value. The leading barrier makes `red` safe to reuse
// across back-to-back calls.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = PTT_NEG_INF;
  for (int i = 0; i < nw; ++i) t = fmaxf(t, red[i]);
  return t;
}

// ------------------------------------------------------------ cp.async
// Asynchronous global -> shared copies (sm_80+), for the CUDA-core
// kernels' rings of tiles: 16 bytes (both addresses 16-byte aligned) or
// 4 bytes.

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's committed groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four consecutive elements of a row into shared memory as f32 (`dst`
// 16-byte aligned): the first `valid` of them (at most 4; 0 or less for
// none) from `src`, the rest zero. f32 elements that start on 16 bytes
// take one 16-byte cp.async, other f32 elements one 4-byte cp.async each;
// zeros and bf16 (converted in registers) are plain stores, visible to
// the block after its next barrier, as the copies are after their wait.
__device__ __forceinline__ void load4(float* dst, const float* src,
                                      int valid) {
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
  } else if (valid <= 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < valid)
        cp_async4(dst + e, src + e);
      else
        dst[e] = 0.f;
    }
  }
}

__device__ __forceinline__ void load4(float* dst, const __nv_bfloat16* src,
                                      int valid) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    dst[e] = e < valid ? __bfloat162float(src[e]) : 0.f;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t ptt_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ptt_set_smem, and the SM's whole unified L1 / shared memory as shared
// memory, so that as many of the kernel's blocks as fit in 228 KB can be
// resident at once (left to itself, CUDA may pick a carveout that holds
// one).
template <typename K>
inline cudaError_t ptt_set_smem_resident(K kernel, size_t bytes) {
  cudaError_t err = ptt_set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The blocks of `kernel` that one SM holds at once with `threads` a block
// and `bytes` of dynamic shared memory, under ptt_set_smem_resident's
// settings: the CUDA occupancy calculator's count, which the wrappers'
// plans read (through an entry of the kernel's source) as the card's
// block slots.
template <typename K>
inline cudaError_t ptt_resident_blocks(K kernel, int threads, size_t bytes,
                                       int* out) {
  cudaError_t err = ptt_set_smem_resident(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                       bytes);
}
