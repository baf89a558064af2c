// K1: layer norm forward over [R, C] rows.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py:30 _ln_fwd_kernel (launched
// by _stats_pallas :62). One warp per row: the row is read three times
// (mean, centred variance, normalize), which the L1 serves after the
// first pass, so device memory sees one read of x and one write of y.
// The work is a reduction plus an elementwise affine: it is bound by
// bytes, and warp shuffles keep the statistics out of shared memory.
// Statistics are f32 whatever the storage type, as on the TPU.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd, int R,
                  int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + static_cast<size_t>(row) * C;
  T* yr = y + static_cast<size_t>(row) * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float m = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - m;
    v += d * d;
  }
  v = warp_sum(v) / C;
  const float r = 1.0f / sqrtf(v + eps);
  for (int c = lane; c < C; c += 32) {
    float o = (to_f32(xr[c]) - m) * r;
    o = o * to_f32(gamma[c]);
    o = o + to_f32(beta[c]);
    yr[c] = from_f32<T>(o);
  }
  if (lane == 0) {
    mean[row] = m;
    rstd[row] = r;
  }
}

template <typename T>
void launch(const void* x, const void* g, const void* b, void* y, void* mean,
            void* rstd, int R, int C, float eps, cudaStream_t stream) {
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), R, C, eps);
}

}  // namespace

extern "C" int ptt_layer_norm(int dtype, const void* x, const void* gamma,
                              const void* beta, void* y, void* mean,
                              void* rstd, int R, int C, float eps,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32) {
    launch<float>(x, gamma, beta, y, mean, rstd, R, C, eps, st);
  } else if (dtype == PTT_BF16) {
    launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, R, C, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
