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

// ---- K8: fused residual add + layer norm, ln(x + h) ----------------------
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py:175 _ln_add_fwd_kernel
// (launched by _stats_add_pallas :190). One warp per row, as in K1. The
// sum s = f32(x) + f32(h) is formed once, on the first pass, and kept in
// shared memory in f32 (one buffer of padded C floats per row), so the
// variance and normalize passes read s from shared memory and never
// re-add from device memory, and the sum is never rounded to the storage
// type (the TPU
// kernel keeps it in f32 too). Bound on the H100: bytes (one read of x
// and h, one write of y). Rows are read and written in 16-byte packs
// when C and the pointers allow it; otherwise element by element. Each
// lane reads back only the sums it wrote, so they are stored lane-major
// within each 32-pack chunk (element i of lane l at i * 32 + l): the
// lanes of a warp touch 32 consecutive words, free of bank conflicts.
// The row buffer is C rounded up to kColPad, whole chunks of any pack.

constexpr int kColPad = 32 * 8;  // 32 lanes x the widest pack (8 bf16)

__host__ __device__ inline int padded_cols(int C) {
  return (C + kColPad - 1) / kColPad * kColPad;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                      const T* __restrict__ gamma, const T* __restrict__ beta,
                      T* __restrict__ y, float* __restrict__ mean,
                      float* __restrict__ rstd, int R, int C, float eps) {
  extern __shared__ float srow[];  // [kRowsPerBlock, padded C] f32 sums
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= R) return;  // no block barrier follows: each warp owns a row
  // this lane's sums: element i of the pack at column c lives at
  // s[c - lane * VEC + i * 32]
  float* s = srow + static_cast<size_t>(warp) * padded_cols(C) + lane;
  const size_t off = static_cast<size_t>(row) * C;
  float acc = 0.f;
  for (int c = lane * VEC; c < C; c += 32 * VEC) {
    const P xv = *reinterpret_cast<const P*>(x + off + c);
    const P hv = *reinterpret_cast<const P*>(h + off + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = to_f32(xv.v[i]) + to_f32(hv.v[i]);
      s[c - lane * VEC + i * 32] = v;
      acc += v;
    }
  }
  const float m = warp_sum(acc) / C;
  float var = 0.f;
  for (int c = lane * VEC; c < C; c += 32 * VEC) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = s[c - lane * VEC + i * 32] - m;
      var += d * d;
    }
  }
  var = warp_sum(var) / C;
  const float r = 1.0f / sqrtf(var + eps);
  for (int c = lane * VEC; c < C; c += 32 * VEC) {
    const P gv = *reinterpret_cast<const P*>(gamma + c);
    const P bv = *reinterpret_cast<const P*>(beta + c);
    P out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float o = (s[c - lane * VEC + i * 32] - m) * r;
      o = o * to_f32(gv.v[i]);
      o = o + to_f32(bv.v[i]);
      out.v[i] = from_f32<T>(o);
    }
    *reinterpret_cast<P*>(y + off + c) = out;
  }
  if (lane == 0) {
    mean[row] = m;
    rstd[row] = r;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t launch_add(const void* x, const void* h, const void* g,
                       const void* b, void* y, void* mean, void* rstd, int R,
                       int C, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t smem =
      static_cast<size_t>(kRowsPerBlock) * padded_cols(C) * sizeof(float);
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  const bool packed = C % kVec == 0 && aligned16(x) && aligned16(h) &&
                      aligned16(g) && aligned16(b) && aligned16(y);
  using Kernel = void (*)(const T*, const T*, const T*, const T*, T*, float*,
                          float*, int, int, float);
  Kernel kernel = add_ln_fwd_kernel<T, 1>;
  if (packed) kernel = add_ln_fwd_kernel<T, kVec>;
  const cudaError_t err = ptt_set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(g), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), R, C, eps);
  return cudaSuccess;
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

// Shared memory K8 takes for rows of C columns (the wrapper refuses a C
// whose rows do not fit in one block's shared memory).
extern "C" int ptt_add_layer_norm_smem_bytes(int C) {
  return kRowsPerBlock * padded_cols(C) * static_cast<int>(sizeof(float));
}

extern "C" int ptt_add_layer_norm(int dtype, const void* x, const void* h,
                                  const void* gamma, const void* beta,
                                  void* y, void* mean, void* rstd, int R,
                                  int C, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = launch_add<float>(x, h, gamma, beta, y, mean, rstd, R, C, eps, st);
  } else if (dtype == PTT_BF16) {
    err = launch_add<__nv_bfloat16>(x, h, gamma, beta, y, mean, rstd, R, C,
                                    eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
