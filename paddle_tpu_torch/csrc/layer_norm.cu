// K1: layer norm forward over [R, C] rows.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py:30 _ln_fwd_kernel (launched
// by _stats_pallas :62). The work is a reduction plus an elementwise
// affine: it is bound by bytes (one read of x, one write of y), and at the
// 8 rows of a decode step by the latency of one row. Two routes, chosen
// by shape in the wrapper (ops/cuda/layer_norm.py ln_route):
//
// row (C a multiple of the 16-byte pack, at most 8 packs a lane): one warp
//   holds a row in registers. Each lane issues all its 16-byte packs of x,
//   and of the scale and bias, before the first reduction, so a row costs
//   one memory round trip; the mean, then the centred variance (the
//   reference's two-pass numerics, not E[x^2] - m^2) come from the
//   registers by warp shuffles, and y leaves in 16-byte packs. The packs a
//   lane holds are a template parameter: C = 768 and C = 1024 are
//   compiled instances, as is every other C of 1-8 packs a lane.
// simt (other C), the first port: one warp per row reads the row three
//   times (mean, centred variance, normalize), the second and third from
//   L1.
//
// Statistics are f32 whatever the storage type, as on the TPU.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---- K1, the row route ---------------------------------------------------

constexpr int kRowWarps = 4;     // rows (one a warp) per block
constexpr int kMaxPacks = 8;     // 16-byte packs of a row a lane may hold

// NP packs of 16 bytes a lane: pack c = lane + 32 i of the row, for the
// packs that exist (C / VEC of them). The row stays in registers as it
// was loaded (bf16 pairs, not f32), converted in each pass, so a lane
// holds few registers and many warps fit on an SM.
template <typename T, int NP>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_row_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd, int R,
                  int C, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const int packs = C / VEC;
  const P* xr = reinterpret_cast<const P*>(x + static_cast<size_t>(row) * C);
  const P* gp = reinterpret_cast<const P*>(gamma);
  const P* bp = reinterpret_cast<const P*>(beta);
  P xv[NP], gv[NP], bv[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = lane + 32 * i;
    if (c < packs) {
      xv[i] = xr[c];
      gv[i] = gp[c];
      bv[i] = bp[c];
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i)
    if (lane + 32 * i < packs)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += to_f32(xv[i].v[e]);
  const float m = warp_sum(s) / C;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (lane + 32 * i < packs) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = to_f32(xv[i].v[e]) - m;
        v += d * d;
      }
    }
  }
  v = warp_sum(v) / C;
  const float r = 1.0f / sqrtf(v + eps);
  P* yr = reinterpret_cast<P*>(y + static_cast<size_t>(row) * C);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = lane + 32 * i;
    if (c < packs) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float t = (to_f32(xv[i].v[e]) - m) * r;
        t = t * to_f32(gv[i].v[e]);
        t = t + to_f32(bv[i].v[e]);
        o.v[e] = from_f32<T>(t);
      }
      yr[c] = o;
    }
  }
  if (lane == 0) {
    mean[row] = m;
    rstd[row] = r;
  }
}

template <typename T, int NP>
void launch_row_np(const void* x, const void* g, const void* b, void* y,
                   void* mean, void* rstd, int R, int C, float eps,
                   cudaStream_t stream) {
  const dim3 grid((R + kRowWarps - 1) / kRowWarps);
  ln_row_kernel<T, NP><<<grid, kRowWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), R, C, eps);
}

// The row route for C a multiple of the pack with 1..kMaxPacks packs a
// lane and every pointer 16-byte aligned; cudaErrorInvalidValue else.
template <typename T>
cudaError_t launch_row(const void* x, const void* g, const void* b, void* y,
                       void* mean, void* rstd, int R, int C, float eps,
                       cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int np = (C / VEC + 31) / 32;
  if (C % VEC != 0 || np < 1 || np > kMaxPacks || !aligned16(x) ||
      !aligned16(g) || !aligned16(b) || !aligned16(y))
    return cudaErrorInvalidValue;
  switch (np) {
    case 1: launch_row_np<T, 1>(x, g, b, y, mean, rstd, R, C, eps, st); break;
    case 2: launch_row_np<T, 2>(x, g, b, y, mean, rstd, R, C, eps, st); break;
    case 3: launch_row_np<T, 3>(x, g, b, y, mean, rstd, R, C, eps, st); break;
    case 4: launch_row_np<T, 4>(x, g, b, y, mean, rstd, R, C, eps, st); break;
    case 5: launch_row_np<T, 5>(x, g, b, y, mean, rstd, R, C, eps, st); break;
    case 6: launch_row_np<T, 6>(x, g, b, y, mean, rstd, R, C, eps, st); break;
    case 7: launch_row_np<T, 7>(x, g, b, y, mean, rstd, R, C, eps, st); break;
    default: launch_row_np<T, 8>(x, g, b, y, mean, rstd, R, C, eps, st);
  }
  return cudaGetLastError();
}

// ---- K1, the simt route --------------------------------------------------

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
// The scale and bias have a storage type P of their own (a template
// parameter): the Transformer under the bf16 policy normalizes f32 rows
// with bf16 parameters, and the TPU kernel widens every operand to f32 in
// the same way. They are read VEC elements at a time, a pack of VEC * size
// of P bytes, and widened exactly; no f32 operand is ever rounded.

constexpr int kColPad = 32 * 8;  // 32 lanes x the widest pack (8 bf16)

__host__ __device__ inline int padded_cols(int C) {
  return (C + kColPad - 1) / kColPad * kColPad;
}

template <typename T, typename PT, int VEC>
__global__ void __launch_bounds__(kThreads)
    add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                      const PT* __restrict__ gamma,
                      const PT* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int R, int C, float eps) {
  extern __shared__ float srow[];  // [kRowsPerBlock, padded C] f32 sums
  using P = Pack<T, VEC>;
  using PP = Pack<PT, VEC>;
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
    const PP gv = *reinterpret_cast<const PP*>(gamma + c);
    const PP bv = *reinterpret_cast<const PP*>(beta + c);
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

template <typename T, typename PT>
cudaError_t launch_add(const void* x, const void* h, const void* g,
                       const void* b, void* y, void* mean, void* rstd, int R,
                       int C, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t smem =
      static_cast<size_t>(kRowsPerBlock) * padded_cols(C) * sizeof(float);
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  const bool packed = C % kVec == 0 && aligned16(x) && aligned16(h) &&
                      aligned16(g) && aligned16(b) && aligned16(y);
  using Kernel = void (*)(const T*, const T*, const PT*, const PT*, T*,
                          float*, float*, int, int, float);
  Kernel kernel = add_ln_fwd_kernel<T, PT, 1>;
  if (packed) kernel = add_ln_fwd_kernel<T, PT, kVec>;
  const cudaError_t err = ptt_set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const PT*>(g), static_cast<const PT*>(b),
      static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), R, C, eps);
  return cudaSuccess;
}

// K8 for rows of type T with the scale and bias of the type pdtype names
// (f32 or bf16, either beside either row type).
template <typename T>
cudaError_t launch_add_params(int pdtype, const void* x, const void* h,
                              const void* g, const void* b, void* y,
                              void* mean, void* rstd, int R, int C, float eps,
                              cudaStream_t st) {
  if (pdtype == PTT_F32)
    return launch_add<T, float>(x, h, g, b, y, mean, rstd, R, C, eps, st);
  if (pdtype == PTT_BF16)
    return launch_add<T, __nv_bfloat16>(x, h, g, b, y, mean, rstd, R, C, eps,
                                        st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The row route (see launch_row for what it takes).
extern "C" int ptt_layer_norm_row(int dtype, const void* x,
                                  const void* gamma, const void* beta,
                                  void* y, void* mean, void* rstd, int R,
                                  int C, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = launch_row<float>(x, gamma, beta, y, mean, rstd, R, C, eps, st);
  } else if (dtype == PTT_BF16) {
    err = launch_row<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, R, C,
                                    eps, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

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

// dtype: the storage type of x, h and y; pdtype: that of the scale and
// bias (f32 or bf16, independently of dtype).
extern "C" int ptt_add_layer_norm(int dtype, int pdtype, const void* x,
                                  const void* h, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int R, int C, float eps,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = launch_add_params<float>(pdtype, x, h, gamma, beta, y, mean, rstd,
                                   R, C, eps, st);
  } else if (dtype == PTT_BF16) {
    err = launch_add_params<__nv_bfloat16>(pdtype, x, h, gamma, beta, y,
                                           mean, rstd, R, C, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
