// K4: fused feed-forward out = gelu(x @ w1 + b1) @ w2 + b2.
//
// Replaces paddle_tpu/ops/pallas/mlp.py:51 _mlp_kernel (launched by
// _mlp_pallas :92). The TPU kernel carries an f32 [BN, Hout] accumulator
// across a sequential grid axis over the intermediate dimension I. Blocks
// on Hopper run in no order, so the I axis is split across blocks
// instead: block (row tile, split) computes the gelu activation of its
// own I slice, one 32-column chunk at a time, in shared memory, and
// multiplies it into an f32 [BN, Hout] partial. A second kernel sums the
// partials of the splits in a fixed order and adds b2 (deterministic, no
// atomics). The [R, I] activation never reaches device memory; only the
// [splits, R, Hout] partials do.
//
// What bounds it on the H100: at decode (R = 8 rows) the weights, 2*H*I
// values, are read once and the arithmetic is tiny, so it is bound by
// bytes; the split spreads that read over enough blocks to use the card,
// and each thread keeps kKU weight loads in flight. Shared-memory operands
// are read 4 wide, so a 16-byte load feeds four FMAs.
// At prefill (R = 512) it is bound by f32 FMAs. Products run on the CUDA
// cores in full f32 (no TF32), matching the reference's f32 numerics;
// tensor cores (wgmma) are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 16;                  // rows per tile
constexpr int kBI = 32;                  // intermediate columns per chunk
constexpr int kKG = kThreads / kBI;      // k-groups of the first product
constexpr int kKU = 16;                  // w1 loads in flight per thread

// exact erf gelu — must match the reference's gelu (approximate=False)
__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlp_partial_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                       const T* __restrict__ b1, const T* __restrict__ w2,
                       float* __restrict__ part, int R, int H, int I,
                       int Hout, int chunks_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                        // [kBN][kBI]
  float* red_s = a_s + kBN * kBI;           // [kKG][kBN][kBI]
  float* x_s = red_s + kKG * kBN * kBI;     // [kBN][H]
  float* acc_s = x_s + kBN * H;             // [kBN][Hout]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBN;
  const int rows = min(kBN, R - row0);
  const int split = blockIdx.y;

  // x tile, rows past R zeroed (the padded row tail of the TPU kernel)
  for (int i = tid; i < kBN * H; i += kThreads) {
    const int r = i / H, c = i - r * H;
    x_s[i] = r < rows ? to_f32(x[static_cast<size_t>(row0 + r) * H + c])
                      : 0.f;
  }
  for (int i = tid; i < kBN * Hout; i += kThreads) acc_s[i] = 0.f;
  __syncthreads();

  const int c = tid % kBI, kg = tid / kBI;
  // k range per group, a multiple of kKU so that x_s reads stay aligned
  const int kper = ((H + kKG - 1) / kKG + kKU - 1) / kKU * kKU;
  const int k0 = min(H, kg * kper), k1 = min(H, k0 + kper);
  const bool vec = (H & 3) == 0;            // x_s rows 16-byte aligned
  const int n_chunks = (I + kBI - 1) / kBI;
  const int ch0 = split * chunks_per_split;
  const int ch1 = min(n_chunks, ch0 + chunks_per_split);

  for (int ch = ch0; ch < ch1; ++ch) {
    const int i0 = ch * kBI;
    const int col = i0 + c;
    // first product: this thread's column over its k range, all rows
    float h[kBN];
#pragma unroll
    for (int r = 0; r < kBN; ++r) h[r] = 0.f;
    if (col < I) {
      int k = k0;
      if (vec) {
        // kKU independent weight loads in flight, then 4-wide x reads
        for (; k + kKU <= k1; k += kKU) {
          float w[kKU];
#pragma unroll
          for (int u = 0; u < kKU; ++u)
            w[u] = to_f32(w1[static_cast<size_t>(k + u) * I + col]);
#pragma unroll
          for (int r = 0; r < kBN; ++r) {
            const float4* xr =
                reinterpret_cast<const float4*>(x_s + r * H + k);
            float s = h[r];
#pragma unroll
            for (int u = 0; u < kKU / 4; ++u) {
              const float4 xv = xr[u];
              s += xv.x * w[4 * u] + xv.y * w[4 * u + 1] +
                   xv.z * w[4 * u + 2] + xv.w * w[4 * u + 3];
            }
            h[r] = s;
          }
        }
      }
      for (; k < k1; ++k) {
        const float w = to_f32(w1[static_cast<size_t>(k) * I + col]);
#pragma unroll
        for (int r = 0; r < kBN; ++r) h[r] += x_s[r * H + k] * w;
      }
    }
#pragma unroll
    for (int r = 0; r < kBN; ++r) red_s[(kg * kBN + r) * kBI + c] = h[r];
    __syncthreads();
    // sum the k-groups, bias, gelu; the padded I tail and rows past R
    // become exact zeros, so they add nothing to the second product
    for (int i = tid; i < kBN * kBI; i += kThreads) {
      const int r = i / kBI, cc = i - r * kBI;
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kKG; ++g) s += red_s[(g * kBN + r) * kBI + cc];
      const int ci = i0 + cc;
      a_s[i] = (ci < I && r < rows) ? gelu_exact(s + to_f32(b1[ci])) : 0.f;
    }
    __syncthreads();
    // second product: each thread owns whole output columns
    const int nvalid = min(kBI, I - i0);
    for (int j = tid; j < Hout; j += kThreads) {
      float w[kBI];
#pragma unroll
      for (int ii = 0; ii < kBI; ++ii)
        w[ii] = ii < nvalid
                    ? to_f32(w2[static_cast<size_t>(i0 + ii) * Hout + j])
                    : 0.f;
      for (int r = 0; r < rows; ++r) {
        float s = acc_s[r * Hout + j];
        const float4* ar = reinterpret_cast<const float4*>(a_s + r * kBI);
#pragma unroll
        for (int u = 0; u < kBI / 4; ++u) {
          const float4 av = ar[u];
          s += av.x * w[4 * u] + av.y * w[4 * u + 1] + av.z * w[4 * u + 2] +
               av.w * w[4 * u + 3];
        }
        acc_s[r * Hout + j] = s;
      }
    }
    __syncthreads();  // red_s / a_s are rewritten by the next chunk
  }

  for (int i = tid; i < rows * Hout; i += kThreads) {
    const int r = i / Hout, j = i - r * Hout;
    part[(static_cast<size_t>(split) * R + row0 + r) * Hout + j] =
        acc_s[r * Hout + j];
  }
}

template <typename T>
__global__ void mlp_reduce_kernel(const float* __restrict__ part,
                                  const T* __restrict__ b2,
                                  T* __restrict__ out, int R, int Hout,
                                  int nsplit) {
  const size_t n = static_cast<size_t>(R) * Hout;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < nsplit; ++p) s += part[static_cast<size_t>(p) * n + i];
  out[i] = from_f32<T>(s + to_f32(b2[i % Hout]));
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, void* part,
                   int R, int H, int I, int Hout, int nsplit,
                   int chunks_per_split, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBN) * H +
                       static_cast<size_t>(kBN) * Hout + kKG * kBN * kBI +
                       kBN * kBI);
  cudaError_t err = ptt_set_smem(mlp_partial_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kBN - 1) / kBN, nsplit);
  mlp_partial_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<float*>(part), R, H, I, Hout, chunks_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(R) * Hout;
  const int threads = 256;
  mlp_reduce_kernel<T><<<static_cast<unsigned>((n + threads - 1) / threads),
                         threads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const T*>(b2),
      static_cast<T*>(out), R, Hout, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_mlp_smem_bytes(int H, int Hout) {
  return static_cast<int>(sizeof(float) *
                          (kBN * H + kBN * Hout + kKG * kBN * kBI +
                           kBN * kBI));
}

extern "C" int ptt_mlp(int dtype, const void* x, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       void* out, void* part, int R, int H, int I, int Hout,
                       int nsplit, int chunks_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = launch<float>(x, w1, b1, w2, b2, out, part, R, H, I, Hout, nsplit,
                        chunks_per_split, st);
  } else if (dtype == PTT_BF16) {
    err = launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, part, R, H, I, Hout,
                                nsplit, chunks_per_split, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
