// K4 on the CUDA cores: out = gelu(x @ w1 + b1) @ w2 + b2 in full f32
// (no TF32), the reference's numerics. The bf16 tensor-core route is in
// csrc/mlp.cu.
//
// Replaces paddle_tpu/ops/pallas/mlp.py:51 _mlp_kernel (launched by
// _mlp_pallas :92). The TPU kernel keeps an f32 [BN, Hout] accumulator in
// VMEM across a sequential grid axis over the intermediate dimension I, so
// the [R, I] activation never reaches HBM. Two routes here, chosen in the
// wrapper (ops/cuda/mlp.py mlp_route) by the rows: f32 at most 32 rows
// (serving's decode, draft and verify calls) and bf16 whose widths the
// tensor cores cannot take run "split"; f32 at more rows (prefill chunks,
// generate's prefill, the f32 crosschecks) runs "gemm".
//
// "split": one pass over I, bound by bytes. At 8 rows the call must read
//   the weights, 2 H I f32 values (18.9 MB at 768/3072), and does 16
//   operations a weight, far below the card's f32 ridge. So the I axis is
//   cut into `splits` slices (one block a slice and row tile, about one
//   block per SM; ops/cuda/mlp.py split_plan): block s owns I columns
//   [i0, i1), whole 8-column units, and walks them in sub-slices of at
//   most 32 (one, at serving's rows, where the plan gives a slice per
//   SM; more where many row tiles need fewer splits), streaming
//   W1[:, i0:i1] and W2[i0:i1, :] once through a cp.async ring of five or
//   six 32 KB stages (four or five in flight per SM: about 60 KB of W1
//   rows, more of W2's). For each sub-slice it computes the gelu
//   activation [RT, 32] in shared memory (never in device memory),
//   multiplies it into its f32 partial of the output, 256 columns a pass,
//   one column a thread with the RT row sums in registers, and writes the
//   partial (the first sub-slice) or adds to it (the thread's own
//   values, the sub-slices in order).
//   split_merge_kernel then sums the splits' partials in a fixed order
//   (eight fixed groups of splits, then the groups in order) and adds b2:
//   no atomics, the same sums every run. The row tile RT is 8, 16 or 32
//   (the rows, rounded up): at decode's 8 rows no row is padding. The
//   first product's threads are (k-group, 4 rows, 4 columns): a 16-byte
//   read of x and of W1 each feed four FMAs a value.
//
// "gemm": two passes, each a register-blocked SIMT GEMM, bound by
//   operations (2 R I (H + Hout) at 67 TFLOP/s f32):
//     pass 1  act = gelu(x @ w1 + b1)   an f32 [R, I] scratch (6.3 MB at
//                                       512 rows, which stays in L2; no
//                                       rounding is added)
//     pass 2  out = act @ w2 + b2       split over K where the tiles alone
//                                       leave SMs idle; the partials are
//                                       summed in split order with b2 by
//                                       gemm_reduce_kernel
//   A block computes a BM x 96 tile (BM = 128 or 64) with 256 threads,
//   each an (BM / 16) x 6 micro-tile: per four k, BM/16 16-byte reads of A
//   (rows padded so a warp's two rows fall on different banks) and 12
//   8-byte reads of B (a warp's 16 column pairs are one 128-byte row) feed
//   4 x (BM / 16) x 6 FMAs. Operand tiles of 32 k go through a cp.async ring
//   of four stages (BM = 64) or three (128), one barrier a stage (32 k
//   read 6 % faster than 16 k on the H100). Two blocks fit on an SM (at
//   most 128 registers a thread, 86 or 90 KB of shared memory), and an SM
//   with two runs the same work about 13 % faster than with one: the
//   plan (ops/cuda/mlp.py simt_gemm_plan) picks BM and pass 2's splits
//   from the waves they fill at the blocks an SM holds, which it reads
//   from ptt_mlp_gemm_resident (the occupancy calculator's count for
//   these tiles: two at either BM on the H100). At 512 x 768 x 3072,
//   pass 1's 64 x 96 tiles are 256 blocks and pass 2's 32 tiles of
//   128 x 96 split 8 ways are 256: one wave on 132 SMs each.
//
// Rows past R, columns past the widths and k past the depth arrive as
// zeros (load4 fills them), so every product over a tail is exact and no
// 0 * NaN can arise; stores are masked. The gelu is the exact erf form
// (the reference's approximate=False) in f32.

#include "common.cuh"

namespace {

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

// --------------------------------------------------------- split route

namespace split {

constexpr int kThreads = 256;
constexpr int kUnit = 8;       // I columns per unit of a split
constexpr int kCols = 32;      // the widest I slice of a block
constexpr int kKC = 128;       // H per stage of the first product
constexpr int kPass = 256;     // output columns per pass of the second

template <int RT>
struct Shape {
  // stages of the ring: as many as the SM's shared memory holds beside
  // the reduction, so that each block keeps five or more in flight
  static constexpr int kStages = RT == 8 ? 6 : 5;
  static constexpr int kXS = kKC + 4;       // padded x row of a stage
  static constexpr int kStageA = RT * kXS + kKC * kCols;
  static constexpr int kStageB = kCols * kPass;
  static constexpr int kStage = kStageA > kStageB ? kStageA : kStageB;
  static constexpr int kKG = 128 / RT;      // k-groups of the first product
  static constexpr int kKS = kKC / kKG;     // k of a group in a stage
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kStages) * kStage +
                       kKG * RT * kCols + RT * kCols);
};

template <typename T, int RT>
__global__ void __launch_bounds__(kThreads, 1)
    split_partial_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                         const T* __restrict__ b1, const T* __restrict__ w2,
                         float* __restrict__ part, int R, int H, int I,
                         int Hout, int splits) {
  using S = Shape<RT>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  constexpr int kStages = S::kStages;
  float* red = ring + kStages * S::kStage;       // [kKG][RT][kCols]
  float* a_s = red + S::kKG * RT * kCols;        // [RT][kCols]

  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int row0 = blockIdx.y * RT;
  const int rows = min(RT, R - row0);
  constexpr int kSubUnits = kCols / kUnit;
  const int units = (I + kUnit - 1) / kUnit;
  const int u0 = static_cast<int>(static_cast<long long>(s) * units /
                                  splits);
  const int u1 = static_cast<int>(static_cast<long long>(s + 1) * units /
                                  splits);
  const int n_a = (H + kKC - 1) / kKC;
  const int per = n_a + (Hout + kPass - 1) / kPass;   // steps a sub-slice
  const int steps = (u1 - u0 + kSubUnits - 1) / kSubUnits * per;
  // sub-slice `sub`'s first I column and width (1 .. kCols)
  auto first_col = [&](int sub) { return (u0 + sub * kSubUnits) * kUnit; };
  auto width = [&](int sub) {
    return min(I, min(u1, u0 + (sub + 1) * kSubUnits) * kUnit) -
           first_col(sub);
  };

  // a sub-slice's step < n_a: x [row0, +RT) x [k0, +kKC) and w1 [k0, +kKC)
  // x [i0, +32); else one pass of w2 [i0, +kr) x [c0, +kPass)
  auto load = [&](int gstep) {
    float* st = ring + (gstep % kStages) * S::kStage;
    const int sub = gstep / per, step = gstep % per;
    const int i0 = first_col(sub), iw = width(sub);
    if (step < n_a) {
      const int k0 = step * kKC;
      for (int c = tid; c < RT * (kKC / 4); c += kThreads) {
        const int r = c / (kKC / 4), k = k0 + 4 * (c % (kKC / 4));
        load4(st + r * S::kXS + (k - k0),
              x + static_cast<size_t>(row0 + r) * H + k,
              r < rows ? H - k : 0);
      }
      float* ws = st + RT * S::kXS;
      for (int c = tid; c < kKC * (kCols / 4); c += kThreads) {
        const int kk = c / (kCols / 4), col = 4 * (c % (kCols / 4));
        load4(ws + kk * kCols + col,
              w1 + static_cast<size_t>(k0 + kk) * I + i0 + col,
              k0 + kk < H ? iw - col : 0);
      }
    } else {
      const int c0 = (step - n_a) * kPass;
      const int kr = (iw + 3) & ~3;
      for (int c = tid; c < kr * (kPass / 4); c += kThreads) {
        const int k = c / (kPass / 4), col = c0 + 4 * (c % (kPass / 4));
        load4(st + k * kPass + (col - c0),
              w2 + static_cast<size_t>(i0 + k) * Hout + col,
              k < iw ? Hout - col : 0);
      }
    }
  };

  // first product: thread (kg, rg, cq) sums rows rg*4.. x columns cq*4..
  // over its k-group's kKS of each stage
  const int cq = tid % 8;
  const int rg = (tid / 8) % (RT / 4);
  const int kg = tid / (2 * RT);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
#pragma unroll 1
  for (int gstep = 0; gstep < steps; ++gstep) {
    cp_async_wait<kStages - 2>();
    __syncthreads();               // stage `gstep` landed; gstep-1 consumed
    if (gstep + kStages - 1 < steps) load(gstep + kStages - 1);
    cp_async_commit();
    const float* st = ring + (gstep % kStages) * S::kStage;
    const int sub = gstep / per, step = gstep % per;
    const int i0 = first_col(sub), iw = width(sub);
    if (step < n_a) {
      if (4 * cq < iw) {
        const float* xs = st + rg * 4 * S::kXS + kg * S::kKS;
        const float* ws = st + RT * S::kXS + kg * S::kKS * kCols + 4 * cq;
#pragma unroll
        for (int kk = 0; kk < S::kKS; kk += 4) {
          float4 xv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xv[i] = *reinterpret_cast<const float4*>(xs + i * S::kXS + kk);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            wv[u] = *reinterpret_cast<const float4*>(ws + (kk + u) * kCols);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xs4[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[i][0] = fmaf(xs4[u], wv[u].x, acc[i][0]);
              acc[i][1] = fmaf(xs4[u], wv[u].y, acc[i][1]);
              acc[i][2] = fmaf(xs4[u], wv[u].z, acc[i][2]);
              acc[i][3] = fmaf(xs4[u], wv[u].w, acc[i][3]);
            }
          }
        }
      }
      continue;
    }
    if (step == n_a) {
      // the k-groups' sums in a fixed order, bias, gelu: the activation
      // slice [RT, kCols], zero past iw and past the rows
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[(kg * RT + rg * 4 + i) * kCols + 4 * cq + j] = acc[i][j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;  // the next sub-slice
      __syncthreads();
      for (int e = tid; e < RT * kCols; e += kThreads) {
        const int r = e / kCols, c = e % kCols;
        float h = 0.f;
#pragma unroll
        for (int g = 0; g < S::kKG; ++g) h += red[(g * RT + r) * kCols + c];
        a_s[e] = (c < iw && r < rows) ? gelu_exact(h + to_f32(b1[i0 + c]))
                                      : 0.f;
      }
      __syncthreads();
    }
    // second product, one pass: column c0 + tid of the partial, all rows
    const int j = (step - n_a) * kPass + tid;
    float o[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) o[r] = 0.f;
    const float* ws = st + tid;
    const int kr = (iw + 3) & ~3;                 // iw to whole float4s
#pragma unroll 2
    for (int k = 0; k < kr; k += 4) {
      const float wk[4] = {ws[k * kPass], ws[(k + 1) * kPass],
                           ws[(k + 2) * kPass], ws[(k + 3) * kPass]};
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(a_s + r * kCols +
                                                            k);
        o[r] = fmaf(av.x, wk[0], o[r]);
        o[r] = fmaf(av.y, wk[1], o[r]);
        o[r] = fmaf(av.z, wk[2], o[r]);
        o[r] = fmaf(av.w, wk[3], o[r]);
      }
    }
    if (j < Hout) {
      float* p = part + (static_cast<size_t>(s) * R + row0) * Hout + j;
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r < rows) p[static_cast<size_t>(r) * Hout] =
            sub ? p[static_cast<size_t>(r) * Hout] + o[r] : o[r];
    }
  }
}

// out [r, j] = b2[j] + sum over the splits of part[s, r, j]: thread
// (g, c) sums splits g, g + 8, ... in order, then the eight groups are
// summed in order.
template <typename T>
__global__ void __launch_bounds__(256)
    split_merge_kernel(const float* __restrict__ part,
                       const T* __restrict__ b2, T* __restrict__ out, int R,
                       int Hout, int splits) {
  __shared__ float red[8][33];
  const int blocks_a_row = (Hout + 31) / 32;
  const int c = threadIdx.x % 32, g = threadIdx.x / 32;
  const int r = blockIdx.x / blocks_a_row;
  const int j = (blockIdx.x % blocks_a_row) * 32 + c;
  float s = 0.f;
  if (j < Hout)
    for (int p = g; p < splits; p += 8)
      s += part[(static_cast<size_t>(p) * R + r) * Hout + j];
  red[g][c] = s;
  __syncthreads();
  if (g == 0 && j < Hout) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += red[q][c];
    out[static_cast<size_t>(r) * Hout + j] = from_f32<T>(t + to_f32(b2[j]));
  }
}

template <typename T, int RT>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* part, void* out,
                   int R, int H, int I, int Hout, int splits,
                   cudaStream_t st) {
  constexpr size_t smem = Shape<RT>::kSmem;
  cudaError_t err = ptt_set_smem(split_partial_kernel<T, RT>, smem);
  if (err != cudaSuccess) return err;
  split_partial_kernel<T, RT>
      <<<dim3(splits, (R + RT - 1) / RT), kThreads, smem, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(w1),
          static_cast<const T*>(b1), static_cast<const T*>(w2),
          static_cast<float*>(part), R, H, I, Hout, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_merge_kernel<T><<<((Hout + 31) / 32) * R, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const T*>(b2),
      static_cast<T*>(out), R, Hout, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int rt, const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* part, void* out,
                     int R, int H, int I, int Hout, int splits,
                     cudaStream_t st) {
  switch (rt) {
    case 8:
      return launch<T, 8>(x, w1, b1, w2, b2, part, out, R, H, I, Hout,
                          splits, st);
    case 16:
      return launch<T, 16>(x, w1, b1, w2, b2, part, out, R, H, I, Hout,
                           splits, st);
    case 32:
      return launch<T, 32>(x, w1, b1, w2, b2, part, out, R, H, I, Hout,
                           splits, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace split

// ---------------------------------------------------------- gemm route

namespace gemm {

constexpr int kThreads = 256;
constexpr int kBK = 32;        // k per stage
constexpr int kBN = 96;        // tile columns
constexpr int kAS = kBK + 4;   // padded A row of a stage
enum Epi { kGelu = 0, kBias = 1, kPartial = 2 };

template <int BM>
struct Tile {
  static constexpr int kTM = BM / 16;    // rows of a thread
  static constexpr int kA = BM * kAS;
  static constexpr int kStage = kA + kBK * kBN;
  // as many stages as leave room for two blocks an SM (90 / 86 KB)
  static constexpr int kStages = BM == 64 ? 4 : 3;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
};

// c = epi(a [M, K] @ b [K, N]) over the k tiles of split blockIdx.z:
// kGelu c = gelu(. + bias), kBias c = . + bias, kPartial c[z] = .
template <int BM, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ bias, float* __restrict__ c,
                int M, int N, int K, int splits) {
  using Tl = Tile<BM>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int kts = (K + kBK - 1) / kBK;
  const int kt0 = static_cast<int>(static_cast<long long>(z) * kts / splits);
  const int kt1 =
      static_cast<int>(static_cast<long long>(z + 1) * kts / splits);
  const int nkt = kt1 - kt0;

  auto load = [&](int kt, int stage) {
    float* as = smem + stage * Tl::kStage;
    float* bs = as + Tl::kA;
    const int k0 = kt * kBK;
    for (int q = tid; q < BM * (kBK / 4); q += kThreads) {
      const int r = q / (kBK / 4), kq = 4 * (q % (kBK / 4));
      load4(as + r * kAS + kq,
            a + static_cast<size_t>(m0 + r) * K + k0 + kq,
            m0 + r < M ? K - (k0 + kq) : 0);
    }
    for (int q = tid; q < kBK * (kBN / 4); q += kThreads) {
      const int kk = q / (kBN / 4), nq = 4 * (q % (kBN / 4));
      load4(bs + kk * kBN + nq,
            b + static_cast<size_t>(k0 + kk) * N + n0 + nq,
            k0 + kk < K ? N - (n0 + nq) : 0);
    }
  };

  constexpr int kStages = Tl::kStages;
  float acc[Tl::kTM][6];
#pragma unroll
  for (int i = 0; i < Tl::kTM; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.f;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) load(kt0 + s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // tile `it` landed; it-1 consumed
    if (it + kStages - 1 < nkt)
      load(kt0 + it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const float* as = smem + (it % kStages) * Tl::kStage;
    const float* bs = as + Tl::kA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 av[Tl::kTM];
#pragma unroll
      for (int i = 0; i < Tl::kTM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kAS +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float2 bv[3];
#pragma unroll
        for (int g = 0; g < 3; ++g)
          bv[g] = *reinterpret_cast<const float2*>(bs + (kk + u) * kBN +
                                                   2 * tx + 32 * g);
#pragma unroll
        for (int i = 0; i < Tl::kTM; ++i) {
          const float x = u == 0 ? av[i].x
                          : u == 1 ? av[i].y
                          : u == 2 ? av[i].z
                                   : av[i].w;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            acc[i][2 * g] = fmaf(x, bv[g].x, acc[i][2 * g]);
            acc[i][2 * g + 1] = fmaf(x, bv[g].y, acc[i][2 * g + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < Tl::kTM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 2 * tx + 32 * g + e;
        if (col >= N) continue;
        const float v = acc[i][2 * g + e];
        if (kEpi == kGelu)
          c[static_cast<size_t>(row) * N + col] = gelu_exact(v + bias[col]);
        else if (kEpi == kBias)
          c[static_cast<size_t>(row) * N + col] = v + bias[col];
        else
          c[(static_cast<size_t>(z) * M + row) * N + col] = v;
      }
    }
  }
}

// out [i] = bias[i % N] + the splits' partials summed in split order
__global__ void gemm_reduce_kernel(const float* __restrict__ part,
                                   const float* __restrict__ bias,
                                   float* __restrict__ out, int M, int N,
                                   int splits) {
  const size_t n = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[static_cast<size_t>(p) * n + i];
  out[i] = s + bias[i % N];
}

template <int BM, int kEpi>
cudaError_t pass(const float* a, const float* b, const float* bias,
                 float* c, int M, int N, int K, int splits,
                 cudaStream_t st) {
  constexpr size_t smem = Tile<BM>::kSmem;
  cudaError_t err = ptt_set_smem_resident(gemm_kernel<BM, kEpi>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  gemm_kernel<BM, kEpi><<<grid, kThreads, smem, st>>>(a, b, bias, c, M, N,
                                                      K, splits);
  return cudaGetLastError();
}

template <int kEpi>
cudaError_t pass_bm(int bm, const float* a, const float* b,
                    const float* bias, float* c, int M, int N, int K,
                    int splits, cudaStream_t st) {
  if (bm == 128) return pass<128, kEpi>(a, b, bias, c, M, N, K, splits, st);
  if (bm == 64) return pass<64, kEpi>(a, b, bias, c, M, N, K, splits, st);
  return cudaErrorInvalidValue;
}

// the fewest blocks an SM holds of the three epilogues at tile rows BM
template <int BM>
cudaError_t resident(int* out) {
  constexpr size_t smem = Tile<BM>::kSmem;
  int n[3];
  cudaError_t err = ptt_resident_blocks(gemm_kernel<BM, kGelu>, kThreads,
                                        smem, &n[0]);
  if (err == cudaSuccess)
    err = ptt_resident_blocks(gemm_kernel<BM, kBias>, kThreads, smem, &n[1]);
  if (err == cudaSuccess)
    err = ptt_resident_blocks(gemm_kernel<BM, kPartial>, kThreads, smem,
                              &n[2]);
  *out = n[0];
  for (int e = 1; e < 3; ++e) *out = n[e] < *out ? n[e] : *out;
  return err;
}

}  // namespace gemm

}  // namespace

// The split route. x [R, H], w1 [H, I], b1 [I], w2 [I, Hout], b2 [Hout]
// of one storage type (f32 or bf16) -> out [R, Hout]; part an f32
// [splits, R, Hout] scratch; rt the row tile (8, 16 or 32).
extern "C" int ptt_mlp_split(int dtype, const void* x, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             void* part, void* out, int R, int H, int I,
                             int Hout, int rt, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = split::dispatch<float>(rt, x, w1, b1, w2, b2, part, out, R, H, I,
                                 Hout, splits, st);
  } else if (dtype == PTT_BF16) {
    err = split::dispatch<__nv_bfloat16>(rt, x, w1, b1, w2, b2, part, out,
                                         R, H, I, Hout, splits, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// *out = the blocks of the gemm route's kernel at tile rows bm (64 or 128)
// that one SM holds, the fewest of its epilogues (simt_gemm_plan's slots
// an SM).
extern "C" int ptt_mlp_gemm_resident(int bm, int* out) {
  if (bm == 128) return static_cast<int>(gemm::resident<128>(out));
  if (bm == 64) return static_cast<int>(gemm::resident<64>(out));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gemm route, f32. act an [R, I] scratch, part an [splits2, R, Hout]
// scratch when splits2 > 1; bm1 / bm2 the tile rows of pass 1 / 2.
extern "C" int ptt_mlp_gemm(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* act,
                            void* part, void* out, int R, int H, int I,
                            int Hout, int bm1, int bm2, int splits2,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x),
              *w1f = static_cast<const float*>(w1),
              *b1f = static_cast<const float*>(b1),
              *w2f = static_cast<const float*>(w2),
              *b2f = static_cast<const float*>(b2);
  float* actf = static_cast<float*>(act);
  float* outf = static_cast<float*>(out);
  cudaError_t err = gemm::pass_bm<gemm::kGelu>(bm1, xf, w1f, b1f, actf, R, I,
                                               H, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits2 <= 1)
    return static_cast<int>(gemm::pass_bm<gemm::kBias>(
        bm2, actf, w2f, b2f, outf, R, Hout, I, 1, st));
  float* partf = static_cast<float*>(part);
  err = gemm::pass_bm<gemm::kPartial>(bm2, actf, w2f, nullptr, partf, R,
                                      Hout, I, splits2, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(R) * Hout;
  gemm::gemm_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             st>>>(partf, b2f, outf, R, Hout, splits2);
  return static_cast<int>(cudaGetLastError());
}
