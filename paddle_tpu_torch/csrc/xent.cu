// K5 and K6: fused vocab cross-entropy, forward statistics and backward.
//
// Replaces paddle_tpu/ops/pallas/xent.py:49 _xent_fwd_kernel (K5, launched
// by xent_stats_pallas :99), :178 _xent_bwd_dh_kernel and :200
// _xent_bwd_dwb_kernel (K6, launched by xent_bwd_pallas :227). The logits
// h @ W^T + b ([N, V]) never reach device memory: each block recomputes
// its tiles of them in f32 and reduces them at once.
//
// One block shape serves all three kernels. A block keeps a RESIDENT tile
// of 32 rows of one operand ([32, H], f32, in shared memory) and STREAMS
// 64-row tiles of the other operand through it:
//   * xent_stats and xent_bwd_dh: resident rows of h, streamed rows of W;
//   * xent_bwd_dwb:               resident rows of W, streamed rows of h.
// The first product S = R X^T ([32, 64], K = H) gives the tile's logits
// (or their transpose). xent_stats reduces each row online to
// (m, s, picked, sum_logits), as the TPU kernel's revisited output block
// does. The backward turns S into the smoothed-CE dlogits
//   gch = (exp(logit - logz) - sn - (sp - sn) * onehot) * g
// (xent.py:156-175) and adds the second product gch X ([32, 64] x
// [64, H]) into an f32 [32, H] accumulator held in registers (96 values
// per thread at H = 768). The TPU kernels keep that accumulator as a
// [bn, H] / [bv, H] VMEM block revisited across a sequential grid axis;
// on Hopper a 64-row accumulator at H = 768 would fill shared memory, so
// the resident tile is 32 rows and the accumulator lives in registers.
//
// The streamed axis may be split across blocks (blockIdx.y) when the
// resident tiles alone are too few to fill the card: each split writes
// f32 partials, and a second kernel combines them in a fixed order
// (deterministic, no atomics), as csrc/mlp.cu does for its I axis.
//
// Semantics kept from the TPU kernels: the vocab tail is masked by the
// static V; a label outside [0, V) never hits; padded rows and vocab
// entries are zero-filled on load and their dlogits are zeros chosen by a
// select, never 0 * NaN. Statistics and gradients are f32 whatever the
// storage type (f32 or bf16).
//
// What bounds it on the H100: operations. xent_stats does 2*N*V*H, each
// backward kernel 4*N*V*H (the logits are recomputed), all here as f32
// FMAs on the CUDA cores. bf16 wgmma tiles fed by TMA are the later
// redesign (ROADMAP).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRes = 32;        // resident rows per block
constexpr int kStr = 64;        // streamed rows per tile
constexpr int kKC = 32;         // K chunk of the first product
constexpr int kBC = 8;          // streamed rows per chunk of the second
constexpr int kCols = 12;       // accumulator columns per thread
constexpr int kMaxH = 64 * kCols;
constexpr int kXS = kKC + 1;    // padded row of a first-product chunk
constexpr int kGS = kStr + 1;   // padded row of the dlogits tile

// Load the resident tile R[r0 : r0 + 32, :H] into res_s (row stride H + 1),
// rows past n as zeros.
template <typename T>
__device__ void load_resident(const T* __restrict__ R, int r0, int n, int H,
                              float* res_s) {
  const int rs = H + 1;
  for (int i = threadIdx.x; i < kRes * H; i += kThreads) {
    const int r = i / H, c = i - r * H;
    res_s[r * rs + c] =
        r0 + r < n ? to_f32(R[static_cast<size_t>(r0 + r) * H + c]) : 0.f;
  }
}

// First product: s[a][j] = sum_k res_s[2*ry + a][k] * X[x0 + sx + 16*j][k]
// with ry = tid / 16, sx = tid % 16; rows of X past n are zeros. X streams
// through xs in [64, kKC] chunks; the next chunk is loaded into registers
// while the current one is multiplied. Starts and ends with the block in
// step (a barrier before the first write of xs, none after the last read:
// callers sync before reusing xs).
template <typename T>
__device__ void first_product(const float* res_s, const T* __restrict__ X,
                              int x0, int n, int H, float* xs,
                              float s[2][4]) {
  constexpr int kPer = kStr * kKC / kThreads;   // 8 loads per thread
  const int tid = threadIdx.x;
  const int sx = tid & 15, ry = tid >> 4;
  const int rs = H + 1;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
  float pre[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / kKC, c = e - r * kKC;
      const int k = k0 + c;
      pre[u] = (x0 + r < n && k < H)
                   ? to_f32(X[static_cast<size_t>(x0 + r) * H + k])
                   : 0.f;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < H; k0 += kKC) {
    __syncthreads();                 // xs consumed by the previous chunk
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / kKC, c = e - r * kKC;
      xs[r * kXS + c] = pre[u];
    }
    __syncthreads();
    if (k0 + kKC < H) fetch(k0 + kKC);
    const float* r0p = res_s + (2 * ry) * rs + k0;
    const float* r1p = r0p + rs;
    const int kn = min(kKC, H - k0);
#pragma unroll 8
    for (int kk = 0; kk < kn; ++kk) {
      const float a0 = r0p[kk], a1 = r1p[kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = xs[(sx + 16 * j) * kXS + kk];
        s[0][j] += a0 * b;
        s[1][j] += a1 * b;
      }
    }
  }
}

// The smoothed-CE dlogits of one (row, col) entry; exactly 0 where the
// entry is padding (a select, so an overflowed exp is discarded).
__device__ __forceinline__ float dlogit(float logit, float logz, float g,
                                        bool hit, bool valid, float sn,
                                        float sp) {
  const float p = expf(logit - logz);
  const float v = (p - sn - (sp - sn) * (hit ? 1.f : 0.f)) * g;
  return valid ? v : 0.f;
}

// ------------------------------------------------------------- K5 stats

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_stats_kernel(const T* __restrict__ h, const T* __restrict__ w,
                      const float* __restrict__ bias,
                      const int* __restrict__ labels,
                      float* __restrict__ part, int N, int V, int H,
                      int tiles_per_split) {
  extern __shared__ float smem[];
  float* res_s = smem;                           // [kRes][H + 1]
  float* xs = res_s + kRes * (H + 1);            // [kStr][kXS]
  __shared__ float bias_s[kStr];
  __shared__ int lab_s[kRes];

  const int tid = threadIdx.x;
  const int sx = tid & 15, ry = tid >> 4;
  const int r0 = blockIdx.x * kRes;
  const int split = blockIdx.y;
  const int ntiles = (V + kStr - 1) / kStr;
  const int t0 = split * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);

  load_resident(h, r0, N, H, res_s);
  if (tid < kRes) lab_s[tid] = r0 + tid < N ? labels[r0 + tid] : -1;

  float m[2], se[2], pk[2], sl[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    m[a] = PTT_NEG_INF;
    se[a] = pk[a] = sl[a] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int v0 = t * kStr;
    __syncthreads();                 // bias_s of the previous tile read
    if (tid < kStr) {
      const int col = v0 + tid;
      bias_s[tid] = (col < V && bias != nullptr) ? bias[col] : 0.f;
    }
    float s[2][4];
    first_product(res_s, w, v0, V, H, xs, s);   // syncs before reading
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int lbl = lab_s[2 * ry + a];
      float lg[4], tmax = PTT_NEG_INF;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + sx + 16 * j;
        ok[j] = col < V;                          // the static-V tail mask
        lg[j] = s[a][j] + bias_s[sx + 16 * j];
        if (ok[j]) tmax = fmaxf(tmax, lg[j]);
      }
      const float mn = fmaxf(m[a], tmax);
      float acc = se[a] * expf(m[a] - mn);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!ok[j]) continue;
        acc += expf(lg[j] - mn);
        sl[a] += lg[j];
        if (v0 + sx + 16 * j == lbl) pk[a] += lg[j];   // never out of range
      }
      se[a] = acc;
      m[a] = mn;
    }
  }

  // combine the 16 threads of a row (one half-warp) with the online rule
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    for (int o = 8; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[a], o);
      const float so = __shfl_xor_sync(0xffffffffu, se[a], o);
      const float mn = fmaxf(m[a], mo);
      se[a] = se[a] * expf(m[a] - mn) + so * expf(mo - mn);
      m[a] = mn;
      pk[a] += __shfl_xor_sync(0xffffffffu, pk[a], o);
      sl[a] += __shfl_xor_sync(0xffffffffu, sl[a], o);
    }
    const int row = r0 + 2 * ry + a;
    if (sx == 0 && row < N) {
      float* p = part + static_cast<size_t>(split) * 4 * N;
      p[row] = m[a];
      p[N + row] = se[a];
      p[2 * N + row] = pk[a];
      p[3 * N + row] = sl[a];
    }
  }
}

// Combine the splits' (m, s, picked, sum_logits) in split order.
__global__ void xent_stats_combine_kernel(const float* __restrict__ part,
                                          float* __restrict__ out, int N,
                                          int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = PTT_NEG_INF;
  for (int p = 0; p < nsplit; ++p)
    m = fmaxf(m, part[static_cast<size_t>(p) * 4 * N + row]);
  float s = 0.f, pk = 0.f, sl = 0.f;
  for (int p = 0; p < nsplit; ++p) {
    const float* q = part + static_cast<size_t>(p) * 4 * N;
    s += q[N + row] * expf(q[row] - m);
    pk += q[2 * N + row];
    sl += q[3 * N + row];
  }
  out[row] = m;
  out[N + row] = s;
  out[2 * N + row] = pk;
  out[3 * N + row] = sl;
}

// ------------------------------------------------------------ K6 backward

// kRowsResident: dh (resident rows of h, streamed rows of W);
// otherwise dw/db (resident rows of W, streamed rows of h).
template <typename T, bool kRowsResident>
__global__ void __launch_bounds__(kThreads, 1)
    xent_bwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const float* __restrict__ bias,
                    const int* __restrict__ labels,
                    const float* __restrict__ logz,
                    const float* __restrict__ g, float* __restrict__ out,
                    float* __restrict__ db_out, int N, int V, int H,
                    int tiles_per_split, float sn, float sp) {
  extern __shared__ float smem[];
  float* res_s = smem;                              // [kRes][H + 1]
  float* g_s = res_s + kRes * (H + 1);              // [kRes][kGS]
  float* xs = g_s + kRes * kGS;        // [kStr][kXS] or [kBC][H]
  // per-row (logz, g, label) and per-column bias of the current tile
  __shared__ float rz_s[kRes > kStr ? kRes : kStr];
  __shared__ float rg_s[kRes > kStr ? kRes : kStr];
  __shared__ int rl_s[kRes > kStr ? kRes : kStr];
  __shared__ float cb_s[kRes > kStr ? kRes : kStr];

  const T* R = kRowsResident ? h : w;
  const T* X = kRowsResident ? w : h;
  const int nres = kRowsResident ? N : V;
  const int nstr = kRowsResident ? V : N;

  const int tid = threadIdx.x;
  const int sx = tid & 15, ry = tid >> 4;      // first-product layout
  const int cg = tid & 63, rg = tid >> 6;      // accumulator layout
  const int r0 = blockIdx.x * kRes;
  const int split = blockIdx.y;
  const int ntiles = (nstr + kStr - 1) / kStr;
  const int t0 = split * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);

  load_resident(R, r0, nres, H, res_s);
  if (kRowsResident) {
    if (tid < kRes) {
      const int row = r0 + tid;
      const bool ok = row < N;
      rz_s[tid] = ok ? logz[row] : 0.f;
      rg_s[tid] = ok ? g[row] : 0.f;
      rl_s[tid] = ok ? labels[row] : -1;
    }
  } else if (tid < kRes) {
    const int col = r0 + tid;
    cb_s[tid] = (col < V && bias != nullptr) ? bias[col] : 0.f;
  }

  float acc[8][kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  float dbacc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dbacc[i] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int x0 = t * kStr;
    __syncthreads();             // per-tile params of the previous tile read
    if (tid < kStr) {
      const int sidx = x0 + tid;
      if (kRowsResident) {
        cb_s[tid] = (sidx < V && bias != nullptr) ? bias[sidx] : 0.f;
      } else {
        const bool ok = sidx < N;
        rz_s[tid] = ok ? logz[sidx] : 0.f;
        rg_s[tid] = ok ? g[sidx] : 0.f;
        rl_s[tid] = ok ? labels[sidx] : -1;
      }
    }
    float s[2][4];
    first_product(res_s, X, x0, nstr, H, xs, s);
    // dlogits of the tile into g_s[resident][streamed]
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int ri = 2 * ry + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int si = sx + 16 * j;
        int row, col, lbl;
        float logit, z, gg;
        if (kRowsResident) {
          row = r0 + ri;
          col = x0 + si;
          logit = s[a][j] + cb_s[si];
          z = rz_s[ri];
          gg = rg_s[ri];
          lbl = rl_s[ri];
        } else {
          row = x0 + si;
          col = r0 + ri;
          logit = s[a][j] + cb_s[ri];
          z = rz_s[si];
          gg = rg_s[si];
          lbl = rl_s[si];
        }
        const bool valid = row < N && col < V;
        g_s[ri * kGS + si] =
            dlogit(logit, z, gg, col == lbl, valid, sn, sp);
      }
    }
    // second product: acc[rg*8 + i][cg + 64*j] += sum_s g_s[..][s] X[x0+s]
    for (int c0 = 0; c0 < kStr; c0 += kBC) {
      __syncthreads();           // g_s written / xs of the last chunk read
      for (int e = tid; e < kBC * H; e += kThreads) {
        const int r = e / H, c = e - r * H;
        const int xr = x0 + c0 + r;
        xs[e] = xr < nstr ? to_f32(X[static_cast<size_t>(xr) * H + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int sc = 0; sc < kBC; ++sc) {
        float xv[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = cg + 64 * j;
          xv[j] = c < H ? xs[sc * H + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float gv = g_s[(rg * 8 + i) * kGS + c0 + sc];
          if (!kRowsResident) dbacc[i] += gv;
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] += gv * xv[j];
        }
      }
    }
  }

  float* o = out + static_cast<size_t>(split) * nres * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + rg * 8 + i;
    if (r >= nres) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = cg + 64 * j;
      if (c < H) o[static_cast<size_t>(r) * H + c] = acc[i][j];
    }
    if (!kRowsResident && cg == 0)
      db_out[static_cast<size_t>(split) * V + r] = dbacc[i];
  }
}

// out[i] = sum over splits of part[p * n + i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t n,
                                  int nsplit) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < nsplit; ++p) s += part[static_cast<size_t>(p) * n + i];
  out[i] = s;
}

cudaError_t sum_splits(const float* part, float* out, size_t n, int nsplit,
                       cudaStream_t st) {
  const int threads = 256;
  sum_splits_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                      threads, 0, st>>>(part, out, n, nsplit);
  return cudaGetLastError();
}

size_t stats_smem(int H) {
  return sizeof(float) * (static_cast<size_t>(kRes) * (H + 1) + kStr * kXS);
}

size_t bwd_smem(int H) {
  const size_t chunk = static_cast<size_t>(kBC) * H > kStr * kXS
                           ? static_cast<size_t>(kBC) * H
                           : static_cast<size_t>(kStr) * kXS;
  return sizeof(float) *
         (static_cast<size_t>(kRes) * (H + 1) + kRes * kGS + chunk);
}

template <typename T>
cudaError_t stats_launch(const void* h, const void* w, const void* bias,
                         const void* labels, void* out, void* part, int N,
                         int V, int H, int nsplit, int tiles_per_split,
                         cudaStream_t st) {
  const size_t smem = stats_smem(H);
  cudaError_t err = ptt_set_smem(xent_stats_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  float* dst = nsplit == 1 ? static_cast<float*>(out)
                           : static_cast<float*>(part);
  const dim3 grid((N + kRes - 1) / kRes, nsplit);
  xent_stats_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels), dst,
      N, V, H, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  xent_stats_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), N, nsplit);
  return cudaGetLastError();
}

template <typename T, bool kRowsResident>
cudaError_t bwd_launch(const void* h, const void* w, const void* bias,
                       const void* labels, const void* logz, const void* g,
                       void* out, void* db, void* part, void* db_part, int N,
                       int V, int H, int nsplit, int tiles_per_split,
                       float sn, float sp, cudaStream_t st) {
  const size_t smem = bwd_smem(H);
  cudaError_t err = ptt_set_smem(xent_bwd_kernel<T, kRowsResident>, smem);
  if (err != cudaSuccess) return err;
  const int nres = kRowsResident ? N : V;
  float* dst = nsplit == 1 ? static_cast<float*>(out)
                           : static_cast<float*>(part);
  float* db_dst = nsplit == 1 ? static_cast<float*>(db)
                              : static_cast<float*>(db_part);
  const dim3 grid((nres + kRes - 1) / kRes, nsplit);
  xent_bwd_kernel<T, kRowsResident><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(logz), static_cast<const float*>(g), dst,
      db_dst, N, V, H, tiles_per_split, sn, sp);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  err = sum_splits(static_cast<const float*>(part), static_cast<float*>(out),
                   static_cast<size_t>(nres) * H, nsplit, st);
  if (err != cudaSuccess || kRowsResident) return err;
  return sum_splits(static_cast<const float*>(db_part),
                    static_cast<float*>(db), static_cast<size_t>(V), nsplit,
                    st);
}

}  // namespace

// h [N, H], w [V, H] (f32 or bf16, one dtype), bias [V] f32 or null,
// labels [N] int32 -> out [4, N] f32: (m, s, picked, sum_logits) per row.
// part [nsplit, 4, N] f32 scratch (unused when nsplit == 1).
extern "C" int ptt_xent_stats(int dtype, const void* h, const void* w,
                              const void* bias, const void* labels,
                              void* out, void* part, int N, int V, int H,
                              int nsplit, int tiles_per_split,
                              void* stream) {
  if (H > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = stats_launch<float>(h, w, bias, labels, out, part, N, V, H, nsplit,
                              tiles_per_split, st);
  } else if (dtype == PTT_BF16) {
    err = stats_launch<__nv_bfloat16>(h, w, bias, labels, out, part, N, V, H,
                                      nsplit, tiles_per_split, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// dh [N, H] f32 for the per-row cotangent g [N] f32 and the saved logz
// [N] f32. part [nsplit, N, H] f32 scratch (unused when nsplit == 1).
extern "C" int ptt_xent_bwd_dh(int dtype, const void* h, const void* w,
                               const void* bias, const void* labels,
                               const void* logz, const void* g, void* dh,
                               void* part, int N, int V, int H, int nsplit,
                               int tiles_per_split, float sn, float sp,
                               void* stream) {
  if (H > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = bwd_launch<float, true>(h, w, bias, labels, logz, g, dh, nullptr,
                                  part, nullptr, N, V, H, nsplit,
                                  tiles_per_split, sn, sp, st);
  } else if (dtype == PTT_BF16) {
    err = bwd_launch<__nv_bfloat16, true>(h, w, bias, labels, logz, g, dh,
                                          nullptr, part, nullptr, N, V, H,
                                          nsplit, tiles_per_split, sn, sp,
                                          st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// dw [V, H] and db [V], f32. part [nsplit, V, H] and db_part [nsplit, V]
// f32 scratch (unused when nsplit == 1).
extern "C" int ptt_xent_bwd_dwb(int dtype, const void* h, const void* w,
                                const void* bias, const void* labels,
                                const void* logz, const void* g, void* dw,
                                void* db, void* part, void* db_part, int N,
                                int V, int H, int nsplit,
                                int tiles_per_split, float sn, float sp,
                                void* stream) {
  if (H > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = bwd_launch<float, false>(h, w, bias, labels, logz, g, dw, db, part,
                                   db_part, N, V, H, nsplit,
                                   tiles_per_split, sn, sp, st);
  } else if (dtype == PTT_BF16) {
    err = bwd_launch<__nv_bfloat16, false>(h, w, bias, labels, logz, g, dw,
                                           db, part, db_part, N, V, H,
                                           nsplit, tiles_per_split, sn, sp,
                                           st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
