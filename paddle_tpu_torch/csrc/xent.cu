// K5 and K6: fused vocab cross-entropy, forward statistics and backward.
//
// Replaces paddle_tpu/ops/pallas/xent.py:49 _xent_fwd_kernel (K5, launched
// by xent_stats_pallas :99), :178 _xent_bwd_dh_kernel and :200
// _xent_bwd_dwb_kernel (K6, launched by xent_bwd_pallas :227). The logits
// h @ W^T + b ([N, V]) never reach device memory: each block recomputes
// its tiles of them and reduces them at once.
//
// Both backward kernels compute, per (row, vocab) entry, the smoothed-CE
// dlogits from the saved logz (xent.py:156-175)
//   gch = (exp(logit - logz) - sn - (sp - sn) * onehot) * g
// and reduce them against the other operand: dh = gch W, dw = gch^T h,
// db = column sums of gch. Two routes, chosen by the storage type:
//
// bf16 (the training path): tensor cores, xent_bwd_tc_kernel below.
//   A block owns a RESIDENT tile of 64 rows (h rows for dh, W rows for
//   dw/db) and one chunk of at most 512 columns of its output, and
//   streams 64-row tiles of the other operand. Per streamed tile, both
//   products are bf16 wgmma with f32 accumulators:
//     S = R X^T    [64, 64], K = H: the logits tile (dh) or its transpose
//                  (dw), split by columns over the two consumer warpgroups
//                  (m64n32 each), so it is computed once per chunk;
//     acc += gch X [64, chunk]: gch rounded to bf16 and staged once in
//                  shared memory (swizzled, the K-major A); X's columns
//                  of the chunk are the MN-major B. Each consumer
//                  warpgroup owns up to four 64-column slots of the chunk
//                  (128 f32 registers).
//   Why chunks and not all of H: a [64, H] f32 accumulator is 49,152
//   registers at H = 768 and 65,536 (the whole register file) at
//   H = 1024, so it cannot live in one block. H is split into the fewest
//   chunks of at most 512 columns across blocks, and each chunk
//   recomputes the logits: H = 768 or 1024 take 2 chunks, so the first
//   product runs twice and the kernel does 1.5x the 4 N V H operations of
//   the bound.
//   Copies: the resident tile (H/64 boxes of [64, 64]) arrives once by
//   TMA; the streamed tile arrives by TMA into a ring of 16 KB stages
//   (two boxes each) with full/empty mbarriers, fed by one producer
//   thread (warpgroup 2, registers given up by setmaxnreg). The chunk's
//   own boxes come last in each tile's K order and are held in the ring
//   until the second product has read them, so X is read once per chunk
//   (from L2) and serves both products: K-major for the first, MN-major
//   for the second (one 128-byte-swizzled layout is both; hopper.cuh).
//   Shared memory: H/64 + 2 x stages + 2 boxes of 8 KB; at H = 1024 the
//   resident tile is 128 KB and 5 stages fit, and H <= 1152 fits at all
//   (the ring must hold the chunk's boxes). db is summed from the f32
//   gch before the bf16 rounding; the bf16 gch adds one rounding (2^-9
//   relative) to each dlogit of the second product. exp is the
//   special-function unit's 2^x (ex2.approx, ~2^-22 relative).
//   What holds it back (PERF.md): the recomputed logits (1.5x the
//   operations), the 64-row resident tile that shared memory allows
//   (each tile's operands are re-read from L2 per 64 x 64 logits), and
//   the per-tile dlogit phase, in which the tensor cores wait.
//
// f32 with H % 4 == 0 and H <= 2048 (the f32 training path: the program
//   path, the crosschecks): 3xTF32 on the tensor cores,
//   xent_bwd_x3_kernel below. Both products are f32-accurate TF32 wgmma
//   (lo·hi + hi·lo + hi·hi, hopper.cuh): the bound is 4 N V H operations
//   at 165 TFLOP/s. The bf16 route's resident tile does not fit: [64, H]
//   in f32 with its lo part is 384 KB at H = 768. So a block owns 128
//   resident rows (64 a consumer warpgroup) and one chunk of 256 columns
//   of H, and the H / 256 blocks of one resident tile form a thread
//   block CLUSTER. Each block STREAMS both operands of the first product
//   over its own chunk of H only, a [64, 32] f32 box of each at a time
//   through a ring of 2 stages (R's two boxes and X's one, 24 KB, and
//   X's lo part). Once a stage arrives, the consumers split X's box in
//   place (hi in place, lo beside it) and stage it transposed (K-major,
//   as TF32 wgmma needs its B), hi and lo, into a [256, 64] X^T tile
//   (128 KB); R's box is split in registers, the first product's
//   register A. Per streamed tile of 64 rows each warpgroup computes
//     S_c = R X^T  [64, 64] over its chunk c of H (m64n64k8), then writes
//                  S_c to its shared memory; every block of the cluster
//                  reads all of them over distributed shared memory and
//                  sums them in rank order, so each holds the same
//                  S = R X^T over all of H (the logits computed once);
//     gch in f32 from S (db summed from it), split into hi and lo in
//                  registers: the register A of
//     acc += gch X [64, 256] (m64n256k8), B the staged X^T, whose K order
//                  is permuted to match the accumulator's column pairs
//                  (see the staging), so gch never passes through shared
//                  memory.
//   What holds it back (PERF.md §6): ptxas serializes every wgmma of
//   the kernel (its note C7512: too few registers beside the 128-register
//   accumulator), so the many small first-product wgmmas wait on each
//   other; the split and staging passes run on the CUDA cores. Blocks
//   that each recompute the whole S for their chunk were slower than the
//   cluster, and 192-column chunks (a 96-register accumulator, which
//   ptxas left asynchronous there) slower still.
// f32 with H % 4 != 0: CUDA cores, xent_bwd_kernel below. A RESIDENT tile
//   of 32 rows ([32, H] f32 in shared memory) against STREAMED 64-row
//   tiles; S = R X^T ([32, 64]) as f32 FMAs, then gch X added into an f32
//   [32, 768] register accumulator; H beyond 768 takes further column
//   chunks (blockIdx.z), each recomputing the logits.
//
// K5 reduces each row of the logits online to (m, s, picked, sum_logits),
// as the TPU kernel's revisited output block does. Two routes, chosen in
// the wrapper (ops/cuda/xent.py stats_route):
//
// bf16 with H % 8 == 0 (the training path): tensor cores, on the shared
//   mainloop of csrc/gemm.cuh (K-major B: the [V, H] table). A work item
//   is a 128-row tile of h and one split of the vocab; the mainloop
//   computes S = h W^T one [128, 256] tile at a time (f32 accumulators,
//   K = H) and the StatsEpi epilogue adds the f32 bias, masks the vocab
//   tail and folds the tile into each thread's running (m, s, picked,
//   sum) of its two rows, in registers; the item's end combines the four
//   lanes that share a row by quad shuffles. While a tile is reduced, the
//   producer already loads the next tile's boxes. No [64, H] tile is held
//   in shared memory, so this route has no H limit. Bound: 2 N V H
//   operations at 989 TFLOP/s; exp is ex2.approx (~2^-22 relative).
// f32 with H % 4 == 0: the same mainloop and epilogue with f32 operands
//   on 3xTF32 (gemm.cuh "f32 operands": boxes of 32 f32, each stage split
//   into hi and lo in shared memory, three tf32 wgmma a k8 step). Bound:
//   2 N V H operations at 165 TFLOP/s.
// Any other shape (f32 with H % 4 != 0, bf16 with H % 8 != 0): CUDA
//   cores, xent_stats_kernel below, the f32 block shape for both storage
//   types.
//
// The streamed axis may be split across blocks (the last grid axis) so
// that the grid fills the card in whole waves: each split writes f32
// partials and a second kernel combines them in a fixed order
// (deterministic, no atomics), as csrc/mlp.cu does for its I axis.
//
// Semantics kept from the TPU kernels: the vocab tail is masked by the
// static V; a label outside [0, V) never hits; padded rows and vocab
// entries are zero-filled on load and their dlogits are zeros chosen by a
// select, never 0 * NaN. Statistics and gradients are f32 whatever the
// storage type (f32 or bf16).
//
// What bounds it on the H100: operations (2 N V H for K5, 4 N V H for
// each backward kernel: 989 TFLOP/s in bf16 on the tensor cores, 165 for
// f32-accurate products as 3xTF32; the SIMT kernels' 67 on the CUDA cores
// is their own limit, not the card's).

#include "common.cuh"
#include "gemm.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRes = 32;        // resident rows per block
constexpr int kStr = 64;        // streamed rows per tile
constexpr int kKC = 32;         // K chunk of the first product
constexpr int kBC = 8;          // streamed rows per chunk of the second
constexpr int kCols = 12;       // accumulator columns per thread
constexpr int kChunk = 64 * kCols;   // output columns per f32 block
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
  const int col0 = blockIdx.z * kChunk;         // this block's columns
  const int cw = min(kChunk, H - col0);
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
    // second product: acc[rg*8 + i][cg + 64*j] += sum_s g_s[..][s]
    // X[x0+s][col0 + cg + 64*j]
    for (int c0 = 0; c0 < kStr; c0 += kBC) {
      __syncthreads();           // g_s written / xs of the last chunk read
      for (int e = tid; e < kBC * cw; e += kThreads) {
        const int r = e / cw, c = e - r * cw;
        const int xr = x0 + c0 + r;
        xs[e] = xr < nstr
                    ? to_f32(X[static_cast<size_t>(xr) * H + col0 + c])
                    : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int sc = 0; sc < kBC; ++sc) {
        float xv[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = cg + 64 * j;
          xv[j] = c < cw ? xs[sc * cw + c] : 0.f;
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
      if (c < cw) o[static_cast<size_t>(r) * H + col0 + c] = acc[i][j];
    }
    if (!kRowsResident && cg == 0 && blockIdx.z == 0)
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
  const size_t cols = H < kChunk ? H : kChunk;
  const size_t chunk = kBC * cols > kStr * kXS ? kBC * cols
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

// ---------------------------------- K5 stats, tensor-core routes (tc, x3)

// The epilogue of K5's tensor-core routes (see the header): each consumer
// thread keeps (m, s, picked, sum_logits) of its two rows over its
// columns, m and s in natural units, the exps as 2^x.
struct StatsEpi {
  static constexpr int kScratch = 0;
  const float* bias;
  const int* labels;
  float* out;              // [splits, 4, N]
  int N, V;
  int row, q2;
  float* dst;
  int lbl[2];
  float m[2], se[2], pk[2], sl[2];

  __device__ __forceinline__ void begin(int row0, int split, uint8_t*) {
    const int tid = threadIdx.x & 127;
    row = row0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
    q2 = 2 * (tid & 3);
    dst = out + static_cast<size_t>(split) * 4 * N;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = row + 8 * a;
      lbl[a] = r < N ? labels[r] : -1;
      m[a] = PTT_NEG_INF;
      se[a] = pk[a] = sl[a] = 0.f;
    }
  }

  template <int kN>
  __device__ __forceinline__ void prepare(int) {}

  // kTail: the tile reaches past V; its columns from V on are left out
  // (their W rows arrived as zeros, but the bias and the sums must not
  // see them, and a label >= V must not hit them).
  template <int kN, bool kTail>
  __device__ __forceinline__ void fold(float (&acc)[kN / 2], int n0) {
    float tmax[2] = {PTT_NEG_INF, PTT_NEG_INF};
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
      const int col = n0 + 8 * i + q2;
      float b[2] = {0.f, 0.f};
      if (bias != nullptr) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!kTail || col + e < V) b[e] = bias[col + e];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = acc[4 * i + 2 * a + e];
          v += b[e];
          if (!kTail || col + e < V) tmax[a] = fmaxf(tmax[a], v);
        }
    }
    float mz[2];
    int lc[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float mn = fmaxf(m[a], tmax[a]);
      se[a] *= hopper::ex2((m[a] - mn) * hopper::kLog2e);
      m[a] = mn;
      mz[a] = mn * hopper::kLog2e;
      lc[a] = lbl[a] - n0 - q2;          // hits column 8 i + e of the tile
    }
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kTail && n0 + 8 * i + q2 + e >= V) continue;
          const float v = acc[4 * i + 2 * a + e];
          se[a] += hopper::ex2(fmaf(v, hopper::kLog2e, -mz[a]));
          sl[a] += v;
          if (lc[a] == 8 * i + e) pk[a] += v;
        }
  }

  template <int kN>
  __device__ __forceinline__ void tile(float (&acc)[kN / 2], int n0) {
    if (n0 + kN <= V)
      fold<kN, false>(acc, n0);
    else
      fold<kN, true>(acc, n0);
  }

  __device__ __forceinline__ void end() {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[a], o);
        const float so = __shfl_xor_sync(0xffffffffu, se[a], o);
        const float mn = fmaxf(m[a], mo);
        se[a] = se[a] * hopper::ex2((m[a] - mn) * hopper::kLog2e) +
                so * hopper::ex2((mo - mn) * hopper::kLog2e);
        m[a] = mn;
        pk[a] += __shfl_xor_sync(0xffffffffu, pk[a], o);
        sl[a] += __shfl_xor_sync(0xffffffffu, sl[a], o);
      }
      const int r = row + 8 * a;
      if (q2 == 0 && r < N) {
        dst[r] = m[a];
        dst[N + r] = se[a];
        dst[2 * N + r] = pk[a];
        dst[3 * N + r] = sl[a];
      }
    }
    __syncwarp();           // converged again before the next wgmma
  }
};

constexpr int kStatsWidth = 256;   // vocab columns per tile (ops/cuda/xent.py)

// K5 on the mainloop: T = bf16 (the tc route) or f32 (3xTF32); H a
// multiple of 16 bytes of T.
template <typename T>
cudaError_t stats_tc_launch(const void* h, const void* w, const void* bias,
                            const void* labels, void* out, void* part, int N,
                            int V, int H, int nsplit, int tiles_per_split,
                            int grid, cudaStream_t st) {
  if (H % (16 / static_cast<int>(sizeof(T))) != 0 ||
      (reinterpret_cast<uintptr_t>(h) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return cudaErrorInvalidValue;
  gemm::Sched s;
  s.M = N;
  s.N = V;
  s.K = H;
  s.splits = nsplit;
  s.per = tiles_per_split;
  s.items = (N + gemm::kTileRows - 1) / gemm::kTileRows * nsplit;
  StatsEpi epi;
  epi.bias = static_cast<const float*>(bias);
  epi.labels = static_cast<const int*>(labels);
  epi.out = static_cast<float*>(nsplit == 1 ? out : part);
  epi.N = N;
  epi.V = V;
  cudaError_t err =
      gemm::launch<kStatsWidth, true, StatsEpi, T>(h, w, s, grid, epi, st);
  if (err != cudaSuccess || nsplit == 1) return err;
  xent_stats_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), N, nsplit);
  return cudaGetLastError();
}

template <bool kRowsResident>
cudaError_t bwd_launch(const void* h, const void* w, const void* bias,
                       const void* labels, const void* logz, const void* g,
                       void* out, void* db, void* part, void* db_part, int N,
                       int V, int H, int nsplit, int tiles_per_split,
                       int nchunks, float sn, float sp, cudaStream_t st) {
  const size_t smem = bwd_smem(H);
  cudaError_t err = ptt_set_smem(xent_bwd_kernel<float, kRowsResident>,
                                 smem);
  if (err != cudaSuccess) return err;
  const int nres = kRowsResident ? N : V;
  float* dst = nsplit == 1 ? static_cast<float*>(out)
                           : static_cast<float*>(part);
  float* db_dst = nsplit == 1 ? static_cast<float*>(db)
                              : static_cast<float*>(db_part);
  const dim3 grid((nres + kRes - 1) / kRes, nsplit, nchunks);
  xent_bwd_kernel<float, kRowsResident><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(logz), static_cast<const float*>(g), dst,
      db_dst, N, V, H, tiles_per_split, sn, sp);
  return cudaGetLastError();
}

// ------------------------------------------- K6 backward, bf16 wgmma route

namespace tc {

using hopper::kBoxBytes;
constexpr int kRows = 64;          // resident rows per block (wgmma M)
constexpr int kMaxSlots = 4;       // 64-column output slots per warpgroup
constexpr int kThreads = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int kStageBytes = 2 * kBoxBytes;   // a ring stage: two boxes
constexpr int kMaxPairs = 16;      // stages per streamed tile, at most

// Output slots per warpgroup for H (the Python plan's arithmetic): the
// fewest chunks of at most 2 x 4 boxes, then the fewest slots per chunk.
int slots_for(int H) {
  const int nk = (H + 63) / 64;
  const int chunks = (nk + 2 * kMaxSlots - 1) / (2 * kMaxSlots);
  const int per_chunk = (nk + chunks - 1) / chunks;
  return (per_chunk + 1) / 2;
}

struct Params {
  const float* bias;
  const int* labels;
  const float* logz;
  const float* g;
  float* out;
  float* db_out;
  int N, V, H, tiles_per_split, stages;
  float sn, sp;
};

size_t smem_bytes(int H, int stages) {
  const size_t boxes = (H + 63) / 64 + 2 * stages + 2;
  return 1024 + boxes * kBoxBytes + (2 * stages + 1) * 8 + kRows * 4 +
         kMaxPairs * 8;
}

// exp is hopper::ex2 (~2^-22 relative; the bf16 rounding of gch that
// follows is 2^-9); the ring position is hopper::Ring.
using hopper::ex2;
using hopper::kLog2e;
using hopper::Ring;

// kRowsResident: dh (resident rows of h, streamed rows of W); otherwise
// dw/db (resident rows of W, streamed rows of h). Each warpgroup owns
// kSlots 64-column slots of a chunk of 2 kSlots boxes. Grid: (resident
// tiles, output chunks, splits of the streamed axis).
template <bool kRowsResident, int kSlots>
__global__ void __launch_bounds__(kThreads, 1)
    xent_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_res,
                       const __grid_constant__ CUtensorMap tm_str,
                       const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nk = (p.H + 63) / 64;
  uint8_t* res_s = base;                          // nk boxes
  uint8_t* ring = res_s + nk * kBoxBytes;         // `stages` x 2 boxes
  uint8_t* gch_s = ring + p.stages * kStageBytes; // 2 boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(gch_s + 2 * kBoxBytes);
  uint64_t* empty = full + p.stages;
  uint64_t* res_full = empty + p.stages;
  float* db_s = reinterpret_cast<float*>(res_full + 1);
  int2* pairs = reinterpret_cast<int2*>(db_s + kRows);

  const int nres = kRowsResident ? p.N : p.V;
  const int nstr = kRowsResident ? p.V : p.N;
  const int r0 = blockIdx.x * kRows;
  const int chunk = blockIdx.y;
  const int split = blockIdx.z;
  const int ntiles = (nstr + 63) / 64;
  const int t0 = split * p.tiles_per_split;
  const int t1 = min(ntiles, t0 + p.tiles_per_split);
  const int kw0 = chunk * 2 * kSlots;              // the chunk's boxes
  const int kw1 = min(nk, kw0 + 2 * kSlots);
  const int nwin = kw1 - kw0;

  // One streamed tile's boxes in the order they pass through the ring,
  // two per stage: the boxes outside the chunk [kw1, nk) + [0, kw0), then
  // the chunk's own [kw0, kw1) (held for the second product). A part of
  // odd length ends with the box at column nk * 64, wholly past H: TMA
  // fills it with zeros, so the R box it meets adds 0.
  const int np0 = (nk - nwin + 1) / 2;            // stages outside the chunk
  const int npairs = np0 + (nwin + 1) / 2;
  if (threadIdx.x == 0) {
    int k = kw1 == nk ? 0 : kw1;
    for (int part = 0, g = 0; part < 2; ++part) {
      const int len = part == 0 ? nk - nwin : nwin;
      for (int i = 0; i < len; i += 2, ++g) {
        const int ka = k;
        if (++k == nk) k = 0;
        int kb = nk;
        if (i + 1 < len) {
          kb = k;
          if (++k == nk) k = 0;
        }
        pairs[g] = make_int2(ka, kb);
      }
    }
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 8);       // one arrival per consumer warp
    }
    hopper::mbar_init(res_full, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(res_full, nk * kBoxBytes);
      for (int k = 0; k < nk; ++k)
        hopper::tma_load_2d(res_s + k * kBoxBytes, &tm_res, res_full,
                            k * 64, r0);
      // per streamed tile, the boxes in the consumers' K order: the
      // chunk's own boxes [kw0, kw1) last
      Ring w(p.stages);
      for (int t = t0; t < t1; ++t) {
        for (int g = 0; g < npairs; ++g) {
          const int2 kp = pairs[g];
          uint8_t* dst = ring + w.stage * kStageBytes;
          hopper::mbar_wait(empty + w.stage, w.phase ^ 1);
          hopper::mbar_expect_tx(full + w.stage, kStageBytes);
          hopper::tma_load_2d(dst, &tm_str, full + w.stage, kp.x * 64,
                              t * 64);
          hopper::tma_load_2d(dst + kBoxBytes, &tm_str, full + w.stage,
                              kp.y * 64, t * 64);
          w.next();
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    hopper::reg_alloc<232>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int rr0 = 16 * warp + (lane >> 2);   // rows rr0 and rr0 + 8
    const int q4 = lane & 3;
    auto release = [&](int st) {               // this warp is done with st
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + st);
    };

    // per resident row: (logz, g, label) for dh, the bias for dw/db
    float rz[2], rg[2], rb[2];
    int rl[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = r0 + rr0 + 8 * a;
      const bool ok = row < nres;
      if (kRowsResident) {
        rz[a] = ok ? p.logz[row] * kLog2e : 0.f;      // logz in log2 units
        rg[a] = ok ? p.g[row] : 0.f;
        rl[a] = ok ? p.labels[row] : -1;
        rb[a] = 0.f;
      } else {
        rb[a] = (ok && p.bias != nullptr) ? p.bias[row] : 0.f;
        rz[a] = rg[a] = 0.f;
        rl[a] = -1;
      }
    }

    float acc[kSlots][32];
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
    float dbacc[2] = {0.f, 0.f};

    hopper::mbar_wait(res_full, 0);
    Ring r(p.stages);
    for (int t = t0; t < t1; ++t) {
      const int x0 = t * 64;
      // per streamed index of this thread's 8 columns of S: the bias for
      // dh; (logz, g, label) for dw/db. Loaded before the first product.
      float cz[8], cg[8], cb[8];
      int cl[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * i + e;
          const int idx = x0 + 32 * wg + 8 * i + 2 * q4 + e;
          const bool ok = idx < nstr;
          if (kRowsResident) {
            cb[j] = (ok && p.bias != nullptr) ? p.bias[idx] : 0.f;
            cz[j] = cg[j] = 0.f;
            cl[j] = -1;
          } else {
            cz[j] = ok ? p.logz[idx] * kLog2e : 0.f;
            cg[j] = ok ? p.g[idx] : 0.f;
            cl[j] = ok ? p.labels[idx] : -1;
            cb[j] = 0.f;
          }
        }

      // first product: S[:, 32 wg : 32 wg + 32] = R X^T over K = H
      float s[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
      int prev = -1, win = 0;
      for (int g = 0; g < npairs; ++g) {
        const int st = r.stage;
        if (g == np0) win = st;              // the chunk's first stage
        const int2 kp = pairs[g];
        hopper::mbar_wait(full + st, r.phase);
        const uint8_t* a0 = res_s + kp.x * kBoxBytes;
        const uint8_t* a1 = res_s + (kp.y < nk ? kp.y : 0) * kBoxBytes;
        const uint8_t* b = ring + st * kStageBytes + wg * 32 * 128;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n32k16_kk(s, hopper::desc_sw128(a0 + 32 * kk),
                                     hopper::desc_sw128(b + 32 * kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n32k16_kk(
              s, hopper::desc_sw128(a1 + 32 * kk),
              hopper::desc_sw128(b + kBoxBytes + 32 * kk));
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        // the previous stage is read; free it unless the chunk holds it
        if (prev >= 0 && g - 1 < np0) release(prev);
        prev = st;
        r.next();
      }
      hopper::wgmma_wait<0>();

      // gch in f32 -> db partial sums; bf16 into the K-major A tile
      uint8_t* gbuf = gch_s + ((t - t0) & 1) * kBoxBytes;
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int rr = rr0 + 8 * a;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 2 * i + e;
            const int cc = 32 * wg + 8 * i + 2 * q4 + e;
            int row, col, lbl;
            float logit = s[4 * i + 2 * a + e], z, gg;
            if (kRowsResident) {
              row = r0 + rr;
              col = x0 + cc;
              logit += cb[j];
              z = rz[a];
              gg = rg[a];
              lbl = rl[a];
            } else {
              row = x0 + cc;
              col = r0 + rr;
              logit += rb[a];
              z = cz[j];
              gg = cg[j];
              lbl = cl[j];
            }
            // dlogit() with exp(logit - logz) = 2^(logit log2e - z)
            const float pr = ex2(fmaf(logit, kLog2e, -z));
            const float hit = col == lbl ? 1.f : 0.f;
            const float d = (pr - p.sn - (p.sp - p.sn) * hit) * gg;
            v[e] = (row < p.N && col < p.V) ? d : 0.f;
            rsum[a] += v[e];
          }
          const int box16 = (4 * wg + i) ^ (rr & 7);   // 128-byte swizzle
          *reinterpret_cast<__nv_bfloat162*>(gbuf + rr * 128 + box16 * 16 +
                                             4 * q4) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      if (!kRowsResident) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          rsum[a] += __shfl_xor_sync(0xffffffffu, rsum[a], 1);
          rsum[a] += __shfl_xor_sync(0xffffffffu, rsum[a], 2);
          dbacc[a] += rsum[a];
        }
      }
      hopper::fence_async_shared();
      hopper::named_barrier(1, 256);      // both halves of gch written

      // second product: acc[slot] += gch X[:, box kw0 + 2 slot + wg].
      // A slot past the chunk's last box (a narrower last chunk) reads
      // that box and is never stored: the wgmma stays unconditional, so
      // ptxas keeps the products asynchronous.
      // window box j: stage win + j / 2, box j % 2 of it
      int bst[kSlots];
#pragma unroll
      for (int slot = 0; slot < kSlots; ++slot) {
        const int j = min(2 * slot + wg, nwin - 1);
        const int st = win + j / 2;
        bst[slot] = (st >= p.stages ? st - p.stages : st) * 2 + (j & 1);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da = hopper::desc_sw128(gbuf + 32 * ks);
#pragma unroll
        for (int slot = 0; slot < kSlots; ++slot)
          hopper::wgmma_m64n64k16_ss<1>(
              acc[slot], da,
              hopper::desc_sw128(ring + bst[slot] * kBoxBytes + 2048 * ks),
              1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      for (int j = np0, st = win; j < npairs; ++j) {
        release(st);
        if (++st == p.stages) st = 0;
      }
    }

    // epilogue: this warpgroup's slots of the chunk, f32
    float* o = p.out + static_cast<size_t>(split) * nres * p.H;
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const int box = kw0 + 2 * slot + wg;
      if (box >= kw1) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int row = r0 + rr0 + 8 * a;
          const int col = box * 64 + 8 * i + 2 * q4;
          if (row < nres && col < p.H)
            *reinterpret_cast<float2*>(o + static_cast<size_t>(row) * p.H +
                                       col) =
                make_float2(acc[slot][4 * i + 2 * a],
                            acc[slot][4 * i + 2 * a + 1]);
        }
    }
    if (!kRowsResident && chunk == 0) {
      // db of the block's rows: warpgroup 0's sum plus warpgroup 1's
      if (wg == 1 && q4 == 0) {
        db_s[rr0] = dbacc[0];
        db_s[rr0 + 8] = dbacc[1];
      }
      hopper::named_barrier(2, 256);
      if (wg == 0 && q4 == 0)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int row = r0 + rr0 + 8 * a;
          if (row < p.V)
            p.db_out[static_cast<size_t>(split) * p.V + row] =
                dbacc[a] + db_s[rr0 + 8 * a];
        }
    }
  }
}

template <bool kRowsResident, int kSlots>
cudaError_t launch_slots(const void* h, const void* w, const void* bias,
                         const void* labels, const void* logz, const void* g,
                         void* out, void* db, void* part, void* db_part,
                         int N, int V, int H, int nsplit,
                         int tiles_per_split, int nchunks, int stages,
                         float sn, float sp, cudaStream_t st) {
  // the shapes the Python plan guarantees (ops/cuda/xent.py tc_plan)
  const int nk = (H + 63) / 64;
  if (H % 8 != 0 || (reinterpret_cast<uintptr_t>(h) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15) ||
      nchunks * 2 * kSlots < nk || nk > 2 * kMaxPairs - 2 ||
      stages < ((nk < 2 * kSlots ? nk : 2 * kSlots) + 1) / 2)
    return cudaErrorInvalidValue;
  CUtensorMap tm_h, tm_w;
  cudaError_t err = hopper::encode_bf16_boxes(&tm_h, h, N, H);
  if (err != cudaSuccess) return err;
  err = hopper::encode_bf16_boxes(&tm_w, w, V, H);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(H, stages);
  err = ptt_set_smem(xent_bwd_tc_kernel<kRowsResident, kSlots>, smem);
  if (err != cudaSuccess) return err;
  const int nres = kRowsResident ? N : V;
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const int*>(labels);
  p.logz = static_cast<const float*>(logz);
  p.g = static_cast<const float*>(g);
  p.out = static_cast<float*>(nsplit == 1 ? out : part);
  p.db_out = static_cast<float*>(nsplit == 1 ? db : db_part);
  p.N = N;
  p.V = V;
  p.H = H;
  p.tiles_per_split = tiles_per_split;
  p.stages = stages;
  p.sn = sn;
  p.sp = sp;
  const dim3 grid((nres + kRows - 1) / kRows, nchunks, nsplit);
  xent_bwd_tc_kernel<kRowsResident, kSlots><<<grid, kThreads, smem, st>>>(
      kRowsResident ? tm_h : tm_w, kRowsResident ? tm_w : tm_h, p);
  return cudaGetLastError();
}

template <bool kRowsResident>
cudaError_t launch(const void* h, const void* w, const void* bias,
                   const void* labels, const void* logz, const void* g,
                   void* out, void* db, void* part, void* db_part, int N,
                   int V, int H, int nsplit, int tiles_per_split,
                   int nchunks, int stages, float sn, float sp,
                   cudaStream_t st) {
  switch (slots_for(H)) {
#define PTT_SLOTS(k)                                                       \
  case k:                                                                  \
    return launch_slots<kRowsResident, k>(h, w, bias, labels, logz, g, out, \
                                          db, part, db_part, N, V, H,      \
                                          nsplit, tiles_per_split, nchunks, \
                                          stages, sn, sp, st);
    PTT_SLOTS(1)
    PTT_SLOTS(2)
    PTT_SLOTS(3)
    PTT_SLOTS(4)
#undef PTT_SLOTS
  }
  return cudaErrorInvalidValue;
}

}  // namespace tc

// ------------------------------------------ K6 backward, 3xTF32 f32 route

namespace x3 {

using hopper::kBoxBytes;
using hopper::kLog2e;
constexpr int kRows = 128;         // resident rows per block: 64 a warpgroup
constexpr int kStr = 64;           // streamed rows per tile
constexpr int kCols = 256;         // output columns per block: one chunk
constexpr int kBoxK = 32;          // f32 columns of a box
constexpr int kChunkBoxes = kCols / kBoxK;
constexpr int kThreads = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int kLoad = 3 * kBoxBytes;     // a stage's boxes: R's two, X's
constexpr int kStage = 4 * kBoxBytes;    // ... and X's lo part
constexpr int kStages = 2;
constexpr int kMaxCluster = 8;           // chunks a resident tile, at most
// streamed tiles a block sums on the tensor cores before it adds its
// accumulator into its output region (see the kernel's note)
constexpr int kFlush = 16;
constexpr int kHalf = kCols * 128;       // X^T rows at 32 of K: 32 KB
constexpr int kStaged = 4 * kHalf;       // hi K 0-31, hi 32-63, lo, lo
constexpr int kSx = 2 * 32 * 128 * 4;    // a block's partial S: 32 KB
constexpr size_t kSmem = 1024 + kStages * kStage + kStaged + kSx +
                         4 * kStr * 4 + (2 * kStages + 2) * 8;
static_assert(kSmem <= 232448, "x3 tiles exceed a block's shared memory");

struct Params {
  const float* bias;
  const int* labels;
  const float* logz;
  const float* g;
  float* out;
  float* db_out;
  int N, V, H, tiles_per_split;
  float sn, sp;
};

// The staged X^T's K position of streamed row `srow` of a tile, within
// its 32-row half: the k8 slice srow / 8 keeps its place, and inside it
// row 2 j goes to position j and row 2 j + 1 to j + 4. The register A
// fragment of a k8 slice (hopper.cuh) then holds gch's columns 2 (l % 4)
// and 2 (l % 4) + 1 at positions l % 4 and l % 4 + 4: exactly the column
// pair that the first product's accumulator gives the same thread.
__device__ __forceinline__ int staged_k(int srow) {
  const int q = srow & 7;
  return (srow & 24) + ((q >> 1) | ((q & 1) << 2));
}

// kRowsResident: dh (resident rows of h, streamed rows of W); otherwise
// dw/db (resident rows of W, streamed rows of h). Grid: (output chunks of
// 256 columns, resident tiles of 128, splits of the streamed axis); the
// chunks of a resident tile and split are one cluster, which every block
// of it leaves only once the others have read its partial logits.
// The second product's sum runs over the whole streamed axis, and the
// tensor cores' f32 accumulation loses accuracy with its length (PERF.md
// §6: summed over 500 tiles on the tensor cores alone, dh's rows that no
// label reaches came 2.1e-4 of their scale from the plain version, 1.1e-4
// over 250): so every kFlush tiles a block adds its accumulator
// into its own output region (f32 adds, rounded to nearest; the first
// time a store) and starts again from zero.
template <bool kRowsResident>
__global__ void __launch_bounds__(kThreads, 1)
    xent_bwd_x3_kernel(const __grid_constant__ CUtensorMap tm_res,
                       const __grid_constant__ CUtensorMap tm_str,
                       const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xt = ring + kStages * kStage;          // the staged X^T
  float* sx = reinterpret_cast<float*>(xt + kStaged);     // partial S
  float* cpar = sx + kSx / 4;                              // [4][kStr]
  int* clab = reinterpret_cast<int*>(cpar + 2 * kStr);
  uint64_t* full = reinterpret_cast<uint64_t*>(cpar + 4 * kStr);
  uint64_t* empty = full + kStages;
  uint64_t* sx_full = empty + kStages;    // the cluster's partials written
  uint64_t* sx_free = sx_full + 1;        // ... and read

  const int nres = kRowsResident ? p.N : p.V;
  const int nstr = kRowsResident ? p.V : p.N;
  const int r0 = blockIdx.y * kRows;
  const int chunk = hopper::cluster_rank();       // == blockIdx.x
  const uint32_t nclus = gridDim.x;               // the cluster: all chunks
  const int split = blockIdx.z;
  const int ntiles = (nstr + kStr - 1) / kStr;
  const int t0 = split * p.tiles_per_split;
  const int t1 = min(ntiles, t0 + p.tiles_per_split);
  const int nk = (p.H + kBoxK - 1) / kBoxK;       // boxes along H
  const int kb0 = chunk * kChunkBoxes;            // the chunk's boxes
  const int kb1 = min(nk, kb0 + kChunkBoxes);
  const int nkc = kb1 - kb0;                      // k-steps a tile

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 8);     // one arrival per consumer warp
    }
    // one arrival per consumer thread of every block of the cluster
    hopper::mbar_init(sx_full, 256 * nclus);
    hopper::mbar_init(sx_free, 256 * nclus);
    hopper::mbar_fence_init();
  }
  hopper::cluster_sync();           // the cluster's barriers initialised

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // --------------------------------------------------------- producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      hopper::Ring w(kStages);
      for (int t = t0; t < t1; ++t) {
        for (int kb = kb0; kb < kb1; ++kb) {
          uint8_t* dst = ring + w.stage * kStage;
          uint64_t* bar = full + w.stage;
          hopper::mbar_wait(empty + w.stage, w.phase ^ 1);
          hopper::mbar_expect_tx(bar, kLoad);
          hopper::tma_load_2d(dst, &tm_res, bar, kb * kBoxK, r0);
          hopper::tma_load_2d(dst + kBoxBytes, &tm_res, bar, kb * kBoxK,
                              r0 + 64);
          hopper::tma_load_2d(dst + 2 * kBoxBytes, &tm_str, bar,
                              kb * kBoxK, t * kStr);
          w.next();
        }
      }
    }
  } else {
    // -------------------------------------------------------- consumers
    hopper::reg_alloc<232>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int rr0 = 64 * wg + 16 * warp + (lane >> 2);   // rows rr0, +8
    const int q4 = lane & 3;
    auto release = [&](int st) {           // this warp is done with st
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + st);
    };
    // per resident row: (logz, g, label) for dh, the bias for dw/db
    float rz[2], rg[2], rb[2];
    int rl[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = r0 + rr0 + 8 * a;
      const bool ok = row < nres;
      if (kRowsResident) {
        rz[a] = ok ? p.logz[row] * kLog2e : 0.f;      // logz in log2 units
        rg[a] = ok ? p.g[row] : 0.f;
        rl[a] = ok ? p.labels[row] : -1;
        rb[a] = 0.f;
      } else {
        rb[a] = (ok && p.bias != nullptr) ? p.bias[row] : 0.f;
        rz[a] = rg[a] = 0.f;
        rl[a] = -1;
      }
    }

    // the second product's accumulator, set by its first wgmma (scale_d
    // 0) and after every flush: no other instruction writes it
    float acc[kCols / 2];
    bool fresh = true;
    float dbacc[2] = {0.f, 0.f};
    // this warpgroup's 64 rows of the chunk, f32: stored, or added to
    // what an earlier flush stored
    float* o = p.out + static_cast<size_t>(split) * nres * p.H;
    const int c0 = kb0 * kBoxK;
    bool flushed = false;
    auto spill = [&]() {
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int row = r0 + rr0 + 8 * a;
          const int col = c0 + 8 * i + 2 * q4;   // H % 4 == 0: col + 1 too
          if (row < nres && col < p.H) {
            float2* q = reinterpret_cast<float2*>(
                o + static_cast<size_t>(row) * p.H + col);
            float2 v = make_float2(acc[4 * i + 2 * a],
                                   acc[4 * i + 2 * a + 1]);
            if (flushed) {
              const float2 u = *q;
              v.x += u.x;
              v.y += u.y;
            }
            *q = v;
          }
        }
      flushed = true;
    };

    hopper::Ring r(kStages);
    for (int t = t0; t < t1; ++t) {
      const int x0 = t * kStr;
      // the tile's per-column parameters (the bias for dh; logz, g and
      // the label for dw/db), read after the tile's first barrier; the
      // last tile's readers passed the barrier that ended it
      if (threadIdx.x < kStr) {
        const int idx = x0 + threadIdx.x;
        const bool ok = idx < nstr;
        if (kRowsResident) {
          cpar[threadIdx.x] = (ok && p.bias != nullptr) ? p.bias[idx] : 0.f;
        } else {
          cpar[threadIdx.x] = ok ? p.logz[idx] * kLog2e : 0.f;
          cpar[kStr + threadIdx.x] = ok ? p.g[idx] : 0.f;
          clab[threadIdx.x] = ok ? p.labels[idx] : -1;
        }
      }

      // first product: S = R X^T, this warpgroup's 64 rows, over K = H
      float s[32];
      uint32_t rhi[4][4], rlo[4][4];        // R's fragments, hi and lo
      int prev = -1;
      for (int j = 0; j < nkc; ++j) {
        const int st = r.stage;
        hopper::mbar_wait(full + st, r.phase);
        uint8_t* sp = ring + st * kStage;
        // split this warpgroup's half of the X box (rows 32 wg to 32 wg +
        // 31) in place, its lo part to the stage's fourth box, and stage
        // it as X^T. The products of the last stage run meanwhile.
        float4* xh = reinterpret_cast<float4*>(sp + 2 * kBoxBytes);
        float4* xl = reinterpret_cast<float4*>(sp + 3 * kBoxBytes);
        const int cbox = j * kBoxK;             // the box's X^T rows
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = 256 * wg + 128 * u + tid;   // float4 of the box
          const float4 v = xh[i];
          const float hv[4] = {hopper::tf32_rna(v.x), hopper::tf32_rna(v.y),
                               hopper::tf32_rna(v.z), hopper::tf32_rna(v.w)};
          const float lv[4] = {hopper::tf32_rna(v.x - hv[0]),
                               hopper::tf32_rna(v.y - hv[1]),
                               hopper::tf32_rna(v.z - hv[2]),
                               hopper::tf32_rna(v.w - hv[3])};
          xh[i] = make_float4(hv[0], hv[1], hv[2], hv[3]);
          xl[i] = make_float4(lv[0], lv[1], lv[2], lv[3]);
          const int srow = i >> 3;                    // streamed row
          const int c4 = (i & 7) ^ (srow & 7);        // unswizzled chunk
          const int kp = staged_k(srow);
          uint8_t* hi = xt + (srow >> 5) * kHalf;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = cbox + 4 * c4 + e;          // an X^T row
            const int off = c * 128 + (((kp >> 2) ^ (c & 7)) << 4) +
                            ((kp & 3) << 2);
            *reinterpret_cast<float*>(hi + off) = hv[e];
            *reinterpret_cast<float*>(hi + 2 * kHalf + off) = lv[e];
          }
        }
        hopper::fence_async_shared();
        hopper::named_barrier(1, 256);      // the X box split by both
        // the last stage's products are done: free it, and this
        // warpgroup's R fragments of the stage become the register A
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(rhi);
        hopper::fence_regs(rlo);
        if (prev >= 0) release(prev);
        // R's box (raw f32, 128-byte swizzle): rows g and g + 8 of this
        // warp's 16 (g = lane / 4, rows of the box r0 + 64 wg + ...),
        // columns 8 kk + q4 and 8 kk + q4 + 4, split in registers
        const uint8_t* rbox = sp + wg * kBoxBytes +
                              (16 * warp + (lane >> 2)) * 128 + 4 * q4;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int chunk16 = (2 * kk + (k >> 1)) ^ (lane >> 2);
            const float x = *reinterpret_cast<const float*>(
                rbox + (k & 1) * 1024 + chunk16 * 16);
            const float hx = hopper::tf32_rna(x);
            rhi[kk][k] = __float_as_uint(hx);
            rlo[kk][k] = __float_as_uint(hopper::tf32_rna(x - hx));
          }
        const uint8_t* b = sp + 2 * kBoxBytes;
        hopper::fence_regs(s);
        hopper::fence_regs(rhi);
        hopper::fence_regs(rlo);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {      // scale_d 0: overwrite
          const uint64_t bh = hopper::desc_sw128(b + 32 * kk);
          const uint64_t bl = hopper::desc_sw128(b + kBoxBytes + 32 * kk);
          hopper::wgmma_m64n64k8_tf32_rs(s, rlo[kk], bh, j | kk);
          hopper::wgmma_m64n64k8_tf32_rs(s, rhi[kk], bl, 1);
          hopper::wgmma_m64n64k8_tf32_rs(s, rhi[kk], bh, 1);
        }
        hopper::wgmma_commit();
        prev = st;
        r.next();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(rhi);
      hopper::fence_regs(rlo);
      release(prev);

      // S's K is cut over the cluster, a chunk of H a block: each block
      // writes its partial, then sums all of them in rank order (the
      // same sums in every block, so every block gets the same gch)
      float* mine = sx + wg * 32 * 128 + tid;   // [wg][e][tid]
      if (t > t0) hopper::mbar_wait_cluster(sx_free, (t - t0 - 1) & 1);
#pragma unroll
      for (int e = 0; e < 32; ++e) mine[e * 128] = s[e];
      for (uint32_t c = 0; c < nclus; ++c)
        hopper::mbar_arrive_cluster(hopper::cluster_addr(sx_full, c));
      hopper::mbar_wait_cluster(sx_full, (t - t0) & 1);
      float sum[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sum[e] = 0.f;
      for (uint32_t c = 0; c < nclus; ++c) {
        const uint32_t from = hopper::cluster_addr(mine, c);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          sum[e] += hopper::ld_cluster(from + e * 128 * 4);
      }
      for (uint32_t c = 0; c < nclus; ++c)
        hopper::mbar_arrive_cluster(hopper::cluster_addr(sx_free, c));

      // gch in f32 from S (db's row sums from it), split into hi and lo
      // as the register A of the second product: fragment entry k of
      // k8 slice i is S's row 8 (k & 1) at column 8 i + 2 q4 + (k >> 1),
      // the staged K order. S itself is only read: a non-wgmma write to
      // an accumulator makes ptxas serialize every wgmma of the kernel.
      float rsum[2] = {0.f, 0.f};
      uint32_t gh[8][4], gl[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int a = k & 1, e = k >> 1;
          const int sc = 8 * i + 2 * q4 + e;     // streamed index in tile
          int row, col, lbl;
          float logit = sum[4 * i + 2 * a + e], z, gg;
          if (kRowsResident) {
            row = r0 + rr0 + 8 * a;
            col = x0 + sc;
            logit += cpar[sc];
            z = rz[a];
            gg = rg[a];
            lbl = rl[a];
          } else {
            row = x0 + sc;
            col = r0 + rr0 + 8 * a;
            logit += rb[a];
            z = cpar[sc];
            gg = cpar[kStr + sc];
            lbl = clab[sc];
          }
          // dlogit() with exp(logit - logz) = 2^(logit log2e - z)
          const float pr = hopper::ex2(fmaf(logit, kLog2e, -z));
          const float hit = col == lbl ? 1.f : 0.f;
          const float d = (pr - p.sn - (p.sp - p.sn) * hit) * gg;
          const float v = (row < p.N && col < p.V) ? d : 0.f;
          rsum[a] += v;
          const float hv = hopper::tf32_rna(v);
          gh[i][k] = __float_as_uint(hv);
          gl[i][k] = __float_as_uint(hopper::tf32_rna(v - hv));
        }
      if (!kRowsResident) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          rsum[a] += __shfl_xor_sync(0xffffffffu, rsum[a], 1);
          rsum[a] += __shfl_xor_sync(0xffffffffu, rsum[a], 2);
          dbacc[a] += rsum[a];
        }
      }

      // second product: acc += gch X[:, the chunk], B the staged X^T
      hopper::fence_regs(acc);
      hopper::fence_regs(gh);
      hopper::fence_regs(gl);
      hopper::wgmma_fence();
      // the first product after a flush (or the block's first) overwrites
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint8_t* b = xt + (i >> 2) * kHalf + 32 * (i & 3);
        const uint64_t bh = hopper::desc_sw128(b);
        const uint64_t bl = hopper::desc_sw128(b + 2 * kHalf);
        hopper::wgmma_m64n256k8_tf32_rs(acc, gl[i], bh, i > 0 || !fresh);
        hopper::wgmma_m64n256k8_tf32_rs(acc, gh[i], bl, 1);
        hopper::wgmma_m64n256k8_tf32_rs(acc, gh[i], bh, 1);
      }
      fresh = false;
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(gh);
      hopper::fence_regs(gl);
      // both warpgroups are done with X^T and the column parameters
      hopper::named_barrier(1, 256);
      if (t + 1 < t1 && (t + 1 - t0) % kFlush == 0) {
        spill();
        fresh = true;                      // the next product overwrites
      }
    }

    spill();                               // the epilogue
    // the other blocks of the cluster are done with this block's sx
    hopper::mbar_wait_cluster(sx_free, (t1 - t0 - 1) & 1);
    if (!kRowsResident && chunk == 0 && q4 == 0) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int row = r0 + rr0 + 8 * a;
        if (row < p.V)
          p.db_out[static_cast<size_t>(split) * p.V + row] = dbacc[a];
      }
    }
  }
}

template <bool kRowsResident>
cudaError_t launch(const void* h, const void* w, const void* bias,
                   const void* labels, const void* logz, const void* g,
                   void* out, void* db, void* part, void* db_part, int N,
                   int V, int H, int nsplit, int tiles_per_split,
                   int nchunks, float sn, float sp, cudaStream_t st) {
  // the shapes the Python plan guarantees (ops/cuda/xent.py x3_plan)
  if (H % 4 != 0 || (reinterpret_cast<uintptr_t>(h) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15) ||
      nchunks != (H + kCols - 1) / kCols || nchunks > kMaxCluster)
    return cudaErrorInvalidValue;
  CUtensorMap tm_h, tm_w;
  cudaError_t err = hopper::encode_f32_boxes(&tm_h, h, N, H);
  if (err != cudaSuccess) return err;
  err = hopper::encode_f32_boxes(&tm_w, w, V, H);
  if (err != cudaSuccess) return err;
  err = ptt_set_smem(xent_bwd_x3_kernel<kRowsResident>, kSmem);
  if (err != cudaSuccess) return err;
  const int nres = kRowsResident ? N : V;
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const int*>(labels);
  p.logz = static_cast<const float*>(logz);
  p.g = static_cast<const float*>(g);
  p.out = static_cast<float*>(nsplit == 1 ? out : part);
  p.db_out = static_cast<float*>(nsplit == 1 ? db : db_part);
  p.N = N;
  p.V = V;
  p.H = H;
  p.tiles_per_split = tiles_per_split;
  p.sn = sn;
  p.sp = sp;
  // a cluster of the nchunks blocks of one resident tile and split
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nchunks, (nres + kRows - 1) / kRows, nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nchunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, xent_bwd_x3_kernel<kRowsResident>,
                           kRowsResident ? tm_h : tm_w,
                           kRowsResident ? tm_w : tm_h, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace x3

// The backward: f32 on 3xTF32 when `x3`, else by storage type (f32 on the
// CUDA cores, bf16 on the tensor cores); then the fixed-order sum of the
// splits' partials.
template <bool kRowsResident>
cudaError_t bwd_route(bool x3, int dtype, const void* h, const void* w,
                      const void* bias, const void* labels, const void* logz,
                      const void* g, void* out, void* db, void* part,
                      void* db_part, int N, int V, int H, int nsplit,
                      int tiles_per_split, int nchunks, int stages, float sn,
                      float sp, cudaStream_t st) {
  cudaError_t err;
  if (x3) {
    if (dtype != PTT_F32) return cudaErrorInvalidValue;
    err = x3::launch<kRowsResident>(h, w, bias, labels, logz, g, out, db,
                                    part, db_part, N, V, H, nsplit,
                                    tiles_per_split, nchunks, sn, sp, st);
  } else if (dtype == PTT_F32) {
    err = bwd_launch<kRowsResident>(h, w, bias, labels, logz, g, out, db,
                                    part, db_part, N, V, H, nsplit,
                                    tiles_per_split, nchunks, sn, sp, st);
  } else if (dtype == PTT_BF16) {
    err = tc::launch<kRowsResident>(h, w, bias, labels, logz, g, out, db,
                                    part, db_part, N, V, H, nsplit,
                                    tiles_per_split, nchunks, stages, sn, sp,
                                    st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || nsplit == 1) return err;
  const int nres = kRowsResident ? N : V;
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

// K5's bf16 tensor-core route: the same outputs; the vocab's 256-column
// tiles are cut into nsplit splits of tiles_per_split, and the row-tile x
// split items run on `grid` blocks (ops/cuda/xent.py stats_tc_plan).
extern "C" int ptt_xent_stats_tc(const void* h, const void* w,
                                 const void* bias, const void* labels,
                                 void* out, void* part, int N, int V, int H,
                                 int nsplit, int tiles_per_split, int grid,
                                 void* stream) {
  return static_cast<int>(stats_tc_launch<__nv_bfloat16>(
      h, w, bias, labels, out, part, N, V, H, nsplit, tiles_per_split, grid,
      static_cast<cudaStream_t>(stream)));
}

// K5's f32 route on 3xTF32 (H % 4 == 0): the tc route's arguments and
// plan, on f32 h and w.
extern "C" int ptt_xent_stats_tf32x3(const void* h, const void* w,
                                     const void* bias, const void* labels,
                                     void* out, void* part, int N, int V,
                                     int H, int nsplit, int tiles_per_split,
                                     int grid, void* stream) {
  return static_cast<int>(stats_tc_launch<float>(
      h, w, bias, labels, out, part, N, V, H, nsplit, tiles_per_split, grid,
      static_cast<cudaStream_t>(stream)));
}

// dh [N, H] f32 for the per-row cotangent g [N] f32 and the saved logz
// [N] f32. part [nsplit, N, H] f32 scratch (unused when nsplit == 1).
// Grid: nchunks column chunks of H; `stages` sizes the bf16 route's ring.
extern "C" int ptt_xent_bwd_dh(int dtype, const void* h, const void* w,
                               const void* bias, const void* labels,
                               const void* logz, const void* g, void* dh,
                               void* part, int N, int V, int H, int nsplit,
                               int tiles_per_split, int nchunks, int stages,
                               float sn, float sp, void* stream) {
  return static_cast<int>(bwd_route<true>(
      false, dtype, h, w, bias, labels, logz, g, dh, nullptr, part, nullptr,
      N, V, H, nsplit, tiles_per_split, nchunks, stages, sn, sp,
      static_cast<cudaStream_t>(stream)));
}

// K6's dh on 3xTF32 (f32, H % 4 == 0): the same arguments; `stages` is
// not read (the ring is fixed), nchunks chunks of 256 columns.
extern "C" int ptt_xent_bwd_dh_tf32x3(int dtype, const void* h,
                                      const void* w, const void* bias,
                                      const void* labels, const void* logz,
                                      const void* g, void* dh, void* part,
                                      int N, int V, int H, int nsplit,
                                      int tiles_per_split, int nchunks,
                                      int stages, float sn, float sp,
                                      void* stream) {
  return static_cast<int>(bwd_route<true>(
      true, dtype, h, w, bias, labels, logz, g, dh, nullptr, part, nullptr,
      N, V, H, nsplit, tiles_per_split, nchunks, stages, sn, sp,
      static_cast<cudaStream_t>(stream)));
}

// dw [V, H] and db [V], f32. part [nsplit, V, H] and db_part [nsplit, V]
// f32 scratch (unused when nsplit == 1).
extern "C" int ptt_xent_bwd_dwb(int dtype, const void* h, const void* w,
                                const void* bias, const void* labels,
                                const void* logz, const void* g, void* dw,
                                void* db, void* part, void* db_part, int N,
                                int V, int H, int nsplit,
                                int tiles_per_split, int nchunks, int stages,
                                float sn, float sp, void* stream) {
  return static_cast<int>(bwd_route<false>(
      false, dtype, h, w, bias, labels, logz, g, dw, db, part, db_part, N,
      V, H, nsplit, tiles_per_split, nchunks, stages, sn, sp,
      static_cast<cudaStream_t>(stream)));
}

// K6's dw/db on 3xTF32 (f32, H % 4 == 0): the same arguments.
extern "C" int ptt_xent_bwd_dwb_tf32x3(int dtype, const void* h,
                                       const void* w, const void* bias,
                                       const void* labels, const void* logz,
                                       const void* g, void* dw, void* db,
                                       void* part, void* db_part, int N,
                                       int V, int H, int nsplit,
                                       int tiles_per_split, int nchunks,
                                       int stages, float sn, float sp,
                                       void* stream) {
  return static_cast<int>(bwd_route<false>(
      true, dtype, h, w, bias, labels, logz, g, dw, db, part, db_part, N, V,
      H, nsplit, tiles_per_split, nchunks, stages, sn, sp,
      static_cast<cudaStream_t>(stream)));
}
