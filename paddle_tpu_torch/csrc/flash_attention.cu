// K2: flash-attention forward, out and per-row logsumexp, on the CUDA
// cores (f32 at every head dim, bf16 at 16 and 32; the bf16 tensor-core
// route is csrc/flash_attention_tc.cu).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:64 _fa_kernel
// (launched by _flash_attention_fwd_tpu :112). On the TPU the kv axis is
// a sequential grid axis that carries the online-softmax state
// (m, l, acc) in VMEM. Here one block owns one work item, a (batch*head,
// 64-row query tile, range of 64-key tiles), walks its kv tiles in a loop
// with m, l and the [64, D] accumulator in registers, and writes either
// the tile's out and lse or, where the query tile's kv tiles were cut
// into several items, its (m, l, acc) partial; fa_merge_kernel then
// combines a tile's partials in chunk order (m* = max m_j, l* = sum l_j
// e^(m_j - m*), out = sum acc_j e^(m_j - m*) / l*), the same sums every
// run, no atomics.
//
// Semantics kept from the TPU kernel: bottom-right causal alignment
// (query row i sees keys <= i + tk - tq), the causal block skip (a query
// tile walks only the kv tiles up to the last that touches its last real
// row's diagonal), the optional key-padding mask [B, Tk], tail tiles
// zeroed on load, and a fully masked row gives exactly 0 (probabilities
// are masked, not only scores) with lse = -1e30 + log(1e-30).
//
// What bounds it on the H100: both products (QK^T and PV) in f32 on the
// CUDA cores, 4 D FMA-operations a (query, key) pair with the causal
// half skipped. At serving's first prefill chunk, [1, 12, 512, 512, 64]
// causal, that is 0.4 GFLOP, 6 us at 67 TFLOP/s; one block per query tile
// gives 96 blocks whose longest walks 8 kv tiles while the shortest
// walks 1, so the run is its longest block. The design shortens that
// path and fills the card:
//   * the plan (ops/cuda/flash_attention.py flash_plan) cuts each query
//     tile's kv tiles into chunks of at most `chunk` tiles, chunk the
//     kv-tile work over the SMs' resident block slots (the occupancy
//     calculator's count, ptt_flash_attention_resident), and lists the
//     items longest first; the grid is (batch*head, item), so the
//     scheduler hands out every head's longest items before any shorter;
//   * K and V tiles are double-buffered through cp.async, so the next
//     tile's loads run under this tile's products;
//   * 128 threads a block, each an 8-row x 4-key micro-tile of the scores
//     (per four d: eight 16-byte reads of Q, broadcast over the warp's
//     two row groups, and four of K feed 128 FMAs) and an 8-row x D/16
//     micro-tile of the output; Q and K rows are padded by 4 floats so
//     the K reads of a quarter-warp fall on distinct banks.
// Without splits (the plan's chunk covers every tile, as at GPT-train's
// f32 shape) the item list is implicit: item r is query tile nq - 1 - r,
// and no merge runs.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;          // query rows of an item
constexpr int kBK = 64;          // keys of a kv tile
constexpr int kMaxItems = 512;   // items of a split plan (ops/cuda/...)

// The work items of a split plan, longest first: query tile << 20 | first
// kv tile << 10 | end kv tile. n == 0: no splits, item r is query tile
// nq - 1 - r over all its kv tiles.
struct Items {
  int n;
  unsigned v[kMaxItems];
};

template <int D>
struct Fa {
  static constexpr int kQS = D + 4;         // padded Q and K rows
  static constexpr int kPS = kBK + 4;       // padded P row
  static constexpr int kQ = kBQ * kQS;
  static constexpr int kK = kBK * kQS;
  static constexpr int kV = kBK * D;
  static constexpr int kP = kBQ * kPS;
  static constexpr size_t kSmem =
      sizeof(float) * (kQ + 2 * (kK + kV) + kP);
  static constexpr int kW = D >= 64 ? 4 : D / 16;   // output piece width
  static constexpr int kG = D / (16 * kW);          // pieces of a thread
  static constexpr int kDC = kW * kG;               // output columns
};

// The kv tiles query tile qi walks: all of them, or (causal) those up to
// the one holding its last real row's diagonal key.
__device__ __forceinline__ int kv_tiles(int qi, int tq, int tk, int causal) {
  const int nk = (tk + kBK - 1) / kBK;
  if (!causal) return nk;
  const int last = min(qi * kBQ + kBQ - 1, tq - 1) + (tk - tq);
  return last < 0 ? 0 : min(nk, last / kBK + 1);
}

// rows [0, 64) of a [T, D] matrix from row r0 into a padded tile; rows
// past `valid` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int valid) {
  for (int c = threadIdx.x; c < kBK * (D / 4); c += kThreads) {
    const int r = c / (D / 4), d = 4 * (c % (D / 4));
    load4(dst + r * stride + d, src + static_cast<size_t>(r) * D + d,
          r < valid ? 4 : 0);
  }
}

template <int W>
__device__ __forceinline__ void load_piece(float (&dst)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x, dst[1] = t.y, dst[2] = t.z, dst[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    dst[0] = t.x, dst[1] = t.y;
  } else {
    dst[0] = *p;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_mask,
                  T* __restrict__ out, float* __restrict__ lse,
                  float* __restrict__ part, int H, int tq, int tk,
                  float scale, int causal, int chunk,
                  const __grid_constant__ Items items) {
  using F = Fa<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [kBQ][kQS]
  float* k_s = q_s + F::kQ;          // 2 x [kBK][kQS]
  float* v_s = k_s + 2 * F::kK;      // 2 x [kBK][D]
  float* p_s = v_s + 2 * F::kV;      // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;           // score columns tx + 16 c; output
                                     // columns tx * kW + 16 kW g
  const int ty = tid >> 4;           // rows ty * 8 .. ty * 8 + 7
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int nq = (tq + kBQ - 1) / kBQ;
  const int nk = (tk + kBK - 1) / kBK;
  const int offset = tk - tq;
  int qi, t0, t1;
  if (items.n == 0) {
    qi = nq - 1 - static_cast<int>(blockIdx.y);
    t0 = 0;
    t1 = kv_tiles(qi, tq, tk, causal);
  } else {
    const unsigned e = items.v[blockIdx.y];
    qi = static_cast<int>(e >> 20);
    t0 = static_cast<int>((e >> 10) & 1023u);
    t1 = static_cast<int>(e & 1023u);
  }
  const int chunks = max(1, (kv_tiles(qi, tq, tk, causal) + chunk - 1) /
                                chunk);
  const int q0 = qi * kBQ;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;

  load_tile<T, D>(q_s, F::kQS, q + qbase + static_cast<size_t>(q0) * D,
                  tq - q0);
  if (t0 < t1) {
    const size_t g = kbase + static_cast<size_t>(t0) * kBK * D;
    load_tile<T, D>(k_s, F::kQS, k + g, tk - t0 * kBK);
    load_tile<T, D>(v_s, D, v + g, tk - t0 * kBK);
  }
  cp_async_commit();

  float m[8], l[8], acc[8][F::kDC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = PTT_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < F::kDC; ++j) acc[i][j] = 0.f;
  }

#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {                // stage st ^ 1 was freed by t - 1
      const size_t g = kbase + static_cast<size_t>(t + 1) * kBK * D;
      load_tile<T, D>(k_s + (st ^ 1) * F::kK, F::kQS, k + g,
                      tk - (t + 1) * kBK);
      load_tile<T, D>(v_s + (st ^ 1) * F::kV, D, v + g, tk - (t + 1) * kBK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                 // tile t (and Q) landed
    const float* kt = k_s + st * F::kK;
    const int k0 = t * kBK;

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(kt + (tx + 16 * c) *
                                                 F::kQS + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            q_s + (ty * 8 + i) * F::kQS + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv.x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv.y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv.z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv.w, kv[c].w, s[i][c]);
        }
      }
    }

    bool keyok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = k0 + tx + 16 * c;
      keyok[c] = kp < tk && (kv_mask == nullptr ||
                             kv_mask[static_cast<size_t>(b) * tk + kp] > 0);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = q0 + ty * 8 + i;
      bool valid[4];
      float rmax = PTT_NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        valid[c] = keyok[c] && (!causal || qp + offset >= kp);
        s[i][c] = valid[c] ? s[i][c] * scale : PTT_NEG_INF;
        rmax = fmaxf(rmax, s[i][c]);
      }
      // a row's 16 threads are one half-warp: xor 8..1 stays inside
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = valid[c] ? expf(s[i][c] - m_new) : 0.f;
        p_s[(ty * 8 + i) * F::kPS + tx + 16 * c] = p;
        rsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < F::kDC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                 // p_s written

    const float* vt = v_s + st * F::kV;
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty * 8 + i) *
                                                 F::kPS + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[F::kDC];
#pragma unroll
        for (int g = 0; g < F::kG; ++g) {
          float piece[F::kW];
          load_piece<F::kW>(piece, vt + (c + u) * D + tx * F::kW +
                                       16 * F::kW * g);
#pragma unroll
          for (int e = 0; e < F::kW; ++e) vv[g * F::kW + e] = piece[e];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = u == 0 ? pv[i].x
                          : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
          for (int j = 0; j < F::kDC; ++j) acc[i][j] = fmaf(p, vv[j],
                                                             acc[i][j]);
        }
      }
    }
    __syncthreads();                 // p_s and stage st consumed
  }
  cp_async_wait<0>();                // an item with no kv tile: Q's copy

  const int maxc = (nk + chunk - 1) / chunk;
  const size_t slot0 =
      (static_cast<size_t>(bh) * nq + qi) * maxc + t0 / chunk;
  float* part_ml = part + static_cast<size_t>(gridDim.x) * nq * maxc *
                              kBQ * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    const int qp = q0 + r;
    if (qp >= tq) continue;
    if (chunks > 1) {                // a partial: (m, l, acc) unnormalised
      const size_t row = slot0 * kBQ + r;
#pragma unroll
      for (int g = 0; g < F::kG; ++g)
#pragma unroll
        for (int e = 0; e < F::kW; ++e)
          part[row * D + tx * F::kW + 16 * F::kW * g + e] =
              acc[i][g * F::kW + e];
      if (tx == 0) {
        part_ml[2 * row] = m[i];
        part_ml[2 * row + 1] = l[i];
      }
      continue;
    }
    const float inv = l[i] > 0.f ? 1.0f / fmaxf(l[i], 1e-30f) : 0.f;
#pragma unroll
    for (int g = 0; g < F::kG; ++g)
#pragma unroll
      for (int e = 0; e < F::kW; ++e)
        out[qbase + static_cast<size_t>(qp) * D + tx * F::kW +
            16 * F::kW * g + e] =
            from_f32<T>(l[i] > 0.f ? acc[i][g * F::kW + e] * inv : 0.f);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * tq + qp] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// A query tile whose kv tiles were cut into chunks: its partials
// combined in chunk order into out and lse. Block (bh, qi, z) takes rows
// z*16 .. z*16+15 of the tile, 16 threads a row, each the row's output
// columns of the forward kernel's layout; every thread forms its row's
// m* and l* itself (the row's 16 threads read the same statistics).
template <typename T, int D>
__global__ void __launch_bounds__(256)
    fa_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                    float* __restrict__ lse, int tq, int tk, int causal,
                    int chunk) {
  using F = Fa<D>;
  const int bh = blockIdx.x, qi = blockIdx.y;
  const int nq = gridDim.y;
  const int chunks = max(1, (kv_tiles(qi, tq, tk, causal) + chunk - 1) /
                                chunk);
  const int tx = threadIdx.x & 15;
  const int r = blockIdx.z * 16 + (threadIdx.x >> 4);
  const int qp = qi * kBQ + r;
  if (chunks <= 1 || qp >= tq) return;
  const int nk = (tk + kBK - 1) / kBK;
  const int maxc = (nk + chunk - 1) / chunk;
  const size_t slot0 = (static_cast<size_t>(bh) * nq + qi) * maxc;
  const float* part_ml = part + static_cast<size_t>(gridDim.x) * nq * maxc *
                                    kBQ * D;
  float mx = PTT_NEG_INF;
  for (int j = 0; j < chunks; ++j)
    mx = fmaxf(mx, part_ml[2 * ((slot0 + j) * kBQ + r)]);
  float ls = 0.f, acc[F::kDC];
#pragma unroll
  for (int e = 0; e < F::kDC; ++e) acc[e] = 0.f;
  for (int j = 0; j < chunks; ++j) {
    const size_t row = (slot0 + j) * kBQ + r;
    const float w = expf(part_ml[2 * row] - mx);
    ls += part_ml[2 * row + 1] * w;
#pragma unroll
    for (int g = 0; g < F::kG; ++g) {
      float piece[F::kW];
      load_piece<F::kW>(piece, part + row * D + tx * F::kW + 16 * F::kW * g);
#pragma unroll
      for (int e = 0; e < F::kW; ++e)
        acc[g * F::kW + e] = fmaf(w, piece[e], acc[g * F::kW + e]);
    }
  }
  const float inv = ls > 0.f ? 1.0f / fmaxf(ls, 1e-30f) : 0.f;
  const size_t o = (static_cast<size_t>(bh) * tq + qp) * D;
#pragma unroll
  for (int g = 0; g < F::kG; ++g)
#pragma unroll
    for (int e = 0; e < F::kW; ++e)
      out[o + tx * F::kW + 16 * F::kW * g + e] =
          from_f32<T>(acc[g * F::kW + e] * inv);
  if (tx == 0)
    lse[static_cast<size_t>(bh) * tq + qp] = mx + logf(fmaxf(ls, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, void* lse, void* part,
                   int B, int H, int tq, int tk, float scale, int causal,
                   int chunk, const Items& items, cudaStream_t st) {
  constexpr size_t smem = Fa<D>::kSmem;
  cudaError_t err = ptt_set_smem_resident(fa_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const int nq = (tq + kBQ - 1) / kBQ;
  const dim3 grid(B * H, items.n ? items.n : nq);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<float*>(part), H, tq, tk, scale, causal, chunk, items);
  err = cudaGetLastError();
  if (err != cudaSuccess || items.n == 0) return err;
  fa_merge_kernel<T, D><<<dim3(B * H, nq, kBQ / 16), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<T*>(out),
      static_cast<float*>(lse), tq, tk, causal, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, void* part,
                       int B, int H, int tq, int tk, float scale, int causal,
                       int chunk, const Items& items, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, mask, out, lse, part, B, H, tq, tk,
                           scale, causal, chunk, items, st);
    case 32:
      return launch<T, 32>(q, k, v, mask, out, lse, part, B, H, tq, tk,
                           scale, causal, chunk, items, st);
  }
  if constexpr (sizeof(T) == 4) {    // bf16 at 64 and 128 takes the tc route
    switch (D) {
      case 64:
        return launch<T, 64>(q, k, v, mask, out, lse, part, B, H, tq, tk,
                             scale, causal, chunk, items, st);
      case 128:
        return launch<T, 128>(q, k, v, mask, out, lse, part, B, H, tq, tk,
                              scale, causal, chunk, items, st);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t resident_d(int D, int* out) {
  switch (D) {
    case 16:
      return ptt_resident_blocks(fa_fwd_kernel<T, 16>, kThreads,
                                 Fa<16>::kSmem, out);
    case 32:
      return ptt_resident_blocks(fa_fwd_kernel<T, 32>, kThreads,
                                 Fa<32>::kSmem, out);
  }
  if constexpr (sizeof(T) == 4) {
    switch (D) {
      case 64:
        return ptt_resident_blocks(fa_fwd_kernel<T, 64>, kThreads,
                                   Fa<64>::kSmem, out);
      case 128:
        return ptt_resident_blocks(fa_fwd_kernel<T, 128>, kThreads,
                                   Fa<128>::kSmem, out);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// *out = the blocks of the forward kernel at this storage type and head
// dim that one SM holds (flash_plan's slots an SM).
extern "C" int ptt_flash_attention_resident(int dtype, int D, int* out) {
  if (dtype == PTT_F32) return static_cast<int>(resident_d<float>(D, out));
  if (dtype == PTT_BF16)
    return static_cast<int>(resident_d<__nv_bfloat16>(D, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

// q [B, H, tq, D], k/v [B, H, tk, D], kv_mask [B, tk] int32 or null;
// out like q, lse [B*H, tq] f32. D in {16, 32, 64, 128} (f32), {16, 32}
// (bf16). chunk: kv tiles per item (ops/cuda/flash_attention.py
// flash_plan); n_items items of the split plan, or 0 for none; part an f32
// scratch of B*H*nq*ceil(nk/chunk)*64*(D + 2) values where n_items > 0.
extern "C" int ptt_flash_attention(int dtype, const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   void* out, void* lse, void* part, int B,
                                   int H, int tq, int tk, int D, float scale,
                                   int causal, int chunk, int n_items,
                                   const unsigned* items, void* stream) {
  if (n_items < 0 || n_items > kMaxItems || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Items it;
  it.n = n_items;
  for (int i = 0; i < n_items; ++i) it.v[i] = items[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = dispatch_d<float>(D, q, k, v, kv_mask, out, lse, part, B, H, tq,
                            tk, scale, causal, chunk, it, st);
  } else if (dtype == PTT_BF16) {
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, kv_mask, out, lse, part, B,
                                    H, tq, tk, scale, causal, chunk, it, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
