// K3: flash-attention backward, dq and dk/dv from the saved logsumexp.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:180 _fa_bwd_dq_kernel
// and :232 _fa_bwd_dkv_kernel (launched by _flash_attention_bwd_tpu
// :289). Both recompute the probabilities p = exp(s - lse) tile by tile
// from q, k and K2's per-row lse, so the [Tq, Tk] matrices never reach
// device memory; delta = rowsum(dO * O) arrives precomputed (the
// reference computes it in XLA, :299).
//
// The TPU kernels run a sequential grid axis that carries an f32
// accumulator in VMEM: kv tiles for dq, query tiles for dk/dv. Here that
// axis becomes a loop inside one block:
//   * flash_attention_bwd_dq:  one block per (batch*head, 64-row query
//     tile) walks the kv tiles, dq += dS K;
//   * flash_attention_bwd_dkv: one block per (batch*head, 64-row kv tile)
//     walks the query tiles, dv += P^T dO and dk += dS^T Q.
// Each output tile is owned by exactly one block: deterministic, no
// atomics, like the TPU's two-kernel split.
//
// Semantics kept from the TPU kernels (and K2): bottom-right causal
// alignment (query row i sees keys <= i + tk - tq), the causal block skip
// as a loop bound (dq stops at the last kv tile touching the diagonal,
// dk/dv starts at the first query tile that does), the optional
// key-padding mask [B, Tk], tail rows zeroed on load and masked, and a
// fully masked row contributes exactly 0 (p is selected to 0, so its
// overflowed exp(s - lse) is discarded).
//
// What bounds it on the H100: at the training shapes, bytes at the card's
// peak rates; in this kernel the products (three for dq, four for dk/dv)
// run on the CUDA cores in f32, so it is bound by f32 operations. wgmma on
// bf16 tiles is the later redesign.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPP = kBK + 1;    // padded row of a [64, 64] score tile

template <typename T>
__device__ void load_rows(const T* __restrict__ src, size_t base, int r0,
                          int n, int D, float* dst, int stride) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * stride + d] =
        r0 + r < n ? to_f32(src[base + static_cast<size_t>(r0 + r) * D + d])
                   : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_mask, T* __restrict__ dq,
                     int H, int tq, int tk, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kBQ][DP]
  float* do_s = q_s + kBQ * DP;      // [kBQ][DP]
  float* k_s = do_s + kBQ * DP;      // [kBK][DP]
  float* v_s = k_s + kBK * DP;       // [kBK][DP]
  float* ds_s = v_s + kBK * DP;      // [kBQ][kPP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;           // columns tx + 16c
  const int ty = tid >> 4;           // rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int offset = tk - tq;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;

  load_rows(q, qbase, q0, tq, D, q_s, DP);
  load_rows(dout, qbase, q0, tq, D, do_s, DP);
  float lse_r[4], dlt_r[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty * 4 + a;
    const bool ok = qp < tq;
    lse_r[a] = ok ? lse[static_cast<size_t>(bh) * tq + qp] : 0.f;
    dlt_r[a] = ok ? delta[static_cast<size_t>(bh) * tq + qp] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[a][j] = 0.f;

  int nk = (tk + kBK - 1) / kBK;
  if (causal) {
    const int last = q0 + kBQ - 1 + offset;   // last key any row here sees
    nk = last < 0 ? 0 : min(nk, last / kBK + 1);
  }

  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kBK;
    __syncthreads();                 // previous k_s / v_s / ds_s consumed
    load_rows(k, kbase, k0, tk, D, k_s, DP);
    load_rows(v, kbase, k0, tk, D, v_s, DP);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = k_s[(tx + 16 * c) * DP + d];
        vv[c] = v_s[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float qv = q_s[(ty * 4 + a) * DP + d];
        const float dv = do_s[(ty * 4 + a) * DP + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] += qv * kv[c];
          dp[a][c] += dv * vv[c];
        }
      }
    }

    bool keymask[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = k0 + tx + 16 * c;
      keymask[c] = kp < tk && (kv_mask == nullptr ||
                               kv_mask[static_cast<size_t>(b) * tk + kp] > 0);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + ty * 4 + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool valid = qp < tq && keymask[c] &&
                           (!causal || qp + offset >= kp);
        const float p = valid ? expf(s[a][c] * scale - lse_r[a]) : 0.f;
        ds_s[(ty * 4 + a) * kPP + tx + 16 * c] =
            p * (dp[a][c] - dlt_r[a]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float kr[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) kr[j] = k_s[kk * DP + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float dsv = ds_s[(ty * 4 + a) * kPP + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[a][j] += dsv * kr[j];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty * 4 + a;
    if (qp >= tq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[qbase + static_cast<size_t>(qp) * D + tx + 16 * j] =
          from_f32<T>(acc[a][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ kv_mask, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int tq, int tk, float scale,
                      int causal) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [kBK][DP]
  float* v_s = k_s + kBK * DP;       // [kBK][DP]
  float* q_s = v_s + kBK * DP;       // [kBQ][DP]
  float* do_s = q_s + kBQ * DP;      // [kBQ][DP]
  float* p_s = do_s + kBQ * DP;      // [kBK][kPP]  P^T
  float* ds_s = p_s + kBK * kPP;     // [kBK][kPP]  dS^T
  __shared__ float lse_s[kBQ], dlt_s[kBQ];

  const int tid = threadIdx.x;
  const int tx = tid & 15;           // query columns tx + 16c
  const int ty = tid >> 4;           // kv rows ty*4 .. ty*4+3
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int offset = tk - tq;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;

  load_rows(k, kbase, k0, tk, D, k_s, DP);
  load_rows(v, kbase, k0, tk, D, v_s, DP);
  bool keymask[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + ty * 4 + a;
    keymask[a] = kp < tk && (kv_mask == nullptr ||
                             kv_mask[static_cast<size_t>(b) * tk + kp] > 0);
  }

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < DC; ++j) dka[a][j] = dva[a][j] = 0.f;

  const int nq = (tq + kBQ - 1) / kBQ;
  int qb = 0;
  if (causal) {
    // first query tile whose last row sees this tile's first key
    const int need = k0 - offset - (kBQ - 1);
    qb = need <= 0 ? 0 : (need + kBQ - 1) / kBQ;
  }

  for (int qi = qb; qi < nq; ++qi) {
    const int q0 = qi * kBQ;
    __syncthreads();                 // previous q_s / do_s / p_s consumed
    load_rows(q, qbase, q0, tq, D, q_s, DP);
    load_rows(dout, qbase, q0, tq, D, do_s, DP);
    if (tid < kBQ) {
      const int qp = q0 + tid;
      const bool ok = qp < tq;
      lse_s[tid] = ok ? lse[static_cast<size_t>(bh) * tq + qp] : 0.f;
      dlt_s[tid] = ok ? delta[static_cast<size_t>(bh) * tq + qp] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];       // S^T and dP^T: [kv row][query col]
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[a][c] = dpt[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = q_s[(tx + 16 * c) * DP + d];
        dov[c] = do_s[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float kv = k_s[(ty * 4 + a) * DP + d];
        const float vv = v_s[(ty * 4 + a) * DP + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          st[a][c] += kv * qv[c];
          dpt[a][c] += vv * dov[c];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kp = k0 + ty * 4 + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 16 * c;
        const int qp = q0 + qc;
        const bool valid = qp < tq && keymask[a] &&
                           (!causal || qp + offset >= kp);
        const float p = valid ? expf(st[a][c] * scale - lse_s[qc]) : 0.f;
        p_s[(ty * 4 + a) * kPP + qc] = p;
        ds_s[(ty * 4 + a) * kPP + qc] = p * (dpt[a][c] - dlt_s[qc]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float qr[DC], dor[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        qr[j] = q_s[qq * DP + tx + 16 * j];
        dor[j] = do_s[qq * DP + tx + 16 * j];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pv = p_s[(ty * 4 + a) * kPP + qq];
        const float dsv = ds_s[(ty * 4 + a) * kPP + qq];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dva[a][j] += pv * dor[j];
          dka[a][j] += dsv * qr[j];
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + ty * 4 + a;
    if (kp >= tk) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const size_t o = kbase + static_cast<size_t>(kp) * D + tx + 16 * j;
      dk[o] = from_f32<T>(dka[a][j]);
      dv[o] = from_f32<T>(dva[a][j]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + kBQ * kPP);
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * kBK * kPP);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *mask;
  void *dq, *dk, *dv;
  int B, H, tq, tk;
  float scale;
  int causal;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t st) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = ptt_set_smem(fa_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + kBQ - 1) / kBQ, a.B * a.H);
  fa_bwd_dq_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.mask), static_cast<T*>(a.dq), a.H, a.tq,
      a.tk, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t st) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = ptt_set_smem(fa_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tk + kBK - 1) / kBK, a.B * a.H);
  fa_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.mask), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.tq, a.tk, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 16:
      return kDq ? launch_dq<T, 16>(a, st) : launch_dkv<T, 16>(a, st);
    case 32:
      return kDq ? launch_dq<T, 32>(a, st) : launch_dkv<T, 32>(a, st);
    case 64:
      return kDq ? launch_dq<T, 64>(a, st) : launch_dkv<T, 64>(a, st);
    case 128:
      return kDq ? launch_dq<T, 128>(a, st) : launch_dkv<T, 128>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int run(int dtype, int D, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = dispatch_d<float, kDq>(D, a, st);
  } else if (dtype == PTT_BF16) {
    err = dispatch_d<__nv_bfloat16, kDq>(D, a, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// q, dout [B, H, tq, D]; k, v [B, H, tk, D] (one dtype, f32 or bf16);
// lse, delta [B*H, tq] f32; kv_mask [B, tk] int32 or null; dq like q.
extern "C" int ptt_flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask, void* dq, int B,
    int H, int tq, int tk, int D, float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, kv_mask, dq, nullptr, nullptr,
               B, H, tq, tk, scale, causal};
  return run<true>(dtype, D, a, stream);
}

// As above; dk, dv like k.
extern "C" int ptt_flash_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask, void* dk,
    void* dv, int B, int H, int tq, int tk, int D, float scale, int causal,
    void* stream) {
  const Args a{q, k, v, dout, lse, delta, kv_mask, nullptr, dk, dv,
               B, H, tq, tk, scale, causal};
  return run<false>(dtype, D, a, stream);
}
