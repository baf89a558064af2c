// K2: flash-attention forward, out and per-row logsumexp.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:64 _fa_kernel
// (launched by _flash_attention_fwd_tpu :112). On the TPU the kv axis is
// a sequential grid axis that carries the online-softmax state
// (m, l, acc) in VMEM. Here one block owns one (batch*head, 64-row query
// tile) and walks the kv tiles in a loop, keeping m and l in registers
// and the [64, D] accumulator spread over the block's registers; blocks
// carry nothing between them.
//
// Semantics kept from the TPU kernel: bottom-right causal alignment
// (query row i sees keys <= i + tk - tq), the causal block skip (the kv
// loop stops at the last tile that touches the diagonal), the optional
// key-padding mask [B, Tk], tail tiles zeroed on load, and a fully masked
// row gives exactly 0 (probabilities are masked, not only scores).
//
// What bounds it on the H100: both products (QK^T and PV) run in this
// kernel on the CUDA cores in f32, so at prefill it is bound by f32
// operations (4*B*H*Tq*Tk*D/2 FMAs with the causal half skipped). Tiles
// are staged in shared memory with one padded column so the score loop
// reads K without bank conflicts. wgmma on bf16 tiles with TMA loads is
// the later redesign.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_mask,
                  T* __restrict__ out, float* __restrict__ lse, int H,
                  int tq, int tk, float scale, int causal) {
  constexpr int DP = D + 1;      // padded K row: conflict-free score reads
  constexpr int PP = kBK + 1;
  constexpr int DC = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;             // [kBQ][D]
  float* k_s = q_s + kBQ * D;    // [kBK][DP]
  float* v_s = k_s + kBK * DP;   // [kBK][D]
  float* p_s = v_s + kBK * D;    // [kBQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;       // column group
  const int ty = tid >> 4;       // rows ty*4 .. ty*4+3
  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = qi * kBQ;
  const int offset = tk - tq;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = (q0 + r < tq) ? to_f32(q[qbase + static_cast<size_t>(q0) * D + i])
                           : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = PTT_NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[a][j] = 0.f;
  }

  int nk = (tk + kBK - 1) / kBK;
  if (causal) {
    const int last = q0 + kBQ - 1 + offset;   // last key any row here sees
    nk = last < 0 ? 0 : min(nk, last / kBK + 1);
  }

  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kBK;
    __syncthreads();             // previous tile's k_s / v_s / p_s consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool ok = k0 + r < tk;
      const size_t g = kbase + static_cast<size_t>(k0) * D + i;
      k_s[r * DP + d] = ok ? to_f32(k[g]) : 0.f;
      v_s[i] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float qv = q_s[(ty * 4 + a) * D + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] += qv * kv[c];
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
      bool valid[4];
      float rmax = PTT_NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        valid[c] = keymask[c] && (!causal || qp + offset >= kp);
        s[a][c] = valid[c] ? s[a][c] * scale : PTT_NEG_INF;
        rmax = fmaxf(rmax, s[a][c]);
      }
      // the 16 threads of a row are one half-warp: xor 8..1 stays inside
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m[a], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = valid[c] ? expf(s[a][c] - m_new) : 0.f;
        p_s[(ty * 4 + a) * PP + tx + 16 * c] = p;
        rsum += p;
      }
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + rsum;
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = v_s[kk * D + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = p_s[(ty * 4 + a) * PP + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[a][j] += p * vv[j];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty * 4 + a;
    if (qp >= tq) continue;
    const float inv = l[a] > 0.f ? 1.0f / fmaxf(l[a], 1e-30f) : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      out[qbase + static_cast<size_t>(qp) * D + tx + 16 * j] =
          from_f32<T>(l[a] > 0.f ? acc[a][j] * inv : 0.f);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * tq + qp] =
          m[a] + logf(fmaxf(l[a], 1e-30f));
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * D + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, void* lse, int B, int H,
                   int tq, int tk, float scale, int causal, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = ptt_set_smem(fa_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBQ - 1) / kBQ, B * H);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, tq, tk, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int H,
                       int tq, int tk, float scale, int causal,
                       cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, mask, out, lse, B, H, tq, tk, scale,
                           causal, st);
    case 32:
      return launch<T, 32>(q, k, v, mask, out, lse, B, H, tq, tk, scale,
                           causal, st);
    case 64:
      return launch<T, 64>(q, k, v, mask, out, lse, B, H, tq, tk, scale,
                           causal, st);
    case 128:
      return launch<T, 128>(q, k, v, mask, out, lse, B, H, tq, tk, scale,
                            causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, tq, D], k/v [B, H, tk, D], kv_mask [B, tk] int32 or null;
// out like q, lse [B*H, tq] f32. D in {16, 32, 64, 128}.
extern "C" int ptt_flash_attention(int dtype, const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   void* out, void* lse, int B, int H,
                                   int tq, int tk, int D, float scale,
                                   int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PTT_F32) {
    err = dispatch_d<float>(D, q, k, v, kv_mask, out, lse, B, H, tq, tk,
                            scale, causal, st);
  } else if (dtype == PTT_BF16) {
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, kv_mask, out, lse, B, H, tq,
                                    tk, scale, causal, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
