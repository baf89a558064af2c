// K7: paged decode attention, one query token per slot.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py:48 _decode_kernel
// (launched by paged_decode_attention_tpu :114). The TPU kernel receives
// the page table through scalar prefetch and lets the BlockSpec index map
// gather each page; it walks the pages on a sequential grid axis carrying
// (m, l, acc). Here one block owns one (head, slot) pair: it reads
// page_table[s, j] itself, stops at the last page that holds a token
// (pages at or past `length` are never read), stages each [ps, hd] K/V
// page in shared memory as f32 (int8 rows dequantized by their per-row
// scale on the way in), and folds it into an online softmax in f32. A
// slot of length 0 runs no page and writes exactly 0.
//
// What bounds it on the H100: each slot's K/V bytes are read once and do
// two FMAs per element, so it is bound by bytes. One block per
// (slot, head) gives only S*H blocks (96 at 8 slots x 12 heads) on 132
// SMs; the later redesign splits each slot's pages across blocks
// (flash-decoding) and combines the partial (m, l, acc) in a second pass.
// Staging keeps kStage loads of K and V in flight per thread: with one at
// a time the kernel waited a memory latency per element.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 8;      // loads in flight per thread while staging

template <typename P>
__global__ void decode_kernel(const float* __restrict__ q,
                              const P* __restrict__ k_pages,
                              const P* __restrict__ v_pages,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ page_table,
                              const int* __restrict__ lengths,
                              float* __restrict__ out, int N, int H, int ps,
                              int hd, int pmax, float scale) {
  extern __shared__ float smem[];
  const int HP = hd + 1;
  float* q_s = smem;               // [hd]
  float* k_s = q_s + hd;           // [ps][hd+1]
  float* v_s = k_s + ps * HP;      // [ps][hd]
  float* p_s = v_s + ps * hd;      // [ps]
  float* red = p_s + ps;           // [32]

  const int h = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int len = lengths[s];
  const size_t qo = (static_cast<size_t>(s) * H + h) * hd;
  for (int d = tid; d < hd; d += nt) q_s[d] = q[qo + d];

  float m = PTT_NEG_INF, l = 0.f, acc = 0.f;   // acc: column d = tid
  const int npages = len <= 0 ? 0 : min((len + ps - 1) / ps, pmax);
  for (int j = 0; j < npages; ++j) {
    int page = page_table[static_cast<size_t>(s) * pmax + j];
    page = min(max(page, 0), N - 1);
    const size_t base = (static_cast<size_t>(page) * H + h) * ps * hd;
    __syncthreads();               // previous page fully consumed
    // issue kStage independent loads of K and V before using any, so a
    // page costs a few memory latencies instead of one per element
    for (int i0 = tid; i0 < ps * hd; i0 += nt * kStage) {
      float kk[kStage], vv[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * nt;
        const bool ok = i < ps * hd;
        kk[u] = ok ? to_f32(k_pages[base + i]) : 0.f;
        vv[u] = ok ? to_f32(v_pages[base + i]) : 0.f;
        if (ok && k_scale != nullptr) {
          const size_t srow = static_cast<size_t>(page) * ps + i / hd;
          kk[u] *= k_scale[srow];
          vv[u] *= v_scale[srow];
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * nt;
        if (i < ps * hd) {
          const int r = i / hd;
          k_s[r * HP + (i - r * hd)] = kk[u];
          v_s[i] = vv[u];
        }
      }
    }
    __syncthreads();
    float tmax = PTT_NEG_INF;
    for (int r = tid; r < ps; r += nt) {
      float sc = 0.f;
      for (int d = 0; d < hd; ++d) sc += q_s[d] * k_s[r * HP + d];
      sc = (j * ps + r < len) ? sc * scale : PTT_NEG_INF;
      p_s[r] = sc;
      tmax = fmaxf(tmax, sc);
    }
    tmax = block_max(tmax, red);
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
    for (int r = tid; r < ps; r += nt) {
      const float p = (j * ps + r < len) ? expf(p_s[r] - m_new) : 0.f;
      p_s[r] = p;
      psum += p;
    }
    psum = block_sum(psum, red);   // its barriers publish p_s
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    if (tid < hd) {
      float a = 0.f;
      for (int r = 0; r < ps; ++r) a += p_s[r] * v_s[r * hd + tid];
      acc = acc * alpha + a;
    }
  }
  if (tid < hd)
    out[qo + tid] = l > 0.f ? acc / fmaxf(l, 1e-30f) : 0.f;
}

template <typename P>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* ptab,
                   const void* lens, void* out, int S, int N, int H, int ps,
                   int hd, int pmax, float scale, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(hd) + ps * (hd + 1) +
                       static_cast<size_t>(ps) * hd + ps + 32);
  cudaError_t err = ptt_set_smem(decode_kernel<P>, smem);
  if (err != cudaSuccess) return err;
  const int threads = hd > kThreads ? ((hd + 31) / 32) * 32 : kThreads;
  const dim3 grid(H, S);
  decode_kernel<P><<<grid, threads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(ptab),
      static_cast<const int*>(lens), static_cast<float*>(out), N, H, ps, hd,
      pmax, scale);
  return cudaGetLastError();
}

}  // namespace

// q [S, H, hd] f32; pools [N, H, ps, hd] of `pool_dtype`; k/v_scale
// [N, ps] f32 (int8 pools only, else null); page_table [S, pmax] int32;
// lengths [S] int32; out [S, H, hd] f32.
extern "C" int ptt_decode_attention(int pool_dtype, const void* q,
                                    const void* k_pages,
                                    const void* v_pages, const void* k_scale,
                                    const void* v_scale,
                                    const void* page_table,
                                    const void* lengths, void* out, int S,
                                    int N, int H, int ps, int hd, int pmax,
                                    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pool_dtype == PTT_F32) {
    err = launch<float>(q, k_pages, v_pages, nullptr, nullptr, page_table,
                        lengths, out, S, N, H, ps, hd, pmax, scale, st);
  } else if (pool_dtype == PTT_BF16) {
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                page_table, lengths, out, S, N, H, ps, hd,
                                pmax, scale, st);
  } else if (pool_dtype == PTT_I8) {
    err = launch<int8_t>(q, k_pages, v_pages, k_scale, v_scale, page_table,
                         lengths, out, S, N, H, ps, hd, pmax, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
