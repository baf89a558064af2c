// K7: paged decode attention, one query token per slot.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py:48 _decode_kernel
// (launched by paged_decode_attention_tpu :114). The TPU kernel receives
// the page table through scalar prefetch and lets the BlockSpec index map
// gather each page; it walks the pages on a sequential grid axis carrying
// (m, l, acc). What bounds it on the H100: each slot's live K/V bytes are
// read once and do two FMAs per element, so it is bound by bytes. Two
// routes, chosen by shape in the wrapper (ops/cuda/decode_attention.py
// decode_route):
//
// split (head dims that are multiples of 8 up to 256), flash-decoding:
//   the grid is (split, head, slot), and each split owns a contiguous run
//   of `per` page-table entries of its slot, so a few slots still give
//   the 132 SMs thousands of blocks (split_plan picks `per` from the SM
//   count and pmax alone: the host never reads the lengths). A split
//   whose first token lies at or past its slot's length returns at once:
//   its partial is empty and no merge reads it. Inside a block
//   every warp works: a row of K or V is read by G = hd/8 lanes (rounded
//   up to a power of two), each one 8-element chunk in one vector load
//   (16 bytes of bf16, 8 of int8, two 16-byte loads of f32), converted to
//   f32 in registers. Each group of G lanes issues the loads of kUnroll
//   rows before it uses any, scores them by a shuffle sum over the group,
//   and folds them into its own online softmax (m, l, acc[8]); int8 rows
//   are dequantised by their [N, ps] row scales in registers (the score
//   and the probability take the scale). The groups merge by shuffles,
//   the warps through shared memory, and the split's (m, l, acc[hd])
//   goes to an f32 workspace. The last live split of a (slot, head) to
//   finish, found by an atomic ticket, merges the live splits' partials in
//   split order and sets the ticket back to 0, so the buffer of tickets is
//   zero again after every launch (and every CUDA graph replay). Every
//   merge is in a fixed order, so the output is bitwise repeatable, and
//   the host never reads device data, so the launch can be captured in a
//   CUDA graph. With one split the block writes the output itself.
//
// simt (other head dims), the first port: one block per (head, slot)
//   walks the slot's pages, stages each [ps, hd] K/V page in shared
//   memory as f32 (int8 rows dequantised on the way in), and folds it
//   into an online softmax in f32.
//
// Both read page_table[s, j] themselves, never read a page at or past
// `length`, and give exactly 0 for a slot of length 0.

#include "common.cuh"

namespace {

// ------------------------------------------------------------------ simt

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

// ----------------------------------------------------------------- split

namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;     // rows each lane group has in flight
constexpr int kChunk = 8;      // elements of a row one lane reads
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMergeSplits = 16;  // partials the merge stages at a time

// One lane's 8-element chunk of a row as it lies in memory, loaded in one
// go (two 16-byte loads for f32), and its conversion to f32.
template <typename P>
struct Raw;

template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void to_f32(float (&f)[kChunk]) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
};

template <>
struct Raw<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    a = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void to_f32(float (&f)[kChunk]) const {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of its f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Raw<int8_t> {
  uint2 a;
  __device__ __forceinline__ void load(const int8_t* p) {
    a = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void to_f32(float (&f)[kChunk]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = static_cast<float>(static_cast<int8_t>(a.x >> (8 * i)));
      f[4 + i] = static_cast<float>(static_cast<int8_t>(a.y >> (8 * i)));
    }
  }
};

// (m, l, acc) += (m2, l2, acc2): the online-softmax merge, in base 2.
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[kChunk],
                                      float m2, float l2,
                                      const float (&acc2)[kChunk]) {
  const float mn = fmaxf(m, m2);
  const float a = exp2f(m - mn), b = exp2f(m2 - mn);
  l = l * a + l2 * b;
#pragma unroll
  for (int e = 0; e < kChunk; ++e) acc[e] = acc[e] * a + acc2[e] * b;
  m = mn;
}

// The live length of a slot: in [0, pmax * ps].
__device__ __forceinline__ int live_length(const int* lengths, int s,
                                           int ps, int pmax) {
  return min(max(lengths[s], 0), pmax * ps);
}

// Grid (splits, H, S); kThreads threads. part: [S, H, splits, hd + 2] f32,
// each partial as (m in base 2, l, acc[hd]); tickets: [S * H]; with one
// split the block writes out [S, H, hd] itself. G lanes read one row
// (G * 8 >= hd, a power of two of at most 32). Dynamic shared memory:
// per ints of page ids,
// kWarps * (hd + 2) floats of warp partials and kMergeSplits * (hd + 2)
// floats of the merge's staged partials.
template <typename P>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const float* __restrict__ q,
                        const P* __restrict__ k_pages,
                        const P* __restrict__ v_pages,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ tickets, int N, int H, int ps,
                        int hd, int pmax, int per, int G, float scale) {
  extern __shared__ float smem[];
  int* pages = reinterpret_cast<int*>(smem);        // [per]
  float* wpart = smem + per;                        // [kWarps][hd + 2]

  const int split = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sh = static_cast<size_t>(s) * H + h;
  // issue the length, the split's page ids and the query together: none
  // waits for another (every page-table entry is in range)
  const int first = split * per;
  const int npt = min(per, pmax - first);
  int pg = 0;
  if (tid < npt) pg = page_table[static_cast<size_t>(s) * pmax + first + tid];
  for (int i = tid + kThreads; i < npt; i += kThreads)
    pages[i] = min(max(page_table[static_cast<size_t>(s) * pmax + first + i],
                       0), N - 1);
  const int cidx = lane & (G - 1);                  // this lane's chunk
  const int c0 = cidx * kChunk;
  const bool cvalid = c0 < hd;
  float qf[kChunk];                                 // the query, in base 2
#pragma unroll
  for (int e = 0; e < kChunk; ++e)
    qf[e] = cvalid ? q[sh * hd + c0 + e] * (scale * kLog2e) : 0.f;
  const int len = live_length(lengths, s, ps, pmax);
  const int tok0 = first * ps;
  const int tok1 = min(tok0 + per * ps, len);
  if (tok0 >= tok1) {
    // an empty split: no other split merges it. Split 0 is empty only in
    // a slot of length 0, whose output is exactly 0
    if (split == 0)
      for (int d = tid; d < hd; d += kThreads) out[sh * hd + d] = 0.f;
    return;
  }
  if (tid < npt) pages[tid] = min(max(pg, 0), N - 1);
  __syncthreads();

  const int per_warp = 32 / G;                      // row groups a warp has
  const int groups = kWarps * per_warp;             // NG
  const int gi = warp * per_warp + lane / G;
  const size_t head_off = static_cast<size_t>(h) * ps * hd + c0;
  const size_t page_stride = static_cast<size_t>(H) * ps * hd;

  // this group's next row: page index pi (into `pages`), row r in it
  int pi = gi / ps, r = gi - (gi / ps) * ps;
  float m = PTT_NEG_INF, l = 0.f, acc[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) acc[e] = 0.f;

  // the loop bound is the warp's first row, so all lanes of a warp run
  // the same iterations and take part in every shuffle
  for (int t0 = tok0 + warp * per_warp; t0 < tok1; t0 += groups * kUnroll) {
    Raw<P> kr[kUnroll], vr[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + (gi - warp * per_warp) + u * groups;
      ok[u] = t < tok1;
      ksc[u] = vsc[u] = 1.f;
      if (ok[u]) {
        const int page = pages[pi];
        const size_t off = page * page_stride + head_off +
                           static_cast<size_t>(r) * hd;
        if (cvalid) {
          kr[u].load(k_pages + off);
          vr[u].load(v_pages + off);
        }
        if (k_scale != nullptr) {
          ksc[u] = k_scale[static_cast<size_t>(page) * ps + r];
          vsc[u] = v_scale[static_cast<size_t>(page) * ps + r];
        }
      }
      r += groups;                                  // step on by NG rows
      while (r >= ps) {
        r -= ps;
        ++pi;
      }
    }
    float sc[kUnroll];
    float mx = PTT_NEG_INF;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.f;
      if (ok[u] && cvalid) {
        float kf[kChunk];
        kr[u].to_f32(kf);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) d = fmaf(qf[e], kf[e], d);
      }
      for (int o = G >> 1; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      sc[u] = d * ksc[u];
      if (ok[u]) mx = fmaxf(mx, sc[u]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      const float p = exp2f(sc[u] - mn);
      l += p;
      if (cvalid) {
        float vf[kChunk];
        vr[u].to_f32(vf);
        const float pv = p * vsc[u];
#pragma unroll
        for (int e = 0; e < kChunk; ++e) acc[e] = fmaf(pv, vf[e], acc[e]);
      }
    }
    m = mn;
  }

  // merge the warp's row groups (lanes G, 2G, ... apart share a chunk)
  for (int o = G; o < 32; o <<= 1) {
    float acc2[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      acc2[e] = __shfl_xor_sync(0xffffffffu, acc[e], o);
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, acc, m2, l2, acc2);
  }
  float* wp = wpart + warp * (hd + 2);
  if (lane < G && cvalid) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) wp[2 + c0 + e] = acc[e];
  }
  if (lane == 0) {
    wp[0] = m;
    wp[1] = l;
  }
  __syncthreads();
  // merge the warps in order, one thread per column
  float mb = PTT_NEG_INF;
  for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wpart[w * (hd + 2)]);
  float lb = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    const float* x = wpart + w * (hd + 2);
    lb += x[1] * exp2f(x[0] - mb);
  }
  for (int d = tid; d < hd; d += kThreads) {
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* x = wpart + w * (hd + 2);
      a += x[2 + d] * exp2f(x[0] - mb);
    }
    if (splits == 1) {
      out[sh * hd + d] = lb > 0.f ? a / lb : 0.f;
    } else {
      part[(sh * splits + split) * (hd + 2) + 2 + d] = a;
    }
  }
  if (splits == 1) return;
  if (tid == 0) {
    float* dst = part + (sh * splits + split) * (hd + 2);
    dst[0] = mb;
    dst[1] = lb;
  }

  // the last live split of (slot, head) to finish merges all of them, in
  // split order; it sets the ticket back to 0 for the next launch
  __shared__ int last;
  __syncthreads();                 // every thread's part of the partial
  const int live = (len + per * ps - 1) / (per * ps);
  if (tid == 0) {
    // release: this block's partial, ordered before by the barrier;
    // acquire: the partials of the splits that took their tickets before
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(tickets + sh)
                 : "memory");
    last = ticket == live - 1;
    if (last) tickets[sh] = 0;
  }
  __syncthreads();
  if (!last) return;
  // the live partials, kMergeSplits at a time, staged whole in shared
  // memory by one pass of loads, then folded in split order, one thread
  // per column
  const float* pp = part + sh * splits * (hd + 2);
  float* stage = wpart + kWarps * (hd + 2);   // [kMergeSplits][hd + 2]
  constexpr int kCols = (32 * kChunk + kThreads - 1) / kThreads;
  float gm = PTT_NEG_INF, gl = 0.f, ga[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) ga[c] = 0.f;
  for (int j0 = 0; j0 < live; j0 += kMergeSplits) {
    const int nj = min(kMergeSplits, live - j0);
    __syncthreads();               // the chunk before is folded
    for (int i = tid; i < nj * (hd + 2); i += kThreads)
      stage[i] = __ldcg(pp + static_cast<size_t>(j0) * (hd + 2) + i);
    __syncthreads();
    float cm = gm;
    for (int j = 0; j < nj; ++j) cm = fmaxf(cm, stage[j * (hd + 2)]);
    const float rescale = exp2f(gm - cm);
    gl *= rescale;
#pragma unroll
    for (int c = 0; c < kCols; ++c) ga[c] *= rescale;
    for (int j = 0; j < nj; ++j) {
      const float* x = stage + j * (hd + 2);
      const float w = exp2f(x[0] - cm);
      gl += x[1] * w;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tid + c * kThreads;
        if (d < hd) ga[c] += x[2 + d] * w;
      }
    }
    gm = cm;
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = tid + c * kThreads;
    if (d < hd) out[sh * hd + d] = gl > 0.f ? ga[c] / gl : 0.f;
  }
}

// Lanes per row: hd / 8 rounded up to a power of two.
inline int lanes_per_row(int hd) {
  int g = 1;
  while (g * kChunk < hd) g <<= 1;
  return g;
}

template <typename P>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* ptab,
                   const void* lens, void* out, void* part, void* tickets,
                   int S, int N, int H, int ps, int hd, int pmax, int per,
                   int splits, float scale, cudaStream_t st) {
  const size_t smem = sizeof(int) * static_cast<size_t>(per) +
                      sizeof(float) * (kWarps + kMergeSplits) * (hd + 2);
  cudaError_t err = ptt_set_smem(decode_split_kernel<P>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, H, S);
  decode_split_kernel<P><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(ptab),
      static_cast<const int*>(lens), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), N, H, ps, hd,
      pmax, per, lanes_per_row(hd), scale);
  return cudaGetLastError();
}

}  // namespace split

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

// The split route: the same arguments, plus part (the [S, H, splits,
// hd + 2] f32 workspace of the partials) and tickets ([S * H] int32, zero
// before the launch and after it), both unused with one split, per
// (page-table entries per split) and splits. hd must be a multiple of 8
// of at most 256 and the pools 16-byte aligned (ops/cuda/
// decode_attention.py checks both).
extern "C" int ptt_decode_attention_split(
    int pool_dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, void* part, void* tickets, int S, int N,
    int H, int ps, int hd, int pmax, int per, int splits, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd % split::kChunk != 0 || hd > 32 * split::kChunk || per < 1 ||
      splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (pool_dtype == PTT_F32) {
    err = split::launch<float>(q, k_pages, v_pages, nullptr, nullptr,
                               page_table, lengths, out, part, tickets, S,
                               N, H, ps, hd, pmax, per, splits, scale, st);
  } else if (pool_dtype == PTT_BF16) {
    err = split::launch<__nv_bfloat16>(q, k_pages, v_pages, nullptr,
                                       nullptr, page_table, lengths, out,
                                       part, tickets, S, N, H, ps, hd, pmax,
                                       per, splits, scale, st);
  } else if (pool_dtype == PTT_I8) {
    err = split::launch<int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                page_table, lengths, out, part, tickets, S,
                                N, H, ps, hd, pmax, per, splits, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
