// K2's tensor-core route: flash-attention forward on bf16 wgmma, out and
// per-row logsumexp.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:64 _fa_kernel for
// bf16 q, k, v with a head dim D of 64 or 128 (the route rule,
// ops/cuda/flash_attention.py flash_route); csrc/flash_attention.cu keeps
// f32 and D = 16/32. The TPU kernel's sequential kv grid axis, which
// carries (m, l, acc) in VMEM, becomes a loop over the kv tiles for each
// work item (batch * head, 128-row query tile) of a persistent block.
//
// Design (csrc/flash_tc.cuh has the block shape and the box layout):
//   * An item's 128 Q rows arrive once by TMA, into one of two buffers;
//     K and V tiles of kBK keys (128 at D = 64, 64 at D = 128) stream
//     through a ring of kStages stages.
//   * Each consumer warpgroup owns 64 query rows: S = Q K^T is m64 x kBK
//     (D / 16 wgmma, K tile K-major), the online softmax runs on the
//     accumulator fragment (row max and sum over a quad's lanes, 2^x by
//     hopper::ex2 on scores prescaled by scale * log2 e), and O += P V
//     takes P straight from those registers, packed to bf16, as the
//     register A operand (kBK / 16 wgmma, V tile MN-major): P never
//     touches shared memory. The row sum l is kept per lane and summed
//     over the quad once, at the end.
//   * Overlap (FlashAttention-3's two kinds): each warpgroup issues S for
//     tile t together with O += P V of tile t - 1 and runs the softmax of
//     S_t while that product is still on the tensor cores; and the two
//     warpgroups take turns to issue (flash_tc::Pingpong), so one's
//     softmax overlaps the other's products.
//
// Semantics kept from the TPU kernel and the simt route: bottom-right
// causal alignment (query row i sees keys <= i + tk - tq), the causal
// skip as the kv loop's bound, with the query tiles that visit the most
// kv tiles walked first; the key-padding mask [B, Tk]; masked scores
// are -inf, so their probabilities are exactly 0 (not only small); a
// fully masked row gives out exactly 0 and lse = -1e30 + log(1e-30), as
// chunked_attention (ops/cuda/flash_attention.py) gives it; lse in f32.
//
// Numerics: products of bf16 inputs are exact in f32, and the
// accumulators are f32. The one rounding this route adds is P's to bf16
// (2^-9 relative) before O += P V; l sums the f32 probabilities. out is
// one bf16 rounding of the f32 O / l.
//
// What bounds it on the H100: at D = 64 the exponentials as much as the
// products: 4 D = 256 operations of the tensor cores (989 T/s) per score
// against one exponential of the special-function units (3.9 T/s), both
// about 0.26 ps per score; bytes are far below either.

#include "flash_tc.cuh"

namespace {

using flash_tc::kBoxBytes;
using flash_tc::kRows;
using flash_tc::kThreads;

template <int kD>
struct Fwd {
  static constexpr int kBK = kD == 64 ? 128 : 64;   // keys per kv tile
  static constexpr int kHalves = kD / 64;
  static constexpr int kQBytes = 2 * kHalves * kBoxBytes;   // 128 rows
  static constexpr int kTileBytes = (kBK / 64) * kHalves * kBoxBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;   // K and V
  // ring depth (6 stages at D = 64 measured no faster)
  static constexpr int kStages = 4;
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + static_cast<size_t>(kStages) * kStageBytes +
      8 * (2 * kStages + 4);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct Params {
  const int* mask;          // [B, tk] int32 or null
  __nv_bfloat16* out;       // [B * H, tq, D]
  float* lse;               // [B * H, tq]
  int BH, H, tq, tk, causal;
  float scale;
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    fa_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  using C = Fwd<kD>;
  constexpr int kBK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = q_s + 2 * C::kQBytes;     // Q: two buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages *
                                               C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* q_full = empty + C::kStages;    // [2]
  uint64_t* q_empty = q_full + 2;           // [2]

  const int tiles = (p.tq + kRows - 1) / kRows;
  const int off = p.tk - p.tq;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 8);    // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(q_full + i, 1);
      hopper::mbar_init(q_empty + i, 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // --------------------------------------------------------- producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      hopper::Ring pos(C::kStages);
      for (flash_tc::Walk w = flash_tc::walk_start();
           w.next(p.BH, tiles, p.causal, true);) {
        const int q0 = w.tile * kRows;
        uint8_t* qb = q_s + w.buf() * C::kQBytes;
        hopper::mbar_wait(q_empty + w.buf(), w.parity() ^ 1);
        hopper::mbar_expect_tx(q_full + w.buf(), C::kQBytes);
        for (int g = 0; g < 2; ++g)
          for (int c = 0; c < C::kHalves; ++c)
            hopper::tma_load_3d(qb + (g * C::kHalves + c) * kBoxBytes, &tm_q,
                                q_full + w.buf(), 64 * c, q0 + 64 * g, w.bh);
        const int nkv = flash_tc::kv_tiles(q0, kRows, p.tq, p.tk, off,
                                           p.causal, kBK);
        for (int t = 0; t < nkv; ++t) {
          uint8_t* st = ring + pos.stage * C::kStageBytes;
          uint64_t* bar = full + pos.stage;
          hopper::mbar_wait(empty + pos.stage, pos.phase ^ 1);
          hopper::mbar_expect_tx(bar, C::kStageBytes);
          for (int c = 0; c < C::kHalves; ++c)
            for (int rb = 0; rb < kBK / 64; ++rb) {
              const int box = (c * (kBK / 64) + rb) * kBoxBytes;
              hopper::tma_load_3d(st + box, &tm_k, bar, 64 * c,
                                  t * kBK + 64 * rb, w.bh);
              hopper::tma_load_3d(st + C::kTileBytes + box, &tm_v, bar,
                                  64 * c, t * kBK + 64 * rb, w.bh);
            }
          pos.next();
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  hopper::reg_alloc<232>();
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const int cq = 2 * (lane & 3);           // first column of a pair
  const float sc = p.scale * hopper::kLog2e;
  const flash_tc::Pingpong turn{wg};
  turn.start();
  hopper::Ring pos(C::kStages);

  for (flash_tc::Walk w = flash_tc::walk_start();
       w.next(p.BH, tiles, p.causal, true);) {
    const int qw = w.tile * kRows + 64 * wg;   // this warpgroup's first row
    const int b = w.bh / p.H;
    const int nkv = flash_tc::kv_tiles(w.tile * kRows, kRows, p.tq, p.tk,
                                       off, p.causal, kBK);
    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m[2] = {PTT_NEG_INF, PTT_NEG_INF}, l[2] = {0.f, 0.f};
    float s[kBK / 2], alpha[2];
    uint32_t pa[kBK / 16][4];

    // Scores of tile t into the log2 domain's probabilities, in place:
    // masked scores are -inf (their probability exactly 0), m and l move
    // on, alpha takes the factor the accumulator must be scaled by.
    auto softmax = [&](int t) {
      const int k0 = t * kBK;
      if (flash_tc::needs_mask(qw, 64, k0, kBK, p.tq, p.tk, off, p.causal,
                               p.mask)) {
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * i + cq + e;
            const bool ok = flash_tc::key_ok(key, p.tk, p.mask, b);
#pragma unroll
            for (int a = 0; a < 2; ++a)
              if (!flash_tc::attends(qw + r0 + 8 * a, key, ok, p.tq, off,
                                     p.causal))
                s[4 * i + 2 * a + e] = flash_tc::neg_inf();
          }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float mx = flash_tc::neg_inf();
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i)
          mx = fmaxf(mx, fmaxf(s[4 * i + 2 * a], s[4 * i + 2 * a + 1]));
        // the scale is positive: the max of the scaled scores is the
        // scaled max (and -inf stays -inf)
        const float mn = fmaxf(m[a], flash_tc::quad_max(mx) * sc);
        alpha[a] = hopper::ex2(m[a] - mn);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * i + 2 * a + e];
            x = hopper::ex2(fmaf(x, sc, -mn));
            sum += x;
          }
        l[a] = l[a] * alpha[a] + sum;
        m[a] = mn;
      }
    };

    // Per tile t: S_t = Q K_t^T is issued together with the previous
    // tile's O += P V, in this warpgroup's pingpong turn; the softmax of
    // S_t runs while that product is still on the tensor cores, and only
    // then is O rescaled and P_t packed over P_t-1.
    hopper::mbar_wait(q_full + w.buf(), w.parity());
    const uint8_t* qa = q_s + w.buf() * C::kQBytes +
                        wg * C::kHalves * kBoxBytes;
    if (nkv > 0) {
      hopper::mbar_wait(full + pos.stage, pos.phase);
      turn.take();
      hopper::wgmma_fence();
      flash_tc::product_abt<kBK, kD>(s, qa, kBoxBytes,
                                     ring + pos.stage * C::kStageBytes);
      hopper::wgmma_commit();
      turn.give();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      softmax(0);
      flash_tc::pack_a<kBK>(s, pa);
    }
    for (int t = 1; t < nkv; ++t) {
      const int prev = pos.stage;
      pos.next();
      hopper::mbar_wait(full + pos.stage, pos.phase);
      turn.take();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::wgmma_fence();
      flash_tc::product_abt<kBK, kD>(s, qa, kBoxBytes,
                                     ring + pos.stage * C::kStageBytes);
      hopper::wgmma_commit();
      flash_tc::product_pb<kBK, kD>(
          o, pa, ring + prev * C::kStageBytes + C::kTileBytes);
      hopper::wgmma_commit();
      turn.give();
      hopper::wgmma_wait<1>();              // S_t is in
      hopper::fence_regs(s);
      softmax(t);
      hopper::wgmma_wait<0>();              // O += P_t-1 V_t-1 is in
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + prev);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < kD / 8; ++i) {
          o[4 * i + 2 * a] *= alpha[a];
          o[4 * i + 2 * a + 1] *= alpha[a];
        }
      flash_tc::pack_a<kBK>(s, pa);
    }
    // Q is read by no product after the last S: its buffer goes back
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(q_empty + w.buf());
    if (nkv > 0) {                          // the last tile's O += P V
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::wgmma_fence();
      flash_tc::product_pb<kBK, kD>(
          o, pa, ring + pos.stage * C::kStageBytes + C::kTileBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + pos.stage);
      pos.next();
    }

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float sum = flash_tc::quad_sum(l[a]);
      const int q = qw + r0 + 8 * a;
      if (q >= p.tq) continue;
      const size_t row = static_cast<size_t>(w.bh) * p.tq + q;
      const float inv = sum > 0.f ? 1.0f / sum : 0.f;
#pragma unroll
      for (int i = 0; i < kD / 8; ++i)
        flash_tc::store_pair(p.out + row * kD + 8 * i + cq,
                             o[4 * i + 2 * a] * inv,
                             o[4 * i + 2 * a + 1] * inv);
      if ((lane & 3) == 0)
        p.lse[row] = sum > 0.f ? m[a] * flash_tc::kLn2 + logf(sum)
                               : PTT_NEG_INF + logf(1e-30f);
    }
  }
  turn.finish();
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Params& p, cudaStream_t st) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = hopper::encode_bf16_boxes_3d(&tm_q, q, p.BH, p.tq, kD);
  if (err == cudaSuccess)
    err = hopper::encode_bf16_boxes_3d(&tm_k, k, p.BH, p.tk, kD);
  if (err == cudaSuccess)
    err = hopper::encode_bf16_boxes_3d(&tm_v, v, p.BH, p.tk, kD);
  int grid = 0;
  if (err == cudaSuccess)
    err = flash_tc::persistent_grid(p.BH * ((p.tq + kRows - 1) / kRows),
                                    &grid);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Fwd<kD>::kSmem;
  err = ptt_set_smem(fa_fwd_tc_kernel<kD>, smem);
  if (err != cudaSuccess) return err;
  fa_fwd_tc_kernel<kD><<<grid, kThreads, smem, st>>>(tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, tq, D], k/v [B, H, tk, D] bf16, 16-byte aligned; kv_mask
// [B, tk] int32 or null; out like q, lse [B*H, tq] f32. D in {64, 128};
// tk >= 1.
extern "C" int ptt_flash_attention_tc(const void* q, const void* k,
                                      const void* v, const void* kv_mask,
                                      void* out, void* lse, int B, int H,
                                      int tq, int tk, int D, float scale,
                                      int causal, void* stream) {
  const Params p{static_cast<const int*>(kv_mask),
                 static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
                 B * H, H, tq, tk, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = launch<64>(q, k, v, p, st);
  else if (D == 128)
    err = launch<128>(q, k, v, p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
