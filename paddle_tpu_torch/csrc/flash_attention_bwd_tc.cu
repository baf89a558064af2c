// K3's tensor-core route: flash-attention backward on bf16 wgmma, dq and
// dk/dv from K2's saved logsumexp.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:180 _fa_bwd_dq_kernel
// and :232 _fa_bwd_dkv_kernel for bf16 with a head dim D of 64 or 128 (the
// route rule, ops/cuda/flash_attention.py flash_route);
// csrc/flash_attention_bwd.cu keeps f32 and D = 16/32. Both kernels
// recompute p = exp(s - lse) tile by tile, so the [Tq, Tk] matrices never
// reach device memory; delta = rowsum(dO * O) arrives precomputed (the
// reference computes it in XLA, :299). The TPU's two-kernel split is
// kept: each output tile is owned by exactly one block, so there are no
// atomics and the result does not depend on the order blocks run in, and
// every intermediate stays in registers.
//
// Design (csrc/flash_tc.cuh has the block shape and the box layout):
//   * flash_attention_bwd_dq: work items of (batch * head, 128 query
//     rows); Q and dO resident, K and V tiles of 64 keys stream through
//     the ring. Per tile and consumer warpgroup (64 query rows):
//     S = Q K^T and dP = dO V^T (K and V tiles K-major), then
//     P = 2^(S scale log2 e - lse log2 e) masked to 0,
//     dS / scale = P (dP - delta), packed to bf16 in registers, and
//     dq += (dS / scale) K (register A, K tile MN-major); the scale
//     multiplies dq once, at the store.
//   * flash_attention_bwd_dkv: work items of (batch * head, 128 kv rows);
//     K and V resident, Q and dO tiles of 64 queries stream through the
//     ring with their 64 lse (times log2 e) and delta values, which the
//     producer warp's 32 lanes copy beside each stage. Per tile and
//     consumer warpgroup (64 kv rows): S^T = K Q^T and dP^T = V dO^T (Q and
//     dO tiles K-major), P^T and dS^T / scale as above, then
//     dv += P^T dO and dk += (dS^T / scale) Q (register A, dO and Q tiles
//     MN-major), dk scaled at the store. At D = 64 that
//     is four 32-register f32 accumulators per consumer thread.
//   * Overlap: the last products of a tile (dq, or dv and dk) are left
//     running while the warpgroup waits for the next tile and issues its
//     first two, and the two warpgroups take turns to issue those
//     (flash_tc::Pingpong), so one's elementwise work overlaps the
//     other's products.
//
// Semantics kept from the TPU kernels and the simt route: bottom-right
// causal alignment, the causal skip as loop bounds (dq stops at the last
// kv tile touching the diagonal, dk/dv starts at the first query tile
// that does; the tiles that visit the most partner tiles are walked
// first), the key-padding mask [B, Tk], tail rows read as zeros (3-D
// tensor maps) and masked; a pair that does not attend gives p exactly 0
// (selected, so a fully masked row's overflowed exp(s - lse) is
// discarded), so such rows and keys give exactly 0.
//
// Numerics: the products of bf16 inputs are exact in f32 and every
// accumulator is f32. The roundings this route adds are P's and
// (dS / scale)'s to bf16 (2^-9 relative each) before the products that
// take them as their A operand. Each output is one bf16 rounding of an
// f32 accumulator (dq and dk times the scale, in f32).
//
// What bounds it on the H100: the products, 3 (dq) and 4 (dk/dv) per
// attended pair and head dim at 989 T/s of bf16, with one exponential
// per pair each at 3.9 T/s: 384 and 512 product operations per
// exponential at D = 64, so the exponentials are less exposed than in
// the forward. The two-kernel split does 7 products where a fused
// backward with atomic dq does 5.

#include "flash_tc.cuh"

namespace {

using flash_tc::kBoxBytes;
using flash_tc::kRows;
using flash_tc::kThreads;
constexpr int kTile = 64;     // streamed rows per stage (keys or queries)

template <int kD>
struct Bwd {
  static constexpr int kHalves = kD / 64;
  // ring depth: 2 is what fits at D = 128 (8 at D = 64 measured no
  // faster than 4)
  static constexpr int kStages = kD == 64 ? 4 : 2;
  static constexpr int kResBytes = 2 * 2 * kHalves * kBoxBytes;   // 2 x 128
  static constexpr int kTileBytes = kHalves * kBoxBytes;          // 64 rows
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr size_t kSmem =
      1024 + 2 * kResBytes + static_cast<size_t>(kStages) * kStageBytes +
      kStages * 2 * kTile * sizeof(float) + 8 * (2 * kStages + 4);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct Params {
  const float* lse;         // [B * H, tq]
  const float* delta;       // [B * H, tq]
  const int* mask;          // [B, tk] int32 or null
  __nv_bfloat16* d0;        // dq, or dk
  __nv_bfloat16* d1;        // dv (dk/dv kernel)
  int BH, H, tq, tk, causal;
  float scale;
};

// The shared memory of both kernels: the resident tiles (two buffers of
// 2 tensors x 2 warpgroups x D / 64 boxes), the ring, the dk/dv kernel's
// per-stage lse and delta, the barriers.
template <int kD>
struct Smem {
  using C = Bwd<kD>;
  uint8_t* res;
  uint8_t* ring;
  float* side;              // [kStages][2][kTile]: lse * log2 e, delta
  uint64_t* full;
  uint64_t* empty;
  uint64_t* res_full;       // [2]
  uint64_t* res_empty;      // [2]
  __device__ explicit Smem(uint8_t* raw) {
    res = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    ring = res + 2 * C::kResBytes;
    side = reinterpret_cast<float*>(ring + C::kStages * C::kStageBytes);
    full = reinterpret_cast<uint64_t*>(side + C::kStages * 2 * kTile);
    empty = full + C::kStages;
    res_full = empty + C::kStages;
    res_empty = res_full + 2;
  }
  // box (buffer, tensor t, warpgroup w, column half c) of the resident
  // tiles
  __device__ uint8_t* res_box(int buf, int t, int w, int c) const {
    return res + buf * C::kResBytes +
           ((t * 2 + w) * C::kHalves + c) * kBoxBytes;
  }
  __device__ void init(int full_arrivals) const {
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(full + i, full_arrivals);
      hopper::mbar_init(empty + i, 8);      // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(res_full + i, 1);
      hopper::mbar_init(res_empty + i, 8);
    }
    hopper::mbar_fence_init();
  }
};

// Load an item's resident tiles into its buffer: tensors a and b, rows
// r0 .. r0 + 127 of matrix bh, once the buffer's previous item is done.
template <int kD>
__device__ __forceinline__ void load_resident(const Smem<kD>& sm,
                                              const flash_tc::Walk& w,
                                              const CUtensorMap* a,
                                              const CUtensorMap* b, int r0) {
  uint64_t* bar = sm.res_full + w.buf();
  hopper::mbar_wait(sm.res_empty + w.buf(), w.parity() ^ 1);
  hopper::mbar_expect_tx(bar, Bwd<kD>::kResBytes);
  for (int g = 0; g < 2; ++g)
    for (int c = 0; c < Bwd<kD>::kHalves; ++c) {
      hopper::tma_load_3d(sm.res_box(w.buf(), 0, g, c), a, bar, 64 * c,
                          r0 + 64 * g, w.bh);
      hopper::tma_load_3d(sm.res_box(w.buf(), 1, g, c), b, bar, 64 * c,
                          r0 + 64 * g, w.bh);
    }
}

// Load one stage: rows t0 .. t0 + 63 of tensors a and b.
template <int kD>
__device__ __forceinline__ void load_stage(uint8_t* st, uint64_t* bar,
                                           const CUtensorMap* a,
                                           const CUtensorMap* b, int t0,
                                           int bh) {
  hopper::mbar_expect_tx(bar, Bwd<kD>::kStageBytes);
  for (int c = 0; c < Bwd<kD>::kHalves; ++c) {
    hopper::tma_load_3d(st + c * kBoxBytes, a, bar, 64 * c, t0, bh);
    hopper::tma_load_3d(st + Bwd<kD>::kTileBytes + c * kBoxBytes, b, bar,
                        64 * c, t0, bh);
  }
}

// This warp is done with a ring stage or a resident buffer.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(bar);
}

// Store a warpgroup's [64, kD] f32 accumulator times f as bf16 rows
// r < rows.
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[kD / 2],
                                           int row0, int rows, int r0,
                                           int cq, float f) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = row0 + r0 + 8 * a;
    if (r >= rows) continue;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i)
      flash_tc::store_pair(dst + static_cast<size_t>(r) * kD + 8 * i + cq,
                           acc[4 * i + 2 * a] * f,
                           acc[4 * i + 2 * a + 1] * f);
  }
}

// ------------------------------------------------------------------ dq

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const Params p) {
  using C = Bwd<kD>;
  extern __shared__ uint8_t smem_raw[];
  const Smem<kD> sm(smem_raw);
  const int tiles = (p.tq + kRows - 1) / kRows;
  const int off = p.tk - p.tq;
  if (threadIdx.x == 0) sm.init(1);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // --------------------------------------------------------- producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      hopper::Ring pos(C::kStages);
      // causal: the query tiles that visit the most kv tiles go first
      for (flash_tc::Walk w = flash_tc::walk_start();
           w.next(p.BH, tiles, p.causal, true);) {
        const int q0 = w.tile * kRows;
        load_resident(sm, w, &tm_q, &tm_do, q0);
        const int nkv = flash_tc::kv_tiles(q0, kRows, p.tq, p.tk, off,
                                           p.causal, kTile);
        for (int t = 0; t < nkv; ++t) {
          hopper::mbar_wait(sm.empty + pos.stage, pos.phase ^ 1);
          load_stage<kD>(sm.ring + pos.stage * C::kStageBytes,
                         sm.full + pos.stage, &tm_k, &tm_v, t * kTile, w.bh);
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
  const int cq = 2 * (lane & 3);
  const float sc = p.scale * hopper::kLog2e;
  const flash_tc::Pingpong turn{wg};
  turn.start();
  hopper::Ring pos(C::kStages);
  for (flash_tc::Walk w = flash_tc::walk_start();
       w.next(p.BH, tiles, p.causal, true);) {
    const int qw = w.tile * kRows + 64 * wg;   // this warpgroup's first row
    const int b = w.bh / p.H;
    const int nkv = flash_tc::kv_tiles(w.tile * kRows, kRows, p.tq, p.tk,
                                       off, p.causal, kTile);
    float lse2[2], dlt[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int q = qw + r0 + 8 * a;
      const bool ok = q < p.tq;
      const size_t row = static_cast<size_t>(w.bh) * p.tq + q;
      lse2[a] = ok ? p.lse[row] * hopper::kLog2e : 0.f;
      dlt[a] = ok ? p.delta[row] : 0.f;
    }
    float dq[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;

    // Per tile t: S_t and dP_t in this warpgroup's pingpong turn; their
    // wait also brings in the previous tile's dq product, which ran
    // behind them; then dS_t in registers and dq += dS_t K_t, left
    // running.
    hopper::mbar_wait(sm.res_full + w.buf(), w.parity());
    const uint8_t* qa = sm.res_box(w.buf(), 0, wg, 0);
    const uint8_t* doa = sm.res_box(w.buf(), 1, wg, 0);
    int prev = -1;
    uint32_t pa[kTile / 16][4];
    for (int t = 0; t < nkv; ++t) {
      const int k0 = t * kTile;
      const uint8_t* ks = sm.ring + pos.stage * C::kStageBytes;
      const uint8_t* vs = ks + C::kTileBytes;
      hopper::mbar_wait(sm.full + pos.stage, pos.phase);
      turn.take();
      float s[kTile / 2], dp[kTile / 2];
      hopper::wgmma_fence();
      flash_tc::product_abt<kTile, kD>(s, qa, kBoxBytes, ks);
      flash_tc::product_abt<kTile, kD>(dp, doa, kBoxBytes, vs);
      hopper::wgmma_commit();
      turn.give();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::fence_regs(dq);
      hopper::fence_regs(pa);
      if (prev >= 0) release(sm.empty + prev);   // dq product of t - 1

      // dS / scale (the scale goes onto dq at the store); pairs that do
      // not attend get p = 0 exactly
      if (flash_tc::needs_mask(qw, 64, k0, kTile, p.tq, p.tk, off,
                               p.causal, p.mask)) {
#pragma unroll
        for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * i + cq + e;
            const bool ok = flash_tc::key_ok(key, p.tk, p.mask, b);
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const int x = 4 * i + 2 * a + e;
              const float pr =
                  flash_tc::attends(qw + r0 + 8 * a, key, ok, p.tq, off,
                                    p.causal)
                      ? hopper::ex2(fmaf(s[x], sc, -lse2[a]))
                      : 0.f;
              s[x] = pr * (dp[x] - dlt[a]);
            }
          }
      } else {
#pragma unroll
        for (int x = 0; x < kTile / 2; ++x) {
          const int a = (x >> 1) & 1;
          s[x] = hopper::ex2(fmaf(s[x], sc, -lse2[a])) * (dp[x] - dlt[a]);
        }
      }
      flash_tc::pack_a<kTile>(s, pa);
      hopper::wgmma_fence();
      flash_tc::product_pb<kTile, kD>(dq, pa, ks);
      hopper::wgmma_commit();
      prev = pos.stage;
      pos.next();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    release(sm.res_empty + w.buf());
    if (prev >= 0) release(sm.empty + prev);
    store_rows<kD>(p.d0 + static_cast<size_t>(w.bh) * p.tq * kD, dq, qw,
                   p.tq, r0, cq, p.scale);
  }
  turn.finish();
}

// ---------------------------------------------------------------- dk/dv

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const Params p) {
  using C = Bwd<kD>;
  extern __shared__ uint8_t smem_raw[];
  const Smem<kD> sm(smem_raw);
  const int tiles = (p.tk + kRows - 1) / kRows;
  const int off = p.tk - p.tq;
  const int nq = (p.tq + kTile - 1) / kTile;
  // the TMA bytes and one arrival from each producer lane, which writes
  // its part of the stage's lse and delta first
  if (threadIdx.x == 0) sm.init(1 + 32);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    // ---------------------------------------------------- producer warp
    hopper::reg_dealloc<40>();
    if (threadIdx.x < 256 + 32) {
      hopper::Ring pos(C::kStages);
      // causal: kv tile 0, which meets the most query tiles, goes first
      for (flash_tc::Walk w = flash_tc::walk_start();
           w.next(p.BH, tiles, p.causal, false);) {
        const int k0 = w.tile * kRows;
        if (lane == 0) load_resident(sm, w, &tm_k, &tm_v, k0);
        const size_t base = static_cast<size_t>(w.bh) * p.tq;
        // lane j copies the lse (times log2 e) and delta of queries j and
        // j + 32 of a tile, read one tile ahead, so that the loads' latency
        // passes while the lane waits for the next free stage
        float ahead[4];
        auto read = [&](int t) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = t * kTile + lane + 32 * h;
            const bool ok = q < p.tq;
            ahead[2 * h] = ok ? p.lse[base + q] * hopper::kLog2e : 0.f;
            ahead[2 * h + 1] = ok ? p.delta[base + q] : 0.f;
          }
        };
        const int qb = flash_tc::first_q_tile(k0, off, p.causal, kTile);
        if (qb < nq) read(qb);
        for (int t = qb; t < nq; ++t) {
          hopper::mbar_wait(sm.empty + pos.stage, pos.phase ^ 1);
          if (lane == 0)
            load_stage<kD>(sm.ring + pos.stage * C::kStageBytes,
                           sm.full + pos.stage, &tm_q, &tm_do, t * kTile,
                           w.bh);
          float* side = sm.side + pos.stage * 2 * kTile;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            side[lane + 32 * h] = ahead[2 * h];
            side[kTile + lane + 32 * h] = ahead[2 * h + 1];
          }
          hopper::mbar_arrive(sm.full + pos.stage);
          pos.next();
          if (t + 1 < nq) read(t + 1);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  hopper::reg_alloc<232>();
  const int r0 = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float sc = p.scale * hopper::kLog2e;
  const flash_tc::Pingpong turn{wg};
  turn.start();
  hopper::Ring pos(C::kStages);
  for (flash_tc::Walk w = flash_tc::walk_start();
       w.next(p.BH, tiles, p.causal, false);) {
    const int k0 = w.tile * kRows;
    const int kw = k0 + 64 * wg;           // this warpgroup's first key
    const int b = w.bh / p.H;
    const int qb = flash_tc::first_q_tile(k0, off, p.causal, kTile);
    bool key_ok[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int key = kw + r0 + 8 * a;
      key_ok[a] = flash_tc::key_ok(key, p.tk, p.mask, b);
    }
    float dk[kD / 2], dv[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;

    // Per query tile t: S^T_t and dP^T_t in this warpgroup's pingpong
    // turn; their wait also brings in the previous tile's dv and dk
    // products; then P^T_t and dS^T_t in registers and dv += P^T dO_t,
    // dk += dS^T Q_t, left running.
    hopper::mbar_wait(sm.res_full + w.buf(), w.parity());
    const uint8_t* ka = sm.res_box(w.buf(), 0, wg, 0);
    const uint8_t* va = sm.res_box(w.buf(), 1, wg, 0);
    int prev = -1;
    uint32_t pp[kTile / 16][4], pd[kTile / 16][4];
    for (int t = qb; t < nq; ++t) {
      const int q0 = t * kTile;
      const uint8_t* qs = sm.ring + pos.stage * C::kStageBytes;
      const uint8_t* dos = qs + C::kTileBytes;
      const float* side = sm.side + pos.stage * 2 * kTile;
      hopper::mbar_wait(sm.full + pos.stage, pos.phase);
      turn.take();
      float st[kTile / 2], dpt[kTile / 2];
      hopper::wgmma_fence();
      flash_tc::product_abt<kTile, kD>(st, ka, kBoxBytes, qs);
      flash_tc::product_abt<kTile, kD>(dpt, va, kBoxBytes, dos);
      hopper::wgmma_commit();
      turn.give();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      hopper::fence_regs(pp);
      hopper::fence_regs(pd);
      if (prev >= 0) release(sm.empty + prev);   // products of t - 1

      // P^T, and dS^T / scale (the scale goes onto dk at the store);
      // pairs that do not attend get p = 0 exactly
      const bool need = flash_tc::needs_mask(q0, kTile, kw, 64, p.tq, p.tk,
                                             off, p.causal, p.mask);
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) {
        const float2 lse2 =
            *reinterpret_cast<const float2*>(side + 8 * i + cq);
        const float2 dlt =
            *reinterpret_cast<const float2*>(side + kTile + 8 * i + cq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + 8 * i + cq + e;
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int x = 4 * i + 2 * a + e;
            float pr = hopper::ex2(fmaf(st[x], sc, -(e ? lse2.y : lse2.x)));
            if (need) {
              const int key = kw + r0 + 8 * a;
              if (!flash_tc::attends(q, key, key_ok[a], p.tq, off, p.causal))
                pr = 0.f;
            }
            st[x] = pr;
            dpt[x] = pr * (dpt[x] - (e ? dlt.y : dlt.x));
          }
        }
      }
      flash_tc::pack_a<kTile>(st, pp);
      flash_tc::pack_a<kTile>(dpt, pd);
      hopper::wgmma_fence();
      flash_tc::product_pb<kTile, kD>(dv, pp, dos);
      flash_tc::product_pb<kTile, kD>(dk, pd, qs);
      hopper::wgmma_commit();
      prev = pos.stage;
      pos.next();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    release(sm.res_empty + w.buf());
    if (prev >= 0) release(sm.empty + prev);
    const size_t base = static_cast<size_t>(w.bh) * p.tk * kD;
    store_rows<kD>(p.d0 + base, dk, kw, p.tk, r0, cq, p.scale);
    store_rows<kD>(p.d1 + base, dv, kw, p.tk, r0, cq, 1.f);
  }
  turn.finish();
}

template <int kD, bool kDq>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const Params& p, cudaStream_t st) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = hopper::encode_bf16_boxes_3d(&tm_q, q, p.BH, p.tq, kD);
  if (err == cudaSuccess)
    err = hopper::encode_bf16_boxes_3d(&tm_do, dout, p.BH, p.tq, kD);
  if (err == cudaSuccess)
    err = hopper::encode_bf16_boxes_3d(&tm_k, k, p.BH, p.tk, kD);
  if (err == cudaSuccess)
    err = hopper::encode_bf16_boxes_3d(&tm_v, v, p.BH, p.tk, kD);
  const int rows = kDq ? p.tq : p.tk;
  int grid = 0;
  if (err == cudaSuccess)
    err = flash_tc::persistent_grid(p.BH * ((rows + kRows - 1) / kRows),
                                    &grid);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Bwd<kD>::kSmem;
  if (kDq) {
    err = ptt_set_smem(fa_bwd_dq_tc_kernel<kD>, smem);
    if (err != cudaSuccess) return err;
    fa_bwd_dq_tc_kernel<kD><<<grid, kThreads, smem, st>>>(tm_q, tm_k, tm_v,
                                                          tm_do, p);
  } else {
    err = ptt_set_smem(fa_bwd_dkv_tc_kernel<kD>, smem);
    if (err != cudaSuccess) return err;
    fa_bwd_dkv_tc_kernel<kD><<<grid, kThreads, smem, st>>>(tm_q, tm_k, tm_v,
                                                           tm_do, p);
  }
  return cudaGetLastError();
}

template <bool kDq>
int run(const void* q, const void* k, const void* v, const void* dout,
        const Params& p, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = launch<64, kDq>(q, k, v, dout, p, st);
  else if (D == 128)
    err = launch<128, kDq>(q, k, v, dout, p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// q, dout [B, H, tq, D]; k, v [B, H, tk, D]; bf16, 16-byte aligned; lse,
// delta [B*H, tq] f32; kv_mask [B, tk] int32 or null; dq like q. D in
// {64, 128}; tq, tk >= 1.
extern "C" int ptt_flash_attention_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask, void* dq, int B,
    int H, int tq, int tk, int D, float scale, int causal, void* stream) {
  const Params p{static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<const int*>(kv_mask),
                 static_cast<__nv_bfloat16*>(dq), nullptr, B * H, H, tq,
                 tk, causal, scale};
  return run<true>(q, k, v, dout, p, D, stream);
}

// As above; dk, dv like k.
extern "C" int ptt_flash_attention_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask, void* dk,
    void* dv, int B, int H, int tq, int tk, int D, float scale, int causal,
    void* stream) {
  const Params p{static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<const int*>(kv_mask),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), B * H, H, tq, tk, causal,
                 scale};
  return run<false>(q, k, v, dout, p, D, stream);
}
