// K3's f32 route on 3xTF32 wgmma ("tf32x3"): flash-attention backward, dq
// and dk/dv from K2's saved logsumexp, at f32 accuracy on the tensor
// cores.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:180 _fa_bwd_dq_kernel
// and :232 _fa_bwd_dkv_kernel (launched at :332 and :356 by
// _flash_attention_bwd_tpu :289; delta = rowsum(dO * O) computed in XLA,
// :298-300, and here in torch) for f32 with a head dim D of 64 (the route
// rule, ops/cuda/flash_attention.py flash_bwd_route);
// csrc/flash_attention_bwd.cu keeps f32 at D = 16, 32 and 128. Both
// kernels recompute p = exp(s - lse) tile by tile, so the [Tq, Tk]
// matrices never reach device memory. The TPU's two-kernel split is
// kept: each output tile is owned by one block, so there are no atomics
// and the result does not depend on the order blocks run in.
//
// Products. Each f32 operand x is split hi = tf32(x), lo = tf32(x - hi)
// (hopper.cuh) and each product is lo·hi + hi·lo + hi·hi in the f32
// accumulator: 3 TF32 products each for S = Q K^T, dP = dO V^T and
// dQ = dS K (dq), for S^T = K Q^T, dP^T = V dO^T, dV = P^T dO and
// dK = dS^T Q (dk/dv). P and dS are not rounded to bf16, as the tc route
// rounds them: they are split in registers and enter the last products
// as tf32 register-A fragments.
//
// No transpose. TF32 wgmma reads both operands K-major. S and dP (S^T
// and dP^T) reduce over D, and their operands are K-major as stored. dQ,
// dV and dK reduce over the streamed rows, so their B operands as stored
// (K; dO and Q: [rows, D]) are MN-major: the pass that splits a streamed
// tile also stages it transposed, rows = D, each k8 slice's K positions
// permuted (tile row 2j to position j, 2j + 1 to j + 4, as xent.cu
// stages K6's X^T; split_staged), so that the column pair (2q, 2q + 1) that
// the first products' accumulator gives a thread is the pair (q, q + 4)
// of its tf32 A fragment: P and dS pass from accumulator to register A
// without shared memory. The other known way, the transposed products
// (dQ^T = K^T dS^T), would write P and dS to shared memory and store
// the outputs transposed; staging B keeps them in registers.
//
// Shared memory (227 KB a block; a [64, 64] f32 tile is 16 KB, 32 KB
// with its lo part):
//   * dq: Q and dO of 64 resident query rows, hi and lo, 64 KB; a ring of
//     2 stages of raw K and V tiles (64 keys each, split in place to
//     their hi parts), 64 KB; K's and V's lo parts, 32 KB, and the staged
//     K^T, hi and lo, twice (tile t's split writes one while tile t - 1's
//     dq product reads the other), 64 KB: 225 KB.
//   * dk/dv: K and V of 64 resident keys, hi and lo, 64 KB; a ring of 2
//     stages of raw Q and dO tiles (64 queries), 64 KB; their lo parts
//     and the staged Q^T and dO^T, hi and lo, 96 KB (no room for a second
//     pair); the tile's lse and delta: 226 KB.
// The bf16 route's block (128 resident rows in two warpgroups and a
// 4-stage ring) would need 2.5-3x that in f32 with lo parts, so a block
// here is one warpgroup over 64 resident rows, one block an SM, and its
// thread 0 issues the TMA loads. D = 128 doubles every tile and does not
// fit; it stays on the SIMT route.
//
// Per streamed tile: wait for its stage; split it by all 128 threads (hi
// in place, lo, the staged transposed copies), in dq while the last
// tile's dq product runs, in dk/dv dO while the last tile's dk product
// runs (its dv product done) and Q once that is done; the first products
// (S, then dP, each its own commit group), P computed while dP runs;
// refill the stage two tiles ahead; dS; P and dS split into register
// fragments; the final products (dQ, or dV then dK) left running into
// the next tile. Each split writes its float4s so that the 8 threads of
// a quarter warp meet distinct bank groups (split_staged). Blocks run
// the work items that visit the most streamed tiles first (the last
// query tile for dq, key tile 0 for dk/dv) under causal, head-major
// without.
//
// Numerics: |x - hi - lo| <= 2^-22 |x|, so each product lies within
// about 3 x 2^-22 of its f32 value (one TF32 product: 2^-10). The
// exponentials are 2^(s scale log2 e - lse log2 e) (ex2.approx, ~2^-22
// relative). The accumulators sum over the streamed tiles on the tensor
// cores in f32: 24 k8 steps a tile, 768 at Tk = 2048.
//
// Semantics kept from the SIMT route: bottom-right causal alignment
// (query row i sees keys <= i + tk - tq), the causal skip as loop bounds
// (dq stops at the last kv tile touching the diagonal, dk/dv starts at
// the first query tile that does), the key-padding mask [B, Tk], tail
// rows read as zeros (3-D tensor maps) and masked; a pair that does not
// attend gives p exactly 0 (selected, so a fully masked row's overflowed
// exp(s - lse) is discarded), so such rows and keys give exactly 0.
//
// What bounds it on the H100: the products, 3 (dq) and 4 (dk/dv) per
// attended pair and head dim at 165 TFLOP/s (a third of TF32's 495), and
// one exponential per pair at 3.9 T/s: 384 and 512 product operations
// per exponential, so the products bound it. What holds it at about 4x
// that bound is the data movement of one 64-row block an SM: each block
// loads and splits its resident tiles alone, and every 64 resident rows
// read the whole streamed side again (PERF.md §6 has the ablations).

#include "flash_tc.cuh"

namespace {

using hopper::kBoxBytes;
using hopper::kLog2e;
constexpr int kD = 64;                   // the route's head dim
constexpr int kTile = 64;                // rows of a tile
constexpr int kThreads = 128;            // one warpgroup
constexpr int kStages = 2;
constexpr int kTileBytes = 2 * kBoxBytes;          // [64, 64] f32
constexpr int kResBytes = 4 * kTileBytes;          // two tiles, hi and lo
constexpr int kStageBytes = 2 * kTileBytes;        // two raw tiles
constexpr int kDqWork = 6 * kTileBytes;  // K lo, V lo, two K^T
constexpr int kDkvWork = 6 * kTileBytes;  // Q lo, dO lo, Q^T, dO^T
constexpr int kBars = 8 * (kStages + 1);
constexpr size_t kDqSmem =
    1024 + kResBytes + kStages * kStageBytes + kDqWork + kBars;
constexpr size_t kDkvSmem = 1024 + kResBytes + kStages * kStageBytes +
                            kDkvWork + 2 * kTile * sizeof(float) + kBars;
static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448,
              "shared memory of one block");

struct Params {
  const float* lse;         // [B * H, tq]
  const float* delta;       // [B * H, tq]
  const int* mask;          // [B, tk] int32 or null
  float* d0;                // dq, or dk
  float* d1;                // dv (dk/dv kernel)
  int BH, H, tq, tk, causal;
  float scale;
};

// This block's work item (matrix bh, resident tile): head-major without
// causal (the blocks that run at once share their heads' streamed tiles
// in L2), rank-major with causal, rank 0 the tile that visits the most
// streamed tiles (the last one with `reverse`).
__device__ __forceinline__ void work_item(int bhs, int tiles, int causal,
                                          bool reverse, int* bh, int* tile) {
  const int it = blockIdx.x;
  if (causal) {
    const int rank = it / bhs;
    *bh = it - rank * bhs;
    *tile = reverse ? tiles - 1 - rank : rank;
  } else {
    *bh = it / tiles;
    *tile = it - *bh * tiles;
  }
}

// Rows r0 .. r0 + 63 of matrix bh: a [64, 64] f32 tile, two boxes of 32
// columns, counted on bar.
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int bh) {
  hopper::tma_load_3d(dst, map, bar, 0, r0, bh);
  hopper::tma_load_3d(dst + kBoxBytes, map, bar, 32, r0, bh);
}

__device__ __forceinline__ void load_stage(uint8_t* st, uint64_t* bar,
                                           const CUtensorMap* a,
                                           const CUtensorMap* b, int r0,
                                           int bh) {
  hopper::mbar_expect_tx(bar, kStageBytes);
  load_tile(st, a, bar, r0, bh);
  load_tile(st + kTileBytes, b, bar, r0, bh);
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 tf32_of(const float4& v) {
  return make_float4(hopper::tf32_rna(v.x), hopper::tf32_rna(v.y),
                     hopper::tf32_rna(v.z), hopper::tf32_rna(v.w));
}

__device__ __forceinline__ float4 minus(const float4& a, const float4& b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// Split the raw [64, 64] f32 tile at `raw` (two TMA boxes of 32 columns,
// 128-byte swizzle) in place into its tf32 hi parts, its lo parts to the
// same offsets at `lo`, and stage it transposed, hi at `t` and lo at
// t + 2 kBoxBytes: two halves of 32 tile rows, each [64 rows = the
// tile's columns, 32 K positions] in the same swizzle, in which tile row
// 2 j of a k8 slice takes position j and row 2 j + 1 position j + 4 (as
// xent.cu stages K6's X^T). So the tile rows 8 g + h + {0, 2, 4, 6} of
// one 16-byte column chunk cc are, transposed, the 16-byte chunk
// 2 (g % 4) + h of staged rows 4 cc .. 4 cc + 3 in half g / 4: a work
// unit of four float4 reads and eight float4 writes. The 256 units go
// two to a thread, so that the 8 threads of a quarter warp meet 8
// distinct bank groups in the tile and in the staged copy alike
// (g % 4 and h from the thread's lane, the chunk cc offset by them).
__device__ __forceinline__ void split_staged(uint8_t* raw, uint8_t* lo,
                                             uint8_t* t, int tid) {
  const int h = tid & 1, g3 = (tid >> 1) & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = (tid >> 3) + 16 * u;
    const int w = r & 3, z = (r >> 2) & 1, gh = (r >> 3) & 1, box = r >> 4;
    const int g = 4 * gh + g3;
    const int cc = 8 * box + 2 * (g3 ^ w) + z;      // 4 columns: 4 cc ..
    float4 hv[4], lv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int row = 8 * g + h + 2 * m;
      const int off =
          box * kBoxBytes + row * 128 + (((cc & 7) ^ (row & 7)) << 4);
      float4* hp = reinterpret_cast<float4*>(raw + off);
      const float4 v = *hp;
      hv[m] = tf32_of(v);
      lv[m] = tf32_of(minus(v, hv[m]));
      *hp = hv[m];
      *reinterpret_cast<float4*>(lo + off) = lv[m];
    }
    uint8_t* half = t + gh * kBoxBytes;
    const int ch = 2 * g3 + h;                      // the staged chunk
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * cc + e;                     // the tile's column
      const int off = c * 128 + ((ch ^ (c & 7)) << 4);
      *reinterpret_cast<float4*>(half + off) =
          make_float4(lane_of(hv[0], e), lane_of(hv[1], e),
                      lane_of(hv[2], e), lane_of(hv[3], e));
      *reinterpret_cast<float4*>(half + 2 * kBoxBytes + off) =
          make_float4(lane_of(lv[0], e), lane_of(lv[1], e),
                      lane_of(lv[2], e), lane_of(lv[3], e));
    }
  }
}

// d[64 x 64] = A B^T over D at f32 accuracy: A and B [64, 64] tiles
// K-major as stored (two boxes of 32 columns), hi parts at ah and bh, lo
// parts at al and bl. Overwrites d.
__device__ __forceinline__ void product_x3(float (&d)[32], const uint8_t* ah,
                                           const uint8_t* al,
                                           const uint8_t* bh,
                                           const uint8_t* bl) {
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const int o = (kk >> 2) * kBoxBytes + 32 * (kk & 3);
    hopper::wgmma_m64n64k8_tf32(d, hopper::desc_sw128(al + o),
                                hopper::desc_sw128(bh + o), kk);
    hopper::wgmma_m64n64k8_tf32(d, hopper::desc_sw128(ah + o),
                                hopper::desc_sw128(bl + o), 1);
    hopper::wgmma_m64n64k8_tf32(d, hopper::desc_sw128(ah + o),
                                hopper::desc_sw128(bh + o), 1);
  }
}

// d[64 x 64] (+)= F B at f32 accuracy: F [64 rows, 64 streamed rows] in
// registers as tf32 A fragments, hi fh and lo fl (k8 slice i, entry k =
// a + 2 e: the accumulator's row r + 8 a at column 8 i + 2 q + e), B the
// staged transposed tile (hi at b, lo at b + 2 kBoxBytes). `acc` 0
// overwrites d.
__device__ __forceinline__ void product_rs_x3(float (&d)[32],
                                              const uint32_t (&fh)[8][4],
                                              const uint32_t (&fl)[8][4],
                                              const uint8_t* b, int acc) {
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) {
    const uint8_t* bi = b + (i >> 2) * kBoxBytes + 32 * (i & 3);
    const uint64_t bh = hopper::desc_sw128(bi);
    const uint64_t bl = hopper::desc_sw128(bi + 2 * kBoxBytes);
    hopper::wgmma_m64n64k8_tf32_rs(d, fl[i], bh, acc | i);
    hopper::wgmma_m64n64k8_tf32_rs(d, fh[i], bl, 1);
    hopper::wgmma_m64n64k8_tf32_rs(d, fh[i], bh, 1);
  }
}

// Fragment entry (i, k) of v: its hi and lo parts.
__device__ __forceinline__ void put(uint32_t (&fh)[8][4],
                                    uint32_t (&fl)[8][4], int i, int k,
                                    float v) {
  const float h = hopper::tf32_rna(v);
  fh[i][k] = __float_as_uint(h);
  fl[i][k] = __float_as_uint(hopper::tf32_rna(v - h));
}

// Store the [64, 64] accumulator times f as rows r < rows of dst (zeros
// where no streamed tile was visited).
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[32],
                                           int row0, int rows, int r0,
                                           int cq, float f, bool any) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = row0 + r0 + 8 * a;
    if (r >= rows) continue;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * kD + 8 * i +
                                 cq) =
          any ? make_float2(acc[4 * i + 2 * a] * f,
                            acc[4 * i + 2 * a + 1] * f)
              : make_float2(0.f, 0.f);
  }
}

__device__ __forceinline__ uint8_t* aligned(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// ------------------------------------------------------------------ dq

__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dq_x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* res = aligned(smem_raw);    // Q hi, dO hi, Q lo, dO lo
  uint8_t* ring = res + kResBytes;     // stages of raw K, V
  // K lo, V lo, and K^T (hi, lo) twice: tile t's split writes buffer t % 2
  // while tile t - 1's dq product reads the other
  uint8_t* work = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(work + kDqWork);
  uint64_t* res_full = full + kStages;

  const int tid = threadIdx.x;
  int bh, tile;
  work_item(p.BH, (p.tq + kTile - 1) / kTile, p.causal, true, &bh, &tile);
  const int q0 = tile * kTile;
  const int off = p.tk - p.tq;
  const int b = bh / p.H;
  const int nkv = flash_tc::kv_tiles(q0, kTile, p.tq, p.tk, off, p.causal,
                                     kTile);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(full + s, 1);
    hopper::mbar_init(res_full, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(res_full, 2 * kTileBytes);
    load_tile(res, &tm_q, res_full, q0, bh);
    load_tile(res + kTileBytes, &tm_do, res_full, q0, bh);
    for (int s = 0; s < kStages && s < nkv; ++s)
      load_stage(ring + s * kStageBytes, full + s, &tm_k, &tm_v, s * kTile,
                 bh);
  }

  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);   // rows r0, r0 + 8
  const int cq = 2 * (lane & 3);
  float lse2[2], dlt[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int q = q0 + r0 + 8 * a;
    const bool ok = q < p.tq;
    const size_t row = static_cast<size_t>(bh) * p.tq + q;
    lse2[a] = ok ? p.lse[row] * kLog2e : 0.f;
    dlt[a] = ok ? p.delta[row] : 0.f;
  }
  // Q and dO split in place, their lo parts 32 KB further (visible to the
  // products after the first tile's fence and barrier)
  hopper::mbar_wait(res_full, 0);
  hopper::split_tf32_smem(reinterpret_cast<float4*>(res),
                          reinterpret_cast<float4*>(res + 2 * kTileBytes),
                          2 * kTileBytes / 16, tid, kThreads);

  const float sc = p.scale * kLog2e;
  // dq / scale, set by its first product: no other instruction writes it
  float dq[32];
  uint32_t gh[8][4], gl[8][4];
  hopper::Ring pos(kStages);
  for (int t = 0; t < nkv; ++t) {
    const int k0 = t * kTile;
    uint8_t* st = ring + pos.stage * kStageBytes;
    uint8_t* kt = work + (2 + 2 * (t & 1)) * kTileBytes;
    hopper::mbar_wait(full + pos.stage, pos.phase);
    // the split overlaps tile t - 1's dq product, which reads only the
    // other K^T; the lo parts were last read by tile t - 1's S and dP
    split_staged(st, work, kt, tid);                            // K
    hopper::split_tf32_smem(                                    // V
        reinterpret_cast<float4*>(st + kTileBytes),
        reinterpret_cast<float4*>(work + kTileBytes), kTileBytes / 16, tid,
        kThreads);
    hopper::fence_async_shared();
    __syncthreads();

    float s[32], dp[32], pr[32];
    hopper::wgmma_fence();
    product_x3(s, res, res + 2 * kTileBytes, st, work);
    hopper::wgmma_commit();
    product_x3(dp, res + kTileBytes, res + 3 * kTileBytes, st + kTileBytes,
               work + kTileBytes);
    hopper::wgmma_commit();
    // S (and the last dq product) done; dP still running: the
    // probabilities meanwhile. Pairs that do not attend get p = 0
    // exactly. S and dP are only read: a non-wgmma write to an
    // accumulator makes ptxas serialize the kernel's wgmmas.
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    const bool need = flash_tc::needs_mask(q0, kTile, k0, kTile, p.tq, p.tk,
                                           off, p.causal, p.mask);
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * i + cq + e;
        const bool ok = need && flash_tc::key_ok(key, p.tk, p.mask, b);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int x = 4 * i + 2 * a + e;
          pr[x] = hopper::ex2(fmaf(s[x], sc, -lse2[a]));
          if (need && !flash_tc::attends(q0 + r0 + 8 * a, key, ok, p.tq,
                                         off, p.causal))
            pr[x] = 0.f;
        }
      }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    hopper::fence_regs(dq);
    hopper::fence_regs(gh);
    hopper::fence_regs(gl);
    // the stage is read: refill it two tiles ahead
    if (tid == 0 && t + kStages < nkv)
      load_stage(st, full + pos.stage, &tm_k, &tm_v, (t + kStages) * kTile,
                 bh);
    // dS / scale (the scale goes onto dq at the store), split into the A
    // fragments of the dq product
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int x = 4 * i + 2 * a + e;
          put(gh, gl, i, a + 2 * e, pr[x] * (dp[x] - dlt[a]));
        }
    hopper::fence_regs(gh);
    hopper::fence_regs(gl);
    hopper::wgmma_fence();
    product_rs_x3(dq, gh, gl, kt, t);
    hopper::wgmma_commit();
    pos.next();
    // every thread is past this tile's products before the next split
    // writes what they read
    __syncthreads();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dq);
  store_rows(p.d0 + static_cast<size_t>(bh) * p.tq * kD, dq, q0, p.tq, r0,
             cq, p.scale, nkv > 0);
}

// ---------------------------------------------------------------- dk/dv

__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dkv_x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* res = aligned(smem_raw);    // K hi, V hi, K lo, V lo
  uint8_t* ring = res + kResBytes;     // stages of raw Q, dO
  uint8_t* work = ring + kStages * kStageBytes;   // Q lo, dO lo, Q^T, dO^T
  uint8_t* qt = work + 2 * kTileBytes;
  uint8_t* dot = work + 4 * kTileBytes;
  float* side = reinterpret_cast<float*>(work + kDkvWork);  // lse2, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(side + 2 * kTile);
  uint64_t* res_full = full + kStages;

  const int tid = threadIdx.x;
  int bh, tile;
  work_item(p.BH, (p.tk + kTile - 1) / kTile, p.causal, false, &bh, &tile);
  const int k0 = tile * kTile;
  const int off = p.tk - p.tq;
  const int b = bh / p.H;
  const int nq = (p.tq + kTile - 1) / kTile;
  const int qb = flash_tc::first_q_tile(k0, off, p.causal, kTile);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(full + s, 1);
    hopper::mbar_init(res_full, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(res_full, 2 * kTileBytes);
    load_tile(res, &tm_k, res_full, k0, bh);
    load_tile(res + kTileBytes, &tm_v, res_full, k0, bh);
    for (int s = 0; s < kStages && qb + s < nq; ++s)
      load_stage(ring + s * kStageBytes, full + s, &tm_q, &tm_do,
                 (qb + s) * kTile, bh);
  }

  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);   // keys r0, r0 + 8
  const int cq = 2 * (lane & 3);
  bool key_ok[2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
    key_ok[a] = flash_tc::key_ok(k0 + r0 + 8 * a, p.tk, p.mask, b);
  hopper::mbar_wait(res_full, 0);
  hopper::split_tf32_smem(reinterpret_cast<float4*>(res),
                          reinterpret_cast<float4*>(res + 2 * kTileBytes),
                          2 * kTileBytes / 16, tid, kThreads);

  const float sc = p.scale * kLog2e;
  const size_t lbase = static_cast<size_t>(bh) * p.tq;
  // dk / scale and dv, each set by its first product
  float dk[32], dv[32];
  uint32_t ph[8][4], pl[8][4], sh[8][4], sl[8][4];
  hopper::Ring pos(kStages);
  for (int t = qb; t < nq; ++t) {
    const int q0 = t * kTile;
    uint8_t* st = ring + pos.stage * kStageBytes;
    hopper::mbar_wait(full + pos.stage, pos.phase);
    {
      const int q = q0 + (tid & (kTile - 1));
      const bool ok = q < p.tq;
      side[tid] = tid < kTile ? (ok ? p.lse[lbase + q] * kLog2e : 0.f)
                              : (ok ? p.delta[lbase + q] : 0.f);
    }
    // the last tile's dv product is done (dO^T free), its dk product may
    // still run while dO is split; then Q, once it is done too (Q^T free).
    // The lo parts were last read by the last tile's S^T and dP^T.
    hopper::wgmma_wait<1>();
    hopper::fence_regs(dv);
    hopper::fence_regs(ph);
    hopper::fence_regs(pl);
    split_staged(st + kTileBytes, work + kTileBytes, dot, tid);    // dO
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(sh);
    hopper::fence_regs(sl);
    split_staged(st, work, qt, tid);                               // Q
    hopper::fence_async_shared();
    __syncthreads();

    float sT[32], dpT[32];
    hopper::wgmma_fence();
    product_x3(sT, res, res + 2 * kTileBytes, st, work);
    hopper::wgmma_commit();
    product_x3(dpT, res + kTileBytes, res + 3 * kTileBytes, st + kTileBytes,
               work + kTileBytes);
    hopper::wgmma_commit();
    // S^T done, dP^T still running: P^T split into the A fragments of the
    // dv product meanwhile; pairs that do not attend get p = 0 exactly
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sT);
    const bool need = flash_tc::needs_mask(q0, kTile, k0, kTile, p.tq, p.tk,
                                           off, p.causal, p.mask);
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * i + cq + e;         // the query's column
        const float l2 = side[qc];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int x = 4 * i + 2 * a + e;
          float pr = hopper::ex2(fmaf(sT[x], sc, -l2));
          if (need && !flash_tc::attends(q0 + qc, k0 + r0 + 8 * a,
                                         key_ok[a], p.tq, off, p.causal))
            pr = 0.f;
          put(ph, pl, i, a + 2 * e, pr);
        }
      }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpT);
    if (tid == 0 && t + kStages < nq)
      load_stage(st, full + pos.stage, &tm_q, &tm_do, (t + kStages) * kTile,
                 bh);
    // dS^T / scale (the scale goes onto dk at the store) from p = hi + lo
    // (within 2^-22 of p), split into the A fragments of the dk product
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = side[kTile + 8 * i + cq + e];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int x = 4 * i + 2 * a + e, k = a + 2 * e;
          const float pr = __uint_as_float(ph[i][k]) +
                           __uint_as_float(pl[i][k]);
          put(sh, sl, i, k, pr * (dpT[x] - dl));
        }
      }
    hopper::fence_regs(ph);
    hopper::fence_regs(pl);
    hopper::fence_regs(sh);
    hopper::fence_regs(sl);
    hopper::wgmma_fence();
    product_rs_x3(dv, ph, pl, dot, t - qb);
    hopper::wgmma_commit();
    product_rs_x3(dk, sh, sl, qt, t - qb);
    hopper::wgmma_commit();
    pos.next();
    // every thread is past this tile's reads of `side` and its products
    // before the next tile writes them
    __syncthreads();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dk);
  hopper::fence_regs(dv);
  const size_t base = static_cast<size_t>(bh) * p.tk * kD;
  store_rows(p.d0 + base, dk, k0, p.tk, r0, cq, p.scale, qb < nq);
  store_rows(p.d1 + base, dv, k0, p.tk, r0, cq, 1.f, qb < nq);
}

template <bool kDq>
int run(const void* q, const void* k, const void* v, const void* dout,
        const Params& p, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the shapes the Python plan guarantees (flash_attention.py x3_plan):
  // D = 64, 16-byte aligned bases (TMA)
  if (D != kD || ((reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) |
                   reinterpret_cast<uintptr_t>(dout)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = hopper::encode_f32_boxes_3d(&tm_q, q, p.BH, p.tq, kD);
  if (err == cudaSuccess)
    err = hopper::encode_f32_boxes_3d(&tm_do, dout, p.BH, p.tq, kD);
  if (err == cudaSuccess)
    err = hopper::encode_f32_boxes_3d(&tm_k, k, p.BH, p.tk, kD);
  if (err == cudaSuccess)
    err = hopper::encode_f32_boxes_3d(&tm_v, v, p.BH, p.tk, kD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(p.BH) *
      (((kDq ? p.tq : p.tk) + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (kDq) {
    err = ptt_set_smem(fa_bwd_dq_x3_kernel, kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_bwd_dq_x3_kernel<<<grid, kThreads, kDqSmem, st>>>(tm_q, tm_k, tm_v,
                                                        tm_do, p);
  } else {
    err = ptt_set_smem(fa_bwd_dkv_x3_kernel, kDkvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_bwd_dkv_x3_kernel<<<grid, kThreads, kDkvSmem, st>>>(tm_q, tm_k, tm_v,
                                                          tm_do, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout [B, H, tq, D]; k, v [B, H, tk, D]; f32, 16-byte aligned, D = 64;
// lse, delta [B*H, tq] f32; kv_mask [B, tk] int32 or null; dq like q.
// tq, tk >= 1.
extern "C" int ptt_flash_attention_bwd_dq_x3(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask, void* dq, int B,
    int H, int tq, int tk, int D, float scale, int causal, void* stream) {
  const Params p{static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<const int*>(kv_mask), static_cast<float*>(dq),
                 nullptr, B * H, H, tq, tk, causal, scale};
  return run<true>(q, k, v, dout, p, D, stream);
}

// As above; dk, dv like k.
extern "C" int ptt_flash_attention_bwd_dkv_x3(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask, void* dk,
    void* dv, int B, int H, int tq, int tk, int D, float scale, int causal,
    void* stream) {
  const Params p{static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<const int*>(kv_mask), static_cast<float*>(dk),
                 static_cast<float*>(dv), B * H, H, tq, tk, causal, scale};
  return run<false>(q, k, v, dout, p, D, stream);
}
