// What K2's and K3's tensor-core kernels (csrc/flash_attention_tc.cu,
// csrc/flash_attention_bwd_tc.cu) share: the block shape, the two kinds
// of product on [64, 64] TMA boxes, and the tile ranges of the causal
// skip.
//
// A block has three warpgroups: consumers 0 and 1 own 64 resident rows
// each (queries for K2 and K3's dq, keys for K3's dk/dv), warpgroup 2
// gives up its registers and one of its threads (K3's dk/dv: one warp)
// feeds an mbarrier ring with the streamed tiles by TMA. Blocks are
// persistent, one per SM, and walk work items of 128 resident rows
// (Walk): the resident tiles are double-buffered, so the producer loads
// the next item's while the consumers finish the current one, and the
// ring runs on across items; a block's start and its epilogue's stores
// no longer leave the tensor cores idle. Every operand
// lives in shared memory as [64 rows, 64 columns] bf16 boxes with the
// 128-byte swizzle (hopper.cuh). A tile of R rows and D columns is laid
// out [D / 64 column halves][R / 64 row blocks], so that
//   * as a K-major operand (rows = M or N, columns = the head dim, the
//     product's K) its row blocks follow one another, and the k16 slice kk
//     lies in column half kk / 4, 32 (kk % 4) bytes along;
//   * as an MN-major operand (rows = the product's K, columns = the head
//     dim, its N) the k16 slice j lies in row block j / 4, 2048 (j % 4)
//     bytes down, and the column halves lie R / 64 boxes apart (the
//     descriptor's leading byte offset).
// So no operand is ever transposed: Q, K, V and dO each serve as K-major
// in one product and MN-major in another.
//
// Tensor maps are 3-D, [B * H matrices, T rows, D columns]: a tile that
// runs past a head's T reads zeros, never the next head's rows.

#pragma once

#include "common.cuh"
#include "gemm.cuh"      // gemm::Wgmma<128>: the m64n128 shared-memory shape
#include "hopper.cuh"

namespace flash_tc {

using hopper::kBoxBytes;
constexpr int kThreads = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int kRows = 128;         // resident rows of a block
constexpr float kLn2 = 0.6931471805599453f;

// -inf: a masked score, whose 2^(s - m) is exactly 0 for any finite m
__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// d[64 x kN] (+)= A[64 x 16] B[16 x kN], both from shared memory.
template <int kN, int kTransB>
__device__ __forceinline__ void mma_ss(float (&d)[kN / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (kN == 64)
    hopper::wgmma_m64n64k16_ss<kTransB>(d, da, db, scale_d);
  else
    gemm::Wgmma<128>::run<kTransB>(d, da, db, scale_d);
}

// d[64 x kN] (+)= A[64 x 16] B[16 x kN], A from registers.
template <int kN, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[kN / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  if constexpr (kN == 64)
    hopper::wgmma_m64n64k16_rs<kTransB>(d, a, db, scale_d);
  else
    hopper::wgmma_m64n128k16_rs<kTransB>(d, a, db, scale_d);
}

// d[64 x kN] = A B^T over the head dim kD: A the warpgroup's 64 resident
// rows (column half c at a + c * a_half), B a streamed or resident tile
// of kN rows, both K-major. Overwrites d (the first slice's scale_d is 0).
template <int kN, int kD>
__device__ __forceinline__ void product_abt(float (&d)[kN / 2],
                                            const uint8_t* a, int a_half,
                                            const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk / 4, off = 32 * (kk % 4);
    mma_ss<kN, 0>(d, hopper::desc_sw128(a + c * a_half + off),
                  hopper::desc_sw128(b + c * (kN / 64) * kBoxBytes + off),
                  kk);
  }
}

// d[64 x kD] += P B: P a [64 x kK] probability tile in registers, packed
// as the register A operand (pa[j] is the k16 slice j, hopper::acc_to_a),
// B a tile of kK rows and kD columns, MN-major.
template <int kK, int kD>
__device__ __forceinline__ void product_pb(float (&d)[kD / 2],
                                           const uint32_t (&pa)[kK / 16][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int j = 0; j < kK / 16; ++j)
    mma_rs<kD, 1>(d, pa[j],
                  hopper::desc_sw128(b + (j / 4) * kBoxBytes + 2048 * (j % 4),
                                     (kK / 64) * kBoxBytes),
                  1);
}

// Pack a whole [64 x kK] fragment as register A operands.
template <int kK>
__device__ __forceinline__ void pack_a(const float (&acc)[kK / 2],
                                       uint32_t (&pa)[kK / 16][4]) {
#pragma unroll
  for (int j = 0; j < kK / 16; ++j) hopper::acc_to_a(acc, j, pa[j]);
}

// One persistent block per SM, or fewer for fewer items.
inline cudaError_t persistent_grid(int items, int* grid) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  *grid = items < sms ? items : sms;
  return cudaSuccess;
}

// The row's max and sum over the four lanes of its quad.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The pingpong of the two consumer warpgroups (FlashAttention-3's warp
// scheduler barriers): named barrier 1 + w is warpgroup w's turn to
// issue its products. A warpgroup takes its turn, issues, and gives the
// turn to the other, so that one's products run on the tensor cores
// while the other works through its elementwise part. Both warpgroups
// take the same number of turns; warpgroup 1 gives the first turn before
// any and warpgroup 0 takes the last one after all, so both barriers end
// balanced.
struct Pingpong {
  int wg;
  __device__ void start() const {
    if (wg == 1) hopper::named_arrive(1, 256);
  }
  __device__ void take() const { hopper::named_barrier(1 + wg, 256); }
  __device__ void give() const { hopper::named_arrive(2 - wg, 256); }
  __device__ void finish() const {
    if (wg == 0) hopper::named_barrier(1, 256);
  }
};

// A persistent block's walk over the work items blockIdx.x, + gridDim.x,
// ... of `bhs` heads x `tiles` resident tiles. Without causal the items
// are head-major (it = bh * tiles + tile): the blocks that run at once
// hold the tiles of the same few heads, whose streamed K and V (or Q and
// dO) are then read from device memory about once and from L2 after
// that; in rank-major order a head's tiles run a whole pass of the grid
// apart, and at BERT's 768 heads (100 MB of K and V) each pass reads
// them from device memory again. With causal the tiles' work differs,
// and head-major order would hand a block the same tile of every head
// whenever gridDim.x is a multiple of `tiles`: the items are rank-major
// (it = rank * bhs + bh), every head's tile of one rank before the next
// rank, and with `reverse` (causal query tiles) the last tile, which
// visits the most kv tiles, has rank 0. The resident tiles of
// consecutive items alternate between two buffers; `use` counts this
// block's items.
struct Walk {
  int it, use, bh, tile;
  __device__ bool next(int bhs, int tiles, bool causal, bool reverse) {
    if (use >= 0) it += gridDim.x;
    ++use;
    if (it >= bhs * tiles) return false;
    if (causal) {
      const int rank = it / bhs;          // once per item, not per tile
      bh = it - rank * bhs;
      tile = reverse ? tiles - 1 - rank : rank;
    } else {
      bh = it / tiles;
      tile = it - bh * tiles;
    }
    return true;
  }
  __device__ int buf() const { return use & 1; }
  __device__ uint32_t parity() const { return (use >> 1) & 1; }
};

__device__ __forceinline__ Walk walk_start() {
  return Walk{static_cast<int>(blockIdx.x), -1, 0, 0};
}

// The kv tiles [0, n) that query rows [q0, q0 + rows) visit: all of them,
// or with causal (bottom-right: row i sees keys <= i + off, off = tk - tq)
// up to the last tile holding a key the block's last row sees.
__device__ __forceinline__ int kv_tiles(int q0, int rows, int tq, int tk,
                                        int off, int causal, int tile) {
  const int n = (tk + tile - 1) / tile;
  if (!causal) return n;
  const int last = min(q0 + rows, tq) - 1 + off;
  return last < 0 ? 0 : min(n, last / tile + 1);
}

// The first query tile that meets key k0 under causal (0 without).
__device__ __forceinline__ int first_q_tile(int k0, int off, int causal,
                                            int tile) {
  const int first = k0 - off;      // the first query that sees key k0
  return (!causal || first <= 0) ? 0 : first / tile;
}

// Which (query, key) pairs attend: the one rule of K2 and of both K3
// kernels. Query q attends key k when q < tq, k < tk, the key mask (if
// any) keeps key k for batch row b, and under causal (bottom-right,
// off = tk - tq) k <= q + off. A pair that does not attend gets
// probability exactly 0. key_ok holds the key's part, so that a thread
// tests each of its keys once for both of its rows.
__device__ __forceinline__ bool key_ok(int key, int tk, const int* mask,
                                       int b) {
  return key < tk &&
         (mask == nullptr || mask[static_cast<size_t>(b) * tk + key] > 0);
}

__device__ __forceinline__ bool attends(int q, int key, bool key_ok, int tq,
                                        int off, int causal) {
  return key_ok && q < tq && (!causal || q + off >= key);
}

// Whether the tile of query rows [q0, q0 + nq) and keys [k0, k0 + nk)
// holds a pair that does not attend; a tile that holds none skips the
// per-pair test of attends().
__device__ __forceinline__ bool needs_mask(int q0, int nq, int k0, int nk,
                                           int tq, int tk, int off,
                                           int causal, const int* mask) {
  return q0 + nq > tq || k0 + nk > tk || mask != nullptr ||
         (causal && k0 + nk - 1 > q0 + off);
}

// A pair of bf16 values to device memory.
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

}  // namespace flash_tc
