// K4: fused feed-forward out = gelu(x @ w1 + b1) @ w2 + b2.
//
// Replaces paddle_tpu/ops/pallas/mlp.py:51 _mlp_kernel (launched by
// _mlp_pallas :92). The TPU kernel keeps an f32 [BN, Hout] accumulator in
// VMEM across a sequential grid axis over the intermediate dimension I, so
// the [R, I] activation never reaches HBM. The wrapper (ops/cuda/mlp.py
// mlp_route) picks the route by a rule on the storage type, the widths
// and the rows:
//
// bf16 with H, I and Hout multiples of 8 (training): two tensor-core
//   passes on the shared mainloop of csrc/gemm.cuh (TMA ring, wgmma,
//   128-row tiles):
//     pass 1  a = bf16(gelu(x @ w1 + b1))   into an [R, I] scratch
//     pass 2  out = a @ w2 + b2             f32 accumulation, one rounding
//   Why two passes and not the TPU's one: Hopper cannot hold the TPU's
//   accumulator. A 128-row [128, Hout] f32 accumulator is 384 KB at
//   Hout = 768, more than the SM's 256 KB register file. A 64-row one
//   spread over three warpgroups fits, but then every 64 rows stream all
//   of W1 and W2 (9.4 MB at BERT's widths): 512 row tiles x 9.4 MB = 4.8 GB
//   of L2 reads, about 0.8 ms at ~6 TB/s, slower than the library's whole
//   MLP. Splitting Hout across blocks instead recomputes the first
//   product (1.5-2x the operations). The round trip costs less: writing a
//   once as bf16 and reading it back is 2 x 201 MB at BERT's shape,
//   ~0.12 ms at 3.35 TB/s, and each pass stays compute-bound (~600
//   operations per byte, above the card's ridge of ~295).
//   What bounds it: operations, 2 R I (H + Hout) at 989 TFLOP/s.
//   Numerics: the products are bf16 x bf16 into f32, as the TPU kernel's
//   f32 body (paddle_tpu/ops/pallas/mlp.py:64-89); the one rounding added
//   is that of a to bf16 between the passes (2^-9 relative). The gelu is
//   the erf form in f32, its erfc from a fit within 2.5e-7 of float64
//   (gelu_fit). Rows past R and the K tails arrive from TMA as zeros
//   (no 0 * NaN: the TPU kernel's masking at mlp.py:76-80 is not
//   needed), and stores are masked.
//
// f32, and bf16 with other widths: the CUDA cores, csrc/mlp_simt.cu
//   (its header says how).

#include "common.cuh"
#include "gemm.cuh"

namespace {

// The tensor-core route's gelu, x Phi(x), branch-free with one 2^x:
// erfc(u / sqrt 2) = 2^(u Q(u)) for u = min(|x|, 6.5), with Q the
// degree-10 Chebyshev least-squares fit of log2(erfc(u / sqrt 2)) / u on
// [0, 6.5] (float64, coefficients rounded to f32), and Phi(x) = e / 2 for
// x < 0, 1 - e / 2 for x >= 0 (no cancellation on either side). Its
// erfc is within 2.5e-7 of float64's (tests/test_torch_kernels.py
// evaluates this table), the order of f32 erff's own error; erff takes
// two branches that a warp's mixed signs both run.
__device__ __forceinline__ float gelu_fit(float x) {
  const float u = fminf(fabsf(x), 6.5f);
  float q = 2.133715427e-09f;
  q = fmaf(q, u, -8.336778734e-08f);
  q = fmaf(q, u, 1.435743684e-06f);
  q = fmaf(q, u, -1.422381683e-05f);
  q = fmaf(q, u, 8.696952864e-05f);
  q = fmaf(q, u, -2.988232882e-04f);
  q = fmaf(q, u, 1.761948624e-05f);
  q = fmaf(q, u, 6.942159962e-03f);
  q = fmaf(q, u, -5.244437233e-02f);
  q = fmaf(q, u, -4.592190683e-01f);
  q = fmaf(q, u, -1.151104331e+00f);
  const float e = hopper::ex2(q * u);
  return 0.5f * x * (x >= 0.f ? 2.f - e : e);
}

// ------------------------------------------------- bf16 tensor-core route

// The epilogue of both passes: add the bf16 bias, apply the gelu (pass 1
// only, gelu_fit), store bf16 [M, N] rows; rows past M and columns past N
// are not stored (N is a multiple of 8, so a column pair is whole).
//
// It goes through shared memory, 16 columns at a time: each consumer warp
// writes its [16, 16] piece of the accumulator (plus the bias) into its
// own padded f32 slot, then reads it back four rows per step, lane l on
// columns 2 (l % 8), +1 of row l / 8, so that each store is a whole
// 32-byte row segment. Only the writes are unrolled (the accumulator is
// in registers, indexed at compile time); the gelu and the stores are one
// rolled loop, so the epilogue's code stays small (fully unrolled over a
// 256-column tile, the epilogue ran several times slower than its
// arithmetic; PERF.md, PR 5). The tile's bias pairs are loaded into
// registers before its products, so their latency hides behind them.
template <bool kGelu>
struct BiasStore {
  static constexpr int kCols = 16;               // columns per piece
  static constexpr int kPad = kCols + 4;         // f32 row of a slot
  static constexpr int kScratch = 8 * 16 * kPad * 4;   // 8 consumer warps
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  int M, N;
  int row_w;       // the first of this warp's 16 rows
  int lane;
  int n0;          // the tile's first column
  float* slot;     // this warp's [16, kPad] f32
  __nv_bfloat162 bb[32];   // this thread's bias pairs of the tile

  __device__ __forceinline__ void begin(int row0, int, uint8_t* scratch) {
    const int warp = threadIdx.x >> 5;           // 0..7 over both groups
    lane = threadIdx.x & 31;
    row_w = row0 + 16 * (warp & 3);
    slot = reinterpret_cast<float*>(scratch) + warp * 16 * kPad;
  }

  template <int kN>
  __device__ __forceinline__ void prepare(int first) {
    static_assert(kN / 8 <= 32, "bias pairs of a tile");
    n0 = first;
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane & 3);
      bb[i] = col < N ? *reinterpret_cast<const __nv_bfloat162*>(bias + col)
                      : __floats2bfloat162_rn(0.f, 0.f);
    }
  }

  // Piece c of the accumulator, plus the bias, into the slot: fragment
  // rows lane / 4 and + 8, columns 8 i + 2 (lane % 4), +1.
  template <int kN, int kC>
  __device__ __forceinline__ void write_piece(const float (&acc)[kN / 2],
                                              int c) {
    if constexpr (kC < kN / kCols) {
      if (c != kC) return write_piece<kN, kC + 1>(acc, c);
      const int r = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
      for (int ii = 0; ii < kCols / 8; ++ii) {
        const int i = kC * (kCols / 8) + ii;
        const float2 b = __bfloat1622float2(bb[i]);
#pragma unroll
        for (int a = 0; a < 2; ++a)
          *reinterpret_cast<float2*>(slot + (r + 8 * a) * kPad + 8 * ii +
                                     q2) =
              make_float2(acc[4 * i + 2 * a] + b.x,
                          acc[4 * i + 2 * a + 1] + b.y);
      }
    }
  }

  // Piece c: through the slot, plus gelu (pass 1), to the output.
  template <int kN>
  __device__ __forceinline__ void piece(const float (&acc)[kN / 2], int c) {
    __syncwarp();                     // the slot's previous piece is read
    write_piece<kN, 0>(acc, c);
    __syncwarp();
    const int cc = 2 * (lane & 7);
    const int col = n0 + kCols * c + cc;
#pragma unroll 2
    for (int j = 0; j < 16; j += 4) {
      const int rr = j + (lane >> 3);
      const int r = row_w + rr;
      if (r >= M || col >= N) break;
      float2 v = *reinterpret_cast<const float2*>(slot + rr * kPad + cc);
      if (kGelu) {
        v.x = gelu_fit(v.x);
        v.y = gelu_fit(v.y);
      }
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(r) * N + col) =
          __floats2bfloat162_rn(v.x, v.y);
    }
    __syncwarp();           // converged again before the next wgmma
  }

  template <int kN>
  __device__ __forceinline__ void tile(const float (&acc)[kN / 2], int) {
#pragma unroll 1
    for (int c = 0; c < kN / kCols; ++c) piece<kN>(acc, c);
  }

  __device__ __forceinline__ void end() {}
};

// One pass: out [M, N] = epilogue(a [M, K] @ w [K, N] + bias) with tiles
// of kN columns, one item per tile, on `grid` blocks.
template <bool kGelu>
cudaError_t tc_pass(const void* a, const void* w, const void* bias,
                    void* out, int M, int K, int N, int width, int grid,
                    cudaStream_t st) {
  gemm::Sched s;
  s.M = M;
  s.N = N;
  s.K = K;
  s.splits = (N + width - 1) / width;
  s.per = 1;
  s.items = (M + gemm::kTileRows - 1) / gemm::kTileRows * s.splits;
  BiasStore<kGelu> epi;
  epi.bias = static_cast<const __nv_bfloat16*>(bias);
  epi.out = static_cast<__nv_bfloat16*>(out);
  epi.M = M;
  epi.N = N;
  switch (width) {
    case 128:
      return gemm::launch<128, false>(a, w, s, grid, epi, st);
    case 192:
      return gemm::launch<192, false>(a, w, s, grid, epi, st);
    case 256:
      return gemm::launch<256, false>(a, w, s, grid, epi, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The bf16 route's shapes (ops/cuda/mlp.py checks them first): H, I,
// Hout multiples of 8, the TMA operands 16-byte aligned and the biases
// 4-byte aligned (read in pairs).
static bool tc_takes(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* act, int H,
                     int I, int Hout) {
  const uintptr_t tma = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(w1) |
                        reinterpret_cast<uintptr_t>(w2) |
                        reinterpret_cast<uintptr_t>(act);
  const uintptr_t pairs = reinterpret_cast<uintptr_t>(b1) |
                          reinterpret_cast<uintptr_t>(b2);
  return H % 8 == 0 && I % 8 == 0 && Hout % 8 == 0 && (tma & 15) == 0 &&
         (pairs & 3) == 0;
}

// bf16 x [R, H], w1 [H, I], b1 [I], w2 [I, Hout], b2 [Hout] -> out
// [R, Hout]; act [R, I] bf16 scratch. Pass p runs tiles of width_p
// columns on grid_p blocks (ops/cuda/mlp.py gemm_plan).
extern "C" int ptt_mlp_tc(const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* act,
                          void* out, int R, int H, int I, int Hout,
                          int width1, int grid1, int width2, int grid2,
                          void* stream) {
  if (!tc_takes(x, w1, b1, w2, b2, act, H, I, Hout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = tc_pass<true>(x, w1, b1, act, R, H, I, width1, grid1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tc_pass<false>(act, w2, b2, out, R, I, Hout, width2, grid2, st));
}
