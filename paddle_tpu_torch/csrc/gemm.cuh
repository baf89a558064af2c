// The port's one Hopper GEMM mainloop: C = A B on bf16 tensor cores with an
// f32 accumulator, fed by TMA through an mbarrier ring, with the epilogue
// supplied by the caller. K4 (csrc/mlp.cu, both passes) and K5
// (csrc/xent.cu, the statistics) run on it. With f32 operands (T = float,
// K5's f32 route) it runs the 3xTF32 products of hopper.cuh instead: see
// "f32 operands" below.
//
// Operands. A is row-major [M, K] (K-major). B is either row-major [K, N]
// (MN-major: x @ W, K4) or row-major [N, K] (K-major: h W^T, K5's tied
// [V, H] table). Both arrive as [64, 64] boxes of bf16 with the 128-byte
// swizzle (hopper.cuh): a ring stage holds A's two boxes (128 rows x 64 of
// K) and B's kN / 64 boxes (64 of K x kN). kN / 64 boxes side by side are
// one operand in either major: K-major rows continue from box to box
// (8-row groups 1024 bytes apart throughout), and MN-major 64-column
// atoms lie one box (8 KB, the descriptor's leading byte offset) apart.
//
// Tiles. A tile is 128 rows x kN columns (kN = 128, 192 or 256). Two
// consumer warpgroups own 64 rows each and issue m64nNk16 wgmma into an
// f32 accumulator of kN / 2 registers a thread (at most 128); warpgroup 2
// gives up its registers (setmaxnreg) and one of its threads feeds the
// ring. TMA fills rows past M and the K tail with zeros, so a padded row
// or column adds exact zeros to the products (never 0 * NaN); epilogues
// mask their stores. The tensor cores wait while a block runs an
// epilogue (PERF.md, PR 5, measured the ways around it: no registers for
// a second accumulator at kN = 256; two 128-column accumulators taking
// turns, or two blocks of 128-column tiles per SM, ask more of L2 per
// operation and were no faster).
//
// Work. The output is cut into 128-row tiles and kN-column tiles. A work
// item is a row tile and one split of its column tiles (`per` adjacent
// tiles); items are numbered with the split fastest, and a block walks
// items blockIdx.x, + gridDim.x, ... (persistent: the grid is at most one
// block per SM). While the consumers run one tile's epilogue, the producer
// is already filling the ring with the next tile's boxes. Neighbouring
// blocks hold the same row tile of A at once (read from device memory
// about once), and B (the weights, 4.7 MB at BERT's MLP) stays in L2.
// The ring's position is stepped, never divided (hopper::Ring).
//
// f32 operands (3xTF32). A box is [64 rows, 32 f32] (8 KB, the 128-byte
// swizzle), so a stage covers 32 of K. Each stage has a second half of the
// same size for the lo parts: once a stage has arrived, the 256 consumer
// threads split it in place (each value becomes its tf32 hi, its lo goes
// to the same offset of the second half; hopper::split_tf32_smem), fence
// the generic writes for the async proxy and meet at named barrier 1;
// then each k8 step issues lo·hi, hi·lo and hi·hi. The split of stage s
// runs while the products of stage s - 1 are in flight. Only a K-major B
// is taken (TF32 wgmma has no transpose). kN = 256 leaves room for 2
// stages of 96 KB.
//
// The epilogue Epi is a struct whose copy in each consumer thread carries
// that thread's state across the item's tiles. Epi::kScratch bytes of
// shared memory (16-byte aligned) are its own, beside the ring:
//   begin(row0, split, scratch)
//                        the item starts; row0 is the warpgroup's first row
//   prepare<kN>(n0)      a tile's products are about to be issued: start
//                        the loads its epilogue needs (they land while the
//                        tensor cores run)
//   tile<kN>(acc, n0)    one tile's accumulator, first column n0
//   end()                the item is done
// A thread's accumulator holds rows r = row0 + 16 warp + lane / 4 and r + 8
// at columns n0 + 8 i + 2 (lane % 4) + e: acc[4 i + 2 a + e] is row r + 8 a.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace gemm {

using hopper::kBoxBytes;
constexpr int kThreads = 384;       // consumer warpgroups 0, 1; producer 2
constexpr int kTileRows = 128;
constexpr int kMaxStages = 8;

// d[64 x kN] (+)= A[64 x 16] B[16 x kN]; A K-major, B K-major (kTransB 0)
// or MN-major (1), both from shared memory; scale_d 0 overwrites d.
template <int kN>
struct Wgmma;

template <>
struct Wgmma<128> {
  template <int kTransB>
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<192> {
  template <int kTransB>
  __device__ __forceinline__ static void run(float (&d)[96], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, %99;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<256> {
  template <int kTransB>
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

// The operand types: a box's K width, and whether products are 3xTF32.
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kBoxK = 64;
  static constexpr bool kX3 = false;
};
template <>
struct Elem<float> {
  static constexpr int kBoxK = 32;
  static constexpr bool kX3 = true;
};

// The bytes TMA brings into a stage: A's two boxes and B's kN / 64.
template <int kN>
__host__ __device__ constexpr int stage_bytes() {
  return (2 + kN / 64) * kBoxBytes;
}

// A stage's bytes in shared memory: twice the loaded ones with f32
// operands (the lo parts).
template <int kN, typename T>
__host__ __device__ constexpr int stage_span() {
  return stage_bytes<kN>() * (Elem<T>::kX3 ? 2 : 1);
}

// Ring stages that fit beside an epilogue's kScratch bytes.
template <int kN, int kScratch, typename T>
__host__ __device__ constexpr int stages() {
  constexpr int n =
      (232448 - 1024 - kScratch) / (stage_span<kN, T>() + 16);
  return n < kMaxStages ? n : kMaxStages;
}

template <int kN, int kScratch, typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 +
         static_cast<size_t>(stages<kN, kScratch, T>()) *
             (stage_span<kN, T>() + 16) +
         kScratch;
}

// C [M, N] = A [M, K] B, cut as the header says.
struct Sched {
  int M, N, K;
  int splits;   // column splits per row tile
  int per;      // column tiles per split
  int items;    // row tiles x splits
};

struct Item {
  int m0, split, c0, c1;   // first row; split; column tiles [c0, c1)
};

__device__ __forceinline__ Item item_of(const Sched& s, int it, int ntiles) {
  Item w;
  const int mt = it / s.splits;          // once per item, not per box
  w.split = it - mt * s.splits;
  w.m0 = mt * kTileRows;
  w.c0 = w.split * s.per;
  w.c1 = min(ntiles, w.c0 + s.per);
  return w;
}

template <int kN, bool kBKMajor, class Epi, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b, const Sched s,
                const Epi epi) {
  constexpr bool kX3 = Elem<T>::kX3;
  constexpr int kBoxK = Elem<T>::kBoxK;
  static_assert(kBKMajor || !kX3, "3xTF32 takes a K-major B only");
  constexpr int kLoad = stage_bytes<kN>();
  constexpr int kStage = stage_span<kN, T>();
  constexpr int kStages = stages<kN, Epi::kScratch, T>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  uint8_t* scratch = reinterpret_cast<uint8_t*>(empty + kStages);
  const int ksteps = (s.K + kBoxK - 1) / kBoxK;
  const int ntiles = (s.N + kN - 1) / kN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 8);    // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // --------------------------------------------------------- producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      hopper::Ring w(kStages);
      for (int it = blockIdx.x; it < s.items; it += gridDim.x) {
        const Item t = item_of(s, it, ntiles);
        for (int c = t.c0; c < t.c1; ++c) {
          const int n0 = c * kN;
          for (int k = 0; k < ksteps; ++k) {
            uint8_t* dst = ring + w.stage * kStage;
            uint64_t* bar = full + w.stage;
            hopper::mbar_wait(empty + w.stage, w.phase ^ 1);
            hopper::mbar_expect_tx(bar, kLoad);
            hopper::tma_load_2d(dst, &tm_a, bar, kBoxK * k, t.m0);
            hopper::tma_load_2d(dst + kBoxBytes, &tm_a, bar, kBoxK * k,
                                t.m0 + 64);
#pragma unroll
            for (int j = 0; j < kN / 64; ++j) {
              if (kBKMajor)
                hopper::tma_load_2d(dst + (2 + j) * kBoxBytes, &tm_b, bar,
                                    kBoxK * k, n0 + 64 * j);
              else
                hopper::tma_load_2d(dst + (2 + j) * kBoxBytes, &tm_b, bar,
                                    n0 + 64 * j, 64 * k);
            }
            w.next();
          }
        }
      }
    }
  } else {
    // -------------------------------------------------------- consumers
    hopper::reg_alloc<232>();     // 2 x 128 x 232 + 128 x 40 <= 65,536
    const int lane = threadIdx.x & 31;
    auto release = [&](int st) {  // this warp is done with stage st
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + st);
    };
    Epi e = epi;
    hopper::Ring r(kStages);
    float acc[kN / 2];
    for (int it = blockIdx.x; it < s.items; it += gridDim.x) {
      const Item t = item_of(s, it, ntiles);
      e.begin(t.m0 + 64 * wg, t.split, scratch);
      for (int c = t.c0; c < t.c1; ++c) {
        e.template prepare<kN>(c * kN);
        int prev = -1;
        for (int k = 0; k < ksteps; ++k) {
          const int st = r.stage;
          hopper::mbar_wait(full + st, r.phase);
          uint8_t* sp = ring + st * kStage;
          const uint8_t* a = sp + wg * kBoxBytes;
          const uint8_t* b = sp + 2 * kBoxBytes;
          if constexpr (kX3) {
            hopper::split_tf32_smem(reinterpret_cast<float4*>(sp),
                                    reinterpret_cast<float4*>(sp + kLoad),
                                    kLoad / 16, threadIdx.x, 256);
            hopper::fence_async_shared();
            hopper::named_barrier(1, 256);    // the stage split by both
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {    // scale_d 0: overwrite
              const uint64_t ah = hopper::desc_sw128(a + 32 * kk);
              const uint64_t al = hopper::desc_sw128(a + kLoad + 32 * kk);
              const uint64_t bh = hopper::desc_sw128(b + 32 * kk);
              const uint64_t bl = hopper::desc_sw128(b + kLoad + 32 * kk);
              hopper::wgmma_m64n256k8_tf32(acc, al, bh, k | kk);
              hopper::wgmma_m64n256k8_tf32(acc, ah, bl, 1);
              hopper::wgmma_m64n256k8_tf32(acc, ah, bh, 1);
            }
          } else {
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)      // scale_d 0: overwrite
              Wgmma<kN>::template run<kBKMajor ? 0 : 1>(
                  acc, hopper::desc_sw128(a + 32 * kk),
                  kBKMajor ? hopper::desc_sw128(b + 32 * kk)
                           : hopper::desc_sw128(b + 2048 * kk, kBoxBytes),
                  k | kk);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          if (prev >= 0) release(prev);       // its products are done
          prev = st;
          r.next();
        }
        hopper::wgmma_wait<0>();
        release(prev);
        e.template tile<kN>(acc, c * kN);
      }
      e.end();
    }
  }
}

// Encode the operands' tensor maps and launch `grid` blocks. A is [M, K];
// B is [N, K] when kBKMajor, else [K, N]; both of type T (bf16, or f32
// for 3xTF32), rows 16-byte multiples, bases 16-byte aligned (the caller
// checks).
template <int kN, bool kBKMajor, class Epi, typename T = __nv_bfloat16>
cudaError_t launch(const void* a, const void* b, const Sched& s, int grid,
                   const Epi& epi, cudaStream_t st) {
  auto encode = Elem<T>::kX3 ? hopper::encode_f32_boxes
                             : hopper::encode_bf16_boxes;
  CUtensorMap tm_a, tm_b;
  cudaError_t err = encode(&tm_a, a, s.M, s.K);
  if (err != cudaSuccess) return err;
  err = kBKMajor ? encode(&tm_b, b, s.N, s.K) : encode(&tm_b, b, s.K, s.N);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<kN, Epi::kScratch, T>();
  err = ptt_set_smem(gemm_kernel<kN, kBKMajor, Epi, T>, smem);
  if (err != cudaSuccess) return err;
  gemm_kernel<kN, kBKMajor, Epi, T><<<grid, kThreads, smem, st>>>(
      tm_a, tm_b, s, epi);
  return cudaGetLastError();
}

}  // namespace gemm
