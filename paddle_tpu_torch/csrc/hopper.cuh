// Hopper (sm_90a) building blocks for the port's tensor-core kernels:
// mbarriers, TMA tile loads (2-D, and 3-D for a stack of matrices),
// wgmma shared-memory descriptors, the bf16 wgmma shapes K6 and the flash
// kernels use (csrc/gemm.cuh holds the wide ones of the shared GEMM
// mainloop), register-A wgmma on a packed accumulator fragment, the ring
// position, 2^x, the 3xTF32 split and the tf32 wgmma shapes of K3's, K5's
// and K6's f32 routes, cluster shared memory, and the host-side
// tensor-map encoding.
//
// Layout convention: every tile in shared memory is made of TMA boxes of
// [64 rows, 64 bf16 columns] = 8 KB, written with the 128-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_128B) at a 1024-byte aligned address. Such a box
// is at once
//   * a K-major operand (rows = M or N, the 64 columns = K): a k16 slice
//     starts 32 bytes further along the row, 8-row groups 1024 bytes apart;
//   * an MN-major operand (rows = K, the 64 columns = N): a k16 slice
//     starts 16 rows (2048 bytes) further down, 8-row groups 1024 bytes
//     apart, and the 64 columns are one swizzle atom.
// So one descriptor form serves both: both byte offsets are 1024 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBoxRows = 64;
constexpr int kBoxCols = 64;
constexpr int kBoxBytes = kBoxRows * kBoxCols * 2;   // 8 KB of bf16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA

// Copy the box at (column col, row row) of a 2-D tensor map into dst;
// completion is counted on bar's transaction bytes. Out-of-range rows and
// columns arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// The same from a 3-D tensor map: the box at (column col, row row) of
// matrix z. Rows past the map's row count arrive as zeros, so a tail tile
// of one matrix never reads the next one's rows.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row), "r"(z)
      : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `threads` threads (a multiple of 32) with id 1..15.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier `id` without waiting: with bar.sync of the same
// id and count elsewhere, one group of threads lets another go on.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------- warpgroups

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// The shared-memory descriptor of a 128-byte-swizzled operand starting at
// `p` (see the layout convention above). `lbo` is the byte distance
// between 64-column atoms of an MN-major operand wider than one box (the
// box size when boxes lie side by side); K-major operands ignore it.
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo = 1024) {
  const uint64_t addr = (smem_addr(p) & 0x3FFFF) >> 4;
  return addr | (static_cast<uint64_t>(lbo >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

// A position in an mbarrier ring: stage index and the parity of its
// fill, kept incrementally (no division on the per-box path).
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  int stages;
  __device__ explicit Ring(int n) : stages(n) {}
  __device__ void next() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wgmma's issue or wait.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kN) : "memory");
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_kk(float (&d)[16],
                                                   uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A K-major and B K-major
// (kTransB 0) or MN-major (1), both in shared memory; scale_d 0
// overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

// ------------------------------------------------------------ register A
//
// An m64nN f32 accumulator fragment holds, in thread t of the warpgroup
// (warp w = t / 32, lane l), rows r = 16 w + l / 4 and r + 8 at columns
// 8 i + 2 (l % 4) + e: d[4 i + 2 a + e] is row r + 8 a. The register A
// operand of an m64 k16 wgmma holds, in the same thread, rows r and r + 8
// at columns 2 (l % 4) + e and 8 + 2 (l % 4) + e, as four bf16 pairs:
// (r, 0-7), (r + 8, 0-7), (r, 8-15), (r + 8, 8-15). So columns 16 j ..
// 16 j + 15 of an accumulator, packed to bf16 pairs in register order,
// are the A operand of the k16 slice j of the next product: a
// probability tile computed in registers feeds the tensor cores without
// passing through shared memory.

// Two floats as one bf16 pair, `lo` in the low half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of k16 slice j from an accumulator fragment (see above).
template <int kN>
__device__ __forceinline__ void acc_to_a(const float (&acc)[kN], int j,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = pack_bf16(acc[8 * j + 2 * r], acc[8 * j + 2 * r + 1]);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A in registers, the bf16 pairs
// of an m64 accumulator fragment (see the register A note above), B from
// shared memory, K-major (kTransB 0) or MN-major (1); scale_d 0
// overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTransB));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]: A in registers, the bf16 pairs
// of an m64 accumulator fragment (see the register A note above), B from
// shared memory, K-major (kTransB 0) or MN-major (1); scale_d 0
// overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTransB));
}

// ----------------------------------------------------------------- 3xTF32
//
// f32-accurate products on the tensor cores (K5's and K6's f32 routes,
// csrc/xent.cu). TF32 wgmma reads 19 bits of each f32 operand (sign, 8 of
// exponent, 10 of mantissa) at 495 TFLOP/s. Each f32 operand is split
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest (cvt.rna: low 13 mantissa bits 0, so the tensor core reads them
// exactly), and a product is lo·hi + hi·lo + hi·hi in the f32
// accumulator. x - hi is exact in f32 and |x - hi| <= 2^-11 |x|, so
// |x - hi - lo| <= 2^-22 |x|; the dropped lo·lo and the two operands' lo
// roundings leave each product within about 3 x 2^-22 of its f32 value
// (1xTF32, hi·hi alone: 2^-10). Three TF32 products: 165 TFLOP/s.
// TF32 wgmma takes no transpose: both shared-memory operands are
// K-major. A k8 step is 32 bytes along a row, as a bf16 k16 step is, so
// the boxes of the layout convention above serve with 32 f32 columns.

// tf32(x), rounded to nearest (ties away), as an f32 with 13 zero bits.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// Split `n4` float4s of shared memory at `hi` in place: each value
// becomes its hi part, and its lo part goes to the same offset at `lo`.
// Thread `tid` of `threads` takes every threads-th float4.
__device__ __forceinline__ void split_tf32_smem(float4* hi, float4* lo,
                                                int n4, int tid,
                                                int threads) {
  for (int i = tid; i < n4; i += threads) {
    const float4 v = hi[i];
    const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y),
                                 tf32_rna(v.z), tf32_rna(v.w));
    hi[i] = h;
    lo[i] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                        tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
  }
}

// The "+f" operands of an accumulator's 32 (128) registers.
#define PTT_ACC32(d) \
  "+f"((d)[0]), "+f"((d)[1]), "+f"((d)[2]), "+f"((d)[3]), "+f"((d)[4]), \
  "+f"((d)[5]), "+f"((d)[6]), "+f"((d)[7]), "+f"((d)[8]), "+f"((d)[9]), \
  "+f"((d)[10]), "+f"((d)[11]), "+f"((d)[12]), "+f"((d)[13]), "+f"((d)[14]), \
  "+f"((d)[15]), "+f"((d)[16]), "+f"((d)[17]), "+f"((d)[18]), "+f"((d)[19]), \
  "+f"((d)[20]), "+f"((d)[21]), "+f"((d)[22]), "+f"((d)[23]), "+f"((d)[24]), \
  "+f"((d)[25]), "+f"((d)[26]), "+f"((d)[27]), "+f"((d)[28]), "+f"((d)[29]), \
  "+f"((d)[30]), "+f"((d)[31])
#define PTT_ACC128(d) \
  PTT_ACC32(d), PTT_ACC32((d) + 32), PTT_ACC32((d) + 64), \
  PTT_ACC32((d) + 96)

// d[64 x 256] (+)= A[64 x 8] B[8 x 256], tf32, both K-major in shared
// memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k8_tf32(float (&d)[128],
                                                     uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
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
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1;\n"
      "}\n"
      : PTT_ACC128(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32, both K-major in shared
// memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : PTT_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 256] (+)= A[64 x 8] B[8 x 256], tf32: A in registers, B K-major
// in shared memory; scale_d 0 overwrites d. The tf32 A fragment of an
// m64 k8 slice holds, in thread t of the warpgroup (warp w, lane l), rows
// r = 16 w + l / 4 and r + 8 at columns l % 4 and l % 4 + 4: a[0] is
// (r, l % 4), a[1] (r + 8, l % 4), a[2] (r, l % 4 + 4), a[3]
// (r + 8, l % 4 + 4).
__device__ __forceinline__ void wgmma_m64n256k8_tf32_rs(
    float (&d)[128], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
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
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : PTT_ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32: A in registers (the tf32 A
// fragment, see wgmma_m64n256k8_tf32_rs), B K-major in shared memory;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : PTT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// -------------------------------------------------------------- clusters
//
// Distributed shared memory between the blocks of a thread block cluster
// (K6's tf32x3 route: the blocks of one resident tile, one per chunk of
// H, exchange their partial logits).

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// Arrive, with release at cluster scope, on an mbarrier given by its
// shared::cluster address (this block's or another's).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// mbar_wait with acquire at cluster scope: the arrivals' writes from the
// other blocks of the cluster are visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --------------------------------------------------------------- host

// A tensor map of a row-major [rows, cols] bf16 matrix read in boxes of
// [64, 64] with the 128-byte swizzle. cols * 2 must be a multiple of 16
// and `base` 16-byte aligned (the caller checks). Returns a CUDA error.
// cuTensorMapEncodeTiled lives in libcuda; the runtime's entry-point
// lookup hands it over, so the library does not link libcuda itself.
using TensorMapEncode = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once; a CUDA error if it is missing.
inline cudaError_t tensor_map_encoder(TensorMapEncode* out) {
  static TensorMapEncode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<TensorMapEncode>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// The boxes of a row-major [rows, cols] matrix of `elem_bytes`-byte
// values: [64 rows, 128 bytes], 128-byte swizzle.
inline cudaError_t encode_boxes(CUtensorMap* map, CUtensorMapDataType type,
                                int elem_bytes, const void* base, int rows,
                                int cols) {
  TensorMapEncode encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) *
                                 elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             kBoxRows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t encode_bf16_boxes(CUtensorMap* map, const void* base,
                                     int rows, int cols) {
  return encode_boxes(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows,
                      cols);
}

// The same for f32: boxes of [64 rows, 32 f32] (8 KB, as a bf16 box), for
// the 3xTF32 routes. cols * 4 must be a multiple of 16.
inline cudaError_t encode_f32_boxes(CUtensorMap* map, const void* base,
                                    int rows, int cols) {
  return encode_boxes(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows,
                      cols);
}

// The same boxes over `mats` row-major [rows, cols] matrices of
// `elem_bytes`-byte values stored one after another ([mats, rows, cols]):
// a box never crosses from one matrix into the next, whose rows it reads
// as zeros instead.
inline cudaError_t encode_boxes_3d(CUtensorMap* map, CUtensorMapDataType type,
                                   int elem_bytes, const void* base,
                                   int mats, int rows, int cols) {
  TensorMapEncode encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * elem_bytes;
  const cuuint64_t strides[2] = {
      row_bytes, row_bytes * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t encode_bf16_boxes_3d(CUtensorMap* map, const void* base,
                                        int mats, int rows, int cols) {
  return encode_boxes_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                         mats, rows, cols);
}

// The same for f32: boxes of [64 rows, 32 f32] (K3's tf32x3 route).
inline cudaError_t encode_f32_boxes_3d(CUtensorMap* map, const void* base,
                                       int mats, int rows, int cols) {
  return encode_boxes_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, mats,
                         rows, cols);
}

}  // namespace hopper
