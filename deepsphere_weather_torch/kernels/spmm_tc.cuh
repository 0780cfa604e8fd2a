// Block-sparse SpMM bodies for Hopper (sm_90a), shared by the two BCSR
// layouts' kernels: bcsr_super_spmm.cu (super-row layout, K1/K2) and
// bcsr_spmm.cu (plain padded layout, K3/K4). Each source includes this
// header and wraps the bodies in `__global__` kernels of its own names, so
// that a profile or the SASS tells the two apart.
//
// A layout enters only through a view of one row block (`Rows`, defined by
// each source):
//   rows.col(u)                 the block-column of slot u: the x rows
//                               col(u)*128 .. +127 its block multiplies;
//   rows.a_row(u), rows.a_col(u)
//                               where slot u's 128x128 A block starts in A
//                               viewed 2-D with rows.stride columns.
// A row block walks the slots its list names (`Walk`: nz[g] = the count c
// of slots whose block is nonzero, then those slots in increasing order;
// NULL: every slot), in order, with no split-K and no atomics. A row's sum
// thus depends only on its own row block: a row-range launch equals the
// full launch's rows bit for bit, and, since a zero block adds an exact
// zero, a listed walk equals the walk over every slot. A row block with no
// listed slot writes zeros.
//
// Tensor-core body (bf16 x; `tc_body`): one CTA computes one 128-row block
// x BN columns (BN = 256, 128 or 64 by M alone, `tc_col_tile`, at most 128
// for fp32 A, so that a range launch and the full one run the same
// instructions):
//   - a producer warp walks the listed slots and, for each 64-deep half of
//     a slot, issues TMA copies (cp.async.bulk.tensor) of the A tile and of
//     the x rows the slot's block-column steers, into a ring of shared-
//     memory stages with full/empty mbarriers, 128-byte swizzled;
//   - two consumer warpgroups, 64 rows each, run wgmma.mma_async m64nBNk16
//     (x N-major from shared memory, fp32 accumulators in registers) and
//     cast to bf16 once, in the epilogue.
// bf16 A is read by wgmma from shared memory (K-major), one commit group
// per stage and one group in flight. fp32 A (A_F32) comes in as two
// 32-column fp32 boxes (128 bytes wide) per stage; each thread reads its
// wgmma A fragment from them and splits each value in registers into
// hi = bf16(a) and, with SPLIT, lo = bf16(a - hi), then issues wgmma with
// A from registers against the same x descriptor: once for hi (the A of
// the TPU's compiled kernel, which rounds fp32 A to bf16 against bf16 x),
// twice for hi + lo (the interpreter kernel's fp32 A). x is exactly bf16
// and a bf16 product is exact in the fp32 accumulator, so the split's only
// error is |a - hi - lo| <= 2^-8 |a - hi| <= 2^-16 |a| per term, far below
// the bf16 output's rounding of 2^-8. The register operands are read until
// their group ends, so that path keeps no group in flight across stages.
//
// Gather body (fp32 x, fp32 or bf16 A; `gather_body`): the product over
// the nonzero entries of the listed blocks, in plain fp32 FMAs (no TF32:
// the fp32 path matches the TPU's Precision.HIGHEST). A knn-20 Laplacian's
// 128x128 block is about 2% filled: at HEALPix-64 a row walks about 1130
// columns of listed blocks for about 21 nonzeros, so a body that multiplies
// whole blocks (67 TFLOP/s fp32 without tensor cores) spends 98% of its
// FMAs on zeros, and its bound, 1.70 ms at x[49152, 1024], lies above
// torch.sparse.mm's time. This body's bound is memory: the listed A blocks
// read once (223 MB fp32 at that shape), x and the output (PERF.md). One
// CTA owns RG rows of one row block (RG = 32, 16 or 8: the largest that
// gives every SM a CTA; at HEALPix-16's 24 row blocks, 16) and the whole
// width M:
//   1. warp 0 keeps a ring of A stages in flight: for each listed slot,
//      one 1-D bulk async copy (cp.async.bulk) per row of the rows' 128
//      entries, completing on the stage's full mbarrier; A is thus read
//      once, not once per column tile;
//   2. each warp compacts its rows' entries of the arrived slot into
//      (global column, value) lists in shared memory, 32 columns a warp
//      ballot, positions by __popc: a row's list keeps the walk's order
//      (slot after slot, columns increasing within a slot), built on the
//      device in the launch;
//   3. then, tile after tile of 64 V columns (V = 4 where M is a multiple
//      of 256, else 1), a row's 16 lanes gather the x rows its list names
//      through L1, V float4s each per list entry read, and add v * x in
//      list order, one fmaf a term.
// What bounds it in fact (PERF.md): step 3 reads every x element once per
// nonzero of its column through L1 (21 times at knn-20: 4.2 GB at
// x[49152, 1024], about 0.13 ms of the SMs' 128 bytes a clock), and steps
// 1-2 stream A and the output at most 2 CTAs an SM (128 registers a
// thread); V = 4 feeds four gathers from each list entry and keeps 16 in
// flight, which measured faster than V = 1 and 2.
// A row's list holds G_CAP entries; a 32-column unit that would overflow
// any row of the CTA first flushes: step 3 over the lists so far, adding
// onto the output written by the previous flush. An fp32 sum stored and
// read back is the same fp32 sum, so a row's result is one FMA chain over
// its nonzeros in the walk's order whatever the flushes and RG: a range
// launch equals the full launch's rows bit for bit. The dense-block sum
// runs the same chain with a zero product between the terms, which adds an
// exact zero; it differs in one respect: 0 x inf (or 0 x NaN) gives NaN
// there and nothing here, where a zero entry of A multiplies nothing (as
// on the ELL route, ell_spmm.cu). bf16 A widens to fp32 exactly. The
// output is fp32.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

constexpr int BS = 128;   // block size of the BCSR layouts (rows per block)

// Codes from this header above CUDA's own: ENCODE_ERROR + the CUresult of
// a failed cuTensorMapEncodeTiled (CUDA_ERROR_NOT_FOUND: no encoder).
constexpr int ENCODE_ERROR = 1 << 16;

// The slots one row block walks: nz [.., 1 + slots] row g, or every slot.
struct Walk {
  const int32_t* list;
  int n;
  __device__ Walk(const int32_t* nz, int64_t g, int slots)
      : list(nz ? nz + g * (slots + 1) : nullptr), n(list ? list[0] : slots) {}
  __device__ int slot(int i) const { return list ? list[1 + i] : i; }
};

// ---------------------------------------------------------------------------
// Tensor-core body (bf16 x): TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int BK = 64;          // depth of one stage: one 128-byte swizzle row of bf16
constexpr int WG = 128;         // threads of a warpgroup
constexpr int CONSUMERS = 2;    // consumer warpgroups, 64 rows each
constexpr int TC_THREADS = CONSUMERS * WG + 32;   // + one producer warp
constexpr int A_TILE = BS * BK * 2;               // 16 KB: 128 rows x 64 bf16 (or 32 fp32)
constexpr int X_BOX = BK * 64 * 2;                // 8 KB: 64 k x 64 columns
constexpr int SMEM_MAX = 232448;                  // dynamic shared memory of a block

// The ring of one instance: a stage holds A's 128 x 64 k (one bf16 box or
// two fp32 boxes) and x's 64 k x BN; as many stages (at most 4) as fit
// beside 1 KB of slack to align them to the 128-byte swizzle's 1 KB atom
// and the 2 mbarriers of each.
template <int BN, bool A_F32>
struct Ring {
  static constexpr int A_STAGE = A_F32 ? 2 * A_TILE : A_TILE;
  static constexpr int X_STAGE = BN / 64 * X_BOX;
  static constexpr int FIT = (SMEM_MAX - 1024 - 64) / (A_STAGE + X_STAGE);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = STAGES * (A_STAGE + X_STAGE) + 1024 + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One 2-D TMA box into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
       | ((uint64_t)(lbo >> 4) << 16)
       | ((uint64_t)(sbo >> 4) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving accumulator or A-fragment reads or writes
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// wgmma operand lists: the accumulators of m64nBN (BN / 2 fp32 a thread)
#define D8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D32(i) D8(i), D8(i + 8), D8(i + 16), D8(i + 24)
#define ACC32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define ACC64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define ACC128                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
  " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
  " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
  " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d += A[64 x 16] B[16 x BN], A from shared memory (K-major) or from
// registers (`a`, the fragment of mma.m16n8k16 per warp), B N-major
// (imm-trans-b 1). The predicate (scale-d) is always 1: d accumulates.
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : D32(0) : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : D32(0), D32(32) : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACC128
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : D32(0), D32(32), D32(64), D32(96) : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D32(0), D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4],
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACC128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : D32(0), D32(32), D32(64), D32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC32
#undef ACC64
#undef ACC128
#undef D32
#undef D8

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma A fragments of one 64-deep fp32 stage (two 128-row x 32-column
// boxes, 128-byte swizzled: the 16-byte chunk j of row r lies at chunk
// j ^ (r % 8)) for the thread's rows r0 and r0 + 8 and k pair 2t: per
// k16 step kk, register v + 2h holds (row r0 + 8v, k 16kk + 2t + 8h and
// the next), as bf16 hi, and with SPLIT the remainder lo = bf16(a - hi).
template <bool SPLIT>
__device__ __forceinline__ void split_fragments(const uint8_t* a, int r0, int t,
                                                uint32_t (&hi)[BK / 16][4],
                                                uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint8_t* box = a + (kk / 2) * A_TILE;   // k 0-31, then 32-63
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * (kk % 2) + 2 * t + 8 * h;   // column in the box
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int r = r0 + 8 * v;
        const float2 f = *reinterpret_cast<const float2*>(
            box + r * 128 + (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4);
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(f.x, f.y);
        hi[kk][v + 2 * h] = bf16x2_bits(h2);
        if (SPLIT) {
          const float2 back = __bfloat1622float2(h2);
          lo[kk][v + 2 * h] =
              bf16x2_bits(__floats2bfloat162_rn(f.x - back.x, f.y - back.y));
        }
      }
    }
  }
}

// Output row block o (blockIdx.y) x BN columns (blockIdx.x) of A @ x:
// consumer warpgroup w takes rows 64w .. 64w + 63 of the row block.
template <int BN, bool A_F32, bool SPLIT, class Rows>
__device__ __forceinline__ void tc_body(const CUtensorMap* a_map,
                                        const CUtensorMap* x_map,
                                        const Rows& rows, const Walk& walk,
                                        __nv_bfloat16* __restrict__ out,
                                        int64_t o, int64_t M) {
  static_assert(BN <= 256, "accumulators: 128 registers a thread");
  static_assert(A_F32 || !SPLIT, "only fp32 A is split");
  using R = Ring<BN, A_F32>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* a_st = smem;                         // STAGES x A's 128 rows x 64 k
  uint8_t* x_st = smem + R::STAGES * R::A_STAGE;  // STAGES x BN/64 x [64 k][64 cols]
  uint64_t* full = reinterpret_cast<uint64_t*>(x_st + R::STAGES * R::X_STAGE);
  uint64_t* empty = full + R::STAGES;
  const int col0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < R::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * WG) {
    // producer warp: one lane keeps the ring full, two 64-deep halves of
    // each listed slot
    if (threadIdx.x == CONSUMERS * WG) {
      for (int n = 0, it = 0; n < walk.n; ++n) {
        const int u = walk.slot(n);
        const int c = rows.col(u);
        for (int k = 0; k < BS; k += BK, ++it) {
          const int stage = it % R::STAGES;
          mbar_wait(&empty[stage], ((it / R::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[stage], R::A_STAGE + R::X_STAGE);
          uint8_t* a_dst = a_st + stage * R::A_STAGE;
          tma_load(a_dst, a_map, &full[stage], rows.a_col(u) + k, rows.a_row(u));
          if (A_F32)   // the second 32-column fp32 box
            tma_load(a_dst + A_TILE, a_map, &full[stage],
                     rows.a_col(u) + k + 32, rows.a_row(u));
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(x_st + stage * R::X_STAGE + j * X_BOX, x_map, &full[stage],
                     col0 + 64 * j, c * BS + k);
        }
      }
    }
    return;
  }

  // consumer warpgroup w: rows 64w .. 64w + 63 of the row block
  const int w = threadIdx.x / WG;
  const int t = threadIdx.x % WG;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

  for (int it = 0; it < walk.n * (BS / BK); ++it) {
    const int stage = it % R::STAGES;
    mbar_wait(&full[stage], (it / R::STAGES) & 1);
    const uint8_t* b = x_st + stage * R::X_STAGE;
    if constexpr (A_F32) {
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
      split_fragments<SPLIT>(a_st + stage * R::A_STAGE,
                             w * 64 + (t / 32) * 16 + (t % 32) / 4, t % 4, hi,
                             lo);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = smem_desc(b + kk * 2048, X_BOX, 1024);
        mma(d, hi[kk], db);
        if (SPLIT) mma(d, lo[kk], db);
      }
      wgmma_commit();
      fence_acc(d);
      // the fragments are read until the group ends: none stays in flight
      wgmma_wait<0>();
      fence_frag(hi);
      if (SPLIT) fence_frag(lo);
      mbar_arrive(&empty[stage]);
    } else {
      const uint8_t* a = a_st + stage * R::A_STAGE + w * 64 * (BK * 2);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // A: K-major, 8-row groups 1 KB apart, k16 steps 32 bytes along the
        // swizzled row; x: N-major, 8-row k groups 1 KB apart, 64-column
        // boxes X_BOX apart, k16 steps 16 rows = 2 KB
        mma(d, smem_desc(a + kk * 32, 16, 1024),
            smem_desc(b + kk * 2048, X_BOX, 1024));
      wgmma_commit();
      fence_acc(d);
      // one group stays in flight: the previous stage is free once it ends
      wgmma_wait<1>();
      if (it > 0) mbar_arrive(&empty[(it - 1) % R::STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_acc(d);

  // d[4j + v0 + 2 v1] is (row 16*warp + lane/4 + 8 v1, column
  // 8j + 2*(lane%4) + v0) of the warpgroup's rows
  const int64_t row = o * BS + w * 64 + (t / 32) * 16 + (t % 32) / 4;
  __nv_bfloat16* y = out + row * M + col0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(y + 8 * j) =
        __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(y + 8 * M + 8 * j) =
        __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// Gather body (fp32 x): A's nonzeros compacted on the device, x gathered
// ---------------------------------------------------------------------------

constexpr int G_THREADS = 256;            // 8 warps
constexpr int G_WARPS = G_THREADS / 32;
constexpr int G_MIN_CTAS = 2;             // CTAs an SM: at most 128 registers
constexpr int G_LANES = 16;               // lanes a row: a half-warp
constexpr int G_BN = 64;                  // columns of the narrowest tile
constexpr int G_CAP = 64;                 // list entries a row holds
constexpr int G_MAX_RG = 32;              // rows of a CTA at most
constexpr int G_MAX_STAGES = 4;
constexpr int G_RING = 32768;             // bytes of A stages at most
constexpr int G_LISTS = 256;              // mbarriers and list lengths first

static_assert(G_MAX_RG <= 32, "warp 0 copies one row a lane");
static_assert(G_CAP >= 32, "a 32-column unit must fit an empty list");

// Where a CTA's shared memory goes: the stages' full mbarriers and the
// rows' list lengths, the lists ((column, value bits) pairs), the ring of
// A stages (RG rows of one slot each; as many as G_RING holds, at most
// G_MAX_STAGES).
struct GatherSmem {
  int lists, ring, stage, stages, bytes;
  __host__ __device__ GatherSmem(int RG, int a_size) {
    lists = G_LISTS;
    ring = (lists + RG * G_CAP * 8 + 127) / 128 * 128;
    stage = RG * BS * a_size;
    stages = G_RING / stage < G_MAX_STAGES ? G_RING / stage : G_MAX_STAGES;
    bytes = ring + stages * stage;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One 1-D bulk async copy into shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float v, float4 x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

// Step 3 over the lists so far: out[r, :] (+)= sum_j v_j * x[c_j, :] for
// the CTA's rows, tile after tile of 64 V columns; `more` adds onto what
// the previous flush wrote. A row's 16 lanes take V float4s each, 64
// columns apart (16 lanes read 256 contiguous bytes of an x row), so a
// warp covers two rows of a tile and each list entry read feeds V
// gathers; UNR entries' gathers are in flight before their FMAs.
template <int V, int UNR>
__device__ __forceinline__ void gather_flush(const int* cnt,
                                             const int2* lists, int RG,
                                             const float* __restrict__ x,
                                             float* __restrict__ out,
                                             int64_t M, bool more) {
  constexpr int T = G_BN * V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pairs = RG / 2;
  const int items = (int)(M / T) * pairs;
  for (int item = warp; item < items; item += G_WARPS) {
    const int r = (item % pairs) * 2 + lane / G_LANES;
    const int64_t c = (int64_t)(item / pairs) * T + (lane % G_LANES) * 4;
    const int n = cnt[r];
    const int2* e = lists + r * G_CAP;
    float* o = out + r * M + c;
    float4 acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      acc[v] = more ? *reinterpret_cast<const float4*>(o + G_BN * v)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    const float* xc = x + c;
    int j = 0;
    for (; j + UNR <= n; j += UNR) {
      int2 p[UNR];
      float4 xv[UNR][V];
#pragma unroll
      for (int q = 0; q < UNR; ++q) {
        p[q] = e[j + q];
#pragma unroll
        for (int v = 0; v < V; ++v)
          xv[q][v] = __ldg(reinterpret_cast<const float4*>(
              xc + (int64_t)p[q].x * M + G_BN * v));
      }
#pragma unroll
      for (int q = 0; q < UNR; ++q)
#pragma unroll
        for (int v = 0; v < V; ++v)
          fma4(acc[v], __int_as_float(p[q].y), xv[q][v]);
    }
    for (; j < n; ++j) {
      const int2 p = e[j];
      float4 xv[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        xv[v] = __ldg(reinterpret_cast<const float4*>(
            xc + (int64_t)p.x * M + G_BN * v));
#pragma unroll
      for (int v = 0; v < V; ++v) fma4(acc[v], __int_as_float(p.y), xv[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      *reinterpret_cast<float4*>(o + G_BN * v) = acc[v];
  }
}

// Rows i0 .. i0 + RG - 1 of one row block (`rows`, `walk`) of A @ x, x
// fp32 [x_rows, M] (M % (64 V) == 0, 16-byte aligned), into out, which
// points at the CTA's first output row. RG divides 128 and is at most
// G_MAX_RG.
template <typename TA, int V, int UNR, class Rows>
__device__ __forceinline__ void gather_body(const TA* __restrict__ a,
                                            const Rows& rows, const Walk& walk,
                                            int i0, int RG,
                                            const float* __restrict__ x,
                                            float* __restrict__ out,
                                            int64_t M) {
  extern __shared__ __align__(128) uint8_t smem[];
  const GatherSmem sm(RG, (int)sizeof(TA));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* cnt = reinterpret_cast<int*>(smem + G_MAX_STAGES * 8);
  int2* lists = reinterpret_cast<int2*>(smem + sm.lists);
  uint8_t* ring = smem + sm.ring;
  constexpr int ROW_BYTES = BS * (int)sizeof(TA);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < sm.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0: slot n's rows into stage n % stages
  auto issue = [&](int n) {
    const int u = walk.slot(n);
    const int s = n % sm.stages;
    if (lane == 0) mbar_expect_tx(&full[s], (uint32_t)sm.stage);
    __syncwarp();
    if (lane < RG)
      bulk_load(ring + s * sm.stage + lane * ROW_BYTES,
                a + (int64_t)(rows.a_row(u) + i0 + lane) * rows.stride +
                    rows.a_col(u),
                ROW_BYTES, &full[s]);
  };
  if (warp == 0)
    for (int n = 0; n < walk.n && n < sm.stages; ++n) issue(n);

  // warp w compacts rows w + 8k; their list lengths live in registers and
  // go to shared memory for a flush
  constexpr int K = G_MAX_RG / G_WARPS;
  int len[K];
#pragma unroll
  for (int k = 0; k < K; ++k) len[k] = 0;
  bool flushed = false;
  auto flush = [&]() {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (warp + G_WARPS * k < RG && lane == 0) cnt[warp + G_WARPS * k] = len[k];
    __syncthreads();
    gather_flush<V, UNR>(cnt, lists, RG, x, out, M, flushed);
    flushed = true;
    __syncthreads();   // the lists are read before they are written again
#pragma unroll
    for (int k = 0; k < K; ++k) len[k] = 0;
  };

  for (int n = 0; n < walk.n; ++n) {
    const int s = n % sm.stages;
    mbar_wait(&full[s], (uint32_t)((n / sm.stages) & 1));
    const TA* st = reinterpret_cast<const TA*>(ring + s * sm.stage);
    const int col0 = rows.col(walk.slot(n)) * BS;
    // the ballot of each row's 32-column units, and the values
    float v[K][4];
    uint32_t b[K][4];
    bool over = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = warp + G_WARPS * k;
      if (r < RG) {   // warp-uniform
        int total = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[k][q] = to_f32(st[r * BS + 32 * q + lane]);
          b[k][q] = __ballot_sync(0xffffffffu, v[k][q] != 0.f);
          total += __popc(b[k][q]);
        }
        over |= len[k] + total > G_CAP;
      }
    }
    if (!__syncthreads_or(over)) {
      // every warp has read stage s: its next slot may come in
      if (warp == 0 && n + sm.stages < walk.n) issue(n + sm.stages);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int r = warp + G_WARPS * k;
          if (r < RG) {
            if (v[k][q] != 0.f)
              lists[r * G_CAP + len[k] +
                    __popc(b[k][q] & ((1u << lane) - 1u))] =
                  make_int2(col0 + 32 * q + lane, __float_as_int(v[k][q]));
            len[k] += __popc(b[k][q]);
          }
        }
      continue;
    }
    // a row's list would overflow within this slot: unit by unit, a flush
    // first where a unit would overflow one; the values are read again
    // from stage s, which stays until the slot is done, so that none is
    // held across a flush
    for (int q = 0; q < 4; ++q) {
      bool o = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = warp + G_WARPS * k;
        if (r < RG)
          o |= len[k] + __popc(__ballot_sync(
                   0xffffffffu, to_f32(st[r * BS + 32 * q + lane]) != 0.f))
               > G_CAP;
      }
      if (__syncthreads_or(o)) flush();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = warp + G_WARPS * k;
        if (r < RG) {
          const float a_rq = to_f32(st[r * BS + 32 * q + lane]);
          const uint32_t bq = __ballot_sync(0xffffffffu, a_rq != 0.f);
          if (a_rq != 0.f)
            lists[r * G_CAP + len[k] + __popc(bq & ((1u << lane) - 1u))] =
                make_int2(col0 + 32 * q + lane, __float_as_int(a_rq));
          len[k] += __popc(bq);
        }
      }
    }
    __syncthreads();   // every warp has read stage s
    if (warp == 0 && n + sm.stages < walk.n) issue(n + sm.stages);
  }
  flush();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Columns per CTA of the tensor-core body for x width M (0: unsupported).
inline int tc_col_tile(int64_t M) {
  return M % 256 == 0 ? 256 : M % 128 == 0 ? 128 : M % 64 == 0 ? 64 : 0;
}

// Widest column tile of the tensor-core body with fp32 A: at 256 columns
// the 128 accumulators a thread and the split A fragments spill.
constexpr int F32A_BN = 128;

// Columns per CTA of the tensor-core body (bf16 x) for width M and A's type.
inline int tc_tile(int64_t M, int a_bf16) {
  const int tile = tc_col_tile(M);
  return a_bf16 || tile <= F32A_BN ? tile : F32A_BN;
}

// f(std::integral_constant<int, BN>()) for the column tile `tile`.
template <class F>
int with_col_tile(int tile, F&& f) {
  switch (tile) {
    case 256: return f(std::integral_constant<int, 256>());
    case 128: return f(std::integral_constant<int, 128>());
    case 64: return f(std::integral_constant<int, 64>());
  }
  return (int)cudaErrorInvalidValue;
}

// Columns of the gather body's tile for width M (0: unsupported).
inline int gather_col_tile(int64_t M) { return M % G_BN == 0 ? G_BN : 0; }

// Rows a CTA of the gather body owns for a launch over `blocks` row
// blocks: the largest of 32, 16, 8 that gives every SM a CTA.
inline int gather_rows(int64_t blocks) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  int RG = G_MAX_RG;
  while (RG > 8 && blocks * (BS / RG) < (int64_t)sms) RG /= 2;
  return RG;
}

// Launch the gather-body kernel K<TA, V, UNR>::fn (taking its row-group
// size, then `args`) over `blocks` row blocks: V = 4 float4s a lane where
// M is a multiple of 256 columns, else 1.
template <typename TA, template <typename, int, int> class K,
          typename... Args>
int launch_gather(int64_t blocks, int64_t M, cudaStream_t stream,
                  Args... args) {
  const int RG = gather_rows(blocks);
  const GatherSmem sm(RG, (int)sizeof(TA));
  auto go = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)(blocks * (BS / RG)), G_THREADS, sm.bytes, stream>>>(
        RG, args...);
    return (int)cudaGetLastError();
  };
  return M % (4 * G_BN) == 0 ? go(K<TA, 4, 4>::fn) : go(K<TA, 1, 8>::fn);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: fetched through the runtime so
// that the library does not link it.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// bf16 (or fp32) [rows, cols] row-major in boxes of box_rows x 64 (32)
// columns: 128 bytes, the swizzle's span; 128-byte swizzled.
inline int encode(CUtensorMap* map, const void* base, bool f32, uint64_t rows,
                  uint64_t cols, uint32_t box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  const uint32_t size = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * size};
  const cuuint32_t box[2] = {128 / size, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// A's descriptor (128-row boxes), encoded once per (address, type, shape):
// a descriptor is a function of those alone, so a freed and reused address
// of the same type and shape gets the same, right, descriptor.
inline int a_map_memo(CUtensorMap* map, const void* a, bool f32, uint64_t rows,
                      uint64_t cols) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, bool, uint64_t, uint64_t>,
                  CUtensorMap> cache;
  const auto key = std::make_tuple(a, f32, rows, cols);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return 0;
  }
  const int err = encode(map, a, f32, rows, cols, BS);
  if (err) return err;
  if (cache.size() >= 256) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

// Launch `kernel` (a tc_body instance taking A's and x's descriptors, then
// `args`) over grid_y row blocks: A viewed 2-D [a_rows, a_cols], x the bf16
// [x_rows, M].
template <int BN, bool A_F32, typename Kernel, typename... Args>
int launch_tc(Kernel kernel, const void* a, uint64_t a_rows, uint64_t a_cols,
              const void* x, uint64_t x_rows, int64_t M, int64_t grid_y,
              cudaStream_t stream, Args... args) {
  CUtensorMap a_map, x_map;
  int err = a_map_memo(&a_map, a, A_F32, a_rows, a_cols);
  if (err) return err;
  // x has a new address every call
  err = encode(&x_map, x, false, x_rows, (uint64_t)M, BK);
  if (err) return err;
  constexpr int smem = Ring<BN, A_F32>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(M / BN), (unsigned)grid_y);
  kernel<<<grid, TC_THREADS, smem, stream>>>(a_map, x_map, args...);
  return (int)cudaGetLastError();
}

inline const char* error_string(int code) {
  if (code >= ENCODE_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (CUresult %d)", code - ENCODE_ERROR);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace
