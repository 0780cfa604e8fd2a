// Super-row block-sparse SpMM for Hopper (sm_90a): Y = A @ X.
//
// Replaces two TPU kernels of deepsphere_weather_tpu/ops/pallas_spmm.py
// that compute the same function over the same layout:
//   - `_spmm_kernel_super_sched` (K1), every super-row: `bcsr_super_spmm`;
//   - `_spmm_kernel_super` (K2), the super-rows [s_begin, s_end) of a
//     row-sharded operator against the full x: `bcsr_super_spmm_rows`.
//
//   out[(s - s_begin)*R*128 + r*128 + i, m] =
//       sum_{u listed for row block s*R + r}
//           sum_j svals[s, r, i, u*128 + j] * x[ucols[s, u]*128 + j, m]
//
// svals [n_s, R, 128, max_u*128] holds, per super-row s (R consecutive
// 128-row blocks of the Laplacian), the row blocks concatenated over the
// union of block-columns that any of its rows touches; ucols [n_s, max_u]
// names each union slot's block-column. nz [n_s, R, 1 + max_u] lists, per
// row block, the count c of union slots whose block is nonzero and then
// those slots in increasing order; without nz every slot is walked. A
// zero block adds an exact zero, so the two agree bit for bit, and a row
// block with no listed slot writes zeros. x is [x_rows, M], the full x
// whatever the range (ucols holds global block-columns).
//
// Both entries launch one kernel body per regime, over the range's row
// blocks; a row's sum depends only on its own row block's listed slots,
// taken in slot order (no split-K, no atomics), so a range launch equals
// the full launch's rows bit for bit.
//
// bf16 regime (bf16 A, bf16 x; the regime of the main paths): tensor
// cores. The earlier design widened bf16 to fp32 FMAs (67 TFLOP/s peak),
// multiplied the zero blocks and loaded synchronously: it was bound by the
// FMA issue rate. Here one CTA computes one 128-row block x BN columns
// (BN = 256, 128 or 64 by M alone, `col_tile`, so that a range launch and
// the full one run the same instructions):
//   - a producer warp walks the row block's listed slots and, for each
//     64-deep half of a slot, issues TMA copies (cp.async.bulk.tensor) of
//     the A tile (svals viewed as [n_s*R*128, max_u*128], at row block *
//     128, u*128 + k) and of the x rows the slot's block-column steers
//     (at ucols[s, u]*128 + k, col0): the counterpart of the TPU kernel's
//     scalar-steered DMA; into a ring of STAGES shared-memory stages with
//     full/empty mbarriers, 128-byte swizzled;
//   - two consumer warpgroups, 64 rows each, run wgmma.mma_async
//     m64nBNk16 (bf16 operands from shared memory, A K-major, x N-major,
//     fp32 accumulators in registers), one commit group per stage and one
//     group in flight, and cast to bf16 once, in the epilogue;
//   - zero blocks are skipped: only listed slots are loaded and multiplied.
// x is reused across a super-row's R row blocks through L2: a CTA over a
// super-row's two row blocks sharing each x tile measured slower at 24
// and at 384 row blocks (PERF.md). The TPU's stay/copy/new slot schedule and VMEM budget have no
// counterpart here. What bounds it now (PERF.md): at HEALPix-16 (24 row
// blocks) the grid, 24 to 192 CTAs for 132 SMs, and short loops (about 8
// listed slots a row block) whose fill and epilogue do not overlap; at
// HEALPix-64 (384) the traffic from L2, where every row block reads its x
// tiles and every column tile its A tiles again (~1.3 GB per width-1024
// launch, ~5.5 TB/s).
//
// fp32 and mixed regimes: plain fp32 FMAs (no TF32: the fp32 path matches
// the TPU's Precision.HIGHEST), one CTA per row block and 64 columns,
// 16-deep shared-memory slices, the same slot walk. Mixed operand types
// follow the TPU kernel: fp32 x widens bf16 A exactly; bf16 x rounds fp32
// A to bf16 first. The output is bf16 for bf16 x and fp32 otherwise.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int BS = 128;   // block size of the BCSR layout (rows per block)

// Codes from this file above CUDA's own: ENCODE_ERROR + the CUresult of a
// failed cuTensorMapEncodeTiled (CUDA_ERROR_NOT_FOUND: no encoder).
constexpr int ENCODE_ERROR = 1 << 16;

__device__ __forceinline__ const int32_t* slot_list(const int32_t* nz,
                                                    int64_t g, int max_u) {
  return nz ? nz + g * (max_u + 1) : nullptr;
}

// ---------------------------------------------------------------------------
// fp32 FMA body (fp32 and mixed regimes)
// ---------------------------------------------------------------------------

constexpr int F_BM = 128;   // output rows per CTA (one row block)
constexpr int F_BN = 64;    // output columns per CTA
constexpr int F_BK = 16;    // depth of one shared-memory stage
constexpr int F_TM = 8;     // rows per thread
constexpr int F_TN = 4;     // columns per thread
constexpr int F_THREADS = (F_BM / F_TM) * (F_BN / F_TN);   // 256
constexpr int F_APAD = 4;   // keeps the transposed A stores 2-way at worst

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A operand as the product sees it: fp32 A against bf16 x is rounded to
// bf16 first (the TPU kernel casts A to the bf16 regime's dtype).
template <typename TA, bool X_BF16>
__device__ __forceinline__ float a_operand(TA v) {
  float f = to_f32(v);
  if (X_BF16) f = __bfloat162float(__float2bfloat16(f));
  return f;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename TA, typename TX, typename TO, bool X_BF16>
__global__ void __launch_bounds__(F_THREADS)
bcsr_super_spmm_fma(const TA* __restrict__ svals,
                    const int32_t* __restrict__ ucols,
                    const int32_t* __restrict__ nz,
                    const TX* __restrict__ x,
                    TO* __restrict__ out,
                    int64_t s_begin, int R, int max_u, int64_t M) {
  __shared__ __align__(16) float As[F_BK][F_BM + F_APAD];
  __shared__ __align__(16) float Bs[F_BK][F_BN];

  const int tid = threadIdx.x;
  const int tx = tid % (F_BN / F_TN);      // 0..15: column group
  const int ty = tid / (F_BN / F_TN);      // 0..15: row group
  const int64_t o = blockIdx.y;            // output row block
  const int64_t g = s_begin * R + o;       // row block of A = s*R + r
  const int64_t s = g / R;
  const int64_t col0 = (int64_t)blockIdx.x * F_BN;
  const int64_t K = (int64_t)max_u * BS;   // row length of svals
  const int32_t* list = slot_list(nz, g, max_u);
  const int n_slots = list ? list[0] : max_u;

  // row block g's rows start at svals[s, r, 0, 0] = svals + g*128*K
  const TA* a_rows = svals + g * F_BM * K;

  // loader coordinates
  const int a_k = tid % F_BK;              // A: 16 consecutive k per row
  const int a_i = tid / F_BK;              // rows a_i + 16*p
  const int b_c = tid % F_BN;              // x: 64 consecutive columns
  const int b_k = tid / F_BN;              // k rows b_k + 4*p

  float acc[F_TM][F_TN];
#pragma unroll
  for (int i = 0; i < F_TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.f;

  for (int n = 0; n < n_slots; ++n) {
    const int u = list ? list[1 + n] : n;
    const int64_t c = ucols[s * max_u + u];
    const TA* a_slot = a_rows + (int64_t)u * BS;
    const TX* x_slot = x + c * BS * M + col0;
    for (int kk = 0; kk < BS; kk += F_BK) {
#pragma unroll
      for (int p = 0; p < F_BM / (F_THREADS / F_BK); ++p) {
        const int i = a_i + p * (F_THREADS / F_BK);
        As[a_k][i] = a_operand<TA, X_BF16>(a_slot[(int64_t)i * K + kk + a_k]);
      }
#pragma unroll
      for (int p = 0; p < F_BK / (F_THREADS / F_BN); ++p) {
        const int k = b_k + p * (F_THREADS / F_BN);
        Bs[k][b_c] = to_f32(x_slot[(int64_t)(kk + k) * M + b_c]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < F_BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * F_TM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * F_TM + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * F_TN]);
        const float av[F_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[F_TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < F_TM; ++i)
#pragma unroll
          for (int j = 0; j < F_TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  TO* y = out + (o * F_BM + ty * F_TM) * M + col0 + tx * F_TN;
#pragma unroll
  for (int i = 0; i < F_TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) store_out(y + (int64_t)i * M + j, acc[i][j]);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body: TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int BK = 64;          // depth of one stage: 64 bf16, one 128-byte swizzle row
constexpr int STAGES = 4;       // shared-memory ring
constexpr int WG = 128;         // threads of a warpgroup
constexpr int CONSUMERS = 2;    // consumer warpgroups, 64 rows each
constexpr int TC_THREADS = CONSUMERS * WG + 32;   // + one producer warp
constexpr int A_TILE = BS * BK * 2;               // 16 KB: 128 rows x 64 k
constexpr int X_BOX = BK * 64 * 2;                // 8 KB: 64 k x 64 columns

template <int BN>
constexpr int tc_smem_bytes() {
  // stages, 1 KB of slack to align them to the 128-byte swizzle's 1 KB
  // atom, and the 2*STAGES mbarriers
  return STAGES * (A_TILE + BN / 64 * X_BOX) + 1024 + 2 * STAGES * 8;
}

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
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[32] += A[64 x 16] B[16 x 64]: A K-major, B N-major (imm-trans-b 1)
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64] += A[64 x 16] B[16 x 128]: A K-major, B N-major (imm-trans-b 1)
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[128] += A[64 x 16] B[16 x 256]: A K-major, B N-major (imm-trans-b 1)
__device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// One CTA: one row block x BN columns; consumer warpgroup w takes rows
// 64w .. 64w + 63 of the row block.
template <int BN>
__global__ void __launch_bounds__(TC_THREADS, 1)
bcsr_super_spmm_tc(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap x_map,
                   const int32_t* __restrict__ ucols,
                   const int32_t* __restrict__ nz,
                   __nv_bfloat16* __restrict__ out,
                   int64_t s_begin, int R, int max_u, int64_t M) {
  static_assert(BN <= 256, "accumulators: 128 registers a thread");
  constexpr int X_TILE = BN / 64 * X_BOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* a_st = smem;                       // STAGES x [128 rows][64 k]
  uint8_t* x_st = smem + STAGES * A_TILE;     // STAGES x BN/64 x [64 k][64 cols]
  uint64_t* full = reinterpret_cast<uint64_t*>(x_st + STAGES * X_TILE);
  uint64_t* empty = full + STAGES;

  const int64_t o = blockIdx.y;               // output row block
  const int64_t g = s_begin * R + o;          // row block of A = s*R + r
  const int64_t s = g / R;
  const int col0 = blockIdx.x * BN;
  const int32_t* list = slot_list(nz, g, max_u);
  const int n_slots = list ? list[0] : max_u;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
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
      for (int n = 0, it = 0; n < n_slots; ++n) {
        const int u = list ? list[1 + n] : n;
        const int c = ucols[s * max_u + u];
        for (int k = 0; k < BS; k += BK, ++it) {
          const int stage = it % STAGES;
          mbar_wait(&empty[stage], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[stage], A_TILE + X_TILE);
          tma_load(a_st + stage * A_TILE, &a_map, &full[stage], u * BS + k,
                   (int)(g * BS));
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(x_st + stage * X_TILE + j * X_BOX, &x_map, &full[stage],
                     col0 + 64 * j, c * BS + k);
        }
      }
    }
    return;
  }

  // consumer warpgroup w: rows 64w .. 64w + 63 of the row block
  const int w = threadIdx.x / WG;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

  for (int it = 0; it < n_slots * (BS / BK); ++it) {
    const int stage = it % STAGES;
    mbar_wait(&full[stage], (it / STAGES) & 1);
    const uint8_t* a = a_st + stage * A_TILE + w * 64 * (BK * 2);
    const uint8_t* b = x_st + stage * X_TILE;
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
    if (it > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(d);

  // d[4j + v0 + 2 v1] is (row 16*warp + lane/4 + 8 v1, column
  // 8j + 2*(lane%4) + v0) of the warpgroup's rows
  const int t = threadIdx.x % WG;
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
// Host side
// ---------------------------------------------------------------------------

// Columns per CTA of the tensor-core body for x width M (0: unsupported).
int tc_col_tile(int64_t M) {
  return M % 256 == 0 ? 256 : M % 128 == 0 ? 128 : M % 64 == 0 ? 64 : 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: fetched through the runtime so
// that the library does not link it.
EncodeTiled encoder() {
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

// bf16 [rows, cols] row-major in boxes of box_rows x 64 columns (128 bytes:
// the swizzle's span), 128-byte swizzled.
int encode(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
           uint32_t box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// svals' descriptor, encoded once per (address, shape): a descriptor is a
// function of those alone, so a freed and reused address of the same
// shape gets the same, right, descriptor.
int svals_map(CUtensorMap* map, const void* svals, uint64_t rows,
              uint64_t cols) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, uint64_t, uint64_t>, CUtensorMap> cache;
  const auto key = std::make_tuple(svals, rows, cols);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return 0;
  }
  const int err = encode(map, svals, rows, cols, BS);
  if (err) return err;
  if (cache.size() >= 256) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

template <int BN>
int launch_tc(const void* svals, const int32_t* ucols, const int32_t* nz,
              const void* x, void* out, int64_t s_begin, int64_t s_end, int R,
              int max_u, int64_t x_rows, int64_t M, cudaStream_t stream) {
  CUtensorMap a_map, x_map;
  // the rows the range reads; svals' address is the full layout's
  int err = svals_map(&a_map, svals, (uint64_t)s_end * R * BS,
                      (uint64_t)max_u * BS);
  if (err) return err;
  // x has a new address every call
  err = encode(&x_map, x, (uint64_t)x_rows, (uint64_t)M, BK);
  if (err) return err;
  constexpr int smem = tc_smem_bytes<BN>();
  const cudaError_t e = cudaFuncSetAttribute(
      bcsr_super_spmm_tc<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(M / BN), (unsigned)((s_end - s_begin) * R));
  bcsr_super_spmm_tc<BN><<<grid, TC_THREADS, smem, stream>>>(
      a_map, x_map, ucols, nz, static_cast<__nv_bfloat16*>(out), s_begin, R,
      max_u, M);
  return (int)cudaGetLastError();
}

template <typename TA, typename TX, typename TO, bool X_BF16>
int launch_fma(const void* svals, const int32_t* ucols, const int32_t* nz,
               const void* x, void* out, int64_t s_begin, int64_t s_end, int R,
               int max_u, int64_t M, cudaStream_t stream) {
  const dim3 grid((unsigned)(M / F_BN), (unsigned)((s_end - s_begin) * R));
  bcsr_super_spmm_fma<TA, TX, TO, X_BF16><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const TA*>(svals), ucols, nz, static_cast<const TX*>(x),
      static_cast<TO*>(out), s_begin, R, max_u, M);
  return (int)cudaGetLastError();
}

// One launch over the super-rows [s_begin, s_end).
int launch_range(const void* svals, int a_bf16, const int32_t* ucols,
                 const void* x, int x_bf16, const int32_t* nz, void* out,
                 int64_t s_begin, int64_t s_end, int R, int max_u,
                 int64_t x_rows, int64_t M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && a_bf16) {
    const int bn = tc_col_tile(M);
#define LAUNCH_TC(BN_)                                                     \
  return launch_tc<BN_>(svals, ucols, nz, x, out, s_begin, s_end, R, max_u, \
                        x_rows, M, st)
    if (bn == 256) LAUNCH_TC(256);
    if (bn == 128) LAUNCH_TC(128);
    if (bn == 64) LAUNCH_TC(64);
#undef LAUNCH_TC
    return (int)cudaErrorInvalidValue;
  }
  if (x_bf16)
    return launch_fma<float, __nv_bfloat16, __nv_bfloat16, true>(
        svals, ucols, nz, x, out, s_begin, s_end, R, max_u, M, st);
  if (a_bf16)
    return launch_fma<__nv_bfloat16, float, float, false>(
        svals, ucols, nz, x, out, s_begin, s_end, R, max_u, M, st);
  return launch_fma<float, float, float, false>(
      svals, ucols, nz, x, out, s_begin, s_end, R, max_u, M, st);
}

}  // namespace

extern "C" {

// Columns per CTA for x width M in the regime of the operand types (0: the
// kernel does not take M); the wrapper checks M against it.
int bcsr_super_spmm_col_tile(int64_t M, int a_bf16, int x_bf16) {
  if (a_bf16 && x_bf16) return tc_col_tile(M);
  return M % F_BN == 0 ? F_BN : 0;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// or a code above CUDA's for a failed TMA-descriptor encode (see
// bcsr_super_spmm_error_string). a_bf16 / x_bf16 select the operand types;
// the output is bf16 iff x_bf16. nz [n_s, R, 1 + max_u] or NULL (walk every
// slot). The product over every super-row: out [n_s*R*128, M].
int bcsr_super_spmm(const void* svals, int a_bf16, const int32_t* ucols,
                    const void* x, int x_bf16, const int32_t* nz, void* out,
                    int64_t n_s, int R, int max_u, int64_t M, void* stream) {
  return launch_range(svals, a_bf16, ucols, x, x_bf16, nz, out, 0, n_s, R,
                      max_u, n_s * R * BS, M, stream);
}

// The super-rows [s_begin, s_end) of the same layout against the full x
// [x_rows, M]: out [(s_end - s_begin)*R*128, M]. The wrapper checks the
// range.
int bcsr_super_spmm_rows(const void* svals, int a_bf16, const int32_t* ucols,
                         const void* x, int x_bf16, const int32_t* nz,
                         void* out, int64_t s_begin, int64_t s_end, int R,
                         int max_u, int64_t x_rows, int64_t M,
                         void* stream) {
  return launch_range(svals, a_bf16, ucols, x, x_bf16, nz, out, s_begin,
                      s_end, R, max_u, x_rows, M, stream);
}

const char* bcsr_super_spmm_error_string(int code) {
  if (code >= ENCODE_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled failed (CUresult %d)", code - ENCODE_ERROR);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
