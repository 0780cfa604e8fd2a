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
// those slots in increasing order; without nz every slot is walked. x is
// [x_rows, M], the full x whatever the range (ucols holds global
// block-columns).
//
// The kernel bodies, their numerics and why a range launch equals the full
// launch's rows and a listed walk every slot's, bit for bit, are in
// spmm_tc.cuh, shared with the plain layout's kernel (bcsr_spmm.cu). This
// file gives them the super-row layout: row block g = s*R + r reads slot
// u's A tile at (g*128, u*128) of svals viewed 2-D [n_s*R*128, max_u*128]
// and the x rows of block-column ucols[s, u]: the counterpart of the TPU
// kernel's scalar-steered DMA.
//
// bf16 regime (bf16 A, bf16 x; the regime of the main paths): the
// tensor-core body. The earlier design widened bf16 to fp32 FMAs (67
// TFLOP/s peak), multiplied the zero blocks and loaded synchronously: it
// was bound by the FMA issue rate. x is reused across a super-row's R row
// blocks through L2: a CTA over a super-row's two row blocks sharing each
// x tile measured slower at 24 and at 384 row blocks (PERF.md). The TPU's
// stay/copy/new slot schedule and VMEM budget have no counterpart here.
// What bounds it now (PERF.md): at HEALPix-16 (24 row blocks) the grid, 24
// to 192 CTAs for 132 SMs, and short loops (about 8 listed slots a row
// block) whose fill and epilogue do not overlap; at HEALPix-64 (384) the
// traffic from L2, where every row block reads its x tiles and every column
// tile its A tiles again (~1.3 GB per width-1024 launch, ~5.5 TB/s).
//
// fp32 x (fp32 or bf16-stored A): the gather body, which multiplies the
// nonzero entries of the listed blocks alone (`gather_body`: the blocks
// compacted to per-row (column, value) lists in shared memory, x gathered).
// Its first design multiplied every entry of every listed block on fp32
// FMAs: 2.97 ms at x[49152, 1024], against 0.61 for torch.sparse.mm
// (PERF.md).
// fp32 A against bf16 x: the tensor-core body with fp32 A rounded to bf16
// in registers (as the TPU kernel casts A to bf16 against bf16 x; the plain
// layout's round_a = 1), at most F32A_BN columns a CTA; the output is bf16.

#include "spmm_tc.cuh"

namespace {

// Row block g of svals viewed 2-D [n_s*R*128, max_u*128]: slot u's block
// at (g*128, u*128), its block-column ucols[g / R, u].
struct SuperRows {
  const int32_t* ucols;   // ucols[g / R, :]
  int row;                // g * 128
  int64_t stride;         // max_u * 128
  __device__ SuperRows(const int32_t* ucols_all, int64_t g, int R, int max_u)
      : ucols(ucols_all + (g / R) * max_u), row((int)(g * BS)),
        stride((int64_t)max_u * BS) {}
  __device__ int col(int u) const { return ucols[u]; }
  __device__ int a_row(int) const { return row; }
  __device__ int a_col(int u) const { return u * BS; }
};

template <typename TA, int V, int UNR>
__global__ void __launch_bounds__(G_THREADS, G_MIN_CTAS)
bcsr_super_spmm_gather(int RG, const TA* __restrict__ svals,
                       const int32_t* __restrict__ ucols,
                       const int32_t* __restrict__ nz,
                       const float* __restrict__ x, float* __restrict__ out,
                       int64_t s_begin, int R, int max_u, int64_t M) {
  const int per = BS / RG;                      // CTAs a row block
  const int64_t o = blockIdx.x / per;           // output row block
  const int i0 = (int)(blockIdx.x % per) * RG;  // first row in the block
  const int64_t g = s_begin * R + o;            // row block of A = s*R + r
  gather_body<TA, V, UNR>(svals, SuperRows(ucols, g, R, max_u),
                          Walk(nz, g, max_u), i0, RG, x,
                          out + (o * BS + i0) * M, M);
}

// The gather kernel's instances, for launch_gather.
template <typename TA, int V, int UNR>
struct SuperGather {
  static constexpr auto fn = &bcsr_super_spmm_gather<TA, V, UNR>;
};

template <int BN, bool A_F32>
__global__ void __launch_bounds__(TC_THREADS, 1)
bcsr_super_spmm_tc(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap x_map,
                   const int32_t* __restrict__ ucols,
                   const int32_t* __restrict__ nz,
                   __nv_bfloat16* __restrict__ out,
                   int64_t s_begin, int R, int max_u, int64_t M) {
  const int64_t o = blockIdx.y;
  const int64_t g = s_begin * R + o;
  tc_body<BN, A_F32, false>(&a_map, &x_map, SuperRows(ucols, g, R, max_u),
                            Walk(nz, g, max_u), out, o, M);
}

// One launch over the super-rows [s_begin, s_end).
int launch_range(const void* svals, int a_bf16, const int32_t* ucols,
                 const void* x, int x_bf16, const int32_t* nz, void* out,
                 int64_t s_begin, int64_t s_end, int R, int max_u,
                 int64_t x_rows, int64_t M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (s_end - s_begin) * R;
  if (!x_bf16) {
    if (!gather_col_tile(M)) return (int)cudaErrorInvalidValue;
    const float* xf = static_cast<const float*>(x);
    float* y = static_cast<float*>(out);
    if (a_bf16)
      return launch_gather<__nv_bfloat16, SuperGather>(
          blocks, M, st, static_cast<const __nv_bfloat16*>(svals), ucols,
          nz, xf, y, s_begin, R, max_u, M);
    return launch_gather<float, SuperGather>(
        blocks, M, st, static_cast<const float*>(svals), ucols, nz, xf, y,
        s_begin, R, max_u, M);
  }
  return with_col_tile(tc_tile(M, a_bf16), [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    // the rows the range reads; svals' address is the full layout's
    const uint64_t a_rows = (uint64_t)s_end * R * BS;
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(out);
#define LAUNCH_TC(A_F32)                                                    \
  return launch_tc<BN, A_F32>(bcsr_super_spmm_tc<BN, A_F32>, svals, a_rows, \
                              (uint64_t)max_u * BS, x, (uint64_t)x_rows, M,  \
                              blocks, st, ucols, nz, y, s_begin, R, max_u, M)
    if (a_bf16) LAUNCH_TC(false);
    if constexpr (BN <= F32A_BN) LAUNCH_TC(true);
#undef LAUNCH_TC
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace

extern "C" {

// Columns per CTA for x width M in the regime of the operand types (0: the
// kernel does not take M); the wrapper checks M against it. bf16 x runs
// the tensor-core body (at most F32A_BN columns with fp32 A), fp32 x the
// gather body.
int bcsr_super_spmm_col_tile(int64_t M, int a_bf16, int x_bf16) {
  return x_bf16 ? tc_tile(M, a_bf16) : gather_col_tile(M);
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

const char* bcsr_super_spmm_error_string(int code) { return error_string(code); }

}  // extern "C"
