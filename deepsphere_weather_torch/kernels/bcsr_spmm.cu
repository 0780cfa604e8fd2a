// Plain-BCSR block-sparse SpMM for Hopper (sm_90a): Y = A @ X.
//
// Replaces two TPU kernels of deepsphere_weather_tpu/ops/pallas_spmm.py
// that compute the same function over the same layout:
//   - `_spmm_kernel_dma` (K3), the compiled kernel (fp32 accumulation;
//     fp32 A against bf16 X is rounded to bf16 first): `round_a` = 1; under
//     row sharding the JAX package runs it on a row slice of A against the
//     full X, which is `bcsr_spmm_rows`;
//   - `_spmm_kernel` (K4), the interpreter kernel (both operands widened to
//     fp32, so fp32 A stays fp32 against bf16 X): `round_a` = 0.
// The two differ only for fp32 A against bf16 X.
//
//   out[(r - rb_begin)*128 + i, m] =
//       sum_{b listed for row block r} sum_j vals[r, b, i, j] * x[cols[r, b]*128 + j, m]
//
// for r in [rb_begin, rb_end); the full product is the range [0, n_rb).
// vals [n_rb, max_nb, 128, 128] holds, per 128-row block r, its nonzero
// 128x128 blocks; cols [n_rb, max_nb] names each slot's block-column
// (padding slots repeat column 0 with zero values). nz [n_rb, 1 + max_nb]
// lists, per row block, the count c of slots whose block is nonzero and
// then those slots in increasing order (4% of the slots are zero at
// HEALPix-16, 11% at HEALPix-64); without nz every slot is walked. x is
// the full [x_rows, M] whatever the range.
//
// The kernel bodies, their numerics and why a range launch equals the full
// launch's rows and a listed walk every slot's, bit for bit, are in
// spmm_tc.cuh, shared with the super-row layout's kernel
// (bcsr_super_spmm.cu). This file gives them the plain layout: row block r
// reads slot b's A tile at ((r*max_nb + b)*128, 0) of vals viewed 2-D
// [n_rb*max_nb*128, 128] and the x rows of block-column cols[r, b]. The TPU
// kernel's DMA ring of x blocks has its counterpart in the TMA ring.
//
// Regimes:
//   - bf16 A, bf16 x (the plain-layout train step): the tensor-core body,
//     A from shared memory;
//   - fp32 A, bf16 x: the tensor-core body with fp32 A boxes split in
//     registers, into hi = bf16(a) alone (round_a = 1, K3's rounding) or
//     hi + lo (round_a = 0, K4: within 2^-16 |a| of fp32 A per term), at
//     most 128 columns a CTA (F32A_BN);
//   - fp32 x (either A): the gather body, over the nonzero entries of the
//     listed blocks alone (spmm_tc.cuh); its first design multiplied whole
//     blocks on fp32 FMAs, 2.92 ms at x[49152, 1024] against 0.61 for
//     torch.sparse.mm (PERF.md).
// The earlier design ran every regime on fp32 FMAs (67 TFLOP/s fp32 peak
// against 989 bf16 on the tensor cores), loaded synchronously, fixed the
// column tile at 64 and multiplied the padding slots: 24-35x above its
// bound and about 3x behind cuSPARSE (PERF.md).

#include "spmm_tc.cuh"

namespace {

// Row block r of vals viewed 2-D [n_rb*max_nb*128, 128]: slot b's block at
// ((r*max_nb + b)*128, 0), its block-column cols[r, b].
struct PlainRows {
  const int32_t* cols;    // cols[r, :]
  int row;                // r * max_nb * 128
  static constexpr int64_t stride = BS;
  __device__ PlainRows(const int32_t* cols_all, int64_t r, int max_nb)
      : cols(cols_all + r * max_nb), row((int)(r * max_nb * BS)) {}
  __device__ int col(int b) const { return cols[b]; }
  __device__ int a_row(int b) const { return row + b * BS; }
  __device__ int a_col(int) const { return 0; }
};

template <typename TA, int V, int UNR>
__global__ void __launch_bounds__(G_THREADS, G_MIN_CTAS)
bcsr_spmm_gather(int RG, const TA* __restrict__ vals,
                 const int32_t* __restrict__ cols,
                 const int32_t* __restrict__ nz,
                 const float* __restrict__ x, float* __restrict__ out,
                 int64_t rb_begin, int max_nb, int64_t M) {
  const int per = BS / RG;                      // CTAs a row block
  const int64_t o = blockIdx.x / per;           // output row block
  const int i0 = (int)(blockIdx.x % per) * RG;  // first row in the block
  const int64_t r = rb_begin + o;               // row block of A
  gather_body<TA, V, UNR>(vals, PlainRows(cols, r, max_nb),
                          Walk(nz, r, max_nb), i0, RG, x,
                          out + (o * BS + i0) * M, M);
}

// The gather kernel's instances, for launch_gather.
template <typename TA, int V, int UNR>
struct PlainGather {
  static constexpr auto fn = &bcsr_spmm_gather<TA, V, UNR>;
};

template <int BN, bool A_F32, bool SPLIT>
__global__ void __launch_bounds__(TC_THREADS, 1)
bcsr_spmm_tc(const __grid_constant__ CUtensorMap a_map,
             const __grid_constant__ CUtensorMap x_map,
             const int32_t* __restrict__ cols,
             const int32_t* __restrict__ nz,
             __nv_bfloat16* __restrict__ out,
             int64_t rb_begin, int max_nb, int64_t M) {
  const int64_t o = blockIdx.y;
  const int64_t r = rb_begin + o;
  tc_body<BN, A_F32, SPLIT>(&a_map, &x_map, PlainRows(cols, r, max_nb),
                            Walk(nz, r, max_nb), out, o, M);
}

// One launch over the row blocks [rb_begin, rb_end).
int launch_range(const void* vals, int a_bf16, const int32_t* cols,
                 const void* x, int x_bf16, int round_a, const int32_t* nz,
                 void* out, int64_t rb_begin, int64_t rb_end, int max_nb,
                 int64_t x_rows, int64_t M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!x_bf16) {
    if (!gather_col_tile(M)) return (int)cudaErrorInvalidValue;
    const int64_t blocks = rb_end - rb_begin;
    const float* xf = static_cast<const float*>(x);
    float* y = static_cast<float*>(out);
    if (a_bf16)
      return launch_gather<__nv_bfloat16, PlainGather>(
          blocks, M, st, static_cast<const __nv_bfloat16*>(vals), cols, nz,
          xf, y, rb_begin, max_nb, M);
    return launch_gather<float, PlainGather>(
        blocks, M, st, static_cast<const float*>(vals), cols, nz, xf, y,
        rb_begin, max_nb, M);
  }
  return with_col_tile(tc_tile(M, a_bf16), [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    // the rows the range reads; vals' address is the full layout's
    const uint64_t a_rows = (uint64_t)rb_end * max_nb * BS;
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(out);
#define LAUNCH_TC(A_F32, SPLIT)                                              \
  return launch_tc<BN, A_F32>(bcsr_spmm_tc<BN, A_F32, SPLIT>, vals, a_rows,  \
                              (uint64_t)BS, x, (uint64_t)x_rows, M,          \
                              rb_end - rb_begin, st, cols, nz, y, rb_begin,  \
                              max_nb, M)
    if (a_bf16) LAUNCH_TC(false, false);
    if constexpr (BN <= F32A_BN) {
      if (round_a) LAUNCH_TC(true, false);
      LAUNCH_TC(true, true);
    }
#undef LAUNCH_TC
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace

extern "C" {

// Columns per CTA for x width M in the regime of the operand types (0: the
// kernel does not take M); the wrapper checks M against it. Every bf16-x
// regime runs the tensor-core body, whatever A's type (at most F32A_BN
// columns with fp32 A); fp32 x the gather body.
int bcsr_spmm_col_tile(int64_t M, int a_bf16, int x_bf16) {
  return x_bf16 ? tc_tile(M, a_bf16) : gather_col_tile(M);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// or a code above CUDA's for a failed TMA-descriptor encode (see
// bcsr_spmm_error_string). a_bf16 / x_bf16 select the operand types; the
// output is bf16 iff x_bf16. round_a selects the regime of fp32 A against
// bf16 x (see above). nz [n_rb, 1 + max_nb] or NULL (walk every slot).
// The product over every row block: out [n_rb*128, M].
int bcsr_spmm(const void* vals, int a_bf16, const int32_t* cols,
              const void* x, int x_bf16, int round_a, const int32_t* nz,
              void* out, int64_t n_rb, int max_nb, int64_t M, void* stream) {
  return launch_range(vals, a_bf16, cols, x, x_bf16, round_a, nz, out, 0,
                      n_rb, max_nb, n_rb * BS, M, stream);
}

// The row blocks [rb_begin, rb_end) of the same layout against the full x
// [x_rows, M]: out [(rb_end - rb_begin)*128, M]. The wrapper checks the
// range.
int bcsr_spmm_rows(const void* vals, int a_bf16, const int32_t* cols,
                   const void* x, int x_bf16, int round_a, const int32_t* nz,
                   void* out, int64_t rb_begin, int64_t rb_end, int max_nb,
                   int64_t x_rows, int64_t M, void* stream) {
  return launch_range(vals, a_bf16, cols, x, x_bf16, round_a, nz, out,
                      rb_begin, rb_end, max_nb, x_rows, M, stream);
}

const char* bcsr_spmm_error_string(int code) { return error_string(code); }

}  // extern "C"
