// Plain-BCSR block-sparse SpMM for Hopper (sm_90a): Y = A @ X.
//
// Replaces two TPU kernels of deepsphere_weather_tpu/ops/pallas_spmm.py
// that compute the same function over the same layout:
//   - `_spmm_kernel_dma` (K3), the compiled kernel (fp32 accumulation;
//     fp32 A against bf16 X is rounded to bf16 first): `round_a` = 1; under
//     row sharding the JAX package runs it on a row slice of A against the
//     full X, which is `bcsr_spmm_rows`;
//   - `_spmm_kernel`, the interpreter kernel (both operands widened to
//     fp32, so fp32 A stays fp32 against bf16 X): `round_a` = 0.
// The two differ only for fp32 A against bf16 X.
//
//   out[(r - rb_begin)*128 + i, m] =
//       sum_b sum_j vals[r, b, i, j] * x[cols[r, b]*128 + j, m]
//
// for r in [rb_begin, rb_end); the full product is the range [0, n_rb),
// and both entries launch the one kernel body, so a row of a range launch
// equals the same row of a full launch bit for bit.
//
// vals [n_rb, max_nb, 128, 128] holds, per 128-row block r, its nonzero
// 128x128 blocks; cols [n_rb, max_nb] names each slot's block-column
// (padding slots repeat column 0 with zero values). x is the full
// [n_rb*128, M] whatever the range, M a multiple of 64.
//
// Numerics: fp32 accumulation in registers with plain fp32 FMAs (no TF32:
// the fp32 path matches the TPU's Precision.HIGHEST). bf16 operands are
// widened to fp32, where a product of two bf16 values is exact. The output
// is bf16 for bf16 x and fp32 otherwise.
//
// Design (first, simple version, the same tiling as bcsr_super_spmm.cu):
// one CTA per (128-row block, 64-column tile) walks the row block's max_nb
// slots; for each it stages 16-deep slices of the A block and of the x rows
// steered by cols in shared memory and accumulates an 8x4 register tile per
// thread. The TPU kernel's DMA ring (outstanding x-block copies from HBM)
// has no counterpart here: x blocks come through L2, where neighbouring
// row blocks share most of their columns. What bounds it on the H100: at
// the training step's widths the FMA throughput (67 TFLOP/s fp32 peak, no
// tensor cores), not HBM bytes. Padding slots (4% of the slots at
// HEALPix-16, 11% at HEALPix-64) are multiplied as the TPU kernel does.
// Tensor cores (wgmma) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;   // block size of the BCSR layout
constexpr int BM = 128;   // output rows per CTA (one row block)
constexpr int BN = 64;    // output columns per CTA
constexpr int BK = 16;    // depth of one shared-memory stage
constexpr int TM = 8;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int APAD = 4;   // keeps the transposed A stores 2-way at worst

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A operand as the product sees it: ROUND_A rounds fp32 A to bf16 (the
// compiled TPU kernel's regime against bf16 x).
template <typename TA, bool ROUND_A>
__device__ __forceinline__ float a_operand(TA v) {
  float f = to_f32(v);
  if (ROUND_A) f = __bfloat162float(__float2bfloat16(f));
  return f;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename TA, typename TX, bool ROUND_A>
__global__ void __launch_bounds__(THREADS)
bcsr_spmm_kernel(const TA* __restrict__ vals,
                 const int32_t* __restrict__ cols,
                 const TX* __restrict__ x,
                 TX* __restrict__ out,
                 int64_t rb_begin, int max_nb, int64_t M) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);          // 0..15: column group
  const int ty = tid / (BN / TN);          // 0..15: row group
  const int64_t o = blockIdx.y;            // output row block
  const int64_t r = rb_begin + o;          // row block of A
  const int64_t col0 = (int64_t)blockIdx.x * BN;

  // loader coordinates
  const int a_k = tid % BK;                // A: 16 consecutive k per row
  const int a_i = tid / BK;                // rows a_i + 16*p
  const int b_c = tid % BN;                // x: 64 consecutive columns
  const int b_k = tid / BN;                // k rows b_k + 4*p

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int b = 0; b < max_nb; ++b) {
    const int64_t c = cols[r * max_nb + b];
    const TA* a_blk = vals + (r * max_nb + b) * BS * BS;   // row stride BS
    const TX* x_blk = x + c * BS * M + col0;
    for (int kk = 0; kk < BS; kk += BK) {
#pragma unroll
      for (int p = 0; p < BM / (THREADS / BK); ++p) {
        const int i = a_i + p * (THREADS / BK);
        As[a_k][i] = a_operand<TA, ROUND_A>(a_blk[i * BS + kk + a_k]);
      }
#pragma unroll
      for (int p = 0; p < BK / (THREADS / BN); ++p) {
        const int k = b_k + p * (THREADS / BN);
        Bs[k][b_c] = to_f32(x_blk[(int64_t)(kk + k) * M + b_c]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
        const float4 bv4 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
        const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  TX* y = out + (o * BM + ty * TM) * M + col0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) store_out(y + (int64_t)i * M + j, acc[i][j]);
}

// One launch over the row blocks [rb_begin, rb_end): a CTA per output row
// block and 64-column tile.
template <typename TA, typename TX, bool ROUND_A>
int launch(const void* vals, const int32_t* cols, const void* x, void* out,
           int64_t rb_begin, int64_t rb_end, int max_nb, int64_t M,
           cudaStream_t stream) {
  dim3 grid((unsigned)(M / BN), (unsigned)(rb_end - rb_begin));
  bcsr_spmm_kernel<TA, TX, ROUND_A><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(vals), cols, static_cast<const TX*>(x),
      static_cast<TX*>(out), rb_begin, max_nb, M);
  return (int)cudaGetLastError();
}

int launch_range(const void* vals, int a_bf16, const int32_t* cols,
                 const void* x, int x_bf16, int round_a, void* out,
                 int64_t rb_begin, int64_t rb_end, int max_nb, int64_t M,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (a_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16, false>(
          vals, cols, x, out, rb_begin, rb_end, max_nb, M, st);
    if (round_a)
      return launch<float, __nv_bfloat16, true>(vals, cols, x, out, rb_begin,
                                                rb_end, max_nb, M, st);
    return launch<float, __nv_bfloat16, false>(vals, cols, x, out, rb_begin,
                                               rb_end, max_nb, M, st);
  }
  if (a_bf16)
    return launch<__nv_bfloat16, float, false>(vals, cols, x, out, rb_begin,
                                               rb_end, max_nb, M, st);
  return launch<float, float, false>(vals, cols, x, out, rb_begin, rb_end,
                                     max_nb, M, st);
}

}  // namespace

extern "C" {

// Columns per CTA for x width M, the same in every regime (0: the kernel
// does not take M); the wrapper checks M against it.
int bcsr_spmm_col_tile(int64_t M, int a_bf16, int x_bf16) {
  (void)a_bf16;
  (void)x_bf16;
  return M % BN == 0 ? BN : 0;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// a_bf16 / x_bf16 select the operand types; the output is bf16 iff x_bf16.
// round_a selects the regime of fp32 A against bf16 x (see above).
// The product over every row block: out [n_rb*128, M].
int bcsr_spmm(const void* vals, int a_bf16, const int32_t* cols,
              const void* x, int x_bf16, int round_a, void* out,
              int64_t n_rb, int max_nb, int64_t M, void* stream) {
  return launch_range(vals, a_bf16, cols, x, x_bf16, round_a, out, 0, n_rb,
                      max_nb, M, stream);
}

// The row blocks [rb_begin, rb_end) of the same layout against the full x:
// out [(rb_end - rb_begin)*128, M]. The wrapper checks the range.
int bcsr_spmm_rows(const void* vals, int a_bf16, const int32_t* cols,
                   const void* x, int x_bf16, int round_a, void* out,
                   int64_t rb_begin, int64_t rb_end, int max_nb, int64_t M,
                   void* stream) {
  return launch_range(vals, a_bf16, cols, x, x_bf16, round_a, out, rb_begin,
                      rb_end, max_nb, M, stream);
}

const char* bcsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
