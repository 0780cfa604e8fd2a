// Super-row block-sparse SpMM for Hopper (sm_90a): Y = A @ X.
//
// Replaces two TPU kernels of deepsphere_weather_tpu/ops/pallas_spmm.py
// that compute the same function over the same layout:
//   - `_spmm_kernel_super_sched` (K1), every super-row: `bcsr_super_spmm`;
//   - `_spmm_kernel_super` (K2), the super-rows [s_begin, s_end) of a
//     row-sharded operator against the full x: `bcsr_super_spmm_rows`.
//
//   out[(s - s_begin)*R*128 + r*128 + i, m] =
//       sum_u sum_j svals[s, r, i, u*128 + j] * x[ucols[s, u]*128 + j, m]
//
// for s in [s_begin, s_end); the full product is the range [0, n_s). Both
// entries launch the one kernel body below, so a row of a range launch is
// summed in the same order as in a full launch and equals it bit for bit.
//
// svals [n_s, R, 128, max_u*128] holds, per super-row s (R consecutive
// 128-row blocks of the Laplacian), the row blocks concatenated over the
// union of block-columns that any of its rows touches; ucols [n_s, max_u]
// names each union slot's block-column (padding slots repeat a real column
// with zero values). x is [n_cb*128, M], M a multiple of 64: the full x,
// whatever the range (ucols holds global block-columns).
//
// Numerics: fp32 accumulation in registers with plain fp32 FMAs (no TF32:
// the fp32 path matches the TPU's Precision.HIGHEST). bf16 operands are
// widened to fp32, where a product of two bf16 values is exact, so the bf16
// path equals a bf16 tensor-core product with fp32 accumulation up to the
// order of the sum. Mixed operand types follow the TPU kernel: fp32 x widens
// bf16 A exactly; bf16 x rounds fp32 A to bf16 first. The output is bf16 for
// bf16 x and fp32 otherwise.
//
// Design (first, simple version): one CTA per (128-row block, 64-column
// tile); for each union slot it stages 16-deep slices of the A block and of
// the gathered x block in shared memory (x rows steered by ucols) and
// accumulates an 8x4 register tile per thread. The TPU kernel's DMA slot
// schedule and ping-pong residency manage VMEM and have no counterpart
// here; x reuse across the R row blocks of a super-row comes from L2.
// What bounds it on the H100: at the slice's widths the FMA issue rate
// (67 TFLOP/s fp32 peak, no tensor cores), not HBM bytes; zero A blocks
// (rows that do not touch a union slot) are multiplied like the TPU kernel
// does. Tensor cores (wgmma) and skipping zero blocks are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;   // block size of the BCSR layout (rows per block)
constexpr int BM = 128;   // output rows per CTA (one row block)
constexpr int BN = 64;    // output columns per CTA
constexpr int BK = 16;    // depth of one shared-memory stage
constexpr int TM = 8;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int APAD = 4;   // keeps the transposed A stores 2-way at worst

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
__global__ void __launch_bounds__(THREADS)
bcsr_super_spmm_kernel(const TA* __restrict__ svals,
                       const int32_t* __restrict__ ucols,
                       const TX* __restrict__ x,
                       TO* __restrict__ out,
                       int64_t s_begin, int R, int max_u, int64_t M) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);          // 0..15: column group
  const int ty = tid / (BN / TN);          // 0..15: row group
  const int64_t o = blockIdx.y;            // output row block
  const int64_t g = s_begin * R + o;       // row block of A = s*R + r
  const int64_t s = g / R;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  const int64_t K = (int64_t)max_u * BS;   // row length of svals

  // row block g's rows start at svals[s, r, 0, 0] = svals + g*128*K
  const TA* a_rows = svals + g * BM * K;

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

  for (int u = 0; u < max_u; ++u) {
    const int64_t c = ucols[s * max_u + u];
    const TA* a_slot = a_rows + (int64_t)u * BS;
    const TX* x_slot = x + c * BS * M + col0;
    for (int kk = 0; kk < BS; kk += BK) {
#pragma unroll
      for (int p = 0; p < BM / (THREADS / BK); ++p) {
        const int i = a_i + p * (THREADS / BK);
        As[a_k][i] = a_operand<TA, X_BF16>(a_slot[(int64_t)i * K + kk + a_k]);
      }
#pragma unroll
      for (int p = 0; p < BK / (THREADS / BN); ++p) {
        const int k = b_k + p * (THREADS / BN);
        Bs[k][b_c] = to_f32(x_slot[(int64_t)(kk + k) * M + b_c]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
        const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  TO* y = out + (o * BM + ty * TM) * M + col0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) store_out(y + (int64_t)i * M + j, acc[i][j]);
}

// One launch over the super-rows [s_begin, s_end): a CTA per output row
// block and 64-column tile.
template <typename TA, typename TX, typename TO, bool X_BF16>
int launch(const void* svals, const int32_t* ucols, const void* x, void* out,
           int64_t s_begin, int64_t s_end, int R, int max_u, int64_t M,
           cudaStream_t stream) {
  dim3 grid((unsigned)(M / BN), (unsigned)((s_end - s_begin) * R));
  bcsr_super_spmm_kernel<TA, TX, TO, X_BF16><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(svals), ucols, static_cast<const TX*>(x),
      static_cast<TO*>(out), s_begin, R, max_u, M);
  return (int)cudaGetLastError();
}

int launch_range(const void* svals, int a_bf16, const int32_t* ucols,
                 const void* x, int x_bf16, void* out, int64_t s_begin,
                 int64_t s_end, int R, int max_u, int64_t M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (a_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, true>(
          svals, ucols, x, out, s_begin, s_end, R, max_u, M, st);
    return launch<float, __nv_bfloat16, __nv_bfloat16, true>(
        svals, ucols, x, out, s_begin, s_end, R, max_u, M, st);
  }
  if (a_bf16)
    return launch<__nv_bfloat16, float, float, false>(
        svals, ucols, x, out, s_begin, s_end, R, max_u, M, st);
  return launch<float, float, float, false>(svals, ucols, x, out, s_begin,
                                            s_end, R, max_u, M, st);
}

}  // namespace

extern "C" {

// Columns per CTA: the wrapper checks M against it.
int bcsr_super_spmm_col_tile() { return BN; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// a_bf16 / x_bf16 select the operand types; the output is bf16 iff x_bf16.
// The product over every super-row: out [n_s*R*128, M].
int bcsr_super_spmm(const void* svals, int a_bf16, const int32_t* ucols,
                    const void* x, int x_bf16, void* out, int64_t n_s, int R,
                    int max_u, int64_t M, void* stream) {
  return launch_range(svals, a_bf16, ucols, x, x_bf16, out, 0, n_s, R, max_u,
                      M, stream);
}

// The super-rows [s_begin, s_end) of the same layout against the full x:
// out [(s_end - s_begin)*R*128, M]. The wrapper checks the range.
int bcsr_super_spmm_rows(const void* svals, int a_bf16, const int32_t* ucols,
                         const void* x, int x_bf16, void* out,
                         int64_t s_begin, int64_t s_end, int R, int max_u,
                         int64_t M, void* stream) {
  return launch_range(svals, a_bf16, ucols, x, x_bf16, out, s_begin, s_end, R,
                      max_u, M, stream);
}

const char* bcsr_super_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
