// ELL SpMM for Hopper (sm_90a), fp32: Y = L @ X over L's nonzeros.
//
// Replaces the fp32 regime of three TPU kernels of
// deepsphere_weather_tpu/ops/pallas_spmm.py, which all compute this
// function for fp32 x against an fp32 operator:
//   - `_spmm_kernel_super_sched` (K1), the whole product: `ell_spmm`;
//   - `_spmm_kernel_super` (K2), the rows [r0, r1) of a row-sharded operator
//     against the full x: `ell_spmm_rows`;
//   - `_spmm_kernel_dma` (K3), the same product on the plain BCSR layout.
// (Their bf16 regimes stay on the tensor-core kernels, bcsr_super_spmm.cu
// and bcsr_spmm.cu.) It also runs the ELL operator of JAX's
// `ops/cheb.py` (`ell_matvec`), whose layout it takes:
//
//   out[r - r0, m] = sum_{j = 0 .. W-1} vals[r, j] * x[cols[r, j], m]
//
// vals [n, W] fp32 and cols [n, W] int32 hold row r's nonzeros in its CSR
// order, padded to the fixed width W with column 0 and value 0
// (`laplacian_to_ell`); x is [x_rows, M] and every column index addresses
// one of its rows (true of the ELL of an [n, n] matrix against x [n, M];
// not checked per launch).
//
// Numerics: plain fp32, no TF32 (the TPU's Precision.HIGHEST). Each term is
// one rounded product added to the row's sum in j order (__fmul_rn then
// __fadd_rn, never contracted to an FMA), with no split and no atomics: a
// row's result depends only on its own row, so a row-range launch equals
// the full launch's rows bit for bit, and the plain PyTorch version, which
// adds the same rounded products in the same order, equals the kernel bit
// for bit.
//
// What bounds it: bytes. A knn-20 Laplacian has about 21 nonzeros a row, so
// the product does 2 operations per 4-byte x element it reads through a
// nonzero; the least traffic reads x once, writes y once and reads the
// layout once (HEALPix-64, M = 1024: 412 MB, 0.123 ms at 3.35 TB/s, against
// 2.13 GFLOP, 0.032 ms at 67 TFLOP/s). The BCSR kernels' fp32 body
// multiplied every entry of every nonzero 128x128 block, about 2% filled,
// and was bound by the FMA issue rate (PERF.md).
//
// Design: each row is read from x about 21 times, by its neighbours, so
// the design is about where those reads hit. A CTA of WARPS warps owns
// ROWS consecutive rows and one column tile of LPR*4 columns: LPR lanes
// share a row, each loading a float4 of every neighbour's x row, so a warp
// takes 32/LPR rows at once. Nested HEALPix ordering keeps a row's
// neighbours at nearby indices, so the rows in flight read overlapping
// neighbourhoods and many reads hit L1; a tile's x slab (x_rows * LPR * 16
// bytes, 12.6 MB at HEALPix-64) is small against the 50 MB L2, and the grid
// runs every row block of one column tile before the next tile
// (blockIdx.x is the row block), so x crosses HBM about once. A row
// group's (col, val) pairs are read once, one pair a lane, and broadcast
// with warp shuffles. Small CTAs of few rows ran fastest on an H100 (more
// of them in flight per SM); the L2 traffic of the repeated x reads is
// what remains between this and the bound (PERF.md). The TPU kernels'
// 128x128 tiles, VMEM budget and slot schedule have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LPR = 16;            // lanes per row
constexpr int WARPS = 4;           // warps per CTA
constexpr int ROWS = 16;           // consecutive rows per CTA
constexpr int G = 32 / LPR;        // rows a warp takes at once
constexpr int TILE = LPR * 4;      // columns of a CTA
constexpr unsigned FULL = 0xffffffffu;
static_assert(32 % LPR == 0 && ROWS % (WARPS * G) == 0, "ELL tile shape");

__device__ __forceinline__ void add_term(float4& acc, float v, float4 xv) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v, xv.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v, xv.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v, xv.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v, xv.w));
}

__global__ void __launch_bounds__(WARPS * 32)
ell_spmm_kernel(const float* __restrict__ vals,
                const int32_t* __restrict__ cols,
                const float* __restrict__ x, float* __restrict__ out,
                int64_t r0, int64_t r1, int W, int64_t M) {
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR;
  const int64_t c = (int64_t)blockIdx.y * TILE + sub * 4;
  const bool on = c < M;   // M % 4 == 0: a lane's 4 columns are all in or out
  const int64_t base = r0 + (int64_t)blockIdx.x * ROWS;
  const int64_t end = base + ROWS < r1 ? base + ROWS : r1;
  // rw, the warp's first row, and every trip count are warp-uniform: the
  // shuffles always run on the whole warp
  for (int64_t rw = base + (threadIdx.x >> 5) * G; rw < end;
       rw += WARPS * G) {
    const int64_t r = rw + lane / LPR;
    const bool valid = r < end;
    const float* vr = vals + r * W;
    const int32_t* cr = cols + r * W;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < W; j0 += LPR) {
      const int cnt = W - j0 < LPR ? W - j0 : LPR;
      int my_c = 0;
      float my_v = 0.f;
      if (valid && sub < cnt) {
        my_c = __ldg(cr + j0 + sub);
        my_v = __ldg(vr + j0 + sub);
      }
#pragma unroll
      for (int j = 0; j < LPR; ++j) {
        if (j < cnt) {
          const int col = __shfl_sync(FULL, my_c, j, LPR);
          const float v = __shfl_sync(FULL, my_v, j, LPR);
          if (valid && on)
            add_term(acc, v, __ldg(reinterpret_cast<const float4*>(
                                 x + (int64_t)col * M + c)));
        }
      }
    }
    if (valid && on)
      *reinterpret_cast<float4*>(out + (r - r0) * M + c) = acc;
  }
}

int launch(const float* vals, const int32_t* cols, const float* x,
           float* out, int64_t r0, int64_t r1, int W, int64_t M,
           void* stream) {
  const dim3 grid((unsigned)((r1 - r0 + ROWS - 1) / ROWS),
                  (unsigned)((M + TILE - 1) / TILE));
  ell_spmm_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, cols, x, out, r0, r1, W, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The wrapper checks the shapes and M % 4 == 0 and passes 16-byte aligned
// x and out.
// The whole product: out [n, M] for the n rows of vals/cols.
int ell_spmm(const float* vals, const int32_t* cols, const float* x,
             float* out, int64_t n, int W, int64_t M, void* stream) {
  return launch(vals, cols, x, out, 0, n, W, M, stream);
}

// The rows [r0, r1) of the same product against the full x:
// out [r1 - r0, M], row i the full product's row r0 + i.
int ell_spmm_rows(const float* vals, const int32_t* cols, const float* x,
                  float* out, int64_t r0, int64_t r1, int W, int64_t M,
                  void* stream) {
  return launch(vals, cols, x, out, r0, r1, W, M, stream);
}

const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
