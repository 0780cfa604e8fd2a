// ELL SpMM for Hopper (sm_90a), fp32: Y = L @ X over L's nonzeros.
//
// Replaces the fp32 regime of three TPU kernels of
// deepsphere_weather_tpu/ops/pallas_spmm.py, which all compute this
// function for fp32 x against an fp32 operator:
//   - `_spmm_kernel_super_sched` (K1, :493), the whole product: `ell_spmm`;
//   - `_spmm_kernel_super` (K2, :402), the rows [r0, r1) of a row-sharded
//     operator against the full x: `ell_spmm_rows`;
//   - `_spmm_kernel_dma` (K3, :340), the same product on the plain BCSR
//     layout.
// (Their bf16 regimes stay on the tensor-core kernels, bcsr_super_spmm.cu
// and bcsr_spmm.cu.) It also runs the ELL operator of JAX's
// `ops/cheb.py` (`ell_matvec`), whose layout it takes:
//
//   out[r - r0, m] = sum_{j = 0 .. W-1} vals[r, j] * x[cols[r, j], m]
//
// vals [n, W] fp32 and cols [n, W] int32 hold row r's nonzeros in its CSR
// order, padded to the fixed width W with column 0 and value 0
// (`laplacian_to_ell`); x is [x_rows, M], M % 4 == 0.
//
// The kernel reads the layout through its union tables (`ell_tables` in
// ops/bcsr.py, built once on the host): the rows are cut into blocks of
// consecutive rows (32, fewer where a block's union would name more than
// 112 x rows); for block b, urows[uoff[b] .. uoff[b+1]) is the sorted union
// of the columns its rows name (padding slots name column 0, so row 0 is in
// the union of every block with a padded slot) and loc[r, j] (int16) is
// slot (r, j)'s index into its block's union:
// cols[r, j] == urows[uoff[b] + loc[r, j]].
//
// Numerics: plain fp32, no TF32 (the TPU's Precision.HIGHEST). Each term is
// one rounded product added to the row's sum in j order (__fmul_rn then
// __fadd_rn, never contracted to an FMA), with no split and no atomics: a
// row's result depends only on its own row, so a row-range launch equals
// the full launch's rows bit for bit, and the plain PyTorch version, which
// adds the same rounded products in the same order, equals the kernel bit
// for bit. Padding slots add 0 * x[0] as the plain version does.
//
// What bounds it: the least HBM traffic reads x once, writes y once and
// reads the layout once (HEALPix-64 knn-20, M = 1024: 412 MB, 0.123 ms at
// 3.35 TB/s). But about 21 nonzeros a row make each x element that an SM
// reads feed one product, and an SM reads 128 bytes a clock from shared
// memory: at width 1024 that alone is 0.14 ms on an H100 at its 1.98 GHz
// boost clock, above the HBM bound. The design moves x from L2 into shared memory once per block
// and spends the SMs' shared-memory reads on the products (PERF.md).
//
// Design: one CTA owns one row block and a run of column tiles of T
// columns (T = 16, 32 or 64 by M, so that every lane computes). Three
// producer warps walk the tiles through a ring of two shared-memory stages
// (full and empty mbarriers): for each tile, once its stage is free, one
// 1-D bulk async copy (cp.async.bulk, TMA's 1-D form) per union row of the
// row's T x 4 contiguous bytes, all completing on the stage's full
// barrier, so the next tile's copies are in flight while this one
// computes. One warp could not issue the copies fast enough: the block's
// union is 3.4 rows a row at 32 rows, a copy per union row and tile. Eight
// consumer warps first load their rows' (offset into a stage, value) pairs
// into shared memory once per CTA, not once per tile; then, per tile, a
// row's lanes each take V float4s of the row (T / V columns apart): 8 lanes
// read 128 contiguous bytes of one union row (a conflict-free wavefront)
// and each pair read feeds V float4s. x thus crosses L2 about 3.4 times
// (the union's repeats across blocks), where the previous design read it
// through L1/L2 once per nonzero (about 21 times), and the layout once per
// CTA, where it read it once per 64-column tile. Blocks of 32 rows leave
// three CTAs an SM; blocks of 64-128 rows, with fewer repeats, held fewer
// and ran slower (PERF.md). The TPU kernels' 128x128 tiles, VMEM budget and
// slot schedule have no counterpart here.

#include "spmm_tc.cuh"   // bulk_load, mbar_init, mbar_expect_tx, mbar_wait

namespace {

constexpr int CONSUMER_WARPS = 8;   // warps that compute
constexpr int PRODUCER_WARPS = 3;   // warps that issue the copies
constexpr int THREADS = (CONSUMER_WARPS + PRODUCER_WARPS) * 32;
constexpr int STAGES = 2;           // stages of the ring
constexpr int WIDE_TILE = 64;       // the widest column tile
constexpr int SMEM_BUDGET = 232448; // dynamic shared memory of a CTA

// Where a CTA's shared memory goes: the stages' full and empty mbarriers,
// the union's x rows, the (offset, value) table of its rows (two slots in
// 16 bytes), the stages (T floats per union row each).
struct Smem {
  int64_t urows, table, stages, bytes;
  int64_t stage_floats;
  __host__ __device__ Smem(int umax, int rmax, int W, int T) {
    urows = 16 * STAGES;
    table = (urows + 4 * (int64_t)umax + 15) / 16 * 16;
    stages = (table + 16 * (int64_t)rmax * ((W + 1) / 2) + 127) / 128 * 128;
    stage_floats = (int64_t)umax * T;
    bytes = stages + 4 * stage_floats * STAGES;
  }
};

struct EllArgs {
  const float* vals;     // [n, W]
  const int16_t* loc;    // [n, W]
  const int32_t* blocks; // [2, nb + 1]: first rows, then union offsets
  const int32_t* urows;  // the unions, block after block
  const float* x;        // [x_rows, M]
  float* out;            // [r1 - r0, M]
  int64_t r0, r1, M;
  int nb, W, umax, rmax, tiles_per_cta;
};

__device__ __forceinline__ void add_term(float4& acc, float v, float4 xv) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v, xv.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v, xv.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v, xv.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v, xv.w));
}

// How a column tile of T columns is shared: a row's LPR lanes each take V
// float4s, T / V columns apart, so that 8 lanes read 128 contiguous bytes
// of a union row (one conflict-free shared-memory wavefront; 16-column
// tiles: 64) and each (offset, value) pair read feeds V float4s.
template <int T>
struct Lanes {
  static constexpr int V = T >= 64 ? T / 32 : 1;
  static constexpr int LPR = T / (4 * V);
};

template <int T>
__global__ void __launch_bounds__(THREADS) ell_spmm_kernel(const EllArgs a) {
  constexpr int V = Lanes<T>::V, LPR = Lanes<T>::LPR;
  constexpr int PASS = CONSUMER_WARPS * 32 / LPR;   // rows side by side
  extern __shared__ __align__(128) uint8_t smem[];
  const int b = blockIdx.x;
  const int64_t first = a.blocks[b], last = a.blocks[b + 1];
  const int64_t lo = first > a.r0 ? first : a.r0;
  const int64_t hi = last < a.r1 ? last : a.r1;
  const int tiles = (int)((a.M + T - 1) / T);
  const int t_begin = blockIdx.y * a.tiles_per_cta;
  const int t_end = min(tiles, t_begin + a.tiles_per_cta);
  if (lo >= hi || t_begin >= t_end) return;   // CTA-uniform
  const int u0 = a.blocks[a.nb + 1 + b];
  const int u = a.blocks[a.nb + 2 + b] - u0;
  const int wh = (a.W + 1) / 2;
  const int rows = (int)(hi - lo);
  const Smem sm(a.umax, a.rmax, a.W, T);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int32_t* urow = reinterpret_cast<int32_t*>(smem + sm.urows);
  int4* table = reinterpret_cast<int4*>(smem + sm.table);
  float* stage = reinterpret_cast<float*>(smem + sm.stages);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCER_WARPS);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < u; i += THREADS) urow[i] = a.urows[u0 + i];
  __syncthreads();

  if (threadIdx.x >= CONSUMER_WARPS * 32) {
    // producer warps: for each tile, once its stage is free, one copy per
    // union row of the row's T x 4 bytes, completing on the stage's full
    // barrier; each warp announces its own copies' bytes before issuing
    // them, so the barrier's count of pending bytes never goes below 0
    constexpr int STRIDE = PRODUCER_WARPS * 32;
    const int i0 = threadIdx.x - CONSUMER_WARPS * 32;
    const unsigned mine = u > i0 ? (unsigned)((u - i0 + STRIDE - 1) / STRIDE)
                                 : 0u;
    const unsigned copies = __reduce_add_sync(0xffffffffu, mine);
    for (int t = t_begin, k = 0; t < t_end; ++t, ++k) {
      const int s = k % STAGES;
      if (k >= STAGES) mbar_wait(&empty[s], (uint32_t)((k / STAGES - 1) & 1));
      const int64_t c0 = (int64_t)t * T;
      const uint32_t bytes =
          (uint32_t)(4 * (a.M - c0 < T ? a.M - c0 : (int64_t)T));
      if (lane == 0) mbar_expect_tx(&full[s], bytes * copies);
      __syncwarp();
      float* dst = stage + s * sm.stage_floats;
      for (int i = i0; i < u; i += STRIDE)
        bulk_load(dst + (int64_t)i * T, a.x + (int64_t)urow[i] * a.M + c0,
                  bytes, &full[s]);
    }
    return;
  }

  // consumers: the rows' (offset into a stage, value) pairs, once per CTA
  for (int i = threadIdx.x; i < rows * a.W; i += CONSUMER_WARPS * 32) {
    const int r = i / a.W, j = i - r * a.W;
    const int64_t g = (lo + r) * a.W + j;
    int* e = reinterpret_cast<int*>(table + r * wh + j / 2) + 2 * (j & 1);
    e[0] = (int)a.loc[g] * T;
    e[1] = __float_as_int(a.vals[g]);
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMER_WARPS * 32) : "memory");

  const int sub = threadIdx.x % LPR;
  for (int t = t_begin, k = 0; t < t_end; ++t, ++k) {
    const int s = k % STAGES;
    mbar_wait(&full[s], (uint32_t)((k / STAGES) & 1));
    const int64_t c = (int64_t)t * T + sub * 4;   // the lane's first column
    if (c < a.M) {
      const float* st = stage + s * sm.stage_floats + sub * 4;
      for (int r = threadIdx.x / LPR; r < rows; r += PASS) {
        const int4* e = table + r * wh;
        float4 acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        int j = 0;
#pragma unroll 2
        for (; j + 1 < a.W; j += 2) {
          const int4 p = e[j / 2];
#pragma unroll
          for (int v = 0; v < V; ++v)
            add_term(acc[v], __int_as_float(p.y),
                     *reinterpret_cast<const float4*>(st + p.x + 4 * LPR * v));
#pragma unroll
          for (int v = 0; v < V; ++v)
            add_term(acc[v], __int_as_float(p.w),
                     *reinterpret_cast<const float4*>(st + p.z + 4 * LPR * v));
        }
        if (j < a.W) {
          const int4 p = e[j / 2];
#pragma unroll
          for (int v = 0; v < V; ++v)
            add_term(acc[v], __int_as_float(p.y),
                     *reinterpret_cast<const float4*>(st + p.x + 4 * LPR * v));
        }
        float* o = a.out + (lo + r - a.r0) * a.M + c;
        // M % 4 == 0: each of the lane's float4s is all in or all out
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (c + 4 * LPR * v < a.M)
            *reinterpret_cast<float4*>(o + 4 * LPR * v) = acc[v];
      }
    }
    __syncwarp();   // the warp is done with stage s
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// How a launch at width M runs: the column tile, the stages, the dynamic
// shared memory and the CTAs an SM holds (asked of the runtime once per
// instance and size).
struct Plan {
  int T = 0, smem = 0, per_sm = 0, sms = 0;
};

template <int T>
int plan_t(const EllArgs& a, Plan* p) {
  p->T = T;
  p->smem = (int)Smem(a.umax, a.rmax, a.W, T).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      ell_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p->smem);
  if (e != cudaSuccess) return (int)e;
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, std::tuple<int, int>> cache;
  int dev;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, T, p->smem);
  auto hit = cache.find(key);
  if (hit == cache.end()) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ell_spmm_kernel<T>, THREADS, p->smem);
    if (e != cudaSuccess) return (int)e;
    hit = cache.emplace(key, std::make_tuple(sms, per_sm)).first;
  }
  std::tie(p->sms, p->per_sm) = hit->second;
  return 0;
}

// The column tile at width M: the narrowest of 16, 32, ... WIDE_TILE that
// holds M (so that every lane computes), halved until the stages fit; 0
// if not even 16 columns fit (a row naming about 1700 distinct columns).
int col_tile(int64_t M, int umax, int rmax, int W) {
  int T = 16;
  while (T < WIDE_TILE && T < M) T *= 2;
  for (; T >= 16; T /= 2) {
    if (Smem(umax, rmax, W, T).bytes <= SMEM_BUDGET) return T;
  }
  return 0;
}

int plan(const EllArgs& a, Plan* p) {
  switch (col_tile(a.M, a.umax, a.rmax, a.W)) {
    case 16: return plan_t<16>(a, p);
    case 32: return plan_t<32>(a, p);
    case 64: return plan_t<64>(a, p);
  }
  return (int)cudaErrorInvalidValue;   // the tables' blocks do not fit
}

template <int T>
void launch_t(EllArgs a, const Plan& p, int64_t n, cudaStream_t stream) {
  // enough column groups to fill the card once with the blocks the row
  // range touches; each CTA walks a run of tiles
  const int64_t tiles = (a.M + T - 1) / T;
  const int64_t active = ((int64_t)a.nb * (a.r1 - a.r0) + n - 1) / n;
  const int64_t slots = (int64_t)p.sms * (p.per_sm > 0 ? p.per_sm : 1);
  int64_t groups = (slots + active - 1) / (active > 0 ? active : 1);
  groups = groups < 1 ? 1 : groups > tiles ? tiles : groups;
  a.tiles_per_cta = (int)((tiles + groups - 1) / groups);
  groups = (tiles + a.tiles_per_cta - 1) / a.tiles_per_cta;
  const dim3 grid((unsigned)a.nb, (unsigned)groups);
  ell_spmm_kernel<T><<<grid, THREADS, p.smem, stream>>>(a);
}

EllArgs args(const float* vals, const int16_t* loc, const int32_t* blocks,
             const int32_t* urows, const float* x, float* out, int64_t r0,
             int64_t r1, int nb, int W, int64_t M, int umax, int rmax) {
  umax = umax > 0 ? umax : 1;   // a layout of width 0 stages nothing
  return EllArgs{vals, loc, blocks, urows, x, out, r0, r1, M,
                 nb, W, umax, rmax, 0};
}

int launch(const EllArgs& a, int64_t n, void* stream) {
  if (a.r1 <= a.r0) return 0;
  Plan p;
  const int err = plan(a, &p);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.T) {
    case 16: launch_t<16>(a, p, n, s); break;
    case 32: launch_t<32>(a, p, n, s); break;
    case 64: launch_t<64>(a, p, n, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The wrapper checks the shapes and M % 4 == 0 and passes 16-byte aligned
// x and out; loc, blocks [2, nb + 1] and urows are the layout's union
// tables, umax the largest union and rmax the most rows of a block.
// The whole product: out [n, M] for the n rows of vals.
int ell_spmm(const float* vals, const int16_t* loc, const int32_t* blocks,
             const int32_t* urows, const float* x, float* out, int64_t n,
             int nb, int W, int64_t M, int umax, int rmax, void* stream) {
  return launch(args(vals, loc, blocks, urows, x, out, 0, n, nb, W, M, umax,
                     rmax), n, stream);
}

// The rows [r0, r1) of the same product against the full x:
// out [r1 - r0, M], row i the full product's row r0 + i.
int ell_spmm_rows(const float* vals, const int16_t* loc,
                  const int32_t* blocks, const int32_t* urows, const float* x,
                  float* out, int64_t n, int64_t r0, int64_t r1, int nb,
                  int W, int64_t M, int umax, int rmax, void* stream) {
  return launch(args(vals, loc, blocks, urows, x, out, r0, r1, nb, W, M, umax,
                     rmax), n, stream);
}

// How a launch at width M over tables of (umax, rmax) and width W runs:
// out = {column tile, dynamic shared memory bytes, CTAs per SM}.
int ell_spmm_plan(int64_t M, int umax, int rmax, int W, int* out) {
  Plan p;
  const int err = plan(args(nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, 0, 1, 0, W, M, umax, rmax), &p);
  out[0] = p.T;
  out[1] = p.smem;
  out[2] = p.per_sm;
  return err;
}

const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
