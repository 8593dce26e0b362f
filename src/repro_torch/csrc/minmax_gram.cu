// Min-sum Gram kernel for Hopper (sm_90a):
//   S[m, n] = sum_d min(x[m, d], y[n, d]),  x (M, D), y (N, D) fp32 -> (M, N) fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/minmax_gram.py:
//   min_sum_launch  <- _min_sum_pallas (:66) / _minsum_kernel (:24)
// (reached by min_sum_pallas and _minmax_gram_pallas).  As in the
// reference, the min-max epilogue K = S / max(sum x + sum y - S, 1e-30)
// stays outside the kernel, in PyTorch (repro_torch/kernels/minmax_gram.py).
//
// What bounds it on this card: operations.  Every (m, n, d) costs one min
// and one add, 2·M·N·D instructions on 4·(M + N)·D bytes in and 4·M·N bytes
// out; min is not a tensor-core operation, so the ceiling is the SIMT
// lanes' issue rate (one instruction a lane a cycle), not the HBM rate (at
// (12,000, 12,000, 784) the instructions take some 7 ms at that rate, the
// bytes 0.18 ms).  Every address computation, copy or bounds check spends
// the same issue slots as the work.
//
// What the design does about it (a plan from kernels/minmax_gram.py:
// gram_plan picks the mode, the tile and the slices of D):
//   * Tiled mode: a persistent grid, each block walking its units (output
//     tile, slice of D) in a static order: unit u = tile * S + slice,
//     block b taking b, b + grid, ...; the grid is at most as many blocks
//     as the SMs hold at once (one a SM for 128 x 128 tiles, two for
//     128 x 64, three for 64 x 64), so every block starts at once.  A
//     block is one producer warp and two consumer warpgroups (288
//     threads; one warpgroup, 160 threads, for 64 x 64).  The producer's
//     one thread keeps a ring of ST = 4 stages
//     full with 2-D TMA loads of row-major boxes, BM rows of x and BN rows
//     of y by 32 d (128 bytes a row, 128-byte swizzle), each stage's
//     arrival counted by a full mbarrier and its release by an empty one
//     (one arrive a consumer warp); it runs ahead into the next unit while
//     the consumers finish one.  No thread spends an instruction on a copy
//     or a bounds check: rows past M or N and d past D arrive as zeros
//     (TMA's fill), and min(0, 0) adds exactly 0, as the reference's zero
//     padding does.
//   * Consumers: WM x WN warps, warp w = WM wn + wm, lane = 8 lm + ln; a
//     thread owns rows wm·4·RM + lm + 4i of x (i < RM) and wn·8·RN + ln +
//     8j of y (j < RN): an RM x RN micro-tile of fp32 accumulators, 8 x 8
//     (128 x 128 tiles, 4 x 2 warps), 8 x 4 (128 x 64, 4 x 2) or 4 x 8
//     (64 x 64, 4 x 1: fewer loads a triple than 4 x 4 over 4 x 2 warps,
//     and faster on the card).  Per 4 d it reads one float4 along d for
//     each of its rows (RM + RN LDS.128) and issues 4·RM·RN FMNMX and as
//     many FADD: the loads are 3% of the issue at 8 x 8.  With
//     the swizzle the 8 y rows a quarter-warp reads hold 8 distinct values
//     of row % 8, so their 16-byte chunks land in 8 distinct bank groups,
//     and the x rows are broadcasts: no bank conflict.  A chunk's tail past
//     D is skipped in groups of 4 d.
//   * Summation order: each accumulator sums its slice's d in ascending
//     order from 0.0f, by IEEE adds (__fadd_rn, no contraction).  With S =
//     1 the tile is stored from registers.  With S > 1 each unit stores its
//     fp32 partial tile into plane s of an (S, M, N) workspace, and a
//     second, elementwise kernel adds the S planes in slice order, slice 0
//     first: the result does not depend on which block ran which slice or
//     when, and no unit waits for another.
//   * Small-output mode (m·n below one tile's threads, e.g. the estimator's
//     (1, 1, D)): one block of 256 threads an output; thread t sums d = t,
//     t + 256, ... in ascending order, then a tree in shared memory adds
//     thread t + h into t for h = 128, 64, ..., 1.
// Every order the plans produce stays within |dS| <= 2·D·2^-24·S of any
// other (all terms are nonnegative).  Offsets into S and the workspace
// are size_t: M·N reaches 1.44e8 at the timing shape.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int BD = 32;                   // d per stage: one 128-byte row
constexpr int ST = 4;                    // stages in the ring
constexpr int SMALL_THREADS = 256;
constexpr int COMBINE_THREADS = 256;
constexpr int SM_SMEM = 233472;          // an SM's shared memory on sm_90

// An RM x RN micro-tile a thread, WM x WN consumer warps of 4 x 8 lanes,
// so a tile is BM = 4·RM·WM rows of x by BN = 8·RN·WN rows of y; the
// producer warp comes first.  Blocks that fit an SM at once (shared
// memory; the launch bound holds the registers to it): OCCUPANCY.
template <int RM, int RN, int WM, int WN>
struct Tile {
  static constexpr int BM = 4 * RM * WM;
  static constexpr int BN = 8 * RN * WN;
  static constexpr int CONSUMERS = 32 * WM * WN;
  static constexpr int THREADS = 32 + CONSUMERS;
  static constexpr int X_BYTES = BM * 128;
  static constexpr int STAGE_BYTES = X_BYTES + BN * 128;
  // the stages, then ST full and ST empty barriers, and 1 KB to align the
  // base to the swizzle's 1,024-byte period
  static constexpr int SMEM = ST * STAGE_BYTES + 16 * ST + 1024;
  static constexpr int OCCUPANCY = SM_SMEM / (SMEM + 1024);
  static_assert(OCCUPANCY >= 1, "stages exceed shared memory");
  static_assert(STAGE_BYTES % 1024 == 0, "stages must keep the swizzle");
  static_assert(RM % 2 == 0, "x rows come in swizzle pairs");
};

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// one 2-D box (32 d x rows) of a (rows, D) map into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

template <int RM, int RN, int WM, int WN>
__global__ void __launch_bounds__((Tile<RM, RN, WM, WN>::THREADS),
                                  (Tile<RM, RN, WM, WN>::OCCUPANCY))
min_sum_tiled_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap y_map, int m, int n,
                     int d, int splits, float* __restrict__ partials,
                     float* __restrict__ out) {
  using T = Tile<RM, RN, WM, WN>;
  constexpr int BM = T::BM, BN = T::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + ST * T::STAGE_BYTES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (ST + st); };

  const int tiles_n = (n + BN - 1) / BN;
  const int units = ((m + BM - 1) / BM) * tiles_n * splits;
  const int chunks = (d + BD - 1) / BD;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), WM * WN);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 32) {
    // the producer: one thread keeps the ring full across the units
    if (tid == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int tile = u / splits, s = u % splits;
        const int r0 = tile / tiles_n * BM, c0 = tile % tiles_n * BN;
        const int hi = chunks * (s + 1) / splits;
        for (int c = chunks * s / splits; c < hi; ++c, ++it) {
          const int st = it % ST;
          mbar_wait(empty(st), ((it / ST) & 1) ^ 1);
          mbar_expect_tx(full(st), T::STAGE_BYTES);
          const uint32_t dst = base + st * T::STAGE_BYTES;
          tma_load_2d(dst, &x_map, c * BD, r0, full(st));
          tma_load_2d(dst + T::X_BYTES, &y_map, c * BD, c0, full(st));
        }
      }
    }
    return;
  }

  const int ct = tid - 32, warp = ct / 32, lane = ct % 32;
  const int wm = warp % WM, wn = warp / WM, lm = lane / 8, ln = lane % 8;
  // this thread's rows within a stage: x row wm·4·RM + lm + 4i at x_off +
  // 512 i, y row wn·8·RN + ln + 8j at y_off + 1,024 j; the 128-byte
  // swizzle moves the 16-byte chunk q of row r to chunk q ^ (r % 8), and
  // r % 8 is lm (even i), lm ^ 4 (odd i) or ln (every j)
  const int x_off = (wm * 4 * RM + lm) * 128;
  const int y_off = T::X_BYTES + (wn * 8 * RN + ln) * 128;
  const size_t plane = static_cast<size_t>(m) * n;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u / splits, s = u % splits;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

    const int hi = chunks * (s + 1) / splits;
    for (int c = chunks * s / splits; c < hi; ++c, ++it) {
      const int st = it % ST;
      mbar_wait(full(st), (it / ST) & 1);
      const unsigned char* sx = smem + st * T::STAGE_BYTES + x_off;
      const unsigned char* sy = smem + st * T::STAGE_BYTES + y_off;
      const int groups = (min(BD, d - c * BD) + 3) / 4;
      // [sass: inner]
#pragma unroll 1
      for (int q = 0; q < groups; ++q) {
        const int qx = (q ^ lm) << 4, qx4 = (q ^ lm ^ 4) << 4;
        const int qy = (q ^ ln) << 4;
        float4 xv[RM], yv[RN];
#pragma unroll
        for (int k = 0; k < RM / 2; ++k) {
          xv[2 * k] = *reinterpret_cast<const float4*>(sx + 1024 * k + qx);
          xv[2 * k + 1] =
              *reinterpret_cast<const float4*>(sx + 1024 * k + 512 + qx4);
        }
#pragma unroll
        for (int j = 0; j < RN; ++j)
          yv[j] = *reinterpret_cast<const float4*>(sy + 1024 * j + qy);
#pragma unroll
        for (int e = 0; e < 4; ++e)   // d ascending: the float4's lanes
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j)
              acc[i][j] = __fadd_rn(acc[i][j],
                                    fminf(lane_of(xv[i], e), lane_of(yv[j], e)));
      }
      // [sass: /inner]
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // S = 1: the tile itself; S > 1: slice s's plane of the workspace, in
    // S's layout, for the combine pass
    float* dst = splits == 1 ? out : partials + s * plane;
    const int row0 = tile / tiles_n * BM + wm * 4 * RM + lm;
    const int col0 = tile % tiles_n * BN + wn * 8 * RN + ln;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = row0 + 4 * i;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = col0 + 8 * j;
        if (col < n) dst[static_cast<size_t>(row) * n + col] = acc[i][j];
      }
    }
  }
}

// S > 1: each output the sum of its S slice partials in slice order, slice
// 0 first (all S loads in flight before the adds)
__global__ void __launch_bounds__(COMBINE_THREADS)
min_sum_combine_kernel(const float* __restrict__ partials, int splits,
                       size_t plane, float* __restrict__ out) {
  for (size_t e = blockIdx.x * static_cast<size_t>(COMBINE_THREADS) +
                  threadIdx.x;
       e < plane; e += static_cast<size_t>(gridDim.x) * COMBINE_THREADS) {
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = t < splits ? __ldcs(partials + t * plane + e) : 0.0f;
    float sum = v[0];
#pragma unroll
    for (int t = 1; t < 8; ++t)
      if (t < splits) sum = __fadd_rn(sum, v[t]);
    out[e] = sum;
  }
}

__global__ void __launch_bounds__(SMALL_THREADS)
min_sum_small_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     int n, int d, int ldx, int ldy, float* __restrict__ out) {
  __shared__ float part[SMALL_THREADS];
  const int t = threadIdx.x;
  const int o = blockIdx.x;
  const float* xr = x + static_cast<size_t>(o / n) * ldx;
  const float* yr = y + static_cast<size_t>(o % n) * ldy;
  float acc = 0.0f;
  // [sass: small]
  for (int k = t; k < d; k += SMALL_THREADS)
    acc = __fadd_rn(acc, fminf(__ldg(xr + k), __ldg(yr + k)));
  // [sass: /small]
  part[t] = acc;
  __syncthreads();
#pragma unroll
  for (int h = SMALL_THREADS / 2; h > 0; h /= 2) {
    if (t < h) part[t] = __fadd_rn(part[t], part[t + h]);
    __syncthreads();
  }
  if (t == 0) out[o] = part[0];
}

// A (rows, d) fp32 matrix with row stride ld floats (ld % 4 == 0, base
// 16-byte aligned) as a 2-D map (d, rows) of 32 x box_rows boxes, 128-byte
// swizzle; reads past rows or d fill zeros.
bool make_map(CUtensorMap* map, const float* ptr, int rows, int d, int ld,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {BD, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int RM, int RN, int WM, int WN>
cudaError_t launch_tiled(const float* x, const float* y, int m, int n, int d,
                         int ldx, int ldy, int splits, int blocks,
                         float* partials, float* out, cudaStream_t stream) {
  using T = Tile<RM, RN, WM, WN>;
  CUtensorMap maps[2];
  if (!make_map(&maps[0], x, m, d, ldx, T::BM) ||
      !make_map(&maps[1], y, n, d, ldy, T::BN))
    return cudaErrorInvalidValue;
  auto kernel = min_sum_tiled_kernel<RM, RN, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, T::THREADS, T::SMEM, stream>>>(maps[0], maps[1], m, n, d,
                                                splits, partials, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t plane = static_cast<size_t>(m) * n;
  const size_t want = (plane + COMBINE_THREADS - 1) / COMBINE_THREADS;
  const int grid = static_cast<int>(want < 4096 ? want : 4096);
  min_sum_combine_kernel<<<grid, COMBINE_THREADS, 0, stream>>>(
      partials, splits, plane, out);
  return cudaGetLastError();
}

// The kernel a query names: kind 0 the tiled kernel of a tile_m x tile_n
// tile, 1 the combine pass, 2 the small-output mode; with its block size
// and the dynamic shared memory its launcher sets.  Null for another.
const void* kernel_of(int kind, int tile_m, int tile_n, int* threads,
                      int* smem) {
  *smem = 0;
  if (kind == 1) {
    *threads = COMBINE_THREADS;
    return reinterpret_cast<const void*>(min_sum_combine_kernel);
  }
  if (kind == 2) {
    *threads = SMALL_THREADS;
    return reinterpret_cast<const void*>(min_sum_small_kernel);
  }
  if (kind != 0) return nullptr;
#define GRAM_TILE(TM, TN, RM, RN, WM, WN)                               \
  if (tile_m == TM && tile_n == TN) {                                   \
    *threads = Tile<RM, RN, WM, WN>::THREADS;                           \
    *smem = Tile<RM, RN, WM, WN>::SMEM;                                 \
    return reinterpret_cast<const void*>(                               \
        min_sum_tiled_kernel<RM, RN, WM, WN>);                          \
  }
  GRAM_TILE(128, 128, 8, 8, 4, 2)
  GRAM_TILE(128, 64, 8, 4, 4, 2)
  GRAM_TILE(64, 64, 4, 8, 4, 1)
#undef GRAM_TILE
  return nullptr;
}

}  // namespace

extern "C" {

// Queries for the kernel contracts (host code only), by the kinds of
// kernel_of: the dynamic shared memory its launcher sets, its attributes
// (out: static shared bytes, registers, local bytes, max threads, max
// dynamic shared bytes) and the blocks an SM holds at its launch.
int min_sum_smem_bytes(int kind, int tile_m, int tile_n) {
  int threads = 0, smem = 0;
  if (kernel_of(kind, tile_m, tile_n, &threads, &smem) == nullptr) return -1;
  return smem;
}

int min_sum_attributes(int kind, int tile_m, int tile_n, int* out) {
  int threads = 0, smem = 0;
  const void* kernel = kernel_of(kind, tile_m, tile_n, &threads, &smem);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  out[0] = static_cast<int>(a.sharedSizeBytes);
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = a.maxDynamicSharedSizeBytes;
  return cudaSuccess;
}

int min_sum_occupancy(int kind, int tile_m, int tile_n, int* blocks) {
  int threads = 0, smem = 0;
  const void* kernel = kernel_of(kind, tile_m, tile_n, &threads, &smem);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, smem);
}

// Row 7 of the TPU kernel table: x (m, d) and y (n, d) fp32 with row
// strides ldx and ldy floats -> S (m, n) fp32, on the plan gram_plan made:
// small != 0 takes the small-output mode (blocks = m·n); otherwise a
// tile_m x tile_n tile (128 x 128, 128 x 64 or 64 x 64) and splits S in
// {1, 2, 4, 8} on `blocks` persistent blocks, x and y 16-byte aligned with
// ldx, ldy multiples of 4 (TMA), and for S > 1 a workspace `partials` of S
// x m x n floats, added into S by a second, elementwise kernel.  Returns
// the launches' cudaError_t (a refused launch or a tensor map the driver
// will not encode gives an error, never a run).
int min_sum_launch(const float* x, const float* y, int m, int n, int d,
                   int ldx, int ldy, int tile_m, int tile_n, int splits,
                   int blocks, int small, float* partials, float* out,
                   cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (d <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  if (small) {
    min_sum_small_kernel<<<blocks, SMALL_THREADS, 0, stream>>>(
        x, y, n, d, ldx, ldy, out);
    return cudaGetLastError();
  }
  if (splits < 1 || splits > 8 || (splits > 1 && partials == nullptr))
    return cudaErrorInvalidValue;
  if (tile_m == 128 && tile_n == 128)
    return launch_tiled<8, 8, 4, 2>(x, y, m, n, d, ldx, ldy, splits, blocks,
                              partials, out, stream);
  if (tile_m == 128 && tile_n == 64)
    return launch_tiled<8, 4, 4, 2>(x, y, m, n, d, ldx, ldy, splits, blocks,
                              partials, out, stream);
  if (tile_m == 64 && tile_n == 64)
    return launch_tiled<4, 8, 4, 1>(x, y, m, n, d, ldx, ldy, splits, blocks,
                              partials, out, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
