// Regenerated-parameter CWS for Hopper (sm_90a), the row-tiled body with
// D split across a thread-block cluster: x (n, D) nonneg + two key words ->
// the raw samples (i*, t*) as two (n, k) int32 arrays, or the b-bit codes
// packed into (n, ceil(k*b/32)) uint32 words.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/cws_hash.py:
//   cws_regen_split_hash_launch    <- cws_hash_rng_pallas (:395,
//                                     _cws_hash_rng_kernel; raw emit)
//   cws_regen_split_packed_launch  <- cws_encode_rng_packed_pallas (:534;
//                                     packed emit)
// The other four CWS kernels stay on cws_encode.cu's one-thread-per-pair
// body.
//
// What bounds it on this card: operations.  Each (d, hash) parameter costs
// three threefry-2x32 evaluations, four log1p and one log (a few hundred
// instructions); each (row, d, hash) with x > 0 one IEEE division and
// about eight fp32 operations.  The bytes (4·n·D in, 8·n·k or n·k·b/8
// out) are a small fraction.  cws_encode.cu regenerates every parameter
// once per 16-row block and loads it from shared memory once per row, and
// at a handful of rows (the estimator's n = 2) it fills a few dozen
// blocks on 132 SMs, each walking all of D alone.
//
// What the design does about it:
//   * Row-tiled registers.  A block of 16 warps is WN row warps x WD =
//     16/WN d warps; lane = hash (a hash tile of BK = 32).  Each thread
//     keeps the running (best log a, best d, best t) of R rows (a template
//     constant) for its hash in registers, loads a (d, hash) parameter from
//     shared memory once and applies it to all R rows, whose log x it loads
//     in groups of four ahead of their steps.  A block covers WN·R rows (up
//     to 16 x 8 = 128), so at n = 512 a parameter is regenerated 4 times
//     instead of 32.  Two blocks of 512 threads fill an SM (64 registers a
//     thread, no spills): 32 warps to hide the division's latency.  A
//     warp's rows are shared by its 32 lanes, so the skip of a zero entry
//     is uniform across the warp.
//   * Cooperative regeneration.  Per chunk of BD = 64 dimensions the whole
//     block stages log x of its rows and regenerates the (BD, BK) parameter
//     tile into shared memory; WD > 1 (few rows) splits each chunk's
//     dimensions over the d warps, so all 512 threads have work at n = 2.
//   * D split across a cluster.  The S CTAs of one (row tile, hash tile)
//     form a cluster on the grid's z axis (S in {1, 2, 4, 8}, chosen by
//     kernels/cws_hash.py:split_plan: the most that keep the grid within
//     one wave of two blocks per SM and a whole chunk of D per rank); rank
//     s reduces the contiguous range [s·D/S, (s+1)·D/S).  The partial
//     (la, i, t) triples meet in shared memory: first the d warps' within a
//     CTA, then rank 0 reads ranks 1..S-1 through distributed shared memory
//     (map_shared_rank) in ascending rank order and writes the emit.  No
//     global scratch, no atomics, one launch.
//
// Bit-exactness: the arithmetic is cws_common.cuh's, built with
// --fmad=false.  A serial scan keeps the first minimum over ascending d;
// each thread's scan is ascending with strict <, and every combine takes
// the smaller la and, on equal la, the smaller d (a sentinel -1 compares as
// the largest d), which is the serial scan's winner for any partition of
// D.  The [sass: ...] comments mark the regions chip_smoke.py counts SASS
// instructions in.
#include <cooperative_groups.h>

#include "cws_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 32;        // hashes per block: one per lane
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2; // resident blocks an SM holds: 64 registers
constexpr int GROUP = 4;      // rows whose log x a thread loads at once
constexpr int BD = 64;        // dimensions per shared-memory chunk
constexpr int MAX_SPLIT = 8;  // CTAs per cluster (the portable limit)

constexpr int EMIT_PACKED = 1;   // (n, words) uint32 packed codes
constexpr int EMIT_RAW = 2;      // (n, k) int32 i* and t*

// (la, i) beats (best_la, best_i): smaller la, or equal la at a smaller d.
__device__ __forceinline__ bool beats(float la, int i, float best_la,
                                      int best_i) {
  return la < best_la ||
         (la == best_la &&
          static_cast<uint32_t>(i) < static_cast<uint32_t>(best_i));
}

// Floats of dynamic shared memory: the walk's staging buffers, and after
// the walk (aliased onto them) the partial triples of every d warp.
__host__ __device__ constexpr size_t staging_floats(int bn) {
  return static_cast<size_t>(bn) * BD + 3 * BD * BK;
}
__host__ __device__ constexpr size_t partial_floats(int bn, int d_warps) {
  return 3 * static_cast<size_t>(d_warps) * bn * BK;
}

template <int R, int Emit, bool TrackT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
cws_regen_split_kernel(const float* __restrict__ x, uint32_t k0, uint32_t k1,
                       int n, int d, int k, int row_warps, int b_i, int b_t,
                       void* __restrict__ out, int32_t* __restrict__ out_t,
                       int out_cols) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());

  const int bn = row_warps * R, d_warps = WARPS / row_warps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % row_warps, wd = warp / row_warps;
  const int h0 = blockIdx.x * BK, row0 = blockIdx.y * bn;

  // the walk's staging: log x (bn, BD), then r, log c, beta (BD, BK)
  float* const s_lu = smem;
  float* const s_r = s_lu + bn * BD;
  float* const s_lc = s_r + BD * BK;
  float* const s_be = s_lc + BD * BK;

  float best_a[R], best_t[R];
  int best_i[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    best_a[j] = INFINITY;
    best_i[j] = -1;
    best_t[j] = 0.0f;
  }

  // this rank's dimensions: never empty, the plan keeps D >= S
  const int d_lo = static_cast<int>(static_cast<long long>(d) * rank / splits);
  const int d_hi =
      static_cast<int>(static_cast<long long>(d) * (rank + 1) / splits);
  const int sub = BD / d_warps;   // this warp's dimensions of each chunk
  for (int d0 = d_lo; d0 < d_hi; d0 += BD) {
    const int dn = min(BD, d_hi - d0);
    for (int e = tid; e < bn * BD; e += THREADS) {
      const int rr = e / BD, dd = e % BD;
      const int gr = row0 + rr;
      s_lu[e] = gr < n && dd < dn
                    ? cws::log_entry(x[static_cast<size_t>(gr) * d + d0 + dd])
                    : -INFINITY;
    }
    for (int e = tid; e < BD * BK; e += THREADS) {
      const int dd = e / BK, gh = h0 + e % BK;
      float r = 1.0f, lc = 0.0f, be = 0.0f;
      if (dd < dn && gh < k) {
        // [sass: regen]
        cws::regen_param(k0, k1, static_cast<uint32_t>(d0 + dd),
                         static_cast<uint32_t>(gh), r, lc, be);
        // [sass: /regen]
      }
      s_r[e] = r;
      s_lc[e] = lc;
      s_be[e] = be;
    }
    __syncthreads();

    const int hi = min(wd * sub + sub, dn);
    // [sass: column]
    for (int dd = wd * sub; dd < hi; ++dd) {
      const float r = s_r[dd * BK + lane], lc = s_lc[dd * BK + lane],
                  be = s_be[dd * BK + lane];
      const float* lu_col = s_lu + wn * R * BD + dd;
      constexpr int G = R < GROUP ? R : GROUP;
#pragma unroll
      for (int g = 0; g < R; g += G) {
        float lu[G];   // G rows' log x, loaded ahead of their steps
#pragma unroll
        for (int j = 0; j < G; ++j) lu[j] = lu_col[(g + j) * BD];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          // [sass: inner]
          if (isfinite(lu[j])) {   // a zero, NaN or inf entry never wins
            float tt, la;
            cws::step(lu[j], r, lc, be, tt, la);
            if (la < best_a[g + j]) {
              best_a[g + j] = la;
              best_i[g + j] = d0 + dd;
              if (TrackT) best_t[g + j] = tt;
            }
          }
          // [sass: /inner]
        }
      }
    }
    // [sass: /column]
    __syncthreads();
  }

  // partial triples, aliased onto the staging buffers: [d warp][row][hash]
  const int cells = bn * BK;
  float* const p_la = smem;
  int* const p_i = reinterpret_cast<int*>(p_la + d_warps * cells);
  float* const p_t = reinterpret_cast<float*>(p_i + d_warps * cells);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int c = wd * cells + (wn * R + j) * BK + lane;
    p_la[c] = best_a[j];
    p_i[c] = best_i[j];
    p_t[c] = best_t[j];
  }
  __syncthreads();
  if (d_warps > 1) {   // the d warps' partials, into slot 0
    for (int c = tid; c < cells; c += THREADS) {
      float la = p_la[c], t = p_t[c];
      int i = p_i[c];
      for (int w = 1; w < d_warps; ++w) {
        const int o = w * cells + c;
        if (beats(p_la[o], p_i[o], la, i)) {
          la = p_la[o];
          i = p_i[o];
          t = p_t[o];
        }
      }
      p_la[c] = la;
      p_i[c] = i;
      p_t[c] = t;
    }
  }
  cluster.sync();   // every rank's slot 0 is final and visible

  if (rank == 0) {
    // a packed code overwrites its own cell of p_i, read just before
    int* const s_code = p_i;
    for (int c = tid; c < cells; c += THREADS) {
      float la = p_la[c], t = p_t[c];
      int i = p_i[c];
      // every rank's triple first (the remote loads overlap), then the
      // fold in ascending rank order: ascending d
      float rla[MAX_SPLIT], rt[MAX_SPLIT];
      int ri[MAX_SPLIT];
#pragma unroll
      for (int s = 1; s < MAX_SPLIT; ++s) {
        if (s < splits) {
          rla[s] = *cluster.map_shared_rank(p_la + c, s);
          ri[s] = *cluster.map_shared_rank(p_i + c, s);
          rt[s] = *cluster.map_shared_rank(p_t + c, s);
        }
      }
#pragma unroll
      for (int s = 1; s < MAX_SPLIT; ++s) {
        if (s < splits && beats(rla[s], ri[s], la, i)) {
          la = rla[s];
          i = ri[s];
          t = rt[s];
        }
      }
      const int row = row0 + c / BK, h = h0 + c % BK;
      if constexpr (Emit == EMIT_RAW) {
        // i*, and t* clipped to +-2^30; an all-zero row keeps (-1, 0)
        if (row < n && h < k) {
          const size_t o = static_cast<size_t>(row) * out_cols + h;
          static_cast<int32_t*>(out)[o] = i;
          out_t[o] = cws::clip_t(i, t);
        }
      } else {
        // pad hash columns pack as zero
        s_code[c] = h < k ? cws::code_of<TrackT>(i, t, b_i, b_t) : 0;
      }
    }
    if constexpr (Emit == EMIT_PACKED) {
      __syncthreads();
      const int b = b_i + b_t, cpw = 32 / b, words = BK / cpw;
      for (int e = tid; e < bn * words; e += THREADS) {
        const int rr = e / words, wi = e % words;
        const int row = row0 + rr, w = h0 / cpw + wi;
        if (row >= n || w >= out_cols) continue;
        uint32_t word = 0;
        for (int c = 0; c < cpw; ++c)
          word |= static_cast<uint32_t>(s_code[rr * BK + wi * cpw + c])
                  << (c * b);
        static_cast<uint32_t*>(out)[static_cast<size_t>(row) * out_cols + w] =
            word;
      }
    }
  }
  cluster.sync();   // ranks 1..S-1 keep their shared memory until read
}

template <int R, int Emit, bool TrackT>
cudaError_t launch_r(const float* x, uint32_t k0, uint32_t k1, int n, int d,
                     int k, int row_warps, int splits, int b_i, int b_t,
                     void* out, int32_t* out_t, int out_cols,
                     cudaStream_t stream) {
  auto kernel = cws_regen_split_kernel<R, Emit, TrackT>;
  const int bn = row_warps * R, d_warps = WARPS / row_warps;
  const size_t floats = staging_floats(bn) > partial_floats(bn, d_warps)
                            ? staging_floats(bn)
                            : partial_floats(bn, d_warps);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((k + BK - 1) / BK, (n + bn - 1) / bn, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, k0, k1, n, d, k, row_warps, b_i,
                           b_t, out, out_t, out_cols);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int Emit, bool TrackT>
cudaError_t launch(const float* x, uint32_t k0, uint32_t k1, int n, int d,
                   int k, int rows_per_thread, int row_warps, int splits,
                   int b_i, int b_t, void* out, int32_t* out_t, int out_cols,
                   cudaStream_t stream) {
  if (n <= 0 || k <= 0) return cudaSuccess;
  const bool pow2_warps = row_warps > 0 && row_warps <= WARPS &&
                          (row_warps & (row_warps - 1)) == 0;
  const bool pow2_split = splits > 0 && splits <= MAX_SPLIT &&
                          (splits & (splits - 1)) == 0;
  if (!pow2_warps || !pow2_split || (splits > 1 && d < splits) ||
      (n + row_warps * rows_per_thread - 1) / (row_warps * rows_per_thread) >
          65535)
    return cudaErrorInvalidValue;
  switch (rows_per_thread) {
#define CWS_SPLIT_CASE(R)                                                   \
  case R:                                                                   \
    return launch_r<R, Emit, TrackT>(x, k0, k1, n, d, k, row_warps, splits, \
                                     b_i, b_t, out, out_t, out_cols, stream);
    CWS_SPLIT_CASE(1)
    CWS_SPLIT_CASE(2)
    CWS_SPLIT_CASE(4)
    CWS_SPLIT_CASE(8)
#undef CWS_SPLIT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Row 6: regenerated params -> raw i* and t*, each (n, k) int32, on the
// plan (rows_per_thread, row_warps, splits) of kernels/cws_hash.py.
int cws_regen_split_hash_launch(const float* x, uint32_t k0, uint32_t k1,
                                int n, int d, int k, int rows_per_thread,
                                int row_warps, int splits, int32_t* i_out,
                                int32_t* t_out, cudaStream_t stream) {
  return launch<EMIT_RAW, true>(x, k0, k1, n, d, k, rows_per_thread,
                                row_warps, splits, 0, 0, i_out, t_out, k,
                                stream);
}

// Row 3: regenerated params -> (n, words) packed uint32 codes.
int cws_regen_split_packed_launch(const float* x, uint32_t k0, uint32_t k1,
                                  int n, int d, int k, int b_i, int b_t,
                                  int rows_per_thread, int row_warps,
                                  int splits, uint32_t* out, int words,
                                  cudaStream_t stream) {
  if (b_t > 0)
    return launch<EMIT_PACKED, true>(x, k0, k1, n, d, k, rows_per_thread,
                                     row_warps, splits, b_i, b_t, out,
                                     nullptr, words, stream);
  return launch<EMIT_PACKED, false>(x, k0, k1, n, d, k, rows_per_thread,
                                    row_warps, splits, b_i, b_t, out, nullptr,
                                    words, stream);
}

}  // extern "C"
