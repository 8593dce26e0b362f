// CWS for Hopper (sm_90a), the row-tiled body with D split across a
// thread-block cluster: x (n, D) nonneg + two key words or the stored
// (D, k) parameter matrices -> embedding-bag indices (n, k) int32, the
// b-bit codes packed into (n, ceil(k*b/32)) uint32 words, or the raw
// samples (i*, t*) as two (n, k) int32 arrays.
//
// Replaces six Pallas TPU kernels of src/repro/kernels/cws_hash.py:
//   cws_split_index_launch         <- cws_encode_rng_pallas (:431;
//                                     regenerated params, index emit)
//   cws_split_stored_index_launch  <- cws_encode_pallas (:246; stored
//                                     params, index emit)
//   cws_regen_split_packed_launch  <- cws_encode_rng_packed_pallas (:534;
//                                     regenerated params, packed emit)
//   cws_split_stored_packed_launch <- cws_encode_packed_pallas (:488;
//                                     stored params, packed emit)
//   cws_split_stored_hash_launch   <- cws_hash_pallas (:213, _cws_kernel;
//                                     stored params, raw emit)
//   cws_regen_split_hash_launch    <- cws_hash_rng_pallas (:395,
//                                     _cws_hash_rng_kernel; raw emit)
//
// What bounds it on this card: operations.  Each regenerated (d, hash)
// parameter costs three threefry-2x32 evaluations, four log1p and one log
// (a few hundred instructions); each (row, d, hash) with x > 0 one IEEE
// division and about eight fp32 operations.  The bytes (4·n·D in, plus
// 12·D·k of stored parameters; 4·n·k, n·k·b/8 or 8·n·k out) are a small
// fraction.  A one-thread-per-(row, hash) body regenerates or loads every
// parameter once per 16-row block and reads it from shared memory once
// per row, and at a handful of rows (the estimator's n = 2) fills a few
// dozen blocks on 132 SMs, each walking all of D alone.
//
// What the design does about it:
//   * Row-tiled registers.  A block of 16 warps is WN row warps x WD =
//     16/WN d warps; lane = hash (a hash tile of BK = 32).  Each thread
//     keeps the running (best log a, best d, best t) of R rows (a template
//     constant) for its hash in registers, loads a (d, hash) parameter from
//     shared memory once and applies it to all R rows, whose log x it loads
//     in groups of four ahead of their steps.  A block covers WN·R rows (up
//     to 16 x 8 = 128), so at n = 512 a parameter is regenerated or loaded
//     4 times instead of 32.  Two blocks of 512 threads fill an SM (64
//     registers a thread, no spills): 32 warps to hide the division's
//     latency.  A warp's rows are shared by its 32 lanes, so the skip of a
//     zero entry is uniform across the warp.
//   * The parameter tile.  Per chunk of BD = 64 dimensions the whole block
//     stages log x of its rows and the (BD, BK) tiles of r, log c and beta
//     in shared memory.  Regenerated parameters are computed there
//     cooperatively.  Stored ones (Stored) arrive by cp.async into one of
//     two buffers: chunk c+1's tiles are in flight while the block computes
//     on chunk c, one commit group a chunk.  A tile row is 32 consecutive
//     floats (128 bytes), so a warp's copies are whole segments: 16-byte
//     copies where k % 4 == 0 and the matrices are 16-byte aligned, 4-byte
//     ones otherwise (the launcher says which).  WD > 1 (few rows) splits
//     each chunk's dimensions over the d warps, so all 512 threads have
//     work at n = 2.
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
constexpr int TILE = BD * BK; // floats of one parameter's (BD, BK) tile
static_assert(TILE / 4 == THREADS, "one 16-byte copy a thread a parameter");

constexpr int EMIT_INDEX = 0;    // (n, k) int32 bag indices
constexpr int EMIT_PACKED = 1;   // (n, words) uint32 packed codes
constexpr int EMIT_RAW = 2;      // (n, k) int32 i* and t*

// (la, i) beats (best_la, best_i): smaller la, or equal la at a smaller d.
__device__ __forceinline__ bool beats(float la, int i, float best_la,
                                      int best_i) {
  return la < best_la ||
         (la == best_la &&
          static_cast<uint32_t>(i) < static_cast<uint32_t>(best_i));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every commit group but the newest ``Pending`` has landed (this thread's)
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// The thread's index, read anew: what a copy derives from it is then
// computed where the copy is issued, not kept in registers across the walk.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Start the copies of one chunk's stored tiles: rows [c0, c0 + cn) and
// hash columns [h0, h0 + BK) of the (D, k) row-major r, log c and beta
// into s_par (r, log c, beta: TILE floats each).  Entries past the chunk
// or past k are stored as (1, 0, 0), the value the regen path gives them:
// never emitted, and their step stays well defined.
__device__ __forceinline__ void issue_tile(const float* __restrict__ r_g,
                                           const float* __restrict__ lc_g,
                                           const float* __restrict__ be_g,
                                           float* s_par, int c0, int cn,
                                           int h0, int k, bool wide) {
  const int tid = fresh_tid();
  float* const s_r = s_par;
  float* const s_lc = s_par + TILE;
  float* const s_be = s_par + 2 * TILE;
  if (wide) {
    // four hashes a thread: with k % 4 == 0 a group is all in or all out
    const int dd = tid / (BK / 4), hh = tid % (BK / 4) * 4;
    const int e = dd * BK + hh;
    if (dd < cn && h0 + hh < k) {
      // [sass: load]
      const size_t o = static_cast<size_t>(c0 + dd) * k + h0 + hh;
      cp_async16(s_r + e, r_g + o);
      cp_async16(s_lc + e, lc_g + o);
      cp_async16(s_be + e, be_g + o);
      // [sass: /load]
    } else {
      *reinterpret_cast<float4*>(s_r + e) = make_float4(1.f, 1.f, 1.f, 1.f);
      *reinterpret_cast<float4*>(s_lc + e) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(s_be + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < TILE / THREADS; ++j) {
    const int e = j * THREADS + tid, dd = e / BK, hh = e % BK;
    if (dd < cn && h0 + hh < k) {
      const size_t o = static_cast<size_t>(c0 + dd) * k + h0 + hh;
      cp_async4(s_r + e, r_g + o);
      cp_async4(s_lc + e, lc_g + o);
      cp_async4(s_be + e, be_g + o);
    } else {
      s_r[e] = 1.0f;
      s_lc[e] = 0.0f;
      s_be[e] = 0.0f;
    }
  }
}

// Floats of dynamic shared memory: the walk's staging buffers (log x and
// one parameter buffer, two when Stored), and after the walk (aliased onto
// them) the partial triples of every d warp.
__host__ __device__ constexpr size_t staging_floats(int bn, bool stored) {
  return static_cast<size_t>(bn) * BD + (stored ? 2 : 1) * 3 * TILE;
}
__host__ __device__ constexpr size_t partial_floats(int bn, int d_warps) {
  return 3 * static_cast<size_t>(d_warps) * bn * BK;
}

template <int R, int Emit, bool TrackT, bool Stored>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
cws_split_kernel(const float* __restrict__ x, const float* __restrict__ r_g,
                 const float* __restrict__ lc_g,
                 const float* __restrict__ be_g, uint32_t k0, uint32_t k1,
                 int n, int d, int k, int row_warps, int b_i, int b_t,
                 int wide, void* __restrict__ out,
                 int32_t* __restrict__ out_t, int out_cols) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());

  const int bn = row_warps * R, d_warps = WARPS / row_warps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % row_warps, wd = warp / row_warps;
  const int h0 = blockIdx.x * BK, row0 = blockIdx.y * bn;

  // the walk's staging: log x (bn, BD), then r, log c, beta (BD, BK) in
  // one buffer, or (Stored) two taken in turns
  float* const s_lu = smem;
  float* const s_par0 = s_lu + bn * BD;

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
  if constexpr (Stored) {   // the first chunk's tiles in flight
    issue_tile(r_g, lc_g, be_g, s_par0, d_lo, min(BD, d_hi - d_lo), h0, k,
               wide);
    cp_async_commit();
  }
  int buf = 0;
  for (int d0 = d_lo; d0 < d_hi; d0 += BD) {
    const int dn = min(BD, d_hi - d0);
    float* const s_r = s_par0 + buf * 3 * TILE;
    float* const s_lc = s_r + TILE;
    float* const s_be = s_lc + TILE;
    if constexpr (Stored) {
      // the next chunk's tiles into the other buffer, which the last
      // chunk's closing barrier freed; a group is committed even when
      // empty, so waiting for all but the newest one below waits for this
      // chunk's
      const int d1 = d0 + BD;
      if (d1 < d_hi)
        issue_tile(r_g, lc_g, be_g, s_par0 + (buf ^ 1) * 3 * TILE, d1,
                   min(BD, d_hi - d1), h0, k, wide);
      cp_async_commit();
    }
    for (int e = tid; e < bn * BD; e += THREADS) {
      const int rr = e / BD, dd = e % BD;
      const int gr = row0 + rr;
      s_lu[e] = gr < n && dd < dn
                    ? cws::log_entry(x[static_cast<size_t>(gr) * d + d0 + dd])
                    : -INFINITY;
    }
    if constexpr (Stored) {
      cp_async_wait<1>();
    } else {
      for (int e = tid; e < TILE; e += THREADS) {
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
    if constexpr (Stored) buf ^= 1;
  }
  if constexpr (Stored) cp_async_wait<0>();   // the last, empty group

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
      } else if constexpr (Emit == EMIT_INDEX) {
        // hash h's bag: h * 2^b + its code, sentinel -> bucket 0; a warp
        // writes 32 consecutive hashes of one row
        if (row < n && h < k)
          static_cast<int32_t*>(out)[static_cast<size_t>(row) * out_cols +
                                     h] =
              h * (1 << (b_i + b_t)) + cws::code_of<TrackT>(i, t, b_i, b_t);
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

// What one launch reads and writes; the stored matrices are null and
// ``wide`` 0 in regen mode.
struct Problem {
  const float* x;
  const float* r;
  const float* lc;
  const float* be;
  uint32_t k0, k1;
  int n, d, k, b_i, b_t, wide;
  void* out;
  int32_t* out_t;
  int out_cols;
};

// The dynamic shared memory a launch of R rows a thread and row_warps row
// warps sets: the staging buffers or the partials, whichever is larger.
size_t dyn_smem_bytes(int rows_per_thread, int row_warps, bool stored) {
  const int bn = row_warps * rows_per_thread, d_warps = WARPS / row_warps;
  const size_t floats = staging_floats(bn, stored) > partial_floats(bn, d_warps)
                            ? staging_floats(bn, stored)
                            : partial_floats(bn, d_warps);
  return floats * sizeof(float);
}

template <int R, int Emit, bool TrackT, bool Stored>
cudaError_t launch_r(const Problem& p, int row_warps, int splits,
                     cudaStream_t stream) {
  auto kernel = cws_split_kernel<R, Emit, TrackT, Stored>;
  const int bn = row_warps * R;
  const size_t smem = dyn_smem_bytes(R, row_warps, Stored);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.k + BK - 1) / BK, (p.n + bn - 1) / bn, splits);
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
  err = cudaLaunchKernelEx(&cfg, kernel, p.x, p.r, p.lc, p.be, p.k0, p.k1,
                           p.n, p.d, p.k, row_warps, p.b_i, p.b_t, p.wide,
                           p.out, p.out_t, p.out_cols);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <int Emit, bool TrackT, bool Stored>
cudaError_t launch(const Problem& p, int rows_per_thread, int row_warps,
                   int splits, cudaStream_t stream) {
  if (p.n <= 0 || p.k <= 0) return cudaSuccess;
  const bool pow2_warps = row_warps > 0 && row_warps <= WARPS &&
                          (row_warps & (row_warps - 1)) == 0;
  const bool pow2_split = splits > 0 && splits <= MAX_SPLIT &&
                          (splits & (splits - 1)) == 0;
  if (!pow2_warps || !pow2_split || (splits > 1 && p.d < splits) ||
      (p.n + row_warps * rows_per_thread - 1) /
              (row_warps * rows_per_thread) >
          65535)
    return cudaErrorInvalidValue;
  // 16-byte copies need whole groups of four hashes on 16-byte boundaries
  if (p.wide && (p.k % 4 != 0 || !aligned16(p.r) || !aligned16(p.lc) ||
                 !aligned16(p.be)))
    return cudaErrorMisalignedAddress;
  switch (rows_per_thread) {
#define CWS_SPLIT_CASE(R) \
  case R:                 \
    return launch_r<R, Emit, TrackT, Stored>(p, row_warps, splits, stream);
    CWS_SPLIT_CASE(1)
    CWS_SPLIT_CASE(2)
    CWS_SPLIT_CASE(4)
    CWS_SPLIT_CASE(8)
#undef CWS_SPLIT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The emits whose t* bits are optional track t* only for b_t > 0.
template <int Emit, bool Stored>
cudaError_t launch_code(const Problem& p, int rows_per_thread, int row_warps,
                        int splits, cudaStream_t stream) {
  if (p.b_t > 0)
    return launch<Emit, true, Stored>(p, rows_per_thread, row_warps, splits,
                                      stream);
  return launch<Emit, false, Stored>(p, rows_per_thread, row_warps, splits,
                                     stream);
}

// The instantiation the launchers run for (R, emit, t* tracked, stored);
// null for one they never run (a raw emit always tracks t*).  Taking
// these addresses instantiates nothing the launchers do not.
template <int Emit, bool TrackT, bool Stored>
const void* kernel_r(int r) {
  switch (r) {
    case 1: return reinterpret_cast<const void*>(cws_split_kernel<1, Emit, TrackT, Stored>);
    case 2: return reinterpret_cast<const void*>(cws_split_kernel<2, Emit, TrackT, Stored>);
    case 4: return reinterpret_cast<const void*>(cws_split_kernel<4, Emit, TrackT, Stored>);
    case 8: return reinterpret_cast<const void*>(cws_split_kernel<8, Emit, TrackT, Stored>);
    default: return nullptr;
  }
}

template <int Emit, bool Stored>
const void* kernel_t(int r, int track_t) {
  return track_t ? kernel_r<Emit, true, Stored>(r)
                 : kernel_r<Emit, false, Stored>(r);
}

const void* kernel_of(int r, int emit, int track_t, int stored) {
  switch (emit) {
    case EMIT_INDEX:
      return stored ? kernel_t<EMIT_INDEX, true>(r, track_t)
                    : kernel_t<EMIT_INDEX, false>(r, track_t);
    case EMIT_PACKED:
      return stored ? kernel_t<EMIT_PACKED, true>(r, track_t)
                    : kernel_t<EMIT_PACKED, false>(r, track_t);
    case EMIT_RAW:
      if (!track_t) return nullptr;
      return stored ? kernel_r<EMIT_RAW, true, true>(r)
                    : kernel_r<EMIT_RAW, true, false>(r);
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// Queries for the kernel contracts (host code only): the dynamic shared
// memory a launch sets, an instantiation's attributes, and the blocks of
// it an SM holds at a launch's block size and shared memory.

int cws_split_smem_bytes(int rows_per_thread, int row_warps, int stored) {
  if (row_warps <= 0 || row_warps > WARPS || rows_per_thread <= 0) return -1;
  return static_cast<int>(dyn_smem_bytes(rows_per_thread, row_warps,
                                         stored != 0));
}

// out: static shared bytes, registers a thread, local bytes a thread,
// max threads a block, max dynamic shared bytes (the attribute as set).
int cws_split_attributes(int rows_per_thread, int emit, int track_t,
                         int stored, int* out) {
  const void* kernel = kernel_of(rows_per_thread, emit, track_t, stored);
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

int cws_split_occupancy(int rows_per_thread, int emit, int track_t,
                        int stored, int row_warps, int* blocks) {
  const void* kernel = kernel_of(rows_per_thread, emit, track_t, stored);
  const int smem = cws_split_smem_bytes(rows_per_thread, row_warps, stored);
  if (kernel == nullptr || smem < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       THREADS, smem);
}

// Each launcher takes the plan (rows_per_thread, row_warps, splits) of
// kernels/cws_hash.py:split_plan.

// Row 1: regenerated params -> (n, k) int32 indices.
int cws_split_index_launch(const float* x, uint32_t k0, uint32_t k1, int n,
                           int d, int k, int b_i, int b_t,
                           int rows_per_thread, int row_warps, int splits,
                           int32_t* out, cudaStream_t stream) {
  const Problem p = {x, nullptr, nullptr, nullptr, k0, k1, n, d, k, b_i,
                     b_t, 0, out, nullptr, k};
  return launch_code<EMIT_INDEX, false>(p, rows_per_thread, row_warps,
                                        splits, stream);
}

// Row 2: stored (D, k) params -> (n, k) int32 indices; copy_bytes 16 or 4,
// the width of the parameter tiles' copies.
int cws_split_stored_index_launch(const float* x, const float* r,
                                  const float* lc, const float* be, int n,
                                  int d, int k, int b_i, int b_t,
                                  int rows_per_thread, int row_warps,
                                  int splits, int copy_bytes, int32_t* out,
                                  cudaStream_t stream) {
  if (copy_bytes != 16 && copy_bytes != 4) return cudaErrorInvalidValue;
  const Problem p = {x, r, lc, be, 0u, 0u, n, d, k, b_i, b_t,
                     copy_bytes == 16, out, nullptr, k};
  return launch_code<EMIT_INDEX, true>(p, rows_per_thread, row_warps, splits,
                                       stream);
}

// Row 3: regenerated params -> (n, words) packed uint32 codes.
int cws_regen_split_packed_launch(const float* x, uint32_t k0, uint32_t k1,
                                  int n, int d, int k, int b_i, int b_t,
                                  int rows_per_thread, int row_warps,
                                  int splits, uint32_t* out, int words,
                                  cudaStream_t stream) {
  const Problem p = {x, nullptr, nullptr, nullptr, k0, k1, n, d, k, b_i,
                     b_t, 0, out, nullptr, words};
  return launch_code<EMIT_PACKED, false>(p, rows_per_thread, row_warps,
                                         splits, stream);
}

// Row 4: stored (D, k) params -> (n, words) packed uint32 codes; copy_bytes
// as row 2's.
int cws_split_stored_packed_launch(const float* x, const float* r,
                                   const float* lc, const float* be, int n,
                                   int d, int k, int b_i, int b_t,
                                   int rows_per_thread, int row_warps,
                                   int splits, int copy_bytes, uint32_t* out,
                                   int words, cudaStream_t stream) {
  if (copy_bytes != 16 && copy_bytes != 4) return cudaErrorInvalidValue;
  const Problem p = {x, r, lc, be, 0u, 0u, n, d, k, b_i, b_t,
                     copy_bytes == 16, out, nullptr, words};
  return launch_code<EMIT_PACKED, true>(p, rows_per_thread, row_warps,
                                        splits, stream);
}

// Row 5: stored (D, k) params -> raw i* and t*, each (n, k) int32;
// copy_bytes as row 2's.
int cws_split_stored_hash_launch(const float* x, const float* r,
                                 const float* lc, const float* be, int n,
                                 int d, int k, int rows_per_thread,
                                 int row_warps, int splits, int copy_bytes,
                                 int32_t* i_out, int32_t* t_out,
                                 cudaStream_t stream) {
  if (copy_bytes != 16 && copy_bytes != 4) return cudaErrorInvalidValue;
  const Problem p = {x, r, lc, be, 0u, 0u, n, d, k, 0, 0,
                     copy_bytes == 16, i_out, t_out, k};
  return launch<EMIT_RAW, true, true>(p, rows_per_thread, row_warps, splits,
                                      stream);
}

// Row 6: regenerated params -> raw i* and t*, each (n, k) int32.
int cws_regen_split_hash_launch(const float* x, uint32_t k0, uint32_t k1,
                                int n, int d, int k, int rows_per_thread,
                                int row_warps, int splits, int32_t* i_out,
                                int32_t* t_out, cudaStream_t stream) {
  const Problem p = {x, nullptr, nullptr, nullptr, k0, k1, n, d, k, 0, 0,
                     0, i_out, t_out, k};
  return launch<EMIT_RAW, true, false>(p, rows_per_thread, row_warps, splits,
                                       stream);
}

}  // extern "C"
