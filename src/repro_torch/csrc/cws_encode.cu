// CWS kernels for Hopper (sm_90a): x (n, D) nonneg -> embedding-bag
// indices (n, k) int32, b-bit codes packed into (n, ceil(k*b/32)) uint32
// words, or the raw samples (i*, t*) as two (n, k) int32 arrays.
//
// Replaces four Pallas TPU kernels of src/repro/kernels/cws_hash.py:
//   cws_encode_launch             <- cws_encode_pallas            (stored params)
//   cws_encode_rng_launch         <- cws_encode_rng_pallas        (regenerated params)
//   cws_encode_packed_launch      <- cws_encode_packed_pallas     (stored, packed emit)
//   cws_hash_launch               <- cws_hash_pallas / _cws_kernel (stored, raw emit)
// The regenerated packed and raw kernels (cws_encode_rng_packed_pallas,
// cws_hash_rng_pallas) run on the row-tiled, cluster-split body of
// cws_regen_split.cu; this body's instantiations for them stay reachable
// through cws_encode_rng_packed_launch and cws_hash_rng_launch as the
// yardstick that body is timed against.
// One device body, templated on <Regen, Emit, TrackT>, plays the part of
// the TPU kernels' shared _accum_loop and their emit steps.
//
// What bounds it on this card: operations, not bytes.  Each (row, d, hash)
// with x > 0 costs one IEEE division plus about eight fp32 operations, and
// in regen mode each (d, hash) needs three threefry-2x32 evaluations,
// four log1p and one log (this kernel repeats them once per block of BN
// rows); the bytes are 4·n·D in (plus 12·D·k of parameters in stored
// mode) and 4·n·k, n·k·b/8 or (raw) 8·n·k out.
//
// What the design does about it: one thread per (row, hash) pair, a block
// of BN rows x BK hashes walking D in chunks of BD.  The block stages
// log x for its rows and the (BD, BK) parameter tile in shared memory
// once per chunk (regenerated there cooperatively in regen mode), so a
// parameter is loaded or regenerated once per BN rows instead of once per
// row, and each x entry's log is taken once per block instead of once per
// hash.  The running (best log a, best d, best t) stay in registers; a
// warp is one row of 32 hashes, so the mask on zero entries is uniform
// across the warp.  Ragged edges are masked by bounds, never padded.
//
// Bit-exactness: the arithmetic is cws_common.cuh's, built with
// --fmad=false.  Ties go to the lowest d (strict < over ascending d).
// The [sass: ...] comments mark the regions chip_smoke.py counts SASS
// instructions in.
#include "cws_common.cuh"

namespace {

constexpr int BK = 32;   // hashes per block (threadIdx.x): one warp
constexpr int BN = 16;   // rows per block (threadIdx.y)
constexpr int BD = 64;   // dimensions per shared-memory chunk
constexpr int THREADS = BK * BN;

// What a block writes at the end of its walk over D.
constexpr int EMIT_INDEX = 0;    // (n, k) int32 bag indices
constexpr int EMIT_PACKED = 1;   // (n, words) uint32 packed codes
constexpr int EMIT_RAW = 2;      // (n, k) int32 i* and t*

template <bool Regen, int Emit, bool TrackT>
__global__ void __launch_bounds__(THREADS)
cws_encode_kernel(const float* __restrict__ x, const float* __restrict__ r_g,
                  const float* __restrict__ lc_g,
                  const float* __restrict__ be_g, uint32_t k0, uint32_t k1,
                  int n, int d, int k, int b_i, int b_t,
                  void* __restrict__ out, int32_t* __restrict__ out_t,
                  int out_cols) {
  constexpr bool Packed = Emit == EMIT_PACKED;
  __shared__ float s_lu[BN][BD];
  __shared__ float s_r[BD][BK];
  __shared__ float s_lc[BD][BK];
  __shared__ float s_be[BD][BK];
  __shared__ int s_code[Packed ? BN : 1][Packed ? BK : 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BK + tx;
  const int h0 = blockIdx.x * BK, row0 = blockIdx.y * BN;
  const int row = row0 + ty, h = h0 + tx;

  float best_a = INFINITY;
  int best_i = -1;
  float best_t = 0.0f;

  for (int d0 = 0; d0 < d; d0 += BD) {
    for (int e = tid; e < BN * BD; e += THREADS) {
      const int rr = e / BD, dd = e % BD;
      const int gr = row0 + rr, gd = d0 + dd;
      s_lu[rr][dd] = gr < n && gd < d
                         ? cws::log_entry(x[static_cast<size_t>(gr) * d + gd])
                         : -INFINITY;
    }
    for (int e = tid; e < BD * BK; e += THREADS) {
      const int dd = e / BK, hh = e % BK;
      const int gd = d0 + dd, gh = h0 + hh;
      float r = 1.0f, lc = 0.0f, be = 0.0f;
      if (gd < d && gh < k) {
        if (Regen) {
          // [sass: regen]
          cws::regen_param(k0, k1, static_cast<uint32_t>(gd),
                           static_cast<uint32_t>(gh), r, lc, be);
          // [sass: /regen]
        } else {
          const size_t o = static_cast<size_t>(gd) * k + gh;
          r = r_g[o];
          lc = lc_g[o];
          be = be_g[o];
        }
      }
      s_r[dd][hh] = r;
      s_lc[dd][hh] = lc;
      s_be[dd][hh] = be;
    }
    __syncthreads();

    const int dn = min(BD, d - d0);
    for (int dd = 0; dd < dn; ++dd) {
      // [sass: inner]
      const float lu = s_lu[ty][dd];
      if (!isfinite(lu)) continue;   // zero, NaN or inf entry: never wins
      const float r = s_r[dd][tx], lc = s_lc[dd][tx], be = s_be[dd][tx];
      float tt, la;
      cws::step(lu, r, lc, be, tt, la);
      if (la < best_a) {
        best_a = la;
        best_i = d0 + dd;
        if (TrackT) best_t = tt;
      }
      // [sass: /inner]
    }
    __syncthreads();
  }

  // Raw emit (repro/kernels/cws_hash.py:_cws_kernel): i*, and t* clipped
  // to +-2^30; an all-zero row keeps (-1, 0).
  if constexpr (Emit == EMIT_RAW) {
    if (row < n && h < k) {
      const size_t o = static_cast<size_t>(row) * out_cols + h;
      static_cast<int32_t*>(out)[o] = best_i;
      out_t[o] = cws::clip_t(best_i, best_t);
    }
    return;
  }

  // Emit: b-bit code, sentinel -> bucket 0 (repro/kernels/cws_hash.py:_encode_emit).
  const int code = cws::code_of<TrackT>(best_i, best_t, b_i, b_t);

  if constexpr (Packed) {
    const int b = b_i + b_t, cpw = 32 / b;
    s_code[ty][tx] = h < k ? code : 0;   // pad hash columns pack as zero
    __syncthreads();
    if (row < n && tx % cpw == 0) {
      uint32_t word = 0;
      for (int c = 0; c < cpw; ++c)
        word |= static_cast<uint32_t>(s_code[ty][tx + c]) << (c * b);
      const int w = (h0 + tx) / cpw;
      if (w < out_cols)
        static_cast<uint32_t*>(out)[static_cast<size_t>(row) * out_cols + w] =
            word;
    }
  } else if (row < n && h < k) {
    static_cast<int32_t*>(out)[static_cast<size_t>(row) * out_cols + h] =
        h * (1 << (b_i + b_t)) + code;
  }
}

template <bool Regen, int Emit>
cudaError_t launch(const float* x, const float* r, const float* lc,
                   const float* be, uint32_t k0, uint32_t k1, int n, int d,
                   int k, int b_i, int b_t, void* out, int32_t* out_t,
                   int out_cols, cudaStream_t stream) {
  if (n <= 0 || k <= 0) return cudaSuccess;
  const dim3 grid((k + BK - 1) / BK, (n + BN - 1) / BN);
  const dim3 block(BK, BN);
  if constexpr (Emit == EMIT_RAW) {   // t* is always part of the output
    cws_encode_kernel<Regen, Emit, true><<<grid, block, 0, stream>>>(
        x, r, lc, be, k0, k1, n, d, k, b_i, b_t, out, out_t, out_cols);
  } else if (b_t > 0) {
    cws_encode_kernel<Regen, Emit, true><<<grid, block, 0, stream>>>(
        x, r, lc, be, k0, k1, n, d, k, b_i, b_t, out, out_t, out_cols);
  } else {
    cws_encode_kernel<Regen, Emit, false><<<grid, block, 0, stream>>>(
        x, r, lc, be, k0, k1, n, d, k, b_i, b_t, out, out_t, out_cols);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Row 2 of the TPU kernel table: stored params -> (n, k) int32 indices.
int cws_encode_launch(const float* x, const float* r, const float* lc,
                      const float* be, int n, int d, int k, int b_i, int b_t,
                      int32_t* out, cudaStream_t stream) {
  return launch<false, EMIT_INDEX>(x, r, lc, be, 0u, 0u, n, d, k, b_i, b_t,
                                   out, nullptr, k, stream);
}

// Row 1: regenerated params -> (n, k) int32 indices.
int cws_encode_rng_launch(const float* x, uint32_t k0, uint32_t k1, int n,
                          int d, int k, int b_i, int b_t, int32_t* out,
                          cudaStream_t stream) {
  return launch<true, EMIT_INDEX>(x, nullptr, nullptr, nullptr, k0, k1, n, d,
                                  k, b_i, b_t, out, nullptr, k, stream);
}

// Row 4: stored params -> (n, words) packed uint32.
int cws_encode_packed_launch(const float* x, const float* r, const float* lc,
                             const float* be, int n, int d, int k, int b_i,
                             int b_t, uint32_t* out, int words,
                             cudaStream_t stream) {
  return launch<false, EMIT_PACKED>(x, r, lc, be, 0u, 0u, n, d, k, b_i, b_t,
                                    out, nullptr, words, stream);
}

// Row 3's yardstick (the row runs on cws_regen_split.cu): regenerated
// params -> (n, words) packed uint32.
int cws_encode_rng_packed_launch(const float* x, uint32_t k0, uint32_t k1,
                                 int n, int d, int k, int b_i, int b_t,
                                 uint32_t* out, int words,
                                 cudaStream_t stream) {
  return launch<true, EMIT_PACKED>(x, nullptr, nullptr, nullptr, k0, k1, n,
                                   d, k, b_i, b_t, out, nullptr, words,
                                   stream);
}

// Row 5: stored params -> raw i* and t*, each (n, k) int32.
int cws_hash_launch(const float* x, const float* r, const float* lc,
                    const float* be, int n, int d, int k, int32_t* i_out,
                    int32_t* t_out, cudaStream_t stream) {
  return launch<false, EMIT_RAW>(x, r, lc, be, 0u, 0u, n, d, k, 0, 0, i_out,
                                 t_out, k, stream);
}

// Row 6's yardstick (the row runs on cws_regen_split.cu): regenerated
// params -> raw i* and t*, each (n, k) int32.
int cws_hash_rng_launch(const float* x, uint32_t k0, uint32_t k1, int n,
                        int d, int k, int32_t* i_out, int32_t* t_out,
                        cudaStream_t stream) {
  return launch<true, EMIT_RAW>(x, nullptr, nullptr, nullptr, k0, k1, n, d, k,
                                0, 0, i_out, t_out, k, stream);
}

}  // extern "C"
