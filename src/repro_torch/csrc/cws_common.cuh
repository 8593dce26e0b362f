// Device arithmetic of the CWS kernels (cws_split.cu): the counter-based
// parameter regeneration, the per-(row, d, hash) step, the t* clip and the
// b-bit code.
//
// Bit-exactness with the reference (integers must match exactly): build
// WITHOUT --use_fast_math and WITH --fmad=false; the arithmetic below also
// spells out round-to-nearest IEEE division, multiply and add, in the
// reference's order.  logf / log1pf / floorf, not the __logf intrinsics.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace cws {

constexpr uint32_t STREAM_R = 0x243F6A89u;
constexpr uint32_t STREAM_C = 0x85A308D3u;
constexpr uint32_t STREAM_BETA = 0x13198A2Fu;
constexpr uint32_t THREEFRY_PARITY = 0x1BD11BDAu;
constexpr float T_CLIP = 1073741824.0f;   // t* is clipped to +-2^30

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// Threefry-2x32, 20 rounds (repro/core/regen.py:threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ THREEFRY_PARITY};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// Top 24 bits -> fp32 uniform in [0, 1), exact.
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ float exp1(float u) { return -log1pf(-u); }

// (r, log c, beta) at global coordinate (d, h) (repro/core/regen.py:regen_tile).
__device__ __forceinline__ void regen_param(uint32_t k0, uint32_t k1,
                                            uint32_t d, uint32_t h, float& r,
                                            float& lc, float& be) {
  uint32_t u0 = d, u1 = h;
  threefry2x32(k0, k1 ^ STREAM_R, u0, u1);
  r = fmaxf(__fadd_rn(exp1(uniform24(u0)), exp1(uniform24(u1))), 1e-12f);
  u0 = d;
  u1 = h;
  threefry2x32(k0, k1 ^ STREAM_C, u0, u1);
  const float c = __fadd_rn(exp1(uniform24(u0)), exp1(uniform24(u1)));
  lc = logf(fmaxf(c, 1e-38f));
  u0 = d;
  u1 = h;
  threefry2x32(k0, k1 ^ STREAM_BETA, u0, u1);
  be = uniform24(u0);
}

// log of a positive entry, -inf for a zero, NaN or negative one.
__device__ __forceinline__ float log_entry(float v) {
  return v > 0.0f ? logf(fmaxf(v, 1e-38f)) : -INFINITY;
}

// One (row, d, hash) step: tt = floor(lu / r + be) and
// la = lc - r * (tt - be + 1), each operation rounded as the reference does.
__device__ __forceinline__ void step(float lu, float r, float lc, float be,
                                     float& tt, float& la) {
  tt = floorf(__fadd_rn(__fdiv_rn(lu, r), be));
  la = __fsub_rn(lc, __fmul_rn(r, __fadd_rn(__fsub_rn(tt, be), 1.0f)));
}

// t* as the raw emit stores it: clipped to +-2^30, 0 for an all-zero row.
__device__ __forceinline__ int32_t clip_t(int best_i, float best_t) {
  return best_i < 0 ? 0
                    : static_cast<int32_t>(
                          fminf(fmaxf(best_t, -T_CLIP), T_CLIP));
}

// The b-bit code of one (row, hash) (repro/kernels/cws_hash.py:
// _encode_emit): b_i low bits of i* (all of it for b_i = 0), then b_t bits
// of the clipped t*; an all-zero row maps to bucket 0.
template <bool TrackT>
__device__ __forceinline__ int code_of(int best_i, float best_t, int b_i,
                                       int b_t) {
  if (best_i < 0) return 0;
  int code = b_i ? (best_i & ((1 << b_i) - 1)) : best_i;
  if (TrackT)
    code = code * (1 << b_t) + (clip_t(best_i, best_t) & ((1 << b_t) - 1));
  return code;
}

}  // namespace cws
