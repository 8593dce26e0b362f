// Min-sum Gram kernel for Hopper (sm_90a):
//   S[m, n] = sum_d min(x[m, d], y[n, d]),  x (M, D), y (N, D) fp32 -> (M, N) fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/minmax_gram.py:
//   min_sum_launch  <- _min_sum_pallas / _minsum_kernel
// (reached by min_sum_pallas and _minmax_gram_pallas).  As in the
// reference, the min-max epilogue K = S / max(sum x + sum y - S, 1e-30)
// stays outside the kernel, in PyTorch (repro_torch/kernels/minmax_gram.py).
//
// What bounds it on this card: operations.  Every (m, n, d) costs one min
// and one add (2·M·N·D fp32 operations) on 4·(M + N)·D bytes in and
// 4·M·N bytes out; min is not a tensor-core operation, so the ceiling is
// the SIMT lanes' issue rate, not the HBM rate (at (12,000, 12,000, 784)
// the operations take some 7 ms at that rate, the bytes 0.18 ms).
//
// What the design does about it: a register-tiled SIMT "GEMM" with fminf
// and an IEEE add in place of the FMA.  A block of 16 x 16 threads owns a
// 64 x 64 output tile and walks all of D itself (the TPU grid carried the
// sum across sequential D steps in VMEM; blocks here run in no order, so
// none carries anything to another).  Per chunk of BD = 32 dimensions the
// block stages x and y transposed into shared memory (d-major, so a
// thread's 4 rows or 4 columns are one 16-byte load), then each thread
// updates its 4 x 4 register micro-tile: per d, two 16-byte shared loads
// feed 16 min + 16 add.  Each sum runs over d in ascending order from 0.
// Ragged M, N and D edges are masked by bounds (the D tail of the last
// chunk is not walked at all), never padded; offsets are size_t, since
// M·N reaches 1.44e8 at the timing shape.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RM = 4, RN = 4;          // outputs per thread (rows x cols)
constexpr int TY = 16, TX = 16;        // threads per block (y x x)
constexpr int TM = TY * RM;            // 64 rows of x per block
constexpr int TN = TX * RN;            // 64 rows of y per block
constexpr int BD = 32;                 // dimensions per shared-memory chunk
constexpr int THREADS = TX * TY;
constexpr int LD = TM + 4;             // row stride: 16-byte aligned rows

static_assert(TM == TN, "the staging loop fills x and y tiles together");

__device__ __forceinline__ void accum(float (&acc)[RM][RN],
                                      const float* xs, const float* ys) {
  const float4 xv = *reinterpret_cast<const float4*>(xs);
  const float4 yv = *reinterpret_cast<const float4*>(ys);
  const float xa[RM] = {xv.x, xv.y, xv.z, xv.w};
  const float ya[RN] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      acc[i][j] = __fadd_rn(acc[i][j], fminf(xa[i], ya[j]));
}

__global__ void __launch_bounds__(THREADS)
min_sum_kernel(const float* __restrict__ x, const float* __restrict__ y,
               int m, int n, int d, float* __restrict__ out) {
  __shared__ __align__(16) float s_x[BD][LD];
  __shared__ __align__(16) float s_y[BD][LD];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < d; d0 += BD) {
    // consecutive threads read consecutive d of one row: coalesced
    for (int e = tid; e < TM * BD; e += THREADS) {
      const int rr = e / BD, dd = e % BD;
      const int gd = d0 + dd, gm = m0 + rr, gn = n0 + rr;
      s_x[dd][rr] = (gm < m && gd < d) ? x[static_cast<size_t>(gm) * d + gd]
                                       : 0.0f;
      s_y[dd][rr] = (gn < n && gd < d) ? y[static_cast<size_t>(gn) * d + gd]
                                       : 0.0f;
    }
    __syncthreads();

    const int dn = min(BD, d - d0);
    if (dn == BD) {
#pragma unroll 8
      for (int dd = 0; dd < BD; ++dd)
        accum(acc, &s_x[dd][ty * RM], &s_y[dd][tx * RN]);
    } else {
      for (int dd = 0; dd < dn; ++dd)
        accum(acc, &s_x[dd][ty * RM], &s_y[dd][tx * RN]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + ty * RM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = n0 + tx * RN + j;
      if (gn < n) out[static_cast<size_t>(gm) * n + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Row 7 of the TPU kernel table: x (m, d), y (n, d) -> S (m, n) fp32.
// The caller keeps ceil(m / 64) within the grid's y limit (65,535).
int min_sum_launch(const float* x, const float* y, int m, int n, int d,
                   float* out, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  const dim3 block(TX, TY);
  min_sum_kernel<<<grid, block, 0, stream>>>(x, y, m, n, d, out);
  return cudaGetLastError();
}

}  // extern "C"
