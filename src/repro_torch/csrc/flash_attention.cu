// Flash-attention forward for Hopper (sm_90a), causal with an optional
// sliding window, GQA without repeating k/v:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / r] * scale) v[b, j, h / r]
// with q (B, Sq, H, D), k and v (B, Sk, G, D), r = H / G, scale = D^-1/2,
// over the keys visible from query row i: j < Sk, j <= i + q_base and, when
// window > 0, j > i + q_base - window.  fp32 or bf16 in, the same type out.
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_attention.py:
//   flash_attention_fwd_launch  <- flash_attention_fwd / _flash_kernel
//                                  (_block_update for one score tile)
//                                  (row 8 of the TPU kernel table)
//   flash_attention_step_launch <- flash_attention_step /
//                                  _flash_carry_kernel (row 9)
//
// Row 9 is the block-resumable variant the ring schedule chains over K/V
// shards: the same device body with CARRY = true.  Its k/v are one shard
// (b, sk, g, d) whose row 0 sits at global position k_base (the twin of
// q_base); key j is visible from query row i when j < sk (the shard's true
// length, the reference's k_valid: no key past the shard can alias the
// next shard's positions), k_base + j <= i + q_base and, with a window,
// k_base + j > i + q_base - window.  The block loads the running (m, l,
// acc) of its 64 rows from the fp32 carry (m, l of shape (b, sq, h, 1),
// acc (b, sq, h, d)) instead of (-1e30, 0, 0), walks only the 64-key
// tiles its rows can see (the reference's `needed`: k_off <= q_off +
// blk_q - 1, local k < k_valid and, with a window, k_off + blk_k - 1 >
// q_off - window), and writes the carry back un-normalized, with no
// division by l and no cast.  A shard that shows a block no key still
// takes the launch (as the reference's grid does) and writes the carry
// back as it came.  One difference from the reference, in rows only: a
// masked score contributes p = 0, not exp(-1e30 - m), so a row that has
// seen no visible key keeps l = 0 and acc = 0, where the reference leaves
// tile-dependent values that its next visible key multiplies by
// exp(-1e30 - m) = 0.  For every row that sees a key the two agree; a
// fully masked shard leaves every row's carry exactly as it came.
//
// Numerics, as the reference: q, k and v are widened to fp32 on load; the
// scores, the running (m, l, acc) of the online softmax and p . v stay in
// fp32 (p is never rounded to bf16); a masked score is the finite -1e30,
// not -inf.  A row whose first needed tile holds no visible key yet then
// gets exp(0) = 1 garbage in l and acc, which the first visible key wipes
// out with corr = exp(-1e30 - m) = 0 (with -inf the same tile would give
// exp(-inf + inf) = NaN).  The output is acc / max(l, 1e-30), rounded to
// the output type once.  Only the order of the fp32 sums differs.
//
// What bounds it on this card: operations.  Every visible (query, key)
// pair costs 2·D multiply-adds (q.k and p.v) on 4·D bytes of q, k, v and
// out per row, so at the model's lengths the work is hundreds of flops per
// byte.  This body keeps everything in fp32 FMAs on the SIMT lanes (the
// fp32-FMA ceiling is SMs x 128 lanes x 2 flops x clock): it is the route
// for fp32 q/k/v, and for bf16 at head dims the tensor-core body does not
// take.  bf16 at D in {64, 128, 192, 256} runs on flash_attention_wgmma.cu,
// wgmma on the tensor cores with p kept to fp32 accuracy as a bf16 hi + lo
// pair (kernels/flash_attention.py:flash_body routes).  Row 9 moves more
// bytes than row 8: the fp32 carry, 8 + 4·D bytes per (row, head), is
// read and written once a step; under a sliding window, where a shard
// shows each row at most `window` keys, that traffic is as large a bound
// as the work.
//
// What the design does about it: one block of 256 threads per (q tile of
// 64 rows, head, batch row); the grid runs the heaviest q tiles first.  The
// block walks only the 64-key tiles its mask needs (the reference's
// `needed` predicate, as a loop range), staging q once and each k/v tile
// through shared memory as fp32: q and k d-major, so a thread's 4 rows or 4
// keys are one 16-byte load; v row-major.  A thread owns a 4 x 4 tile of
// scores (4 query rows x 4 keys) and the same 4 rows of the output
// accumulator over D / 16 columns, in registers.  The row max and row sum
// reduce over the 16 lanes of a half-warp that share those rows
// (__shfl_xor_sync), so m, l and the correction stay in registers; p goes
// through shared memory, key-major, to the p . v loop.  At D = 256 the
// tiles take 217 KB of dynamic shared memory (one block per SM), set with
// cudaFuncAttributeMaxDynamicSharedMemorySize.  Ragged Sq and Sk are
// masked in the kernel (out-of-range rows and keys stage as zeros and are
// never written or counted), never padded by copies; element offsets are
// size_t (they reach 5e8).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int TX = 16, TY = 16;         // threads: keys/columns x rows
constexpr int THREADS = TX * TY;
constexpr int RQ = BQ / TY;             // 4 query rows per thread
constexpr int RK = BK / TX;             // 4 keys per thread
constexpr int LD = BQ + 4;              // stride of the d-major and p tiles
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "q and k tiles share the stride LD");
static_assert(RQ == 4 && RK == 4, "the tiles load as float4");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr size_t smem_floats(int d) {
  return static_cast<size_t>(d) * LD * 2      // q and k tiles, d-major
         + static_cast<size_t>(BK) * d        // v tile
         + static_cast<size_t>(BK) * LD;      // p tile, key-major
}

// Row `row` of a (B, S, heads, D) tensor at (batch bi, head hi): element 0.
template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, int bi, int row,
                                            int s, int heads, int hi, int d) {
  return base + ((static_cast<size_t>(bi) * s + row) * heads + hi) *
                    static_cast<size_t>(d);
}

// The running state of the online softmax, fp32: (m, l) of shape
// (b, sq, h, 1) and acc (b, sq, h, d), dense.  Row 8 passes none.
struct Carry {
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
};

// DPT: output columns per thread, ceil(D / 16) rounded up to an
// instantiated size; columns tx + 16 c at or past D are skipped.  CARRY:
// row 9 (load and store the carry, k rows at k_base) or row 8 (start from
// (-1e30, 0, 0), k_base = 0, write acc / l in T).
template <typename T, int DPT, bool CARRY>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Carry carry,
                 int sq, int sk, int h, int g, int d, int window,
                 int q_base, int k_base, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_qt = smem;                        // [d][LD]
  float* s_kt = s_qt + static_cast<size_t>(d) * LD;   // [d][LD]
  float* s_v = s_kt + static_cast<size_t>(d) * LD;    // [BK][d]
  float* s_pt = s_v + static_cast<size_t>(BK) * d;    // [BK][LD]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int hh = blockIdx.y, bi = blockIdx.z;
  const int kvh = hh / (h / g);

  // q tile, widened to fp32; rows past Sq stage as zeros
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int i = q0 + r;
    const T* src = i < sq ? row_ptr(q, bi, i, sq, h, hh, d) : nullptr;
    for (int c = lane; c < d; c += 32)
      s_qt[c * LD + r] = src ? to_f32(src[c]) : 0.0f;
  }

  float acc[RQ][DPT];
  float m_run[RQ], l_run[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.0f;
    const int i = q0 + ty * RQ + r;
    if (CARRY && i < sq) {
      // each thread loads the (m, l) of its rows and the acc columns it
      // will store back, so the carry may be updated in place
      const size_t row = (static_cast<size_t>(bi) * sq + i) * h + hh;
      m_run[r] = carry.m_in[row];
      l_run[r] = carry.l_in[row];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + TX * c;
        if (col < d) acc[r][c] = carry.acc_in[row * d + col];
      }
    }
  }

  // the local keys this tile's valid rows can see: [k_begin, k_end)
  const int q_first = q0 + q_base;
  const int q_last = min(q0 + BQ, sq) - 1 + q_base;
  const int k_end = min(sk, q_last + 1 - k_base);
  const int k_begin =
      window > 0 ? static_cast<int>(max(0LL, static_cast<long long>(q_first) -
                                                  window + 1 - k_base))
                 : 0;

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's reads of s_kt, s_v, s_pt are done
    for (int r = warp; r < BK; r += THREADS / 32) {
      const int j = k0 + r;
      const T* ks = j < sk ? row_ptr(k, bi, j, sk, g, kvh, d) : nullptr;
      const T* vs = j < sk ? row_ptr(v, bi, j, sk, g, kvh, d) : nullptr;
      for (int c = lane; c < d; c += 32) {
        s_kt[c * LD + r] = ks ? to_f32(ks[c]) : 0.0f;
        s_v[r * d + c] = vs ? to_f32(vs[c]) : 0.0f;
      }
    }
    __syncthreads();

    // scores of rows ty*4.. against keys tx*4..
    float s[RQ][RK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < RK; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(s_qt + c * LD + ty * RQ);
      const float4 ka = *reinterpret_cast<const float4*>(s_kt + c * LD + tx * RK);
      const float qv[RQ] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[RK] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int cc = 0; cc < RK; ++cc) s[r][cc] = fmaf(qv[r], kv[cc], s[r][cc]);
    }

    // mask, then the online softmax; each row lives on 16 lanes (tx)
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int pos = q0 + ty * RQ + r + q_base;
      float mx = NEG_INF;
      bool ok[RK];
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        const int j = k0 + tx * RK + c;
        const int jg = k_base + j;
        ok[c] = j < sk && jg <= pos && (window <= 0 || jg > pos - window);
        s[r][c] = ok[c] ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      const float corr = expf(m_run[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        // row 9: a masked key adds nothing, even to a row that has seen
        // no key yet (see the header)
        s[r][c] = CARRY && !ok[c] ? 0.0f : expf(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[r] = corr * l_run[r] + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[r][c] *= corr;
    }
#pragma unroll
    for (int c = 0; c < RK; ++c)
      *reinterpret_cast<float4*>(s_pt + (tx * RK + c) * LD + ty * RQ) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc += p . v over this tile's in-range keys (past Sk, v is zero)
    const int kn = min(BK, sk - k0);
    for (int j = 0; j < kn; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(s_pt + j * LD + ty * RQ);
      const float pv[RQ] = {pa.x, pa.y, pa.z, pa.w};
      const float* vr = s_v + j * d;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + TX * c;
        const float vv = col < d ? vr[col] : 0.0f;
#pragma unroll
        for (int r = 0; r < RQ; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

  // every lane of a row has read its (m, l) before any lane writes them
  if (CARRY) __syncthreads();
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = q0 + ty * RQ + r;
    if (i >= sq) continue;
    if (CARRY) {
      // un-normalized, fp32: the next ring step resumes from it
      const size_t row = (static_cast<size_t>(bi) * sq + i) * h + hh;
      if (tx == 0) {
        carry.m_out[row] = m_run[r];
        carry.l_out[row] = l_run[r];
      }
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + TX * c;
        if (col < d) carry.acc_out[row * d + col] = acc[r][c];
      }
      continue;
    }
    const float lm = fmaxf(l_run[r], 1e-30f);
    T* dst = out + ((static_cast<size_t>(bi) * sq + i) * h + hh) *
                       static_cast<size_t>(d);
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + TX * c;
      if (col < d) dst[col] = from_f32<T>(acc[r][c] / lm);
    }
  }
}

template <typename T, int DPT, bool CARRY>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Carry& carry, int b, int sq, int sk, int h, int g,
                   int d, int window, int q_base, int k_base, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(d) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DPT, CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), carry, sq, sk, h, g,
      d, window, q_base, k_base, scale);
  return cudaGetLastError();
}

template <typename T, bool CARRY>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     const Carry& carry, int b, int sq, int sk, int h, int g,
                     int d, int window, int q_base, int k_base, float scale,
                     cudaStream_t stream) {
  const int cols = (d + TX - 1) / TX;
#define FLASH_CASE(N)                                                      \
  if (cols <= N)                                                           \
    return launch<T, N, CARRY>(q, k, v, out, carry, b, sq, sk, h, g, d,    \
                               window, q_base, k_base, scale, stream);
  FLASH_CASE(1)
  FLASH_CASE(2)
  FLASH_CASE(4)
  FLASH_CASE(8)
  FLASH_CASE(12)
  FLASH_CASE(16)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

// The instantiation the launchers run for head dim d, bf16 or fp32 and
// the carry; null for a d they refuse.
template <typename T, bool CARRY>
const void* kernel_cols(int d) {
  const int cols = (d + TX - 1) / TX;
#define FLASH_KERNEL(N) \
  if (cols <= N) return reinterpret_cast<const void*>(flash_fwd_kernel<T, N, CARRY>);
  FLASH_KERNEL(1)
  FLASH_KERNEL(2)
  FLASH_KERNEL(4)
  FLASH_KERNEL(8)
  FLASH_KERNEL(12)
  FLASH_KERNEL(16)
#undef FLASH_KERNEL
  return nullptr;
}

const void* kernel_of(int d, int bf16, int carry) {
  if (d <= 0 || d > MAX_D) return nullptr;
  if (bf16)
    return carry ? kernel_cols<__nv_bfloat16, true>(d)
                 : kernel_cols<__nv_bfloat16, false>(d);
  return carry ? kernel_cols<float, true>(d) : kernel_cols<float, false>(d);
}

}  // namespace

extern "C" {

// Queries for the kernel contracts (host code only): the dynamic shared
// memory a launch at head dim d sets, the instantiation's attributes (out:
// static shared bytes, registers, local bytes, max threads, max dynamic
// shared bytes) and the blocks an SM holds at its launch.
int flash_simt_smem_bytes(int d) {
  if (d <= 0 || d > MAX_D) return -1;
  return static_cast<int>(smem_floats(d) * sizeof(float));
}

int flash_simt_attributes(int d, int bf16, int carry, int* out) {
  const void* kernel = kernel_of(d, bf16, carry);
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

int flash_simt_occupancy(int d, int bf16, int carry, int* blocks) {
  const void* kernel = kernel_of(d, bf16, carry);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int smem = flash_simt_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       THREADS, smem);
}

// Row 8 of the TPU kernel table.  q (b, sq, h, d), k and v (b, sk, g, d)
// and out (b, sq, h, d), all dense, fp32 (bf16 = 0) or bf16 (bf16 = 1).
// Returns the launch's cudaError_t (a refused launch never runs).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int sk, int h, int g,
                               int d, int window, int q_base, float scale,
                               int bf16, cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return cudaSuccess;
  if (d <= 0 || d > MAX_D || g <= 0 || h % g != 0 || sk < 0 || q_base < 0 ||
      h > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  const Carry none = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return bf16 ? dispatch<__nv_bfloat16, false>(q, k, v, out, none, b, sq, sk,
                                               h, g, d, window, q_base, 0,
                                               scale, stream)
              : dispatch<float, false>(q, k, v, out, none, b, sq, sk, h, g,
                                       d, window, q_base, 0, scale, stream);
}

// Row 9 of the TPU kernel table.  q (b, sq, h, d) and the k/v shard
// (b, sk, g, d), dense, fp32 (bf16 = 0) or bf16 (bf16 = 1); the carry fp32:
// m_in, l_in, m_out, l_out (b, sq, h), acc_in, acc_out (b, sq, h, d).  The
// out pointers may equal the in pointers (each thread stores only what it
// loaded).  Returns the launch's cudaError_t.
int flash_attention_step_launch(const void* q, const void* k, const void* v,
                                const float* m_in, const float* l_in,
                                const float* acc_in, float* m_out,
                                float* l_out, float* acc_out, int b, int sq,
                                int sk, int h, int g, int d, int window,
                                int q_base, int k_base, float scale, int bf16,
                                cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return cudaSuccess;
  if (d <= 0 || d > MAX_D || g <= 0 || h % g != 0 || sk < 0 || q_base < 0 ||
      k_base < 0 || h > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  const Carry carry = {m_in, l_in, acc_in, m_out, l_out, acc_out};
  return bf16 ? dispatch<__nv_bfloat16, true>(q, k, v, nullptr, carry, b, sq,
                                              sk, h, g, d, window, q_base,
                                              k_base, scale, stream)
              : dispatch<float, true>(q, k, v, nullptr, carry, b, sq, sk, h,
                                      g, d, window, q_base, k_base, scale,
                                      stream);
}

}  // extern "C"
