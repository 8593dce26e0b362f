// Flash-attention forward for Hopper's tensor cores (sm_90a), bf16 q/k/v,
// head dim D in {64, 128, 192, 256}: the same function and contracts as
// flash_attention.cu, whose SIMT body stays the route for fp32 and for
// every other D.
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_attention.py:
//   flash_attention_wgmma_fwd_launch  <- :117 flash_attention_fwd /
//                                        :80 _flash_kernel (row 8)
//   flash_attention_wgmma_step_launch <- :218 flash_attention_step /
//                                        :171 _flash_carry_kernel (row 9)
//
// The function, for q (B, Sq, H, D) and k, v (B, Sk, G, D), r = H / G,
// scale = D^-1/2: key j is visible from query row i when j < Sk,
// k_base + j <= i + q_base and, with window > 0, k_base + j > i + q_base -
// window (row 8 has k_base = 0).  Row 8 writes acc / max(l, 1e-30) in bf16,
// rounded once.  Row 9 folds the shard into the fp32 carry (m, l of shape
// (B, Sq, H), acc (B, Sq, H, D)), read and written un-normalized in place:
// each thread stores only what it loaded, so the out pointers may equal the
// in pointers.  As in the SIMT body, a masked score is the finite -1e30; in
// row 9 a masked key adds p = 0, so a shard that a row cannot see leaves
// its carry bit for bit, and in row 8 the garbage exp(0) = 1 that a row's
// leading all-masked tile leaves is wiped by its first visible key
// (corr = exp(-1e30 - m) = 0).  Each block walks only the 64-key tiles its
// rows need (the reference's `needed`), heaviest q tiles first.
//
// Numerics.  S = Q K^T by wgmma on bf16 inputs with an fp32 accumulator:
// the products of two bf16 values are exact in fp32, as the SIMT body's
// widened FMAs are; only the order of the sums differs.  Scale, mask,
// running max m, corr and l stay fp32 in registers.  p = exp(s - m) is fp32,
// computed as 2^((s - m) log2 e) on the special-function unit (relative
// error about 2^-22; corr is exactly 1 where m does not move).  The tensor
// cores take 16-bit A operands, so p goes in as two bf16 terms, hi =
// bf16(p) and lo = bf16(p - hi): hi + lo holds p to 2^-17 relative, and
// hi.V and lo.V are each exact products in fp32, so acc = corr.acc + hi.V +
// lo.V keeps the reference's fp32 p within the tolerances the SIMT body is
// held to.  One bf16 p alone would add errors of order 2^-9 of sum p|v| / l
// (tests/test_torch_flash_wgmma_numerics.py measures both).  l sums the
// fp32 p.
//
// What bounds it on this card: operations.  Every visible (query, key)
// pair costs 4·D flops of products in the function (q.k and p.v), 6·D here
// (p.v twice, hi and lo), so this design's own floor is 1.5x the bf16
// tensor-core bound; bytes are q, k, v and out once (row 9 adds the fp32
// carry, 8 + 4·D bytes a row and head, in and out, which under a window
// weighs about as much as the work).
//
// What the design does about it.  A block of three warpgroups: warpgroup 0
// is the producer (one thread issues TMA loads; setmaxnreg gives its
// registers to the consumers), warpgroups 1 and 2 are consumers, each
// owning 64 query rows and their fp32 accumulator in wgmma registers.  With
// GQA (r >= 2) the two consumers take two query heads of one kv head at
// the same rows, so they share the tile range and each K/V tile is loaded
// once for both; an odd r leaves the last pair one consumer.  With r = 1
// they take two consecutive 64-row q tiles of one head, and the producer
// loads the union of their tile ranges (a consumer waits for, and hands
// back, a tile outside its own range without computing on it).  Q is
// loaded once; K and V tiles go through rings of 2-4 stages (D = 256:
// Q 64 KB + 2 x (32 + 32) KB of shared memory), filled by TMA over 4-D
// tensor maps (D, heads, S, B) with 128-byte swizzle and 64-element boxes,
// so rows past S arrive as zeros and a tile never reads another batch row,
// and synchronised by mbarriers (full: TMA bytes arrived; empty: every
// consumer thread done with the stage), K's and V's apart, so a K stage
// goes back to the producer as soon as S is done.  Q K^T is D / 16 wgmma
// m64n64k16 from shared memory, both K-major; p.V is, for each 16-key step,
// one m64n{D}k16 for hi and one for lo, p from registers (the S
// accumulator's layout is the A fragment's) and V from shared memory
// MN-major (transpose bit).  A tile that every row of a consumer sees
// whole skips the mask arithmetic, and a row whose max did not move skips
// the rescale of its accumulator.
//
// The softmax between the two products is the work the tensor cores wait
// on, so it is kept short and overlapped: the mask is a 32-bit word built
// without branches (skipped for whole tiles), exp runs on the SFU, and each
// consumer's loop is software-pipelined, its softmax running under its own
// p.V and, when the two consumers take turns, under the other's products.
// The A fragments of p are written only after the wait that retires the
// p.V reading the previous ones: ptxas serialises every wgmma of a kernel
// in which a register an in-flight wgmma may read is redefined (C7513).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int BQ = 64;              // query rows per consumer warpgroup
constexpr int BK = 64;              // keys per tile
constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int BOX_BYTES = 64 * 128; // one 64-row x 64-element bf16 box
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr int tile_bytes(int d) { return 128 * d; }
__host__ __device__ constexpr int stages_for(int d) {
  return (SMEM_LIMIT - 2048 - 2 * tile_bytes(d)) / (2 * tile_bytes(d)) < 4
             ? (SMEM_LIMIT - 2048 - 2 * tile_bytes(d)) / (2 * tile_bytes(d))
             : 4;
}
// Q of both consumers, the K and V stages, the barriers, and 1 KB to align
// the base to the 128-byte swizzle's 1,024-byte period
__host__ __device__ constexpr int smem_bytes(int d) {
  return 2 * tile_bytes(d) + 2 * stages_for(d) * tile_bytes(d) + 1024 + 1024;
}

struct Carry {
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
};

// one 64 x 64 box of a (D, heads, S, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, in 16-byte units.  K-major (q, k): 8-row groups
// 1,024 bytes apart, the leading offset unused.  MN-major (v, N = D):
// 64-element swizzle atoms along N one 64 x 64 box (8 KB) apart (leading),
// 8-key groups 1,024 bytes apart (stride).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc(addr, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight (they complete in
// order)
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define R0_31                                                             \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define R32_63                                                            \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63"
#define R64_95                                                            \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, " \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95"
#define R96_127                                                           \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "   \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "     \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127"
#define WGMMA_OUT32(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),             \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
      "+f"(d[30]), "+f"(d[31])

// d (64 x 64, fp32) (+)= A (64 x 16) . B (16 x 64)^T, both from shared
// memory, K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R0_31 "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, fp32, as N / 64 rows of 32 registers) += A (64 x 16, bf16
// fragments in registers) . B, B (16 x N) from shared memory MN-major
// (transpose bit set)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 64][32],
                                         const uint32_t (&a)[4], uint64_t db);
#define WGMMA_RS(N, REGS, A, DB, SC, ...)                                  \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_rs<N>(                             \
      float(&d)[N / 64][32], const uint32_t(&a)[4], uint64_t db) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                    \
                 "k16.f32.bf16.bf16 {" REGS "}, " A ", %" #DB              \
                 ", p, 1, 1, 1;\n}\n"                                       \
                 : __VA_ARGS__                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),    \
                   "r"(1));                                                \
  }
WGMMA_RS(64, R0_31, "{%32, %33, %34, %35}", 36, 37, WGMMA_OUT32(d[0]))
WGMMA_RS(128, R0_31 ", " R32_63, "{%64, %65, %66, %67}", 68, 69,
         WGMMA_OUT32(d[0]), WGMMA_OUT32(d[1]))
WGMMA_RS(192, R0_31 ", " R32_63 ", " R64_95, "{%96, %97, %98, %99}", 100,
         101, WGMMA_OUT32(d[0]), WGMMA_OUT32(d[1]), WGMMA_OUT32(d[2]))
WGMMA_RS(256, R0_31 ", " R32_63 ", " R64_95 ", " R96_127,
         "{%128, %129, %130, %131}", 132, 133, WGMMA_OUT32(d[0]),
         WGMMA_OUT32(d[1]), WGMMA_OUT32(d[2]), WGMMA_OUT32(d[3]))
#undef WGMMA_RS

// Pin an accumulator's registers at this point of the program, so the
// compiler moves none of them while a wgmma that writes them is in flight.
__device__ __forceinline__ void fence_operand(float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// Named barriers 1 and 2 (0 is __syncthreads): the two consumer warpgroups'
// turns at the tensor cores.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// e^x for x <= 0 as 2^(x log2 e) on the special-function unit
// (ex2.approx.ftz: relative error about 2^-22, below the 2^-17 to which
// hi + lo holds p); e^(-1e30 - m) flushes to 0
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The 64-key tiles [begin, end) that query rows [r0, r1) of a block see.
__device__ __forceinline__ void tile_range(int r0, int r1, int sk, int window,
                                           int q_base, int k_base, int& begin,
                                           int& end) {
  const int q_first = r0 + q_base;
  const int q_last = r1 - 1 + q_base;
  const int k_end = min(sk, q_last + 1 - k_base);
  const int k_begin =
      window > 0 ? static_cast<int>(max(0LL, static_cast<long long>(q_first) -
                                                 window + 1 - k_base))
                 : 0;
  begin = k_begin / BK;
  end = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  if (end < begin) end = begin;
}

// D: head dim (64, 128, 192, 256).  CARRY: row 9 (load and store the fp32
// carry) or row 8 (start from (-1e30, 0, 0), write acc / l in bf16).
// pair_rows: r = 1, the consumers take rows q0 and q0 + 64 of one head;
// else two heads of one kv head at rows q0.
template <int D, bool CARRY>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ out, Carry carry, int sq,
                   int sk, int h, int g, int window, int q_base, int k_base,
                   float scale, int pair_rows) {
  constexpr int NB = D / 64;   // 64-element boxes; acc rows of 32 registers
  constexpr int ST = stages_for(D);
  constexpr int TILE = tile_bytes(D);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_q = base;                       // [2][NB][64 x 128 B]
  const uint32_t s_k = s_q + 2 * TILE;             // [ST][NB][64 x 128 B]
  const uint32_t s_v = s_k + ST * TILE;            // [ST][NB][64 x 128 B]
  const uint32_t bars = s_v + ST * TILE;           // 4 rings of ST, then q
  const uint32_t bar_q = bars + 32 * ST;

  const int tid = threadIdx.x;
  const int bi = blockIdx.z;
  const int r = h / g;
  // the two consumers' heads and first rows, and which of them has work
  int head[2], row0[2];
  bool active[2];
  if (pair_rows) {
    const int q0 = (gridDim.x - 1 - blockIdx.x) * 2 * BQ;  // heaviest first
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      head[c] = blockIdx.y;
      row0[c] = q0 + c * BQ;
      active[c] = row0[c] < sq;
    }
  } else {
    const int pairs = (r + 1) / 2;
    const int kvh = blockIdx.y / pairs, pair = blockIdx.y % pairs;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      head[c] = kvh * r + 2 * pair + c;
      row0[c] = q0;
      active[c] = 2 * pair + c < r;
    }
  }
  const int kvh = head[0] / r;
  int begin[2], end[2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
    tile_range(row0[c], min(row0[c] + BQ, sq), sk, window, q_base, k_base,
               begin[c], end[c]);
  // the union of the active consumers' ranges: what the producer loads
  const int u_begin = active[1] ? min(begin[0], begin[1]) : begin[0];
  const int u_end = active[1] ? max(end[0], end[1]) : end[0];
  const int n_tiles = u_end > u_begin ? u_end - u_begin : 0;
  const int n_active = active[1] ? 2 : 1;

  // four rings of ST barriers: K full, K empty, V full, V empty; then Q's
  auto bar = [&](int ring, int it) { return bars + 8 * (ring * ST + it % ST); };
  enum { K_FULL, K_EMPTY, V_FULL, V_EMPTY };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar(K_FULL, s), 1);
      mbar_init(bar(K_EMPTY, s), 128 * n_active);
      mbar_init(bar(V_FULL, s), 1);
      mbar_init(bar(V_EMPTY, s), 128 * n_active);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the ring phase of iteration `it` (a stage's first fill is phase 0)
  auto phase = [&](int it) { return (it / ST) & 1; };

  if (tid < 128) {
    // producer warpgroup: one thread keeps the K and V stages filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, n_active * TILE);
      for (int c = 0; c < n_active; ++c)
        for (int j = 0; j < NB; ++j)
          tma_load(s_q + c * TILE + j * BOX_BYTES, &q_map, 64 * j, head[c],
                   row0[c], bi, bar_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST, k0 = (u_begin + it) * BK;
        mbar_wait(bar(K_EMPTY, it), phase(it) ^ 1);
        mbar_expect_tx(bar(K_FULL, it), TILE);
        for (int j = 0; j < NB; ++j)
          tma_load(s_k + s * TILE + j * BOX_BYTES, &k_map, 64 * j, kvh, k0,
                   bi, bar(K_FULL, it));
        mbar_wait(bar(V_EMPTY, it), phase(it) ^ 1);
        mbar_expect_tx(bar(V_FULL, it), TILE);
        for (int j = 0; j < NB; ++j)
          tma_load(s_v + s * TILE + j * BOX_BYTES, &v_map, 64 * j, kvh, k0,
                   bi, bar(V_FULL, it));
      }
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = tid / 128 - 1;
  if (!active[c]) return;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int hh = head[c];
  const int q0 = row0[c];
  // this thread's rows of the tile (the wgmma accumulator layout): rr[0]
  // and rr[0] + 8; columns 8 i + 2 (lane % 4) + {0, 1} of each 8-column
  // chunk i
  const int rr[2] = {16 * warp + lane / 4, 16 * warp + lane / 4 + 8};
  const int col0 = 2 * (lane % 4);
  const bool leader = lane % 4 == 0;

  float acc[NB][32];
  float m_run[2], l_run[2];   // l_run: this thread's share of the row sum
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    m_run[x] = NEG_INF;
    l_run[x] = 0.0f;
    if (CARRY) {
      // the quad's leader loads (m, l) and stores them back; every thread
      // loads the acc columns it stores back
      const int i = q0 + rr[x];
      const size_t row = (static_cast<size_t>(bi) * sq + i) * h + hh;
      float m = NEG_INF;
      if (i < sq) {
        if (leader) {
          m = carry.m_in[row];
          l_run[x] = carry.l_in[row];
        }
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int ch = 0; ch < 8; ++ch)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[j][4 * ch + 2 * x + e] =
                  carry.acc_in[row * D + 64 * j + 8 * ch + col0 + e];
      }
      m_run[x] = __shfl_sync(0xffffffffu, m, lane & ~3);
    }
  }

  const int pos_first = q0 + q_base;
  const int pos_last = min(q0 + BQ, sq) - 1 + q_base;
  if (n_tiles > 0) mbar_wait(bar_q, 0);
  const uint32_t q_smem = s_q + c * TILE;

  // S = Q K^T of iteration `it` into sc, issued and committed
  auto issue_scores = [&](int it, float (&sc)[32]) {
    const uint32_t k_smem = s_k + (it % ST) * TILE;
    fence_operand(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss(sc, desc_k_major(q_smem + off), desc_k_major(k_smem + off),
               kk > 0);
    }
    wgmma_commit();
  };
  // acc += hi.V + lo.V of iteration `it`, issued and committed
  auto issue_pv = [&](int it, const uint32_t (&hi)[4][4],
                      const uint32_t (&lo)[4][4]) {
    const uint32_t v_smem = s_v + (it % ST) * TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_mn_major(v_smem + kk * 16 * 128);
      wgmma_rs<D>(acc, hi[kk], dv);
      wgmma_rs<D>(acc, lo[kk], dv);
    }
    wgmma_commit();
  };
  // the online softmax of the scores sc of key tile `tile`: updates m_run
  // and l_run, returns corr, and leaves the fp32 p in sc
  auto softmax = [&](int tile, float (&sc)[32], float (&corr)[2]) {
    const int k0 = tile * BK;
    // bit i of `seen`: the key of score sc[i] is visible from its row (it
    // lies before Sk, at or before the row's position and inside its
    // window); all set for a tile every row of this consumer sees whole
    const bool whole = k0 + BK <= sk && k_base + k0 + BK - 1 <= pos_first &&
                       (window <= 0 || k_base + k0 > pos_last - window);
    uint32_t seen = 0xffffffffu;
    float mx[2] = {NEG_INF, NEG_INF};
    if (whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] *= scale;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    } else {
      seen = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int x = (i >> 1) & 1, j = k0 + 8 * (i / 4) + col0 + (i & 1);
        const int jg = k_base + j, pos = q0 + rr[x] + q_base;
        const bool ok = (j < sk) & (jg <= pos) &
                        ((window <= 0) | (jg > pos - window));
        seen |= static_cast<uint32_t>(ok) << i;
        sc[i] = ok ? sc[i] * scale : NEG_INF;
        mx[x] = fmaxf(mx[x], sc[i]);
      }
    }
    float m_new[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      m_new[x] = fmaxf(m_run[x], mx[x]);
      corr[x] = m_new[x] == m_run[x] ? 1.0f : exp_sfu(m_run[x] - m_new[x]);
      m_run[x] = m_new[x];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1;
      // row 9: a masked key adds nothing, even to a row that has seen no
      // key yet
      sc[i] = CARRY && !((seen >> i) & 1) ? 0.0f : exp_sfu(sc[i] - m_new[x]);
      sum[x] += sc[i];
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) l_run[x] = corr[x] * l_run[x] + sum[x];
  };
  // p split into bf16 hi + lo as the A fragments of the four 16-key steps:
  // register q of step kk holds columns 16 kk + 8 (q / 2) + col0 + {0, 1}
  // of row rr[q % 2], i.e. p[8 kk + 2 q] and p[8 kk + 2 q + 1], the lower
  // column in the low half
  auto split = [&](const float (&p)[32], uint32_t (&hi)[4][4],
                   uint32_t (&lo)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e0 = 8 * kk + 2 * q;
        const __nv_bfloat162 h = __floats2bfloat162_rn(p[e0], p[e0 + 1]);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 l = __floats2bfloat162_rn(p[e0] - hf.x,
                                                       p[e0 + 1] - hf.y);
        hi[kk][q] = *reinterpret_cast<const uint32_t*>(&h);
        lo[kk][q] = *reinterpret_cast<const uint32_t*>(&l);
      }
  };
  // acc *= corr, skipped where corr = 1 (the row max did not move)
  auto rescale = [&](const float (&corr)[2]) {
    if (corr[0] != 1.0f || corr[1] != 1.0f) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[j][e] *= corr[(e >> 1) & 1];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_operand(acc[j]);
  };
  // a tile outside this consumer's range: wait for it and hand it back
  auto pass = [&](int it) {
    mbar_wait(bar(K_FULL, it), phase(it));
    mbar_arrive(bar(K_EMPTY, it));
    mbar_wait(bar(V_FULL, it), phase(it));
    mbar_arrive(bar(V_EMPTY, it));
  };

  // this consumer's own tiles are iterations [first, last) of the block's
  // n_tiles.  Software-pipelined: iteration it issues S(it) and p.V(it - 1)
  // together and runs the softmax of S(it) while the tensor cores work on
  // p.V(it - 1).  The A fragments of p(it) are written only after the wait
  // that retires p.V(it - 1) (a register a wgmma in flight may read is
  // never redefined), then acc is rescaled.  K goes back as soon as S is
  // done, V once p.V is.  Each tile's arithmetic, and its order, is the
  // unpipelined loop's.  When both consumers walk the same tiles they take
  // turns issuing their products (consumer c after named barrier 1 + c,
  // then it lets the other go), so one's softmax runs under the other's
  // products instead of both waiting on the tensor cores at once.
  const int first = begin[c] - u_begin, last = end[c] - u_begin;
  const bool turns = active[1] && begin[0] == begin[1] &&
                     end[0] == end[1] && last > first;
  const int n_turns = last - first + 1;   // prologue, iterations, epilogue
  int turn = 0;
  auto take_turn = [&]() {
    if (turns) named_sync(1 + c);
  };
  auto pass_turn = [&]() {   // consumer 1's last turn hands over to no one
    if (turns && !(c == 1 && ++turn == n_turns)) named_arrive(2 - c);
  };
  if (turns && c == 1) named_arrive(1);   // consumer 0 goes first
  int it = 0;
  for (; it < first; ++it) pass(it);
  if (last > first) {
    float sc[32], corr[2];
    uint32_t hi[4][4], lo[4][4];
    mbar_wait(bar(K_FULL, it), phase(it));
    take_turn();
    issue_scores(it, sc);
    pass_turn();
    wgmma_wait<0>();
    fence_operand(sc);
    mbar_arrive(bar(K_EMPTY, it));
    softmax(u_begin + it, sc, corr);
    split(sc, hi, lo);
    rescale(corr);
    for (++it; it < last; ++it) {
      mbar_wait(bar(K_FULL, it), phase(it));
      mbar_wait(bar(V_FULL, it - 1), phase(it - 1));
      take_turn();
      issue_scores(it, sc);
      issue_pv(it - 1, hi, lo);
      pass_turn();
      wgmma_wait<1>();
      fence_operand(sc);
      mbar_arrive(bar(K_EMPTY, it));
      softmax(u_begin + it, sc, corr);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NB; ++j) fence_operand(acc[j]);
      mbar_arrive(bar(V_EMPTY, it - 1));
      split(sc, hi, lo);
      rescale(corr);
    }
    mbar_wait(bar(V_FULL, it - 1), phase(it - 1));
    take_turn();
    wgmma_fence();
    issue_pv(it - 1, hi, lo);
    pass_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_operand(acc[j]);
    mbar_arrive(bar(V_EMPTY, it - 1));
  }
  for (; it < n_tiles; ++it) pass(it);

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float l = l_run[x];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int i = q0 + rr[x];
    if (i >= sq) continue;
    const size_t row = (static_cast<size_t>(bi) * sq + i) * h + hh;
    if (CARRY) {
      // un-normalized, fp32: the next ring step resumes from it
      if (leader) {
        carry.m_out[row] = m_run[x];
        carry.l_out[row] = l;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int ch = 0; ch < 8; ++ch)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            carry.acc_out[row * D + 64 * j + 8 * ch + col0 + e] =
                acc[j][4 * ch + 2 * x + e];
    } else {
      const float lm = fmaxf(l, 1e-30f);
      __nv_bfloat16* dst = out + row * D;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(
              acc[j][4 * ch + 2 * x] / lm, acc[j][4 * ch + 2 * x + 1] / lm);
          *reinterpret_cast<__nv_bfloat162*>(dst + 64 * j + 8 * ch + col0) =
              pair;
        }
    }
  }
}

// A dense bf16 (b, s, heads, d) tensor as a 4-D map (d, heads, s, b) with
// 64 x 1 x 64 x 1 boxes, 128-byte swizzle; reads past s fill zeros.
bool make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
              int d) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(heads) * d * 2,
      static_cast<cuuint64_t>(s) * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool CARRY>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Carry& carry, int b, int sq, int sk, int h, int g,
                   int window, int q_base, int k_base, float scale,
                   cudaStream_t stream) {
  CUtensorMap maps[3];
  if (!make_map(&maps[0], q, b, sq, h, D) ||
      !make_map(&maps[1], k, b, sk, g, D) ||
      !make_map(&maps[2], v, b, sk, g, D))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D, CARRY>;
  const int smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int r = h / g;
  const int pair_rows = r == 1;
  const dim3 grid(pair_rows ? (sq + 2 * BQ - 1) / (2 * BQ) : (sq + BQ - 1) / BQ,
                  pair_rows ? h : g * ((r + 1) / 2), b);
  kernel<<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), carry, sq,
      sk, h, g, window, q_base, k_base, scale, pair_rows);
  return cudaGetLastError();
}

template <bool CARRY>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     const Carry& carry, int b, int sq, int sk, int h, int g,
                     int d, int window, int q_base, int k_base, float scale,
                     cudaStream_t stream) {
#define WGMMA_CASE(N)                                                      \
  if (d == N)                                                              \
    return launch<N, CARRY>(q, k, v, out, carry, b, sq, sk, h, g, window,  \
                            q_base, k_base, scale, stream);
  WGMMA_CASE(64)
  WGMMA_CASE(128)
  WGMMA_CASE(192)
  WGMMA_CASE(256)
#undef WGMMA_CASE
  return cudaErrorInvalidValue;
}

bool bad_args(int b, int sq, int sk, int h, int g, int d, int q_base,
              int k_base) {
  return (d != 64 && d != 128 && d != 192 && d != 256) || g <= 0 ||
         h % g != 0 || sk < 0 || q_base < 0 || k_base < 0 || h > 65535 ||
         b > 65535;
}

// The instantiation the launchers run for head dim d and the carry; null
// for a d they refuse.
const void* kernel_of(int d, int carry) {
#define WGMMA_KERNEL(N)                                                    \
  if (d == N)                                                              \
    return carry ? reinterpret_cast<const void*>(flash_wgmma_kernel<N, true>) \
                 : reinterpret_cast<const void*>(flash_wgmma_kernel<N, false>);
  WGMMA_KERNEL(64)
  WGMMA_KERNEL(128)
  WGMMA_KERNEL(192)
  WGMMA_KERNEL(256)
#undef WGMMA_KERNEL
  return nullptr;
}

}  // namespace

extern "C" {

// Queries for the kernel contracts (host code only): the dynamic shared
// memory a launch at head dim d sets, the instantiation's attributes (out:
// static shared bytes, registers, local bytes, max threads, max dynamic
// shared bytes) and the blocks an SM holds at its launch.
int flash_wgmma_smem_bytes(int d) {
  if (d != 64 && d != 128 && d != 192 && d != 256) return -1;
  return smem_bytes(d);
}

int flash_wgmma_attributes(int d, int carry, int* out) {
  const void* kernel = kernel_of(d, carry);
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

int flash_wgmma_occupancy(int d, int carry, int* blocks) {
  const void* kernel = kernel_of(d, carry);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       THREADS, smem);
}

// Row 8 on the tensor cores.  q (b, sq, h, d), k and v (b, sk, g, d) and
// out (b, sq, h, d), dense bf16, base pointers 16-byte aligned (TMA).
// With sk = 0 no row sees a key and out is 0, as the SIMT body leaves it.
// Returns the launch's cudaError_t (a refused launch never runs).
int flash_attention_wgmma_fwd_launch(const void* q, const void* k,
                                     const void* v, void* out, int b, int sq,
                                     int sk, int h, int g, int d, int window,
                                     int q_base, float scale,
                                     cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return cudaSuccess;
  if (bad_args(b, sq, sk, h, g, d, q_base, 0)) return cudaErrorInvalidValue;
  if (sk == 0)
    return cudaMemsetAsync(out, 0, static_cast<size_t>(b) * sq * h * d * 2,
                           stream);
  const Carry none = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return dispatch<false>(q, k, v, out, none, b, sq, sk, h, g, d, window,
                         q_base, 0, scale, stream);
}

// Row 9 on the tensor cores.  q (b, sq, h, d) and the k/v shard
// (b, sk, g, d), dense bf16, 16-byte aligned; the carry fp32: m_in, l_in,
// m_out, l_out (b, sq, h), acc_in, acc_out (b, sq, h, d).  The out pointers
// may equal the in pointers.  An empty shard (sk = 0) hands the carry back.
// Returns the launch's cudaError_t.
int flash_attention_wgmma_step_launch(
    const void* q, const void* k, const void* v, const float* m_in,
    const float* l_in, const float* acc_in, float* m_out, float* l_out,
    float* acc_out, int b, int sq, int sk, int h, int g, int d, int window,
    int q_base, int k_base, float scale, cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return cudaSuccess;
  if (bad_args(b, sq, sk, h, g, d, q_base, k_base))
    return cudaErrorInvalidValue;
  if (sk == 0) {
    const size_t rows = static_cast<size_t>(b) * sq * h;
    cudaError_t err = cudaSuccess;
    const void* src[3] = {m_in, l_in, acc_in};
    void* dst[3] = {m_out, l_out, acc_out};
    const size_t bytes[3] = {rows * 4, rows * 4, rows * d * 4};
    for (int i = 0; i < 3 && err == cudaSuccess; ++i)
      if (src[i] != dst[i])
        err = cudaMemcpyAsync(dst[i], src[i], bytes[i],
                              cudaMemcpyDeviceToDevice, stream);
    return err;
  }
  const Carry carry = {m_in, l_in, acc_in, m_out, l_out, acc_out};
  return dispatch<true>(q, k, v, nullptr, carry, b, sq, sk, h, g, d, window,
                        q_base, k_base, scale, stream);
}

}  // extern "C"
