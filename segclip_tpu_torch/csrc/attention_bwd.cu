// Attention backward from the saved probabilities, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of segclip_tpu/ops/pallas/attention.py:96
// (reached through `_call_bwd`, pallas_call at :203, VJP at :217-247). With P
// the (Lq, Lk) probabilities that the forward saved (csrc/attention_fwd.cu),
// per batch and head, all in fp32 from the operands:
//   dV = Pᵀ·dO
//   dP = dO·Vᵀ
//   dS = P ∘ (dP − D),   D_i = rowsum(dP ∘ P)_i
//   dQ = dS·K·scale
//   dK = dSᵀ·Q·scale
// and dQ, dK, dV are written in the operands' dtype. The biases get no
// gradient (they are masks).
//
// Layout: dO, Q, K, V are (B, L, H·64) with a row stride and a batch stride
// per operand, as in the forward, so the q|k|v column views of a packed
// projection go in without copies. P is (B, H, Lq, ≥ Lk) in V's dtype with
// its own batch, head and row strides (the forward's padded rows go in
// as they are); dQ, dK, dV are contiguous (B, L, H·64).
//
// What bounds it on the H100: bytes. At 96×196, H = 12, P, dO, Q, K and V
// read and dQ, dK and dV written are 291 MB (0.087 ms at 3.35 TB/s) against
// 22.7 GFLOP (0.023 ms at 989 TFLOP/s bf16); P is 90 MB of it.
//
// dS is fp32. Rounded to bf16 before dS·K and dSᵀ·Q it would move dQ and dK
// by about 0.3 bf16 ulp on average, so every kernel here splits it into bf16
// hi + lo parts and runs each of those products twice: fp32-exact to about
// 2^-17. dV = PᵀdO and dP = dO·Vᵀ take bf16 operands (P, dO, V), whose
// products are exact. No kernel uses atomics: the gradients are the same
// bits from run to run.
//
// Four kernels. The wrapper (ops/kernels/attention.py `bwd_route`) picks the
// one-pass or the cluster kernel by dtype and Lk alone, and nothing falls
// back; rows past BWD_CLUSTER_LIMIT (bf16) and every float32 row take
// attention_bwd_long.cu's and attention_bwd_tf32x3.cu's kernels, so no
// route reaches the two-pass pairs below (`attention_bwd_two_pass` launches
// them directly, and chip_smoke.py times them beside those kernels):
//
// bfloat16, Lk ≤ BWD_ONE_PASS_LIMIT (256): `attention_bwd_one_pass_kernel`,
// the path of the model (every backward of the B = 96 and B = 512 steps and
// of ViT-L/14's 32×256). The TPU kernel carries a whole (batch, head pair) in
// VMEM and sums dK and dV over all query rows inside one program; here one
// block owns one (batch, head) and walks its query rows in 64-row tiles, so
// dK and dV are summed on chip in a fixed order, with no atomics and no
// second pass:
//   - warpgroup 0 takes the rows: per query tile, dP = dO·Vᵀ on wgmma over
//     the whole row (m64n64 pieces of 64 keys; dO K-major, V K-major, as the
//     forward's Q·Kᵀ), D = rowsum(dP ∘ P) in registers, dS = P ∘ (dP − D)
//     in fp32 and its bf16 hi and lo parts written into swizzled tiles (P's
//     fragments read and dS's written by ldmatrix / stmatrix at the
//     accumulator's places, then `fence.proxy.async`), and dQ = dS·K·scale
//     on wgmma from shared memory (dS K-major, K MN-major through the
//     transpose bit), stored from registers (rows ≥ Lq dropped). Past 128
//     keys the row is taken in two parts, the first part's dP computed again
//     once D is whole (8 more products a tile), so that 64 registers of dP
//     are live at a time, not 128;
//   - the column warpgroups (one for Lk ≤ 128, two above: each owns 64 or
//     128 key rows) hold dV and dK in fp32 accumulators across all tiles:
//     dV += Pᵀ·dO as soon as a tile arrives, dK += dSᵀ·Q (hi, then lo) as
//     soon as warpgroup 0 has written that warpgroup's pieces of dS; both A
//     operands are MN-major (Pᵀ and dSᵀ read with the transpose bit from the
//     tiles P and dS are stored in), as are Q and dO as B. Named barriers
//     hand dS over (one per column warpgroup) and back;
//   - registers: at Lk > 128 three warpgroups of 168 each; `setmaxnreg`
//     moves 16 from warpgroup 0 to the columns' 128 accumulator registers
//     (below that ptxas serializes their wgmma for want of registers), and
//     the warpgroup index is broadcast from lane 0 so that ptxas sees the
//     warpgroup branches as warp-uniform (in a path it takes for divergent
//     it serializes every wgmma);
//   - TMA copies (hopper.cuh): V and K of the head arrive once per block,
//     each on its mbarrier, rows past Lk filled with zeros; each tile's P,
//     dO and Q arrive on one of two stage mbarriers, the next tile fetched
//     while this one is computed. P's map is Lk wide, so its columns past Lk
//     read as zeros whatever the padding holds; P, dO and Q rows past Lq read
//     as zeros and add nothing to dK or dV;
//   - dK and dV leave once per block: each column warpgroup stages them in
//     swizzled tiles over its own P pieces and stores them by TMA, which
//     drops rows ≥ Lk.
// Shared memory at Lk = 256: K and V 32 KB each, two stages of P (32 KB), dO
// and Q (8 KB each), dS hi and lo 32 KB each: 224 KB, one block of three
// warpgroups per SM; at Lk ≤ 64, 80 KB and two blocks of two warpgroups.
// Measured (PERF.md): about half its byte bound at 96×196. What holds it
// there: warpgroup 0's chain per tile (dP, the elementwise dS, dQ), which
// the column warpgroups' products overlap only in part, and one block per
// SM, whose first loads and last stores nothing else overlaps.
//
// bfloat16, BWD_ONE_PASS_LIMIT < Lk ≤ BWD_CLUSTER_LIMIT (1024):
// `attention_bwd_cluster_kernel`, the one-pass design spread over a
// thread-block cluster (448 px's 24×784 and cross 24×8×792, ViT-L/14's cross
// 32×8×264). What bounds it on the H100: bytes. At 24×784, H = 12, P, dO,
// Q, K and V read and dQ, dK and dV written are 556 MB (0.166 ms at 3.35
// TB/s; P 354 MB of it) against 91 GFLOP (0.092 ms; 136 with dS in two
// parts). dK and dV of 784 keys do not fit one SM, so:
//   - one cluster of C ≤ BWD_CLUSTER_MAX blocks (8, the portable maximum)
//     per (batch, head); block c owns the key slab [128c, 128(c + 1)), holds
//     its K and V by TMA, and its column warpgroup sums the slab's dV += Pᵀ·dO
//     and dK += dSᵀ·Q in fp32 registers across all query tiles, as the
//     one-pass kernel's column warpgroups do;
//   - per 64-row query tile, each block's P slab arrives by its own TMA
//     copy, so P is read once; dO and Q arrive once for the cluster by
//     rank 0's multicast (past the first two tiles);
//   - warpgroup 0 forms dP = dO·V_slabᵀ and the partial D_c = rowsum(dP ∘
//     P) and pushes D_c into every block (`st.async` into distributed shared
//     memory, DSMEM, completing on the receiver's mbarrier); every block
//     takes D = Σ_c D_c in rank order; then dS = P ∘ (dP − D) in hi + lo
//     parts, and the partial dQ_c = dS·K_slab, staged and copied by the copy
//     engine (`cp.async.bulk.shared::cluster`) to the blocks that own its
//     rows: block c's column warpgroup sums rows [64c/C, 64(c+1)/C) of dQ in
//     rank order, scales, rounds and stores them; dK and dV leave once per
//     (batch, head) by TMA store;
//   - the grid holds as many clusters as the card runs at once, each taking
//     (batch, head) rows one after the other with its tiles counted on
//     across them, so that one row's first copies overlap the row before's
//     last tiles (the cross blocks' rows have a single query tile).
//   No atomics and no D scratch in HBM: the gradients are the same bits from
//   run to run.
//
// bfloat16, any Lk, no route (rows past BWD_CLUSTER_LIMIT took it until
// attention_bwd_long.cu): `attention_bwd_{dq,dkv}_bf16_kernel`, two passes
// on `mma.sync` (tc_bf16.cuh). Blocks of this design own
// 64 rows, and blocks run in no order, so the sum of dK and dV over query
// blocks cannot be carried across them without atomics. Instead:
//   (a) one block per (b, h, query rows): D, written to a (B, H, Lq4) fp32
//       scratch (Lq4 = Lq rounded up to 4), then dS and dQ;
//   (b) one block per (b, h, key rows): dV and dK, with dS rebuilt from P,
//       dO, V and D.
// Its design:
//   - blocks of 64 rows, four warps of 16; every product on tensor cores
//     (`mma.sync.m16n8k16`) with fp32 accumulators;
//   - dO, Q, K, V and P tiles staged in shared memory by `cp.async`,
//     double-buffered, zero-filled past Lq and Lk; P is read in coalesced
//     16-byte pieces;
//   - pass (a) keeps its 64 P rows in shared memory while Lk ≤ 512
//     (PA_CACHE_TILES), so it reads each P tile once; it computes dP = dO·Vᵀ
//     twice, once for D and once for dS, since D needs the whole row first
//     (on tensor cores that costs FLOPs, not bytes). Above that Lk it streams
//     P twice;
//   - pass (b) reads Pᵀ fragments with `ldmatrix.trans`, rebuilds dPᵀ = V·dOᵀ
//     on tensor cores, and sums dV and dK in fp32 registers.
//
// float32, any Lk, no route (rows past 256 keys took it until
// attention_bwd_long.cu): `attention_bwd_{dq,dkv}_simt_kernel`, fp32 FMAs
// (no TF32), the two passes above. Pass (a) takes 16 query rows per block
// and walks the keys twice in 64-row tiles (D, then dS and dQ); pass (b)
// takes 64 key rows and walks the queries in 32-row tiles.
//
// Masks: query rows at or past Lq and key rows at or past Lk are never
// stored and read as zeros (P = 0 there, so they add nothing). Entries that
// the causal mask removed have P = 0 and add nothing either. A fully masked
// row (P = NaN) gives NaN in dQ's row and in every row of dK and dV, as the
// plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tc_bf16.cuh"

namespace segclip_kernels {
namespace {

using segclip_tc::bf16;
using segclip_tc::HD;
using segclip_tc::LDS;

struct Args {
  const void* p;         // (B, H, Lq, ≥ Lk), strided
  const void* dout;      // (B, Lq, H·64), strided
  const void* q;
  const void* k;
  const void* v;
  void* dq;              // (B, Lq, H·64) contiguous
  void* dk;              // (B, Lk, H·64) contiguous
  void* dv;
  float* drow;           // (B, H, d_rs) scratch: D
  int heads, lq, lk;
  long long p_bs, p_hs, p_rs, do_bs, do_rs, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  long long d_rs;        // Lq rounded up to 4
  float scale;
};

// ---------------------------------------------------------------- bfloat16

constexpr int BR = 64;                         // rows per block and per tile
constexpr int THREADS_TC = 128;                // four warps of 16 rows
constexpr int TILE_ELEMS = BR * LDS;           // elements of one staged tile
constexpr int PA_CACHE_TILES = 8;              // pass (a) keeps P rows while Lk ≤ 512

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Pass (a)'s shared memory: K and V double buffers, then P (the block's
// whole rows, or a double buffer when they do not fit).
__host__ __device__ inline bool pa_cached(int lk) { return cdiv(lk, BR) <= PA_CACHE_TILES; }
__host__ __device__ inline int pa_plds(int lk) {
  return pa_cached(lk) ? cdiv(lk, BR) * BR + 8 : LDS;
}
__host__ __device__ inline size_t pa_smem(int lk) {
  return sizeof(bf16) * (4 * TILE_ELEMS + (pa_cached(lk) ? BR * pa_plds(lk) : 2 * TILE_ELEMS));
}
constexpr size_t PA_SMEM_MAX = sizeof(bf16) * (4 * TILE_ELEMS + BR * (PA_CACHE_TILES * BR + 8));
constexpr size_t PB_SMEM = sizeof(bf16) * 6 * TILE_ELEMS + sizeof(float) * 2 * BR;

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Pass (a): D and dQ. Grid (⌈Lq / 64⌉, H, B), dynamic shared memory pa_smem(Lk).
__global__ void __launch_bounds__(THREADS_TC) attention_bwd_dq_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);            // [2][TILE_ELEMS]; sk[0] first holds dO
  bf16* sv = sk + 2 * TILE_ELEMS;                                  // [2][TILE_ELEMS]
  bf16* sp = sv + 2 * TILE_ELEMS;                                  // P rows or [2][TILE_ELEMS]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int tiles = cdiv(a.lk, BR);
  const bool cached = pa_cached(a.lk);
  const int plds = pa_plds(a.lk);
  auto p_tile = [&](int t) { return cached ? sp + t * BR : sp + (t & 1) * TILE_ELEMS; };

  const bf16* dop = static_cast<const bf16*>(a.dout) + b * a.do_bs + h * HD;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_bs + h * HD;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_bs + h * HD;
  const bf16* pp = static_cast<const bf16*>(a.p) + b * a.p_bs + h * a.p_hs;
  auto load_p = [&](int t) {
    segclip_tc::load_block<BR, THREADS_TC>(p_tile(t), plds, pp, a.p_rs, q0, a.lq, t * BR, a.lk);
  };

  segclip_tc::load_rows<BR, THREADS_TC>(sk, dop, a.do_rs, q0, a.lq);
  segclip_tc::load_rows<BR, THREADS_TC>(sv, vp, a.v_rs, 0, a.lk);
  load_p(0);
  segclip_tc::cp_async_commit();
  segclip_tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t dof[4][4];
  segclip_tc::load_a_rows(dof, sk, warp, lane);

  const int lrow = 16 * warp + g;                            // this thread's rows: lrow, lrow + 8
  const bool active = q0 + 16 * warp < a.lq;                 // a warp past Lq only loads
  float dp[8][4];

  // D_i = Σ_j P_ij dP_ij
  float dsum[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      segclip_tc::load_rows<BR, THREADS_TC>(sv + ((t + 1) & 1) * TILE_ELEMS, vp, a.v_rs,
                                            (t + 1) * BR, a.lk);
      load_p(t + 1);
      segclip_tc::cp_async_commit();
      segclip_tc::cp_async_wait<1>();
    } else {
      segclip_tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int ncols = min(BR, a.lk - t * BR);                // real keys in this tile
    if (active) {
      segclip_tc::mma_abt(dp, dof, sv + (t & 1) * TILE_ELEMS, lane, ncols);
      const bf16* pt = p_tile(t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= ncols) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 pv = segclip_tc::unpack(
              *reinterpret_cast<const uint32_t*>(pt + (lrow + 8 * r) * plds + 8 * j + c));
          dsum[r] = fmaf(pv.x, dp[j][2 * r], dsum[r]);
          dsum[r] = fmaf(pv.y, dp[j][2 * r + 1], dsum[r]);
        }
      }
    }
    __syncthreads();
  }
  const float drow[2] = {quad_sum(dsum[0]), quad_sum(dsum[1])};
  float* dr = a.drow + (static_cast<long long>(b) * a.heads + h) * a.d_rs;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if ((lane & 3) == 0 && q0 + lrow + 8 * r < a.lq) dr[q0 + lrow + 8 * r] = drow[r];

  // dS = P (dP − D); dQ = dS·K, scaled at the end
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  segclip_tc::load_rows<BR, THREADS_TC>(sk, kp, a.k_rs, 0, a.lk);
  segclip_tc::load_rows<BR, THREADS_TC>(sv, vp, a.v_rs, 0, a.lk);
  if (!cached) load_p(0);
  segclip_tc::cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int nb = (t + 1) & 1;
      segclip_tc::load_rows<BR, THREADS_TC>(sk + nb * TILE_ELEMS, kp, a.k_rs, (t + 1) * BR, a.lk);
      segclip_tc::load_rows<BR, THREADS_TC>(sv + nb * TILE_ELEMS, vp, a.v_rs, (t + 1) * BR, a.lk);
      if (!cached) load_p(t + 1);
      segclip_tc::cp_async_commit();
      segclip_tc::cp_async_wait<1>();
    } else {
      segclip_tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int ncols = min(BR, a.lk - t * BR);
    if (active) {
      segclip_tc::mma_abt(dp, dof, sv + (t & 1) * TILE_ELEMS, lane, ncols);
      const bf16* pt = p_tile(t);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {                       // keys 16kk .. 16kk + 15
        if (16 * kk >= ncols) break;
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 pv = segclip_tc::unpack(
                *reinterpret_cast<const uint32_t*>(pt + (lrow + 8 * r) * plds + 8 * j + c));
            dp[j][2 * r] = pv.x * (dp[j][2 * r] - drow[r]);
            dp[j][2 * r + 1] = pv.y * (dp[j][2 * r + 1] - drow[r]);
          }
        uint32_t hi[4], lo[4];
        segclip_tc::acc_to_a_split(hi, lo, dp[2 * kk], dp[2 * kk + 1]);
        segclip_tc::mma_ab_step(acc, hi, sk + (t & 1) * TILE_ELEMS, kk, lane);
        segclip_tc::mma_ab_step(acc, lo, sk + (t & 1) * TILE_ELEMS, kk, lane);
      }
    }
    __syncthreads();
  }

  bf16* dqp = static_cast<bf16*>(a.dq) +
              (static_cast<long long>(b) * a.lq + q0 + 16 * warp) * (a.heads * HD) + h * HD;
  segclip_tc::stage_store(sk + 16 * warp * LDS, acc, a.scale, dqp, a.heads * HD,
                          a.lq - q0 - 16 * warp, HD, lane);
}

// Pass (b): dK and dV. Grid (⌈Lk / 64⌉, H, B), dynamic shared memory PB_SMEM.
// Warp w owns key rows k0 + 16w .. k0 + 16w + 15.
__global__ void __launch_bounds__(THREADS_TC) attention_bwd_dkv_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);            // [2][TILE_ELEMS]
  bf16* sdo = sq + 2 * TILE_ELEMS;                                 // [2][TILE_ELEMS]
  bf16* sp = sdo + 2 * TILE_ELEMS;                                 // [2][TILE_ELEMS]; sp[1] first holds V
  float* sd = reinterpret_cast<float*>(sp + 2 * TILE_ELEMS);      // [2][BR]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 2 * (lane & 3);
  const int tiles = cdiv(a.lq, BR);
  const bool active = k0 + 16 * warp < a.lk;                 // a warp past Lk only loads

  const bf16* dop = static_cast<const bf16*>(a.dout) + b * a.do_bs + h * HD;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_bs + h * HD;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_bs + h * HD;
  const bf16* pp = static_cast<const bf16*>(a.p) + b * a.p_bs + h * a.p_hs;
  const float* dr = a.drow + (static_cast<long long>(b) * a.heads + h) * a.d_rs;
  auto load_tile = [&](int i) {
    const int nb = i & 1, i0 = i * BR;
    segclip_tc::load_rows<BR, THREADS_TC>(sq + nb * TILE_ELEMS, qp, a.q_rs, i0, a.lq);
    segclip_tc::load_rows<BR, THREADS_TC>(sdo + nb * TILE_ELEMS, dop, a.do_rs, i0, a.lq);
    segclip_tc::load_block<BR, THREADS_TC>(sp + nb * TILE_ELEMS, LDS, pp, a.p_rs, i0, a.lq, k0, a.lk);
    if (threadIdx.x < BR / 4) {
      const int r = i0 + 4 * threadIdx.x;
      int bytes = 4 * (a.lq - r);
      bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
      segclip_tc::cp_async16(sd + nb * BR + 4 * threadIdx.x, bytes ? dr + r : dr, bytes);
    }
  };

  segclip_tc::load_rows<BR, THREADS_TC>(sp + TILE_ELEMS, vp, a.v_rs, k0, a.lk);
  load_tile(0);
  segclip_tc::cp_async_commit();
  segclip_tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t vf[4][4];
  segclip_tc::load_a_rows(vf, sp + TILE_ELEMS, warp, lane);
  __syncthreads();

  float dk[8][4], dv[8][4], dpt[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      load_tile(i + 1);
      segclip_tc::cp_async_commit();
      segclip_tc::cp_async_wait<1>();
    } else {
      segclip_tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tq = sq + (i & 1) * TILE_ELEMS;
    const bf16* tdo = sdo + (i & 1) * TILE_ELEMS;
    const bf16* tp = sp + (i & 1) * TILE_ELEMS;
    const float* td = sd + (i & 1) * BR;
    const int nrows = min(BR, a.lq - i * BR);                // real queries in this tile
    if (active) segclip_tc::mma_abt(dpt, vf, tdo, lane, nrows);  // dPᵀ = V·dOᵀ
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (!active || 16 * kk >= nrows) break;
      uint32_t pf[4];                                         // Pᵀ, keys × queries 16kk..
      segclip_tc::ldmatrix_x4_trans(
          pf, tp + (16 * kk + (lane >> 4) * 8 + (lane & 7)) * LDS + 16 * warp +
                  ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int half = 0; half < 2; ++half) {                  // n-tile 2kk + half
        float* s = dpt[2 * kk + half];
        const float d0 = td[16 * kk + 8 * half + c], d1 = td[16 * kk + 8 * half + c + 1];
        const float2 p0 = segclip_tc::unpack(pf[2 * half]);     // key row g
        const float2 p1 = segclip_tc::unpack(pf[2 * half + 1]); // key row g + 8
        s[0] = p0.x * (s[0] - d0);
        s[1] = p0.y * (s[1] - d1);
        s[2] = p1.x * (s[2] - d0);
        s[3] = p1.y * (s[3] - d1);
      }
      uint32_t hi[4], lo[4];
      segclip_tc::acc_to_a_split(hi, lo, dpt[2 * kk], dpt[2 * kk + 1]);
      segclip_tc::mma_ab_step(dv, pf, tdo, kk, lane);         // dV += Pᵀ·dO
      segclip_tc::mma_ab_step(dk, hi, tq, kk, lane);          // dK += dSᵀ·Q
      segclip_tc::mma_ab_step(dk, lo, tq, kk, lane);
    }
    __syncthreads();
  }

  const long long o = (static_cast<long long>(b) * a.lk + k0 + 16 * warp) * (a.heads * HD) + h * HD;
  bf16* stage = sq + 16 * warp * LDS;
  const int rows = a.lk - k0 - 16 * warp;
  segclip_tc::stage_store(stage, dk, a.scale, static_cast<bf16*>(a.dk) + o, a.heads * HD, rows,
                          HD, lane);
  segclip_tc::stage_store(stage, dv, 1.f, static_cast<bf16*>(a.dv) + o, a.heads * HD, rows, HD,
                          lane);
}

// ------------------------------------------------------ bfloat16, one pass

using namespace segclip_hopper;

// The longest rows the one-pass backward takes: a 64-row query tile's whole
// dP rows are one wgmma accumulator of at most four 64-column pieces, and
// dK and dV of 256 key rows fill two warpgroups' registers.
constexpr int BWD_ONE_PASS_LIMIT = 256;

struct OnePassArgs {
  CUtensorMap p;           // (Lk, Lq, B·H), the saved probabilities
  CUtensorMap dout, q;     // (H·64, Lq, B) over the operands' own strides
  CUtensorMap k, v;        // (H·64, Lk, B)
  CUtensorMap dk, dv;      // (H·64, Lk, B), the contiguous outputs
  bf16* dq;                // (B, Lq, H·64) contiguous
  int heads, lq, lk;
  float scale;
};

// Named barriers: dS of a tile read (the column warpgroups arrive,
// warpgroup 0 waits), warpgroup 0's own, column warpgroup c's part of dS
// written (BAR_DS_FULL + c: warpgroup 0 arrives, c waits), and column
// warpgroup c's own (BAR_COLS + c).
constexpr int BAR_DS_EMPTY = 1, BAR_ROWS = 2, BAR_DS_FULL = 3, BAR_COLS = 5;
// The cluster backward's: a row's last dQ has read the dS tiles.
constexpr int BAR_DQ_DONE = 7;
// The cluster backward's: a tile's dQ partial is staged (warpgroup 0
// arrives, the column warpgroup waits and issues its copies).
constexpr int BAR_STAGED = 8;
// Registers per thread at Lk > 128 (three warpgroups, 168 each at launch):
// warpgroup 0 gives 16 and each column warpgroup takes 8, for its 128
// accumulator registers (`setmaxnreg`).
constexpr int ROW_REGS = 152, COL_REGS = 176;

__host__ __device__ constexpr int bwd_col_groups(int nc) { return (nc + 1) / 2; }
__host__ __device__ constexpr int bwd_threads(int nc) { return 128 * (1 + bwd_col_groups(nc)); }
// K, V, dS hi and dS lo (NC tiles each), two stages of P (NC tiles), dO and
// Q (one tile each), then four mbarriers.
__host__ __device__ constexpr int bwd_one_pass_smem(int nc) {
  return (6 * nc + 4) * TILE_BYTES + 32;
}

// Warpgroup 0's work on one query tile, piece by piece of 64 key columns
// (addresses in shared memory). P's and dS's fragments move by ldmatrix /
// stmatrix, four 8 × 8 pieces a call, at the accumulator's places: lane l
// gives row 16w + 8·(i % 2) + l % 8 of 8-column group 2jp + i / 2, i = l / 8
// (`frag`, for jp = 0), so register i of call jp holds the pair of row
// r0 + 8·(i % 2), group j = 2jp + i / 2.
struct RowTile {
  uint32_t dout, v, p, hi, lo, frag;

  __device__ __forceinline__ uint32_t frag_at(int c, int jp) const {
    return c * TILE_BYTES + (frag ^ (jp << 5));
  }
  // dp[c] = dO·V[piece c0 + c]ᵀ, each a 64 × 64 fp32 accumulator (the
  // first `live` pieces).
  template <int N>
  __device__ __forceinline__ void dp_product(float (&dp)[N][32], int c0, int live = N) const {
#pragma unroll
    for (int c = 0; c < N; ++c) fence_regs(dp[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c < live)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(dp[c], desc_sw128(dout + 32 * kk),
                             desc_sw128(v + (c0 + c) * TILE_BYTES + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < N; ++c) fence_regs(dp[c]);
  }
  // d[r] += this thread's share of rowsum(dP ∘ P) over pieces c0.. of row
  // r0 + 8r (the first `live` of them: the others hold no copy); P's columns
  // past Lk are 0.
  template <int N>
  __device__ __forceinline__ void rowsum(float (&d)[2], const float (&dp)[N][32], int c0,
                                         int live = N) const {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c >= live) break;
      uint32_t pv[4][4];
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) ldmatrix_x4(pv[jp], p + frag_at(c0 + c, jp));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * jp + (i >> 1), r = i & 1;
          const float2 p2 = segclip_tc::unpack(pv[jp][i]);
          d[r] = fmaf(p2.x, dp[c][4 * j + 2 * r], d[r]);
          d[r] = fmaf(p2.y, dp[c][4 * j + 2 * r + 1], d[r]);
        }
    }
  }
  // The whole row's D from the four threads that share it.
  __device__ __forceinline__ void finish_d(float (&d)[2]) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) d[r] = quad_sum(d[r]);
  }
  // dS = P ∘ (dP − D) in fp32 over pieces c0.. (the first `live`), split
  // into bf16 hi + lo and written into the dS tiles.
  template <int N>
  __device__ __forceinline__ void store_ds(const float (&dp)[N][32], int c0, const float (&d)[2],
                                           int live = N) const {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c >= live) break;
      uint32_t pv[4][4];
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) ldmatrix_x4(pv[jp], p + frag_at(c0 + c, jp));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * jp + (i >> 1), r = i & 1;
          const float2 p2 = segclip_tc::unpack(pv[jp][i]);
          const float x0 = p2.x * (dp[c][4 * j + 2 * r] - d[r]);
          const float x1 = p2.y * (dp[c][4 * j + 2 * r + 1] - d[r]);
          h[i] = segclip_tc::pack(x0, x1);
          const float2 hv = segclip_tc::unpack(h[i]);
          l[i] = segclip_tc::pack(x0 - hv.x, x1 - hv.y);
        }
        stmatrix_x4(hi + frag_at(c0 + c, jp), h);
        stmatrix_x4(lo + frag_at(c0 + c, jp), l);
      }
    }
  }
};

// One block per (batch, head). Warpgroup 0 takes the query rows (dP, D, dS,
// dQ); column warpgroup c ≥ 1 owns the key tiles MT·(c − 1) .. MT·c − 1 of
// 64 rows (dV, dK). In each warpgroup, warp w holds rows 16w + g and
// 16w + g + 8 of a 64-row accumulator tile, columns 8j + 2(lane % 4) + {0, 1}.
template <int NC>
__global__ void __launch_bounds__(bwd_threads(NC), NC == 1 ? 2 : 1)
    attention_bwd_one_pass_kernel(const __grid_constant__ OnePassArgs a) {
  constexpr int THREADS = bwd_threads(NC);
  constexpr int MT = NC == 1 ? 1 : 2;          // key tiles a column warpgroup owns
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* sk = smem;
  uint8_t* sv = sk + NC * TILE_BYTES;
  uint8_t* shi = sv + NC * TILE_BYTES;
  uint8_t* slo = shi + NC * TILE_BYTES;
  uint8_t* sp = slo + NC * TILE_BYTES;         // [stage][NC]
  uint8_t* sdo = sp + 2 * NC * TILE_BYTES;     // [stage]
  uint8_t* sq = sdo + 2 * TILE_BYTES;          // [stage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sq + 2 * TILE_BYTES);
  const uint32_t bar_v = smem_u32(bars), bar_k = smem_u32(bars + 1);
  const uint32_t bar_full = smem_u32(bars + 2);     // stage st's barrier: bar_full + 8·st

  const int h = blockIdx.x, b = blockIdx.y;
  // The warpgroup index broadcast from lane 0, so that the compiler sees the
  // branch below as warp-uniform: in a path it thinks divergent it would
  // serialize every wgmma.
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0), wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);
  const int tiles = (a.lq + TILE - 1) / TILE;

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();      // the swizzle needs 1024-byte tiles
    mbar_init(bar_v, 1);
    mbar_init(bar_k, 1);
    mbar_init(bar_full, 1);
    mbar_init(bar_full + 8, 1);
    fence_barrier_init();
  }
  __syncthreads();
  // P, dO and Q of query tile t into stage t % 2, on that stage's barrier.
  auto load_tile = [&](int t) {
    const int st = t & 1;
    mbar_expect_tx(bar_full + 8 * st, (NC + 2) * TILE_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load_3d(sp + (st * NC + c) * TILE_BYTES, &a.p, bar_full + 8 * st, c * TILE, t * TILE,
                  b * a.heads + h);
    tma_load_3d(sdo + st * TILE_BYTES, &a.dout, bar_full + 8 * st, h * HD, t * TILE, b);
    tma_load_3d(sq + st * TILE_BYTES, &a.q, bar_full + 8 * st, h * HD, t * TILE, b);
  };
  if (tid == 0) {            // V (for the first dP), tile 0, K (for the first dQ), tile 1
    mbar_expect_tx(bar_v, NC * TILE_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_load_3d(sv + c * TILE_BYTES, &a.v, bar_v, h * HD, c * TILE, b);
    load_tile(0);
    mbar_expect_tx(bar_k, NC * TILE_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_load_3d(sk + c * TILE_BYTES, &a.k, bar_k, h * HD, c * TILE, b);
    if (tiles > 1) load_tile(1);
  }

  if (wg == 0) {
    // ------------------------------------------------ the rows: dP, D, dS, dQ
    if constexpr (NC >= 3) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(ROW_REGS));
    const uint32_t k_addr = smem_u32(sk), v_addr = smem_u32(sv);
    const uint32_t hi_addr = smem_u32(shi), lo_addr = smem_u32(slo);
    const long long dm = static_cast<long long>(a.heads) * HD;
    // This lane's row address for ldmatrix / stmatrix (RowTile)
    const int mi = lane >> 3;
    const uint32_t frag = sw128(16 * warp + 8 * (mi & 1) + (lane & 7), mi >> 1, 0);
    for (int t = 0; t < tiles; ++t) {
      const int st = t & 1, q0 = t * TILE;
      if (t > 0) {
        named_sync(BAR_DS_EMPTY, THREADS);    // the column warpgroups are done with tile t − 1
        if (tid == 0 && t + 1 < tiles) load_tile(t + 1);   // into tile t − 1's stage
      }
      mbar_wait(bar_full + 8 * st, (t >> 1) & 1);
      if (t == 0) mbar_wait(bar_v, 0);

      // dP = dO·Vᵀ over the whole row (V's rows past Lk are zeros), D =
      // rowsum(dP ∘ P), then dS, handed to each column warpgroup as soon as
      // its pieces are written. Past two 64-column pieces (Lk > 128) the row
      // is taken in two parts, pieces 0..1 (column warpgroup 0's) and the
      // rest (column warpgroup 1's): the first part's dP gives its share of
      // D and is computed again once D is whole, so that warpgroup 0 never
      // holds more than two pieces (64 registers) of dP.
      const uint32_t do_addr = smem_u32(sdo + st * TILE_BYTES);
      const uint32_t p_addr = smem_u32(sp + st * NC * TILE_BYTES);
      const RowTile rt{do_addr, v_addr, p_addr, hi_addr, lo_addr, frag};
      float d[2] = {0.f, 0.f};
      if constexpr (NC <= 2) {
        float dp[NC][32];
        rt.dp_product(dp, 0);
        rt.rowsum(d, dp, 0);
        rt.finish_d(d);
        rt.store_ds(dp, 0, d);
        fence_proxy_async();
        named_arrive(BAR_DS_FULL, 256);
      } else {
        {
          float dp[2][32];
          rt.dp_product(dp, 0);
          rt.rowsum(d, dp, 0);
        }
        float dp[NC - 2][32];
        rt.dp_product(dp, 2);
        rt.rowsum(d, dp, 2);
        rt.finish_d(d);
        rt.store_ds(dp, 2, d);
        fence_proxy_async();
        named_arrive(BAR_DS_FULL + 1, 256);
        float dpa[2][32];
        rt.dp_product(dpa, 0);
        rt.store_ds(dpa, 0, d);
        fence_proxy_async();
        named_arrive(BAR_DS_FULL, 256);
      }
      named_sync(BAR_ROWS, 128);

      // dQ = dS·K·scale, dS (K-major) hi then lo, K (MN-major) through the
      // transpose bit; K's rows past Lk are zeros.
      if (t == 0) mbar_wait(bar_k, 0);
      float dq[32];
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NC; ++kk) {
        if (16 * kk >= a.lk) break;
        const uint32_t at = (kk >> 2) * TILE_BYTES + 32 * (kk & 3);
        const uint64_t kd = desc_sw128(k_addr + 2048 * kk);
        wgmma_m64n64k16_ss<0, 1>(dq, desc_sw128(hi_addr + at), kd, kk);
        wgmma_m64n64k16_ss<0, 1>(dq, desc_sw128(lo_addr + at), kd, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);

      // dQ out from registers, rows < Lq.
      bf16* dqp = a.dq + (static_cast<long long>(b) * a.lq + q0 + r0) * dm + h * HD + c2;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (q0 + r0 + 8 * r < a.lq)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(dqp + 8 * r * dm + 8 * j) = segclip_tc::pack(
                dq[4 * j + 2 * r] * a.scale, dq[4 * j + 2 * r + 1] * a.scale);
    }
  } else {
    // ------------------------------------- the columns: dV and dK of MT key tiles
    if constexpr (NC >= 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(COL_REGS));
    const int col = wg - 1, m0 = MT * col;
    float dv[MT][32], dk[MT][32];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) dv[m][i] = dk[m][i] = 0.f;
    const uint32_t hi_addr = smem_u32(shi), lo_addr = smem_u32(slo);
    for (int t = 0; t < tiles; ++t) {
      const int st = t & 1;
      const int ksteps = (min(TILE, a.lq - t * TILE) + 15) / 16;   // query rows of the tile
      const uint32_t p_addr = smem_u32(sp + st * NC * TILE_BYTES);
      const uint32_t do_addr = smem_u32(sdo + st * TILE_BYTES);
      const uint32_t q_addr = smem_u32(sq + st * TILE_BYTES);
      mbar_wait(bar_full + 8 * st, (t >> 1) & 1);

      // dV += Pᵀ·dO: Pᵀ (MN-major A) from P's tile, dO (MN-major B).
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_regs(dv[m]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < NC)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < ksteps)
              wgmma_m64n64k16_ss<1, 1>(dv[m], desc_sw128(p_addr + (m0 + m) * TILE_BYTES + 2048 * kk),
                                       desc_sw128(do_addr + 2048 * kk), 1);
      wgmma_commit();

      // dK += dSᵀ·Q once warpgroup 0 has written this warpgroup's pieces of
      // dS: hi, then lo.
      named_sync(BAR_DS_FULL + col, 256);
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_regs(dk[m]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < NC)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < ksteps) {
              const uint32_t at = (m0 + m) * TILE_BYTES + 2048 * kk;
              const uint64_t qd = desc_sw128(q_addr + 2048 * kk);
              wgmma_m64n64k16_ss<1, 1>(dk[m], desc_sw128(hi_addr + at), qd, 1);
              wgmma_m64n64k16_ss<1, 1>(dk[m], desc_sw128(lo_addr + at), qd, 1);
            }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        fence_regs(dv[m]);
        fence_regs(dk[m]);
      }
      if (t + 1 < tiles) named_arrive(BAR_DS_EMPTY, THREADS);
    }

    // dV and dK out: staged over this warpgroup's own P pieces of both stages
    // (nothing else reads them now), one TMA store per tile; rows ≥ Lk dropped.
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m0 + m < NC) {
        uint8_t* sdv = sp + (m0 + m) * TILE_BYTES;
        uint8_t* sdk = sp + (NC + m0 + m) * TILE_BYTES;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t at = sw128(r0 + 8 * r, j, c2);
            *reinterpret_cast<uint32_t*>(sdv + at) =
                segclip_tc::pack(dv[m][4 * j + 2 * r], dv[m][4 * j + 2 * r + 1]);
            *reinterpret_cast<uint32_t*>(sdk + at) = segclip_tc::pack(
                dk[m][4 * j + 2 * r] * a.scale, dk[m][4 * j + 2 * r + 1] * a.scale);
          }
      }
    fence_proxy_async();
    named_sync(BAR_COLS + col, 128);
    if (wtid == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < NC) {
          tma_store_3d(&a.dv, sp + (m0 + m) * TILE_BYTES, h * HD, (m0 + m) * TILE, b);
          tma_store_3d(&a.dk, sp + (NC + m0 + m) * TILE_BYTES, h * HD, (m0 + m) * TILE, b);
        }
      bulk_commit();
      bulk_wait_read<0>();                    // shared memory stays until the stores read it
    }
  }
}

template <int NC>
int launch_bwd_one_pass(const OnePassArgs& a, int batch, cudaStream_t stream) {
  const auto kernel = attention_bwd_one_pass_kernel<NC>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool raised[64] = {};                // the shared-memory limit, once per device
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bwd_one_pass_smem(NC));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[device] = true;
  }
  kernel<<<dim3(a.heads, batch), bwd_threads(NC), bwd_one_pass_smem(NC), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------ bfloat16, one thread-block cluster per (batch, head)

// The longest rows the cluster backward takes: at most BWD_CLUSTER_MAX blocks
// (the portable maximum), each a slab of BWD_SLAB 64-key pieces.
constexpr int BWD_CLUSTER_LIMIT = 1024;
constexpr int BWD_SLAB = 2;
constexpr int BWD_CLUSTER_MAX = 8;
static_assert(BWD_CLUSTER_LIMIT == BWD_CLUSTER_MAX * BWD_SLAB * TILE, "the cluster backward's rows");
constexpr int BWD_CLUSTER_THREADS = 256;       // warpgroup 0 (rows) and one column warpgroup

struct ClusterArgs {
  CUtensorMap p;           // (Lk, Lq, B·H), the saved probabilities
  CUtensorMap dout, q;     // (H·64, Lq, B) over the operands' own strides
  CUtensorMap k, v;        // (H·64, Lk, B)
  CUtensorMap dk, dv;      // (H·64, Lk, B), the contiguous outputs
  bf16* dq;                // (B, Lq, H·64) contiguous
  int batch, heads, lq, lk;
  float scale;
};

inline int bwd_cluster_blocks(int lk) { return (lk + BWD_SLAB * TILE - 1) / (BWD_SLAB * TILE); }
// K, V, dS hi and dS lo (BWD_SLAB tiles each), two stages of P (BWD_SLAB
// tiles), three of dO and Q (one tile each), two staging tiles of the
// block's dQ partial (fp32), two receive areas for its share of dQ's rows,
// two of every block's D_c (64 floats each), then eleven mbarriers.
constexpr int BWD_XD_BYTES = BWD_CLUSTER_MAX * TILE * 4;
constexpr int bwd_cluster_smem() {
  return (6 * BWD_SLAB + 6 + 4) * TILE_BYTES + 2 * share_area_bytes(BWD_CLUSTER_MAX) +
         2 * BWD_XD_BYTES + 88;
}

// Grid (C, G) in clusters of C, G at most the clusters the card holds at
// once: cluster g takes the (batch, head) rows g, g + G, ... one after the
// other, its tiles counted on across them, so that the copies of one row's
// first tiles overlap the last tiles of the row before. Block c of a cluster
// owns the keys [c·128, (c + 1)·128) of the row, as the one-pass backward
// owns a whole row: warpgroup 0 takes the query rows (dP, D_c, dS, dQ_c),
// warpgroup 1 holds the slab's dV and dK in fp32 across the row's query
// tiles and sums the block's share of dQ's rows. Per 64-row query tile
// every block pushes its D_c into each block (st_async) and copies its dQ
// partial's rows to the blocks that sum them (bulk copies from a staging
// tile); both alternate between two receive areas and mbarriers by tile. A
// block pushes D_c of tile t only once its column warpgroup is done with
// tile t − 1, so every push of a kind comes after the receiver has read the
// one two tiles before. dO and Q of tiles 0 and 1 arrive by each block's own
// copies, of later tiles once for the cluster (rank 0's multicast, three
// stages: the copy of tile t + 1 leaves once every block's D_c of tile t has
// come, when all are done with tile t − 2); each block's P slab by its own
// copy (two stages); K and V of the next row once this row's last dP and dQ
// have read them. The column warpgroup's first thread issues the copies of
// tiles past 1; it stages a row's dK and dV over the dS tiles (warpgroup 0
// done with them) for their TMA stores.
__global__ void __launch_bounds__(BWD_CLUSTER_THREADS, 1)
    attention_bwd_cluster_kernel(const __grid_constant__ ClusterArgs a) {
  constexpr int NC = BWD_SLAB, THREADS = BWD_CLUSTER_THREADS;
  constexpr int AREA = share_area_bytes(BWD_CLUSTER_MAX);
  constexpr int XTILE = 2 * TILE_BYTES;        // a 64 × 64 fp32 staging tile
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* sk = smem;
  uint8_t* sv = sk + NC * TILE_BYTES;
  uint8_t* shi = sv + NC * TILE_BYTES;
  uint8_t* slo = shi + NC * TILE_BYTES;
  uint8_t* sp = slo + NC * TILE_BYTES;         // [tile % 2][NC]
  uint8_t* sdo = sp + 2 * NC * TILE_BYTES;     // [tile % 3]
  uint8_t* sq = sdo + 3 * TILE_BYTES;          // [tile % 3]
  uint8_t* xs = sq + 3 * TILE_BYTES;           // [tile % 2] this block's dQ partial, fp32
  uint8_t* xq = xs + 2 * XTILE;                // [tile % 2][rank][this block's dQ rows][64] fp32
  float* xd = reinterpret_cast<float*>(xq + 2 * AREA);   // [tile % 2][rank][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xd + 2 * BWD_CLUSTER_MAX * TILE);
  const uint32_t bar_v = smem_u32(bars), bar_k = smem_u32(bars + 1);
  const uint32_t bar_p = smem_u32(bars + 2);       // P of tile t: bar_p + 8·(t % 2)
  const uint32_t bar_s = smem_u32(bars + 4);       // dO and Q of tile t: bar_s + 8·(t % 3)
  const uint32_t bar_d = smem_u32(bars + 7);       // the D_c of tile t: bar_d + 8·(t % 2)
  const uint32_t bar_q = smem_u32(bars + 9);       // the dQ rows of tile t: bar_q + 8·(t % 2)

  const int rank = cluster_rank(), blocks = cluster_blocks();
  const uint16_t all = static_cast<uint16_t>((1u << blocks) - 1);
  const int key0 = rank * NC * TILE;            // this block's slab
  const int lim = a.lk - key0;                  // its real keys, where fewer than NC·64
  const int live = min(NC, (lim + TILE - 1) / TILE);   // its pieces that hold a real key
  // The warpgroup index broadcast from lane 0, so that the compiler sees the
  // branch below as warp-uniform (else it serializes every wgmma).
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0), wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);
  const int tiles = (a.lq + TILE - 1) / TILE;   // query tiles of a row
  const int rows = a.batch * a.heads;            // (batch, head) rows
  const int total = (rows - blockIdx.y + gridDim.y - 1) / gridDim.y * tiles;   // this cluster's tiles
  // Tile t of this cluster: of row blockIdx.y + (t / tiles)·G, its query tile t % tiles.
  auto row_of = [&](int t) { return static_cast<int>(blockIdx.y + (t / tiles) * gridDim.y); };
  const int qrow0 = share_row0(rank, blocks), qrow1 = share_row0(rank + 1, blocks);
  const uint32_t d_bytes = blocks * TILE * 4;
  // the dQ rows copied to this block for tile t: every block's real rows of its share
  auto q_bytes = [&](int t) {
    return blocks * share_rows(rank, blocks, a.lq - (t % tiles) * TILE) * TILE * 4;
  };

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();      // the swizzle needs 1024-byte tiles
    for (int i = 0; i < 11; ++i) mbar_init(bar_v + 8 * i, 1);
    fence_barrier_init();
    for (int t = 0; t < 2 && t < total; ++t) {   // the pushes of tiles 0 and 1
      mbar_expect_tx(bar_d + 8 * t, d_bytes);
      mbar_expect_tx(bar_q + 8 * t, q_bytes(t));
    }
  }
  // This block's P slab of tile t into stage t % 2; dO and Q of tile t into
  // stage t % 3: tiles 0 and 1 by the block's own copies, later ones once
  // for the cluster, issued by rank 0 (every block arms its barrier); K and
  // V of a row.
  auto load_p = [&](int t) {
    const int row = row_of(t);
    const uint32_t bar = bar_p + 8 * (t & 1);
    mbar_expect_tx(bar, live * TILE_BYTES);
    for (int c = 0; c < live; ++c)
      tma_load_3d(sp + ((t & 1) * NC + c) * TILE_BYTES, &a.p, bar, key0 + c * TILE,
                  (t % tiles) * TILE, row);
  };
  auto load_shared = [&](int t) {
    const int st = t % 3, row = row_of(t), h = row % a.heads, b = row / a.heads;
    const uint32_t bar = bar_s + 8 * st;
    mbar_expect_tx(bar, 2 * TILE_BYTES);
    if (t < 2) {
      tma_load_3d(sdo + st * TILE_BYTES, &a.dout, bar, h * HD, (t % tiles) * TILE, b);
      tma_load_3d(sq + st * TILE_BYTES, &a.q, bar, h * HD, (t % tiles) * TILE, b);
    } else if (rank == 0) {
      tma_load_3d_multicast(sdo + st * TILE_BYTES, &a.dout, bar, all, h * HD, (t % tiles) * TILE,
                            b);
      tma_load_3d_multicast(sq + st * TILE_BYTES, &a.q, bar, all, h * HD, (t % tiles) * TILE, b);
    }
  };
  auto load_kv = [&](const CUtensorMap* map, uint8_t* dst, uint32_t bar, int row) {
    mbar_expect_tx(bar, live * TILE_BYTES);
    for (int c = 0; c < live; ++c)
      tma_load_3d(dst + c * TILE_BYTES, map, bar, (row % a.heads) * HD, key0 + c * TILE,
                  row / a.heads);
  };
  if (tid == 0) {            // V, tile 0, K, tile 1
    load_kv(&a.v, sv, bar_v, blockIdx.y);
    load_p(0);
    load_shared(0);
    load_kv(&a.k, sk, bar_k, blockIdx.y);
    if (total > 1) {
      load_p(1);
      load_shared(1);
    }
  }
  // Every block's barriers must be set up before a push or a multicast
  // reaches them: arrived at now, waited for before the first push.
  cluster_arrive_relaxed();

  if (wg == 0) {
    // ----------------------------------- the rows: dP, D_c, D, dS, dQ_c
    const uint32_t k_addr = smem_u32(sk), v_addr = smem_u32(sv);
    const uint32_t hi_addr = smem_u32(shi), lo_addr = smem_u32(slo);
    const uint32_t xs_addr = smem_u32(xs), xq_addr = smem_u32(xq);
    const uint32_t xd_at = smem_u32(xd + rank * TILE + r0);   // this thread's D_c in every block
    const int mi = lane >> 3;
    const uint32_t frag = sw128(16 * warp + 8 * (mi & 1) + (lane & 7), mi >> 1, 0);
    for (int t = 0; t < total; ++t) {
      const int st = t & 1, s3 = t % 3, u = t % tiles, j = t / tiles;   // tile u of row j
      const bool next_row = u == tiles - 1 && t + 1 < total;
      mbar_wait(bar_p + 8 * st, (t >> 1) & 1);
      mbar_wait(bar_s + 8 * s3, (t / 3) & 1);
      if (u == 0) mbar_wait(bar_v, j & 1);

      // dP = dO·V_slabᵀ (V's rows past Lk are zeros) while the column
      // warpgroup finishes tile t − 1, D_c = rowsum(dP ∘ P) over the slab,
      // pushed to every block once the column warpgroup is done with tile
      // t − 1; D = Σ D_c in rank order; then dS.
      const RowTile rt{smem_u32(sdo + s3 * TILE_BYTES), v_addr,
                       smem_u32(sp + st * NC * TILE_BYTES), hi_addr, lo_addr, frag};
      float dp[NC][32];
      rt.dp_product(dp, 0, live);
      if (next_row && tid == 0) load_kv(&a.v, sv, bar_v, row_of(t + 1));   // V read for the row
      float d[2] = {0.f, 0.f};
      rt.rowsum(d, dp, 0, live);
      rt.finish_d(d);
      if (t > 0)
        named_sync(BAR_DS_EMPTY, THREADS);    // the column warpgroup is done with tile t − 1
      else
        cluster_wait();                       // every block's barriers are set up
      if ((lane & 3) == 0)
        for (int p = 0; p < blocks; ++p) {
          const uint32_t pb = mapa(bar_d + 8 * st, p);
          st_async(mapa(xd_at + st * BWD_XD_BYTES, p), d[0], pb);
          st_async(mapa(xd_at + st * BWD_XD_BYTES + 32, p), d[1], pb);
        }
      mbar_wait_cluster(bar_d + 8 * st, (t >> 1) & 1);   // every D_c
      float x[2][BWD_CLUSTER_MAX];            // every D_c loaded before the sum
#pragma unroll
      for (int p = 0; p < BWD_CLUSTER_MAX; ++p)
        if (p < blocks) {
          x[0][p] = xd[st * BWD_CLUSTER_MAX * TILE + p * TILE + r0];
          x[1][p] = xd[st * BWD_CLUSTER_MAX * TILE + p * TILE + r0 + 8];
        }
      d[0] = d[1] = 0.f;
#pragma unroll
      for (int p = 0; p < BWD_CLUSTER_MAX; ++p)
        if (p < blocks) {
          d[0] += x[0][p];
          d[1] += x[1][p];
        }
      rt.store_ds(dp, 0, d, live);
      fence_proxy_async();
      named_arrive(BAR_DS_FULL, 256);
      named_sync(BAR_ROWS, 128);

      // dQ_c = dS·K_slab, dS (K-major) hi then lo, K (MN-major) through the
      // transpose bit; staged (the staging tile of tile t − 2 was read:
      // every block has waited for those copies before pushing D_c of tile
      // t), and its rows copied to the blocks that sum them: by the column
      // warpgroup, off this chain, unless the rows have one query tile
      // (measured: the later copies then hold up the receivers more).
      if (u == 0) mbar_wait(bar_k, j & 1);
      float dq[32];
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NC; ++kk) {
        if (16 * kk >= lim) break;
        const uint32_t at = (kk >> 2) * TILE_BYTES + 32 * (kk & 3);
        const uint64_t kd = desc_sw128(k_addr + 2048 * kk);
        wgmma_m64n64k16_ss<0, 1>(dq, desc_sw128(hi_addr + at), kd, kk);
        wgmma_m64n64k16_ss<0, 1>(dq, desc_sw128(lo_addr + at), kd, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (u == tiles - 1) {                   // the row's dS and K are read
        named_arrive(BAR_DQ_DONE, 256);
        if (next_row && tid == 0) load_kv(&a.k, sk, bar_k, row_of(t + 1));
      }
      stage_partial(xs + st * XTILE, dq, r0, c2);
      fence_proxy_async();
      if (tiles > 1) {
        named_arrive(BAR_STAGED, 256);        // the column warpgroup copies it
      } else {                                // rows of one tile: the copies cannot wait
        named_sync(BAR_ROWS, 128);
        if (warp == 0)
          push_shares(xs_addr + st * XTILE, xq_addr + st * AREA, bar_q + 8 * st, rank, blocks,
                      a.lq, lane);
      }
    }
    cluster_arrive_relaxed();                 // the end (below): every push to this block waited for
  } else {
    // ------ the columns: dV and dK of the slab's pieces; the block's dQ rows
    const long long dm = static_cast<long long>(a.heads) * HD;
    // The dQ of tile t: this block's share of rows, summed over the cluster;
    // then the receive area is armed for tile t + 2.
    auto reduce_dq = [&](int t) {
      const int row = row_of(t);
      bf16* dqb = a.dq + static_cast<long long>(row / a.heads) * a.lq * dm + (row % a.heads) * HD;
      mbar_wait_cluster(bar_q + 8 * (t & 1), (t >> 1) & 1);
      reduce_share<BWD_CLUSTER_MAX>(xq + (t & 1) * AREA, blocks, qrow0, qrow1, a.scale,
                                    dqb + static_cast<long long>(t % tiles) * TILE * dm, dm,
                                    a.lq - (t % tiles) * TILE, wtid, 128);
      if (wtid == 0 && t + 2 < total) mbar_expect_tx(bar_q + 8 * (t & 1), q_bytes(t + 2));
    };
    cluster_wait();                           // every block's barriers are set up
    float dv[NC][32], dk[NC][32];             // a row's first products overwrite them
    const uint32_t hi_addr = smem_u32(shi), lo_addr = smem_u32(slo);
    const uint32_t xs_addr = smem_u32(xs), xq_addr = smem_u32(xq);
    for (int t = 0; t < total; ++t) {
      const int st = t & 1, s3 = t % 3, u = t % tiles;
      const int ksteps = (min(TILE, a.lq - u * TILE) + 15) / 16;   // query rows of the tile
      const uint32_t p_addr = smem_u32(sp + st * NC * TILE_BYTES);
      const uint32_t do_addr = smem_u32(sdo + s3 * TILE_BYTES);
      const uint32_t q_addr = smem_u32(sq + s3 * TILE_BYTES);
      mbar_wait(bar_p + 8 * st, (t >> 1) & 1);
      mbar_wait(bar_s + 8 * s3, (t / 3) & 1);

      // dV += Pᵀ·dO: Pᵀ (MN-major A) from P's tile, dO (MN-major B).
#pragma unroll
      for (int m = 0; m < NC; ++m) fence_regs(dv[m]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < NC; ++m)
        if (m < live)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < ksteps)
              wgmma_m64n64k16_ss<1, 1>(dv[m], desc_sw128(p_addr + m * TILE_BYTES + 2048 * kk),
                                       desc_sw128(do_addr + 2048 * kk), u > 0 || kk > 0);
      wgmma_commit();
      if (t > 0) reduce_dq(t - 1);              // while warpgroup 0 forms dS
      // Once every block's D_c of tile t has come (all are done with tile
      // t − 2): dO and Q of tile t + 1 into tile t − 2's stage.
      if (wtid == 0) {
        mbar_wait_cluster(bar_d + 8 * st, (t >> 1) & 1);
        if (t + 2 < total) mbar_expect_tx(bar_d + 8 * st, d_bytes);
        if (t >= 1 && t + 1 < total) load_shared(t + 1);
      }

      // dK += dSᵀ·Q once warpgroup 0 has written dS: hi, then lo.
      named_sync(BAR_DS_FULL, 256);
#pragma unroll
      for (int m = 0; m < NC; ++m) fence_regs(dk[m]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < NC; ++m)
        if (m < live)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < ksteps) {
              const uint32_t at = m * TILE_BYTES + 2048 * kk;
              const uint64_t qd = desc_sw128(q_addr + 2048 * kk);
              wgmma_m64n64k16_ss<1, 1>(dk[m], desc_sw128(hi_addr + at), qd, u > 0 || kk > 0);
              wgmma_m64n64k16_ss<1, 1>(dk[m], desc_sw128(lo_addr + at), qd, 1);
            }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        fence_regs(dv[m]);
        fence_regs(dk[m]);
      }
      // Warpgroup 0's dQ partial of tile t, staged: its rows to the blocks
      // that sum them, one lane a peer (rows of more than one tile).
      if (tiles > 1) {
        named_sync(BAR_STAGED, 256);
        if (warp == 0)
          push_shares(xs_addr + st * XTILE, xq_addr + st * AREA, bar_q + 8 * st, rank, blocks,
                      a.lq - u * TILE, lane);
      }

      if (u == tiles - 1) {
        // The row's dV and dK out: staged over the dS tiles once warpgroup
        // 0's dQ has read them, one TMA store per piece with a real key
        // (rows ≥ Lk dropped), read before warpgroup 0 writes dS again.
        const int row = row_of(t);
        named_sync(BAR_DQ_DONE, 256);
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          uint8_t* sdv = shi + m * TILE_BYTES;
          uint8_t* sdk = slo + m * TILE_BYTES;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint32_t at = sw128(r0 + 8 * r, jj, c2);
              *reinterpret_cast<uint32_t*>(sdv + at) =
                  segclip_tc::pack(dv[m][4 * jj + 2 * r], dv[m][4 * jj + 2 * r + 1]);
              *reinterpret_cast<uint32_t*>(sdk + at) = segclip_tc::pack(
                  dk[m][4 * jj + 2 * r] * a.scale, dk[m][4 * jj + 2 * r + 1] * a.scale);
            }
        }
        fence_proxy_async();
        named_sync(BAR_COLS, 128);
        if (wtid == 0) {
          for (int m = 0; m < live; ++m) {
            tma_store_3d(&a.dv, shi + m * TILE_BYTES, (row % a.heads) * HD, key0 + m * TILE,
                         row / a.heads);
            tma_store_3d(&a.dk, slo + m * TILE_BYTES, (row % a.heads) * HD, key0 + m * TILE,
                         row / a.heads);
          }
          bulk_commit();
          bulk_wait_read<0>();                // the dS tiles stay until the stores read them
        }
      }
      // Both warpgroups are done with P of tile t (warpgroup 0 before it
      // handed dS over): its stage takes tile t + 2.
      if (wtid == 0 && t + 2 < total) load_p(t + 2);
      if (t + 1 < total) named_arrive(BAR_DS_EMPTY, THREADS);
    }
    reduce_dq(total - 1);
    cluster_arrive_relaxed();                 // the end (below): every copy to this block landed
  }
  cluster_wait();           // no block leaves while a copy from its shared memory may be on its way
}

// Launches the cluster backward, or with `active` set asks how many of its
// clusters the card holds at once.
// Launches the cluster backward, G = min(B·H, the clusters the card holds
// at once) clusters; or with `active` set only reports that count.
int launch_bwd_cluster(const ClusterArgs& a, cudaStream_t stream, int* active) {
  const auto kernel = attention_bwd_cluster_kernel;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool raised[64] = {};                // the shared-memory limit, once per device
  static int resident[64][BWD_CLUSTER_MAX + 1] = {};   // clusters held at once, by their blocks
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bwd_cluster_smem());
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[device] = true;
  }
  const int blocks = bwd_cluster_blocks(a.lk);
  int& held = resident[device][blocks];
  if (!held) {
    err = launch_clusters(kernel, a, dim3(blocks, 1), blocks, BWD_CLUSTER_THREADS,
                          bwd_cluster_smem(), stream, &held);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (active) {
    *active = held;
    return 0;
  }
  if (held < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rows = a.batch * a.heads;
  err = launch_clusters(kernel, a, dim3(blocks, rows < held ? rows : held), blocks,
                        BWD_CLUSTER_THREADS, bwd_cluster_smem(), stream, nullptr);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ---------------------------------------------------------------- float32

// pass (a)
constexpr int QT = 16;                         // query rows per block
constexpr int KT = 64;                         // key rows per shared tile
constexpr int THREADS_A = 128;
constexpr int LANES = THREADS_A / QT;          // threads per query row: 8
constexpr int COLS = KT / LANES;               // score columns per thread: 8
constexpr int DIMS = HD / LANES;               // dQ dims per thread: 8
// pass (b)
constexpr int KB = 64;                         // key rows per block
constexpr int QB = 32;                         // query rows per shared tile
constexpr int THREADS_B = 256;
constexpr int SPLIT = THREADS_B / KB;          // threads per key row: 4
constexpr int DPT = HD / SPLIT;                // dK/dV dims per thread: 16

// Rows [row0, row0 + KT) of one head's (L, 64) slice into shared memory,
// zero past `rows`.
__device__ __forceinline__ void load_tile(float (*dst)[HD + 1], const float* src,
                                          long long rs, int row0, int rows) {
  for (int e = threadIdx.x; e < KT * HD; e += THREADS_A) {
    const int r = e / HD, c = e % HD;
    const int gr = row0 + r;
    dst[r][c] = gr < rows ? src[gr * rs + c] : 0.f;
  }
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, LANES);
  return x;
}

__device__ __forceinline__ float dot64(const float (&a)[HD], const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// Pass (a): D and dQ. Grid (ceil(Lq / QT), H, B).
__global__ void __launch_bounds__(THREADS_A) attention_bwd_dq_simt_kernel(Args a) {
  __shared__ float dos[QT][HD + 1];
  __shared__ float ks[KT][HD + 1];
  __shared__ float vs[KT][HD + 1];
  __shared__ float dss[QT][KT + 1];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x;
  const int row = tid / LANES, lane = tid % LANES;
  const int qrow = q0 + row;

  const float* dop = static_cast<const float*>(a.dout) + b * a.do_bs + h * HD;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_bs + h * HD;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_bs + h * HD;

  for (int e = tid; e < QT * HD; e += THREADS_A) {
    const int r = e / HD, c = e % HD;
    dos[r][c] = q0 + r < a.lq ? dop[(q0 + r) * a.do_rs + c] : 0.f;
  }
  __syncthreads();
  float dor[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dor[d] = dos[row][d];

  const int prow = qrow < a.lq ? qrow : a.lq - 1;       // rows past Lq are never stored
  const float* pp = static_cast<const float*>(a.p) + b * a.p_bs + h * a.p_hs + prow * a.p_rs;

  // D = Σ_j P_ij (dO_i · V_j)
  float dsum = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += KT) {
    __syncthreads();
    load_tile(vs, vp, a.v_rs, k0, a.lk);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = lane + LANES * j;
      if (k0 + c < a.lk) dsum = fmaf(pp[k0 + c], dot64(dor, vs[c]), dsum);
    }
  }
  const float drow = row_sum(dsum);
  if (lane == 0 && qrow < a.lq)
    a.drow[(static_cast<long long>(b) * a.heads + h) * a.d_rs + qrow] = drow;

  // dS = P (dP − D); dQ = dS·K, scaled at the end
  float acc[DIMS];
#pragma unroll
  for (int j = 0; j < DIMS; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += KT) {
    __syncthreads();
    load_tile(ks, kp, a.k_rs, k0, a.lk);
    load_tile(vs, vp, a.v_rs, k0, a.lk);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = lane + LANES * j;
      float ds = 0.f;
      if (k0 + c < a.lk) ds = pp[k0 + c] * (dot64(dor, vs[c]) - drow);
      dss[row][c] = ds;
    }
    __syncwarp();
    const int kmax = min(KT, a.lk - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float ds = dss[row][kk];
#pragma unroll
      for (int j = 0; j < DIMS; ++j) acc[j] = fmaf(ds, ks[kk][lane + LANES * j], acc[j]);
    }
  }

  if (qrow < a.lq) {
    float* dqp = static_cast<float*>(a.dq) +
                 (static_cast<long long>(b) * a.lq + qrow) * (a.heads * HD) + h * HD;
#pragma unroll
    for (int j = 0; j < DIMS; ++j) dqp[lane + LANES * j] = acc[j] * a.scale;
  }
}

// Pass (b): dK and dV. Grid (ceil(Lk / KB), H, B). Thread `part` of key row
// `key` owns dims part + SPLIT·t, t < DPT (interleaved, so the four threads
// of a key read four different shared-memory banks).
__global__ void __launch_bounds__(THREADS_B) attention_bwd_dkv_simt_kernel(Args a) {
  __shared__ float dos[QB][HD];
  __shared__ float qs[QB][HD];
  __shared__ float ps[QB][KB + 1];
  __shared__ float dtile[QB];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * KB;
  const int tid = threadIdx.x;
  const int key = tid / SPLIT, part = tid % SPLIT;
  const int krow = k0 + key;

  const float* dop = static_cast<const float*>(a.dout) + b * a.do_bs + h * HD;
  const float* qp = static_cast<const float*>(a.q) + b * a.q_bs + h * HD;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_bs + h * HD;
  const float* pp = static_cast<const float*>(a.p) + b * a.p_bs + h * a.p_hs;
  const float* dp_row = a.drow + (static_cast<long long>(b) * a.heads + h) * a.d_rs;

  float vr[DPT], dk[DPT], dv[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    vr[t] = krow < a.lk ? vp[krow * a.v_rs + part + SPLIT * t] : 0.f;
    dk[t] = 0.f;
    dv[t] = 0.f;
  }

  for (int i0 = 0; i0 < a.lq; i0 += QB) {
    __syncthreads();
    for (int e = tid; e < QB * HD; e += THREADS_B) {
      const int r = e / HD, c = e % HD;
      const bool ok = i0 + r < a.lq;
      dos[r][c] = ok ? dop[(i0 + r) * a.do_rs + c] : 0.f;
      qs[r][c] = ok ? qp[(i0 + r) * a.q_rs + c] : 0.f;
    }
    for (int e = tid; e < QB * KB; e += THREADS_B) {
      const int r = e / KB, c = e % KB;
      ps[r][c] = i0 + r < a.lq && k0 + c < a.lk ? pp[(i0 + r) * a.p_rs + k0 + c] : 0.f;
    }
    if (tid < QB) dtile[tid] = i0 + tid < a.lq ? dp_row[i0 + tid] : 0.f;
    __syncthreads();

    const int imax = min(QB, a.lq - i0);
    for (int i = 0; i < imax; ++i) {
      float dor[DPT];
      float dpart = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        dor[t] = dos[i][part + SPLIT * t];
        dpart = fmaf(dor[t], vr[t], dpart);
      }
#pragma unroll
      for (int off = SPLIT / 2; off > 0; off >>= 1)
        dpart += __shfl_xor_sync(0xffffffffu, dpart, off, SPLIT);
      const float p = ps[i][key];
      const float ds = p * (dpart - dtile[i]);
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        dv[t] = fmaf(p, dor[t], dv[t]);
        dk[t] = fmaf(ds, qs[i][part + SPLIT * t], dk[t]);
      }
    }
  }

  if (krow < a.lk) {
    const long long o = (static_cast<long long>(b) * a.lk + krow) * (a.heads * HD) + h * HD;
    float* dkp = static_cast<float*>(a.dk) + o;
    float* dvp = static_cast<float*>(a.dv) + o;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      dkp[part + SPLIT * t] = dk[t] * a.scale;
      dvp[part + SPLIT * t] = dv[t];
    }
  }
}

int launch_bf16(const Args& a, int batch, cudaStream_t s) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_dq_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(PA_SMEM_MAX));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(attention_bwd_dkv_bf16_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(PB_SMEM));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attention_bwd_dq_bf16_kernel<<<dim3(cdiv(a.lq, BR), a.heads, batch), THREADS_TC,
                                 pa_smem(a.lk), s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_bf16_kernel<<<dim3(cdiv(a.lk, BR), a.heads, batch), THREADS_TC, PB_SMEM,
                                  s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Args& a, int batch, cudaStream_t s) {
  attention_bwd_dq_simt_kernel<<<dim3(cdiv(a.lq, QT), a.heads, batch), THREADS_A, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_simt_kernel<<<dim3(cdiv(a.lk, KB), a.heads, batch), THREADS_B, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace segclip_kernels

using namespace segclip_kernels;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (P, dO, Q, K, V, dQ, dK, dV all in it).
// Strides are in elements. drow is a (B, H, (Lq + 3) / 4 · 4) fp32 scratch.
// At bfloat16 the wrapper guarantees 16-byte alignment of p, dO, q, k, v
// and of their strides. Returns the cudaError_t of the launches (0 on
// success).
int segclip_attention_bwd(int dtype, const void* p, const void* dout, const void* q,
                          const void* k, const void* v, void* dq, void* dk, void* dv,
                          void* drow, int batch, int heads, int lq, int lk, long long p_bs,
                          long long p_hs, long long p_rs, long long do_bs, long long do_rs,
                          long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                          long long v_bs, long long v_rs, float scale, void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{p, dout, q, k, v, dq, dk, dv, static_cast<float*>(drow), heads, lq, lk,
         p_bs, p_hs, p_rs, do_bs, do_rs, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
         (lq + 3) / 4 * 4, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, batch, s);
  if (dtype == 1) return launch_bf16(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The longest Lk that `segclip_attention_bwd_one_pass` takes.
int segclip_attention_bwd_one_pass_limit() { return BWD_ONE_PASS_LIMIT; }

// The bf16 one-pass backward, for 1 ≤ Lk ≤ BWD_ONE_PASS_LIMIT. Strides are
// in elements; the wrapper guarantees 16-byte aligned p, dO, q, k, v and
// strides, and P's rows padded to a multiple of 8 elements (p_rs ≥ Lk). P's
// batch and head dims are read as one (B·H) dim: p_bs = H·p_hs unless B or H
// is 1. dq, dk, dv are contiguous (B, L, H·64). Returns the cudaError_t of
// the launch (0 on success).
int segclip_attention_bwd_one_pass(const void* p, const void* dout, const void* q,
                                   const void* k, const void* v, void* dq, void* dk, void* dv,
                                   int batch, int heads, int lq, int lk, long long p_bs,
                                   long long p_hs, long long p_rs, long long do_bs,
                                   long long do_rs, long long q_bs, long long q_rs,
                                   long long k_bs, long long k_rs, long long v_bs,
                                   long long v_rs, float scale, void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || lk > BWD_ONE_PASS_LIMIT || batch > 65535 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lq > 1 && (p_rs < lk || p_rs % 8)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 1 && heads > 1 && p_bs != heads * p_hs)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long dm = static_cast<long long>(heads) * HD;
  const long long p_bh = heads > 1 ? p_hs : p_bs;        // the stride of the B·H dim
  OnePassArgs a{};
  const bool ok =
      encode_bf16_3d(&a.p, p, lk, lq, static_cast<uint64_t>(batch) * heads, p_rs, p_bh) &&
      encode_bf16_3d(&a.dout, dout, dm, lq, batch, do_rs, do_bs) &&
      encode_bf16_3d(&a.q, q, dm, lq, batch, q_rs, q_bs) &&
      encode_bf16_3d(&a.k, k, dm, lk, batch, k_rs, k_bs) &&
      encode_bf16_3d(&a.v, v, dm, lk, batch, v_rs, v_bs) &&
      encode_bf16_3d(&a.dk, dk, dm, lk, batch, dm, dm * lk) &&
      encode_bf16_3d(&a.dv, dv, dm, lk, batch, dm, dm * lk);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.dq = static_cast<bf16*>(dq);
  a.heads = heads;
  a.lq = lq;
  a.lk = lk;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((lk + TILE - 1) / TILE) {
    case 1: return launch_bwd_one_pass<1>(a, batch, s);
    case 2: return launch_bwd_one_pass<2>(a, batch, s);
    case 3: return launch_bwd_one_pass<3>(a, batch, s);
    default: return launch_bwd_one_pass<4>(a, batch, s);
  }
}

// The longest Lk that `segclip_attention_bwd_cluster` takes.
int segclip_attention_bwd_cluster_limit() { return BWD_CLUSTER_LIMIT; }

// The cluster that `segclip_attention_bwd_cluster` launches for rows of lk
// keys (BWD_ONE_PASS_LIMIT < lk ≤ BWD_CLUSTER_LIMIT) over batch·heads
// (batch, head) rows: its blocks, the keys of a block's slab, the dynamic
// shared memory of a block, and how many such clusters the current card
// holds at once (0: it cannot launch). Returns a cudaError_t.
int segclip_attention_bwd_cluster_shape(int lk, long long batch_heads, int* blocks, int* slab,
                                        int* smem, int* active) {
  if (lk <= BWD_ONE_PASS_LIMIT || lk > BWD_CLUSTER_LIMIT || batch_heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *blocks = bwd_cluster_blocks(lk);
  *slab = BWD_SLAB * TILE;
  *smem = bwd_cluster_smem();
  ClusterArgs a{};
  a.batch = a.heads = 1;
  a.lk = lk;
  return launch_bwd_cluster(a, nullptr, active);
}

// The bf16 cluster backward, for BWD_ONE_PASS_LIMIT < Lk ≤ BWD_CLUSTER_LIMIT,
// with the arguments and guarantees of `segclip_attention_bwd_one_pass`.
// Returns the cudaError_t of the launch (0 on success).
int segclip_attention_bwd_cluster(const void* p, const void* dout, const void* q, const void* k,
                                  const void* v, void* dq, void* dk, void* dv, int batch,
                                  int heads, int lq, int lk, long long p_bs, long long p_hs,
                                  long long p_rs, long long do_bs, long long do_rs,
                                  long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                                  long long v_bs, long long v_rs, float scale, void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk <= BWD_ONE_PASS_LIMIT || lk > BWD_CLUSTER_LIMIT ||
      batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lq > 1 && (p_rs < lk || p_rs % 8)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 1 && heads > 1 && p_bs != heads * p_hs)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long dm = static_cast<long long>(heads) * HD;
  const long long p_bh = heads > 1 ? p_hs : p_bs;        // the stride of the B·H dim
  ClusterArgs a{};
  const bool ok =
      encode_bf16_3d(&a.p, p, lk, lq, static_cast<uint64_t>(batch) * heads, p_rs, p_bh) &&
      encode_bf16_3d(&a.dout, dout, dm, lq, batch, do_rs, do_bs) &&
      encode_bf16_3d(&a.q, q, dm, lq, batch, q_rs, q_bs) &&
      encode_bf16_3d(&a.k, k, dm, lk, batch, k_rs, k_bs) &&
      encode_bf16_3d(&a.v, v, dm, lk, batch, v_rs, v_bs) &&
      encode_bf16_3d(&a.dk, dk, dm, lk, batch, dm, dm * lk) &&
      encode_bf16_3d(&a.dv, dv, dm, lk, batch, dm, dm * lk);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.dq = static_cast<bf16*>(dq);
  a.batch = batch;
  a.heads = heads;
  a.lq = lq;
  a.lk = lk;
  a.scale = scale;
  return launch_bwd_cluster(a, static_cast<cudaStream_t>(stream), nullptr);
}

}  // extern "C"
