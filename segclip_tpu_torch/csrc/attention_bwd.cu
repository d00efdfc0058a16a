// Attention backward from the saved probabilities, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of segclip_tpu/ops/pallas/attention.py
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
// as they are); dQ, dK, dV are contiguous (B, L, H·64). D goes through a
// (B, H, Lq4) fp32 scratch, Lq4 = Lq rounded up to 4.
//
// The TPU kernel carries a whole (batch, head pair) in VMEM and reduces dK
// and dV over all query rows inside one program. Blocks on Hopper run in no
// order, so that reduction cannot be carried across blocks, and float
// atomics would make the gradients change from run to run. Two passes with
// no atomics keep them bit-reproducible:
//   (a) one block per (b, h, query rows): D, written to the scratch, then
//       dS and dQ;
//   (b) one block per (b, h, key rows): dV and dK, with dS rebuilt from P,
//       dO, V and D.
//
// bfloat16, `attention_bwd_{dq,dkv}_bf16_kernel` (the path of the model).
// What bounds it on the H100: bytes. At 96×196, H = 12, P, dO, Q, K and V
// read and dQ, dK and dV written are 291 MB (0.087 ms at 3.35 TB/s) against
// 22.7 GFLOP (0.023 ms at 989 TFLOP/s bf16). The design:
//   - blocks of 64 rows, four warps of 16; every product on tensor cores
//     (`mma.sync.m16n8k16`, tc_bf16.cuh) with fp32 accumulators;
//   - dO, Q, K, V and P tiles staged in shared memory by `cp.async`,
//     double-buffered, zero-filled past Lq and Lk; P is read in coalesced
//     16-byte pieces;
//   - pass (a) keeps its 64 P rows in shared memory while Lk ≤ 512
//     (PA_CACHE_TILES), so it reads each P tile once; it computes dP = dO·Vᵀ
//     twice, once for D and once for dS, since D needs the whole row first
//     (on tensor cores that costs FLOPs, not bytes). Above that Lk it streams
//     P twice;
//   - pass (b) reads Pᵀ fragments with `ldmatrix.trans`, rebuilds dPᵀ = V·dOᵀ
//     on tensor cores, and sums dV and dK in fp32 registers;
//   - dS is fp32. Rounded to bf16 before dS·K and dSᵀ·Q it would move dQ and
//     dK by about 0.3 bf16 ulp on average, so it is split into bf16 hi + lo
//     parts and each product is two MMAs: fp32-exact to about 2^-17. dV = PᵀdO
//     and dP = dO·Vᵀ take bf16 operands (P, dO, V), whose products are exact.
//
// float32, `attention_bwd_{dq,dkv}_simt_kernel`: the parity path, fp32 FMAs
// (no TF32). Pass (a) takes 16 query rows per block and walks the keys
// twice in 64-row tiles (D, then dS and dQ); pass (b) takes 64 key rows and
// walks the queries in 32-row tiles.
//
// Masks: query rows at or past Lq and key rows at or past Lk are never
// stored and read as zeros (P = 0 there, so they add nothing). Entries that
// the causal mask removed have P = 0 and add nothing either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
constexpr int TILE = BR * LDS;                 // elements of one staged tile
constexpr int PA_CACHE_TILES = 8;              // pass (a) keeps P rows while Lk ≤ 512

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Pass (a)'s shared memory: K and V double buffers, then P (the block's
// whole rows, or a double buffer when they do not fit).
__host__ __device__ inline bool pa_cached(int lk) { return cdiv(lk, BR) <= PA_CACHE_TILES; }
__host__ __device__ inline int pa_plds(int lk) {
  return pa_cached(lk) ? cdiv(lk, BR) * BR + 8 : LDS;
}
__host__ __device__ inline size_t pa_smem(int lk) {
  return sizeof(bf16) * (4 * TILE + (pa_cached(lk) ? BR * pa_plds(lk) : 2 * TILE));
}
constexpr size_t PA_SMEM_MAX = sizeof(bf16) * (4 * TILE + BR * (PA_CACHE_TILES * BR + 8));
constexpr size_t PB_SMEM = sizeof(bf16) * 6 * TILE + sizeof(float) * 2 * BR;

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Pass (a): D and dQ. Grid (⌈Lq / 64⌉, H, B), dynamic shared memory pa_smem(Lk).
__global__ void __launch_bounds__(THREADS_TC) attention_bwd_dq_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);            // [2][TILE]; sk[0] first holds dO
  bf16* sv = sk + 2 * TILE;                                  // [2][TILE]
  bf16* sp = sv + 2 * TILE;                                  // P rows or [2][TILE]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int tiles = cdiv(a.lk, BR);
  const bool cached = pa_cached(a.lk);
  const int plds = pa_plds(a.lk);
  auto p_tile = [&](int t) { return cached ? sp + t * BR : sp + (t & 1) * TILE; };

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
      segclip_tc::load_rows<BR, THREADS_TC>(sv + ((t + 1) & 1) * TILE, vp, a.v_rs,
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
      segclip_tc::mma_abt(dp, dof, sv + (t & 1) * TILE, lane, ncols);
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
      segclip_tc::load_rows<BR, THREADS_TC>(sk + nb * TILE, kp, a.k_rs, (t + 1) * BR, a.lk);
      segclip_tc::load_rows<BR, THREADS_TC>(sv + nb * TILE, vp, a.v_rs, (t + 1) * BR, a.lk);
      if (!cached) load_p(t + 1);
      segclip_tc::cp_async_commit();
      segclip_tc::cp_async_wait<1>();
    } else {
      segclip_tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int ncols = min(BR, a.lk - t * BR);
    if (active) {
      segclip_tc::mma_abt(dp, dof, sv + (t & 1) * TILE, lane, ncols);
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
        segclip_tc::mma_ab_step(acc, hi, sk + (t & 1) * TILE, kk, lane);
        segclip_tc::mma_ab_step(acc, lo, sk + (t & 1) * TILE, kk, lane);
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
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);            // [2][TILE]
  bf16* sdo = sq + 2 * TILE;                                 // [2][TILE]
  bf16* sp = sdo + 2 * TILE;                                 // [2][TILE]; sp[1] first holds V
  float* sd = reinterpret_cast<float*>(sp + 2 * TILE);      // [2][BR]

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
    segclip_tc::load_rows<BR, THREADS_TC>(sq + nb * TILE, qp, a.q_rs, i0, a.lq);
    segclip_tc::load_rows<BR, THREADS_TC>(sdo + nb * TILE, dop, a.do_rs, i0, a.lq);
    segclip_tc::load_block<BR, THREADS_TC>(sp + nb * TILE, LDS, pp, a.p_rs, i0, a.lq, k0, a.lk);
    if (threadIdx.x < BR / 4) {
      const int r = i0 + 4 * threadIdx.x;
      int bytes = 4 * (a.lq - r);
      bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
      segclip_tc::cp_async16(sd + nb * BR + 4 * threadIdx.x, bytes ? dr + r : dr, bytes);
    }
  };

  segclip_tc::load_rows<BR, THREADS_TC>(sp + TILE, vp, a.v_rs, k0, a.lk);
  load_tile(0);
  segclip_tc::cp_async_commit();
  segclip_tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t vf[4][4];
  segclip_tc::load_a_rows(vf, sp + TILE, warp, lane);
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
    const bf16* tq = sq + (i & 1) * TILE;
    const bf16* tdo = sdo + (i & 1) * TILE;
    const bf16* tp = sp + (i & 1) * TILE;
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

}  // extern "C"
