// Attention backward from the saved probabilities for rows too long for the
// cluster kernels, for Hopper (sm_90a): bfloat16 rows of more than 1024 keys
// ("long") and float32 rows of more than 256 keys ("tf32x3_long").
//
// Replaces the TPU kernel `_bwd_kernel` of segclip_tpu/ops/pallas/attention.py:96
// (reached through `_call_bwd`, pallas_call at :203, VJP at :217-247) for
// those rows: the float32 ViT-L/14 step's cross rows (264 keys), a float32
// 448 px step's 784 and 792, a bf16 672 px step's 1764 and 1772.
// `ops/kernels/attention.bwd_route` sends every bf16 call with Lk ≥
// BWD_LONG_MIN_LK here (`segclip_attention_bwd_long`) and every float32 call
// with Lk ≥ BWD_TF32X3_LONG_MIN_LK (`segclip_attention_bwd_tf32x3_long`);
// attention_bwd.cu's two-pass pairs, which took these rows before (the
// `mma.sync` pair for bf16, the SIMT pair on fp32 FMAs for float32), are
// reached by no route.
//
// What it computes, per batch and head, from P (the forward's (Lq, Lk)
// probabilities), dO, Q, K and V, with attention_bwd.cu's formulas and dtype
// chains: dV = Pᵀ·dO, dP = dO·Vᵀ, D_i = rowsum(dP ∘ P)_i, dS = P ∘ (dP − D),
// dQ = dS·K·scale, dK = dSᵀ·Q·scale, all summed in fp32; at bf16 dS is split
// into bf16 hi + lo parts before dS·K and dSᵀ·Q (attention_bwd.cu:24-30), at
// float32 every product is fp32-accurate on TF32 tensor cores (hi =
// cvt.rna.tf32(x), lo = that of x − hi; lo·hi + hi·lo + hi·hi per 8-wide
// k-step; attention_bwd_tf32x3.cu). P is read through the forward's padded
// (B, H, Lq, Lk8) view by its strides: its TMA map is Lk wide, so columns
// past Lk read as zeros whatever the padding holds.
//
// What bounds it on the H100 (ops/kernels/bounds.py): bytes. At bf16 4×1764,
// H = 12 (the 672 px step's vision rows), P (299 MB), dO, Q, K, V read and
// dQ, dK, dV written are 375 MB, 0.112 ms at 3.35 TB/s, against 76 GFLOP
// (0.077 ms at 989 TFLOP/s). At float32 2×784, H = 12, the 7.6 GFLOP of
// fp32-accurate products (0.046 ms at 495 / 3 TFLOP/s) bound it before the
// 93 MB (0.028 ms). The rows do not fit one SM, nor one portable cluster of
// eight (the cluster kernels' design), and blocks cannot sum dK and dV over
// query tiles, nor dQ over key slabs, without atomics or a second pass. So
// each route is two launches, with D passed through a (B·H, Lq4) fp32
// scratch (Lq4 = Lq rounded up to 4) that the wrapper allocates:
//   1. the row pass, one block per (batch, head, 64-row query tile): it
//      walks the row's 64-key pieces twice through a TMA ring, first for D =
//      Σ rowsum(dP ∘ P) (dP = dO·Vᵀ per piece), then for dS = P ∘ (dP − D)
//      and dQ += dS·K; it writes D and dQ once;
//   2. the slab pass, one block per (batch, head, key slab): it walks the
//      query tiles, dPᵀ = V·dOᵀ, dSᵀ = Pᵀ ∘ (dPᵀ − D) with D from the
//      scratch, dV += Pᵀ·dO and dK += dSᵀ·Q in fp32 registers, and writes dK
//      and dV once.
// It reads P three times where the bound counts it once (1.0 GB at 4×1764
// bf16: about 2.6 times the bound's bytes), and forms dP twice in the row
// pass and dPᵀ once more in the slab pass (six products where the bound
// counts four). The other schedule, per-slab dQ partials summed by a third
// launch, would write and read an fp32 dQ per 128-key slab instead: 0.61 GB
// at 4×1764, against the 0.60 GB of P's two extra reads, and a third launch.
// No atomics: every sum runs in a fixed order that depends on Lq and Lk
// alone, never on the batch, the heads or the grid, so the gradients are the
// same bits from run to run.
//
// The bf16 route (`attention_bwd_long_rows_kernel<NWG>`,
// `attention_bwd_long_cols_kernel`), on `wgmma` with TMA:
//   - row pass: NWG warpgroups take every NWG-th 64-key piece (NWG = 2; 4
//     for rows of one query tile, the cross blocks' 8 queries, whose row
//     pass has only B·H blocks), as attention_fwd_long.cu does. Each has a
//     TMA ring of V, P (walk 1) and V, P, K (walk 2) pieces. dP = dO·Vᵀ is
//     K-major on both sides, as the forward's Q·Kᵀ; P is read at the
//     accumulator's places as bf16 pairs; dS's hi and lo pairs are the
//     register A operand of dQ += dS·K, K read MN-major through the
//     transpose bit (the forward's P·V). The warpgroups' D and dQ partials
//     are summed through shared memory in warpgroup order;
//   - slab pass: a block owns a 128-key slab, each of its two warpgroups one
//     64-key piece, with dO, Q and P of a query tile shared through a
//     three-stage TMA ring. dPᵀ = V·dOᵀ (both K-major); Pᵀ comes by
//     `ldmatrix.trans` straight into the register A layout (the two-pass
//     pair does the same on `mma.sync`), dSᵀ = Pᵀ ∘ (dPᵀ − D) is split in
//     registers, and dV += Pᵀ·dO and dK += dSᵀ·Q take dO and Q MN-major
//     through the transpose bit. dK and dV leave from registers.
//
// The float32 route (`attention_bwd_tf32x3_long_rows_kernel`,
// `attention_bwd_tf32x3_long_cols_kernel`), on TF32 `wgmma` with TMA. TF32
// reads 32-bit shared operands K-major only, with no transpose bit, so:
//   - row pass: both warpgroups take every piece, each 32 of its 64 keys
//     (m64n32 products; one 64-row tile of dP a warpgroup, as
//     attention_bwd_tf32x3.cu found, needs more registers than a thread
//     has). Per piece the block splits V in place (hi over the raw tile, lo
//     beside it) and transposes and splits K into Kᵀ (hopper.cuh `transpose_split`: keys permuted in each
//     8-key step so that dS's accumulator registers are the A fragments of
//     dS·K without moving); dP = dO·Vᵀ with dO split once; dQ += dS·K over
//     the warpgroup's 32 keys, the two warpgroups' partials added at the
//     end, warpgroup 0's first. Two stages of V, P and K in the ring;
//   - slab pass: attention_bwd_tf32x3.cu's per-block column work over a
//     64-key slab with its cluster exchanges removed: the two warpgroups
//     split each query tile's rows (m64n32), dPᵀ = V·dOᵀ, P read at the
//     accumulator's places serves dSᵀ and the A fragments of dV += Pᵀ·dO,
//     dSᵀ those of dK += dSᵀ·Q, and dOᵀ and Qᵀ are transposed and split by
//     the threads. D comes from the scratch; dQ is the row pass's;
//   - each piece's dS·K and each tile's Pᵀ·dO and dSᵀ·Q are added to dQ, dV
//     and dK on the CUDA cores: the tensor cores' own fp32 accumulation
//     keeps fewer bits than an IEEE add, and over a row of a thousand keys
//     its error, left to them, came close to the float32 tolerance.
//
// Shared memory: bf16 row pass 156 KB (NWG = 2, three stages) or 206 KB
// (NWG = 4, two stages), slab pass 113 KB; float32 row pass 193 KB, slab
// pass 128 KB; one block per SM each.
//
// Masks: rows past Lq or Lk read as zeros (the copies fill them) and are
// never stored; D past Lq reads as 0. A fully masked row (P = NaN) gives NaN
// in dQ's row and in every row of dK and dV, as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tc_bf16.cuh"

namespace segclip_kernels {
namespace {

using namespace segclip_hopper;
using segclip_tc::bf16;

// The shortest rows each route takes: past attention_bwd.cu's
// BWD_CLUSTER_LIMIT (bf16) and attention_bwd_tf32x3.cu's BWD_TF32X3_LIMIT
// (float32).
constexpr int BWD_LONG_MIN_LK = 1025;
constexpr int BWD_TF32X3_LONG_MIN_LK = 257;
constexpr int HDIM = 64;
constexpr int WG = 128;                            // threads of a warpgroup

struct LongBwdArgs {
  CUtensorMap p;             // (Lk, Lq, B·H), the saved probabilities
  CUtensorMap dout, q;       // (H·64, Lq, B) over the operands' own strides
  CUtensorMap k, v;          // (H·64, Lk, B)
  void *dq, *dk, *dv;        // (B, L, H·64) contiguous, in the operands' dtype
  float* drow;               // (B·H, d_rs): D
  int heads, lq, lk, d_rs;
  float scale;
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// D of query rows q and q + 1 (q even) from the scratch row `dr`; 0 at or
// past Lq (the scratch holds no value there).
__device__ __forceinline__ float2 d_pair(const float* dr, int q, int lq) {
  if (q >= lq) return make_float2(0.f, 0.f);
  float2 d = *reinterpret_cast<const float2*>(dr + q);
  if (q + 1 >= lq) d.y = 0.f;
  return d;
}

// ------------------------------------------------------------------ bf16

// Row pass: a ring stage holds a piece's V, P and K tiles.
constexpr int ROW_STAGE = 3 * TILE_BYTES;
template <int NWG>
struct RowsSmem {
  static constexpr int STAGES = NWG == 2 ? 3 : 2;
  static constexpr int RING = TILE_BYTES;                          // after the dO tile
  static constexpr int STATS = RING + NWG * STAGES * ROW_STAGE;    // D partials [wg][row]
  static constexpr int BARS = STATS + NWG * TILE * 4;              // dO, then the rings' stages
  static constexpr int TOTAL = BARS + 8 * (1 + NWG * STAGES);
};

// One block per 64-row query tile of one (batch, head), NWG warpgroups.
// Warpgroup w takes the pieces w, w + NWG, ...; its stream of items is
// those pieces' V and P (walk 1: D), then their V, P and K (walk 2: dS, dQ),
// item i in stage i % STAGES of its own ring; its thread 0 asks for item i +
// STAGES once the warpgroup has read item i. In each warpgroup, warp w'
// holds rows 16w' + g and 16w' + g + 8 of the tile and, per piece, keys 8j +
// 2(lane % 4) + {0, 1} (the accumulator layout).
template <int NWG>
__global__ void __launch_bounds__(NWG * WG, 1)
    attention_bwd_long_rows_kernel(const __grid_constant__ LongBwdArgs a) {
  using S = RowsSmem<NWG>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  float* const xd = reinterpret_cast<float*>(smem + S::STATS);
  const uint32_t bar_do = smem_u32(smem + S::BARS);

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.heads + h;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);   // proven warp-uniform for ptxas
  const int t = tid & (WG - 1), warp = t >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * warp + g;
  const int pieces = (a.lk + TILE - 1) / TILE;
  const int mine = (pieces - wg + NWG - 1) / NWG;
  const int items = 2 * mine;
  uint8_t* const ring = smem + S::RING + wg * STAGES * ROW_STAGE;
  const uint32_t full = bar_do + 8 + wg * STAGES * 8;

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();      // the swizzle needs 1024-byte tiles
    for (int i = 0; i < 1 + NWG * STAGES; ++i) mbar_init(bar_do + 8 * i, 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto issue = [&](int i) {
    if (t != 0 || i >= items) return;
    const int s = i % STAGES, key0 = (wg + NWG * (i < mine ? i : i - mine)) * TILE;
    const uint32_t bar = full + 8 * s;
    uint8_t* dst = ring + s * ROW_STAGE;
    mbar_expect_tx(bar, (i < mine ? 2 : 3) * TILE_BYTES);
    tma_load_3d(dst, &a.v, bar, h * HDIM, key0, b);
    tma_load_3d(dst + TILE_BYTES, &a.p, bar, key0, q0, bh);
    if (i >= mine) tma_load_3d(dst + 2 * TILE_BYTES, &a.k, bar, h * HDIM, key0, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_do, TILE_BYTES);
    tma_load_3d(smem, &a.dout, bar_do, h * HDIM, q0, b);
  }
#pragma unroll
  for (int i = 0; i < STAGES; ++i) issue(i);
  auto release = [&](int i) {
    named_sync(1 + wg, WG);
    issue(i + STAGES);
  };

  // dP = dO·Vᵀ of item i's piece, fp32 (both K-major).
  const uint32_t do_addr = smem_u32(smem);
  auto dp_product = [&](float (&dp)[32], int i) {
    mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
    const uint32_t v_addr = smem_u32(ring + (i % STAGES) * ROW_STAGE);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss(dp, desc_sw128(do_addr + 32 * kk), desc_sw128(v_addr + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);
  };
  // P of row r0 + 8r, keys 8j + c2 and 8j + c2 + 1 of item i's piece.
  auto p_pair = [&](int i, int j, int r) {
    const uint8_t* pt = ring + (i % STAGES) * ROW_STAGE + TILE_BYTES;
    return segclip_tc::unpack(*reinterpret_cast<const uint32_t*>(pt + sw128(r0 + 8 * r, j, c2)));
  };

  mbar_wait(bar_do, 0);
  float dp[32];

  // Walk 1: this warpgroup's share of D over its pieces in order, then the
  // quad, then the warpgroups in order.
  float d[2] = {0.f, 0.f};
  for (int i = 0; i < mine; ++i) {
    dp_product(dp, i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 pv = p_pair(i, j, r);
        d[r] = fmaf(pv.x, dp[4 * j + 2 * r], d[r]);
        d[r] = fmaf(pv.y, dp[4 * j + 2 * r + 1], d[r]);
      }
    release(i);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) d[r] = quad_sum(d[r]);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) xd[wg * TILE + r0 + 8 * r] = d[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s = xd[r0 + 8 * r];
#pragma unroll
    for (int w = 1; w < NWG; ++w) s += xd[w * TILE + r0 + 8 * r];
    d[r] = s;
  }
  if (wg == 0 && (lane & 3) == 0) {
    float* dr = a.drow + static_cast<long long>(bh) * a.d_rs + q0;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + r0 + 8 * r < a.lq) dr[r0 + 8 * r] = d[r];
  }

  // Walk 2: dS = P ∘ (dP − D) in fp32, its bf16 hi and lo pairs the register
  // A operand of dQ += dS·K (K MN-major through the transpose bit).
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int c = 0; c < mine; ++c) {
    const int i = mine + c;
    dp_product(dp, i);
    uint32_t hi[8][2], lo[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 pv = p_pair(i, j, r);
        const float x0 = pv.x * (dp[4 * j + 2 * r] - d[r]);
        const float x1 = pv.y * (dp[4 * j + 2 * r + 1] - d[r]);
        hi[j][r] = segclip_tc::pack(x0, x1);
        const float2 hv = segclip_tc::unpack(hi[j][r]);
        lo[j][r] = segclip_tc::pack(x0 - hv.x, x1 - hv.y);
      }
    const uint32_t k_addr = smem_u32(ring + (i % STAGES) * ROW_STAGE + 2 * TILE_BYTES);
    fence_regs(dq);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      fence_regs(hi[j]);
      fence_regs(lo[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t kd = desc_sw128(k_addr + 2048 * kk);
      const uint32_t fh[4] = {hi[2 * kk][0], hi[2 * kk][1], hi[2 * kk + 1][0], hi[2 * kk + 1][1]};
      const uint32_t fl[4] = {lo[2 * kk][0], lo[2 * kk][1], lo[2 * kk + 1][0], lo[2 * kk + 1][1]};
      wgmma_m64n64k16_rs_tb(dq, fh, kd, 1);
      wgmma_m64n64k16_rs_tb(dq, fl, kd, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      fence_regs(hi[j]);
      fence_regs(lo[j]);
    }
    release(i);
  }

  // dQ = the warpgroups' partials summed in warpgroup order, each staged in
  // its own ring (every copy it asked for has landed and been read), scaled.
  if (wg > 0)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      reinterpret_cast<float2*>(ring)[i * WG + t] = make_float2(dq[2 * i], dq[2 * i + 1]);
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int w = 1; w < NWG; ++w) {
      const float2* stage = reinterpret_cast<const float2*>(ring + w * STAGES * ROW_STAGE);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 x = stage[i * WG + t];
        dq[2 * i] += x.x;
        dq[2 * i + 1] += x.y;
      }
    }
    const long long dm = static_cast<long long>(a.heads) * HDIM;
    bf16* out = static_cast<bf16*>(a.dq) + (static_cast<long long>(b) * a.lq + q0 + r0) * dm +
                h * HDIM + c2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + r0 + 8 * r < a.lq)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * r * dm + 8 * j) =
              segclip_tc::pack(dq[4 * j + 2 * r] * a.scale, dq[4 * j + 2 * r + 1] * a.scale);
  }
}

// Slab pass: two V pieces, then COL_STAGES stages of a query tile's P (two
// 64-key pieces), dO and Q, then the mbarriers (V, the stages).
constexpr int COL_STAGES = 3;
constexpr int COL_STAGE = 4 * TILE_BYTES;
constexpr int COLS_SMEM = 2 * TILE_BYTES + COL_STAGES * COL_STAGE + 8 * (1 + COL_STAGES);

// One block per 128-key slab of one (batch, head); warpgroup w owns the
// piece of keys [128·x + 64w, +64) and holds its dV and dK in fp32 registers
// across the query tiles. In each warpgroup, warp w' holds keys 16w' + g
// and 16w' + g + 8 of the piece and query columns 8j + 2(lane % 4) + {0, 1}
// of each tile (the accumulator layout of dPᵀ).
__global__ void __launch_bounds__(2 * WG, 1)
    attention_bwd_long_cols_kernel(const __grid_constant__ LongBwdArgs a) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* const stages = smem + 2 * TILE_BYTES;
  const uint32_t bar_v = smem_u32(stages + COL_STAGES * COL_STAGE), full = bar_v + 8;

  const int h = blockIdx.y, b = blockIdx.z, bh = b * a.heads + h;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);   // proven warp-uniform for ptxas
  const int warp = (tid & (WG - 1)) >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * warp + g;
  const int slab0 = blockIdx.x * 2 * TILE;
  const int live = min(2, (a.lk - slab0 + TILE - 1) / TILE);   // pieces with a real key
  const bool has_keys = wg < live;
  const int key0 = slab0 + wg * TILE;
  const int tiles = (a.lq + TILE - 1) / TILE;

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();      // the swizzle needs 1024-byte tiles
    for (int i = 0; i < 1 + COL_STAGES; ++i) mbar_init(bar_v + 8 * i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto load_tile = [&](int u) {
    const int s = u % COL_STAGES;
    const uint32_t bar = full + 8 * s;
    uint8_t* dst = stages + s * COL_STAGE;
    mbar_expect_tx(bar, (live + 2) * TILE_BYTES);
    for (int c = 0; c < live; ++c)
      tma_load_3d(dst + c * TILE_BYTES, &a.p, bar, slab0 + c * TILE, u * TILE, bh);
    tma_load_3d(dst + 2 * TILE_BYTES, &a.dout, bar, h * HDIM, u * TILE, b);
    tma_load_3d(dst + 3 * TILE_BYTES, &a.q, bar, h * HDIM, u * TILE, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_v, live * TILE_BYTES);
    for (int c = 0; c < live; ++c)
      tma_load_3d(smem + c * TILE_BYTES, &a.v, bar_v, h * HDIM, slab0 + c * TILE, b);
    for (int u = 0; u < COL_STAGES && u < tiles; ++u) load_tile(u);
  }

  const float* dr = a.drow + static_cast<long long>(bh) * a.d_rs;
  const uint32_t v_addr = smem_u32(smem + wg * TILE_BYTES);
  // This lane's row of the 8 × 8 matrices `ldmatrix.trans` reads: matrix i =
  // lane / 8 holds queries 8·(i / 2).. and keys 16w' + 8·(i % 2)..
  const int mi = lane >> 3;
  const uint32_t pt_off = sw128(8 * (mi >> 1) + (lane & 7), 2 * warp + (mi & 1), 0);
  float dv[32], dk[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv[i] = dk[i] = 0.f;
  if (has_keys) mbar_wait(bar_v, 0);
  for (int u = 0; u < tiles; ++u) {
    const int s = u % COL_STAGES, q0 = u * TILE;
    const int ksteps = (min(TILE, a.lq - q0) + 15) / 16;   // 16-query steps with a real query
    uint8_t* const st = stages + s * COL_STAGE;
    const uint32_t do_addr = smem_u32(st + 2 * TILE_BYTES), q_addr = smem_u32(st + 3 * TILE_BYTES);
    if (has_keys) {
      float2 dd[8];                            // D at this thread's query columns
#pragma unroll
      for (int j = 0; j < 8; ++j) dd[j] = d_pair(dr, q0 + 8 * j + c2, a.lq);
      mbar_wait(full + 8 * s, (u / COL_STAGES) & 1);

      // dPᵀ = V·dOᵀ (keys × queries), while Pᵀ's fragments come by
      // ldmatrix.trans in the register A layout (keys × 16 queries a k-step).
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(dpt, desc_sw128(v_addr + 32 * kk), desc_sw128(do_addr + 32 * kk), kk);
      wgmma_commit();
      uint32_t pf[4][4];
      const uint32_t p_addr = smem_u32(st + wg * TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4_trans(pf[kk], p_addr + pt_off + kk * 16 * 128);
      wgmma_wait<0>();
      fence_regs(dpt);

      // dSᵀ = Pᵀ ∘ (dPᵀ − D) in fp32, split into bf16 hi and lo pairs in the
      // register A layout (pf[kk][2·half + r]: key r0 + 8r, queries 16kk +
      // 8·half + c2, + 1).
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = 2 * kk + half, e = 2 * half + r;
            const float2 pv = segclip_tc::unpack(pf[kk][e]);
            const float x0 = pv.x * (dpt[4 * j + 2 * r] - dd[j].x);
            const float x1 = pv.y * (dpt[4 * j + 2 * r + 1] - dd[j].y);
            hi[kk][e] = segclip_tc::pack(x0, x1);
            const float2 hv = segclip_tc::unpack(hi[kk][e]);
            lo[kk][e] = segclip_tc::pack(x0 - hv.x, x1 - hv.y);
          }

      // dV += Pᵀ·dO, dK += dSᵀ·Q (hi, then lo): dO and Q MN-major through
      // the transpose bit, over the tile's 16-query steps with a real query.
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pf[kk]);
        fence_regs(hi[kk]);
        fence_regs(lo[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < ksteps) {
          wgmma_m64n64k16_rs_tb(dv, pf[kk], desc_sw128(do_addr + 2048 * kk), 1);
          const uint64_t qd = desc_sw128(q_addr + 2048 * kk);
          wgmma_m64n64k16_rs_tb(dk, hi[kk], qd, 1);
          wgmma_m64n64k16_rs_tb(dk, lo[kk], qd, 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pf[kk]);
        fence_regs(hi[kk]);
        fence_regs(lo[kk]);
      }
    }
    __syncthreads();                           // both warpgroups are done with stage s
    if (tid == 0 && u + COL_STAGES < tiles) load_tile(u + COL_STAGES);
  }

  // dV and dK (scaled) out from registers, keys < Lk.
  if (has_keys) {
    const long long dm = static_cast<long long>(a.heads) * HDIM;
    const long long base = static_cast<long long>(b) * a.lk * dm + h * HDIM + c2;
    bf16* const dvp = static_cast<bf16*>(a.dv) + base;
    bf16* const dkp = static_cast<bf16*>(a.dk) + base;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + r0 + 8 * r;
      if (key < a.lk)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dvp + key * dm + 8 * j) =
              segclip_tc::pack(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dkp + key * dm + 8 * j) = segclip_tc::pack(
              dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
        }
    }
  }
}

// ----------------------------------------------------------------- float32

// Row pass: dO hi and lo; ROW32_STAGES stages of a piece's V (hi over the raw
// tile, lo), P and raw K; Kᵀ hi and lo; the warpgroups' D partials; the
// mbarriers (dO, the stages).
constexpr int ROW32_STAGES = 2;
constexpr int ROW32_STAGE = 4 * F32_PIECE;
constexpr int ROW32_RING = 2 * F32_PIECE;
constexpr int ROW32_KT = ROW32_RING + ROW32_STAGES * ROW32_STAGE;
constexpr int ROW32_STATS = ROW32_KT + 2 * F32_PIECE;
constexpr int ROW32_BARS = ROW32_STATS + 2 * TILE * 4;
constexpr int ROW32_SMEM = ROW32_BARS + 8 * (1 + ROW32_STAGES);

// One block per 64-row query tile of one (batch, head), two warpgroups:
// warpgroup w takes keys [32w, 32w + 32) of every 64-key piece (dP and dS on
// m64n32). The block's stream of items is the pieces' V and P (walk 1: D),
// then their V, P and K (walk 2: dS, dQ), item i in stage i % ROW32_STAGES;
// thread 0 asks for item i + ROW32_STAGES once both warpgroups have read
// item i. Thread (warp w' of its warpgroup, lane l) holds rows 16w' + l / 4
// and 16w' + l / 4 + 8 and, per 8-key step j, keys 32w + 8j + 2(l % 4) +
// {0, 1} of a piece.
__global__ void __launch_bounds__(2 * WG, 1)
    attention_bwd_tf32x3_long_rows_kernel(const __grid_constant__ LongBwdArgs a) {
  constexpr int THREADS = 2 * WG, STAGES = ROW32_STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* const kt = smem + ROW32_KT;
  float* const xd = reinterpret_cast<float*>(smem + ROW32_STATS);
  const uint32_t bar_do = smem_u32(smem + ROW32_BARS), full = bar_do + 8;

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.heads + h;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);   // proven warp-uniform for ptxas
  const int t = tid & (WG - 1), warp = t >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * warp + g;
  const int pieces = (a.lk + TILE - 1) / TILE, items = 2 * pieces;

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();      // the swizzle needs 1024-byte tiles
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(bar_do + 8 * i, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // A 64-row tile as two 32-column boxes; P's second box only where it holds
  // a real key (its values past Lk are taken as 0 below).
  auto issue = [&](int i) {
    if (tid != 0 || i >= items) return;
    const int s = i % STAGES, key0 = (i < pieces ? i : i - pieces) * TILE;
    const bool p_two = key0 + 32 < a.lk;
    const uint32_t bar = full + 8 * s;
    uint8_t* dst = smem + ROW32_RING + s * ROW32_STAGE;
    mbar_expect_tx(bar, F32_PIECE + (p_two ? F32_PIECE : F32_HALF) + (i < pieces ? 0 : F32_PIECE));
    tma_load_3d(dst, &a.v, bar, h * HDIM, key0, b);
    tma_load_3d(dst + F32_HALF, &a.v, bar, h * HDIM + 32, key0, b);
    tma_load_3d(dst + 2 * F32_PIECE, &a.p, bar, key0, q0, bh);
    if (p_two) tma_load_3d(dst + 2 * F32_PIECE + F32_HALF, &a.p, bar, key0 + 32, q0, bh);
    if (i >= pieces) {
      tma_load_3d(dst + 3 * F32_PIECE, &a.k, bar, h * HDIM, key0, b);
      tma_load_3d(dst + 3 * F32_PIECE + F32_HALF, &a.k, bar, h * HDIM + 32, key0, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_do, F32_PIECE);
    tma_load_3d(smem, &a.dout, bar_do, h * HDIM, q0, b);
    tma_load_3d(smem + F32_HALF, &a.dout, bar_do, h * HDIM + 32, q0, b);
  }
#pragma unroll
  for (int i = 0; i < STAGES; ++i) issue(i);

  // Item i arrived: V split in place (and, in walk 2, K transposed and split
  // into Kᵀ) by every thread.
  auto arrive = [&](int i) {
    const int s = i % STAGES;
    uint8_t* st = smem + ROW32_RING + s * ROW32_STAGE;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    split_tile<THREADS>(st, st + F32_PIECE, tid);
    if (i >= pieces) transpose_split<THREADS>(st + 3 * F32_PIECE, kt, kt + F32_PIECE, tid);
    fence_proxy_async();
    __syncthreads();
    return st;
  };
  // dP (m64n32) = dO·Vᵀ over this warpgroup's 32 keys of item i's piece.
  const uint32_t do_addr = smem_u32(smem);
  auto dp_product = [&](float (&dp)[16], const uint8_t* st) {
    tf32_product_ss(dp, do_addr, smem_u32(st) + 32 * wg * 128, 8);
  };
  // P of row r0 + 8r, keys 32w + 8j + c2, + 1 of the piece at key0 (0 past Lk).
  auto p_pair = [&](const uint8_t* st, int key0, int j, int r) {
    if (key0 + 32 * wg >= a.lk) return make_float2(0.f, 0.f);   // a box never copied
    const int row = r0 + 8 * r, col = 8 * j + c2;
    return *reinterpret_cast<const float2*>(st + 2 * F32_PIECE + wg * F32_HALF + row * 128 +
                                            (((col >> 2) ^ (row & 7)) << 4) + (col & 3) * 4);
  };
  // Both warpgroups are done with item i: its stage takes item i + STAGES.
  auto release = [&](int i) {
    __syncthreads();
    issue(i + STAGES);
  };

  // dO split once.
  mbar_wait(bar_do, 0);
  split_tile<THREADS>(smem, smem + F32_PIECE, tid);

  // Walk 1: this thread's share of D over the pieces in order, then the quad,
  // then the two warpgroups, warpgroup 0's first.
  float dp[16], d[2] = {0.f, 0.f};
  for (int i = 0; i < pieces; ++i) {
    const uint8_t* st = arrive(i);
    dp_product(dp, st);
    float2 pv[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) pv[j][r] = p_pair(st, i * TILE, j, r);
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        d[r] = fmaf(pv[j][r].x, dp[4 * j + 2 * r], d[r]);
        d[r] = fmaf(pv[j][r].y, dp[4 * j + 2 * r + 1], d[r]);
      }
    release(i);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) d[r] = quad_sum(d[r]);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) xd[wg * TILE + r0 + 8 * r] = d[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) d[r] = xd[r0 + 8 * r] + xd[TILE + r0 + 8 * r];
  if (wg == 0 && (lane & 3) == 0) {
    float* dr = a.drow + static_cast<long long>(bh) * a.d_rs + q0;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + r0 + 8 * r < a.lq) dr[r0 + 8 * r] = d[r];
  }

  // Walk 2: dS = P ∘ (dP − D), its fragments (hi, lo) the A operand of
  // dS·K over this warpgroup's keys of the piece (Kᵀ, keys permuted alike,
  // as B), each piece's product added to dQ on the CUDA cores: the tensor
  // cores' own fp32 accumulation keeps fewer bits than an IEEE add, so a
  // row's sum over its pieces is not left to them.
  float dq[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int c = 0; c < pieces; ++c) {
    const int i = pieces + c;
    const uint8_t* st = arrive(i);
    dp_product(dp, st);
    float2 pv[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) pv[j][r] = p_pair(st, c * TILE, j, r);
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dp[4 * j + 2 * r] = pv[j][r].x * (dp[4 * j + 2 * r] - d[r]);
        dp[4 * j + 2 * r + 1] = pv[j][r].y * (dp[4 * j + 2 * r + 1] - d[r]);
      }
    uint32_t fh[4][4], fl[4][4];
    tf32_fragments(dp, fh, fl);
#pragma unroll
    for (int e = 0; e < 32; ++e) part[e] = 0.f;
    tf32_product_rs(part, fh, fl, smem_u32(kt), 4 * wg, 4);
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(fh[kk]);
      fence_regs(fl[kk]);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] += part[e];
    release(i);
  }

  // dQ = warpgroup 0's partial + warpgroup 1's (staged over Kᵀ, read by the
  // last product), scaled, rows < Lq.
  float2* const stage = reinterpret_cast<float2*>(kt);
  if (wg == 1)
#pragma unroll
    for (int i = 0; i < 16; ++i) stage[i * WG + t] = make_float2(dq[2 * i], dq[2 * i + 1]);
  __syncthreads();
  if (wg == 0) {
    const long long dm = static_cast<long long>(a.heads) * HDIM;
    float* out = static_cast<float*>(a.dq) + (static_cast<long long>(b) * a.lq + q0 + r0) * dm +
                 h * HDIM + c2;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 x = stage[i * WG + t];
      dq[2 * i] += x.x;
      dq[2 * i + 1] += x.y;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + r0 + 8 * r < a.lq)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(out + 8 * r * dm + 8 * j) =
              make_float2(dq[4 * j + 2 * r] * a.scale, dq[4 * j + 2 * r + 1] * a.scale);
  }
}

// Slab pass: V hi over the raw tile and lo; P; dO hi over the raw tile and
// lo (then Qᵀ hi and lo); dOᵀ hi and lo; raw Q; the mbarriers (V, P, dO, Q).
constexpr int COL32_SMEM = 8 * F32_PIECE + 4 * 8;

// One block per 64-key slab of one (batch, head), two warpgroups that split
// each 64-row query tile: warpgroup w takes query rows [32w, 32w + 32), dPᵀ
// and dSᵀ for them (m64n32: the slab's 64 keys × 32 query rows), their part
// of dV and dK (the two parts added at the end, warpgroup 0's first). The
// next tile's P, Q and dO are asked for as soon as their buffers are read.
// Thread (warp w' of its warpgroup, lane l) holds keys 16w' + l / 4 and
// 16w' + l / 4 + 8 of the slab and, per 8-row step j, query rows 32w + 8j +
// 2(l % 4) + {0, 1}.
__global__ void __launch_bounds__(2 * WG, 1)
    attention_bwd_tf32x3_long_cols_kernel(const __grid_constant__ LongBwdArgs a) {
  constexpr int THREADS = 2 * WG;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* const vh = smem;                    // V: hi over the raw tile, lo
  uint8_t* const pr = smem + 2 * F32_PIECE;    // P of the tile (query rows × the slab's keys)
  uint8_t* const dor = smem + 3 * F32_PIECE;   // dO hi over the raw tile, lo; then Qᵀ hi, lo
  uint8_t* const dot = smem + 5 * F32_PIECE;   // dOᵀ hi, lo (query rows permuted)
  uint8_t* const qr = smem + 7 * F32_PIECE;    // Q of the tile
  const uint32_t bar_v = smem_u32(smem + 8 * F32_PIECE), bar_p = bar_v + 8, bar_do = bar_v + 16,
                 bar_q = bar_v + 24;

  const int key0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.heads + h;
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int t128 = tid & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * (warp & 3) + g;
  const int col0 = 32 * wg;                    // this warpgroup's query rows
  const int tiles = (a.lq + TILE - 1) / TILE;
  const bool p_two = key0 + 32 < a.lk;         // P's second 32-key box holds a real key

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();      // the swizzle needs 1024-byte tiles
    for (int i = 0; i < 4; ++i) mbar_init(bar_v + 8 * i, 1);
    fence_barrier_init();
  }
  if (!p_two)                                  // keys past the first box: zeros, never copied
    for (int i = tid; i < F32_HALF / 16; i += THREADS)
      reinterpret_cast<float4*>(pr + F32_HALF)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  auto load = [&](const CUtensorMap* map, uint8_t* dst, uint32_t bar, int c0, int c1, int c2_,
                  bool two) {
    mbar_expect_tx(bar, two ? F32_PIECE : F32_HALF);
    tma_load_3d(dst, map, bar, c0, c1, c2_);
    if (two) tma_load_3d(dst + F32_HALF, map, bar, c0 + 32, c1, c2_);
  };
  auto load_p = [&](int u) { load(&a.p, pr, bar_p, key0, u * TILE, bh, p_two); };
  auto load_do = [&](int u) { load(&a.dout, dor, bar_do, h * HDIM, u * TILE, b, true); };
  auto load_q = [&](int u) { load(&a.q, qr, bar_q, h * HDIM, u * TILE, b, true); };
  if (tid == 0) {
    load(&a.v, vh, bar_v, h * HDIM, key0, b, true);
    load_do(0);
    load_p(0);
    load_q(0);
  }

  const float* dr = a.drow + static_cast<long long>(bh) * a.d_rs;
  const uint32_t v_addr = smem_u32(vh), do_addr = smem_u32(dor), dot_addr = smem_u32(dot);
  mbar_wait(bar_v, 0);
  split_tile<THREADS>(vh, vh + F32_PIECE, tid);   // fenced with dO's split below

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  for (int u = 0; u < tiles; ++u) {
    const uint32_t ph = u & 1;
    const int q0 = u * TILE, rows = min(TILE, a.lq - q0);
    // this warpgroup's 8-row steps with a real query row
    const int qsteps = max(0, min(4, (rows - col0 + 7) / 8));
    const bool next = u + 1 < tiles;

    // dO: transposed and split into dOᵀ (for dV), then split in place (for
    // dPᵀ).
    mbar_wait(bar_do, ph);
    transpose_split<THREADS>(dor, dot, dot + F32_PIECE, tid);
    __syncthreads();                           // every thread has read the raw tile
    split_tile<THREADS>(dor, dor + F32_PIECE, tid);
    fence_proxy_async();
    __syncthreads();

    // dPᵀ = V_slab·dOᵀ (keys × this warpgroup's query rows), while P and D
    // come into registers at the accumulator's places (key r0 + 8r, query
    // row col0 + 8j + c2 + e).
    float x[16], p[16];
    tf32_product_ss(x, v_addr, do_addr + col0 * 128, 8);
    float2 dd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dd[j] = d_pair(dr, q0 + col0 + 8 * j + c2, a.lq);
    mbar_wait(bar_p, ph);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = r0 + 8 * r, qr_ = col0 + 8 * j + c2 + e;
          p[4 * j + 2 * r + e] = *reinterpret_cast<const float*>(
              pr + (key >> 5) * F32_HALF + qr_ * 128 + ((((key & 31) >> 2) ^ (qr_ & 7)) << 4) +
              (key & 3) * 4);
        }
    wgmma_wait<0>();
    fence_regs(x);
    __syncthreads();                           // P read; dO and V read by the products
    if (tid == 0 && next) load_p(u + 1);

    // Q transposed and split into Qᵀ over dO's tiles (read by dPᵀ).
    mbar_wait(bar_q, ph);
    transpose_split<THREADS>(qr, dor, dor + F32_PIECE, tid);
    fence_proxy_async();
    __syncthreads();                           // Qᵀ written, Q read
    if (tid == 0 && next) load_q(u + 1);

    // dSᵀ = Pᵀ ∘ (dPᵀ − D), in place of dPᵀ.
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x[4 * j + 2 * r] = p[4 * j + 2 * r] * (x[4 * j + 2 * r] - dd[j].x);
        x[4 * j + 2 * r + 1] = p[4 * j + 2 * r + 1] * (x[4 * j + 2 * r + 1] - dd[j].y);
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q over this warpgroup's query rows: Pᵀ's and
    // dSᵀ's fragments from registers, dOᵀ and Qᵀ (rows permuted alike) as B;
    // each tile's product added on the CUDA cores, as the row pass adds dQ's.
    float part[32];
    {
      uint32_t fh[4][4], fl[4][4];
      tf32_fragments(p, fh, fl);
#pragma unroll
      for (int e = 0; e < 32; ++e) part[e] = 0.f;
      tf32_product_rs(part, fh, fl, dot_addr, 4 * wg, qsteps);
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(fh[kk]);
        fence_regs(fl[kk]);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) dv[e] += part[e];
    }
    {
      uint32_t sh[4][4], sl[4][4];
      tf32_fragments(x, sh, sl);
#pragma unroll
      for (int e = 0; e < 32; ++e) part[e] = 0.f;
      tf32_product_rs(part, sh, sl, do_addr, 4 * wg, qsteps);
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(sh[kk]);
        fence_regs(sl[kk]);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[e] += part[e];
    }
    __syncthreads();                           // Qᵀ (dO's tiles) and dOᵀ read by the products
    if (tid == 0 && next) load_do(u + 1);
  }

  // dK and dV of the slab's real keys: warpgroup 0's part + warpgroup 1's,
  // dV added and stored by warpgroup 0, dK by warpgroup 1, each passing the
  // other its part over dOᵀ's tiles.
  float2* const stage = reinterpret_cast<float2*>(dot);
  const long long dm = static_cast<long long>(a.heads) * HDIM;
  const long long base = static_cast<long long>(b) * a.lk * dm + h * HDIM;
  auto store = [&](float* out, const float (&acc)[32], float s) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + r0 + 8 * r;
      if (key < a.lk)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(out + base + key * dm + 8 * j + c2) =
              make_float2(acc[4 * j + 2 * r] * s, acc[4 * j + 2 * r + 1] * s);
    }
  };
  if (wg == 0)
#pragma unroll
    for (int i = 0; i < 16; ++i) stage[i * 128 + t128] = make_float2(dk[2 * i], dk[2 * i + 1]);
  else
#pragma unroll
    for (int i = 0; i < 16; ++i)
      stage[(16 + i) * 128 + t128] = make_float2(dv[2 * i], dv[2 * i + 1]);
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 o = stage[(16 + i) * 128 + t128];
      dv[2 * i] += o.x;
      dv[2 * i + 1] += o.y;
    }
    store(static_cast<float*>(a.dv), dv, 1.f);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 o = stage[i * 128 + t128];
      dk[2 * i] = o.x + dk[2 * i];
      dk[2 * i + 1] = o.y + dk[2 * i + 1];
    }
    store(static_cast<float*>(a.dk), dk, a.scale);
  }
}

// ---------------------------------------------------------------- host side

// Launches `kernel` on `grid` in blocks of `threads` with `smem` bytes of
// dynamic shared memory, its limit raised once per device (`raised`).
cudaError_t launch(void (*kernel)(LongBwdArgs), bool (&raised)[64], const LongBwdArgs& a,
                   dim3 grid, int smem, cudaStream_t stream, int threads) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The maps and scalars of one call (strides in elements); false if a map
// is refused.
bool long_args(LongBwdArgs* a, bool f32, const void* p, const void* dout, const void* q,
               const void* k, const void* v, void* dq, void* dk, void* dv, void* drow, int batch,
               int heads, int lq, int lk, long long p_bs, long long p_hs, long long p_rs,
               long long do_bs, long long do_rs, long long q_bs, long long q_rs, long long k_bs,
               long long k_rs, long long v_bs, long long v_rs, float scale) {
  const long long dm = static_cast<long long>(heads) * HDIM;
  const long long p_bh = heads > 1 ? p_hs : p_bs;        // the stride of the B·H dim
  auto enc = f32 ? encode_f32_3d : encode_bf16_3d;
  if (!(enc(&a->p, p, lk, lq, static_cast<uint64_t>(batch) * heads, p_rs, p_bh) &&
        enc(&a->dout, dout, dm, lq, batch, do_rs, do_bs) &&
        enc(&a->q, q, dm, lq, batch, q_rs, q_bs) && enc(&a->k, k, dm, lk, batch, k_rs, k_bs) &&
        enc(&a->v, v, dm, lk, batch, v_rs, v_bs)))
    return false;
  a->dq = dq;
  a->dk = dk;
  a->dv = dv;
  a->drow = static_cast<float*>(drow);
  a->heads = heads;
  a->lq = lq;
  a->lk = lk;
  a->d_rs = (lq + 3) / 4 * 4;
  a->scale = scale;
  return true;
}

// The checks both entry points make: sizes, and P's strides (rows at least
// Lk long and 16-byte aligned, its batch and head dims one B·H dim).
bool long_shape_ok(int batch, int heads, int lq, int lk, int min_lk, long long p_bs,
                   long long p_hs, long long p_rs, int align) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < min_lk || batch > 65535 || heads > 65535)
    return false;
  if (lq > 1 && (p_rs < lk || p_rs % align)) return false;
  return !(batch > 1 && heads > 1 && p_bs != heads * p_hs);
}

}  // namespace
}  // namespace segclip_kernels

using namespace segclip_kernels;

extern "C" {

// The shortest Lk that `segclip_attention_bwd_long` (bf16) and
// `segclip_attention_bwd_tf32x3_long` (float32) take.
int segclip_attention_bwd_long_min_lk() { return BWD_LONG_MIN_LK; }
int segclip_attention_bwd_tf32x3_long_min_lk() { return BWD_TF32X3_LONG_MIN_LK; }

// The bf16 long-row backward, for Lk ≥ BWD_LONG_MIN_LK: the row pass (D into
// drow, dQ), then the slab pass (dK, dV), on one stream. The arguments of
// `segclip_attention_bwd_one_pass` with the D scratch after dv: drow is a
// float32 (B·H, Lq4) buffer, Lq4 = Lq rounded up to 4. Strides in elements;
// the wrapper guarantees 16-byte aligned p, dO, q, k, v and strides
// (multiples of 8 elements), P's rows at least Lk long; P's batch and head
// dims read as one (B·H) dim, p_bs = H·p_hs unless B or H is 1. dq, dk, dv
// are contiguous bf16 (B, L, H·64). Returns the first cudaError_t of the
// launches (0 on success).
int segclip_attention_bwd_long(const void* p, const void* dout, const void* q, const void* k,
                               const void* v, void* dq, void* dk, void* dv, void* drow, int batch,
                               int heads, int lq, int lk, long long p_bs, long long p_hs,
                               long long p_rs, long long do_bs, long long do_rs, long long q_bs,
                               long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                               long long v_rs, float scale, void* stream) {
  if (!long_shape_ok(batch, heads, lq, lk, BWD_LONG_MIN_LK, p_bs, p_hs, p_rs, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  LongBwdArgs a{};
  if (!long_args(&a, false, p, dout, q, k, v, dq, dk, dv, drow, batch, heads, lq, lk, p_bs, p_hs,
                 p_rs, do_bs, do_rs, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool raised_rows2[64] = {}, raised_rows4[64] = {}, raised_cols[64] = {};
  const dim3 rows_grid((lq + TILE - 1) / TILE, heads, batch);
  cudaError_t err =
      lq <= TILE ? launch(attention_bwd_long_rows_kernel<4>, raised_rows4, a, rows_grid,
                          RowsSmem<4>::TOTAL, s, 4 * WG)
                 : launch(attention_bwd_long_rows_kernel<2>, raised_rows2, a, rows_grid,
                          RowsSmem<2>::TOTAL, s, 2 * WG);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(attention_bwd_long_cols_kernel, raised_cols, a,
               dim3((lk + 2 * TILE - 1) / (2 * TILE), heads, batch), COLS_SMEM, s, 2 * WG);
  return static_cast<int>(err);
}

// The float32 long-row backward (TF32x3), for Lk ≥ BWD_TF32X3_LONG_MIN_LK,
// with the arguments of `segclip_attention_bwd_long`; strides multiples of 4
// elements, dq, dk, dv contiguous float32.
int segclip_attention_bwd_tf32x3_long(const void* p, const void* dout, const void* q,
                                      const void* k, const void* v, void* dq, void* dk, void* dv,
                                      void* drow, int batch, int heads, int lq, int lk,
                                      long long p_bs, long long p_hs, long long p_rs,
                                      long long do_bs, long long do_rs, long long q_bs,
                                      long long q_rs, long long k_bs, long long k_rs,
                                      long long v_bs, long long v_rs, float scale, void* stream) {
  if (!long_shape_ok(batch, heads, lq, lk, BWD_TF32X3_LONG_MIN_LK, p_bs, p_hs, p_rs, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  LongBwdArgs a{};
  if (!long_args(&a, true, p, dout, q, k, v, dq, dk, dv, drow, batch, heads, lq, lk, p_bs, p_hs,
                 p_rs, do_bs, do_rs, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool raised_rows[64] = {}, raised_cols[64] = {};
  cudaError_t err = launch(attention_bwd_tf32x3_long_rows_kernel, raised_rows, a,
                           dim3((lq + TILE - 1) / TILE, heads, batch), ROW32_SMEM, s, 2 * WG);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(attention_bwd_tf32x3_long_cols_kernel, raised_cols, a,
               dim3((lk + TILE - 1) / TILE, heads, batch), COL32_SMEM, s, 2 * WG);
  return static_cast<int>(err);
}

}  // extern "C"
