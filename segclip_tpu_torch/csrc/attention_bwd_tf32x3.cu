// Attention backward at float32 from the saved probabilities, on TF32 tensor
// cores with fp32-accurate split products, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of segclip_tpu/ops/pallas/attention.py:96
// (reached through `_call_bwd`, pallas_call at :203, VJP at :217-247) for
// float32 operands: every float32 training step (phase 5's check, the data-
// and tensor-parallel float32 steps, ViT-B/32's) and the drift replay.
// `ops/kernels/attention.bwd_route` sends every float32 call with Lk ≤
// BWD_TF32X3_LIMIT (256) here (`attention_bwd_tf32x3_kernel`); longer float32
// rows take attention_bwd_long.cu's TF32x3 long kernels (this kernel's
// per-block column work, without the cluster exchange, is their slab pass).
//
// What it computes, per batch and head, from P (the forward's (Lq, Lk)
// probabilities), dO, Q, K and V, all fp32:
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  D_i = rowsum(dP ∘ P)_i,  dS = P ∘ (dP − D),
//   dQ = dS·K·scale,  dK = dSᵀ·Q·scale,
// written as contiguous (B, L, H·64) fp32 tensors. P is read through the
// forward's padded (B, H, Lq, Lk8) view by its strides, no copy.
//
// What bounds it on the H100: bytes. At 96×196, H = 12, P (177 MB), dO, Q,
// K and V (231 MB) read and dQ, dK and dV (173 MB) written are 0.1736 ms at
// 3.35 TB/s, against 22.7 GFLOP of fp32-accurate products (0.1376 ms at
// 495 / 3 TFLOP/s). The SIMT pair it replaces reaches 5 % of that: it forms
// every dP entry three times as 64 FMAs with shared-memory operands, reloads
// K and V for every 16 query rows, reads P twice and passes D through HBM.
//
// The design:
//   - fp32-accurate products on TF32 `wgmma` (3xTF32, as the float32 forward
//     in attention_fwd_tf32x3.cu): x = hi + lo, hi = cvt.rna.tf32(x), lo =
//     cvt.rna.tf32(x − hi); a·b = lo·hi + hi·lo + hi·hi per 8-wide k-step
//     into fp32 accumulators, lo·lo dropped. dS is fp32 and is split the same
//     way before dSᵀ·Q and dS·K. tests/test_torch_tf32x3_bwd.py emulates this
//     arithmetic and holds it to a tenth of the float32 tolerance.
//   - A thread-block cluster per (batch, head), C = ⌈Lk/64⌉ ≤ 4 blocks of
//     two warpgroups; block c owns the key slab [64c, 64c + 64) (Lk ≤ 64: one
//     block, no exchange). One block per (batch, head) does not fit: a
//     256-key head's K and V are 128 KB, their hi/lo operand tiles 128 KB
//     more. Each block holds its slab's V (hi, lo) and Kᵀ (hi, lo) for the
//     whole row walk and its dK and dV in fp32 registers across every 64-row
//     query tile; P is read once, by TMA, each block its own slab. The grid
//     holds as many clusters as the card runs at once, each walking (batch,
//     head) rows one after the other, so that the next row's copies overlap
//     this row's last tile and its dK and dV stores (a cluster per row,
//     one block per SM, left those latencies bare).
//   - The products are taken transposed where that keeps operands in
//     registers: dPᵀ = V_slab·dOᵀ (keys × query rows; V and dO K-major as
//     they arrive, split in place), so that P loaded from shared memory at
//     the accumulator's places serves the D sum, dSᵀ = Pᵀ ∘ (dPᵀ − D) and,
//     as it is, the A fragments of dV += Pᵀ·dO; and dSᵀ the A fragments of
//     dK += dSᵀ·Q. TF32 `wgmma` reads 32-bit shared operands K-major only,
//     with no transpose bit, so the B operands of those two sums over query
//     rows, dOᵀ and Qᵀ, are transposed and split by the threads (hopper.cuh
//     `transpose_split`), their 8-row steps permuted (slot s ↔ row 2s, 2(s −
//     4) + 1) so that the accumulator's registers are the A fragments
//     without moving (thread t holds rows {2t, 2t + 1} of each step). Kᵀ is
//     transposed once per block; dQ_c = dS·K_slab reads dS from shared
//     memory, written there (keys permuted as Kᵀ's) from the registers.
//   - D and dQ across the cluster: each block's partial D_c = rowsum over
//     its 64 keys (registers, shuffles, then its four warps in order) goes
//     into every block's shared memory by `st.async`, completing on the
//     receiver's mbarrier; each block sums D = Σ_c D_c in rank order. Each
//     block's dQ_c is staged and its rows copied by bulk copies to the block
//     that owns them (rank p sums rows [64p/C, 64(p + 1)/C)), which sums the
//     C partials in rank order, scales and stores them. No atomics and no
//     scratch in HBM: the gradients are the same bits from run to run.
//     Single receive areas suffice: a block pushes D_c of tile t + 1 only
//     after it has summed its dQ rows of tile t, which needed every block's
//     copies of tile t, each sent after that block had read the D_c of tile t.
//   - TMA copies (hopper.cuh): 64-row boxes of 32 floats (one 128-byte
//     swizzle row); rows past Lq or Lk and P's columns past Lk read as zeros
//     and add nothing. Each block copies its own dO and Q tiles (they come
//     from L2 after the first block); a multicast would tie every block's
//     buffers to the slowest block's. The next tile's P, Q and dO are asked
//     for as soon as their buffers are read; in a row's last tile, the next
//     row's V, P, raw K (over Q's buffer) and dO.
//   - Shared memory: twelve 16 KB fp32 tiles (V hi/lo, Kᵀ hi/lo; P, dO hi/lo,
//     dOᵀ hi/lo, Q, dS hi/lo; Qᵀ hi/lo over dO's once dPᵀ has read it, while
//     the D_c travel), the dQ receive area and the D exchange: 212 KB, one
//     block per SM.
//   - Registers: the two warpgroups split each query tile's rows; warpgroup
//     w takes rows [32w, 32w + 32): dPᵀ and dSᵀ for them (m64n32 products),
//     their part of dV and dK (the two parts added at the end, warpgroup 0's
//     first) and dims [32w, 32w + 32) of dQ_c. A thread holds dK and dV (64
//     registers), its dPᵀ/dSᵀ and P (32) and one product's split fragments
//     (32). One warpgroup holding a whole tile (128 of those) needed more
//     than 255 registers a thread, and ptxas crashed on it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace segclip_kernels {
namespace {

using namespace segclip_hopper;

// The longest rows the kernel takes: a cluster of at most MAX_C 64-key slabs.
constexpr int BWD_TF32X3_LIMIT = 256;
constexpr int MAX_C = 4;
static_assert(BWD_TF32X3_LIMIT == MAX_C * TILE, "one 64-key slab a block");
constexpr int HD = 64;
constexpr int THREADS = 256;                   // two warpgroups
constexpr int TILES = 12;                      // 16 KB fp32 tiles
constexpr int RECV_BYTES = share_area_bytes(MAX_C);
// The tiles; the dQ receive area; the D exchange: the warps' partials
// [warp][row], every block's D_c [rank][row], D [row]; seven mbarriers.
constexpr int SMEM_BYTES =
    TILES * F32_PIECE + RECV_BYTES + (8 * TILE + MAX_C * TILE + TILE) * 4 + 7 * 8;

struct BwdTf32Args {
  CUtensorMap p;             // (Lk, Lq, B·H), the saved probabilities
  CUtensorMap dout, q;       // (H·64, Lq, B) over the operands' own strides
  CUtensorMap k, v;          // (H·64, Lk, B)
  float *dq, *dk, *dv;       // (B, L, H·64) contiguous
  int batch, heads, lq, lk;
  float scale;
};

// Grid (C, G) in clusters of C along x, G at most the clusters the card
// holds at once: cluster g walks the (batch, head) rows g, g + G, ..., its
// tiles counted on across them, and block c owns the keys [64c, 64c + 64)
// of each. During a row's last tile the next row's V, P, raw K and dO are
// copied in as their buffers free up, so that they arrive while this row
// finishes. Warpgroup w takes query rows [32w, 32w + 32) of each tile: dPᵀ
// and dSᵀ for those columns (m64n32: the slab's 64 keys × 32 rows), their
// part of dV and dK (summed over those rows; the two parts are added at the
// end of the row, warpgroup 0's first) and dims [32w, 32w + 32) of dQ_c.
// Thread (warp w' of its warpgroup, lane l) holds, in every accumulator,
// rows 16w' + l / 4 and 16w' + l / 4 + 8 and, per 8-column step j, columns
// 8j + 2(l % 4) + {0, 1}.
__global__ void __launch_bounds__(THREADS, 1)
    attention_bwd_tf32x3_kernel(const __grid_constant__ BwdTf32Args a) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* const vh = smem;                    // V: hi over the raw tile, lo
  uint8_t* const kth = smem + 2 * F32_PIECE;   // Kᵀ hi, lo (keys permuted)
  uint8_t* const pr = smem + 4 * F32_PIECE;    // P of the tile (query rows × the slab's keys)
  uint8_t* const dor = smem + 5 * F32_PIECE;   // dO hi over the raw tile, lo; then Qᵀ hi, lo
  uint8_t* const dot = smem + 7 * F32_PIECE;   // dOᵀ hi, lo (query rows permuted)
  uint8_t* const qr = smem + 9 * F32_PIECE;    // Q of the tile; the next row's raw K
  uint8_t* const dsh = smem + 10 * F32_PIECE;  // dS hi, lo (keys permuted); the staged dQ partial
  uint8_t* const recv = smem + TILES * F32_PIECE;         // this block's dQ rows, every partial
  float* const dpart = reinterpret_cast<float*>(recv + RECV_BYTES);   // [warp][row]
  float* const xd = dpart + 8 * TILE;                     // [rank][row]: every block's D_c
  float* const dfull = xd + MAX_C * TILE;                 // [row]: D
  uint64_t* const bars = reinterpret_cast<uint64_t*>(dfull + TILE);
  const uint32_t bar_v = smem_u32(bars), bar_k = bar_v + 8, bar_p = bar_v + 16;
  const uint32_t bar_do = bar_v + 24, bar_q = bar_v + 32, bar_d = bar_v + 40, bar_x = bar_v + 48;

  const int rank = blockIdx.x, blocks = gridDim.x;   // the cluster spans x
  const int key0 = rank * TILE;
  // The warpgroup index broadcast from lane 0, so that the compiler sees
  // the branches on it as warp-uniform (else it serializes every wgmma).
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int t128 = tid & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * (warp & 3) + g;
  const int col0 = 32 * wg;                    // this warpgroup's query rows (and dQ's dims)
  const int tiles = (a.lq + TILE - 1) / TILE;  // query tiles of a row
  const int rows_all = a.batch * a.heads;      // (batch, head) rows
  const long long dm = static_cast<long long>(a.heads) * HD;
  const bool p_two = key0 + 32 < a.lk;         // P's second 32-key box holds a real key
  const int ksteps = min(8, (a.lk - key0 + 7) / 8);   // the slab's 8-key steps with a real key
  const int qrow0 = share_row0(rank, blocks), qrow1 = share_row0(rank + 1, blocks);
  auto x_bytes = [&](int u) {                  // the dQ rows copied to this block for tile u
    return static_cast<uint32_t>(blocks * share_rows(rank, blocks, a.lq - u * TILE) * TILE * 4);
  };

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();      // the swizzle needs 1024-byte tiles
    for (int i = 0; i < 7; ++i) mbar_init(bar_v + 8 * i, 1);
    fence_barrier_init();
    if (blocks > 1) {                          // the pushes of the first tile
      mbar_expect_tx(bar_d, blocks * TILE * 4);
      mbar_expect_tx(bar_x, x_bytes(0));
    }
  }
  if (!p_two)                                  // keys past the first box: zeros, never copied
    for (int i = tid; i < F32_HALF / 16; i += THREADS)
      reinterpret_cast<float4*>(pr + F32_HALF)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // Thread 0's copies: a 64-row tile as two 32-column boxes on one barrier;
  // tile u of (batch, head) row `row`.
  auto load = [&](const CUtensorMap* map, uint8_t* dst, uint32_t bar, int c0, int c1, int c2_,
                  bool two) {
    mbar_expect_tx(bar, two ? F32_PIECE : F32_HALF);
    tma_load_3d(dst, map, bar, c0, c1, c2_);
    if (two) tma_load_3d(dst + F32_HALF, map, bar, c0 + 32, c1, c2_);
  };
  auto load_p = [&](int row, int u) { load(&a.p, pr, bar_p, key0, u * TILE, row, p_two); };
  auto load_do = [&](int row, int u) {
    load(&a.dout, dor, bar_do, (row % a.heads) * HD, u * TILE, row / a.heads, true);
  };
  auto load_q = [&](int row, int u) {
    load(&a.q, qr, bar_q, (row % a.heads) * HD, u * TILE, row / a.heads, true);
  };
  auto load_k = [&](int row) {
    load(&a.k, qr, bar_k, (row % a.heads) * HD, key0, row / a.heads, true);
  };
  auto load_v = [&](int row) {
    load(&a.v, vh, bar_v, (row % a.heads) * HD, key0, row / a.heads, true);
  };
  if (tid == 0) {
    load_k(blockIdx.y);
    load_v(blockIdx.y);
    load_do(blockIdx.y, 0);
    load_p(blockIdx.y, 0);
  }
  // Every block's barriers must be set up before a push reaches them:
  // arrived at now, waited for before the first push.
  if (blocks > 1) cluster_arrive_relaxed();

  const uint32_t v_addr = smem_u32(vh), kt_addr = smem_u32(kth), do_addr = smem_u32(dor);
  const uint32_t dot_addr = smem_u32(dot), ds_addr = smem_u32(dsh);
  int n = 0;                                   // this cluster's tiles so far
  for (int row = blockIdx.y, it = 0; row < rows_all; row += gridDim.y, ++it) {
    const int h = row % a.heads, b = row / a.heads;
    const bool more = row + gridDim.y < rows_all;       // a next row for this cluster

    // The slab: K transposed and split (keys permuted) out of Q's buffer,
    // then that row's first Q asked for; V split in place.
    mbar_wait(bar_k, it & 1);
    transpose_split<THREADS>(qr, kth, kth + F32_PIECE, tid);
    mbar_wait(bar_v, it & 1);
    split_tile<THREADS>(vh, vh + F32_PIECE, tid);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) load_q(row, 0);

    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    for (int u = 0; u < tiles; ++u, ++n) {
      const uint32_t ph = n & 1;
      const int q0 = u * TILE, rows = min(TILE, a.lq - q0);
      // this warpgroup's 8-row steps with a real query row
      const int qsteps = max(0, min(4, (rows - col0 + 7) / 8));
      const bool last = u + 1 == tiles;       // the next tile is the next row's first
      const int nrow = last ? row + gridDim.y : row, nu = last ? 0 : u + 1;
      const bool next = !last || more;        // a next tile for this cluster

      // dO: transposed and split into dOᵀ (for dV), then split in place (for
      // dPᵀ).
      mbar_wait(bar_do, ph);
      transpose_split<THREADS>(dor, dot, dot + F32_PIECE, tid);
      __syncthreads();                         // every thread has read the raw tile
      split_tile<THREADS>(dor, dor + F32_PIECE, tid);
      fence_proxy_async();
      __syncthreads();

      // dPᵀ = V_slab·dOᵀ (keys × this warpgroup's query rows), while P comes
      // into registers at the accumulator's places (key r0 + 8r, query row
      // col0 + 8j + c2 + e).
      float x[16], p[16];
      tf32_product_ss(x, v_addr, do_addr + col0 * 128, 8);
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
      __syncthreads();                         // P read; dO and V read by the products
      if (tid == 0 && next) {
        load_p(nrow, nu);
        if (last) load_v(nrow);
      }

      // D_c = rowsum over the slab's keys of dP ∘ P: the thread's two keys,
      // the eight lanes of a column, then the warpgroup's four warps in order.
      float part[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[2 * j + e] = x[4 * j + e] * p[4 * j + e] + x[4 * j + 2 + e] * p[4 * j + 2 + e];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i) part[i] += __shfl_xor_sync(0xffffffffu, part[i], m);
      if (g == 0)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(dpart + warp * TILE + col0 + 8 * j + c2) =
              make_float2(part[2 * j], part[2 * j + 1]);
      if (blocks > 1 && n == 0) cluster_wait();   // every block's barriers are set up
      __syncthreads();
      if (tid < TILE) {
        const float* w4 = dpart + 4 * (tid >> 5) * TILE + tid;   // the owning warpgroup's warps
        const float dc = ((w4[0] + w4[TILE]) + w4[2 * TILE]) + w4[3 * TILE];
        if (blocks == 1) {
          dfull[tid] = dc;
        } else {                               // into every block's D_c of this rank
          const uint32_t at = smem_u32(xd + rank * TILE + tid);
          for (int pb = 0; pb < blocks; ++pb) st_async(mapa(at, pb), dc, mapa(bar_d, pb));
        }
      }
      // While the D_c travel: Q transposed and split into Qᵀ over dO's tiles
      // (read by dPᵀ).
      mbar_wait(bar_q, ph);
      transpose_split<THREADS>(qr, dor, dor + F32_PIECE, tid);
      fence_proxy_async();
      if (blocks > 1) {                        // D = Σ D_c in rank order
        mbar_wait_cluster(bar_d, ph);
        if (tid < TILE) {
          float y[MAX_C];
#pragma unroll
          for (int pb = 0; pb < MAX_C; ++pb)
            if (pb < blocks) y[pb] = xd[pb * TILE + tid];
          float s = y[0];
#pragma unroll
          for (int pb = 1; pb < MAX_C; ++pb)
            if (pb < blocks) s += y[pb];
          dfull[tid] = s;
        }
      }
      __syncthreads();                         // D; Qᵀ written, Q read
      if (tid == 0 && next) {
        if (blocks > 1) mbar_expect_tx(bar_d, blocks * TILE * 4);
        if (last)
          load_k(nrow);                        // the next row's Q comes once K is transposed
        else
          load_q(row, u + 1);
      }

      // dSᵀ = Pᵀ ∘ (dPᵀ − D), in place of dPᵀ.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(dfull + col0 + 8 * j + c2);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          x[4 * j + 2 * r] = p[4 * j + 2 * r] * (x[4 * j + 2 * r] - dd.x);
          x[4 * j + 2 * r + 1] = p[4 * j + 2 * r + 1] * (x[4 * j + 2 * r + 1] - dd.y);
        }
      }

      // dV += Pᵀ·dO over this warpgroup's query rows: Pᵀ's fragments from
      // registers, dOᵀ (rows permuted alike) as B.
      {
        uint32_t fh[4][4], fl[4][4];
        tf32_fragments(p, fh, fl);
        tf32_product_rs(dv, fh, fl, dot_addr, 4 * wg, qsteps);
        wgmma_wait<0>();
        fence_regs(dv);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(fh[kk]);
          fence_regs(fl[kk]);
        }
      }

      // dK += dSᵀ·Q over this warpgroup's query rows (dSᵀ's fragments from
      // registers, Qᵀ as B), and dS into shared memory (query rows × keys,
      // keys permuted as Kᵀ's: key 8s + i at slot 8s + 4(i % 2) + i / 2) for
      // dQ_c = dS·K_slab (dS and Kᵀ K-major). The staged dQ partial of the
      // tile before has been copied out: every block's D_c of this tile came
      // after its copies landed.
      float dq[16];
      {
        uint32_t sh[4][4], sl[4][4];
        tf32_fragments(x, sh, sl);
        tf32_product_rs(dk, sh, sl, do_addr, 4 * wg, qsteps);
        const int slot = 4 * (g & 1) + (g >> 1);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * (2 * (warp & 3) + r) + slot, qr_ = col0 + 8 * j + c2 + e;
              const int off = (col >> 5) * F32_HALF + qr_ * 128 +
                              ((((col & 31) >> 2) ^ (qr_ & 7)) << 4) + (col & 3) * 4;
              const float hi = __uint_as_float(tf32_rna(x[4 * j + 2 * r + e]));
              *reinterpret_cast<float*>(dsh + off) = hi;
              *reinterpret_cast<float*>(dsh + F32_PIECE + off) =
                  __uint_as_float(tf32_rna(x[4 * j + 2 * r + e] - hi));
            }
        fence_proxy_async();
        __syncthreads();
        tf32_product_ss(dq, ds_addr, kt_addr + col0 * 128, ksteps);
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(sh[kk]);
          fence_regs(sl[kk]);
        }
      }
      __syncthreads();                         // Qᵀ (dO's tiles), dS and Kᵀ read by the products
      if (tid == 0 && next) load_do(nrow, nu);

      // dQ (this warpgroup's dims): this block's partial straight out (one
      // block), or staged over dS and its rows copied to the blocks that sum
      // them.
      float* const dq_out = a.dq + (static_cast<long long>(b) * a.lq + q0) * dm + h * HD;
      if (blocks == 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (r0 + 8 * r < rows)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<float2*>(dq_out + (r0 + 8 * r) * dm + col0 + 8 * j + c2) =
                  make_float2(dq[4 * j + 2 * r] * a.scale, dq[4 * j + 2 * r + 1] * a.scale);
      } else {
        stage_partial(dsh, dq, r0, c2, col0);   // this warpgroup's dims
        fence_proxy_async();
        __syncthreads();
        if (warp == 0)
          push_shares(ds_addr, smem_u32(recv), bar_x, rank, blocks, rows, lane);
        mbar_wait_cluster(bar_x, ph);
        reduce_share<MAX_C>(recv, blocks, qrow0, qrow1, a.scale, dq_out, dm, rows, tid, THREADS);
        __syncthreads();                       // the receive area read
        if (tid == 0 && next) mbar_expect_tx(bar_x, x_bytes(nu));
      }
    }

    // dK and dV of the slab's real keys: warpgroup 0's part + warpgroup 1's,
    // dV added and stored by warpgroup 0, dK by warpgroup 1, each passing the
    // other its part over dOᵀ's tiles (read by the row's last dV).
    float2* const stage = reinterpret_cast<float2*>(dot);
    const long long base = static_cast<long long>(b) * a.lk * dm + h * HD;
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
      store(a.dv, dv, 1.f);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 o = stage[i * 128 + t128];
        dk[2 * i] = o.x + dk[2 * i];
        dk[2 * i + 1] = o.y + dk[2 * i + 1];
      }
      store(a.dk, dk, a.scale);
    }
  }
  if (blocks > 1) {          // no block leaves while a copy from its shared memory may be on its way
    cluster_arrive_relaxed();
    cluster_wait();
  }
}

// Launches the kernel, G = min(B·H, the clusters the card holds at once)
// clusters of ⌈Lk/64⌉ blocks.
int launch_bwd_tf32x3(const BwdTf32Args& a, cudaStream_t stream) {
  const auto kernel = attention_bwd_tf32x3_kernel;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool raised[64] = {};                // the shared-memory limit, once per device
  static int resident[64][MAX_C + 1] = {};    // clusters held at once, by their blocks
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[device] = true;
  }
  const int blocks = (a.lk + TILE - 1) / TILE;
  int& held = resident[device][blocks];
  if (!held) {
    err = launch_clusters(kernel, a, dim3(blocks, 1), blocks, THREADS, SMEM_BYTES, stream, &held);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (held < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rows = a.batch * a.heads;
  err = launch_clusters(kernel, a, dim3(blocks, rows < held ? rows : held), blocks, THREADS,
                        SMEM_BYTES, stream, nullptr);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace
}  // namespace segclip_kernels

using namespace segclip_kernels;

extern "C" {

// The longest Lk that `segclip_attention_bwd_tf32x3` takes.
int segclip_attention_bwd_tf32x3_limit() { return BWD_TF32X3_LIMIT; }

// The float32 TF32x3 backward, for 1 ≤ Lk ≤ BWD_TF32X3_LIMIT, with the
// arguments of `segclip_attention_bwd_one_pass`: strides in elements; the
// wrapper guarantees 16-byte aligned p, dO, q, k, v and strides (multiples
// of 4 elements), P's rows at least Lk long; P's batch and head dims read as
// one (B·H) dim, p_bs = H·p_hs unless B or H is 1. dq, dk, dv are
// contiguous float32 (B, L, H·64). Returns the cudaError_t of the launch (0
// on success).
int segclip_attention_bwd_tf32x3(const void* p, const void* dout, const void* q, const void* k,
                                 const void* v, void* dq, void* dk, void* dv, int batch,
                                 int heads, int lq, int lk, long long p_bs, long long p_hs,
                                 long long p_rs, long long do_bs, long long do_rs, long long q_bs,
                                 long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                 long long v_rs, float scale, void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || lk > BWD_TF32X3_LIMIT ||
      static_cast<long long>(batch) * heads > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lq > 1 && (p_rs < lk || p_rs % 4)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 1 && heads > 1 && p_bs != heads * p_hs)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long dm = static_cast<long long>(heads) * HD;
  const long long p_bh = heads > 1 ? p_hs : p_bs;        // the stride of the B·H dim
  BwdTf32Args a{};
  const bool ok =
      encode_f32_3d(&a.p, p, lk, lq, static_cast<uint64_t>(batch) * heads, p_rs, p_bh) &&
      encode_f32_3d(&a.dout, dout, dm, lq, batch, do_rs, do_bs) &&
      encode_f32_3d(&a.q, q, dm, lq, batch, q_rs, q_bs) &&
      encode_f32_3d(&a.k, k, dm, lk, batch, k_rs, k_bs) &&
      encode_f32_3d(&a.v, v, dm, lk, batch, v_rs, v_bs);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.batch = batch;
  a.heads = heads;
  a.lq = lq;
  a.lk = lk;
  a.scale = scale;
  return launch_bwd_tf32x3(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
