// Semantic group assignment for Hopper (sm_90a), eval and training forward,
// in one launch: one thread-block cluster per image.
//
// Replaces the TPU kernel `_kernel` of segclip_tpu/ops/pallas/grouping.py
// (pallas_call at :124), reached at eval through `fused_group_assign` (:141,
// training=False) and at training through `fused_group_assign_st` (:158,
// training=True). Per image n:
//   logits = q·kᵀ                 (G, L), fp32 sums of exact products, unscaled
//   soft   = softmax over G        per patch
//   y_soft = softmax over G of (logits + noise) / tau   (training; = soft at eval)
//   hard   = one-hot argmax_G y_soft, ties to the lowest group index
//   out    = hard·v / max(Σ_L hard, 1), accumulated in fp32, cast to v's dtype
// The Gumbel noise (N, G, L) fp32 comes in from the caller, as the TPU
// kernel's does; y_soft is written out as the straight-through backward's
// residual. At eval the noise pointer is null and nothing else changes.
// The TPU's lane padding (G to 8, L to 128, −1e30 rows) is not carried
// over: groups past G are masked in the softmaxes, patches past L are not
// read.
//
// What bounds it on the H100. At the training shape (96×8×196×768, bf16)
// the call must read k and v, 58 MB: it is bound by bytes (18.7 µs at
// 3.35 TB/s), so the loads must be wide and many must be in flight. At
// eval (N ≤ 2) it reads under 1.3 MB and is bound by latency: the launch
// and the chain of dependent steps inside each block.
//
// What the design does about each:
//   - One launch per call. The grid is (C, N) with a cluster of C = 8
//     blocks per image (cudaLaunchKernelEx). Block r assigns patch rows
//     [r·R, r·R + R), R a multiple of 16, then stores their winning groups
//     into every peer's shared memory (distributed shared memory), and one
//     cluster barrier later every block holds all L winners, counts them,
//     and sums its own D/C columns of v over all L patches. Since no block
//     reads a peer's shared memory after that barrier, none is needed
//     before exit; the barrier's arrival at the start, waited for before
//     the stores, guarantees every peer has started. Nothing passes through
//     global memory between the two halves.
//   - Logits on tensor cores (bf16). logitsᵀ of 16 patches is k_tile (16 ×
//     16) · qᵀ (16 × 8) per k-step: `mma.sync.m16n8k16` with N = 8 groups
//     (up to four n-tiles for G ≤ 32), bf16 products exact in fp32, fp32
//     sums. q is staged once per block in bf16 and read as B fragments by
//     `ldmatrix`. A block owns at most a few 16-patch tiles, so the 8 warps
//     split each tile's D (k-steps w, w + 8, ...) rather than own a tile
//     each, and their partial tiles are added in warp order through shared
//     memory. The softmaxes and the argmax over G then take half a warp per
//     patch (a warp when G > 16), lane g holding group g, so the
//     lowest-index tie rule is the shuffle reduction's.
//   - hard·v on tensor cores (bf16): hardᵀ (G × L) · v (L × 16 columns),
//     the one-hot A fragments built in registers from the winners (exact in
//     bf16), B read by `ldmatrix.trans` from the staged slice of v; each
//     warp owns 16-column pieces, sums over all L in a fixed order and
//     writes its piece of out.
//   - 16-byte streaming. q, the k tiles (two in flight) and v's column
//     slice move by `cp.async` 16-byte copies into rows padded to an odd
//     number of 16-byte units (`ldmatrix` has no bank conflict). v's slice
//     has its own space when the block still fits three to an SM, else it
//     goes into the k tiles' space once the last tile is read.
//   - The float32 form (the parity path) and any operand the 16-byte path
//     does not take (D not a multiple of 16 bytes, a pointer off 16 bytes)
//     run the same structure with exact-fp32 SIMT logits (no TF32; warps
//     split D, lanes keep 8 groups' partial dots at a time) and hard·v as
//     per-warp per-group partial sums in shared memory added in warp order;
//     vector loads where aligned, k and v from global memory where not.
// No float atomics: every sum has a fixed order, so a call run twice gives
// the same bits. An empty group gives 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tc_bf16.cuh"

namespace cg = cooperative_groups;

namespace segclip_kernels {
namespace {

using segclip_tc::bf16;

constexpr int C = 8;                 // blocks per image: the cluster (portable maximum)
constexpr int G_MAX = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16;             // patches per tile: the M of mma.m16n8k16
constexpr int U = 8;                 // v rows in flight per lane when v is read from global
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory one H100 block can use

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Byte offsets into the dynamic shared memory. The head (every winner of
// the image, one byte each, and the counts per group) and, when it fits,
// this block's slice of v live through the whole kernel; the assignment's
// buffers and the aggregation's partial sums share the space after them.
struct Layout {
  int gp;       // G rounded up to 8: n-tiles of the logits
  int rows;     // patch rows per block (a multiple of TILE)
  int ldk;      // row stride of the staged q (tensor cores) and k tiles, in elements
  int dc;       // columns of D per block (a multiple of the vector width)
  int ldv;      // row stride of the staged v slice, in elements
  int kstages;  // k tiles staged at once (16-byte paths)
  bool stage_v; // v's slice is staged too
  bool v_in_ring;  // ... into the k tiles' space, once the last tile is read
  size_t total, vs, q, k, red, part, bytes;

  __host__ __device__ Layout(int G, int L, int D, int elem, bool tc, bool vec) {
    const int vw = vec ? 16 / elem : 1;
    gp = cdiv(G, 8) * 8;
    rows = cdiv(cdiv(L, TILE), C) * TILE;
    dc = cdiv(cdiv(D, C), vw) * vw;
    // rows of an odd number of 16-byte units: 8 rows hit 8 bank groups
    ldk = tc ? cdiv(D, 16) * 16 + 8 : D + ((D / vw) % 2 == 0 ? vw : 2 * vw);
    ldv = tc ? cdiv(dc, 16) * 16 + 8 : dc;
    total = align16(L);
    const size_t head = total + 4 * G_MAX;
    const size_t vbytes = align16(static_cast<size_t>(cdiv(L, TILE)) * TILE * ldv * elem);
    const int most = rows / TILE < 2 ? rows / TILE : 2;
    // v apart if the block still fits three to an SM, else v in the k
    // tiles' space (tensor-core path); then one k stage; then v unstaged
    for (int choice = 0; choice < 5; ++choice) {
      kstages = vec ? (choice == 2 || choice == 4 ? 1 : most) : 0;
      stage_v = vec && choice < 3;
      const size_t ring = static_cast<size_t>(kstages) * TILE * ldk * elem;
      v_in_ring = tc && stage_v && choice >= 1 && vbytes <= ring;
      const size_t body = head + (stage_v && !v_in_ring ? vbytes : 0);
      q = body;
      size_t at = q + align16(tc ? static_cast<size_t>(gp) * ldk * elem
                                 : static_cast<size_t>(G) * D * elem);
      k = at;
      at += ring;
      vs = v_in_ring ? k : head;
      red = at;
      at += static_cast<size_t>(WARPS) * TILE * gp * 4;
      part = body;
      const size_t agg = part + (tc && stage_v ? 0 : static_cast<size_t>(WARPS) * G * dc * 4);
      bytes = at > agg ? at : agg;
      if (bytes <= (choice == 0 ? SMEM_MAX / 3 - 1024 : SMEM_MAX)) break;
    }
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* noise;   // (N, G, L) or null (eval)
  float tau;
  void* out;
  float* hard;
  float* soft;
  float* ysoft;         // null at eval
  int G, L, D;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// 16 bytes of T as fp32, by bit operations (a bf16 is the top half of its
// fp32), so that nothing is taken by address and spilled to local memory.
template <typename T>
__device__ __forceinline__ void unpack16(float (&x)[16 / sizeof(T)], const uint4 r) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      x[i] = __uint_as_float(w[i]);
    } else {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// VW elements of T from p as fp32: one 16-byte load when VW > 1.
template <typename T, int VW>
__device__ __forceinline__ void load_vec(float (&x)[VW], const T* p) {
  if constexpr (VW == 1) {
    x[0] = to_f32(*p);
  } else {
    unpack16<T>(x, *reinterpret_cast<const uint4*>(p));
  }
}

// rows × pieces 16-byte pieces from src (row stride sld elements) to dst
// (row stride dld) by cp.async, spread over the block's threads.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dld, const T* src, long long sld, int rows,
                                          int pieces, int tid) {
  constexpr int EP = 16 / sizeof(T);
  int r = tid / pieces, c = tid - r * pieces;
  const int dr = THREADS / pieces, dp = THREADS - dr * pieces;
  while (r < rows) {
    segclip_tc::cp_async16(dst + r * dld + c * EP, src + r * sld + c * EP, 16);
    r += dr;
    c += dp;
    if (c >= pieces) {
      c -= pieces;
      ++r;
    }
  }
}

// Waits until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0) segclip_tc::cp_async_wait<0>();
  else if (n == 1) segclip_tc::cp_async_wait<1>();
  else segclip_tc::cp_async_wait<2>();
}

// Softmax over the G lanes of a group of `width` lanes (16 or 32; lanes
// with gi ≥ G hold −inf and give 0).
__device__ __forceinline__ float lane_softmax(float x, int gi, int G, int width) {
  float m = x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < width) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  const float e = gi < G ? expf(x - m) : 0.f;
  float sum = e;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < width) sum += __shfl_xor_sync(FULL, sum, off);
  return e / sum;
}

// The gi < G with the largest y, the lowest such gi on ties.
__device__ __forceinline__ int lane_argmax(float y, int gi, int G, int width) {
  float best = gi < G ? y : -1.f;
  int idx = gi;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off >= width) continue;
    const float ob = __shfl_xor_sync(FULL, best, off);
    const int oi = __shfl_xor_sync(FULL, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  return idx;
}

// A warp's share of one tile's logits on tensor cores: the k-steps
// kk = warp, warp + WARPS, ... of k_tile (16 × D) · qᵀ (D × gp), written to
// the warp's (16 × gp) slab of `red`.
__device__ __forceinline__ void tile_logits_tc(const bf16* kt, const bf16* qs, int ldk,
                                               int ksteps, int gp, float* red, int warp,
                                               int lane) {
  float acc[G_MAX / 8][4] = {};
  for (int kk = warp; kk < ksteps; kk += WARPS) {
    uint32_t a[4];
    segclip_tc::ldmatrix_x4(a, kt + (lane & 15) * ldk + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < G_MAX / 8; ++j) {
      if (8 * j >= gp) break;
      uint32_t b[2];
      segclip_tc::ldmatrix_x2(b, qs + (8 * j + (lane & 7)) * ldk + kk * 16 + ((lane >> 3) & 1) * 8);
      segclip_tc::mma(acc[j], a, b[0], b[1]);
    }
  }
  float* mine = red + warp * TILE * gp;
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < G_MAX / 8; ++j) {
    if (8 * j >= gp) break;
    mine[g * gp + 8 * j + c] = acc[j][0];
    mine[g * gp + 8 * j + c + 1] = acc[j][1];
    mine[(g + 8) * gp + 8 * j + c] = acc[j][2];
    mine[(g + 8) * gp + 8 * j + c + 1] = acc[j][3];
  }
}

// The same share by fp32 FMAs, with k rows at kt + r·ldk (shared memory,
// or global memory on the general path): the warp takes the D-range
// [warp·dw, warp·dw + dw); lane (r, h) = (lane % 16, lane / 16) takes tile
// row r's VW-wide pieces h, h + 2, ... of it, four in flight, and keeps the
// partial dots of 8 groups at a time; the two halves are added by a
// shuffle.
template <typename T, int VW>
__device__ __forceinline__ void tile_logits_simt(const T* qs, const T* kt, long long ldk,
                                                 int nrows, int G, int gp, int D, float* red,
                                                 int warp, int lane) {
  constexpr int B = 4;
  const int dw = cdiv(cdiv(D, VW), WARPS) * VW;
  const int d_hi = min(D, (warp + 1) * dw);
  const int r = lane & 15;
  const T* kr = kt + r * ldk;
  float* mine = red + warp * TILE * gp + r * gp;
  for (int g0 = 0; g0 < G; g0 += 8) {
    float part[8] = {};
    if (r < nrows) {
      for (int d0 = warp * dw + (lane >> 4) * VW; d0 < d_hi; d0 += 2 * VW * B) {
        float kv[B][VW];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int d = d0 + b * 2 * VW;
          if (d < d_hi) load_vec<T, VW>(kv[b], kr + d);
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int d = d0 + b * 2 * VW;
          if (d >= d_hi) break;
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            if (g0 + g < G) {
              float qv[VW];
              load_vec<T, VW>(qv, qs + (g0 + g) * D + d);
#pragma unroll
              for (int i = 0; i < VW; ++i) part[g] = fmaf(qv[i], kv[b][i], part[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      if (g0 + g < G) {
        const float s = part[g] + __shfl_xor_sync(FULL, part[g], 16);
        if (lane < 16) mine[g0 + g] = s;
      }
    }
  }
}

// hard·v for this block's columns on tensor cores, from the staged v slice
// (rows padded with zeros to a multiple of 16, columns to a multiple of
// 16): out (G × 16) = hardᵀ (G × L) · v (L × 16) for each 16-column piece,
// the one-hot A fragments built in registers from the winners (exact in
// bf16), fp32 sums over all L in order, divided by the count and written
// out. Warp w takes the pieces w, w + WARPS, ...
__device__ __forceinline__ void aggregate_tc(const bf16* vs, int ldv, const unsigned char* allwin,
                                             const int* total, int G, int L, int D, int cw,
                                             bf16* out, int warp, int lane) {
  const int gq = lane >> 2, cq = 2 * (lane & 3), msteps = cdiv(G, 16), ksteps = cdiv(L, TILE);
  for (int cb = 16 * warp; cb < cw; cb += 16 * WARPS) {
    float acc[2][2][2][4] = {};                                // [chain][m-tile][n-tile]
    // k-step ks into chain c: the winners of patches kb + cq, +1 and
    // kb + cq + 8, +9 (bytes past L are 0xff, no group), B from v's slice
    auto step = [&](int ks, float (&chain)[2][2][4]) {
      const int kb = ks * TILE;
      const uint32_t w01 = *reinterpret_cast<const uint16_t*>(allwin + kb + cq);
      const uint32_t w89 = *reinterpret_cast<const uint16_t*>(allwin + kb + cq + 8);
      const int wk[4] = {static_cast<int>(w01 & 0xff), static_cast<int>(w01 >> 8),
                         static_cast<int>(w89 & 0xff), static_cast<int>(w89 >> 8)};
      uint32_t r[4];
      segclip_tc::ldmatrix_x4_trans(r, vs + (kb + (lane & 15)) * ldv + cb + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= msteps) break;
        const int g0 = 16 * mt + gq, g1 = g0 + 8;
        const uint32_t a[4] = {segclip_tc::pack(wk[0] == g0, wk[1] == g0),
                               segclip_tc::pack(wk[0] == g1, wk[1] == g1),
                               segclip_tc::pack(wk[2] == g0, wk[3] == g0),
                               segclip_tc::pack(wk[2] == g1, wk[3] == g1)};
        segclip_tc::mma(chain[mt][0], a, r[0], r[1]);
        segclip_tc::mma(chain[mt][1], a, r[2], r[3]);
      }
    };
    int ks = 0;
#pragma unroll 2
    for (; ks + 1 < ksteps; ks += 2) {                         // even and odd k-steps: two chains
      step(ks, acc[0]);
      step(ks + 1, acc[1]);
    }
    if (ks < ksteps) step(ks, acc[0]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cb + 8 * j + cq;
        if (col >= cw) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int g = 16 * mt + gq + 8 * h;
          if (g >= G) continue;
          const float den = fmaxf(static_cast<float>(total[g]), 1.f);
          const float s0 = acc[0][mt][j][2 * h] + acc[1][mt][j][2 * h];
          const float s1 = acc[0][mt][j][2 * h + 1] + acc[1][mt][j][2 * h + 1];
          *reinterpret_cast<uint32_t*>(out + static_cast<long long>(g) * D + col) =
              segclip_tc::pack(s0 / den, s1 / den);
        }
      }
    }
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Grid (C, N), cluster (C, 1, 1), THREADS threads, Layout::bytes of dynamic
// shared memory. VEC: D is a multiple of 16 bytes of T and q, k, v are
// 16-byte aligned: q, k tiles and v's slice are then staged by cp.async,
// and with T = bf16 the logits and hard·v run on tensor cores. Otherwise
// (the general path) k and v are read from global memory by the threads.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 3) group_assign_kernel(Args a) {
  constexpr bool TC = std::is_same<T, bf16>::value && VEC;
  constexpr int VW = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int E = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x < (16 - a.L % 16) % 16) smem[a.L + threadIdx.x] = 0xff;   // past L: no group
  cluster_arrive_relaxed();                                    // waited for before writing to peers
  const int rank = static_cast<int>(cluster.block_rank());
  const long long n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, L = a.L, D = a.D;
  const Layout lay(G, L, D, E, TC, VEC);
  const int gp = lay.gp, ldk = lay.ldk, ldv = lay.ldv, kst = lay.kstages;

  unsigned char* allwin = smem;                                // every winner of the image
  int* total = reinterpret_cast<int*>(smem + lay.total);       // patches per group
  T* vs = reinterpret_cast<T*>(smem + lay.vs);
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* ks = reinterpret_cast<T*>(smem + lay.k);
  float* red = reinterpret_cast<float*>(smem + lay.red);       // the warps' partial logits
  float* part = reinterpret_cast<float*>(smem + lay.part);     // the warps' partial hard·v
  const int l0 = rank * lay.rows, l1 = min(L, l0 + lay.rows);
  const int ntiles = l1 > l0 ? cdiv(l1 - l0, TILE) : 0;
  const T* q = static_cast<const T*>(a.q) + n * G * D;
  const T* k = static_cast<const T*>(a.k) + n * L * D;
  const T* v = static_cast<const T*>(a.v) + n * L * D;
  const int c0 = rank * lay.dc, cw = min(lay.dc, D - c0);      // this block's columns of v
  const bool v_staged = lay.stage_v && cw > 0;
  // v's slice comes in at the start, or into the k tiles' space after the
  // last tile is read
  const bool v_early = v_staged && (!lay.v_in_ring || ntiles == 0);
  if (tid < G_MAX) total[tid] = 0;

  // ---- staging by 16-byte cp.async: q with the first k tile, the next k
  // tiles, then v's slice, one commit group each. Rows past the block's
  // patches are not copied (their logits are never read); where the tensor
  // cores read past D or past the slice, zeros are written.
  int committed = 0;                                           // cp.async groups so far
  auto stage_tile = [&](int t) {
    const int r0 = l0 + t * TILE;
    copy_rows(ks + (t % kst) * TILE * ldk, ldk, k + static_cast<long long>(r0) * D, D,
              min(TILE, l1 - r0), D / VW, tid);
    segclip_tc::cp_async_commit();
    ++committed;
  };
  auto load_v = [&]() {
    if constexpr (TC) {                                        // v rows [L, 16⌈L/16⌉), columns [cw, ldv − 8)
      const int wv = ldv - 8, cpad = wv - cw, lpad = cdiv(L, TILE) * TILE - L;
      for (int e = tid; e < lpad * wv; e += THREADS) vs[(L + e / wv) * ldv + e % wv] = from_f32<T>(0.f);
      for (int e = tid; e < L * cpad; e += THREADS) vs[(e / cpad) * ldv + cw + e % cpad] = from_f32<T>(0.f);
    }
    copy_rows(vs, ldv, v + c0, D, L, cw / VW, tid);
    segclip_tc::cp_async_commit();
    ++committed;
  };
  if constexpr (VEC) {
    if (TC && ntiles > 0) {                                    // q and k columns [D, ldk − 8)
      const int dpad = ldk - 8 - D;
      for (int e = tid; e < (gp + kst * TILE) * dpad; e += THREADS) {
        const int r = e / dpad, c = D + e % dpad;
        (r < gp ? qs + r * ldk : ks + (r - gp) * ldk)[c] = from_f32<T>(0.f);
      }
    }
    if (ntiles > 0) {
      copy_rows(qs, TC ? ldk : D, q, D, G, D / VW, tid);
      for (int t = 0; t < min(kst, ntiles); ++t) stage_tile(t);
    }
    if (v_early) load_v();
  } else {
    for (int e = tid; e < G * D; e += THREADS) qs[e] = q[e];
  }

  // ---- assignment, one tile of 16 patches at a time. The softmaxes take
  // half a warp per patch when G ≤ 16 (two patches at once), else a warp.
  const int width = G <= 16 ? 16 : 32, gi = lane & (width - 1);
  for (int t = 0; t < ntiles; ++t) {
    const int r0 = l0 + t * TILE;
    float nz[2] = {0.f, 0.f};                                  // noise of this warp's patches
    if (a.noise) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (width == 16 && h == 1) break;
        const int l = r0 + warp + 8 * (width == 16 ? lane >> 4 : h);
        if (l < l1 && gi < G) nz[h] = a.noise[(n * G + gi) * L + l];
      }
    }
    if constexpr (VEC) {                                       // tile t's group: t, or t + 1 past v's
      cp_async_wait_n(committed - 1 - (t < kst || !v_early ? t : t + 1));
    }
    __syncthreads();                                           // tile t landed; red free
    if constexpr (TC) {
      tile_logits_tc(ks + (t % kst) * TILE * ldk, qs, ldk, (ldk - 8) / 16, gp, red, warp, lane);
    } else if constexpr (VEC) {
      tile_logits_simt<T, VW>(qs, ks + (t % kst) * TILE * ldk, ldk, l1 - r0, G, gp, D, red, warp,
                              lane);
    } else {
      tile_logits_simt<T, VW>(qs, k + static_cast<long long>(r0) * D, D, l1 - r0, G, gp, D, red,
                              warp, lane);
    }
    __syncthreads();                                           // partials written, tile read
    if constexpr (VEC) {
      if (t + kst < ntiles) stage_tile(t + kst);               // refill the stage just read
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (width == 16 && h == 1) break;
      const int p = warp + 8 * (width == 16 ? lane >> 4 : h), l = r0 + p;
      float logit = -INFINITY;
      if (gi < G) {                                            // the warps' partials, in warp order
        logit = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) logit += red[(w * TILE + p) * gp + gi];
      }
      const float pr = lane_softmax(logit, gi, G, width);
      float py = pr;                                           // the softmax the winner comes from
      if (a.noise)
        py = lane_softmax(gi < G ? (logit + nz[h]) / a.tau : -INFINITY, gi, G, width);
      const int idx = lane_argmax(py, gi, G, width);
      if (l < l1 && gi < G) {
        const long long o = (n * G + gi) * L + l;
        a.soft[o] = pr;
        a.hard[o] = gi == idx ? 1.f : 0.f;
        if (a.ysoft) a.ysoft[o] = py;
        if (gi == 0) allwin[l] = static_cast<unsigned char>(idx);
      }
    }
    if constexpr (VEC) {
      if (t + 1 == ntiles && v_staged && !v_early) load_v();   // the k tiles are read
    }
  }

  // ---- this block's winners into every peer's shared memory, then one
  // cluster barrier: after it every block holds all L winners, and no block
  // touches another's shared memory again
  __syncthreads();
  cluster_wait();                                              // every peer has started
  {
    const int words = cdiv(l1 - l0, 4);                        // l0 is a multiple of 16
    const uint32_t* mine = reinterpret_cast<const uint32_t*>(allwin + (l1 > l0 ? l0 : 0));
    for (int e = tid; e < (C - 1) * words; e += THREADS) {
      const int peer = (rank + 1 + e / words) % C, w = e % words;
      cluster.map_shared_rank(const_cast<uint32_t*>(mine), peer)[w] = mine[w];
    }
  }
  cluster.sync();
  for (int l = tid; l < L; l += THREADS) atomicAdd(&total[allwin[l]], 1);   // integers
  if (v_staged) segclip_tc::cp_async_wait<0>();
  __syncthreads();                                             // counts and v's slice in place
  if (cw <= 0) return;
  T* out = static_cast<T*>(a.out) + n * G * D + c0;
  if constexpr (TC) {
    if (v_staged) {
      aggregate_tc(vs, ldv, allwin, total, G, L, D, cw, out, warp, lane);
      return;
    }
  }

  // ---- aggregation of this block's columns by the threads: each warp
  // adds its rows of v (l = warp, warp + WARPS, ...) into its own per-group
  // partial sums, which are then added in warp order
  for (int e = tid; e < WARPS * G * lay.dc; e += THREADS) part[e] = 0.f;
  __syncthreads();
  using Raw = typename std::conditional<VEC, uint4, T>::type;
  const T* src = v_staged ? vs : v + c0;                       // row l of the slice at src + l·stride
  const long long stride = v_staged ? ldv : D;
  float* mine = part + warp * G * lay.dc;
  for (int j = lane; j < cw / VW; j += 32) {
    const int c = j * VW;
    for (int l = warp; l < L; l += WARPS * U) {
      Raw x[U];
      int gw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int lu = l + u * WARPS;
        gw[u] = lu < L ? allwin[lu] : -1;
        if (lu < L) x[u] = *reinterpret_cast<const Raw*>(src + lu * stride + c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (gw[u] < 0) break;
        float* dst = mine + gw[u] * lay.dc + c;
        if constexpr (VEC) {
          float e[VW];
          unpack16<T>(e, x[u]);
#pragma unroll
          for (int i = 0; i < VW; i += 4) {
            float4 s = *reinterpret_cast<float4*>(dst + i);
            s.x += e[i];
            s.y += e[i + 1];
            s.z += e[i + 2];
            s.w += e[i + 3];
            *reinterpret_cast<float4*>(dst + i) = s;
          }
        } else {
          dst[0] += to_f32(x[u]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * cw; e += THREADS) {               // the warps' partials, in warp order
    const int g = e / cw, c = e - g * cw;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[(w * G + g) * lay.dc + c];
    out[static_cast<long long>(g) * D + c] = from_f32<T>(s / fmaxf(static_cast<float>(total[g]), 1.f));
  }
}

// Launches the kernel, or with `clusters` set, asks how many of its
// clusters fit on the card at once instead.
template <typename T, bool VEC>
int run(const Args& a, int n, cudaStream_t stream, size_t* smem, int* clusters) {
  constexpr bool TC = std::is_same<T, bf16>::value && VEC;
  const Layout lay(a.G, a.L, a.D, sizeof(T), TC, VEC);
  if (smem) *smem = lay.bytes;
  if (lay.bytes > SMEM_MAX) {
    if (clusters) *clusters = 0;
    return clusters ? 0 : static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = group_assign_kernel<T, VEC>;
  static size_t allowed = 48 * 1024;   // the most this instantiation may use so far (one card per process)
  if (lay.bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = lay.bytes;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, n);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg));
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

int dispatch(int dtype, int vec, const Args& a, int n, cudaStream_t s, size_t* smem,
             int* clusters) {
  if (n < 1 || n > 65535 || a.G < 1 || a.G > G_MAX || a.L < 1 || a.D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return vec ? run<float, true>(a, n, s, smem, clusters)
                             : run<float, false>(a, n, s, smem, clusters);
  if (dtype == 1) return vec ? run<bf16, true>(a, n, s, smem, clusters)
                             : run<bf16, false>(a, n, s, smem, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace segclip_kernels

using namespace segclip_kernels;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (N, G, D), k and v (N, L, D), out
// (N, G, D) contiguous in that dtype; noise (N, G, L) fp32 or null (eval);
// hard, soft and y_soft (N, G, L) fp32, y_soft null when noise is. vec = 1
// takes the 16-byte path: the caller guarantees D·sizeof(dtype) % 16 == 0
// and 16-byte aligned q, k and v. Returns the cudaError_t of the launch (0
// on success).
int segclip_group_assign(int dtype, int vec, const void* q, const void* k, const void* v,
                         const void* noise, float tau, void* out, void* hard, void* soft,
                         void* ysoft, int n, int g, int l, int d, void* stream) {
  if (noise && !(tau > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const float*>(noise), tau, out, static_cast<float*>(hard),
               static_cast<float*>(soft), static_cast<float*>(ysoft), g, l, d};
  return dispatch(dtype, vec, a, n, static_cast<cudaStream_t>(stream), nullptr, nullptr);
}

// What a call at these sizes needs: the bytes of shared memory per block,
// and how many clusters of C such blocks the current card can hold at once
// (0 when the shared memory exceeds a block's limit). Returns a
// cudaError_t.
int segclip_group_assign_limits(int dtype, int vec, int g, int l, int d, long long* smem,
                                int* clusters) {
  const Args a{nullptr, nullptr, nullptr, nullptr, 1.f, nullptr, nullptr, nullptr, nullptr,
               g, l, d};
  size_t bytes = 0;
  const int err = dispatch(dtype, vec, a, 1, nullptr, &bytes, clusters);
  *smem = static_cast<long long>(bytes);
  return err;
}

}  // extern "C"
