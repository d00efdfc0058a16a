// Attention forward at float32, softmax(Q Kᵀ·scale + bias2d + biasb)·V, on
// TF32 tensor cores with fp32-accurate split products, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of segclip_tpu/ops/pallas/attention.py
// (reached through `attention_vmem`, called at :186) for float32 operands:
// zero-shot eval at the reference's precision (`--compute-dtype float32`,
// amp O0, the batching-invariant eval mode), the float32 training step, the
// drift replay, and whole-image requests past 1024 patches at float32.
// `ops/kernels/attention.fwd_route` sends every float32 call here
// (`attention_fwd_tf32x3_kernel`), whatever its Lk; attention_fwd.cu's SIMT
// kernel, which took the float32 rows past 1024 keys before, is reached by
// no route.
//
// What it computes: the function and dtype chain of the float32 route, as
// the SIMT kernel does. Scores q·kᵀ·scale + bias2d + biasb in fp32; columns
// at or past Lk are −inf, bias2d may hold −inf, and a row whose every score
// is −inf gives NaN, as softmax does; the row max m, p = expf(s − m) / l in
// fp32; O = P·V summed in fp32 and written as (B, Lq, H·64); P, when asked
// for, normalised with the final m and l, into the wrapper's padded (B, H,
// Lq, Lk8) buffer (columns [Lk, Lk8) zero), which the float32 backward reads
// by its strides.
//
// What bounds it on the H100: bytes. At 96×196, H = 12, with P saved, Q, K,
// V, O and P are 408 MB (0.122 ms at 3.35 TB/s) against 11.3 GFLOP of
// fp32-accurate products, three TF32 products each (0.069 ms at 495 / 3
// TFLOP/s). The SIMT kernel it replaces is far from both: it computes Q·Kᵀ
// twice, every score as 64 FMAs each with its own shared-memory load, and
// every block of 16 rows loads K and V again.
//
// The design:
//   - fp32-accurate products on TF32 `wgmma` (3xTF32, the scheme of
//     PyTorch's float32 scaled_dot_product_attention): each operand x = hi +
//     lo, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x − hi); a·b = lo·hi +
//     hi·lo + hi·hi per 8-wide k-step into fp32 accumulators. lo·lo (about
//     2^-22 relative) is dropped; tests/test_torch_tf32x3.py emulates this
//     arithmetic and holds it to a tenth of the float32 tolerances.
//   - One block per 64-row query tile of one (batch, head), two warpgroups
//     that share each row's keys: rows go in chunks of at most four 64-key
//     pieces, warpgroup w taking pieces [w·NW, (w + 1)·NW), NW = ⌈NC/2⌉
//     (rows of at most 64 keys: one warpgroup, three blocks an SM).
//     Rows of at most 256 keys are one chunk: one Q·Kᵀ, expf once per
//     score, the row max and sum (each warpgroup's partial, combined through
//     shared memory, warpgroup 0's first), p / l, then P·V. Longer rows,
//     of any length: pass 1 finds m and l over the chunks (online, l
//     rescaled as m grows), pass 2 computes each chunk's scores again, forms
//     p = expf(s − m) / l, stores P and adds P·V. Past 1024 keys (a 448×672
//     image's 1176, a 224×2048 image's 1792) only the number of chunks
//     grows: the launch is the same one block per 64-row query tile, its
//     shape a function of Lk alone, never of B·H. O is the two warpgroups' partials
//     summed, warpgroup 0's first. P is normalised before P·V, so O is the
//     same with and without P saved, and nothing in a row depends on
//     another row, on the batch or on the launch: a batched decode equals
//     one image at a time bit for bit. A single warpgroup holding a 256-key
//     row's 128 scores a thread ran out of registers (ptxas spilled and
//     serialised its wgmma); half a row is 64.
//   - TMA copies (hopper.cuh): 64-row boxes of 32 floats (one 128-byte
//     swizzle row), two per 64-dim tile, from the q|k|v column views of the
//     packed projection on their own row strides; rows past Lq or Lk are
//     filled with zeros by the copy.
//   - TF32 `wgmma` reads 32-bit shared operands K-major only (no transpose
//     bit). Q·Kᵀ: Q and K tiles are K-major as they arrive; the threads
//     overwrite each with its hi part and write its lo part beside it (an
//     elementwise pass, so the swizzle is kept). P·V: V is not K-major as B,
//     so the threads write each V tile transposed into Vᵀ hi and Vᵀ lo tiles
//     (keys contiguous). P comes from registers as the A operand: the
//     accumulator holds keys {2t, 2t + 1} of each 8-key step in thread t =
//     lane % 4, where a TF32 A fragment wants k-slots {t, t + 4}; instead of
//     moving P, the reduction index is permuted: slot s of each 8-key step of
//     Vᵀ holds key 2s (s < 4) or 2(s − 4) + 1. The product is unchanged.
//   - Shared memory: every piece of a chunk at once, so each copy is asked
//     for up front and waited for once: the Q tile (hi, lo) and the chunk's
//     K tiles (hi, lo) for Q·Kᵀ, then, over the same bytes, its V tiles
//     (raw, Vᵀ hi, Vᵀ lo), copied in while the softmax runs (192 KB at four
//     pieces, one block per SM; 64 KB at one; Q is copied again for each
//     chunk of pass 2). Each warpgroup splits its own tiles, the next one
//     while the last one's products run. Each block reads K and V once per
//     query tile (K twice past 256 keys); they come from L2 after the first.
//   - The exponential is `expf`, the division hopper.cuh's branch-free
//     `div_normal`: correctly rounded for every l ≥ 1 and p ≥ 2^-100 (its
//     proof for l ≤ 1024 scales with l's exponent; attention_fwd_long.cu
//     says how, and chip_smoke.py's phase 1 holds it to IEEE `/` on the
//     card), and within an ulp below. P and O leave from registers by 8-byte stores, a
//     quad of threads writing 32 contiguous bytes of a row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace segclip_kernels {
namespace {

using namespace segclip_hopper;

constexpr int HDIM = 64;
constexpr int MAX_NC = 4;                       // 64-key pieces of a chunk, all in shared memory
constexpr int WG_THREADS = 128;
// Two warpgroups, each half of a chunk's pieces; rows of one piece (at most
// 64 keys) take one warpgroup, and three such blocks share an SM.
__host__ __device__ constexpr int threads_for(int nc) { return nc > 1 ? 2 * WG_THREADS : WG_THREADS; }
constexpr int HALF = F32_HALF;                  // 8192: 64 rows of 32 floats, one swizzled tile
constexpr int PIECE = F32_PIECE;                // a 64 × 64 fp32 tile
constexpr int K_OFF = 2 * PIECE;                // K piece i at K_OFF + 2i·PIECE: hi, lo
constexpr int V_STRIDE = 3 * PIECE;             // V piece i at i·V_STRIDE: raw, Vᵀ hi, Vᵀ lo

// Shared memory for chunks of NC pieces: the Q·Kᵀ phase's Q and K tiles, or
// the P·V phase's V tiles over the same bytes; then the row statistics'
// exchange (max and sum, [warpgroup][row]) and nine mbarriers (Q, K and V
// piece by piece).
__host__ __device__ constexpr int tiles_bytes(int nc) {
  return K_OFF + 2 * nc * PIECE > nc * V_STRIDE ? K_OFF + 2 * nc * PIECE : nc * V_STRIDE;
}
__host__ __device__ constexpr int smem_total(int nc) { return tiles_bytes(nc) + 4 * TILE * 4 + 72; }

struct Tf32Args {
  CUtensorMap q, k, v;     // (H·64, L, B) fp32 maps over the operands' own strides
  float* o;                // (B, Lq, H·64) contiguous
  float* p;                // (B, H, Lq, p_rs) or null
  const float* bias2d;     // (Lq, Lk) or null
  const float* biasb;      // (B, Lk) or null
  long long p_bs, p_hs, p_rs;
  int heads, lq, lk;
  float scale;
};

__device__ __forceinline__ float qmax(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float qsum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One block per 64-row query tile of one (batch, head): two warpgroups, each
// owning NW = ⌈NC/2⌉ of a chunk's 64-key pieces (warpgroup w pieces
// [w·NW, (w + 1)·NW)); one warpgroup where a row is one piece (NC = 1). In each warpgroup warp w' holds rows 16w' + g and
// 16w' + g + 8 of the tile and, per piece, keys 64c + 8j + 2(lane % 4) +
// {0, 1} (the accumulator layout). The row max and sum are combined across
// the warpgroups through shared memory, O's two partials at the end, always
// warpgroup 0's first: every block of every launch gives a row the same
// bits.
template <int NC>
__global__ void __launch_bounds__(threads_for(NC), NC > 1 ? 1 : 3) attention_fwd_tf32x3_kernel(
    const __grid_constant__ Tf32Args a) {
  constexpr int NW = (NC + 1) / 2;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* const sq = smem;                    // Q hi, Q lo at + PIECE
  float* const xm = reinterpret_cast<float*>(smem + tiles_bytes(NC));   // [warpgroup][row]
  float* const xl = xm + 2 * TILE;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(xl + 2 * TILE);     // Q, K 0-3, V 0-3
  const uint32_t bar_q = smem_u32(bars), bar_k0 = bar_q + 8, bar_v0 = bar_q + 40;

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);   // proven warp-uniform for ptxas
  const int t = tid & (WG_THREADS - 1), warp = t >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * warp + g;
  const int lk = a.lk;
  const int pieces = (lk + TILE - 1) / TILE;
  const int chunks = (pieces + NC - 1) / NC;
  const bool stream = chunks > 1;
  uint32_t ph_q = 0, ph_k = 0, ph_v = 0;       // barrier parities (bit i: piece i)

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();      // the swizzle needs 1024-byte tiles
    for (int i = 0; i < 9; ++i) mbar_init(bar_q + 8 * i, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // Thread 0's copies: Q, and chunk ch's K or V pieces, each a 64-row tile
  // as two 32-column boxes on its own barrier.
  auto load_tile = [&](const CUtensorMap* map, uint8_t* dst, uint32_t bar, int row) {
    mbar_expect_tx(bar, PIECE);
    tma_load_3d(dst, map, bar, h * HDIM, row, b);
    tma_load_3d(dst + HALF, map, bar, h * HDIM + 32, row, b);
  };
  auto issue_k = [&](int ch, bool with_q) {
    if (tid != 0) return;
    if (with_q) load_tile(&a.q, sq, bar_q, q0);
    for (int i = 0; i < min(NC, pieces - ch * NC); ++i)
      load_tile(&a.k, smem + K_OFF + 2 * i * PIECE, bar_k0 + 8 * i, (ch * NC + i) * TILE);
  };
  auto issue_v = [&](int ch) {
    if (tid != 0) return;
    for (int i = 0; i < min(NC, pieces - ch * NC); ++i)
      load_tile(&a.v, smem + i * V_STRIDE, bar_v0 + 8 * i, (ch * NC + i) * TILE);
  };
  auto ready_q = [&]() {                       // both warpgroups split Q; ends at a barrier
    mbar_wait(bar_q, ph_q);
    ph_q ^= 1;
    split_tile<threads_for(NC)>(sq, sq + PIECE, tid);
    fence_proxy_async();
    __syncthreads();
  };
  auto wait_k = [&](int i) {
    mbar_wait(bar_k0 + 8 * i, (ph_k >> i) & 1);
    ph_k ^= 1u << i;
  };
  auto wait_v = [&](int i) {
    mbar_wait(bar_v0 + 8 * i, (ph_v >> i) & 1);
    ph_v ^= 1u << i;
  };

  // S = Q·Kᵀ over this warpgroup's pieces of chunk ch (n pieces in all),
  // fp32, three TF32 products per k-step; each piece split while the last
  // one's products run.
  auto qk = [&](float (&s)[NW][32], int ch) {
    const int n = min(NC, pieces - ch * NC);
    const uint32_t q_addr = smem_u32(sq);
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      const int i = wg * NW + c;
      if (i < n) {
        uint8_t* kt = smem + K_OFF + 2 * i * PIECE;
        wait_k(i);
        split_tile<WG_THREADS>(kt, kt + PIECE, t);
        fence_proxy_async();
        named_sync(1 + wg, WG_THREADS);
        const uint32_t k_addr = smem_u32(kt);
        fence_regs(s[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t off = (kk >> 2) * HALF + (kk & 3) * 32;
          const uint64_t qh = desc_sw128(q_addr + off), ql = desc_sw128(q_addr + PIECE + off);
          const uint64_t kh = desc_sw128(k_addr + off), kl = desc_sw128(k_addr + PIECE + off);
          wgmma_m64n64k8_tf32_ss(s[c], ql, kh, kk);
          wgmma_m64n64k8_tf32_ss(s[c], qh, kl, 1);
          wgmma_m64n64k8_tf32_ss(s[c], qh, kh, 1);
        }
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NW; ++c) fence_regs(s[c]);
  };

  // Scale, biases, −inf past Lk, on this warpgroup's scores of chunk ch
  // (its pieces past the row's last are all −inf).
  const float* bb = a.biasb ? a.biasb + static_cast<long long>(b) * lk : nullptr;
  const float* b2r[2] = {nullptr, nullptr};
  if (a.bias2d) {
    b2r[0] = a.bias2d + static_cast<long long>(min(q0 + r0, a.lq - 1)) * lk;
    b2r[1] = a.bias2d + static_cast<long long>(min(q0 + r0 + 8, a.lq - 1)) * lk;
  }
  auto finish = [&](float (&s)[NW][32], int ch) {
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      const int base = (ch * NC + wg * NW + c) * TILE;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[c][i] *= a.scale;
      if (a.bias2d || bb || base + TILE > lk) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = base + 8 * j + c2 + (e & 1);
            float x = s[c][4 * j + e];
            if (col < lk) {
              if (a.bias2d) x += b2r[e >> 1][col];
              if (bb) x += bb[col];
            } else {
              x = -INFINITY;
            }
            s[c][4 * j + e] = x;
          }
      }
    }
  };
  // A row statistic of this warpgroup's pieces (quad-reduced `part`)
  // combined with the other's: warpgroup 0's first.
  auto combine = [&](float* x, const float (&part)[2], bool is_max) {
    if (NC == 1) return make_float2(part[0], part[1]);   // one warpgroup
    if ((lane & 3) == 0) {
      x[wg * TILE + r0] = part[0];
      x[wg * TILE + r0 + 8] = part[1];
    }
    __syncthreads();
    float out[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float u = x[r0 + 8 * r], w = x[TILE + r0 + 8 * r];
      out[r] = is_max ? fmaxf(u, w) : u + w;
    }
    return make_float2(out[0], out[1]);
  };
  // Each thread's part of a row in four independent chains (j % 4), then
  // the chains, then the quad.
  auto row_max = [&](const float (&s)[NW][32]) {
    float part[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < NW; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          x[j & 3] = fmaxf(x[j & 3], fmaxf(s[c][4 * j + 2 * r], s[c][4 * j + 2 * r + 1]));
      part[r] = qmax(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
    }
    return combine(xm, part, true);
  };
  auto row_sum = [&](const float (&s)[NW][32]) {
    float part[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < NW; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j & 3] += s[c][4 * j + 2 * r] + s[c][4 * j + 2 * r + 1];
      part[r] = qsum((x[0] + x[1]) + (x[2] + x[3]));
    }
    return combine(xl, part, false);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[NW][32];
  issue_k(0, true);
  ready_q();
  if (stream) {              // pass 1: the row max and sum over the chunks
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch > 0) {
        __syncthreads();                        // the last chunk's K pieces are read
        issue_k(ch, false);
      }
      qk(s, ch);
      finish(s, ch);
      const float2 cm = row_max(s);
      const float m_new[2] = {fmaxf(m[0], cm.x), fmaxf(m[1], cm.y)};
      const float m_safe[2] = {m_new[0] == -INFINITY ? 0.f : m_new[0],
                               m_new[1] == -INFINITY ? 0.f : m_new[1]};
#pragma unroll
      for (int c = 0; c < NW; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) s[c][i] = expf(s[c][i] - m_safe[(i >> 1) & 1]);
      const float2 cs = row_sum(s);
      l[0] = l[0] * expf(m[0] - m_safe[0]) + cs.x;
      l[1] = l[1] * expf(m[1] - m_safe[1]) + cs.y;
      m[0] = m_new[0];
      m[1] = m_new[1];
    }
    __syncthreads();
    issue_k(0, false);
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const int lk8 = (lk + 7) & ~7;
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch > 0) {                               // the V tiles overwrote Q
      __syncthreads();
      issue_k(ch, true);
      ready_q();
    }
    qk(s, ch);
    const int n = min(NC, pieces - ch * NC);
    __syncthreads();                            // K is read: V may land over it
    issue_v(ch);
    finish(s, ch);
    if (!stream) {
      const float2 cm = row_max(s);
      m[0] = cm.x;
      m[1] = cm.y;
    }
#pragma unroll
    for (int c = 0; c < NW; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) s[c][i] = expf(s[c][i] - m[(i >> 1) & 1]);
    if (!stream) {
      const float2 cs = row_sum(s);
      l[0] = cs.x;
      l[1] = cs.y;
    }
    const float rl[2] = {div_reciprocal(l[0]), div_reciprocal(l[1])};
#pragma unroll
    for (int c = 0; c < NW; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) s[c][i] = div_normal(s[c][i], l[(i >> 1) & 1], rl[(i >> 1) & 1]);

    // O += P·V over this warpgroup's pieces: each V tile transposed and
    // split by the warpgroup's threads; P's hi fragments in the A register
    // order (slot t ↔ key 2t: a0, a1; slot t + 4 ↔ key 2t + 1: a2, a3) for
    // hi·Vᵀlo and hi·Vᵀhi, then, while those run, its lo fragments for
    // lo·Vᵀhi; while all of them run, the piece's P goes out (columns [Lk,
    // Lk8) as zeros) and the next V tile is transposed.
    float* prow = a.p ? a.p + b * a.p_bs + h * a.p_hs + static_cast<long long>(q0 + r0) * a.p_rs
                      : nullptr;
    if (wg * NW < n) {
      wait_v(wg * NW);
      uint8_t* vt = smem + wg * NW * V_STRIDE;
      transpose_split(vt, vt + PIECE, vt + 2 * PIECE, t);
      fence_proxy_async();
      named_sync(1 + wg, WG_THREADS);
    }
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      const int i = wg * NW + c;
      if (i < n) {
        const uint32_t v_addr = smem_u32(smem + i * V_STRIDE);
        const int steps = min(8, (lk - (ch * NC + i) * TILE + 7) / 8);
        uint32_t fh[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) fh[kk][e] = tf32_rna(s[c][4 * kk + ((e & 1) << 1) + (e >> 1)]);
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) fence_regs(fh[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          if (kk < steps) {
            const uint32_t off = PIECE + (kk >> 2) * HALF + (kk & 3) * 32;
            wgmma_m64n64k8_tf32_rs(o, fh[kk], desc_sw128(v_addr + PIECE + off), 1);
            wgmma_m64n64k8_tf32_rs(o, fh[kk], desc_sw128(v_addr + off), 1);
          }
        uint32_t fl[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[c][4 * kk + ((e & 1) << 1) + (e >> 1)];
            fl[kk][e] = tf32_rna(x - __uint_as_float(fh[kk][e]));
          }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) fence_regs(fl[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          if (kk < steps)
            wgmma_m64n64k8_tf32_rs(o, fl[kk],
                                   desc_sw128(v_addr + PIECE + (kk >> 2) * HALF + (kk & 3) * 32), 1);
        wgmma_commit();
        if (prow) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = (ch * NC + i) * TILE + 8 * j + c2;
            if (col < lk8) {
#pragma unroll
              for (int r = 0; r < 2; ++r)
                if (q0 + r0 + 8 * r < a.lq)
                  *reinterpret_cast<float2*>(prow + 8 * r * a.p_rs + col) =
                      make_float2(col < lk ? s[c][4 * j + 2 * r] : 0.f,
                                  col + 1 < lk ? s[c][4 * j + 2 * r + 1] : 0.f);
            }
          }
        }
        if (c + 1 < NW && i + 1 < n) {
          wait_v(i + 1);
          uint8_t* vn = smem + (i + 1) * V_STRIDE;
          transpose_split(vn, vn + PIECE, vn + 2 * PIECE, t);
          fence_proxy_async();
        }
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          fence_regs(fh[kk]);
          fence_regs(fl[kk]);
        }
        if (c + 1 < NW && i + 1 < n) named_sync(1 + wg, WG_THREADS);
      }
    }
  }

  // O = warpgroup 0's partial + warpgroup 1's, staged in the raw tile of
  // warpgroup 1's first V piece (warpgroup 0 no longer reads it).
  if (NC > 1) {
    float2* stage = reinterpret_cast<float2*>(smem + NW * V_STRIDE);
    if (wg == 1)
#pragma unroll
      for (int i = 0; i < 16; ++i) stage[i * WG_THREADS + t] = make_float2(o[2 * i], o[2 * i + 1]);
    __syncthreads();
    if (wg == 0)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 x = stage[i * WG_THREADS + t];
        o[2 * i] += x.x;
        o[2 * i + 1] += x.y;
      }
  }
  if (wg == 0) {
    float* orow = a.o + (static_cast<long long>(b) * a.lq + q0 + r0) * (a.heads * HDIM) + h * HDIM;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + r0 + 8 * r < a.lq)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(orow + 8 * r * a.heads * HDIM + 8 * j + c2) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
}

template <int NC>
int launch_tf32x3(const Tf32Args& a, int batch, cudaStream_t stream) {
  const auto kernel = attention_fwd_tf32x3_kernel<NC>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool raised[64] = {};                // the shared-memory limit, once per device
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_total(NC));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[device] = true;
  }
  kernel<<<dim3((a.lq + TILE - 1) / TILE, a.heads, batch), threads_for(NC), smem_total(NC),
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace segclip_kernels

using namespace segclip_kernels;

extern "C" {

// The float32 TF32x3 kernel, for any Lk ≥ 1. Strides are in
// elements; the wrapper guarantees 16-byte aligned q, k, v and row and batch
// strides (multiples of 4 elements), which the copies need. o is a
// contiguous (B, Lq, H·64) tensor; p is null or a (B, H, Lq, p_rs) buffer
// with p_rs ≥ Lk a multiple of 8, p_hs = Lq·p_rs and p_bs = H·p_hs. Returns
// the cudaError_t of the launch (0 on success).
int segclip_attention_fwd_tf32x3(const void* q, const void* k, const void* v, const void* bias2d,
                                 const void* biasb, void* o, void* p, int batch, int heads, int lq,
                                 int lk, long long q_bs, long long q_rs, long long k_bs,
                                 long long k_rs, long long v_bs, long long v_rs, long long p_bs,
                                 long long p_hs, long long p_rs, float scale, void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p && (p_rs < lk || p_rs % 8 || p_hs != lq * p_rs || p_bs != heads * p_hs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long dm = static_cast<long long>(heads) * HDIM;
  Tf32Args a{};
  if (!(encode_f32_3d(&a.q, q, dm, lq, batch, q_rs, q_bs) &&
        encode_f32_3d(&a.k, k, dm, lk, batch, k_rs, k_bs) &&
        encode_f32_3d(&a.v, v, dm, lk, batch, v_rs, v_bs)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.o = static_cast<float*>(o);
  a.p = static_cast<float*>(p);
  a.bias2d = static_cast<const float*>(bias2d);
  a.biasb = static_cast<const float*>(biasb);
  a.p_bs = p_bs;
  a.p_hs = p_hs;
  a.p_rs = p_rs;
  a.heads = heads;
  a.lq = lq;
  a.lk = lk;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((lk + TILE - 1) / TILE) {
    case 1: return launch_tf32x3<1>(a, batch, s);
    case 2: return launch_tf32x3<2>(a, batch, s);
    case 3: return launch_tf32x3<3>(a, batch, s);
    default: return launch_tf32x3<MAX_NC>(a, batch, s);
  }
}

}  // extern "C"
