// Attention forward at bfloat16 for rows of more than 1024 keys,
// softmax(Q Kᵀ·scale + bias2d + biasb)·V, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of segclip_tpu/ops/pallas/attention.py
// (reached through `attention_vmem`, called at :186) for bf16 rows past
// CLUSTER_LIMIT (attention_fwd.cu): whole-image requests of more than 1024
// patches (a 448×672 image's 1176 and cross 1184, the eval CLIs' widest
// 224×2048 image's 1792 and cross 1800). `ops/kernels/attention.fwd_route`
// sends every bf16 call with Lk ≥ LONG_MIN_LK here ("long",
// `attention_fwd_long_kernel`); attention_fwd.cu's two-pass `mma.sync`
// kernel, which took these rows before, is reached by no route.
//
// What it computes: the function and dtype chain of attention_fwd.cu (the
// TPU kernel's, ops/pallas/attention.py:71-89). Scores q·kᵀ·scale + bias2d +
// biasb in fp32; columns at or past Lk are −inf, bias2d may hold −inf, and a
// row whose every score is −inf gives NaN, as softmax does; the row max m
// and sum l in fp32; p = expf(s − m) / l normalised in fp32 and then
// rounded to bf16 (no deferred normalisation: the rounding of P is the
// TPU's); O = P·V summed in fp32, rounded once to bf16; P, when asked for,
// into the wrapper's padded (B, H, Lq, Lk8) buffer with columns [Lk, Lk8)
// zero.
//
// What bounds it on the H100: operations. At 1×1176, H = 12, Q, K, V and O
// are 7.2 MB (0.0022 ms at 3.35 TB/s) against two products of 2.1 GFLOP
// each (0.0043 ms at 989 TFLOP/s bf16). A row of 1176 scores does not fit a
// warpgroup's registers, so the kernel takes the rows twice (three products
// where the bound counts two). The two-pass `mma.sync` kernel it replaces
// spent its time on instructions, not on either bound: the exp and the IEEE
// division of every score twice, and each warp's own ldmatrix of every K
// and V fragment.
//
// The design:
//   - One block per 64-row query tile of one (batch, head), NWG warpgroups
//     that split the row's 64-key pieces: warpgroup w takes pieces w, w +
//     NWG, w + 2·NWG, ... and keeps one piece's 64×64 scores (32 a thread)
//     live. NWG = 2 (two blocks an SM) where Lq > 64; rows of one query tile
//     (the cross blocks' 8 queries: 1×8×1184 is 12 blocks on 132 SMs) take
//     NWG = 4, one block an SM, so that each row's keys are walked by four
//     warpgroups at once. Pass 1: S = Q·Kᵀ per piece on `wgmma` (K-major K
//     from shared memory), scale, biases, −inf past Lk, and the row max m
//     and sum l online (l rescaled as m grows; the sum's exponentials are
//     `__expf`, within 2 ulps of `expf`, as PR 3's kernel took them: it
//     moves l no further than the order of its fp32 sums does). The
//     warpgroups' (m, l) are combined through shared memory in warpgroup
//     order, so all hold the same bits. Pass 2: S again per piece, p =
//     expf(s − m) / l, rounded to bf16 in pairs (the accumulator's layout is
//     the register A layout), P stored, and O += P·V on `wgmma` with V from
//     shared memory through the transpose bit. O is the warpgroups' fp32
//     partials summed in warpgroup order. Nothing is split across blocks,
//     NWG depends on Lq alone and every sum runs in a fixed order: a row's
//     bits do not depend on the batch or the launch.
//   - TMA copies (hopper.cuh) through a ring per warpgroup: STAGES stages of
//     a K piece and a V piece (8 KB each), one mbarrier each; the
//     warpgroup's stream is its pieces' K for pass 1, then their K and V for
//     pass 2, and its thread 0 asks for item i + STAGES as soon as the
//     warpgroup's products have read item i, so the next pieces' copies are
//     in flight under this one's softmax. The Q tile arrives once. Rows past
//     Lq or Lk are filled with zeros by the copy (a P of 0 times an
//     uninitialised V row could be NaN).
//   - Shared memory: the Q tile 8 KB, NWG × STAGES × 16 KB of rings, the
//     row statistics' exchange: 105 KB at NWG = 2, two blocks an SM (a
//     1×1176 launch, 19 tiles × 12 heads = 228 blocks, is one wave on 132
//     SMs); 202 KB at NWG = 4.
//   - The exponential is `expf`, the division hopper.cuh's branch-free
//     `div_normal`: its proof for l in [1, 1024] scales with l's exponent (the
//     approximate reciprocal and every fma scale exactly by powers of two
//     while nothing leaves the normal range), so it is correctly rounded for
//     every l ≥ 1 and p ≥ 2^-100 (p / l ≥ 2^-124 stays normal up to l =
//     2^24), and within an ulp below. `segclip_attention_division_check`
//     holds it to IEEE `/` on the card (chip_smoke.py's phase 1, every
//     significand of l in [1, 2) scaled by 2^0..2^13, with random p).
//   - P and O leave from registers: 4-byte bf16 pairs, a quad of threads
//     writing 16 contiguous bytes of a row.

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

// The shortest rows the kernel takes: past attention_fwd.cu's CLUSTER_LIMIT.
constexpr int LONG_MIN_LK = 1025;
constexpr int HDIM = 64;
constexpr int WG_THREADS = 128;
constexpr int STAGES = 3;                          // ring stages per warpgroup
constexpr int STAGE_BYTES = 2 * TILE_BYTES;        // a K piece, then a V piece
constexpr int RING_OFF = TILE_BYTES;               // after the Q tile
// Shared memory of NWG warpgroups: the Q tile, the rings, the row max and
// sum ([warpgroup][row]), then the mbarriers (Q, then each ring's stages).
__host__ __device__ constexpr int stat_off(int nwg) { return RING_OFF + nwg * STAGES * STAGE_BYTES; }
__host__ __device__ constexpr int bar_off(int nwg) { return stat_off(nwg) + 2 * nwg * TILE * 4; }
__host__ __device__ constexpr int smem_total(int nwg) { return bar_off(nwg) + 8 * (1 + nwg * STAGES); }

struct LongArgs {
  CUtensorMap q, k, v;     // (H·64, L, B) bf16 maps over the operands' own strides
  bf16* o;                 // (B, Lq, H·64) contiguous
  bf16* p;                 // (B, H, Lq, p_rs) or null
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

// One block per 64-row query tile of one (batch, head), NWG warpgroups. In
// each, warp w' holds rows 16w' + g and 16w' + g + 8 of the tile and, per
// piece, keys 8j + 2(lane % 4) + {0, 1} of it (the accumulator layout).
template <int NWG>
__global__ void __launch_bounds__(NWG * WG_THREADS, 4 / NWG) attention_fwd_long_kernel(
    const __grid_constant__ LongArgs a) {
  extern __shared__ __align__(1024) uint8_t smem[];
  float* const xm = reinterpret_cast<float*>(smem + stat_off(NWG));
  float* const xl = xm + NWG * TILE;
  const uint32_t bar_q = smem_u32(smem + bar_off(NWG));

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);   // proven warp-uniform for ptxas
  const int t = tid & (WG_THREADS - 1), warp = t >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * warp + g;
  const int lk = a.lk;
  const int pieces = (lk + TILE - 1) / TILE;
  const int mine = (pieces - wg + NWG - 1) / NWG;  // pieces wg, wg + NWG, ...
  const int items = 2 * mine;                      // pass 1's K, then pass 2's K and V
  uint8_t* const ring = smem + RING_OFF + wg * STAGES * STAGE_BYTES;
  const uint32_t full = bar_q + 8 + wg * STAGES * 8;

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();      // the swizzle needs 1024-byte tiles
    for (int i = 0; i < 1 + NWG * STAGES; ++i) mbar_init(bar_q + 8 * i, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // Item i of this warpgroup's stream, asked for by its thread 0: piece
  // wg + NWG·(i mod mine), its K tile (pass 1, i < mine) or its K and V tiles
  // (pass 2), into stage i mod STAGES.
  auto issue = [&](int i) {
    if (t != 0 || i >= items) return;
    const int s = i % STAGES, row = (wg + NWG * (i < mine ? i : i - mine)) * TILE;
    const uint32_t bar = full + 8 * s;
    uint8_t* dst = ring + s * STAGE_BYTES;
    mbar_expect_tx(bar, i < mine ? TILE_BYTES : 2 * TILE_BYTES);
    tma_load_3d(dst, &a.k, bar, h * HDIM, row, b);
    if (i >= mine) tma_load_3d(dst + TILE_BYTES, &a.v, bar, h * HDIM, row, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, TILE_BYTES);
    tma_load_3d(smem, &a.q, bar_q, h * HDIM, q0, b);
  }
#pragma unroll
  for (int i = 0; i < STAGES; ++i) issue(i);
  // The warpgroup's products have read item i's stage: it meets, and its
  // thread 0 asks for item i + STAGES there.
  auto release = [&](int i) {
    named_sync(1 + wg, WG_THREADS);
    issue(i + STAGES);
  };

  // S = Q·Kᵀ of item i's piece, fp32.
  const uint32_t q_addr = smem_u32(smem);
  auto scores = [&](float (&s)[32], int i) {
    mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
    const uint32_t k_addr = smem_u32(ring + (i % STAGES) * STAGE_BYTES);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss(s, desc_sw128(q_addr + 32 * kk), desc_sw128(k_addr + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  };

  // Scale, biases, −inf past Lk, on the scores of the piece at key `base`.
  const float* bb = a.biasb ? a.biasb + static_cast<long long>(b) * lk : nullptr;
  const float* b2r[2] = {nullptr, nullptr};
  if (a.bias2d) {
    b2r[0] = a.bias2d + static_cast<long long>(min(q0 + r0, a.lq - 1)) * lk;
    b2r[1] = a.bias2d + static_cast<long long>(min(q0 + r0 + 8, a.lq - 1)) * lk;
  }
  auto finish = [&](float (&s)[32], int base) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= a.scale;
    if (a.bias2d || bb || base + TILE > lk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = base + 8 * j + c2 + (e & 1);
          float x = s[4 * j + e];
          if (col < lk) {
            if (a.bias2d) x += b2r[e >> 1][col];
            if (bb) x += bb[col];
          } else {
            x = -INFINITY;
          }
          s[4 * j + e] = x;
        }
    }
  };

  mbar_wait(bar_q, 0);
  float s[32];

  // Pass 1: this warpgroup's m and l over its pieces, each thread's part of
  // a row in four independent chains (j % 4), then the chains, then the quad;
  // the sum's exponentials by `__expf`.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < mine; ++i) {
    scores(s, i);
    release(i);
    finish(s, (wg + NWG * i) * TILE);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j & 3] = fmaxf(x[j & 3], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      const float m_new = fmaxf(m[r], qmax(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]))));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j & 3] += __expf(s[4 * j + 2 * r] - m_safe) + __expf(s[4 * j + 2 * r + 1] - m_safe);
      l[r] = l[r] * __expf(m[r] - m_safe) + qsum((y[0] + y[1]) + (y[2] + y[3]));
      m[r] = m_new;
    }
  }
  // The warpgroups' (m, l), in warpgroup order: all hold the same bits.
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xm[wg * TILE + r0 + 8 * r] = m[r];
      xl[wg * TILE + r0 + 8 * r] = l[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mm = xm[r0 + 8 * r];
#pragma unroll
    for (int w = 1; w < NWG; ++w) mm = fmaxf(mm, xm[w * TILE + r0 + 8 * r]);
    const float m_safe = mm == -INFINITY ? 0.f : mm;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWG; ++w)
      sum += xl[w * TILE + r0 + 8 * r] * expf(xm[w * TILE + r0 + 8 * r] - m_safe);
    l[r] = sum;
    m[r] = mm;
  }
  const float rl[2] = {div_reciprocal(l[0]), div_reciprocal(l[1])};

  // Pass 2: p = expf(s − m) / l rounded to bf16 pairs, P out, O += P·V.
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  bf16* prow = a.p ? a.p + b * a.p_bs + h * a.p_hs + static_cast<long long>(q0 + r0) * a.p_rs
                   : nullptr;
  const int lk8 = (lk + 7) & ~7;
  for (int c = 0; c < mine; ++c) {
    const int i = mine + c, base = (wg + NWG * c) * TILE;
    scores(s, i);
    finish(s, base);
    uint32_t pk[8][2];                           // bf16 pairs: [j][row g, g + 8]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = div_normal(expf(s[4 * j + e] - m[e >> 1]), l[e >> 1], rl[e >> 1]);
      if (base + TILE > lk) {                    // the row's last piece: p = 0 past Lk
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (base + 8 * j + c2 + (e & 1) >= lk) p[e] = 0.f;
      }
      pk[j][0] = segclip_tc::pack(p[0], p[1]);
      pk[j][1] = segclip_tc::pack(p[2], p[3]);
    }
    const uint32_t v_addr = smem_u32(ring + (i % STAGES) * STAGE_BYTES + TILE_BYTES);
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < 8; ++j) fence_regs(pk[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                                pk[2 * kk + 1][1]};
      wgmma_m64n64k16_rs_tb(o, frag, desc_sw128(v_addr + 2048 * kk), 1);
    }
    wgmma_commit();
    if (prow) {                                  // while P·V runs
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = base + 8 * j + c2;
        if (col < lk8)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (q0 + r0 + 8 * r < a.lq)
              *reinterpret_cast<uint32_t*>(prow + 8 * r * a.p_rs + col) = pk[j][r];
      }
    }
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < 8; ++j) fence_regs(pk[j]);
    release(i);
  }

  // O = the warpgroups' partials summed in warpgroup order, each staged in
  // its own ring (every copy it asked for has landed and been read).
  if (wg > 0)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      reinterpret_cast<float2*>(ring)[i * WG_THREADS + t] = make_float2(o[2 * i], o[2 * i + 1]);
  __syncthreads();
  if (wg == 0) {
    bf16* orow = a.o + (static_cast<long long>(b) * a.lq + q0 + r0) * (a.heads * HDIM) + h * HDIM;
#pragma unroll
    for (int w = 1; w < NWG; ++w) {
      const float2* stage = reinterpret_cast<const float2*>(ring + w * STAGES * STAGE_BYTES);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 x = stage[i * WG_THREADS + t];
        o[2 * i] += x.x;
        o[2 * i + 1] += x.y;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + r0 + 8 * r < a.lq)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * r * a.heads * HDIM + 8 * j + c2) =
              segclip_tc::pack(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
}

// div_normal(p, l) and IEEE p / l side by side, one pair a thread.
__global__ void division_check_kernel(const float* p, const float* l, float* fast, float* ieee,
                                      int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    fast[i] = div_normal(p[i], l[i], div_reciprocal(l[i]));
    ieee[i] = p[i] / l[i];
  }
}

template <int NWG>
int launch_long(const LongArgs& a, int batch, cudaStream_t stream) {
  const auto kernel = attention_fwd_long_kernel<NWG>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool raised[64] = {};                // the shared-memory limit, once per device
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_total(NWG));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[device] = true;
  }
  kernel<<<dim3((a.lq + TILE - 1) / TILE, a.heads, batch), NWG * WG_THREADS, smem_total(NWG),
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace segclip_kernels

using namespace segclip_kernels;

extern "C" {

// The shortest Lk that `segclip_attention_fwd_long` takes.
int segclip_attention_fwd_long_min_lk() { return LONG_MIN_LK; }

// The bf16 long-row kernel, for Lk ≥ LONG_MIN_LK. Strides are in elements;
// the wrapper guarantees 16-byte aligned q, k, v and row and batch strides,
// which the copies need. o is a contiguous (B, Lq, H·64) tensor; p is null
// or a (B, H, Lq, p_rs) buffer with p_rs ≥ Lk a multiple of 8, p_hs =
// Lq·p_rs and p_bs = H·p_hs. Returns the cudaError_t of the launch (0 on
// success).
int segclip_attention_fwd_long(const void* q, const void* k, const void* v, const void* bias2d,
                               const void* biasb, void* o, void* p, int batch, int heads, int lq,
                               int lk, long long q_bs, long long q_rs, long long k_bs,
                               long long k_rs, long long v_bs, long long v_rs, long long p_bs,
                               long long p_hs, long long p_rs, float scale, void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < LONG_MIN_LK || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p && (p_rs < lk || p_rs % 8 || p_hs != lq * p_rs || p_bs != heads * p_hs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long dm = static_cast<long long>(heads) * HDIM;
  LongArgs a{};
  if (!(encode_bf16_3d(&a.q, q, dm, lq, batch, q_rs, q_bs) &&
        encode_bf16_3d(&a.k, k, dm, lk, batch, k_rs, k_bs) &&
        encode_bf16_3d(&a.v, v, dm, lk, batch, v_rs, v_bs)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.o = static_cast<bf16*>(o);
  a.p = static_cast<bf16*>(p);
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
  return lq <= TILE ? launch_long<4>(a, batch, s) : launch_long<2>(a, batch, s);
}

// fast[i] = hopper.cuh's div_normal(p[i], l[i]) and ieee[i] = p[i] / l[i]
// (IEEE, correctly rounded) for n float32 pairs on the card: the check that
// the kernels' branch-free division is IEEE's over the range of l they meet.
// Returns the cudaError_t of the launch.
int segclip_attention_division_check(const void* p, const void* l, void* fast, void* ieee, int n,
                                     void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  division_check_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(l), static_cast<float*>(fast),
      static_cast<float*>(ieee), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
