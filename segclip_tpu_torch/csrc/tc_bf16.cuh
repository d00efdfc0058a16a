// Tensor-core building blocks for the bf16 attention kernels (sm_90a):
// `mma.sync.m16n8k16` with bf16 operands and fp32 accumulators, `ldmatrix`
// from shared memory, and `cp.async` 16-byte copies with zero fill.
//
// Tiles in shared memory are bf16 rows of 64 elements padded to LDS = 72
// (144 bytes), so the eight 16-byte rows one `ldmatrix` 8×8 matrix reads
// fall in eight different bank groups.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and c = 2·(lane % 4):
//   accumulator of a 16×8 tile: d0,d1 at (g, c), (g, c+1); d2,d3 at (g+8, c), (g+8, c+1);
//   A (16×16): a0 (g, c..c+1), a1 (g+8, c..c+1), a2 (g, c+8..), a3 (g+8, c+8..),
//              each a pair of bf16 in one 32-bit register, lower column low;
//   B (16×8):  b0 (rows c..c+1, column g), b1 (rows c+8.., column g).
// So the accumulators of two neighbouring 16×8 tiles, rounded to bf16 and
// packed in pairs, are the A fragment of the next product: a score tile
// becomes the left operand of P·V without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace segclip_tc {

constexpr int HD = 64;       // head dim
constexpr int LDS = 72;      // shared row stride of a 64-wide bf16 tile, in elements

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// `src_bytes` (0 to 16) are written as zeros and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a·b over one m16n8k16 tile: bf16 products, exact in fp32, summed in fp32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (round to nearest even) in one register,
// `lo` in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  return __bfloat1622float2(v);
}

// Rows [row0, row0 + ROWS) of a (rows, 64) bf16 slice with row stride `rs`
// into a shared tile of stride LDS, asynchronously; rows at or past `rows`
// read as zeros. The caller commits the group.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long rs, int row0,
                                          int rows) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * 8; c += THREADS) {
    const int r = c >> 3, ch = c & 7;
    const int gr = row0 + r;
    const bool ok = gr < rows;
    cp_async16(dst + r * LDS + ch * 8, src + (ok ? gr : 0) * rs + ch * 8, ok ? 16 : 0);
  }
}

// A ROWS × 64 block of a (rows, cols) bf16 matrix with row stride `rs`, at
// (row0, col0), into a shared tile of row stride `lds`; entries at or past
// `rows` or `cols` read as zeros (a 16-byte piece across `cols` is cut).
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_block(bf16* dst, int lds, const bf16* src, long long rs,
                                           int row0, int rows, int col0, int cols) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * 8; c += THREADS) {
    const int r = c >> 3, ch = c & 7;
    const int gr = row0 + r, gc = col0 + ch * 8;
    int bytes = gr < rows ? 2 * (cols - gc) : 0;
    bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
    cp_async16(dst + r * lds + ch * 8, bytes ? src + gr * rs + gc : src, bytes);
  }
}

// The four A fragments (k = 0..63 in steps of 16) of rows [16w, 16w + 16)
// of a shared 64-wide tile.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], const bf16* tile, int w,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], tile + (16 * w + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
}

// s (16 × 64, eight 16×8 accumulators) = a · tileᵀ, where a is a warp's
// 16 × 64 A operand and the shared tile holds 64 rows of 64 (the columns of
// s are the tile's rows): QKᵀ, dO·Vᵀ, V·dOᵀ. Only the first `ncols` tile
// rows are real (the edge of L): 16-column pairs past them are left at 0.
__device__ __forceinline__ void mma_abt(float (&s)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* tile, int lane, int ncols) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (16 * p >= ncols) break;
      uint32_t r[4];
      ldmatrix_x4(r, tile + (16 * p + (lane >> 4) * 8 + (lane & 7)) * LDS + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma(s[2 * p], a[kk], r[0], r[1]);
      mma(s[2 * p + 1], a[kk], r[2], r[3]);
    }
  }
}

// acc (16 × 64) += a · tile[16kk, 16kk + 16) for one k-step: a is a warp's
// 16 × 16 A fragment, the shared tile holds rows of 64 (the k index runs
// over its rows): P·V, dS·K, Pᵀ·dO, dSᵀ·Q.
__device__ __forceinline__ void mma_ab_step(float (&acc)[8][4], const uint32_t (&a)[4],
                                            const bf16* tile, int kk, int lane) {
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, tile + (16 * kk + (lane & 15)) * LDS + 16 * dp + (lane >> 4) * 8);
    mma(acc[2 * dp], a, r[0], r[1]);
    mma(acc[2 * dp + 1], a, r[2], r[3]);
  }
}

// Two neighbouring accumulator tiles, `left` (columns 16kk .. 16kk + 7) and
// `right` (16kk + 8 .. 16kk + 15), rounded to bf16 as one A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&left)[4],
                                         const float (&right)[4]) {
  a[0] = pack(left[0], left[1]);
  a[1] = pack(left[2], left[3]);
  a[2] = pack(right[0], right[1]);
  a[3] = pack(right[2], right[3]);
}

// The same fp32 values split into bf16 parts, hi = bf16(x) and
// lo = bf16(x − hi), so hi·b + lo·b is x·b to about 2^-17 relative.
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&left)[4],
                                               const float (&right)[4]) {
  acc_to_a(hi, left, right);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 r = unpack(hi[i]);
    const float (&x)[4] = i < 2 ? left : right;
    lo[i] = pack(x[2 * (i & 1)] - r.x, x[2 * (i & 1) + 1] - r.y);
  }
}

// A warp's 16 × 64 fp32 tile (eight accumulators), rounded to bf16, into
// its 16-row staging area of stride LDS, then out to `dst` rows [0, rows)
// with row stride `rs` in 16-byte stores, columns [0, cols) in 8-wide
// pieces (cols a multiple of 8).
__device__ __forceinline__ void stage_store(bf16* stage, const float (&acc)[8][4], float scale,
                                            bf16* dst, long long rs, int rows, int cols,
                                            int lane) {
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LDS + 8 * j + c) =
        pack(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LDS + 8 * j + c) =
        pack(acc[j][2] * scale, acc[j][3] * scale);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int e = lane + 32 * it, r = e >> 3, ch = e & 7;
    if (r < rows && ch * 8 < cols)
      *reinterpret_cast<uint4*>(dst + r * rs + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + ch * 8);
  }
  __syncwarp();
}

}  // namespace segclip_tc
