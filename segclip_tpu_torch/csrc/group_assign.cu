// Semantic group assignment for Hopper (sm_90a), eval and training forward.
//
// Replaces the TPU kernel `_kernel` of segclip_tpu/ops/pallas/grouping.py
// (pallas_call at :124), reached at eval through `fused_group_assign` (:141,
// training=False) and at training through `fused_group_assign_st` (:158,
// training=True, lines :62-64 and :76-81). Per image n:
//   logits = q·kᵀ                 (G, L), fp32 from fp32-cast q and k, unscaled
//   soft   = softmax over G        per patch
//   y_soft = softmax over G of (logits + noise) / tau   (training; = soft at eval)
//   hard   = one-hot argmax_G y_soft, ties to the lowest group index
//   out    = hard·v / max(Σ_L hard, 1), accumulated in fp32, cast to v's dtype
// The Gumbel noise (N, G, L) fp32 comes in from the caller, as the TPU
// kernel's does; y_soft is written out as the straight-through backward's
// residual. At eval the noise pointer is null and nothing else changes.
//
// What bounds it on the H100: one image reads q (G·D), k and v (L·D each),
// about 0.6 MB in bf16 at G=8, L=196, D=768, and does 2.4 MFLOP: a few
// microseconds of work, so the call is bound by latency — how many loads are
// in flight at once — and not by bandwidth or FLOPs. The TPU kernel does the
// whole image in one program; one block per image here would put each image
// on a single SM (measured 0.55 ms). So the work is spread over many blocks
// in two passes, with nothing but the winning group index in between:
//   - assign: one block per (image, 8 patches), one warp per patch. Lanes
//     split D, keep G ≤ 32 partial dots in registers and reduce them with
//     shuffles; lane g then owns group g's logit (and its noise), so the
//     softmaxes and the argmax over G are warp reductions. Writes soft,
//     hard, y_soft (training) and the winner.
//   - aggregate: one block per (image, 64 columns of D). Because hard is
//     one-hot, hard·v is a gather-sum: each warp adds its patches' v rows
//     into its own per-group partial sums in shared memory (no atomics, so
//     the order of the sums is fixed and the result reproducible), then the
//     warps' partials are added in warp order and divided by the count. An
//     empty group gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int G_MAX = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 64;                       // columns of D per aggregate block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Softmax over the G lanes of a warp (lanes ≥ G hold −inf and give 0).
__device__ __forceinline__ float lane_softmax(float x, int lane, int G) {
  float m = x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  const float e = lane < G ? expf(x - m) : 0.f;
  float sum = e;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
  return e / sum;
}

// Grid (ceil(L / WARPS), N). Dynamic shared memory: q[n] as fp32 (G·D).
// noise (N, G, L) and y_soft are null at eval.
template <typename T>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const float* __restrict__ noise, float tau, float* __restrict__ hard,
              float* __restrict__ soft, float* __restrict__ ysoft, int* __restrict__ winner,
              int G, int L, int D) {
  extern __shared__ float qs[];
  const long long n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < G * D; e += THREADS) qs[e] = to_f32(q[n * G * D + e]);
  __syncthreads();

  const int l = blockIdx.x * WARPS + warp;
  if (l >= L) return;
  float part[G_MAX];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) part[g] = 0.f;
  const T* kr = k + (n * L + l) * D;
  for (int d = lane; d < D; d += 32) {
    const float kd = to_f32(kr[d]);
#pragma unroll
    for (int g = 0; g < G_MAX; ++g)
      if (g < G) part[g] = fmaf(qs[g * D + d], kd, part[g]);
  }
  float logit = -INFINITY;                     // lane g ends with group g's logit
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g >= G) break;
    float x = part[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
    if (lane == g) logit = x;
  }

  const float p = lane_softmax(logit, lane, G);
  float py = p;                                // y_soft: the softmax the winner is taken from
  if (noise) {
    const float y = lane < G ? (logit + noise[(n * G + lane) * L + l]) / tau : -INFINITY;
    py = lane_softmax(y, lane, G);
  }

  // argmax over y_soft, lowest index on ties
  float best = lane < G ? py : -1.f;
  int idx = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, off);
    const int oi = __shfl_xor_sync(FULL, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane < G) {
    const long long o = (n * G + lane) * L + l;
    soft[o] = p;
    hard[o] = lane == idx ? 1.f : 0.f;
    if (ysoft) ysoft[o] = py;
  }
  if (lane == 0) winner[n * L + l] = idx;
}

// Grid (ceil(D / COLS), N). Dynamic shared memory: WARPS × G × COLS fp32
// partial sums, one slab per warp.
template <typename T>
__global__ void __launch_bounds__(THREADS)
aggregate_kernel(const T* __restrict__ v, const int* __restrict__ winner, T* __restrict__ out,
                 int G, int L, int D) {
  extern __shared__ float part[];
  __shared__ int count[G_MAX];
  const long long n = blockIdx.y;
  const int c0 = blockIdx.x * COLS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < WARPS * G * COLS; e += THREADS) part[e] = 0.f;
  if (tid < G_MAX) count[tid] = 0;
  __syncthreads();

  const int* win = winner + n * L;
  for (int l = tid; l < L; l += THREADS) atomicAdd(&count[win[l]], 1);
  float* mine = part + warp * G * COLS;
  for (int l = warp; l < L; l += WARPS) {
    const int g = win[l];
    const T* vr = v + (n * L + l) * D + c0;
#pragma unroll
    for (int c = lane; c < COLS; c += 32)
      if (c0 + c < D) mine[g * COLS + c] += to_f32(vr[c]);
  }
  __syncthreads();

  for (int e = tid; e < G * COLS; e += THREADS) {
    const int g = e / COLS, c = e % COLS;
    if (c0 + c >= D) continue;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += part[(w * G + g) * COLS + c];
    out[(n * G + g) * D + c0 + c] = from_f32<T>(s / fmaxf(static_cast<float>(count[g]), 1.f));
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* noise, float tau,
           void* out, float* hard, float* soft, float* ysoft, int* winner, int n, int g, int l,
           int d, cudaStream_t stream) {
  const size_t smem_a = sizeof(float) * static_cast<size_t>(g) * d;
  const size_t smem_b = sizeof(float) * static_cast<size_t>(WARPS) * g * COLS;
  cudaError_t err = allow_smem(assign_kernel<T>, smem_a);
  if (err == cudaSuccess) err = allow_smem(aggregate_kernel<T>, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  assign_kernel<T><<<dim3((l + WARPS - 1) / WARPS, n), THREADS, smem_a, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), noise, tau, hard, soft, ysoft, winner,
      g, l, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_kernel<T><<<dim3((d + COLS - 1) / COLS, n), THREADS, smem_b, stream>>>(
      static_cast<const T*>(v), winner, static_cast<T*>(out), g, l, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (N, G, D), k and v (N, L, D), out
// (N, G, D) contiguous in that dtype; noise (N, G, L) fp32 or null (eval);
// hard, soft and y_soft (N, G, L) fp32, y_soft null when noise is; winner
// (N, L) int32 scratch. Returns the cudaError_t of the launches (0 on
// success).
int segclip_group_assign(int dtype, const void* q, const void* k, const void* v,
                         const void* noise, float tau, void* out, void* hard, void* soft,
                         void* ysoft, void* winner, int n, int g, int l, int d, void* stream) {
  if (n < 1 || n > 65535 || g < 1 || g > G_MAX || l < 1 || d < 1 || (noise && !(tau > 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* nz = static_cast<const float*>(noise);
  float* h = static_cast<float*>(hard);
  float* so = static_cast<float*>(soft);
  float* ys = static_cast<float*>(ysoft);
  int* w = static_cast<int*>(winner);
  if (dtype == 0) return launch<float>(q, k, v, nz, tau, out, h, so, ys, w, n, g, l, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, nz, tau, out, h, so, ys, w, n, g, l, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
