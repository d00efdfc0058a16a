// Multi-tensor AdaptAdamW and global-norm clip for Hopper (sm_90a): the
// optimizer's part of a training step over every trainable leaf in four
// launches (norm partials, norm finalize, scale, update).
//
// Replaces no TPU kernel. The JAX package's clip and AdaptAdamW are jnp over
// the parameter tree (segclip_tpu/train/optimizer.py: global_norm_clip,
// adapt_adamw), which XLA fuses into a few loops. The port's plain version
// (train/optimizer.py: global_norm_clip_plain, adamw_plain) is a Python loop
// of ATen ops, about 20 launches a leaf: at ViT-B/16's 414 leaves (188.7 M
// float32 parameters) some 8,300 launches a step, begun on an empty queue
// after the NaN check's sync, so the host's launch rate set the optimizer's
// time (~100 ms idle of ~117 ms).
//
// What bounds it on the H100: bytes. The update reads p, g, m and v and
// writes p, m and v: 28 B a float32 parameter, 5.28 GB, 1.58 ms at 3.35
// TB/s; the norm reads g once more (0.23 ms), the scale reads and writes it
// (0.45 ms): about 2.3 ms a step, whatever the number of leaves.
//
// What the design does about it:
//   - One launch per pass over all leaves. A launch's table of leaves (their
//     addresses, sizes, group or shard flag, and each leaf's first block)
//     rides in the kernel's parameters as a __grid_constant__ struct (up to
//     32764 bytes on sm_90 since CUDA 12.1), copied at launch: no copy to the
//     card beforehand, no host sync. MAX_LEAVES leaves a launch; the wrapper
//     (ops/kernels/adamw.py, `plan`) cuts longer lists, and lists of several
//     dtypes, into more launches.
//   - One block per CHUNK elements of one leaf. A block finds its leaf by a
//     binary search over the first blocks (the same for all its threads, so
//     the constant cache broadcasts it) and streams its chunk in pieces of
//     four elements (16 bytes at float32) where every pointer allows, one
//     element at a time where not.
//   - The norm without float atomics: each block writes its chunk's sum of
//     g² (each thread's elements in order, then the warps' lanes by
//     shuffles, then the warps in order) into its slot of the half of a
//     partials buffer that its leaf's shard flag names, and 0 into the other
//     half; one finalize block sums each half in a fixed order. The same
//     gradients give the same norm, bit for bit, on every run. Under tensor
//     parallelism the caller all-reduces the sharded half's sum between the
//     finalize that sums and a second one that takes the norm.
//   - The norm and the scale stay on the card: the scale pass reads the
//     scale from device memory.
//   - The update is the plain version's fp32 arithmetic in its order; where
//     the plain version rounds between two ATen ops, the kernel rounds too
//     (the _rn intrinsics, which nvcc does not contract into an FMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace segclip_kernels {
namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FINAL_THREADS = 1024;
constexpr int CHUNK = 16384;          // elements a block
constexpr int MAX_LEAVES = 512;       // leaves a launch
constexpr int MAX_GROUPS = 16;        // parameter groups a launch
constexpr int VEC = 4;                // elements a vector access
constexpr unsigned FULL = 0xffffffffu;
// The finalize's output, float32: the two sums of squares (replicated,
// sharded), the norm and the scale min(1, max_norm / (norm + 1e-6)).
enum { SUM_REPLICATED = 0, SUM_SHARDED = 1, NORM = 2, SCALE = 3 };

static_assert(CHUNK % (VEC * THREADS) == 0, "a chunk is whole vector sweeps");

struct GradTable {
  void* g[MAX_LEAVES];
  long long numel[MAX_LEAVES];
  int first[MAX_LEAVES + 1];        // each leaf's first block; first[n] = the launch's blocks
  unsigned char flag[MAX_LEAVES];   // 1: a sharded leaf (tensor parallelism)
  int n;
  long long part;                   // this launch's first partial
  long long total;                  // the call's partials: where the sharded half starts
};

struct Hyper {
  float b1, omb1, b2, omb2, inv_sqrt_bc2, eps;
};

struct AdamTable {
  void* p[MAX_LEAVES];
  const void* g[MAX_LEAVES];        // null: no gradient this step, updated as with zeros
  void* m[MAX_LEAVES];
  void* v[MAX_LEAVES];
  long long numel[MAX_LEAVES];
  int first[MAX_LEAVES + 1];
  unsigned char group[MAX_LEAVES];
  float lr[MAX_GROUPS];             // lr_t = peak lr · schedule, as fp32
  float c2[MAX_GROUPS];             // lr_t / bc1, as fp32
  float wd[MAX_GROUPS];
  int n;
  Hyper h;
};

static_assert(sizeof(AdamTable) <= 32764 && sizeof(GradTable) <= 32764,
              "a kernel's parameters are at most 32764 bytes");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
struct alignas(VEC * sizeof(T)) Vec {
  T x[VEC];
};

template <typename T>
__device__ __forceinline__ bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (VEC * sizeof(T)) == 0;
}

// The last leaf whose first block is at most b: the leaf block b works on
// (a leaf of no elements owns no block and is passed over).
__device__ __forceinline__ int leaf_of(const int* first, int n, int b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The block's sum of s, in a fixed order (lanes by xor shuffles, then the
// warps in order); valid in thread 0. `red` holds NT / 32 floats.
template <int NT>
__device__ __forceinline__ float block_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = 0.f;
  if (warp == 0) {
    s = lane < NT / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  }
  return s;
}

template <typename P>
__global__ void __launch_bounds__(THREADS)
    grad_norm_partials_kernel(const __grid_constant__ GradTable t, float* __restrict__ part) {
  __shared__ float red[WARPS];
  const int b = blockIdx.x;
  const int l = leaf_of(t.first, t.n, b);
  const P* g = static_cast<const P*>(t.g[l]);
  const long long lo = static_cast<long long>(b - t.first[l]) * CHUNK;
  const long long hi = min(lo + CHUNK, t.numel[l]);
  float s = 0.f;
  long long rest = lo;
  if (aligned<P>(g)) {
#pragma unroll 4
    for (long long j = lo + VEC * threadIdx.x; j + VEC <= hi; j += VEC * THREADS) {
      const Vec<P> x = *reinterpret_cast<const Vec<P>*>(g + j);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float y = to_f(x.x[k]);
        s = fmaf(y, y, s);
      }
    }
    rest = lo + (hi - lo) / VEC * VEC;
  }
  for (long long j = rest + threadIdx.x; j < hi; j += THREADS) {
    const float y = to_f(g[j]);
    s = fmaf(y, y, s);
  }
  s = block_sum<THREADS>(s, red);
  if (threadIdx.x == 0) {
    const long long slot = t.part + b;
    part[slot + (t.flag[l] ? t.total : 0)] = s;
    part[slot + (t.flag[l] ? 0 : t.total)] = 0.f;
  }
}

// Sums each half of the partials in a fixed order into out[SUM_*] (total >
// 0), then, with `finish`, takes the norm and the scale from out[SUM_*]:
// norm = √(sharded + replicated), scale = clamp(max_norm · (1 / (norm +
// 1e-6)), max = 1), as the plain version's ATen ops round them (a NaN norm
// gives a NaN scale, as clamp does).
__global__ void __launch_bounds__(FINAL_THREADS)
    grad_norm_finalize_kernel(const float* __restrict__ part, long long total,
                              float* __restrict__ out, float max_norm, int finish) {
  __shared__ float red[FINAL_THREADS / 32];
  for (int h = 0; h < 2 && total > 0; ++h) {
    float s = 0.f;
    for (long long j = threadIdx.x; j < total; j += FINAL_THREADS) s += part[h * total + j];
    s = block_sum<FINAL_THREADS>(s, red);
    if (threadIdx.x == 0) out[SUM_REPLICATED + h] = s;
    __syncthreads();                  // red is written again
  }
  if (finish && threadIdx.x == 0) {
    const float norm = __fsqrt_rn(__fadd_rn(out[SUM_SHARDED], out[SUM_REPLICATED]));
    float scale = __fmul_rn(__frcp_rn(__fadd_rn(norm, 1e-6f)), max_norm);
    if (scale > 1.f) scale = 1.f;
    out[NORM] = norm;
    out[SCALE] = scale;
  }
}

// g ← g · scale, the scale first rounded to g's dtype (g.mul_(scale.to(g.dtype))).
template <typename P>
__global__ void __launch_bounds__(THREADS)
    grad_scale_kernel(const __grid_constant__ GradTable t, const float* __restrict__ out) {
  const int b = blockIdx.x;
  const int l = leaf_of(t.first, t.n, b);
  P* g = static_cast<P*>(t.g[l]);
  const float s = to_f(from_f<P>(out[SCALE]));
  const long long lo = static_cast<long long>(b - t.first[l]) * CHUNK;
  const long long hi = min(lo + CHUNK, t.numel[l]);
  long long rest = lo;
  if (aligned<P>(g)) {
#pragma unroll 4
    for (long long j = lo + VEC * threadIdx.x; j + VEC <= hi; j += VEC * THREADS) {
      Vec<P> x = *reinterpret_cast<const Vec<P>*>(g + j);
#pragma unroll
      for (int k = 0; k < VEC; ++k) x.x[k] = from_f<P>(__fmul_rn(to_f(x.x[k]), s));
      *reinterpret_cast<Vec<P>*>(g + j) = x;
    }
    rest = lo + (hi - lo) / VEC * VEC;
  }
  for (long long j = rest + threadIdx.x; j < hi; j += THREADS)
    g[j] = from_f<P>(__fmul_rn(to_f(g[j]), s));
}

// One element of AdaptAdamW, in fp32, rounded as the plain version's ops:
//   m.mul_(b1).add_(g, alpha=1 - b1)       (ATen: m + alpha · g, one FMA)
//   v.mul_(b2).addcmul_(g, g, value=1 - b2) (ATen: v + value · (g · g), g · g rounded first)
//   denom = v.sqrt() / √bc2 + eps          (ATen divides by a scalar as · its reciprocal)
//   p ← p + (−p · lr_t · wd − (lr_t / bc1) · m / denom)
__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v, float lr, float c2,
                                      float wd, const Hyper& h) {
  m = fmaf(h.omb1, g, __fmul_rn(m, h.b1));
  v = fmaf(h.omb2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
  const float denom = __fadd_rn(__fmul_rn(__fsqrt_rn(v), h.inv_sqrt_bc2), h.eps);
  const float decay = __fmul_rn(__fmul_rn(-p, lr), wd);
  const float step = __fdiv_rn(__fmul_rn(c2, m), denom);
  p = __fadd_rn(p, __fsub_rn(decay, step));
}

template <typename P, typename M>
__global__ void __launch_bounds__(THREADS) adamw_kernel(const __grid_constant__ AdamTable t) {
  const int b = blockIdx.x;
  const int l = leaf_of(t.first, t.n, b);
  P* p = static_cast<P*>(t.p[l]);
  const P* g = static_cast<const P*>(t.g[l]);
  M* m = static_cast<M*>(t.m[l]);
  M* v = static_cast<M*>(t.v[l]);
  const int grp = t.group[l];
  const float lr = t.lr[grp], c2 = t.c2[grp], wd = t.wd[grp];
  const Hyper h = t.h;
  const long long lo = static_cast<long long>(b - t.first[l]) * CHUNK;
  const long long hi = min(lo + CHUNK, t.numel[l]);
  long long rest = lo;
  if (aligned<P>(p) && (g == nullptr || aligned<P>(g)) && aligned<M>(m) && aligned<M>(v)) {
#pragma unroll 2
    for (long long j = lo + VEC * threadIdx.x; j + VEC <= hi; j += VEC * THREADS) {
      Vec<P> pv = *reinterpret_cast<const Vec<P>*>(p + j);
      Vec<P> gv = pv;
      if (g != nullptr) gv = *reinterpret_cast<const Vec<P>*>(g + j);
      Vec<M> mv = *reinterpret_cast<const Vec<M>*>(m + j);
      Vec<M> vv = *reinterpret_cast<const Vec<M>*>(v + j);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float pk = to_f(pv.x[k]), mk = to_f(mv.x[k]), vk = to_f(vv.x[k]);
        adamw(pk, g != nullptr ? to_f(gv.x[k]) : 0.f, mk, vk, lr, c2, wd, h);
        pv.x[k] = from_f<P>(pk);
        mv.x[k] = from_f<M>(mk);
        vv.x[k] = from_f<M>(vk);
      }
      *reinterpret_cast<Vec<P>*>(p + j) = pv;
      *reinterpret_cast<Vec<M>*>(m + j) = mv;
      *reinterpret_cast<Vec<M>*>(v + j) = vv;
    }
    rest = lo + (hi - lo) / VEC * VEC;
  }
  for (long long j = rest + threadIdx.x; j < hi; j += THREADS) {
    float pk = to_f(p[j]), mk = to_f(m[j]), vk = to_f(v[j]);
    adamw(pk, g != nullptr ? to_f(g[j]) : 0.f, mk, vk, lr, c2, wd, h);
    p[j] = from_f<P>(pk);
    m[j] = from_f<M>(mk);
    v[j] = from_f<M>(vk);
  }
}

// The launch's blocks, or 0 when the table is out of range: 1..MAX_LEAVES
// leaves, first blocks from 0 and not decreasing, each leaf's blocks enough
// for its elements and no more.
int blocks_of(int n, const long long* numel, const int* first) {
  if (n < 1 || n > MAX_LEAVES || first[0] != 0) return 0;
  for (int i = 0; i < n; ++i) {
    const long long need = (numel[i] + CHUNK - 1) / CHUNK;
    if (numel[i] < 0 || first[i + 1] - static_cast<long long>(first[i]) != need) return 0;
  }
  return first[n];
}

GradTable grad_table(int n, void* const* g, const long long* numel, const int* first,
                     const unsigned char* flag) {
  GradTable t;
  t.n = n;
  for (int i = 0; i < n; ++i) {
    t.g[i] = g[i];
    t.numel[i] = numel[i];
    t.first[i] = first[i];
    t.flag[i] = flag[i] ? 1 : 0;
  }
  t.first[n] = first[n];
  t.part = t.total = 0;
  return t;
}

}  // namespace
}  // namespace segclip_kernels

using namespace segclip_kernels;

extern "C" {

// The constants the wrapper plans with: elements a block, leaves a launch,
// parameter groups a launch.
void segclip_adamw_limits(int* chunk, int* max_leaves, int* max_groups) {
  *chunk = CHUNK;
  *max_leaves = MAX_LEAVES;
  *max_groups = MAX_GROUPS;
}

// dtype: 0 = float32, 1 = bfloat16, the gradients'. n leaves: g[i] the
// contiguous gradient of numel[i] elements (none null), first[i] its first
// block (n + 1 entries), flag[i] 1 for a sharded leaf. Block b's sum of
// squares goes to part[part_offset + b] (flag 0) or part[total +
// part_offset + b] (flag 1), 0 to the other. Returns a cudaError_t.
int segclip_grad_norm_partials(int dtype, int n, void* const* g, const long long* numel,
                               const int* first, const unsigned char* flag,
                               long long part_offset, long long total, float* part,
                               void* stream) {
  const int blocks = blocks_of(n, numel, first);
  if (blocks < 1 || part_offset < 0 || part_offset + blocks > total)
    return static_cast<int>(cudaErrorInvalidValue);
  GradTable t = grad_table(n, g, numel, first, flag);
  t.part = part_offset;
  t.total = total;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) grad_norm_partials_kernel<float><<<blocks, THREADS, 0, s>>>(t, part);
  else if (dtype == 1) grad_norm_partials_kernel<bf16><<<blocks, THREADS, 0, s>>>(t, part);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out: 4 float32 (sums replicated and sharded, norm, scale). total > 0:
// the two halves of part summed into out[0..1]; finish: the norm and the
// scale from out[0..1]. Returns a cudaError_t.
int segclip_grad_norm_finalize(const float* part, long long total, float* out, float max_norm,
                               int finish, void* stream) {
  if (total < 0) return static_cast<int>(cudaErrorInvalidValue);
  grad_norm_finalize_kernel<<<1, FINAL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      part, total, out, max_norm, finish);
  return static_cast<int>(cudaGetLastError());
}

// Every gradient times out[3], in place; the table as for the partials.
int segclip_grad_scale(int dtype, int n, void* const* g, const long long* numel,
                       const int* first, const float* out, void* stream) {
  const int blocks = blocks_of(n, numel, first);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  static const unsigned char zeros[MAX_LEAVES] = {};
  const GradTable t = grad_table(n, g, numel, first, zeros);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) grad_scale_kernel<float><<<blocks, THREADS, 0, s>>>(t, out);
  else if (dtype == 1) grad_scale_kernel<bf16><<<blocks, THREADS, 0, s>>>(t, out);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// One AdaptAdamW step over n leaves. p_dtype (the parameters' and
// gradients'), m_dtype (both moments'): 0 = float32, 1 = bfloat16.
// ptrs: n rows of (p, g, m, v), each contiguous with numel[i] elements, g
// null for a leaf with no gradient; first as for the partials; group[i] <
// groups indexes lr, c2 (lr_t / bc1) and wd; omb1 = 1 - b1 and omb2 = 1 - b2
// as the caller rounds them, inv_sqrt_bc2 = 1 / √bc2. Returns a cudaError_t.
int segclip_adamw(int p_dtype, int m_dtype, int n, void* const* ptrs, const long long* numel,
                  const int* first, const unsigned char* group, int groups, const float* lr,
                  const float* c2, const float* wd, float b1, float omb1, float b2, float omb2,
                  float eps, float inv_sqrt_bc2, void* stream) {
  const int blocks = blocks_of(n, numel, first);
  if (blocks < 1 || groups < 1 || groups > MAX_GROUPS)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable t;
  t.n = n;
  for (int i = 0; i < n; ++i) {
    if (group[i] >= groups) return static_cast<int>(cudaErrorInvalidValue);
    t.p[i] = ptrs[4 * i];
    t.g[i] = ptrs[4 * i + 1];
    t.m[i] = ptrs[4 * i + 2];
    t.v[i] = ptrs[4 * i + 3];
    t.numel[i] = numel[i];
    t.first[i] = first[i];
    t.group[i] = group[i];
  }
  t.first[n] = first[n];
  for (int i = 0; i < groups; ++i) {
    t.lr[i] = lr[i];
    t.c2[i] = c2[i];
    t.wd[i] = wd[i];
  }
  t.h = Hyper{b1, omb1, b2, omb2, inv_sqrt_bc2, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0 && m_dtype == 0) adamw_kernel<float, float><<<blocks, THREADS, 0, s>>>(t);
  else if (p_dtype == 0 && m_dtype == 1) adamw_kernel<float, bf16><<<blocks, THREADS, 0, s>>>(t);
  else if (p_dtype == 1 && m_dtype == 0) adamw_kernel<bf16, float><<<blocks, THREADS, 0, s>>>(t);
  else if (p_dtype == 1 && m_dtype == 1) adamw_kernel<bf16, bf16><<<blocks, THREADS, 0, s>>>(t);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
