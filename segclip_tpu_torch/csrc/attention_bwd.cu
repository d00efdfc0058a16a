// Attention backward from the saved probabilities, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of segclip_tpu/ops/pallas/attention.py
// (reached through `_call_bwd`, pallas_call at :203, VJP at :217-247). With P
// the (Lq, Lk) probabilities that the forward saved (csrc/attention_fwd.cu),
// per batch and head, all in fp32 from fp32-cast operands:
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
// projection go in without copies. P is a contiguous (B, H, Lq, Lk) tensor
// in V's dtype; dQ, dK, dV are contiguous (B, L, H·64).
//
// What bounds it on the H100: at SegCLIP's lengths (L ≤ ~200) one head's
// operands are a few tens of KB and P at most 150 KB, so a call is a few
// hundred small blocks of latency-bound work, like the forward. The TPU
// kernel carries a whole (batch, head pair) in VMEM and reduces dK and dV
// over all query rows inside one program. Blocks on Hopper run in no order,
// so that reduction cannot be carried across blocks; float atomics would
// make the result change from run to run. Two passes with no atomics keep it
// reproducible, as the grouping kernel does:
//   (a) one block per (b, h, 16 query rows) walks the keys twice in 64-row
//       tiles: first D_i = Σ_j P_ij (dO_i·V_j), which it writes to a
//       (B, H, Lq) fp32 scratch, then dS_ij and dQ_i = Σ_j dS_ij K_j·scale;
//   (b) one block per (b, h, 64 key rows) walks the queries in 32-row tiles
//       and sums dV_j = Σ_i P_ij dO_i and dK_j = Σ_i dS_ij Q_i·scale, with
//       dS rebuilt from P, dO, V and D.
// fp32 FMAs throughout; tensor cores are left for a later redesign.
//
// Masks: query rows at or past Lq and key rows at or past Lk are never
// stored and read as zeros (P = 0 there, so they add nothing). Entries that
// the causal mask removed have P = 0 and add nothing either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 64;                         // head dim
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* p;         // (B, H, Lq, Lk)
  const void* dout;      // (B, Lq, H·64), strided
  const void* q;
  const void* k;
  const void* v;
  void* dq;              // (B, Lq, H·64) contiguous
  void* dk;              // (B, Lk, H·64) contiguous
  void* dv;
  float* drow;           // (B, H, Lq) scratch: D
  int heads, lq, lk;
  long long do_bs, do_rs, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale;
};

// Rows [row0, row0 + KT) of one head's (L, 64) slice into shared memory, as
// fp32, zero past `rows`.
template <typename T>
__device__ __forceinline__ void load_tile(float (*dst)[HD + 1], const T* src,
                                          long long rs, int row0, int rows) {
  for (int e = threadIdx.x; e < KT * HD; e += THREADS_A) {
    const int r = e / HD, c = e % HD;
    const int gr = row0 + r;
    dst[r][c] = gr < rows ? to_f32(src[gr * rs + c]) : 0.f;
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
template <typename T>
__global__ void __launch_bounds__(THREADS_A) attention_bwd_dq_kernel(Args a) {
  __shared__ float dos[QT][HD + 1];
  __shared__ float ks[KT][HD + 1];
  __shared__ float vs[KT][HD + 1];
  __shared__ float dss[QT][KT + 1];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x;
  const int row = tid / LANES, lane = tid % LANES;
  const int qrow = q0 + row;

  const T* dop = static_cast<const T*>(a.dout) + b * a.do_bs + h * HD;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_bs + h * HD;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_bs + h * HD;

  for (int e = tid; e < QT * HD; e += THREADS_A) {
    const int r = e / HD, c = e % HD;
    dos[r][c] = q0 + r < a.lq ? to_f32(dop[(q0 + r) * a.do_rs + c]) : 0.f;
  }
  __syncthreads();
  float dor[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dor[d] = dos[row][d];

  const int prow = qrow < a.lq ? qrow : a.lq - 1;       // rows past Lq are never stored
  const T* pp = static_cast<const T*>(a.p) +
                ((static_cast<long long>(b) * a.heads + h) * a.lq + prow) * a.lk;

  // D = Σ_j P_ij (dO_i · V_j)
  float dsum = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += KT) {
    __syncthreads();
    load_tile(vs, vp, a.v_rs, k0, a.lk);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = lane + LANES * j;
      if (k0 + c < a.lk) dsum = fmaf(to_f32(pp[k0 + c]), dot64(dor, vs[c]), dsum);
    }
  }
  const float drow = row_sum(dsum);
  if (lane == 0 && qrow < a.lq)
    a.drow[(static_cast<long long>(b) * a.heads + h) * a.lq + qrow] = drow;

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
      if (k0 + c < a.lk) ds = to_f32(pp[k0 + c]) * (dot64(dor, vs[c]) - drow);
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
    T* dqp = static_cast<T*>(a.dq) +
             (static_cast<long long>(b) * a.lq + qrow) * (a.heads * HD) + h * HD;
#pragma unroll
    for (int j = 0; j < DIMS; ++j) dqp[lane + LANES * j] = from_f32<T>(acc[j] * a.scale);
  }
}

// Pass (b): dK and dV. Grid (ceil(Lk / KB), H, B). Thread `part` of key row
// `key` owns dims part + SPLIT·t, t < DPT (interleaved, so the four threads
// of a key read four different shared-memory banks).
template <typename T>
__global__ void __launch_bounds__(THREADS_B) attention_bwd_dkv_kernel(Args a) {
  __shared__ float dos[QB][HD];
  __shared__ float qs[QB][HD];
  __shared__ float ps[QB][KB + 1];
  __shared__ float dtile[QB];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * KB;
  const int tid = threadIdx.x;
  const int key = tid / SPLIT, part = tid % SPLIT;
  const int krow = k0 + key;

  const T* dop = static_cast<const T*>(a.dout) + b * a.do_bs + h * HD;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_bs + h * HD;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_bs + h * HD;
  const T* pp = static_cast<const T*>(a.p) +
                (static_cast<long long>(b) * a.heads + h) * a.lq * a.lk;
  const float* dp_row = a.drow + (static_cast<long long>(b) * a.heads + h) * a.lq;

  float vr[DPT], dk[DPT], dv[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    vr[t] = krow < a.lk ? to_f32(vp[krow * a.v_rs + part + SPLIT * t]) : 0.f;
    dk[t] = 0.f;
    dv[t] = 0.f;
  }

  for (int i0 = 0; i0 < a.lq; i0 += QB) {
    __syncthreads();
    for (int e = tid; e < QB * HD; e += THREADS_B) {
      const int r = e / HD, c = e % HD;
      const bool ok = i0 + r < a.lq;
      dos[r][c] = ok ? to_f32(dop[(i0 + r) * a.do_rs + c]) : 0.f;
      qs[r][c] = ok ? to_f32(qp[(i0 + r) * a.q_rs + c]) : 0.f;
    }
    for (int e = tid; e < QB * KB; e += THREADS_B) {
      const int r = e / KB, c = e % KB;
      ps[r][c] = i0 + r < a.lq && k0 + c < a.lk
                     ? to_f32(pp[static_cast<long long>(i0 + r) * a.lk + k0 + c])
                     : 0.f;
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
    T* dkp = static_cast<T*>(a.dk) + o;
    T* dvp = static_cast<T*>(a.dv) + o;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      dkp[part + SPLIT * t] = from_f32<T>(dk[t] * a.scale);
      dvp[part + SPLIT * t] = from_f32<T>(dv[t]);
    }
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t s) {
  attention_bwd_dq_kernel<T><<<dim3((a.lq + QT - 1) / QT, a.heads, batch), THREADS_A, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<T><<<dim3((a.lk + KB - 1) / KB, a.heads, batch), THREADS_B, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (P, dO, Q, K, V, dQ, dK, dV all in it).
// Strides are in elements. drow is a (B, H, Lq) fp32 scratch. Returns the
// cudaError_t of the launches (0 on success).
int segclip_attention_bwd(int dtype, const void* p, const void* dout, const void* q,
                          const void* k, const void* v, void* dq, void* dk, void* dv,
                          void* drow, int batch, int heads, int lq, int lk, long long do_bs,
                          long long do_rs, long long q_bs, long long q_rs, long long k_bs,
                          long long k_rs, long long v_bs, long long v_rs, float scale,
                          void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{p, dout, q, k, v, dq, dk, dv, static_cast<float*>(drow), heads, lq, lk,
         do_bs, do_rs, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, batch, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
