// Flash attention backward for Hopper (sm_90a): dQ, dK, dV from q, k, v, the
// forward's output o, its log-sum-exp lse and the upstream gradient dO.
//
// The backward of: flash_attention.cu (`flash_attention_lse_launch`), the
// port of src/repro/kernels/flash_attention.py `_flash_kernel`.  The JAX
// package has no backward kernel (it differentiates plain jnp); this is how
// the port computes what `jax.value_and_grad` computes there, and
// kernels/ref.py `attention_bwd` is its plain version:
//
//   P  = exp(S - lse), S = scale q k^T masked as in the forward
//   D  = rowsum(dO * O)                                  (dot kernel)
//   dV = sum over the group's q heads of P^T dO          (dK/dV kernel)
//   dS = P * (dO v^T - D), 0 where the mask holds
//   dK = scale dS^T q                                    (dK/dV kernel)
//   dQ = scale dS k                                      (dQ kernel)
//
// A row with no key in its band (lse == -1e30) weighs every key 1/S in dV
// and passes no gradient to its scores, as the forward's uniform average.
//
// What bounds it on the H100: at the llama3.2-1b train shape (q
// (4,512,32,64), k/v (4,512,8,64), bf16, causal) it must read q, k, v, o,
// dO (21 MB with lse and D) and write dq, dk, dv (12.6 MB): 10 us at
// 3.35 TB/s; it does 10 flops a head dim per unmasked pair (QK^T, dO V^T,
// P^T dO, dS^T Q, dS K), 10.8 GFLOP, 11 us on the bf16 tensor cores or
// 161 us in float32 on the CUDA cores.
//
// What the design does, in this first version: it is deterministic (no
// atomics; every output element is written once by one CTA) and simple,
// on the CUDA cores in float32 for both input types (bf16 inputs are
// widened as they are loaded, gradients rounded once at the store), so it
// is bound by the CUDA cores' float32 rate and by shared-memory reads,
// not by the tensor cores.
// - dK/dV: one CTA per (batch, kv head, 64-key tile).  Each key is owned by
//   D/16 neighbouring threads, 16 head dims each, holding its k and v
//   slices and its dK and dV accumulators in registers; the two dot
//   products of a (query, key) pair are summed over those threads by
//   `__shfl_xor_sync`.  The CTA loops over the group's H/KV query heads
//   (GQA is summed inside the CTA) and over the 32-row q tiles that the
//   causal/window band reaches (or that hold a row with no key in its
//   band), staging q (pre-scaled), dO, lse and D in shared memory, read by
//   every thread as broadcasts.
// - dQ: one CTA per (batch, head, 64-row q tile), the same layout with rows
//   in place of keys, looping over the 32-key tiles of the band.
// - D = rowsum(dO * O): one warp a row.
// Tensor cores (`mma.sync` as in the forward, then `wgmma`) are a later
// step, taken only behind a measurement.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the forward's mask value
constexpr int kSlice = 16;         // head dims a thread owns
constexpr int kTile = 64;          // keys (dK/dV) or rows (dQ) a CTA owns
constexpr int kStep = 32;          // rows (dK/dV) or keys (dQ) a stage holds

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool keep(int qp, int kp, int causal, int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Does row `r` keep no key at all?  (Then it averages every key.)
__device__ __forceinline__ bool row_empty(int r, int s_len, int causal,
                                          int window) {
  const int k_max = causal ? min(r, s_len - 1) : s_len - 1;
  const int k_min = window > 0 ? max(r - window + 1, 0) : 0;
  return k_max < k_min;
}

// 16 floats of shared memory, 16-byte aligned, as four wide loads
__device__ __forceinline__ void load16(float (&r)[kSlice], const float* p) {
#pragma unroll
  for (int d = 0; d < kSlice; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + d);
    r[d] = x.x, r[d + 1] = x.y, r[d + 2] = x.z, r[d + 3] = x.w;
  }
}

// Sum over the SPLIT neighbouring lanes that own one row or key.
template <int SPLIT>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int m = 1; m < SPLIT; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O), one warp a (b, t, h) row; written as (B,H,T)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ dsum, int n_rows,
                                     int t_len, int n_heads, int head_dim) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int64_t base = (int64_t)row * head_dim;
  float acc = 0.f;
  for (int d = lane; d < head_dim; d += 32)
    acc = fmaf(to_f(o[base + d]), to_f(dout[base + d]), acc);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int h = row % n_heads;
    const int bt = row / n_heads;  // b * T + t
    const int b = bt / t_len, t = bt % t_len;
    dsum[((int64_t)b * n_heads + h) * t_len + t] = acc;
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one CTA per (b, kv head, 64-key tile)
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kTile*(D / kSlice))
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int t_len, int s_len, int n_heads,
                      int n_kv, int causal, int window, float scale) {
  constexpr int SPLIT = D / kSlice;
  constexpr int kThreads = kTile * SPLIT;
  __shared__ __align__(16) float s_q[kStep][D];   // q * scale
  __shared__ __align__(16) float s_do[kStep][D];
  __shared__ float s_lse[kStep], s_d[kStep];

  const int tid = threadIdx.x;
  const int j = tid / SPLIT, d0 = (tid % SPLIT) * kSlice;
  const int b = blockIdx.x / n_kv, g = blockIdx.x % n_kv;
  const int rep = n_heads / n_kv;
  const int k0 = blockIdx.y * kTile;
  const int k_hi = min(k0 + kTile, s_len) - 1;
  const int kp = k0 + j;
  const bool key_in = kp < s_len;
  const int64_t q_row = (int64_t)n_heads * D, kv_row = (int64_t)n_kv * D;
  const int64_t kv_at = ((int64_t)b * s_len + (key_in ? kp : 0)) * kv_row +
                        (int64_t)g * D + d0;

  float kr[kSlice], vr[kSlice], ak[kSlice], av[kSlice];
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    kr[d] = key_in ? to_f(k[kv_at + d]) : 0.f;
    vr[d] = key_in ? to_f(v[kv_at + d]) : 0.f;
    ak[d] = av[d] = 0.f;
  }
  const float inv_s = 1.f / (float)s_len;
  const int n_qt = (t_len + kStep - 1) / kStep;

  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const int64_t lrow = ((int64_t)b * n_heads + h) * t_len;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kStep;
      const int q_hi = min(q0 + kStep, t_len) - 1;
      // the tile matters if some (row, key) pair is kept, or if a row keeps
      // no key (the last row decides: emptiness only grows with the row)
      const bool pairs = (!causal || k0 <= q_hi) &&
                         (window <= 0 || k_hi > q0 - window);
      if (!pairs && !row_empty(q_hi, s_len, causal, window)) continue;
      __syncthreads();  // the previous stage is consumed
      for (int i = tid; i < kStep * D; i += kThreads) {
        const int rr = i / D, d = i % D;
        const bool in = q0 + rr < t_len;
        const int64_t at = ((int64_t)b * t_len + q0 + rr) * q_row +
                           (int64_t)h * D + d;
        s_q[rr][d] = in ? to_f(q[at]) * scale : 0.f;
        s_do[rr][d] = in ? to_f(dout[at]) : 0.f;
      }
      for (int rr = tid; rr < kStep; rr += kThreads) {
        const bool in = q0 + rr < t_len;
        s_lse[rr] = in ? lse[lrow + q0 + rr] : 0.f;
        s_d[rr] = in ? dsum[lrow + q0 + rr] : 0.f;
      }
      __syncthreads();
      const int rows = q_hi - q0 + 1;
      for (int rr = 0; rr < rows; ++rr) {
        float qv[kSlice], ov[kSlice];
        load16(qv, &s_q[rr][d0]);
        load16(ov, &s_do[rr][d0]);
        float sp = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kSlice; ++d) {
          sp = fmaf(qv[d], kr[d], sp);
          dp = fmaf(ov[d], vr[d], dp);
        }
        sp = lanes_sum<SPLIT>(sp);
        dp = lanes_sum<SPLIT>(dp);
        const int qp = q0 + rr;
        const float l = s_lse[rr];
        const bool empty = l <= 0.5f * kNegInf;
        const bool kept = key_in && keep(qp, kp, causal, window);
        const float p = empty ? (key_in ? inv_s : 0.f)
                              : (kept ? __expf(sp - l) : 0.f);
        const float ds = (kept && !empty) ? p * (dp - s_d[rr]) : 0.f;
#pragma unroll
        for (int d = 0; d < kSlice; ++d) {
          av[d] = fmaf(p, ov[d], av[d]);
          ak[d] = fmaf(ds, qv[d], ak[d]);
        }
      }
    }
  }
  if (key_in) {
#pragma unroll
    for (int d = 0; d < kSlice; ++d) {
      dk[kv_at + d] = from_f<T>(ak[d]);
      dv[kv_at + d] = from_f<T>(av[d]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (b, head, 64-row q tile)
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kTile*(D / kSlice))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int t_len, int s_len, int n_heads, int n_kv, int causal,
                    int window, float scale) {
  constexpr int SPLIT = D / kSlice;
  constexpr int kThreads = kTile * SPLIT;
  __shared__ __align__(16) float s_k[kStep][D];
  __shared__ __align__(16) float s_v[kStep][D];

  const int tid = threadIdx.x;
  const int i = tid / SPLIT, d0 = (tid % SPLIT) * kSlice;
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int g = h / (n_heads / n_kv);
  const int q0 = blockIdx.y * kTile;
  const int q_hi = min(q0 + kTile, t_len) - 1;
  const int qp = q0 + i;
  const bool row_in = qp < t_len;
  const int64_t q_row = (int64_t)n_heads * D, kv_row = (int64_t)n_kv * D;
  const int64_t q_at = ((int64_t)b * t_len + (row_in ? qp : 0)) * q_row +
                       (int64_t)h * D + d0;
  const int64_t kv_off = (int64_t)b * s_len * kv_row + (int64_t)g * D;
  const int64_t lrow = ((int64_t)b * n_heads + h) * t_len;

  float qr[kSlice], dor[kSlice], acc[kSlice];
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    qr[d] = row_in ? to_f(q[q_at + d]) * scale : 0.f;
    dor[d] = row_in ? to_f(dout[q_at + d]) : 0.f;
    acc[d] = 0.f;
  }
  const float l = row_in ? lse[lrow + qp] : 0.f;
  const float dsr = row_in ? dsum[lrow + qp] : 0.f;
  const bool live = row_in && l > 0.5f * kNegInf;  // an empty row gets 0

  // keys [k_begin, k_end) that some row of the tile keeps
  int k_begin = 0, k_end = s_len;
  if (causal) k_end = min(s_len, q_hi + 1);
  if (window > 0) k_begin = max(q0 - window + 1, 0) / kStep * kStep;

  for (int kb = k_begin; kb < k_end; kb += kStep) {
    __syncthreads();
    for (int e = tid; e < kStep * D; e += kThreads) {
      const int jj = e / D, d = e % D;
      const bool in = kb + jj < s_len;
      const int64_t at = kv_off + (int64_t)(in ? kb + jj : 0) * kv_row + d;
      s_k[jj][d] = in ? to_f(k[at]) : 0.f;
      s_v[jj][d] = in ? to_f(v[at]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kStep; ++jj) {
      float kv[kSlice], vv[kSlice];
      load16(kv, &s_k[jj][d0]);
      load16(vv, &s_v[jj][d0]);
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kSlice; ++d) {
        sp = fmaf(qr[d], kv[d], sp);
        dp = fmaf(dor[d], vv[d], dp);
      }
      sp = lanes_sum<SPLIT>(sp);
      dp = lanes_sum<SPLIT>(dp);
      const int kp = kb + jj;
      const bool kept = live && kp < s_len && keep(qp, kp, causal, window);
      const float ds = kept ? __expf(sp - l) * (dp - dsr) : 0.f;
#pragma unroll
      for (int d = 0; d < kSlice; ++d) acc[d] = fmaf(ds, kv[d], acc[d]);
    }
  }
  if (row_in) {
#pragma unroll
    for (int d = 0; d < kSlice; ++d) dq[q_at + d] = from_f<T>(acc[d] * scale);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           float* dsum, int batch, int t_len, int s_len, int n_heads,
           int n_kv, int causal, int window, float scale,
           cudaStream_t stream) {
  const int n_rows = batch * t_len * n_heads;
  flash_bwd_dot_kernel<T><<<(n_rows + 7) / 8, 256, 0, stream>>>(
      (const T*)o, (const T*)dout, dsum, n_rows, t_len, n_heads, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  constexpr int kThreads = kTile * (D / kSlice);
  const dim3 g_kv(batch * n_kv, (s_len + kTile - 1) / kTile);
  flash_bwd_dkdv_kernel<D, T><<<g_kv, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, dsum, (T*)dk, (T*)dv, t_len, s_len, n_heads, n_kv,
      causal, window, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 g_q(batch * n_heads, (t_len + kTile - 1) / kTile);
  flash_bwd_dq_kernel<D, T><<<g_q, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, dsum, (T*)dq, t_len, s_len, n_heads, n_kv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dtype(int is_bf16, const void* q, const void* k, const void* v,
                 const void* o, const void* lse, const void* dout, void* dq,
                 void* dk, void* dv, float* dsum, int batch, int t_len,
                 int s_len, int n_heads, int n_kv, int causal, int window,
                 float scale, cudaStream_t st) {
  if (is_bf16)
    return launch<D, bf16>(q, k, v, o, lse, dout, dq, dk, dv, dsum, batch,
                           t_len, s_len, n_heads, n_kv, causal, window,
                           scale, st);
  return launch<D, float>(q, k, v, o, lse, dout, dq, dk, dv, dsum, batch,
                          t_len, s_len, n_heads, n_kv, causal, window, scale,
                          st);
}

}  // namespace

// q, o, dout, dq (B,T,H,D); k, v, dk, dv (B,S,KV,D), all contiguous and of
// one dtype (is_bf16 ? bfloat16 : float32); lse and dsum (B,H,T) float32,
// dsum scratch that the launch fills.  window <= 0 means none.  Three
// kernels on `stream`; returns the first cudaGetLastError() that is not 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int batch, int t_len, int s_len, int n_heads, int n_kv,
    int head_dim, int causal, int window, int is_bf16, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* ds = (float*)dsum;
  switch (head_dim) {
    case 16:
      return launch_dtype<16>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, ds,
                              batch, t_len, s_len, n_heads, n_kv, causal,
                              window, scale, st);
    case 32:
      return launch_dtype<32>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, ds,
                              batch, t_len, s_len, n_heads, n_kv, causal,
                              window, scale, st);
    case 64:
      return launch_dtype<64>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, ds,
                              batch, t_len, s_len, n_heads, n_kv, causal,
                              window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
