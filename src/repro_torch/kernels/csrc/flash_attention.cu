// Flash attention (forward) for Hopper (sm_90a), on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py, `_flash_kernel`, reached
// through `flash_attention` (and `ops.attention`): tiled online-softmax
// attention, causal and sliding-window masks by index, GQA by index mapping
// (q head h reads kv head h / rep), float32 running max, denominator and
// accumulator, output in q's dtype.
//
// What bounds it on the H100: at the llama3.2-1b prefill shape (q
// (4,512,32,64), k/v (4,512,8,64), bf16, causal) the function moves 21 MB
// (6.3 us at 3.35 TB/s) and does 4.3 GFLOP (4.3 us at the bf16 tensor-core
// rate), so bytes bound it.  This first version does its products on the
// CUDA cores in float32, so it is bound by those cores' FMA rate and by the
// shared-memory reads that feed them, far above either bound.  Tensor cores
// (mma/wgmma), TMA and a pipelined K/V ring are later work.
//
// What the design does: the TPU kernel walks kv tiles as a sequential grid
// axis with its running statistics in VMEM.  Here one CTA owns one (batch x
// head, 64-row q tile), one thread per query row, and loops over kv tiles
// itself.  The q tile is staged through shared memory for coalesced loads,
// then held pre-scaled by 1/sqrt(D) in registers with the row's float32
// accumulator, max and denominator.  Each 32-key K and V tile is loaded
// once, coalesced, into shared memory as float32, and every thread reads it
// as a broadcast.  Masked scores are -1e30 and the result is divided by
// max(l, 1e-30), as in the TPU kernel.  Tiles wholly outside the causal or
// window band are skipped when every row of the q tile has some key in the
// band: their weights are then exactly zero, so the result is unchanged.
// Ragged T and S are masked here (keys past S weigh nothing), so any
// lengths work.  The q tiles run heaviest (latest) first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per CTA, one thread each
constexpr int kBK = 32;            // keys per shared-memory tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int t_len,
             int s_len, int n_heads, int n_kv, int causal, int window,
             float scale) {
  __shared__ __align__(16) float s_k[kBK][D];
  __shared__ __align__(16) float s_v[kBK][D];
  __shared__ float s_q[kBQ][D + 1];  // q in, o out; +1 avoids bank conflicts

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int g = h / (n_heads / n_kv);                  // GQA: kv head h / rep
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest tiles first
  const int rows = min(kBQ, t_len - q0);
  const int64_t q_row = (int64_t)n_heads * D;          // stride between tokens
  const int64_t kv_row = (int64_t)n_kv * D;
  const int64_t q_off = ((int64_t)b * t_len + q0) * q_row + (int64_t)h * D;
  const int64_t kv_off = (int64_t)b * s_len * kv_row + (int64_t)g * D;

  for (int i = tid; i < kBQ * D; i += kBQ) {
    const int r = i / D, d = i % D;
    s_q[r][d] = r < rows ? load_f32(q + q_off + r * q_row + d) * scale : 0.f;
  }
  __syncthreads();
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = s_q[tid][d];
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int qpos = q0 + tid;

  // Does every row of the tile keep some key?  Validity only gets harder as
  // the row grows, so the last row decides.
  const int q_hi = q0 + rows - 1;
  const int k_max = causal ? min(q_hi, s_len - 1) : s_len - 1;
  const int k_min = window > 0 ? max(q_hi - window + 1, 0) : 0;
  int k_begin = 0, k_end = s_len;
  if (k_max >= k_min) {  // yes: skip the tiles outside every row's band
    if (causal) k_end = min(s_len, q_hi + 1);
    if (window > 0) k_begin = max(q0 - window + 1, 0) / kBK * kBK;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kBQ) {
      const int r = i / D, d = i % D;
      const int kp = k0 + r;
      const bool in = kp < s_len;
      s_k[r][d] = in ? load_f32(k + kv_off + kp * kv_row + d) : 0.f;
      s_v[r][d] = in ? load_f32(v + kv_off + kp * kv_row + d) : 0.f;
    }
    __syncthreads();

    float sc[kBK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&s_k[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      const int kp = k0 + j;
      const bool keep = (!causal || kp <= qpos) &&
                        (window <= 0 || kp > qpos - window);
      // keys past S are no keys at all: weight exactly 0 in every case
      sc[j] = kp >= s_len ? -INFINITY : (keep ? dot : kNegInf);
      m_tile = fmaxf(m_tile, sc[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      sc[j] = expf(sc[j] - m_new);
      p_sum += sc[j];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = sc[j];
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&s_v[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  const float den = fmaxf(l, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) s_q[tid][d] = acc[d] / den;
  __syncthreads();
  for (int i = tid; i < rows * D; i += kBQ) {
    const int r = i / D, d = i % D;
    store_f32(o + q_off + r * q_row + d, s_q[r][d]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int t_len, int s_len, int n_heads, int n_kv, int causal,
           int window, float scale, cudaStream_t stream) {
  const dim3 grid(batch * n_heads, (t_len + kBQ - 1) / kBQ);
  flash_kernel<T, D><<<grid, kBQ, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, t_len, s_len, n_heads,
      n_kv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int head_dim, const void* q, const void* k, const void* v,
             void* o, int batch, int t_len, int s_len, int n_heads, int n_kv,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, batch, t_len, s_len, n_heads, n_kv,
                           causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, batch, t_len, s_len, n_heads, n_kv,
                           causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, t_len, s_len, n_heads, n_kv,
                           causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,T,H,D), k/v (B,S,KV,D), o (B,T,H,D), all contiguous and of one dtype
// (is_bf16 ? bfloat16 : float32).  window <= 0 means none.  Returns the
// cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int t_len, int s_len, int n_heads,
                                      int n_kv, int head_dim, int causal,
                                      int window, int is_bf16, float scale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_d<__nv_bfloat16>(head_dim, q, k, v, o, batch, t_len, s_len,
                                   n_heads, n_kv, causal, window, scale, st);
  return launch_d<float>(head_dim, q, k, v, o, batch, t_len, s_len, n_heads,
                         n_kv, causal, window, scale, st);
}
