// The flash backward's kernels and their launch at one head dim, included
// by each of flash_bwd_d<D>.cu (one translation unit a head dim, so the
// build compiles them in parallel); flash_attention_bwd.cu holds the C
// entry point and the design note.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "device_helpers.cuh"
// the forward's TMA maps, tile layouts, descriptors and product helpers
#include "flash_fwd.cuh"
#include "hopper.cuh"

// One launch (see flash_attention_bwd.cu): q, o, dout, dq (B,T,H,D); k, v,
// dk, dv (B,S,KV,D); lse and dsum (B,H,T) float32.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* lse;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* dsum;
  int batch, t_len, s_len, n_heads, n_kv, causal, window, is_bf16, o_f32;
  float scale, softcap;
  cudaStream_t stream;
};

// The backward at head dim D -> the first cudaGetLastError() of its
// launches that is not 0; defined in flash_bwd_d<D>.cu.
template <int D>
int flash_bwd_launch(const BwdArgs& a);
template <>
int flash_bwd_launch<16>(const BwdArgs& a);
template <>
int flash_bwd_launch<32>(const BwdArgs& a);
template <>
int flash_bwd_launch<64>(const BwdArgs& a);
template <>
int flash_bwd_launch<80>(const BwdArgs& a);
template <>
int flash_bwd_launch<128>(const BwdArgs& a);
template <>
int flash_bwd_launch<256>(const BwdArgs& a);

namespace {

// float32 kernels: keys (dK/dV) or rows (dQ) a CTA owns, and rows (dK/dV)
// or keys (dQ) a stage holds
template <int D>
constexpr int kTile = D == 256 ? 16 : 64;
template <int D>
constexpr int kStep = D == 256 ? 16 : 32;

// Head dims a thread owns: 16, so D/16 lanes share a key or row, except
// at D = 80, where 5 lanes would straddle warps and their sums need
// power-of-two butterflies: 4 lanes of 20 there.
template <int D>
constexpr int kSlice = D == 80 ? 20 : 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// N floats of shared memory, 16-byte aligned, as N/4 wide loads
template <int N>
__device__ __forceinline__ void load_slice(float (&r)[N], const float* p) {
#pragma unroll
  for (int d = 0; d < N; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + d);
    r[d] = x.x, r[d + 1] = x.y, r[d + 2] = x.z, r[d + 3] = x.w;
  }
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O), one warp a (b, t, h) row; written as (B,H,T).  O in
// dO's dtype or in float32.
// ---------------------------------------------------------------------------

template <typename TO, typename T>
__global__ void flash_bwd_dot_kernel(const TO* __restrict__ o,
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
__global__ void __launch_bounds__(kTile<D>*(D / kSlice<D>))
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int t_len, int s_len, int n_heads,
                      int n_kv, int causal, int window, float scale,
                      float softcap) {
  constexpr int SL = kSlice<D>;
  constexpr int SPLIT = D / SL;
  constexpr int kTileF = kTile<D>, kStepF = kStep<D>;
  constexpr int kThreads = kTileF * SPLIT;
  __shared__ __align__(16) float s_q[kStepF][D];   // q * scale
  __shared__ __align__(16) float s_do[kStepF][D];
  __shared__ float s_lse[kStepF], s_d[kStepF];

  const int tid = threadIdx.x;
  const int j = tid / SPLIT, d0 = (tid % SPLIT) * SL;
  const int b = blockIdx.x / n_kv, g = blockIdx.x % n_kv;
  const int rep = n_heads / n_kv;
  const int k0 = blockIdx.y * kTileF;
  const int k_hi = min(k0 + kTileF, s_len) - 1;
  const int kp = k0 + j;
  const bool key_in = kp < s_len;
  const int64_t q_row = (int64_t)n_heads * D, kv_row = (int64_t)n_kv * D;
  const int64_t kv_at = ((int64_t)b * s_len + (key_in ? kp : 0)) * kv_row +
                        (int64_t)g * D + d0;

  float kr[SL], vr[SL], ak[SL], av[SL];
#pragma unroll
  for (int d = 0; d < SL; ++d) {
    kr[d] = key_in ? to_f(k[kv_at + d]) : 0.f;
    vr[d] = key_in ? to_f(v[kv_at + d]) : 0.f;
    ak[d] = av[d] = 0.f;
  }
  const float inv_s = 1.f / (float)s_len;
  const float cap_in = softcap > 0.f ? 1.f / softcap : 0.f;
  const int n_qt = (t_len + kStepF - 1) / kStepF;

  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const int64_t lrow = ((int64_t)b * n_heads + h) * t_len;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kStepF;
      const int q_hi = min(q0 + kStepF, t_len) - 1;
      // the tile matters if some (row, key) pair is kept, or if a row keeps
      // no key (the last row decides: emptiness only grows with the row)
      const bool pairs = (!causal || k0 <= q_hi) &&
                         (window <= 0 || k_hi > q0 - window);
      if (!pairs && !row_empty(q_hi, s_len, causal, window)) continue;
      __syncthreads();  // the previous stage is consumed
      for (int i = tid; i < kStepF * D; i += kThreads) {
        const int rr = i / D, d = i % D;
        const bool in = q0 + rr < t_len;
        const int64_t at = ((int64_t)b * t_len + q0 + rr) * q_row +
                           (int64_t)h * D + d;
        s_q[rr][d] = in ? to_f(q[at]) * scale : 0.f;
        s_do[rr][d] = in ? to_f(dout[at]) : 0.f;
      }
      for (int rr = tid; rr < kStepF; rr += kThreads) {
        const bool in = q0 + rr < t_len;
        s_lse[rr] = in ? lse[lrow + q0 + rr] : 0.f;
        s_d[rr] = in ? dsum[lrow + q0 + rr] : 0.f;
      }
      __syncthreads();
      const int rows = q_hi - q0 + 1;
      for (int rr = 0; rr < rows; ++rr) {
        float qv[SL], ov[SL];
        load_slice(qv, &s_q[rr][d0]);
        load_slice(ov, &s_do[rr][d0]);
        float sp = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < SL; ++d) {
          sp = fmaf(qv[d], kr[d], sp);
          dp = fmaf(ov[d], vr[d], dp);
        }
        sp = lanes_sum<SPLIT>(sp);
        dp = lanes_sum<SPLIT>(dp);
        float dcap = 1.f;  // the softcap's derivative
        if (softcap > 0.f) {
          const float th = tanhf(sp * cap_in);
          sp = softcap * th;
          dcap = 1.f - th * th;
        }
        const int qp = q0 + rr;
        const float l = s_lse[rr];
        const bool empty = l <= 0.5f * kNegInf;
        const bool kept = key_in && keep(qp, kp, causal, window);
        const float p = empty ? (key_in ? inv_s : 0.f)
                              : (kept ? __expf(sp - l) : 0.f);
        const float ds =
            (kept && !empty) ? p * (dp - s_d[rr]) * dcap : 0.f;
#pragma unroll
        for (int d = 0; d < SL; ++d) {
          av[d] = fmaf(p, ov[d], av[d]);
          ak[d] = fmaf(ds, qv[d], ak[d]);
        }
      }
    }
  }
  if (key_in) {
#pragma unroll
    for (int d = 0; d < SL; ++d) {
      dk[kv_at + d] = from_f<T>(ak[d]);
      dv[kv_at + d] = from_f<T>(av[d]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (b, head, 64-row q tile)
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kTile<D>*(D / kSlice<D>))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int t_len, int s_len, int n_heads, int n_kv, int causal,
                    int window, float scale, float softcap) {
  constexpr int SL = kSlice<D>;
  constexpr int SPLIT = D / SL;
  constexpr int kTileF = kTile<D>, kStepF = kStep<D>;
  constexpr int kThreads = kTileF * SPLIT;
  __shared__ __align__(16) float s_k[kStepF][D];
  __shared__ __align__(16) float s_v[kStepF][D];

  const int tid = threadIdx.x;
  const int i = tid / SPLIT, d0 = (tid % SPLIT) * SL;
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int g = h / (n_heads / n_kv);
  const int q0 = blockIdx.y * kTileF;
  const int q_hi = min(q0 + kTileF, t_len) - 1;
  const int qp = q0 + i;
  const bool row_in = qp < t_len;
  const int64_t q_row = (int64_t)n_heads * D, kv_row = (int64_t)n_kv * D;
  const int64_t q_at = ((int64_t)b * t_len + (row_in ? qp : 0)) * q_row +
                       (int64_t)h * D + d0;
  const int64_t kv_off = (int64_t)b * s_len * kv_row + (int64_t)g * D;
  const int64_t lrow = ((int64_t)b * n_heads + h) * t_len;

  float qr[SL], dor[SL], acc[SL];
#pragma unroll
  for (int d = 0; d < SL; ++d) {
    qr[d] = row_in ? to_f(q[q_at + d]) * scale : 0.f;
    dor[d] = row_in ? to_f(dout[q_at + d]) : 0.f;
    acc[d] = 0.f;
  }
  const float l = row_in ? lse[lrow + qp] : 0.f;
  const float dsr = row_in ? dsum[lrow + qp] : 0.f;
  const bool live = row_in && l > 0.5f * kNegInf;  // an empty row gets 0
  const float cap_in = softcap > 0.f ? 1.f / softcap : 0.f;

  // keys [k_begin, k_end) that some row of the tile keeps
  int k_begin = 0, k_end = s_len;
  if (causal) k_end = min(s_len, q_hi + 1);
  if (window > 0) k_begin = max(q0 - window + 1, 0) / kStepF * kStepF;

  for (int kb = k_begin; kb < k_end; kb += kStepF) {
    __syncthreads();
    for (int e = tid; e < kStepF * D; e += kThreads) {
      const int jj = e / D, d = e % D;
      const bool in = kb + jj < s_len;
      const int64_t at = kv_off + (int64_t)(in ? kb + jj : 0) * kv_row + d;
      s_k[jj][d] = in ? to_f(k[at]) : 0.f;
      s_v[jj][d] = in ? to_f(v[at]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kStepF; ++jj) {
      float kv[SL], vv[SL];
      load_slice(kv, &s_k[jj][d0]);
      load_slice(vv, &s_v[jj][d0]);
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < SL; ++d) {
        sp = fmaf(qr[d], kv[d], sp);
        dp = fmaf(dor[d], vv[d], dp);
      }
      sp = lanes_sum<SPLIT>(sp);
      dp = lanes_sum<SPLIT>(dp);
      float dcap = 1.f;  // the softcap's derivative
      if (softcap > 0.f) {
        const float th = tanhf(sp * cap_in);
        sp = softcap * th;
        dcap = 1.f - th * th;
      }
      const int kp = kb + jj;
      const bool kept = live && kp < s_len && keep(qp, kp, causal, window);
      const float ds = kept ? __expf(sp - l) * (dp - dsr) * dcap : 0.f;
#pragma unroll
      for (int d = 0; d < SL; ++d) acc[d] = fmaf(ds, kv[d], acc[d]);
    }
  }
  if (row_in) {
#pragma unroll
    for (int d = 0; d < SL; ++d) dq[q_at + d] = from_f<T>(acc[d] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA loads, warp-specialised
// ---------------------------------------------------------------------------

// wgmma's M: the keys of a dK/dV CTA (both consumer warpgroups' walks),
// the q rows of a dQ consumer warpgroup (a dQ CTA owns kTQ = 2 x 64)
constexpr int kBwdM = 64;
// The q rows (dK/dV) or keys (dQ) a ring stage holds, wgmma's N for
// S = Q K^T and dP = dO V^T (S^T, dP^T): 64 up to D = 128; 32 at D = 256,
// where a thread's 128-float accumulator sits beside S and dP.
template <int D>
constexpr int kBwdN = D <= 128 ? 64 : 32;
// Stages of the rings: Q/dO (dK/dV) and K/V (dQ).  (A ring of 5 for the
// dK/dV kernel, its two consumers each on its own tiles, was no faster.)
constexpr int kDkdvStages = 3;
constexpr int kDqStages = 3;
// What a dK/dV launch accumulates: both up to D = 128; at D = 256 the
// kernel runs twice, a dV pass and then a dK pass (one 128-float
// accumulator a thread each).
enum DkdvPass { kDkdvBoth, kDkdvOnlyDv, kDkdvOnlyDk };
constexpr int kEpilogueBarrier = 1;  // the dK/dV consumers' hand-over

// Dynamic shared memory a CTA: its stage and room to align it to 1,024,
// and at least 116 KB, so that an SM never holds two CTAs (as the
// forward's: their consumers' setmaxnreg.inc would wait on each other).
template <typename S>
constexpr int bwd_smem_bytes() {
  return (int)sizeof(S) + 1024 > 116 * 1024 ? (int)sizeof(S) + 1024
                                            : 116 * 1024;
}

template <typename S>
__device__ __forceinline__ S& aligned_stage(unsigned char* smem) {
  return *reinterpret_cast<S*>(smem +
                               ((1024 - (smem_addr(smem) & 1023)) & 1023));
}

// acc (64 x N) = A B^T over the head dim: A the rows [row0, row0 + 64) of
// an RA-row tile, B an N-row tile, both K-major in shared memory; issued,
// not waited for.
template <int D, int RA, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 8][4],
                                         uint32_t a_tile, int row0,
                                         uint32_t b_tile) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    Wgmma<N>::ss(acc, kmajor_desc<D, RA>(a_tile, row0, kc),
                 kmajor_desc<D, N>(b_tile, 0, kc), kc > 0);
}

// Two floats as two bf16 terms each, hi = bf16(x) and lo = bf16(x - hi):
// hi + lo keeps ~16 bits of x, where hi alone keeps 8.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// X (64 x N, float32 in the accumulator layout) as the A fragments of its
// two bf16 terms: the layout of 8-column tiles 2 kc and 2 kc + 1 is the A
// layout of 16-column step kc (as the forward's pack_p).
template <int N>
__device__ __forceinline__ void split_terms(const float (&x)[N / 8][4],
                                            uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    split_bf16(x[2 * kc][0], x[2 * kc][1], hi[kc][0], lo[kc][0]);
    split_bf16(x[2 * kc][2], x[2 * kc][3], hi[kc][1], lo[kc][1]);
    split_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1], hi[kc][2], lo[kc][2]);
    split_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3], hi[kc][3], lo[kc][3]);
  }
}

// acc (64 x D) += X B, X given as its two bf16 terms, B an N-row tile
// read MN-major (its rows are the product's k): hi then lo, a 16-row step
// at a time, into one accumulator; issued, not waited for.
template <int D, int N>
__device__ __forceinline__ void issue_rs2(float (&acc)[D / 8][4],
                                          const uint32_t (&hi)[N / 16][4],
                                          const uint32_t (&lo)[N / 16][4],
                                          uint32_t b_tile) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    issue_pv_step<D, N>(acc, hi[kc], b_tile, kc);
    issue_pv_step<D, N>(acc, lo[kc], b_tile, kc);
  }
}

// Where the time goes (compiled in only with FLASH_BWD_PHASES, which
// scripts/bwd_variants.py --phases defines and reads back through
// `bwd_phases_take`): each consumer warp's `clock64` cycles in each phase,
// summed over the warps of a launch (`mark(i)` charges the cycles since
// the last mark to phase i), and each CTA's start and end on
// `%globaltimer` and its SM.  Kernel slots: the dK/dV launch by its
// DkdvPass (0-2), dQ 3.  Without it the marks are empty.
enum BwdPhase {
  kBwdLoop,      // the walk's bookkeeping up to the stage's wait
  kBwdWait,      // the stage's tiles land
  kBwdScores,    // S and dP (S^T and dP^T) issued and done
  kBwdSoftmax,   // masks, P and dS
  kBwdGrads,     // their two bf16 terms, the products issued and done
  kBwdEpilogue,  // the hand-over (dK/dV), scale and stores
  kBwdTiles,     // tiles walked (a count, not cycles)
  kBwdPhases
};
constexpr int kBwdKernels = 4;
constexpr int kDqSlot = 3;
#ifdef FLASH_BWD_PHASES
constexpr int kBwdMaxCtas = 1 << 14;
__device__ unsigned long long bwd_phase_sums[kBwdKernels][kBwdPhases];
// start (ns), end (ns), SM
__device__ unsigned long long bwd_cta_stamps[kBwdKernels][kBwdMaxCtas][3];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cta_begin(int slot) {
  if (threadIdx.x == 0 && blockIdx.x < kBwdMaxCtas) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm));
    bwd_cta_stamps[slot][blockIdx.x][0] = global_ns();
    bwd_cta_stamps[slot][blockIdx.x][2] = sm;
  }
}

struct BwdPhases {
  long long t = 0;
  long long sum[kBwdPhases] = {};
  __device__ __forceinline__ void start() { t = clock64(); }
  __device__ __forceinline__ void mark(int i) {
    const long long now = clock64();
    sum[i] += now - t;
    t = now;
  }
  // this warp's sums into the launch's, and (one thread a warpgroup) the
  // CTA's end
  __device__ __forceinline__ void flush(int slot, int lane, int tiles) {
    sum[kBwdTiles] = tiles;
    if (lane == 0)
      for (int i = 0; i < kBwdPhases; ++i)
        atomicAdd(&bwd_phase_sums[slot][i], (unsigned long long)sum[i]);
    if (threadIdx.x % 128 == 0 && blockIdx.x < kBwdMaxCtas)
      atomicMax(&bwd_cta_stamps[slot][blockIdx.x][1], global_ns());
  }
};

// The sums and stamps since the last call -> sums (kBwdKernels x
// kBwdPhases values), stamps (kBwdKernels x kBwdMaxCtas x 3), then 0.
inline int bwd_phases_take(unsigned long long* sums,
                           unsigned long long* stamps) {
  int err = (int)cudaMemcpyFromSymbol(sums, bwd_phase_sums,
                                      sizeof(bwd_phase_sums));
  if (!err)
    err = (int)cudaMemcpyFromSymbol(stamps, bwd_cta_stamps,
                                    sizeof(bwd_cta_stamps));
  static unsigned long long zero[kBwdKernels][kBwdMaxCtas][3];
  if (!err)
    err = (int)cudaMemcpyToSymbol(bwd_phase_sums, zero,
                                  sizeof(bwd_phase_sums));
  if (!err)
    err = (int)cudaMemcpyToSymbol(bwd_cta_stamps, zero,
                                  sizeof(bwd_cta_stamps));
  return err;
}
#else
__device__ __forceinline__ void cta_begin(int) {}
struct BwdPhases {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int, int, int) {}
};
#endif

// ---------------------------------------------------------------------------
// dK, dV: one CTA a (b, kv head, 64-key tile)
// ---------------------------------------------------------------------------

template <int D>
struct alignas(1024) DkdvSmem {
  // the walk's Q and dO tiles; at the end, consumer 1's partial sums
  bf16 q[kDkdvStages][kBwdN<D> * D];
  bf16 dout[kDkdvStages][kBwdN<D> * D];
  bf16 k[kBwdM * D];
  bf16 v[kBwdM * D];
  // each consumer's lse, then D, of its tile's rows (0 past T),
  // double-buffered: copied by the consumer itself (cp.async) a tile ahead
  float rows[kConsumers][2][2 * kBwdN<D>];
  uint64_t rows_full[kConsumers];  // a consumer's rows have landed
  uint64_t kv_full;  // K and V have landed
  // a stage's Q and dO have landed; they are consumed
  uint64_t full[kDkdvStages], empty[kDkdvStages];
};

// Does the q tile [q0, q_hi] hold a kept pair of the keys [k0, k_hi], or a
// row that keeps no key (and so weighs every key 1/S)?  The last row
// decides emptiness: it only grows with the row.
__device__ __forceinline__ bool dkdv_visit(int q0, int q_hi, int k0, int k_hi,
                                           int s_len, int causal,
                                           int window) {
  const bool pairs = (!causal || k0 <= q_hi) &&
                     (window <= 0 || k_hi > q0 - window);
  return pairs || row_empty(q_hi, s_len, causal, window);
}

// dK, dV (or, by PASS, one of them) of 64 keys: the CTAs key tile major,
// the first (the heaviest under a causal band) first.  Warpgroups 0 and 1
// are the consumers, each taking every other q tile of the walk (the
// group's H/KV heads, the band's tiles) into its own partial sums; the
// first adds the second's at the end, a fixed order.  Warpgroup 2 is the
// producer.  The maps: q and dO over (D, H, T, B) in boxes of kBwdN<D>
// rows, k and v over (D, KV, S, B) in boxes of 64.
template <int D, int PASS, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap q_wide,
                           const __grid_constant__ CUtensorMap q_tail,
                           const __grid_constant__ CUtensorMap do_wide,
                           const __grid_constant__ CUtensorMap do_tail,
                           const __grid_constant__ CUtensorMap k_wide,
                           const __grid_constant__ CUtensorMap k_tail,
                           const __grid_constant__ CUtensorMap v_wide,
                           const __grid_constant__ CUtensorMap v_tail,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int t_len, int s_len, int n_heads, int n_kv,
                           int causal, int window, float scale,
                           float softcap) {
  constexpr int N = kBwdN<D>;
  constexpr int NS = kDkdvStages;
  constexpr bool kDv = PASS != kDkdvOnlyDk, kDk = PASS != kDkdvOnlyDv;
  extern __shared__ unsigned char bwd_smem[];
  DkdvSmem<D>& sm = aligned_stage<DkdvSmem<D>>(bwd_smem);
  cta_begin(PASS);

  const int n_bg = gridDim.x / ((s_len + kBwdM - 1) / kBwdM);
  const int bg = blockIdx.x % n_bg;
  const int b = bg / n_kv, g = bg % n_kv;
  const int k0 = blockIdx.x / n_bg * kBwdM;  // key tiles major
  const int k_hi = min(k0 + kBwdM, s_len) - 1;
  const int rep = n_heads / n_kv;
  const int n_qt = (t_len + N - 1) / N;
  // the walk: the group's heads r, and for each the q tiles qt visited
  auto next_tile = [&](int qt) {
    while (qt < n_qt &&
           !dkdv_visit(qt * N, min(qt * N + N, t_len) - 1, k0, k_hi, s_len,
                       causal, window))
      ++qt;
    return qt;
  };
  const int qt_first = next_tile(0);
  // (r, qt) on to the walk's next tile; r == rep past its end
  auto step = [&](int& r, int& qt) {
    qt = next_tile(qt + 1);
    if (qt >= n_qt) ++r, qt = qt_first;
  };
  const int r_first = qt_first < n_qt ? 0 : rep;  // rep: no tile visited
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int c = 0; c < kConsumers; ++c) mbar_init(&sm.rows_full[c], 128);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 4);  // the consuming warpgroup's warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every TMA load, K and V once, then the
    // walk's Q and dO tiles into the ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&sm.kv_full, (kDk ? 2 : 1) * kBwdM * D * 2);
      load_tile<D, kBwdM>(sm.k, k_wide, k_tail, &sm.kv_full, g, k0, b);
      if (kDk)
        load_tile<D, kBwdM>(sm.v, v_wide, v_tail, &sm.kv_full, g, k0, b);
      int r = r_first, qt = qt_first;
      for (int it = 0; r < rep; ++it, step(r, qt)) {
        const int st = it % NS, q0 = qt * N, h = g * rep + r;
        if (it >= NS) mbar_wait(&sm.empty[st], (it / NS - 1) & 1);
        mbar_expect_tx(&sm.full[st], 2 * N * D * 2);
        load_tile<D, N>(sm.q[st], q_wide, q_tail, &sm.full[st], h, q0, b);
        load_tile<D, N>(sm.dout[st], do_wide, do_tail, &sm.full[st], h, q0,
                        b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tc = lane & 3;  // fragment row, column pair
    const int kp[2] = {k0 + warp * 16 + gr, k0 + warp * 16 + gr + 8};
    const float inv_s = 1.f / (float)s_len;
    const float sl2 = scale * kLog2e;
    // softcap (kCap): P^T = 2^(c log2(e) tanh(s scale / c) - lse log2(e))
    const float cap_in = kCap ? scale / softcap : 0.f;
    const float cap_l2 = kCap ? softcap * kLog2e : 0.f;
    const uint32_t k_tile = smem_addr(sm.k), v_tile = smem_addr(sm.v);

    float dka[kDk ? D / 8 : 1][4], dva[kDv ? D / 8 : 1][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int n = 0; n < (kDk ? D / 8 : 1); ++n) dka[n][e] = 0.f;
#pragma unroll
      for (int n = 0; n < (kDv ? D / 8 : 1); ++n) dva[n][e] = 0.f;
    }
    // this warpgroup's tiles are the walk's cw-th, then every other one:
    // (r, qt) the current, (rn, qtn) the next
    int r = r_first, qt = qt_first;
    if (cw == 1 && r < rep) step(r, qt);
    int rn = r, qtn = qt;
    if (rn < rep) step(rn, qtn);
    if (rn < rep) step(rn, qtn);
    // lse (threads 0 .. N - 1) or D (N .. 2N - 1) of row tid % N of tile
    // (rr, qq) into buffer `buf` by cp.async, arriving on rows_full when
    // it has landed (zeros past T): a tile ahead, so no thread waits on
    // the read (read into registers, its latency showed)
    auto stage_rows = [&](int rr, int qq, int buf) {
      if (tid < (kDk ? 2 : 1) * N) {
        const int row = qq * N + tid % N;
        const bool in = row < t_len;
        const int64_t at =
            ((int64_t)b * n_heads + g * rep + rr) * t_len + (in ? row : 0);
        cp_async4(&sm.rows[cw][buf][tid], (tid < N ? lse : dsum) + at, in);
      }
      cp_async_mbar_arrive(&sm.rows_full[cw]);
    };
    if (r < rep) stage_rows(r, qt, 0);
    BwdPhases ph;
    ph.start();
    mbar_wait(&sm.kv_full, 0);
    int tiles = 0;
    for (int it = cw; r < rep; it += kConsumers) {
      const int st = it % NS, q0 = qt * N;
      const int q_hi = min(q0 + N, t_len) - 1;
      const uint32_t q_tile = smem_addr(sm.q[st]);
      const uint32_t do_tile = smem_addr(sm.dout[st]);
      ph.mark(kBwdLoop);
      mbar_wait(&sm.full[st], (it / NS) & 1);
      ph.mark(kBwdWait);
      // S^T = K Q^T and dP^T = V dO^T (64 keys x N rows)
      float sp[N / 8][4], dp[kDk ? N / 8 : 1][4];
      wgmma_fence();
      issue_ss<D, kBwdM, N>(sp, k_tile, 0, q_tile);
      if constexpr (kDk) issue_ss<D, kBwdM, N>(dp, v_tile, 0, do_tile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sp);
      if constexpr (kDk) fence_operands(dp);
      // this tile's rows landed; every warp of this warpgroup has issued
      // this tile's products, so none still reads the other buffer: the
      // next tile's rows into it.  (A thread's arrival for the next phase
      // only after its wait for this one: else two phases could complete
      // before a slow warp looks, and its parity wait never return.)
      mbar_wait(&sm.rows_full[cw], tiles & 1);
      if (rn < rep) stage_rows(rn, qtn, (tiles + 1) & 1);
      ph.mark(kBwdScores);
      // P^T in place of S^T, dS^T = P^T (dP^T - D) in place of dP^T;
      // masked element by element only where the band's edge crosses
      // the tile (rows past T carry zero Q, dO, lse and D and add 0)
      const bool inside = (!causal || k0 + kBwdM - 1 <= q0) &&
                          (window <= 0 || k0 > q_hi - window);
      const float* lses = sm.rows[cw][tiles & 1];
      const float* dds = lses + N;
      // one copy of the loop a case, so a tile inside the band carries
      // no mask code (predicated into every tile, it doubled the loop)
      auto scores_to_grads = [&](auto masked) {
        constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          float2 l2 =
              *reinterpret_cast<const float2*>(&lses[j * 8 + tc * 2]);
          l2.x *= kLog2e;
          l2.y *= kLog2e;
          float2 dd = {0.f, 0.f};
          if constexpr (kDk)
            dd = *reinterpret_cast<const float2*>(&dds[j * 8 + tc * 2]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lv = (e & 1) ? l2.y : l2.x;
            float x;
            [[maybe_unused]] float dcap;  // the cap's derivative
            if constexpr (kCap) {
              const float th = tanhf(sp[j][e] * cap_in);
              x = fast_exp2(fmaf(cap_l2, th, -lv));
              dcap = 1.f - th * th;
            } else {
              x = fast_exp2(fmaf(sp[j][e], sl2, -lv));
            }
            [[maybe_unused]] const bool empty = lv <= 0.5f * kNegInf;
            if constexpr (kMasked) {
              const int qp = q0 + j * 8 + tc * 2 + (e & 1);
              const bool kept =
                  qp < t_len && keep(qp, kp[e >> 1], causal, window);
              x = kept ? x : (empty ? inv_s : 0.f);
            }
            sp[j][e] = x;
            if constexpr (kDk) {
              float ds = x * (dp[j][e] - ((e & 1) ? dd.y : dd.x));
              if constexpr (kCap) ds *= dcap;
              dp[j][e] = (!kMasked || !empty) ? ds : 0.f;
            }
          }
        }
      };
      if (inside)
        scores_to_grads(std::false_type{});
      else
        scores_to_grads(std::true_type{});
      ph.mark(kBwdSoftmax);
      // dV += P^T dO (two terms), issued before dS^T's terms are made,
      // then dK += dS^T Q: with both sets of terms built first, ptxas
      // serialised the products at D = 128 for want of registers
      if constexpr (kDv) {
        uint32_t ph_hi[N / 16][4], ph_lo[N / 16][4];
        split_terms<N>(sp, ph_hi, ph_lo);
        wgmma_fence();
        issue_rs2<D, N>(dva, ph_hi, ph_lo, do_tile);
        wgmma_commit();
      }
      if constexpr (kDk) {
        uint32_t ds_hi[N / 16][4], ds_lo[N / 16][4];
        split_terms<N>(dp, ds_hi, ds_lo);
        wgmma_fence();
        issue_rs2<D, N>(dka, ds_hi, ds_lo, q_tile);
        wgmma_commit();
      }
      wgmma_wait<0>();
      if constexpr (kDv) fence_operands(dva);
      if constexpr (kDk) fence_operands(dka);
      ph.mark(kBwdGrads);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[st]);
      ++tiles;
      r = rn, qt = qtn;
      if (rn < rep) step(rn, qtn);
      if (rn < rep) step(rn, qtn);
    }

    // consumer 1's partial sums through the Q/dO stages (both walks done:
    // no TMA load or wgmma reads them any more) to consumer 0, which adds
    // them to its own and stores dK * scale and dV, 4 bytes a lane
    float* red = reinterpret_cast<float*>(sm.q);
    constexpr int kDkOff = kDv ? 128 * (D / 2) : 0;
    fence_proxy_async();
    named_barrier(kEpilogueBarrier, 256);
    if (cw == 1) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kDv) red[(n * 4 + e) * 128 + tid] = dva[n][e];
          if constexpr (kDk) red[kDkOff + (n * 4 + e) * 128 + tid] = dka[n][e];
        }
    }
    named_barrier(kEpilogueBarrier, 256);
    if (cw == 0) {
      const int64_t kv_row = (int64_t)n_kv * D;
      const int64_t kv_off = (int64_t)b * s_len * kv_row + (int64_t)g * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = n * 8 + tc * 2;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i0 = (n * 4 + 2 * rr) * 128 + tid;
          if (kp[rr] >= s_len) continue;
          const int64_t at = kv_off + (int64_t)kp[rr] * kv_row + c;
          if constexpr (kDv)
            *reinterpret_cast<uint32_t*>(dv + at) =
                pack_bf16(dva[n][2 * rr] + red[i0],
                          dva[n][2 * rr + 1] + red[i0 + 128]);
          if constexpr (kDk)
            *reinterpret_cast<uint32_t*>(dk + at) =
                pack_bf16((dka[n][2 * rr] + red[kDkOff + i0]) * scale,
                          (dka[n][2 * rr + 1] + red[kDkOff + i0 + 128]) *
                              scale);
        }
      }
    }
    ph.mark(kBwdEpilogue);
    ph.flush(PASS, lane, tiles);
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA a (b, head, 128-row q tile)
// ---------------------------------------------------------------------------

template <int D>
struct alignas(1024) DqSmem {
  bf16 q[kTQ * D];
  bf16 dout[kTQ * D];
  bf16 k[kDqStages][kBwdN<D> * D];
  bf16 v[kDqStages][kBwdN<D> * D];
  uint64_t qo_full;  // Q and dO have landed
  // a stage's K and V have landed; they are consumed
  uint64_t full[kDqStages], empty[kDqStages];
};

// dQ: the CTAs q tile major, the last (the heaviest under a causal band)
// first; warpgroups 0 and 1 are the consumers, 64 rows each, and
// warpgroup 2 the producer (one thread issues every TMA load).  The maps:
// q and dO over (D, H, T, B) in boxes of 128 rows, k and v over
// (D, KV, S, B) in boxes of kBwdN<D>.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_wide,
                         const __grid_constant__ CUtensorMap q_tail,
                         const __grid_constant__ CUtensorMap do_wide,
                         const __grid_constant__ CUtensorMap do_tail,
                         const __grid_constant__ CUtensorMap k_wide,
                         const __grid_constant__ CUtensorMap k_tail,
                         const __grid_constant__ CUtensorMap v_wide,
                         const __grid_constant__ CUtensorMap v_tail,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         bf16* __restrict__ dq, int t_len, int s_len,
                         int n_heads, int n_kv, int causal, int window,
                         float scale, float softcap) {
  constexpr int N = kBwdN<D>;
  constexpr int NS = kDqStages;
  extern __shared__ unsigned char bwd_smem[];
  DqSmem<D>& sm = aligned_stage<DqSmem<D>>(bwd_smem);
  cta_begin(kDqSlot);

  const int n_qt = (t_len + kTQ - 1) / kTQ;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh;
  const int b = bh / n_heads, h = bh % n_heads;
  const int g = h / (n_heads / n_kv);                    // GQA: kv head
  const int q0 = (n_qt - 1 - blockIdx.x / n_bh) * kTQ;   // heaviest first
  const int q_hi = min(q0 + kTQ, t_len) - 1;
  // keys [k_begin, k_end) that some row of the tile keeps (a row with no
  // key in its band gets dQ = 0 and needs none)
  int k_begin = 0, k_end = s_len;
  if (causal) k_end = min(s_len, q_hi + 1);
  if (window > 0) k_begin = max(q0 - window + 1, 0) / N * N;
  const int n_tiles = max(k_end - k_begin + N - 1, 0) / N;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.qo_full, 1);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: Q and dO once, then K and V tile by tile into the ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&sm.qo_full, 2 * kTQ * D * 2);
      load_tile<D, kTQ>(sm.q, q_wide, q_tail, &sm.qo_full, h, q0, b);
      load_tile<D, kTQ>(sm.dout, do_wide, do_tail, &sm.qo_full, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NS;
        const int kb = k_begin + it * N;
        if (it >= NS) mbar_wait(&sm.empty[st], (it / NS - 1) & 1);
        mbar_expect_tx(&sm.full[st], 2 * N * D * 2);
        load_tile<D, N>(sm.k[st], k_wide, k_tail, &sm.full[st], g, kb, b);
        load_tile<D, N>(sm.v[st], v_wide, v_tail, &sm.full[st], g, kb, b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tc = lane & 3;
    const int r0 = cw * kBwdM;  // this warpgroup's rows of the tile
    const int qw0 = q0 + r0, qw_hi = min(qw0 + kBwdM, t_len) - 1;
    const int qp[2] = {qw0 + warp * 16 + gr, qw0 + warp * 16 + gr + 8};
    const int64_t lrow = ((int64_t)b * n_heads + h) * t_len;
    // this thread's two rows: lse (base 2), D, and whether a key is kept
    float l2[2], dr[2];
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = qp[i] < t_len;
      const float l = in ? lse[lrow + qp[i]] : 0.f;
      live[i] = in && l > 0.5f * kNegInf;
      l2[i] = live[i] ? l * kLog2e : 0.f;
      dr[i] = in ? dsum[lrow + qp[i]] : 0.f;
    }
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const float sl2 = scale * kLog2e;
    // softcap (kCap): P = 2^(c log2(e) tanh(s scale / c) - lse log2(e))
    const float cap_in = kCap ? scale / softcap : 0.f;
    const float cap_l2 = kCap ? softcap * kLog2e : 0.f;
    const uint32_t q_tile = smem_addr(sm.q), do_tile = smem_addr(sm.dout);
    BwdPhases ph;
    ph.start();
    mbar_wait(&sm.qo_full, 0);
    int tiles = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NS;
      const int kb = k_begin + it * N;
      const uint32_t k_tile = smem_addr(sm.k[st]);
      ph.mark(kBwdLoop);
      mbar_wait(&sm.full[st], (it / NS) & 1);
      ph.mark(kBwdWait);
      // a tile with no kept pair for this warpgroup's rows adds nothing
      const bool work = qw0 < t_len && (!causal || kb <= qw_hi) &&
                        (window <= 0 || kb + N - 1 > qw0 - window);
      if (work) {
        // S = Q K^T and dP = dO V^T (64 rows x N keys)
        float sp[N / 8][4], dp[N / 8][4];
        wgmma_fence();
        issue_ss<D, kTQ, N>(sp, q_tile, r0, k_tile);
        issue_ss<D, kTQ, N>(dp, do_tile, r0, smem_addr(sm.v[st]));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(sp);
        fence_operands(dp);
        ph.mark(kBwdScores);
        // dS = P (dP - D) (times the cap's derivative) in place of S
        const bool inside = kb + N <= s_len &&
                            (!causal || kb + N - 1 <= qw0) &&
                            (window <= 0 || kb > qw_hi - window);
        // one copy of the loop a case, as in the dK/dV kernel
        auto scores_to_grads = [&](auto masked) {
          constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              float ds;
              if constexpr (kCap) {
                const float th = tanhf(sp[j][e] * cap_in);
                ds = fast_exp2(fmaf(cap_l2, th, -l2[i])) *
                     (dp[j][e] - dr[i]) * (1.f - th * th);
              } else {
                ds = fast_exp2(fmaf(sp[j][e], sl2, -l2[i])) *
                     (dp[j][e] - dr[i]);
              }
              if constexpr (kMasked) {
                const int kp = kb + j * 8 + tc * 2 + (e & 1);
                const bool kept = live[i] && kp < s_len &&
                                  keep(qp[i], kp, causal, window);
                ds = kept ? ds : 0.f;
              }
              sp[j][e] = ds;
            }
          }
        };
        if (inside)
          scores_to_grads(std::false_type{});
        else
          scores_to_grads(std::true_type{});
        ph.mark(kBwdSoftmax);
        // dQ += dS K (two terms)
        uint32_t ds_hi[N / 16][4], ds_lo[N / 16][4];
        split_terms<N>(sp, ds_hi, ds_lo);
        wgmma_fence();
        issue_rs2<D, N>(acc, ds_hi, ds_lo, k_tile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
        ph.mark(kBwdGrads);
        ++tiles;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    }

    // dQ * scale, 4 bytes a lane
    const int64_t q_row = (int64_t)n_heads * D;  // stride between tokens
    bf16* dqb = dq + (int64_t)b * t_len * q_row + (int64_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + tc * 2;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (qp[rr] < t_len)
          *reinterpret_cast<uint32_t*>(dqb + qp[rr] * q_row + c) =
              pack_bf16(acc[n][2 * rr] * scale, acc[n][2 * rr + 1] * scale);
    }
    ph.mark(kBwdEpilogue);
    ph.flush(kDqSlot, lane, tiles);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// q, dO, k and v as 4-D maps (see tensor_map), q and dO in boxes of
// `q_rows` rows, k and v in boxes of `k_rows`: maps[i][0] the 64-column
// boxes, maps[i][1] the tail's (left zero where unused).
template <int D>
int bwd_maps(CUtensorMap (&maps)[4][2], const BwdArgs& a, int q_rows,
             int k_rows) {
  const void* base[4] = {a.q, a.dout, a.k, a.v};
  const int len[4] = {a.t_len, a.t_len, a.s_len, a.s_len};
  const int heads[4] = {a.n_heads, a.n_heads, a.n_kv, a.n_kv};
  const int rows[4] = {q_rows, q_rows, k_rows, k_rows};
  for (int i = 0; i < 4; ++i) {
    int err = 0;
    if (kWide<D> > 0)
      err = tensor_map(&maps[i][0], base[i], a.batch, len[i], heads[i], D,
                       64, rows[i]);
    if (!err && kTail<D> > 0)
      err = tensor_map(&maps[i][1], base[i], a.batch, len[i], heads[i], D,
                       kTail<D>, rows[i]);
    if (err) return err;
  }
  return 0;
}

// the dK/dV kernel as pass PASS
template <int D, int PASS, bool kCap>
int launch_dkdv_bf16(const CUtensorMap (&m)[4][2], const BwdArgs& a) {
  constexpr int smem = bwd_smem_bytes<DkdvSmem<D>>();
  const int err =
      allow_dynamic_smem<flash_bwd_dkdv_bf16_kernel<D, PASS, kCap>, smem>();
  if (err) return err;
  const int grid = a.batch * a.n_kv * ((a.s_len + kBwdM - 1) / kBwdM);
  flash_bwd_dkdv_bf16_kernel<D, PASS, kCap><<<grid, kThreads, smem,
                                              a.stream>>>(
      m[0][0], m[0][1], m[1][0], m[1][1], m[2][0], m[2][1], m[3][0], m[3][1],
      (const float*)a.lse, a.dsum, (bf16*)a.dk, (bf16*)a.dv, a.t_len,
      a.s_len, a.n_heads, a.n_kv, a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

// the bf16 kernels: the dK/dV kernel (its dV and dK passes at D = 256),
// then dQ
template <int D, bool kCap>
int launch_bwd_bf16(const BwdArgs& a) {
  CUtensorMap kv_maps[4][2] = {}, q_maps[4][2] = {};
  int err = bwd_maps<D>(kv_maps, a, kBwdN<D>, kBwdM);
  if (!err) err = bwd_maps<D>(q_maps, a, kTQ, kBwdN<D>);
  if (err) return err;
  if constexpr (D <= 128) {
    err = launch_dkdv_bf16<D, kDkdvBoth, kCap>(kv_maps, a);
  } else {
    err = launch_dkdv_bf16<D, kDkdvOnlyDv, kCap>(kv_maps, a);
    if (!err) err = launch_dkdv_bf16<D, kDkdvOnlyDk, kCap>(kv_maps, a);
  }
  if (err) return err;
  constexpr int smem = bwd_smem_bytes<DqSmem<D>>();
  err = allow_dynamic_smem<flash_bwd_dq_bf16_kernel<D, kCap>, smem>();
  if (err) return err;
  const int grid = a.batch * a.n_heads * ((a.t_len + kTQ - 1) / kTQ);
  const CUtensorMap(&m)[4][2] = q_maps;
  flash_bwd_dq_bf16_kernel<D, kCap><<<grid, kThreads, smem, a.stream>>>(
      m[0][0], m[0][1], m[1][0], m[1][1], m[2][0], m[2][1], m[3][0], m[3][1],
      (const float*)a.lse, a.dsum, (bf16*)a.dq, a.t_len, a.s_len, a.n_heads,
      a.n_kv, a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

// the dot kernel, then the dtype's kernels
template <int D>
int bwd_launch(const BwdArgs& a) {
  const int n_rows = a.batch * a.t_len * a.n_heads;
  const int dot_blocks = (n_rows + 7) / 8;
  if (!a.is_bf16)
    flash_bwd_dot_kernel<float, float><<<dot_blocks, 256, 0, a.stream>>>(
        (const float*)a.o, (const float*)a.dout, a.dsum, n_rows, a.t_len,
        a.n_heads, D);
  else if (a.o_f32)
    flash_bwd_dot_kernel<float, bf16><<<dot_blocks, 256, 0, a.stream>>>(
        (const float*)a.o, (const bf16*)a.dout, a.dsum, n_rows, a.t_len,
        a.n_heads, D);
  else
    flash_bwd_dot_kernel<bf16, bf16><<<dot_blocks, 256, 0, a.stream>>>(
        (const bf16*)a.o, (const bf16*)a.dout, a.dsum, n_rows, a.t_len,
        a.n_heads, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (a.is_bf16)
    return a.softcap > 0.f ? launch_bwd_bf16<D, true>(a)
                           : launch_bwd_bf16<D, false>(a);
  using T = float;
  constexpr int kThreadsF = kTile<D> * (D / kSlice<D>);
  const dim3 g_kv(a.batch * a.n_kv, (a.s_len + kTile<D> - 1) / kTile<D>);
  flash_bwd_dkdv_kernel<D, T><<<g_kv, kThreadsF, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, a.dsum, (T*)a.dk, (T*)a.dv, a.t_len, a.s_len,
      a.n_heads, a.n_kv, a.causal, a.window, a.scale, a.softcap);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 g_q(a.batch * a.n_heads, (a.t_len + kTile<D> - 1) / kTile<D>);
  flash_bwd_dq_kernel<D, T><<<g_q, kThreadsF, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, a.dsum, (T*)a.dq, a.t_len, a.s_len, a.n_heads,
      a.n_kv, a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

}  // namespace
