// Fused Mamba1 selective scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py, `_scan_kernel`, reached
// through `selective_scan` (and `ops.selective_scan`): from a zero state,
//   h_t = exp(delta_t * A) h_{t-1} + (delta_t x_t) B_t,   y_t = sum_N h_t C_t,
// with delta, x (B,T,D), B, C (B,T,N), A (D,N), all float32; it returns
// y (B,T,D) and h_final (B,D,N).
//
// What bounds it on the H100: bytes.  At the falcon-mamba-7b prefill shape
// (B=4, T=512, D=8192, N=16) it must read delta and x (134 MB), write y
// (67 MB) and move B, C, A and h_final (3 MB): 204 MB, 61 us at 3.35 TB/s.
// Its arithmetic, 7 float32 operations per (b, t, d, n) (delta*a, exp, the
// multiply-add into h, (delta x)*B, the multiply-add into y), is 1.88 G,
// 28 us at the 67 TFLOP/s float32 rate.
//
// What the design does: the TPU kernel carries a (d_block, N) state in VMEM
// across a sequential chunk axis.  Here the time loop runs inside the
// thread: one thread owns one (batch, channel) and keeps its N states and
// its row of A in registers for the whole sequence, so the state never
// touches memory until h_final.  Neighbouring threads own neighbouring
// channels, so every load of delta and x and every store of y is coalesced
// across the warp, and each element is read or written once.  The rows B_t
// and C_t serve all D channels of a batch: the CTA stages them in shared
// memory 64 time steps at a time and every thread reads them as broadcasts.
// The exponential is expf (accurate to a few ulp), not __expf.  Nothing is
// written per step except y.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per CTA
constexpr int kTC = 64;        // time steps of B and C staged at once

template <int N>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ delta, const float* __restrict__ x,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ a, float* __restrict__ y,
            float* __restrict__ h_final, int t_len, int d_len) {
  __shared__ float s_b[kTC * N];
  __shared__ float s_c[kTC * N];

  const int bi = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool on = d < d_len;
  float an[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    an[n] = on ? a[(int64_t)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const int64_t seq = (int64_t)bi * t_len;
  const float* dl = delta + seq * d_len + d;
  const float* xl = x + seq * d_len + d;
  float* yl = y + seq * d_len + d;
  const float* bb = bm + seq * N;
  const float* cc = cm + seq * N;

  for (int t0 = 0; t0 < t_len; t0 += kTC) {
    const int tc = min(kTC, t_len - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < tc * N; i += kThreads) {
      s_b[i] = bb[(int64_t)t0 * N + i];
      s_c[i] = cc[(int64_t)t0 * N + i];
    }
    __syncthreads();
    if (!on) continue;
#pragma unroll 4
    for (int tt = 0; tt < tc; ++tt) {
      const int64_t off = (int64_t)(t0 + tt) * d_len;
      const float dt = dl[off];
      const float dx = dt * xl[off];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dt * an[n]) * h[n] + dx * s_b[tt * N + n];
        acc = fmaf(h[n], s_c[tt * N + n], acc);
      }
      yl[off] = acc;
    }
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      h_final[((int64_t)bi * d_len + d) * N + n] = h[n];
  }
}

template <int N>
int launch(const void* delta, const void* x, const void* b, const void* c,
           const void* a, void* y, void* h_final, int batch, int t_len,
           int d_len, cudaStream_t stream) {
  const dim3 grid((d_len + kThreads - 1) / kThreads, batch);
  scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      (const float*)delta, (const float*)x, (const float*)b, (const float*)c,
      (const float*)a, (float*)y, (float*)h_final, t_len, d_len);
  return (int)cudaGetLastError();
}

}  // namespace

#define SCAN_CASE(n)                                                      \
  case n:                                                                 \
    return launch<n>(delta, x, b, c, a, y, h_final, batch, t_len, d_len, \
                     (cudaStream_t)stream);

// delta, x, y (B,T,D); b, c (B,T,N); a (D,N); h_final (B,D,N); float32,
// contiguous, 1 <= N <= 16.  Returns the cudaGetLastError() of the launch.
extern "C" int selective_scan_launch(const void* delta, const void* x,
                                     const void* b, const void* c,
                                     const void* a, void* y, void* h_final,
                                     int batch, int t_len, int d_len,
                                     int d_state, void* stream) {
  switch (d_state) {
    SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
    SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
    SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)
    SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
}
