// Mamba1 selective scan backward for Hopper (sm_90a).
//
// The backward of: selective_scan.cu (`selective_scan_lanes`), the port of
// src/repro/kernels/selective_scan.py `_scan_kernel`.  The JAX package has
// no backward kernel (it differentiates plain jnp); this is how the port
// computes what `jax.value_and_grad` computes there, and kernels/ref.py
// `selective_scan_bwd` is its plain version.  With a_t = exp(delta_t A),
// from the forward h_t = a_t h_{t-1} + delta_t x_t B_t, y_t = C_t . h_t:
//
//   g_t       = dy_t C_t + a_{t+1} g_{t+1},   from g = dh_final
//   dC_t      = sum_D dy_t h_t            dB_t = sum_D g_t delta_t x_t
//   dx_t      = delta_t sum_N g_t B_t     ddelta_t = sum_N g_t (A a_t h_{t-1}
//                                                          + x_t B_t)
//   dA        = sum_{B,T} g_t delta_t a_t h_{t-1}
//
// What bounds it on the H100: at the falcon-mamba-7b train shape (B=4,
// T=512, D=8192, N=16) it must read delta, x and dy (201 MB) and write
// ddelta and dx (134 MB), with B, C, A, dh_final, dB, dC and dA (4 MB):
// 101 us at 3.35 TB/s; against ~12 float32 operations per (b, t, d, n),
// 3.2 GFLOP, 48 us.  The exponentials (one per (b, t, d, n) in each of the
// three sweeps below) take ~65 us a sweep on the special-function units.
//
// What the design does, in this first version: deterministic (no atomics)
// and simple.
// - One thread per (channel, state), NP = N rounded up to a power of two
//   lanes a channel, 32 channels a CTA: the reductions over N (dx, ddelta)
//   are `__shfl_xor_sync` butterflies within a channel's lanes, and those
//   over a warp's channels (dB, dC) a butterfly across them.
// - States for the reverse sweep come from checkpoints: a first forward
//   sweep stores h at the start of every 16-step chunk (scratch of
//   B x T/16 x D x N floats, 67 MB at the falcon shape, against 1.07 GB
//   for every h); the reverse sweep walks the chunks from the last,
//   recomputes the chunk's 16 states from its checkpoint into registers
//   (the loop is unrolled), then runs the chunk backwards.  So the forward
//   recurrence runs twice and the reverse once.
// - Each chunk's delta, x, dy, B_t and C_t are staged in shared memory;
//   dx and ddelta go back through shared memory as coalesced rows.
// - dB and dC sum over all D channels, and dA over the batch: each CTA
//   writes its partial sums (per warp, then summed over the CTA's warps in
//   a fixed order), and a second kernel sums the partials over the CTAs
//   in a fixed order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;      // channels a CTA owns
constexpr int kT = 16;       // time steps a chunk (and checkpoint interval)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NP>
struct Chunk {
  float dt[kT][kCh];
  float x[kT][kCh];
  float dy[kT][kCh];
  float dx[kT][kCh];
  float dd[kT][kCh];
  float b[kT][NP];
  float c[kT][NP];
  float pb[NP][kT][NP];  // per warp: sum over its channels of dB, dC
  float pc[NP][kT][NP];
};

// Steps [t0, t0 + kT) of this CTA's channels; zeros past T, D and N (a
// zero delta leaves h as it is and adds nothing to any gradient).
template <int NP>
__device__ __forceinline__ void stage(Chunk<NP>& s, const float* delta,
                                      const float* x, const float* dy,
                                      const float* bm, const float* cm,
                                      int bi, int t0, int d0, int t_len,
                                      int d_len, int n) {
  constexpr int kThreads = kCh * NP;
  for (int i = threadIdx.x; i < kT * kCh; i += kThreads) {
    const int u = i / kCh, cc = i % kCh;
    const bool in = t0 + u < t_len && d0 + cc < d_len;
    const int64_t at = ((int64_t)bi * t_len + t0 + u) * d_len + d0 + cc;
    s.dt[u][cc] = in ? delta[at] : 0.f;
    s.x[u][cc] = in ? x[at] : 0.f;
    if (dy != nullptr) s.dy[u][cc] = in ? dy[at] : 0.f;
  }
  for (int i = threadIdx.x; i < kT * NP; i += kThreads) {
    const int u = i / NP, nn = i % NP;
    const bool in = t0 + u < t_len && nn < n;
    const int64_t at = ((int64_t)bi * t_len + t0 + u) * n + nn;
    s.b[u][nn] = in ? bm[at] : 0.f;
    if (cm != nullptr) s.c[u][nn] = in ? cm[at] : 0.f;
  }
}

template <int NP>
__global__ void __launch_bounds__(kCh * NP)
scan_bwd_kernel(const float* __restrict__ delta, const float* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dy,
                const float* __restrict__ dh_final,
                float* __restrict__ ddelta, float* __restrict__ dx,
                float* __restrict__ ckpt, float* __restrict__ part_b,
                float* __restrict__ part_c, float* __restrict__ part_a,
                int t_len, int d_len, int n) {
  constexpr int kThreads = kCh * NP;
  __shared__ __align__(16) Chunk<NP> s;
  const int bi = blockIdx.y, cb = blockIdx.x, d0 = cb * kCh;
  const int ch = threadIdx.x / NP, nn = threadIdx.x % NP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = d0 + ch;
  const bool live = d < d_len && nn < n;
  const float av = live ? a[(int64_t)d * n + nn] : 0.f;
  const float a2 = av * kLog2e;
  const int chunks = (t_len + kT - 1) / kT;
  // checkpoint of chunk k: (B, chunks, D, N)
  auto ck = [&](int k) {
    return ckpt + (((int64_t)bi * chunks + k) * d_len + d) * n + nn;
  };

  // forward sweep: h at the start of every chunk
  float h = 0.f;
  for (int k = 0; k < chunks; ++k) {
    if (live) *ck(k) = h;
    __syncthreads();
    stage<NP>(s, delta, x, nullptr, bm, nullptr, bi, k * kT, d0, t_len,
              d_len, n);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      const float dt = s.dt[u][ch];
      h = fmaf(fast_exp2(dt * a2), h, dt * s.x[u][ch] * s.b[u][nn]);
    }
  }

  // reverse sweep
  float carry = (live && dh_final != nullptr)
                    ? dh_final[((int64_t)bi * d_len + d) * n + nn] : 0.f;
  float da = 0.f;
  const int n_cb = gridDim.x;
  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * kT;
    __syncthreads();  // the previous chunk's shared memory is consumed
    stage<NP>(s, delta, x, dy, bm, cm, bi, t0, d0, t_len, d_len, n);
    __syncthreads();
    float hist[kT];  // hist[u] = h_{t0 + u - 1}
    h = live ? *ck(k) : 0.f;
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      hist[u] = h;
      const float dt = s.dt[u][ch];
      h = fmaf(fast_exp2(dt * a2), h, dt * s.x[u][ch] * s.b[u][nn]);
    }
#pragma unroll
    for (int u = kT - 1; u >= 0; --u) {
      const float h_t = u == kT - 1 ? h : hist[u + 1];
      const float dt = s.dt[u][ch], xv = s.x[u][ch], gy = s.dy[u][ch];
      const float bv = s.b[u][nn], cv = s.c[u][nn];
      const float at = fast_exp2(dt * a2);
      const float g = fmaf(gy, cv, carry);
      float v_c = gy * h_t;                         // sum over D
      float v_b = g * dt * xv;                      // sum over D
      float v_x = g * bv;                           // sum over N
      float v_d = g * fmaf(av * at, hist[u], xv * bv);  // sum over N
      da = fmaf(g * dt * at, hist[u], da);
      carry = at * g;
#pragma unroll
      for (int m = 1; m < NP; m <<= 1) {
        v_x += __shfl_xor_sync(0xffffffffu, v_x, m);
        v_d += __shfl_xor_sync(0xffffffffu, v_d, m);
      }
#pragma unroll
      for (int m = NP; m < 32; m <<= 1) {
        v_b += __shfl_xor_sync(0xffffffffu, v_b, m);
        v_c += __shfl_xor_sync(0xffffffffu, v_c, m);
      }
      if (nn == 0) {
        s.dx[u][ch] = dt * v_x;
        s.dd[u][ch] = v_d;
      }
      if (lane < NP) {
        s.pb[warp][u][nn] = v_b;
        s.pc[warp][u][nn] = v_c;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kT * kCh; i += kThreads) {
      const int u = i / kCh, cc = i % kCh;
      if (t0 + u < t_len && d0 + cc < d_len) {
        const int64_t at = ((int64_t)bi * t_len + t0 + u) * d_len + d0 + cc;
        dx[at] = s.dx[u][cc];
        ddelta[at] = s.dd[u][cc];
      }
    }
    // this CTA's dB, dC: its warps' sums in order -> (B, n_cb, T, N)
    constexpr int kWarps = kThreads / 32 > 0 ? kThreads / 32 : 1;
    for (int i = threadIdx.x; i < kT * NP; i += kThreads) {
      const int u = i / NP, m = i % NP;
      if (t0 + u < t_len && m < n) {
        float sb = 0.f, sc = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          sb += s.pb[w][u][m];
          sc += s.pc[w][u][m];
        }
        const int64_t at = (((int64_t)bi * n_cb + cb) * t_len + t0 + u) * n + m;
        part_b[at] = sb;
        part_c[at] = sc;
      }
    }
  }
  if (live) part_a[((int64_t)bi * d_len + d) * n + nn] = da;
}

// dB, dC (B,T,N): partials summed over the n_cb channel blocks in order;
// dA (D,N): partials summed over the batch in order.
__global__ void scan_bwd_reduce_kernel(const float* __restrict__ part_b,
                                       const float* __restrict__ part_c,
                                       const float* __restrict__ part_a,
                                       float* __restrict__ db,
                                       float* __restrict__ dc,
                                       float* __restrict__ da, int batch,
                                       int t_len, int d_len, int n,
                                       int n_cb) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t tn = (int64_t)t_len * n;
  const int64_t n_bc = batch * tn;
  if (i < n_bc) {
    const int64_t bi = i / tn, r = i % tn;
    float sb = 0.f, sc = 0.f;
    for (int c = 0; c < n_cb; ++c) {
      const int64_t at = (bi * n_cb + c) * tn + r;
      sb += part_b[at];
      sc += part_c[at];
    }
    db[i] = sb;
    dc[i] = sc;
  } else if (i < n_bc + (int64_t)d_len * n) {
    const int64_t j = i - n_bc;
    float s = 0.f;
    for (int bi = 0; bi < batch; ++bi) s += part_a[bi * (int64_t)d_len * n + j];
    da[j] = s;
  }
}

template <int NP>
int launch(const float* delta, const float* x, const float* b, const float* c,
           const float* a, const float* dy, const float* dh_final,
           float* ddelta, float* dx, float* db, float* dc, float* da,
           float* ckpt, float* part_b, float* part_c, float* part_a,
           int batch, int t_len, int d_len, int n, cudaStream_t stream) {
  const int n_cb = (d_len + kCh - 1) / kCh;
  scan_bwd_kernel<NP><<<dim3(n_cb, batch), kCh * NP, 0, stream>>>(
      delta, x, b, c, a, dy, dh_final, ddelta, dx, ckpt, part_b, part_c,
      part_a, t_len, d_len, n);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t total = (int64_t)batch * t_len * n + (int64_t)d_len * n;
  scan_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                           stream>>>(part_b, part_c, part_a, db, dc, da,
                                     batch, t_len, d_len, n, n_cb);
  return (int)cudaGetLastError();
}

}  // namespace

// delta, x, dy, ddelta, dx (B,T,D); b, c, db, dc (B,T,N); a, da (D,N);
// dh_final (B,D,N) or null (zeros); float32, contiguous, 1 <= N <= 16.
// Scratch: ckpt (B, ceil(T/16), D, N), part_b and part_c (B, ceil(D/32),
// T, N), part_a (B, D, N).  Two kernels on `stream`; returns the first
// cudaGetLastError() that is not 0.
extern "C" int selective_scan_bwd_launch(
    const void* delta, const void* x, const void* b, const void* c,
    const void* a, const void* dy, const void* dh_final, void* ddelta,
    void* dx, void* db, void* dc, void* da, void* ckpt, void* part_b,
    void* part_c, void* part_a, int batch, int t_len, int d_len,
    int d_state, void* stream) {
#define SCAN_BWD(np)                                                        \
  return launch<np>((const float*)delta, (const float*)x, (const float*)b,  \
                    (const float*)c, (const float*)a, (const float*)dy,     \
                    (const float*)dh_final, (float*)ddelta, (float*)dx,     \
                    (float*)db, (float*)dc, (float*)da, (float*)ckpt,       \
                    (float*)part_b, (float*)part_c, (float*)part_a, batch,  \
                    t_len, d_len, d_state, (cudaStream_t)stream)
  if (d_state < 1 || d_state > 16) return (int)cudaErrorInvalidValue;
  if (d_state == 1) SCAN_BWD(1);
  if (d_state == 2) SCAN_BWD(2);
  if (d_state <= 4) SCAN_BWD(4);
  if (d_state <= 8) SCAN_BWD(8);
  SCAN_BWD(16);
#undef SCAN_BWD
}
