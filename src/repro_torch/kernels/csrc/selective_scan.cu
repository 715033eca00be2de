// Fused Mamba1 selective scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py, `_scan_kernel`, reached
// through `selective_scan` (and `ops.selective_scan`): from a zero state,
//   h_t = exp(delta_t * A) h_{t-1} + (delta_t x_t) B_t,   y_t = sum_N h_t C_t,
// with delta, x (B,T,D), B, C (B,T,N), A (D,N), all float32; it returns
// y (B,T,D) and h_final (B,D,N).
//
// What bounds it on the H100: bytes, then the exponential.  At the
// falcon-mamba-7b prefill shape (B=4, T=512, D=8192, N=16) it must read
// delta and x (134 MB), write y (67 MB) and move B, C, A and h_final
// (3 MB): 204 MB, 61 us at 3.35 TB/s.  It takes one exponential per
// (b, t, d, n), 268 M of them; the special-function unit does 16 a clock
// per SM, so on 132 SMs they take 64-72 us (at 1.98-1.75 GHz): about the
// byte bound.  The other float32 work (delta*a, the multiply-add into h,
// (delta x)*B, the multiply-add into y) and the shared-memory reads of
// B_t and C_t come near that too.
//
// What the design does: the time loop stays sequential inside each thread
// (a parallel scan over time would cost log T more exponentials), but a
// channel's N states are split over L neighbouring lanes (4 lanes of 4
// states at N = 16), and each lane works on 2 neighbouring channels, whose
// B_t and C_t are the same: it reads them once for both, and twice the
// threads of one-thread-per-channel are in flight.  A CTA owns 64
// channels of one sequence.  delta and x come in chunks of 16 time steps x
// 64 channels, with the chunk's B_t and C_t rows, through a 3-stage ring
// in shared memory filled by `cp.async`: two chunks are in flight while
// the current one runs.  Each lane sums its states' h * C; the L partial
// sums of L consecutive steps are reduced together by a butterfly of
// `__shfl_xor_sync` that leaves lane l holding y of step l (L - 1 shuffles
// per L steps): y = (p0 + p2) + (p1 + p3) at L = 4.  y goes back into the
// chunk's x slot, then out as coalesced rows.  Steps past T and channels
// past D are zero-filled (delta = 0 leaves h as it is) and never stored.
//
// The exponential is exp2(delta * a') on the special-function unit
// (`ex2.approx.ftz`, about 2 ulp), with a' = a * log2(e) prescaled once in
// registers.  Against expf it adds the rounding of a' and of the product:
// a relative error of about |delta * a| * 2^-23 * ln 2 + 2^-22 per factor,
// 2e-6 at |delta * a| = 20 (where the factor is already 2e-9), far below
// the 1e-4 tolerance the kernel is held to.
//
// The training forward (`selective_scan_ckpt_launch`, the kCkpt
// instantiations) also writes h at the start of every kCkptSteps-step
// interval into ckpt (B, ceil(T/kCkptSteps), D, N), interval 0's the zero
// state: the states are in registers there anyway, and the backward
// (selective_scan_bwd.cu) starts each interval's recompute from them
// instead of making its own forward sweep.  The prefill (no grad) keeps
// the launch without them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;  // channels a CTA owns
constexpr int kPerThread = 2;  // channels a lane works on (sharing B, C)
constexpr int kSteps = 16;     // time steps a ring stage holds
constexpr int kStages = 3;
constexpr int kCkptSteps = 8;  // the training forward's checkpoint interval
static_assert(kSteps % kCkptSteps == 0 && kCkptSteps % 4 == 0,
              "an interval starts at a step group of every lane split");
constexpr float kLog2e = 1.4426950408889634f;

// lanes per channel: 4 from N = 10 (every lane keeps a state), 2 from 5
__host__ __device__ constexpr int lanes_for(int n) {
  return n >= 10 ? 4 : (n >= 5 ? 2 : 1);
}
__host__ __device__ constexpr int threads_for(int n) {
  return kChannels / kPerThread * lanes_for(n);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// global -> shared without registers; zero-filled when !in (the source is
// then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
struct Stage {
  float dt[kSteps][kChannels];
  float x[kSteps][kChannels];  // y of the chunk once it is consumed
  float b[kSteps][N];
  float c[kSteps][N];
};

// K consecutive floats of shared memory, K-aligned, as wide loads
template <int K>
__device__ __forceinline__ void load_k(float (&v)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + k);
      v[k] = q.x, v[k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}

// A lane's S states' entries of a shared row of N: wide loads where the
// lanes tile the row exactly (then n0 and N are multiples of S); else
// entries past N are not read (they stay 0).
template <int S, int N>
__device__ __forceinline__ void load_row(float (&v)[S], const float* row,
                                         int n0) {
  if constexpr (lanes_for(N) * S == N) {
    load_k<S>(v, row + n0);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = n0 + s < N ? row[n0 + s] : 0.f;
  }
}

template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2)
      *reinterpret_cast<float2*>(p + k) = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] = v[k];
  }
}

// Chunk `chunk` (steps chunk*kSteps ...) of this CTA's channels into `st`.
template <int N, bool kVec>
__device__ __forceinline__ void load_chunk(
    Stage<N>& st, const float* __restrict__ delta, const float* __restrict__ x,
    const float* __restrict__ bm, const float* __restrict__ cm, bool vec_bc,
    int bi, int chunk, int d0, int t_len, int d_len) {
  constexpr int kThreads = threads_for(N);
  const int t0 = chunk * kSteps;
  const int64_t seq = (int64_t)bi * t_len;
  if constexpr (kVec) {  // d_len % 4 == 0: rows of 16-B pieces
    constexpr int kPieces = kChannels / 4;
    for (int i = threadIdx.x; i < kSteps * kPieces; i += kThreads) {
      const int tt = i / kPieces, d = d0 + (i % kPieces) * 4;
      const bool in = t0 + tt < t_len && d < d_len;
      const int64_t off = in ? (seq + t0 + tt) * d_len + d : 0;
      cp_async16(&st.dt[tt][d - d0], delta + off, in);
      cp_async16(&st.x[tt][d - d0], x + off, in);
    }
  } else {
    for (int i = threadIdx.x; i < kSteps * kChannels; i += kThreads) {
      const int tt = i / kChannels, d = d0 + i % kChannels;
      const bool in = t0 + tt < t_len && d < d_len;
      const int64_t off = in ? (seq + t0 + tt) * d_len + d : 0;
      cp_async4(&st.dt[tt][d - d0], delta + off, in);
      cp_async4(&st.x[tt][d - d0], x + off, in);
    }
  }
  // B_t, C_t: kSteps rows of N contiguous floats
  if (N % 4 == 0 && vec_bc) {
    for (int i = threadIdx.x; i < kSteps * N / 4; i += kThreads) {
      const int tt = (4 * i) / N;
      const bool in = t0 + tt < t_len;
      const int64_t off = in ? (seq + t0) * N + 4 * i : 0;
      cp_async16(&st.b[0][0] + 4 * i, bm + off, in);
      cp_async16(&st.c[0][0] + 4 * i, cm + off, in);
    }
  } else {
    for (int i = threadIdx.x; i < kSteps * N; i += kThreads) {
      const bool in = t0 + i / N < t_len;
      const int64_t off = in ? (seq + t0) * N + i : 0;
      cp_async4(&st.b[0][0] + i, bm + off, in);
      cp_async4(&st.c[0][0] + i, cm + off, in);
    }
  }
}

// The L partial sums p[0..L) of L consecutive steps, held by the L lanes of
// a channel, reduced so that lane l returns the sum for step l.
template <int L>
__device__ __forceinline__ float reduce_steps(float (&p)[L], int lane) {
#pragma unroll
  for (int m = L / 2; m >= 1; m >>= 1) {
    const bool upper = (lane & m) != 0;
#pragma unroll
    for (int k = 0; k < m; ++k) {
      const float send = upper ? p[k] : p[k + m];
      const float keep = upper ? p[k + m] : p[k];
      p[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return p[0];
}

// Up to 128 registers a thread: at the falcon-mamba shape a launch puts 4
// CTAs on an SM anyway (512 CTAs on 132 SMs), and the room lets the
// compiler keep more of the next steps' loads in flight.
template <int N, bool kVec, bool kCkpt>
__global__ void __launch_bounds__(threads_for(N), 512 / threads_for(N))
selective_scan_lanes(const float* __restrict__ delta,
                     const float* __restrict__ x,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ a, float* __restrict__ y,
                     float* __restrict__ h_final, float* __restrict__ ckpt,
                     bool vec_bc, int t_len, int d_len) {
  constexpr int L = lanes_for(N);
  constexpr int S = (N + L - 1) / L;  // states a lane keeps
  constexpr int K = kPerThread;
  constexpr bool kExact = L * S == N;  // no lane keeps a padding state
  __shared__ __align__(16) Stage<N> ring[kStages];

  const int bi = blockIdx.y, d0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / L * K, lane = threadIdx.x % L;
  const int n0 = lane * S;
  float a2[K][S], h[K][S];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int d = d0 + ch + k;
      a2[k][s] = (d < d_len && n0 + s < N)
                     ? a[(int64_t)d * N + n0 + s] * kLog2e : 0.f;
      h[k][s] = 0.f;
    }
  }

  const int chunks = (t_len + kSteps - 1) / kSteps;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks)
      load_chunk<N, kVec>(ring[c], delta, x, bm, cm, vec_bc, bi, c, d0, t_len,
                          d_len);
    cp_async_commit();
  }
  const int64_t seq = (int64_t)bi * t_len;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; the stage refilled below is free
    if (c + kStages - 1 < chunks)
      load_chunk<N, kVec>(ring[(c + kStages - 1) % kStages], delta, x, bm, cm,
                          vec_bc, bi, c + kStages - 1, d0, t_len, d_len);
    cp_async_commit();

    Stage<N>& st = ring[c % kStages];
#pragma unroll
    for (int g = 0; g < kSteps; g += L) {
      if constexpr (kCkpt) {
        const int t = c * kSteps + g;
        if (g % kCkptSteps == 0 && t < t_len) {
          const int n_int = (t_len + kCkptSteps - 1) / kCkptSteps;
          float* row = ckpt + (((int64_t)bi * n_int + t / kCkptSteps) *
                                   d_len + d0 + ch) * N;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (d0 + ch + k >= d_len) continue;
            if constexpr (kExact) {
              store_k<S>(row + k * N + n0, h[k]);
            } else {
#pragma unroll
              for (int s = 0; s < S; ++s)
                if (n0 + s < N) row[k * N + n0 + s] = h[k][s];
            }
          }
        }
      }
      float p[K][L];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const int tt = g + u;
        float dt[K], xv[K], bv[S], cv[S];
        load_k<K>(dt, &st.dt[tt][ch]);
        load_k<K>(xv, &st.x[tt][ch]);
        load_row<S, N>(bv, st.b[tt], n0);
        load_row<S, N>(cv, st.c[tt], n0);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float dx = dt[k] * xv[k];
          float acc = 0.f;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (kExact || n0 + s < N) {
              h[k][s] = fmaf(fast_exp2(dt[k] * a2[k][s]), h[k][s],
                             dx * bv[s]);
              acc = fmaf(h[k][s], cv[s], acc);
            }
          }
          p[k][u] = acc;
        }
      }
      float yv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) yv[k] = reduce_steps<L>(p[k], lane);
      __syncwarp();  // every lane has read x of steps g .. g + L - 1
      store_k<K>(&st.x[g + lane][ch], yv);
    }
    __syncthreads();
    // the chunk's y, kSteps rows of this CTA's channels, out coalesced
    const int t0 = c * kSteps;
    constexpr int kThreads = threads_for(N);
    if constexpr (kVec) {
      constexpr int kPieces = kChannels / 4;
      for (int i = threadIdx.x; i < kSteps * kPieces; i += kThreads) {
        const int tt = i / kPieces, dd = d0 + (i % kPieces) * 4;
        if (t0 + tt < t_len && dd < d_len)
          *reinterpret_cast<float4*>(y + (seq + t0 + tt) * d_len + dd) =
              *reinterpret_cast<const float4*>(&st.x[tt][dd - d0]);
      }
    } else {
      for (int i = threadIdx.x; i < kSteps * kChannels; i += kThreads) {
        const int tt = i / kChannels, dd = d0 + i % kChannels;
        if (t0 + tt < t_len && dd < d_len)
          y[(seq + t0 + tt) * d_len + dd] = st.x[tt][dd - d0];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + ch + k;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (d < d_len && n0 + s < N)
        h_final[((int64_t)bi * d_len + d) * N + n0 + s] = h[k][s];
  }
}

template <int N, bool kCkpt>
int launch(const void* delta, const void* x, const void* b, const void* c,
           const void* a, void* y, void* h_final, void* ckpt, int batch,
           int t_len, int d_len, cudaStream_t stream) {
  const dim3 grid((d_len + kChannels - 1) / kChannels, batch);
  const int threads = threads_for(N);
  const bool vec = d_len % 4 == 0 && (uintptr_t)delta % 16 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const bool vec_bc = (uintptr_t)b % 16 == 0 && (uintptr_t)c % 16 == 0;
  auto kernel = vec ? selective_scan_lanes<N, true, kCkpt>
                    : selective_scan_lanes<N, false, kCkpt>;
  kernel<<<grid, threads, 0, stream>>>(
      (const float*)delta, (const float*)x, (const float*)b, (const float*)c,
      (const float*)a, (float*)y, (float*)h_final, (float*)ckpt, vec_bc,
      t_len, d_len);
  return (int)cudaGetLastError();
}

}  // namespace

#define SCAN_CASE(n)                                                      \
  case n:                                                                 \
    return ckpt == nullptr                                                \
               ? launch<n, false>(delta, x, b, c, a, y, h_final, nullptr, \
                                  batch, t_len, d_len,                    \
                                  (cudaStream_t)stream)                   \
               : launch<n, true>(delta, x, b, c, a, y, h_final, ckpt,     \
                                 batch, t_len, d_len, (cudaStream_t)stream);
#define SCAN_CASES                                                        \
  SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)                     \
  SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)                     \
  SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)                  \
  SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)

// delta, x, y (B,T,D); b, c (B,T,N); a (D,N); h_final (B,D,N); float32,
// contiguous, 1 <= N <= 16.  Returns the cudaGetLastError() of the launch.
extern "C" int selective_scan_launch(const void* delta, const void* x,
                                     const void* b, const void* c,
                                     const void* a, void* y, void* h_final,
                                     int batch, int t_len, int d_len,
                                     int d_state, void* stream) {
  void* const ckpt = nullptr;
  switch (d_state) {
    SCAN_CASES
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The training forward: as selective_scan_launch, and ckpt
// (B, ceil(T/8), D, N) float32, contiguous: h at the start of every
// 8-step interval (kCkptSteps), the first the zero state.
extern "C" int selective_scan_ckpt_launch(const void* delta, const void* x,
                                          const void* b, const void* c,
                                          const void* a, void* y,
                                          void* h_final, void* ckpt,
                                          int batch, int t_len, int d_len,
                                          int d_state, void* stream) {
  if (ckpt == nullptr) return (int)cudaErrorInvalidValue;
  switch (d_state) {
    SCAN_CASES
    default:
      return (int)cudaErrorInvalidValue;
  }
}
