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
// 3.2 GFLOP, 48 us.  An exponential per (b, t, d, n) and sweep takes
// ~65-72 us on the special-function units (16 a clock an SM).
//
// What the design does.  The first version (one thread per (channel,
// state), 32 channels a CTA) spent its time on 10 shuffles, ~6 shared
// loads and 3 exponentials per (b, t, d, n) and on 134 MB of dB/dC
// partials.  Here, deterministic (no atomics; every sum in a fixed order):
// - States over lanes, as the forward: a channel's N states are split over
//   L = 1, 2 or 4 neighbouring lanes (4 lanes of 4 states at N = 16), and
//   each lane works on 2 neighbouring channels that share its reads of B_t
//   and C_t.  A CTA owns 128 channels of one sequence (256 threads at
//   N = 16).
// - Sums over N (dx, ddelta): each lane sums its states, then the 4 values
//   (dx and ddelta of its 2 channels) go through a transposing butterfly
//   over the channel's L lanes, each step halving what a lane carries: 3
//   shuffles a lane and step at L = 4, and lane l ends with value l.
// - Sums over channels (dB, dC): each lane adds its 2 channels in
//   registers, then its 2S values (dB and dC of its states) go through a
//   transposing butterfly over the warp's channel pairs (7 shuffles a lane
//   and step at N = 16, one value each at the end), the warps' sums are
//   added in warp order through shared memory, and a second kernel adds
//   the CTAs' partials in CTA order: B x ceil(D/128) x T x N of them, 4x
//   fewer than at 32 channels a CTA (33.5 MB of traffic at the falcon
//   shape, from 134 MB).  About 1.25 shuffles per (b, t, d, n) in all.
// - Checkpoints: a first forward sweep stores h at the start of every
//   kSteps-step interval (the last interval's start stays in registers);
//   the reverse sweep walks the intervals from the last, recomputes each
//   kSub-step part's states and factors a_t from its checkpoint into
//   registers (the part's steps are unrolled) and runs the part backwards
//   with the kept a_t: one exponential fewer per (b, t, d, n) in the
//   reverse step.  At kSub = 8 a lane keeps 2 x 64 floats of states and
//   factors, about what 255 registers a thread allow beside the rest;
//   with kSteps = 2 kSub the later part's recompute first runs through the
//   earlier part's steps without keeping them, so 2.5 exponentials per
//   (b, t, d, n) in all (3 before) and 67 MB of checkpoints; kSteps = kSub
//   would need 2 and 134 MB.
// - Each interval's delta, x, dy, B_t, C_t rows and checkpoint are staged
//   with `cp.async` into one of two buffers in (dynamic) shared memory
//   while the previous interval computes; dx and ddelta go back into the
//   x and dy slots of the step they were read from and out as coalesced
//   rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_helpers.cuh"

namespace {

constexpr int kChannels = 128;  // channels a CTA owns
constexpr int kPerThread = 2;   // channels a lane works on (sharing B, C)
constexpr int kSteps = 16;      // time steps a checkpoint interval holds
constexpr int kSub = 8;         // steps whose states a lane keeps at once
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kSteps % kSub == 0, "an interval is whole parts");

// lanes per channel: 4 from N = 10, 2 from 5 (as the forward)
__host__ __device__ constexpr int lanes_for(int n) {
  return n >= 10 ? 4 : (n >= 5 ? 2 : 1);
}
__host__ __device__ constexpr int threads_for_lanes(int l) {
  return kChannels / kPerThread * l;
}
__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}
__host__ __device__ constexpr int pow2_at_least(int n) {
  return 1 << log2i(2 * n - 1);
}

// One interval: rows of the CTA's channels, then the B_t and C_t rows of
// N floats each (LS >= N of room), then h at the interval's start for the
// CTA's channels, (channel, state).
template <int LS>
struct Stage {
  float dt[kSteps][kChannels];
  float x[kSteps][kChannels];   // dx once consumed
  float dy[kSteps][kChannels];  // ddelta once consumed
  float b[kSteps * LS];
  float c[kSteps * LS];
  float h0[kChannels * LS];
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

// A lane's S states' entries of a row of N: wide loads where the lanes tile
// the row exactly (then n0 and N are multiples of S); else entries past N
// are not read (they stay 0).
template <int S>
__device__ __forceinline__ void load_row(float (&v)[S], const float* row,
                                         int n0, int n, bool exact) {
  if (exact) {
    load_k<S>(v, row + n0);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = n0 + s < n ? row[n0 + s] : 0.f;
  }
}

// Interval `chunk` (steps chunk*kSteps ...) of the CTA's channels into
// `st`: delta, x and B_t always; dy and C_t for the reverse sweep (kFull);
// the checkpoint from `ck` when it is given (zeros when `ck_in` is false).
template <int L, int LS, bool kFull>
__device__ __forceinline__ void load_chunk(
    Stage<LS>& st, const float* __restrict__ delta,
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ ck, bool ck_in, bool vec, bool vec_bc,
    bool vec_ck, int bi, int chunk, int d0, int t_len, int d_len, int n) {
  constexpr int kThreads = threads_for_lanes(L);
  const int t0 = chunk * kSteps;
  const int64_t seq = (int64_t)bi * t_len;
  if (vec) {  // d_len % 4 == 0: rows of 16-B pieces
    constexpr int kPieces = kChannels / 4;
    for (int i = threadIdx.x; i < kSteps * kPieces; i += kThreads) {
      const int tt = i / kPieces, d = d0 + (i % kPieces) * 4;
      const bool in = t0 + tt < t_len && d < d_len;
      const int64_t off = in ? (seq + t0 + tt) * d_len + d : 0;
      cp_async16(&st.dt[tt][d - d0], delta + off, in);
      cp_async16(&st.x[tt][d - d0], x + off, in);
      if (kFull) cp_async16(&st.dy[tt][d - d0], dy + off, in);
    }
  } else {
    for (int i = threadIdx.x; i < kSteps * kChannels; i += kThreads) {
      const int tt = i / kChannels, d = d0 + i % kChannels;
      const bool in = t0 + tt < t_len && d < d_len;
      const int64_t off = in ? (seq + t0 + tt) * d_len + d : 0;
      cp_async4(&st.dt[tt][d - d0], delta + off, in);
      cp_async4(&st.x[tt][d - d0], x + off, in);
      if (kFull) cp_async4(&st.dy[tt][d - d0], dy + off, in);
    }
  }
  // B_t, C_t: kSteps rows of n contiguous floats
  if (vec_bc) {  // n % 4 == 0
    for (int i = threadIdx.x; i < kSteps * n / 4; i += kThreads) {
      const bool in = t0 + 4 * i / n < t_len;
      const int64_t off = in ? (seq + t0) * n + 4 * i : 0;
      cp_async16(&st.b[4 * i], bm + off, in);
      if (kFull) cp_async16(&st.c[4 * i], cm + off, in);
    }
  } else {
    for (int i = threadIdx.x; i < kSteps * n; i += kThreads) {
      const bool in = t0 + i / n < t_len;
      const int64_t off = in ? (seq + t0) * n + i : 0;
      cp_async4(&st.b[i], bm + off, in);
      if (kFull) cp_async4(&st.c[i], cm + off, in);
    }
  }
  // the checkpoint: (channel, state) of the CTA's channels, contiguous
  if (ck != nullptr) {
    const int n_f = min(kChannels, d_len - d0) * n;
    if (vec_ck) {  // (d_len * n) % 4 == 0
      for (int i = threadIdx.x; i < kChannels * n / 4; i += kThreads) {
        const bool in = ck_in && 4 * i < n_f;
        cp_async16(&st.h0[4 * i], ck + (in ? 4 * i : 0), in);
      }
    } else {
      for (int i = threadIdx.x; i < kChannels * n; i += kThreads) {
        const bool in = ck_in && i < n_f;
        cp_async4(&st.h0[i], ck + (in ? i : 0), in);
      }
    }
  }
}

// p[0 .. Q) of each lane summed over the lanes whose ids differ in the bits
// of masks M, M/2, ..., LO, in that order (a fixed order).  While a lane
// carries more than one value, each step halves them: the lane whose bit
// is set keeps the upper half and adds its partner's; then plain
// butterflies.  See Held for what a lane holds afterwards.
template <int C, int M, int LO, int Q>
__device__ __forceinline__ void reduce_lanes(float (&p)[Q], int wl) {
  if constexpr (M >= LO && M >= 1) {
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const bool upper = (wl & M) != 0;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = upper ? p[k] : p[k + H];
        const float keep = upper ? p[k + H] : p[k];
        p[k] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      reduce_lanes<H, M / 2, LO>(p, wl);
    } else {
      p[0] += __shfl_xor_sync(0xffffffffu, p[0], M);
      reduce_lanes<1, M / 2, LO>(p, wl);
    }
  }
}

// After reduce_lanes<Q, HI, LO>, lane wl holds the sums of the indices
// base(wl) .. base(wl) + kCount - 1 in p[0 .. kCount), and of the lanes
// holding the same sums, the one with own(wl) writes them.
template <int Q, int HI, int LO>
struct Held {
  static constexpr int kBits = HI >= LO ? log2i(HI / LO) + 1 : 0;
  static constexpr int kHalvings = log2i(Q) < kBits ? log2i(Q) : kBits;
  static constexpr int kCount = Q >> kHalvings;
  __device__ static int bits(int wl) {
    return (wl / LO) & ((1 << kBits) - 1);
  }
  __device__ static int base(int wl) {
    return (bits(wl) >> (kBits - kHalvings)) * kCount;
  }
  __device__ static bool own(int wl) {
    return (bits(wl) & ((1 << (kBits - kHalvings)) - 1)) == 0;
  }
};

// L lanes a channel, S states a lane (N <= L S: states past N are padding
// with a = B = C = 0, whose h and g stay 0).
template <int L, int S>
__global__ void __launch_bounds__(threads_for_lanes(L), 4 / L)
scan_bwd_lanes(const float* __restrict__ delta, const float* __restrict__ x,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ a, const float* __restrict__ dy,
               const float* __restrict__ dh_final,
               float* __restrict__ ddelta, float* __restrict__ dx,
               float* __restrict__ ckpt, float* __restrict__ part_b,
               float* __restrict__ part_c, float* __restrict__ part_a,
               bool vec, bool vec_bc, bool vec_ck, int t_len, int d_len,
               int n) {
  constexpr int LS = L * S;
  constexpr int K = kPerThread;
  constexpr int kThreads = threads_for_lanes(L);
  constexpr int kWarps = kThreads / 32;
  constexpr int SP = pow2_at_least(S);
  constexpr int Q = 2 * SP;  // dB and dC of a lane's states, padded
  using HeldN = Held<2 * K, L / 2, 1>;   // dx, ddelta over a channel's lanes
  using HeldD = Held<Q, 16, L>;          // dB, dC over a warp's channels
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<LS>* st = reinterpret_cast<Stage<LS>*>(smem);
  float* pb = reinterpret_cast<float*>(smem + 2 * sizeof(Stage<LS>));
  // pb[warp][step][2n]: the warp's dB (then dC) sums of each step

  const int bi = blockIdx.y, cb = blockIdx.x, d0 = cb * kChannels;
  const int n_cb = gridDim.x;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int ch = threadIdx.x / L * K, lane = threadIdx.x % L;
  const int n0 = lane * S;
  const bool exact = LS == n;  // no lane keeps a padding state
  float a2[K][S], h[K][S];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int d = d0 + ch + k;
      a2[k][s] = (d < d_len && n0 + s < n)
                     ? a[(int64_t)d * n + n0 + s] * kLog2e : 0.f;
      h[k][s] = 0.f;
    }
  }
  const int chunks = (t_len + kSteps - 1) / kSteps;
  auto ck = [&](int c) {  // checkpoint of interval c: (B, chunks, D, N)
    return ckpt + (((int64_t)bi * chunks + c) * d_len + d0) * n;
  };
  // one forward step of the recurrence from staged step tt
  auto forward = [&](const Stage<LS>& s_, int tt, float (&e)[K][S]) {
    float dt[K], xv[K], bv[S];
    load_k<K>(dt, &s_.dt[tt][ch]);
    load_k<K>(xv, &s_.x[tt][ch]);
    load_row<S>(bv, &s_.b[tt * n], n0, n, exact);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float dxk = dt[k] * xv[k];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        e[k][s] = fast_exp2(dt[k] * a2[k][s]);
        h[k][s] = fmaf(e[k][s], h[k][s], dxk * bv[s]);
      }
    }
  };

  // forward sweep over intervals 0 .. chunks - 2: h at each one's start
  if (chunks > 1)
    load_chunk<L, LS, false>(st[0], delta, x, nullptr, bm, nullptr, nullptr,
                             false, vec, vec_bc, vec_ck, bi, 0, d0, t_len,
                             d_len, n);
  cp_async_commit();
  for (int c = 0; c + 1 < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // interval c landed; the other buffer is free
    if (c + 2 < chunks)
      load_chunk<L, LS, false>(st[(c + 1) & 1], delta, x, nullptr, bm,
                               nullptr, nullptr, false, vec, vec_bc, vec_ck,
                               bi, c + 1, d0, t_len, d_len, n);
    cp_async_commit();
    if (c > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (d0 + ch + k < d_len && n0 + s < n)
            ck(c)[(ch + k) * n + n0 + s] = h[k][s];
    }
    const Stage<LS>& s_ = st[c & 1];
#pragma unroll 4
    for (int tt = 0; tt < kSteps; ++tt) {
      float e[K][S];
      forward(s_, tt, e);
    }
  }
  __syncthreads();  // the forward sweep's buffers are consumed

  // reverse sweep, from the last interval; its start state goes to the
  // stage from these registers, interval 0's is zero-filled, the others'
  // are the checkpoints
  float carry[K][S], da[K][S];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int d = d0 + ch + k;
      const bool live = d < d_len && n0 + s < n;
      carry[k][s] = (live && dh_final != nullptr)
                        ? dh_final[((int64_t)bi * d_len + d) * n + n0 + s]
                        : 0.f;
      da[k][s] = 0.f;
      if (n0 + s < n) st[0].h0[(ch + k) * n + n0 + s] = h[k][s];
    }
  }
  load_chunk<L, LS, true>(st[0], delta, x, dy, bm, cm, nullptr, false, vec,
                          vec_bc, vec_ck, bi, chunks - 1, d0, t_len, d_len,
                          n);
  cp_async_commit();
  for (int it = 0; it < chunks; ++it) {
    const int c = chunks - 1 - it, t0 = c * kSteps;
    cp_async_wait<0>();
    __syncthreads();  // interval c landed; the other buffer is free
    if (c > 0)
      load_chunk<L, LS, true>(st[(it + 1) & 1], delta, x, dy, bm, cm,
                              ck(c - 1), c - 1 > 0, vec, vec_bc, vec_ck, bi,
                              c - 1, d0, t_len, d_len, n);
    cp_async_commit();
    Stage<LS>& s_ = st[it & 1];
    float* pw = pb + warp * kSteps * 2 * n;

#pragma unroll 1
    for (int j = kSteps / kSub - 1; j >= 0; --j) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int s = 0; s < S; ++s)
          h[k][s] = n0 + s < n ? s_.h0[(ch + k) * n + n0 + s] : 0.f;
#pragma unroll 1
      for (int tt = 0; tt < j * kSub; ++tt) {  // to the part's start
        float e[K][S];
        forward(s_, tt, e);
      }
      float hist[kSub + 1][K][S], at[kSub][K][S];  // h_{t-1}, a_t
#pragma unroll
      for (int u = 0; u <= kSub; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int s = 0; s < S; ++s) hist[u][k][s] = h[k][s];
        if (u < kSub) forward(s_, j * kSub + u, at[u]);
      }
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int tt = j * kSub + u;
        float dt[K], xv[K], gy[K], bv[S], cv[S];
        load_k<K>(dt, &s_.dt[tt][ch]);
        load_k<K>(xv, &s_.x[tt][ch]);
        load_k<K>(gy, &s_.dy[tt][ch]);
        load_row<S>(bv, &s_.b[tt * n], n0, n, exact);
        load_row<S>(cv, &s_.c[tt * n], n0, n, exact);
        float pbc[Q];  // this lane's dB then dC, over its two channels
#pragma unroll
        for (int q = 0; q < Q; ++q) pbc[q] = 0.f;
        float pn[2 * K];  // dx then ddelta of its two channels, its states
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float dxk = dt[k] * xv[k];
          float gb = 0.f, wa = 0.f;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float h_t = hist[u + 1][k][s];
            const float g = fmaf(gy[k], cv[s], carry[k][s]);
            pbc[s] = fmaf(g, dxk, pbc[s]);
            pbc[SP + s] = fmaf(gy[k], h_t, pbc[SP + s]);
            gb = fmaf(g, bv[s], gb);
            carry[k][s] = at[u][k][s] * g;
            const float w = carry[k][s] * hist[u][k][s];
            wa = fmaf(a2[k][s], w, wa);
            da[k][s] = fmaf(dt[k], w, da[k][s]);
          }
          pn[k] = dt[k] * gb;
          pn[K + k] = fmaf(xv[k], gb, wa * kLn2);
        }
        reduce_lanes<2 * K, L / 2, 1>(pn, wl);
        reduce_lanes<Q, 16, L>(pbc, wl);
        __syncwarp();  // every lane has read step tt's x and dy
        if (HeldN::own(wl)) {
#pragma unroll
          for (int i = 0; i < HeldN::kCount; ++i) {
            const int q = HeldN::base(wl) + i;
            (q < K ? s_.x : s_.dy)[tt][ch + q % K] = pn[i];
          }
        }
        if (HeldD::own(wl)) {
#pragma unroll
          for (int i = 0; i < HeldD::kCount; ++i) {
            const int q = HeldD::base(wl) + i, s = q % SP;
            if (s < S && n0 + s < n)
              pw[tt * 2 * n + (q / SP) * n + n0 + s] = pbc[i];
          }
        }
      }
    }
    __syncthreads();
    // dx and ddelta of the interval, rows of the CTA's channels, coalesced
    const int64_t seq = (int64_t)bi * t_len;
    if (vec) {
      constexpr int kPieces = kChannels / 4;
      for (int i = threadIdx.x; i < kSteps * kPieces; i += kThreads) {
        const int tt = i / kPieces, d = d0 + (i % kPieces) * 4;
        if (t0 + tt < t_len && d < d_len) {
          const int64_t at = (seq + t0 + tt) * d_len + d;
          *reinterpret_cast<float4*>(dx + at) =
              *reinterpret_cast<const float4*>(&s_.x[tt][d - d0]);
          *reinterpret_cast<float4*>(ddelta + at) =
              *reinterpret_cast<const float4*>(&s_.dy[tt][d - d0]);
        }
      }
    } else {
      for (int i = threadIdx.x; i < kSteps * kChannels; i += kThreads) {
        const int tt = i / kChannels, d = d0 + i % kChannels;
        if (t0 + tt < t_len && d < d_len) {
          const int64_t at = (seq + t0 + tt) * d_len + d;
          dx[at] = s_.x[tt][d - d0];
          ddelta[at] = s_.dy[tt][d - d0];
        }
      }
    }
    // this CTA's dB, dC: its warps' sums in order -> (B, n_cb, T, N)
    for (int i = threadIdx.x; i < kSteps * 2 * n; i += kThreads) {
      const int tt = i / (2 * n), r = i % (2 * n);
      if (t0 + tt < t_len) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += pb[w * kSteps * 2 * n + i];
        const int64_t at =
            (((int64_t)bi * n_cb + cb) * t_len + t0 + tt) * n + r % n;
        (r < n ? part_b : part_c)[at] = sum;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + ch + k;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (d < d_len && n0 + s < n)
        part_a[((int64_t)bi * d_len + d) * n + n0 + s] = da[k][s];
  }
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

template <int L, int S>
int launch(const float* delta, const float* x, const float* b, const float* c,
           const float* a, const float* dy, const float* dh_final,
           float* ddelta, float* dx, float* db, float* dc, float* da,
           float* ckpt, float* part_b, float* part_c, float* part_a,
           int batch, int t_len, int d_len, int n, cudaStream_t stream) {
  constexpr int kThreads = threads_for_lanes(L);
  const int n_cb = (d_len + kChannels - 1) / kChannels;
  const bool vec = d_len % 4 == 0 && (uintptr_t)delta % 16 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)dy % 16 == 0 &&
                   (uintptr_t)ddelta % 16 == 0 && (uintptr_t)dx % 16 == 0;
  const bool vec_bc = n % 4 == 0 && (uintptr_t)b % 16 == 0 &&
                      (uintptr_t)c % 16 == 0;
  const bool vec_ck = ((int64_t)d_len * n) % 4 == 0 &&
                      (uintptr_t)ckpt % 16 == 0;
  const int smem = (int)(2 * sizeof(Stage<L * S>) +
                         sizeof(float) * (kThreads / 32) * kSteps * 2 * n);
  int err = (int)cudaFuncSetAttribute(
      scan_bwd_lanes<L, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err) return err;
  scan_bwd_lanes<L, S><<<dim3(n_cb, batch), kThreads, smem, stream>>>(
      delta, x, b, c, a, dy, dh_final, ddelta, dx, ckpt, part_b, part_c,
      part_a, vec, vec_bc, vec_ck, t_len, d_len, n);
  err = (int)cudaGetLastError();
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
// Scratch: ckpt (B, ceil(T/16), D, N), part_b and part_c (B, ceil(D/128),
// T, N), part_a (B, D, N).  Two kernels on `stream`; returns the first
// error (cudaFuncSetAttribute or cudaGetLastError) that is not 0.
extern "C" int selective_scan_bwd_launch(
    const void* delta, const void* x, const void* b, const void* c,
    const void* a, const void* dy, const void* dh_final, void* ddelta,
    void* dx, void* db, void* dc, void* da, void* ckpt, void* part_b,
    void* part_c, void* part_a, int batch, int t_len, int d_len,
    int d_state, void* stream) {
#define SCAN_BWD(n)                                                       \
  case n:                                                                 \
    return launch<lanes_for(n), (n + lanes_for(n) - 1) / lanes_for(n)>(   \
        (const float*)delta, (const float*)x, (const float*)b,            \
        (const float*)c, (const float*)a, (const float*)dy,               \
        (const float*)dh_final, (float*)ddelta, (float*)dx, (float*)db,   \
        (float*)dc, (float*)da, (float*)ckpt, (float*)part_b,             \
        (float*)part_c, (float*)part_a, batch, t_len, d_len, d_state,     \
        (cudaStream_t)stream);
  // one kernel a (lanes, states a lane): N = 5 and 6 share (2, 3), ...
  switch (d_state) {
    SCAN_BWD(1) SCAN_BWD(2) SCAN_BWD(3) SCAN_BWD(4)
    SCAN_BWD(5) SCAN_BWD(6) SCAN_BWD(7) SCAN_BWD(8)
    SCAN_BWD(9) SCAN_BWD(10) SCAN_BWD(11) SCAN_BWD(12)
    SCAN_BWD(13) SCAN_BWD(14) SCAN_BWD(15) SCAN_BWD(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SCAN_BWD
}
