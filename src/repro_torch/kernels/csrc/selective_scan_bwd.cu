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
// 3.2 GFLOP, 48 us.  In instructions it is more: the recompute of h and
// a_t (an exponential on the special-function units, 16 a clock an SM:
// ~72 us an exponential per (b, t, d, n)), the eight multiply-adds of the
// reverse step and the butterflies that sum over lanes, about 17
// instructions per (b, t, d, n), ~155 us at one a clock on every
// scheduler.
//
// What the design does (deterministic: no atomics, every sum in a fixed
// order):
// - The training forward (selective_scan.cu, `selective_scan_ckpt_launch`)
//   writes h at the start of every kSteps-step interval, so this kernel
//   makes no forward sweep: it walks the intervals once, from the last.
//   At kSteps = kSub = 8 an interval is one part: its states and factors
//   a_t are recomputed from its checkpoint into registers once (one
//   exponential per (b, t, d, n)) and kept for the reverse step.  In
//   turns on the card, the sum of the training forward's and this
//   kernel's times chose 8-step checkpoints over 16-step ones (two parts
//   an interval, part 1's start recomputed through part 0: 1.5
//   exponentials): 0.418 against 0.436 ms at the falcon shape on an
//   H100, the forward writing 134 MB of checkpoints against 67 MB.
//   (Part 0's states and factors kept in shared memory instead would
//   need 128 KB beside the 16-step ring's 104 KB and the sums' 48 KB;
//   a_t there for every part was slower than in registers.)
// - One producer thread feeds a ring of kStages intervals through TMA: the
//   (kSteps x 128-channel) boxes of delta, x and dy from (B, T, D) maps,
//   the kSteps rows of B_t and C_t from (B, T, N) maps and the checkpoint
//   from a (B, intervals, D, N) map, all completing on the stage's
//   mbarrier; steps past T and channels past D arrive as zeros.  TMA needs
//   rows of a multiple of 16 bytes: where D % 4 != 0 (delta, x, dy) or
//   N % 4 != 0 (B, C, the checkpoint) that operand group is copied with
//   `cp.async` by the producer's warp instead, whose 32 threads arrive on
//   the same barrier when their copies land.  The producer warpgroup
//   keeps 56 registers (`setmaxnreg`) and gives the rest to the two
//   compute warpgroups (224 each) at N >= 10.
// - States over lanes, as the forward: a channel's N states are split over
//   L = 1, 2 or 4 neighbouring lanes (4 lanes of 4 states at N = 16), and
//   each lane works on 2 neighbouring channels that share its reads of B_t
//   and C_t.  A CTA owns 128 channels of one sequence (256 compute threads
//   at N = 16).  One kernel a state count N: with N a constant the rows of
//   N floats in shared memory are addressed by immediates (a kernel a
//   lane split, N read at run time, had about one integer instruction,
//   mostly address arithmetic, for every two floating-point ones in its
//   SASS, and took 15% longer).
// - The reverse step of a part runs kBatch steps' arithmetic first,
//   keeping each step's partial sums, then their butterflies together,
//   whose shuffle chains are independent of each other:
//   - sums over N (dx, ddelta): each lane sums its states, then the 4
//     values (dx and ddelta of its 2 channels) go through a transposing
//     butterfly over the channel's L lanes, each step halving what a lane
//     carries, and lane l ends with value l;
//   - sums over channels (dB, dC): each lane adds its 2 channels in
//     registers, then its 2S values go through a transposing butterfly
//     over the warp's channel pairs, the warps' sums are added in warp
//     order by the epilogue, and a second kernel adds the CTAs' partials
//     in CTA order (and dA's over the batch).
// - dx and ddelta go back into the x and dy slots of the step they were
//   read from, each warp's dB and dC sums into the stage's slot of them,
//   and the compute threads arrive on the stage's `done` barrier: the
//   producer warpgroup's other three warps (the epilogue) add the warps'
//   sums in order, store them and the dx and ddelta rows (coalesced), and
//   release the stage to the feeder.  The compute warps never wait for
//   each other.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_helpers.cuh"
#include "hopper.cuh"

namespace {

constexpr int kChannels = 128;  // channels a CTA owns
constexpr int kPerThread = 2;   // channels a lane works on (sharing B, C)
constexpr int kSteps = 8;       // time steps a checkpoint interval holds
constexpr int kSub = 8;         // steps whose states a lane keeps at once
constexpr int kBatch = 4;       // steps whose butterflies run together
constexpr int kStages = kSteps == 8 ? 4 : 3;  // the ring's intervals
// The producer warpgroup: its first warp feeds the ring (one thread issues
// the TMA boxes), the other three are the epilogue.
constexpr int kProducer = 128;
constexpr int kFeeder = 32;
constexpr int kEpilogue = kProducer - kFeeder;
constexpr int kProducerRegs = 56;   // setmaxnreg at N >= 10:
constexpr int kComputeRegs = 224;   //   128 x 56 + 256 x 224 = 384 x 168
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kSteps % kSub == 0 && kSub % kBatch == 0,
              "an interval is whole parts, a part whole batches");

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

// Where the time goes (compiled in only with SCAN_BWD_PHASES, which
// scripts/bwd_variants.py --phases defines and reads back through
// `selective_scan_bwd_phases`): each compute warp's `clock64` cycles in
// each phase, summed over the warps of a launch (`mark(i)` charges the
// cycles since the last mark to phase i), each CTA's start and end on
// `%globaltimer` and its SM, and the two kernels' times by CUDA events.
// Without it the marks are empty.
enum ScanPhase {
  kPhFwdSweep,   // a forward sweep of its own (none: the forward's ckpt)
  kPhWait,       // an interval's stage lands
  kPhRecompute,  // states and factors from the checkpoint
  kPhReverse,    // the reverse step's arithmetic
  kPhButterfly,  // sums over lanes (dx, ddelta; dB, dC)
  kPhStores,     // dx, ddelta into shared memory and out as rows
  kPhPartials,   // the warps' and the CTA's dB, dC sums (and the barrier)
  kPhIntervals,  // intervals walked (a count, not cycles)
  kScanPhases
};
#ifdef SCAN_BWD_PHASES
constexpr int kMaxCtas = 1 << 12;
__device__ unsigned long long scan_phase_sums[kScanPhases];
__device__ unsigned long long scan_cta_stamps[kMaxCtas][3];  // start, end, SM

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

struct ScanPhases {
  long long t = 0;
  long long sum[kScanPhases] = {};
  __device__ __forceinline__ void start() {
    const int cta = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0 && cta < kMaxCtas) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm));
      scan_cta_stamps[cta][0] = global_ns();
      scan_cta_stamps[cta][2] = sm;
    }
    t = clock64();
  }
  __device__ __forceinline__ void mark(int i) {
    const long long now = clock64();
    sum[i] += now - t;
    t = now;
  }
  __device__ __forceinline__ void flush(int intervals) {
    sum[kPhIntervals] = intervals;
    if (threadIdx.x % 32 == 0)
      for (int i = 0; i < kScanPhases; ++i)
        atomicAdd(&scan_phase_sums[i], (unsigned long long)sum[i]);
    end();
  }
  // the CTA's end: the last of its warps' (the epilogue's too)
  __device__ static void end() {
    const int cta = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x % 32 == 0 && cta < kMaxCtas)
      atomicMax(&scan_cta_stamps[cta][1], global_ns());
  }
};
cudaEvent_t scan_events[3];
bool scan_events_made = false;
#else
struct ScanPhases {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int) {}
  __device__ static void end() {}
};
#endif

// One interval of the CTA's channels: rows of delta, x and dy, the
// checkpoint (channel, state) of N floats a channel, then the kSteps rows
// of B_t and C_t, N floats each (as the TMA boxes land them).
template <int LS>
struct alignas(128) Stage {
  float dt[kSteps][kChannels];
  float x[kSteps][kChannels];   // dx once consumed
  float dy[kSteps][kChannels];  // ddelta once consumed
  float h0[kChannels * LS];
  float b[kSteps * 16];
  float c[kSteps * 16];
};

template <int L, int S>
struct alignas(128) BwdSmem {
  static constexpr int W = threads_for_lanes(L) / 32;  // compute warps
  Stage<L * S> st[kStages];
  // pb[stage][warp][step][2N]: each compute warp's dB (then dC) sums
  float pb[kStages][W][kSteps * 32];
  // a stage has landed; its dx, ddelta and sums are in; it is free again
  uint64_t full[kStages], done[kStages], empty[kStages];
};

// The launch's operands as the producer reads them: tensor maps of the
// groups TMA takes, pointers of those it does not.
struct Maps {
  CUtensorMap dt, x, dy;  // (D, T, B), boxes of 128 x kSteps
  CUtensorMap b, c;       // (N, T, B), boxes of N x kSteps
  CUtensorMap ck;         // (N, D, intervals, B), boxes of N x 128
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

// The feeder: interval `chunk` of the CTA's channels into stage `s`.
// Its thread 0 issues the TMA boxes of the groups TMA takes and announces
// their bytes; where a group is not on TMA, every thread of the feeder
// warp copies its share with cp.async (zeros past T and D) and arrives
// when its copies land.
template <int LS>
__device__ __forceinline__ void produce(
    Stage<LS>& st, uint64_t* full, const Maps& maps, bool tma_rows,
    bool tma_n, const float* __restrict__ delta, const float* __restrict__ x,
    const float* __restrict__ dy, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ ckpt, int pt,
    int bi, int chunk, int d0, int t_len, int d_len, int n) {
  const int t0 = chunk * kSteps;
  if (pt == 0) {
    const uint32_t bytes =
        (tma_rows ? 3 * kSteps * kChannels * 4 : 0) +
        (tma_n ? (2 * kSteps + kChannels) * n * 4 : 0);
    if (bytes)
      mbar_expect_tx(full, bytes);
    else
      mbar_arrive(full);
    if (tma_rows) {
      tma_load_3d(&st.dt[0][0], &maps.dt, full, d0, t0, bi);
      tma_load_3d(&st.x[0][0], &maps.x, full, d0, t0, bi);
      tma_load_3d(&st.dy[0][0], &maps.dy, full, d0, t0, bi);
    }
    if (tma_n) {
      tma_load_3d(st.b, &maps.b, full, 0, t0, bi);
      tma_load_3d(st.c, &maps.c, full, 0, t0, bi);
      tma_load_4d(st.h0, &maps.ck, full, 0, d0, chunk, bi);
    }
  }
  if (tma_rows && tma_n) return;
  const int64_t row0 = (int64_t)bi * t_len + t0;  // the interval's first row
  if (!tma_rows) {
    const int64_t base = row0 * d_len + d0;
#pragma unroll 1
    for (int i = pt; i < kSteps * kChannels; i += kFeeder) {
      const int tt = i / kChannels, dd = i % kChannels;
      const bool in = t0 + tt < t_len && d0 + dd < d_len;
      const int64_t off = in ? base + tt * d_len + dd : 0;
      cp_async4(&st.dt[tt][dd], delta + off, in);
      cp_async4(&st.x[tt][dd], x + off, in);
      cp_async4(&st.dy[tt][dd], dy + off, in);
    }
  }
  if (!tma_n) {
#pragma unroll 1
    for (int i = pt; i < kSteps * n; i += kFeeder) {
      const bool in = t0 + i / n < t_len;
      const int64_t off = in ? row0 * n + i : 0;
      cp_async4(&st.b[i], bm + off, in);
      cp_async4(&st.c[i], cm + off, in);
    }
    const int chunks = (t_len + kSteps - 1) / kSteps;
    const float* ck = ckpt + (((int64_t)bi * chunks + chunk) * d_len + d0) * n;
    const int n_f = min(kChannels, d_len - d0) * n;
#pragma unroll 1
    for (int i = pt; i < kChannels * n; i += kFeeder)
      cp_async4(&st.h0[i], ck + (i < n_f ? i : 0), i < n_f);
  }
  cp_async_mbar_arrive(full);
}

// N states a channel, split over L lanes of S (N <= L S: states past N are
// padding with a = B = C = 0, whose h and g stay 0); N is a constant so
// that the shared-memory rows of N floats are addressed by immediates.
// The compute threads come first, then the producer warpgroup.
template <int N, int L = lanes_for(N), int S = (N + L - 1) / L>
__global__ void __launch_bounds__(threads_for_lanes(L) + kProducer, 1)
scan_bwd_tma(const __grid_constant__ Maps maps,
             const float* __restrict__ delta, const float* __restrict__ x,
             const float* __restrict__ bm, const float* __restrict__ cm,
             const float* __restrict__ a, const float* __restrict__ ckpt,
             const float* __restrict__ dy,
             const float* __restrict__ dh_final,
             float* __restrict__ ddelta, float* __restrict__ dx,
             float* __restrict__ part_b, float* __restrict__ part_c,
             float* __restrict__ part_a, bool tma_rows, bool tma_n,
             int t_len, int d_len) {
  constexpr int n = N;
  constexpr int LS = L * S;
  constexpr int K = kPerThread;
  constexpr int kThreads = threads_for_lanes(L);
  constexpr int kWarps = kThreads / 32;
  constexpr bool kRealloc = L == 4;  // whole warpgroups of both kinds
  constexpr int SP = pow2_at_least(S);
  constexpr int Q = 2 * SP;  // dB and dC of a lane's states, padded
  using HeldN = Held<2 * K, L / 2, 1>;   // dx, ddelta over a channel's lanes
  using HeldD = Held<Q, 16, L>;          // dB, dC over a warp's channels
  extern __shared__ unsigned char bwd_smem[];
  BwdSmem<L, S>& sm = *reinterpret_cast<BwdSmem<L, S>*>(
      bwd_smem + ((128 - (smem_addr(bwd_smem) & 127)) & 127));

  const int bi = blockIdx.y, cb = blockIdx.x, d0 = cb * kChannels;
  const int n_cb = gridDim.x;
  const int chunks = (t_len + kSteps - 1) / kSteps;
  const bool all_tma = tma_rows && tma_n;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], all_tma ? 1 : 1 + kFeeder);
      mbar_init(&sm.done[s], kThreads);    // an arrival a compute thread
      mbar_init(&sm.empty[s], kEpilogue);  // an arrival an epilogue thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int64_t seq = (int64_t)bi * t_len;
  // the warp, read from lane 0 so the compiler knows it is uniform (ptxas
  // then gives each side of the branch its own registers)
  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  if (warp_id >= kThreads / 32) {
    if constexpr (kRealloc) setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x - kThreads;
    if (pt < kFeeder) {
      // the feeder: the intervals from the last into the ring
      if (all_tma && pt != 0) return;
      for (int it = 0; it < chunks; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&sm.empty[s], (it / kStages - 1) & 1);
        produce<LS>(sm.st[s], &sm.full[s], maps, tma_rows, tma_n, delta, x,
                    dy, bm, cm, ckpt, pt, bi, chunks - 1 - it, d0, t_len,
                    d_len, n);
      }
      return;
    }
    // the epilogue: each interval's dx, ddelta rows and the CTA's dB, dC
    // (its warps' sums in order -> (B, n_cb, T, N)) out, then the stage
    // back to the feeder
    const int et = pt - kFeeder;
    const bool vec_out = d_len % 4 == 0 && (uintptr_t)dx % 16 == 0 &&
                         (uintptr_t)ddelta % 16 == 0;
    for (int it = 0; it < chunks; ++it) {
      const int c = chunks - 1 - it, t0 = c * kSteps, s = it % kStages;
      const Stage<LS>& st = sm.st[s];
      mbar_wait(&sm.done[s], (it / kStages) & 1);
      const float* pbi = &sm.pb[s][0][0];
      const int64_t part0 = (((int64_t)bi * n_cb + cb) * t_len + t0) * n;
#pragma unroll 1
      for (int i = et; i < kSteps * 2 * n; i += kEpilogue) {
        const int tt = i / (2 * n), r = i % (2 * n);
        if (t0 + tt < t_len) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) sum += pbi[w * kSteps * 32 + i];
          (r < n ? part_b : part_c)[part0 + tt * n + r % n] = sum;
        }
      }
      const int64_t row0 = (seq + t0) * d_len + d0;
      const int rows = min(kSteps, t_len - t0), cols = min(kChannels,
                                                           d_len - d0);
      if (vec_out) {
        constexpr int kPieces = kChannels / 4;
#pragma unroll 1
        for (int i = et; i < rows * kPieces; i += kEpilogue) {
          const int tt = i / kPieces, dd = (i % kPieces) * 4;
          if (dd < cols) {
            const int64_t at = row0 + tt * d_len + dd;
            *reinterpret_cast<float4*>(dx + at) =
                *reinterpret_cast<const float4*>(&st.x[tt][dd]);
            *reinterpret_cast<float4*>(ddelta + at) =
                *reinterpret_cast<const float4*>(&st.dy[tt][dd]);
          }
        }
      } else {
#pragma unroll 1
        for (int i = et; i < rows * kChannels; i += kEpilogue) {
          const int tt = i / kChannels, dd = i % kChannels;
          if (dd < cols) {
            const int64_t at = row0 + tt * d_len + dd;
            dx[at] = st.x[tt][dd];
            ddelta[at] = st.dy[tt][dd];
          }
        }
      }
      // the stage may be refilled (by TMA: the async proxy, after this
      // thread's generic reads of it)
      fence_proxy_async();
      mbar_arrive(&sm.empty[s]);
    }
    ScanPhases::end();
    return;
  }
  if constexpr (kRealloc) setmaxnreg_inc<kComputeRegs>();

  ScanPhases ph;
  ph.start();
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int ch = threadIdx.x / L * K, lane = threadIdx.x % L;
  const int n0 = lane * S;
  constexpr bool exact = LS == n;  // no lane keeps a padding state
  float a2[K][S], carry[K][S], da[K][S];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int d = d0 + ch + k;
      const bool live = d < d_len && n0 + s < n;
      a2[k][s] = live ? a[(int64_t)d * n + n0 + s] * kLog2e : 0.f;
      carry[k][s] = (live && dh_final != nullptr)
                        ? dh_final[((int64_t)bi * d_len + d) * n + n0 + s]
                        : 0.f;
      da[k][s] = 0.f;
    }
  }
  // one forward step of the recurrence from staged step tt: h_t, a_t
  auto forward = [&](const Stage<LS>& s_, int tt, float (&h)[K][S],
                     float (&e)[K][S]) {
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

  for (int it = 0; it < chunks; ++it) {
    const int s_i = it % kStages;
    Stage<LS>& s_ = sm.st[s_i];
    float* pw = sm.pb[s_i][warp];
    mbar_wait(&sm.full[s_i], (it / kStages) & 1);
    ph.mark(kPhWait);

#pragma unroll 1
    for (int j = kSteps / kSub - 1; j >= 0; --j) {
      float hist[kSub + 1][K][S], at[kSub][K][S];  // h_{t-1}, a_t
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int s = 0; s < S; ++s)
          hist[0][k][s] = n0 + s < n ? s_.h0[(ch + k) * n + n0 + s] : 0.f;
#pragma unroll 1
      for (int tt = 0; tt < j * kSub; ++tt) {  // to the part's start
        float e[K][S];
        forward(s_, tt, hist[0], e);
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int s = 0; s < S; ++s) hist[u + 1][k][s] = hist[u][k][s];
        forward(s_, j * kSub + u, hist[u + 1], at[u]);
      }
      ph.mark(kPhRecompute);
      // the part's reverse steps, kBatch at a time: each step's partial
      // sums first, then their butterflies together
#pragma unroll
      for (int hb = kSub / kBatch - 1; hb >= 0; --hb) {
        float pn[kBatch][2 * K];  // dx then ddelta of a lane's two channels
        float pbc[kBatch][Q];     // dB then dC of its states, its channels
#pragma unroll
        for (int v = kBatch - 1; v >= 0; --v) {
          const int u = hb * kBatch + v, tt = j * kSub + u;
          float dt[K], xv[K], gy[K], bv[S], cv[S];
          load_k<K>(dt, &s_.dt[tt][ch]);
          load_k<K>(xv, &s_.x[tt][ch]);
          load_k<K>(gy, &s_.dy[tt][ch]);
          load_row<S>(bv, &s_.b[tt * n], n0, n, exact);
          load_row<S>(cv, &s_.c[tt * n], n0, n, exact);
#pragma unroll
          for (int q = 0; q < Q; ++q) pbc[v][q] = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float dxk = dt[k] * xv[k];
            float gb = 0.f, wa = 0.f;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const float g = fmaf(gy[k], cv[s], carry[k][s]);
              pbc[v][s] = fmaf(g, dxk, pbc[v][s]);
              pbc[v][SP + s] =
                  fmaf(gy[k], hist[u + 1][k][s], pbc[v][SP + s]);
              gb = fmaf(g, bv[s], gb);
              carry[k][s] = at[u][k][s] * g;
              const float w = carry[k][s] * hist[u][k][s];
              wa = fmaf(a2[k][s], w, wa);
              da[k][s] = fmaf(dt[k], w, da[k][s]);
            }
            pn[v][k] = dt[k] * gb;
            pn[v][K + k] = fmaf(xv[k], gb, wa * kLn2);
          }
        }
        ph.mark(kPhReverse);
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
          reduce_lanes<2 * K, L / 2, 1>(pn[v], wl);
          reduce_lanes<Q, 16, L>(pbc[v], wl);
        }
        ph.mark(kPhButterfly);
        __syncwarp();  // every lane has read the batch's x and dy
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
          const int tt = j * kSub + hb * kBatch + v;
          if (HeldN::own(wl)) {
#pragma unroll
            for (int i = 0; i < HeldN::kCount; ++i) {
              const int q = HeldN::base(wl) + i;
              (q < K ? s_.x : s_.dy)[tt][ch + q % K] = pn[v][i];
            }
          }
        }
        ph.mark(kPhStores);
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
          const int tt = j * kSub + hb * kBatch + v;
          if (HeldD::own(wl)) {
#pragma unroll
            for (int i = 0; i < HeldD::kCount; ++i) {
              const int q = HeldD::base(wl) + i, s = q % SP;
              if (s < S && n0 + s < n)
                pw[tt * 2 * n + (q / SP) * n + n0 + s] = pbc[v][i];
            }
          }
        }
        ph.mark(kPhPartials);
      }
    }
    // this thread's dx, ddelta and dB, dC sums of the interval are in:
    // the epilogue takes them out
    mbar_arrive(&sm.done[s_i]);
    ph.mark(kPhPartials);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + ch + k;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (d < d_len && n0 + s < n)
        part_a[((int64_t)bi * d_len + d) * n + n0 + s] = da[k][s];
  }
  ph.mark(kPhPartials);
  ph.flush(chunks);
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

// A float32 tensor of `rank` dims (innermost first) as a tensor map in
// boxes of `box`, unswizzled; elements past the tensor load as zeros.
int float_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint32_t* box) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t strides[3];
  cuuint64_t stride = 4;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                            const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int N>
int launch(const float* delta, const float* x, const float* b, const float* c,
           const float* a, const float* ckpt, const float* dy,
           const float* dh_final, float* ddelta, float* dx, float* db,
           float* dc, float* da, float* part_b, float* part_c, float* part_a,
           int batch, int t_len, int d_len, cudaStream_t stream) {
  constexpr int L = lanes_for(N), S = (N + L - 1) / L, n = N;
  constexpr int kThreads = threads_for_lanes(L);
  const int n_cb = (d_len + kChannels - 1) / kChannels;
  const int chunks = (t_len + kSteps - 1) / kSteps;
  // TMA takes rows of a multiple of 16 bytes from 16-byte aligned bases
  const bool tma_rows = d_len % 4 == 0 && aligned16(delta) && aligned16(x) &&
                        aligned16(dy);
  const bool tma_n = n % 4 == 0 && aligned16(b) && aligned16(c) &&
                     aligned16(ckpt);
  Maps maps = {};
  int err = 0;
  if (tma_rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)d_len, (cuuint64_t)t_len,
                                (cuuint64_t)batch};
    const cuuint32_t box[3] = {kChannels, kSteps, 1};
    err = float_map(&maps.dt, delta, 3, dims, box);
    if (!err) err = float_map(&maps.x, x, 3, dims, box);
    if (!err) err = float_map(&maps.dy, dy, 3, dims, box);
  }
  if (!err && tma_n) {
    const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)t_len,
                                (cuuint64_t)batch};
    const cuuint32_t box[3] = {(cuuint32_t)n, kSteps, 1};
    err = float_map(&maps.b, b, 3, dims, box);
    if (!err) err = float_map(&maps.c, c, 3, dims, box);
    const cuuint64_t ck_dims[4] = {(cuuint64_t)n, (cuuint64_t)d_len,
                                   (cuuint64_t)chunks, (cuuint64_t)batch};
    const cuuint32_t ck_box[4] = {(cuuint32_t)n, kChannels, 1, 1};
    if (!err) err = float_map(&maps.ck, ckpt, 4, ck_dims, ck_box);
  }
  if (err) return err;
  constexpr int smem = (int)sizeof(BwdSmem<L, S>) + 128;
  err = allow_dynamic_smem<scan_bwd_tma<N>, smem>();
  if (err) return err;
#ifdef SCAN_BWD_PHASES
  if (!scan_events_made) {
    for (auto& e : scan_events) cudaEventCreate(&e);
    scan_events_made = true;
  }
  cudaEventRecord(scan_events[0], stream);
#endif
  scan_bwd_tma<N><<<dim3(n_cb, batch), kThreads + kProducer, smem,
                    stream>>>(maps, delta, x, b, c, a, ckpt, dy, dh_final,
                              ddelta, dx, part_b, part_c, part_a, tma_rows,
                              tma_n, t_len, d_len);
  err = (int)cudaGetLastError();
  if (err) return err;
#ifdef SCAN_BWD_PHASES
  cudaEventRecord(scan_events[1], stream);
#endif
  const int64_t total = (int64_t)batch * t_len * n + (int64_t)d_len * n;
  scan_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                           stream>>>(part_b, part_c, part_a, db, dc, da,
                                     batch, t_len, d_len, n, n_cb);
#ifdef SCAN_BWD_PHASES
  cudaEventRecord(scan_events[2], stream);
#endif
  return (int)cudaGetLastError();
}

}  // namespace

// delta, x, dy, ddelta, dx (B,T,D); b, c, db, dc (B,T,N); a, da (D,N);
// ckpt (B, ceil(T/8), D, N), the training forward's checkpoints
// (selective_scan_ckpt_launch); dh_final (B,D,N) or null (zeros);
// float32, contiguous, 1 <= N <= 16.  Scratch: part_b and part_c
// (B, ceil(D/128), T, N), part_a (B, D, N).  Two kernels on `stream`;
// returns the first error (a tensor map's encoding, cudaFuncSetAttribute
// or cudaGetLastError) that is not 0.
extern "C" int selective_scan_bwd_launch(
    const void* delta, const void* x, const void* b, const void* c,
    const void* a, const void* ckpt, const void* dy, const void* dh_final,
    void* ddelta, void* dx, void* db, void* dc, void* da, void* part_b,
    void* part_c, void* part_a, int batch, int t_len, int d_len,
    int d_state, void* stream) {
#define SCAN_BWD(n)                                                       \
  case n:                                                                 \
    return launch<n>((const float*)delta, (const float*)x,                \
                     (const float*)b, (const float*)c, (const float*)a,   \
                     (const float*)ckpt, (const float*)dy,                \
                     (const float*)dh_final, (float*)ddelta, (float*)dx,  \
                     (float*)db, (float*)dc, (float*)da, (float*)part_b,  \
                     (float*)part_c, (float*)part_a, batch, t_len, d_len, \
                     (cudaStream_t)stream);
  // one kernel a state count
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

#ifdef SCAN_BWD_PHASES
// The phase sums (kScanPhases values) and CTA stamps (kMaxCtas x 3) since
// the last call, then 0; ms: the scan kernel's and the reduce kernel's
// times of the last launch by CUDA events.
extern "C" int selective_scan_bwd_phases(unsigned long long* sums,
                                         unsigned long long* stamps,
                                         float* ms) {
  int err = (int)cudaEventSynchronize(scan_events[2]);
  if (!err) err = (int)cudaEventElapsedTime(ms, scan_events[0],
                                            scan_events[1]);
  if (!err) err = (int)cudaEventElapsedTime(ms + 1, scan_events[1],
                                            scan_events[2]);
  if (!err) err = (int)cudaMemcpyFromSymbol(sums, scan_phase_sums,
                                            sizeof(scan_phase_sums));
  if (!err) err = (int)cudaMemcpyFromSymbol(stamps, scan_cta_stamps,
                                            sizeof(scan_cta_stamps));
  static unsigned long long zero[kMaxCtas][3];
  if (!err) err = (int)cudaMemcpyToSymbol(scan_phase_sums, zero,
                                          sizeof(scan_phase_sums));
  if (!err) err = (int)cudaMemcpyToSymbol(scan_cta_stamps, zero,
                                          sizeof(scan_cta_stamps));
  return err;
}
#endif
