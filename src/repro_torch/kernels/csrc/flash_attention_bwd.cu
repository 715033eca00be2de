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
//
// O is the forward's output in q's dtype or in float32: the training
// forward hands the bf16 path its float32 output (before the rounding to
// bf16), since D from the rounded O moved dQ and dK by up to 0.005 of
// their scale on non-causal attention, past the 2^-8 tolerance.
//   dV = sum over the group's q heads of P^T dO          (dK/dV kernel)
//   dS = P * (dO v^T - D), 0 where the mask holds
//   dK = scale dS^T q                                    (dK/dV kernel)
//   dQ = scale dS k                                      (dQ kernel)
//
// A row with no key in its band (lse == -1e30) weighs every key 1/S in dV
// and passes no gradient to its scores, as the forward's uniform average.
// Keys past S and rows past T weigh 0.
//
// What bounds it on the H100: at the llama3.2-1b train shape (q
// (4,512,32,64), k/v (4,512,8,64), bf16, causal) it must read q, k, v, o,
// dO (21 MB with lse and D) and write dq, dk, dv (12.6 MB): 10 us at
// 3.35 TB/s; it does 10 flops a head dim per unmasked pair (QK^T, dO V^T,
// P^T dO, dS^T Q, dS K), 10.8 GFLOP, 11 us on the bf16 tensor cores or
// 161 us in float32 on the CUDA cores.  The separate dQ kernel recomputes
// S and dP (14 flops a head dim and pair in all, ~15 us on the tensor
// cores): the price of writing every output once, with no atomics, so the
// backward is deterministic and a resumed run repeats its loss bit for bit.
// The bf16 kernels issue 20 (P and dS as two bf16 terms, below).
//
// bf16, the training path (`flash_bwd_dkdv_bf16_kernel`,
// `flash_bwd_dq_bf16_kernel`): every product on the tensor cores,
// `mma.sync.m16n8k16` bf16 -> float32, with the forward's conventions
// (device_helpers.cuh): tiles of bf16 rows padded by 16 bytes in shared
// memory, `cp.async` double buffering, `ldmatrix` (and `ldmatrix.trans`
// where the product needs the tile's columns as its k), and an accumulator
// of two n8 tiles reused as the A fragment of one k16 step.  Every product
// keeps the natural layouts, q/dO (B,T,H,D) and k/v (B,S,KV,D): no
// transpose in memory.
// - dK/dV: one CTA a (b, kv head, 64-key tile), 4 warps of 16 keys, keys as
//   the A rows.  K and V stay in registers as A fragments; the CTA walks
//   the group's H/KV query heads (GQA summed inside the CTA) and the
//   64-row q tiles of the band, each tile's Q, dO, lse and D staged with
//   `cp.async` while the previous one computes:
//     S^T = K Q^T (Q's B fragments by `ldmatrix`), P^T = 2^(S^T scale
//     log2(e) - lse log2(e)), dV += P^T dO (P^T as bf16 A fragments; dO
//     by `ldmatrix.trans`), dP^T = V dO^T, dS^T = P^T (dP^T - D),
//     dK += dS^T Q (dS^T as bf16 A fragments; Q by `ldmatrix.trans`).
//   dK is multiplied by `scale` in float32 at the store (Q is not
//   pre-scaled in bf16, which would add a rounding the reference lacks).
// - dQ: one CTA a (b, head, 64-row q tile), 4 warps of 16 rows; Q and dO
//   stay in registers as A fragments, each row's lse and D in registers;
//   the CTA walks the band's 64-key K/V tiles: S = Q K^T, dP = dO V^T,
//   dS, dQ += dS K (K by `ldmatrix.trans`), scaled at the store.
// P and dS enter their products as TWO bf16 terms each, hi = bf16(x) and
// lo = bf16(x - hi), so two `mma`s a product: one bf16 rounding of P puts
// dV at up to 0.0065 of its scale from the float32 reference, and one of
// dS puts dQ at up to 0.007 (dS sums to ~0 over a row's keys, so dQ
// cancels), both past the 2^-8 the gradients are held to; hi + lo keeps
// ~16 bits, and every gradient stays within 0.0025 (a CPU model of this
// arithmetic, tests/test_torch_bwd_redesign.py).  With the rounding of the
// gradients at the store, these are the only changes to the reference's
// float32 arithmetic.  Only the tiles the band's edge (or T,
// or S in the dQ kernel) crosses are masked element by element.  The
// tiles walked hold every weighted pair; the heaviest CTAs of a causal
// band (the first key tiles, the last q tiles) run first.
// Tile sizes come from the registers: a dK/dV warp holds 16 keys x D of dK
// and dV accumulators (2 x D/2 floats), K and V fragments (2 x D/4
// registers) and S^T, dP^T for a 64-row q step (2 x 32 floats): ~160 live
// values at D = 64, under the 255 a thread may have, with room for
// addresses; 2 CTAs (8 warps) share an SM.  A dQ warp holds a third less.
// Shared memory: two 64-row tiles of two operands, 37 KB (dK/dV, with lse
// and D) and 36 KB (dQ), under the 48 KB of static shared memory.
// Head dims 80 (h2o-danube) and 128 (qwen2-vl): the accumulators grow to
// 2 x 40 and 2 x 64 floats, so K and V (dK/dV) or Q and dO (dQ) stay in
// their own shared-memory tiles and each k-step loads its A fragment by
// `ldmatrix` (`kAInRegs`), and at D = 128 the dK/dV warp takes each 64-row
// stage in two halves of 32 rows (`kSubB`), so S^T and dP^T are 2 x 16
// floats.  The stages, 67 KB (80) and 103 KB (128), take dynamic shared
// memory (`shared_stage`, device_helpers.cuh); 2 CTAs still share an SM.
// Windowed attention (h2o-danube trains on T = 2 windows) walks only the
// band: the dK/dV kernel's `visit` skips the q tiles with no kept pair and
// no row without keys, the dQ kernel starts at the band's first key tile.
// Head dim 256 (gemma3): a warp's dK and dV accumulators alone would be
// 2 x 128 floats a thread, past the 255 registers.  So the dK/dV kernel
// runs as two launches, a dV pass and a dK pass (`DkdvPass`), each holding
// one 128-float accumulator and recomputing S^T (16 flops a head dim and
// pair in all, against 14): deterministic, no atomics, each output written
// once.  Both take 32-row halves of a stage (`kSubB`), and the dQ kernel
// takes each 64-key stage in 32-key halves (`kSubQ`), so S and dP (or S^T
// and dP^T) are 2 x 16 floats beside the 128.  The stages are 199 KB
// (dK/dV, K and V staged) and 198 KB (dQ, Q and dO staged) of dynamic
// shared memory, one CTA an SM.
//
// Softcap (gemma3's option, 0 = off): S is recomputed capped,
// c tanh(s / c) with s the scaled score (`tanhf`), P from it, and
// dS = P (dP - D) (1 - tanh^2) takes the cap's derivative.  The bf16
// kernels take it as a template flag (`kCap`), each built with and
// without, so the uncapped kernels are the kernels as they were (a
// runtime branch cost the llama shape's backward 14% on an H100, by
// scripts/bwd_variants.py --baseline); capped, the dK/dV
// kernel computes dP^T before the P^T products, while S^T still holds the
// raw scores.  The float32 kernels take it at run time.
//
// float32 (`flash_bwd_dkdv_kernel`, `flash_bwd_dq_kernel`), what the
// per-layer and whole-step route checks compute: on the CUDA cores, the
// products in full float32.
// - dK/dV: one CTA per (batch, kv head, 64-key tile; 16 at D = 256,
//   `kTile`).  Each key is owned by
//   D/16 neighbouring threads, 16 head dims each (4 of 20 at D = 80,
//   `kSlice`), holding its k and v
//   slices and its dK and dV accumulators in registers; the two dot
//   products of a (query, key) pair are summed over those threads by
//   `__shfl_xor_sync`.  The CTA loops over the group's H/KV query heads
//   (GQA is summed inside the CTA) and over the 32-row (16 at D = 256,
//   `kStep`) q tiles that the causal/window band reaches (or that hold a
//   row with no key in its band), staging q (pre-scaled), dO, lse and D in
//   shared memory, read by every thread as broadcasts.
// - dQ: one CTA per (batch, head, 64-row q tile; 16 at D = 256), the same
//   layout with rows in place of keys, looping over the 32-key (16) tiles
//   of the band.
//   At D = 256, 64 keys of 16 lanes would be 1,024 threads of at most 64
//   registers, and 32-row stages 64 KB of static shared memory: hence the
//   16-key (16-row) CTAs of 256 threads and the 16-row (16-key) stages.
// - D = rowsum(dO * O): one warp a row (both types).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "device_helpers.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the forward's mask value
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
// bf16: tensor cores (mma.sync m16n8k16, bf16 -> float32)
// ---------------------------------------------------------------------------

constexpr int kTB = 64;      // keys (dK/dV) or rows (dQ) a CTA owns
constexpr int kStepB = 64;   // rows (dK/dV) or keys (dQ) a stage holds
constexpr int kThreadsB = 128;  // 4 warps, 16 keys or rows each
constexpr int kPad = 8;      // bf16 elements of padding a shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

// Up to D = 64 a warp holds its 16 keys' K and V (dK/dV) or its 16 rows'
// Q and dO (dQ) in registers as A fragments, D/4 registers each.  Past 64
// they stay in shared memory and each k-step loads its A fragment by
// `ldmatrix`: beside the D/2-float dK and dV accumulators they would take
// 256 registers at D = 128 (and spill at D = 80, where D = 64 already
// takes 254).
template <int D>
constexpr bool kAInRegs = D <= 64;
// The q rows a dK/dV warp's S^T and dP^T tiles span at once (within a
// stage of kStepB): 64 up to D = 80; 32 at D = 128, where 2 x 16 floats of
// S^T and dP^T sit beside 128 floats of dK and dV accumulators.
template <int D>
constexpr int kSubB = D <= 80 ? 64 : 32;
// The keys a dQ warp's S and dP tiles span at once (within a stage of
// kStepB): 64 up to D = 128; 32 at D = 256, beside 128 floats of dQ.
template <int D>
constexpr int kSubQ = D <= 128 ? 64 : 32;
// What a dK/dV launch accumulates: both up to D = 128; at D = 256 the
// kernel runs twice, a dV pass and then a dK pass (see "Head dim 256").
enum DkdvPass { kDkdvBoth, kDkdvOnlyDv, kDkdvOnlyDk };

// rows [row0, row0 + kStepB) of a (rows, D) slab with `stride` elements
// between rows -> shared memory; rows >= n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(bf16 (*dst)[D + kPad],
                                           const bf16* __restrict__ src,
                                           int row0, int n_rows,
                                           int64_t stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = threadIdx.x; i < kStepB * kChunks; i += kThreadsB) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = row0 + r < n_rows;
    cp_async16(&dst[r][c], src + (in ? row0 + r : 0) * stride + c, in);
  }
}

// kStepB floats of a (B,H,T) row from `row0`; zero past T
__device__ __forceinline__ void stage_floats(float* dst,
                                             const float* __restrict__ src,
                                             int row0, int n_rows) {
  for (int i = threadIdx.x; i < kStepB; i += kThreadsB) {
    const bool in = row0 + i < n_rows;
    cp_async4(dst + i, src + (in ? row0 + i : 0), in);
  }
}

// A fragments of the warp's 16 rows of a staged tile, D/16 k-steps
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                       const bf16 (*t)[D + kPad], int warp,
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldsm_x4(f[kc], &t[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
}

// acc (16 x N) += A (16 x D) * t^T, t N staged rows of D: the B fragments
// of rows as columns, by `ldmatrix`.  A: fragments in registers, or the
// warp's 16 rows of the staged tile `ta`, loaded a k-step at a time.
template <int D, int N>
__device__ __forceinline__ void mma_kstep(float (&acc)[N / 8][4],
                                          const uint32_t (&a)[4],
                                          const bf16 (*t)[D + kPad], int kc,
                                          int lane) {
#pragma unroll
  for (int jp = 0; jp < N / 16; ++jp) {
    uint32_t b[4];  // n tiles 2jp and 2jp + 1
    ldsm_x4(b, &t[jp * 16 + (lane & 7) + ((lane >> 4) << 3)]
                 [kc * 16 + ((lane >> 3) & 1) * 8]);
    mma_bf16(acc[2 * jp], a, b[0], b[1]);
    mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
  }
}
template <int D, int N>
__device__ __forceinline__ void mma_rows(float (&acc)[N / 8][4],
                                         const uint32_t (&a)[D / 16][4],
                                         const bf16 (*t)[D + kPad],
                                         int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) mma_kstep<D, N>(acc, a[kc], t, kc, lane);
}
template <int D, int N>
__device__ __forceinline__ void mma_rows(float (&acc)[N / 8][4],
                                         const bf16 (*ta)[D + kPad],
                                         const bf16 (*t)[D + kPad], int warp,
                                         int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, &ta[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
    mma_kstep<D, N>(acc, a, t, kc, lane);
  }
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

// acc (16 x D) += X (16 x N, float32 accumulators split into two bf16
// terms as A fragments) * t, t N staged rows of D read by
// `ldmatrix.trans`: two products, hi then lo
template <int D, int N>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4],
                                         const float (&x)[N / 8][4],
                                         const bf16 (*t)[D + kPad],
                                         int lane) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * kc][0], x[2 * kc][1], hi[0], lo[0]);
    split_bf16(x[2 * kc][2], x[2 * kc][3], hi[1], lo[1]);
    split_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];  // d tiles 2np and 2np + 1
      ldsm_x4_trans(b, &t[kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                         [np * 16 + (lane >> 4) * 8]);
      mma_bf16(acc[2 * np], hi, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * np], lo, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// The warp's 16 rows of a (16 x D) accumulator times `mul`, rounded to
// bf16, through the warp's own rows of `t` (no other warp reads them) to
// rows [row0 + warp*16, +16) of `dst`, 16 bytes a lane; rows >= n_rows are
// not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[D / 8][4],
                                           float mul, bf16 (*t)[D + kPad],
                                           int row0, int n_rows,
                                           int64_t stride, int warp,
                                           int lane) {
  const int gr = lane >> 2, tc = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + tc * 2;
    *reinterpret_cast<uint32_t*>(&t[warp * 16 + gr][c]) =
        pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(&t[warp * 16 + gr + 8][c]) =
        pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = warp * 16 + i / kChunks, c = (i % kChunks) * 8;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (int64_t)(row0 + r) * stride + c) =
          *reinterpret_cast<const uint4*>(&t[r][c]);
  }
}

template <int D>
struct DkdvStage {
  bf16 q[2][kStepB][D + kPad];
  bf16 dout[2][kStepB][D + kPad];
  float lse[2][kStepB];
  float dsum[2][kStepB];
};
template <int D>
struct DkdvStageKV : DkdvStage<D> {  // K and V kept staged (D > 64)
  bf16 k[kTB][D + kPad];
  bf16 v[kTB][D + kPad];
};
template <int D>
using DkdvSmem =
    typename std::conditional<kAInRegs<D>, DkdvStage<D>, DkdvStageKV<D>>::type;

// dK, dV (or, by PASS, one of them): one CTA per (b, kv head, 64-key
// tile), the first key tiles (the heaviest under a causal band) first
template <int D, int PASS, bool kCap>
__global__ void __launch_bounds__(kThreadsB, 2)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int t_len, int s_len, int n_heads, int n_kv,
                           int causal, int window, float scale,
                           float softcap) {
  constexpr int kSub = kSubB<D>;
  constexpr bool kDv = PASS != kDkdvOnlyDk, kDk = PASS != kDkdvOnlyDv;
  DkdvSmem<D>& s = shared_stage<DkdvSmem<D>>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;  // fragment row, column pair
  const int b = blockIdx.x / n_kv, g = blockIdx.x % n_kv;
  const int rep = n_heads / n_kv;
  const int k0 = blockIdx.y * kTB;
  const int k_hi = min(k0 + kTB, s_len) - 1;
  const int64_t q_row = (int64_t)n_heads * D, kv_row = (int64_t)n_kv * D;
  const int64_t kv_off = (int64_t)b * s_len * kv_row + (int64_t)g * D;
  const int n_qt = (t_len + kStepB - 1) / kStepB;

  // a q tile is visited if some (row, key) pair of it is kept, or if a row
  // keeps no key (the last row decides: emptiness only grows with the row)
  auto visit = [&](int qt) {
    const int q0 = qt * kStepB, q_hi = min(q0 + kStepB, t_len) - 1;
    const bool pairs = (!causal || k0 <= q_hi) &&
                       (window <= 0 || k_hi > q0 - window);
    return pairs || row_empty(q_hi, s_len, causal, window);
  };
  auto next_tile = [&](int qt) {
    while (qt < n_qt && !visit(qt)) ++qt;
    return qt;
  };
  // the (head, q tile) walk: r over the group's heads, qt over the band
  const int qt_first = next_tile(0);
  auto stage = [&](int buf, int r, int qt) {
    const int h = g * rep + r, q0 = qt * kStepB;
    const int64_t lrow = ((int64_t)b * n_heads + h) * t_len;
    const int64_t q_off = (int64_t)b * t_len * q_row + (int64_t)h * D;
    stage_rows<D>(s.q[buf], q + q_off, q0, t_len, q_row);
    stage_rows<D>(s.dout[buf], dout + q_off, q0, t_len, q_row);
    stage_floats(s.lse[buf], lse + lrow, q0, t_len);
    stage_floats(s.dsum[buf], dsum + lrow, q0, t_len);
  };

  // K and V through buffer 1 into A fragments (or to their own tiles);
  // the first q tile to buffer 0
  if constexpr (kAInRegs<D>) {
    stage_rows<D>(s.q[1], k + kv_off, k0, s_len, kv_row);
    stage_rows<D>(s.dout[1], v + kv_off, k0, s_len, kv_row);
  } else {
    stage_rows<D>(s.k, k + kv_off, k0, s_len, kv_row);
    if (kDk) stage_rows<D>(s.v, v + kv_off, k0, s_len, kv_row);
  }
  if (qt_first < n_qt) stage(0, 0, qt_first);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[kAInRegs<D> ? D / 16 : 1][4], vf[kAInRegs<D> ? D / 16 : 1][4];
  if constexpr (kAInRegs<D>) {
    load_a<D>(kf, s.q[1], warp, lane);
    load_a<D>(vf, s.dout[1], warp, lane);
    __syncthreads();
  }

  float dka[kDk ? D / 8 : 1][4], dva[kDv ? D / 8 : 1][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < (kDk ? D / 8 : 1); ++n) dka[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < (kDv ? D / 8 : 1); ++n) dva[n][e] = 0.f;
  }
  const float inv_s = 1.f / (float)s_len;
  const float sl2 = scale * kLog2e;
  // softcap (kCap): P^T = 2^(c log2(e) tanh(s scale / c) - lse log2(e))
  const float cap_in = kCap ? scale / softcap : 0.f;
  const float cap_l2 = kCap ? softcap * kLog2e : 0.f;
  const int kp[2] = {k0 + warp * 16 + gr, k0 + warp * 16 + gr + 8};

  int r = 0, qt = qt_first, buf = 0;
  while (qt < n_qt) {
    // the next (head, tile) loads while this one computes
    int r_next = r, qt_next = next_tile(qt + 1);
    if (qt_next >= n_qt) qt_next = ++r_next < rep ? qt_first : n_qt;
    if (qt_next < n_qt) {
      stage(buf ^ 1, r_next, qt_next);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * kStepB, q_hi = min(q0 + kStepB, t_len) - 1;
    const bf16(*tq)[D + kPad] = s.q[buf];
    const bf16(*tdo)[D + kPad] = s.dout[buf];
    const float* sl = s.lse[buf];
    const float* sd = s.dsum[buf];
    // every (row, key) pair of the tile kept: no mask (rows past T carry
    // zero Q, dO, lse and D and add exactly 0; keys past S are not stored)
    const bool inside = (!causal || k0 + kTB - 1 <= q0) &&
                        (window <= 0 || k0 > q_hi - window);

    // kSub rows of the stage at a time
#pragma unroll
    for (int sub = 0; sub < kStepB; sub += kSub) {
      const bf16(*sq)[D + kPad] = tq + sub;
      const bf16(*sdo)[D + kPad] = tdo + sub;
      // S^T = K Q^T (16 keys x kSub rows), then P^T in place; capped,
      // dP^T = V dO^T first (the cap's derivative needs the raw S^T)
      float st[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      if constexpr (kAInRegs<D>)
        mma_rows<D, kSub>(st, kf, sq, lane);
      else
        mma_rows<D, kSub>(st, s.k, sq, warp, lane);
      auto v_dot = [&]() {  // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
          dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
        if constexpr (kAInRegs<D>)
          mma_rows<D, kSub>(dpt, vf, sdo, lane);
        else
          mma_rows<D, kSub>(dpt, s.v, sdo, warp, lane);
      };
      if constexpr (kCap && kDk) v_dot();
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(&sl[sub + j * 8 + tc * 2]);
        float2 dd = {0.f, 0.f};
        if constexpr (kCap && kDk)
          dd = *reinterpret_cast<const float2*>(&sd[sub + j * 8 + tc * 2]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l.y : l.x;
          float x;
          [[maybe_unused]] float dcap;  // the cap's derivative
          if constexpr (kCap) {
            const float th = tanhf(st[j][e] * cap_in);
            x = fast_exp2(fmaf(cap_l2, th, -lv * kLog2e));
            dcap = 1.f - th * th;
          } else {
            x = fast_exp2(fmaf(st[j][e], sl2, -lv * kLog2e));
          }
          if (inside) {
            st[j][e] = x;
          } else {
            const int qp = q0 + sub + j * 8 + tc * 2 + (e & 1);
            const bool kept =
                qp < t_len && keep(qp, kp[e >> 1], causal, window);
            st[j][e] = kept ? x : (lv <= 0.5f * kNegInf ? inv_s : 0.f);
          }
          if constexpr (kCap && kDk) {  // dS^T in place of dP^T
            const float ds =
                st[j][e] * (dpt[j][e] - ((e & 1) ? dd.y : dd.x)) * dcap;
            dpt[j][e] = (inside || lv > 0.5f * kNegInf) ? ds : 0.f;
          }
        }
      }
      // dV += P^T dO
      if constexpr (kDv) mma_cols<D, kSub>(dva, st, sdo, lane);
      if constexpr (!kCap && kDk) {
        // dP^T = V dO^T, then dS^T = P^T (dP^T - D) in place (0 for a row
        // with no key in its band)
        v_dot();
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) {
          const float2 dd =
              *reinterpret_cast<const float2*>(&sd[sub + j * 8 + tc * 2]);
          const float2 l =
              *reinterpret_cast<const float2*>(&sl[sub + j * 8 + tc * 2]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ds =
                st[j][e] * (dpt[j][e] - ((e & 1) ? dd.y : dd.x));
            dpt[j][e] = (inside || ((e & 1) ? l.y : l.x) > 0.5f * kNegInf)
                            ? ds : 0.f;
          }
        }
      }
      // dK += dS^T Q
      if constexpr (kDk) mma_cols<D, kSub>(dka, dpt, sq, lane);
    }
    __syncthreads();  // this buffer is consumed before it is loaded again
    r = r_next, qt = qt_next, buf ^= 1;
  }

  // dK * scale and dV through buffer 0 (consumed) to global
  if constexpr (kDk)
    store_rows<D>(dk + kv_off, dka, scale, s.q[0], k0, s_len, kv_row, warp,
                  lane);
  if constexpr (kDv)
    store_rows<D>(dv + kv_off, dva, 1.f, s.dout[0], k0, s_len, kv_row, warp,
                  lane);
}

template <int D>
struct DqStage {
  bf16 k[2][kStepB][D + kPad];
  bf16 v[2][kStepB][D + kPad];
};
template <int D>
struct DqStageQO : DqStage<D> {  // Q and dO kept staged (D > 64)
  bf16 q[kTB][D + kPad];
  bf16 dout[kTB][D + kPad];
};
template <int D>
using DqSmem =
    typename std::conditional<kAInRegs<D>, DqStage<D>, DqStageQO<D>>::type;

// dQ: one CTA per (b, head, 64-row q tile), the last tiles (the heaviest
// under a causal band) first
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreadsB, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         bf16* __restrict__ dq, int t_len, int s_len,
                         int n_heads, int n_kv, int causal, int window,
                         float scale, float softcap) {
  constexpr int kSub = kSubQ<D>;
  DqSmem<D>& s = shared_stage<DqSmem<D>>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int g = h / (n_heads / n_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTB;
  const int q_hi = min(q0 + kTB, t_len) - 1;
  const int64_t q_row = (int64_t)n_heads * D, kv_row = (int64_t)n_kv * D;
  const int64_t q_off = (int64_t)b * t_len * q_row + (int64_t)h * D;
  const int64_t kv_off = (int64_t)b * s_len * kv_row + (int64_t)g * D;
  const int64_t lrow = ((int64_t)b * n_heads + h) * t_len;

  // keys [k_begin, k_end) that some row of the tile keeps (a row with no
  // key in its band gets dQ = 0)
  int k_begin = 0, k_end = s_len;
  if (causal) k_end = min(s_len, q_hi + 1);
  if (window > 0) k_begin = max(q0 - window + 1, 0) / kStepB * kStepB;
  const int n_tiles = max(k_end - k_begin + kStepB - 1, 0) / kStepB;

  // Q and dO through buffer 1 into A fragments (or to their own tiles);
  // the first K/V tile to buffer 0
  if constexpr (kAInRegs<D>) {
    stage_rows<D>(s.k[1], q + q_off, q0, t_len, q_row);
    stage_rows<D>(s.v[1], dout + q_off, q0, t_len, q_row);
  } else {
    stage_rows<D>(s.q, q + q_off, q0, t_len, q_row);
    stage_rows<D>(s.dout, dout + q_off, q0, t_len, q_row);
  }
  if (n_tiles > 0) {
    stage_rows<D>(s.k[0], k + kv_off, k_begin, s_len, kv_row);
    stage_rows<D>(s.v[0], v + kv_off, k_begin, s_len, kv_row);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kAInRegs<D> ? D / 16 : 1][4], dof[kAInRegs<D> ? D / 16 : 1][4];
  if constexpr (kAInRegs<D>) {
    load_a<D>(qf, s.k[1], warp, lane);
    load_a<D>(dof, s.v[1], warp, lane);
    __syncthreads();
  }

  // this thread's two rows: lse (base 2), D, and whether a key is kept
  const int qp[2] = {q0 + warp * 16 + gr, q0 + warp * 16 + gr + 8};
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
  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const float sl2 = scale * kLog2e;
  // softcap (kCap): P = 2^(c log2(e) tanh(s scale / c) - lse log2(e))
  const float cap_in = kCap ? scale / softcap : 0.f;
  const float cap_l2 = kCap ? softcap * kLog2e : 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = k_begin + it * kStepB;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage_rows<D>(s.k[buf ^ 1], k + kv_off, kb + kStepB, s_len, kv_row);
      stage_rows<D>(s.v[buf ^ 1], v + kv_off, kb + kStepB, s_len, kv_row);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool inside = kb + kStepB <= s_len &&
                        (!causal || kb + kStepB - 1 <= q0) &&
                        (window <= 0 || kb > q_hi - window);
    // kSub keys of the stage at a time
#pragma unroll
    for (int sub = 0; sub < kStepB; sub += kSub) {
      const bf16(*tk)[D + kPad] = s.k[buf] + sub;
      const bf16(*tv)[D + kPad] = s.v[buf] + sub;
      // S = Q K^T and dP = dO V^T (16 rows x kSub keys)
      float sc[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      if constexpr (kAInRegs<D>) {
        mma_rows<D, kSub>(sc, qf, tk, lane);
        mma_rows<D, kSub>(dp, dof, tv, lane);
      } else {
        mma_rows<D, kSub>(sc, s.q, tk, warp, lane);
        mma_rows<D, kSub>(dp, s.dout, tv, warp, lane);
      }
      // dS = P (dP - D) (times the cap's derivative) in place of S
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float ds;
          if constexpr (kCap) {
            const float th = tanhf(sc[j][e] * cap_in);
            ds = fast_exp2(fmaf(cap_l2, th, -l2[i])) * (dp[j][e] - dr[i]) *
                 (1.f - th * th);
          } else {
            ds = fast_exp2(fmaf(sc[j][e], sl2, -l2[i])) * (dp[j][e] - dr[i]);
          }
          if (inside) {
            sc[j][e] = ds;
          } else {
            const int kp = kb + sub + j * 8 + tc * 2 + (e & 1);
            const bool kept = live[i] && kp < s_len &&
                              keep(qp[i], kp, causal, window);
            sc[j][e] = kept ? ds : 0.f;
          }
        }
      }
      // dQ += dS K
      mma_cols<D, kSub>(dqa, sc, tk, lane);
    }
    __syncthreads();  // this buffer is consumed before it is loaded again
  }

  // dQ * scale through buffer 0 (consumed) to global
  store_rows<D>(dq + q_off, dqa, scale, s.k[0], q0, t_len, q_row, warp,
                lane);
}

// the dK/dV kernel as pass PASS on `stream`
template <int D, int PASS, bool kCap>
int launch_dkdv_bf16(const void* q, const void* k, const void* v,
                     const void* lse, const void* dout, void* dk, void* dv,
                     const float* dsum, int batch, int t_len, int s_len,
                     int n_heads, int n_kv, int causal, int window,
                     float scale, float softcap, cudaStream_t stream) {
  const dim3 g_kv(batch * n_kv, (s_len + kTB - 1) / kTB);
  constexpr int smem = dynamic_smem_bytes<DkdvSmem<D>>();
  const int err =
      allow_dynamic_smem<flash_bwd_dkdv_bf16_kernel<D, PASS, kCap>, smem>();
  if (err) return err;
  flash_bwd_dkdv_bf16_kernel<D, PASS, kCap>
      <<<g_kv, kThreadsB, smem, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          (const float*)lse, dsum, (bf16*)dk, (bf16*)dv, t_len, s_len,
          n_heads, n_kv, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

// the bf16 kernels (the dK/dV kernel's passes, then dQ) on `stream`
template <int D, bool kCap>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* lse, const void* dout, void* dq, void* dk,
                void* dv, const float* dsum, int batch, int t_len,
                int s_len, int n_heads, int n_kv, int causal, int window,
                float scale, float softcap, cudaStream_t stream) {
  int err;
  if constexpr (D <= 128) {
    err = launch_dkdv_bf16<D, kDkdvBoth, kCap>(q, k, v, lse, dout, dk, dv,
                                               dsum, batch, t_len, s_len,
                                               n_heads, n_kv, causal, window,
                                               scale, softcap, stream);
  } else {  // a dV pass, then a dK pass
    err = launch_dkdv_bf16<D, kDkdvOnlyDv, kCap>(q, k, v, lse, dout, dk, dv,
                                                 dsum, batch, t_len, s_len,
                                                 n_heads, n_kv, causal,
                                                 window, scale, softcap,
                                                 stream);
    if (err) return err;
    err = launch_dkdv_bf16<D, kDkdvOnlyDk, kCap>(q, k, v, lse, dout, dk, dv,
                                                 dsum, batch, t_len, s_len,
                                                 n_heads, n_kv, causal,
                                                 window, scale, softcap,
                                                 stream);
  }
  if (err) return err;
  const dim3 g_q(batch * n_heads, (t_len + kTB - 1) / kTB);
  constexpr int smem_q = dynamic_smem_bytes<DqSmem<D>>();
  err = allow_dynamic_smem<flash_bwd_dq_bf16_kernel<D, kCap>, smem_q>();
  if (err) return err;
  flash_bwd_dq_bf16_kernel<D, kCap><<<g_q, kThreadsB, smem_q, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, dsum, (bf16*)dq, t_len, s_len, n_heads, n_kv,
      causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           int o_f32, const void* lse, const void* dout, void* dq, void* dk,
           void* dv, float* dsum, int batch, int t_len, int s_len,
           int n_heads, int n_kv, int causal, int window, float scale,
           float softcap, cudaStream_t stream) {
  const int n_rows = batch * t_len * n_heads;
  const int dot_blocks = (n_rows + 7) / 8;
  if (o_f32)
    flash_bwd_dot_kernel<float, T><<<dot_blocks, 256, 0, stream>>>(
        (const float*)o, (const T*)dout, dsum, n_rows, t_len, n_heads, D);
  else
    flash_bwd_dot_kernel<T, T><<<dot_blocks, 256, 0, stream>>>(
        (const T*)o, (const T*)dout, dsum, n_rows, t_len, n_heads, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if constexpr (std::is_same<T, bf16>::value) {
    if (softcap > 0.f)
      return launch_bf16<D, true>(q, k, v, lse, dout, dq, dk, dv, dsum,
                                  batch, t_len, s_len, n_heads, n_kv, causal,
                                  window, scale, softcap, stream);
    return launch_bf16<D, false>(q, k, v, lse, dout, dq, dk, dv, dsum, batch,
                                 t_len, s_len, n_heads, n_kv, causal, window,
                                 scale, softcap, stream);
  } else {
    constexpr int kThreads = kTile<D> * (D / kSlice<D>);
    const dim3 g_kv(batch * n_kv, (s_len + kTile<D> - 1) / kTile<D>);
    flash_bwd_dkdv_kernel<D, T><<<g_kv, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, dsum, (T*)dk, (T*)dv, t_len, s_len, n_heads,
        n_kv, causal, window, scale, softcap);
    err = (int)cudaGetLastError();
    if (err) return err;
    const dim3 g_q(batch * n_heads, (t_len + kTile<D> - 1) / kTile<D>);
    flash_bwd_dq_kernel<D, T><<<g_q, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, dsum, (T*)dq, t_len, s_len, n_heads, n_kv,
        causal, window, scale, softcap);
    return (int)cudaGetLastError();
  }
}

template <int D>
int launch_dtype(int is_bf16, const void* q, const void* k, const void* v,
                 const void* o, int o_f32, const void* lse, const void* dout,
                 void* dq, void* dk, void* dv, float* dsum, int batch,
                 int t_len, int s_len, int n_heads, int n_kv, int causal,
                 int window, float scale, float softcap, cudaStream_t st) {
  if (is_bf16)
    return launch<D, bf16>(q, k, v, o, o_f32, lse, dout, dq, dk, dv, dsum,
                           batch, t_len, s_len, n_heads, n_kv, causal,
                           window, scale, softcap, st);
  return launch<D, float>(q, k, v, o, 1, lse, dout, dq, dk, dv, dsum, batch,
                          t_len, s_len, n_heads, n_kv, causal, window, scale,
                          softcap, st);
}

// launch_dtype<head_dim>(args...), for the compiled head dims
template <typename... A>
int launch_dim(int head_dim, A... args) {
  switch (head_dim) {
    case 16:
      return launch_dtype<16>(args...);
    case 32:
      return launch_dtype<32>(args...);
    case 64:
      return launch_dtype<64>(args...);
    case 80:
      return launch_dtype<80>(args...);
    case 128:
      return launch_dtype<128>(args...);
    case 256:
      return launch_dtype<256>(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq (B,T,H,D); k, v, dk, dv (B,S,KV,D), all contiguous and of
// one dtype (is_bf16 ? bfloat16 : float32); o (B,T,H,D) contiguous, float32
// if o_f32 (as it always is with float32 inputs), else bfloat16; lse and
// dsum (B,H,T) float32, dsum scratch that the launch fills.  window <= 0
// means none; softcap <= 0 means none.  Three kernels on `stream` (four at
// D = 256 in bf16: the dot kernel, the dK/dV kernel's dV and dK passes,
// the dQ kernel); returns the first cudaGetLastError() that is not 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int batch, int t_len, int s_len, int n_heads, int n_kv,
    int head_dim, int causal, int window, int is_bf16, int o_f32,
    float scale, float softcap, void* stream) {
  return launch_dim(head_dim, is_bf16, q, k, v, o, o_f32, lse, dout, dq, dk,
                    dv, (float*)dsum, batch, t_len, s_len, n_heads, n_kv,
                    causal, window, scale, softcap, (cudaStream_t)stream);
}
