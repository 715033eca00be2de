// Flash attention (forward) for Hopper (sm_90a): bf16 on the tensor cores,
// float32 on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py, `_flash_kernel`, reached
// through `flash_attention` (and `ops.attention`): tiled online-softmax
// attention, causal and sliding-window masks by index, GQA by index mapping
// (q head h reads kv head h / rep), float32 running max, denominator and
// accumulator, output in q's dtype.
//
// Semantics shared by both kernels: masked scores are -1e30, as in the TPU
// kernel, so a row with no key in its band keeps the reference's uniform
// average; keys past S weigh exactly 0 (any T and S work); the result is
// divided by max(l, 1e-30).  Tiles wholly outside the causal or window band
// are skipped only when every row of the q tile has some key in the band:
// their weights are then exactly zero, so the result is unchanged.  The q
// tiles run heaviest (latest) first.
//
// What bounds it on the H100: at the llama3.2-1b prefill shape (q
// (4,512,32,64), k/v (4,512,8,64), bf16, causal) the function moves 21 MB
// (6.3 us at 3.35 TB/s) and does 4.3 GFLOP (4.3 us at the bf16 tensor-core
// rate), so bytes bound it, closely followed by the tensor cores.  The
// bf16 kernel is held back by neither: with its K/V loads removed it still
// takes ~80% of its time (scripts/flash_bf16_variants.py), which goes to
// each warp's dependent chain of `mma.sync`, softmax and `mma.sync` per
// tile and the two barriers a tile, with 16 warps an SM to hide it.
//
// bf16, the serving path (`flash_bf16_kernel`).  The earlier version ran
// these products on the CUDA cores in float32, one thread per query row,
// with bf16 K/V widened to float32 in shared memory: shared-memory
// broadcasts and the FMA rate held it at 40x its bound.  Here:
// - a CTA is 4 warps over a 64-row q tile, 16 rows a warp.  The q tile is
//   staged once through shared memory and held in `mma` A fragments
//   (`ldmatrix`);
// - 64-key K and V tiles stay bf16 in shared memory, double-buffered with
//   `cp.async`, so the next tile loads while this one computes.  Rows are
//   padded by 8 elements (16 B), so the 8 row addresses of each `ldmatrix`
//   fall in distinct bank groups.  Rows past T or S are zero-filled by the
//   copy's src-size operand, never read;
// - S = Q K^T by `mma.sync.m16n8k16` bf16 -> float32 (the products of bf16
//   values are exact in float32); 1/sqrt(D) and log2(e) scale S in
//   float32, and the softmax runs in base 2 on the accumulator fragments,
//   its row max and sum reduced across each quad with `__shfl_xor_sync`.
//   Running max, denominator and O stay in float32 registers;
// - O += P V: P is rounded to bf16 in registers and reused as the A
//   operand (the accumulator layout of two 8-key tiles is the A layout of
//   one 16-key step); V's B fragments come from `ldmatrix.trans`.  That
//   rounding of P (2^-9 relative a weight) is the only one the bf16 path
//   adds to the reference's arithmetic;
// - only the tiles the band's edge crosses, or that reach past S, are
//   masked element by element;
// - registers are capped at 128 a thread so 4 CTAs (16 warps) share an SM
//   to hide the latency of each warp's dependent mma -> softmax -> mma
//   chain, and 2^x runs as one `ex2.approx` (each faster at the llama
//   shape, spills included: scripts/flash_bf16_variants.py).  That holds
//   up to D = 64; see "Head dims" below for 80 and 128;
// - the output is staged through the q tile's shared memory and written
//   16 bytes a lane.
// `wgmma`, TMA and warp specialisation are later steps.
//
// Training (`flash_attention_lse_launch`): the same kernels also write each
// row's log-sum-exp of the masked scaled scores, lse (B,H,T) float32, which
// the backward kernels (flash_attention_bwd.cu) read to recompute P.  A row
// with no key in its band gets lse = -1e30 (the mask value) exactly, the
// backward's sign for "every key weighs 1/S".  The bf16 kernel also writes
// the float32 output (the accumulator over l, before its rounding to bf16)
// where it is given an `o32` pointer: the backward's D = rowsum(dO * O)
// from the bf16 output moved dQ and dK by up to 0.005 of their scale, past
// the 2^-8 tolerance, on non-causal attention.  It costs 4 bytes an output
// element written, beside the 2 of the bf16 output.  `flash_attention_launch`
// passes no lse and no o32 pointer, and the serving path is unchanged.
//
// Head dims 16, 32, 64, 80 (h2o-danube) and 128 (qwen2-vl).  D = 80 is 5
// k-steps of 16 and 10 n-tiles of 8 (the P V loop pairs n-tiles within
// each 16 columns, so nothing needs D / 16 even); its padded rows of 88
// bf16 (176 B) keep `ldmatrix` rows 16-byte aligned and their 8 addresses
// in distinct bank groups, as 72 and 136 do.  Past D = 64 the stage (q
// tile and double-buffered K/V) outgrows the 48 KB of static shared
// memory: 55 KB at 80, 85 KB at 128, taken as dynamic shared memory
// (`shared_stage`, device_helpers.cuh), and the O accumulator grows to
// 40 and 64 floats a thread.  So each head dim has its own CTAs an SM
// (`kFwdCtas`): 4 up to 64, 3 at 80 and 2 at 128, which lifts the
// register cap from 128 to 170 and 255; an SM then runs 12 or 8 warps.
//
// Head dim 256 (gemma3).  bf16: O's accumulator alone is 128 floats a
// thread (16 rows x 256 / 32 lanes), so q's A fragments (64 registers
// more) no longer stay in registers: each k-step reads its fragment from
// the staged q tile by `ldmatrix` (`kQFrags`), as the backward kernels do
// past D = 64, and the K/V tiles hold 32 keys (`kTK`), so S is 16 floats
// a thread.  The stage is 64 x 264 + 2 x 2 x 32 x 264 bf16, 99 KB of
// dynamic shared memory, and 2 CTAs share an SM (64-key tiles would take
// 165 KB and leave one).  float32: one thread cannot hold a 256-float
// accumulator, so 4 threads share a q row (`kFSplit`), each owning every
// 4th float4 of the head dim (neighbouring 16-byte words of a key, no bank
// conflict), their partial dot products summed by `__shfl_xor_sync`; a
// CTA is 256 threads and its stage 128 KB, dynamic.
//
// Softcap (gemma3's option; 0 = off): each scaled score s becomes
// c tanh(s / c) in float32 (`tanhf`) before the mask, as in the JAX
// package's plain attention; the bf16 kernel then multiplies by log2(e)
// for its base-2 softmax, and lse is the natural-log lse of the capped
// scores.  The bf16 kernel takes it as a template flag (`kCap`), each head
// dim built with and without: a runtime branch there cost the uncapped
// kernel 11% at the llama shape on an H100 (q (4,512,32,64), the tanhf
// code's registers spilled at the D = 64 cap of 128; timed against the
// source before the cap by scripts/flash_bf16_variants.py --baseline),
// and uncapped it is the
// kernel as it was.  The float32 kernel takes it at run time.
//
// float32 (`flash_f32_kernel`), what the per-layer route checks compute:
// one CTA owns one (batch x head, 64-row q tile), one thread per query row
// (up to D = 128), and loops over 32-key tiles loaded coalesced into
// shared memory, read by every thread as a broadcast.  The q row is held
// pre-scaled by 1/sqrt(D) in registers with its float32 accumulator, max
// and denominator (read from shared memory at D = 128, `kQInRegs`).  TF32
// tensor cores would keep 10 bits of the mantissa, too few for the float32
// checks, so this path stays on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_helpers.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

// ---------------------------------------------------------------------------
// Which key tiles a q tile visits
// ---------------------------------------------------------------------------

struct Band {
  int k_begin, k_end;
};

// Keys [k_begin, k_end) that the q tile [q0, q_hi] visits, in steps of
// `tile` from k_begin.  Does every row of the tile keep some key?  Validity
// only gets harder as the row grows, so the last row decides; if one row
// keeps none, every key is visited so that row averages them all.
__device__ __forceinline__ Band band(int q0, int q_hi, int s_len, int causal,
                                     int window, int tile) {
  const int k_max = causal ? min(q_hi, s_len - 1) : s_len - 1;
  const int k_min = window > 0 ? max(q_hi - window + 1, 0) : 0;
  Band bd{0, s_len};
  if (k_max >= k_min) {
    if (causal) bd.k_end = min(s_len, q_hi + 1);
    if (window > 0) bd.k_begin = max(q0 - window + 1, 0) / tile * tile;
  }
  return bd;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // query rows per CTA, one thread each
constexpr int kBK = 32;  // keys per shared-memory tile

template <int D>
struct F32Smem {
  float k[kBK][D];
  float v[kBK][D];
  float q[kBQ][D + 1];  // q in, o out; +1 avoids bank conflicts
};

// Threads a q row: 1 up to D = 128, 4 at D = 256 (see "Head dim 256").
// Thread `part` of a row owns the float4s part, part + SPLIT, ... of the
// head dim: its e-th value is dim f32_dim<SPLIT>(e, part).
template <int D>
constexpr int kFSplit = D == 256 ? 4 : 1;

template <int SPLIT>
__device__ __forceinline__ int f32_dim(int e, int part) {
  return ((e >> 2) * SPLIT + part) * 4 + (e & 3);
}

// Up to 80 head dims a thread (D = 256: 64 a thread) holds its q values in
// registers beside its accumulator; at D = 128 the two would take 256 of
// the 255 registers a thread may have, so the row is read from its
// (conflict-free) row of s_q for each key, and the stage, 64 KB, takes
// dynamic shared memory.
template <int D>
constexpr bool kQInRegs = D / kFSplit<D> <= 80;

template <int D>
__global__ void __launch_bounds__(kBQ * kFSplit<D>)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int t_len, int s_len, int n_heads, int n_kv, int causal,
                 int window, float scale, float softcap) {
  constexpr int SPLIT = kFSplit<D>;
  constexpr int DS = D / SPLIT;            // head dims a thread owns
  constexpr int kThreadsF = kBQ * SPLIT;
  F32Smem<D>& sm = shared_stage<F32Smem<D>>();
  auto& s_k = sm.k;
  auto& s_v = sm.v;
  auto& s_q = sm.q;

  const int tid = threadIdx.x;
  const int row = tid / SPLIT, part = tid % SPLIT;
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

  for (int i = tid; i < kBQ * D; i += kThreadsF) {
    const int r = i / D, d = i % D;
    s_q[r][d] = r < rows ? q[q_off + r * q_row + d] * scale : 0.f;
  }
  __syncthreads();
  float qr[kQInRegs<D> ? DS : 1], acc[DS];
#pragma unroll
  for (int e = 0; e < DS; ++e) {
    if constexpr (kQInRegs<D>) qr[e] = s_q[row][f32_dim<SPLIT>(e, part)];
    acc[e] = 0.f;
  }
  auto qv = [&](int e) {
    if constexpr (kQInRegs<D>) return qr[e];
    else return s_q[row][f32_dim<SPLIT>(e, part)];
  };
  float m = kNegInf, l = 0.f;
  const int qpos = q0 + row;
  const Band bd = band(q0, q0 + rows - 1, s_len, causal, window, kBK);
  const float cap_in = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int k0 = bd.k_begin; k0 < bd.k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kThreadsF) {
      const int r = i / D, d = i % D;
      const int kp = k0 + r;
      const bool in = kp < s_len;
      s_k[r][d] = in ? k[kv_off + kp * kv_row + d] : 0.f;
      s_v[r][d] = in ? v[kv_off + kp * kv_row + d] : 0.f;
    }
    __syncthreads();

    float sc[kBK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < DS; e += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(
            &s_k[j][f32_dim<SPLIT>(e, part)]);
        dot = fmaf(qv(e), kk.x, dot);
        dot = fmaf(qv(e + 1), kk.y, dot);
        dot = fmaf(qv(e + 2), kk.z, dot);
        dot = fmaf(qv(e + 3), kk.w, dot);
      }
      dot = lanes_sum<SPLIT>(dot);
      if (softcap > 0.f) dot = softcap * tanhf(dot * cap_in);
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
    for (int e = 0; e < DS; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = sc[j];
#pragma unroll
      for (int e = 0; e < DS; e += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(
            &s_v[j][f32_dim<SPLIT>(e, part)]);
        acc[e] = fmaf(p, vv.x, acc[e]);
        acc[e + 1] = fmaf(p, vv.y, acc[e + 1]);
        acc[e + 2] = fmaf(p, vv.z, acc[e + 2]);
        acc[e + 3] = fmaf(p, vv.w, acc[e + 3]);
      }
    }
    m = m_new;
  }

  const float den = fmaxf(l, 1e-30f);
  if (lse != nullptr && part == 0 && row < rows)  // (B,H,T); m is -1e30
    lse[((int64_t)b * n_heads + h) * t_len + q0 + row] =  // iff no key kept
        m <= kNegInf ? kNegInf : m + logf(l);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < DS; ++e) s_q[row][f32_dim<SPLIT>(e, part)] = acc[e] / den;
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreadsF) {
    const int r = i / D, d = i % D;
    o[q_off + r * q_row + d] = s_q[r][d];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kTQ = 64;     // query rows per CTA
constexpr int kWarps = 4;   // 16 query rows a warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;     // bf16 elements of padding a shared-memory row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Keys a K/V tile: 64, or 32 at D = 256 (see "Head dim 256").
template <int D>
constexpr int kTK = D <= 128 ? 64 : 32;
// q's A fragments held in registers for the whole kernel (up to D = 128),
// or read from the staged q tile by `ldmatrix` at each k-step (D = 256).
template <int D>
constexpr bool kQFrags = D <= 128;

// ROWS rows [row0, row0 + ROWS) of a (rows, D) slab with `stride` elements
// between rows -> shared memory; rows >= n_rows are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16 (*dst)[D + kPad],
                                          const bf16* __restrict__ src,
                                          int row0, int n_rows,
                                          int64_t stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = row0 + r < n_rows;
    cp_async16(&dst[r][c], src + (in ? row0 + r : 0) * stride + c, in);
  }
}

template <int D>
struct FwdSmem {
  bf16 q[kTQ][D + kPad];  // q in, o out
  bf16 k[2][kTK<D>][D + kPad];
  bf16 v[2][kTK<D>][D + kPad];
};

// CTAs an SM each head dim is built for, which caps its registers: 4 up
// to D = 64 (128 registers a thread, 45 KB of static shared memory a CTA);
// 3 at D = 80 (170 registers: 40 accumulator floats and 20 q fragment
// registers beside the 32 scores; 55 KB, dynamic); 2 at D = 128 (255
// registers for 64 accumulator floats and 32 q fragment registers; 85 KB,
// dynamic, of which the SM holds two) and at D = 256 (128 accumulator
// floats and 16 scores; 99 KB, dynamic).
template <int D>
constexpr int kFwdCtas = D <= 64 ? 4 : (D <= 80 ? 3 : 2);

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, kFwdCtas<D>)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ o32, float* __restrict__ lse, int t_len, int s_len, int n_heads, int n_kv, int causal,
                  int window, float scale, float softcap) {
  constexpr int TK = kTK<D>;
  FwdSmem<D>& sm = shared_stage<FwdSmem<D>>();
  auto& s_q = sm.q;
  auto& s_k = sm.k;
  auto& s_v = sm.v;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;  // fragment row, column pair
  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int g = h / (n_heads / n_kv);                  // GQA: kv head h / rep
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTQ;   // heaviest tiles first
  const int q_hi = min(q0 + kTQ, t_len) - 1;
  const int64_t q_row = (int64_t)n_heads * D;          // stride between tokens
  const int64_t kv_row = (int64_t)n_kv * D;
  const int64_t q_off = (int64_t)b * t_len * q_row + (int64_t)h * D;
  const int64_t kv_off = (int64_t)b * s_len * kv_row + (int64_t)g * D;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  const Band bd = band(q0, q_hi, s_len, causal, window, TK);
  const int n_tiles = (bd.k_end - bd.k_begin + TK - 1) / TK;

  load_tile<D, kTQ>(s_q, q + q_off, q0, t_len, q_row);
  load_tile<D, TK>(s_k[0], kb, bd.k_begin, s_len, kv_row);
  load_tile<D, TK>(s_v[0], vb, bd.k_begin, s_len, kv_row);
  cp_async_commit();

  // this warp's 16 q rows as A fragments (kQFrags)
  uint32_t qf[kQFrags<D> ? D / 16 : 1][4];
  float acc[D / 8][4];      // O, 16 rows x D
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // rows gr and gr + 8 (base-2 scores)
  float l_run[2] = {0.f, 0.f};          // this thread's share of the sums
  const int qp[2] = {q0 + warp * 16 + gr, q0 + warp * 16 + gr + 8};
  const float sl2 = scale * kLog2e;
  // softcap (kCap): x = c log2(e) tanh(s scale / c)
  const float cap_in = kCap ? scale / softcap : 0.f;
  const float cap_l2 = kCap ? softcap * kLog2e : 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = bd.k_begin + it * TK;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      load_tile<D, TK>(s_k[buf ^ 1], kb, k0 + TK, s_len, kv_row);
      load_tile<D, TK>(s_v[buf ^ 1], vb, k0 + TK, s_len, kv_row);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQFrags<D>) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc)
          ldsm_x4(qf[kc],
                  &s_q[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
      }
    }

    // S = Q K^T: 16 rows x TK keys, as TK / 8 tiles of 8 keys
    float s[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4];
      if constexpr (kQFrags<D>) {
        qa[0] = qf[kc][0], qa[1] = qf[kc][1], qa[2] = qf[kc][2],
        qa[3] = qf[kc][3];
      } else {
        ldsm_x4(qa, &s_q[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int jp = 0; jp < TK / 16; ++jp) {
        uint32_t kf[4];  // B fragments of key tiles 2jp and 2jp + 1
        ldsm_x4(kf, &s_k[buf][jp * 16 + (lane & 7) + ((lane >> 4) << 3)]
                         [kc * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * jp], qa, kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qa, kf[2], kf[3]);
      }
    }

    // scale to base 2 (capped first with a softcap); mask only where the
    // band's edge or S crosses the tile
    const bool inside = k0 + TK <= s_len && (!causal || k0 + TK - 1 <= q0) &&
                        (window <= 0 || k0 > q_hi - window);
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if constexpr (kCap)
          x = cap_l2 * tanhf(s[j][e] * cap_in);
        else
          x = s[j][e] * sl2;
        if (!inside) {
          const int kp = k0 + j * 8 + tc * 2 + (e & 1);
          const int row = qp[e >> 1];
          const bool keep = (!causal || kp <= row) &&
                            (window <= 0 || kp > row - window);
          x = kp >= s_len ? -INFINITY : (keep ? x : kNegInf);
        }
        s[j][e] = x;
      }
    }

    // online softmax: row max across the quad, rescale, P = 2^(S - max)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2], p_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = fast_exp2(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - mx[e >> 1]);
        p_sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + p_sum[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, 16 keys a step; P in bf16 as the A operand
#pragma unroll
    for (int kc = 0; kc < TK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vf[4];  // B fragments of d tiles 2np and 2np + 1
        ldsm_x4_trans(vf, &s_v[buf][kc * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8]
                               [np * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before it is loaded again
  }

  // epilogue: the row sums across the quad, O / l through the warp's own
  // rows of s_q (no other warp reads them), 16 bytes a lane to global
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    den[r] = fmaxf(l_run[r], 1e-30f);
  }
  if (lse != nullptr && tc == 0) {  // natural log: (m2 + log2 l) ln 2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qp[r] < t_len)
        lse[((int64_t)b * n_heads + h) * t_len + qp[r]] =
            m_run[r] <= kNegInf ? kNegInf
                                : (m_run[r] + log2f(l_run[r])) * kLn2;
    }
  }
  if (o32 != nullptr) {  // float32 O straight from the fragments, 8 B a lane
    float* ob32 = o32 + q_off;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + tc * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qp[r] < t_len)
          *reinterpret_cast<float2*>(ob32 + qp[r] * q_row + c) = make_float2(
              acc[n][2 * r] / den[r], acc[n][2 * r + 1] / den[r]);
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + tc * 2;
    *reinterpret_cast<uint32_t*>(&s_q[warp * 16 + gr][c]) =
        pack_bf16(acc[n][0] / den[0], acc[n][1] / den[0]);
    *reinterpret_cast<uint32_t*>(&s_q[warp * 16 + gr + 8][c]) =
        pack_bf16(acc[n][2] / den[1], acc[n][3] / den[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  bf16* ob = o + q_off;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = warp * 16 + i / kChunks, c = (i % kChunks) * 8;
    if (q0 + r < t_len)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * q_row + c) =
          *reinterpret_cast<const uint4*>(&s_q[r][c]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* o32,
           float* lse, int batch, int t_len, int s_len, int n_heads, int n_kv,
           int causal, int window, int is_bf16, float scale, float softcap,
           cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid(batch * n_heads, (t_len + kTQ - 1) / kTQ);
    constexpr int smem = dynamic_smem_bytes<FwdSmem<D>>();
    int err;
    if (softcap > 0.f) {
      err = allow_dynamic_smem<flash_bf16_kernel<D, true>, smem>();
      if (err) return err;
      flash_bf16_kernel<D, true><<<grid, kThreads, smem, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, o32,
          lse, t_len, s_len, n_heads, n_kv, causal, window, scale, softcap);
    } else {
      err = allow_dynamic_smem<flash_bf16_kernel<D, false>, smem>();
      if (err) return err;
      flash_bf16_kernel<D, false><<<grid, kThreads, smem, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, o32,
          lse, t_len, s_len, n_heads, n_kv, causal, window, scale, softcap);
    }
  } else {
    const dim3 grid(batch * n_heads, (t_len + kBQ - 1) / kBQ);
    constexpr int smem = dynamic_smem_bytes<F32Smem<D>>();
    const int err = allow_dynamic_smem<flash_f32_kernel<D>, smem>();
    if (err) return err;
    flash_f32_kernel<D><<<grid, kBQ * kFSplit<D>, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
        t_len, s_len, n_heads, n_kv, causal, window, scale, softcap);
  }
  return (int)cudaGetLastError();
}

// launch<head_dim>(args...), for the compiled head dims
template <typename... A>
int launch_dim(int head_dim, A... args) {
  switch (head_dim) {
    case 16:
      return launch<16>(args...);
    case 32:
      return launch<32>(args...);
    case 64:
      return launch<64>(args...);
    case 80:
      return launch<80>(args...);
    case 128:
      return launch<128>(args...);
    case 256:
      return launch<256>(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,T,H,D), k/v (B,S,KV,D), o (B,T,H,D), all contiguous and of one dtype
// (is_bf16 ? bfloat16, 16-byte aligned : float32).  window <= 0 means none;
// softcap <= 0 means none.  Returns the cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int t_len, int s_len, int n_heads,
                                      int n_kv, int head_dim, int causal,
                                      int window, int is_bf16, float scale,
                                      float softcap, void* stream) {
  return launch_dim(head_dim, q, k, v, o, (float*)nullptr, (float*)nullptr,
                    batch, t_len, s_len, n_heads, n_kv, causal, window,
                    is_bf16, scale, softcap, (cudaStream_t)stream);
}

// The same launch, also writing lse (B,H,T) float32 (contiguous): the
// training forward, whose backward is flash_attention_bwd_launch.  With
// bf16 inputs, o32 (B,T,H,D) float32 (contiguous), if not null, receives
// the output before its rounding to bf16; float32 inputs ignore it.
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* o, void* o32,
                                          void* lse, int batch, int t_len,
                                          int s_len, int n_heads, int n_kv,
                                          int head_dim, int causal, int window,
                                          int is_bf16, float scale,
                                          float softcap, void* stream) {
  return launch_dim(head_dim, q, k, v, o, (float*)o32, (float*)lse, batch,
                    t_len, s_len, n_heads, n_kv, causal, window, is_bf16,
                    scale, softcap, (cudaStream_t)stream);
}
