// The flash forward's kernels and their launch at one head dim, included
// by each of flash_fwd_d<D>.cu (one translation unit a head dim, so the
// build compiles them in parallel); flash_attention.cu holds the C entry
// points and the design note.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_helpers.cuh"
#include "hopper.cuh"

// One launch: q (B,T,H,D), k/v (B,S,KV,D), o (B,T,H,D); o32 and lse may
// be null (see flash_attention.cu).
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* o32;
  float* lse;
  int batch, t_len, s_len, n_heads, n_kv, causal, window, is_bf16;
  float scale, softcap;
  cudaStream_t stream;
};

// The forward at head dim D -> cudaGetLastError() of its launch; defined
// in flash_fwd_d<D>.cu.
template <int D>
int flash_fwd_launch(const FwdArgs& a);
template <>
int flash_fwd_launch<16>(const FwdArgs& a);
template <>
int flash_fwd_launch<32>(const FwdArgs& a);
template <>
int flash_fwd_launch<64>(const FwdArgs& a);
template <>
int flash_fwd_launch<80>(const FwdArgs& a);
template <>
int flash_fwd_launch<128>(const FwdArgs& a);
template <>
int flash_fwd_launch<256>(const FwdArgs& a);

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
// bf16: tensor cores (wgmma), TMA loads, warp-specialised
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kTQ = 128;           // q rows a CTA: two consumer warpgroups
constexpr int kConsumers = 2;      // warpgroups of 64 rows (wgmma's M)
// the consumers, then the producer warpgroup (one warp of it works)
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240; //   = the 384 x 168 of the launch
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Keys a K/V tile: 128, or 80 at D = 256 (its 128-float O accumulator
// beside S and P, and shared memory for 2 stages).
template <int D>
constexpr int kTK = D <= 128 ? 128 : 80;
// Stages of the K/V ring: 3 where shared memory holds them (D <= 128:
// 229 KB at 128), else 2.
template <int D>
constexpr int kStages = D <= 128 ? 3 : 2;
// A head dim in column chunks as the TMA loads them: kWide of 64 columns
// (128-byte rows, 128-byte swizzle), then a tail of kTail = 16 (32-byte
// rows and swizzle) or 32 (64-byte) columns.  D = 80 is 64 + 16.
template <int D>
constexpr int kWide = D / 64;
template <int D>
constexpr int kTail = D % 64;
// O += P V as one wgmma over the whole head dim where D is 64-column
// chunks only, not a wgmma a chunk (P read from the registers once).
constexpr bool kWidePV = true;
// Each warpgroup overlaps its own work: O += P V of tile j runs on the
// tensor cores while the softmax of tile j + 1 runs on the CUDA cores (up
// to D = 128; at 256 it was slower, its S, P and O together too many
// registers).
template <int D>
constexpr bool kOverlap = D <= 128;
// The two consumers take turns to issue their products (named barriers),
// so that one's softmax runs while the other's products do: where each
// overlaps its own work (at D = 256 the turns were 5% slower).
template <int D>
constexpr bool kPingPong = kOverlap<D>;
constexpr int kTurnBarrier = 3;  // 3 + c: consumer c's turn; 1, 2: epilogue

// A tile of R rows of D columns in shared memory is its chunks one after
// the other, each R rows of its width; every chunk starts on a 1,024-byte
// boundary (R is a multiple of 8), where the swizzle patterns repeat.
template <int D>
__host__ __device__ constexpr int chunk_row_bytes(int c) {
  return c < kWide<D> ? 128 : kTail<D> * 2;
}
template <int D, int R>
__device__ __forceinline__ int chunk_base(int c) {
  return c * R * 128;
}
__device__ __forceinline__ Swizzle swizzle_of(int row_bytes) {
  return row_bytes == 128 ? kSw128 : row_bytes == 64 ? kSw64 : kSw32;
}

// The byte of element (row, col) of such a tile, through the swizzle the
// TMA wrote it with: 16-byte chunk index XOR bits 7.. of its offset.
template <int D, int R>
__device__ __forceinline__ int tile_byte(int row, int col) {
  const int c = min(col / 64, kWide<D>);
  const int rb = chunk_row_bytes<D>(c);
  int off = row * rb + (col - 64 * c) * 2;
  off ^= ((off >> 7) & (rb / 16 - 1)) << 4;
  return chunk_base<D, R>(c) + off;
}

// The K-major wgmma descriptor of k-step kc (16 columns) of a tile of R
// rows at shared address `tile`, from its row `row0` on: 8-row groups
// `sbo` = 8 rows apart, the step's 32 bytes inside the swizzled row.
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kc) {
  const int c = min(kc / 4, kWide<D>);
  const int rb = chunk_row_bytes<D>(c);
  return wgmma_desc(tile + chunk_base<D, R>(c) + row0 * rb +
                        (kc - 4 * c) * 32,
                    16, 8 * rb, swizzle_of(rb));
}

// The MN-major descriptor of a V tile (TK keys) from its chunk c on at key
// step kc (16 keys): 8-key groups 8 rows apart, and the next 64-column
// chunk a chunk further on (for a wgmma wider than one chunk).
template <int D, int TK>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int c,
                                                 int kc) {
  const int rb = chunk_row_bytes<D>(c);
  return wgmma_desc(tile + chunk_base<D, TK>(c) + kc * 16 * rb, TK * 128,
                    8 * rb, swizzle_of(rb));
}

template <int D>
struct alignas(1024) FwdSmem {
  bf16 q[kTQ * D];  // q in; each warpgroup's O out through its own rows
  bf16 k[kStages<D>][kTK<D> * D];
  bf16 v[kStages<D>][kTK<D> * D];
  uint64_t q_full;  // the q tile has landed
  // a stage's K, its V have landed; its K and V are consumed
  uint64_t full_k[kStages<D>], full_v[kStages<D>], empty[kStages<D>];
};
// Dynamic shared memory a CTA: the stage and room to align it to 1,024,
// and at least 116 KB, so that an SM never holds two CTAs (whose
// consumers' setmaxnreg.inc would wait for registers the other holds).
template <int D>
constexpr int kFwdSmemBytes =
    (int)sizeof(FwdSmem<D>) + 1024 > 116 * 1024
        ? (int)sizeof(FwdSmem<D>) + 1024
        : 116 * 1024;

// One R-row tile of a (D, heads, rows, batch) tensor map at (head, row0,
// b) -> dst, one TMA load a chunk, completing on `bar`.
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap& wide,
                                          const CUtensorMap& tail,
                                          uint64_t* bar, int head, int row0,
                                          int b) {
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
#pragma unroll
  for (int c = 0; c < kWide<D>; ++c)
    tma_load_4d(base + chunk_base<D, R>(c), &wide, bar, 64 * c, head, row0,
                b);
  if constexpr (kTail<D> > 0)
    tma_load_4d(base + chunk_base<D, R>(kWide<D>), &tail, bar,
                64 * kWide<D>, head, row0, b);
}

// The scores of one tile, masked only where `inside` is false (the band's
// edge or S crosses it) -> the factor that scales them to base 2.  Under a
// softcap they are capped and scaled here (factor 1); else the tiles that
// need no mask keep them as they are (factor 1/sqrt(D) log2(e), applied
// with the exponent's subtraction in one FFMA, exact in the max), and the
// masked ones are scaled before the mask (factor 1), so that a masked
// score is -1e30 in base 2 and a row with no key keeps weights of 1.
template <int TK, bool kCap>
__device__ __forceinline__ float score_tile(float (&s)[TK / 8][4], int k0,
                                            bool inside, const int (&qp)[2],
                                            int tc, int s_len, int causal,
                                            int window, float sl2,
                                            float cap_in, float cap_l2) {
  if (!kCap && inside) return sl2;
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
  return 1.f;
}

// The online softmax of one tile of scores (times `scale` in base 2): the
// row max across the quad, alpha = 2^(old max - new max), P = 2^(S scale -
// max) in place of S, and the running sums; max and sums in base 2.
template <int TK>
__device__ __forceinline__ void softmax_tile(float (&s)[TK / 8][4],
                                             float scale, float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {s[0][0], s[0][2]};
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m_run[r], mx[r] * scale);  // rounding is monotone
    alpha[r] = fast_exp2(m_run[r] - mx[r]);
    m_run[r] = mx[r];
  }
  float p_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = fast_exp2(fmaf(s[j][e], scale, -mx[e >> 1]));
      p_sum[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + p_sum[r];
}

// P rounded to bf16 as the A fragments of P V: the accumulator layout of
// 8-key tiles 2 kc and 2 kc + 1 is the A layout of 16-key step kc.
template <int TK>
__device__ __forceinline__ void pack_p(const float (&s)[TK / 8][4],
                                       uint32_t (&pa)[TK / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < TK / 16; ++kc) {
    pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
    pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
    pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
  }
}

// S = Q K^T over the head dim's 16-column steps; issued, not waited for.
template <int D, int TK>
__device__ __forceinline__ void issue_qk(float (&s)[TK / 8][4],
                                         uint32_t q_tile, int row0,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    Wgmma<TK>::ss(s, kmajor_desc<D, kTQ>(q_tile, row0, kc),
                  kmajor_desc<D, TK>(k_tile, 0, kc), kc > 0);
}

// O += P V for 16-key step kc, issued and not waited for: one wgmma over
// all of D where it is 64-column chunks only (D = 64, 128, 256), else a
// wgmma a chunk (chunk C on).
template <int D, int TK, int C = 0>
__device__ __forceinline__ void issue_pv_step(float (&o)[D / 8][4],
                                              const uint32_t (&a)[4],
                                              uint32_t v_tile, int kc) {
  if constexpr (kWidePV && kTail<D> == 0) {
    Wgmma<D>::template rs<0>(o, a, mnmajor_desc<D, TK>(v_tile, 0, kc));
  } else if constexpr (C < kWide<D>) {
    Wgmma<64>::rs<8 * C>(o, a, mnmajor_desc<D, TK>(v_tile, C, kc));
    issue_pv_step<D, TK, C + 1>(o, a, v_tile, kc);
  } else if constexpr (kTail<D> > 0) {
    Wgmma<kTail<D>>::template rs<8 * kWide<D>>(
        o, a, mnmajor_desc<D, TK>(v_tile, kWide<D>, kc));
  }
}

template <int D, int TK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 8][4],
                                         const uint32_t (&pa)[TK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < TK / 16; ++kc)
    issue_pv_step<D, TK>(o, pa[kc], v_tile, kc);
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 8][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// Where a consumer warp's cycles go (`clock64`), summed over the warps of
// every launch: compiled in only with FLASH_FWD_PHASES, which
// scripts/flash_bf16_variants.py --phases defines and reads back through
// `fwd_phases_take`; `mark(i)` charges the cycles since the last mark to
// phase i.  Without it the marks are empty.
enum FwdPhase {
  kWaitK,      // K of the tile lands
  kTurn,       // the other consumer issues (kPingPong<D>)
  kIssue,      // S = Q K^T and O += P V issued, V waited for
  kWaitS,      // S done
  kSoftmax,    // masks, scale, row max, exponentials, sums
  kWaitPV,     // O += P V done
  kPack,       // stage released, O rescaled, P packed to bf16
  kEpilogue,   // lse, float32 O, O in bf16
  kTiles,      // key tiles walked (a count, not cycles)
  kFwdPhases
};
#ifdef FLASH_FWD_PHASES
__device__ unsigned long long fwd_phase_sums[kFwdPhases];

struct Phases {
  long long t = 0;
  long long sum[kFwdPhases] = {};
  __device__ __forceinline__ void start() { t = clock64(); }
  __device__ __forceinline__ void mark(int i) {
    const long long now = clock64();
    sum[i] += now - t;
    t = now;
  }
  __device__ __forceinline__ void flush(int lane, int tiles) {
    sum[kTiles] = tiles;
    if (lane == 0)
      for (int i = 0; i < kFwdPhases; ++i)
        atomicAdd(&fwd_phase_sums[i], (unsigned long long)sum[i]);
  }
};

// The sums since the last call -> out (kFwdPhases values), then 0.
inline int fwd_phases_take(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, fwd_phase_sums,
                                      sizeof(fwd_phase_sums));
  const unsigned long long zero[kFwdPhases] = {};
  if (!err)
    err = (int)cudaMemcpyToSymbol(fwd_phase_sums, zero, sizeof(zero));
  return err;
}
#else
struct Phases {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int, int) {}
};
#endif

// One CTA a (batch x head, 128-row q tile), the q tiles of one (batch,
// head) consecutive (so the CTAs on the card at once share few heads' K
// and V in L2), heaviest first: warpgroups 0 and 1 are the consumers, each
// over 64 rows of the tile, and warpgroup 2 the producer (one thread
// issues every TMA load).  The maps: q over (D, H, T, B) in boxes of 128
// rows, k and v over (D, KV, S, B) in boxes of kTK rows; `wide` with
// 64-column boxes, `tail` with the tail's.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap q_wide,
                  const __grid_constant__ CUtensorMap q_tail,
                  const __grid_constant__ CUtensorMap k_wide,
                  const __grid_constant__ CUtensorMap k_tail,
                  const __grid_constant__ CUtensorMap v_wide,
                  const __grid_constant__ CUtensorMap v_tail,
                  bf16* __restrict__ o, float* __restrict__ o32,
                  float* __restrict__ lse, int t_len, int s_len, int n_heads,
                  int n_kv, int causal, int window, float scale,
                  float softcap) {
  constexpr int TK = kTK<D>;
  constexpr int NS = kStages<D>;
  extern __shared__ unsigned char fwd_smem[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      fwd_smem + ((1024 - (smem_addr(fwd_smem) & 1023)) & 1023));

  const int n_qt = (t_len + kTQ - 1) / kTQ;  // q tiles a (batch, head)
  const int bh = blockIdx.x / n_qt;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int g = h / (n_heads / n_kv);                  // GQA: kv head h / rep
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * kTQ;  // heaviest first
  const int q_hi = min(q0 + kTQ, t_len) - 1;
  const Band bd = band(q0, q_hi, s_len, causal, window, TK);
  const int n_tiles = (bd.k_end - bd.k_begin + TK - 1) / TK;
  // the warpgroup, read from lane 0 so the compiler knows it is uniform
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(&sm.full_k[st], 1);
      mbar_init(&sm.full_v[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: q once, then K and V tile by tile into the ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&sm.q_full, kTQ * D * 2);
      load_tile<D, kTQ>(sm.q, q_wide, q_tail, &sm.q_full, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NS;
        const int k0 = bd.k_begin + it * TK;
        if (it >= NS) mbar_wait(&sm.empty[st], (it / NS - 1) & 1);
        mbar_expect_tx(&sm.full_k[st], TK * D * 2);
        load_tile<D, TK>(sm.k[st], k_wide, k_tail, &sm.full_k[st], g, k0, b);
        mbar_expect_tx(&sm.full_v[st], TK * D * 2);
        load_tile<D, TK>(sm.v[st], v_wide, v_tail, &sm.full_v[st], g, k0, b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tc = lane & 3;  // fragment row, column pair
    const int r0 = cw * 64;                   // this warpgroup's rows
    const int qw0 = q0 + r0, qw_hi = min(qw0 + 64, t_len) - 1;
    const int qp[2] = {qw0 + warp * 16 + gr, qw0 + warp * 16 + gr + 8};
    const float sl2 = scale * kLog2e;
    // softcap (kCap): x = c log2(e) tanh(s scale / c)
    const float cap_in = kCap ? scale / softcap : 0.f;
    const float cap_l2 = kCap ? softcap * kLog2e : 0.f;
    const uint32_t q_tile = smem_addr(sm.q);

    float acc[D / 8][4];  // O, 64 rows x D over the warpgroup
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};  // rows gr and gr + 8 (base 2)
    float l_run[2] = {0.f, 0.f};          // this thread's share of the sums
    float s[TK / 8][4], alpha[2];
    uint32_t pa[TK / 16][4];
    Phases ph;
    ph.start();

    // turns (kPingPong<D>): wait for this consumer's, then, once its
    // products are issued, hand it to the other; the last hand-over of
    // consumer 1 is left out, so every arrival is waited for
    auto take_turn = [&]() {
      if constexpr (kPingPong<D>) named_barrier(kTurnBarrier + cw, 256);
    };
    auto pass_turn = [&](bool last) {
      if constexpr (kPingPong<D>)
        if (!(last && cw == 1)) named_barrier_arrive(kTurnBarrier + 1 - cw,
                                                     256);
    };
    // tile `it`: its K, then S = Q K^T issued (not waited for)
    auto issue_scores = [&](int it) {
      mbar_wait(&sm.full_k[it % NS], (it / NS) & 1);
      ph.mark(kWaitK);
      take_turn();
      ph.mark(kTurn);
      wgmma_fence();
      issue_qk<D, TK>(s, q_tile, r0, smem_addr(sm.k[it % NS]));
      wgmma_commit();
    };
    // its scores masked where the band's edge or S crosses it, P in
    // place of S, alpha
    auto softmax = [&](int it) {
      const int k0 = bd.k_begin + it * TK;
      const bool inside = k0 + TK <= s_len &&
                          (!causal || k0 + TK - 1 <= qw0) &&
                          (window <= 0 || k0 > qw_hi - window);
      const float scale = score_tile<TK, kCap>(
          s, k0, inside, qp, tc, s_len, causal, window, sl2, cap_in, cap_l2);
      softmax_tile<TK>(s, scale, m_run, l_run, alpha);
      ph.mark(kSoftmax);
    };
    // its V, then O += P V issued (not waited for; its turn taken)
    auto issue_values = [&](int it) {
      mbar_wait(&sm.full_v[it % NS], (it / NS) & 1);
      issue_pv<D, TK>(acc, pa, smem_addr(sm.v[it % NS]));
      wgmma_commit();
    };
    // its stage back to the producer, once this warp's wgmmas are done
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[it % NS]);
    };

    mbar_wait(&sm.q_full, 0);
    ph.mark(kWaitK);
    if constexpr (kPingPong<D>)  // consumer 0 issues first
      if (cw == 1) named_barrier_arrive(kTurnBarrier, 256);
    if constexpr (kOverlap<D>) {
      // per tile: S of this tile and O += P V of the previous one issued
      // together, this softmax while P V runs; P is packed only once that
      // P V is done (it reads the fragments asynchronously)
      issue_scores(0);
      pass_turn(false);
      ph.mark(kIssue);
      wgmma_wait<0>();
      fence_operands(s);
      ph.mark(kWaitS);
      softmax(0);
      pack_p<TK>(s, pa);
      ph.mark(kPack);
      for (int it = 1; it < n_tiles; ++it) {
        issue_scores(it);
        issue_values(it - 1);
        pass_turn(false);
        ph.mark(kIssue);
        wgmma_wait<1>();  // S
        fence_operands(s);
        ph.mark(kWaitS);
        softmax(it);
        wgmma_wait<0>();  // P V
        fence_operands(acc);
        ph.mark(kWaitPV);
        release(it - 1);
        rescale<D>(acc, alpha);
        pack_p<TK>(s, pa);
        ph.mark(kPack);
      }
      take_turn();
      ph.mark(kTurn);
      wgmma_fence();
      issue_values(n_tiles - 1);
      pass_turn(true);
      ph.mark(kIssue);
      wgmma_wait<0>();
      fence_operands(acc);
      ph.mark(kWaitPV);
      release(n_tiles - 1);
    } else {
      for (int it = 0; it < n_tiles; ++it) {
        issue_scores(it);
        pass_turn(false);
        ph.mark(kIssue);
        wgmma_wait<0>();
        fence_operands(s);
        ph.mark(kWaitS);
        softmax(it);
        rescale<D>(acc, alpha);
        pack_p<TK>(s, pa);
        ph.mark(kPack);
        take_turn();
        ph.mark(kTurn);
        wgmma_fence();
        issue_values(it);
        pass_turn(it == n_tiles - 1);
        ph.mark(kIssue);
        wgmma_wait<0>();
        fence_operands(acc);
        ph.mark(kWaitPV);
        release(it);
      }
    }

    // epilogue: the row sums across the quad, lse, the float32 O straight
    // from the fragments, and O / l in bf16 through this warpgroup's own
    // rows of the q tile, 16 bytes a lane to global
    float inv[2];  // 1 / max(l, 1e-30)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv[r] = 1.f / fmaxf(l_run[r], 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {  // O / l, both outputs' values
      acc[n][0] *= inv[0];
      acc[n][1] *= inv[0];
      acc[n][2] *= inv[1];
      acc[n][3] *= inv[1];
    }
    const int64_t q_row = (int64_t)n_heads * D;  // stride between tokens
    const int64_t q_off = (int64_t)b * t_len * q_row + (int64_t)h * D;
    if (lse != nullptr && tc == 0) {  // natural log: (m2 + log2 l) ln 2
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (qp[r] < t_len)
          lse[((int64_t)b * n_heads + h) * t_len + qp[r]] =
              m_run[r] <= kNegInf ? kNegInf
                                  : (m_run[r] + log2f(l_run[r])) * kLn2;
      }
    }
    if (o32 != nullptr) {  // 8 B a lane
      float* ob32 = o32 + q_off;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = n * 8 + tc * 2;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (qp[r] < t_len)
            *reinterpret_cast<float2*>(ob32 + qp[r] * q_row + c) =
                make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
    unsigned char* q_bytes = reinterpret_cast<unsigned char*>(sm.q);
    fence_proxy_async();
    named_barrier(1 + cw, 128);  // every warp's wgmma reads of q are done
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + tc * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(
            q_bytes + tile_byte<D, kTQ>(r0 + warp * 16 + gr + 8 * r, c)) =
            pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
    named_barrier(1 + cw, 128);
    constexpr int kChunks = D / 8;  // 16-byte chunks a row
    bf16* ob = o + q_off;
#pragma unroll 4
    for (int i = tid; i < 64 * kChunks; i += 128) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (qw0 + r < t_len)
        *reinterpret_cast<uint4*>(ob + (qw0 + r) * q_row + c) =
            *reinterpret_cast<const uint4*>(q_bytes +
                                            tile_byte<D, kTQ>(r0 + r, c));
    }
    ph.mark(kEpilogue);
    ph.flush(lane, n_tiles);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// A (batch, len, heads, d) bf16 tensor as a 4-D map (d, heads, len,
// batch), innermost first, in boxes of `cols` columns of one head and
// `rows` rows, swizzled as wide as a box row (128, 64 or 32 bytes).
// Elements past the tensor, rows past len included, load as zeros.
inline int tensor_map(CUtensorMap* map, const void* base, int batch,
                      int len, int heads, int d, int cols, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)len * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, bool kCap>
int launch_bf16(const FwdArgs& a) {
  // q, k, v: the 64-column map and the tail's (left zero where unused)
  CUtensorMap maps[3][2] = {};
  const void* base[3] = {a.q, a.k, a.v};
  const int len[3] = {a.t_len, a.s_len, a.s_len};
  const int heads[3] = {a.n_heads, a.n_kv, a.n_kv};
  const int rows[3] = {kTQ, kTK<D>, kTK<D>};
  for (int i = 0; i < 3; ++i) {
    int err = 0;
    if (kWide<D> > 0)
      err = tensor_map(&maps[i][0], base[i], a.batch, len[i], heads[i], D,
                       64, rows[i]);
    if (!err && kTail<D> > 0)
      err = tensor_map(&maps[i][1], base[i], a.batch, len[i], heads[i], D,
                       kTail<D>, rows[i]);
    if (err) return err;
  }
  constexpr int smem = kFwdSmemBytes<D>;
  const int err = allow_dynamic_smem<flash_bf16_kernel<D, kCap>, smem>();
  if (err) return err;
  const int grid = a.batch * a.n_heads * ((a.t_len + kTQ - 1) / kTQ);
  flash_bf16_kernel<D, kCap><<<grid, kThreads, smem, a.stream>>>(
      maps[0][0], maps[0][1], maps[1][0], maps[1][1], maps[2][0], maps[2][1],
      (bf16*)a.o, a.o32, a.lse, a.t_len, a.s_len, a.n_heads, a.n_kv,
      a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const FwdArgs& a) {
  if (a.is_bf16)
    return a.softcap > 0.f ? launch_bf16<D, true>(a) : launch_bf16<D, false>(a);
  const dim3 grid(a.batch * a.n_heads, (a.t_len + kBQ - 1) / kBQ);
  constexpr int smem = dynamic_smem_bytes<F32Smem<D>>();
  const int err = allow_dynamic_smem<flash_f32_kernel<D>, smem>();
  if (err) return err;
  flash_f32_kernel<D><<<grid, kBQ * kFSplit<D>, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      a.lse, a.t_len, a.s_len, a.n_heads, a.n_kv, a.causal, a.window,
      a.scale, a.softcap);
  return (int)cudaGetLastError();
}

}  // namespace
