// Fused HAIL split reader for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hail_reader.py, `_reader_kernel`, reached
// through `hail_read_batch` (and `hail_read`, its Q = 1 case).
//
// What bounds it on the H100: device-memory bytes.  Per row a live tile
// reads the key (4 B), the bad flag (1 B) and, where some query keeps the
// row, the C projected columns (4*C B); every row writes Q mask bytes and
// 4*C output bytes.  The arithmetic is a handful of integer compares per
// row and query, far below the card's operations-per-byte balance, so the
// floor is the bytes over 3.35 TB/s, and most of them are writes.
//
// What the design does about it, in two kernels behind one entry point:
//  * `reader_kernel_ranges` counts each block's root directory ONCE per
//    (block, query), one CTA each: count(mins < lo) and count(mins <= hi)
//    over the CTA's threads.  It is a count, not a binary search: the
//    directory is not checksummed, a corrupted one is out of order, and on
//    an unsorted directory a search gives another row range than the count
//    the reference takes.  The port's lower-bound rule:
//    p_first = max(count(mins < lo) - 1, 0), p_last = max(count(mins <= hi)
//    - 1, 0).  (The reference counts mins <= lo for p_first, which skips
//    rows equal to lo that sit before a partition starting with lo; see
//    ref.index_search.)  It writes {lo, hi, r0, r1} per (block, query) to a
//    scratch table, and the rows-read fraction.
//  * `reader_kernel_scan`, one CTA per (row tile, block), runs after it on
//    the stream.  A full-scan block's range is [0, rows) for every query,
//    so its CTAs take (lo, hi) from the query tensor and load their rows
//    with the block's scan mode; an indexed block's CTAs read the table
//    first.  A tile that no query's range touches loads nothing and
//    writes its zeros.  A live tile stages its keys and bad flags in
//    shared memory with 16-byte loads.  Its mask, the contiguous (rows x Q)
//    bytes of the output, is computed by a grid of threads over (rows,
//    queries), neighbouring threads on neighbouring bytes, each thread
//    holding its query's entry in registers while it walks its rows, into
//    a shared-memory window laid out at the output's own offset within 16
//    bytes; the window goes out as 16-byte stores.  The union of a row's
//    bytes lands in shared memory.  The (rows x C) projection range is
//    walked 4 ints a thread, loaded as one 16-byte vector only where a row
//    of the group is kept.  Where a range does not start or end on a
//    16-byte boundary (odd Q, C = 1 or 3, rows not a multiple of 16, an
//    input that is a view at an offset) a scalar head and tail cover the
//    rest.
//  * The scan kernel is built twice: for Q <= kOneWindowQ a tile's whole
//    mask is one window and the kernel fits 8 CTAs an SM; the other build
//    takes any Q.
//  * Any number of queries: the first kStageQ query entries are staged in
//    shared memory per CTA, later ones are read from the table or the
//    query tensor, and a mask of more than kWindow bytes a tile goes out
//    in several windows, so shared memory does not grow with Q.  The query
//    ranges arrive as a device tensor, never as scalar arguments, so a new
//    range never builds a new kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 1024;
constexpr int kThreads = 256;
constexpr int kWindow = 8192;       // mask bytes staged at a time
constexpr int kMinBlocks = 6;       // CTAs an SM (registers), Q > kOneWindowQ
constexpr int kMinBlocksOne = 8;    // and Q <= kOneWindowQ
constexpr int kOneWindowQ = 8;      // a tile's whole mask in one window
static_assert(kOneWindowQ * kTileRows <= kWindow, "one window a tile");
constexpr int kStageQ = 256;        // query entries staged
constexpr int kCountThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

// A range of n elements of `size` bytes starting at p: a scalar head up to
// the first 16-byte boundary, whole 16-byte groups, a scalar tail.
struct Span {
  int head;
  int64_t groups;
  int tail;
};

__device__ __forceinline__ Span split16(const void* p, int64_t n, int size) {
  const int per = 16 / size;
  const int64_t head =
      min((int64_t)(((16 - ((uintptr_t)p & 15)) & 15) / size), n);
  const int64_t groups = (n - head) / per;
  return {(int)head, groups, (int)(n - head - groups * per)};
}

__global__ void __launch_bounds__(kCountThreads)
reader_kernel_ranges(const int32_t* __restrict__ mins,
                     const int32_t* __restrict__ use_index,
                     const int32_t* __restrict__ lohi,
                     int4* __restrict__ qtab, float* __restrict__ frac,
                     int rows, int n_parts, int n_q, int partition_size) {
  __shared__ int s_cnt[2][kCountThreads / 32];
  const int q = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int lo = lohi[2 * q], hi = lohi[2 * q + 1];
  int r0 = 0, r1 = rows;
  if (use_index[b] > 0) {                    // the same for the whole CTA
    const int32_t* m = mins + (int64_t)b * n_parts;
    int c_lo = 0, c_hi = 0;
#pragma unroll 4
    for (int p = threadIdx.x; p < n_parts; p += kCountThreads) {
      const int v = m[p];
      c_lo += v < lo;
      c_hi += v <= hi;
    }
    c_lo = __reduce_add_sync(kAll, c_lo);
    c_hi = __reduce_add_sync(kAll, c_hi);
    if (lane == 0) {
      s_cnt[0][warp] = c_lo;
      s_cnt[1][warp] = c_hi;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    c_lo = c_hi = 0;
    for (int w = 0; w < kCountThreads / 32; ++w) {
      c_lo += s_cnt[0][w];
      c_hi += s_cnt[1][w];
    }
    r0 = max(c_lo - 1, 0) * partition_size;
    r1 = min((max(c_hi - 1, 0) + 1) * partition_size, rows);
  } else if (threadIdx.x != 0) {
    return;
  }
  const int64_t i = (int64_t)b * n_q + q;
  qtab[i] = make_int4(lo, hi, r0, r1);
  // IEEE division (no fast math), as the reference computes it
  frac[i] = (float)(r1 - r0) / (float)rows;
}

// A thread's share of a tile's keys and bad flags: n <= kTileRows =
// 4 * kThreads rows, so one 16-byte group of keys a thread at most and a
// fourth of that for the flags.  Loaded first, stored to shared memory
// later, so the loads overlap the others a CTA makes at its start.
struct Rows {
  int4 keys;
  uint4 bad;
};

__device__ __forceinline__ Rows load_rows(const int32_t* kt, const uint8_t* bt,
                                          int n) {
  const int t = threadIdx.x;
  const Span ks = split16(kt, n, 4);
  const Span bs = split16(bt, n, 1);
  Rows v = {make_int4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (t < ks.groups)
    v.keys = __ldg(reinterpret_cast<const int4*>(kt + ks.head) + t);
  if (t < bs.groups)
    v.bad = __ldg(reinterpret_cast<const uint4*>(bt + bs.head) + t);
  return v;
}

// the keys and good flags (bad == 0) of the tile's n rows into shared
// memory (scalar heads and tails loaded here), the union flags cleared
__device__ __forceinline__ void store_rows(Rows v, const int32_t* kt,
                                           const uint8_t* bt, int n,
                                           int32_t* s_key, uint8_t* s_good,
                                           uint8_t* s_any) {
  const int t = threadIdx.x;
  const Span ks = split16(kt, n, 4);
  const Span bs = split16(bt, n, 1);
  if (t < ks.head) s_key[t] = kt[t];
  if (t < ks.tail) s_key[n - ks.tail + t] = kt[n - ks.tail + t];
  if (t < bs.head) s_good[t] = bt[t] == 0;
  if (t < bs.tail) s_good[n - bs.tail + t] = bt[n - bs.tail + t] == 0;
  if (t < ks.groups) {
    int32_t* d = s_key + ks.head + 4 * t;
    d[0] = v.keys.x;
    d[1] = v.keys.y;
    d[2] = v.keys.z;
    d[3] = v.keys.w;
  }
  if (t < bs.groups) {
    const uint32_t w[4] = {v.bad.x, v.bad.y, v.bad.z, v.bad.w};
    uint8_t* d = s_good + bs.head + 16 * t;
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = ((w[k >> 2] >> (8 * (k & 3))) & 0xff) == 0;
  }
  reinterpret_cast<uint32_t*>(s_any)[t] = 0;   // kTileRows bytes
}

// query q's {lo, hi, r0, r1}: a full scan's range is [0, rows) for every
// query; an indexed block's comes from the table
__device__ __forceinline__ int4 table_entry(int q, bool full_scan,
                                            const int32_t* lohi,
                                            const int4* qt, int rows) {
  return full_scan ? make_int4(__ldg(lohi + 2 * q), __ldg(lohi + 2 * q + 1),
                               0, rows)
                   : __ldg(qt + q);
}

// One window of a tile's mask: rows [ra, rb) x queries [qa, qb), its
// bytes contiguous in the output (all queries of each row, or one row's
// slice when Q > kWindow), written to `out` in shared memory.
struct Window {
  int ra, rb, qa, qb, tile_lo;
  uint8_t* out;
};

// The window's bytes and the rows' union flags.  Threads form a grid of
// tq_n queries x tr_n rows (tq_n = min(Q, kThreads)): neighbouring threads
// write neighbouring bytes, and a thread keeps its query's entry in
// registers while it walks its rows.  With every query staged (kStaged)
// the loop reads shared memory only: without it the compiler emits the
// table read for every entry, needed or not.
template <bool kStaged>
__device__ __forceinline__ void mask_window(Window v, int tr, int tq,
                                            int tr_n, int tq_n,
                                            const int4* s_q,
                                            const int32_t* s_key,
                                            const uint8_t* s_good,
                                            uint8_t* s_any, bool full_scan,
                                            const int32_t* lohi,
                                            const int4* qt, int rows) {
  const int width = v.qb - v.qa;
  for (int q = v.qa + tq; q < v.qb; q += tq_n) {
    const int4 e = kStaged || q < kStageQ
                       ? s_q[q]
                       : table_entry(q, full_scan, lohi, qt, rows);
    const int lo = e.x, hi = e.y, r0 = e.z - v.tile_lo, r1 = e.w - v.tile_lo;
    uint8_t* o = v.out + (q - v.qa);
#pragma unroll 4
    for (int r = v.ra + tr; r < v.rb; r += tr_n) {
      const int key = s_key[r];
      const bool m = s_good[r] && key >= lo && key <= hi && r >= r0 && r < r1;
      o[(r - v.ra) * width] = m;
      if (m) s_any[r] = 1;
    }
  }
}

// w bytes from shared memory to dst, where src and dst share their offset
// within 16 bytes: a scalar head, 16-byte groups, a scalar tail
__device__ __forceinline__ void copy_out(uint8_t* dst, const uint8_t* src,
                                         int w) {
  const int t = threadIdx.x;
  const Span s = split16(dst, w, 1);
  if (t < s.head) dst[t] = src[t];
  for (int g = t; g < s.groups; g += kThreads)
    reinterpret_cast<uint4*>(dst + s.head)[g] =
        reinterpret_cast<const uint4*>(src + s.head)[g];
  if (t < s.tail) dst[w - s.tail + t] = src[w - s.tail + t];
}

// zeros over n elements of `size` bytes at p, 16 bytes a store
__device__ __forceinline__ void zero_range(void* p, int64_t n, int size) {
  const Span s = split16(p, n, size);
  uint8_t* base = static_cast<uint8_t*>(p);
  for (int i = threadIdx.x; i < s.head * size; i += kThreads) base[i] = 0;
  uint4* body = reinterpret_cast<uint4*>(base + (int64_t)s.head * size);
  for (int64_t g = threadIdx.x; g < s.groups; g += kThreads)
    body[g] = make_uint4(0, 0, 0, 0);
  uint8_t* tail = base + (n - s.tail) * size;
  for (int i = threadIdx.x; i < s.tail * size; i += kThreads) tail[i] = 0;
}

// kOneWindow: Q <= kOneWindowQ, the tile's whole mask is one window
template <bool kOneWindow>
__global__ void __launch_bounds__(kThreads,
                                  kOneWindow ? kMinBlocksOne : kMinBlocks)
reader_kernel_scan(const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ proj,
                   const uint8_t* __restrict__ bad,
                   const int32_t* __restrict__ use_index,
                   const int32_t* __restrict__ lohi,
                   const int4* __restrict__ qtab,
                   uint8_t* __restrict__ mask, int32_t* __restrict__ out,
                   int rows, int n_cols, int n_q) {
  // {lo, hi, r0, r1} of the first kStageQ queries, rows of the block
  __shared__ int4 s_q[kStageQ];
  __shared__ __align__(16) int32_t s_key[kTileRows];
  __shared__ __align__(16) uint8_t s_good[kTileRows];
  __shared__ __align__(16) uint8_t s_any[kTileRows];
  // a window of the mask, its byte j at s_mask[shift + j]
  __shared__ __align__(16) uint8_t s_mask[kWindow + 16];

  const int b = blockIdx.y, t = threadIdx.x;
  const int tile_lo = blockIdx.x * kTileRows;
  const int n = min(kTileRows, rows - tile_lo);
  const int64_t row0 = (int64_t)b * rows + tile_lo;
  const int4* qt = qtab + (int64_t)b * n_q;
  const int32_t* kt = keys + row0;
  const uint8_t* bt = bad + row0;

  // A full scan's rows go out together with its query entries; an indexed
  // block's wait until the table says the tile is live.  Each scan mode
  // has its own loop: one load an entry.
  const bool full_scan = __ldg(use_index + b) <= 0;
  int live = full_scan;
  if (full_scan) {
    const Rows staged = load_rows(kt, bt, n);
#pragma unroll 1
    for (int q = t; q < min(n_q, kStageQ); q += kThreads)
      s_q[q] = make_int4(__ldg(lohi + 2 * q), __ldg(lohi + 2 * q + 1), 0,
                         rows);
    store_rows(staged, kt, bt, n, s_key, s_good, s_any);
  } else {
#pragma unroll 1
    for (int q = t; q < n_q; q += kThreads) {
      const int4 e = __ldg(qt + q);
      if (q < kStageQ) s_q[q] = e;
      live |= e.z < tile_lo + n && e.w > tile_lo;
    }
  }
  live = __syncthreads_or(live);

  uint8_t* mt = mask + row0 * n_q;
  int32_t* ot = out + row0 * n_cols;
  if (!live) {                 // pruned for every query: zeros, no loads
    zero_range(mt, (int64_t)n * n_q, 1);
    zero_range(ot, (int64_t)n * n_cols, 4);
    return;
  }
  if (!full_scan) {
    store_rows(load_rows(kt, bt, n), kt, bt, n, s_key, s_good, s_any);
    __syncthreads();
  }

  // --- the mask: (n x Q) bytes, a window of them at a time ------------
  // staged in shared memory at the output's own offset within 16 bytes,
  // then copied out 16 bytes a store
  const int tq_n = min(n_q, kThreads), tr_n = kThreads / tq_n;
  const int tr = t / tq_n, tq = t % tq_n;    // tr >= tr_n: idle
  if (kOneWindow) {
    const int shift = (int)((uintptr_t)mt & 15);
    const Window win = {0, n, 0, n_q, tile_lo, s_mask + shift};
    if (tr < tr_n)
      mask_window<true>(win, tr, tq, tr_n, tq_n, s_q, s_key, s_good, s_any,
                        full_scan, lohi, qt, rows);
    __syncthreads();
    copy_out(mt, s_mask + shift, n * n_q);
  } else {
    const int win_rows = max(1, kWindow / n_q), win_q = min(n_q, kWindow);
    for (int ra = 0; ra < n; ra += win_rows) {
      for (int qa = 0; qa < n_q; qa += win_q) {
        const int rb = min(n, ra + win_rows), qb = min(n_q, qa + win_q);
        uint8_t* dst = mt + (int64_t)ra * n_q + qa;
        const int shift = (int)((uintptr_t)dst & 15);
        const Window win = {ra, rb, qa, qb, tile_lo, s_mask + shift};
        if (tr < tr_n) {
          if (n_q <= kStageQ)
            mask_window<true>(win, tr, tq, tr_n, tq_n, s_q, s_key, s_good,
                              s_any, full_scan, lohi, qt, rows);
          else
            mask_window<false>(win, tr, tq, tr_n, tq_n, s_q, s_key, s_good,
                               s_any, full_scan, lohi, qt, rows);
        }
        __syncthreads();
        copy_out(dst, s_mask + shift, (rb - ra) * (qb - qa));
        if (rb < n || qb < n_q) __syncthreads();   // the window is reused
      }
    }
  }

  // --- the projection masked by the union: (n x C) ints, 4 a thread -----
  const int32_t* pt = proj + row0 * n_cols;
  const int64_t n_ints = (int64_t)n * n_cols;
  const Span os = split16(ot, n_ints, 4);
  const bool proj_vec = (((uintptr_t)pt ^ (uintptr_t)ot) & 15) == 0;
  if (t < os.head) ot[t] = s_any[t / n_cols] ? __ldg(pt + t) : 0;
  if (n_cols > 0) {
    // group g holds ints head + 4 g ..; a thread's next group is 4 *
    // kThreads ints on: (row, column) steps by (gdrow, gdc)
    const int gdrow = (4 * kThreads) / n_cols, gdc = (4 * kThreads) % n_cols;
    const int f = os.head + 4 * t;
    int row = f / n_cols, c0 = f % n_cols;
    const int4* src = reinterpret_cast<const int4*>(pt + os.head);
    int4* body = reinterpret_cast<int4*>(ot + os.head);
    for (int64_t g = t; g < os.groups; g += kThreads) {
      unsigned kept = 0;
      int r = row, c = c0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        kept |= (unsigned)s_any[r] << k;
        if (++c == n_cols) {
          c = 0;
          ++r;
        }
      }
      int4 v = make_int4(0, 0, 0, 0);
      if (kept && proj_vec) {
        v = __ldg(src + g);
      } else if (kept) {
        const int32_t* p = pt + os.head + 4 * g;
        v = make_int4(kept & 1 ? __ldg(p) : 0, kept & 2 ? __ldg(p + 1) : 0,
                      kept & 4 ? __ldg(p + 2) : 0, kept & 8 ? __ldg(p + 3) : 0);
      }
      body[g] = make_int4(kept & 1 ? v.x : 0, kept & 2 ? v.y : 0,
                          kept & 4 ? v.z : 0, kept & 8 ? v.w : 0);
      c0 += gdc;
      row += gdrow;
      if (c0 >= n_cols) {
        c0 -= n_cols;
        ++row;
      }
    }
  }
  if (t < os.tail) {
    const int64_t i = n_ints - os.tail + t;
    ot[i] = s_any[i / n_cols] ? __ldg(pt + i) : 0;
  }
}

}  // namespace

extern "C" int hail_read_launch(const void* mins, const void* keys,
                                const void* proj, const void* bad,
                                const void* use_index, const void* lohi,
                                void* mask, void* out, void* frac,
                                void* ranges, int n_blocks, int rows,
                                int n_parts, int n_cols, int n_q,
                                int partition_size, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  reader_kernel_ranges<<<dim3(n_q, n_blocks), kCountThreads, 0, s>>>(
      (const int32_t*)mins, (const int32_t*)use_index, (const int32_t*)lohi,
      (int4*)ranges, (float*)frac, rows, n_parts, n_q, partition_size);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto scan = n_q <= kOneWindowQ ? reader_kernel_scan<true>
                                       : reader_kernel_scan<false>;
  const dim3 grid((rows + kTileRows - 1) / kTileRows, n_blocks);
  scan<<<grid, kThreads, 0, s>>>(
      (const int32_t*)keys, (const int32_t*)proj, (const uint8_t*)bad,
      (const int32_t*)use_index, (const int32_t*)lohi, (const int4*)ranges,
      (uint8_t*)mask, (int32_t*)out, rows, n_cols, n_q);
  return (int)cudaGetLastError();
}
