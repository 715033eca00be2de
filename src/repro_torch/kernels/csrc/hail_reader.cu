// Fused HAIL split reader for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hail_reader.py, `_reader_kernel`, reached
// through `hail_read_batch` (and `hail_read`, its Q = 1 case).
//
// What bounds it on the H100: device-memory bytes.  Per row a live tile
// reads the key (4 B), the bad flag (1 B) and, where some query matches, the
// C projected columns (4*C B); it writes Q mask bytes and 4*C output bytes.
// The arithmetic is a handful of integer compares per row and query, far
// below the card's operations-per-byte balance, so the floor is the bytes
// over 3.35 TB/s.
//
// What the design does about it: one CTA per (row tile, block).  The CTA
// derives each query's row range [r0, r1) from the block's root directory
// with the reference's count rule, corrected at the lower bound:
// p_first = max(count(mins < lo) - 1, 0), p_last = max(count(mins <= hi) - 1,
// 0).  (The reference counts mins <= lo for p_first, which skips rows equal
// to lo that sit before a partition starting with lo; see
// ref.index_search.)  A tile that no
// query's range touches loads nothing and only writes the zeros its
// outputs need.  A live tile loads each key once and tests all Q ranges
// against it (one pass over the data for a whole batch of queries), and a
// row's projection is loaded only when some query keeps the row.  The query
// ranges arrive as a device tensor, never as scalar arguments, so a new
// range never builds a new kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 1024;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
reader_kernel(const int32_t* __restrict__ mins,
              const int32_t* __restrict__ keys,
              const int32_t* __restrict__ proj,
              const uint8_t* __restrict__ bad,
              const int32_t* __restrict__ use_index,
              const int32_t* __restrict__ lohi,
              uint8_t* __restrict__ mask,
              int32_t* __restrict__ out,
              float* __restrict__ frac,
              int rows, int n_parts, int n_cols, int n_q,
              int partition_size) {
  extern __shared__ int32_t smem[];
  int32_t* s_lo = smem;
  int32_t* s_hi = s_lo + n_q;
  int32_t* s_r0 = s_hi + n_q;
  int32_t* s_r1 = s_r0 + n_q;
  int32_t* s_cnt = s_r1 + n_q;  // (count(mins < lo), count(mins <= hi))
  __shared__ int s_live;

  const int b = blockIdx.y;
  const int tile_lo = blockIdx.x * kTileRows;
  const int tile_rows = min(kTileRows, rows - tile_lo);
  const bool indexed = use_index[b] > 0;

  for (int q = threadIdx.x; q < n_q; q += blockDim.x) {
    s_lo[q] = lohi[2 * q];
    s_hi[q] = lohi[2 * q + 1];
    s_cnt[2 * q] = 0;
    s_cnt[2 * q + 1] = 0;
  }
  if (threadIdx.x == 0) s_live = 0;
  __syncthreads();

  // root-directory lookup: two counts per query
  if (indexed) {
    const int32_t* m = mins + (int64_t)b * n_parts;
    for (int q = 0; q < n_q; ++q) {
      const int lo = s_lo[q], hi = s_hi[q];
      int c_lo = 0, c_hi = 0;
      for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
        const int v = m[p];
        c_lo += v < lo;
        c_hi += v <= hi;
      }
      for (int off = 16; off > 0; off >>= 1) {
        c_lo += __shfl_down_sync(0xffffffffu, c_lo, off);
        c_hi += __shfl_down_sync(0xffffffffu, c_hi, off);
      }
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(&s_cnt[2 * q], c_lo);
        atomicAdd(&s_cnt[2 * q + 1], c_hi);
      }
    }
    __syncthreads();
  }

  for (int q = threadIdx.x; q < n_q; q += blockDim.x) {
    int r0 = 0, r1 = rows;
    if (indexed) {
      const int p_first = max(s_cnt[2 * q] - 1, 0);
      const int p_last = max(s_cnt[2 * q + 1] - 1, 0);
      r0 = p_first * partition_size;
      r1 = min((p_last + 1) * partition_size, rows);
    }
    s_r0[q] = r0;
    s_r1[q] = r1;
    // rows-read fraction, written once per (block, query) by the first tile;
    // IEEE division (no fast math), as the reference computes it
    if (blockIdx.x == 0) frac[(int64_t)b * n_q + q] = (float)(r1 - r0) / (float)rows;
    if (tile_lo < r1 && tile_lo + tile_rows > r0) s_live = 1;
  }
  __syncthreads();

  const int64_t base = (int64_t)b * rows + tile_lo;
  if (!s_live) {  // pruned for every query: zeros only, no loads
    uint8_t* mt = mask + base * n_q;
    for (int i = threadIdx.x; i < tile_rows * n_q; i += blockDim.x) mt[i] = 0;
    int32_t* ot = out + base * n_cols;
    for (int i = threadIdx.x; i < tile_rows * n_cols; i += blockDim.x) ot[i] = 0;
    return;
  }

  for (int i = threadIdx.x; i < tile_rows; i += blockDim.x) {
    const int r = tile_lo + i;
    const int64_t row = base + i;
    const int32_t key = keys[row];
    const bool good = bad[row] == 0;
    bool any = false;
    uint8_t* mrow = mask + row * n_q;
    for (int q = 0; q < n_q; ++q) {
      const bool m = good && key >= s_lo[q] && key <= s_hi[q] &&
                     r >= s_r0[q] && r < s_r1[q];
      mrow[q] = m;
      any = any || m;
    }
    const int32_t* prow = proj + row * n_cols;
    int32_t* orow = out + row * n_cols;
    for (int c = 0; c < n_cols; ++c) orow[c] = any ? prow[c] : 0;
  }
}

}  // namespace

extern "C" int hail_read_launch(const void* mins, const void* keys,
                                const void* proj, const void* bad,
                                const void* use_index, const void* lohi,
                                void* mask, void* out, void* frac,
                                int n_blocks, int rows, int n_parts,
                                int n_cols, int n_q, int partition_size,
                                void* stream) {
  const dim3 grid((rows + kTileRows - 1) / kTileRows, n_blocks);
  const size_t smem = 6 * (size_t)n_q * sizeof(int32_t);
  reader_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)mins, (const int32_t*)keys, (const int32_t*)proj,
      (const uint8_t*)bad, (const int32_t*)use_index, (const int32_t*)lohi,
      (uint8_t*)mask, (int32_t*)out, (float*)frac, rows, n_parts, n_cols,
      n_q, partition_size);
  return (int)cudaGetLastError();
}
