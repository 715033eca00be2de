// Single-block PAX range scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pax_scan.py, `_scan_kernel`, reached through
// `pax_scan` (and `ops.pax_scan`): for one block's key column and C
// projected columns, the range mask lo <= key <= hi, the projection with
// the rows outside the range set to 0, and one match count per row tile.
//
// What bounds it on the H100: device-memory bytes.  Per row it reads the
// key (4 B) and, where the row is kept, its C projected words; it writes a
// mask byte and C output words, plus 4 B a tile.  Two compares a row are
// far below the card's operations-per-byte balance.
//
// What the design does: the TPU kernel walks row tiles as a sequential
// grid axis; here one CTA owns one row tile of `tile` rows (the TPU rule:
// 1024 lowered until it divides the rows, so the counts have the TPU
// kernel's shape) and loops over it when it is longer than the CTA.  Keys,
// mask bytes and the projection's words are read and written coalesced:
// the projection pass walks the tile's tile * C contiguous words, so
// neighbouring threads touch neighbouring words whatever C is, and loads a
// word only when its row is kept.  The count is a warp shuffle sum and one
// pass over the warps' sums in shared memory, written once per tile with
// no atomics.  The projection is moved as 32-bit words, so int32 and
// float32 columns share one kernel and are copied bit for bit.  (lo, hi)
// arrive as a device int32 pair: a new range builds no new kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
scan_kernel(const int32_t* __restrict__ keys,
            const uint32_t* __restrict__ proj,
            const int32_t* __restrict__ lohi, uint8_t* __restrict__ mask,
            uint32_t* __restrict__ out, int32_t* __restrict__ counts,
            int tile, int n_cols) {
  __shared__ int s_warp[kMaxThreads / 32];
  const int lo = lohi[0], hi = lohi[1];
  const int64_t row0 = (int64_t)blockIdx.x * tile;
  const int32_t* k = keys + row0;

  int kept = 0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int32_t key = k[i];
    const bool m = key >= lo && key <= hi;
    mask[row0 + i] = m;
    kept += m;
  }
  const int64_t w0 = row0 * n_cols;
  const int words = tile * n_cols;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int32_t key = k[i / n_cols];  // from L1: the pass above read it
    out[w0 + i] = (key >= lo && key <= hi) ? proj[w0 + i] : 0u;
  }

  for (int off = 16; off > 0; off >>= 1)
    kept += __shfl_down_sync(0xffffffffu, kept, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) total += s_warp[w];
    counts[blockIdx.x] = total;
  }
}

}  // namespace

// keys (n_tiles * tile,) int32; proj (n_tiles * tile, n_cols) of 32-bit
// words; lohi (2,) int32 on the device; mask (rows,) bool as bytes; out
// like proj; counts (n_tiles,) int32.  Returns the cudaGetLastError() of
// the launch.
extern "C" int pax_scan_launch(const void* keys, const void* proj,
                               const void* lohi, void* mask, void* out,
                               void* counts, int n_tiles, int tile,
                               int n_cols, void* stream) {
  const int threads = tile >= kMaxThreads ? kMaxThreads : (tile + 31) / 32 * 32;
  scan_kernel<<<n_tiles, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const uint32_t*)proj, (const int32_t*)lohi,
      (uint8_t*)mask, (uint32_t*)out, (int32_t*)counts, tile, n_cols);
  return (int)cudaGetLastError();
}
