// Root-directory lookup for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/index_search.py, `_search_kernel`, reached
// through `index_search` (and `ops.index_search`): for each block's sorted
// partition minima and one runtime range [lo, hi], the first and last
// partition the range can touch.
//
// What bounds it on the H100: bytes, and at the sizes it sees, the launch.
// It reads each minimum once (4 B) and does two compares on it; a (64, 512)
// root set is 131 KB, 0.04 us at 3.35 TB/s, far below a launch's cost.
//
// What the design does: one warp per block row.  The lanes walk the row 32
// minima at a time, and two ballots with a popcount count the minima below
// lo and those at most hi, so the warp needs no shared memory and no
// atomics.  The port's lower-bound rule is used (as in hail_reader.cu):
// p_first = max(count(mins < lo) - 1, 0), p_last = max(count(mins <= hi) -
// 1, 0).  (lo, hi) arrive as a device int32 pair, so a new range never
// builds a new kernel and a bound that lives on the card never syncs the
// host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // block rows a CTA

__global__ void __launch_bounds__(kWarps * 32)
search_kernel(const int32_t* __restrict__ mins,
              const int32_t* __restrict__ lohi, int32_t* __restrict__ out,
              int n_blocks, int n_parts) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_blocks) return;  // whole warps leave together
  const int lo = lohi[0], hi = lohi[1];
  const int32_t* m = mins + (int64_t)row * n_parts;
  int c_lo = 0, c_hi = 0;
  for (int p0 = 0; p0 < n_parts; p0 += 32) {
    const int p = p0 + lane;
    const bool in = p < n_parts;
    const int v = in ? m[p] : 0;
    c_lo += __popc(__ballot_sync(0xffffffffu, in && v < lo));
    c_hi += __popc(__ballot_sync(0xffffffffu, in && v <= hi));
  }
  if (lane == 0) {
    out[2 * (int64_t)row] = max(c_lo - 1, 0);
    out[2 * (int64_t)row + 1] = max(c_hi - 1, 0);
  }
}

}  // namespace

// mins (n_blocks, n_parts) int32, each row sorted; lohi (2,) int32 on the
// device; out (n_blocks, 2) int32.  Returns the cudaGetLastError() of the
// launch.
extern "C" int index_search_launch(const void* mins, const void* lohi,
                                   void* out, int n_blocks, int n_parts,
                                   void* stream) {
  const int grid = (n_blocks + kWarps - 1) / kWarps;
  search_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)mins, (const int32_t*)lohi, (int32_t*)out, n_blocks,
      n_parts);
  return (int)cudaGetLastError();
}
