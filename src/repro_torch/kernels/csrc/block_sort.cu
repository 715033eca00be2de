// Stable block sort for Hopper (sm_90a): an LSD radix sort in the one-sweep
// style (one histogram launch, then one launch per 8-bit digit).
//
// Replaces: src/repro/kernels/block_sort.py, `_bitonic_kernel`, reached
// through `bitonic_sort` (and `ops.sort_block`, which the adaptive index
// builds call).  The TPU kernel runs a bitonic network under the
// lexicographic (key, original position) comparator, so its permutation is
// the stable argsort.  A stable least-significant-digit radix sort computes
// that same permutation bit for bit: ties keep their original order in
// every pass.  The entry point keeps the network's name.
//
// What bounds it on the H100: device-memory bytes.  The least traffic is
// reading the keys once and writing sorted keys and the permutation once
// (12 B an element); the work is a few integer operations a key a pass.
// A network does log n (log n + 1) / 2 compare-exchange steps for every
// element (190 at n = 2^19) and 36 launches a call; a radix sort over four
// 8-bit digits of `key ^ 0x80000000` (which orders int32 as unsigned)
// moves each key and position four times, in five launches:
//  * `radix_histogram` counts all four digits of every block in one read of
//    the keys: shared-memory counters (warp-aggregated with
//    `__match_any_sync`, since duplicated keys hit one counter), then global
//    atomics into a (blocks, 4, 256) table;
//  * `radix_pass`, once per digit, walks a block in tiles of kTile keys.  A
//    CTA takes its tile from an atomic counter, not from blockIdx: it waits
//    on the tiles before it, and those were handed to CTAs already running,
//    so the wait cannot deadlock.  Warp w ranks the keys of its 512-key
//    segment in position order (step j covers keys j*32 + lane) with
//    `__match_any_sync` and per-warp digit counters; the tile's digit counts
//    are published per (tile, digit) as one 32-bit word (a 2-bit flag,
//    aggregate or inclusive, and a 30-bit count) and each digit's prefix
//    over earlier tiles comes from decoupled look-back.  With the digit's
//    global base (the histogram's exclusive prefix) every key has its place;
//    keys and positions are scattered through shared memory first, so the
//    writes leave grouped by digit.  Positions start as iota in pass 0.
//  * Buffers ping-pong in -> tmp -> out -> tmp -> out.  grid.y is the
//    block; every block has its own histogram, status words and tile
//    counter.  The wrapper allocates all scratch, zeroed where it must be.
// For n < kTile one tile holds the block, padded with INT32_MAX (digit 255
// in every pass, after every real key in position order); pads are never
// written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                   // keys a thread ranks
constexpr int kTile = kThreads * kItems;     // 4096 keys a CTA
constexpr int kRadix = 256;
constexpr int kPasses = 4;
constexpr uint32_t kFlagAggregate = 1u << 30;
constexpr uint32_t kFlagInclusive = 2u << 30;
constexpr uint32_t kCountMask = (1u << 30) - 1;

__device__ __forceinline__ uint32_t digit_of(int32_t key, int shift) {
  return (((uint32_t)key ^ 0x80000000u) >> shift) & (kRadix - 1);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive sum of v over the kThreads threads, in thread order.
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? s_warp_sums[w] : 0;
  __syncthreads();  // s_warp_sums may be reused
  return before + x - v;
}

// Counts of all four digits of every key; grid (tiles, blocks).
__global__ void __launch_bounds__(kThreads)
radix_histogram(const int32_t* __restrict__ keys, int32_t* __restrict__ hist,
                int n) {
  __shared__ int s_hist[kPasses][kRadix];
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads)
    (&s_hist[0][0])[i] = 0;
  __syncthreads();
  const int b = blockIdx.y;
  const int64_t row = (int64_t)b * n;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int j = 0; j < kItems; ++j) {
    const int i = blockIdx.x * kTile + j * kThreads + threadIdx.x;
    const bool valid = i < n;
    const int32_t key = valid ? keys[row + i] : 0;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      // 256 stands for "no key", so every lane takes part in the match
      const uint32_t d = valid ? digit_of(key, 8 * p) : kRadix;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (valid && lane == __ffs(peers) - 1)
        atomicAdd(&s_hist[p][d], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) {
    const int c = (&s_hist[0][0])[i];
    if (c) atomicAdd(&hist[(int64_t)b * kPasses * kRadix + i], c);
  }
}

// One stable counting pass over digit `pass`; grid (tiles, blocks).
// status: (blocks, tiles, 256) words of this pass, zeroed; counter: the
// pass's per-block tile counters, zeroed.  keys_in/vals_in may be the
// previous pass's output; vals_in is unused in pass 0 (positions = iota).
__global__ void __launch_bounds__(kThreads)
radix_pass(const int32_t* __restrict__ keys_in,
           const int32_t* __restrict__ vals_in,
           int32_t* __restrict__ keys_out, int32_t* __restrict__ vals_out,
           const int32_t* __restrict__ hist, uint32_t* status,
           int32_t* counter, int n, int tiles, int pass) {
  __shared__ int32_t s_keys[kTile];
  __shared__ int32_t s_vals[kTile];
  __shared__ int s_warp[kWarps][kRadix];  // warp counts, then warp prefixes
  __shared__ int s_tile_start[kRadix];    // digit's first slot in the tile
  __shared__ int s_dst[kRadix];           // slot -> block index offset
  __shared__ int s_sums[kWarps];
  __shared__ int s_tile;

  const int b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int shift = 8 * pass;
  const int64_t row = (int64_t)b * n;
  if (t == 0) s_tile = atomicAdd(&counter[b], 1);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp[w][t] = 0;
  // the digit's first index in the sorted block: exclusive prefix of the
  // block's histogram (thread t owns digit t from here on)
  const int global_start = block_exclusive_sum(
      hist[((int64_t)b * kPasses + pass) * kRadix + t], s_sums);
  const int tile = s_tile;  // block_exclusive_sum synchronised

  // load: warp w owns keys [w*512, (w+1)*512) of the tile, step j the 32
  // keys j*32 + lane, so (warp, j, lane) is position order
  const int seg = tile * kTile + warp * (32 * kItems);
  int32_t key[kItems], val[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = seg + j * 32 + lane;
    const bool valid = i < n;
    key[j] = valid ? keys_in[row + i] : INT32_MAX;
    val[j] = pass == 0 ? i : (valid ? vals_in[row + i] : 0);
  }

  // stable rank inside the warp: earlier steps' counts + earlier lanes of
  // this step with the same digit
  int rank[kItems];
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t d = digit_of(key[j], shift);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = s_warp[warp][d];
    rank[j] = before + __popc(peers & lt);
    __syncwarp();
    if ((peers & lt) == 0) s_warp[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // digit t: prefix over the warps, and the tile's count
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w][t];
    s_warp[w][t] = total;
    total += c;
  }
  // publish, then look back over the earlier tiles for digit t
  uint32_t* word = status + ((int64_t)b * tiles + tile) * kRadix + t;
  atomicExch(word, (tile == 0 ? kFlagInclusive : kFlagAggregate) |
                       (uint32_t)total);
  int before_tile = 0;
  const int tile_start = block_exclusive_sum(total, s_sums);
  if (tile > 0) {
    const volatile uint32_t* prev = word;
    for (int p = tile - 1; p >= 0; --p) {
      prev -= kRadix;
      uint32_t s;
      do {
        s = *prev;
      } while ((s & ~kCountMask) == 0);
      before_tile += (int)(s & kCountMask);
      if ((s & ~kCountMask) == kFlagInclusive) break;
    }
    atomicExch(word, kFlagInclusive | (uint32_t)(before_tile + total));
  }
  s_tile_start[t] = tile_start;
  s_dst[t] = global_start + before_tile - tile_start;
  __syncthreads();

  // scatter through shared memory: slot = the key's place in the tile
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t d = digit_of(key[j], shift);
    const int slot = s_tile_start[d] + s_warp[warp][d] + rank[j];
    s_keys[slot] = key[j];
    s_vals[slot] = val[j];
  }
  __syncthreads();
  const int valid = min(kTile, n - tile * kTile);  // pads sit last
#pragma unroll 4
  for (int i = t; i < valid; i += kThreads) {
    const int32_t k = s_keys[i];
    const int dst = s_dst[digit_of(k, shift)] + i;
    keys_out[row + dst] = k;
    vals_out[row + dst] = s_vals[i];
  }
}

}  // namespace

// keys_in, keys_out, perm_out, keys_tmp, perm_tmp: (n_blocks, n) int32;
// hist: n_blocks * 4 * 256 int32, zeroed; status: 4 * n_blocks * tiles *
// 256 words, zeroed; counters: 4 * n_blocks int32, zeroed; tiles =
// max(1, n / 4096).  n is a power of two below 2^30.  Returns the
// cudaGetLastError() of the launches.
extern "C" int bitonic_sort_launch(const void* keys_in, void* keys_out,
                                   void* perm_out, void* keys_tmp,
                                   void* perm_tmp, void* hist, void* status,
                                   void* counters, int n_blocks, int n,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = n < kTile ? 1 : n / kTile;
  const dim3 grid(tiles, n_blocks);
  radix_histogram<<<grid, kThreads, 0, s>>>((const int32_t*)keys_in,
                                            (int32_t*)hist, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int32_t* src_k = (const int32_t*)keys_in;
  const int32_t* src_v = src_k;  // not read in pass 0
  for (int pass = 0; pass < kPasses; ++pass) {
    int32_t* dst_k = (int32_t*)(pass % 2 == 0 ? keys_tmp : keys_out);
    int32_t* dst_v = (int32_t*)(pass % 2 == 0 ? perm_tmp : perm_out);
    radix_pass<<<grid, kThreads, 0, s>>>(
        src_k, src_v, dst_k, dst_v, (const int32_t*)hist,
        (uint32_t*)status + (int64_t)pass * n_blocks * tiles * kRadix,
        (int32_t*)counters + pass * n_blocks, n, tiles, pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src_k = dst_k;
    src_v = dst_v;
  }
  return 0;
}
