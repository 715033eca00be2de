// Stable bitonic block sort for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/block_sort.py, `_bitonic_kernel`, reached
// through `bitonic_sort` (and `ops.sort_block`, which the adaptive index
// builds call).
//
// What bounds it on the H100: device-memory bytes.  The network does
// n/2 * log2(n) * (log2(n) + 1) / 2 compare-exchanges of (key, position)
// pairs, a few integer operations each, so the operations take well under the
// time of moving the data once; the least traffic is reading the keys once
// and writing sorted keys and the permutation once (12 B an element).
//
// What the design does about it: the comparator is lexicographic on
// (key, original position), so every element is distinct and the network's
// output is the stable argsort the eager upload produces.  A 2^19-row block
// needs 4 MB for keys plus positions, far more than the 227 KB of shared
// memory a CTA has, so the network runs in two kinds of pass:
//  * in shared memory, a CTA sorts a tile of up to 4096 elements (32 KB)
//    through every stage whose partner distance is below the tile, so those
//    log2(tile) * (log2(tile) + 1) / 2 steps cost one read and one write of
//    the tile;
//  * a stage whose partner distance reaches the tile size runs as one
//    global-memory compare-exchange pass, after which the stage's remaining
//    short-distance steps go back to shared memory in one tile merge.
// Every block of a call shares each launch (grid.y is the block).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;
constexpr int kGlobalThreads = 256;

__device__ __forceinline__ bool after(int32_t ka, int32_t pa, int32_t kb,
                                      int32_t pb) {
  return ka > kb || (ka == kb && pa > pb);
}

// Compare-exchange of the pair (lo, hi) with lo < hi: ascending iff the
// position's bit k is clear (the same rule as the reference network).
__device__ __forceinline__ void exchange(int32_t& klo, int32_t& plo,
                                         int32_t& khi, int32_t& phi,
                                         bool ascending) {
  const bool swap = ascending ? after(klo, plo, khi, phi)
                              : after(khi, phi, klo, plo);
  if (swap) {
    const int32_t k = klo, p = plo;
    klo = khi;
    plo = phi;
    khi = k;
    phi = p;
  }
}

// Index of the t-th pair's lower element for partner distance j (a power of
// two): t with a zero bit inserted at j.
__device__ __forceinline__ int pair_lo(int t, int j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// The steps j = j_start, j_start / 2, ..., 1 of stages k = k_first ... k_last
// on one tile held in shared memory.
__device__ void tile_network(int32_t* sk, int32_t* sp, int tile, int base,
                             int k_first, int k_last, int j_start_last) {
  for (int k = k_first; k <= k_last; k <<= 1) {
    const int j_start = (k == k_last) ? j_start_last : (k >> 1);
    for (int j = j_start; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
        const int lo = pair_lo(t, j);
        const int hi = lo + j;
        const bool asc = ((base + lo) & k) == 0;
        int32_t klo = sk[lo], plo = sp[lo], khi = sk[hi], phi = sp[hi];
        exchange(klo, plo, khi, phi, asc);
        sk[lo] = klo;
        sp[lo] = plo;
        sk[hi] = khi;
        sp[hi] = phi;
      }
      __syncthreads();
    }
  }
}

// First pass: every stage k <= tile, tile by tile; positions start as iota.
__global__ void sort_tiles(const int32_t* __restrict__ keys_in,
                           int32_t* __restrict__ keys_out,
                           int32_t* __restrict__ perm_out, int n, int tile) {
  extern __shared__ int32_t smem[];
  int32_t* sk = smem;
  int32_t* sp = smem + tile;
  const int base = blockIdx.x * tile;
  const int64_t off = (int64_t)blockIdx.y * n + base;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    sk[i] = keys_in[off + i];
    sp[i] = base + i;
  }
  __syncthreads();
  if (tile >= 2) tile_network(sk, sp, tile, base, 2, tile, tile >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    keys_out[off + i] = sk[i];
    perm_out[off + i] = sp[i];
  }
}

// The steps j < tile of stage k > tile, in place.
__global__ void merge_tiles(int32_t* __restrict__ keys,
                            int32_t* __restrict__ perm, int n, int tile,
                            int k) {
  extern __shared__ int32_t smem[];
  int32_t* sk = smem;
  int32_t* sp = smem + tile;
  const int base = blockIdx.x * tile;
  const int64_t off = (int64_t)blockIdx.y * n + base;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    sk[i] = keys[off + i];
    sp[i] = perm[off + i];
  }
  __syncthreads();
  tile_network(sk, sp, tile, base, k, k, tile >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    keys[off + i] = sk[i];
    perm[off + i] = sp[i];
  }
}

// One step (k, j) with j >= tile, in place in device memory.
__global__ void __launch_bounds__(kGlobalThreads)
exchange_global(int32_t* __restrict__ keys, int32_t* __restrict__ perm,
                int n, int j, int k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const int lo = pair_lo(t, j);
  const int hi = lo + j;
  const int64_t off = (int64_t)blockIdx.y * n;
  int32_t klo = keys[off + lo], plo = perm[off + lo];
  int32_t khi = keys[off + hi], phi = perm[off + hi];
  exchange(klo, plo, khi, phi, (lo & k) == 0);
  keys[off + lo] = klo;
  perm[off + lo] = plo;
  keys[off + hi] = khi;
  perm[off + hi] = phi;
}

}  // namespace

extern "C" int bitonic_sort_launch(const void* keys_in, void* keys_out,
                                   void* perm_out, int n_blocks, int n,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* keys = (int32_t*)keys_out;
  int32_t* perm = (int32_t*)perm_out;
  const int tile = n < kTile ? n : kTile;
  const int threads = tile / 2 < 32 ? 32 : (tile / 2 > 1024 ? 1024 : tile / 2);
  const size_t smem = 2 * (size_t)tile * sizeof(int32_t);
  const dim3 tiles(n / tile, n_blocks);
  sort_tiles<<<tiles, threads, smem, s>>>((const int32_t*)keys_in, keys, perm,
                                          n, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 pairs((n / 2 + kGlobalThreads - 1) / kGlobalThreads, n_blocks);
  for (int k = 2 * tile; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      exchange_global<<<pairs, kGlobalThreads, 0, s>>>(keys, perm, n, j, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    merge_tiles<<<tiles, threads, smem, s>>>(keys, perm, n, tile, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
