// Hopper (sm_90a) device helpers of the bf16 flash forward and backward
// (flash_fwd.cuh, flash_bwd.cuh) and the scan backward
// (selective_scan_bwd.cu): mbarriers, TMA tensor loads and the host's
// encoder of their maps, warpgroup matrix multiplies (`wgmma`) with their
// shared-memory descriptors, register reallocation between warpgroups
// (`setmaxnreg`) and named barriers.
#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_helpers.cuh"

namespace {

// --- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the other threads and to
// the TMA unit (the async proxy).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival, announcing `bytes` of TMA transfers that complete
// on the same phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of parity `parity`.  (No
// timeout that traps: a trap anywhere in the flash forward made ptxas hold
// its consumers to the launch's registers and serialise their `wgmma`s.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// An arrival on `bar` once this thread's earlier cp.async copies have
// landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// --- TMA ------------------------------------------------------------------

// The box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, -> shared memory at dst; its bytes complete on `bar`.  Elements
// outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The box of a 3-D tensor map at coordinates (c0, c1, c2), innermost
// first, -> shared memory at dst, as tma_load_4d.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (so the library links no -lcuda); null where it is missing.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// Orders this thread's generic-proxy shared-memory accesses with the async
// proxy's (TMA, wgmma) to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- warpgroups ------------------------------------------------------------

// The registers of every thread of this warpgroup, raised or lowered to N
// (the warpgroups move them between each other).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads: wait
// there, or arrive without waiting.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory layouts of a wgmma operand, as the TMA writes them:
// rows of 128, 64 or 32 bytes swizzled in 16-byte chunks (descriptor
// layout types 1, 2 and 3).
enum Swizzle { kSw128 = 1, kSw64 = 2, kSw32 = 3 };

// The 64-bit descriptor of an operand at shared address `addr`: `lbo` and
// `sbo` the leading and stride byte offsets (in bytes, multiples of 16),
// base offset 0 (every swizzle atom starts on a 1,024-byte boundary).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, Swizzle sw) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)sw << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After wgmma_wait: the accumulator's registers are read only after the
// wait (the compiler may not hoist their uses above it).
template <int NT>
__device__ __forceinline__ void fence_operands(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// m64nNk16 bf16 -> float32: `ss` with A and B from shared memory (N = 64,
// 80, 128), `rs` with A from registers (the accumulator layout of two
// 8-column tiles) and B MN-major (N = 16, 32, 64, 128, 256).  The
// accumulator of a thread (warp w, lane l of the warpgroup) holds, in
// d[j][0..3], rows 16 w + l / 4 and 16 w + l / 4 + 8 at columns
// 8 j + 2 (l % 4) + {0, 1}: the `mma.sync.m16n8` layout, one 8-column
// tile per j.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d[OFF, OFF + 2) (64 x 16) += A B, A (P) from registers and B
  // MN-major in shared memory
  template <int OFF, int NT>
  static __device__ __forceinline__ void rs(float (&d)[NT][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]),
          "+f"(d[OFF + 0][3]), "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]),
          "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32) = (scale_d ? d : 0) + A B, A and B K-major in shared
  // memory (the backward's 32-row steps at D = 256)
  static __device__ __forceinline__ void ss(float (&d)[4][4],
                                            uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d[OFF, OFF + 4) (64 x 32) += A B, A (P) from registers and B
  // MN-major in shared memory
  template <int OFF, int NT>
  static __device__ __forceinline__ void rs(float (&d)[NT][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]),
          "+f"(d[OFF + 0][3]), "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]),
          "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]), "+f"(d[OFF + 2][0]),
          "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]),
          "+f"(d[OFF + 3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64) = (scale_d ? d : 0) + A B, A and B K-major in shared
  // memory
  static __device__ __forceinline__ void ss(float (&d)[8][4],
                                            uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d[OFF, OFF + 8) (64 x 64) += A B, A (P) from registers and B
  // MN-major in shared memory
  template <int OFF, int NT>
  static __device__ __forceinline__ void rs(float (&d)[NT][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]),
          "+f"(d[OFF + 0][3]), "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]),
          "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]), "+f"(d[OFF + 2][0]),
          "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]),
          "+f"(d[OFF + 3][3]), "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]),
          "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]), "+f"(d[OFF + 5][0]),
          "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
          "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]),
          "+f"(d[OFF + 6][3]), "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]),
          "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};

template <>
struct Wgmma<80> {
  // d (64 x 80) = (scale_d ? d : 0) + A B, A and B K-major in shared
  // memory
  static __device__ __forceinline__ void ss(float (&d)[10][4],
                                            uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        "%38, %39}, "
        "%40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128) = (scale_d ? d : 0) + A B, A and B K-major in shared
  // memory
  static __device__ __forceinline__ void ss(float (&d)[16][4],
                                            uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d[OFF, OFF + 16) (64 x 128) += A B, A (P) from registers and B
  // MN-major in shared memory
  template <int OFF, int NT>
  static __device__ __forceinline__ void rs(float (&d)[NT][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]),
          "+f"(d[OFF + 0][3]), "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]),
          "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]), "+f"(d[OFF + 2][0]),
          "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]),
          "+f"(d[OFF + 3][3]), "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]),
          "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]), "+f"(d[OFF + 5][0]),
          "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
          "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]),
          "+f"(d[OFF + 6][3]), "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]),
          "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3]), "+f"(d[OFF + 8][0]),
          "+f"(d[OFF + 8][1]), "+f"(d[OFF + 8][2]), "+f"(d[OFF + 8][3]),
          "+f"(d[OFF + 9][0]), "+f"(d[OFF + 9][1]), "+f"(d[OFF + 9][2]),
          "+f"(d[OFF + 9][3]), "+f"(d[OFF + 10][0]), "+f"(d[OFF + 10][1]),
          "+f"(d[OFF + 10][2]), "+f"(d[OFF + 10][3]), "+f"(d[OFF + 11][0]),
          "+f"(d[OFF + 11][1]), "+f"(d[OFF + 11][2]), "+f"(d[OFF + 11][3]),
          "+f"(d[OFF + 12][0]), "+f"(d[OFF + 12][1]), "+f"(d[OFF + 12][2]),
          "+f"(d[OFF + 12][3]), "+f"(d[OFF + 13][0]), "+f"(d[OFF + 13][1]),
          "+f"(d[OFF + 13][2]), "+f"(d[OFF + 13][3]), "+f"(d[OFF + 14][0]),
          "+f"(d[OFF + 14][1]), "+f"(d[OFF + 14][2]), "+f"(d[OFF + 14][3]),
          "+f"(d[OFF + 15][0]), "+f"(d[OFF + 15][1]), "+f"(d[OFF + 15][2]),
          "+f"(d[OFF + 15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // d[OFF, OFF + 32) (64 x 256) += A B, A (P) from registers and B
  // MN-major in shared memory
  template <int OFF, int NT>
  static __device__ __forceinline__ void rs(float (&d)[NT][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108,"
        "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118,"
        "%119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]),
          "+f"(d[OFF + 0][3]), "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]),
          "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]), "+f"(d[OFF + 2][0]),
          "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]),
          "+f"(d[OFF + 3][3]), "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]),
          "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]), "+f"(d[OFF + 5][0]),
          "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
          "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]),
          "+f"(d[OFF + 6][3]), "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]),
          "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3]), "+f"(d[OFF + 8][0]),
          "+f"(d[OFF + 8][1]), "+f"(d[OFF + 8][2]), "+f"(d[OFF + 8][3]),
          "+f"(d[OFF + 9][0]), "+f"(d[OFF + 9][1]), "+f"(d[OFF + 9][2]),
          "+f"(d[OFF + 9][3]), "+f"(d[OFF + 10][0]), "+f"(d[OFF + 10][1]),
          "+f"(d[OFF + 10][2]), "+f"(d[OFF + 10][3]), "+f"(d[OFF + 11][0]),
          "+f"(d[OFF + 11][1]), "+f"(d[OFF + 11][2]), "+f"(d[OFF + 11][3]),
          "+f"(d[OFF + 12][0]), "+f"(d[OFF + 12][1]), "+f"(d[OFF + 12][2]),
          "+f"(d[OFF + 12][3]), "+f"(d[OFF + 13][0]), "+f"(d[OFF + 13][1]),
          "+f"(d[OFF + 13][2]), "+f"(d[OFF + 13][3]), "+f"(d[OFF + 14][0]),
          "+f"(d[OFF + 14][1]), "+f"(d[OFF + 14][2]), "+f"(d[OFF + 14][3]),
          "+f"(d[OFF + 15][0]), "+f"(d[OFF + 15][1]), "+f"(d[OFF + 15][2]),
          "+f"(d[OFF + 15][3]), "+f"(d[OFF + 16][0]), "+f"(d[OFF + 16][1]),
          "+f"(d[OFF + 16][2]), "+f"(d[OFF + 16][3]), "+f"(d[OFF + 17][0]),
          "+f"(d[OFF + 17][1]), "+f"(d[OFF + 17][2]), "+f"(d[OFF + 17][3]),
          "+f"(d[OFF + 18][0]), "+f"(d[OFF + 18][1]), "+f"(d[OFF + 18][2]),
          "+f"(d[OFF + 18][3]), "+f"(d[OFF + 19][0]), "+f"(d[OFF + 19][1]),
          "+f"(d[OFF + 19][2]), "+f"(d[OFF + 19][3]), "+f"(d[OFF + 20][0]),
          "+f"(d[OFF + 20][1]), "+f"(d[OFF + 20][2]), "+f"(d[OFF + 20][3]),
          "+f"(d[OFF + 21][0]), "+f"(d[OFF + 21][1]), "+f"(d[OFF + 21][2]),
          "+f"(d[OFF + 21][3]), "+f"(d[OFF + 22][0]), "+f"(d[OFF + 22][1]),
          "+f"(d[OFF + 22][2]), "+f"(d[OFF + 22][3]), "+f"(d[OFF + 23][0]),
          "+f"(d[OFF + 23][1]), "+f"(d[OFF + 23][2]), "+f"(d[OFF + 23][3]),
          "+f"(d[OFF + 24][0]), "+f"(d[OFF + 24][1]), "+f"(d[OFF + 24][2]),
          "+f"(d[OFF + 24][3]), "+f"(d[OFF + 25][0]), "+f"(d[OFF + 25][1]),
          "+f"(d[OFF + 25][2]), "+f"(d[OFF + 25][3]), "+f"(d[OFF + 26][0]),
          "+f"(d[OFF + 26][1]), "+f"(d[OFF + 26][2]), "+f"(d[OFF + 26][3]),
          "+f"(d[OFF + 27][0]), "+f"(d[OFF + 27][1]), "+f"(d[OFF + 27][2]),
          "+f"(d[OFF + 27][3]), "+f"(d[OFF + 28][0]), "+f"(d[OFF + 28][1]),
          "+f"(d[OFF + 28][2]), "+f"(d[OFF + 28][3]), "+f"(d[OFF + 29][0]),
          "+f"(d[OFF + 29][1]), "+f"(d[OFF + 29][2]), "+f"(d[OFF + 29][3]),
          "+f"(d[OFF + 30][0]), "+f"(d[OFF + 30][1]), "+f"(d[OFF + 30][2]),
          "+f"(d[OFF + 30][3]), "+f"(d[OFF + 31][0]), "+f"(d[OFF + 31][1]),
          "+f"(d[OFF + 31][2]), "+f"(d[OFF + 31][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};

}  // namespace
