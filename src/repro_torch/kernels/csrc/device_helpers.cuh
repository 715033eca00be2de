// Device helpers shared by the flash kernels (flash_fwd.cuh,
// flash_bwd.cuh) and the scans (selective_scan.cu, selective_scan_bwd.cu):
// asynchronous copies into shared memory, 2^x on the special-function
// unit, sums across lanes, bf16 packing, and a kernel's shared-memory
// stage, static up to 48 KB and dynamic past it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block may declare at most 48 KB of static shared memory; past that it
// takes dynamic shared memory, which the launch sizes and, past 48 KB
// too, must first allow with cudaFuncSetAttribute.
constexpr int kStaticSmemBytes = 48 * 1024;

// The kernel's shared-memory stage S: a static __shared__ object where S
// fits in 48 KB, else the block's dynamic shared memory, which the launch
// sizes with dynamic_smem_bytes<S>() after allow_dynamic_smem.
template <typename S>
__device__ __forceinline__ S& shared_stage() {
  if constexpr (sizeof(S) <= kStaticSmemBytes) {
    __shared__ __align__(128) S s;
    return s;
  } else {
    extern __shared__ __align__(128) unsigned char dynamic_smem[];
    return *reinterpret_cast<S*>(dynamic_smem);
  }
}

template <typename S>
constexpr int dynamic_smem_bytes() {
  return sizeof(S) <= kStaticSmemBytes ? 0 : (int)sizeof(S);
}

// Let Kernel take Bytes of dynamic shared memory on the current device.
// The attribute belongs to the device's context, so it is set once per
// instantiation and device, and that call's cudaError_t kept and returned
// at every later launch; none for 0 bytes.
constexpr int kMaxDevices = 64;

template <auto Kernel, int Bytes>
inline int allow_dynamic_smem() {
  if constexpr (Bytes == 0) {
    return 0;
  } else {
    static int set[kMaxDevices] = {};  // 0: not yet, else cudaError_t + 1
    int dev = 0;
    const int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (dev >= kMaxDevices)
      return (int)cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bytes);
    if (!set[dev])
      set[dev] = 1 + (int)cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bytes);
    return set[dev] - 1;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously and without registers;
// zero-filled when !in (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (about 2 ulp; 0 for -inf and for
// -1e30, 1 for 0), without exp2f's extra range handling
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Sum over the SPLIT neighbouring lanes that share one row or key (the
// float32 flash kernels' split head dims), by butterflies.
template <int SPLIT>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int m = 1; m < SPLIT; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
